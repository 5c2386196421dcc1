from .sage import GraphSAGE, SAGEConv, tree_neighbor_mean
from .gnn import GAT, GATConv, GCN, GCNConv, GIN, GINConv
from .hgt import HGT, HGTConv
from .node2vec import (N2VState, Node2Vec, Node2VecTrainer,
                       make_node2vec_trainer)
from .dropout import keyed_dropout
