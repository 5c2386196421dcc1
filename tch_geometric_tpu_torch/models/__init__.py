from .sage import GraphSAGE, SAGEConv, tree_neighbor_mean
from .gnn import GAT, GATConv, GCN, GCNConv, GIN, GINConv
from .dropout import keyed_dropout
