from .sage import GraphSAGE, SAGEConv, tree_neighbor_mean
