from .dataset import Data, HeteroData
from .graph import CscGraph, CsrGraph, SparseGraph, make_graph
from .io import load_fake_dataset, load_fake_hetero_graph, load_karate_graph
from .ogb import (OGBN_SPECS, load_ogbn_dir, planted_hetero, planted_ogbn,
                  synthetic_ogbn)
from .storage import (coo_to_csc_device, csc_graph_from_coo,
                      csr_graph_from_coo, ind2ptr, ind2ptr_np, to_csc, to_csr)
