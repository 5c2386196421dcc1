from .dataset import Data
from .graph import CscGraph, CsrGraph, SparseGraph, make_graph
from .io import load_fake_dataset, load_fake_hetero_graph, load_karate_graph
from .ogb import OGBN_SPECS, planted_ogbn, synthetic_ogbn
from .storage import ind2ptr, to_csc, to_csr
