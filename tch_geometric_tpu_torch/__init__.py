"""tch_geometric_tpu_torch — the PyTorch/CUDA port of ``tch_geometric_tpu``.

A second package beside the JAX one, with its module layout and names.  It
imports torch and numpy only.  Entry points take ``device=`` (default
``"cuda"``); the blocked full-graph operators run hand-written Hopper
kernels (``csrc/``), built with ``nvcc`` at first use.  On CPU tensors every
kernel wrapper runs its plain PyTorch version.

Ported so far:

* the GraphSAGE serving path — COO -> CSC, device graph tables, multi-hop
  neighbor sampling (bit-equal to ``jax.random``), feature gather,
  ``GraphSAGE.tree_forward`` and full-graph ``blocked_forward`` (kernels
  B1, B2), and the int8 blocked SpMM (``ops.spmm_blocked_q8``, B11);
* GAT, GCN and GIN serving (``models.gnn``), with the multi-head GAT
  aggregation three ways: head-packed (``GATConv(blocked=...)``, B3),
  composed (``ops.gat_attend_blocked``, B7 + B8) and flash
  (``ops.gat_attend_blocked_flash``, B9);
* single-head blocked dot-product attention (``ops.attend_blocked``,
  ``_fused``, ``_flash``; B2, B4, B5, B6, B10);
* sampled training (``parallel``: the single and multibatch trainers,
  Adam equal to ``optax.adam``, keyed dropout, checkpoints, metrics);
* the neighbor-sampling family: uniform and weighted samplers, the three
  temporal filter modes, homogeneous (``sample_neighbors``,
  ``neighbor_sampling_homogenous``) and heterogeneous
  (``sample_hetero_neighbors``, ``neighbor_sampling_heterogenous``), with
  ``data.HeteroData``, ``ops.csc_sort_edges`` / ``csc_edge_cumsum`` and
  ``ops.spmm(edge_weight=, agg="max")``;
* the rest of the reference-parity API: node2vec, temporal and CTDNE walks
  (``random_walk``, ``tempo_random_walk``, ``biased_tempo_random_walk``),
  HGT and budget sampling (``hgt_sampling`` / ``sample_hgt``,
  ``budget_sampling`` / ``sample_budget``), negative sampling, the
  ``transforms`` and ``loader`` modules, and the data layer under them:
  ``SparseGraph.find_edge`` / ``has_edge``, ``data.coo_to_csc_device`` (a
  stable sort on the card), the native C++ CSC/CSR sort (``native``),
  ``data.load_ogbn_dir`` and ``data.planted_hetero``;
* the HGT and node2vec models (``models.HGT``, ``HGTConv``, ``Node2Vec``
  with ``make_node2vec_trainer``) and the single-device HGT and
  link-prediction trainers (``parallel.make_hgt_trainer``,
  ``make_link_trainer``), with Adam equal to ``optax.adam``
  (``utils.adam``) and the flax carriers ``utils.hgt_params_from_flax``
  and ``node2vec_params_from_flax``.

The distributed family (``parallel``'s mesh, sharded features,
``dist_*`` samplers and partitioned trainers) is not ported yet.

Every Pallas kernel of the JAX package has its counterpart here; the
samplers are plain torch ops on the caller's device.
"""

from . import (data, loader, models, ops, parallel, sampling, transforms,
               utils)
from .data.storage import ind2ptr_np as ind2ptr
from .data.storage import to_csc, to_csr
from .sampling.budget import budget_sampling, sample_budget
from .sampling.hetero_neighbor import (neighbor_sampling_heterogenous,
                                      sample_hetero_neighbors)
from .sampling.hgt import hgt_sampling, sample_hgt
from .sampling.negative import (negative_sample_neighbors_heterogenous,
                                negative_sample_neighbors_homogenous)
from .sampling.neighbor import neighbor_sampling_homogenous, sample_neighbors
from .sampling.rng import seed as rng_reseed
from .sampling.walks import (biased_tempo_random_walk, random_walk,
                             tempo_random_walk)
from .utils.config import (
    TEMPORAL_SAMPLE_DYNAMIC,
    TEMPORAL_SAMPLE_RELATIVE,
    TEMPORAL_SAMPLE_STATIC,
    EdgeSampler,
    TemporalEdgeFilter,
    UniformEdgeSampler,
    WeightedEdgeSampler,
    validate_mixeddata,
)

__version__ = "0.1.0"

__all__ = [
    "data", "loader", "models", "ops", "parallel", "sampling", "transforms",
    "utils", "ind2ptr", "to_csc", "to_csr", "rng_reseed",
    "neighbor_sampling_homogenous", "sample_neighbors",
    "neighbor_sampling_heterogenous", "sample_hetero_neighbors",
    "random_walk", "tempo_random_walk", "biased_tempo_random_walk",
    "hgt_sampling", "sample_hgt", "budget_sampling", "sample_budget",
    "negative_sample_neighbors_homogenous",
    "negative_sample_neighbors_heterogenous",
    "TEMPORAL_SAMPLE_DYNAMIC", "TEMPORAL_SAMPLE_RELATIVE",
    "TEMPORAL_SAMPLE_STATIC", "EdgeSampler", "TemporalEdgeFilter",
    "UniformEdgeSampler", "WeightedEdgeSampler", "validate_mixeddata",
]
