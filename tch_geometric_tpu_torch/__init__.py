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
  ``ops.spmm(edge_weight=, agg="max")``.

Every Pallas kernel of the JAX package has its counterpart here; the
samplers are plain torch ops on the caller's device.
"""

from . import data, models, ops, parallel, sampling, utils
from .data.storage import ind2ptr, to_csc, to_csr
from .sampling.hetero_neighbor import (neighbor_sampling_heterogenous,
                                      sample_hetero_neighbors)
from .sampling.neighbor import neighbor_sampling_homogenous, sample_neighbors
from .sampling.rng import seed as rng_reseed
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

__all__ = [
    "data", "models", "ops", "parallel", "sampling", "utils",
    "ind2ptr", "to_csc", "to_csr",
    "neighbor_sampling_homogenous", "sample_neighbors",
    "neighbor_sampling_heterogenous", "sample_hetero_neighbors", "rng_reseed",
    "TEMPORAL_SAMPLE_DYNAMIC", "TEMPORAL_SAMPLE_RELATIVE",
    "TEMPORAL_SAMPLE_STATIC", "EdgeSampler", "TemporalEdgeFilter",
    "UniformEdgeSampler", "WeightedEdgeSampler", "validate_mixeddata",
]
