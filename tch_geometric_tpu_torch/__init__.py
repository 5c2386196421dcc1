"""tch_geometric_tpu_torch — the PyTorch/CUDA port of ``tch_geometric_tpu``.

A second package beside the JAX one, with its module layout and names.  It
imports torch and numpy only.  Entry points take ``device=`` (default
``"cuda"``); the blocked full-graph SpMM runs hand-written Hopper kernels
(``csrc/``), built with ``nvcc`` at first use.  On CPU tensors every kernel
wrapper runs its plain PyTorch version.

Ported so far: the GraphSAGE serving path — COO -> CSC, device graph tables,
uniform multi-hop neighbor sampling (bit-equal to ``jax.random``), feature
gather, ``GraphSAGE.tree_forward`` and full-graph ``blocked_forward``.
"""

from . import data, models, ops, parallel, sampling, utils
from .data.storage import ind2ptr, to_csc, to_csr
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
)

__all__ = [
    "data", "models", "ops", "parallel", "sampling", "utils",
    "ind2ptr", "to_csc", "to_csr",
    "neighbor_sampling_homogenous", "sample_neighbors", "rng_reseed",
    "TEMPORAL_SAMPLE_DYNAMIC", "TEMPORAL_SAMPLE_RELATIVE",
    "TEMPORAL_SAMPLE_STATIC", "EdgeSampler", "TemporalEdgeFilter",
    "UniformEdgeSampler", "WeightedEdgeSampler",
]
