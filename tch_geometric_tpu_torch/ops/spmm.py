"""Plain CSR SpMM: ``y[i] = reduce_{e in row i} x[indices[e]]``.

Counterpart of ``tch_geometric_tpu/ops/spmm.py::spmm``: gather + segment
reduce.  It is the aggregation of ``GraphSAGE.__call__`` and the reference
the blocked path is checked against; it materialises the (E, F) gather, so
it is for graphs small enough for that.
"""
from __future__ import annotations

import torch

from ..data.graph import SparseGraph
from .segment import csr_row_ids, segment_mean, segment_sum


def spmm(graph: SparseGraph, x: torch.Tensor, *, agg: str = "sum"
         ) -> torch.Tensor:
    """Aggregate source features ``x[indices]`` into destination rows
    (``agg`` "sum" or "mean")."""
    E = graph.num_edges
    n = graph.num_ptr_nodes
    rows = csr_row_ids(graph.indptr, E)
    gathered = x[graph.indices]                        # (E, F) gather
    if agg == "sum":
        return segment_sum(gathered, rows, n)
    if agg == "mean":
        return segment_mean(gathered, rows, n)
    raise ValueError(f"unknown agg {agg!r}")
