"""Plain CSR SpMM and SDDMM.

Counterpart of ``tch_geometric_tpu/ops/spmm.py``: ``spmm`` is gather +
segment reduce, ``y[i] = reduce_{e in row i} x[indices[e]]``, the
aggregation of ``GraphSAGE.__call__``; ``sddmm`` is the per-edge dot
product, the scores of the segment-op attention reference.  Both are what
the blocked paths are checked against; they materialise (E, F) gathers, so
they are for graphs small enough for that.
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


def sddmm(graph: SparseGraph, x_dst: torch.Tensor, x_src: torch.Tensor
          ) -> torch.Tensor:
    """Per-edge dot products ``s[e] = <x_dst[row(e)], x_src[indices[e]]>``;
    (E,), or (E, H) when the inputs carry a trailing head dim."""
    rows = csr_row_ids(graph.indptr, graph.num_edges)
    return (x_dst[rows] * x_src[graph.indices]).sum(dim=-1)
