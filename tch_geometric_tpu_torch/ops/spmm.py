"""Plain CSR SpMM and SDDMM.

Counterpart of ``tch_geometric_tpu/ops/spmm.py``: ``spmm`` is gather +
segment reduce, ``y[i] = reduce_{e in row i} w[e] * x[indices[e]]`` (sum,
mean or max), the aggregation of ``GraphSAGE.__call__``; ``sddmm`` is the
per-edge dot product, the scores of the segment-op attention reference.
Both are what the blocked paths are checked against; they materialise
(E, F) gathers, so they are for graphs small enough for that.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..data.graph import SparseGraph
from .segment import csr_row_ids, segment_max, segment_mean, segment_sum


def spmm(graph: SparseGraph, x: torch.Tensor, *, agg: str = "sum",
         edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Aggregate source features ``x[indices]``, each scaled by its
    ``edge_weight`` (by sorted edge position) where given, into destination
    rows; ``agg`` "sum", "mean" or "max" (a row with no edges, or a
    non-finite max, gives 0)."""
    E = graph.num_edges
    n = graph.num_ptr_nodes
    rows = csr_row_ids(graph.indptr, E)
    gathered = x[graph.indices]                        # (E, F) gather
    if edge_weight is not None:
        gathered = gathered * edge_weight[:, None].to(gathered.dtype)
    if agg == "sum":
        return segment_sum(gathered, rows, n)
    if agg == "mean":
        return segment_mean(gathered, rows, n)
    if agg == "max":
        out = segment_max(gathered, rows, n)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(f"unknown agg {agg!r}")


def sddmm(graph: SparseGraph, x_dst: torch.Tensor, x_src: torch.Tensor
          ) -> torch.Tensor:
    """Per-edge dot products ``s[e] = <x_dst[row(e)], x_src[indices[e]]>``;
    (E,), or (E, H) when the inputs carry a trailing head dim."""
    rows = csr_row_ids(graph.indptr, graph.num_edges)
    return (x_dst[rows] * x_src[graph.indices]).sum(dim=-1)
