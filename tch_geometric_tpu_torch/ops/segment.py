"""Segment reductions over CSR edge structures, and CSC edge transforms.

Counterpart of ``tch_geometric_tpu/ops/segment.py``: the plain gather +
segment-reduce formulation behind the full-graph ``__call__`` of
GraphSAGE, GCN, GIN and GAT, and the host (numpy) per-column edge
transforms ``csc_sort_edges`` and ``csc_edge_cumsum``.
"""
from __future__ import annotations

import numpy as np
import torch


def csr_row_ids(indptr: torch.Tensor, num_edges: int) -> torch.Tensor:
    """Per-edge destination row id from a pointer array."""
    counts = indptr[1:] - indptr[:-1]
    n = indptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                   counts, output_size=num_edges)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(data.new_ones(data.shape[:1]), segment_ids,
                      num_segments)
    return s / cnt.clamp(min=1)[(...,) + (None,) * (data.dim() - 1)]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max; a segment with no entries gets -inf (the identity
    of ``jax.ops.segment_max``)."""
    out = data.new_full((num_segments,) + tuple(data.shape[1:]),
                        float("-inf"))
    idx = segment_ids.reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(data), data, "amax")


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask=None) -> torch.Tensor:
    """Per-segment softmax of ``scores`` (E,) or (E, H); masked-out entries
    get weight 0.  A segment's max is taken with masked entries at -inf and
    replaced by 0 where it is not finite; the denominator is floored at
    1e-16."""
    if mask is not None:
        m = mask[:, None] if scores.dim() == 2 else mask
        scores = torch.where(m, scores, float("-inf"))
    smax = segment_max(scores, segment_ids, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    ex = torch.exp(scores - smax[segment_ids])
    if mask is not None:
        ex = torch.where(m, ex, 0.0)
    den = segment_sum(ex, segment_ids, num_segments)
    return ex / den[segment_ids].clamp(min=1e-16)


def csc_sort_edges(col_ptrs, perm, row_weights, descending: bool = False
                   ) -> np.ndarray:
    """Within each CSC column, stably reorder ``perm`` by ``row_weights``:
    one lexsort on (column, weight), no loop over columns.  Pointers past
    the edge count are clamped to it."""
    perm = np.asarray(perm)
    w = np.asarray(row_weights)
    E = perm.shape[0]
    col_ptrs = np.minimum(np.asarray(col_ptrs), E)
    col_of = np.repeat(np.arange(col_ptrs.shape[0] - 1), np.diff(col_ptrs))
    order = np.lexsort((-w if descending else w, col_of))
    return perm[order]


def csc_edge_cumsum(col_ptrs, row_data) -> np.ndarray:
    """Per-column inclusive cumulative sum of edge data: the global cumsum
    less each column's base."""
    x = np.asarray(row_data)
    col_ptrs = np.minimum(np.asarray(col_ptrs), x.shape[0])
    csum = np.cumsum(x)
    base = np.concatenate([[0], csum])[col_ptrs[:-1]]
    col_of = np.repeat(np.arange(col_ptrs.shape[0] - 1), np.diff(col_ptrs))
    return (csum - base[col_of]).astype(x.dtype)
