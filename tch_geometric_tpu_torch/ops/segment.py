"""Segment reductions over CSR edge structures.

Counterpart of the SpMM-facing part of ``tch_geometric_tpu/ops/segment.py``:
the plain gather + segment-sum formulation behind ``GraphSAGE.__call__``.
"""
from __future__ import annotations

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
