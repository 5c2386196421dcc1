"""Weighted blocked SpMM through the hand-written Hopper kernel B2.

Counterpart of ``tch_geometric_tpu/ops/attention_blocked.py``; only the
weighted SpMM is ported so far (the hot half of ``spmm_hot_split`` and the
weighted segmented path run it).  The attention kernels of that module
(SDDMM, edge softmax, GAT) are still to port.
"""
from __future__ import annotations

import torch

from .spmm_blocked import BlockedCsr, spmm_blocked
from .spmm_kernels import _launch


def spmm_blocked_weighted_cuda(b: BlockedCsr, x: torch.Tensor,
                               edge_weight: torch.Tensor, *,
                               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """B2: ``y[i] = sum_e w[e] x[src(e)]`` with ``edge_weight`` (T, C) in
    the blocked layout.  Pad lanes are excluded by their local row.
    Returns (num_rows, F) float32.

    The kernel multiplies the float32 weight into each row in float32; the
    plain version rounds the weight to ``compute_dtype`` first, as the JAX
    package's XLA path does (multiplicities and softmax weights differ
    from their bf16 rounding by at most 2**-9 relative)."""
    if x.device.type == "cpu":
        return spmm_blocked(b, x, agg="sum", edge_weight=edge_weight,
                            compute_dtype=compute_dtype)
    out = _launch(b, x.to(compute_dtype).contiguous(),
                  edge_weight.to(torch.float32).contiguous())
    spmm_blocked_weighted_cuda.launches += 1
    return out[: b.num_rows]


spmm_blocked_weighted_cuda.launches = 0
