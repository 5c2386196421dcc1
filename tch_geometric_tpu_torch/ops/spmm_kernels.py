"""Blocked SpMM through the hand-written Hopper kernel B1.

Counterpart of ``tch_geometric_tpu/ops/spmm_pallas.py``: the same wrappers
with the same ``agg`` handling, with the CUDA kernel of
``csrc/spmm_blocked.cu`` in place of the Pallas kernel.  A wrapper given a
CPU tensor runs the plain version (``spmm_blocked``); given a CUDA tensor it
launches the kernel or raises.  Each kernel wrapper counts its launches in
a plain integer attribute, ``spmm_blocked_cuda.launches``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .spmm_blocked import (BlockedCsr, HotSplitCsr, HotSplitSeg,
                           SegmentedBlockedCsr, spmm_blocked)


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(b: BlockedCsr, xc: torch.Tensor,
            weight: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch ``tgt_spmm_blocked`` on the current stream; returns the
    (B*W, F) float32 output."""
    if xc.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{xc.device}")
    if xc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {xc.dtype}")
    if xc.dim() != 2 or not xc.is_contiguous():
        raise ValueError("x must be a contiguous (N, F) tensor")
    if xc.shape[1] % 2 == 0 and xc.data_ptr() % (2 * xc.element_size()):
        # with F even the kernel loads two columns at a time
        raise ValueError("x must start at a multiple of two elements")
    T, C = b.edge_src.shape
    B, W, F = b.num_blocks, b.rows_per_block, xc.shape[1]
    dev = xc.device
    _check(b.edge_src, "edge_src", torch.int32, (T, C), dev)
    _check(b.edge_local_row, "edge_local_row", torch.int32, (T, C), dev)
    _check(b.block_start, "block_start", torch.int32, (B + 1,), dev)
    if weight is not None:
        _check(weight, "edge_weight", torch.float32, (T, C), dev)
    out = torch.empty((B * W, F), dtype=torch.float32, device=dev)
    if B == 0 or F == 0:
        return out
    lib = _build.load("spmm_blocked")
    with torch.cuda.device(dev):
        rc = lib.tgt_spmm_blocked(
            xc.data_ptr(), int(xc.dtype == torch.bfloat16),
            b.edge_src.data_ptr(), b.edge_local_row.data_ptr(),
            None if weight is None else weight.data_ptr(),
            b.block_start.data_ptr(), B, C, W, F, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.tgt_cuda_error_string(rc).decode()
        raise RuntimeError(f"tgt_spmm_blocked launch failed: {msg} ({rc})")
    return out


def _finish(out: torch.Tensor, degree, agg: str) -> torch.Tensor:
    if agg == "mean":
        return out / degree.clamp(min=1)[:, None].to(out.dtype)
    if agg != "sum":
        raise ValueError(f"unsupported agg {agg!r}")
    return out


def spmm_blocked_cuda(b: BlockedCsr, x: torch.Tensor, *, agg: str = "sum",
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """B1: ``y[i] = agg_{e in row i} x[src(e)]`` over a BlockedCsr.

    ``x`` (N, F) is cast to ``compute_dtype`` (float32 or bfloat16); the
    kernel gathers its rows and accumulates in float32.  Returns
    (num_rows, F) float32."""
    if x.device.type == "cpu":
        return spmm_blocked(b, x, agg=agg, compute_dtype=compute_dtype)
    out = _launch(b, x.to(compute_dtype).contiguous(), None)
    spmm_blocked_cuda.launches += 1
    return _finish(out[: b.num_rows], b.degree, agg)


spmm_blocked_cuda.launches = 0


def spmm_blocked_auto(b: BlockedCsr, x: torch.Tensor, *, agg: str = "sum",
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """B1 on a CUDA tensor, the plain version on a CPU tensor."""
    return spmm_blocked_cuda(b, x, agg=agg, compute_dtype=compute_dtype)


def spmm_blocked_segmented(seg: SegmentedBlockedCsr, x: torch.Tensor, *,
                           agg: str = "sum", compute_dtype=torch.bfloat16,
                           out_dtype=torch.float32) -> torch.Tensor:
    """Full-graph SpMM over a ``SegmentedBlockedCsr``: a loop over segments,
    each through B1 (or B2 when ``seg.edge_weight`` is present)."""
    from .attention_blocked import spmm_blocked_weighted_cuda

    outs = []
    for s in range(seg.num_segments):
        b, w = seg.segment(s)
        if w is None:
            o = spmm_blocked_auto(b, x, agg="sum",
                                  compute_dtype=compute_dtype)
        else:
            o = spmm_blocked_weighted_cuda(b, x, w,
                                           compute_dtype=compute_dtype)
        outs.append(o.to(out_dtype))
    out = torch.cat(outs)[: seg.num_rows]
    return _finish(out, seg.degree, agg)


def spmm_hot_split(hs: HotSplitCsr, x: torch.Tensor, *, agg: str = "sum",
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Hot/cold split SpMM: cold edges through B1 against ``x``, hot edges
    (deduplicated, multiplicity as weight) through B2 against the compact
    ``x[hot_ids]`` table.  Equal to the unsplit SpMM."""
    from .attention_blocked import spmm_blocked_weighted_cuda

    cold = spmm_blocked_cuda(hs.cold, x, agg="sum",
                             compute_dtype=compute_dtype)
    x_hot = x[hs.hot_ids]
    hot = spmm_blocked_weighted_cuda(hs.hot, x_hot, hs.hot_count,
                                     compute_dtype=compute_dtype)
    n = hs.num_rows
    return _finish(cold[:n] + hot[:n], hs.degree, agg)


def spmm_hot_split_segmented(hs: HotSplitSeg, x: torch.Tensor, *,
                             agg: str = "sum", compute_dtype=torch.bfloat16,
                             out_dtype=torch.float32) -> torch.Tensor:
    """Hot/cold split over segmented layouts (both halves segmented)."""
    cold = spmm_blocked_segmented(hs.cold, x, agg="sum",
                                  compute_dtype=compute_dtype,
                                  out_dtype=out_dtype)
    hot = spmm_blocked_segmented(hs.hot, x[hs.hot_ids], agg="sum",
                                 compute_dtype=compute_dtype,
                                 out_dtype=out_dtype)
    n = hs.num_rows
    return _finish(cold[:n] + hot[:n], hs.degree, agg)
