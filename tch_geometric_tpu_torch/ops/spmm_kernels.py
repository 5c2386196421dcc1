"""Blocked SpMM through the hand-written Hopper kernels B1 and B11.

Counterpart of ``tch_geometric_tpu/ops/spmm_pallas.py``: the same wrappers
with the same ``agg`` handling, with the CUDA kernels of
``csrc/spmm_blocked.cu`` in place of the Pallas kernels, and the int8 path
(:func:`quantize_rows`, :func:`spmm_blocked_q8`, B11).  A wrapper given a
CPU tensor runs the plain version (``spmm_blocked``, ``spmm_blocked_q8``);
given a CUDA tensor it launches the kernel or raises.  Each kernel wrapper
counts its launches in a plain integer attribute,
``spmm_blocked_cuda.launches``.
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


def _launch(b: BlockedCsr, xc: torch.Tensor, weight: Optional[torch.Tensor],
            row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``tgt_spmm_blocked`` (B1, B2) or, for int8 rows with their
    ``row_scale``, ``tgt_spmm_blocked_q8`` (B11) on the current stream;
    returns the (B*W, F) float32 output."""
    if xc.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{xc.device}")
    q8 = row_scale is not None
    if q8 and xc.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {xc.dtype}")
    if not q8 and xc.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {xc.dtype}")
    if xc.dim() != 2 or not xc.is_contiguous():
        raise ValueError("x must be a contiguous (N, F) tensor")
    T, C = b.edge_src.shape
    B, W, F = b.num_blocks, b.rows_per_block, xc.shape[1]
    dev = xc.device
    _check(b.edge_src, "edge_src", torch.int32, (T, C), dev)
    _check(b.edge_local_row, "edge_local_row", torch.int32, (T, C), dev)
    _check(b.chunk_block, "chunk_block", torch.int32, (T,), dev)
    _check(b.block_start, "block_start", torch.int32, (B + 1,), dev)
    if weight is not None:
        _check(weight, "edge_weight", torch.float32, (T, C), dev)
    if q8:
        _check(row_scale, "row_scale", torch.float32, (xc.shape[0],), dev)
    out = torch.empty((B * W, F), dtype=torch.float32, device=dev)
    if B == 0 or F == 0:
        return out
    lib = _build.load("spmm_blocked")
    stream = torch.cuda.current_stream(dev).cuda_stream
    layout = (b.edge_src.data_ptr(), b.edge_local_row.data_ptr())
    with torch.cuda.device(dev):
        if q8:
            fn = "tgt_spmm_blocked_q8"
            rc = lib.tgt_spmm_blocked_q8(
                xc.data_ptr(), row_scale.data_ptr(), *layout,
                b.chunk_block.data_ptr(), b.block_start.data_ptr(), T, B, C,
                W, F, out.data_ptr(), stream)
        else:
            fn = "tgt_spmm_blocked"
            rc = lib.tgt_spmm_blocked(
                xc.data_ptr(), int(xc.dtype == torch.bfloat16), *layout,
                None if weight is None else weight.data_ptr(),
                b.chunk_block.data_ptr(), b.block_start.data_ptr(), T, B, C,
                W, F, out.data_ptr(), stream)
    if rc != 0:
        msg = lib.tgt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({rc})")
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


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 quantization: returns ``(q int8, scale f32)``,
    bit-equal to the JAX package's (``torch.round`` rounds half to even, as
    ``jnp.round`` does)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = (amax / 127.0).to(torch.float32)
    q = torch.round(x / scale.clamp(min=1e-12)).clamp(-127, 127)
    return q.to(torch.int8), scale[..., 0]


def spmm_blocked_q8(b: BlockedCsr, q: torch.Tensor, row_scale: torch.Tensor,
                    *, agg: str = "sum") -> torch.Tensor:
    """Plain version of B11: SpMM over the int8 rows ``q`` of
    :func:`quantize_rows`, each lane weighted by its source row's scale
    rounded to bfloat16 (the JAX kernel folds the scale into its bfloat16
    one-hot), float32 sums.  ``q * bf16(scale)`` is exact in float32.
    Returns (num_rows, F) float32."""
    w = row_scale.to(torch.bfloat16).float()[b.edge_src.long()]
    return spmm_blocked(b, q.float(), agg=agg, edge_weight=w,
                        compute_dtype=torch.float32)


def spmm_blocked_q8_cuda(b: BlockedCsr, q: torch.Tensor,
                         row_scale: torch.Tensor, *,
                         agg: str = "sum") -> torch.Tensor:
    """B11: :func:`spmm_blocked_q8` through the hand-written Hopper kernel
    (B1's row-grouped chunks: each lane's weight ``bf16(scale[src])``
    staged with the chunk, each int8 row read whole with vector loads) on a
    CUDA tensor; the plain version on a CPU tensor.  Differs from the plain
    version only in summation order."""
    if q.device.type == "cpu":
        return spmm_blocked_q8(b, q, row_scale, agg=agg)
    out = _launch(b, q.contiguous(), None,
                  row_scale.to(torch.float32).contiguous())
    spmm_blocked_q8_cuda.launches += 1
    return _finish(out[: b.num_rows], b.degree, agg)


spmm_blocked_q8_cuda.launches = 0
