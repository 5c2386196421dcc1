"""Blocked edge attention: the weighted SpMM (B2) and head-packed GAT (B3).

Counterpart of ``tch_geometric_tpu/ops/attention_blocked.py``.  Ported so
far:

* :func:`spmm_blocked_weighted_cuda` — B2, the weighted blocked SpMM (the
  hot half of ``spmm_hot_split`` and the weighted segmented path);
* :func:`gat_attend_blocked_packed` (plain) and
  :func:`gat_attend_blocked_packed_cuda` (B3, ``csrc/gat_packed.cu``) — the
  multi-head GATv1 aggregation that ``GATConv(blocked=...)`` runs;
* the helpers ``_pad_dst``, :func:`blocked_dst_rows` and
  :func:`gat_edge_logits_blocked`.

The other attention kernels of that module (SDDMM, edge softmax, the flash
and composed GAT and dot-attention variants) are still to port.

Softmax stabilisation of B3, in the plain version and the kernel alike, is
the JAX kernel's: per (row block, head), each chunk's logits are shifted by
the chunk's max ``M`` over its valid lanes, and chunks are combined with a
running max ``m`` over the block (``exp(M - m)`` rescales).  The shift is
the same for every row of a block, so a row whose logits all sit about 87
below the block's max underflows to ``z = 0`` and reads 0, as on the TPU.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as nnf

from . import _build
from .spmm_blocked import (PLAIN_GROUP_LANES, BlockedCsr, _block_groups,
                           spmm_blocked)
from .spmm_kernels import _check, _launch


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


def _pad_dst(b: BlockedCsr, x_dst: torch.Tensor) -> torch.Tensor:
    """Pad dst features to the block grid (B*W rows)."""
    pad = b.num_blocks * b.rows_per_block - x_dst.shape[0]
    if pad:
        x_dst = nnf.pad(x_dst, (0, 0) * (x_dst.dim() - 1) + (0, pad))
    return x_dst


def blocked_dst_rows(b: BlockedCsr) -> torch.Tensor:
    """Global dst row id of every blocked lane (invalid lanes clamped into
    their block — mask with ``b.edge_valid``)."""
    W = b.rows_per_block
    return (b.chunk_block[:, None] * W
            + b.edge_local_row.clamp(max=W - 1))


def gat_edge_logits_blocked(b: BlockedCsr, alpha_src: torch.Tensor,
                            alpha_dst: torch.Tensor, *,
                            negative_slope: float = 0.2) -> torch.Tensor:
    """GATv1-style additive logits in blocked edge layout (single head).

    ``alpha_src``/``alpha_dst``: (N,) per-node projections.  Returns (T, C)
    f32 ``leaky_relu(alpha_src[src(e)] + alpha_dst[dst(e)])``."""
    rows = blocked_dst_rows(b).clamp(0, alpha_dst.shape[0] - 1).long()
    s = (alpha_src[b.edge_src.long()].float() + alpha_dst[rows].float())
    return nnf.leaky_relu(s, negative_slope)


def _check_packed_args(b: BlockedCsr, alpha_src, alpha_src_vec):
    if (alpha_src is None) == (alpha_src_vec is None):
        raise ValueError(
            "pass exactly one of alpha_src (per-node logit table) or "
            "alpha_src_vec (GATv1 (H, D) projection; the kernel recomputes "
            "the logits)")
    C = b.edge_src.shape[1]
    if C % 128 or b.rows_per_block % 128:
        raise ValueError(f"the head-packed GAT needs chunk_edges and "
                         f"rows_per_block divisible by 128, got C={C}, "
                         f"W={b.rows_per_block}")


def _alpha_src_table(hc: torch.Tensor, alpha_src, alpha_src_vec, H: int,
                     D: int) -> torch.Tensor:
    """Per-node (N, H) float32 source logits as the JAX kernel sees them:
    the table rounded to the compute dtype (it rides the feature gather),
    or the projection ``sum_d h[i,h,d] * a[h,d]`` of the compute-dtype rows
    with ``a`` rounded to the compute dtype and float32 accumulation."""
    if alpha_src is not None:
        return alpha_src.to(hc.dtype).float()
    a = alpha_src_vec.to(hc.dtype).float()
    return (hc.float().reshape(-1, H, D) * a).sum(-1)


def gat_attend_blocked_packed(b: BlockedCsr, h: torch.Tensor,
                              alpha_src: Optional[torch.Tensor],
                              alpha_dst: torch.Tensor, *,
                              negative_slope: float = 0.2,
                              compute_dtype=torch.bfloat16,
                              alpha_src_vec: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain version of B3: multi-head GATv1 aggregation on the blocked
    layout.

    ``h``: (N, H, D); ``alpha_dst``: (N, H); exactly one of ``alpha_src``
    (N, H) and ``alpha_src_vec`` (H, D, the GATv1 projection, so that
    ``alpha_src[i, h] = sum_d h[i, h, d] * vec[h, d]``).  Per dst row and
    head: ``softmax(leaky_relu(alpha_src[src] + alpha_dst[dst]))``-weighted
    sum of ``h[src]``.  Returns (num_rows, H, D) float32; rows with no
    edges are 0.

    Rounding follows the JAX kernel: ``h`` (and a table ``alpha_src``) in
    ``compute_dtype``; in bfloat16 each lane's weight ``e`` is rounded to
    bfloat16 and multiplied into its row in bfloat16, the denominator sums
    the float32 ``e``, and every sum accumulates in float32.  Blocks are
    processed in groups of about ``PLAIN_GROUP_LANES`` lanes.
    """
    _check_packed_args(b, alpha_src, alpha_src_vec)
    N, H, D = h.shape
    W = b.rows_per_block
    C = b.edge_src.shape[1]
    hc = h.reshape(N, H * D).to(compute_dtype)
    asrc = _alpha_src_table(hc, alpha_src, alpha_src_vec, H, D)
    ad = _pad_dst(b, alpha_dst.float())                    # (B*W, H)
    dev = h.device
    iota = torch.arange(W, device=dev, dtype=torch.int32)
    bs_host = b.block_start.tolist()
    out = torch.empty((b.num_blocks * W, H, D), dtype=torch.float32,
                      device=dev)
    for b0, b1 in _block_groups(bs_host, max(1, PLAIN_GROUP_LANES // C)):
        t0, t1 = bs_host[b0], bs_host[b1]
        src = b.edge_src[t0:t1].long()                       # (Tg, C)
        lr = b.edge_local_row[t0:t1]
        valid = (lr < W)[..., None]                          # (Tg, C, 1)
        blk = b.chunk_block[t0:t1].long()
        rows = blk[:, None] * W + lr.clamp(max=W - 1).long()
        s = nnf.leaky_relu(asrc[src] + ad[rows], negative_slope)
        s = torch.where(valid, s, float("-inf"))             # (Tg, C, H)
        M = s.amax(dim=1)                                    # (Tg, H)
        Mf = torch.where(torch.isfinite(M), M, 0.0)
        e = torch.where(valid, torch.exp(s - Mf[:, None]), 0.0)
        g = hc[src].reshape(-1, C, H, D)
        rhs = (g * e.to(compute_dtype)[..., None]).float()   # JAX's rhs
        oh = (lr[:, :, None] == iota).float().transpose(1, 2)  # (Tg, W, C)
        part = torch.bmm(oh, rhs.reshape(-1, C, H * D))
        zc = torch.bmm(oh, e)                                # (Tg, W, H)
        # combine the chunks of each block against its running max
        bl = blk - b0
        m = M.new_full((b1 - b0, H), float("-inf")).scatter_reduce(
            0, bl[:, None].expand_as(M), M, "amax")
        r = torch.where(torch.isfinite(M), torch.exp(M - m[bl]), 0.0)
        acc = part.new_zeros((b1 - b0, W, H, D)).index_add_(
            0, bl, part.reshape(-1, W, H, D) * r[:, None, :, None])
        z = zc.new_zeros((b1 - b0, W, H)).index_add_(0, bl, zc * r[:, None])
        zc_ = z[..., None]
        out[b0 * W:b1 * W] = torch.where(
            zc_ > 0, acc / zc_.clamp(min=1e-20), 0.0).reshape(-1, H, D)
    return out[: b.num_rows]


def gat_attend_blocked_packed_cuda(b: BlockedCsr, h: torch.Tensor,
                                   alpha_src: Optional[torch.Tensor],
                                   alpha_dst: torch.Tensor, *,
                                   negative_slope: float = 0.2,
                                   compute_dtype=torch.bfloat16,
                                   alpha_src_vec: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """B3: :func:`gat_attend_blocked_packed` through the hand-written
    Hopper kernel of ``csrc/gat_packed.cu`` on a CUDA tensor; the plain
    version on a CPU tensor.  Same arguments and result."""
    if h.device.type == "cpu":
        return gat_attend_blocked_packed(
            b, h, alpha_src, alpha_dst, negative_slope=negative_slope,
            compute_dtype=compute_dtype, alpha_src_vec=alpha_src_vec)
    _check_packed_args(b, alpha_src, alpha_src_vec)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    if h.dim() != 3:
        raise ValueError(f"h must be (N, H, D), got {tuple(h.shape)}")
    N, H, D = h.shape
    T, C = b.edge_src.shape
    B, W = b.num_blocks, b.rows_per_block
    dev = h.device
    hc = h.reshape(N, H * D).to(compute_dtype).contiguous()
    ad = alpha_dst.to(torch.float32).contiguous()
    _check(ad, "alpha_dst", torch.float32, (ad.shape[0], H), dev)
    _check(b.edge_src, "edge_src", torch.int32, (T, C), dev)
    _check(b.edge_local_row, "edge_local_row", torch.int32, (T, C), dev)
    _check(b.block_start, "block_start", torch.int32, (B + 1,), dev)
    if alpha_src is not None:
        # the table; the kernel rounds it to the compute dtype
        asrc = alpha_src.to(torch.float32).contiguous()
        _check(asrc, "alpha_src", torch.float32, (N, H), dev)
        vec = None
    else:
        # the kernel's projection writes the per-node logits here
        asrc = torch.empty((N, H), dtype=torch.float32, device=dev)
        vec = alpha_src_vec.to(torch.float32).contiguous()
        _check(vec, "alpha_src_vec", torch.float32, (H, D), dev)
    out = torch.empty((B * W, H * D), dtype=torch.float32, device=dev)
    lib = _build.load("gat_packed")
    with torch.cuda.device(dev):
        rc = lib.tgt_gat_packed(
            hc.data_ptr(), int(compute_dtype == torch.bfloat16),
            asrc.data_ptr(), None if vec is None else vec.data_ptr(),
            ad.data_ptr(), ad.shape[0], b.edge_src.data_ptr(),
            b.edge_local_row.data_ptr(), b.block_start.data_ptr(),
            N, B, C, W, H, D, float(negative_slope), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.tgt_cuda_error_string(rc).decode()
        raise RuntimeError(f"tgt_gat_packed launch failed: {msg} ({rc})")
    gat_attend_blocked_packed_cuda.launches += 1
    return out[: b.num_rows].reshape(-1, H, D)


gat_attend_blocked_packed_cuda.launches = 0
