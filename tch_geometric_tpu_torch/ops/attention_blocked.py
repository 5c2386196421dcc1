"""Blocked edge attention: weighted SpMM, multi-head GAT and single-head
dot-product attention.

Counterpart of ``tch_geometric_tpu/ops/attention_blocked.py``, whole (each
JAX name, without ``_pallas``, is the plain version, the ``_cuda`` suffix
its kernel wrapper):

* :func:`spmm_blocked_weighted_cuda` — B2, the weighted blocked SpMM (the
  hot half of ``spmm_hot_split`` and the weighted segmented path);
* :func:`gat_attend_blocked_packed` (plain) and
  :func:`gat_attend_blocked_packed_cuda` (B3, ``csrc/gat_blocked.cu``) —
  the multi-head GATv1 aggregation that ``GATConv(blocked=...)`` runs;
* single-head softmax(<x_dst, x_src> * scale)-weighted aggregation, kernels
  in ``csrc/attend_blocked.cu``: :func:`sddmm_blocked` (B5, the per-lane
  scores of ``sddmm_blocked_pallas`` and ``_v2``),
  :func:`edge_softmax_blocked` (B6), :func:`attend_blocked` (B5, scale, B6,
  B8), :func:`attend_blocked_fused` (B10) and :func:`attend_blocked_flash`
  (B4, both stat modes);
* the multi-head GAT's two other routes, kernels in
  ``csrc/gat_blocked.cu``: :func:`edge_softmax_blocked_multihead` (B7),
  :func:`spmm_blocked_multiweighted` (B8, at H=1 also the attend routes'
  last step), :func:`gat_attend_blocked` (logits, B7, B8; on the card B7
  computes the logits itself) and :func:`gat_attend_blocked_flash` (B9, a
  per-row running max);
* the helpers ``_pad_dst``, :func:`blocked_dst_rows` and
  :func:`gat_edge_logits_blocked`.

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


def _self_logits(b: BlockedCsr, asrc: torch.Tensor, ad: torch.Tensor,
                 negative_slope: float) -> torch.Tensor:
    """(B*W, H) float32 self-loop logits ``leaky_relu(alpha_src[i] +
    alpha_dst[i])`` of the rows ``i < min(N, num_rows)``, -inf past them
    (``ad``: alpha_dst padded to the block grid)."""
    R = min(asrc.shape[0], b.num_rows)
    s = ad.new_full(ad.shape, float("-inf"))
    s[:R] = nnf.leaky_relu(asrc[:R] + ad[:R], negative_slope)
    return s


def gat_attend_blocked_packed(b: BlockedCsr, h: torch.Tensor,
                              alpha_src: Optional[torch.Tensor],
                              alpha_dst: torch.Tensor, *,
                              negative_slope: float = 0.2,
                              compute_dtype=torch.bfloat16,
                              alpha_src_vec: Optional[torch.Tensor] = None,
                              self_loops: bool = False) -> torch.Tensor:
    """Plain version of B3: multi-head GATv1 aggregation on the blocked
    layout.

    ``h``: (N, H, D); ``alpha_dst``: (N, H); exactly one of ``alpha_src``
    (N, H) and ``alpha_src_vec`` (H, D, the GATv1 projection, so that
    ``alpha_src[i, h] = sum_d h[i, h, d] * vec[h, d]``).  Per dst row and
    head: ``softmax(leaky_relu(alpha_src[src] + alpha_dst[dst]))``-weighted
    sum of ``h[src]``.  Returns (num_rows, H, D) float32; rows with no
    edges are 0.

    ``self_loops``: each row ``i < min(N, num_rows)`` takes one more term,
    its own row ``h[i]`` under the logit ``leaky_relu(alpha_src[i] +
    alpha_dst[i])``, and a lane whose source is its row weighs nothing
    (PyG's ``GATConv`` removes a graph's self loops, then adds one per
    node), so a layout may hold the graph's own.  The self logits join each
    block's max and the term ``e_i h[i]`` is float32, unrounded, so a row
    with no other edges reads ``h[i]`` in the compute dtype.  The JAX
    kernel has no such mode.

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
    s_self = _self_logits(b, asrc, ad, negative_slope) if self_loops else None
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
        if s_self is not None:                   # the layout's own loops
            valid = valid & (src != rows)[..., None]
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
        if s_self is not None:
            ss = s_self[b0 * W:b1 * W].reshape(b1 - b0, W, H)
            m = torch.maximum(m, ss.amax(dim=1))
        r = torch.where(torch.isfinite(M), torch.exp(M - m[bl]), 0.0)
        acc = part.new_zeros((b1 - b0, W, H, D)).index_add_(
            0, bl, part.reshape(-1, W, H, D) * r[:, None, :, None])
        z = zc.new_zeros((b1 - b0, W, H)).index_add_(0, bl, zc * r[:, None])
        if s_self is not None:
            es = torch.where(torch.isfinite(ss), torch.exp(ss - m[:, None]),
                             0.0)                            # (nb, W, H)
            own = hc[b0 * W:min(b1 * W, N)].float()
            rows = own.new_zeros(((b1 - b0) * W, H * D))
            rows[: own.shape[0]] = own
            acc = acc + es[..., None] * rows.reshape(-1, W, H, D)
            z = z + es
        zc_ = z[..., None]
        out[b0 * W:b1 * W] = torch.where(
            zc_ > 0, acc / zc_.clamp(min=1e-20), 0.0).reshape(-1, H, D)
    return out[: b.num_rows]


def _gat_cuda(b: BlockedCsr, hc: torch.Tensor, H: int, D: int,
              asrc: torch.Tensor, vec: Optional[torch.Tensor],
              ad: torch.Tensor, *, flash: bool, round_alpha: bool,
              negative_slope: float, debug_stats: bool = False,
              self_rows: int = 0):
    """B3 (``flash=False``) or B9 through ``csrc/gat_blocked.cu`` on the
    compute-dtype rows ``hc`` (N, H*D).  Two C calls, four kernels: B3's
    projection of ``vec`` into ``asrc`` (vec mode only), a pre-pass over
    each chunk's lanes without row reads (split-piece count, reference
    maxima), then the main kernel (one CUDA block per chunk, all heads) and
    the merge of the split rows (B3 with ``self_rows``: also each row's
    self loop, on the rows below it, and the lanes whose source is their
    row left out of both kernels).  Between the two calls the host reads
    the number of split-row slots to size their scratch (one
    synchronisation).
    Returns ``(out (B*W, H*D), raw or None, m (B*W, H), z (B*W, H),
    slots)``; ``raw``, ``m`` and ``z`` are B9's ``debug_stats``."""
    T, C = b.edge_src.shape
    W, B = b.rows_per_block, b.num_blocks
    BW = B * W
    dev = hc.device
    _check_layout(b, dev)
    _check(b.chunk_block, "chunk_block", torch.int32, (T,), dev)
    f32, i32 = torch.float32, torch.int32
    bf16 = int(hc.dtype == torch.bfloat16)
    split = torch.empty((T,), dtype=i32, device=dev)
    chunk_ref = torch.empty((T, 2 if flash else 1, H), dtype=f32, device=dev)
    chunk_rows = (torch.empty((T, 2), dtype=i32, device=dev) if flash
                  else None)
    row_m = torch.empty((BW, H), dtype=f32, device=dev)
    row_z = torch.empty((BW, H), dtype=f32, device=dev)
    lanes = (b.edge_src.data_ptr(), b.edge_local_row.data_ptr(),
             b.chunk_block.data_ptr())
    rows_ptr = None if chunk_rows is None else chunk_rows.data_ptr()
    _run("gat_blocked", dev, "tgt_gat_count", hc.data_ptr(), bf16,
         int(flash), int(round_alpha), asrc.data_ptr(),
         None if vec is None else vec.data_ptr(), ad.data_ptr(), ad.shape[0],
         *lanes, asrc.shape[0], T, C, W, H, D, float(negative_slope),
         int(self_rows > 0), split.data_ptr(), chunk_ref.data_ptr(), rows_ptr, row_m.data_ptr(),
         row_z.data_ptr())
    slot_off = torch.zeros((T + 1,), dtype=i32, device=dev)
    torch.cumsum(split, 0, out=slot_off[1:])
    S = int(slot_off[-1])
    slot_row = torch.empty((S,), dtype=i32, device=dev)
    slot_m = torch.empty((S, H), dtype=f32, device=dev)
    slot_z = torch.empty((S, H), dtype=f32, device=dev)
    slot_acc = torch.empty((S, H * D), dtype=f32, device=dev)
    out = torch.empty((BW, H * D), dtype=f32, device=dev)
    raw = torch.empty_like(out) if debug_stats else None
    _run("gat_blocked", dev, "tgt_gat_attend", hc.data_ptr(), bf16,
         int(flash), int(round_alpha), asrc.data_ptr(), ad.data_ptr(),
         ad.shape[0], *lanes, b.block_start.data_ptr(), slot_off.data_ptr(),
         chunk_ref.data_ptr(), rows_ptr, T, B, C, W, H, D,
         float(negative_slope), row_m.data_ptr(), row_z.data_ptr(),
         slot_row.data_ptr(), slot_m.data_ptr(), slot_z.data_ptr(),
         slot_acc.data_ptr(), out.data_ptr(),
         None if raw is None else raw.data_ptr(), int(self_rows))
    return out, raw, row_m, row_z, S


def gat_attend_blocked_packed_cuda(b: BlockedCsr, h: torch.Tensor,
                                   alpha_src: Optional[torch.Tensor],
                                   alpha_dst: torch.Tensor, *,
                                   negative_slope: float = 0.2,
                                   compute_dtype=torch.bfloat16,
                                   alpha_src_vec: Optional[torch.Tensor] = None,
                                   self_loops: bool = False) -> torch.Tensor:
    """B3: :func:`gat_attend_blocked_packed` through the hand-written
    Hopper kernels of ``csrc/gat_blocked.cu`` (one CUDA block per chunk for
    all heads, its lanes sorted by row, a warp per piece of at most 32
    lanes of one row reading each source row whole; each lane weighed
    against its chunk's max, taken by a pre-pass; split rows merged against
    the row block's max, and with ``self_loops`` each row's own term folded
    in there) on a CUDA tensor; the plain version on a CPU tensor.  Same
    arguments and result; ``.last_slots`` holds the last call's split-row
    slot count."""
    if h.device.type == "cpu":
        return gat_attend_blocked_packed(
            b, h, alpha_src, alpha_dst, negative_slope=negative_slope,
            compute_dtype=compute_dtype, alpha_src_vec=alpha_src_vec,
            self_loops=self_loops)
    _check_packed_args(b, alpha_src, alpha_src_vec)
    if h.dim() != 3:
        raise ValueError(f"h must be (N, H, D), got {tuple(h.shape)}")
    N, H, D = h.shape
    hc = _compute_rows(h.reshape(N, H * D), compute_dtype, "h")
    dev = hc.device
    ad = alpha_dst.to(torch.float32).contiguous()
    _check(ad, "alpha_dst", torch.float32, (ad.shape[0], H), dev)
    if alpha_src is not None:
        # the table; the kernels round it to the compute dtype
        asrc = alpha_src.to(torch.float32).contiguous()
        _check(asrc, "alpha_src", torch.float32, (N, H), dev)
        vec = None
    else:
        # the projection kernel writes the per-node logits here
        asrc = torch.empty((N, H), dtype=torch.float32, device=dev)
        vec = alpha_src_vec.to(torch.float32).contiguous()
        _check(vec, "alpha_src_vec", torch.float32, (H, D), dev)
    out, _, _, _, S = _gat_cuda(b, hc, H, D, asrc, vec, ad, flash=False,
                                round_alpha=vec is None,
                                negative_slope=negative_slope,
                                self_rows=(min(N, b.num_rows) if self_loops
                                           else 0))
    gat_attend_blocked_packed_cuda.launches += 1
    gat_attend_blocked_packed_cuda.last_slots = S
    return out[: b.num_rows].reshape(-1, H, D)


gat_attend_blocked_packed_cuda.launches = 0
gat_attend_blocked_packed_cuda.last_slots = 0   # of the last call


# ---------------------------------------------------------------------------
# Single-head dot-product attention: B5, B6, B2, B10 and B4
# ---------------------------------------------------------------------------

def _attend_scale(F: int, scale: Optional[float]) -> float:
    return float(scale if scale is not None else 1.0 / (F ** 0.5))


def _lane_rows(b: BlockedCsr, t0: int, t1: int):
    """Local row, validity and global dst row (pad lanes clamped into their
    block) of the lanes of chunks ``[t0, t1)``."""
    W = b.rows_per_block
    lr = b.edge_local_row[t0:t1]
    rows = b.chunk_block[t0:t1, None].long() * W + lr.clamp(max=W - 1).long()
    return lr, lr < W, rows


def _scores(b: BlockedCsr, xd: torch.Tensor, xs: torch.Tensor, t0: int,
            t1: int) -> torch.Tensor:
    """``<xd[dst(e)], xs[src(e)]>`` of the lanes of chunks ``[t0, t1)`` in
    float32 from the compute-dtype rows; 0 on pad lanes and where the dst
    row is past ``xd``'s rows (the JAX package's zero padding)."""
    _, valid, rows = _lane_rows(b, t0, t1)
    nd = xd.shape[0]
    d = xd[rows.clamp(max=max(nd - 1, 0))].float()
    g = xs[b.edge_src[t0:t1].long()].float()
    return torch.where(valid & (rows < nd), (d * g).sum(-1), 0.0)


def _contract(b: BlockedCsr, b0: int, b1: int, t0: int, t1: int,
              rhs: torch.Tensor) -> torch.Tensor:
    """Per-row sum of the lane terms ``rhs`` (Tg, C, F) float32 of blocks
    ``[b0, b1)`` (chunks ``[t0, t1)``): a one-hot contraction per chunk,
    added per block.  Returns ((b1 - b0) * W, F)."""
    W = b.rows_per_block
    F = rhs.shape[-1]
    lr = b.edge_local_row[t0:t1]
    iota = torch.arange(W, device=lr.device, dtype=lr.dtype)
    oh = (lr[:, None, :] == iota[None, :, None]).float()       # (Tg, W, C)
    part = torch.bmm(oh, rhs)                                   # (Tg, W, F)
    bl = b.chunk_block[t0:t1].long() - b0
    return part.new_zeros((b1 - b0, W, F)).index_add_(0, bl, part).reshape(
        -1, F)


def _groups(b: BlockedCsr):
    """``(b0, b1, t0, t1)`` block groups of about ``PLAIN_GROUP_LANES``
    lanes."""
    bs = b.block_start.tolist()
    C = b.edge_src.shape[1]
    return [(b0, b1, bs[b0], bs[b1])
            for b0, b1 in _block_groups(bs, max(1, PLAIN_GROUP_LANES // C))]


def sddmm_blocked(b: BlockedCsr, x_dst: torch.Tensor, x_src: torch.Tensor,
                  *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of B5: the per-lane scores
    ``s[e] = <x_dst[dst(e)], x_src[src(e)]>`` in the blocked layout.

    Returns (T, C) float32, exactly 0 on pad lanes.  The rows are rounded
    to ``compute_dtype`` and every sum is float32 (the JAX kernels'
    ``preferred_element_type=f32`` dot); ``x_dst`` rows past its end read as
    zeros.  The function of both ``sddmm_blocked_pallas`` and
    ``sddmm_blocked_pallas_v2``."""
    T, C = b.edge_src.shape
    xs, xd = x_src.to(compute_dtype), x_dst.to(compute_dtype)
    out = torch.empty((T, C), dtype=torch.float32, device=x_src.device)
    for _, _, t0, t1 in _groups(b):
        out[t0:t1] = _scores(b, xd, xs, t0, t1)
    return out


def edge_softmax_blocked(b: BlockedCsr, scores: torch.Tensor) -> torch.Tensor:
    """Plain version of B6: the per-dst-row softmax of (T, C) scores.

    Values on pad lanes are ignored, even NaN.  Returns (T, C) float32
    weights that sum to 1 over each row's valid lanes; 0 on pad lanes and
    wherever the row's max is not finite or its sum not positive.  The row
    stats are taken in two sweeps (max, then the exp-sum); the JAX kernel's
    online recurrence gives the same function up to float32 rounding."""
    W = b.rows_per_block
    inf = float("inf")
    out = torch.empty(b.edge_src.shape, dtype=torch.float32,
                      device=scores.device)
    for b0, b1, t0, t1 in _groups(b):
        _, valid, rows = _lane_rows(b, t0, t1)
        rows = rows - b0 * W
        s = torch.where(valid, scores[t0:t1].float(), -inf)
        m = s.new_full(((b1 - b0) * W,), -inf).scatter_reduce(
            0, rows.reshape(-1), s.reshape(-1), "amax")
        mr = m[rows]
        ok = valid & torch.isfinite(mr)
        e = torch.where(ok, torch.exp(s - torch.where(ok, mr, 0.0)), 0.0)
        z = torch.zeros_like(m).index_add_(0, rows.reshape(-1), e.reshape(-1))
        zr = z[rows]
        out[t0:t1] = torch.where(ok & (zr > 0), e / zr.clamp(min=1e-38), 0.0)
    return out


def edge_softmax_blocked_multihead(b: BlockedCsr,
                                   scores: torch.Tensor) -> torch.Tensor:
    """Plain version of B7: the per-dst-row softmax of (H, T, C) scores,
    each head as :func:`edge_softmax_blocked` (the JAX kernel's one online
    traversal for all heads gives the same function up to float32
    rounding).  Returns (H, T, C) float32, 0 on pad lanes."""
    return torch.stack([edge_softmax_blocked(b, s) for s in scores])


def spmm_blocked_multiweighted(b: BlockedCsr, x: torch.Tensor,
                               edge_weight: torch.Tensor, *,
                               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of B8: the H-head weighted SpMM.  ``x``: (N, H*D)
    head-concatenated rows; ``edge_weight``: (H, T, C).  Column ``c`` of row
    ``i`` is ``sum_e w[c // D, e] x[src(e), c]`` with each term rounded to
    ``compute_dtype``, ``bf16(x * w)``, and float32 sums, as the JAX kernel
    computes it.  Pad lanes are excluded.  Returns (num_rows, H*D)
    float32."""
    W = b.rows_per_block
    H, F = edge_weight.shape[0], x.shape[-1]
    if F % H:
        raise ValueError(f"x has {F} columns, not a multiple of {H} heads")
    xc = x.to(compute_dtype)
    out = torch.empty((b.num_blocks * W, F), dtype=torch.float32,
                      device=x.device)
    for b0, b1, t0, t1 in _groups(b):
        w = torch.where(b.edge_local_row[t0:t1] < W,
                        edge_weight[:, t0:t1].float(), 0.0)     # (H, Tg, C)
        w = w.permute(1, 2, 0).repeat_interleave(F // H, dim=-1)
        rhs = (xc[b.edge_src[t0:t1].long()].float() * w).to(
            compute_dtype).float()
        out[b0 * W:b1 * W] = _contract(b, b0, b1, t0, t1, rhs)
    return out[: b.num_rows]


def attend_blocked(b: BlockedCsr, x_dst: torch.Tensor, x_src: torch.Tensor,
                   *, scale: Optional[float] = None,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """softmax(<x_dst, x_src> * scale)-weighted neighbour aggregation
    (transformer-style graph attention, single head), composed as the JAX
    package composes it: scores (B5), ``s * scale`` in float32 (default
    ``1/sqrt(F)``), edge softmax (B6), weighted SpMM with ``bf16(x * w)``
    terms (the JAX B2; here one head of B8).  Plain version; returns
    (num_rows, F) float32."""
    s = sddmm_blocked(b, x_dst, x_src, compute_dtype=compute_dtype)
    s = s * _attend_scale(x_src.shape[-1], scale)
    att = edge_softmax_blocked(b, s)
    return spmm_blocked_multiweighted(b, x_src, att[None],
                                      compute_dtype=compute_dtype)


def attend_blocked_fused(b: BlockedCsr, x_dst: torch.Tensor,
                         x_src: torch.Tensor, *,
                         scale: Optional[float] = None,
                         compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of B10: :func:`attend_blocked` with the scale folded
    into ``x_dst`` before its rounding to ``compute_dtype`` (pass A: scaled
    scores and row stats; pass B: each lane's weight ``exp(s - m) / z`` and
    the ``bf16(x * w)`` sum).  In bfloat16 it therefore differs from
    :func:`attend_blocked` by rounding.  Returns (num_rows, F) float32."""
    sc = _attend_scale(x_src.shape[-1], scale)
    xd = (x_dst * sc).to(compute_dtype)
    s = sddmm_blocked(b, xd, x_src, compute_dtype=compute_dtype)
    att = edge_softmax_blocked(b, s)
    return spmm_blocked_multiweighted(b, x_src, att[None],
                                      compute_dtype=compute_dtype)


def attend_blocked_flash(b: BlockedCsr, x_dst: torch.Tensor,
                         x_src: torch.Tensor, *,
                         scale: Optional[float] = None,
                         compute_dtype=torch.bfloat16,
                         row_stats: bool = True) -> torch.Tensor:
    """Plain version of B4: the attention of :func:`attend_blocked_fused`
    in one traversal of each block's chunks, with a rescaled output
    accumulator, then ``out / z`` where ``z > 0`` (0 elsewhere).

    The recurrence is the JAX kernels', chunk by chunk in block order:
    ``row_stats=True`` keeps a running max per row and weighs each lane by
    ``e = exp(s - m_running)``; ``row_stats=False`` weighs every lane of a
    chunk by ``exp(s - M)`` with ``M`` the chunk's max over its valid lanes
    (0 for a chunk of pads only) and combines chunks with ``exp(M - m)``
    factors, so a row ~87 below its chunk's max underflows to 0.  The
    weight is rounded to ``compute_dtype`` before it multiplies the row
    (``bf16(e) * x``); ``z`` sums the float32 ``e``.  Blocks are processed
    in groups, their k-th chunks together.  Returns (num_rows, F)
    float32."""
    W = b.rows_per_block
    F = x_src.shape[-1]
    cd = compute_dtype
    inf = float("inf")
    xs = x_src.to(cd)
    xd = (x_dst * _attend_scale(F, scale)).to(cd)
    dev = x_src.device
    iota = torch.arange(W, device=dev, dtype=torch.int32)
    out = torch.empty((b.num_blocks * W, F), dtype=torch.float32, device=dev)
    for b0, b1, t0, t1 in _groups(b):
        s = _scores(b, xd, xs, t0, t1)                          # (Tg, C)
        lr = b.edge_local_row[t0:t1]
        src = b.edge_src[t0:t1].long()
        first = b.block_start[b0:b1].long() - t0
        count = b.block_start[b0 + 1:b1 + 1].long() - b.block_start[b0:b1]
        acc = torch.zeros((b1 - b0, W, F), dtype=torch.float32, device=dev)
        m = torch.full((b1 - b0, W), -inf, device=dev)
        z = torch.zeros((b1 - b0, W), device=dev)
        for k in range(int(count.max())):
            sel = torch.nonzero(count > k).squeeze(1)           # blocks
            t = first[sel] + k                                  # their chunk
            ss, ll = s[t], lr[t]
            valid = ll < W
            oh = ll[:, None, :] == iota[None, :, None]          # (n, W, C)
            m_old = m[sel]
            if row_stats:
                m_c = torch.where(oh, ss[:, None, :], -inf).amax(-1)
                m_new = torch.maximum(m_old, m_c)
                m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
                m_e = m_safe.gather(1, ll.clamp(max=W - 1).long())
                e = torch.where(valid, torch.exp(ss - m_e), 0.0)
                r_old = torch.where(torch.isfinite(m_old),
                                    torch.exp(m_old - m_safe), 0.0)
                r_c = torch.ones_like(r_old)
            else:
                M = torch.where(valid, ss, -inf).amax(-1)
                M = torch.where(torch.isfinite(M), M, 0.0)
                e = torch.where(valid, torch.exp(ss - M[:, None]), 0.0)
                m_new = torch.maximum(m_old, M[:, None])
                r_old = torch.exp(m_old - m_new)
                r_c = torch.exp(M[:, None] - m_new)
            ohw = torch.where(oh, e.to(cd).float()[:, None, :], 0.0)
            part = torch.bmm(ohw, xs[src[t]].float())           # (n, W, F)
            z_c = torch.where(oh, e[:, None, :], 0.0).sum(-1)   # (n, W)
            acc[sel] = acc[sel] * r_old[..., None] + part * r_c[..., None]
            z[sel] = z[sel] * r_old + z_c * r_c
            m[sel] = m_new
        zc = z[..., None]
        out[b0 * W:b1 * W] = torch.where(
            zc > 0, acc / zc.clamp(min=1e-20), 0.0).reshape(-1, F)
    return out[: b.num_rows]


# ---- kernel wrappers (csrc/attend_blocked.cu) -----------------------------

def _check_layout(b: BlockedCsr, dev: torch.device) -> None:
    T, C = b.edge_src.shape
    _check(b.edge_src, "edge_src", torch.int32, (T, C), dev)
    _check(b.edge_local_row, "edge_local_row", torch.int32, (T, C), dev)
    _check(b.block_start, "block_start", torch.int32, (b.num_blocks + 1,),
           dev)


def _compute_rows(x: torch.Tensor, compute_dtype,
                  name: str = "x") -> torch.Tensor:
    """``x`` as contiguous compute-dtype rows on a CUDA device (the kernels
    pick their load width from the rows' address, so any offset will do)."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    xc = x.to(compute_dtype).contiguous()
    if xc.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor for {name}, "
                         f"got {xc.device}")
    return xc


def _attend_operands(b: BlockedCsr, x_dst: torch.Tensor, x_src: torch.Tensor,
                     compute_dtype):
    """``(xd, xs)``: the rows as contiguous compute-dtype CUDA tensors,
    checked with the layout for the kernels of ``csrc/attend_blocked.cu``."""
    if (x_src.dim() != 2 or x_dst.dim() != 2
            or x_dst.shape[1] != x_src.shape[1]):
        raise ValueError(f"x_dst and x_src must be (rows, F) with one F, got "
                         f"{tuple(x_dst.shape)} and {tuple(x_src.shape)}")
    xs = _compute_rows(x_src, compute_dtype, "x_src")
    xd = _compute_rows(x_dst, compute_dtype, "x_dst")
    if xd.device != xs.device:
        raise ValueError(f"x_dst is on {xd.device}, expected {xs.device}")
    _check_layout(b, xs.device)
    return xd, xs


def _run(lib_name: str, dev: torch.device, fn: str, *args) -> None:
    """Call ``fn`` of library ``lib_name`` on ``dev``'s current stream;
    raise on a launch error."""
    lib = _build.load(lib_name)
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(*args,
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.tgt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({rc})")


def sddmm_blocked_cuda(b: BlockedCsr, x_dst: torch.Tensor,
                       x_src: torch.Tensor, *,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """B5: :func:`sddmm_blocked` through the hand-written Hopper kernel
    (one CUDA block per chunk, its lanes sorted by row; a warp scores a
    piece of at most 32 lanes of one row against the destination row held
    in registers) on a CUDA tensor; the plain version on a CPU tensor.
    Same arguments and result."""
    if x_src.device.type == "cpu":
        return sddmm_blocked(b, x_dst, x_src, compute_dtype=compute_dtype)
    xd, xs = _attend_operands(b, x_dst, x_src, compute_dtype)
    T, C = b.edge_src.shape
    _check(b.chunk_block, "chunk_block", torch.int32, (T,), xs.device)
    out = torch.empty((T, C), dtype=torch.float32, device=xs.device)
    _run("attend_blocked", xs.device, "tgt_sddmm_blocked", xd.data_ptr(),
         xd.shape[0], xs.data_ptr(), int(compute_dtype == torch.bfloat16),
         b.edge_src.data_ptr(), b.edge_local_row.data_ptr(),
         b.chunk_block.data_ptr(), T, C, b.rows_per_block, xs.shape[1],
         out.data_ptr())
    sddmm_blocked_cuda.launches += 1
    return out


sddmm_blocked_cuda.launches = 0


def _edge_softmax_launch(b: BlockedCsr, fn: str, dev: torch.device, *args,
                         looped: bool = False) -> torch.Tensor:
    """Launch B6's kernel through entry ``fn`` (``tgt_edge_softmax_blocked``
    or ``tgt_edge_softmax_logits``, its own arguments ``args`` first) with
    the layout and a (T, C) float32 output, which it returns.  ``looped``:
    every row block takes the looped path (the gates hold both paths);
    else the row blocks of at most :func:`edge_softmax_fast_lanes` lanes
    read each lane once.  Counts nothing."""
    T, C = b.edge_src.shape
    _check_layout(b, dev)
    att = torch.empty((T, C), dtype=torch.float32, device=dev)
    _run("attend_blocked", dev, fn, *args, b.edge_local_row.data_ptr(),
         b.block_start.data_ptr(), b.num_blocks, C, b.rows_per_block,
         int(looped), att.data_ptr())
    return att


def edge_softmax_fast_lanes() -> int:
    """The most lanes a row block may have for B6's one-read path (the
    kernel's registers hold them); larger blocks loop.  Builds the kernel's
    library if needed."""
    return int(_build.load("attend_blocked").tgt_edge_softmax_fast_lanes())


def edge_softmax_blocked_cuda(b: BlockedCsr,
                              scores: torch.Tensor) -> torch.Tensor:
    """B6: :func:`edge_softmax_blocked` through the hand-written Hopper
    kernel on a CUDA tensor (one CUDA block per row block, its W rows'
    (m, z) in shared memory, each lane's row and score read once, into
    shared memory and registers; larger row blocks loop); the plain
    version on a CPU tensor."""
    if scores.device.type == "cpu":
        return edge_softmax_blocked(b, scores)
    s = scores.to(torch.float32).contiguous()
    _check(s, "scores", torch.float32, tuple(b.edge_src.shape), s.device)
    att = _edge_softmax_launch(b, "tgt_edge_softmax_blocked", s.device,
                               s.data_ptr())
    edge_softmax_blocked_cuda.launches += 1
    return att


edge_softmax_blocked_cuda.launches = 0


def attend_blocked_cuda(b: BlockedCsr, x_dst: torch.Tensor,
                        x_src: torch.Tensor, *,
                        scale: Optional[float] = None,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`attend_blocked` on a CUDA tensor through B5, the float32
    scale, B6 and B8 with one head (``bf16(x * w)`` terms, as the plain
    version and the JAX Pallas B2 round them), each counting its launch;
    the plain version on a CPU tensor."""
    if x_src.device.type == "cpu":
        return attend_blocked(b, x_dst, x_src, scale=scale,
                              compute_dtype=compute_dtype)
    s = sddmm_blocked_cuda(b, x_dst, x_src, compute_dtype=compute_dtype)
    s = s * _attend_scale(x_src.shape[-1], scale)
    att = edge_softmax_blocked_cuda(b, s)
    return spmm_blocked_multiweighted_cuda(b, x_src, att[None],
                                           compute_dtype=compute_dtype)


def attend_blocked_fused_cuda(b: BlockedCsr, x_dst: torch.Tensor,
                              x_src: torch.Tensor, *,
                              scale: Optional[float] = None,
                              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """B10: :func:`attend_blocked_fused` through the hand-written Hopper
    kernels on a CUDA tensor (one C call: B5's kernel scores the scaled
    ``x_dst`` into a (T, C) scratch, a kernel per row block takes each
    row's (m, z) from it, and B1's row-grouped weighted sum adds
    ``bf16(w * x_src)`` with each lane's weight ``exp(s - m) / z``); the
    plain version on a CPU tensor."""
    if x_src.device.type == "cpu":
        return attend_blocked_fused(b, x_dst, x_src, scale=scale,
                                    compute_dtype=compute_dtype)
    F = x_src.shape[-1]
    xd, xs = _attend_operands(b, x_dst * _attend_scale(F, scale), x_src,
                              compute_dtype)
    T, C = b.edge_src.shape
    BW = b.num_blocks * b.rows_per_block
    dev = xs.device
    _check(b.chunk_block, "chunk_block", torch.int32, (T,), dev)
    s = torch.empty((T, C), dtype=torch.float32, device=dev)
    m = torch.empty((BW,), dtype=torch.float32, device=dev)
    z = torch.empty((BW,), dtype=torch.float32, device=dev)
    out = torch.empty((BW, F), dtype=torch.float32, device=dev)
    _run("attend_blocked", dev, "tgt_attend_fused", xd.data_ptr(),
         xd.shape[0], xs.data_ptr(), int(compute_dtype == torch.bfloat16),
         b.edge_src.data_ptr(), b.edge_local_row.data_ptr(),
         b.chunk_block.data_ptr(), b.block_start.data_ptr(), T,
         b.num_blocks, C, b.rows_per_block, F, s.data_ptr(), m.data_ptr(),
         z.data_ptr(), out.data_ptr())
    attend_blocked_fused_cuda.launches += 1
    return out[: b.num_rows]


attend_blocked_fused_cuda.launches = 0


def attend_blocked_flash_cuda(b: BlockedCsr, x_dst: torch.Tensor,
                              x_src: torch.Tensor, *,
                              scale: Optional[float] = None,
                              compute_dtype=torch.bfloat16,
                              row_stats: bool = True) -> torch.Tensor:
    """B4: :func:`attend_blocked_flash` through the hand-written Hopper
    kernels on a CUDA tensor; the plain version on a CPU tensor.

    Three kernels make one call: a count of each chunk's split pieces, the
    main kernel (one CUDA block per chunk, its lanes sorted by row, an
    online softmax per piece of at most 32 lanes of one row; owned rows
    stored, split rows' partial (m, z, acc) in slots), and the merge of the
    split rows.  Between the first two the host reads the number of slots
    to size their scratch (one synchronisation)."""
    if x_src.device.type == "cpu":
        return attend_blocked_flash(b, x_dst, x_src, scale=scale,
                                    compute_dtype=compute_dtype,
                                    row_stats=row_stats)
    F = x_src.shape[-1]
    xd, xs = _attend_operands(b, x_dst * _attend_scale(F, scale), x_src,
                              compute_dtype)
    T, C = b.edge_src.shape
    W = b.rows_per_block
    BW = b.num_blocks * W
    dev = xs.device
    _check(b.chunk_block, "chunk_block", torch.int32, (T,), dev)
    split = torch.empty((T,), dtype=torch.int32, device=dev)
    row_m = torch.empty((BW,), dtype=torch.float32, device=dev)
    row_z = torch.empty((BW,), dtype=torch.float32, device=dev)
    _run("attend_blocked", dev, "tgt_attend_flash_count",
         b.edge_local_row.data_ptr(), b.chunk_block.data_ptr(), T, C, W,
         split.data_ptr(), row_m.data_ptr(), row_z.data_ptr())
    slot_off = torch.zeros((T + 1,), dtype=torch.int32, device=dev)
    torch.cumsum(split, 0, out=slot_off[1:])
    S = int(slot_off[-1])
    slot_row = torch.empty((S,), dtype=torch.int32, device=dev)
    slot_m = torch.empty((S,), dtype=torch.float32, device=dev)
    slot_z = torch.empty((S,), dtype=torch.float32, device=dev)
    slot_acc = torch.empty((S, F), dtype=torch.float32, device=dev)
    out = torch.empty((BW, F), dtype=torch.float32, device=dev)
    _run("attend_blocked", dev, "tgt_attend_flash", xd.data_ptr(),
         xd.shape[0], xs.data_ptr(), int(compute_dtype == torch.bfloat16),
         int(bool(row_stats)), b.edge_src.data_ptr(),
         b.edge_local_row.data_ptr(), b.chunk_block.data_ptr(),
         b.block_start.data_ptr(), slot_off.data_ptr(), T, b.num_blocks, C,
         W, F, row_m.data_ptr(), row_z.data_ptr(), slot_row.data_ptr(),
         slot_m.data_ptr(), slot_z.data_ptr(), slot_acc.data_ptr(),
         out.data_ptr())
    attend_blocked_flash_cuda.launches += 1
    attend_blocked_flash_cuda.last_slots = S
    return out[: b.num_rows]


attend_blocked_flash_cuda.launches = 0
attend_blocked_flash_cuda.last_slots = 0   # split-row slots of the last call


# ---------------------------------------------------------------------------
# Multi-head GAT, composed (B7, B8) and flash (B9)
# ---------------------------------------------------------------------------

def gat_attend_blocked(b: BlockedCsr, h: torch.Tensor, alpha_src: torch.Tensor,
                       alpha_dst: torch.Tensor, *,
                       negative_slope: float = 0.2,
                       compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Multi-head GAT aggregation on the blocked layout, composed as the JAX
    package composes it: (H, T, C) float32 logits
    ``leaky_relu(alpha_src[src] + alpha_dst[dst])`` by gathers, the
    multi-head edge softmax (B7), the multi-weighted SpMM with
    ``bf16(h * w)`` terms (B8).  ``h``: (N, H, D); ``alpha_src``,
    ``alpha_dst``: (N, H).  Plain version; returns (num_rows, H, D)
    float32."""
    N, H, D = h.shape
    logits = gat_edge_logits_blocked(b, alpha_src, alpha_dst,
                                     negative_slope=negative_slope)
    att = edge_softmax_blocked_multihead(b, logits.movedim(-1, 0))
    out = spmm_blocked_multiweighted(b, h.reshape(N, H * D), att,
                                     compute_dtype=compute_dtype)
    return out.reshape(-1, H, D)


def gat_attend_blocked_flash(b: BlockedCsr, h: torch.Tensor,
                             alpha_src: torch.Tensor, alpha_dst: torch.Tensor,
                             *, negative_slope: float = 0.2,
                             compute_dtype=torch.bfloat16,
                             debug_stats: bool = False):
    """Plain version of B9: :func:`gat_attend_blocked` in one traversal of
    each block's chunks, with the JAX kernel's recurrence, chunk by chunk in
    block order: per row and head a running max ``m`` (updated by the
    chunk's max logit), each lane weighed by ``e = exp(s - m)``, the
    accumulator and ``z`` rescaled by ``exp(m_old - m)``; then ``out / z``
    where ``z > 0`` (0 elsewhere).

    The logit adds ``alpha_src[src]`` rounded to ``compute_dtype`` (it rides
    the JAX kernel's row gather) to the float32 ``alpha_dst[dst]`` (0 past
    its rows); the weight is rounded to ``compute_dtype`` before it
    multiplies the row (``bf16(e) * h``, exact in float32) and ``z`` sums
    the float32 ``e``.  Returns (num_rows, H, D) float32; with
    ``debug_stats`` also the undivided (B*W, H*D) accumulator and the
    (B*W, H) ``m`` and ``z``, as the JAX function does."""
    N, H, D = h.shape
    W = b.rows_per_block
    cd = compute_dtype
    inf = float("inf")
    hc = h.to(cd)
    asrc = alpha_src.to(cd).float()
    ad = _pad_dst(b, alpha_dst.float())                    # (B*W, H)
    dev = h.device
    BW = b.num_blocks * W
    acc_all = torch.empty((BW, H, D), dtype=torch.float32, device=dev)
    m_all = torch.empty((BW, H), dtype=torch.float32, device=dev)
    z_all = torch.empty((BW, H), dtype=torch.float32, device=dev)
    for b0, b1, t0, t1 in _groups(b):
        lr, valid, rows = _lane_rows(b, t0, t1)
        src = b.edge_src[t0:t1].long()
        s = nnf.leaky_relu(asrc[src] + ad[rows], negative_slope)  # (Tg, C, H)
        first = b.block_start[b0:b1].long() - t0
        count = b.block_start[b0 + 1:b1 + 1].long() - b.block_start[b0:b1]
        nw = (b1 - b0) * W
        acc = torch.zeros((nw, H, D), dtype=torch.float32, device=dev)
        m = torch.full((nw, H), -inf, device=dev)
        z = torch.zeros((nw, H), device=dev)
        for k in range(int(count.max())):
            sel = torch.nonzero(count > k).squeeze(1)           # blocks
            t = first[sel] + k                                  # their chunk
            ok = valid[t]
            # each valid lane's row within the group
            idx = (sel[:, None] * W + lr[t].clamp(max=W - 1).long())[ok]
            ss = s[t][ok]                                       # (L, H)
            m_c = torch.full_like(m, -inf).scatter_reduce(
                0, idx[:, None].expand_as(ss), ss, "amax")
            m_new = torch.maximum(m, m_c)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            r_old = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            e = torch.exp(ss - m_safe[idx])                     # (L, H)
            term = e.to(cd).float()[..., None] * hc[src[t][ok]].float()
            acc = acc * r_old[..., None] + torch.zeros_like(acc).index_add_(
                0, idx, term)
            z = z * r_old + torch.zeros_like(z).index_add_(0, idx, e)
            m = m_new
        acc_all[b0 * W:b1 * W] = acc
        m_all[b0 * W:b1 * W] = m
        z_all[b0 * W:b1 * W] = z
    zc = z_all[..., None]
    att = torch.where(zc > 0, acc_all / zc.clamp(min=1e-20), 0.0)
    if debug_stats:
        return att[: b.num_rows], acc_all.reshape(BW, H * D), m_all, z_all
    return att[: b.num_rows]


# ---- kernel wrappers (csrc/gat_blocked.cu) --------------------------------

def _edge_softmax_mh_launch(b: BlockedCsr, fn: str, H: int,
                            dev: torch.device, *args) -> torch.Tensor:
    """Launch B7's entry ``fn`` (``tgt_edge_softmax_multihead`` or
    ``tgt_gat_edge_softmax``, its own arguments ``args`` first) with the
    layout, the pre-pass's scratch and the (H, T, C) output; counts the
    launch on ``edge_softmax_blocked_multihead_cuda``."""
    T, C = b.edge_src.shape
    _check_layout(b, dev)
    _check(b.chunk_block, "chunk_block", torch.int32, (T,), dev)
    chunk_rows = torch.empty((T, 2), dtype=torch.int32, device=dev)
    chunk_mz = torch.empty((T, 2, H, 2), dtype=torch.float32, device=dev)
    att = torch.empty((H, T, C), dtype=torch.float32, device=dev)
    _run("gat_blocked", dev, fn, *args, b.edge_local_row.data_ptr(),
         b.chunk_block.data_ptr(), b.block_start.data_ptr(), T, C,
         b.rows_per_block, H, chunk_rows.data_ptr(), chunk_mz.data_ptr(),
         att.data_ptr())
    edge_softmax_blocked_multihead_cuda.launches += 1
    return att


def edge_softmax_blocked_multihead_cuda(b: BlockedCsr,
                                        scores: torch.Tensor) -> torch.Tensor:
    """B7: :func:`edge_softmax_blocked_multihead` through the hand-written
    Hopper kernels on a CUDA tensor; the plain version on a CPU tensor.

    Two kernels make a call: a pre-pass per chunk takes the statistics
    (max, sum) of the chunk's lowest and highest row, the only rows that
    can span chunks; the main kernel (B1's row-grouped chunks: one CUDA
    block per chunk, its lanes sorted by row, a thread per piece of at most
    32 lanes of one row) reduces each piece's statistics in registers,
    merges a row's pieces and writes every lane's weight in lane order.
    One head takes B6's kernel instead (:func:`edge_softmax_blocked_cuda`),
    counted here."""
    if scores.device.type == "cpu":
        return edge_softmax_blocked_multihead(b, scores)
    s = scores.to(torch.float32).contiguous()
    dev = s.device
    T, C = b.edge_src.shape
    H = s.shape[0]
    _check(s, "scores", torch.float32, (H, T, C), dev)
    if H == 1:
        # one head: B6's kernel, faster there than these two (PERF.md)
        att = _edge_softmax_launch(b, "tgt_edge_softmax_blocked", dev,
                                   s.data_ptr())
        edge_softmax_blocked_multihead_cuda.launches += 1
        return att[None]
    return _edge_softmax_mh_launch(b, "tgt_edge_softmax_multihead", H, dev,
                                   s.data_ptr())


edge_softmax_blocked_multihead_cuda.launches = 0


def _gat_edge_softmax_blocked_cuda(b: BlockedCsr, alpha_src: torch.Tensor,
                                   alpha_dst: torch.Tensor, *,
                                   negative_slope: float = 0.2
                                   ) -> torch.Tensor:
    """B7 on the GAT logits of :func:`gat_edge_logits_blocked`: the
    (H, T, C) weights ``edge_softmax_blocked_multihead(b,
    gat_edge_logits_blocked(b, alpha_src, alpha_dst).movedim(-1, 0))``
    (the plain version, taken on a CPU tensor), with the logits computed
    in B7's kernels from the (N, H) tables on a CUDA tensor (bit for bit
    the plain version's) and never stored; one head takes B6's kernel with
    the same logits.  Counts its launch on
    ``edge_softmax_blocked_multihead_cuda``."""
    if alpha_src.device.type == "cpu":
        logits = gat_edge_logits_blocked(b, alpha_src, alpha_dst,
                                         negative_slope=negative_slope)
        return edge_softmax_blocked_multihead(b, logits.movedim(-1, 0))
    asrc = alpha_src.to(torch.float32).contiguous()
    ad = alpha_dst.to(torch.float32).contiguous()
    dev = asrc.device
    if asrc.dim() != 2 or ad.dim() != 2 or ad.shape[0] == 0:
        raise ValueError(f"alpha_src and alpha_dst must be (rows, H) tables, "
                         f"got {tuple(asrc.shape)} and {tuple(ad.shape)}")
    H = asrc.shape[1]
    _check(ad, "alpha_dst", torch.float32, (ad.shape[0], H), dev)
    if H == 1:
        # one head: B6's kernel computing the same logits (PERF.md)
        att = _edge_softmax_launch(
            b, "tgt_edge_softmax_logits", dev, asrc.data_ptr(),
            ad.data_ptr(), ad.shape[0], float(negative_slope),
            b.edge_src.data_ptr())
        edge_softmax_blocked_multihead_cuda.launches += 1
        return att[None]
    return _edge_softmax_mh_launch(
        b, "tgt_gat_edge_softmax", H, dev, asrc.data_ptr(), ad.data_ptr(),
        ad.shape[0], float(negative_slope), b.edge_src.data_ptr())


def spmm_blocked_multiweighted_cuda(b: BlockedCsr, x: torch.Tensor,
                                    edge_weight: torch.Tensor, *,
                                    compute_dtype=torch.bfloat16
                                    ) -> torch.Tensor:
    """B8: :func:`spmm_blocked_multiweighted` through the hand-written
    Hopper kernel (B1's row-grouped chunks: one CUDA block per chunk, its
    lanes sorted by row, a warp per piece of at most 32 lanes of one row,
    each column weighted by its head's lane weight, terms rounded
    ``bf16(x * w)``) on a CUDA tensor; the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return spmm_blocked_multiweighted(b, x, edge_weight,
                                          compute_dtype=compute_dtype)
    xc = _compute_rows(x, compute_dtype)
    dev = xc.device
    T, C = b.edge_src.shape
    H = edge_weight.shape[0]
    F = xc.shape[-1]
    if xc.dim() != 2 or F % H:
        raise ValueError(f"x must be (N, H*D) with H={H}, got "
                         f"{tuple(xc.shape)}")
    w = edge_weight.to(torch.float32).contiguous()
    _check(w, "edge_weight", torch.float32, (H, T, C), dev)
    _check_layout(b, dev)
    _check(b.chunk_block, "chunk_block", torch.int32, (T,), dev)
    out = torch.empty((b.num_blocks * b.rows_per_block, F),
                      dtype=torch.float32, device=dev)
    _run("gat_blocked", dev, "tgt_spmm_multiweighted", xc.data_ptr(),
         int(compute_dtype == torch.bfloat16), b.edge_src.data_ptr(),
         b.edge_local_row.data_ptr(), w.data_ptr(), b.chunk_block.data_ptr(),
         b.block_start.data_ptr(), T, b.num_blocks, C, b.rows_per_block, F,
         F // H, out.data_ptr())
    spmm_blocked_multiweighted_cuda.launches += 1
    return out[: b.num_rows]


spmm_blocked_multiweighted_cuda.launches = 0


def gat_attend_blocked_cuda(b: BlockedCsr, h: torch.Tensor,
                            alpha_src: torch.Tensor, alpha_dst: torch.Tensor,
                            *, negative_slope: float = 0.2,
                            compute_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`gat_attend_blocked` on a CUDA tensor: B7 with the logits
    folded in (computed in its kernels from the (N, H) tables, where the
    JAX package gathers them with XLA), then B8, each counting its launch;
    the plain version on a CPU tensor."""
    if h.device.type == "cpu":
        return gat_attend_blocked(b, h, alpha_src, alpha_dst,
                                  negative_slope=negative_slope,
                                  compute_dtype=compute_dtype)
    N, H, D = h.shape
    att = _gat_edge_softmax_blocked_cuda(b, alpha_src, alpha_dst,
                                         negative_slope=negative_slope)
    out = spmm_blocked_multiweighted_cuda(b, h.reshape(N, H * D), att,
                                          compute_dtype=compute_dtype)
    return out.reshape(-1, H, D)


def gat_attend_blocked_flash_cuda(b: BlockedCsr, h: torch.Tensor,
                                  alpha_src: torch.Tensor,
                                  alpha_dst: torch.Tensor, *,
                                  negative_slope: float = 0.2,
                                  compute_dtype=torch.bfloat16,
                                  debug_stats: bool = False):
    """B9: :func:`gat_attend_blocked_flash` through the hand-written Hopper
    kernels of ``csrc/gat_blocked.cu`` (B3's, with each lane weighed
    against its row's running max after its chunk, as the plain version
    rounds it: a pre-pass takes the max of each chunk's first and last
    row, the only rows that span chunks; split rows merged against the
    row's final max) on a CUDA tensor; the plain version on a CPU tensor.
    Same arguments and results; ``.last_slots`` holds the last call's
    split-row slot count."""
    if h.device.type == "cpu":
        return gat_attend_blocked_flash(
            b, h, alpha_src, alpha_dst, negative_slope=negative_slope,
            compute_dtype=compute_dtype, debug_stats=debug_stats)
    if h.dim() != 3:
        raise ValueError(f"h must be (N, H, D), got {tuple(h.shape)}")
    N, H, D = h.shape
    if D > 128:
        raise ValueError(f"the GAT flash kernel takes at most 128 columns "
                         f"per head, got D={D}")
    hc = _compute_rows(h.reshape(N, H * D), compute_dtype, "h")
    dev = hc.device
    asrc = alpha_src.to(torch.float32).contiguous()
    ad = alpha_dst.to(torch.float32).contiguous()
    _check(asrc, "alpha_src", torch.float32, (N, H), dev)
    _check(ad, "alpha_dst", torch.float32, (ad.shape[0], H), dev)
    out, raw, m, z, S = _gat_cuda(b, hc, H, D, asrc, None, ad, flash=True,
                                  round_alpha=True,
                                  negative_slope=negative_slope,
                                  debug_stats=debug_stats)
    gat_attend_blocked_flash_cuda.launches += 1
    gat_attend_blocked_flash_cuda.last_slots = S
    att = out[: b.num_rows].reshape(-1, H, D)
    return (att, raw, m, z) if debug_stats else att


gat_attend_blocked_flash_cuda.launches = 0
gat_attend_blocked_flash_cuda.last_slots = 0    # of the last call
