"""Blocked-ELL layout and the plain blocked SpMM.

Counterpart of ``tch_geometric_tpu/ops/spmm_blocked.py``.  Rows are grouped
into aligned blocks of ``W`` rows; each block's CSR-contiguous edge list is
cut into chunks of ``C`` edge lanes (a heavy block gets several chunks, an
empty block one chunk of pads).  Pad lanes carry ``edge_src = 0`` and
``local_row = W``.  Chunks are ordered by block, so block ``b`` owns chunks
``[block_start[b], block_start[b+1])``.

The layout builders are the JAX package's numpy code, so both packages
consume identical arrays.  :func:`spmm_blocked` is the plain version of the
hand-written kernels B1 and B2 (``ops/spmm_kernels.py``,
``ops/attention_blocked.py``): a one-hot contraction per chunk, then a
cumsum over chunks and a difference at block boundaries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch


@dataclass
class BlockedCsr:
    """Chunked blocked-ELL layout of a CSR graph (device tensors).

    Each chunk's live lanes are one contiguous CSR range of its row block
    (in any order within the chunk), so a chunk covers a contiguous range
    of rows and only its first and last row can have lanes in another
    chunk.  The CUDA kernels B1 and B2 rely on it: they store the other
    rows without atomics.  A builder must keep it."""

    edge_src: torch.Tensor                 # (T, C) int32 padded source ids
    edge_local_row: torch.Tensor           # (T, C) int32 row in block, W on pads
    edge_valid: Optional[torch.Tensor]     # (T, C) bool
    chunk_block: torch.Tensor              # (T,) int32 row-block id
    block_start: torch.Tensor              # (B+1,) int32 first chunk per block
    degree: Optional[torch.Tensor]         # (N,) int32 row degrees (mean)
    edge_ptr: Optional[torch.Tensor] = None  # (T, C) int32 CSR edge index
    num_rows: int = 0
    rows_per_block: int = 128
    chunk_edges: int = 2048

    @property
    def num_blocks(self) -> int:
        return self.block_start.shape[0] - 1

    @property
    def num_chunks(self) -> int:
        return self.edge_src.shape[0]


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


def build_blocked(indptr, indices, *, rows_per_block: int = 128,
                  chunk_edges: Optional[int] = None,
                  sort_chunk_sources: bool = True,
                  device="cuda") -> BlockedCsr:
    """Host-side one-time layout build (numpy), moved to ``device``.

    ``chunk_edges=None`` picks the 128-multiple chunk size that minimises
    the total padded lanes; ``sort_chunk_sources`` orders each chunk's
    lanes by source id (the local row follows its edge)."""
    out = _build_blocked_np(indptr, indices, rows_per_block, chunk_edges,
                            sort_chunk_sources)
    return BlockedCsr(
        edge_src=_t(out["edge_src"], device),
        edge_local_row=_t(out["local_row"], device),
        edge_valid=_t(out["valid"], device),
        chunk_block=_t(out["chunk_block"], device),
        block_start=_t(out["block_start"], device),
        degree=_t(out["degree"], device),
        edge_ptr=_t(out["edge_ptr"], device),
        num_rows=out["num_rows"],
        rows_per_block=rows_per_block,
        chunk_edges=out["chunk_edges"],
    )


def _build_blocked_np(indptr, indices, rows_per_block=128, chunk_edges=None,
                      sort_chunk_sources=True) -> dict:
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    N = indptr.shape[0] - 1
    W = rows_per_block
    B = -(-N // W)
    if chunk_edges is None:
        blk_e = np.diff(indptr[np.minimum(np.arange(B + 1) * W, N)])
        mean_blk = float(blk_e.mean()) if B else 256.0
        # candidates: 128-multiples from ~0.5x mean to the max block size
        lo = max(256, int(mean_blk * 0.5) // 128 * 128)
        hi = max(lo + 128, int(blk_e.max()) // 128 * 128 + 128) if B else lo + 128
        cands = np.unique(np.linspace(lo, hi, 64, dtype=np.int64) // 128 * 128)
        totals = [(int(np.sum(-(-blk_e // C1))) * int(C1), int(C1))
                  for C1 in cands]
        chunk_edges = min(totals)[1]
    C = chunk_edges

    deg = np.diff(indptr)
    dst = np.repeat(np.arange(N, dtype=np.int64), deg)
    E = indices.shape[0]

    blk_first_edge = indptr[np.minimum(np.arange(B + 1) * W, N)]
    blk_edges = np.diff(blk_first_edge)
    chunks_per_blk = np.maximum(-(-blk_edges // C), 1)
    T = int(chunks_per_blk.sum())

    chunk_block = np.repeat(np.arange(B, dtype=np.int32), chunks_per_blk)
    block_start = np.concatenate([[0], np.cumsum(chunks_per_blk)]).astype(np.int32)
    chunk_rank = np.arange(T, dtype=np.int64) - block_start[chunk_block]
    chunk_edge0 = blk_first_edge[chunk_block] + chunk_rank * C

    offs = chunk_edge0[:, None] + np.arange(C)[None, :]
    blk_edge_end = blk_first_edge[chunk_block + 1]
    valid = offs < blk_edge_end[:, None]
    offs_c = np.minimum(offs, E - 1) if E > 0 else np.zeros_like(offs)
    edge_src = np.where(valid, indices[offs_c], 0).astype(np.int32)
    if sort_chunk_sources and E > 0:
        # stable per-chunk sort by (valid last, src); local_row follows.  It
        # permutes lanes within a chunk only: each chunk's live lanes stay
        # one contiguous CSR range, which B1 and B2 rely on (BlockedCsr)
        order = np.lexsort((edge_src, ~valid), axis=-1)
        take = np.take_along_axis
        edge_src = take(edge_src, order, axis=1)
        offs_c = take(offs_c, order, axis=1)
        valid = take(valid, order, axis=1)
    # invalid lanes get local_row == W: they never match a row
    local_row = np.where(valid, dst[offs_c] - chunk_block[:, None].astype(np.int64) * W,
                         W).astype(np.int32)

    return dict(
        edge_src=edge_src,
        local_row=local_row,
        valid=valid,
        chunk_block=chunk_block,
        block_start=block_start,
        degree=deg.astype(np.int32),
        edge_ptr=np.where(valid, offs_c, -1).astype(np.int32),
        num_rows=int(N),
        num_blocks=int(B),
        chunk_edges=int(C),
    )


@dataclass
class SegmentedBlockedCsr:
    """Blocked-ELL layout split into S equal block-range segments.

    Segment s owns row blocks ``[s*Bp, (s+1)*Bp)``; per-segment chunk counts
    are padded to the max with pad chunks (``local_row == W``) that no
    block's ``block_start`` range reaches.  The JAX package needs segments
    to bound its gathered (E, F) intermediate; the port's kernels gather
    inside the kernel, and the segmented wrappers loop over segments with
    the same kernels.
    """

    edge_src: torch.Tensor        # (S, Tp, C) int32
    edge_local_row: torch.Tensor  # (S, Tp, C) int32
    chunk_block: torch.Tensor     # (S, Tp) int32 block id local to segment
    block_start: torch.Tensor     # (S, Bp+1) int32 local first chunk
    degree: torch.Tensor          # (N,) int32 global row degrees
    edge_weight: Optional[torch.Tensor] = None  # (S, Tp, C) f32, 0 on pads
    num_rows: int = 0
    rows_per_block: int = 128
    chunk_edges: int = 2048
    blocks_per_segment: int = 0

    @property
    def num_segments(self) -> int:
        return self.edge_src.shape[0]

    def segment(self, s: int) -> Tuple[BlockedCsr, Optional[torch.Tensor]]:
        """Segment ``s`` as a BlockedCsr over its ``Bp*W`` rows, and its
        edge weights."""
        W = self.rows_per_block
        b = BlockedCsr(
            edge_src=self.edge_src[s], edge_local_row=self.edge_local_row[s],
            edge_valid=None, chunk_block=self.chunk_block[s],
            block_start=self.block_start[s], degree=None, edge_ptr=None,
            num_rows=self.blocks_per_segment * W, rows_per_block=W,
            chunk_edges=self.chunk_edges)
        w = None if self.edge_weight is None else self.edge_weight[s]
        return b, w


def build_blocked_segmented(indptr, indices, *, num_segments: int,
                            rows_per_block: int = 128,
                            chunk_edges: Optional[int] = None,
                            sort_chunk_sources: bool = True,
                            edge_attr=None,
                            device="cuda") -> SegmentedBlockedCsr:
    """Host-side build of the segmented layout.  ``edge_attr``: optional
    (E,) per-edge weights in CSR edge order, mapped into the (S, Tp, C)
    layout (0 on pad lanes)."""
    W = rows_per_block
    o = _build_blocked_np(indptr, indices, W, chunk_edges, sort_chunk_sources)
    B, C = o["num_blocks"], o["chunk_edges"]
    S = max(1, min(int(num_segments), B))
    Bp = -(-B // S)
    bs = o["block_start"].astype(np.int64)

    attr_blk = None
    if edge_attr is not None:
        edge_attr = np.asarray(edge_attr, np.float32)
        E = edge_attr.shape[0]
        ep = o["edge_ptr"]
        attr_blk = np.where(ep >= 0,
                            edge_attr[np.clip(ep, 0, max(E - 1, 0))],
                            0.0).astype(np.float32)

    seg_blk0 = np.minimum(np.arange(S + 1) * Bp, B)
    seg_t0 = bs[seg_blk0]
    T_s = np.diff(seg_t0)
    Tp = int(T_s.max()) if S else 1

    es = np.zeros((S, Tp, C), np.int32)
    lr = np.full((S, Tp, C), W, np.int32)
    cb = np.zeros((S, Tp), np.int32)
    bstart = np.zeros((S, Bp + 1), np.int32)
    wt = np.zeros((S, Tp, C), np.float32) if attr_blk is not None else None
    for s in range(S):
        t0, t1 = int(seg_t0[s]), int(seg_t0[s + 1])
        n = t1 - t0
        es[s, :n] = o["edge_src"][t0:t1]
        lr[s, :n] = o["local_row"][t0:t1]
        if wt is not None:
            wt[s, :n] = attr_blk[t0:t1]
        local_cb = o["chunk_block"][t0:t1] - int(seg_blk0[s])
        cb[s, :n] = local_cb
        cb[s, n:] = local_cb[-1] if n else 0
        gb = np.minimum(seg_blk0[s] + np.arange(Bp + 1), seg_blk0[s + 1])
        bstart[s] = (bs[gb] - t0).astype(np.int32)

    return SegmentedBlockedCsr(
        edge_src=_t(es, device),
        edge_local_row=_t(lr, device),
        chunk_block=_t(cb, device),
        block_start=_t(bstart, device),
        degree=_t(o["degree"], device),
        edge_weight=None if wt is None else _t(wt, device),
        num_rows=o["num_rows"],
        rows_per_block=W,
        chunk_edges=C,
        blocks_per_segment=Bp,
    )


def _hot_cold_split(indptr, indices, hot_k: int):
    """Top-``hot_k`` sources by in-multiset frequency become hot; hot edges
    are deduplicated per (dst row, hot source) with their multiplicity.
    Returns ``(N, deg, hot_ids, (cold_indptr, cold_src),
    (hot_indptr, hot_src, counts))``."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    N = indptr.shape[0] - 1
    deg = np.diff(indptr)
    K = int(min(hot_k, N))

    freq = np.bincount(indices, minlength=N)
    hot_ids = np.argsort(-freq, kind="stable")[:K].astype(np.int64)
    hot_slot = np.full((N,), -1, np.int64)
    hot_slot[hot_ids] = np.arange(K)

    dst = np.repeat(np.arange(N, dtype=np.int64), deg)
    is_hot = hot_slot[indices] >= 0

    cold_dst = dst[~is_hot]
    cold_src = indices[~is_hot]
    cold_indptr = np.searchsorted(cold_dst, np.arange(N + 1))

    hkey = dst[is_hot] * K + hot_slot[indices[is_hot]]
    uk, counts = np.unique(hkey, return_counts=True)
    hot_dst = uk // K
    hot_src = (uk % K).astype(np.int64)
    hot_indptr = np.searchsorted(hot_dst, np.arange(N + 1))
    return (N, deg, hot_ids, (cold_indptr, cold_src),
            (hot_indptr, hot_src, counts))


@dataclass
class HotSplitSeg:
    """Segmented hot/cold split (see HotSplitCsr)."""

    cold: SegmentedBlockedCsr
    hot: SegmentedBlockedCsr      # edge_weight carries the multiplicities
    hot_ids: torch.Tensor         # (K,) int64 global ids of hot sources
    degree: torch.Tensor          # (N,) original row degrees
    num_rows: int = 0


def build_blocked_hot_segmented(indptr, indices, *, hot_k: int = 16384,
                                num_segments: int,
                                rows_per_block: int = 128,
                                chunk_edges: Optional[int] = None,
                                device="cuda") -> HotSplitSeg:
    """Segmented twin of :func:`build_blocked_hot`."""
    N, deg, hot_ids, (cip, csrc), (hip, hsrc, counts) = _hot_cold_split(
        indptr, indices, hot_k)
    cold = build_blocked_segmented(cip, csrc, num_segments=num_segments,
                                   rows_per_block=rows_per_block,
                                   chunk_edges=chunk_edges, device=device)
    hot = build_blocked_segmented(hip, hsrc, num_segments=num_segments,
                                  rows_per_block=rows_per_block,
                                  chunk_edges=chunk_edges,
                                  edge_attr=counts.astype(np.float32),
                                  device=device)
    return HotSplitSeg(cold=cold, hot=hot, hot_ids=_t(hot_ids, device),
                       degree=_t(deg, device, torch.int32), num_rows=int(N))


@dataclass
class HotSplitCsr:
    """Hot/cold split of a blocked CSR for power-law graphs.

    Cold edges gather from the full feature table; hot edges (the top
    ``hot_k`` sources) are deduplicated per (dst row, hot source) with the
    multiplicity as an edge weight, and gather from the compact
    ``x[hot_ids]`` table.  Exact for sum/mean aggregation.
    """

    cold: BlockedCsr
    hot: BlockedCsr               # edge_src indexes the hot table [0, K)
    hot_ids: torch.Tensor         # (K,) int64 global ids of hot sources
    hot_count: torch.Tensor       # (Th, Ch) f32 multiplicity per hot lane
    degree: torch.Tensor          # (N,) original row degrees (for mean)
    num_rows: int = 0


def build_blocked_hot(indptr, indices, *, hot_k: int = 16384,
                      rows_per_block: int = 128,
                      chunk_edges: Optional[int] = None,
                      device="cuda") -> HotSplitCsr:
    """Host-side hot/cold split build (numpy), moved to ``device``."""
    N, deg, hot_ids, (cip, csrc), (hip, hsrc, counts) = _hot_cold_split(
        indptr, indices, hot_k)
    cold = build_blocked(cip, csrc, rows_per_block=rows_per_block,
                         chunk_edges=chunk_edges, device=device)
    hot = build_blocked(hip, hsrc, rows_per_block=rows_per_block,
                        chunk_edges=chunk_edges, device=device)
    hot_count = edge_attr_to_blocked(
        hot, _t(counts, device, torch.float32))
    return HotSplitCsr(cold=cold, hot=hot, hot_ids=_t(hot_ids, device),
                       hot_count=hot_count,
                       degree=_t(deg, device, torch.int32), num_rows=int(N))


def edge_attr_to_blocked(b: BlockedCsr, attr: torch.Tensor) -> torch.Tensor:
    """Map CSR-edge-ordered per-edge attributes into the (T, C) blocked
    layout (invalid lanes -> 0).  Inverse of ``b.edge_ptr``."""
    E = attr.shape[0]
    vals = attr[b.edge_ptr.long().clamp(0, max(E - 1, 0))]
    return torch.where(b.edge_valid, vals, torch.zeros((), dtype=attr.dtype,
                                                       device=attr.device))


# Lanes per one-hot contraction group of the plain version: bounds its
# (lanes, F) gather and (lanes, W) one-hot to a few hundred MB at F, W = 256.
PLAIN_GROUP_LANES = 1 << 20


def _block_groups(block_start: List[int], max_chunks: int):
    """Split blocks into consecutive ranges of at most ``max_chunks``
    chunks each (a block with more chunks forms a range alone)."""
    groups, b0 = [], 0
    B = len(block_start) - 1
    for b in range(B):
        if block_start[b + 1] - block_start[b0] > max_chunks and b > b0:
            groups.append((b0, b))
            b0 = b
    if B:
        groups.append((b0, B))
    return groups


def spmm_blocked(b: BlockedCsr, x: torch.Tensor, *, agg: str = "sum",
                 edge_weight: Optional[torch.Tensor] = None,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain blocked SpMM.  x: (N, F) -> (num_rows, F) float32.

    The rows are cast to ``compute_dtype`` (and the weights too), then
    contracted with the one-hot in float32 — the JAX package's
    ``preferred_element_type=f32`` contraction.  Blocks are processed in
    groups of about ``PLAIN_GROUP_LANES`` lanes so a full-size graph fits
    in device memory; each group is one batched one-hot matmul, a cumsum
    over its chunks and a difference at block boundaries.
    """
    W = b.rows_per_block
    T, C = b.edge_src.shape
    F = x.shape[-1]
    xc = x.to(compute_dtype)
    w = None
    if edge_weight is not None:
        w = (torch.where(b.edge_valid, edge_weight, 0.0)
             if b.edge_valid is not None else edge_weight)
        w = w.to(compute_dtype).float()
    iota = torch.arange(W, device=x.device, dtype=torch.int32)
    bs_host = b.block_start.tolist()
    out = torch.empty((b.num_blocks * W, F), dtype=torch.float32,
                      device=x.device)
    for b0, b1 in _block_groups(bs_host, max(1, PLAIN_GROUP_LANES // C)):
        t0, t1 = bs_host[b0], bs_host[b1]
        g = xc[b.edge_src[t0:t1].long()].float()               # (Tg, C, F)
        oh = (b.edge_local_row[t0:t1, :, None] == iota).float()  # (Tg, C, W)
        if w is not None:
            oh = oh * w[t0:t1, :, None]
        partial = torch.bmm(oh.transpose(1, 2), g)             # (Tg, W, F)
        csum = torch.cat([partial.new_zeros((1, W, F)),
                          partial.cumsum(dim=0)])
        starts = b.block_start[b0:b1 + 1].long() - t0
        blocks = csum[starts[1:]] - csum[starts[:-1]]          # (Bg, W, F)
        out[b0 * W:b1 * W] = blocks.reshape(-1, F)
    out = out[: b.num_rows]
    if agg == "mean":
        out = out / b.degree.clamp(min=1)[:, None].to(out.dtype)
    elif agg != "sum":
        raise ValueError(f"unsupported agg {agg!r}")
    return out
