"""Batched sampling engines.

Counterpart of ``tch_geometric_tpu/sampling/primitives.py``; each engine
draws exactly the bits its JAX twin draws (``sampling/rng.py``), with the
same key derivation and draw shapes, so outputs are bit-equal (Gumbel keys
up to the last ulp of ``log``):

* :func:`floyd_sample` — exact uniform k-subset of ``[0, deg)`` per node by
  Floyd's algorithm, O(k^2) compares, independent of degree;
* :func:`floyd_hop` — one hop of it over a graph's frontier, with the edge
  pointers and neighbor ids: on a CUDA tensor one launch of the
  hand-written kernel ``csrc/floyd.cu`` (:func:`floyd_hop_cuda`);
* :func:`uniform_lane_topk` — one uniform per ELL lane, top ``k`` among the
  lanes ``< deg``;
* :func:`replacement_positions` — ``k`` independent ``randint`` draws;
* :func:`window_topk_sample` / :func:`window_choice_sample` — Gumbel top-k
  (without replacement) or per-draw Gumbel argmax (with replacement) over
  each node's neighbor window, scanned in chunks of ``window`` lanes with a
  running carry, chunk ``c`` keyed ``fold_in(key, c)``: the weighted and
  filtered engines;
* :func:`masked_gumbel_topk` — Gumbel top-k over a dense logit table.

Ties follow lax: in :func:`top_k` the lower index wins, in
:func:`argmax` the first maximum.  ``row0`` (the engines of the neighbor
sampler): the rows are a block, from row ``row0``, of a larger frontier,
and each draw takes that block of the larger frontier's draw
(``rng``'s block draws).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops import _build
from ..utils.metrics import trace_span
from . import rng

NEG_INF = float("-inf")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def floyd_sample(key: torch.Tensor, deg: torch.Tensor, k: int,
                 row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact uniform sample of ``min(k, deg)`` distinct positions in
    ``[0, deg)`` per element of ``deg``.

    Returns ``(positions, valid)`` of shape ``deg.shape + (k,)``; invalid
    slots hold position 0.  Floyd: for j in deg-k..deg-1 draw t ~ U[0, j];
    insert j if t was already chosen, else t.
    """
    deg = deg.long()
    chosen = torch.full(deg.shape + (k,), -1, dtype=torch.long,
                        device=deg.device)
    for i in range(k):
        j = deg - (k - i)                  # may be < 0 when deg < k
        hi = torch.clamp(j + 1, min=1)
        t = rng.randint(rng.fold_in(key, i), deg.shape, 0, hi,
                        device=deg.device, row0=row0)
        hit = (chosen == t[..., None]).any(dim=-1)
        chosen[..., i] = torch.where(hit, j, t)

    iota = torch.arange(k, device=deg.device)
    take_all = (deg <= k)[..., None]
    positions = torch.where(take_all, iota.expand_as(chosen), chosen)
    valid = torch.where(take_all, iota < deg[..., None], deg[..., None] > 0)
    return torch.where(valid, positions, 0), valid


def floyd_hop(key: torch.Tensor, graph, frontier: torch.Tensor,
              frontier_valid: torch.Tensor, k: int, row0: int = 0, *,
              window_table: bool = False):
    """Uniform k-subset without replacement of each frontier node's
    in-edges, by :func:`floyd_sample` under ``key``, on a graph with no ELL
    table: ``(deg (B,), pos (B, k), valid (B, k), eptr (B, k), neighbor
    (B, k))``.  ``row0``: the frontier's first row in a larger frontier
    whose draws it takes a block of; ``window_table``: the neighbor ids as
    the graph's aligned-window table gathers them, when it has one (they
    differ from ``indices[eptr]`` on invalid slots only).

    On a CPU tensor the plain version (:func:`floyd_hop_plain`); on a CUDA
    tensor one launch of the kernel (:func:`floyd_hop_cuda`), in one
    ``rng_bits`` span: the launch draws the hop's bits and derives their
    keys.  The two give the same integers."""
    if frontier.device.type == "cpu":
        return floyd_hop_plain(key, graph, frontier, frontier_valid, k, row0,
                               window_table=window_table)
    with trace_span("rng_bits"):
        return floyd_hop_cuda(key, graph, frontier, frontier_valid, k, row0,
                              window_table=window_table)


def floyd_hop_plain(key: torch.Tensor, graph, frontier: torch.Tensor,
                    frontier_valid: torch.Tensor, k: int, row0: int = 0, *,
                    window_table: bool = False):
    """:func:`floyd_hop` as torch ops on any device: the plain version."""
    node = frontier.clamp(0, graph.num_ptr_nodes - 1)
    starts, ends = graph.neighbors_range(node)
    deg = torch.where(frontier_valid, ends - starts, 0)
    pos, valid = floyd_sample(key, deg, k, row0)
    eptr = (starts.long()[:, None] + pos).clamp(0, max(graph.num_edges - 1,
                                                       0))
    if window_table and graph.indices_win is not None:
        win, off = graph.gather_neighbor_windows_rows(starts)
        neighbor = torch.gather(win, -1, off[..., None] + pos).long()
    else:
        neighbor = graph.gather_neighbors(eptr)
    return deg, pos, valid, eptr, neighbor


def floyd_hop_cuda(key: torch.Tensor, graph, frontier: torch.Tensor,
                   frontier_valid: torch.Tensor, k: int, row0: int = 0, *,
                   window_table: bool = False):
    """:func:`floyd_hop` as one launch of ``tgt_floyd_hop`` on the current
    stream of the frontier's CUDA device; counts its launches in
    ``floyd_hop_cuda.launches``.  The key goes to the kernel as its two
    words; nothing is copied to the card."""
    dev = frontier.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA device, got {dev}")
    k, row0 = int(k), int(row0)
    if k < 0 or not 0 <= row0 < 2 ** 64:
        raise ValueError(f"k={k} and row0={row0} must be >= 0")
    B = frontier.shape[0]
    deg = torch.empty((B,), dtype=torch.int64, device=dev)
    pos, eptr, neighbor = (torch.empty((B, k), dtype=torch.int64, device=dev)
                           for _ in range(3))
    valid = torch.empty((B, k), dtype=torch.bool, device=dev)
    if B == 0:
        return deg, pos, valid, eptr, neighbor
    indptr, indices = graph.indptr, graph.indices
    if indptr.dtype != torch.int64 or indices.dtype != torch.int64:
        raise ValueError("the graph's indptr and indices must be int64")
    if frontier.dtype != torch.int64 or not frontier.is_contiguous():
        frontier = frontier.to(torch.int64).contiguous()
    if (frontier_valid.dtype != torch.bool
            or not frontier_valid.is_contiguous()):
        frontier_valid = frontier_valid.to(torch.bool).contiguous()
    # the aligned-window table (int32 rows of WINDOW_LANES), whose gather
    # the neighbor ids follow, or none: indices[eptr]
    win = graph.indices_win if window_table else None
    win_rows, win_lanes = (0, 0) if win is None else win.shape
    if win is not None and win.dtype != torch.int32:
        raise ValueError("the graph's window table must be int32")
    k0, k1 = rng._words(key)
    _build.launch("floyd", "tgt_floyd_hop", dev, indptr.data_ptr(),
                  indices.data_ptr(), None if win is None else win.data_ptr(),
                  frontier.data_ptr(), frontier_valid.data_ptr(),
                  graph.num_ptr_nodes, graph.num_edges, win_rows, win_lanes,
                  B, k, row0, k0, k1, deg.data_ptr(), pos.data_ptr(),
                  valid.data_ptr(), eptr.data_ptr(), neighbor.data_ptr())
    floyd_hop_cuda.launches += 1
    return deg, pos, valid, eptr, neighbor


floyd_hop_cuda.launches = 0


def top_k(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: among equal values the lower
    index comes first (a stable descending sort; ``torch.topk`` promises
    no order among ties)."""
    sv, si = torch.sort(vals, dim=-1, descending=True, stable=True)
    return sv[..., :k], si[..., :k]


def uniform_lane_topk(key: torch.Tensor, deg: torch.Tensor, num_lanes: int,
                      k: int, row0: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact uniform k-subset of ``[0, deg)`` when ``deg <= num_lanes``:
    rank every lane by one uniform draw, take the top ``k`` lanes
    ``< deg``.  Valid slots are the first ``min(deg, k)``; invalid slots
    hold position 0."""
    deg = deg.long()
    lane = torch.arange(num_lanes, device=deg.device)
    r = rng.uniform(key, deg.shape + (num_lanes,), device=deg.device,
                    row0=row0)
    vals = torch.where(lane < deg[..., None], r, NEG_INF)
    return topk_slots(vals, k)


def topk_slots(keys_: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(positions, valid)`` of the top ``k`` keys along the last axis,
    -inf keys invalid at position 0; past the axis' length, the slots are
    invalid padding."""
    kk = min(k, keys_.shape[-1])
    top_vals, pos = top_k(keys_, kk)
    valid = torch.isfinite(top_vals)
    if kk < k:
        pad = keys_.shape[:-1] + (k - kk,)
        pos = torch.cat([pos, pos.new_zeros(pad)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(pad)], dim=-1)
    return torch.where(valid, pos, 0), valid


def replacement_positions(key: torch.Tensor, deg: torch.Tensor, k: int,
                          row0: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k`` independent uniform positions in ``[0, deg)`` per node.
    Empty rows -> invalid."""
    deg = deg.long()
    hi = torch.clamp(deg, min=1)[..., None]
    positions = rng.randint(key, deg.shape + (k,), 0, hi, device=deg.device,
                            row0=row0)
    valid = (deg > 0)[..., None].expand(positions.shape)
    return torch.where(valid, positions, 0), valid


def argmax(vals: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` along the last axis: the first maximum wins (an
    all -inf row gives 0)."""
    return torch.argmax(vals, dim=-1)


# ---------------------------------------------------------------------------
# Chunked Gumbel top-k over neighbor windows
# ---------------------------------------------------------------------------

EdgeFn = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _window_chunk_logits(chunk: int, starts: torch.Tensor,
                         degs: torch.Tensor, window: int, num_edges: int,
                         logw_at: EdgeFn, mask_at: EdgeFn):
    """Chunk ``chunk``'s ``(positions (B, W), logits (B, W))``: window
    positions ``chunk*W + [0, W)``, log-weights by global edge pointer
    (0 when uniform), -inf past the degree or where ``mask_at`` refuses."""
    offs = chunk * window + torch.arange(window, device=degs.device)
    pos = offs.expand(degs.shape + (window,))
    valid = pos < degs[..., None]
    eptr = (starts[..., None] + pos).clamp(0, max(num_edges - 1, 0))
    logits = torch.zeros(pos.shape, dtype=torch.float32, device=degs.device)
    if logw_at is not None:
        logits = logw_at(eptr).float()
    if mask_at is not None:
        valid = valid & mask_at(eptr)
    return pos, torch.where(valid, logits, NEG_INF)


def window_topk_sample(key: torch.Tensor, starts: torch.Tensor,
                       degs: torch.Tensor, k: int, *, max_degree: int,
                       num_edges: int, logw_at: EdgeFn = None,
                       mask_at: EdgeFn = None, window: int = 256,
                       row0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted sample WITHOUT replacement of ``k`` window positions.

    ``starts``/``degs``: (B,) window start edge pointers and sizes;
    ``logw_at(eptr)`` log-weights by global edge pointer (None: uniform),
    ``mask_at(eptr)`` admissibility (temporal filters).  Gumbel top-k with a
    running (B, k) carry over ``ceil(max_degree / window)`` chunks.
    Returns ``(positions (B, k) window-relative, valid (B, k))``.
    """
    starts, degs = starts.long(), degs.long()
    B = starts.shape[0]
    top_vals = torch.full((B, k), NEG_INF, device=degs.device)
    top_pos = torch.zeros((B, k), dtype=torch.long, device=degs.device)
    for c in range(max(1, cdiv(max(max_degree, 1), window))):
        pos, logits = _window_chunk_logits(c, starts, degs, window,
                                           num_edges, logw_at, mask_at)
        noise = rng.gumbel(rng.fold_in(key, c), pos.shape,
                           device=degs.device, row0=row0)
        keys_ = torch.where(torch.isfinite(logits), logits + noise, NEG_INF)
        top_vals, idx = top_k(torch.cat([top_vals, keys_], dim=1), k)
        top_pos = torch.gather(torch.cat([top_pos, pos], dim=1), 1, idx)
    valid = torch.isfinite(top_vals)
    return torch.where(valid, top_pos, 0), valid


def window_choice_sample(key: torch.Tensor, starts: torch.Tensor,
                         degs: torch.Tensor, k: int, *, max_degree: int,
                         num_edges: int, logw_at: EdgeFn = None,
                         mask_at: EdgeFn = None, window: int = 256,
                         row0: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k`` independent weighted draws (with replacement) per window:
    each draw is a Gumbel argmax over the admissible window, chunk by chunk
    (a ``(B, k, W)`` draw each) with a per-draw running max.  A draw is
    valid iff the admissible set is non-empty."""
    starts, degs = starts.long(), degs.long()
    B = starts.shape[0]
    best_vals = torch.full((B, k), NEG_INF, device=degs.device)
    best_pos = torch.zeros((B, k), dtype=torch.long, device=degs.device)
    for c in range(max(1, cdiv(max(max_degree, 1), window))):
        pos, logits = _window_chunk_logits(c, starts, degs, window,
                                           num_edges, logw_at, mask_at)
        noise = rng.gumbel(rng.fold_in(key, c), (B, k, pos.shape[-1]),
                           device=degs.device, row0=row0)
        total = torch.where(torch.isfinite(logits)[:, None, :],
                            logits[:, None, :] + noise, NEG_INF)
        chunk_best = total.amax(dim=-1)
        chunk_pos = torch.gather(pos, 1, argmax(total))
        better = chunk_best > best_vals
        best_vals = torch.where(better, chunk_best, best_vals)
        best_pos = torch.where(better, chunk_pos, best_pos)
    valid = torch.isfinite(best_vals)
    return torch.where(valid, best_pos, 0), valid


def masked_gumbel_topk(key: torch.Tensor, logits: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gumbel top-k over a dense logit table ``(..., N)`` (-inf marks
    invalid entries).  Returns ``(indices (..., k), valid (..., k))``."""
    noise = rng.gumbel(key, logits.shape, device=logits.device)
    return topk_slots(torch.where(torch.isfinite(logits), logits + noise,
                                  NEG_INF), k)
