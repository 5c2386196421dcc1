"""Random walks: node2vec, temporal and CTDNE-biased temporal walks.

Counterpart of ``tch_geometric_tpu/sampling/walks.py``.  Every walk of a
batch advances in lockstep, one step per loop iteration, with the JAX
package's keys and draw shapes, so the walks compare array for array:

* **node2vec** (``random_walk``): step ``l`` draws with
  ``split(key, walk_length)[l]``; trial ``t`` draws a uniform neighbor with
  ``fold_in(step_key, t)`` and its accept uniform with ``fold_in(tkey, 1)``
  (1/p back to the previous node, 1 to a neighbor of it, 1/q farther, all
  over the largest).  A walk keeps its first accepted candidate, or the
  last trial's when all ``num_trials`` reject.  On an ELL graph the walker
  carries its current node's row, so the distance-1 test compares the
  candidate's lanes with the previous node; elsewhere it is ``has_edge``.
* **tempo_random_walk**: one uniform draw per step among the neighbors
  whose timestamp lies in the root's half-open window (a Gumbel argmax on
  the ELL lanes, else ``primitives.window_choice_sample``); a dead end
  restarts from a uniformly chosen earlier position of the same walk, held
  as a one-slot reservoir.
* **biased_tempo_random_walk** (CTDNE): forward-in-time admissibility, a
  Gumbel argmax over uniform, linear (closeness rank, a stable argsort) or
  exponential log-weights, and whole-walk retries until every walk is done
  or ``retry_count`` attempts (a host check each attempt; a finished batch
  would not change).

Timestamps are int32 (``-1`` is the missing timestamp; an edge without one
takes its target's), as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..data.graph import CsrGraph, make_graph, take_clamped
from ..utils.types import NAN_TIMESTAMP
from . import primitives, rng
from .neighbor import _aligned_window_values, _int32, _select_lanes

NUM_TRIALS = 16  # bounded replacement for the reference's unbounded loop

WALK_BIAS_UNIFORM = "uniform"
WALK_BIAS_LINEAR = "linear"
WALK_BIAS_EXPONENTIAL = "exponential"
INT32_MAX = 2**31 - 1


def _rows(graph: CsrGraph, cur: torch.Tensor):
    """``(starts, degrees)`` of the walkers' current nodes."""
    starts, ends = graph.neighbors_range(cur.clamp(0,
                                                   graph.num_ptr_nodes - 1))
    return starts, ends - starts


def _clip_edge(graph: CsrGraph, eptr: torch.Tensor) -> torch.Tensor:
    return eptr.clamp(0, max(graph.num_edges - 1, 0))


# ---------------------------------------------------------------------------
# node2vec
# ---------------------------------------------------------------------------

def node2vec_probs(p: float, q: float) -> Tuple[float, float, float]:
    """The accept probabilities of a step back to the previous node, to a
    neighbor of it and farther, computed in float32 from ``float32(p)``
    and ``float32(q)`` as the JAX package computes them."""
    inv_p = 1.0 / torch.tensor(p, dtype=torch.float32)
    inv_q = 1.0 / torch.tensor(q, dtype=torch.float32)
    max_prob = torch.maximum(torch.maximum(inv_p, torch.ones(())), inv_q)
    return (float(inv_p / max_prob), float(1.0 / max_prob),
            float(inv_q / max_prob))


def _random_walk_impl(key, graph: CsrGraph, start: torch.Tensor,
                      walk_length: int, p: float, q: float,
                      num_trials: int) -> torch.Tensor:
    """``(B, walk_length + 1)`` walks from ``start``, -1 after a dead
    end."""
    device = graph.device
    B = start.shape[0]
    start = start.long()
    prob0, prob1, prob2 = node2vec_probs(p, q)

    use_ell = graph.ell is not None
    prev = torch.full((B,), -1, dtype=torch.long, device=device)
    cur = start
    active = torch.ones((B,), dtype=torch.bool, device=device)
    if use_ell:
        cur_lanes, cur_deg, _ = graph.ell_rows(cur)
        cur_lanes, cur_deg = cur_lanes.long(), cur_deg.long()
        lane_iota = torch.arange(cur_lanes.shape[-1], device=device)
    steps = []
    step_keys = rng.split(key, walk_length)
    for ell in range(walk_length):
        step_key = step_keys[ell]
        if use_ell:
            deg = cur_deg
        else:
            starts, deg = _rows(graph, cur)
        active = active & (deg > 0)        # a dead end breaks the walk

        chosen = torch.full((B,), -1, dtype=torch.long, device=device)
        accepted = torch.zeros((B,), dtype=torch.bool, device=device)
        if use_ell:
            chosen_lanes, chosen_deg = cur_lanes, cur_deg
        for t in range(num_trials):
            tkey = rng.fold_in(step_key, t)
            pos = rng.randint(tkey, (B,), 0, deg.clamp(min=1), device=device)
            if use_ell:
                cand = _select_lanes(cur_lanes, pos[:, None].clamp(
                    max=cur_lanes.shape[-1] - 1))[:, 0]
                cand_lanes, cand_deg, _ = graph.ell_rows(cand)
                cand_lanes, cand_deg = cand_lanes.long(), cand_deg.long()
                is_tri = ((cand_lanes == prev[:, None])
                          & (lane_iota < cand_deg[:, None])).any(dim=-1)
            else:
                cand = graph.gather_neighbors(starts + pos)
                is_tri = graph.has_edge(cand, prev)
            r = rng.uniform(rng.fold_in(tkey, 1), (B,), device=device)
            acc = torch.where(cand == prev, r < prob0,
                              torch.where(is_tri, r < prob1, r < prob2))
            take = ~accepted & acc
            if t == num_trials - 1:      # bounded fallback: the last draw
                take = take | ~accepted
            chosen = torch.where(take, cand, chosen)
            if use_ell:
                chosen_lanes = torch.where(take[:, None], cand_lanes,
                                           chosen_lanes)
                chosen_deg = torch.where(take, cand_deg, chosen_deg)
            accepted = accepted | acc

        nxt = torch.where(active, chosen, -1)
        prev = torch.where(active, cur, prev)
        cur = torch.where(active, nxt, cur)
        if use_ell:
            cur_lanes = torch.where(active[:, None], chosen_lanes, cur_lanes)
            cur_deg = torch.where(active, chosen_deg, cur_deg)
        steps.append(nxt)
    return torch.stack([start] + steps, dim=1)


def _start(start, device) -> torch.Tensor:
    start = start if torch.is_tensor(start) else np.asarray(start)
    return torch.as_tensor(start, device=device).long()


def _csr_from_parts(row_ptrs, col_indices, device) -> CsrGraph:
    row_ptrs = np.asarray(row_ptrs)
    col_indices = np.asarray(col_indices)
    return make_graph(row_ptrs, col_indices,
                      num_src=row_ptrs.shape[0] - 1,
                      num_dst=int(col_indices.max(initial=-1)) + 1,
                      device=device)


def random_walk(row_ptrs, col_indices, start, walk_length: int,
                p: float = 1.0, q: float = 1.0, *,
                key: Optional[torch.Tensor] = None,
                num_trials: int = NUM_TRIALS, device="cuda") -> np.ndarray:
    """Reference-parity node2vec walk on ``device``: host CSR arrays in,
    ``(num_starts, walk_length + 1)`` int64 walks out, padded with -1 after
    a dead end."""
    if key is None:
        key = rng.next_key()
    graph = _csr_from_parts(row_ptrs, col_indices, device)
    if p == 1.0 and q == 1.0:
        num_trials = 1       # accept probability is 1: the first draw wins
    walks = _random_walk_impl(key, graph, _start(start, device),
                              int(walk_length), p, q, int(num_trials))
    return walks.cpu().numpy()


# ---------------------------------------------------------------------------
# temporal walks
# ---------------------------------------------------------------------------

def _neighbor_ts(graph: CsrGraph, edge_ts, node_ts, eptr):
    """Edge timestamp, or the target's when the edge has none."""
    ets = take_clamped(edge_ts, eptr)
    nts = node_ts[graph.gather_neighbors(eptr)]
    return torch.where(ets != NAN_TIMESTAMP, ets, nts)


def _effective_ts(graph: CsrGraph, edge_ts, node_ts):
    """``_neighbor_ts`` of every edge, once: the ELL paths read it by
    window."""
    return torch.where(edge_ts != NAN_TIMESTAMP, edge_ts,
                       node_ts[graph.indices])


def _tempo_walk_impl(key, graph: CsrGraph, node_ts, edge_ts, start,
                     start_ts, walk_length: int, win_lo: int, win_hi: int,
                     window_chunk: int):
    """``(walks, timestamps)``, both ``(B, walk_length)``; the window is
    ``[start_ts + win_lo, start_ts + win_hi)``."""
    device = graph.device
    B, L = start.shape[0], walk_length
    start = start.long()
    start_ts = start_ts.int()
    if L <= 1:
        return start[:, None], start_ts[:, None]
    lo = (start_ts + win_lo)[:, None]
    hi = (start_ts + win_hi)[:, None]
    root_nan = (start_ts == NAN_TIMESTAMP)[:, None]

    use_ell = graph.ell is not None
    if use_ell:
        ts_eff = _effective_ts(graph, edge_ts, node_ts)
        P = max(graph.max_degree, 1)
        lane_iota = torch.arange(P, device=device)

    def admissible(t):
        return (t == NAN_TIMESTAMP) | root_nan | ((t >= lo) & (t < hi))

    r_node, r_ts, cur = start, start_ts, start
    walk, walk_ts = [start], [start_ts]
    step_keys = rng.split(key, L - 1)
    for ell in range(L - 1):
        step_key = step_keys[ell]
        if use_ell:
            lanes, deg, starts = graph.ell_rows(cur)
            t = _aligned_window_values(ts_eff, starts, P)
            adm = (lane_iota[None, :] < deg[:, None]) & admissible(t)
            noise = rng.gumbel(step_key, (B, P), device=device)
            keysv = torch.where(adm, noise, primitives.NEG_INF)
            pos = primitives.argmax(keysv)[:, None]
            ok = torch.isfinite(keysv.amax(dim=-1))
            nxt = _select_lanes(lanes, pos)[:, 0].long()
            nxt_ts = _select_lanes(t, pos)[:, 0]
        else:
            starts, deg = _rows(graph, cur)
            pos, valid = primitives.window_choice_sample(
                step_key, starts, deg, 1, max_degree=graph.max_degree,
                num_edges=graph.num_edges,
                mask_at=lambda e: admissible(_neighbor_ts(graph, edge_ts,
                                                          node_ts, e)),
                window=window_chunk)
            eptr = _clip_edge(graph, starts + pos[:, 0])
            nxt = graph.gather_neighbors(eptr)
            nxt_ts = _neighbor_ts(graph, edge_ts, node_ts, eptr)
            ok = valid[:, 0]

        # a dead end restarts from a uniformly chosen earlier position of
        # the same walk: a one-slot reservoir over positions 0..l
        nxt = torch.where(ok, nxt, r_node)
        nxt_ts = torch.where(ok, nxt_ts, r_ts)
        take = (rng.uniform(rng.fold_in(step_key, 7), (B,), device=device)
                < 1.0 / torch.tensor(ell + 2, dtype=torch.float32))
        r_node = torch.where(take, nxt, r_node)
        r_ts = torch.where(take, nxt_ts, r_ts)
        cur = nxt
        walk.append(nxt)
        walk_ts.append(nxt_ts)
    return torch.stack(walk, dim=1), torch.stack(walk_ts, dim=1)


def tempo_random_walk(row_ptrs, col_indices, node_timestamps,
                      edge_timestamps, start, start_timestamps,
                      walk_length: int, window: Tuple[int, int], *,
                      key: Optional[torch.Tensor] = None,
                      window_chunk: int = 256, device="cuda"):
    """Reference-parity temporal walk on ``device``: ``(walks,
    walk_timestamps)``, both ``(num_starts, walk_length)`` int64."""
    if key is None:
        key = rng.next_key()
    graph = _csr_from_parts(row_ptrs, col_indices, device)
    walks, ts = _tempo_walk_impl(
        key, graph, _int32(node_timestamps, device),
        _int32(edge_timestamps, device), _start(start, device),
        _int32(start_timestamps, device), int(walk_length), int(window[0]),
        int(window[1]), int(window_chunk))
    return walks.cpu().numpy(), ts.long().cpu().numpy()


def _biased_attempt(att_key, graph: CsrGraph, node_ts, edge_ts, ts_eff,
                    start, start_ts, walk_length: int, walk_bias: str,
                    forward: bool):
    """One CTDNE attempt: ``(walks, timestamps, completed)``."""
    device = graph.device
    B, L = start.shape[0], walk_length
    if L <= 1:
        return (start[:, None], start_ts[:, None],
                torch.ones((B,), dtype=torch.bool, device=device))
    D = max(graph.max_degree, 1)
    pos = torch.arange(D, device=device)[None, :]
    cur, cur_ts = start, start_ts
    alive = torch.ones((B,), dtype=torch.bool, device=device)
    walk, walk_ts = [start], [start_ts]
    step_keys = rng.split(att_key, L - 1)
    for ell in range(L - 1):
        if ts_eff is not None:
            lanes, deg, starts = graph.ell_rows(cur)
            t = _aligned_window_values(ts_eff, starts, D)
        else:
            starts, deg = _rows(graph, cur)
            eptr = _clip_edge(graph, starts[:, None] + pos)
            t = _neighbor_ts(graph, edge_ts, node_ts, eptr)
        cts = cur_ts[:, None]
        # forward in time; a missing timestamp always passes
        adm = (((t == NAN_TIMESTAMP) | (cts == NAN_TIMESTAMP) | (cts <= t))
               & (pos < deg[:, None]))
        wt = torch.where(t == NAN_TIMESTAMP, cts, t)
        if walk_bias == WALK_BIAS_EXPONENTIAL:
            logw = (cts - wt if forward else wt - cts).float()
        elif walk_bias == WALK_BIAS_LINEAR:
            # closeness rank: the closest admissible time weighs most
            key_t = torch.where(adm, wt, INT32_MAX)
            order = torch.argsort(key_t, dim=1, stable=True)
            rank = torch.empty_like(order).scatter_(
                1, order, pos.expand(B, D).contiguous())
            n_adm = adm.sum(dim=1, keepdim=True)
            logw = torch.log((n_adm - rank).clamp(min=1).float())
        else:
            logw = torch.zeros((B, D), device=device)
        logw = torch.where(cts == NAN_TIMESTAMP, 0.0, logw)
        g = rng.gumbel(step_keys[ell], (B, D), device=device)
        score = torch.where(adm, logw + g, primitives.NEG_INF)
        best = primitives.argmax(score)
        ok = adm.any(dim=1) & alive
        if ts_eff is not None:
            nxt = _select_lanes(lanes, best[:, None])[:, 0].long()
        else:
            nxt = graph.gather_neighbors(_clip_edge(graph, starts + best))
        nxt_ts = _select_lanes(t, best[:, None])[:, 0]

        cur = torch.where(ok, nxt, cur)
        # the walk's time moves only on a timestamped step
        cur_ts = torch.where(ok & (nxt_ts != NAN_TIMESTAMP), nxt_ts, cur_ts)
        alive = ok
        walk.append(torch.where(ok, nxt, -1))
        walk_ts.append(torch.where(ok, nxt_ts, -1))
    return torch.stack(walk, dim=1), torch.stack(walk_ts, dim=1), alive


def _biased_tempo_walk_impl(key, graph: CsrGraph, node_ts, edge_ts, start,
                            start_ts, walk_length: int, walk_bias: str,
                            forward: bool, retry_count: int):
    """Whole-walk retries: attempt ``i`` keyed ``fold_in(key, i)`` fills the
    walks not done yet, until all are or ``retry_count`` attempts ran."""
    device = graph.device
    B, L = start.shape[0], walk_length
    start, start_ts = start.long(), start_ts.int()
    ts_eff = (_effective_ts(graph, edge_ts, node_ts)
              if graph.ell is not None else None)
    walks = torch.full((B, L), -1, dtype=torch.long, device=device)
    ts_buf = torch.full((B, L), -1, dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    for i in range(max(retry_count, 1)):
        if bool(done.all()):
            break
        w, t, ok = _biased_attempt(rng.fold_in(key, i), graph, node_ts,
                                   edge_ts, ts_eff, start, start_ts, L,
                                   walk_bias, forward)
        take = ~done[:, None]
        walks = torch.where(take, w, walks)
        ts_buf = torch.where(take, t, ts_buf)
        done = done | ok
    return walks, ts_buf


def biased_tempo_random_walk(row_ptrs, col_indices, node_timestamps,
                             edge_timestamps, start, start_timestamps,
                             walk_length: int, walk_bias: str,
                             forward: bool = True, retry_count: int = 10, *,
                             key: Optional[torch.Tensor] = None,
                             device="cuda"):
    """Reference-parity CTDNE walk on ``device``: ``(walks,
    walk_timestamps)``, both ``(num_starts, walk_length)`` int64, -1 where a
    walk stopped."""
    if key is None:
        key = rng.next_key()
    if walk_bias not in (WALK_BIAS_UNIFORM, WALK_BIAS_LINEAR,
                         WALK_BIAS_EXPONENTIAL):
        raise ValueError(f"unknown walk_bias {walk_bias!r}")
    graph = _csr_from_parts(row_ptrs, col_indices, device)
    walks, ts = _biased_tempo_walk_impl(
        key, graph, _int32(node_timestamps, device),
        _int32(edge_timestamps, device), _start(start, device),
        _int32(start_timestamps, device), int(walk_length), walk_bias,
        bool(forward), int(retry_count))
    return walks.cpu().numpy(), ts.long().cpu().numpy()
