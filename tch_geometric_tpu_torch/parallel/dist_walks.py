"""Distributed random walks over a partitioned graph topology.

Counterpart of ``tch_geometric_tpu/parallel/dist_walks.py``.  The walker
state lives with the requesting rank while adjacency rows live only with
their owner (:class:`~.dist_sampling.PartitionedGraph`): every step routes
``(local_row, uid, state...)`` requests through the owner-routed exchange
(:func:`~.dist_sampling.exchange_rounds`), the owner draws the next hop
from its local row under a key folded on the walk's global uid, and the
response routes back.  The walks are therefore bit-identical for any
number of ranks, and to the JAX package's.

* node2vec: each step is two exchanges.  The current node's owner draws
  ``num_trials`` uniform candidates; the candidates' owners answer the
  distance-1 probe ``has_edge(cand, prev)`` in one batched exchange; the
  requester applies the Knightking accept rule (bounded trials, the last
  one taken).
* tempo walk: root-anchored window admissibility by the owner against its
  effective edge timestamps; a dead end restarts from a reservoir-carried
  uniform earlier position of the same walk.
* CTDNE: forward-in-time admissibility and the exponential, linear or
  uniform bias on the owner; whole-walk retries while the ``psum``'d count
  of walks not done is positive, read on the host once an attempt, so
  every rank runs the same attempts and the ``all_to_all``s stay matched.

The owner's row engines take the ELL table where the graph has one, else a
chunked window sweep over the CSC row; the sweep's loop is bounded by the
largest degree among the rows the owner received (one host read an owner
call), which gives the draws of the JAX package's loop over the whole
graph's largest degree: a lane past every row's degree scores -inf and
never wins the strict running max.

Timestamps: owners hold effective edge timestamps (a NaN edge timestamp
falls back to its node's), precomputed by :func:`effective_edge_ts` and
given to ``build_partitioned_graph`` as ``edge_timestamps``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..sampling import primitives, rng
from ..sampling.neighbor import _select_lanes
from ..sampling.walks import (WALK_BIAS_EXPONENTIAL, WALK_BIAS_LINEAR,
                              WALK_BIAS_UNIFORM, node2vec_probs)
from ..utils.types import NAN_TIMESTAMP
from .dist_sampling import (PartitionedGraph, _check_graph, _uid_keys,
                            exchange_rounds, resolve_num_rounds,
                            sample_capacity)
from .mesh import (LocalShard, Mesh, along, any_rank, axis_index,
                   current_mesh, psum, spmd)
from .multihost import placed

NEG_INF = float("-inf")
INT32_MAX = 2 ** 31 - 1


def effective_edge_ts(indices, edge_ts, node_ts) -> np.ndarray:
    """Per-edge timestamp with the dst node's as the fallback where the
    edge's is NaN (host numpy); give the result to
    ``build_partitioned_graph`` as ``edge_timestamps``."""
    indices = np.asarray(indices, dtype=np.int64)
    edge_ts = np.asarray(edge_ts, dtype=np.int32)
    node_ts = np.asarray(node_ts, dtype=np.int32)
    return np.where(edge_ts != NAN_TIMESTAMP, edge_ts, node_ts[indices])


# ---------------------------------------------------------------------------
# Owner-side row engines (ELL table, chunked window sweep)
# ---------------------------------------------------------------------------

def _window_chunks(deg: torch.Tensor, live: torch.Tensor, window: int
                   ) -> int:
    """Chunks of ``window`` lanes that cover the largest degree of the
    ``live`` rows (at least one): one host read.  The other rows are the
    exchange's empty slots, whose answers no requester reads."""
    dmax = int(torch.where(live, deg, 0).max()) if deg.numel() else 0
    return max(1, -(-max(dmax, 1) // window))


def _owner_row_argmax_ell(g: PartitionedGraph, rows, score_fn):
    """Argmax over the ELL lanes of ``score_fn(t (B, W), in_deg (B, W))``:
    (next global id, its timestamp, ok)."""
    row = g.ell[rows]
    lanes, deg = row[:, :-2], row[:, -2]
    W = lanes.shape[-1]
    in_deg = torch.arange(W, device=rows.device)[None, :] < deg[:, None]
    t = (g.ell_ts[rows] if g.ell_ts is not None
         else torch.full(lanes.shape, NAN_TIMESTAMP, dtype=torch.int32,
                         device=rows.device))
    score = score_fn(t, in_deg)
    pos = primitives.argmax(score)[:, None]
    ok = torch.isfinite(score.amax(dim=-1))
    return _select_lanes(lanes, pos)[:, 0], _select_lanes(t, pos)[:, 0], ok


def _owner_row_argmax_window(g: PartitionedGraph, rows, live, score_fn,
                             window: int):
    """Chunked argmax over the CSC row: per chunk the scores
    ``score_fn(t, in_deg, chunk)``, carrying the running (best, position)
    with a strict ``>`` (the first maximum wins)."""
    deg = g.ldeg[rows].long()
    lstart = g.lstart[rows].long()
    B = rows.shape[0]
    ecap = g.lindices.shape[0]
    device = rows.device
    best = torch.full((B,), NEG_INF, device=device)
    bpos = torch.zeros((B,), dtype=torch.long, device=device)
    for c in range(_window_chunks(deg, live, window)):
        pos = (c * window + torch.arange(window, device=device)).expand(
            B, window)
        in_deg = pos < deg[:, None]
        lptr = (lstart[:, None] + pos).clamp(0, ecap - 1)
        t = (g.lts[lptr] if g.lts is not None
             else torch.full((B, window), NAN_TIMESTAMP, dtype=torch.int32,
                             device=device))
        score = score_fn(t, in_deg, c)
        cb = score.amax(dim=-1)
        better = cb > best
        best = torch.where(better, cb, best)
        bpos = torch.where(better, c * window + primitives.argmax(score),
                           bpos)
    lptr = (lstart + bpos).clamp(0, ecap - 1)
    nxt_ts = (g.lts[lptr] if g.lts is not None
              else torch.full((B,), NAN_TIMESTAMP, dtype=torch.int32,
                              device=device))
    return g.lindices[lptr], nxt_ts, torch.isfinite(best)


def _owner_step(g: PartitionedGraph, keys, rows, live, make_score: Callable,
                window: int):
    """The ELL or the chunked engine.  ``make_score(t, in_deg, keys,
    chunk)`` gives per-lane scores, -inf where inadmissible; its noise is
    keyed per (row, chunk) through ``keys``."""
    if g.ell is not None:
        return _owner_row_argmax_ell(
            g, rows, lambda t, in_deg: make_score(t, in_deg, keys, 0))
    return _owner_row_argmax_window(
        g, rows, live, lambda t, in_deg, c: make_score(t, in_deg, keys, c),
        window)


def _gumbel(keys, width: int, chunk: int) -> torch.Tensor:
    """(B, width) Gumbel noise, row ``b`` under ``fold_in(keys[b],
    chunk)``."""
    return rng.gumbel_each(rng.fold_in_each(keys, chunk), (width,))


def _recv_rows(g: PartitionedGraph, recv):
    """The local rows of received requests and which slots hold one (the
    payload's last column, 1 in every request, 0 in an empty slot)."""
    rows = recv[..., 0].reshape(-1).long().clamp(0, g.ldeg.shape[0] - 1)
    return rows, recv[..., -1].reshape(-1) != 0


def _has_neighbor(g: PartitionedGraph, rows, live, targets, window: int):
    """``targets (B, K)`` among each row's neighbors: (B, K) bool.  ELL rows
    answer by one lane compare, others by the chunked window sweep over
    the ``live`` rows' largest degree."""
    B, K = targets.shape
    device = rows.device
    if g.ell is not None:
        row = g.ell[rows]
        lanes, deg = row[:, :-2], row[:, -2]
        in_deg = (torch.arange(lanes.shape[-1], device=device)[None, :]
                  < deg[:, None])
        return ((lanes[:, :, None] == targets[:, None, :])
                & in_deg[:, :, None]).any(dim=1)
    deg = g.ldeg[rows].long()
    lstart = g.lstart[rows].long()
    ecap = g.lindices.shape[0]
    hit = torch.zeros((B, K), dtype=torch.bool, device=device)
    for c in range(_window_chunks(deg, live, window)):
        pos = c * window + torch.arange(window, device=device)[None, :]
        ok = pos < deg[:, None]
        ids = g.lindices[(lstart[:, None] + pos).clamp(0, ecap - 1)]
        hit |= ((ids[:, :, None] == targets[:, None, :])
                & ok[:, :, None]).any(dim=1)
    return hit


# ---------------------------------------------------------------------------
# Shared step plumbing
# ---------------------------------------------------------------------------

def _route_step(g: PartitionedGraph, frontier, valid, extra_cols, owner_fn,
                *, axis, num_parts: int, capacity: int, num_rounds: int,
                ret_cols: int):
    """Route one walk step: payload ``[local_row, *extra_cols, 1]`` (the
    last column tells a request from an empty slot, :func:`_recv_rows`)."""
    gid = frontier.long().clamp(0, max(g.num_nodes - 1, 0))
    local = torch.div(gid, num_parts, rounding_mode="floor")
    payload = torch.stack([local.to(torch.int32)]
                          + [c.to(torch.int32) for c in extra_cols]
                          + [torch.ones_like(local, dtype=torch.int32)],
                          dim=-1)
    return exchange_rounds(payload, gid % num_parts, valid, owner_fn,
                           axis=axis, num_parts=num_parts, capacity=capacity,
                           num_rounds=num_rounds, ret_cols=ret_cols)


def _uids(dev: int, B: int, device) -> torch.Tensor:
    return dev * B + torch.arange(B, device=device)


# ---------------------------------------------------------------------------
# node2vec
# ---------------------------------------------------------------------------

def _dist_node2vec_device(key, g: PartitionedGraph, start, *, dev: int,
                          walk_length: int, p: float, q: float,
                          num_trials: int, axis, num_parts: int,
                          capacity_factor: float, num_rounds: int,
                          window: int):
    device = start.device
    B = start.shape[0]
    T = num_trials
    uid = _uids(dev, B, device)
    prob0, prob1, prob2 = node2vec_probs(p, q)
    cap1 = sample_capacity(capacity_factor, B, num_parts)
    capT = sample_capacity(capacity_factor, B * T, num_parts)
    route = dict(axis=axis, num_parts=num_parts, num_rounds=num_rounds)

    def cand_owner_fn(step_key):
        def owner_fn(recv):
            Pn, C, _ = recv.shape
            rows, _live = _recv_rows(g, recv)
            keys = _uid_keys(step_key, recv[..., 1].reshape(-1))
            if g.ell is not None:
                row = g.ell[rows]
                lanes, deg = row[:, :-2], row[:, -2]
            else:
                deg = g.ldeg[rows]
            pos = rng.randint_each(keys, (T,), 0,
                                   deg.long().clamp(min=1)[:, None])
            if g.ell is not None:
                cand = _select_lanes(lanes, pos)
            else:
                lptr = (g.lstart[rows].long()[:, None] + pos).clamp(
                    0, g.lindices.shape[0] - 1)
                cand = g.lindices[lptr]
            out = torch.cat([cand.to(torch.int32),
                             (deg > 0).to(torch.int32)[:, None]], dim=-1)
            return out.reshape(Pn, C, T + 1)
        return owner_fn

    def tri_owner_fn(recv):
        """has_edge(cand, prev): is ``prev`` among cand's neighbors?"""
        Pn, C, _ = recv.shape
        hit = _has_neighbor(g, *_recv_rows(g, recv),
                            recv[..., 1].reshape(-1, 1), window)
        return hit.to(torch.int32).reshape(Pn, C, 1)

    prev = torch.full((B,), -1, dtype=torch.int32, device=device)
    cur = start.to(torch.int32)
    active = torch.ones((B,), dtype=torch.bool, device=device)
    overflow = torch.zeros((), dtype=torch.long, device=device)
    steps = []
    for step_key in rng.split(key, walk_length):
        # exchange 1: cur's owner draws T uniform candidates and deg > 0
        res, got, ovf1 = _route_step(g, cur, active, [uid],
                                     cand_owner_fn(step_key), capacity=cap1,
                                     ret_cols=T + 1, **route)
        cand = res[:, :T]
        act = active & got & (res[:, T] != 0)
        # exchange 2: the candidates' owners answer has_edge(cand, prev)
        tri, tgot, ovf2 = _route_step(
            g, cand.reshape(-1), act[:, None].expand(B, T).reshape(-1),
            [prev[:, None].expand(B, T).reshape(-1)], tri_owner_fn,
            capacity=capT, ret_cols=1, **route)
        is_tri = (tri[:, 0] != 0).reshape(B, T) & tgot.reshape(B, T)
        # the requester's accept sweep; the last trial always accepts
        r = rng.uniform_each(_uid_keys(rng.fold_in(step_key, 1), uid), (T,))
        acc = torch.where(cand == prev[:, None], r < prob0,
                          torch.where(is_tri, r < prob1, r < prob2))
        acc[:, T - 1] = True
        first = primitives.argmax(acc.to(torch.uint8))
        chosen = cand.gather(1, first[:, None])[:, 0]
        nxt = torch.where(act, chosen, -1)
        prev = torch.where(act, cur, prev)
        cur = torch.where(act, nxt, cur)
        active = act
        steps.append(nxt)
        overflow = overflow + ovf1 + ovf2
    walks = torch.stack([start.to(torch.int32)] + steps, dim=1)
    return walks, overflow


def _walk_inputs(graph, mesh: Mesh, axis, start, *, timed: bool):
    Pn = mesh.axis_size(axis)
    _check_graph(graph, Pn, False, timed)
    start = torch.as_tensor(start if torch.is_tensor(start)
                            else np.asarray(start))
    if start.shape[0] % Pn:
        raise ValueError("the global start batch must divide the mesh axis")
    return Pn, start


def dist_random_walk(key, graph: PartitionedGraph, start, walk_length: int,
                     mesh: Mesh, *, p: float = 1.0, q: float = 1.0,
                     axis: str = "data", num_trials: int = 16,
                     capacity_factor: float = 1.3,
                     num_rounds: Optional[int] = None, window: int = 256):
    """Distributed node2vec walk (the reference's ``random_walk``).

    ``graph`` must be built from the CSR (rows are out-edges).  Returns
    ``(walks (P, B/P, L+1) int32, overflow (P,))``: concatenating the rank
    blocks gives the one-device ``(B, L+1)`` walks, a broken walk padded
    with -1.  At ``p == q == 1`` one trial a step suffices."""
    Pn, start = _walk_inputs(graph, mesh, axis, start, timed=False)
    if p == 1.0 and q == 1.0:
        num_trials = 1
    num_rounds = resolve_num_rounds(num_rounds, Pn)

    def body(gshard, start_local):
        return _dist_node2vec_device(
            key, gshard, start_local, dev=axis_index(axis),
            walk_length=int(walk_length), p=float(p), q=float(q),
            num_trials=int(num_trials), axis=axis, num_parts=Pn,
            capacity_factor=float(capacity_factor), num_rounds=num_rounds,
            window=int(window))

    on = (axis,)
    return along(mesh, axis, spmd(mesh, body, placed(graph, mesh, on),
                                  placed(start, mesh, on)))


# ---------------------------------------------------------------------------
# Temporal walk
# ---------------------------------------------------------------------------

def _dist_tempo_device(key, g: PartitionedGraph, start, start_ts, *,
                       dev: int, walk_length: int, win_lo: int, win_hi: int,
                       axis, num_parts: int, capacity_factor: float,
                       num_rounds: int, window: int):
    device = start.device
    B = start.shape[0]
    uid = _uids(dev, B, device)
    start = start.to(torch.int32)
    start_ts = start_ts.to(torch.int32)
    if walk_length <= 1:
        return (start[:, None], start_ts[:, None],
                torch.zeros((), dtype=torch.long, device=device))
    lo, hi = start_ts + win_lo, start_ts + win_hi
    root_nan = (start_ts == NAN_TIMESTAMP).to(torch.int32)
    cap = sample_capacity(capacity_factor, B, num_parts)

    def owner_fn_for(step_key):
        def owner_fn(recv):
            Pn, C, _ = recv.shape
            rows, live = _recv_rows(g, recv)
            keys = _uid_keys(step_key, recv[..., 1].reshape(-1))
            rlo, rhi = recv[..., 2].reshape(-1, 1), recv[..., 3].reshape(-1, 1)
            rnan = recv[..., 4].reshape(-1, 1) != 0

            def make_score(t, in_deg, kk, chunk):
                in_win = (t >= rlo) & (t < rhi)
                adm = in_deg & ((t == NAN_TIMESTAMP) | rnan | in_win)
                return torch.where(adm, _gumbel(kk, t.shape[-1], chunk),
                                   NEG_INF)

            nxt, nxt_ts, ok = _owner_step(g, keys, rows, live, make_score,
                                          window)
            out = torch.stack([nxt.to(torch.int32), nxt_ts.to(torch.int32),
                               ok.to(torch.int32)], dim=-1)
            return out.reshape(Pn, C, 3)
        return owner_fn

    everyone = torch.ones((B,), dtype=torch.bool, device=device)
    r_node, r_ts, cur = start, start_ts, start
    walk, walk_ts = [start], [start_ts]
    overflow = torch.zeros((), dtype=torch.long, device=device)
    for ell, step_key in enumerate(rng.split(key, walk_length - 1)):
        res, got, ovf = _route_step(
            g, cur, everyone, [uid, lo, hi, root_nan],
            owner_fn_for(step_key), axis=axis, num_parts=num_parts,
            capacity=cap, num_rounds=num_rounds, ret_cols=3)
        ok = got & (res[:, 2] != 0)
        # a dead end restarts from a reservoir-carried uniform earlier
        # position of the same walk
        nxt = torch.where(ok, res[:, 0], r_node)
        nxt_ts = torch.where(ok, res[:, 1], r_ts)
        u = rng.uniform_each(_uid_keys(rng.fold_in(step_key, 7), uid), ())
        take = u < 1.0 / torch.tensor(ell + 2, dtype=torch.float32)
        r_node = torch.where(take, nxt, r_node)
        r_ts = torch.where(take, nxt_ts, r_ts)
        cur = nxt
        walk.append(nxt)
        walk_ts.append(nxt_ts)
        overflow = overflow + ovf
    return torch.stack(walk, dim=1), torch.stack(walk_ts, dim=1), overflow


def _timed_walk(mesh: Mesh, axis, graph, start, start_ts, num_rounds,
                run):
    """Run ``run(gshard, start_local, ts_local, dev, P, num_rounds)`` on
    every rank of a timestamped walk."""
    Pn, start = _walk_inputs(graph, mesh, axis, start, timed=True)
    start_ts = torch.as_tensor(start_ts if torch.is_tensor(start_ts)
                               else np.asarray(start_ts)).to(torch.int32)
    num_rounds = resolve_num_rounds(num_rounds, Pn)

    def body(gshard, start_local, ts_local):
        return run(gshard, start_local, ts_local, axis_index(axis), Pn,
                   num_rounds)

    on = (axis,)
    return along(mesh, axis, spmd(mesh, body, placed(graph, mesh, on),
                                  placed(start, mesh, on),
                                  placed(start_ts, mesh, on)))


def dist_tempo_random_walk(key, graph: PartitionedGraph, start, start_ts,
                           walk_length: int, win, mesh: Mesh, *,
                           axis: str = "data", capacity_factor: float = 1.3,
                           num_rounds: Optional[int] = None,
                           window: int = 256):
    """Distributed temporal walk (the reference's ``tempo_random_walk``).

    ``graph`` must be built with ``edge_timestamps=effective_edge_ts(...)``.
    Returns ``(walks, walk_ts, overflow)``, walks and timestamps ``(P,
    B/P, L)`` int32, the window of walk ``b`` ``[start_ts[b] + win[0],
    start_ts[b] + win[1])``."""
    def run(gshard, start_local, ts_local, dev, Pn, rounds):
        return _dist_tempo_device(
            key, gshard, start_local, ts_local, dev=dev,
            walk_length=int(walk_length), win_lo=int(win[0]),
            win_hi=int(win[1]), axis=axis, num_parts=Pn,
            capacity_factor=float(capacity_factor), num_rounds=rounds,
            window=int(window))

    return _timed_walk(mesh, axis, graph, start, start_ts, num_rounds, run)


# ---------------------------------------------------------------------------
# CTDNE biased temporal walk
# ---------------------------------------------------------------------------

def _ctdne_log_weights(t, adm, ct, walk_bias: str, forward: bool):
    """Per-lane log weights of the bias, 0 where the walk's time is NaN."""
    wt = torch.where(t == NAN_TIMESTAMP, ct, t)
    if walk_bias == WALK_BIAS_EXPONENTIAL:
        logw = (ct - wt if forward else wt - ct).float()
    elif walk_bias == WALK_BIAS_LINEAR:
        # closeness rank over the whole row (the ELL table): the closest
        # admissible time weighs most
        key_t = torch.where(adm, wt, INT32_MAX)
        order = torch.argsort(key_t, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        n_adm = adm.sum(dim=1, keepdim=True)
        logw = torch.log((n_adm - rank).clamp(min=1).float())
    else:
        logw = torch.zeros(t.shape, device=t.device)
    return torch.where(ct == NAN_TIMESTAMP, 0.0, logw)


def _dist_ctdne_device(key, g: PartitionedGraph, start, start_ts, *,
                       dev: int, walk_length: int, walk_bias: str,
                       forward: bool, retry_count: int, axis,
                       num_parts: int, capacity_factor: float,
                       num_rounds: int, window: int):
    device = start.device
    B, L = start.shape[0], walk_length
    uid = _uids(dev, B, device)
    start = start.to(torch.int32)
    start_ts = start_ts.to(torch.int32)
    if L <= 1:
        return (start[:, None], start_ts[:, None],
                torch.zeros((), dtype=torch.long, device=device))
    cap = sample_capacity(capacity_factor, B, num_parts)

    def owner_fn_for(step_key):
        def owner_fn(recv):
            Pn, C, _ = recv.shape
            rows, live = _recv_rows(g, recv)
            keys = _uid_keys(step_key, recv[..., 1].reshape(-1))
            ct = recv[..., 2].reshape(-1, 1)

            def make_score(t, in_deg, kk, chunk):
                # forward in time; a missing timestamp always passes
                adm = in_deg & ((t == NAN_TIMESTAMP) | (ct == NAN_TIMESTAMP)
                                | (ct <= t))
                logw = _ctdne_log_weights(t, adm, ct, walk_bias, forward)
                return torch.where(
                    adm, logw + _gumbel(kk, t.shape[-1], chunk), NEG_INF)

            nxt, nxt_ts, ok = _owner_step(g, keys, rows, live, make_score,
                                          window)
            out = torch.stack([nxt.to(torch.int32), nxt_ts.to(torch.int32),
                               ok.to(torch.int32)], dim=-1)
            return out.reshape(Pn, C, 3)
        return owner_fn

    def attempt(att_key):
        cur, cur_ts = start, start_ts
        alive = torch.ones((B,), dtype=torch.bool, device=device)
        walk, walk_ts = [start], [start_ts]
        overflow = torch.zeros((), dtype=torch.long, device=device)
        for step_key in rng.split(att_key, L - 1):
            res, got, ovf = _route_step(
                g, cur, alive, [uid, cur_ts], owner_fn_for(step_key),
                axis=axis, num_parts=num_parts, capacity=cap,
                num_rounds=num_rounds, ret_cols=3)
            ok = alive & got & (res[:, 2] != 0)
            nxt, nxt_ts = res[:, 0], res[:, 1]
            cur = torch.where(ok, nxt, cur)
            # the walk's time moves only on a timestamped step
            cur_ts = torch.where(ok & (nxt_ts != NAN_TIMESTAMP), nxt_ts,
                                 cur_ts)
            alive = ok
            walk.append(torch.where(ok, nxt, -1))
            walk_ts.append(torch.where(ok, nxt_ts, -1))
            overflow = overflow + ovf
        return (torch.stack(walk, dim=1), torch.stack(walk_ts, dim=1), alive,
                overflow)

    # whole-walk retries while the group has a walk not done (the psum'd
    # count, read on the host).  Every rank of the mesh runs the same
    # attempts, so the collectives stay matched; on a mesh of more axes a
    # group with none left runs the others' attempts as no-ops
    mesh = current_mesh()
    whole = mesh.axes(axis) == mesh.axis_names
    walks = torch.full((B, L), -1, dtype=torch.int32, device=device)
    ts_buf = torch.full((B, L), -1, dtype=torch.int32, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    overflow = torch.zeros((), dtype=torch.long, device=device)
    for i in range(max(retry_count, 1)):
        remaining = int(psum((~done).sum(), axis))
        if not (remaining if whole else any_rank(torch.tensor(remaining))):
            break
        w, t, ok, o = attempt(rng.fold_in(key, i))
        if remaining:
            take = ~done[:, None]
            walks = torch.where(take, w, walks)
            ts_buf = torch.where(take, t, ts_buf)
            done = done | ok
            overflow = overflow + o
    return walks, ts_buf, overflow


def dist_biased_tempo_random_walk(key, graph: PartitionedGraph, start,
                                  start_ts, walk_length: int, walk_bias: str,
                                  mesh: Mesh, *, forward: bool = True,
                                  retry_count: int = 10, axis: str = "data",
                                  capacity_factor: float = 1.3,
                                  num_rounds: Optional[int] = None,
                                  window: int = 256):
    """Distributed CTDNE walk (the reference's ``biased_tempo_random_walk``).

    ``graph`` must be built with effective edge timestamps; the linear bias
    ranks whole rows, so it needs the ELL table.  Returns ``(walks,
    walk_ts, overflow)`` as :func:`dist_tempo_random_walk`; a walk no
    attempt completed holds its last attempt's steps, -1 past its dead
    end.  The outputs do not depend on ``num_rounds`` for every request
    that wins a slot (draws are keyed by request uid)."""
    if walk_bias not in (WALK_BIAS_UNIFORM, WALK_BIAS_LINEAR,
                         WALK_BIAS_EXPONENTIAL):
        raise ValueError(f"unknown walk bias {walk_bias!r}")
    g = graph.value if isinstance(graph, LocalShard) else graph
    if walk_bias == WALK_BIAS_LINEAR and g.ell is None:
        raise ValueError("the linear bias needs whole-row ranks: build "
                         "with ell_table=True")

    def run(gshard, start_local, ts_local, dev, Pn, rounds):
        return _dist_ctdne_device(
            key, gshard, start_local, ts_local, dev=dev,
            walk_length=int(walk_length), walk_bias=walk_bias,
            forward=bool(forward), retry_count=int(retry_count), axis=axis,
            num_parts=Pn, capacity_factor=float(capacity_factor),
            num_rounds=rounds, window=int(window))

    return _timed_walk(mesh, axis, graph, start, start_ts, num_rounds, run)
