"""Distributed neighbor sampling over a partitioned graph topology.

Counterpart of ``tch_geometric_tpu/parallel/dist_sampling.py`` (the flat
plan).  Each rank owns only the adjacency rows of the nodes ``v % P ==
rank`` (the feature table's interleaved owner rule), and every sampling hop
is a two-exchange protocol: an ``all_to_all`` routes frontier requests to
the owners of the frontier nodes, each owner samples its local rows, and a
second ``all_to_all`` routes the sampled (neighbor, edge pointer, valid,
state) tuples back.  No rank holds more than ``E / P`` edges or ``N / P``
feature rows.

Every draw is keyed by ``fold_in(fold(key, hop), slot_uid)``, ``slot_uid``
the node's slot in the global sample tree of the whole seed batch; the
requester ships the uid with the request and the owner folds it, so the
sampled trees are bit-identical for any number of ranks, and to the JAX
package's.

Static shapes: the per-owner request capacity of a hop is
``capacity_factor * ceil(L_hop / P)``; requests past it are retried in
further rounds (``num_rounds``), and what no round carries gives invalid
subtrees, counted in the returned overflow.

The trainers (``make_partitioned_trainer``,
``make_partitioned_multibatch_trainer``) shard everything graph-sized: per
step, distributed sampling (two ``all_to_all`` a hop), the distributed
feature fetch (two more), the local tree forward and backward, and the
gradient ``pmean``.  Under the hierarchical plan (``hier=(slice_axis,
chip_axis)``, a 2-axis mesh of S slices of C chips) the topology is split
over the chip axis and replicated over slices, so the sampling exchanges
span one slice's chips; the feature table stays split over all S*C ranks
and is fetched by :func:`_hier_feature_gather` (one slice-axis
``all_gather`` of the rank's shard, then a routed fetch over the chip
axis); gradients, loss and accuracy are reduced over both axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import ell_width_for
from ..sampling import primitives, rng
from ..sampling.neighbor import (NeighborSample, _filter_mask_from_ts,
                                 _layer_layout, _select_lanes,
                                 split_sample_batches)
from ..utils.adam import LearningRate, gradients, own_params
from ..utils.config import TEMPORAL_SAMPLE_DYNAMIC, TemporalEdgeFilter
from .mesh import (Axes, LocalShard, Mesh, Spec, all_gather, all_to_all,
                   along, any_rank, axis_index, pmean, psum, spmd, _tree_map)
from .multihost import placed
from .sharded_features import (DistTrainer, feature_capacity, halo_gather,
                               loss_and_acc, replica_init_fn, replica_update,
                               routed_row_fetch)
from .train import MultibatchTrainer, TrainState

NEG_INF = float("-inf")


@dataclasses.dataclass
class PartitionedGraph:
    """Interleave-partitioned CSC adjacency (device tensors).

    The owner of global node ``v`` is ``v % num_parts``, its local row
    ``v // num_parts``.  Every tensor has leading length ``P * rows_per_part``
    (or ``P * local_edge_cap``), so splitting it into P blocks gives each
    owner its shard.  ``lindices`` holds neighbor global ids (the sampled
    frontier is routed again next hop); ``gstart`` keeps each row's global
    CSC edge pointer, so emitted edge pointers stay in the global edge
    space.  All int32 (log-weights float32), as the JAX package holds them.
    """

    ldeg: torch.Tensor       # (P*Np,) row degree
    lstart: torch.Tensor     # (P*Np,) row start within the owner's shard
    gstart: torch.Tensor     # (P*Np,) global CSC edge ptr of the row
    lindices: torch.Tensor   # (P*Emax,) neighbor global ids
    # optional ELL rows: lanes [0, W-2) neighbor ids, W-2 degree, W-1 the
    # global start (data/graph.py's layout)
    ell: Optional[torch.Tensor] = None        # (P*Np, W)
    llogw: Optional[torch.Tensor] = None      # (P*Emax,) log edge weights
    lts: Optional[torch.Tensor] = None        # (P*Emax,) edge timestamps
    ell_logw: Optional[torch.Tensor] = None   # (P*Np, W-2) ELL-aligned
    ell_ts: Optional[torch.Tensor] = None     # (P*Np, W-2) ELL-aligned
    num_nodes: int = 0
    num_parts: int = 1
    rows_per_part: int = 0
    local_edge_cap: int = 0
    max_degree: int = 0

    def nbytes(self) -> int:
        """Bytes of every tensor the graph holds."""
        return sum(t.numel() * t.element_size()
                   for t in (self.ldeg, self.lstart, self.gstart,
                             self.lindices, self.ell, self.llogw, self.lts,
                             self.ell_logw, self.ell_ts) if t is not None)


def build_partitioned_graph(indptr, indices, num_parts: int, *,
                            edge_weights=None, edge_timestamps=None,
                            ell_table: Optional[bool] = None,
                            device="cuda") -> PartitionedGraph:
    """Global CSC -> interleaved per-owner shards, built by torch ops on
    ``device``: one stable sort of the edges by owner (the CSC's row order
    already is each owner's local row order) and a chunked ELL fill.
    Equal, array for array, to the JAX package's host build.  Log-weights
    are ``log(float32(w))`` taken by numpy on the host, as that build takes
    them."""
    device = torch.device(device)
    as_long = lambda a: torch.as_tensor(  # noqa: E731
        a if torch.is_tensor(a) else np.asarray(a)).to(device).long()
    indptr = as_long(indptr)
    indices = as_long(indices)
    N = indptr.shape[0] - 1
    E = indices.shape[0]
    Pn = int(num_parts)
    Np = -(-N // Pn) if N else 1
    deg = indptr[1:] - indptr[:-1]
    max_deg = int(deg.max()) if N else 0

    i32 = dict(dtype=torch.int32, device=device)
    ldeg = torch.zeros((Pn * Np,), **i32)
    lstart = torch.zeros((Pn * Np,), **i32)
    gstart = torch.zeros((Pn * Np,), **i32)
    counts = []
    for p in range(Pn):
        d = deg[p::Pn]
        n_p = d.shape[0]
        ldeg[p * Np: p * Np + n_p] = d.to(torch.int32)
        lstart[p * Np: p * Np + n_p] = (torch.cumsum(d, 0) - d).to(
            torch.int32)
        gstart[p * Np: p * Np + n_p] = indptr[:-1][p::Pn].to(torch.int32)
        counts.append(int(d.sum()) if n_p else 0)
    emax = max(1, max(counts) if N else 1)

    logw = None
    if edge_weights is not None:
        w = (edge_weights.cpu().numpy() if torch.is_tensor(edge_weights)
             else edge_weights)
        logw = torch.from_numpy(
            np.log(np.asarray(w, dtype=np.float32))).to(device)
    ts = None
    if edge_timestamps is not None:
        ts = torch.as_tensor(
            edge_timestamps if torch.is_tensor(edge_timestamps)
            else np.asarray(edge_timestamps)).to(device).to(torch.int32)

    lind = torch.zeros((Pn * emax,), **i32)
    llogw = (torch.zeros((Pn * emax,), dtype=torch.float32, device=device)
             if logw is not None else None)
    lts = torch.zeros((Pn * emax,), **i32) if ts is not None else None
    if E:
        edge_owner = torch.repeat_interleave(
            torch.arange(N, device=device), deg) % Pn
        _, order = torch.sort(edge_owner, stable=True)
        owner_sorted = edge_owner[order]
        starts_p = torch.tensor(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                                dtype=torch.long, device=device)
        dst = (torch.arange(E, device=device) - starts_p[owner_sorted]
               + emax * owner_sorted)
        lind[dst] = indices[order].to(torch.int32)
        if llogw is not None:
            llogw[dst] = logw[order]
        if lts is not None:
            lts[dst] = ts[order]

    W = ell_width_for(max_deg)
    if ell_table is None:
        ell_table = W is not None and N > 0
    ell = ell_logw = ell_ts = None
    if ell_table and W is not None and N > 0:
        ell = torch.zeros((Pn * Np, W), **i32)
        if logw is not None:
            ell_logw = torch.zeros((Pn * Np, W - 2), dtype=torch.float32,
                                   device=device)
        if ts is not None:
            ell_ts = torch.zeros((Pn * Np, W - 2), **i32)
        lane = torch.arange(W - 2, device=device)[None, :]
        chunk = 1 << 19                 # rows a chunk: bounds temporaries
        for p in range(Pn):
            rows = torch.arange(p, N, Pn, device=device)
            for lo in range(0, rows.shape[0], chunk):
                r = rows[lo: lo + chunk]
                offs = torch.clamp(indptr[r][:, None] + lane,
                                   max=max(E - 1, 0))
                sl = slice(p * Np + lo, p * Np + lo + r.shape[0])
                if E:
                    ell[sl, : W - 2] = indices[offs].to(torch.int32)
                if ell_logw is not None and E:
                    ell_logw[sl] = logw[offs]
                if ell_ts is not None and E:
                    ell_ts[sl] = ts[offs]
            n_p = rows.shape[0]
            ell[p * Np: p * Np + n_p, W - 2] = deg[rows].to(torch.int32)
            ell[p * Np: p * Np + n_p, W - 1] = indptr[rows].to(torch.int32)

    return PartitionedGraph(
        ldeg=ldeg, lstart=lstart, gstart=gstart, lindices=lind, ell=ell,
        llogw=llogw, lts=lts, ell_logw=ell_logw, ell_ts=ell_ts,
        num_nodes=N, num_parts=Pn, rows_per_part=Np, local_edge_cap=emax,
        max_degree=max_deg)


# ---------------------------------------------------------------------------
# Request routing (shared with sharded_features.routed_row_fetch)
# ---------------------------------------------------------------------------

class _Router(NamedTuple):
    """Routing plan for one owner-routed exchange (see _route_to_owners)."""

    rank: torch.Tensor     # (L,) position within the owner bucket among the
    #                        VALID requests; L for an invalid one
    ok: torch.Tensor       # (L,) bool: wins a round-0 slot
    scatter: Callable      # (payload (L,)|(L, Q), rnd) -> (P, C[, Q])
    pickup: Callable       # (back (P, C, ...), rnd) -> (L, ...) in request
    #                        order (garbage outside in_round(rnd))
    in_round: Callable     # rnd -> (L,) bool: carried in round rnd
    max_rounds: Optional[int]


def _owner_ranks(ow: torch.Tensor, valid: torch.Tensor, num_parts: int
                 ) -> torch.Tensor:
    """Each valid request's rank within its owner's bucket: the count of
    earlier valid requests to the same owner, in index order (an int64
    cumsum of the valid one-hot); -1 for an invalid request."""
    onehot = ((ow[:, None] == torch.arange(num_parts, device=ow.device))
              & valid[:, None]).long()
    csum = torch.cumsum(onehot, dim=0)
    return (csum * onehot).sum(-1) - 1


def _where_rows(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
    return torch.where(m, a, torch.zeros((), dtype=a.dtype, device=a.device))


def _route_to_owners(owner, valid, num_parts: int, capacity: int) -> _Router:
    """Routing plan: per-request owner rank with the capacity-overflow
    mask.  Invalid requests take no capacity; ``scatter`` packs payloads
    into their (P, C) owner slots (zeros elsewhere), ``pickup`` restores a
    response buffer to request order.

    Two plans, as in the JAX package: at ``num_parts == 1 and capacity >=
    L`` the packing is the identity (scatter pads, pickup slices, and
    invalid slots carry zeros as under the general plan); otherwise the
    counting ranks, one collision-free slot scatter (out-of-round requests
    are masked out, where JAX drops their out-of-range slots), one pack
    gather and one pickup gather."""
    L = owner.shape[0]
    device = owner.device

    if num_parts == 1 and capacity >= L:
        rank = torch.arange(L, device=device)
        none = torch.zeros((L,), dtype=torch.bool, device=device)

        def in_round(rnd: int):
            return valid if rnd == 0 else none

        def scatter(payload, rnd: int = 0):
            p = _where_rows(in_round(rnd), payload)
            if capacity > L:
                p = torch.cat([p, p.new_zeros((capacity - L,)
                                              + tuple(p.shape[1:]))])
            return p[None]

        def pickup(back, rnd: int = 0):
            return back.reshape((capacity,) + tuple(back.shape[2:]))[:L]

        return _Router(rank, valid, scatter, pickup, in_round, 1)

    ow = owner.long().clamp(0, num_parts - 1)
    rank = _owner_ranks(ow, valid, num_parts)
    rank = torch.where(valid, rank, L)
    ok = (rank < capacity) & valid
    idx = torch.arange(L, device=device)

    def in_round(rnd: int):
        return ((rank >= rnd * capacity) & (rank < (rnd + 1) * capacity)
                & valid)

    def scatter(payload, rnd: int = 0):
        ir = in_round(rnd)
        slot = ow * capacity + rank - rnd * capacity
        src = torch.full((num_parts * capacity,), L, dtype=torch.long,
                         device=device)
        src[slot[ir]] = idx[ir]
        req = _where_rows(src < L, payload[src.clamp(0, max(L - 1, 0))])
        return req.reshape((num_parts, capacity) + tuple(payload.shape[1:]))

    def pickup(back, rnd: int = 0):
        r = torch.where(in_round(rnd), rank - rnd * capacity, 0)
        return back[ow, r]

    return _Router(rank, ok, scatter, pickup, in_round, None)


def resolve_num_rounds(num_rounds, num_parts: int) -> int:
    """``None`` -> 1 at P = 1 (the identity plan carries everything in one
    round) and 2 at P > 1, so an overflowing frontier is retried rather
    than dropped; draws are keyed by request uid, so the outputs do not
    depend on which round carried a request."""
    if num_rounds is None:
        return 1 if int(num_parts) == 1 else 2
    return int(num_rounds)


def exchange_rounds(payload: torch.Tensor, owner, valid, owner_fn, *,
                    axis: str, num_parts: int, capacity: int,
                    num_rounds: int = 1, ret_cols: int = 1):
    """Owner-routed request/response exchange with overflow retries
    (inside ``spmd``).

    ``payload (L, Q) int32`` goes to each request's owner;
    ``owner_fn(recv (P, C, Q)) -> (P, C, ret_cols) int32`` runs there.
    Round ``r`` carries the per-owner ranks ``[r*C, (r+1)*C)``, one request
    and one response ``all_to_all`` each; a round after the first runs only
    if some rank of the mesh still has a request to carry
    (:func:`~.mesh.any_rank`), since an empty round changes nothing.  Returns
    ``(result (L, ret_cols) int32, got (L,) bool, overflow)``, ``overflow``
    the valid requests no round carried."""
    L = payload.shape[0]
    router = _route_to_owners(owner, valid, num_parts, capacity)
    rounds = (num_rounds if router.max_rounds is None
              else min(num_rounds, router.max_rounds))
    out = torch.zeros((L, ret_cols), dtype=torch.int32, device=payload.device)
    got = torch.zeros((L,), dtype=torch.bool, device=payload.device)
    for rnd in range(rounds):
        if rnd and not any_rank((valid & ~got).sum()):
            break
        in_round = router.in_round(rnd)
        req = router.scatter(payload, rnd)                    # (P, C, Q)
        res = owner_fn(all_to_all(req, axis))                 # (P, C, R)
        mine = router.pickup(all_to_all(res, axis), rnd)
        out = torch.where(in_round[:, None], mine, out)
        got = got | in_round
    return out, got, (valid & ~got).sum()


# ---------------------------------------------------------------------------
# Owner-side engines: one key per request uid
# ---------------------------------------------------------------------------

def _uid_keys(key_hop: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
    """Per-request counter-based keys: the global tree-slot uid folded in."""
    return rng.fold_in_many(key_hop, uids)


def _uid_uniform_lane_topk(keys, deg, num_lanes: int, k: int):
    """``uniform_lane_topk`` with one key per row (the same law)."""
    r = rng.uniform_each(keys, (num_lanes,))
    lane = torch.arange(num_lanes, device=deg.device)
    vals = torch.where(lane < deg.long()[:, None], r, NEG_INF)
    return primitives.topk_slots(vals, k)


def _uid_floyd(keys, deg, k: int):
    """``floyd_sample`` with one key per row (rows past the ELL width).
    Draw ``i`` is ``randint`` under ``fold_in(row key, i)`` in
    ``[0, deg - k + i]``; every draw is made at once, then Floyd's pass
    runs over them."""
    deg = deg.long()
    B = deg.shape[0]
    i = torch.arange(k, device=deg.device)
    j = deg[:, None] - (k - i)                                # (B, k)
    # fold_in(row key, i) for i < k is split(row key, k)[i]
    draws = rng.randint_each(rng.split_each(keys, k).reshape(-1, 2), (1,),
                             0, torch.clamp(j + 1, min=1).reshape(-1, 1))
    draws = draws.reshape(B, k)
    chosen = torch.full((B, k), -1, dtype=torch.long, device=deg.device)
    for n in range(k):
        t = draws[:, n]
        hit = (chosen == t[:, None]).any(dim=-1)
        chosen[:, n] = torch.where(hit, j[:, n], t)
    iota = torch.arange(k, device=deg.device)
    take_all = (deg <= k)[:, None]
    positions = torch.where(take_all, iota.expand_as(chosen), chosen)
    valid = torch.where(take_all, iota < deg[:, None], deg[:, None] > 0)
    return torch.where(valid, positions, 0), valid


def _uid_replacement(keys, deg, k: int):
    deg = deg.long()
    pos = rng.randint_each(keys, (k,), 0, torch.clamp(deg, min=1)[:, None])
    valid = (deg > 0)[:, None].expand(pos.shape)
    return torch.where(valid, pos, 0), valid


def _gumbel_noise(keys, shape):
    """``-log(-log(u))``, ``u`` uniform in [1e-12, 1) under each row's key,
    as the JAX engines draw it."""
    return -torch.log(-torch.log(rng.uniform_each(keys, shape, 1e-12)))


def _uid_gumbel_topk(keys, logits, k: int):
    """Gumbel top-k over (B, L) logits with one key per row: weighted
    sampling without replacement."""
    total = torch.where(torch.isfinite(logits),
                        logits + _gumbel_noise(keys, (logits.shape[-1],)),
                        NEG_INF)
    return primitives.topk_slots(total, k)


def _uid_gumbel_choice(keys, logits, k: int):
    """k independent weighted draws a row (with replacement): a Gumbel
    argmax per draw, one key per row."""
    noise = _gumbel_noise(keys, (k, logits.shape[-1]))
    total = torch.where(torch.isfinite(logits)[:, None, :],
                        logits[:, None, :] + noise, NEG_INF)
    pos = primitives.argmax(total)
    valid = torch.isfinite(total.amax(dim=-1))
    return torch.where(valid, pos, 0), valid


def _uid_window_sample(keys, deg, lstart_rows, llogw, lts, state, k: int, *,
                       max_degree: int, window: int, weighted: bool,
                       filter_cfg, with_replacement: bool):
    """Chunked weighted or filtered sampling for rows past the ELL width:
    the neighbor window in chunks with a running top-k (or per-draw max)
    carry, chunk ``c`` keyed ``fold_in(row key, c)``.  Returns (pos (B, k),
    valid (B, k))."""
    B = deg.shape[0]
    device = deg.device
    deg, lstart_rows = deg.long(), lstart_rows.long()
    n_chunks = max(1, -(-max(max_degree, 1) // window))
    ecap = (llogw.shape[0] if llogw is not None
            else lts.shape[0] if lts is not None else 1)

    def chunk_logits(c):
        pos = (c * window + torch.arange(window, device=device)).expand(
            B, window)
        ok = pos < deg[:, None]
        lptr = (lstart_rows[:, None] + pos).clamp(0, ecap - 1)
        logits = (llogw[lptr] if weighted else
                  torch.zeros((B, window), dtype=torch.float32,
                              device=device))
        if filter_cfg is not None:
            ok = ok & _filter_mask_from_ts(filter_cfg, lts[lptr], state)
        return pos, torch.where(ok, logits, NEG_INF)

    top_vals = torch.full((B, k), NEG_INF, device=device)
    top_pos = torch.zeros((B, k), dtype=torch.long, device=device)
    for c in range(n_chunks):
        pos, logits = chunk_logits(c)
        ck = rng.fold_in_each(keys, c)
        finite = torch.isfinite(logits)
        if not with_replacement:
            g = torch.where(finite, logits + _gumbel_noise(ck, (window,)),
                            NEG_INF)
            top_vals, idx = primitives.top_k(torch.cat([top_vals, g], 1), k)
            top_pos = torch.gather(torch.cat([top_pos, pos], 1), 1, idx)
        else:
            g = torch.where(finite[:, None, :],
                            logits[:, None, :]
                            + _gumbel_noise(ck, (k, window)), NEG_INF)
            chunk_best = g.amax(dim=-1)
            chunk_pos = c * window + primitives.argmax(g)
            better = chunk_best > top_vals
            top_vals = torch.where(better, chunk_best, top_vals)
            top_pos = torch.where(better, chunk_pos, top_pos)
    valid = torch.isfinite(top_vals)
    return torch.where(valid, top_pos, 0), valid


def _owner_sample(g: PartitionedGraph, key_hop, recv, k: int,
                  with_replacement: bool, weighted: bool, filter_cfg,
                  window: int):
    """Sample k in-edges for each received request (owner side).

    ``recv (P, C, 3)``: [local_row, slot_uid, filter_state] a request.
    Returns ``(neighbor, eptr, valid, new_state)``, each (P, C, k), in the
    requester's global id and global edge-pointer space."""
    Pn, C, _ = recv.shape
    rows = recv[..., 0].reshape(-1).long().clamp(0, g.ldeg.shape[0] - 1)
    keys = _uid_keys(key_hop, recv[..., 1].reshape(-1))
    state = recv[..., 2].reshape(-1)
    plain = not weighted and filter_cfg is None

    ts_sel = None
    if g.ell is not None:
        row = g.ell[rows]
        lanes, deg, starts = row[:, :-2], row[:, -2], row[:, -1]
        L = lanes.shape[-1]
        if plain:
            if with_replacement:
                pos, pvalid = _uid_replacement(keys, deg, k)
            else:
                pos, pvalid = _uid_uniform_lane_topk(keys, deg, L, k)
        else:
            ok = (torch.arange(L, device=rows.device)[None, :]
                  < deg.long()[:, None])
            logits = (g.ell_logw[rows] if weighted else
                      torch.zeros((rows.shape[0], L), dtype=torch.float32,
                                  device=rows.device))
            tsl = None
            if filter_cfg is not None:
                tsl = g.ell_ts[rows]
                ok = ok & _filter_mask_from_ts(filter_cfg, tsl, state)
            logits = torch.where(ok, logits, NEG_INF)
            engine = (_uid_gumbel_choice if with_replacement
                      else _uid_gumbel_topk)
            pos, pvalid = engine(keys, logits, k)
            if tsl is not None:
                ts_sel = _select_lanes(tsl, pos.clamp(0, L - 1))
        neighbor = _select_lanes(lanes, pos.clamp(0, L - 1))
        eptr = starts.long()[:, None] + pos
    else:
        deg = g.ldeg[rows]
        lstart_rows = g.lstart[rows]
        if plain:
            if with_replacement:
                pos, pvalid = _uid_replacement(keys, deg, k)
            else:
                pos, pvalid = _uid_floyd(keys, deg, k)
        else:
            pos, pvalid = _uid_window_sample(
                keys, deg, lstart_rows, g.llogw, g.lts, state, k,
                max_degree=g.max_degree, window=window, weighted=weighted,
                filter_cfg=filter_cfg, with_replacement=with_replacement)
        lptr = (lstart_rows.long()[:, None] + pos).clamp(
            0, g.lindices.shape[0] - 1)
        neighbor = g.lindices[lptr]
        eptr = g.gstart[rows].long()[:, None] + pos
        if filter_cfg is not None:
            ts_sel = g.lts[lptr]

    # TemporalFilter::mutate: DYNAMIC carries the sampled edge's timestamp,
    # STATIC and RELATIVE keep the state
    if filter_cfg is not None and filter_cfg.mode == TEMPORAL_SAMPLE_DYNAMIC:
        new_state = ts_sel
    else:
        new_state = state[:, None].expand(state.shape[0], k)

    shape = (Pn, C, k)
    return (neighbor.reshape(shape).to(torch.int32),
            eptr.reshape(shape).to(torch.int32), pvalid.reshape(shape),
            new_state.reshape(shape).to(torch.int32))


def _exchange_hop(key_hop, graph_shard: PartitionedGraph, frontier, fvalid,
                  fuid, fstate, k: int, *, axis: str, num_parts: int,
                  capacity: int, with_replacement: bool, weighted: bool,
                  filter_cfg, window: int, num_rounds: int = 1):
    """One distributed hop: route, owner-sample, route back (inside
    ``spmd``).  Returns ``(neighbor, eptr, valid, new_state)``, each (L, k),
    and the overflow."""
    g = graph_shard
    gid = frontier.long().clamp(0, max(g.num_nodes - 1, 0))
    owner = gid % num_parts
    local = torch.div(gid, num_parts, rounding_mode="floor")

    def owner_fn(recv):
        neighbor, eptr, pvalid, new_state = _owner_sample(
            g, key_hop, recv, k, with_replacement, weighted, filter_cfg,
            window)
        return torch.cat([neighbor, eptr, pvalid.to(torch.int32),
                          new_state], dim=-1)                 # (P, C, 4k)

    payload = torch.stack([local.to(torch.int32), fuid.to(torch.int32),
                           fstate.to(torch.int32)], dim=-1)   # (L, 3)
    mine, got, overflow = exchange_rounds(
        payload, owner, fvalid, owner_fn, axis=axis, num_parts=num_parts,
        capacity=capacity, num_rounds=num_rounds, ret_cols=4 * k)
    neighbor = mine[:, :k]
    eptr = mine[:, k: 2 * k]
    valid = (mine[:, 2 * k: 3 * k] != 0) & got[:, None]
    new_state = mine[:, 3 * k:]
    return neighbor, eptr, valid, new_state, overflow


def sample_capacity(capacity_factor: float, L: int, num_parts: int) -> int:
    """The sampler's per-owner capacity of a hop: ``ceil(cf * L / P)``
    clamped to [1, L] (python floats, as the JAX package computes it)."""
    return max(1, min(int(math.ceil(capacity_factor * L / num_parts)), L))


def _dist_sample_device(key, graph_shard: PartitionedGraph, seeds_local, *,
                        dev: int, fanouts: Tuple[int, ...], axis: str,
                        num_parts: int, total_seeds: int,
                        capacity_factor: float, with_replacement: bool,
                        weighted: bool = False, filter_static=None,
                        seed_state=None, window: int = 256,
                        num_rounds: int = 1, seed_gidx=None):
    """Multi-hop distributed sampling of one rank's seed shard (inside
    ``spmd``): ``_sample_neighbors_impl``'s slot arithmetic, draws keyed by
    the global tree slot uid.  ``seed_gidx`` (B0,): each local seed's index
    in the global batch (default the contiguous ``dev*B0 + arange``); a
    child's is ``g_parent*k + j``.  Returns (NeighborSample, overflow)."""
    device = seeds_local.device
    B0 = seeds_local.shape[0]
    node_base, edge_base = _layer_layout(B0, fanouts)
    gnode_base, _ = _layer_layout(total_seeds, fanouts)

    filter_cfg = None
    if filter_static is not None:
        w, fwd, mode = filter_static
        filter_cfg = TemporalEdgeFilter(window=w, forward=fwd, mode=mode)

    nodes = [seeds_local.long()]
    valids = [torch.ones((B0,), dtype=torch.bool, device=device)]
    states = [torch.zeros((B0,), dtype=torch.int32, device=device)
              if seed_state is None else seed_state.to(torch.int32)]
    rows, cols, eptrs, evalids = [], [], [], []
    overflow = torch.zeros((), dtype=torch.long, device=device)

    L = B0
    gidx = (dev * B0 + torch.arange(B0, device=device)
            if seed_gidx is None else seed_gidx.long())
    for ell, k in enumerate(fanouts):
        frontier, fvalid, fstate = nodes[ell], valids[ell], states[ell]
        fuid = gnode_base[ell] + gidx
        neighbor, eptr, valid, new_state, ovf = _exchange_hop(
            rng.fold(key, ell), graph_shard, frontier, fvalid, fuid, fstate,
            k, axis=axis, num_parts=num_parts,
            capacity=sample_capacity(capacity_factor, L, num_parts),
            with_replacement=with_replacement, weighted=weighted,
            filter_cfg=filter_cfg, window=window, num_rounds=num_rounds)
        overflow = overflow + ovf
        slot = node_base[ell + 1] + (
            torch.arange(L, device=device)[:, None] * k
            + torch.arange(k, device=device)[None, :])
        col = node_base[ell] + torch.arange(L, device=device)[:, None]
        nodes.append(neighbor.reshape(-1).long())
        valids.append(valid.reshape(-1))
        states.append(new_state.reshape(-1))
        rows.append(slot.reshape(-1))
        cols.append(col.expand(L, k).reshape(-1))
        eptrs.append(eptr.reshape(-1).long())
        evalids.append(valid.reshape(-1))
        gidx = (gidx[:, None] * k
                + torch.arange(k, device=device)[None, :]).reshape(-1)
        L = L * k

    sample = NeighborSample(
        nodes=torch.cat(nodes), node_valid=torch.cat(valids),
        node_state=torch.cat(states).long(), rows=torch.cat(rows),
        cols=torch.cat(cols), eptr=torch.cat(eptrs),
        edge_valid=torch.cat(evalids), node_base=node_base,
        edge_base=edge_base, fanouts=tuple(fanouts))
    return sample, overflow


def _filter_static(filter):
    return (tuple(int(v) for v in filter[0]), bool(filter[1]),
            int(filter[2]))


def _check_graph(graph, num_parts: int, weighted: bool, filtered: bool):
    g = graph.value if isinstance(graph, LocalShard) else graph
    if g.num_parts != num_parts:
        raise ValueError(
            f"graph was partitioned for {g.num_parts} ranks but the mesh "
            f"axis has {num_parts}: rebuild with build_partitioned_graph("
            f"..., num_parts={num_parts})")
    if weighted and g.llogw is None:
        raise ValueError("weighted sampling needs edge_weights at "
                         "build_partitioned_graph")
    if filtered and g.lts is None:
        raise ValueError("a temporal filter needs edge_timestamps at "
                         "build_partitioned_graph")


def dist_sample_neighbors(key, graph: PartitionedGraph, seeds, fanouts,
                          mesh: Mesh, *, axis: str = "data",
                          with_replacement: bool = False,
                          weighted: bool = False,
                          filter: Optional[tuple] = None,
                          capacity_factor: float = 1.3, window: int = 256,
                          num_rounds: Optional[int] = None):
    """Distributed multi-hop neighbor sampling (the public entry point).

    ``seeds (B,)`` is the global seed batch (B divisible by the axis); the
    result's tensors have a leading rank axis, ``nodes (P, L)`` etc., rank
    d's block the tree of seeds ``[d*B/P, (d+1)*B/P)`` (under a process
    group, ``(1, L)``: this process's block).  On a mesh of more axes,
    ``axis`` may be any one of them (or a tuple): the graph and seeds split
    over it and replicate over the others.  Concatenating the blocks
    layer by layer gives the P = 1 tree bit-exactly.  Returns ``(sample,
    overflow (P,))``.

    ``weighted=True`` samples in proportion to the ``edge_weights`` given
    to :func:`build_partitioned_graph` (Gumbel top-k); ``filter`` is
    ``(((lo, hi), forward, mode), seed_state (B,) or None)``, the 3-mode
    temporal filter evaluated by the owner against its timestamps with each
    path's state carried in the request."""
    Pn = mesh.axis_size(axis)
    fanouts = tuple(int(k) for k in fanouts)
    seeds = torch.as_tensor(seeds if torch.is_tensor(seeds)
                            else np.asarray(seeds))
    B = seeds.shape[0]
    if B % Pn:
        raise ValueError("the global seed batch must divide the mesh axis")
    filter_static, seed_state = None, None
    if filter is not None:
        filter_static, seed_state = filter
        filter_static = _filter_static(filter_static)
    _check_graph(graph, Pn, weighted, filter_static is not None)
    if seed_state is None:
        seed_state = torch.zeros((B,), dtype=torch.int32)
    seed_state = torch.as_tensor(
        seed_state if torch.is_tensor(seed_state)
        else np.asarray(seed_state)).to(torch.int32)
    num_rounds = resolve_num_rounds(num_rounds, Pn)
    total = B

    def body(gshard, seeds_local, state_local):
        return _dist_sample_device(
            key, gshard, seeds_local, dev=axis_index(axis), fanouts=fanouts,
            axis=axis, num_parts=Pn, total_seeds=total,
            capacity_factor=float(capacity_factor),
            with_replacement=bool(with_replacement), weighted=bool(weighted),
            filter_static=filter_static, seed_state=state_local,
            window=int(window), num_rounds=num_rounds)

    on = (axis,)
    return along(mesh, axis, spmd(
        mesh, body, placed(graph, mesh, on), placed(seeds, mesh, on),
        placed(seed_state, mesh, on)))


# ---------------------------------------------------------------------------
# Fully partitioned training: topology and features both sharded
# ---------------------------------------------------------------------------

class _Plan(NamedTuple):
    """Where a partitioned trainer's values live and what its collectives
    span: the flat plan over ``axis``, or the hierarchical one."""
    num_parts: int          # feature-table partitions (seed-batch blocks)
    samp_axis: Axes         # the sampling exchanges and the graph's split
    samp_parts: int
    reduce_axes: Axes       # gradients, loss, accuracy, overflow
    shard: Spec             # seeds, labels and features
    graph_spec: Spec
    hier: Optional[Tuple[str, str]]

    def dev(self) -> int:
        """This rank's block of the global seed batch (inside ``spmd``):
        ``slice_index * C + chip_index`` under ``hier``."""
        return axis_index(self.reduce_axes)


def _plan(mesh: Mesh, axis: str, hier) -> _Plan:
    if hier is None:
        n = mesh.axis_size(axis)
        return _Plan(n, axis, n, axis, (axis,), (axis,), None)
    ax_slice, ax_chip = hier
    both = mesh.axes((ax_slice, ax_chip))
    chips = mesh.axis_size(ax_chip)
    return _Plan(mesh.axis_size(both), ax_chip, chips, both, (both,),
                 (ax_chip,), (ax_slice, ax_chip))


def _hier_feature_gather(x_shard, ids, *, ax_slice: str, ax_chip: str,
                         num_slices: int, chips_per_slice: int,
                         capacity: int, valid=None, num_rounds: int = 1):
    """The hierarchical feature fetch (inside ``spmd``): an ``all_gather``
    of this rank's shard over the slice axis, then a routed fetch over the
    chip axis.

    ``x_shard (Np, F)``: the rank's shard of the table interleaved over
    all P = S*C ranks (rank ``s*C + c`` owns the rows ``i % P == s*C +
    c``).  The gathered ``(S*Np, F)`` table holds every row whose owner
    has this rank's chip index, so a request for ``id`` goes to chip ``id %
    C`` and reads local row ``((id % P) // C) * Np + id // P`` there.
    Returns ``((L, F) rows, overflow)``, the rows bit-identical to the flat
    :func:`~.sharded_features.halo_gather` of the same ids."""
    S, C = num_slices, chips_per_slice
    P = S * C
    Np = x_shard.shape[0]
    if valid is None:
        valid = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    table = all_gather(x_shard, ax_slice).reshape(S * Np, x_shard.shape[-1])
    ids = ids.long()
    owner_chip = ids % C
    local = torch.div(ids % P, C, rounding_mode="floor") * Np \
        + torch.div(ids, P, rounding_mode="floor")
    return routed_row_fetch(table, owner_chip, local, valid, axis=ax_chip,
                            num_parts=C, capacity=capacity,
                            num_rounds=num_rounds)


def _fetch(x_shard, sample, plan: _Plan, *, capacity_factor, num_rounds,
           exchange_dtype):
    """The tree's feature rows by the owner-routed fetch (flat or
    hierarchical): (x, overflow).  With ``exchange_dtype`` the rows
    travel, and reach the model, in that dtype."""
    n_rows = x_shard.shape[0] * plan.num_parts
    ids = sample.nodes.clamp(0, n_rows - 1)
    table = x_shard if exchange_dtype is None else x_shard.to(exchange_dtype)
    cap = feature_capacity(capacity_factor, ids.shape[0], plan.samp_parts)
    if plan.hier is None:
        return halo_gather(table, ids, axis=plan.samp_axis,
                           num_parts=plan.num_parts, capacity=cap,
                           valid=sample.node_valid, num_rounds=num_rounds)
    ax_slice, ax_chip = plan.hier
    return _hier_feature_gather(
        table, ids, ax_slice=ax_slice, ax_chip=ax_chip,
        num_slices=plan.num_parts // plan.samp_parts,
        chips_per_slice=plan.samp_parts, capacity=cap,
        valid=sample.node_valid, num_rounds=num_rounds)


def make_partitioned_trainer(
    model,
    fanouts: Sequence[int],
    mesh: Mesh,
    *,
    axis: str = "data",
    learning_rate: LearningRate = 1e-2,
    with_replacement: bool = False,
    weighted: bool = False,
    filter: Optional[tuple] = None,
    window: int = 256,
    capacity_factor: float = 1.3,
    num_rounds: Optional[int] = None,
    exchange_dtype=None,
    hier: Optional[Tuple[str, str]] = None,
) -> DistTrainer:
    """Sampled-training closures where nothing graph-sized is replicated:
    the adjacency is a :class:`PartitionedGraph`, the features are
    interleave-sharded (``build_interleaved_features``), the seeds and
    labels split over the same axis.

    ``init_fn(key, graph, x_sharded, seeds[, seed_ts]) -> TrainState``.
    ``train_step(state, key, graph, x_sharded, seeds, labels, seed_ts=None)
    -> (state, loss, acc, overflow)``: step key ``fold(key, step)``, the
    same on every rank (the trees are keyed by global uid), dropout keyed
    ``fold(step_key, DROPOUT_STREAM)`` over each rank's own tree;
    gradients, loss and accuracy averaged and the (sampling + feature)
    overflow summed over ``axis``; one Adam update of the model's
    parameters in place.  ``eval_step(state, key, graph, x_sharded, seeds,
    labels, seed_ts=None) -> (loss, acc)``, dropout off, key ``fold(key,
    2**20)``.

    ``weighted=True`` trains on weight-proportional samples (the graph
    built with ``edge_weights``); ``filter=((lo, hi), forward, mode)`` the
    temporal filter, ``seed_ts`` each seed's root timestamp (zeros when
    omitted).  ``exchange_dtype`` (e.g. ``torch.bfloat16``): the feature
    rows travel in it and the model takes them so, promoting per op as jnp
    does (a float32 model averages the children in bfloat16 and runs its
    linears in float32).

    ``hier=(slice_axis, chip_axis)`` (in mesh order) runs the hierarchical
    plan (module doc): build the graph with ``num_parts = C`` (the chip
    axis' size; it is split over the chip axis and replicated over
    slices) and the features interleaved over all S*C ranks; seeds,
    labels and features split over ``(slice_axis, chip_axis)``, rank
    ``s*C + c`` holding block ``s*C + c``.  The trees, the fetched rows and
    so the losses are those of the flat plan over S*C ranks."""
    fanouts = tuple(int(k) for k in fanouts)
    plan = _plan(mesh, axis, hier)
    num_rounds = resolve_num_rounds(num_rounds, plan.num_parts)
    filter_static = None if filter is None else _filter_static(filter)
    red = plan.reduce_axes

    def logits_of(key, gshard, x_shard, seeds_local, ts_local,
                  deterministic):
        sample, s_ovf = _dist_sample_device(
            key, gshard, seeds_local, dev=plan.dev(), fanouts=fanouts,
            axis=plan.samp_axis, num_parts=plan.samp_parts,
            total_seeds=seeds_local.shape[0] * plan.num_parts,
            capacity_factor=capacity_factor,
            with_replacement=with_replacement, weighted=weighted,
            filter_static=filter_static, seed_state=ts_local, window=window,
            num_rounds=num_rounds)
        x, f_ovf = _fetch(x_shard, sample, plan,
                          capacity_factor=capacity_factor,
                          num_rounds=num_rounds,
                          exchange_dtype=exchange_dtype)
        logits = model.tree_forward(
            sample, x, deterministic=deterministic,
            dropout_key=rng.fold(key, rng.DROPOUT_STREAM))
        return logits, s_ovf + f_ovf

    def arguments(graph, x_sharded, seeds, labels, seed_ts):
        _check_graph(graph, plan.samp_parts, weighted,
                     filter_static is not None)
        if seed_ts is None:
            seed_ts = torch.zeros(np.shape(seeds), dtype=torch.int32)
        return ([placed(graph, mesh, plan.graph_spec)]
                + [placed(v, mesh, plan.shard)
                   for v in (x_sharded, seeds, labels, seed_ts)])

    def train_step(state: TrainState, key, graph, x_sharded, seeds, labels,
                   seed_ts=None):
        own_params(model, state.params)
        step_key = rng.fold(key, state.step)
        holder = {"opt": state.opt_state}

        def body(gshard, x_shard, seeds_local, labels_local, ts_local):
            logits, overflow = logits_of(step_key, gshard, x_shard,
                                         seeds_local, ts_local, False)
            loss, acc = loss_and_acc(logits, labels_local)
            grads = gradients(loss, state.params)
            replica_update(state.params, grads, holder, learning_rate, red)
            return (pmean(loss.detach(), red), pmean(acc, red),
                    psum(overflow, red))

        loss, acc, overflow = spmd(mesh, body, *arguments(
            graph, x_sharded, seeds, labels, seed_ts))
        return (TrainState(state.params, holder["opt"], state.step + 1),
                loss[0], acc[0], overflow[0])

    @torch.no_grad()
    def eval_step(state, key, graph, x_sharded, seeds, labels, seed_ts=None):
        if isinstance(state, TrainState):
            own_params(model, state.params)
        k = rng.fold(key, 1 << 20)

        def body(gshard, x_shard, seeds_local, labels_local, ts_local):
            logits, _ = logits_of(k, gshard, x_shard, seeds_local, ts_local,
                                  True)
            loss, acc = loss_and_acc(logits, labels_local)
            return pmean(loss, red), pmean(acc, red)

        loss, acc = spmd(mesh, body, *arguments(graph, x_sharded, seeds,
                                                labels, seed_ts))
        return loss[0], acc[0]

    return DistTrainer(replica_init_fn(mesh, model), train_step, eval_step)


def _rank_major(a, num_parts: int):
    """(M, B) -> (P*M, B/P): rank d's rows are columns ``[d*B/P,
    (d+1)*B/P)`` of every batch, so a leading-axis split gives each rank its
    (M, B/P) stripe."""
    if isinstance(a, LocalShard):
        return a
    t = torch.as_tensor(a if torch.is_tensor(a) else np.asarray(a))
    M, B = t.shape
    if B % num_parts:
        raise ValueError("each batch must divide the mesh axis")
    return t.reshape(M, num_parts, B // num_parts).transpose(0, 1).reshape(
        num_parts * M, B // num_parts)


def make_partitioned_multibatch_trainer(
    model,
    fanouts: Sequence[int],
    mesh: Mesh,
    *,
    axis: str = "data",
    learning_rate: LearningRate = 1e-2,
    with_replacement: bool = False,
    window: int = 256,
    capacity_factor: float = 1.3,
    num_rounds: Optional[int] = None,
    exchange_dtype=None,
    hier: Optional[Tuple[str, str]] = None,
) -> MultibatchTrainer:
    """Fully partitioned trainer that takes M minibatches a step.

    ``train_step(state, key, graph, x_sharded, seeds (M, B), labels (M, B))
    -> (state, losses (M,), accs (M,), overflow)``: one distributed tree of
    all M*B seeds (every exchange and the feature fetch amortised over M),
    keyed by each seed's true global index ``m*B + d*B/P + j`` under the
    (M, B/P) stripes, split into M per-batch trees
    (``split_sample_batches``), then M forward/backward/Adam updates in
    turn, each with its gradient ``pmean`` and dropout key ``fold(step_key,
    m, DROPOUT_STREAM)``.  ``exchange_dtype`` and ``hier`` as in
    :func:`make_partitioned_trainer`; under ``hier`` the stripes are
    rank-major over both axes (``P(None, (slice, chip))``), ``d = s*C +
    c``."""
    fanouts = tuple(int(k) for k in fanouts)
    plan = _plan(mesh, axis, hier)
    num_parts = plan.num_parts
    num_rounds = resolve_num_rounds(num_rounds, num_parts)
    red = plan.reduce_axes

    def train_step(state: TrainState, key, graph, x_sharded, seeds, labels):
        own_params(model, state.params)
        _check_graph(graph, plan.samp_parts, False, False)
        step_key = rng.fold(key, state.step)
        holder = {"opt": state.opt_state}

        def body(gshard, x_shard, seeds_local, labels_local):
            M, Bp = seeds_local.shape
            dev = plan.dev()
            gidx = (torch.arange(M, device=seeds_local.device)[:, None]
                    * (Bp * num_parts) + dev * Bp
                    + torch.arange(Bp, device=seeds_local.device)[None, :]
                    ).reshape(-1)
            sample, s_ovf = _dist_sample_device(
                step_key, gshard, seeds_local.reshape(-1), dev=dev,
                fanouts=fanouts, axis=plan.samp_axis,
                num_parts=plan.samp_parts, total_seeds=M * Bp * num_parts,
                capacity_factor=capacity_factor,
                with_replacement=with_replacement, window=window,
                num_rounds=num_rounds, seed_gidx=gidx)
            x, f_ovf = _fetch(x_shard, sample, plan,
                              capacity_factor=capacity_factor,
                              num_rounds=num_rounds,
                              exchange_dtype=exchange_dtype)
            split, xs = split_sample_batches(sample, M, x)
            losses, accs = [], []
            for m in range(M):
                sample_m = _tree_map(lambda a: a[m], split)
                logits = model.tree_forward(
                    sample_m, xs[m], deterministic=False,
                    dropout_key=rng.fold(step_key, m, rng.DROPOUT_STREAM))
                loss, acc = loss_and_acc(logits, labels_local[m])
                grads = gradients(loss, state.params)
                replica_update(state.params, grads, holder, learning_rate,
                               red)
                losses.append(pmean(loss.detach(), red))
                accs.append(pmean(acc, red))
            return (torch.stack(losses), torch.stack(accs),
                    psum(s_ovf + f_ovf, red))

        losses, accs, overflow = spmd(
            mesh, body, placed(graph, mesh, plan.graph_spec),
            placed(x_sharded, mesh, plan.shard),
            placed(_rank_major(seeds, num_parts), mesh, plan.shard),
            placed(_rank_major(labels, num_parts), mesh, plan.shard))
        return (TrainState(state.params, holder["opt"], state.step + 1),
                losses[0], accs[0], overflow[0])

    return MultibatchTrainer(replica_init_fn(mesh, model), train_step)
