"""Distributed HGT sampling over a partitioned heterogeneous topology, and
the partitioned heterogeneous layouts it runs on.

Counterpart of ``tch_geometric_tpu/parallel/dist_hgt.py``.  The HGT
sampler keeps a per-type budget (node -> score, time), adds to it along the
in-edges of every newly sampled node, and samples ``num_samples[t][hop]``
nodes of each type with probability proportional to score squared.  Over
the partition the budget itself is sharded:

* **Budget tables** follow the ownership rule (node ``v`` lives at rank
  ``v % P``, row ``v // P``): per-rank score, budget time, in-sample flag
  and output slot a type.
* **The budget update** is two routed exchanges a relation: the new nodes
  route to their adjacency owner, who draws a uniform subset of at most 50
  in-edges (keyed by the node's output slot) and returns (source id,
  effective timestamp, subset size); the contributions then route one way
  to each source's budget owner, who adds ``SCORE_ONE // size`` (an int32
  fixed-point score: integer adds are exact in any order, so the budgets,
  and the whole sample, do not depend on P) and takes the max of the
  timestamps.  A source already in the sample takes no score.
* **The score-squared draw** is a distributed top-k: each owner perturbs
  ``2 * log(score)`` of its rows by Gumbel noise keyed by the global node
  id, takes its local top-n, and every rank takes the same global top-n of
  the all-gathered candidates.
* **The induced adjacency**: each sampled destination routes to its
  adjacency owner for its subset of in-edges, and each candidate source to
  its budget owner, who answers whether it is in the sample and its slot.

Work splits by slicing every replicated node list ``P`` ways.  Three
program structures over the relations give the same sample when nothing
overflows: one exchange pair a relation on the per-relation dict
(``stacked=False``), and on :class:`StackedRels` either all relations'
requests in one exchange a phase (``"fused"``) or one relation at a time
at the stacked capacity (``"scan"``).  The layouts: one partitioned graph
a relation, or all relations stacked into one padded container whose
owner-block axis stays first and relation axis second, so the split that
gives each rank its block of a per-relation graph gives it its block of
every relation at once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..sampling import primitives, rng
from ..sampling.hgt import MAX_NEIGHBORS
from ..sampling.neighbor import _select_lanes
from ..utils.types import NAN_TIMESTAMP, rel_key
from .dist_budget import _owner_fill
from .dist_sampling import (PartitionedGraph, _check_graph, _route_to_owners,
                            _uid_floyd, _uid_keys, _uid_uniform_lane_topk,
                            build_partitioned_graph, exchange_rounds,
                            resolve_num_rounds, sample_capacity)
from .mesh import (Mesh, all_gather, all_to_all, along, any_rank, axis_index,
                   spmd)
from .multihost import placed, put_partitioned

NEG_INF = float("-inf")
SCORE_ONE = 1 << 14     # fixed-point unit: a contribution is SCORE_ONE // size


def build_partitioned_hetero(col_ptrs, row_indices, edge_types, num_parts,
                             *, edge_timestamps=None,
                             node_counts: Optional[Dict[str, int]] = None,
                             device="cuda") -> Dict[str, PartitionedGraph]:
    """One :func:`~.dist_sampling.build_partitioned_graph` a relation:
    ``col_ptrs[r]`` / ``row_indices[r]`` its CSC (rows are the dst nodes),
    ``edge_timestamps[r]`` its timestamps by sorted edge where given.  Each
    relation decides its own ELL table from its own largest degree.
    ``node_counts`` is accepted for the JAX signature (the HGT sampler's
    budget tables need it); the layouts do not."""
    rels = {}
    for e in edge_types:
        r = rel_key(tuple(e))
        ts = None
        if edge_timestamps is not None and r in edge_timestamps:
            ts = edge_timestamps[r]
        rels[r] = build_partitioned_graph(col_ptrs[r], row_indices[r],
                                          num_parts, edge_timestamps=ts,
                                          device=device)
    return rels


def _pad_to(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """``x`` (1-d) padded with ``fill`` to length ``n``."""
    out = x.new_full((n,), fill)
    out[: x.shape[0]] = x
    return out


@dataclasses.dataclass
class StackedRels:
    """Every relation's :class:`~.dist_sampling.PartitionedGraph` tensors
    stacked on a relation axis, padded to common shapes.

    The owner-block axis stays first and the relation axis second, so a
    split of the leading axis into P blocks gives each rank its ``(Np, R,
    ...)`` block of every relation.  The ELL and timestamp groups are
    present for all relations or for none (:func:`stack_partitioned_rels`
    drops the ELL tables of all when some relation has none)."""

    ldeg: torch.Tensor       # (P*Np, R) int32
    lstart: torch.Tensor     # (P*Np, R)
    gstart: torch.Tensor     # (P*Np, R)
    lindices: torch.Tensor   # (P*Emax, R)
    ell: Optional[torch.Tensor] = None       # (P*Np, R, W)
    lts: Optional[torch.Tensor] = None       # (P*Emax, R)
    ell_ts: Optional[torch.Tensor] = None    # (P*Np, R, W-2)
    num_rels: int = 0
    num_parts: int = 1
    rows_per_part: int = 0
    local_edge_cap: int = 0
    max_degree: int = 0


def _blocks(a: torch.Tensor, num_parts: int, n_r: int, n_m: int,
            fill=0) -> torch.Tensor:
    """``(P*n_r, ...)`` owner blocks padded with ``fill`` to ``(P*n_m,
    ...)``."""
    a = a.reshape((num_parts, n_r) + tuple(a.shape[1:]))
    out = a.new_full((num_parts, n_m) + tuple(a.shape[2:]), fill)
    out[:, :n_r] = a
    return out.reshape((num_parts * n_m,) + tuple(a.shape[2:]))


def stack_partitioned_rels(rels: Dict[str, PartitionedGraph],
                           rel_order: Sequence[str]) -> StackedRels:
    """Stack per-relation graphs into one padded :class:`StackedRels` (on
    the graphs' device).  ``rel_order`` fixes the relation axis (the
    samplers' sorted relation order).  Rows and edges of each owner block
    pad to the largest over the relations (padded rows have degree 0 and
    are never sampled, padded timestamps are missing), and ELL rows to the
    widest, degree and start kept in the last two lanes."""
    gs = [rels[r] for r in rel_order]
    Pn = gs[0].num_parts
    if any(g.num_parts != Pn for g in gs):
        raise ValueError("every relation must be partitioned for the same "
                         "number of ranks")
    Npm = max(g.rows_per_part for g in gs)
    Em = max(g.local_edge_cap for g in gs)
    has_ell = all(g.ell is not None for g in gs)
    has_ts = all(g.lts is not None for g in gs)
    Wm = max(g.ell.shape[1] for g in gs) if has_ell else 0

    def rows_of(name, fill=0):
        return torch.stack([_blocks(getattr(g, name), Pn, g.rows_per_part,
                                    Npm, fill) for g in gs], dim=1)

    def edges_of(name, fill=0):
        return torch.stack([_blocks(getattr(g, name), Pn, g.local_edge_cap,
                                    Em, fill) for g in gs], dim=1)

    lts = edges_of("lts", NAN_TIMESTAMP) if has_ts else None
    ell = ell_ts = None
    if has_ell:
        out = []
        for g in gs:
            e = _blocks(g.ell, Pn, g.rows_per_part, Npm)    # (P*Npm, W_r)
            row = e.new_zeros((e.shape[0], Wm))
            row[:, : e.shape[1] - 2] = e[:, :-2]
            row[:, -2:] = e[:, -2:]
            out.append(row)
        ell = torch.stack(out, dim=1)
        if has_ts and all(g.ell_ts is not None for g in gs):
            out = []
            for g in gs:
                e = _blocks(g.ell_ts, Pn, g.rows_per_part, Npm,
                            NAN_TIMESTAMP)
                row = e.new_full((e.shape[0], Wm - 2), NAN_TIMESTAMP)
                row[:, : e.shape[1]] = e
                out.append(row)
            ell_ts = torch.stack(out, dim=1)
    return StackedRels(
        ldeg=rows_of("ldeg"), lstart=rows_of("lstart"),
        gstart=rows_of("gstart"), lindices=edges_of("lindices"), ell=ell,
        lts=lts, ell_ts=ell_ts, num_rels=len(gs), num_parts=Pn,
        rows_per_part=Npm, local_edge_cap=Em,
        max_degree=max(g.max_degree for g in gs))


def put_stacked_rels(rels: Dict[str, PartitionedGraph],
                     rel_order: Sequence[str], mesh: Mesh,
                     axis: str = "data") -> StackedRels:
    """:func:`stack_partitioned_rels`, placed as
    :func:`~.multihost.put_partitioned` places a per-relation dict under
    ``(axis,)``: the whole container on the mesh's device on a thread
    mesh, this process's owner block of every tensor under a process
    group."""
    return put_partitioned(stack_partitioned_rels(rels, rel_order), mesh,
                           (axis,))



# ---------------------------------------------------------------------------
# The sampler's owner side and its one-way exchange
# ---------------------------------------------------------------------------

def _owner_subset(g: PartitionedGraph, keys, rows, M: int):
    """Owner side: a uniform subset of at most ``M`` of each requested row's
    in-edges (lane top-k on the ELL row, Floyd past it).  Returns ``(src,
    eptr, ets, ok)``, each (B, M), and ``ncount (B,)``, the subset's size;
    ``ets`` the raw edge timestamp, missing where the graph has none."""
    src, eptr, ets, ok = _owner_fill(g, keys, rows, M)
    return src, eptr, ets, ok, g.ldeg[rows].clamp(max=M)


def _owner_subset_at(stk: StackedRels, ri, keys, rows, M: int):
    """:func:`_owner_subset` on the stacked relations: ``ri`` is one
    relation index (an int) or one a row (a (B,) tensor).  Every fetch goes
    through one flat index, ``rows * R + ri``, into the ``(Np * R, ...)``
    view of the rank's block."""
    B = rows.shape[0]
    R = stk.ldeg.shape[-1]
    if not isinstance(ri, int):
        ri = ri.long()
    ri_col = ri if isinstance(ri, int) else ri[:, None]
    fidx = rows * R + ri
    if stk.ell is not None:
        W = stk.ell.shape[-1]
        row = stk.ell.reshape(-1, W)[fidx]
        lanes, deg, starts = row[:, :-2], row[:, -2], row[:, -1]
        L = lanes.shape[-1]
        pos, ok = _uid_uniform_lane_topk(keys, deg, L, M)
        cpos = pos.clamp(0, L - 1)
        src = _select_lanes(lanes, cpos)
        eptr = starts[:, None] + pos.int()
        ets = (_select_lanes(stk.ell_ts.reshape(-1, L)[fidx], cpos)
               if stk.ell_ts is not None else None)
    else:
        deg = stk.ldeg.reshape(-1)[fidx]
        pos, ok = _uid_floyd(keys, deg, M)
        lptr = (stk.lstart.reshape(-1)[fidx].long()[:, None] + pos).clamp(
            0, stk.lindices.shape[0] - 1)
        src = stk.lindices.reshape(-1)[lptr * R + ri_col]
        eptr = stk.gstart.reshape(-1)[fidx][:, None] + pos.int()
        ets = (stk.lts.reshape(-1)[lptr * R + ri_col]
               if stk.lts is not None else None)
    if ets is None:
        ets = torch.full((B, M), NAN_TIMESTAMP, dtype=torch.int32,
                         device=rows.device)
    return src, eptr, ets, ok, deg.clamp(max=M)


def _scatter_route(payload, owner, valid, apply_fn, *, axis,
                   num_parts: int, capacity: int, num_rounds: int):
    """One-way routed scatter (inside ``spmd``): each valid request's
    ``payload`` row goes to its owner, where ``apply_fn(recv (P, C, Q),
    in_round (P, C))`` folds it in; no response.  A round after the first
    runs only if some rank still has a request.  Returns the overflow."""
    router = _route_to_owners(owner, valid, num_parts, capacity)
    rounds = (num_rounds if router.max_rounds is None
              else min(num_rounds, router.max_rounds))
    carried = torch.zeros_like(valid)
    for rnd in range(rounds):
        if rnd and not any_rank((valid & ~carried).sum()):
            break
        in_round = router.in_round(rnd)
        req = router.scatter(torch.cat(
            [payload, in_round.to(torch.int32)[:, None]], -1), rnd)
        recv = all_to_all(req, axis)
        apply_fn(recv[..., :-1], recv[..., -1] != 0)
        carried = carried | in_round
    return (valid & ~carried).sum()


def _rel_keys(key, R: int, device):
    """``fold(key, ri)`` for every relation, (R, 2) on ``device``."""
    return torch.stack([rng.fold_in(key, ri) for ri in range(R)]).to(device)


def _owner_rows(recv, n_rows: int):
    return recv[..., 0].reshape(-1).long().clamp(0, n_rows - 1)


def _gid_route(gid, Pn: int):
    """(owner, local row) of non-negative global ids, int32."""
    return ((gid % Pn).to(torch.int32),
            torch.div(gid, Pn, rounding_mode="floor").to(torch.int32))


def _clamp_ids(ids, hi):
    """``clip(ids, 0, hi)``, ``hi`` an int or one bound a row."""
    return (ids.clamp(0, hi) if isinstance(hi, int)
            else torch.minimum(ids.clamp(min=0), hi))


def _budget_reply(subset, t_ts, timerange, M: int, Pm: int, C: int):
    """The budget update's owner reply (P, C, 2M+1): the subset's sources
    (-1 where invalid or outside ``timerange``), their effective
    timestamps (a missing edge timestamp takes the target's) and the
    subset's size."""
    srcs, _eptr, ets, ok, ncount = subset
    vts = torch.where(ets == NAN_TIMESTAMP, t_ts[:, None], ets)
    if timerange is not None:
        lo, hi = timerange
        ok = ok & ((vts == NAN_TIMESTAMP) | ((vts >= lo) & (vts < hi)))
    return torch.cat([torch.where(ok, srcs, -1).int(), vts.int(),
                      ncount.int()[:, None]], -1).reshape(Pm, C, 2 * M + 1)


def _adj_reply(subset, M: int, Pm: int, C: int):
    """The induced adjacency's owner reply (P, C, 2M): the subset's
    sources (-1 where invalid) and edge pointers."""
    srcs, eptr, _ets, ok, _nc = subset
    return torch.cat([torch.where(ok, srcs, -1).int(), eptr.int()],
                     -1).reshape(Pm, C, 2 * M)


def _contributions(res, got, M: int, smax, Pn: int, extra=None):
    """The budget contributions of a reply (L, 2M+1) whose request was
    carried: the ``[source's local row, subset size, timestamp(, extra)]``
    payload (L*M rows), the sources' owners and validity."""
    srcs, vts, ncount = res[:, :M], res[:, M: 2 * M], res[:, 2 * M]
    fsrc = srcs.reshape(-1)
    sowner, slocal = _gid_route(_clamp_ids(fsrc, smax), Pn)
    cols = [slocal, ncount[:, None].expand(-1, M).reshape(-1),
            vts.reshape(-1)]
    if extra is not None:
        cols.append(extra.int())
    return (torch.stack(cols, -1), sowner,
            ((srcs >= 0) & got[:, None]).reshape(-1))


def _membership(res, got, uid, M: int, smax, Pn: int, mem_owner_fn,
                capacity: int, axis, num_rounds: int, extra=None):
    """The induced adjacency's second exchange: each candidate source of a
    carried reply (L, 2M) asks its budget owner whether it is in the
    sample and at which slot.  Returns ``(rows, cols, eptr, edge_valid,
    overflow)`` of the L*M candidate edges."""
    srcs, eptr = res[:, :M], res[:, M:]
    fok = ((srcs >= 0) & got[:, None]).reshape(-1)
    sowner, slocal = _gid_route(_clamp_ids(srcs.reshape(-1), smax), Pn)
    payload = (slocal[:, None] if extra is None
               else torch.stack([slocal, extra.int()], -1))
    res2, got2, ovf = exchange_rounds(
        payload, sowner, fok, mem_owner_fn, axis=axis, num_parts=Pn,
        capacity=capacity, num_rounds=num_rounds, ret_cols=2)
    keep = fok & got2 & (res2[:, 0] != 0)
    return (torch.where(keep, res2[:, 1], 0),
            uid[:, None].expand(-1, M).reshape(-1), eptr.reshape(-1), keep,
            ovf)


class _Tables:
    """One rank's budget tables, flat, each type's rows from its offset on,
    and one drop lane at the end (JAX's out-of-range ``mode="drop"``
    index), never read."""

    def __init__(self, size: int, num_parts: int, device):
        i32 = dict(dtype=torch.int32, device=device)
        self.drop, self.num_parts = size, num_parts
        self.score = torch.zeros((size + 1,), **i32)
        self.btime = torch.full((size + 1,), NAN_TIMESTAMP, **i32)
        self.in_sample = torch.zeros((size + 1,), dtype=torch.bool,
                                     device=device)
        self.local_id = torch.zeros((size + 1,), **i32)

    def mark(self, off: int, ids, mine, slots):
        """Move this rank's ``ids`` (where ``mine``) of the type at ``off``
        into the sample at output ``slots``: in the sample, its slot,
        score 0."""
        idx = torch.where(mine, off + torch.div(
            ids.long(), self.num_parts, rounding_mode="floor"), self.drop)
        self.score[idx] = 0
        self.in_sample[idx] = True
        self.local_id[idx] = slots.to(torch.int32)

    def add(self, floc, recv, in_round):
        """Fold the contributions ``[local, size, ts, ...]`` of ``recv``'s
        rows into the flat rows ``floc`` (in range): the score adds
        ``SCORE_ONE // size`` and the time takes the max, except at a
        source already in the sample."""
        ok = in_round.reshape(-1) & ~self.in_sample[floc]
        idx = torch.where(ok, floc, self.drop)
        nc = recv[..., 1].reshape(-1).clamp(min=1)
        self.score.index_add_(0, idx, torch.where(
            ok, SCORE_ONE // nc, 0).to(torch.int32))
        self.btime.scatter_reduce_(0, idx, recv[..., 2].reshape(-1).to(
            torch.int32), "amax", include_self=True)

    def member(self, floc, Pm: int, C: int):
        """The membership reply (P, C, 2): in-sample flag and slot."""
        return torch.stack([self.in_sample[floc].to(torch.int32),
                            self.local_id[floc]], -1).reshape(Pm, C, 2)


def _top_n(score, btime, gid, live, key_t, n: int, axis):
    """The distributed score-squared draw of one type (every rank gets the
    same ``n`` picks): Gumbel noise keyed by global id on ``2 *
    log(score)`` of the live rows, the local top ``min(n, Np)``, and the
    top ``n`` of every rank's candidates.  Returns ``(chosen, chosen_ts,
    valid)``; an invalid pick is id 0 at a missing timestamp.  Each
    ``log`` is rounded from float64, so the card draws the CPU's bits: one
    last-bit difference reorders two candidates, and every later budget
    and pick of the sample with them."""
    noise = rng.gumbel_each(rng.fold_in_many(key_t, gid), (),
                            rounded_log=True)
    logits = torch.where(
        live, 2.0 * rng.log_rounded(score.float().clamp(min=1.0)) + noise,
        NEG_INF)
    lv, li = primitives.top_k(logits, min(n, score.shape[0]))
    av = all_gather(lv, axis).reshape(-1)
    ag = all_gather(gid[li], axis).reshape(-1)
    at = all_gather(btime[li], axis).reshape(-1)
    gv, gi = primitives.top_k(av, n)
    valid = torch.isfinite(gv)
    return (torch.where(valid, ag[gi], 0),
            torch.where(valid, at[gi], NAN_TIMESTAMP), valid)


class _Sample:
    """One rank's sampler state shared by the engines: the replicated
    per-type node lists, the budget tables (type ``t``'s ``Np[t]`` rows
    from ``off[t] = ti * Npm`` on) and the overflow count."""

    def __init__(self, meta, seeds, seed_ts, dev: int, device):
        (self.node_types, self.rel_specs, num_samples, self.num_hops,
         self.timerange, counts, seed_caps, self.capacity_factor,
         self.num_rounds, Pn) = meta
        self.num_samples, self.node_counts = dict(num_samples), dict(counts)
        self.seed_caps, self.Pn = dict(seed_caps), Pn
        self.dev, self.device = dev, device
        counts = self.node_counts
        self.Np = {t: -(-counts[t] // Pn) if counts[t] else 1
                   for t in self.node_types}
        self.Npm = max(self.Np.values())
        self.off = {t: ti * self.Npm for ti, t in enumerate(self.node_types)}
        self.tab = _Tables(len(self.node_types) * self.Npm, Pn, device)
        self.overflow = torch.zeros((), dtype=torch.long, device=device)
        caps = {t: [self.seed_caps[t]] + [self.num_samples[t][l]
                                          for l in range(self.num_hops)]
                for t in self.node_types}
        self.base = {t: np.cumsum([0] + caps[t]).tolist()
                     for t in self.node_types}
        i32 = dict(dtype=torch.int32, device=device)
        self.nodes, self.node_ts, self.node_valid = {}, {}, {}
        for t in self.node_types:
            C, n = self.base[t][-1], self.seed_caps[t]
            self.nodes[t] = torch.zeros((C,), **i32)
            self.node_ts[t] = torch.full((C,), NAN_TIMESTAMP, **i32)
            self.node_valid[t] = torch.zeros((C,), dtype=torch.bool,
                                             device=device)
            if n:
                s = seeds[t].to(torch.int32)
                self.nodes[t][:n] = s
                self.node_ts[t][:n] = seed_ts[t].to(torch.int32)
                self.node_valid[t][:n] = s >= 0
                # a repeated seed's slot is whichever write the backend's
                # scatter keeps, as in JAX
                self.tab.mark(self.off[t], s, (s % Pn == dev) & (s >= 0),
                              torch.arange(n, device=device))

    def cap_for(self, L: int) -> int:
        return sample_capacity(self.capacity_factor, L, self.Pn)

    def seed_lists(self):
        n = self.seed_caps
        return tuple({t: d[t][: n[t]] for t in self.node_types}
                     for d in (self.nodes, self.node_ts, self.node_valid))

    def hop(self, key, layer: int, axis):
        """Hop ``layer``'s score-squared draw of every type: writes the
        picks into their slots and moves them out of the budget.  Returns
        the new nodes, timestamps and validity by type."""
        new_nodes, new_ts, new_valid = {}, {}, {}
        Pn, tab = self.Pn, self.tab
        for ti, t in enumerate(self.node_types):
            n = self.num_samples[t][layer]
            if n == 0 or self.node_counts[t] == 0:
                new_nodes[t] = torch.zeros((n,), dtype=torch.int32,
                                           device=self.device)
                new_ts[t] = torch.full((n,), NAN_TIMESTAMP,
                                       dtype=torch.int32, device=self.device)
                new_valid[t] = torch.zeros((n,), dtype=torch.bool,
                                           device=self.device)
                continue
            o, npt = self.off[t], self.Np[t]
            gid = (torch.arange(npt, dtype=torch.int32, device=self.device)
                   * Pn + self.dev)
            sc = tab.score[o: o + npt]
            live = (sc > 0) & (gid < self.node_counts[t])
            chosen, chosen_ts, valid = _top_n(
                sc, tab.btime[o: o + npt], gid, live,
                rng.fold(key, 1, layer, ti), n, axis)
            new_nodes[t], new_ts[t], new_valid[t] = chosen, chosen_ts, valid
            b = self.base[t][layer + 1]
            self.nodes[t][b: b + n] = chosen
            self.node_ts[t][b: b + n] = chosen_ts
            self.node_valid[t][b: b + n] = valid
            tab.mark(o, chosen, valid & (chosen % Pn == self.dev),
                     b + torch.arange(n, device=self.device))
        return new_nodes, new_ts, new_valid

    def empty_rel(self):
        z = torch.zeros((0,), dtype=torch.int32, device=self.device)
        return z, z, z, torch.zeros((0,), dtype=torch.bool,
                                    device=self.device)

    def rel_is_empty(self, src: str, dst: str) -> bool:
        return (self.base[dst][-1] == 0 or self.node_counts[dst] == 0
                or self.node_counts[src] == 0)

    def outputs(self, rows, cols, eptr, ev):
        return (self.nodes, self.node_ts, self.node_valid, rows, cols, eptr,
                ev, self.overflow)


# ---------------------------------------------------------------------------
# The per-rank engines
# ---------------------------------------------------------------------------

def _dist_hgt_device_unrolled(key, rels: Dict[str, PartitionedGraph], seeds,
                              seed_ts, *, dev: int, meta, axis):
    """One rank's HGT sample (inside ``spmd``) on the per-relation dict:
    one exchange pair a relation a phase, each at its own capacity."""
    device = next(iter(seeds.values())).device
    S = _Sample(meta, seeds, seed_ts, dev, device)
    M, Np, tab, off = MAX_NEIGHBORS, S.Np, S.tab, S.off
    counts, Pn = S.node_counts, S.Pn

    def update_budget(upd_key, new_nodes, new_ts, new_valid):
        for ri, (r, src, dst) in enumerate(S.rel_specs):
            m = new_nodes[dst].shape[0]
            if m == 0 or counts[dst] == 0 or counts[src] == 0:
                continue
            g = rels[r]
            mp = m // Pn
            o = dev * mp
            owner, local = _gid_route(
                new_nodes[dst][o: o + mp].clamp(0, max(counts[dst] - 1, 0)),
                Pn)
            uid = o + torch.arange(mp, dtype=torch.int32, device=device)
            rk = rng.fold(upd_key, ri)

            def owner_fn(recv, g=g, rk=rk):
                Pm, C, _ = recv.shape
                subset = _owner_subset(
                    g, _uid_keys(rk, recv[..., 1].reshape(-1)),
                    _owner_rows(recv, g.ldeg.shape[0]), M)
                return _budget_reply(subset, recv[..., 2].reshape(-1),
                                     S.timerange, M, Pm, C)

            res, got, ovf = exchange_rounds(
                torch.stack([local, uid, new_ts[dst][o: o + mp].int()], -1),
                owner, new_valid[dst][o: o + mp], owner_fn, axis=axis,
                num_parts=Pn, capacity=S.cap_for(mp),
                num_rounds=S.num_rounds, ret_cols=2 * M + 1)
            pay2, sowner, fok = _contributions(
                res, got, M, max(counts[src] - 1, 0), Pn)

            def apply_fn(recv, in_round, src=src):
                loc = recv[..., 0].reshape(-1).long().clamp(0, Np[src] - 1)
                tab.add(off[src] + loc, recv, in_round)

            ovf2 = _scatter_route(pay2, sowner, fok, apply_fn, axis=axis,
                                  num_parts=Pn, capacity=S.cap_for(mp * M),
                                  num_rounds=S.num_rounds)
            S.overflow = S.overflow + ovf + ovf2

    update_budget(rng.fold(key, 0), *S.seed_lists())
    for layer in range(S.num_hops):
        new = S.hop(key, layer, axis)
        if layer < S.num_hops - 1:
            update_budget(rng.fold(key, 2, layer), *new)

    rows_o, cols_o, eptr_o, ev_o = {}, {}, {}, {}
    for ri, (r, src, dst) in enumerate(S.rel_specs):
        if S.rel_is_empty(src, dst):
            rows_o[r], cols_o[r], eptr_o[r], ev_o[r] = S.empty_rel()
            continue
        g = rels[r]
        Cp = S.base[dst][-1] // Pn
        o = dev * Cp
        owner, local = _gid_route(S.nodes[dst][o: o + Cp].clamp(
            0, max(counts[dst] - 1, 0)), Pn)
        uid = o + torch.arange(Cp, dtype=torch.int32, device=device)
        rk = rng.fold(key, 3, ri)

        def adj_owner_fn(recv, g=g, rk=rk):
            Pm, C, _ = recv.shape
            return _adj_reply(_owner_subset(
                g, _uid_keys(rk, recv[..., 1].reshape(-1)),
                _owner_rows(recv, g.ldeg.shape[0]), M), M, Pm, C)

        def mem_owner_fn(recv, src=src):
            Pm, C, _ = recv.shape
            loc = recv[..., 0].reshape(-1).long().clamp(0, Np[src] - 1)
            return tab.member(off[src] + loc, Pm, C)

        res, got, ovf = exchange_rounds(
            torch.stack([local, uid], -1), owner,
            S.node_valid[dst][o: o + Cp], adj_owner_fn, axis=axis,
            num_parts=Pn, capacity=S.cap_for(Cp), num_rounds=S.num_rounds,
            ret_cols=2 * M)
        rows_o[r], cols_o[r], eptr_o[r], ev_o[r], ovf2 = _membership(
            res, got, uid, M, max(counts[src] - 1, 0), Pn, mem_owner_fn,
            S.cap_for(Cp * M), axis, S.num_rounds)
        S.overflow = S.overflow + ovf + ovf2
    return S.outputs(rows_o, cols_o, eptr_o, ev_o)


def _stack_typed(d, node_types, fill, width: int):
    """Per-type 1-d tensors padded with ``fill`` to ``width`` and stacked,
    (T, width)."""
    return torch.stack([_pad_to(d[t], width, fill) for t in node_types])


def _dist_hgt_device_stacked(key, stk: StackedRels, seeds, seed_ts, *,
                             dev: int, meta, axis, fused: bool):
    """One rank's HGT sample (inside ``spmd``) on :class:`StackedRels`:
    ``fused`` puts every relation's requests in one exchange a phase, at
    the pooled capacity ``R * cap``; otherwise one relation at a time, at
    the stacked capacity ``cap`` (the largest slice's).  Draws are keyed
    as on the per-relation dict, so the sample is the same when no plan
    overflows."""
    device = stk.ldeg.device
    S = _Sample(meta, seeds, seed_ts, dev, device)
    M, tab, Npm, Pn = MAX_NEIGHBORS, S.tab, S.Npm, S.Pn
    node_types, counts_d = S.node_types, S.node_counts
    T = len(node_types)
    R = len(S.rel_specs)
    t_index = {t: i for i, t in enumerate(node_types)}
    src_idx = [t_index[s] for _r, s, _d in S.rel_specs]
    dst_idx = [t_index[d] for _r, _s, d in S.rel_specs]
    counts = [counts_d[t] for t in node_types]
    src_idx_t = torch.tensor(src_idx, dtype=torch.long, device=device)
    smax_t = torch.tensor([max(c - 1, 0) for c in counts], dtype=torch.int32,
                          device=device)

    def slices(lists, valid, widths, width_max, ri):
        """Relation ``ri``'s request slice of its destination type's
        stacked lists: this rank's ``widths[dst] // P`` entries from
        ``dev * widths[dst] // P`` on, as ``width_max // P`` lanes (the
        lanes past its own are not valid)."""
        di = dst_idx[ri]
        wp, wp_max = widths[di] // Pn, width_max // Pn
        o = dev * wp
        lane = torch.arange(wp_max, dtype=torch.int32, device=device)
        owner, local = _gid_route(lists[0][di, o: o + wp_max].clamp(
            0, max(counts[di] - 1, 0)), Pn)
        return ([local, o + lane] + [a[di, o: o + wp_max] for a in lists[1:]],
                valid[di, o: o + wp_max] & (lane < wp), owner)

    def fused_keys(base_key):
        rkeys = _rel_keys(base_key, R, device)
        return lambda ris, uids: rng.fold_in_each(rkeys[ris], uids)

    def update_budget(upd_key, new_nodes, new_ts, new_valid):
        m_max = max(v.shape[0] for v in new_nodes.values())
        if m_max == 0 or R == 0:
            return
        mp_max = m_max // Pn
        widths = [new_nodes[t].shape[0] for t in node_types]
        lists = (_stack_typed(new_nodes, node_types, 0, m_max),
                 _stack_typed(new_ts, node_types, NAN_TIMESTAMP, m_max))
        valid = _stack_typed(new_valid, node_types, False, m_max)
        cap1, cap2 = S.cap_for(mp_max), S.cap_for(mp_max * M)

        def budget_owner(recv, ri, keys):
            Pm, C, _ = recv.shape
            subset = _owner_subset_at(stk, ri, keys, _owner_rows(recv, Npm),
                                      M)
            return _budget_reply(subset, recv[..., 2].reshape(-1),
                                 S.timerange, M, Pm, C)

        def add(recv, in_round, si):
            loc = recv[..., 0].reshape(-1).long().clamp(0, Npm - 1)
            tab.add(si * Npm + loc, recv, in_round)

        if fused:
            parts = [slices(lists, valid, widths, m_max, ri)
                     for ri in range(R)]
            ris = torch.arange(R, dtype=torch.int32, device=device)[
                :, None].expand(R, mp_max).reshape(-1)
            payload = torch.cat([torch.stack(p[0], -1) for p in parts])
            keys_of = fused_keys(upd_key)

            def owner_fn(recv):
                r_ = recv[..., 3].reshape(-1).long()
                return budget_owner(recv, r_, keys_of(
                    r_, recv[..., 1].reshape(-1)))

            res, got, ovf = exchange_rounds(
                torch.cat([payload, ris[:, None]], -1),
                torch.cat([p[2] for p in parts]),
                torch.cat([p[1] for p in parts]), owner_fn, axis=axis,
                num_parts=Pn, capacity=R * cap1, num_rounds=S.num_rounds,
                ret_cols=2 * M + 1)
            fsrc_i = src_idx_t[ris.long()][:, None].expand(-1, M).reshape(-1)
            pay2, sowner, fok = _contributions(res, got, M, smax_t[fsrc_i],
                                               Pn, extra=fsrc_i)
            ovf2 = _scatter_route(
                pay2, sowner, fok, lambda recv, ir: add(
                    recv, ir, recv[..., 3].reshape(-1).long().clamp(0, T - 1)),
                axis=axis, num_parts=Pn, capacity=R * cap2,
                num_rounds=S.num_rounds)
            S.overflow = S.overflow + ovf + ovf2
            return
        for ri in range(R):
            cols, tok, owner = slices(lists, valid, widths, m_max, ri)
            rk = rng.fold(upd_key, ri)
            res, got, ovf = exchange_rounds(
                torch.stack(cols, -1), owner, tok,
                lambda recv, ri=ri, rk=rk: budget_owner(
                    recv, ri, _uid_keys(rk, recv[..., 1].reshape(-1))),
                axis=axis, num_parts=Pn, capacity=cap1,
                num_rounds=S.num_rounds, ret_cols=2 * M + 1)
            si = src_idx[ri]
            pay2, sowner, fok = _contributions(res, got, M, max(
                counts[si] - 1, 0), Pn)
            ovf2 = _scatter_route(
                pay2, sowner, fok, lambda recv, ir, si=si: add(recv, ir, si),
                axis=axis, num_parts=Pn, capacity=cap2,
                num_rounds=S.num_rounds)
            S.overflow = S.overflow + ovf + ovf2

    update_budget(rng.fold(key, 0), *S.seed_lists())
    for layer in range(S.num_hops):
        new = S.hop(key, layer, axis)
        if layer < S.num_hops - 1:
            update_budget(rng.fold(key, 2, layer), *new)

    rows_o, cols_o, eptr_o, ev_o = {}, {}, {}, {}
    widths = [S.base[t][-1] for t in node_types]
    C_max = max(widths, default=0)
    Cp_max = C_max // Pn
    if R and Cp_max:
        lists = (_stack_typed(S.nodes, node_types, 0, C_max),)
        valid = _stack_typed(S.node_valid, node_types, False, C_max)
        cap_a, cap_m = S.cap_for(Cp_max), S.cap_for(Cp_max * M)

        def adj_owner(recv, ri, keys):
            Pm, C, _ = recv.shape
            return _adj_reply(_owner_subset_at(
                stk, ri, keys, _owner_rows(recv, Npm), M), M, Pm, C)

        def member(recv, si):
            Pm, C, _ = recv.shape
            loc = recv[..., 0].reshape(-1).long().clamp(0, Npm - 1)
            return tab.member(si * Npm + loc, Pm, C)

        if fused:
            parts = [slices(lists, valid, widths, C_max, ri)
                     for ri in range(R)]
            ris = torch.arange(R, dtype=torch.int32, device=device)[
                :, None].expand(R, Cp_max).reshape(-1)
            keys_of = fused_keys(rng.fold(key, 3))
            uid = torch.cat([p[0][1] for p in parts])

            def adj_owner_fn(recv):
                r_ = recv[..., 2].reshape(-1).long()
                return adj_owner(recv, r_, keys_of(
                    r_, recv[..., 1].reshape(-1)))

            res, got, ovf = exchange_rounds(
                torch.stack([torch.cat([p[0][0] for p in parts]), uid, ris],
                            -1),
                torch.cat([p[2] for p in parts]),
                torch.cat([p[1] for p in parts]), adj_owner_fn, axis=axis,
                num_parts=Pn, capacity=R * cap_a, num_rounds=S.num_rounds,
                ret_cols=2 * M)
            fsrc_i = src_idx_t[ris.long()][:, None].expand(-1, M).reshape(-1)
            out = _membership(
                res, got, uid, M, smax_t[fsrc_i], Pn,
                lambda recv: member(recv, recv[..., 1].reshape(-1).long()
                                    .clamp(0, T - 1)),
                R * cap_m, axis, S.num_rounds, extra=fsrc_i)
            S.overflow = S.overflow + ovf + out[4]
            per_rel = [tuple(a.reshape(R, Cp_max * M)[ri] for a in out[:4])
                       for ri in range(R)]
        else:
            per_rel = []
            for ri in range(R):
                cols, tok, owner = slices(lists, valid, widths, C_max, ri)
                rk = rng.fold(key, 3, ri)
                res, got, ovf = exchange_rounds(
                    torch.stack(cols, -1), owner, tok,
                    lambda recv, ri=ri, rk=rk: adj_owner(
                        recv, ri, _uid_keys(rk, recv[..., 1].reshape(-1))),
                    axis=axis, num_parts=Pn, capacity=cap_a,
                    num_rounds=S.num_rounds, ret_cols=2 * M)
                si = src_idx[ri]
                out = _membership(
                    res, got, cols[1], M, max(counts[si] - 1, 0), Pn,
                    lambda recv, si=si: member(recv, si), cap_m, axis,
                    S.num_rounds)
                S.overflow = S.overflow + ovf + out[4]
                per_rel.append(out[:4])
        for ri, (r, src, dst) in enumerate(S.rel_specs):
            if S.rel_is_empty(src, dst):
                rows_o[r], cols_o[r], eptr_o[r], ev_o[r] = S.empty_rel()
                continue
            n_r = (S.base[dst][-1] // Pn) * M
            rows_o[r], cols_o[r], eptr_o[r], ev_o[r] = (
                a[:n_r] for a in per_rel[ri])
    else:
        for r, _s, _d in S.rel_specs:
            rows_o[r], cols_o[r], eptr_o[r], ev_o[r] = S.empty_rel()
    return S.outputs(rows_o, cols_o, eptr_o, ev_o)


def _dist_hgt_device(key, rels, seeds, seed_ts, *, dev: int, meta, axis,
                     fused: bool = True):
    """Engine dispatch: the per-relation dict runs one exchange pair a
    relation; :class:`StackedRels` the relation-fused engine (``fused``)
    or one relation at a time."""
    if isinstance(rels, StackedRels):
        return _dist_hgt_device_stacked(key, rels, seeds, seed_ts, dev=dev,
                                        meta=meta, axis=axis, fused=fused)
    return _dist_hgt_device_unrolled(key, rels, seeds, seed_ts, dev=dev,
                                     meta=meta, axis=axis)


def _as_int32(v) -> torch.Tensor:
    return torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v)).to(
        torch.int32)


def _hgt_meta(node_types, rel_specs, num_samples, num_hops: int, timerange,
             node_counts, seed_caps, capacity_factor: float, num_rounds: int,
             Pn: int):
    """The engines' static configuration: every per-type fanout rounded up
    to a multiple of P."""
    ns = {t: tuple(-(-int(x) // Pn) * Pn for x in num_samples[t])
          for t in node_types}
    return (tuple(node_types), tuple(rel_specs),
            tuple((t, ns[t]) for t in node_types), int(num_hops),
            None if timerange is None else (int(timerange[0]),
                                            int(timerange[1])),
            tuple((t, int(node_counts[t])) for t in node_types),
            tuple(sorted(seed_caps.items())), float(capacity_factor),
            int(num_rounds), int(Pn))


def dist_hgt_sample(key, rels: Dict[str, PartitionedGraph], edge_types,
                    inputs, num_samples, num_hops: int, mesh: Mesh, *,
                    node_counts: Dict[str, int], input_timestamps=None,
                    timerange: Optional[Tuple[int, int]] = None,
                    node_types: Optional[Sequence[str]] = None,
                    axis: str = "data", capacity_factor: float = 2.0,
                    num_rounds: Optional[int] = None, stacked=False):
    """Distributed HGT sampling (the public entry point).

    ``rels`` from :func:`build_partitioned_hetero`; ``inputs[t]`` the seeds
    of type ``t``, ``input_timestamps[t]`` theirs (missing where not
    given); ``num_samples[t][hop]`` the nodes of type ``t`` a hop draws;
    ``timerange`` ``(lo, hi)`` keeps only the budget edges whose effective
    timestamp lies in ``[lo, hi)`` (or is missing).  Each type's seeds and
    fanouts pad to a multiple of P.  ``stacked`` picks the program
    structure: ``False`` one exchange pair a relation; ``True`` or
    ``"fused"`` the relations stacked (:func:`stack_partitioned_rels`) and
    every relation's requests in one exchange a phase; ``"scan"`` stacked,
    one relation at a time.  The three give the same sample when nothing
    overflows.

    Returns ``((nodes, node_ts, node_valid, rows, cols, eptr, edge_valid),
    overflow (P,))``: the per-type node lists (the same on every rank; one
    copy), and the per-relation COO with a leading rank axis, rank ``d``'s
    block covering destination slots ``[d*C/P, (d+1)*C/P)``, so the blocks
    concatenated give a COO that does not depend on P; ``rows`` and
    ``cols`` are slots of the source and destination type's lists."""
    Pn = mesh.axis_size(axis)
    if stacked not in (False, True, "fused", "scan"):
        raise ValueError(f"stacked={stacked!r}: False, True, 'fused' or "
                         "'scan'")
    if node_types is None:
        node_types = sorted({t for e in edge_types for t in (e[0], e[2])})
    rel_specs = tuple(sorted((rel_key(tuple(e)), e[0], e[2])
                             for e in edge_types))
    for r, _s, _d in rel_specs:
        _check_graph(rels[r], Pn, False, False)
    seeds, seed_ts, seed_caps = {}, {}, {}
    for t in node_types:
        v = _as_int32(inputs.get(t, np.zeros((0,), np.int64)))
        m = -(-v.shape[0] // Pn) * Pn
        seed_caps[t] = int(m)
        seeds[t] = _pad_to(v, m, -1).to(mesh.device)
        ts = (_as_int32(input_timestamps[t])
              if input_timestamps is not None and t in input_timestamps
              else torch.full(v.shape, NAN_TIMESTAMP, dtype=torch.int32))
        seed_ts[t] = _pad_to(ts, m, NAN_TIMESTAMP).to(mesh.device)
    meta = _hgt_meta(node_types, rel_specs, num_samples, num_hops, timerange,
                    node_counts, seed_caps, capacity_factor,
                    resolve_num_rounds(num_rounds, Pn), Pn)
    order = [r for r, _s, _d in rel_specs]
    graphs = (stack_partitioned_rels(rels, order) if stacked
              else {r: rels[r] for r in order})
    fused = stacked != "scan"

    def body(gshards, seeds, seed_ts):
        out = _dist_hgt_device(key, gshards, seeds, seed_ts,
                               dev=axis_index(axis), meta=meta, axis=axis,
                               fused=fused)
        return _long_outputs(out[:7]), out[7]

    (nodes, node_ts, node_valid, rows, cols, eptr, ev), ovf = along(
        mesh, axis, spmd(mesh, body, placed(graphs, mesh, (axis,)),
                         seeds=seeds, seed_ts=seed_ts))
    first = lambda d: {k: v[0] for k, v in d.items()}  # noqa: E731
    return ((first(nodes), first(node_ts), first(node_valid), rows, cols,
             eptr, ev), ovf)


def _long_outputs(out):
    """The port's sample dtypes: ids, slots and edge pointers int64,
    timestamps int32."""
    nodes, node_ts, node_valid, rows, cols, eptr, ev = out
    lng = lambda d: {k: v.long() for k, v in d.items()}  # noqa: E731
    return (lng(nodes), node_ts, node_valid, lng(rows), lng(cols),
            lng(eptr), ev)
