"""Distributed per-node budget sampling over a partitioned topology.

Counterpart of ``tch_geometric_tpu/parallel/dist_budget.py``.  The budget
sampler gives every frontier node a budget of up to ``MAX_NEIGHBORS = 50``
uniformly chosen in-edges, then picks ``k`` of the candidates that pass the
runtime temporal filter, uniformly.  Both steps read only the node's own
adjacency row, so in the homogeneous sampler the whole budget runs at the
row's owner inside one request/response exchange a hop: the requester
ships ``(local_row, uid, state)``, the owner fills the budget (lane top-k
on the ELL table, Floyd past it), applies the filter (a half-open window on
``edge ts - state``, negated unless ``forward``; a missing timestamp
passes) and Gumbel-top-k's ``k`` candidates, and returns ``(node, eptr,
new_state, valid)`` for each pick.

The typed sampler (:func:`dist_budget_sample_hetero`) fills each
relation's budget at that relation's owners, which return raw candidates;
the pick across relations runs at the requester, where the candidates of
the R owners meet.  Draws are keyed by the requests' uids in the one-rank
layout (the uids of typed children chain from their parents'), so the
sample is the same for any number of ranks, and the same as the JAX
package's, array for array.  Timestamps, their differences and the uids
stay int32, as the JAX package computes them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..sampling import primitives, rng
from ..sampling.budget import MAX_NEIGHBORS
from ..sampling.neighbor import NeighborSample, _layer_layout, _select_lanes
from ..utils.types import NAN_TIMESTAMP, rel_key
from .dist_hetero import (_append_hop, _chain_uids, _empty_rel, _layouts,
                          _typed_inputs, _typed_outputs)
from .dist_sampling import (PartitionedGraph, _check_graph, _uid_floyd,
                            _uid_keys, _uid_uniform_lane_topk,
                            exchange_rounds, resolve_num_rounds,
                            sample_capacity)
from .mesh import Mesh, along, axis_index, spmd
from .multihost import placed

NEG_INF = float("-inf")


def _budget_filter(filter_static, w_t, v_t):
    """The runtime temporal filter of parent timestamps ``w_t`` against
    candidate timestamps ``v_t`` (int32): a missing timestamp passes, else
    ``v_t - w_t`` (negated unless forward) lies in ``[lo, hi)``."""
    if filter_static is None:
        return torch.ones(v_t.shape, dtype=torch.bool, device=v_t.device)
    (lo, hi), fwd, _rel = filter_static
    d = v_t - w_t
    if not fwd:
        d = -d
    nan = (w_t == NAN_TIMESTAMP) | (v_t == NAN_TIMESTAMP)
    return nan | ((d >= lo) & (d < hi))


def _budget_mutate(filter_static, w_t, v_t):
    """A child's timestamp: its candidate's, or with ``relative`` the
    root's (the parent's, which carries it)."""
    if filter_static is not None and filter_static[2]:
        return w_t.expand(v_t.shape)
    return v_t


def _owner_fill(g: PartitionedGraph, keys, rows, M: int):
    """The owner's budget fill: a uniform ``min(deg, M)``-subset of each
    requested row's in-edges (lane top-k on the ELL row, Floyd past it).
    Returns ``(node, eptr, ts, valid)``, each (B, M); a missing timestamp
    where the graph has none."""
    if g.ell is not None:
        row = g.ell[rows]
        lanes, deg, starts = row[:, :-2], row[:, -2], row[:, -1]
        L = lanes.shape[-1]
        pos, pvalid = _uid_uniform_lane_topk(keys, deg, L, M)
        cpos = pos.clamp(0, L - 1)
        cand_v = _select_lanes(lanes, cpos)
        cand_e = starts[:, None] + pos.int()
        cand_ts = (_select_lanes(g.ell_ts[rows], cpos)
                   if g.ell_ts is not None else None)
    else:
        pos, pvalid = _uid_floyd(keys, g.ldeg[rows], M)
        lptr = (g.lstart[rows].long()[:, None] + pos).clamp(
            0, g.lindices.shape[0] - 1)
        cand_v = g.lindices[lptr]
        cand_e = g.gstart[rows][:, None] + pos.int()
        cand_ts = g.lts[lptr] if g.lts is not None else None
    if cand_ts is None:
        cand_ts = torch.full(cand_v.shape, NAN_TIMESTAMP, dtype=torch.int32,
                             device=cand_v.device)
    return cand_v, cand_e, cand_ts, pvalid


def _pick(score, k: int):
    """``lax.top_k`` of each row's ``k`` best scores as the JAX samplers
    take it: an invalid pick (-inf) keeps the index ``top_k`` gives it,
    picks past the row's length are invalid at index 0.  Returns ``(sel
    (B, k), valid (B, k))``."""
    n = score.shape[-1]
    kk = min(k, n)
    vals, sel = primitives.top_k(score, kk)
    valid = torch.isfinite(vals)
    if kk < k:
        sel = torch.cat([sel, sel.new_zeros(sel.shape[:-1] + (k - kk,))], -1)
        valid = torch.cat([valid, valid.new_zeros(valid.shape[:-1]
                                                  + (k - kk,))], -1)
    return sel.clamp(0, n - 1), valid


def _owner_budget(g: PartitionedGraph, key_hop, recv, k: int,
                  filter_static):
    """Owner side of a homogeneous hop: budget fill, filter and the pick.
    ``recv (P, C, 3)``: ``[local_row, uid, state]`` a request.  Returns
    ``(node, eptr, new_state, valid)``, each (P, C, k)."""
    Pn, C, _ = recv.shape
    rows = recv[..., 0].reshape(-1).long().clamp(0, g.ldeg.shape[0] - 1)
    uids = recv[..., 1].reshape(-1)
    state = recv[..., 2].reshape(-1)[:, None]
    M = MAX_NEIGHBORS
    cand_v, cand_e, cand_ts, pvalid = _owner_fill(
        g, _uid_keys(rng.fold(key_hop, 1), uids), rows, M)
    # a missing edge timestamp takes the frontier's state
    vts = torch.where(cand_ts == NAN_TIMESTAMP, state, cand_ts)
    cand_ok = pvalid & _budget_filter(filter_static, state, vts)
    new_ts = _budget_mutate(filter_static, state, vts)

    noise = rng.gumbel_each(_uid_keys(rng.fold(key_hop, 2), uids), (M,))
    sel, valid = _pick(torch.where(cand_ok, noise, NEG_INF), k)
    shape = (Pn, C, k)
    return tuple(torch.gather(a, 1, sel).reshape(shape).to(torch.int32)
                 for a in (cand_v, cand_e, new_ts)) + (valid.reshape(shape),)


def _dist_budget_device(key, g: PartitionedGraph, seeds_local, seed_ts, *,
                        dev: int, fanouts: Tuple[int, ...], axis,
                        num_parts: int, total_seeds: int,
                        capacity_factor: float, filter_static,
                        num_rounds: int):
    """Multi-hop budget sampling of one rank's seed shard (inside
    ``spmd``); returns (NeighborSample, overflow)."""
    device = seeds_local.device
    B0 = seeds_local.shape[0]
    node_base, edge_base = _layer_layout(B0, fanouts)
    gnode_base, _ = _layer_layout(total_seeds, fanouts)

    nodes = [seeds_local.to(torch.int32)]
    valids = [torch.ones((B0,), dtype=torch.bool, device=device)]
    states = [seed_ts.to(torch.int32)]
    rows, cols, eptrs, evalids = [], [], [], []
    overflow = torch.zeros((), dtype=torch.long, device=device)

    L = B0
    for ell, k in enumerate(fanouts):
        frontier, fvalid, fstate = nodes[ell], valids[ell], states[ell]
        ar = torch.arange(L, device=device)
        fuid = gnode_base[ell] + dev * L + ar
        hop_key = rng.fold(key, ell)
        gid = frontier.long().clamp(0, max(g.num_nodes - 1, 0))

        def owner_fn(recv, hop_key=hop_key, k=k):
            node, eptr, nts, valid = _owner_budget(g, hop_key, recv, k,
                                                   filter_static)
            return torch.cat([node, eptr, nts, valid.to(torch.int32)], -1)

        payload = torch.stack([torch.div(gid, num_parts,
                                         rounding_mode="floor").int(),
                               fuid.int(), fstate], dim=-1)
        mine, got, ovf = exchange_rounds(
            payload, gid % num_parts, fvalid, owner_fn, axis=axis,
            num_parts=num_parts,
            capacity=sample_capacity(capacity_factor, L, num_parts),
            num_rounds=num_rounds, ret_cols=4 * k)
        overflow = overflow + ovf
        valid = (mine[:, 3 * k:] != 0) & got[:, None]

        slot = node_base[ell + 1] + (ar[:, None] * k
                                     + torch.arange(k, device=device))
        col = node_base[ell] + ar[:, None]
        nodes.append(mine[:, :k].reshape(-1))
        valids.append(valid.reshape(-1))
        states.append(mine[:, 2 * k: 3 * k].reshape(-1))
        rows.append(slot.reshape(-1))
        cols.append(col.expand(L, k).reshape(-1))
        eptrs.append(mine[:, k: 2 * k].reshape(-1))
        evalids.append(valid.reshape(-1))
        L = L * k

    sample = NeighborSample(
        nodes=torch.cat(nodes).long(), node_valid=torch.cat(valids),
        node_state=torch.cat(states).long(), rows=torch.cat(rows),
        cols=torch.cat(cols), eptr=torch.cat(eptrs).long(),
        edge_valid=torch.cat(evalids), node_base=node_base,
        edge_base=edge_base, fanouts=tuple(fanouts))
    return sample, overflow


def _filter_of(window, forward: bool, relative: bool):
    if window is None:
        return None
    return ((int(window[0]), int(window[1])), bool(forward), bool(relative))


def dist_budget_sample(key, graph: PartitionedGraph, seeds, fanouts,
                       mesh: Mesh, *, axis: str = "data",
                       input_timestamps=None,
                       window: Optional[Tuple[int, int]] = None,
                       forward: bool = False, relative: bool = False,
                       capacity_factor: float = 1.3,
                       num_rounds: Optional[int] = None):
    """Distributed homogeneous budget sampling (the public entry point).

    ``fanouts[hop]``: the picks a frontier node gets at that hop, each
    uniform among the candidates of its budget (at most 50 of its
    in-edges) that pass the filter.  ``window`` (with ``forward`` and
    ``relative``) turns the runtime temporal filter on, over the
    timestamps given to ``build_partitioned_graph(..., edge_timestamps=)``
    and ``input_timestamps`` (missing where not given).  ``seeds (B,)``
    must divide the mesh axis; rank ``d`` samples the subtrees of seeds
    ``[d*B/P, (d+1)*B/P)``.

    Returns ``(sample, overflow (P,))``, ``sample`` a NeighborSample with a
    leading rank axis, as :func:`~.dist_sampling.dist_sample_neighbors`
    returns it: concatenating the rank blocks layer by layer gives the
    P = 1 sample bit-exactly."""
    Pn = mesh.axis_size(axis)
    filter_static = _filter_of(window, forward, relative)
    _check_graph(graph, Pn, False, filter_static is not None)
    fanouts = tuple(int(k) for k in fanouts)
    seeds = torch.as_tensor(seeds if torch.is_tensor(seeds)
                            else np.asarray(seeds)).to(torch.int32)
    B = seeds.shape[0]
    if B % Pn:
        raise ValueError("the global seed batch must divide the mesh axis")
    seed_ts = (torch.full((B,), NAN_TIMESTAMP, dtype=torch.int32)
               if input_timestamps is None else torch.as_tensor(
                   input_timestamps if torch.is_tensor(input_timestamps)
                   else np.asarray(input_timestamps)).to(torch.int32))
    num_rounds = resolve_num_rounds(num_rounds, Pn)

    def body(gshard, seeds_local, ts_local):
        return _dist_budget_device(
            key, gshard, seeds_local, ts_local, dev=axis_index(axis),
            fanouts=fanouts, axis=axis, num_parts=Pn, total_seeds=B,
            capacity_factor=float(capacity_factor),
            filter_static=filter_static, num_rounds=num_rounds)

    on = (axis,)
    return along(mesh, axis, spmd(
        mesh, body, placed(graph, mesh, on), placed(seeds, mesh, on),
        placed(seed_ts, mesh, on)))


# ---------------------------------------------------------------------------
# Typed (heterogeneous) distributed budget sampling
# ---------------------------------------------------------------------------

def _owner_candidates(g: PartitionedGraph, fill_key, recv, M: int):
    """Owner side of the typed fill: each requested row's raw candidates.
    ``recv (P, C, 2)``: ``[local_row, uid]``.  Returns (P, C, 4M) int32:
    node, eptr, timestamp and validity of the ``M`` candidates."""
    Pn, C, _ = recv.shape
    rows = recv[..., 0].reshape(-1).long().clamp(0, g.ldeg.shape[0] - 1)
    out = _owner_fill(g, _uid_keys(fill_key, recv[..., 1].reshape(-1)),
                      rows, M)
    return torch.cat([a.to(torch.int32) for a in out], -1).reshape(
        Pn, C, 4 * M)


def _dist_budget_hetero_device(key, rels, seeds, seed_ts, *, dev: int, meta,
                               axis):
    """One rank's typed budget sample (inside ``spmd``): the budget layout
    (per-type hop segments subdivided by relation) over its seed shards,
    each relation's fill at that relation's owners and the pick across
    relations here."""
    (node_types, rel_specs, fanouts_t, num_seeds_t, num_hops, filter_static,
     capacity_factor, num_rounds, Pn) = meta
    layout, glayout = _layouts(True, node_types, rel_specs, fanouts_t,
                               num_seeds_t, num_hops, Pn)
    M = MAX_NEIGHBORS
    device = next(iter(seeds.values())).device
    rels_by_dst = {t: [(ri, r, src) for ri, (r, src, dst)
                       in enumerate(rel_specs) if dst == t]
                   for t in node_types}

    nodes = {t: [seeds[t].long()] for t in node_types}
    valids = {t: [seeds[t] >= 0] for t in node_types}
    states = {t: [seed_ts[t].to(torch.int32)] for t in node_types}
    uids = {t: [torch.from_numpy(u).to(device) for u in us]
            for t, us in _chain_uids(layout, glayout, dev).items()}
    rows = {r: [] for r, _s, _d in rel_specs}
    cols = {r: [] for r, _s, _d in rel_specs}
    eptrs = {r: [] for r, _s, _d in rel_specs}
    evalids = {r: [] for r, _s, _d in rel_specs}
    overflow = torch.zeros((), dtype=torch.long, device=device)

    for ell in range(num_hops):
        hop_new = {t: {} for t in node_types}
        for t in node_types:
            B = layout.cap[t][ell]
            k = layout.fanouts[t][ell]
            t_rels = rels_by_dst[t]
            R = len(t_rels)
            if B == 0 or k == 0 or R == 0:
                for _ri, r, src in t_rels:
                    hop_new[src][r] = _empty_rel(device)
                    for d in (rows, cols, eptrs):
                        d[r].append(torch.zeros((0,), dtype=torch.long,
                                                device=device))
                    evalids[r].append(torch.zeros((0,), dtype=torch.bool,
                                                  device=device))
                continue
            frontier, fvalid = nodes[t][ell], valids[t][ell]
            fstate = states[t][ell][:, None]
            fuid = (glayout.node_base[t][ell] + uids[t][ell]).int()
            capacity = sample_capacity(capacity_factor, B, Pn)

            cand_v, cand_e, cand_ts, cand_ok = [], [], [], []
            for ri, r, _src in t_rels:
                g = rels[r]
                gid = frontier.clamp(0, max(g.num_nodes - 1, 0))

                def owner_fn(recv, g=g, fill_key=rng.fold(key, ell, ri)):
                    return _owner_candidates(g, fill_key, recv, M)

                payload = torch.stack([torch.div(
                    gid, Pn, rounding_mode="floor").int(), fuid], dim=-1)
                res, got, ovf = exchange_rounds(
                    payload, gid % Pn, fvalid, owner_fn, axis=axis,
                    num_parts=Pn, capacity=capacity, num_rounds=num_rounds,
                    ret_cols=4 * M)
                overflow = overflow + ovf
                ts_ = res[:, 2 * M: 3 * M]
                # a missing edge timestamp takes the frontier's state
                vts = torch.where(ts_ == NAN_TIMESTAMP, fstate, ts_)
                cand_v.append(res[:, :M])
                cand_e.append(res[:, M: 2 * M])
                cand_ts.append(_budget_mutate(filter_static, fstate, vts))
                cand_ok.append((res[:, 3 * M:] != 0) & got[:, None]
                               & _budget_filter(filter_static, fstate, vts))

            # the uniform pick across every relation's candidates, keyed
            # by the frontier's uid
            flat = (B, R * M)
            noise = rng.gumbel_each(_uid_keys(
                rng.fold(key, ell, 1000 + node_types.index(t)), fuid),
                (R * M,))
            sel, sel_valid = _pick(torch.where(
                torch.stack(cand_ok, 1).reshape(flat), noise, NEG_INF), k)
            sel_rel = torch.div(sel, M, rounding_mode="floor")
            sel_v, sel_e, sel_ts = (
                torch.gather(torch.stack(c, 1).reshape(flat), 1, sel)
                for c in (cand_v, cand_e, cand_ts))

            ar = torch.arange(B, device=device)[:, None]
            col = (layout.node_base[t][ell] + ar).expand(B, k)
            slot0 = ar * k + torch.arange(k, device=device)[None, :]
            for pos_r, (_ri, r, src) in enumerate(t_rels):
                match = sel_valid & (sel_rel == pos_r)
                base = (layout.node_base[src][ell + 1]
                        + layout.rel_node_off[(r, ell)])
                hop_new[src][r] = (sel_v.reshape(-1), match.reshape(-1),
                                   sel_ts.reshape(-1))
                rows[r].append((base + slot0).reshape(-1))
                cols[r].append(col.reshape(-1))
                eptrs[r].append(sel_e.reshape(-1))
                evalids[r].append(match.reshape(-1))
        _append_hop(node_types, rel_specs, hop_new, nodes, valids, states)

    return _typed_outputs(node_types, rel_specs, nodes, states, valids, rows,
                          cols, eptrs, evalids, device) + (overflow,)


def dist_budget_sample_hetero(key, rels, edge_types, inputs, num_neighbors,
                              num_hops: int, mesh: Mesh, *,
                              input_timestamps=None,
                              window: Optional[Tuple[int, int]] = None,
                              forward: bool = False, relative: bool = False,
                              node_types=None, axis: str = "data",
                              capacity_factor: float = 2.0,
                              num_rounds: Optional[int] = None):
    """Typed distributed budget sampling (the public entry point).

    ``rels`` from :func:`~.dist_hgt.build_partitioned_hetero`;
    ``num_neighbors[type][hop]`` the picks of a frontier node of that type
    across all its relations; ``window``, ``forward``, ``relative`` and
    ``input_timestamps`` (per type) as in
    :func:`~..sampling.budget.sample_budget`.  Each type's seed count must
    divide the mesh axis; rank ``d`` samples the subtrees of seeds
    ``[d*B_t/P, (d+1)*B_t/P)`` of each type.

    Returns ``((nodes, node_ts, node_valid, rows, cols, eptr, edge_valid),
    overflow)``: dicts with a leading rank axis, each rank's block laid out
    as the one-device budget sampler lays out its seed shard
    (:func:`~.dist_hetero.merge_rank_blocks` with ``budget=True`` gives the
    one-rank layout), and ``overflow (P,)``."""
    Pn = mesh.axis_size(axis)
    if node_types is None:
        node_types = sorted({t for e in edge_types for t in (e[0], e[2])})
    rel_specs = tuple(sorted((rel_key(tuple(e)), e[0], e[2])
                             for e in edge_types))
    for r, _s, _d in rel_specs:
        _check_graph(rels[r], Pn, False, False)
    seeds, seed_ts, num_seeds = _typed_inputs(node_types, inputs,
                                              input_timestamps, Pn)
    meta = (tuple(node_types), rel_specs,
            tuple((t, tuple(int(x) for x in num_neighbors[t]))
                  for t in node_types),
            num_seeds, int(num_hops), _filter_of(window, forward, relative),
            float(capacity_factor), resolve_num_rounds(num_rounds, Pn), Pn)

    def body(gshards, seeds_local, ts_local):
        out = _dist_budget_hetero_device(key, gshards, seeds_local, ts_local,
                                         dev=axis_index(axis), meta=meta,
                                         axis=axis)
        return out[:7], out[7]

    on = (axis,)
    used = {r: rels[r] for r, _s, _d in rel_specs}
    return along(mesh, axis, spmd(mesh, body, placed(used, mesh, on),
                                  placed(seeds, mesh, on),
                                  placed(seed_ts, mesh, on)))
