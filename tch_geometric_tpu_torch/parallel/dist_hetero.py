"""Distributed heterogeneous neighbor sampling over partitioned relations.

Counterpart of ``tch_geometric_tpu/parallel/dist_hetero.py``: the
reference's ``neighbor_sampling_heterogenous`` over a partition.  Each
relation's CSC is interleave-partitioned by dst ownership
(:func:`~.dist_hgt.build_partitioned_hetero`); per hop and relation, the
dst-type frontier routes to the relation's adjacency owners, who sample
``k_r`` in-edges with the homogeneous sampler's owner engine
(``_owner_sample``: uniform with or without replacement, Gumbel-weighted,
the three-mode temporal filter), keyed by the request's uid.

Each rank's pools follow :class:`~..sampling.hetero_neighbor.HeteroLayout`
over its own seed shard, so the relations interleave differently at every
P.  The uids chain from the parents' uids through the layout of the whole
batch (each rank's seed counts times P): a child's uid is its slot in the
one-rank sample, so the draws, and the sample once
:func:`merge_rank_blocks` reorders it, are the same for any number of
ranks, and the same as the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..sampling import rng
from ..sampling.budget import _Layout
from ..sampling.hetero_neighbor import HeteroLayout
from ..utils.config import TemporalEdgeFilter
from ..utils.types import NAN_TIMESTAMP, rel_key
from .dist_sampling import (_check_graph, _owner_sample, exchange_rounds,
                            resolve_num_rounds, sample_capacity)
from .mesh import Mesh, along, axis_index, spmd
from .multihost import placed


def _rel_fanout(layout, r: str, dst: str, ell: int) -> int:
    """Picks a frontier node of ``dst`` gets through ``r`` at hop ``ell``
    (0 where the frontier is empty), for either layout class."""
    B = layout.cap[dst][ell]
    return layout.rel_edge_cap[r][ell] // B if B else 0


def _chain_uids(layout, glayout, dev: int) -> Dict[str, List[np.ndarray]]:
    """Rank ``dev``'s uids: per type, per hop, each local slot's position in
    the hop segment of the one-rank layout ``glayout``.  Seeds are
    contiguous (``dev * cap + i``); the child of the parent of uid ``u``
    through relation ``r``, pick ``s``, is ``glayout.rel_node_off[(r, hop)]
    + u * k + s``, as the JAX samplers chain them."""
    uids = {t: [dev * layout.cap[t][0] + np.arange(layout.cap[t][0])]
            for t in layout.node_types}
    for ell in range(layout.num_hops):
        parts = {t: [] for t in layout.node_types}
        for r, src, dst in layout.rel_specs:
            k = _rel_fanout(layout, r, dst, ell)
            parent = uids[dst][ell]
            parts[src].append((glayout.rel_node_off[(r, ell)]
                               + parent[:, None] * k
                               + np.arange(k)[None, :]).reshape(-1))
        for t in layout.node_types:
            uids[t].append(np.concatenate(parts[t]).astype(np.int64)
                           if parts[t] else np.zeros((0,), np.int64))
    return uids


def _layouts(budget: bool, node_types, rel_specs, fanouts, num_seeds,
             num_hops: int, num_parts: int):
    """(one rank's layout, the whole batch's layout) of a typed sampler:
    the budget samplers' ``_Layout`` (fanouts per dst type) or
    ``HeteroLayout`` (fanouts per relation)."""
    cls = _Layout if budget else HeteroLayout
    specs = [tuple(r) for r in rel_specs]
    return (cls(node_types, specs, dict(fanouts), dict(num_seeds), num_hops),
            cls(node_types, specs, dict(fanouts),
                {t: n * num_parts for t, n in dict(num_seeds).items()},
                num_hops))


def merge_rank_blocks(sample, edge_types, num_seeds: Dict[str, int],
                      num_neighbors, num_hops: int, *, budget: bool = False,
                      node_types=None):
    """The one-rank layout of a typed distributed sample.

    ``sample``: the first element of :func:`dist_hetero_neighbor_sample`'s
    (``budget=False``) or ``dist_budget_sample_hetero``'s (``budget=True``)
    result, every rank's block (a thread mesh's ``(P, ...)`` dicts);
    ``num_seeds``: the global seed count of each type; the other arguments
    as given to the sampler.  Returns the 7 dicts with the rank axis gone,
    each slot where the P = 1 sample has it (rows and cols renumbered), so
    the result is bit-equal to the P = 1 call's."""
    if node_types is None:
        node_types = sorted({t for e in edge_types for t in (e[0], e[2])})
    rel_specs = tuple(sorted((rel_key(tuple(e)), e[0], e[2])
                             for e in edge_types))
    nodes, node_ts, node_valid, rows, cols, eptr, edge_valid = sample
    Pn = next(iter(nodes.values())).shape[0]
    fanouts = ({t: list(num_neighbors[t]) for t in node_types} if budget
               else {r: list(num_neighbors[r]) for r, _s, _d in rel_specs})
    per_rank = {t: num_seeds.get(t, 0) // Pn for t in node_types}
    layout, glayout = _layouts(budget, node_types, rel_specs, fanouts,
                               per_rank, num_hops, Pn)
    node_pos = {t: [] for t in node_types}
    edge_pos = {r: [] for r, _s, _d in rel_specs}
    for d in range(Pn):
        uids = _chain_uids(layout, glayout, d)
        for t in node_types:
            node_pos[t].append(np.concatenate(
                [glayout.node_base[t][ell] + u
                 for ell, u in enumerate(uids[t])]))
        for r, _src, dst in rel_specs:
            hops = []
            for ell in range(num_hops):
                k = _rel_fanout(layout, r, dst, ell)
                hops.append((glayout.rel_edge_base[r][ell]
                             + uids[dst][ell][:, None] * k
                             + np.arange(k)[None, :]).reshape(-1))
            edge_pos[r].append(np.concatenate(
                [np.zeros((0,), np.int64)] + hops))

    def place(blocks, pos):
        flat = blocks.reshape(-1)
        idx = torch.from_numpy(np.concatenate(pos)).to(flat.device)
        out = torch.empty_like(flat)
        out[idx] = flat
        return out

    nmap = {t: torch.from_numpy(np.stack(node_pos[t])) for t in node_types}
    out_nodes = {t: place(nodes[t], node_pos[t]) for t in node_types}
    out_ts = {t: place(node_ts[t], node_pos[t]) for t in node_types}
    out_valid = {t: place(node_valid[t], node_pos[t]) for t in node_types}
    out_rows, out_cols = {}, {}
    rank = torch.arange(Pn)[:, None]
    for r, src, dst in rel_specs:
        for res, block, t in ((out_rows, rows[r], src),
                              (out_cols, cols[r], dst)):
            slot = nmap[t].to(block.device)[rank.to(block.device),
                                            block.long()]
            res[r] = place(slot.to(block.dtype), edge_pos[r])
    return (out_nodes, out_ts, out_valid, out_rows, out_cols,
            {r: place(eptr[r], edge_pos[r]) for r, _s, _d in rel_specs},
            {r: place(edge_valid[r], edge_pos[r]) for r, _s, _d in rel_specs})


def _empty_rel(device):
    """An empty relation share: (nodes, valid, state)."""
    empty = torch.zeros((0,), dtype=torch.long, device=device)
    return (empty, torch.zeros((0,), dtype=torch.bool, device=device),
            empty.int())


def _typed_outputs(node_types, rel_specs, nodes, states, valids, rows, cols,
                   eptrs, evalids, device):
    """Concatenate the typed samplers' per-hop lists: (nodes, node_ts,
    node_valid, rows, cols, eptr, edge_valid) dicts."""
    def cat(parts, dtype):
        return (torch.cat(parts).to(dtype) if parts
                else torch.zeros((0,), dtype=dtype, device=device))

    rels = [r for r, _s, _d in rel_specs]
    return ({t: cat(nodes[t], torch.long) for t in node_types},
            {t: cat(states[t], torch.int32) for t in node_types},
            {t: cat(valids[t], torch.bool) for t in node_types},
            {r: cat(rows[r], torch.long) for r in rels},
            {r: cat(cols[r], torch.long) for r in rels},
            {r: cat(eptrs[r], torch.long) for r in rels},
            {r: cat(evalids[r], torch.bool) for r in rels})


def _append_hop(node_types, rel_specs, hop_new, nodes, valids, states):
    """Each type's next hop segment: its relations' shares in relation
    order."""
    for t in node_types:
        parts = [hop_new[t][r] for r, src_t, _d in rel_specs
                 if src_t == t and r in hop_new[t]]
        if not parts:
            parts = [_empty_rel(nodes[t][0].device)]
        nodes[t].append(torch.cat([p[0].long() for p in parts]))
        valids[t].append(torch.cat([p[1] for p in parts]))
        states[t].append(torch.cat([p[2].int() for p in parts]))


def _dist_hetero_device(key, rels, seeds, seed_ts, *, dev: int, meta,
                        axis):
    """One rank's typed sample (inside ``spmd``)."""
    (node_types, rel_specs, fanouts_t, num_seeds_t, num_hops,
     with_replacement, weighted_t, filter_static, capacity_factor,
     num_rounds, window, Pn) = meta
    weighted = dict(weighted_t)
    layout, glayout = _layouts(False, node_types, rel_specs, fanouts_t,
                               num_seeds_t, num_hops, Pn)
    device = next(iter(seeds.values())).device
    filter_cfg = None
    if filter_static is not None:
        w, fwd, mode = filter_static
        filter_cfg = TemporalEdgeFilter(window=w, forward=fwd, mode=mode)

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
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731

    for ell in range(num_hops):
        hop_new = {t: {} for t in node_types}
        for ri, (r, src, dst) in enumerate(rel_specs):
            k = layout.fanouts[r][ell]
            B = layout.cap[dst][ell]
            if B == 0 or k == 0:
                hop_new[src][r] = _empty_rel(device)
                for d in (rows, cols, eptrs):
                    d[r].append(torch.zeros((0,), dtype=torch.long,
                                            device=device))
                evalids[r].append(torch.zeros((0,), dtype=torch.bool,
                                              device=device))
                continue
            g = rels[r]
            frontier, fvalid = nodes[dst][ell], valids[dst][ell]
            fstate = states[dst][ell]
            fuid = glayout.node_base[dst][ell] + uids[dst][ell]
            hop_key = rng.fold(key, ell, ri)

            gid = frontier.clamp(0, max(g.num_nodes - 1, 0))
            owner = gid % Pn
            local = torch.div(gid, Pn, rounding_mode="floor")

            def owner_fn(recv, g=g, hop_key=hop_key, k=k, r=r):
                neighbor, eptr, pvalid, new_state = _owner_sample(
                    g, hop_key, recv, k, with_replacement,
                    bool(weighted.get(r, False)),
                    filter_cfg if g.lts is not None else None, window)
                return torch.cat([neighbor, eptr, pvalid.to(torch.int32),
                                  new_state], dim=-1)

            payload = torch.stack([local.int(), fuid.int(), fstate.int()],
                                  dim=-1)
            mine, got, ovf = exchange_rounds(
                payload, owner, fvalid, owner_fn, axis=axis, num_parts=Pn,
                capacity=sample_capacity(capacity_factor, B, Pn),
                num_rounds=num_rounds, ret_cols=4 * k)
            overflow = overflow + ovf
            valid = (mine[:, 2 * k: 3 * k] != 0) & got[:, None]

            slot = (layout.node_base[src][ell + 1]
                    + layout.rel_node_off[(r, ell)]
                    + ar(B)[:, None] * k + ar(k)[None, :])
            col = layout.node_base[dst][ell] + ar(B)[:, None]
            hop_new[src][r] = (mine[:, :k].reshape(-1), valid.reshape(-1),
                               mine[:, 3 * k:].reshape(-1))
            rows[r].append(slot.reshape(-1))
            cols[r].append(col.expand(B, k).reshape(-1))
            eptrs[r].append(mine[:, k: 2 * k].reshape(-1))
            evalids[r].append(valid.reshape(-1))
        _append_hop(node_types, rel_specs, hop_new, nodes, valids, states)

    return _typed_outputs(node_types, rel_specs, nodes, states, valids, rows,
                          cols, eptrs, evalids, device) + (overflow,)


def _typed_inputs(node_types, inputs, input_timestamps, Pn: int):
    """Per-type int32 seeds (empty where not given; each count must divide
    the mesh axis), their timestamps (missing where not given) and each
    rank's seed count."""
    seeds, ts = {}, {}
    for t in node_types:
        v = inputs.get(t, np.zeros((0,), np.int64))
        v = torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v)).to(
            torch.int32)
        if v.shape[0] % Pn:
            raise ValueError(f"type {t!r}: {v.shape[0]} seeds do not divide "
                             f"the mesh axis ({Pn})")
        seeds[t] = v
        if input_timestamps is not None and t in input_timestamps:
            s = input_timestamps[t]
            ts[t] = torch.as_tensor(s if torch.is_tensor(s)
                                    else np.asarray(s)).to(torch.int32)
        else:
            ts[t] = torch.full(v.shape, NAN_TIMESTAMP, dtype=torch.int32)
    return seeds, ts, tuple(sorted((t, v.shape[0] // Pn)
                                   for t, v in seeds.items()))


def dist_hetero_neighbor_sample(key, rels, edge_types, inputs, num_neighbors,
                                num_hops: int, mesh: Mesh, *,
                                with_replacement: bool = False,
                                weighted=None, input_timestamps=None,
                                filter: Optional[tuple] = None,
                                node_types=None, axis: str = "data",
                                capacity_factor: float = 2.0,
                                num_rounds: Optional[int] = None,
                                window: int = 256):
    """Typed distributed neighbor sampling (the public entry point).

    ``rels``: dict ``rel_key`` -> :class:`~.dist_sampling.PartitionedGraph`
    (:func:`~.dist_hgt.build_partitioned_hetero`; build a relation with
    ``edge_weights`` / ``edge_timestamps`` to sample it weighted or
    filtered); ``num_neighbors[rel_key][hop]`` the per-relation fanouts;
    ``weighted`` a set of rel keys sampled in proportion to their edge
    weights; ``filter`` ``((lo, hi), forward, mode)``, applied to the
    relations that carry timestamps, against ``input_timestamps`` per type
    (missing where not given).  Node types in sorted order unless given.
    Each type's seed count must divide the mesh axis; rank ``d`` samples
    the subtrees of seeds ``[d*B_t/P, (d+1)*B_t/P)`` of each type.

    Returns ``((nodes, node_ts, node_valid, rows, cols, eptr, edge_valid),
    overflow)``: dicts with a leading rank axis, each rank's block laid out
    as ``HeteroLayout`` over its seed shard (:func:`merge_rank_blocks`
    gives the one-rank layout), and ``overflow (P,)``."""
    Pn = mesh.axis_size(axis)
    if node_types is None:
        node_types = sorted({t for e in edge_types for t in (e[0], e[2])})
    rel_specs = tuple(sorted((rel_key(tuple(e)), e[0], e[2])
                             for e in edge_types))
    weighted = set() if weighted is None else set(weighted)
    filter_static = None
    if filter is not None:
        filter_static = (tuple(int(x) for x in filter[0]), bool(filter[1]),
                         int(filter[2]))
    for r, _s, _d in rel_specs:
        _check_graph(rels[r], Pn, r in weighted, False)
    seeds, seed_ts, num_seeds = _typed_inputs(node_types, inputs,
                                              input_timestamps, Pn)
    meta = (tuple(node_types), rel_specs,
            tuple((r, tuple(int(x) for x in num_neighbors[r]))
                  for r, _s, _d in rel_specs),
            num_seeds, int(num_hops), bool(with_replacement),
            tuple((r, r in weighted) for r, _s, _d in rel_specs),
            filter_static, float(capacity_factor),
            resolve_num_rounds(num_rounds, Pn), int(window), Pn)

    def body(gshards, seeds_local, ts_local):
        out = _dist_hetero_device(key, gshards, seeds_local, ts_local,
                                  dev=axis_index(axis), meta=meta, axis=axis)
        return out[:7], out[7]

    on = (axis,)
    used = {r: rels[r] for r, _s, _d in rel_specs}
    return along(mesh, axis, spmd(mesh, body, placed(used, mesh, on),
                                  placed(seeds, mesh, on),
                                  placed(seed_ts, mesh, on)))
