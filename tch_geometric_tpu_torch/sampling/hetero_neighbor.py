"""Heterogeneous layer-wise neighbor sampling.

Counterpart of ``tch_geometric_tpu/sampling/hetero_neighbor.py``.  Each
(relation, hop) runs the homogeneous sampler's one-hop step, and the
bookkeeping is static layout arithmetic:

* per-type node pools have static per-hop segment capacities,
  ``cap[src][l+1] = sum over rels r with src(r) = src of
  cap[dst(r)][l] * k_r[l]``; within a hop segment, relations occupy
  fixed sub-ranges in sorted relation order;
* hop ``l`` reads the dst pool's hop-``l`` segment and writes the src
  pool's hop-``l+1`` segment, so self-relations need no aliasing;
* uniform, unfiltered hops fuse the relations that share a dst type into
  one stacked-ELL gather and one draw.

Relation ``ri`` of hop ``l`` draws with ``fold(key, l, ri)``, fused group
``gi`` with ``fold(key, l, 100 + gi)``, as in the JAX package, so samples
compare array for array.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import CscGraph, make_graph
from ..utils.config import EdgeSampler, WeightedEdgeSampler
from ..utils.types import EdgeType, NodeType, RelType, rel_key
from . import primitives, rng
from .neighbor import _int32, _log_weights, _sample_one_hop, _select_lanes


def _stack_ells(gs: Sequence[CscGraph]) -> torch.Tensor:
    """The ELL tables of relations that share a dst type as one ``(m,
    |V_dst|, Wmax)`` tensor: lanes zero-padded to the widest table, the
    last two columns still degree and window start."""
    Wm = max(g.ell.shape[1] for g in gs)
    parts = []
    for g in gs:
        e = g.ell
        if e.shape[1] < Wm:
            lanes = torch.nn.functional.pad(e[:, :-2], (0, Wm - e.shape[1]))
            e = torch.cat([lanes, e[:, -2:]], dim=1)
        parts.append(e)
    return torch.stack(parts)


def _fused_uniform_group(key, gs, ks, frontier, fvalid, with_replacement):
    """One uniform hop for ``m`` relations that share a dst-type frontier:
    one gather of the stacked ELL rows and one ``(m, B, ...)`` draw; each
    stacked row ranks its own lanes, so the relations' draws stay
    independent.  Returns per relation ``(eptr (B, k_r), neighbor (B,
    k_r), valid (B, k_r))``."""
    m = len(gs)
    stacked = _stack_ells(gs)                        # (m, V, W)
    V, W = stacked.shape[1], stacked.shape[2]
    f = frontier.clamp(0, V - 1)
    rows = stacked.reshape(m * V, W)[
        torch.arange(m, device=f.device)[:, None] * V + f[None, :]]
    lanes, deg, starts = rows[..., :-2], rows[..., -2], rows[..., -1]
    deg = torch.where(fvalid[None, :], deg, 0).long()
    kmax = max(ks)
    if with_replacement:
        pos, valid = primitives.replacement_positions(key, deg, kmax)
    else:
        # the first k_r of a uniform kmax-subset in random order are a
        # uniform k_r-subset, so one top-k serves every relation's fanout
        pos, valid = primitives.uniform_lane_topk(key, deg, W - 2, kmax)
    eptr = starts.long()[..., None] + pos
    neighbor = _select_lanes(lanes, pos.clamp(0, W - 3)).long()
    return [(eptr[i, :, :k].clamp(0, max(g.num_edges - 1, 0)),
             neighbor[i, :, :k], valid[i, :, :k])
            for i, (g, k) in enumerate(zip(gs, ks))]


class HeteroLayout:
    """Static per-type / per-relation slot layout of one configuration.

    ``node_base[t][l]``: first slot of hop ``l``'s segment in type ``t``'s
    pool; ``rel_node_off[(r, l)]``: offset of relation ``r``'s hop-``l``
    share within src(r)'s hop-``l+1`` segment; ``rel_edge_base[r][l]``:
    first edge slot of hop ``l`` in relation ``r``'s edge arrays.
    """

    def __init__(self, node_types: Sequence[str],
                 rel_specs: Sequence[Tuple[str, str, str]],
                 fanouts: Dict[str, Sequence[int]],
                 num_seeds: Dict[str, int], num_hops: int):
        self.node_types = list(node_types)
        self.rel_specs = list(rel_specs)
        self.num_hops = num_hops
        self.fanouts = {r: list(f) for r, f in fanouts.items()}

        cap = {t: [num_seeds.get(t, 0)] for t in node_types}
        self.rel_node_off: Dict[Tuple[str, int], int] = {}
        self.rel_edge_cap: Dict[str, List[int]] = {
            r: [] for r, _, _ in rel_specs}
        for ell in range(num_hops):
            add = {t: 0 for t in node_types}
            for r, src, dst in rel_specs:
                contrib = cap[dst][ell] * self.fanouts[r][ell]
                self.rel_node_off[(r, ell)] = add[src]
                add[src] += contrib
                self.rel_edge_cap[r].append(contrib)
            for t in node_types:
                cap[t].append(add[t])

        self.cap = cap
        self.node_base = {
            t: [int(x) for x in np.cumsum([0] + cap[t])] for t in node_types}
        self.rel_edge_base = {
            r: [int(x) for x in np.cumsum([0] + self.rel_edge_cap[r])]
            for r, _, _ in rel_specs}

    def total_nodes(self, t: str) -> int:
        return self.node_base[t][-1]

    def total_edges(self, r: str) -> int:
        return self.rel_edge_base[r][-1]


@dataclass
class HeteroNeighborSample:
    """Padded hetero sample: per-type node pools and per-relation local-id
    COO (device tensors)."""

    nodes: Dict[str, torch.Tensor]        # int64 node ids
    node_valid: Dict[str, torch.Tensor]   # bool
    node_state: Dict[str, torch.Tensor]   # int64 filter state
    rows: Dict[str, torch.Tensor]         # int64 local src-type slot
    cols: Dict[str, torch.Tensor]         # int64 local dst-type slot
    eptr: Dict[str, torch.Tensor]         # int64 edge ptr of the relation
    edge_valid: Dict[str, torch.Tensor]   # bool
    meta: Tuple                           # hashable layout spec

    def layout(self) -> HeteroLayout:
        node_types, rel_specs, fanouts, num_seeds, num_hops = self.meta
        return HeteroLayout(list(node_types), [tuple(r) for r in rel_specs],
                            dict(fanouts), dict(num_seeds), num_hops)


def _sample_hetero_impl(key, graphs: Dict[str, CscGraph],
                        inputs: Dict[str, torch.Tensor],
                        input_state: Dict[str, torch.Tensor],
                        log_weights: Optional[Dict[str, torch.Tensor]],
                        timestamps: Optional[Dict[str, torch.Tensor]],
                        meta: Tuple, with_replacement: bool, filter_cfg,
                        window: int, device) -> HeteroNeighborSample:
    node_types, rel_specs, fanouts_t, num_seeds_t, num_hops = meta
    layout = HeteroLayout(list(node_types), [tuple(r) for r in rel_specs],
                          dict(fanouts_t), dict(num_seeds_t), num_hops)

    def zeros(n, dtype):
        return torch.zeros((n,), dtype=dtype, device=device)

    # per-type pools as lists of per-hop segments; the (possibly empty) seed
    # segment is always there, so hop l's segment sits at list index l
    nodes = {t: [] for t in node_types}
    valids = {t: [] for t in node_types}
    states = {t: [] for t in node_types}
    for t in node_types:
        n0 = layout.cap[t][0]
        if t in inputs and inputs[t].shape[0] > 0:
            nodes[t].append(inputs[t].long())
            valids[t].append(torch.ones((n0,), dtype=torch.bool,
                                        device=device))
            states[t].append(input_state[t].int() if t in input_state
                             else zeros(n0, torch.int32))
        else:
            nodes[t].append(zeros(n0, torch.long))
            valids[t].append(zeros(n0, torch.bool))
            states[t].append(zeros(n0, torch.int32))

    rows = {r: [] for r, _, _ in rel_specs}
    cols = {r: [] for r, _, _ in rel_specs}
    eptrs = {r: [] for r, _, _ in rel_specs}
    evalids = {r: [] for r, _, _ in rel_specs}

    def segment(t, ell):
        """(nodes, valid, state) of type t's hop-ell segment."""
        if layout.cap[t][ell] == 0:
            return (zeros(0, torch.long), zeros(0, torch.bool),
                    zeros(0, torch.int32))
        return nodes[t][ell], valids[t][ell], states[t][ell]

    fuse_ok = (log_weights is None and filter_cfg is None
               and all(graphs[r].ell is not None for r, _, _ in rel_specs))

    for ell in range(num_hops):
        hop_new = {t: {} for t in node_types}  # rel -> (nodes, valid, state)
        fused: Dict[str, Tuple[torch.Tensor, ...]] = {}
        if fuse_ok:
            by_dst: Dict[str, List[int]] = {}
            for ri, (r, src, dst) in enumerate(rel_specs):
                if layout.fanouts[r][ell] > 0 and layout.cap[dst][ell] > 0:
                    by_dst.setdefault(dst, []).append(ri)
            for gi, (dst, ris) in enumerate(sorted(by_dst.items())):
                gs = [graphs[rel_specs[ri][0]] for ri in ris]
                if len(ris) < 2 or len({g.ell.shape[0] for g in gs}) != 1:
                    continue
                ks = [layout.fanouts[rel_specs[ri][0]][ell] for ri in ris]
                frontier, fvalid, _ = segment(dst, ell)
                group = _fused_uniform_group(
                    rng.fold(key, ell, 100 + gi), gs, ks, frontier, fvalid,
                    with_replacement)
                for ri, res in zip(ris, group):
                    fused[rel_specs[ri][0]] = res

        for ri, (r, src, dst) in enumerate(rel_specs):
            k = layout.fanouts[r][ell]
            frontier, fvalid, fstate = segment(dst, ell)
            B = frontier.shape[0]
            if B == 0 or k == 0:
                hop_new[src][r] = (zeros(0, torch.long), zeros(0, torch.bool),
                                   zeros(0, torch.int32))
                rows[r].append(zeros(0, torch.long))
                cols[r].append(zeros(0, torch.long))
                eptrs[r].append(zeros(0, torch.long))
                evalids[r].append(zeros(0, torch.bool))
                continue
            if r in fused:
                eptr, neighbor, valid = fused[r]
                new_state = fstate[:, None].expand(eptr.shape)
            else:
                eptr, neighbor, valid, new_state = _sample_one_hop(
                    rng.fold(key, ell, ri), graphs[r], frontier, fvalid,
                    fstate, k, with_replacement=with_replacement,
                    log_weights=(None if log_weights is None
                                 else log_weights[r]),
                    filter_cfg=filter_cfg,
                    timestamps=None if timestamps is None else timestamps[r],
                    window=window)
            base = (layout.node_base[src][ell + 1]
                    + layout.rel_node_off[(r, ell)])
            slot = base + (torch.arange(B, device=device)[:, None] * k
                           + torch.arange(k, device=device)[None, :])
            col = layout.node_base[dst][ell] + torch.arange(B, device=device)
            hop_new[src][r] = (neighbor.reshape(-1), valid.reshape(-1),
                               new_state.reshape(-1))
            rows[r].append(slot.reshape(-1))
            cols[r].append(col[:, None].expand(B, k).reshape(-1))
            eptrs[r].append(eptr.reshape(-1))
            evalids[r].append(valid.reshape(-1))

        # each type's hop-(ell+1) segment, in relation order
        for t in node_types:
            parts = [hop_new[t][r] for r, src, _ in rel_specs
                     if src == t and r in hop_new[t]]
            if parts:
                for pool, i in ((nodes, 0), (valids, 1), (states, 2)):
                    pool[t].append(torch.cat([p[i] for p in parts]))
            else:
                nodes[t].append(zeros(0, torch.long))
                valids[t].append(zeros(0, torch.bool))
                states[t].append(zeros(0, torch.int32))

    return HeteroNeighborSample(
        nodes={t: torch.cat(nodes[t]) for t in node_types},
        node_valid={t: torch.cat(valids[t]) for t in node_types},
        node_state={t: torch.cat(states[t]).long() for t in node_types},
        rows={r: torch.cat(rows[r]) for r, _, _ in rel_specs},
        cols={r: torch.cat(cols[r]) for r, _, _ in rel_specs},
        eptr={r: torch.cat(eptrs[r]) for r, _, _ in rel_specs},
        edge_valid={r: torch.cat(evalids[r]) for r, _, _ in rel_specs},
        meta=meta,
    )


def sample_hetero_neighbors(
    graphs: Dict[RelType, CscGraph],
    edge_types: Sequence[EdgeType],
    inputs: Dict[NodeType, object],
    num_neighbors: Dict[RelType, Sequence[int]],
    num_hops: int,
    *,
    node_types: Optional[Sequence[NodeType]] = None,
    key: Optional[torch.Tensor] = None,
    sampler: Optional[EdgeSampler] = None,
    filter=None,
    window: int = 256,
) -> HeteroNeighborSample:
    """Multi-hop hetero sampling on the graphs' device.

    ``graphs`` maps relation keys to CSC graphs, ``inputs`` node types to
    seed ids, ``num_neighbors`` relation keys to per-hop fanouts;
    ``sampler`` as in ``sample_neighbors`` (weights per relation key),
    ``filter`` a ``(TemporalEdgeFilter, {node type: initial states})`` pair
    with timestamps per relation key.
    """
    if key is None:
        key = rng.next_key()
    device = next(iter(graphs.values())).device
    if node_types is None:
        node_types = sorted({t for e in edge_types for t in (e[0], e[2])})
    # sorted relation order: deterministic where the reference iterates a
    # hash map
    rel_specs = tuple(sorted(
        (rel_key(e), e[0], e[2]) for e in edge_types
        if rel_key(e) in num_neighbors))

    inputs = {t: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v))
              .to(device).long() for t, v in inputs.items()}
    num_seeds = {t: int(v.shape[0]) for t, v in inputs.items()}

    with_replacement = bool(sampler is not None and sampler.with_replacement)
    log_weights = None
    if isinstance(sampler, WeightedEdgeSampler):
        log_weights = {r: _log_weights(w, device)
                       for r, w in sampler.weights.items()}

    filter_cfg, timestamps, input_state = None, None, {}
    if filter is not None:
        filter_cfg, init_state = filter
        timestamps = {r: _int32(v, device)
                      for r, v in filter_cfg.timestamps.items()}
        input_state = {t: _int32(v, device) for t, v in init_state.items()}

    meta = (
        tuple(node_types),
        rel_specs,
        tuple((r, tuple(int(k) for k in num_neighbors[r]))
              for r, _, _ in rel_specs),
        tuple(sorted(num_seeds.items())),
        int(num_hops),
    )
    return _sample_hetero_impl(key, graphs, inputs, input_state, log_weights,
                               timestamps, meta, with_replacement, filter_cfg,
                               window, device)


def compact_hetero_sample(sample: HeteroNeighborSample):
    """Padded sample -> reference-format host dicts: per-type node lists,
    per-relation local-id COO and edge pointers, and per-relation layer
    offsets ``(src_len, edge_len, dst_len)`` taken at each relation's turn
    within each hop."""
    layout = sample.layout()
    node_types, rel_specs = layout.node_types, layout.rel_specs

    nv = {t: sample.node_valid[t].cpu().numpy() for t in node_types}
    new_idx = {t: np.cumsum(nv[t]) - 1 for t in node_types}
    samples_out = {t: sample.nodes[t].cpu().numpy()[nv[t]].astype(np.int64)
                   for t in node_types}
    # cumulative valid-node counts by slot
    ncum = {t: np.concatenate([[0], np.cumsum(nv[t])]) for t in node_types}

    rows_out, cols_out, eptr_out, offsets_out = {}, {}, {}, {}
    for r, src, dst in rel_specs:
        ev = sample.edge_valid[r].cpu().numpy()
        rows_out[r] = new_idx[src][sample.rows[r].cpu().numpy()[ev]].astype(
            np.int64)
        cols_out[r] = new_idx[dst][sample.cols[r].cpu().numpy()[ev]].astype(
            np.int64)
        eptr_out[r] = sample.eptr[r].cpu().numpy()[ev].astype(np.int64)

        ecum = np.concatenate([[0], np.cumsum(ev)])
        offs = []
        for ell in range(layout.num_hops):
            src_slot = (layout.node_base[src][ell + 1]
                        + layout.rel_node_off[(r, ell)])
            offs.append((int(ncum[src][src_slot]),
                         int(ecum[layout.rel_edge_base[r][ell]]),
                         int(ncum[dst][layout.node_base[dst][ell + 1]])))
        offsets_out[r] = offs

    return samples_out, rows_out, cols_out, eptr_out, offsets_out


def neighbor_sampling_heterogenous(
    node_types: List[NodeType],
    edge_types: List[EdgeType],
    col_ptrs: Dict[RelType, np.ndarray],
    row_indices: Dict[RelType, np.ndarray],
    inputs: Dict[NodeType, np.ndarray],
    num_neighbors: Dict[RelType, List[int]],
    num_hops: int,
    sampler: Optional[EdgeSampler] = None,
    filter: Optional[tuple] = None,
    *,
    key: Optional[torch.Tensor] = None,
    node_counts: Optional[Dict[NodeType, int]] = None,
    device="cuda",
):
    """Reference-parity API: host CSC arrays per relation in, the compact
    reference output dicts out."""
    edge_types = [tuple(e) for e in edge_types]
    graphs = {}
    for e in edge_types:
        r = rel_key(e)
        cp = np.asarray(col_ptrs[r])
        ri = np.asarray(row_indices[r])
        n_src = (int(node_counts[e[0]]) if node_counts
                 else int(ri.max(initial=-1)) + 1)
        graphs[r] = make_graph(cp, ri, num_src=n_src, num_dst=cp.shape[0] - 1,
                               device=device)
    out = sample_hetero_neighbors(
        graphs, edge_types, {t: np.asarray(v) for t, v in inputs.items()},
        num_neighbors, num_hops, node_types=node_types, key=key,
        sampler=sampler, filter=filter)
    return compact_hetero_sample(out)
