"""Per-node budget sampling (GraphSAGE-budget, temporal, heterogeneous).

Counterpart of ``tch_geometric_tpu/sampling/budget.py``.  Every frontier
node's budget is a dense ``(frontier, R_t, 50)`` candidate tensor (R_t the
relations into its type) with validity bits:

* the candidates of (node, relation) are a uniform ``min(deg, 50)``-subset
  of its in-edges (``sample_edges_uniform`` keyed ``fold(key, hop, rel)``),
  masked by the temporal filter;
* ``k`` of each node's valid candidates are chosen uniformly by one Gumbel
  top-k per type (keyed ``fold(key, hop, 1000 + type index)``);
* each (node, relation) pair owns ``k`` statically placed slots, valid where
  the chosen candidate came from that relation.

The filter is the reference's runtime variant: a half-open window on
``edge ts - parent ts`` (negated unless ``forward``), missing timestamps
pass, and a child's timestamp is its edge's, or its root's when
``relative``.  The same keys and shapes as the JAX package give the same
sample, array for array.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import CscGraph, make_graph, take_clamped
from ..utils.types import NAN_TIMESTAMP, EdgeType, NodeType, RelType, rel_key
from . import primitives, rng
from .neighbor import _int32, sample_edges_uniform

MAX_NEIGHBORS = 50  # the reference's candidate cap


@dataclass
class BudgetSample:
    """Padded budget sample: per-type pools + per-relation local-id COO."""

    nodes: Dict[str, torch.Tensor]
    node_ts: Dict[str, torch.Tensor]
    node_valid: Dict[str, torch.Tensor]
    rows: Dict[str, torch.Tensor]
    cols: Dict[str, torch.Tensor]
    eptr: Dict[str, torch.Tensor]
    edge_valid: Dict[str, torch.Tensor]
    meta: Tuple


class _Layout:
    """Static slot layout: per-type hop segments subdivided by relation."""

    def __init__(self, node_types, rel_specs, fanouts, num_seeds, num_hops):
        self.node_types = list(node_types)
        self.rel_specs = list(rel_specs)
        self.num_hops = num_hops
        self.fanouts = dict(fanouts)      # per dst node type, per hop
        cap = {t: [num_seeds.get(t, 0)] for t in node_types}
        self.rel_node_off = {}
        self.rel_edge_cap = {r: [] for r, _, _ in rel_specs}
        for ell in range(num_hops):
            add = {t: 0 for t in node_types}
            for r, src, dst in rel_specs:
                contrib = cap[dst][ell] * self.fanouts[dst][ell]
                self.rel_node_off[(r, ell)] = add[src]
                add[src] += contrib
                self.rel_edge_cap[r].append(contrib)
            for t in node_types:
                cap[t].append(add[t])
        self.cap = cap
        self.node_base = {t: [int(x) for x in np.cumsum([0] + cap[t])]
                          for t in node_types}
        self.rel_edge_base = {r: [int(x) for x in
                                  np.cumsum([0] + self.rel_edge_cap[r])]
                              for r, _, _ in rel_specs}


def _budget_sampling_impl(key, graphs: Dict[str, CscGraph],
                          edge_ts: Optional[Dict[str, torch.Tensor]],
                          inputs: Dict[str, torch.Tensor],
                          input_ts: Optional[Dict[str, torch.Tensor]],
                          meta: Tuple, device) -> BudgetSample:
    (node_types, rel_specs, fanouts_t, num_seeds_t, num_hops,
     filter_static) = meta
    layout = _Layout(node_types, rel_specs, dict(fanouts_t),
                     dict(num_seeds_t), num_hops)
    rels_by_dst = {t: [(ri, r, src) for ri, (r, src, dst)
                       in enumerate(rel_specs) if dst == t]
                   for t in node_types}

    def full(n, value, dtype):
        return torch.full((n,), value, dtype=dtype, device=device)

    nodes = {t: [] for t in node_types}
    valids = {t: [] for t in node_types}
    states = {t: [] for t in node_types}
    for t in node_types:
        n0 = layout.cap[t][0]
        seeded = t in inputs and inputs[t].shape[0] > 0
        nodes[t].append(inputs[t].long() if seeded
                        else full(n0, 0, torch.long))
        valids[t].append(full(n0, seeded, torch.bool))
        states[t].append(input_ts[t].int() if seeded and input_ts
                         and t in input_ts
                         else full(n0, NAN_TIMESTAMP, torch.int32))

    rows = {r: [] for r, _, _ in rel_specs}
    cols = {r: [] for r, _, _ in rel_specs}
    eptrs = {r: [] for r, _, _ in rel_specs}
    evalids = {r: [] for r, _, _ in rel_specs}

    def filt(w_t, v_t):
        """The temporal filter: a missing timestamp passes; half-open."""
        if filter_static is None:
            return torch.ones(v_t.shape, dtype=torch.bool, device=device)
        (lo, hi), fwd, _rel = filter_static
        d = v_t - w_t if fwd else w_t - v_t
        nan = (w_t == NAN_TIMESTAMP) | (v_t == NAN_TIMESTAMP)
        return nan | ((d >= lo) & (d < hi))

    def mutate(w_t, v_t):
        if filter_static is not None and filter_static[2]:   # relative
            return w_t.expand(v_t.shape)
        return v_t

    for ell in range(num_hops):
        hop_new = {t: {} for t in node_types}
        for t in node_types:
            B = layout.cap[t][ell]
            k = layout.fanouts[t][ell]
            t_rels = rels_by_dst[t]
            if B == 0 or k == 0 or not t_rels:
                for _ri, r, src in t_rels:
                    hop_new[src][r] = (full(0, 0, torch.long),
                                       full(0, False, torch.bool),
                                       full(0, 0, torch.int32))
                    for d, dt in ((rows, torch.long), (cols, torch.long),
                                  (eptrs, torch.long),
                                  (evalids, torch.bool)):
                        d[r].append(full(0, 0, dt))
                continue
            R = len(t_rels)
            frontier, fvalid, fstate = (nodes[t][ell], valids[t][ell],
                                        states[t][ell])

            # the (B, R, 50) candidate tensor
            cand_v, cand_e, cand_ts, cand_ok = [], [], [], []
            for ri, r, _src in t_rels:
                _deg, _pos, pvalid, eptr, v = sample_edges_uniform(
                    rng.fold(key, ell, ri), graphs[r], frontier, fvalid,
                    MAX_NEIGHBORS)
                if edge_ts is not None and r in edge_ts:
                    vts = take_clamped(edge_ts[r], eptr)
                    vts = torch.where(vts == NAN_TIMESTAMP, fstate[:, None],
                                      vts)
                else:
                    vts = fstate[:, None].expand(v.shape)
                cand_v.append(v)
                cand_e.append(eptr)
                cand_ts.append(mutate(fstate[:, None], vts))
                cand_ok.append(pvalid & filt(fstate[:, None], vts))
            flat = B, R * MAX_NEIGHBORS

            # k uniform picks among each node's valid candidates
            logits = torch.where(torch.stack(cand_ok, dim=1).reshape(flat),
                                 0.0, primitives.NEG_INF)
            sel, sel_valid = primitives.masked_gumbel_topk(
                rng.fold(key, ell, 1000 + node_types.index(t)), logits, k)
            sel_rel = sel // MAX_NEIGHBORS
            sel_v, sel_e, sel_ts = (
                torch.gather(torch.stack(c, dim=1).reshape(flat), 1, sel)
                for c in (cand_v, cand_e, cand_ts))

            # each pick lands in its relation's static region
            col = (layout.node_base[t][ell]
                   + torch.arange(B, device=device)[:, None]).expand(B, k)
            slot0 = (torch.arange(B, device=device)[:, None] * k
                     + torch.arange(k, device=device)[None, :])
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

        # hop-(ell+1) segments in relation order
        for t in node_types:
            parts = [hop_new[t][r] for r, src_t, _d in rel_specs
                     if src_t == t and r in hop_new[t]]
            nodes[t].append(torch.cat([p[0] for p in parts]) if parts
                            else full(0, 0, torch.long))
            valids[t].append(torch.cat([p[1] for p in parts]) if parts
                             else full(0, False, torch.bool))
            states[t].append(torch.cat([p[2] for p in parts]) if parts
                             else full(0, 0, torch.int32))

    def cat(parts, dtype):
        return torch.cat(parts) if parts else full(0, 0, dtype)

    return BudgetSample(
        nodes={t: cat(nodes[t], torch.long) for t in node_types},
        node_ts={t: cat(states[t], torch.int32) for t in node_types},
        node_valid={t: cat(valids[t], torch.bool) for t in node_types},
        rows={r: cat(rows[r], torch.long) for r, _, _ in rel_specs},
        cols={r: cat(cols[r], torch.long) for r, _, _ in rel_specs},
        eptr={r: cat(eptrs[r], torch.long) for r, _, _ in rel_specs},
        edge_valid={r: cat(evalids[r], torch.bool) for r, _, _ in rel_specs},
        meta=meta,
    )


def sample_budget(
    graphs: Dict[RelType, CscGraph],
    edge_types: Sequence[EdgeType],
    inputs: Dict[NodeType, object],
    num_neighbors: Dict[NodeType, Sequence[int]],
    num_hops: int,
    *,
    edge_timestamps: Optional[Dict[RelType, object]] = None,
    input_timestamps: Optional[Dict[NodeType, object]] = None,
    window: Optional[Tuple[int, int]] = None,
    forward: bool = False,
    relative: bool = False,
    node_types: Optional[Sequence[NodeType]] = None,
    key: Optional[torch.Tensor] = None,
) -> BudgetSample:
    """Budget sampling on the graphs' device.  ``num_neighbors`` maps a
    dst node type to its per-hop picks; ``window`` (with ``forward`` and
    ``relative``) turns the temporal filter on, over ``edge_timestamps``
    per relation (by sorted edge) and ``input_timestamps`` per type."""
    if key is None:
        key = rng.next_key()
    device = next(iter(graphs.values())).device
    if node_types is None:
        node_types = sorted({t for e in edge_types for t in (e[0], e[2])})
    rel_specs = tuple(sorted((rel_key(e), e[0], e[2]) for e in edge_types))
    inputs = {t: torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v))
              .to(device).long() for t, v in inputs.items()}
    if edge_timestamps is not None:
        edge_timestamps = {r: _int32(v, device)
                           for r, v in edge_timestamps.items()}
    if input_timestamps is not None:
        input_timestamps = {t: _int32(v, device)
                            for t, v in input_timestamps.items()}
    filter_static = None
    if window is not None:
        filter_static = ((int(window[0]), int(window[1])), bool(forward),
                         bool(relative))
    meta = (
        tuple(node_types),
        rel_specs,
        tuple((t, tuple(int(x) for x in num_neighbors[t]))
              for t in node_types),
        tuple(sorted((t, int(v.shape[0])) for t, v in inputs.items())),
        int(num_hops),
        filter_static,
    )
    return _budget_sampling_impl(key, graphs, edge_timestamps, inputs,
                                 input_timestamps, meta, device)


def compact_budget_sample(sample: BudgetSample):
    """Padded -> the reference format: per-type nodes and timestamps,
    per-relation local-id COO, edge pointers and layer offsets
    ``(src_len, edge_len, dst_len)`` per hop."""
    (node_types, rel_specs, fanouts_t, num_seeds_t, num_hops,
     _f) = sample.meta
    layout = _Layout(node_types, rel_specs, dict(fanouts_t),
                     dict(num_seeds_t), num_hops)

    def host(x):
        return x.cpu().numpy()

    nv = {t: host(sample.node_valid[t]) for t in node_types}
    new_idx = {t: np.cumsum(nv[t]) - 1 for t in node_types}
    ncum = {t: np.concatenate([[0], np.cumsum(nv[t])]) for t in node_types}
    nodes_out = {t: host(sample.nodes[t])[nv[t]].astype(np.int64)
                 for t in node_types}
    ts_out = {t: host(sample.node_ts[t])[nv[t]].astype(np.int64)
              for t in node_types}
    rows_out, cols_out, eptr_out, offs_out = {}, {}, {}, {}
    for (r, src, dst) in rel_specs:
        ev = host(sample.edge_valid[r])
        rows_out[r] = new_idx[src][host(sample.rows[r])[ev]].astype(np.int64)
        cols_out[r] = new_idx[dst][host(sample.cols[r])[ev]].astype(np.int64)
        eptr_out[r] = host(sample.eptr[r])[ev].astype(np.int64)
        ecum = np.concatenate([[0], np.cumsum(ev)])
        offs = []
        for ell in range(num_hops):
            src_slot = (layout.node_base[src][ell + 1]
                        + layout.rel_node_off[(r, ell)])
            offs.append((int(ncum[src][src_slot]),
                         int(ecum[layout.rel_edge_base[r][ell]]),
                         int(ncum[dst][layout.node_base[dst][ell + 1]])))
        offs_out[r] = offs
    return nodes_out, ts_out, rows_out, cols_out, eptr_out, offs_out


def budget_sampling(
    node_types: List[NodeType],
    edge_types: List[EdgeType],
    col_ptrs: Dict[RelType, np.ndarray],
    row_indices: Dict[RelType, np.ndarray],
    row_timestamps: Optional[Dict[RelType, np.ndarray]],
    inputs: Dict[NodeType, np.ndarray],
    input_timestamps: Optional[Dict[NodeType, np.ndarray]],
    num_neighbors: Dict[NodeType, List[int]],
    num_hops: int,
    window: Optional[Tuple[int, int]] = None,
    forward: bool = False,
    relative: bool = False,
    *,
    key: Optional[torch.Tensor] = None,
    node_counts: Optional[Dict[NodeType, int]] = None,
    device="cuda",
):
    """Reference-parity API: host CSC arrays per relation in, the compact
    reference output out; the sampling runs on ``device``."""
    edge_types = [tuple(e) for e in edge_types]
    graphs = {}
    for e in edge_types:
        r = rel_key(e)
        cp = np.asarray(col_ptrs[r])
        ri = np.asarray(row_indices[r])
        n_src = (int(node_counts[e[0]]) if node_counts
                 else int(ri.max(initial=-1)) + 1)
        graphs[r] = make_graph(cp, ri, num_src=n_src,
                               num_dst=cp.shape[0] - 1, device=device)
    out = sample_budget(
        graphs, edge_types, {t: np.asarray(v) for t, v in inputs.items()},
        num_neighbors, num_hops, edge_timestamps=row_timestamps,
        input_timestamps=input_timestamps, window=window, forward=forward,
        relative=relative, node_types=node_types, key=key)
    return compact_budget_sample(out)
