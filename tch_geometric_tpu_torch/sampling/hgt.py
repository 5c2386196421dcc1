"""Temporal heterogeneous HGT sampling.

Counterpart of ``tch_geometric_tpu/sampling/hgt.py``: the reference's
per-type budget hash maps become dense per-type tables (score, timestamp,
in-sample flag, local id), each with one trailing slot that takes the writes
the JAX package drops (``mode="drop"``) and is sliced off where read.

* Budget update: a uniform ``min(deg, 50)``-subset of each new target's
  in-edges (``sample_edges_uniform``), minus sources already sampled and
  timestamps outside ``timerange``, adds ``1 / min(deg, 50)`` to each
  source's score (``index_add_``: on the CPU in index order, as XLA sums;
  on the card in atomic order, so the last bits of a score may differ) and
  writes the edge's timestamp.  Where several writes hit one node the last
  in flat order wins, as XLA's CPU scatter keeps it: the winner is the
  largest flat position per node (``scatter_reduce`` amax), deterministic
  on the card too.  A repeated seed's local id is likewise its last
  position.
* Sampling ``n`` nodes of a type with probability ~ score^2 is a Gumbel
  top-k over ``2 * log(score)``; the chosen nodes leave the budget.
* The induced adjacency keeps, of a <=50-subset of each sampled node's
  in-edges, those whose source is sampled.

Keys: ``fold(key, 0)`` for the seeds' update, ``fold(key, 1, layer, type
index)`` for the picks, ``fold(key, 2, layer)`` for later updates and
``fold(key, 3, rel index)`` for the adjacency, as in the JAX package.
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

MAX_NEIGHBORS = 50  # the reference's reservoir cap


@dataclass
class HGTSample:
    """Padded HGT sample: per-type node lists + per-relation induced COO."""

    nodes: Dict[str, torch.Tensor]       # (C_t,) node ids
    node_ts: Dict[str, torch.Tensor]     # (C_t,) int32 timestamps
    node_valid: Dict[str, torch.Tensor]  # (C_t,) bool
    rows: Dict[str, torch.Tensor]        # local src slot
    cols: Dict[str, torch.Tensor]        # local dst slot
    eptr: Dict[str, torch.Tensor]
    edge_valid: Dict[str, torch.Tensor]
    meta: Tuple


def _set_last(table: torch.Tensor, index: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``table`` with ``values`` scattered at ``index``; of duplicate
    indices the last in flat order wins (each slot takes the largest flat
    position that names it, or keeps its value)."""
    pos = torch.arange(index.numel(), device=index.device)
    win = torch.full(table.shape, -1, dtype=torch.long, device=index.device)
    win = win.scatter_reduce(0, index.reshape(-1), pos, "amax")
    vals = values.reshape(-1)[win.clamp(min=0)]
    return torch.where(win >= 0, vals.to(table.dtype), table)


def _update_budget(key, rel_specs, graphs, edge_ts, node_counts, score,
                   btime, in_sample, new_nodes, new_ts, new_valid,
                   timerange):
    """Add ``1 / min(deg, 50)`` to the source scores of each new target's
    sampled in-edges and write their timestamps."""
    for ri, (r, src, dst) in enumerate(rel_specs):
        w = new_nodes[dst]
        if w.shape[0] == 0:
            continue
        wts = new_ts[dst]
        deg, _pos, pvalid, eptr, v = sample_edges_uniform(
            rng.fold(key, ri), graphs[r], w, new_valid[dst], MAX_NEIGHBORS)
        ncount = deg.clamp(max=MAX_NEIGHBORS)
        inv_deg = torch.where(ncount > 0, 1.0 / ncount.clamp(min=1), 0.0)
        if edge_ts is not None and r in edge_ts:
            vts = take_clamped(edge_ts[r], eptr)
            vts = torch.where(vts == NAN_TIMESTAMP, wts[:, None], vts)
        else:
            vts = wts[:, None].expand(v.shape)
        ok = pvalid & ~in_sample[src][v]
        if timerange is not None:
            lo, hi = timerange
            ok = ok & ((vts == NAN_TIMESTAMP) | ((vts >= lo) & (vts < hi)))
        n = node_counts[src]
        idx = torch.where(ok, v, n)           # masked lanes -> the pad slot
        score[src] = score[src].index_add(
            0, idx.reshape(-1), torch.where(ok, inv_deg[:, None], 0.0)
            .reshape(-1).float())
        btime[src] = _set_last(btime[src], idx, vts)
    return score, btime


def _hgt_sampling_impl(key, graphs: Dict[str, CscGraph],
                       edge_ts: Optional[Dict[str, torch.Tensor]],
                       inputs: Dict[str, torch.Tensor],
                       input_ts: Optional[Dict[str, torch.Tensor]],
                       meta: Tuple, device) -> HGTSample:
    (node_types, rel_specs, num_samples_t, num_hops, timerange,
     node_counts_t) = meta
    num_samples = dict(num_samples_t)
    node_counts = dict(node_counts_t)

    def full(n, value, dtype):
        return torch.full((n,), value, dtype=dtype, device=device)

    # dense budget tables, one pad slot each
    score = {t: full(node_counts[t] + 1, 0.0, torch.float32)
             for t in node_types}
    btime = {t: full(node_counts[t] + 1, NAN_TIMESTAMP, torch.int32)
             for t in node_types}
    in_sample = {t: full(node_counts[t] + 1, False, torch.bool)
                 for t in node_types}
    local_id = {t: full(node_counts[t] + 1, 0, torch.long)
                for t in node_types}

    caps = {t: [len(inputs[t]) if t in inputs else 0]
            + [num_samples[t][ell] for ell in range(num_hops)]
            for t in node_types}
    base = {t: np.cumsum([0] + caps[t]).tolist() for t in node_types}

    def in_range(ids, n):
        return torch.where((ids >= 0) & (ids < n), ids, n)

    nodes, node_ts, node_valid = {}, {}, {}
    for t in node_types:
        C = base[t][-1]
        nodes[t] = full(C, 0, torch.long)
        node_ts[t] = full(C, NAN_TIMESTAMP, torch.int32)
        node_valid[t] = full(C, False, torch.bool)
        if t in inputs and inputs[t].shape[0] > 0:
            seeds = inputs[t].long()
            S = seeds.shape[0]
            nodes[t][:S] = seeds
            if input_ts is not None and t in input_ts:
                node_ts[t][:S] = input_ts[t].int()
            node_valid[t][:S] = True
            at = in_range(seeds, node_counts[t])
            in_sample[t][at] = True
            # a repeated seed keeps its last position
            local_id[t] = _set_last(local_id[t], at,
                                    torch.arange(S, device=device))

    score, btime = _update_budget(
        rng.fold(key, 0), rel_specs, graphs, edge_ts, node_counts, score,
        btime, in_sample, {t: nodes[t][: base[t][1]] for t in node_types},
        {t: node_ts[t][: base[t][1]] for t in node_types},
        {t: node_valid[t][: base[t][1]] for t in node_types}, timerange)

    for layer in range(num_hops):
        new_nodes, new_ts_d, new_valid = {}, {}, {}
        for t in node_types:
            n = num_samples[t][layer]
            N = node_counts[t]
            if n == 0 or N == 0:
                new_nodes[t] = full(n, 0, torch.long)
                new_ts_d[t] = full(n, NAN_TIMESTAMP, torch.int32)
                new_valid[t] = full(n, False, torch.bool)
                continue
            # n picks with probability ~ score^2; zero scores are out
            s = score[t][:N]
            logits = torch.where(s > 0.0,
                                 2.0 * torch.log(s.clamp(min=1e-30)),
                                 primitives.NEG_INF)
            chosen, valid = primitives.masked_gumbel_topk(
                rng.fold(key, 1, layer, node_types.index(t)), logits, n)
            new_nodes[t] = torch.where(valid, chosen, 0)
            new_ts_d[t] = torch.where(valid, btime[t][chosen], NAN_TIMESTAMP)
            new_valid[t] = valid
            # out of the budget; record the output slot
            slot = base[t][layer + 1] + torch.arange(n, device=device)
            nodes[t][slot] = new_nodes[t]
            node_ts[t][slot] = new_ts_d[t]
            node_valid[t][slot] = valid
            at = torch.where(valid, chosen, N)     # distinct where valid
            score[t] = score[t].index_fill(0, at, 0.0)
            in_sample[t] = in_sample[t].index_fill(0, at, True)
            local_id[t] = _set_last(local_id[t], at, slot)

        if layer < num_hops - 1:
            score, btime = _update_budget(
                rng.fold(key, 2, layer), rel_specs, graphs, edge_ts,
                node_counts, score, btime, in_sample, new_nodes, new_ts_d,
                new_valid, timerange)

    # the induced adjacency: of <= 50 in-edges per node, the sampled ones
    rows, cols, eptrs, evalids = {}, {}, {}, {}
    for ri, (r, src, dst) in enumerate(rel_specs):
        w = nodes[dst]
        C = w.shape[0]
        if C == 0 or node_counts[dst] == 0:
            rows[r] = cols[r] = eptrs[r] = full(0, 0, torch.long)
            evalids[r] = full(0, False, torch.bool)
            continue
        _deg, _pos, pvalid, eptr, v = sample_edges_uniform(
            rng.fold(key, 3, ri), graphs[r], w, node_valid[dst],
            MAX_NEIGHBORS)
        keep = pvalid & in_sample[src][v]
        rows[r] = torch.where(keep, local_id[src][v], 0).reshape(-1)
        cols[r] = torch.arange(C, device=device)[:, None].expand(
            C, MAX_NEIGHBORS).reshape(-1)
        eptrs[r] = eptr.reshape(-1)
        evalids[r] = keep.reshape(-1)

    return HGTSample(nodes=nodes, node_ts=node_ts, node_valid=node_valid,
                     rows=rows, cols=cols, eptr=eptrs, edge_valid=evalids,
                     meta=meta)


def sample_hgt(
    graphs: Dict[RelType, CscGraph],
    edge_types: Sequence[EdgeType],
    inputs: Dict[NodeType, object],
    num_samples: Dict[NodeType, Sequence[int]],
    num_hops: int,
    *,
    node_counts: Dict[NodeType, int],
    edge_timestamps: Optional[Dict[RelType, object]] = None,
    input_timestamps: Optional[Dict[NodeType, object]] = None,
    timerange: Optional[Tuple[int, int]] = None,
    node_types: Optional[Sequence[NodeType]] = None,
    key: Optional[torch.Tensor] = None,
) -> HGTSample:
    """HGT sampling on the graphs' device.  ``num_samples`` maps a node type
    to its per-layer picks; ``timerange`` gates the sampled edges'
    timestamps (``edge_timestamps`` per relation, by sorted edge)."""
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
    meta = (
        tuple(node_types),
        rel_specs,
        tuple((t, tuple(int(x) for x in num_samples[t])) for t in node_types),
        int(num_hops),
        None if timerange is None else (int(timerange[0]),
                                        int(timerange[1])),
        tuple((t, int(node_counts[t])) for t in node_types),
    )
    return _hgt_sampling_impl(key, graphs, edge_timestamps, inputs,
                              input_timestamps, meta, device)


def compact_hgt_sample(sample: HGTSample):
    """Padded -> the reference format: ``(nodes, node_timestamps, rows,
    cols, edge_ptrs)`` dicts."""
    node_types, rel_specs = sample.meta[0], sample.meta[1]

    def host(x):
        return x.cpu().numpy()

    nv = {t: host(sample.node_valid[t]) for t in node_types}
    new_idx = {t: np.cumsum(nv[t]) - 1 for t in node_types}
    nodes_out = {t: host(sample.nodes[t])[nv[t]].astype(np.int64)
                 for t in node_types}
    ts_out = {t: host(sample.node_ts[t])[nv[t]].astype(np.int64)
              for t in node_types}
    rows_out, cols_out, eptr_out = {}, {}, {}
    for (r, src, dst) in rel_specs:
        ev = host(sample.edge_valid[r])
        rows_out[r] = new_idx[src][host(sample.rows[r])[ev]].astype(np.int64)
        cols_out[r] = new_idx[dst][host(sample.cols[r])[ev]].astype(np.int64)
        eptr_out[r] = host(sample.eptr[r])[ev].astype(np.int64)
    return nodes_out, ts_out, rows_out, cols_out, eptr_out


def hgt_sampling(
    node_types: List[NodeType],
    edge_types: List[EdgeType],
    col_ptrs: Dict[RelType, np.ndarray],
    row_indices: Dict[RelType, np.ndarray],
    row_timestamps: Optional[Dict[RelType, np.ndarray]],
    inputs: Dict[NodeType, np.ndarray],
    input_timestamps: Optional[Dict[NodeType, np.ndarray]],
    num_samples: Dict[NodeType, List[int]],
    num_hops: int,
    timerange: Optional[Tuple[int, int]] = None,
    *,
    key: Optional[torch.Tensor] = None,
    node_counts: Optional[Dict[NodeType, int]] = None,
    device="cuda",
):
    """Reference-parity API: host CSC arrays per relation in, the compact
    reference output out; the sampling runs on ``device``."""
    edge_types = [tuple(e) for e in edge_types]
    graphs = {}
    counts: Dict[str, int] = dict(node_counts or {})
    for e in edge_types:
        r = rel_key(e)
        cp = np.asarray(col_ptrs[r])
        ri = np.asarray(row_indices[r])
        counts.setdefault(e[0], int(ri.max(initial=-1)) + 1)
        counts.setdefault(e[2], cp.shape[0] - 1)
        graphs[r] = make_graph(cp, ri, num_src=counts[e[0]],
                               num_dst=cp.shape[0] - 1, device=device)
    out = sample_hgt(
        graphs, edge_types, {t: np.asarray(v) for t, v in inputs.items()},
        num_samples, num_hops, node_counts=counts,
        edge_timestamps=row_timestamps, input_timestamps=input_timestamps,
        timerange=timerange, node_types=node_types, key=key)
    return compact_hgt_sample(out)
