"""Distributed negative sampling over a partitioned graph topology.

Counterpart of ``tch_geometric_tpu/parallel/dist_negative.py``.  The
reference's negative sampler draws, per input node ``v``, up to
``try_count`` uniform candidates ``w`` per negative and accepts the first
that is no edge (``!has_edge(v, w)``) and not ``v`` itself.  The probe
needs one adjacency row, which only its owner holds:

* outbound (the default): ``has_edge(v, w)`` reads v's row, so all
  ``num_neg * try_count`` candidates of an input travel to v's owner in
  one request and the owner answers every membership test against its
  row at once (in row chunks, so the (rows, lanes, candidates) compare
  stays bounded);
* ``inbound``: ``has_edge(w, v)`` reads w's row, so the probes route one
  per candidate to each candidate's owner.

Candidates are drawn on the requesting rank under keys folded on the
input's global uid, so they, and the accepted negatives, are bit-identical
for any number of ranks, and to the JAX package's.  A probe that no round
carried counts as "exists" (its candidate is rejected).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..sampling import primitives, rng
from ..utils.types import rel_key as _rel_key
from .dist_sampling import (PartitionedGraph, _check_graph, _uid_keys,
                            exchange_rounds, resolve_num_rounds,
                            sample_capacity)
from .dist_walks import _has_neighbor, _recv_rows, _uids
from .mesh import Mesh, along, axis_index, spmd
from .multihost import placed

# compare elements (rows x lanes x targets) of one membership chunk
_PROBE_ELEMS = 1 << 26


def _owner_membership(g: PartitionedGraph, recv, n_targets: int,
                      window: int = 512):
    """Owner-side membership probe: ``recv (P, C, 2 + n_targets)`` carries
    ``[local_row, target_0 .. target_{K-1}, 1]``; returns (P, C, K) int32
    bits, is ``target_k`` among the row's neighbors."""
    Pn, C, _ = recv.shape
    rows, live = _recv_rows(g, recv)
    targets = recv[..., 1: 1 + n_targets].reshape(-1, n_targets)
    width = g.ell.shape[1] - 2 if g.ell is not None else window
    step = max(1, _PROBE_ELEMS // max(width * n_targets, 1))
    hit = torch.zeros(targets.shape, dtype=torch.bool, device=recv.device)
    for lo in range(0, rows.shape[0], step):
        hit[lo: lo + step] = _has_neighbor(g, rows[lo: lo + step],
                                           live[lo: lo + step],
                                           targets[lo: lo + step], window)
    return hit.to(torch.int32).reshape(Pn, C, n_targets)


def _probe_exists(g: PartitionedGraph, v, cand, *, inbound: bool, axis,
                  num_parts: int, capacity_factor: float, num_rounds: int):
    """Edge-existence probes of ``v (L,)`` inputs against ``cand (L, K)``
    candidates at their owners: (exists (L, K) bool, overflow)."""
    L, K = cand.shape
    route = dict(axis=axis, num_parts=num_parts, num_rounds=num_rounds)
    if not inbound:
        # v's row: one request an input, K targets each
        gid = v.long().clamp(0, max(g.num_nodes - 1, 0))
        local = torch.div(gid, num_parts, rounding_mode="floor")
        payload = torch.cat([local[:, None], cand.long(),
                             torch.ones_like(local)[:, None]], dim=-1)
        res, got, overflow = exchange_rounds(
            payload.to(torch.int32), gid % num_parts,
            torch.ones((L,), dtype=torch.bool, device=v.device),
            lambda recv: _owner_membership(g, recv, K),
            capacity=sample_capacity(capacity_factor, L, num_parts),
            ret_cols=K,
            **route)
        return (res != 0) | ~got[:, None], overflow
    # each candidate's row: L*K requests, one target (v) each
    gid = cand.reshape(-1).long().clamp(0, max(g.num_nodes - 1, 0))
    local = torch.div(gid, num_parts, rounding_mode="floor")
    vflat = v.long()[:, None].expand(L, K).reshape(-1)
    res, got, overflow = exchange_rounds(
        torch.stack([local, vflat, torch.ones_like(local)], dim=-1).to(
            torch.int32), gid % num_parts,
        torch.ones((L * K,), dtype=torch.bool, device=v.device),
        lambda recv: _owner_membership(g, recv, 1),
        capacity=sample_capacity(capacity_factor, L * K, num_parts),
        ret_cols=1,
        **route)
    return ((res[:, 0] != 0) | ~got).reshape(L, K), overflow


def _first_accepted(cand, ok):
    """Per (input, negative): the first accepted of the try_count
    candidates (the first, if none is) and whether one is."""
    first = primitives.argmax(ok.to(torch.uint8))
    w = cand.gather(-1, first[..., None])[..., 0]
    return w.to(torch.int32), ok.any(dim=-1)


def _dist_negative_device(key, g: PartitionedGraph, inputs_local, *,
                          dev: int, num_neg: int, try_count: int,
                          inbound: bool, axis, num_parts: int,
                          capacity_factor: float, num_rounds: int,
                          exclude=None):
    """One rank's shard: draw candidates for its inputs, probe edge
    existence at the owners, first-accept locally.  ``exclude (L,)``
    rejects one more node id per input (the link trainer's true dst).
    Returns (w (L, num_neg) int32, accepted (L, num_neg), overflow)."""
    L = inputs_local.shape[0]
    K = num_neg * try_count
    device = inputs_local.device
    v = inputs_local.long()
    keys = _uid_keys(rng.fold(key, 0), _uids(dev, L, device))
    cand = rng.randint_each(keys, (K,), 0, max(g.num_nodes, 1))   # (L, K)
    exists, overflow = _probe_exists(
        g, v, cand, inbound=inbound, axis=axis, num_parts=num_parts,
        capacity_factor=capacity_factor, num_rounds=num_rounds)
    ok = ~exists & (cand != v[:, None])
    if exclude is not None:
        ok = ok & (cand != exclude.long()[:, None])
    w, accepted = _first_accepted(cand.reshape(L, num_neg, try_count),
                                  ok.reshape(L, num_neg, try_count))
    return w, accepted, overflow


def dist_negative_sample(key, graph: PartitionedGraph, inputs, num_neg: int,
                         try_count: int, mesh: Mesh, *,
                         inbound: bool = False, axis: str = "data",
                         capacity_factor: float = 1.3,
                         num_rounds: Optional[int] = None):
    """Distributed negative sampling (the reference's
    ``negative_sample_neighbors_homogenous`` over a partition).

    ``inputs (B,)`` must divide the mesh axis; rank ``d`` draws the
    negatives of inputs ``[d*B/P, (d+1)*B/P)``.  Returns ``(w (P, L,
    num_neg) int32, accepted (P, L, num_neg), overflow (P,))``: ``w[d, i,
    n]`` is the first accepted non-edge candidate (valid where
    ``accepted``), bit-identical for any number of ranks."""
    Pn = mesh.axis_size(axis)
    _check_graph(graph, Pn, False, False)
    inputs = torch.as_tensor(inputs if torch.is_tensor(inputs)
                             else np.asarray(inputs)).to(torch.int32)
    if inputs.shape[0] % Pn:
        raise ValueError("the global input batch must divide the mesh axis")
    num_rounds = resolve_num_rounds(num_rounds, Pn)

    def body(gshard, inputs_local):
        return _dist_negative_device(
            key, gshard, inputs_local, dev=axis_index(axis),
            num_neg=int(num_neg), try_count=int(try_count),
            inbound=bool(inbound), axis=axis, num_parts=Pn,
            capacity_factor=float(capacity_factor), num_rounds=num_rounds)

    on = (axis,)
    return along(mesh, axis, spmd(mesh, body, placed(graph, mesh, on),
                                  placed(inputs, mesh, on)))


# ---------------------------------------------------------------------------
# Typed (heterogeneous) distributed negative sampling
# ---------------------------------------------------------------------------

def _dist_negative_hetero_device(key, rels, inputs, *, dev: int, node_types,
                                 type_rels, dst_counts, num_neg: int,
                                 try_count: int, inbound: bool, axis,
                                 num_parts: int, capacity_factor: float,
                                 num_rounds: int):
    K = num_neg * try_count
    out_w, out_acc, out_rel = {}, {}, {}
    device = next(iter(inputs.values())).device
    overflow = torch.zeros((), dtype=torch.long, device=device)
    for ti, t in enumerate(node_types):
        v = inputs[t].long()                    # (L,) type-local ids
        L = v.shape[0]
        t_rels = type_rels[t]
        R = len(t_rels)
        if L == 0 or R == 0:
            out_w[t] = torch.zeros((L, num_neg), dtype=torch.int32,
                                   device=device)
            out_acc[t] = torch.zeros((L, num_neg), dtype=torch.bool,
                                     device=device)
            out_rel[t] = torch.zeros((L, num_neg), dtype=torch.int32,
                                     device=device)
            continue
        uid = _uids(dev, L, device)
        tkey = rng.fold(key, ti)
        # a uniformly random outgoing relation per (input, negative)
        rel_choice = rng.randint_each(_uid_keys(rng.fold(tkey, 0), uid),
                                      (num_neg,), 0, R)
        cands, oks = [], []
        for ri, (r, dst_t) in enumerate(t_rels):
            cand = rng.randint_each(_uid_keys(rng.fold(tkey, 1 + ri), uid),
                                    (K,), 0, max(dst_counts[dst_t], 1))
            exists, ovf = _probe_exists(
                rels[r], v, cand, inbound=inbound, axis=axis,
                num_parts=num_parts, capacity_factor=capacity_factor,
                num_rounds=num_rounds)
            overflow = overflow + ovf
            cands.append(cand)
            oks.append(~exists & (cand != v[:, None]))
        # the chosen relation's candidates per (input, negative)
        li = torch.arange(L, device=device)[:, None]
        ni = torch.arange(num_neg, device=device)[None, :]
        candc = torch.stack(cands).reshape(R, L, num_neg, try_count)[
            rel_choice, li, ni]
        okc = torch.stack(oks).reshape(R, L, num_neg, try_count)[
            rel_choice, li, ni]
        out_w[t], out_acc[t] = _first_accepted(candc, okc)
        out_rel[t] = rel_choice.to(torch.int32)
    return out_w, out_acc, out_rel, overflow


def dist_negative_sample_hetero(key, rels, edge_types, inputs, num_neg: int,
                                try_count: int, mesh: Mesh, *,
                                node_counts, inbound: bool = False,
                                axis: str = "data",
                                capacity_factor: float = 1.3,
                                num_rounds: Optional[int] = None):
    """Typed distributed negative sampling (the reference's
    ``negative_sample_neighbors_heterogenous`` over a partition).

    ``rels``: dict ``rel_key`` -> :class:`PartitionedGraph`, each built by
    ``build_partitioned_graph`` from its relation's CSR (rows are the src
    nodes' out-neighbors).  Per input of type ``t``: a uniformly random
    outgoing relation of ``t`` (keyed per global input uid), then
    first-accept over ``try_count`` uniform candidates in that relation's
    dst space, probed at the owners (``inbound`` flips the probe).  Every
    relation's probe runs for all inputs; node types in sorted order, each
    type's relations in their order of first appearance in
    ``edge_types``.

    Returns ``(w, accepted, rel_choice)`` dicts of per-type tensors with a
    leading rank axis (``(P, L_t, num_neg)``) and ``overflow (P,)``;
    ``rel_choice[t][d, i, n]`` indexes type ``t``'s relation list."""
    Pn = mesh.axis_size(axis)
    edge_types = [tuple(e) for e in edge_types]
    node_types = sorted({tt for e in edge_types for tt in (e[0], e[2])})
    type_rels = {t: [] for t in node_types}
    for e in edge_types:
        type_rels[e[0]].append((_rel_key(e), e[2]))
    dst_counts = {t: int(n) for t, n in node_counts.items()}
    used = {r: rels[r] for trs in type_rels.values() for r, _d in trs}
    for g in used.values():
        _check_graph(g, Pn, False, False)
    typed = {}
    for t in node_types:
        vv = inputs.get(t, np.zeros((0,), np.int64))
        vv = torch.as_tensor(vv if torch.is_tensor(vv)
                             else np.asarray(vv)).to(torch.int32)
        if vv.shape[0] % Pn:
            raise ValueError(f"type {t!r}: {vv.shape[0]} inputs do not "
                             f"divide the mesh axis ({Pn})")
        typed[t] = vv
    num_rounds = resolve_num_rounds(num_rounds, Pn)

    def body(gshards, inputs_local):
        return _dist_negative_hetero_device(
            key, gshards, inputs_local, dev=axis_index(axis),
            node_types=node_types, type_rels=type_rels,
            dst_counts=dst_counts, num_neg=int(num_neg),
            try_count=int(try_count), inbound=bool(inbound), axis=axis,
            num_parts=Pn, capacity_factor=float(capacity_factor),
            num_rounds=num_rounds)

    on = (axis,)
    return along(mesh, axis, spmd(mesh, body, placed(used, mesh, on),
                                  placed(typed, mesh, on)))
