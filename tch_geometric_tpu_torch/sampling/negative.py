"""Neighbor-aware negative sampling.

Counterpart of ``tch_geometric_tpu/sampling/negative.py``.  Every candidate
is drawn at once — a ``(B, num_neg, try_count)`` ``randint`` with the JAX
package's key and shape, so the draws are bit-equal — edge existence is one
batched binary search (``has_edge``) over the whole tensor, and the winner
of each (input, negative) slot is its first accepting trial.

The samples mapping is host compaction, as in the JAX package: the input
list first, then each accepted negative not seen yet, in discovery order;
here by sorting instead of a Python dict, with the same result.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.graph import CsrGraph, make_graph
from ..utils.types import EdgeType, NodeType, RelType, rel_key
from . import primitives, rng


def _negative_candidates(key, graph: CsrGraph, inputs: torch.Tensor,
                         node_count: int, num_neg: int, try_count: int,
                         inbound: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(w (B, num_neg), accepted (B, num_neg))``: the first candidate per
    (input, negative) slot that is no edge and no self-loop.  ``inbound``
    probes ``(candidate, input)`` instead of ``(input, candidate)``."""
    B = inputs.shape[0]
    v = inputs.long()
    cand = rng.randint(key, (B, num_neg, try_count), 0, node_count,
                       device=graph.device)
    vv = v[:, None, None].expand(cand.shape)
    exists = (graph.has_edge(cand, vv) if inbound
              else graph.has_edge(vv, cand))
    ok = ~exists & (cand != vv)
    first = primitives.argmax(ok.int())          # the first accepting trial
    w = torch.gather(cand, -1, first[..., None])[..., 0]
    return w, ok.any(dim=-1)


def _map_samples(seeds: np.ndarray, found: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's samples mapping, vectorised.  ``seeds`` open the
    sample list (a repeated seed maps to its last position, as a dict built
    from them does); each value of ``found``, in order, maps to its seed
    position or, if new, to the next free position.  Returns ``(positions
    of found, the new samples in order)``."""
    seeds = np.asarray(seeds, dtype=np.int64)
    found = np.asarray(found, dtype=np.int64)
    if found.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    seed_vals, rev_first = np.unique(seeds[::-1], return_index=True)
    seed_pos = len(seeds) - 1 - rev_first
    vals, first, inv = np.unique(found, return_index=True,
                                 return_inverse=True)
    at = np.minimum(np.searchsorted(seed_vals, vals), max(len(seed_vals) - 1,
                                                          0))
    known = (seed_vals[at] == vals) if len(seed_vals) else np.zeros(
        len(vals), bool)
    new = np.flatnonzero(~known)
    new = new[np.argsort(first[new], kind="stable")]   # discovery order
    pos = np.empty(len(vals), np.int64)
    pos[known] = seed_pos[at[known]]
    pos[new] = len(seeds) + np.arange(len(new))
    return pos[inv.reshape(-1)], vals[new]


def _homogenous(key, graph: CsrGraph, inputs, node_count: int,
                num_neg: int, try_count: int):
    """``negative_sample_neighbors_homogenous`` on a built graph."""
    inputs = np.asarray(inputs).astype(np.int64)
    w, accepted = _negative_candidates(
        key, graph, torch.from_numpy(inputs).to(graph.device),
        int(node_count), int(num_neg), int(try_count))
    w, accepted = w.cpu().numpy(), accepted.cpu().numpy()
    rows = np.nonzero(accepted)[0].astype(np.int64)
    cols, new = _map_samples(inputs, w[accepted])
    return np.concatenate([inputs, new]), rows, cols, len(inputs)


def negative_sample_neighbors_homogenous(
    row_ptrs,
    col_indices,
    graph_size: Tuple[int, int],
    inputs,
    num_neg: int,
    try_count: int,
    *,
    key: Optional[torch.Tensor] = None,
    device="cuda",
):
    """Reference-parity API: host CSR arrays in; ``(samples, rows, cols,
    sample_count)`` out, ``rows`` indexing the inputs, ``cols`` indexing
    ``samples`` (the inputs, then the negatives in discovery order),
    ``sample_count = len(inputs)``.  Candidates are drawn and probed on
    ``device``."""
    if key is None:
        key = rng.next_key()
    row_ptrs = np.asarray(row_ptrs)
    graph = make_graph(row_ptrs, np.asarray(col_indices),
                       num_src=row_ptrs.shape[0] - 1,
                       num_dst=int(graph_size[1]), device=device)
    return _homogenous(key, graph, inputs, int(graph_size[1]), num_neg,
                       try_count)


def negative_sample_neighbors_heterogenous(
    node_types: List[NodeType],
    edge_types: List[EdgeType],
    row_ptrs: Dict[RelType, np.ndarray],
    col_indices: Dict[RelType, np.ndarray],
    sizes: Dict[RelType, Tuple[int, int]],
    inputs: Dict[NodeType, np.ndarray],
    num_neg: int,
    try_count: int,
    inbound: bool = False,
    *,
    key: Optional[torch.Tensor] = None,
    device="cuda",
):
    """Reference-parity API: per (input, negative) slot a uniformly random
    outgoing relation of the input's type (a host draw), then rejection
    sampling in that relation's dst space; ``inbound`` flips the probe's
    direction.  Returns ``(samples, rows, cols, sample_count)`` dicts."""
    if key is None:
        key = rng.next_key()
    graphs = {}
    for e in edge_types:
        r = rel_key(e)
        rp = np.asarray(row_ptrs[r])
        graphs[r] = make_graph(rp, np.asarray(col_indices[r]),
                               num_src=rp.shape[0] - 1,
                               num_dst=int(sizes[r][1]), device=device)
    return _heterogenous(key, graphs, node_types, edge_types, sizes, inputs,
                         num_neg, try_count, inbound)


def _heterogenous(key, graphs: Dict[RelType, CsrGraph],
                  node_types: List[NodeType], edge_types: List[EdgeType],
                  sizes: Dict[RelType, Tuple[int, int]],
                  inputs: Dict[NodeType, np.ndarray], num_neg: int,
                  try_count: int, inbound: bool):
    """``negative_sample_neighbors_heterogenous`` on built CSR graphs."""
    edge_types = [tuple(e) for e in edge_types]
    # node type -> ordered (rel_key, dst_type) list
    node_rels: Dict[str, List[Tuple[str, str]]] = {}
    for (src, rel, dst) in edge_types:
        node_rels.setdefault(src, []).append((rel_key((src, rel, dst)), dst))

    seeds = {t: np.asarray(inputs[t]).astype(np.int64) if t in inputs
             else np.zeros(0, np.int64) for t in node_types}
    # the accepted slots of each input type in discovery order:
    # (input type, relation index, input, negative)
    found = []
    for ti, (t, t_inputs) in enumerate(sorted(inputs.items())):
        rels = node_rels.get(t, [])
        if not rels:
            continue
        t_inputs = np.asarray(t_inputs).astype(np.int64)
        B = t_inputs.shape[0]
        tkey = rng.fold(key, ti)
        choice = rng.randint(rng.fold(tkey, 0), (B, num_neg), 0, len(rels),
                             device="cpu").numpy()
        w = np.zeros((B, num_neg), np.int64)
        acc = np.zeros((B, num_neg), bool)
        for ri, (r, _dst) in enumerate(rels):
            x = torch.from_numpy(t_inputs).to(graphs[r].device)
            wr, ar = _negative_candidates(
                rng.fold(tkey, 1 + ri), graphs[r], x, int(sizes[r][1]),
                int(num_neg), int(try_count), inbound=bool(inbound))
            pick = choice == ri
            w[pick] = wr.cpu().numpy()[pick]
            acc[pick] = ar.cpu().numpy()[pick]
        i, n = np.nonzero(acc)
        found.append((t, choice[i, n], i, w[i, n]))

    samples = dict(seeds)
    rows_out = {rel_key(e): [] for e in edge_types}
    cols_out = {rel_key(e): [] for e in edge_types}
    for dst_t in node_types:
        picks = []
        for t, rc, i, ww in found:
            m = np.array([d == dst_t for _, d in node_rels[t]])[rc]
            picks.append((t, rc[m], i[m], ww[m]))
        if not sum(len(p[2]) for p in picks):
            continue
        cols, new = _map_samples(seeds[dst_t],
                                 np.concatenate([p[3] for p in picks]))
        samples[dst_t] = np.concatenate([seeds[dst_t], new])
        at = 0
        for t, rc, i, _ in picks:
            c, at = cols[at:at + len(i)], at + len(i)
            for ri, (r, d) in enumerate(node_rels[t]):
                if d == dst_t:
                    rows_out[r].append(i[rc == ri])
                    cols_out[r].append(c[rc == ri])

    def cat(v):
        return (np.concatenate(v).astype(np.int64) if v
                else np.zeros(0, np.int64))

    return (samples, {r: cat(v) for r, v in rows_out.items()},
            {r: cat(v) for r, v in cols_out.items()},
            {t: len(seeds[t]) for t in node_types})
