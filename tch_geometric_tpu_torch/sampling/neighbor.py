"""Layer-wise neighbor sampling (GraphSAGE-style), homogeneous.

Counterpart of ``tch_geometric_tpu/sampling/neighbor.py`` for the uniform
engines.  The whole multi-hop expansion has static shapes:

* layer capacities are ``cap[0] = num_seeds``, ``cap[l+1] = cap[l] *
  fanout[l]``; hop ``l`` writes exactly ``cap[l] * fanout[l]`` node/edge
  slots, each with a validity bit;
* edge ``(i, s)`` of hop ``l`` appends the node at slot
  ``node_base[l+1] + i*k + s``, so the local COO ``(rows, cols)`` follows
  from arithmetic.

The padded slot layout is identical to the JAX package's, and hop ``l``
draws with ``fold(key, l)`` through the same engines, so a sample compares
array for array; ``split_sample_batches`` cuts an M-batch tree into M
per-batch trees.

Weighted sampling (``WeightedEdgeSampler``) and the three temporal filter
modes run the Gumbel engines: on graphs with an ELL table the windowed
values engine (each node's ``max_degree`` lane values by one clamped
gather, then a ``(B, P)`` top-k or a ``(B, k, P)`` argmax), elsewhere the
chunked window engines of ``primitives.py``.  Timestamps and filter states
are int32, as in the JAX package, so ``t - state`` wraps alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import CscGraph, make_graph
from ..utils.config import (TEMPORAL_SAMPLE_DYNAMIC, TEMPORAL_SAMPLE_STATIC,
                            EdgeSampler, TemporalEdgeFilter,
                            WeightedEdgeSampler)
from . import primitives, rng


@dataclass
class NeighborSample:
    """Padded multi-hop sample (device tensors).

    ``nodes[:num_seeds]`` are the seeds; hop ``l`` occupies the slot range
    ``[node_base[l+1], node_base[l+2])``.  ``rows``/``cols`` are local slot
    indices, ``eptr`` the global sorted-CSC edge pointer.  ``seed_block``
    ``(first, total)``: the tree of the seeds ``[first, first + num_seeds)``
    of a ``total``-seed batch, drawn as that block of the whole batch's
    tree (a data-parallel rank's; dropout over it takes the same block,
    ``models.dropout.tree_rows``); None for a whole batch.
    """

    nodes: torch.Tensor        # (N_total,) int64 node ids (garbage if invalid)
    node_valid: torch.Tensor   # (N_total,) bool
    node_state: torch.Tensor   # (N_total,) int64 filter state (timestamps)
    rows: torch.Tensor         # (E_total,) int64 local src slot
    cols: torch.Tensor         # (E_total,) int64 local dst slot
    eptr: torch.Tensor         # (E_total,) int64 global edge ptr
    edge_valid: torch.Tensor   # (E_total,) bool
    node_base: Tuple[int, ...]
    edge_base: Tuple[int, ...]
    fanouts: Tuple[int, ...]
    seed_block: Optional[Tuple[int, int]] = None

    @property
    def num_hops(self) -> int:
        return len(self.fanouts)


def _layer_layout(num_seeds: int, fanouts: Sequence[int]):
    node_base = [0, num_seeds]
    edge_base = [0]
    for k in fanouts:
        cap = node_base[-1] - node_base[-2]
        edge_base.append(edge_base[-1] + cap * k)
        node_base.append(node_base[-1] + cap * k)
    return tuple(node_base), tuple(edge_base)


def _filter_mask_from_ts(filter_cfg: TemporalEdgeFilter, t: torch.Tensor,
                         state: torch.Tensor) -> torch.Tensor:
    """The temporal window test on edge timestamps ``t`` (B, ...) against
    the parents' states (B,): STATIC tests ``t``, RELATIVE and DYNAMIC
    ``t - state`` (negated when not ``forward``), in int32; the window is
    inclusive at both ends."""
    lo, hi = filter_cfg.window
    if filter_cfg.mode == TEMPORAL_SAMPLE_STATIC:
        d = t
    else:
        d = t - state.reshape(state.shape + (1,) * (t.dim() - state.dim()))
        if not filter_cfg.forward:
            d = -d
    return (d >= lo) & (d <= hi)


def _filter_mask_fn(filter_cfg, timestamps, state):
    """``mask_at(eptr) -> bool`` for the current frontier."""

    def mask_at(eptr):
        return _filter_mask_from_ts(filter_cfg, timestamps[eptr], state)

    return mask_at


def _aligned_window_values(arr: torch.Tensor, starts: torch.Tensor,
                           num_pos: int) -> torch.Tensor:
    """``vals (B, num_pos)`` with ``vals[i, p] == arr[starts[i] + p]``, by
    one clamped gather (lanes past the array end repeat its last value;
    mask them with the degree)."""
    idx = starts.long()[:, None] + torch.arange(num_pos, device=arr.device)
    return arr[idx.clamp(0, max(arr.shape[0] - 1, 0))]


def _select_lanes(lanes: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``lanes[i, pos[i, s]]`` (``pos`` in range)."""
    return torch.gather(lanes, -1, pos)


def sample_edges_uniform(key, graph: CscGraph, frontier, frontier_valid,
                         k: int):
    """Uniform k-subset of each frontier node's in-edges: per node
    ``min(k, deg)`` distinct edges, by lane ranking on the ELL row when the
    table exists, else by Floyd's algorithm.  Returns ``(deg (B,), pos
    (B, k), pvalid (B, k), eptr (B, k), v (B, k))``, ``v`` the neighbor
    ids."""
    if graph.ell is None:
        return primitives.floyd_hop(key, graph, frontier, frontier_valid, k)
    node = frontier.clamp(0, graph.num_ptr_nodes - 1)
    lanes, deg_l, starts = graph.ell_rows(node)
    deg = torch.where(frontier_valid, deg_l, 0).long()
    pos, pvalid = primitives.uniform_lane_topk(key, deg, lanes.shape[-1], k)
    eptr = (starts.long()[:, None] + pos).clamp(0, max(graph.num_edges - 1, 0))
    v = _select_lanes(lanes, pos.clamp(0, lanes.shape[-1] - 1)).long()
    return deg, pos, pvalid, eptr, v


def _ell_values_sample(key, graph: CscGraph, starts, degs, frontier_state,
                       k: int, with_replacement: bool, log_weights,
                       filter_cfg, timestamps, row0: int = 0):
    """The windowed-values engine of ELL graphs: each node's P =
    ``max_degree`` lane values by one gather, then a Gumbel top-k over the
    (B, P) keys, or ``k`` argmaxes over (B, k, P) with replacement.
    Returns ``(pos, valid, tvals)``; ``tvals`` are the lanes' timestamps
    (None unfiltered)."""
    P = max(graph.max_degree, 1)
    lane_ok = torch.arange(P, device=degs.device)[None, :] < degs[..., None]
    logits = torch.zeros(degs.shape + (P,), dtype=torch.float32,
                         device=degs.device)
    if log_weights is not None:
        logits = _aligned_window_values(log_weights, starts, P)
    tvals = None
    if filter_cfg is not None:
        tvals = _aligned_window_values(timestamps, starts, P)
        lane_ok = lane_ok & _filter_mask_from_ts(filter_cfg, tvals,
                                                 frontier_state)
    logits = torch.where(lane_ok, logits, primitives.NEG_INF)
    finite = torch.isfinite(logits)
    if with_replacement:
        noise = rng.gumbel(key, degs.shape + (k, P), device=degs.device,
                           row0=row0)
        total = torch.where(finite[..., None, :], logits[..., None, :] + noise,
                            primitives.NEG_INF)
        pos = primitives.argmax(total)
        valid = torch.isfinite(total.amax(dim=-1))
    else:
        noise = rng.gumbel(key, logits.shape, device=degs.device, row0=row0)
        keys_ = torch.where(finite, logits + noise, primitives.NEG_INF)
        # k > P: JAX's lax.top_k refuses; the slots past P are invalid, as
        # the window engines leave them
        pos, valid = primitives.topk_slots(keys_, k)
    return torch.where(valid, pos, 0), valid, tvals


def _sample_one_hop(key, graph: CscGraph, frontier, frontier_valid,
                    frontier_state, k: int, *, with_replacement: bool,
                    log_weights=None, filter_cfg=None, timestamps=None,
                    window: int = 256, row0: int = 0):
    """Sample <= k in-edges of each frontier node.  ``log_weights`` (E,)
    float32 and ``timestamps`` (E,) int32 are by sorted edge position;
    ``filter_cfg`` a ``TemporalEdgeFilter`` or None; ``row0`` the
    frontier's first row in a larger frontier whose draws it takes a block
    of.  Returns ``(eptr (B,k), neighbor (B,k), valid (B,k), state
    (B,k))``."""
    if (graph.ell is None and filter_cfg is None and log_weights is None
            and not with_replacement):
        _, _, valid, eptr, neighbor = primitives.floyd_hop(
            key, graph, frontier, frontier_valid, k, row0,
            window_table=True)
        return (eptr, neighbor, valid,
                frontier_state[..., None].expand(eptr.shape))
    node = frontier.clamp(0, graph.num_ptr_nodes - 1)
    ell_lanes = None
    if graph.ell is not None:
        ell_lanes, deg_l, starts = graph.ell_rows(node)
        degs = torch.where(frontier_valid, deg_l, 0).long()
    else:
        starts, ends = graph.neighbors_range(node)
        degs = torch.where(frontier_valid, ends - starts, 0)
    starts = starts.long()

    tvals = None
    if filter_cfg is None and log_weights is None:
        if with_replacement:
            pos, valid = primitives.replacement_positions(key, degs, k, row0)
        else:
            pos, valid = primitives.uniform_lane_topk(
                key, degs, ell_lanes.shape[-1], k, row0)
    elif ell_lanes is not None:
        pos, valid, tvals = _ell_values_sample(
            key, graph, starts, degs, frontier_state, k, with_replacement,
            log_weights, filter_cfg, timestamps, row0)
    else:
        engine = (primitives.window_choice_sample if with_replacement
                  else primitives.window_topk_sample)
        logw_at = None if log_weights is None else log_weights.__getitem__
        mask_at = (None if filter_cfg is None else
                   _filter_mask_fn(filter_cfg, timestamps, frontier_state))
        pos, valid = engine(key, starts, degs, k,
                            max_degree=graph.max_degree,
                            num_edges=graph.num_edges, logw_at=logw_at,
                            mask_at=mask_at, window=window, row0=row0)

    eptr = (starts[..., None] + pos).clamp(0, max(graph.num_edges - 1, 0))
    if ell_lanes is not None:
        sel = pos.clamp(0, ell_lanes.shape[-1] - 1)
        neighbor = _select_lanes(ell_lanes, sel).long()
    elif graph.indices_win is not None:
        win, off = graph.gather_neighbor_windows_rows(starts)
        neighbor = _select_lanes(win, off[..., None] + pos).long()
    else:
        neighbor = graph.gather_neighbors(eptr)

    # state propagation: DYNAMIC moves to the edge's timestamp
    if filter_cfg is not None and filter_cfg.mode == TEMPORAL_SAMPLE_DYNAMIC:
        if tvals is not None:
            new_state = _select_lanes(tvals, pos.clamp(0, tvals.shape[-1] - 1))
        else:
            new_state = timestamps[eptr]
    else:
        new_state = frontier_state[..., None].expand(eptr.shape)
    return eptr, neighbor, valid, new_state


def _sample_neighbors_impl(key, graph: CscGraph, inputs: torch.Tensor,
                           input_state: torch.Tensor,
                           fanouts: Tuple[int, ...],
                           with_replacement: bool, log_weights=None,
                           filter_cfg=None, timestamps=None,
                           window: int = 256,
                           seed_block: Optional[Tuple[int, int]] = None
                           ) -> NeighborSample:
    """The padded tree of ``inputs``; with ``seed_block`` ``(first,
    total)``, the block of a ``total``-seed batch's tree that the seeds
    ``[first, first + len(inputs))`` span: each hop draws its frontier's
    rows of the whole batch's draw (frontier row ``first * prod(fanouts[:l])``
    on at hop ``l``), so the block equals those slots of the whole tree."""
    num_seeds = inputs.shape[0]
    device = inputs.device
    node_base, edge_base = _layer_layout(num_seeds, fanouts)

    nodes = [inputs.long()]
    valids = [torch.ones((num_seeds,), dtype=torch.bool, device=device)]
    states = [input_state.int()]
    rows, cols, eptrs, evalids = [], [], [], []
    row0 = 0 if seed_block is None else int(seed_block[0])

    for ell, k in enumerate(fanouts):
        frontier, fvalid, fstate = nodes[ell], valids[ell], states[ell]
        B = frontier.shape[0]
        eptr, neighbor, valid, new_state = _sample_one_hop(
            rng.fold(key, ell), graph, frontier, fvalid, fstate, k,
            with_replacement=with_replacement, log_weights=log_weights,
            filter_cfg=filter_cfg, timestamps=timestamps, window=window,
            row0=row0)
        row0 *= k
        slot = node_base[ell + 1] + (
            torch.arange(B, device=device)[:, None] * k
            + torch.arange(k, device=device)[None, :])
        col = node_base[ell] + torch.arange(B, device=device)[:, None]

        nodes.append(neighbor.reshape(-1))
        valids.append(valid.reshape(-1))
        states.append(new_state.reshape(-1))
        rows.append(slot.reshape(-1))
        cols.append(col.expand(B, k).reshape(-1))
        eptrs.append(eptr.reshape(-1))
        evalids.append(valid.reshape(-1))

    def cat(parts, dtype):
        if parts:
            return torch.cat(parts)
        return torch.zeros((0,), dtype=dtype, device=device)

    return NeighborSample(
        nodes=torch.cat(nodes),
        node_valid=torch.cat(valids),
        node_state=torch.cat(states).long(),
        rows=cat(rows, torch.long),
        cols=cat(cols, torch.long),
        eptr=cat(eptrs, torch.long),
        edge_valid=cat(evalids, torch.bool),
        node_base=node_base,
        edge_base=edge_base,
        fanouts=tuple(fanouts),
        seed_block=None if seed_block is None else (int(seed_block[0]),
                                                    int(seed_block[1])),
    )


def _log_weights(weights, device) -> torch.Tensor:
    """``log(float32(w))``, as the JAX package takes it (not
    ``float32(log(w))``)."""
    w = weights if torch.is_tensor(weights) else np.asarray(weights)
    return torch.log(torch.as_tensor(w, device=device).to(torch.float32))


def _int32(a, device) -> torch.Tensor:
    """Host or device integers as int32 on ``device`` (int64 wraps)."""
    a = a if torch.is_tensor(a) else np.asarray(a)
    return torch.as_tensor(a, device=device).to(torch.int32)


def sample_neighbors(graph: CscGraph, inputs, fanouts: Sequence[int], *,
                     key: Optional[torch.Tensor] = None,
                     sampler: Optional[EdgeSampler] = None,
                     filter=None, window: int = 256) -> NeighborSample:
    """Multi-hop neighbor sampling on ``graph``'s device.

    ``inputs`` are the seed nodes, ``fanouts`` the per-hop neighbor counts,
    ``sampler`` a ``UniformEdgeSampler`` (None: uniform without
    replacement) or a ``WeightedEdgeSampler`` (weights by sorted edge
    position; with replacement when it says so), ``filter`` a
    ``(TemporalEdgeFilter, initial_states)`` pair or a bare
    ``TemporalEdgeFilter`` (states then zero), ``window`` the chunk width
    of the window engines.
    """
    if key is None:
        key = rng.next_key()
    device = graph.device
    inputs = torch.as_tensor(inputs).to(device).long()
    with_replacement = bool(sampler is not None and sampler.with_replacement)
    log_weights = None
    if isinstance(sampler, WeightedEdgeSampler):
        log_weights = _log_weights(sampler.weights, device)
    filter_cfg, timestamps = None, None
    input_state = torch.zeros(inputs.shape, dtype=torch.int32, device=device)
    if filter is not None:
        if isinstance(filter, TemporalEdgeFilter):
            filter_cfg = filter
        else:
            filter_cfg, state = filter
            input_state = _int32(state, device)
        timestamps = _int32(filter_cfg.timestamps, device)
    return _sample_neighbors_impl(key, graph, inputs, input_state,
                                  tuple(int(k) for k in fanouts),
                                  with_replacement, log_weights, filter_cfg,
                                  timestamps, window)


def split_sample_batches(sample: NeighborSample, M: int,
                         x: Optional[torch.Tensor] = None):
    """Split a ``B0 = M*B``-seed tree into M per-batch trees: reshapes and
    per-layer rebasing, no gather.

    Layer ``l`` is contiguous and ordered by seed, and hop ``l``'s edges by
    parent slot, so batch ``m``'s share of each layer or edge block is its
    ``m``-th stripe, and ``rows``/``cols`` shift by a per-layer constant.
    Returns a ``NeighborSample`` whose tensors have a leading ``(M, ...)``
    axis and the B-seed ``node_base``/``edge_base``; with ``x`` (N_total,
    F), also ``x`` split as (M, n_m, F).
    """
    nb, eb = sample.node_base, sample.edge_base
    fanouts = sample.fanouts
    B0 = nb[1]
    if B0 % M:
        raise ValueError(f"{B0} seeds do not split into {M} batches")
    nb_m, eb_m = _layer_layout(B0 // M, fanouts)

    def split(a, base, extra=()):
        return torch.cat([a[base[i]: base[i + 1]].reshape(
            (M, (base[i + 1] - base[i]) // M) + extra)
            for i in range(len(base) - 1)], dim=1)

    m_ix = torch.arange(M, device=sample.rows.device)[:, None]
    rows_p, cols_p = [], []
    for ell, k in enumerate(fanouts):
        ps = (nb[ell + 1] - nb[ell]) // M       # parents per batch
        blk = slice(eb[ell], eb[ell + 1])
        r = sample.rows[blk].reshape(M, ps * k)
        rows_p.append(r - nb[ell + 1] - m_ix * (ps * k) + nb_m[ell + 1])
        c = sample.cols[blk].reshape(M, ps * k)
        cols_p.append(c - nb[ell] - m_ix * ps + nb_m[ell])
    out = NeighborSample(
        nodes=split(sample.nodes, nb),
        node_valid=split(sample.node_valid, nb),
        node_state=split(sample.node_state, nb),
        rows=torch.cat(rows_p, dim=1),
        cols=torch.cat(cols_p, dim=1),
        eptr=split(sample.eptr, eb),
        edge_valid=split(sample.edge_valid, eb),
        node_base=nb_m, edge_base=eb_m, fanouts=fanouts)
    if x is None:
        return out
    return out, split(x, nb, tuple(x.shape[1:]))


def compact_sample(sample: NeighborSample):
    """Padded sample -> compact reference-format host arrays
    ``(samples, rows, cols, edge_index, layer_offsets)``."""
    node_valid = sample.node_valid.cpu().numpy()
    edge_valid = sample.edge_valid.cpu().numpy()
    nodes = sample.nodes.cpu().numpy()
    rows, cols, eptr = (sample.rows.cpu().numpy(), sample.cols.cpu().numpy(),
                        sample.eptr.cpu().numpy())

    new_idx = np.cumsum(node_valid) - 1  # old slot -> compact index
    samples_out = nodes[node_valid]
    rows_c = new_idx[rows[edge_valid]]
    cols_c = new_idx[cols[edge_valid]]
    eptr_c = eptr[edge_valid].astype(np.int64)

    node_counts = np.cumsum(np.concatenate([[0], node_valid.astype(np.int64)]))
    edge_counts = np.cumsum(np.concatenate([[0], edge_valid.astype(np.int64)]))
    layer_offsets = []
    for ell in range(sample.num_hops):
        nb = int(node_counts[sample.node_base[ell + 1]])
        eb = int(edge_counts[sample.edge_base[ell]])
        layer_offsets.append((nb, eb, nb))

    return (samples_out.astype(np.int64), rows_c.astype(np.int64),
            cols_c.astype(np.int64), eptr_c, layer_offsets)


def neighbor_sampling_homogenous(col_ptrs, row_indices, inputs,
                                 num_neighbors: List[int],
                                 sampler: Optional[EdgeSampler] = None,
                                 filter=None, *,
                                 key: Optional[torch.Tensor] = None,
                                 device="cuda"):
    """Reference-parity API: host CSC arrays in, the compact reference
    output tuple out."""
    col_ptrs = np.asarray(col_ptrs)
    row_indices = np.asarray(row_indices)
    graph = make_graph(col_ptrs, row_indices,
                       num_src=int(row_indices.max(initial=-1)) + 1,
                       num_dst=col_ptrs.shape[0] - 1, device=device)
    out = sample_neighbors(graph, np.asarray(inputs), num_neighbors,
                           key=key, sampler=sampler, filter=filter)
    return compact_sample(out)
