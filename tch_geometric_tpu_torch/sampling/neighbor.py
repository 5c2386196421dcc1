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
per-batch trees.  Weighted sampling and the temporal filters are not ported
yet: :func:`sample_neighbors` raises ``NotImplementedError`` for them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.graph import CscGraph, make_graph
from ..utils.config import EdgeSampler, UniformEdgeSampler
from . import primitives, rng


@dataclass
class NeighborSample:
    """Padded multi-hop sample (device tensors).

    ``nodes[:num_seeds]`` are the seeds; hop ``l`` occupies the slot range
    ``[node_base[l+1], node_base[l+2])``.  ``rows``/``cols`` are local slot
    indices, ``eptr`` the global sorted-CSC edge pointer.
    """

    nodes: torch.Tensor        # (N_total,) int64 node ids (garbage if invalid)
    node_valid: torch.Tensor   # (N_total,) bool
    node_state: torch.Tensor   # (N_total,) int64 filter state (zeros)
    rows: torch.Tensor         # (E_total,) int64 local src slot
    cols: torch.Tensor         # (E_total,) int64 local dst slot
    eptr: torch.Tensor         # (E_total,) int64 global edge ptr
    edge_valid: torch.Tensor   # (E_total,) bool
    node_base: Tuple[int, ...]
    edge_base: Tuple[int, ...]
    fanouts: Tuple[int, ...]

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


def _sample_one_hop(key, graph: CscGraph, frontier, frontier_valid,
                    frontier_state, k: int, *, with_replacement: bool):
    """Sample <= k in-edges of each frontier node (uniform, unfiltered).
    Returns ``(eptr (B,k), neighbor (B,k), valid (B,k), state (B,k))``."""
    node = frontier.clamp(0, graph.num_ptr_nodes - 1)
    ell_lanes = None
    if graph.ell is not None:
        ell_lanes, deg_l, starts = graph.ell_rows(node)
        degs = torch.where(frontier_valid, deg_l, 0).long()
    else:
        starts, ends = graph.neighbors_range(node)
        degs = torch.where(frontier_valid, ends - starts, 0)
    starts = starts.long()

    if with_replacement:
        pos, valid = primitives.replacement_positions(key, degs, k)
    elif ell_lanes is not None:
        pos, valid = primitives.uniform_lane_topk(
            key, degs, ell_lanes.shape[-1], k)
    else:
        pos, valid = primitives.floyd_sample(key, degs, k)

    eptr = (starts[..., None] + pos).clamp(0, max(graph.num_edges - 1, 0))
    if ell_lanes is not None:
        sel = pos.clamp(0, ell_lanes.shape[-1] - 1)
        neighbor = torch.gather(ell_lanes, -1, sel).long()
    elif graph.indices_win is not None:
        win, off = graph.gather_neighbor_windows_rows(starts)
        neighbor = torch.gather(win, -1, off[..., None] + pos).long()
    else:
        neighbor = graph.gather_neighbors(eptr)
    new_state = frontier_state[..., None].expand(eptr.shape)
    return eptr, neighbor, valid, new_state


def _sample_neighbors_impl(key, graph: CscGraph, inputs: torch.Tensor,
                           input_state: torch.Tensor,
                           fanouts: Tuple[int, ...],
                           with_replacement: bool) -> NeighborSample:
    num_seeds = inputs.shape[0]
    device = inputs.device
    node_base, edge_base = _layer_layout(num_seeds, fanouts)

    nodes = [inputs.long()]
    valids = [torch.ones((num_seeds,), dtype=torch.bool, device=device)]
    states = [input_state.long()]
    rows, cols, eptrs, evalids = [], [], [], []

    for ell, k in enumerate(fanouts):
        frontier, fvalid, fstate = nodes[ell], valids[ell], states[ell]
        B = frontier.shape[0]
        eptr, neighbor, valid, new_state = _sample_one_hop(
            rng.fold(key, ell), graph, frontier, fvalid, fstate, k,
            with_replacement=with_replacement)
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
        node_state=torch.cat(states),
        rows=cat(rows, torch.long),
        cols=cat(cols, torch.long),
        eptr=cat(eptrs, torch.long),
        edge_valid=cat(evalids, torch.bool),
        node_base=node_base,
        edge_base=edge_base,
        fanouts=tuple(fanouts),
    )


def sample_neighbors(graph: CscGraph, inputs, fanouts: Sequence[int], *,
                     key: Optional[torch.Tensor] = None,
                     sampler: Optional[EdgeSampler] = None,
                     filter=None) -> NeighborSample:
    """Multi-hop uniform neighbor sampling on ``graph``'s device.

    ``inputs`` are the seed nodes, ``fanouts`` the per-hop neighbor counts,
    ``sampler`` a ``UniformEdgeSampler`` (or None: without replacement).
    """
    if filter is not None:
        raise NotImplementedError("temporal filters are not ported yet")
    if sampler is not None and not isinstance(sampler, UniformEdgeSampler):
        raise NotImplementedError(
            f"{type(sampler).__name__} is not ported yet")
    if key is None:
        key = rng.next_key()
    with_replacement = bool(sampler is not None and sampler.with_replacement)
    inputs = torch.as_tensor(inputs).to(graph.device).long()
    zeros = torch.zeros(inputs.shape, dtype=torch.long, device=graph.device)
    return _sample_neighbors_impl(key, graph, inputs, zeros,
                                  tuple(int(k) for k in fanouts),
                                  with_replacement)


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
