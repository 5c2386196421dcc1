"""Graph partitioning and distributed aggregation over a mesh.

Counterpart of ``tch_geometric_tpu/parallel/partition.py``: the graph is
edge-partitioned by destination block (the owner computes its rows'
aggregates) and neighbor features cross partitions by collectives:

* :func:`ring_spmm` — ring-accumulated blockwise SpMM: feature blocks rotate
  around the ring by ``ppermute`` while each rank consumes the edge bucket
  whose sources live in the block it holds; P steps, and no rank ever
  holds more than one feature block;
* :func:`alltoall_gather` — each rank requests the halo rows it needs from
  their owners by ``all_to_all`` and aggregates locally.

Both are exact; the layout build is host numpy, padded to static shapes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .mesh import Mesh, Split, all_to_all, along, axis_index, ppermute, spmd


class RingShards(NamedTuple):
    """Edge buckets by (dst_part, src_part), padded to a common size.

    ``src_local`` / ``dst_local``: (P, P, Emax) int64 — bucket [d, s] holds
    the edges owned by dst-part d whose source lives in part s, with
    block-local ids; ``valid`` marks the real ones.
    """

    src_local: torch.Tensor
    dst_local: torch.Tensor
    valid: torch.Tensor
    rows_per_part: int
    num_parts: int


def build_ring_shards(edge_index, num_nodes: int, num_parts: int, *,
                      device="cuda") -> RingShards:
    """Partition COO edges by contiguous dst blocks, bucket by src block."""
    src = np.asarray(edge_index[0]).astype(np.int64)
    dst = np.asarray(edge_index[1]).astype(np.int64)
    Rp = -(-num_nodes // num_parts)
    dpart, spart = dst // Rp, src // Rp
    buckets = {}
    emax = 0
    for d in range(num_parts):
        for s in range(num_parts):
            m = (dpart == d) & (spart == s)
            buckets[(d, s)] = (src[m] - s * Rp, dst[m] - d * Rp)
            emax = max(emax, int(m.sum()))
    emax = max(emax, 1)
    sl = np.zeros((num_parts, num_parts, emax), np.int64)
    dl = np.zeros((num_parts, num_parts, emax), np.int64)
    va = np.zeros((num_parts, num_parts, emax), bool)
    for (d, s), (bs, bd) in buckets.items():
        sl[d, s, :bs.shape[0]] = bs
        dl[d, s, :bs.shape[0]] = bd
        va[d, s, :bs.shape[0]] = True
    t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return RingShards(t(sl), t(dl), t(va), Rp, num_parts)


def pad_features(x: np.ndarray, num_parts: int) -> np.ndarray:
    """Pad node features to ``num_parts * rows_per_part`` rows."""
    n = x.shape[0]
    pad = num_parts * (-(-n // num_parts)) - n
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x


def ring_spmm(shards: RingShards, x: torch.Tensor, mesh: Mesh, *,
              axis: str = "data", agg: str = "sum") -> torch.Tensor:
    """Distributed SpMM (sum): ``x`` (P * Rp, F) split by node block over
    ``axis``; each rank aggregates its dst rows while the source blocks
    rotate by ``ppermute``.  Returns (P * Rp, F)."""
    Pn = shards.num_parts
    if mesh.axis_size(axis) != Pn:
        raise ValueError(f"shards for {Pn} parts on a mesh of "
                         f"{mesh.shape[axis]}")
    ring = [(i, (i + 1) % Pn) for i in range(Pn)]

    def run(sl, dl, va, h):
        my = axis_index(axis)
        sl, dl, va = sl[0], dl[0], va[0]
        acc = torch.zeros((shards.rows_per_part, h.shape[1]), dtype=h.dtype,
                          device=h.device)
        for s in range(Pn):
            src_owner = (my - s) % Pn
            bv = va[src_owner]
            vals = torch.where(bv[:, None], h[sl[src_owner]],
                               torch.zeros((), dtype=h.dtype,
                                           device=h.device))
            acc.index_add_(0, dl[src_owner], vals)
            h = ppermute(h, axis, ring)
        return acc

    on = (axis,)
    out = along(mesh, axis, spmd(
        mesh, run, Split(shards.src_local, on), Split(shards.dst_local, on),
        Split(shards.valid, on), Split(x, on)))
    return out.reshape((-1, out.shape[-1]))


def alltoall_gather(x: torch.Tensor, halo_req: torch.Tensor, mesh: Mesh, *,
                    axis: str = "data") -> torch.Tensor:
    """Halo exchange: fetch rows by block-local id from their owners.

    ``halo_req`` (P, P, R): ``halo_req[d, s]`` the block-local row ids rank
    d needs from owner s (pad with 0; the caller masks).  Returns (P, P, R,
    F): rank d's block holds its (P, R, F) rows."""
    on = (axis,)

    def run(req, x_shard):
        owner_req = all_to_all(req[0], axis)            # (P, R) asked of me
        rows = x_shard[owner_req.long()]                 # (P, R, F)
        return all_to_all(rows, axis)                    # (P, R, F) mine

    return along(mesh, axis, spmd(mesh, run, Split(halo_req, on),
                                  Split(x, on)))
