"""Partitioned heterogeneous layouts: one partitioned graph a relation, and
all relations stacked into one padded container.

Counterpart of the layout half of ``tch_geometric_tpu/parallel/dist_hgt.py``
(:func:`build_partitioned_hetero`, :class:`StackedRels`,
:func:`stack_partitioned_rels`, :func:`put_stacked_rels`).  The typed
distributed samplers (``dist_budget_sample_hetero``,
``dist_hetero_neighbor_sample``) take the per-relation dict; the stacked
form keeps the owner-block axis first and the relation axis second, so the
split that gives each rank its block of a per-relation graph gives it its
block of every relation at once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from ..utils.types import NAN_TIMESTAMP, rel_key
from .dist_sampling import PartitionedGraph, build_partitioned_graph
from .mesh import Mesh
from .multihost import put_partitioned


def build_partitioned_hetero(col_ptrs, row_indices, edge_types, num_parts,
                             *, edge_timestamps=None,
                             node_counts: Optional[Dict[str, int]] = None,
                             device="cuda") -> Dict[str, PartitionedGraph]:
    """One :func:`~.dist_sampling.build_partitioned_graph` a relation:
    ``col_ptrs[r]`` / ``row_indices[r]`` its CSC (rows are the dst nodes),
    ``edge_timestamps[r]`` its timestamps by sorted edge where given.  Each
    relation decides its own ELL table from its own largest degree.
    ``node_counts`` is accepted for the JAX signature (the HGT sampler's
    budget tables need it); the layouts do not."""
    rels = {}
    for e in edge_types:
        r = rel_key(tuple(e))
        ts = None
        if edge_timestamps is not None and r in edge_timestamps:
            ts = edge_timestamps[r]
        rels[r] = build_partitioned_graph(col_ptrs[r], row_indices[r],
                                          num_parts, edge_timestamps=ts,
                                          device=device)
    return rels


def _pad_to(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    """``x`` (1-d) padded with ``fill`` to length ``n``."""
    out = x.new_full((n,), fill)
    out[: x.shape[0]] = x
    return out


@dataclasses.dataclass
class StackedRels:
    """Every relation's :class:`~.dist_sampling.PartitionedGraph` tensors
    stacked on a relation axis, padded to common shapes.

    The owner-block axis stays first and the relation axis second, so a
    split of the leading axis into P blocks gives each rank its ``(Np, R,
    ...)`` block of every relation.  The ELL and timestamp groups are
    present for all relations or for none (:func:`stack_partitioned_rels`
    drops the ELL tables of all when some relation has none)."""

    ldeg: torch.Tensor       # (P*Np, R) int32
    lstart: torch.Tensor     # (P*Np, R)
    gstart: torch.Tensor     # (P*Np, R)
    lindices: torch.Tensor   # (P*Emax, R)
    ell: Optional[torch.Tensor] = None       # (P*Np, R, W)
    lts: Optional[torch.Tensor] = None       # (P*Emax, R)
    ell_ts: Optional[torch.Tensor] = None    # (P*Np, R, W-2)
    num_rels: int = 0
    num_parts: int = 1
    rows_per_part: int = 0
    local_edge_cap: int = 0
    max_degree: int = 0


def _blocks(a: torch.Tensor, num_parts: int, n_r: int, n_m: int,
            fill=0) -> torch.Tensor:
    """``(P*n_r, ...)`` owner blocks padded with ``fill`` to ``(P*n_m,
    ...)``."""
    a = a.reshape((num_parts, n_r) + tuple(a.shape[1:]))
    out = a.new_full((num_parts, n_m) + tuple(a.shape[2:]), fill)
    out[:, :n_r] = a
    return out.reshape((num_parts * n_m,) + tuple(a.shape[2:]))


def stack_partitioned_rels(rels: Dict[str, PartitionedGraph],
                           rel_order: Sequence[str]) -> StackedRels:
    """Stack per-relation graphs into one padded :class:`StackedRels` (on
    the graphs' device).  ``rel_order`` fixes the relation axis (the
    samplers' sorted relation order).  Rows and edges of each owner block
    pad to the largest over the relations (padded rows have degree 0 and
    are never sampled, padded timestamps are missing), and ELL rows to the
    widest, degree and start kept in the last two lanes."""
    gs = [rels[r] for r in rel_order]
    Pn = gs[0].num_parts
    if any(g.num_parts != Pn for g in gs):
        raise ValueError("every relation must be partitioned for the same "
                         "number of ranks")
    Npm = max(g.rows_per_part for g in gs)
    Em = max(g.local_edge_cap for g in gs)
    has_ell = all(g.ell is not None for g in gs)
    has_ts = all(g.lts is not None for g in gs)
    Wm = max(g.ell.shape[1] for g in gs) if has_ell else 0

    def rows_of(name, fill=0):
        return torch.stack([_blocks(getattr(g, name), Pn, g.rows_per_part,
                                    Npm, fill) for g in gs], dim=1)

    def edges_of(name, fill=0):
        return torch.stack([_blocks(getattr(g, name), Pn, g.local_edge_cap,
                                    Em, fill) for g in gs], dim=1)

    lts = edges_of("lts", NAN_TIMESTAMP) if has_ts else None
    ell = ell_ts = None
    if has_ell:
        out = []
        for g in gs:
            e = _blocks(g.ell, Pn, g.rows_per_part, Npm)    # (P*Npm, W_r)
            row = e.new_zeros((e.shape[0], Wm))
            row[:, : e.shape[1] - 2] = e[:, :-2]
            row[:, -2:] = e[:, -2:]
            out.append(row)
        ell = torch.stack(out, dim=1)
        if has_ts and all(g.ell_ts is not None for g in gs):
            out = []
            for g in gs:
                e = _blocks(g.ell_ts, Pn, g.rows_per_part, Npm,
                            NAN_TIMESTAMP)
                row = e.new_full((e.shape[0], Wm - 2), NAN_TIMESTAMP)
                row[:, : e.shape[1]] = e
                out.append(row)
            ell_ts = torch.stack(out, dim=1)
    return StackedRels(
        ldeg=rows_of("ldeg"), lstart=rows_of("lstart"),
        gstart=rows_of("gstart"), lindices=edges_of("lindices"), ell=ell,
        lts=lts, ell_ts=ell_ts, num_rels=len(gs), num_parts=Pn,
        rows_per_part=Npm, local_edge_cap=Em,
        max_degree=max(g.max_degree for g in gs))


def put_stacked_rels(rels: Dict[str, PartitionedGraph],
                     rel_order: Sequence[str], mesh: Mesh,
                     axis: str = "data") -> StackedRels:
    """:func:`stack_partitioned_rels`, placed as
    :func:`~.multihost.put_partitioned` places a per-relation dict under
    ``(axis,)``: the whole container on the mesh's device on a thread
    mesh, this process's owner block of every tensor under a process
    group."""
    return put_partitioned(stack_partitioned_rels(rels, rel_order), mesh,
                           (axis,))
