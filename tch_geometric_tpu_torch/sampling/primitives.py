"""Batched uniform sampling engines.

Counterpart of the unweighted engines of
``tch_geometric_tpu/sampling/primitives.py``; each draws exactly the bits
its JAX twin draws (``sampling/rng.py``), so outputs are bit-equal:

* :func:`floyd_sample` — exact uniform k-subset of ``[0, deg)`` per node by
  Floyd's algorithm, O(k^2) compares, independent of degree;
* :func:`uniform_lane_topk` — one uniform per ELL lane, top ``k`` among the
  lanes ``< deg``;
* :func:`replacement_positions` — ``k`` independent ``randint`` draws.

The weighted (Gumbel top-k over windows) engines are not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import rng

NEG_INF = float("-inf")


def floyd_sample(key: torch.Tensor, deg: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact uniform sample of ``min(k, deg)`` distinct positions in
    ``[0, deg)`` per element of ``deg``.

    Returns ``(positions, valid)`` of shape ``deg.shape + (k,)``; invalid
    slots hold position 0.  Floyd: for j in deg-k..deg-1 draw t ~ U[0, j];
    insert j if t was already chosen, else t.
    """
    deg = deg.long()
    chosen = torch.full(deg.shape + (k,), -1, dtype=torch.long,
                        device=deg.device)
    for i in range(k):
        j = deg - (k - i)                  # may be < 0 when deg < k
        hi = torch.clamp(j + 1, min=1)
        t = rng.randint(rng.fold_in(key, i), deg.shape, 0, hi,
                        device=deg.device)
        hit = (chosen == t[..., None]).any(dim=-1)
        chosen[..., i] = torch.where(hit, j, t)

    iota = torch.arange(k, device=deg.device)
    take_all = (deg <= k)[..., None]
    positions = torch.where(take_all, iota.expand_as(chosen), chosen)
    valid = torch.where(take_all, iota < deg[..., None], deg[..., None] > 0)
    return torch.where(valid, positions, 0), valid


def top_k(vals: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: among equal values the lower
    index comes first (a stable descending sort; ``torch.topk`` promises
    no order among ties)."""
    sv, si = torch.sort(vals, dim=-1, descending=True, stable=True)
    return sv[..., :k], si[..., :k]


def uniform_lane_topk(key: torch.Tensor, deg: torch.Tensor, num_lanes: int,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact uniform k-subset of ``[0, deg)`` when ``deg <= num_lanes``:
    rank every lane by one uniform draw, take the top ``k`` lanes
    ``< deg``.  Valid slots are the first ``min(deg, k)``; invalid slots
    hold position 0."""
    deg = deg.long()
    lane = torch.arange(num_lanes, device=deg.device)
    r = rng.uniform(key, deg.shape + (num_lanes,), device=deg.device)
    vals = torch.where(lane < deg[..., None], r, NEG_INF)
    kk = min(k, num_lanes)
    top_vals, pos = top_k(vals, kk)
    valid = torch.isfinite(top_vals)
    if kk < k:
        pad = deg.shape + (k - kk,)
        pos = torch.cat([pos, pos.new_zeros(pad)], dim=-1)
        valid = torch.cat([valid, valid.new_zeros(pad)], dim=-1)
    return torch.where(valid, pos, 0), valid


def replacement_positions(key: torch.Tensor, deg: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``k`` independent uniform positions in ``[0, deg)`` per node.
    Empty rows -> invalid."""
    deg = deg.long()
    hi = torch.clamp(deg, min=1)[..., None]
    positions = rng.randint(key, deg.shape + (k,), 0, hi, device=deg.device)
    valid = (deg > 0)[..., None].expand(positions.shape)
    return torch.where(valid, positions, 0), valid
