"""GraphSAGE with mean aggregation.

Counterpart of ``tch_geometric_tpu/models/sage.py``.  Three forwards:

* :meth:`GraphSAGE.tree_forward` — over a padded ``NeighborSample``: every
  hop is a static ``(frontier, fanout)`` block, so neighbor aggregation is a
  reshape plus a masked mean, and each layer's linears run once over all
  kept depths;
* :meth:`GraphSAGE.forward` — full graph, plain gather + segment mean;
* :meth:`GraphSAGE.blocked_forward` — full graph over a blocked-ELL layout
  (``BlockedCsr``, ``SegmentedBlockedCsr``, ``HotSplitCsr`` or
  ``HotSplitSeg``), through the CUDA kernels B1/B2 on the card.

Parameters follow ``torch.nn.Linear``'s default init, U(+-1/sqrt(fan_in))
for weights and bias, drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..data.graph import SparseGraph
from ..ops.spmm import spmm
from ..sampling.neighbor import NeighborSample


class SAGEConv(nn.Module):
    """out = lin_self(x) + lin_neigh(agg(x_neighbors)); only lin_self has a
    bias."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None):
        super().__init__()
        self.lin_self = nn.Linear(in_features, out_features, bias=bias,
                                  device=device)
        self.lin_neigh = nn.Linear(in_features, out_features, bias=False,
                                   device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """U(+-1/sqrt(fan_in)) from a CPU ``generator``, then copied to the
        parameters' device: the same seed gives the same weights on any
        device."""
        bound = 1.0 / math.sqrt(self.lin_self.in_features)
        for p in self.parameters():
            w = torch.empty(p.shape, dtype=p.dtype)
            p.copy_(w.uniform_(-bound, bound, generator=generator))

    def forward(self, x_self: torch.Tensor, x_agg: torch.Tensor
                ) -> torch.Tensor:
        return self.lin_self(x_self) + self.lin_neigh(x_agg)


def tree_neighbor_mean(h: torch.Tensor, valid: torch.Tensor,
                       sample: NeighborSample, depth: int) -> torch.Tensor:
    """Masked mean of the children of each depth-``depth`` slot: children of
    frontier slot i are the ``k`` slots from ``base + i*k``."""
    k = sample.fanouts[depth]
    lo, hi = sample.node_base[depth], sample.node_base[depth + 1]
    clo, chi = sample.node_base[depth + 1], sample.node_base[depth + 2]
    B = hi - lo
    child_h = h[clo:chi].reshape(B, k, -1)
    child_m = valid[clo:chi].reshape(B, k, 1).to(child_h.dtype)
    s = (child_h * child_m).sum(dim=1)
    cnt = child_m.sum(dim=1)
    return s / cnt.clamp(min=1.0)


class GraphSAGE(nn.Module):
    """Multi-layer GraphSAGE with mean aggregation.

    ``in_features`` is the input width (flax infers it; torch needs it
    up front).  ``generator`` seeds the init; the modules are created on
    the meta device first so no global RNG state is read."""

    def __init__(self, in_features: int, hidden: int, out: int,
                 num_layers: int, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        dims = [in_features] + [hidden] * (num_layers - 1) + [out]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], device="meta")
            for i in range(num_layers))
        self.to_empty(device=device)
        for conv in self.convs:
            conv.reset_parameters(generator)

    def _act(self, h: torch.Tensor, i: int, deterministic: bool):
        if i < self.num_layers - 1:
            h = torch.relu(h)
            if self.dropout > 0.0 and not deterministic:
                raise NotImplementedError(
                    "keyed dropout is not ported yet; call with "
                    "deterministic=True")
        return h

    def forward(self, x: torch.Tensor, graph: SparseGraph, *,
                deterministic: bool = True) -> torch.Tensor:
        """Full-graph forward: x (N, F), CSC in-neighbor adjacency."""
        h = x
        for i, conv in enumerate(self.convs):
            h = conv(h, spmm(graph, h, agg="mean"))
            h = self._act(h, i, deterministic)
        return h

    def blocked_forward(self, x: torch.Tensor, blocked,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
        """Full-graph forward over a blocked-ELL layout; the aggregation
        reads ``h`` in ``compute_dtype`` and accumulates in float32."""
        from ..ops.spmm_blocked import (HotSplitCsr, HotSplitSeg,
                                        SegmentedBlockedCsr)
        from ..ops.spmm_kernels import (spmm_blocked_auto,
                                        spmm_blocked_segmented,
                                        spmm_hot_split,
                                        spmm_hot_split_segmented)
        h = x
        for i, conv in enumerate(self.convs):
            if isinstance(blocked, HotSplitSeg):
                agg = spmm_hot_split_segmented(
                    blocked, h, agg="mean", compute_dtype=compute_dtype,
                    out_dtype=h.dtype)
            elif isinstance(blocked, HotSplitCsr):
                agg = spmm_hot_split(blocked, h, agg="mean",
                                     compute_dtype=compute_dtype).to(h.dtype)
            elif isinstance(blocked, SegmentedBlockedCsr):
                agg = spmm_blocked_segmented(blocked, h, agg="mean",
                                             compute_dtype=compute_dtype,
                                             out_dtype=h.dtype)
            else:
                agg = spmm_blocked_auto(blocked, h, agg="mean",
                                        compute_dtype=compute_dtype
                                        ).to(h.dtype)
            h = conv(h, agg)
            h = self._act(h, i, True)
        return h

    def tree_forward(self, sample: NeighborSample, x: torch.Tensor, *,
                     deterministic: bool = True) -> torch.Tensor:
        """Sampled-batch forward: x (N_total, F) per-slot features; returns
        the seed logits (num_seeds, out).  Layer j updates the slots at
        depths 0..num_hops-1-j from the depth one deeper."""
        if sample.num_hops < self.num_layers:
            raise ValueError("need at least as many sampled hops as layers")
        h = x
        valid = sample.node_valid
        for j, conv in enumerate(self.convs):
            keep_depths = sample.num_hops - j
            aggs = torch.cat([tree_neighbor_mean(h, valid, sample, d)
                              for d in range(keep_depths)], dim=0)
            n_keep = sample.node_base[keep_depths]
            h = conv(h[:n_keep], aggs)
            h = self._act(h, j, deterministic)
        return h[: sample.node_base[1]]
