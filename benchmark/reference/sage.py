"""Plain GraphSAGE with mean aggregation (Hamilton et al., 2017), as PyG's
``SAGEConv``: ``out = W_self h_i + b + W_neigh mean_{j -> i} h_j``, ReLU
and dropout between layers.

Weights are a dict keyed ``convs.<i>.lin_self.weight`` / ``.bias`` and
``convs.<i>.lin_neigh.weight``, each ``(out, in)``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .common import Params, mean_aggregate

# MaskFn(layer, shape) -> the keep mask of that hidden layer, or None
MaskFn = Optional[Callable[[int, tuple], torch.Tensor]]


def num_layers(params: Params) -> int:
    return len({k.split(".")[1] for k in params if k.startswith("convs.")})


def _layer(params: Params, i: int, h_self: torch.Tensor,
           agg: torch.Tensor) -> torch.Tensor:
    p = f"convs.{i}."
    return (h_self @ params[p + "lin_self.weight"].T
            + params[p + "lin_self.bias"]
            + agg @ params[p + "lin_neigh.weight"].T)


def tree_logits(params: Params, x: torch.Tensor, valid: torch.Tensor,
                bases: Sequence[int], fanouts: Sequence[int],
                mask: MaskFn = None, rate: float = 0.0) -> torch.Tensor:
    """Seed logits of a padded tree: ``x`` the rows of its slots, layer
    ``j`` updating the slots of depths ``0 .. hops - 1 - j`` from the mean
    of their valid children."""
    L = num_layers(params)
    hops = len(fanouts)
    h = x
    for j in range(L):
        keep = hops - j
        aggs = []
        for d in range(keep):
            k = fanouts[d]
            n = bases[d + 1] - bases[d]
            ch = h[bases[d + 1]: bases[d + 2]].reshape(n, k, -1)
            m = valid[bases[d + 1]: bases[d + 2]].reshape(n, k, 1).to(h.dtype)
            aggs.append((ch * m).sum(1) / m.sum(1).clamp(min=1))
        h = _layer(params, j, h[: bases[keep]], torch.cat(aggs))
        if j < L - 1:
            h = torch.relu(h)
            if mask is not None:
                h = h * mask(j, tuple(h.shape)).to(h.dtype) / (1.0 - rate)
    return h[: bases[1]]


def full_logits(params: Params, x: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, deg: torch.Tensor,
                agg_rows: Callable[[torch.Tensor], torch.Tensor] = None
                ) -> torch.Tensor:
    """Logits of every node of the graph ``src -> dst``; ``agg_rows``
    rounds the rows the aggregation reads (the control's lower
    precision)."""
    L = num_layers(params)
    h = x
    for i in range(L):
        a = h if agg_rows is None else agg_rows(h)
        h = _layer(params, i, h, mean_aggregate(a, src, dst, deg))
        if i < L - 1:
            h = torch.relu(h)
    return h
