"""A plain PyTorch GAT as PyG's ``GATConv`` and ``examples/ogbn_products_gat.py``
compute it, for the tests of the port's PyG-style ``GAT``.

Imports nothing but torch: neither JAX nor the port.  Each layer, on a
bipartite graph whose first ``num_targets`` sources are the targets (PyG's
``(x, x_target)`` with targets first; the full graph is the case where every
node is a target):

* ``h = x W^T`` (one linear, no bias, shared by sources and targets);
* the graph's self loops ``j -> j`` are removed, then one is added for every
  target ``i`` (PyG's ``remove_self_loops`` / ``add_self_loops`` with
  ``num_nodes = min(size)``);
* ``e_ij = leaky_relu(a_src . h_j + a_dst . h_i, 0.2)`` per head, softmax
  over the in-edges ``j`` of ``i``, ``out_i = sum_j alpha_ij h_j``;
* heads concatenated (or averaged in a ``concat=False`` layer), ``+ bias``,
  ``+ skip(x_i)`` (a linear with bias), ELU between layers (dropout is off:
  the tests compare deterministic passes).

Parameters are a dict keyed as the port's ``GAT.named_parameters()``:
``convs.<i>.lin.weight`` (out, in), ``convs.<i>.a_src`` / ``a_dst`` (H, D),
``convs.<i>.out_bias``, ``skips.<i>.weight`` / ``bias``.  ``broken`` names
a deliberately wrong variant, for the tests' controls: ``no_self_loops``,
``sum_heads`` (the last layer's heads summed, not averaged) or
``no_skip``.  No departure from the equations above.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.nn import functional as nnf

Params = Dict[str, torch.Tensor]


def gat_layer(p: Params, i: int, x: torch.Tensor, num_targets: int,
              src: torch.Tensor, dst: torch.Tensor, heads: int, concat: bool,
              *, slope: float = 0.2, broken: Optional[str] = None
              ) -> torch.Tensor:
    """Layer ``i`` over the edges ``src -> dst`` (``dst < num_targets``):
    the targets' rows, before the activation."""
    pre = f"convs.{i}."
    H = heads
    h = x @ p[pre + "lin.weight"].T
    D = h.shape[1] // H
    h = h.reshape(-1, H, D)
    src, dst = src.long(), dst.long()
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if broken != "no_self_loops":
        loop = torch.arange(num_targets, device=x.device)
        src, dst = torch.cat([src, loop]), torch.cat([dst, loop])
    a_s = (h * p[pre + "a_src"]).sum(-1)
    a_d = (h[:num_targets] * p[pre + "a_dst"]).sum(-1)
    e = nnf.leaky_relu(a_s[src] + a_d[dst], slope)             # (E, H)
    m = e.new_full((num_targets, H), float("-inf")).scatter_reduce(
        0, dst[:, None].expand_as(e), e, "amax")
    ex = torch.exp(e - m[dst])
    den = e.new_zeros((num_targets, H)).index_add_(0, dst, ex)
    out = h.new_zeros((num_targets, H, D)).index_add_(
        0, dst, ex[..., None] * h[src])
    out = torch.where(den[..., None] > 0, out / den.clamp(min=1e-300)[
        ..., None], 0.0)
    if concat:
        out = out.reshape(num_targets, H * D)
    else:
        out = out.sum(1) if broken == "sum_heads" else out.mean(1)
    if pre + "out_bias" in p:
        out = out + p[pre + "out_bias"]
    if f"skips.{i}.weight" in p and broken != "no_skip":
        out = (out + x[:num_targets] @ p[f"skips.{i}.weight"].T
               + p[f"skips.{i}.bias"])
    return out


def num_layers(p: Params) -> int:
    return len({k.split(".")[1] for k in p if k.startswith("convs.")})


def gat_forward(p: Params, x: torch.Tensor,
                layers: Sequence[Tuple[int, torch.Tensor, torch.Tensor]],
                heads: int, *, broken: Optional[str] = None) -> torch.Tensor:
    """``layers[j] = (num_targets, src, dst)``: layer ``j``'s bipartite
    graph; every layer but the last has ``heads`` concatenated heads, the
    last ``heads`` averaged ones.  ELU between layers."""
    L = num_layers(p)
    h = x
    for j in range(L):
        n, src, dst = layers[j]
        h = gat_layer(p, j, h, n, src, dst, heads, concat=j < L - 1,
                      broken=broken)
        if j < L - 1:
            h = nnf.elu(h)
    return h


def full_graph(p: Params, x: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, heads: int, *,
               broken: Optional[str] = None) -> torch.Tensor:
    """Every node's logits of the graph ``src -> dst`` over ``x``'s rows."""
    n = x.shape[0]
    return gat_forward(p, x, [(n, src, dst)] * num_layers(p), heads,
                       broken=broken)
