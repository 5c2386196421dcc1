"""Plain GAT (Velickovic et al., 2018) as PyG's ``GATConv`` and
``examples/ogbn_products_gat.py`` compute it, over the full graph.

Per layer ``i``: ``h = x W^T`` (one linear, no bias, shared by sources and
targets), split into ``H`` heads of ``D``; the graph's self loops removed,
then one added per node; ``e_ij = leaky_relu(a_src . h_j + a_dst . h_i,
0.2)`` per head, softmax over the in-edges ``j`` of ``i``, ``out_i = sum_j
alpha_ij h_j``; heads concatenated (averaged in the last layer), ``+
bias``, ``+ skip(x_i)`` (a linear with bias); ELU between layers (dropout
is off in inference).

Weights are a dict keyed ``convs.<i>.lin.weight`` (out, in),
``convs.<i>.a_src`` / ``a_dst`` (H, D), ``convs.<i>.out_bias``,
``skips.<i>.weight`` / ``bias``.  The edge work runs in blocks of edges
(``common.edge_blocks``): a wide layer's messages at 512 columns would be
~500 GB in float64.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.nn import functional as nnf

from .common import Params, edge_blocks

# Rows(h) -> the rows the attention reads (the control's lower precision)
Rows = Optional[Callable[[torch.Tensor], torch.Tensor]]


def num_layers(params: Params) -> int:
    return len({k.split(".")[1] for k in params if k.startswith("convs.")})


def _logits(a_s: torch.Tensor, a_d: torch.Tensor, src: torch.Tensor,
            dst: torch.Tensor, slope: float) -> torch.Tensor:
    return nnf.leaky_relu(a_s[src] + a_d[dst], slope)


def layer(params: Params, i: int, x: torch.Tensor, src: torch.Tensor,
          dst: torch.Tensor, heads: int, concat: bool, *,
          slope: float = 0.2, rows: Rows = None) -> torch.Tensor:
    """Layer ``i`` on every node before the activation; ``src``/``dst``
    hold no self loop.  ``rows`` rounds the rows the attention reads (its
    messages and the source logits, computed from them)."""
    pre = f"convs.{i}."
    n = x.shape[0]
    h = x @ params[pre + "lin.weight"].T
    d = h.shape[1] // heads
    hv = (h if rows is None else rows(h)).view(n, heads, d)
    a_s = (hv * params[pre + "a_src"]).sum(-1)                 # (N, H)
    a_d = (h.view(n, heads, d) * params[pre + "a_dst"]).sum(-1)
    del h
    # the self loop of every node starts each row's max, sum and output
    s_self = nnf.leaky_relu(a_s + a_d, slope)
    m = s_self.clone()
    E = src.shape[0]
    for lo, hi in edge_blocks(E, 4 * heads * x.element_size()):
        e = _logits(a_s, a_d, src[lo:hi], dst[lo:hi], slope)
        m.scatter_reduce_(0, dst[lo:hi, None].expand_as(e), e, "amax")
    den = torch.exp(s_self - m)
    out = den[..., None] * hv
    for lo, hi in edge_blocks(E, heads * d * x.element_size()):
        s, t = src[lo:hi], dst[lo:hi]
        ex = torch.exp(_logits(a_s, a_d, s, t, slope) - m[t])
        den.index_add_(0, t, ex)
        out.index_add_(0, t, ex[..., None] * hv[s])
    del hv
    out = out / den[..., None]
    out = out.reshape(n, heads * d) if concat else out.mean(dim=1)
    out = out + params[pre + "out_bias"]
    return (out + x @ params[f"skips.{i}.weight"].T
            + params[f"skips.{i}.bias"])


def full_logits(params: Params, x: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, heads: int, rows: Rows = None
                ) -> torch.Tensor:
    """Logits of every node of the graph ``src -> dst``; the last layer's
    heads are averaged."""
    src, dst = src.long(), dst.long()
    loops = src == dst
    if bool(loops.any()):
        src, dst = src[~loops], dst[~loops]
    L = num_layers(params)
    h = x
    for i in range(L):
        h = layer(params, i, h, src, dst, heads, i < L - 1, rows=rows)
        if i < L - 1:
            h = nnf.elu(h)
    return h
