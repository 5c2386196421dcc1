"""GCN, GAT and GIN — the other message-passing model families.

Counterpart of ``tch_geometric_tpu/models/gnn.py``.  Each conv takes the
same graph containers as GraphSAGE: a full ``SparseGraph`` (gather +
segment ops), or a padded ``NeighborSample`` with ``keep_depths`` (dense
per-depth reductions over the fanout axis, no scatter).  ``GATConv`` also
takes ``blocked=`` (a ``BlockedCsr`` of the same adjacency), which runs the
head-packed GAT kernel B3 on the card.

``in_features`` is each layer's input width (flax infers it; torch needs it
up front).  Linear layers follow ``torch.nn.Linear``'s default init,
U(+-1/sqrt(fan_in)) for weights and bias; GAT's ``a_src``/``a_dst`` follow
flax's ``lecun_normal``; GIN's ``eps`` starts at 0.  Every draw comes from
an explicit CPU ``torch.Generator`` and is then copied to ``device``.
``dtype=None`` computes in float32; a dtype casts each linear's input and
parameters to it.  Dropout between layers (``deterministic=False``) is
:func:`~.dropout.keyed_dropout` under the ``dropout_key`` the caller passes.

Every linear of these models and GraphSAGE runs through :func:`_linear`,
and GAT's tree attention reads ``a_src``/``a_dst`` through :func:`_whole`:
a data- and tensor-parallel train step (``parallel.train``) sets this
thread's :data:`PARAM_HOOKS` to run them on the rank's parameter slices.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as nnf

from ..data.graph import SparseGraph
from ..ops.attention_blocked import gat_attend_blocked_packed_cuda
from ..ops.segment import csr_row_ids, segment_softmax, segment_sum
from ..ops.spmm import spmm
from ..sampling.neighbor import NeighborSample
from .dropout import Rows, keyed_dropout, tree_rows

# flax's truncated normal: N(0, 1) cut at +-2, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _uniform_(p: torch.Tensor, fan_in: int, generator) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(p.shape, dtype=p.dtype)
    p.copy_(w.uniform_(-bound, bound, generator=generator))


def _lecun_normal_(p: torch.Tensor, generator) -> None:
    """flax ``lecun_normal``: fan_in is the product of every axis but the
    last (H for an (H, D) table, H*d for (H, d, d), R*H*d for
    (R, H, d, d))."""
    std = math.sqrt(1.0 / math.prod(p.shape[:-1])) / _TRUNC_STD
    w = torch.empty(p.shape, dtype=p.dtype)
    p.copy_(nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=generator))


class _ParamHooks(threading.local):
    """This thread's tensor-parallel hooks, None outside a DP+TP step:
    ``linear(lin, x, dtype)`` runs each linear, ``whole(p)`` gives a
    parameter whole."""
    linear = None
    whole = None


PARAM_HOOKS = _ParamHooks()


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """``x @ weight.T + bias`` as flax's ``nn.Dense(dtype=dtype)``: input
    and parameters cast to ``dtype``, or with None promoted to their common
    type (bfloat16 rows into a float32 layer give float32)."""
    if dtype is None:
        dtype = torch.promote_types(x.dtype, weight.dtype)
    return nnf.linear(x.to(dtype), weight.to(dtype),
                      None if bias is None else bias.to(dtype))


def _linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """``lin(x)`` by :func:`dense`, or by this thread's tensor-parallel
    hook."""
    if PARAM_HOOKS.linear is not None:
        return PARAM_HOOKS.linear(lin, x, dtype)
    return dense(x, lin.weight, lin.bias, dtype)


def _whole(p: torch.Tensor) -> torch.Tensor:
    """``p``, or this thread's tensor-parallel hook's whole of it."""
    return p if PARAM_HOOKS.whole is None else PARAM_HOOKS.whole(p)


def _tree_child_sums(h: torch.Tensor, sample: NeighborSample,
                     keep_depths: int) -> torch.Tensor:
    """Masked sum of each kept slot's children, depths 0..keep_depths-1."""
    outs = []
    for d in range(keep_depths):
        k = sample.fanouts[d]
        lo, hi = sample.node_base[d], sample.node_base[d + 1]
        clo, chi = sample.node_base[d + 1], sample.node_base[d + 2]
        child = h[clo:chi].reshape(hi - lo, k, -1)
        cm = sample.node_valid[clo:chi].reshape(hi - lo, k, 1)
        outs.append((child * cm.to(h.dtype)).sum(dim=1))
    return torch.cat(outs, dim=0)


def tree_child_counts(sample: NeighborSample) -> torch.Tensor:
    """Valid-child count per tree slot (0 for the deepest layer's slots) —
    the sampled-subtree degree used for GCN normalization on tree batches."""
    parts = []
    for d in range(sample.num_hops):
        k = sample.fanouts[d]
        clo, chi = sample.node_base[d + 1], sample.node_base[d + 2]
        parts.append(sample.node_valid[clo:chi].reshape(-1, k).sum(dim=1)
                     .to(torch.int32))
    n_total = sample.node_base[sample.num_hops + 1]
    deepest = n_total - sample.node_base[sample.num_hops]
    parts.append(torch.zeros((deepest,), dtype=torch.int32,
                             device=sample.node_valid.device))
    return torch.cat(parts)


class GCNConv(nn.Module):
    """Symmetric-normalized graph convolution: D^-1/2 A D^-1/2 X W.

    Pass ``graph`` for the full-graph path, or ``sample`` (+``keep_depths``)
    for a padded-tree batch — normalization then uses the sampled-subtree
    degrees (valid-child counts)."""

    def __init__(self, in_features: int, features: int, dtype=None,
                 device="cuda"):
        super().__init__()
        self.dtype = dtype
        self.lin = nn.Linear(in_features, features, bias=True, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        for p in self.parameters():
            _uniform_(p, self.lin.in_features, generator)

    def forward(self, x: torch.Tensor, graph: Optional[SparseGraph] = None,
                *, add_self_loops: bool = True,
                sample: Optional[NeighborSample] = None,
                keep_depths: Optional[int] = None,
                child_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = _linear(self.lin, x, self.dtype)
        if sample is not None:
            # child_counts: pass tree_child_counts(sample) in from the
            # caller when applying several layers
            cnt = (child_counts if child_counts is not None
                   else tree_child_counts(sample))[: h.shape[0]]
            norm_cnt = cnt + 1 if add_self_loops else cnt.clamp(min=1)
            inv_sqrt = torch.rsqrt(norm_cnt.to(h.dtype))
            hn = h * inv_sqrt[:, None]
            n_keep = sample.node_base[keep_depths]
            agg = (_tree_child_sums(hn, sample, keep_depths)
                   * inv_sqrt[:n_keep, None])
            if add_self_loops:
                agg = agg + h[:n_keep] * (inv_sqrt[:n_keep] ** 2)[:, None]
            return agg
        deg = graph.degree(torch.arange(graph.num_ptr_nodes,
                                        device=graph.device))
        norm_deg = deg + 1 if add_self_loops else deg.clamp(min=1)
        inv_sqrt = torch.rsqrt(norm_deg.to(h.dtype))
        # normalize source side, aggregate, normalize dst side
        agg = spmm(graph, h * inv_sqrt[: h.shape[0], None], agg="sum")
        out = agg * inv_sqrt[:, None]
        if add_self_loops:
            out = out + h * (inv_sqrt ** 2)[:, None]
        return out


class GATConv(nn.Module):
    """Multi-head graph attention (GATv1-style additive logits)."""

    def __init__(self, in_features: int, features: int, heads: int = 4,
                 dtype=None, device="cuda"):
        super().__init__()
        if features % heads:
            raise ValueError(f"features ({features}) must be divisible by "
                             f"heads ({heads})")
        self.features = features
        self.heads = heads
        self.dtype = dtype
        d = features // heads
        self.lin = nn.Linear(in_features, features, bias=False, device=device)
        self.a_src = nn.Parameter(torch.empty((heads, d), device=device))
        self.a_dst = nn.Parameter(torch.empty((heads, d), device=device))

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        _uniform_(self.lin.weight, self.lin.in_features, generator)
        _lecun_normal_(self.a_src, generator)
        _lecun_normal_(self.a_dst, generator)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the blocked attention kernels compute in."""
        return torch.float32 if self.dtype is None else self.dtype

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """``h = lin(x)`` as (N, H, d), in the layer's dtype."""
        H = self.heads
        return _linear(self.lin, x, self.dtype).reshape(-1, H,
                                                        self.features // H)

    def logit_tables(self, h: torch.Tensor):
        """GATv1's per-node logit terms ``(alpha_src, alpha_dst)``, (N, H)
        each: ``sum_d h[i, h, d] * a[h, d]``.  With :meth:`project` these
        are the inputs of the blocked attention routes
        (``gat_attend_blocked_cuda``, ``gat_attend_blocked_flash_cuda``)."""
        return (h * self.a_src[None]).sum(-1), (h * self.a_dst[None]).sum(-1)

    def forward(self, x: torch.Tensor, graph: Optional[SparseGraph] = None,
                blocked=None, *, sample: Optional[NeighborSample] = None,
                keep_depths: Optional[int] = None) -> torch.Tensor:
        """``blocked``: optional ``BlockedCsr`` of the same adjacency —
        routes attention through B3 (``gat_attend_blocked_packed_cuda``)
        instead of segment ops.  ``sample`` (+``keep_depths``): padded-tree
        batch — dense per-depth attention over the fanout axis."""
        h = self.project(x)

        if sample is not None:
            hf = h.reshape(-1, self.features)
            a_src, a_dst = _whole(self.a_src), _whole(self.a_dst)
            return torch.cat([self.tree_attention(hf, sample.node_valid,
                                                  sample, dd, a_src, a_dst)
                              for dd in range(keep_depths)], dim=0)

        if blocked is not None:
            # GATv1's alpha_src is a linear projection of h: the kernel
            # computes it from the rows it reads
            out = gat_attend_blocked_packed_cuda(
                blocked, h, None, (h * self.a_dst[None]).sum(-1),
                alpha_src_vec=self.a_src, compute_dtype=self.compute_dtype)
            return out.reshape(-1, self.features)

        alpha_src, alpha_dst = self.logit_tables(h)         # (N, H) each
        E = graph.num_edges
        rows = csr_row_ids(graph.indptr, E)                 # dst per edge
        logits = nnf.leaky_relu(
            alpha_src[graph.indices] + alpha_dst[rows], 0.2)   # (E, H)
        att = segment_softmax(logits, rows, graph.num_ptr_nodes)
        msg = h[graph.indices] * att[..., None]             # (E, H, d)
        out = segment_sum(msg, rows, graph.num_ptr_nodes)
        return out.reshape(-1, self.features)

    @staticmethod
    def tree_attention(h: torch.Tensor, valid: torch.Tensor,
                       sample: NeighborSample, depth: int,
                       a_src: torch.Tensor, a_dst: torch.Tensor
                       ) -> torch.Tensor:
        """Dense attention over a padded tree layer: (B, k) children —
        softmax over the fanout axis, no scatter."""
        k = sample.fanouts[depth]
        lo, hi = sample.node_base[depth], sample.node_base[depth + 1]
        clo, chi = sample.node_base[depth + 1], sample.node_base[depth + 2]
        B = hi - lo
        H, d = a_src.shape
        hd = h[lo:hi].reshape(B, H, d)
        hc = h[clo:chi].reshape(B, k, H, d)
        mask = valid[clo:chi].reshape(B, k)[..., None]
        logits = nnf.leaky_relu(
            (hc * a_src[None, None]).sum(-1)
            + (hd * a_dst[None]).sum(-1)[:, None, :], 0.2)     # (B, k, H)
        # -1e9 (not -inf): parents with zero valid children would softmax
        # all--inf rows into nans
        logits = torch.where(mask, logits, -1e9)
        att = torch.softmax(logits, dim=1)
        att = torch.where(mask, att, 0.0)
        return (hc * att[..., None]).sum(dim=1).reshape(B, H * d)


class GINConv(nn.Module):
    """Graph Isomorphism Network layer: ``MLP((1+eps)·h_v + Σ_u h_u)``.

    Sum aggregation over the full graph (SpMM) or a padded tree batch
    (masked child sum).  ``eps`` is learnable, initialized to 0."""

    def __init__(self, in_features: int, features: int,
                 hidden: Optional[int] = None, dtype=None, device="cuda"):
        super().__init__()
        width = hidden if hidden is not None else features
        self.dtype = dtype
        self.eps = nn.Parameter(torch.zeros((), device=device))
        self.lin1 = nn.Linear(in_features, width, device=device)
        self.lin2 = nn.Linear(width, features, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.eps.zero_()
        for lin in (self.lin1, self.lin2):
            for p in lin.parameters():
                _uniform_(p, lin.in_features, generator)

    def forward(self, x: torch.Tensor, graph: Optional[SparseGraph] = None,
                *, sample: Optional[NeighborSample] = None,
                keep_depths: Optional[int] = None) -> torch.Tensor:
        if sample is not None:
            n_keep = sample.node_base[keep_depths]
            agg = _tree_child_sums(x, sample, keep_depths)
            h = (1.0 + self.eps) * x[:n_keep] + agg
        else:
            h = (1.0 + self.eps) * x + spmm(graph, x, agg="sum")
        h = torch.relu(_linear(self.lin1, h, self.dtype))
        return _linear(self.lin2, h, self.dtype)


class _Stack(nn.Module):
    """Layers of one conv type with an activation between them."""

    act = staticmethod(torch.relu)

    def _init(self, convs, dropout: float, generator, device):
        self.num_layers = len(convs)
        self.dropout = dropout
        self.convs = nn.ModuleList(convs)
        self.to_empty(device=device)
        for conv in self.convs:
            conv.reset_parameters(generator)

    def _act(self, h: torch.Tensor, i: int, deterministic: bool,
             dropout_key: Optional[torch.Tensor] = None, rows: Rows = None):
        if i < self.num_layers - 1:
            h = self.act(h)
            h = keyed_dropout(h, dropout_key, self.dropout, i,
                              deterministic=deterministic, rows=rows)
        return h

    def forward(self, x: torch.Tensor, graph: SparseGraph, *,
                deterministic: bool = True,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-graph forward: x (N, F), CSC in-neighbor adjacency."""
        h = x
        for i, conv in enumerate(self.convs):
            h = self._act(conv(h, graph), i, deterministic, dropout_key)
        return h

    def tree_forward(self, sample: NeighborSample, x: torch.Tensor, *,
                     deterministic: bool = True,
                     dropout_key: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
        """Sampled-tree forward: x (N_total, F) per-slot features; returns
        the seed logits (num_seeds, out).  With dropout on and
        ``deterministic=False``, ``dropout_key`` keys the masks."""
        if sample.num_hops < self.num_layers:
            raise ValueError("need at least as many sampled hops as layers")
        kw = self._tree_kwargs(sample)
        h = x
        for j, conv in enumerate(self.convs):
            keep_depths = sample.num_hops - j
            h = conv(h, sample=sample, keep_depths=keep_depths, **kw)
            h = self._act(h, j, deterministic, dropout_key,
                          tree_rows(sample, keep_depths))
        return h[: sample.node_base[1]]

    def _tree_kwargs(self, sample: NeighborSample) -> dict:
        """Per-sample arguments every layer's conv takes on a tree batch."""
        return {}


class GIN(_Stack):
    def __init__(self, in_features: int, hidden: int, out: int,
                 num_layers: int, dtype=None, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        feats = [hidden] * (num_layers - 1) + [out]
        ins = [in_features] + feats[:-1]
        self._init([GINConv(i, f, hidden=hidden, dtype=dtype, device="meta")
                    for i, f in zip(ins, feats)], dropout, generator, device)


class GCN(_Stack):
    def __init__(self, in_features: int, hidden: int, out: int,
                 num_layers: int, dtype=None, dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        feats = [hidden] * (num_layers - 1) + [out]
        ins = [in_features] + feats[:-1]
        self._init([GCNConv(i, f, dtype=dtype, device="meta")
                    for i, f in zip(ins, feats)], dropout, generator, device)

    def _tree_kwargs(self, sample: NeighborSample) -> dict:
        # the valid-child counts depend on the sample, not the layer
        return {"child_counts": tree_child_counts(sample)}


class GAT(_Stack):
    """Multi-layer GAT: ``heads`` heads in every layer but the last, which
    has one head and ``max(out, 1)`` features; ELU between layers."""

    act = staticmethod(nnf.elu)

    def __init__(self, in_features: int, hidden: int, out: int,
                 num_layers: int, heads: int = 4, dtype=None,
                 dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        convs, fin = [], in_features
        for i in range(num_layers):
            last = i == num_layers - 1
            f = out if last else hidden
            hh = 1 if last else heads
            convs.append(GATConv(fin, max(f, hh), heads=hh, dtype=dtype,
                                 device="meta"))
            fin = max(f, hh)
        self._init(convs, dropout, generator, device)
