"""GCN, GAT and GIN — the other message-passing model families.

Counterpart of ``tch_geometric_tpu/models/gnn.py``.  Each conv takes the
same graph containers as GraphSAGE: a full ``SparseGraph`` (gather +
segment ops), or a padded ``NeighborSample`` with ``keep_depths`` (dense
per-depth reductions over the fanout axis, no scatter).  ``GATConv`` also
takes ``blocked=`` (a ``BlockedCsr`` of the same adjacency), which runs the
head-packed GAT kernel B3 on the card, and :meth:`GAT.blocked_forward` runs
a whole full-graph pass so.  ``GATConv`` takes PyG's options (averaged
heads, bias, self loops) and ``GAT(..., pyg=True)`` is PyG's model (those
and skip linears); the defaults are the flax model's.

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
from ..utils.metrics import trace_span
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
    """Multi-head graph attention (GATv1-style additive logits).

    ``features`` is the projection's width: ``heads`` heads of ``features //
    heads`` columns, one linear without bias shared by sources and targets.
    PyG's ``GATConv`` options, all off by default (the flax model's layer):

    * ``concat=False``: the heads are averaged, so the layer gives
      ``features // heads`` columns (``out_features``);
    * ``bias``: ``out_bias`` (PyG's ``bias``, zeros at init) is added after
      the heads are joined;
    * ``self_loops``: every target ``i`` that is also a source takes one
      self loop (logit ``leaky_relu(a_src . h_i + a_dst . h_i)``, row
      ``h_i``).  The segment path removes the graph's own self loops first,
      as PyG does; on a tree a parent attends its own slot and children
      that are the parent's node are dropped; B3 folds one term into each
      row and gives the layout's own self-loop lanes no weight.
    """

    def __init__(self, in_features: int, features: int, heads: int = 4,
                 dtype=None, device="cuda", *, concat: bool = True,
                 bias: bool = False, self_loops: bool = False):
        super().__init__()
        if features % heads:
            raise ValueError(f"features ({features}) must be divisible by "
                             f"heads ({heads})")
        self.features = features
        self.heads = heads
        self.dtype = dtype
        self.concat = concat
        self.self_loops = self_loops
        d = features // heads
        self.out_features = features if concat else d
        self.lin = nn.Linear(in_features, features, bias=False, device=device)
        self.a_src = nn.Parameter(torch.empty((heads, d), device=device))
        self.a_dst = nn.Parameter(torch.empty((heads, d), device=device))
        if bias:
            self.out_bias = nn.Parameter(torch.empty((self.out_features,),
                                                     device=device))
        else:
            self.register_parameter("out_bias", None)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        _uniform_(self.lin.weight, self.lin.in_features, generator)
        _lecun_normal_(self.a_src, generator)
        _lecun_normal_(self.a_dst, generator)
        if self.out_bias is not None:
            self.out_bias.zero_()

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

    def attend_blocked(self, h: torch.Tensor, blocked,
                       compute_dtype=None) -> torch.Tensor:
        """B3 (``gat_attend_blocked_packed_cuda``) over ``blocked`` on the
        projected rows ``h`` (N, H, d), read in ``compute_dtype`` (default:
        the layer's), with the layer's self loops: (num_rows, H, d)
        float32."""
        # GATv1's alpha_src is a linear projection of h: the kernel
        # computes it from the rows it reads
        return gat_attend_blocked_packed_cuda(
            blocked, h, None, (h * self.a_dst[None]).sum(-1),
            alpha_src_vec=self.a_src,
            compute_dtype=(self.compute_dtype if compute_dtype is None
                           else compute_dtype),
            self_loops=self.self_loops)

    def join_heads(self, out: torch.Tensor) -> torch.Tensor:
        """(N, H, d) attention output as the layer's rows: the heads
        concatenated, or averaged (``concat=False``)."""
        return (out.reshape(-1, self.features) if self.concat
                else out.mean(dim=1))

    def add_bias(self, out: torch.Tensor) -> torch.Tensor:
        return out if self.out_bias is None else out + self.out_bias

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
            out = torch.cat([self.tree_attention(
                hf, sample.node_valid, sample, dd, a_src, a_dst,
                self_loops=self.self_loops) for dd in range(keep_depths)],
                dim=0)
            return self.add_bias(self.join_heads(
                out.reshape(-1, self.heads, self.features // self.heads)))

        if blocked is not None:
            return self.add_bias(self.join_heads(self.attend_blocked(
                h, blocked)))

        alpha_src, alpha_dst = self.logit_tables(h)         # (N, H) each
        n = graph.num_ptr_nodes
        rows = csr_row_ids(graph.indptr, graph.num_edges)   # dst per edge
        src = graph.indices
        if self.self_loops:
            # PyG: remove the graph's self loops, then add one per node
            keep = src.long() != rows
            loop = torch.arange(min(n, h.shape[0]), device=rows.device)
            src = torch.cat([src[keep].long(), loop])
            rows = torch.cat([rows[keep], loop])
        logits = nnf.leaky_relu(
            alpha_src[src] + alpha_dst[rows], 0.2)          # (E, H)
        att = segment_softmax(logits, rows, n)
        msg = h[src] * att[..., None]                       # (E, H, d)
        return self.add_bias(self.join_heads(segment_sum(msg, rows, n)))

    @staticmethod
    def tree_attention(h: torch.Tensor, valid: torch.Tensor,
                       sample: NeighborSample, depth: int,
                       a_src: torch.Tensor, a_dst: torch.Tensor, *,
                       self_loops: bool = False) -> torch.Tensor:
        """Dense attention over a padded tree layer: (B, k) children —
        softmax over the fanout axis, no scatter.  ``self_loops``: each
        parent also attends its own slot, and a child that is the parent's
        own node is dropped (PyG relabels it onto the parent: a self loop,
        removed before one is added)."""
        k = sample.fanouts[depth]
        lo, hi = sample.node_base[depth], sample.node_base[depth + 1]
        clo, chi = sample.node_base[depth + 1], sample.node_base[depth + 2]
        B = hi - lo
        H, d = a_src.shape
        hd = h[lo:hi].reshape(B, H, d)
        hc = h[clo:chi].reshape(B, k, H, d)
        mask = valid[clo:chi].reshape(B, k)
        dst_term = (hd * a_dst[None]).sum(-1)                 # (B, H)
        logits = nnf.leaky_relu(
            (hc * a_src[None, None]).sum(-1) + dst_term[:, None, :], 0.2)
        if self_loops:
            nodes = sample.nodes
            mask = mask & (nodes[clo:chi].reshape(B, k)
                           != nodes[lo:hi][:, None])
            own = nnf.leaky_relu((hd * a_src[None]).sum(-1) + dst_term, 0.2)
            logits = torch.cat([logits, own[:, None]], dim=1)  # (B, k+1, H)
            hc = torch.cat([hc, hd[:, None]], dim=1)
            mask = torch.cat([mask, mask.new_ones((B, 1))], dim=1)
        mask = mask[..., None]
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

    def _skip(self, i: int, h_in: torch.Tensor, out: torch.Tensor
              ) -> torch.Tensor:
        """Layer ``i``'s output ``out`` of the rows ``h_in[:len(out)]``
        (the targets come first), before the activation: as it is here."""
        return out

    def forward(self, x: torch.Tensor, graph: SparseGraph, *,
                deterministic: bool = True,
                dropout_key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-graph forward: x (N, F), CSC in-neighbor adjacency."""
        h = x
        for i, conv in enumerate(self.convs):
            h = self._act(self._skip(i, h, conv(h, graph)), i, deterministic,
                          dropout_key)
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
            out = conv(h, sample=sample, keep_depths=keep_depths, **kw)
            h = self._act(self._skip(j, h, out), j, deterministic,
                          dropout_key, tree_rows(sample, keep_depths))
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
    """Multi-layer GAT, ELU between layers.

    Every layer but the last has ``heads`` heads of ``hidden // heads``
    columns, concatenated.  By default (the flax model) the last layer has
    one head and ``max(out, 1)`` features.  ``pyg=True`` gives PyG's GAT of
    ``examples/ogbn_products_gat.py`` (``GAT(100, 4 * 128, 47, 3, heads=4,
    pyg=True)``):

    * the last layer has ``heads`` heads of ``out`` columns, averaged;
    * every ``GATConv`` has PyG's bias and self loops (see
      :class:`GATConv`);
    * a linear with bias per layer (``skips``) maps the layer's input to its
      output width and is added to the conv's output before the activation
      (on a tree, of the target slots' rows).

    :meth:`blocked_forward` is the full-graph pass over a blocked layout
    (B3 on the card).
    """

    act = staticmethod(nnf.elu)

    def __init__(self, in_features: int, hidden: int, out: int,
                 num_layers: int, heads: int = 4, dtype=None,
                 dropout: float = 0.0, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", pyg: bool = False):
        super().__init__()
        self.dtype = dtype
        convs, fin = [], in_features
        for i in range(num_layers):
            last = i == num_layers - 1
            opts = dict(dtype=dtype, device="meta", bias=pyg, self_loops=pyg)
            if last and pyg:
                conv = GATConv(fin, out * heads, heads=heads, concat=False,
                               **opts)
            else:
                f = out if last else hidden
                hh = 1 if last else heads
                conv = GATConv(fin, max(f, hh), heads=hh, **opts)
            convs.append(conv)
            fin = conv.out_features
        self.skips = (nn.ModuleList(
            [nn.Linear(c.lin.in_features, c.out_features, device="meta")
             for c in convs]) if pyg else None)
        self._init(convs, dropout, generator, device)
        if pyg:
            with torch.no_grad():
                for lin in self.skips:
                    for p in lin.parameters():
                        _uniform_(p, lin.in_features, generator)

    def _skip(self, i: int, h_in: torch.Tensor, out: torch.Tensor
              ) -> torch.Tensor:
        if self.skips is None:
            return out
        return out + _linear(self.skips[i], h_in[: out.shape[0]], self.dtype)

    def blocked_forward(self, x: torch.Tensor, blocked,
                        compute_dtype=torch.bfloat16) -> torch.Tensor:
        """Full-graph forward over a blocked layout of the in-neighbour
        adjacency, without dropout: per layer the projection in the
        model's dtype, then B3 (with the layer's self loops) reading the
        rows in ``compute_dtype`` with float32 logits, softmax and sums,
        the heads joined, the bias, the skip and the activation.  Runs in a
        ``trace_span`` ``blocked_forward``, each layer's attention (its
        alpha_dst table, B3 with its cast of the rows, the heads joined) in
        one ``aggregate``.  Returns (num_rows, out) float32 logits."""
        with trace_span("blocked_forward"):
            h = x
            for i, conv in enumerate(self.convs):
                hp = conv.project(h)
                with trace_span("aggregate"):
                    out = conv.join_heads(conv.attend_blocked(
                        hp, blocked, compute_dtype))
                h = self._act(self._skip(i, h, conv.add_bias(out)), i, True)
            return h
