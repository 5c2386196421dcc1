"""HGT (Heterogeneous Graph Transformer) layer and model.

Counterpart of ``tch_geometric_tpu/models/hgt.py``: the relation-typed
consumer of the padded per-relation COO of ``HeteroNeighborSample``,
``HGTSample`` and ``BudgetSample`` (rows = local source slot, cols = local
destination slot, an edge-valid mask).  Per node type, K/Q/V and output
linears and a skip gate; per relation, attention and message matrices
(H, d, d) and a prior ``mu`` (H,); a softmax over each destination's valid
in-edges (``ops.segment``), masked edges at -inf.

``stacked_rels=True`` runs every relation with edges as one batched
computation over (R, E_max) stacked edges and (R, H, d, d) stacked
matrices, as the JAX package's relation-batched layout does.  The port
builds every relation's parameters at construction, one entry per relation
in both layouts (``w_att.<rel>``, ``w_msg.<rel>``, ``mu.<rel>``), and the
batched layout stacks the relations that have edges at each call: a
relation without edges is skipped and its parameters take no gradient,
where flax creates no parameters for it.  In the batched layout the
matrices are drawn as one (R, H, d, d) table (lecun_normal, fan-in
R * H * d, R all of ``rel_specs``), as flax draws its stacked table.

Edge features are gathered by ``index_select``, whose gradient is an
``index_add_``: a padded sample points its invalid edges at slot 0, and
advanced indexing's gradient (a sort, then one warp walking each index's
duplicates in turn) took about 10 ms a gather there on an H100.

Linear layers follow ``torch.nn.Linear``'s default init from an explicit
CPU ``torch.Generator``; ``skip`` and ``mu`` start at one.  ``dtype``
casts each linear's input and parameters, as flax's
``nn.Dense(dtype=...)``; the relation products then promote as jnp
promotes (bfloat16 keys times float32 matrices give float32), and the
per-relation layout accumulates its float32 messages into each
destination's bfloat16 zeros, which makes them float32, while the batched
layout casts its sum back, as the JAX layouts do.

``psum_axis`` is the distributed form (inside ``parallel.mesh.spmd``):
each rank holds only the edges of its own block of destination slots (the
per-rank COO of ``parallel.dist_hgt.dist_hgt_sample``) and every node's
inputs, and each layer sums its aggregated messages over the axis before
its output linear, so the hidden states are again the same on every rank.
A destination's softmax needs no collective: its in-edges all lie on one
rank.  The sum takes part in autograd (``parallel.mesh.psum_grad``): the
ranks' gradients averaged are the gradient of their mean loss.
"""
from __future__ import annotations

import copy
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as nnf

from ..ops.segment import segment_softmax, segment_sum
from .gnn import _lecun_normal_, _linear, _uniform_

Edges = Mapping[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
Widths = Union[int, Mapping[str, int]]


def _widths(in_features: Widths, node_types: Sequence[str]
            ) -> Dict[str, int]:
    if isinstance(in_features, int):
        return {t: in_features for t in node_types}
    return {t: int(in_features[t]) for t in node_types}


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum``'s promotion: both operands to their common type."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _reset_linears(lins: nn.ModuleDict, generator) -> None:
    for lin in lins.values():
        for p in lin.parameters():
            _uniform_(p, lin.in_features, generator)


class HGTConv(nn.Module):
    """One HGT layer over per-type node features and per-relation edges.

    ``in_features``: the input width, one for every type or a mapping of
    type to width (flax infers it).  ``rel_specs``: ``(rel_key, src_type,
    dst_type)`` triples.  A type's output mixes in its input by the gate
    ``sigmoid(skip)`` when the input is ``features`` wide."""

    def __init__(self, in_features: Widths, features: int,
                 node_types: Sequence[str],
                 rel_specs: Sequence[Tuple[str, str, str]],
                 heads: int = 2, dtype=None, stacked_rels: bool = False, *,
                 psum_axis=None, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        if features % heads:
            raise ValueError(f"features {features} not divisible by heads "
                             f"{heads}")
        self.features, self.heads, self.dtype = features, heads, dtype
        self.node_types = tuple(node_types)
        self.rel_specs = tuple(tuple(s) for s in rel_specs)
        self.stacked_rels = stacked_rels
        self.psum_axis = psum_axis
        d = features // heads
        fin = _widths(in_features, self.node_types)

        def lins(width):
            return nn.ModuleDict({t: nn.Linear(width(t), features,
                                               device="meta")
                                  for t in self.node_types})

        def rel_params(shape):
            return nn.ParameterDict({
                r: nn.Parameter(torch.empty(shape, device="meta"))
                for r, _s, _d in self.rel_specs})

        self.k, self.q, self.v = (lins(fin.get) for _ in range(3))
        self.a = lins(lambda t: features)
        self.skip = nn.ParameterDict({
            t: nn.Parameter(torch.empty(1, device="meta"))
            for t in self.node_types})
        self.w_att = rel_params((heads, d, d))
        self.w_msg = rel_params((heads, d, d))
        self.mu = rel_params((heads,))
        self.to_empty(device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Linears U(+-1/sqrt(fan_in)); ``w_att``/``w_msg`` lecun_normal per
        relation, or as one (R, H, d, d) table when ``stacked_rels``;
        ``skip`` and ``mu`` one.  Drawn on the CPU from ``generator``, then
        copied to the parameters' device."""
        for lins in (self.k, self.q, self.v, self.a):
            _reset_linears(lins, generator)
        for table in (self.w_att, self.w_msg):
            shape = next(iter(table.values())).shape
            if self.stacked_rels:
                w = torch.empty((len(table),) + tuple(shape))
                _lecun_normal_(w, generator)
                for p, row in zip(table.values(), w):
                    p.copy_(row)
            else:
                for p in table.values():
                    w = torch.empty(shape)
                    _lecun_normal_(w, generator)
                    p.copy_(w)
        for p in list(self.skip.values()) + list(self.mu.values()):
            p.fill_(1.0)

    def forward(self, x: Mapping[str, torch.Tensor], edges: Edges
                ) -> Dict[str, torch.Tensor]:
        """``x``: type -> (N_t, F_t); ``edges``: relation -> (rows, cols,
        valid), rows and cols local slots of the source and destination
        types.  Returns type -> (N_t, features)."""
        H, F = self.heads, self.features
        d = F // H

        def proj(lins):
            return {t: _linear(lins[t], x[t], self.dtype).reshape(-1, H, d)
                    for t in self.node_types}

        K, Q, V = proj(self.k), proj(self.q), proj(self.v)
        out = {t: torch.zeros((x[t].shape[0], H, d),
                              dtype=x[t].dtype if self.dtype is None
                              else self.dtype, device=x[t].device)
               for t in self.node_types}
        if self.stacked_rels:
            out = self._stacked_messages(x, edges, K, Q, V, out)
        else:
            for r, src, dst in self.rel_specs:
                if r not in edges or edges[r][0].shape[0] == 0:
                    continue
                rows, cols, valid = edges[r]
                n_dst = x[dst].shape[0]
                rows_c = rows.clamp(0, x[src].shape[0] - 1)
                cols_c = cols.clamp(0, n_dst - 1)
                kt = _einsum("ehd,hdf->ehf", K[src].index_select(0, rows_c),
                             self.w_att[r])
                score = ((kt * Q[dst].index_select(0, cols_c)).sum(-1)
                         * (self.mu[r] / math.sqrt(d)))          # (E, H)
                att = segment_softmax(score, cols_c, n_dst, mask=valid)
                msg = _einsum("ehd,hdf->ehf", V[src].index_select(0, rows_c),
                              self.w_msg[r])
                msg = torch.where(valid[:, None, None],
                                  msg * att[..., None], 0.0)
                out[dst] = out[dst] + segment_sum(msg, cols_c, n_dst)

        if self.psum_axis is not None:
            from ..parallel.mesh import psum_grad
            out = {t: psum_grad(v, self.psum_axis) for t, v in out.items()}

        res = {}
        for t in self.node_types:
            h = nnf.gelu(_linear(self.a[t], out[t].reshape(-1, F),
                                 self.dtype), approximate="tanh")
            if x[t].shape[-1] == F:
                alpha = torch.sigmoid(self.skip[t])
                h = alpha * h + (1 - alpha) * x[t]
            res[t] = h
        return res

    def _stacked_messages(self, x, edges: Edges, K, Q, V, out):
        """Every relation with edges at once: gathers by one flat index
        (type * N_max + slot) into the types' padded tables, the relation
        products as one batched einsum, the softmax over (relation,
        destination) segments and the sum over (type, destination)
        segments."""
        specs = [(r, s, t) for r, s, t in self.rel_specs
                 if r in edges and edges[r][0].shape[0] > 0]
        if not specs:
            return out
        dev = next(iter(out.values())).device
        H, d = self.heads, self.features // self.heads
        R, T = len(specs), len(self.node_types)
        t_index = {t: i for i, t in enumerate(self.node_types)}
        src_idx = torch.tensor([t_index[s] for _r, s, _t in specs],
                               device=dev)
        dst_idx = torch.tensor([t_index[t] for _r, _s, t in specs],
                               device=dev)
        w_att = torch.stack([self.w_att[r] for r, _s, _t in specs])
        w_msg = torch.stack([self.w_msg[r] for r, _s, _t in specs])
        mu = torch.stack([self.mu[r] for r, _s, _t in specs])     # (R, H)

        E_max = max(edges[r][0].shape[0] for r, _s, _t in specs)
        N_max = max(x[t].shape[0] for t in self.node_types)
        N_arr = torch.tensor([x[t].shape[0] for t in self.node_types],
                             device=dev)

        def pad_e(a, fill=0):
            return nnf.pad(a, (0, E_max - a.shape[0]), value=fill)

        rows_s = torch.stack([pad_e(edges[r][0]) for r, _s, _t in specs])
        cols_s = torch.stack([pad_e(edges[r][1]) for r, _s, _t in specs])
        val_s = torch.stack([pad_e(edges[r][2], False)
                             for r, _s, _t in specs])

        def flat(tables):            # (T * N_max, H, d)
            return torch.cat([nnf.pad(tables[t], (0, 0, 0, 0, 0,
                                                  N_max - tables[t].shape[0]))
                              for t in self.node_types])

        n_src, n_dst = N_arr[src_idx], N_arr[dst_idx]
        rows_c = torch.minimum(rows_s.clamp(min=0), (n_src - 1)[:, None])
        cols_c = torch.minimum(cols_s.clamp(min=0), (n_dst - 1)[:, None])
        idx_src = (src_idx[:, None] * N_max + rows_c).reshape(-1)
        idx_dst = (dst_idx[:, None] * N_max + cols_c).reshape(-1)
        k_e = flat(K).index_select(0, idx_src).reshape(R, E_max, H, d)
        q_e = flat(Q).index_select(0, idx_dst).reshape(R, E_max, H, d)
        v_e = flat(V).index_select(0, idx_src).reshape(R, E_max, H, d)
        kt = _einsum("rehd,rhdf->rehf", k_e, w_att)
        score = (kt * q_e).sum(-1) * (mu[:, None, :] / math.sqrt(d))
        # mask padded destination slots too: segments run over N_max a type
        ok = val_s & (cols_s < n_dst[:, None])                   # (R, E)
        seg_att = (torch.arange(R, device=dev)[:, None] * (T * N_max)
                   + dst_idx[:, None] * N_max + cols_c)
        att = segment_softmax(score.reshape(R * E_max, H),
                              seg_att.reshape(-1), R * T * N_max,
                              mask=ok.reshape(-1)).reshape(R, E_max, H)
        msg = _einsum("rehd,rhdf->rehf", v_e, w_msg) * att[..., None]
        msg = torch.where(ok[..., None, None], msg, 0.0)
        out_dtype = next(iter(out.values())).dtype
        agg = segment_sum(msg.reshape(R * E_max, H, d), idx_dst,
                          T * N_max).to(out_dtype).reshape(T, N_max, H, d)
        return {t: out[t] + agg[t_index[t], : x[t].shape[0]]
                for t in self.node_types}


class HGT(nn.Module):
    """Multi-layer HGT: per-type input linears to ``hidden``,
    ``num_layers`` HGT layers, and a linear head on ``out_type``'s rows.

    ``in_features``: the input width, one for every type or per type;
    ``psum_axis`` as in :class:`HGTConv` (module doc), for every layer."""

    def __init__(self, in_features: Widths, hidden: int, out: int,
                 num_layers: int, node_types: Sequence[str],
                 rel_specs: Sequence[Tuple[str, str, str]], out_type: str,
                 heads: int = 2, dtype=None, stacked_rels: bool = False, *,
                 psum_axis=None, generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.node_types = tuple(node_types)
        self.rel_specs = tuple(tuple(s) for s in rel_specs)
        self.out_type, self.dtype = out_type, dtype
        fin = _widths(in_features, self.node_types)
        self.inputs = nn.ModuleDict({t: nn.Linear(fin[t], hidden,
                                                  device="meta")
                                     for t in self.node_types})
        self.head = nn.Linear(hidden, out, device="meta")
        self.to_empty(device=device)
        with torch.no_grad():
            _reset_linears(self.inputs, generator)
        self.convs = nn.ModuleList(
            HGTConv(hidden, hidden, self.node_types, self.rel_specs,
                    heads=heads, dtype=dtype, stacked_rels=stacked_rels,
                    psum_axis=psum_axis, generator=generator, device=device)
            for _ in range(num_layers))
        with torch.no_grad():
            _reset_linears(nn.ModuleDict({"head": self.head}), generator)

    def forward(self, x: Mapping[str, torch.Tensor], edges: Edges
                ) -> torch.Tensor:
        """Logits of ``out_type``'s rows, (N_out, out)."""
        h = {t: _linear(self.inputs[t], x[t], self.dtype)
             for t in self.node_types}
        for conv in self.convs:
            h = conv(h, edges)
        return _linear(self.head, h[self.out_type], self.dtype)

    def clone(self, *, psum_axis) -> "HGT":
        """The same model, its layers summing over ``psum_axis``: a view
        that shares every parameter tensor with this one (flax's
        ``model.clone(psum_axis=...)``)."""
        view = copy.copy(self)
        view.__dict__["_modules"] = dict(self._modules)
        convs = []
        for conv in self.convs:
            c = copy.copy(conv)
            c.psum_axis = psum_axis
            convs.append(c)
        view.__dict__["_modules"]["convs"] = nn.ModuleList(convs)
        return view
