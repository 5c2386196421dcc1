"""Carry parameters from the JAX package's flax models into the port.

Takes the flax parameter tree as nested mappings of array-likes (numpy
arrays, or anything ``numpy.asarray`` accepts), so this module needs no
JAX import.  ``adam_state_from_optax`` and ``train_state_from_flax`` carry
an ``optax.adam`` state and a JAX ``TrainState`` (or an ``HGTTrainState`` or
``N2VState``) across, so a JAX run stopped at step K continues in the port.

A flax tree may hold fewer parameters than the port's model: flax creates
an HGT relation's parameters only if the relation had edges at init, while
the port builds every relation's at construction.  The carriers return what
the tree holds; loading keeps the model's own values for the rest, and
their Adam moments start at zero.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .adam import AdamState


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(dense: Mapping, prefix: str, out: Dict[str, torch.Tensor]):
    """A flax ``Dense`` into ``<prefix>.weight`` (transposed) and
    ``<prefix>.bias``."""
    out[f"{prefix}.weight"] = _f32(np.asarray(dense["kernel"]).T)
    if "bias" in dense:
        out[f"{prefix}.bias"] = _f32(dense["bias"])


def sage_params_from_flax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``GraphSAGE`` params -> ``GraphSAGE.state_dict()`` keys.

    Each flax ``Dense`` kernel ``(in, out)`` becomes a ``Linear.weight``
    ``(out, in)``; biases carry over as they are.  Accepts the tree with or
    without its top-level ``"params"`` entry."""
    p = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"conv{i}" in p:
        conv = p[f"conv{i}"]
        for lin in ("lin_self", "lin_neigh"):
            _dense(conv[lin], f"convs.{i}.{lin}", out)
        i += 1
    return out


def gnn_params_from_flax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``GAT``, ``GCN`` or ``GIN`` params -> the port's
    ``state_dict()`` keys.

    ``GATConv_i``: ``Dense_0`` -> ``convs.i.lin``, ``a_src``/``a_dst``
    ``(H, D)`` as they are; ``GCNConv_i``: ``Dense_0`` -> ``convs.i.lin``;
    ``GINConv_i``: scalar ``eps`` as it is, ``Dense_0``/``Dense_1`` ->
    ``convs.i.lin1``/``lin2``.  Each ``Dense`` kernel ``(in, out)`` becomes
    a ``Linear.weight`` ``(out, in)``.  Accepts the tree with or without its
    top-level ``"params"`` entry."""
    p = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}
    for kind in ("GATConv", "GCNConv", "GINConv"):
        i = 0
        while f"{kind}_{i}" in p:
            conv, pre = p[f"{kind}_{i}"], f"convs.{i}"
            if kind == "GINConv":
                out[f"{pre}.eps"] = _f32(conv["eps"])
                _dense(conv["Dense_0"], f"{pre}.lin1", out)
                _dense(conv["Dense_1"], f"{pre}.lin2", out)
            else:
                _dense(conv["Dense_0"], f"{pre}.lin", out)
            if kind == "GATConv":
                out[f"{pre}.a_src"] = _f32(conv["a_src"])
                out[f"{pre}.a_dst"] = _f32(conv["a_dst"])
            i += 1
    return out


def hgt_params_from_flax(flax_params: Mapping,
                         rel_specs: Sequence[Tuple[str, str, str]],
                         stacked_rels: bool = False,
                         rels_with_edges: Optional[Sequence[str]] = None
                         ) -> Dict[str, torch.Tensor]:
    """flax ``HGT`` or ``HGTConv`` params -> the port's ``state_dict()``
    keys (``HGT``: ``in_<t>`` -> ``inputs.<t>``, ``hgt<i>`` ->
    ``convs.<i>``, ``head``; a conv's ``k_<t>`` ... ``a_<t>`` Dense ->
    ``k.<t>`` ... ``a.<t>``, ``skip_<t>`` -> ``skip.<t>``).

    Per relation (``stacked_rels=False``) the tree names each relation that
    had edges at flax's init (``w_att_<r>``, ``w_msg_<r>``, ``mu_<r>``) and
    each carries to ``w_att.<r>``, ``w_msg.<r>``, ``mu.<r>``.  Batched
    (``stacked_rels=True``), row ``i`` of the (R, H, d, d) ``w_att`` /
    ``w_msg`` and the (R, H) ``mu`` is the i-th of ``rels_with_edges`` (the
    relations that had edges at flax's init, in ``rel_specs`` order;
    default all of ``rel_specs``).  Relations the tree lacks are left out
    of the result.  Accepts the tree with or without its top-level
    ``"params"`` entry."""
    p = flax_params.get("params", flax_params)
    names = [spec[0] for spec in rel_specs]
    present = names if rels_with_edges is None else [
        r for r in names if r in rels_with_edges]
    out: Dict[str, torch.Tensor] = {}

    def conv(tree: Mapping, pre: str):
        for name, sub in tree.items():
            kind, _, t = name.partition("_")
            if kind in ("k", "q", "v", "a") and "kernel" in sub:
                _dense(sub, f"{pre}{kind}.{t}", out)
            elif kind == "skip":
                out[f"{pre}skip.{t}"] = _f32(sub)
        for kind in ("w_att", "w_msg", "mu"):
            if stacked_rels:
                if kind not in tree:
                    continue
                rows = np.asarray(tree[kind])
                if rows.shape[0] != len(present):
                    raise ValueError(
                        f"{pre}{kind} has {rows.shape[0]} relations; "
                        f"rels_with_edges names {len(present)}")
                for r, row in zip(present, rows):
                    out[f"{pre}{kind}.{r}"] = _f32(row)
            else:
                for r in names:
                    if f"{kind}_{r}" in tree:
                        out[f"{pre}{kind}.{r}"] = _f32(tree[f"{kind}_{r}"])

    if "head" in p:
        i = 0
        while f"hgt{i}" in p:
            conv(p[f"hgt{i}"], f"convs.{i}.")
            i += 1
        for name, sub in p.items():
            if name.startswith("in_"):
                _dense(sub, f"inputs.{name[3:]}", out)
        _dense(p["head"], "head", out)
    else:
        conv(p, "")
    return out


def node2vec_params_from_flax(flax_params: Mapping
                              ) -> Dict[str, torch.Tensor]:
    """flax ``Node2Vec`` params -> ``Node2Vec.state_dict()``: the
    ``nn.Embed`` table as ``embedding.weight``."""
    p = flax_params.get("params", flax_params)
    return {"embedding.weight": _f32(p["embedding"]["embedding"])}


ParamsFromFlax = Callable[[Mapping], Dict[str, torch.Tensor]]


def adam_state_from_optax(opt_state, params_from_flax: ParamsFromFlax =
                          sage_params_from_flax, device="cuda",
                          params: Optional[Mapping[str, torch.Tensor]] = None
                          ) -> AdamState:
    """``optax.adam``'s state -> the port's ``AdamState`` on ``device``.

    ``opt_state`` is optax's ``ScaleByAdamState`` (``count``, ``mu``,
    ``nu``) or the chain that holds it (``optax.adam``'s state tuple);
    ``params_from_flax`` maps the moments' flax trees to the port's keys as
    it maps the parameters (``sage_params_from_flax``,
    ``gnn_params_from_flax``, or ``hgt_params_from_flax`` /
    ``node2vec_params_from_flax`` with their arguments bound).  Given the
    model's ``params``, a parameter the tree lacks gets zero moments."""
    if not hasattr(opt_state, "mu"):
        opt_state = next(s for s in opt_state if hasattr(s, "mu"))

    def moments(tree):
        m = {k: v.to(device) for k, v in params_from_flax(tree).items()}
        if params is not None:
            m = {k: m[k] if k in m else torch.zeros_like(p)
                 for k, p in params.items()}
        return m
    return AdamState(int(np.asarray(opt_state.count)),
                     moments(opt_state.mu), moments(opt_state.nu))


def load_flax_params(model, params: Mapping[str, torch.Tensor]) -> None:
    """Load carried parameters into ``model``; raise on a key the model
    lacks.  Parameters the flax tree lacked keep the model's values."""
    bad = model.load_state_dict(params, strict=False).unexpected_keys
    if bad:
        raise KeyError(f"parameters the model lacks: {bad}")


def train_state_from_flax(model, flax_state,
                          params_from_flax: ParamsFromFlax =
                          sage_params_from_flax, state_type=None):
    """A JAX ``TrainState`` (``params``, ``opt_state``, ``step``) -> the
    port's state of ``model`` (``state_type``, default the port's
    ``TrainState``; ``HGTTrainState`` and ``N2VState`` have the same
    fields): the parameters are loaded into the model, whose own
    parameters the state then holds, and the Adam moments are put on the
    model's device."""
    if state_type is None:
        from ..parallel.train import TrainState as state_type
    load_flax_params(model, params_from_flax(flax_state.params))
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return state_type(params,
                      adam_state_from_optax(flax_state.opt_state,
                                            params_from_flax, device,
                                            params),
                      int(np.asarray(flax_state.step)))
