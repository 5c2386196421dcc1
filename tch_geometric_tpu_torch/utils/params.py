"""Carry parameters from the JAX package's flax models into the port.

Takes the flax parameter tree as nested mappings of array-likes (numpy
arrays, or anything ``numpy.asarray`` accepts), so this module needs no
JAX import.  ``adam_state_from_optax`` and ``train_state_from_flax`` carry
an ``optax.adam`` state and a JAX ``TrainState`` across, so a JAX run
stopped at step K continues in the port.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch


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


ParamsFromFlax = Callable[[Mapping], Dict[str, torch.Tensor]]


def adam_state_from_optax(opt_state, params_from_flax: ParamsFromFlax =
                          sage_params_from_flax, device="cuda"):
    """``optax.adam``'s state -> the port's ``AdamState`` on ``device``.

    ``opt_state`` is optax's ``ScaleByAdamState`` (``count``, ``mu``,
    ``nu``) or the chain that holds it (``optax.adam``'s state tuple);
    ``params_from_flax`` maps the moments' flax trees to the port's keys as
    it maps the parameters (``sage_params_from_flax`` or
    ``gnn_params_from_flax``)."""
    from ..parallel.train import AdamState
    if not hasattr(opt_state, "mu"):
        opt_state = next(s for s in opt_state if hasattr(s, "mu"))

    def moments(tree):
        return {k: v.to(device) for k, v in params_from_flax(tree).items()}
    return AdamState(int(np.asarray(opt_state.count)),
                     moments(opt_state.mu), moments(opt_state.nu))


def train_state_from_flax(model, flax_state,
                          params_from_flax: ParamsFromFlax =
                          sage_params_from_flax):
    """A JAX ``TrainState`` (``params``, ``opt_state``, ``step``) -> the
    port's ``TrainState`` of ``model``: the parameters are loaded into the
    model, whose own parameters the state then holds, and the Adam moments
    are put on the model's device."""
    from ..parallel.train import TrainState
    model.load_state_dict(params_from_flax(flax_state.params))
    params = dict(model.named_parameters())
    device = next(iter(params.values())).device
    return TrainState(params,
                      adam_state_from_optax(flax_state.opt_state,
                                            params_from_flax, device),
                      int(np.asarray(flax_state.step)))
