"""Adam equal to ``optax.adam``, shared by the models and the trainers.

``adam_update`` is one dense step over every parameter, as ``optax.adam``
takes it: each entry's moments decay every step, whether or not the step's
loss reached it.  ``gradients`` gives a parameter the loss does not reach a
zero gradient, so such a parameter keeps its value, as it would in a JAX
parameter tree that lacks it.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
LearningRate = Union[float, Callable[[int], float]]


class AdamState(NamedTuple):
    """``optax.scale_by_adam``'s state: the update count and the first and
    second moments, keyed as the parameters."""
    count: int
    mu: Params
    nu: Params


B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_init(params: Params) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                     {k: torch.zeros_like(p) for k, p in params.items()})


@torch.no_grad()
def adam_update(params: Params, grads: Params, state: AdamState,
                learning_rate: LearningRate) -> AdamState:
    """One ``optax.adam`` step (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    bias-corrected), applied to ``params`` in place; returns the new state.
    A callable ``learning_rate`` is a schedule of the count before this
    update, as optax calls it."""
    count = state.count + 1
    lr = (learning_rate(state.count) if callable(learning_rate)
          else learning_rate)
    # optax takes 1 - decay**count in float32: float32(0.999) is 1.3e-8
    # above 0.999, which moves 1 - 0.999 by 1.3e-5 of itself
    bc1, bc2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(count))
                for b in (B1, B2))
    mu, nu = {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = (1.0 - B1) * g + B1 * state.mu[k]
        nu[k] = (1.0 - B2) * (g * g) + B2 * state.nu[k]
        upd = (mu[k] / bc1) / ((nu[k] / bc2).sqrt() + EPS)
        p.add_(upd * -lr)
    return AdamState(count, mu, nu)


def init_state(model, state_type):
    """``state_type(params, adam_init(params), 0)``: the model's own
    parameters (drawn from its ``generator`` at construction) and a fresh
    Adam state at step 0, for the trainers' ``init_fn``."""
    params = dict(model.named_parameters())
    return state_type(params, adam_init(params), 0)


def gradients(loss: torch.Tensor, params: Params) -> Params:
    """``d loss / d params``, zeros for a parameter the loss does not
    reach."""
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), gs)}


def own_params(model, params: Params) -> None:
    """Raise unless ``params`` are ``model``'s own parameters: the forward
    reads the model's, so other tensors would take no gradient."""
    own = dict(model.named_parameters())
    if own.keys() != params.keys() or any(own[k] is not p
                                          for k, p in params.items()):
        raise ValueError("the state's params are not this trainer's model's "
                         "parameters; build the state with its init_fn")
