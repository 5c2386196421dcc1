"""Link-prediction training with negative sampling on the device.

Counterpart of ``tch_geometric_tpu/parallel/link_train.py``'s
single-device ``make_link_trainer``: sample trees for the batch edges'
endpoints and their negatives in one sampler call, encode them with any
``tree_forward`` model, score positives ``<h_u, h_v>`` and corrupt
destinations, binary cross entropy on the positives and the accepted
negatives.

Orientation: the sampler needs the CSC (rows are in-neighbors), so the
probe of a corrupt edge ``src -> cand`` searches cand's CSC row for src,
``has_edge(cand, src)``.  A candidate is rejected if it is an edge or
equals either endpoint.  The partitioned trainer is not ported.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.nn import functional as nnf

from ..data.graph import CscGraph
from ..sampling import rng
from ..sampling.neighbor import _sample_neighbors_impl
from ..utils.adam import (LearningRate, adam_update, gradients, init_state,
                          own_params)
from ..utils.metrics import trace_span
from .train import TrainState


class LinkTrainer(NamedTuple):
    """``[:3]`` is the JAX trainer's ``(init_fn, train_step, eval_step)``;
    ``negatives(key, graph, src, dst) -> (neg, accepted)`` the corrupt
    destinations a step key draws, (B, num_neg) each."""
    init_fn: Callable[..., TrainState]
    train_step: Callable[..., Tuple[TrainState, torch.Tensor, torch.Tensor]]
    eval_step: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    negatives: Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def first_accepted(ok: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where there is none
    (``jnp.argmax`` of a bool array)."""
    n = ok.shape[-1]
    at = torch.arange(n, device=ok.device).expand_as(ok)
    first = torch.where(ok, at, n).amin(dim=-1)
    return torch.where(first == n, 0, first)


def _sigmoid_bce(logits: torch.Tensor, labels: float) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy`` against a constant label."""
    return (-labels * nnf.logsigmoid(logits)
            - (1.0 - labels) * nnf.logsigmoid(-logits))


def make_link_trainer(model, fanouts: Sequence[int], *, num_neg: int = 1,
                      try_count: int = 8,
                      learning_rate: LearningRate = 1e-3,
                      window: int = 256) -> LinkTrainer:
    """Link prediction with any model that has ``tree_forward(sample, x,
    deterministic=..., dropout_key=...)``.

    ``train_step(state, key, graph, x_table, src, dst) -> (state, loss,
    rank)`` on the batch's positive edges ``src -> dst`` (B,): step key
    ``fold(key, state.step)``; per edge ``num_neg`` corrupt destinations,
    each the first of ``try_count`` candidates ``randint(fold(key, 7), (B,
    num_neg, try_count), 0, num_dst)`` that is no edge from src and neither
    endpoint (a slot with none is left out of the loss); one sampler call
    over ``[src, dst, neg]`` with ``fold(key, 11)``; dropout keyed by
    ``fold(key, DROPOUT_STREAM)``; one Adam step.  ``rank`` is the share of
    accepted negatives that score below their positive.
    ``eval_step(state, key, graph, x_table, src, dst) -> (loss, rank)``
    with dropout off and ``key`` as it is.  ``init_fn(*_)`` takes the JAX
    ``init_fn``'s arguments and needs none."""
    fanouts = tuple(int(k) for k in fanouts)

    def negatives(key, graph: CscGraph, src, dst):
        src = torch.as_tensor(src).to(graph.device).long()
        dst = torch.as_tensor(dst).to(graph.device).long()
        B = src.shape[0]
        cand = rng.randint(rng.fold(key, 7), (B, num_neg, try_count), 0,
                           graph.num_dst, device=graph.device)
        s, d = src[:, None, None], dst[:, None, None]
        ok = (~graph.has_edge(cand, s.expand_as(cand)) & (cand != d)
              & (cand != s))
        neg = cand.gather(-1, first_accepted(ok)[..., None])[..., 0]
        return neg, ok.any(dim=-1)                      # (B, num_neg) each

    def loss_fn(key, graph: CscGraph, x_table, src, dst,
                deterministic: bool):
        src = torch.as_tensor(src).to(graph.device).long()
        dst = torch.as_tensor(dst).to(graph.device).long()
        B = src.shape[0]
        with trace_span("sample"):
            neg, neg_ok = negatives(key, graph, src, dst)
            seeds = torch.cat([src, dst, neg.reshape(-1)])
            sample = _sample_neighbors_impl(
                rng.fold(key, 11), graph, seeds, torch.zeros_like(seeds),
                fanouts, False, window=window)
        with trace_span("gather"):
            x = x_table[sample.nodes.clamp(0, x_table.shape[0] - 1)]
        with trace_span("forward"):
            h = model.tree_forward(
                sample, x, deterministic=deterministic,
                dropout_key=rng.fold(key, rng.DROPOUT_STREAM))
            h_src, h_dst = h[:B], h[B: 2 * B]
            h_neg = h[2 * B:].reshape(B, num_neg, -1)
            pos = (h_src * h_dst).sum(-1)                       # (B,)
            negs = (h_src[:, None, :] * h_neg).sum(-1)          # (B, num_neg)
            n_ok = neg_ok.sum().clamp(min=1)
            loss = (_sigmoid_bce(pos, 1.0).mean()
                    + (_sigmoid_bce(negs, 0.0) * neg_ok).sum() / n_ok)
            rank = ((pos[:, None] > negs) * neg_ok).sum() / n_ok
        return loss, rank.detach()

    def init_fn(*_) -> TrainState:
        return init_state(model, TrainState)

    def train_step(state: TrainState, key: torch.Tensor, graph: CscGraph,
                   x_table: torch.Tensor, src, dst
                   ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
        own_params(model, state.params)
        step_key = rng.fold(key, state.step)
        loss, rank = loss_fn(step_key, graph, x_table, src, dst, False)
        with trace_span("forward"):
            grads = gradients(loss, state.params)
        with trace_span("update"):
            opt_state = adam_update(state.params, grads, state.opt_state,
                                    learning_rate)
        return (TrainState(state.params, opt_state, state.step + 1),
                loss.detach(), rank)

    @torch.no_grad()
    def eval_step(state: Optional[Union[TrainState, dict]],
                  key: torch.Tensor, graph: CscGraph, x_table: torch.Tensor,
                  src, dst) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(state, TrainState):
            own_params(model, state.params)
        elif state is not None:
            model.load_state_dict(state)
        return loss_fn(key, graph, x_table, src, dst, True)

    return LinkTrainer(init_fn, train_step, eval_step, negatives)
