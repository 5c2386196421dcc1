"""Sampled training and serving: sample -> gather -> tree forward -> Adam.

Counterpart of ``tch_geometric_tpu/parallel/train.py``: ``make_gnn_trainer``
(``init_fn``, ``train_step``, ``eval_step``, ``sample_and_gather``),
``make_sage_trainer`` and ``make_multibatch_sage_trainer``, with Adam equal
to ``optax.adam`` (``utils.adam.adam_update``).

The JAX step is one jitted program; here each phase is a sequence of torch
ops on the graph's device, wrapped in a ``trace_span`` of the JAX scope's
name: ``sample``, ``gather``, ``forward`` (the forward, the loss and the
backward) and ``update``.  A ``TrainState``'s ``step`` is a host int, so the
step key ``rng.fold(key, step)`` needs no device sync, and the step returns
its loss and accuracy as device tensors.
"""
from __future__ import annotations

from typing import (Callable, Mapping, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch
from torch.nn import functional as nnf

from ..data.graph import CscGraph
from ..sampling import rng
from ..sampling.neighbor import NeighborSample, _sample_neighbors_impl
from ..utils.adam import (AdamState, LearningRate, Params, adam_update,
                          gradients, init_state, own_params)
from ..utils.adam import adam_init  # noqa: F401  (importable from here too)
from ..utils.metrics import trace_span


class TrainState(NamedTuple):
    """``params``: the model's own parameters, keyed as its
    ``named_parameters()``, which ``train_step`` updates in place (two
    independent runs need two models, e.g. ``copy.deepcopy`` of the model
    and a trainer for each).  ``opt_state``: an :class:`AdamState`.
    ``step``: a host int."""
    params: Params
    opt_state: AdamState
    step: int


class GnnTrainer(NamedTuple):
    """``[:3]`` is the JAX trainer's ``(init_fn, train_step, eval_step)``."""
    init_fn: Callable[..., TrainState]
    train_step: Callable[..., Tuple[TrainState, torch.Tensor, torch.Tensor]]
    eval_step: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    sample_and_gather: Callable[..., Tuple[NeighborSample, torch.Tensor]]


def _sample_and_gather(key: torch.Tensor, graph: CscGraph,
                       x_table: torch.Tensor, seeds, fanouts,
                       with_replacement: bool
                       ) -> Tuple[NeighborSample, torch.Tensor]:
    seeds = torch.as_tensor(seeds).to(graph.device).long()
    with trace_span("sample"):
        sample = _sample_neighbors_impl(key, graph, seeds,
                                        torch.zeros_like(seeds), fanouts,
                                        with_replacement)
    # invalid slots read node 0's row: every path from a non-seed slot to a
    # seed logit passes a child mask, so no seed logit depends on it
    with trace_span("gather"):
        x = x_table[sample.nodes.clamp(0, x_table.shape[0] - 1)]
    return sample, x


def _init_fn(model):
    def init_fn(*_) -> TrainState:
        """The model's own parameters (drawn from its ``generator`` at
        construction) and a fresh Adam state at step 0.  Takes the JAX
        ``init_fn``'s ``(key, graph, x_table, seeds)`` and needs none of
        them."""
        return init_state(model, TrainState)
    return init_fn


def _loss_step(model, params: Params, key: torch.Tensor,
               sample: NeighborSample, x: torch.Tensor, labels,
               learning_rate: LearningRate, opt_state: AdamState):
    """Forward with dropout keyed by ``fold(key, DROPOUT_STREAM)``, mean
    cross entropy, backward, one Adam update of ``params`` in place.
    Returns ``(opt_state, loss, acc)``."""
    with trace_span("forward"):
        logits = model.tree_forward(
            sample, x, deterministic=False,
            dropout_key=rng.fold(key, rng.DROPOUT_STREAM))
        labels = torch.as_tensor(labels).to(logits.device).long()
        loss = nnf.cross_entropy(logits, labels)
        grads = gradients(loss, params)
    with trace_span("update"):
        opt_state = adam_update(params, grads, opt_state, learning_rate)
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    return opt_state, loss.detach(), acc


def make_gnn_trainer(model, fanouts: Sequence[int], *,
                     learning_rate: LearningRate = 1e-2,
                     with_replacement: bool = False) -> GnnTrainer:
    """Build the sampled-training closures for a model with
    ``tree_forward(sample, x, deterministic=..., dropout_key=...)``
    (``GraphSAGE``, ``GCN``, ``GAT``, ``GIN``).

    ``init_fn(key, graph, x_table, seeds) -> TrainState`` (see
    :func:`_init_fn`).

    ``train_step(state, key, graph, x_table, seeds, labels) -> (state,
    loss, acc)``: step key ``fold(key, state.step)``, dropout on, mean cross
    entropy, one Adam update.  It updates ``state.params``, the model's
    parameters, in place and returns a new state at ``step + 1``.

    ``eval_step(state, key, graph, x_table, seeds, labels) -> (loss,
    acc)`` with dropout off; ``state`` is a ``TrainState`` of the model, a
    state dict (loaded into the model) or None (the model as it is).

    ``sample_and_gather(key, graph, x_table, seeds) -> (sample, x)`` draws
    the padded tree of the seeds and gathers its slot features.
    """
    fanouts = tuple(int(k) for k in fanouts)

    def sample_and_gather(key, graph, x_table, seeds):
        return _sample_and_gather(key, graph, x_table, seeds, fanouts,
                                  with_replacement)

    def train_step(state: TrainState, key: torch.Tensor, graph: CscGraph,
                   x_table: torch.Tensor, seeds, labels
                   ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
        own_params(model, state.params)
        step_key = rng.fold(key, state.step)
        sample, x = sample_and_gather(step_key, graph, x_table, seeds)
        opt_state, loss, acc = _loss_step(model, state.params, step_key,
                                          sample, x, labels, learning_rate,
                                          state.opt_state)
        return TrainState(state.params, opt_state, state.step + 1), loss, acc

    @torch.no_grad()
    def eval_step(state: Optional[Union[TrainState, Mapping[str,
                                                             torch.Tensor]]],
                  key: torch.Tensor, graph: CscGraph, x_table: torch.Tensor,
                  seeds, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        if isinstance(state, TrainState):
            own_params(model, state.params)
        elif state is not None:
            model.load_state_dict(state)
        sample, x = sample_and_gather(key, graph, x_table, seeds)
        with trace_span("forward"):
            logits = model.tree_forward(sample, x)
            labels = torch.as_tensor(labels).to(logits.device).long()
            loss = nnf.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc

    return GnnTrainer(_init_fn(model), train_step, eval_step,
                      sample_and_gather)


def make_sage_trainer(model, fanouts: Sequence[int], **kw) -> GnnTrainer:
    """Alias of :func:`make_gnn_trainer` (the JAX package's original
    name)."""
    return make_gnn_trainer(model, fanouts, **kw)


class MultibatchTrainer(NamedTuple):
    """The JAX multibatch trainer's ``(init_fn, train_step)``."""
    init_fn: Callable[..., TrainState]
    train_step: Callable[..., Tuple[TrainState, torch.Tensor, torch.Tensor]]


def make_multibatch_sage_trainer(model, fanouts: Sequence[int], *,
                                 learning_rate: LearningRate = 1e-2,
                                 with_replacement: bool = False
                                 ) -> MultibatchTrainer:
    """Sampled-SAGE trainer that takes M minibatches per call.

    ``train_step(state, key, graph, x_table, seeds (M, B), labels (M, B))
    -> (state, losses (M,), accs (M,))``: batch i is sampled with key
    ``fold(key, step + i)`` (the key of the single-batch trainer's step
    ``step + i``); the M trees' slot features are read in one gather of
    ``M * n_total`` rows, then M forward/backward/Adam updates run in
    turn, so the trajectory is that of M single-batch steps.  The M
    samplers run one after another.  Updates ``state.params`` in place.
    """
    fanouts = tuple(int(k) for k in fanouts)

    def train_step(state: TrainState, key: torch.Tensor, graph: CscGraph,
                   x_table: torch.Tensor, seeds, labels
                   ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
        own_params(model, state.params)
        seeds = torch.as_tensor(seeds).to(graph.device).long()
        M = seeds.shape[0]
        keys = [rng.fold(key, state.step + i) for i in range(M)]
        with trace_span("sample"):
            samples = [_sample_neighbors_impl(
                keys[i], graph, seeds[i], torch.zeros_like(seeds[i]),
                fanouts, with_replacement) for i in range(M)]
        with trace_span("gather"):
            nodes = torch.stack([s.nodes for s in samples])
            xg = x_table[nodes.clamp(0, x_table.shape[0] - 1)]
        labels = torch.as_tensor(labels)
        opt_state, losses, accs = state.opt_state, [], []
        for i in range(M):
            opt_state, loss, acc = _loss_step(model, state.params, keys[i],
                                              samples[i], xg[i], labels[i],
                                              learning_rate, opt_state)
            losses.append(loss)
            accs.append(acc)
        return (TrainState(state.params, opt_state, state.step + M),
                torch.stack(losses), torch.stack(accs))

    return MultibatchTrainer(_init_fn(model), train_step)
