"""Link-prediction training with negative sampling on the device.

Counterpart of ``tch_geometric_tpu/parallel/link_train.py``.

``make_link_trainer`` (one device): sample trees for the batch edges'
endpoints and their negatives in one sampler call, encode them with any
``tree_forward`` model, score positives ``<h_u, h_v>`` and corrupt
destinations, binary cross entropy on the positives and the accepted
negatives.  The sampler needs the CSC (rows are in-neighbors), so the
probe of a corrupt edge ``src -> cand`` searches cand's CSC row for src,
``has_edge(cand, src)``.  A candidate is rejected if it is an edge or
equals either endpoint.

``make_partitioned_link_trainer``: the same step over a partitioned
graph, adjacency and features sharded.  The negatives are drawn and
probed through the owner-routed exchange (``dist_negative``), the trees
of src, dst and the negatives are sampled by three distributed sampler
calls, each keyed by its own segment's uids, the features fetched by the
owner-routed gather.  The loss is a global masked mean (numerator and
denominator ``psum``'d) plus the ``pmean`` of the positives' loss, and
each step takes the gradient of that global loss, as ``shard_map``
differentiates it, then one Adam step per replica.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.nn import functional as nnf

from ..data.graph import CscGraph
from ..sampling import rng
from ..sampling.neighbor import _sample_neighbors_impl
from ..utils.adam import (LearningRate, adam_update, gradients, init_state,
                          own_params)
from ..utils.metrics import step_span, trace_span
from .dist_negative import _dist_negative_device
from .dist_sampling import (_check_graph, _dist_sample_device, _fetch,
                            _filter_static, _plan, resolve_num_rounds)
from .mesh import Mesh, axis_index, pmean, psum, spmd
from .multihost import placed
from .sharded_features import DistTrainer, replica_init_fn, replica_update
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

    @step_span
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


def make_partitioned_link_trainer(model, fanouts: Sequence[int], mesh: Mesh,
                                  *, axis: str = "data", num_neg: int = 1,
                                  try_count: int = 8,
                                  learning_rate: LearningRate = 1e-3,
                                  weighted: bool = False,
                                  filter: Optional[tuple] = None,
                                  window: int = 256,
                                  capacity_factor: float = 1.3,
                                  num_rounds: Optional[int] = None
                                  ) -> DistTrainer:
    """Link prediction over a partitioned graph (module doc).

    ``graph``: a :class:`~.dist_sampling.PartitionedGraph` of the **CSR**
    (rows are out-neighbors, the probe's direction); ``x_sharded`` the
    interleaved features (``build_interleaved_features``); ``src``, ``dst``
    and the optional ``edge_ts`` (B,) split over ``axis``.

    ``init_fn(key, graph, x_sharded, src, dst, edge_ts=None)``: the model's
    own parameters (made equal across processes) and a fresh Adam state.
    ``train_step(state, key, graph, x_sharded, src, dst, edge_ts=None) ->
    (state, loss, overflow)``: step key ``k = fold(key, step)``; negatives
    ``fold(k, 3)``, each the first of ``try_count`` candidates that is no
    edge from src and neither endpoint; the trees of src, dst and the
    negatives ``fold(k, 4)``, ``fold(k, 5)``, ``fold(k, 6)``, dropout keyed
    ``fold(segment key, DROPOUT_STREAM)``; ``overflow`` the (negative,
    sampling and feature) requests no round carried, summed over ranks.
    ``eval_step(...) -> (loss, rank)`` with dropout off and ``k = fold(key,
    2**20)``; ``rank`` the share of accepted negatives scoring below their
    positive.  ``weighted`` and ``filter=((lo, hi), forward, mode)`` as in
    :func:`~.dist_sampling.make_partitioned_trainer`; ``edge_ts`` seeds the
    root state of all three segments."""
    fanouts = tuple(int(k) for k in fanouts)
    plan = _plan(mesh, axis, None)
    Pn = plan.num_parts
    num_rounds = resolve_num_rounds(num_rounds, Pn)
    filter_static = None if filter is None else _filter_static(filter)

    def encode(key, gshard, x_shard, seeds_local, seed_state,
               deterministic):
        sample, s_ovf = _dist_sample_device(
            key, gshard, seeds_local, dev=axis_index(axis), fanouts=fanouts,
            axis=axis, num_parts=Pn, total_seeds=seeds_local.shape[0] * Pn,
            capacity_factor=capacity_factor, with_replacement=False,
            weighted=weighted, filter_static=filter_static,
            seed_state=seed_state, window=window, num_rounds=num_rounds)
        x, f_ovf = _fetch(x_shard, sample, plan,
                          capacity_factor=capacity_factor,
                          num_rounds=num_rounds, exchange_dtype=None)
        h = model.tree_forward(sample, x, deterministic=deterministic,
                               dropout_key=rng.fold(key,
                                                    rng.DROPOUT_STREAM))
        return h, s_ovf + f_ovf

    def loss_terms(key, gshard, x_shard, src, dst, ts, deterministic):
        """This rank's share of the global loss, whose gradients summed
        over ranks are the global loss's, and the loss, rank and overflow
        (all reduced over ``axis``)."""
        L = src.shape[0]
        neg, neg_ok, n_ovf = _dist_negative_device(
            rng.fold(key, 3), gshard, src, dev=axis_index(axis),
            num_neg=num_neg, try_count=try_count, inbound=False, axis=axis,
            num_parts=Pn, capacity_factor=capacity_factor,
            num_rounds=num_rounds, exclude=dst)
        h_src, o1 = encode(rng.fold(key, 4), gshard, x_shard, src, ts,
                           deterministic)
        h_dst, o2 = encode(rng.fold(key, 5), gshard, x_shard, dst, ts,
                           deterministic)
        neg_ts = ts[:, None].expand(L, num_neg).reshape(-1)
        h_neg, o3 = encode(rng.fold(key, 6), gshard, x_shard,
                           neg.reshape(-1), neg_ts, deterministic)
        h_neg = h_neg.reshape(L, num_neg, -1)
        pos = (h_src * h_dst).sum(-1)
        negs = (h_src[:, None, :] * h_neg).sum(-1)
        pos_loss = _sigmoid_bce(pos, 1.0).mean()
        num = (_sigmoid_bce(negs, 0.0) * neg_ok).sum()
        den = psum(neg_ok.sum(), axis).clamp(min=1)
        value = (pmean(pos_loss.detach(), axis)
                 + psum(num.detach(), axis) / den)
        rank = psum(((pos[:, None] > negs) * neg_ok).sum(), axis) / den
        # d value / d params = sum over ranks of d share / d params: the
        # pmean of P times the share
        share = pos_loss + num * (Pn / den)
        return share, value, rank.detach(), n_ovf + o1 + o2 + o3

    def arguments(graph, x_sharded, src, dst, edge_ts):
        _check_graph(graph, Pn, weighted, filter_static is not None)
        if edge_ts is None:
            edge_ts = torch.zeros(np.shape(src), dtype=torch.int32)
        on = (axis,)
        as_int = lambda a: torch.as_tensor(   # noqa: E731
            a if torch.is_tensor(a) else np.asarray(a)).to(torch.int32)
        return ([placed(graph, mesh, on), placed(x_sharded, mesh, on)]
                + [placed(as_int(v), mesh, on) for v in (src, dst, edge_ts)])

    def train_step(state: TrainState, key, graph, x_sharded, src, dst,
                   edge_ts=None):
        own_params(model, state.params)
        step_key = rng.fold(key, state.step)
        holder = {"opt": state.opt_state}

        def body(gshard, x_shard, src_l, dst_l, ts_l):
            share, value, _rank, overflow = loss_terms(
                step_key, gshard, x_shard, src_l, dst_l, ts_l, False)
            grads = gradients(share, state.params)
            replica_update(state.params, grads, holder, learning_rate, axis)
            return value, psum(overflow, axis)

        loss, overflow = spmd(mesh, body, *arguments(graph, x_sharded, src,
                                                     dst, edge_ts))
        return (TrainState(state.params, holder["opt"], state.step + 1),
                loss[0], overflow[0])

    @torch.no_grad()
    def eval_step(state, key, graph, x_sharded, src, dst, edge_ts=None):
        if isinstance(state, TrainState):
            own_params(model, state.params)
        k = rng.fold(key, 1 << 20)

        def body(gshard, x_shard, src_l, dst_l, ts_l):
            _share, value, rank, _ovf = loss_terms(
                k, gshard, x_shard, src_l, dst_l, ts_l, True)
            return value, rank

        loss, rank = spmd(mesh, body, *arguments(graph, x_sharded, src, dst,
                                                 edge_ts))
        return loss[0], rank[0]

    return DistTrainer(replica_init_fn(mesh, model), train_step, eval_step)
