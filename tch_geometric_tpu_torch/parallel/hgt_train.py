"""Heterogeneous training: HGT sampling -> relation-typed attention.

Counterpart of ``tch_geometric_tpu/parallel/hgt_train.py``.

``make_hgt_trainer`` (one device): each step samples with
``_hgt_sampling_impl`` on the graphs' device, gathers every type's slot
features (clamped ids, zero rows where a slot is not valid), runs the
``HGT`` model, takes the mean cross entropy on the seed slots of its
``out_type`` output and one Adam step, under the ``trace_span``s
``sample``, ``gather``, ``forward`` (the forward, the loss and the
backward) and ``update``.

``make_partitioned_hgt_trainer``: nothing graph-sized is replicated.  Each
rank runs the distributed HGT sampler (``dist_hgt._dist_hgt_device``:
sharded fixed-point budgets, owner-routed updates, the distributed
score-squared top-k), fetches every type's slot features from the
interleave-sharded tables (one ``halo_gather`` a type), and runs the model
with ``psum_axis`` on its own block of destination slots; the gradients
are averaged over the axis and one Adam step updates the shared replica.
"""
from __future__ import annotations

from typing import (Callable, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch.nn import functional as nnf

from ..data.graph import CscGraph
from ..models.hgt import HGT
from ..sampling import rng
from ..sampling.hgt import HGTSample, _hgt_sampling_impl
from ..sampling.neighbor import _int32
from ..utils.adam import (AdamState, LearningRate, Params, adam_update,
                          gradients, init_state, own_params)
from ..utils.metrics import step_span, trace_span
from ..utils.types import NAN_TIMESTAMP, EdgeType, rel_key
from .dist_hgt import _as_int32, _dist_hgt_device, _hgt_meta
from .dist_sampling import resolve_num_rounds, sample_capacity
from .mesh import Mesh, axis_index, pmean, psum, spmd
from .multihost import placed
from .sharded_features import (DistTrainer, halo_gather, replica_update,
                               replicate_params)

Edges = Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


class HGTTrainState(NamedTuple):
    """``params``: the model's own parameters (``train_step`` updates them
    in place); ``opt_state``: an ``AdamState``; ``step``: a host int."""
    params: Params
    opt_state: AdamState
    step: int


class HGTTrainer(NamedTuple):
    """``[:2]`` is the JAX trainer's ``(init_fn, train_step)``."""
    init_fn: Callable[..., HGTTrainState]
    train_step: Callable[..., Tuple[HGTTrainState, torch.Tensor,
                                    torch.Tensor]]
    sample_and_gather: Callable[..., Tuple[HGTSample,
                                           Dict[str, torch.Tensor], Edges]]


def make_hgt_trainer(model: HGT, graphs: Mapping[str, CscGraph],
                     edge_types: Sequence[EdgeType],
                     num_samples: Mapping[str, Sequence[int]],
                     num_hops: int, node_counts: Mapping[str, int],
                     x_tables: Mapping[str, torch.Tensor], *,
                     seed_type: str, learning_rate: LearningRate = 1e-3,
                     edge_timestamps: Optional[Mapping[str, object]] = None,
                     timerange: Optional[Tuple[int, int]] = None
                     ) -> HGTTrainer:
    """HGT sampling inside the train step.

    ``train_step(state, key, seeds, labels) -> (state, loss, acc)``: step
    key ``fold(key, state.step)``; seeds are nodes of ``seed_type``; the
    loss is the mean cross entropy of the model's first ``len(seeds)``
    rows.  ``init_fn(*_)`` takes the JAX ``init_fn``'s ``(key, seeds)`` and
    needs neither.  ``sample_and_gather(key, seeds) -> (sample, feats,
    edges)``: the model's inputs of one key."""
    device = next(iter(graphs.values())).device
    node_types = tuple(sorted(node_counts))
    rel_specs = tuple(sorted((rel_key(e), e[0], e[2]) for e in edge_types))
    meta = (
        node_types,
        rel_specs,
        tuple((t, tuple(int(x) for x in num_samples[t])) for t in node_types),
        int(num_hops),
        None if timerange is None else (int(timerange[0]), int(timerange[1])),
        tuple((t, int(node_counts[t])) for t in node_types),
    )
    edge_ts = (None if edge_timestamps is None else
               {r: _int32(v, device) for r, v in edge_timestamps.items()})

    def sample_and_gather(key: torch.Tensor, seeds):
        seeds = torch.as_tensor(seeds).to(device).long()
        with trace_span("sample"):
            sample = _hgt_sampling_impl(key, graphs, edge_ts,
                                        {seed_type: seeds}, None, meta,
                                        device)
        with trace_span("gather"):
            feats = {}
            for t in node_types:
                nodes = sample.nodes[t].clamp(0, node_counts[t] - 1)
                feats[t] = torch.where(sample.node_valid[t][:, None],
                                       x_tables[t][nodes], 0.0)
        edges = {r: (sample.rows[r], sample.cols[r], sample.edge_valid[r])
                 for r in sample.rows}
        return sample, feats, edges

    def init_fn(*_) -> HGTTrainState:
        return init_state(model, HGTTrainState)

    @step_span
    def train_step(state: HGTTrainState, key: torch.Tensor, seeds, labels
                   ) -> Tuple[HGTTrainState, torch.Tensor, torch.Tensor]:
        own_params(model, state.params)
        step_key = rng.fold(key, state.step)
        _sample, feats, edges = sample_and_gather(step_key, seeds)
        with trace_span("forward"):
            logits = model(feats, edges)
            labels = torch.as_tensor(labels).to(logits.device).long()
            logits = logits[: labels.shape[0]]
            loss = nnf.cross_entropy(logits, labels)
            grads = gradients(loss, state.params)
        with trace_span("update"):
            opt_state = adam_update(state.params, grads, state.opt_state,
                                    learning_rate)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return (HGTTrainState(state.params, opt_state, state.step + 1),
                loss.detach(), acc)

    return HGTTrainer(init_fn, train_step, sample_and_gather)


def make_partitioned_hgt_trainer(model: HGT,
                                 edge_types: Sequence[EdgeType],
                                 num_samples: Mapping[str, Sequence[int]],
                                 num_hops: int,
                                 node_counts: Mapping[str, int], mesh: Mesh,
                                 *, seed_type: str, axis: str = "data",
                                 learning_rate: LearningRate = 1e-3,
                                 timerange: Optional[Tuple[int, int]] = None,
                                 capacity_factor: float = 2.0,
                                 num_rounds: Optional[int] = None,
                                 fused: bool = True) -> DistTrainer:
    """Typed training over the partition (module doc).

    ``rels``: a dict of :class:`~.dist_sampling.PartitionedGraph`
    (``build_partitioned_hetero``) or a :class:`~.dist_hgt.StackedRels`
    (``put_stacked_rels``; ``fused`` picks its engine: every relation in
    one exchange a phase, or one at a time); ``x_tables``: type ->
    interleaved features (``build_interleaved_features``), split over
    ``axis``; ``seeds (B,)`` global ids of ``seed_type``, B a multiple of
    P, and ``labels (B,)``, the same on every rank.

    ``init_fn(key, rels, x_tables, seeds, seed_ts=None)``: the model's own
    parameters (made equal across processes) and a fresh Adam state.
    ``train_step(state, key, rels, x_tables, seeds, labels, seed_ts=None)
    -> (state, loss, acc, overflow)``: sample with ``fold(key, step)``;
    the loss is the cross entropy over the seed slots that are valid;
    ``overflow`` the sampler's and the feature fetch's requests no round
    carried, summed over ranks.  ``eval_step(state, key, rels, x_tables,
    seeds, labels, seed_ts=None) -> (loss, acc)`` at ``fold(key, 2**20)``.
    """
    Pn = mesh.axis_size(axis)
    num_rounds = resolve_num_rounds(num_rounds, Pn)
    node_types = tuple(sorted(node_counts))
    rel_specs = tuple(sorted((rel_key(tuple(e)), e[0], e[2])
                             for e in edge_types))
    dist_model = model.clone(psum_axis=axis)
    on = (axis,)

    def sample_gather(key, rels_s, x_shards, seeds, seed_ts):
        B = seeds.shape[0]
        meta = _hgt_meta(node_types, rel_specs, num_samples, num_hops,
                         timerange, node_counts,
                         {t: B if t == seed_type else 0 for t in node_types},
                         capacity_factor, num_rounds, Pn)
        none = seeds.new_zeros((0,))
        with trace_span("sample"):
            (nodes, _nts, node_valid, rows, cols, _eptr, ev,
             overflow) = _dist_hgt_device(
                key, rels_s, {t: seeds if t == seed_type else none
                              for t in node_types},
                {t: seed_ts if t == seed_type else none
                 for t in node_types},
                dev=axis_index(axis), meta=meta, axis=axis, fused=fused)
        feats = {}
        with trace_span("gather"):
            for t in node_types:
                xs, L = x_shards[t], nodes[t].shape[0]
                if L == 0:
                    feats[t] = xs.new_zeros((0, xs.shape[1]))
                    continue
                x, o = halo_gather(
                    xs, nodes[t].clamp(0, xs.shape[0] * Pn - 1), axis=axis,
                    num_parts=Pn,
                    capacity=sample_capacity(capacity_factor, L, Pn),
                    valid=node_valid[t], num_rounds=num_rounds)
                feats[t] = torch.where(node_valid[t][:, None], x, 0.0)
                overflow = overflow + o
        edges = {r: (rows[r].long(), cols[r].long(), ev[r]) for r in rows}
        return feats, edges, node_valid, overflow

    def loss_terms(key, rels_s, x_shards, seeds, seed_ts, labels):
        """This rank's loss (the same on every rank), accuracy and
        overflow; the loss is the mean cross entropy of the valid seed
        slots."""
        feats, edges, node_valid, overflow = sample_gather(
            key, rels_s, x_shards, seeds, seed_ts)
        with trace_span("forward"):
            n = seeds.shape[0]
            logits = dist_model(feats, edges)[:n]
            ok = node_valid[seed_type][:n]
            den = ok.sum().clamp(min=1)
            ce = nnf.cross_entropy(logits, labels, reduction="none")
            loss = (ce * ok).sum() / den
        acc = ((logits.detach().argmax(-1) == labels) & ok).sum() / den
        return loss, acc, overflow

    def arguments(rels, x_tables, seeds, labels, seed_ts):
        seeds = _as_int32(seeds)
        seed_ts = (torch.full(seeds.shape, NAN_TIMESTAMP, dtype=torch.int32)
                   if seed_ts is None else _as_int32(seed_ts))
        labels = torch.as_tensor(labels if torch.is_tensor(labels)
                                 else np.asarray(labels)).long()
        dev = mesh.device
        return ((placed(rels, mesh, on), placed(x_tables, mesh, on)),
                dict(seeds=seeds.to(dev), labels=labels.to(dev),
                     seed_ts=seed_ts.to(dev)))

    def init_fn(*_) -> HGTTrainState:
        """The model's own parameters, made equal across processes, and a
        fresh Adam state; takes the JAX ``init_fn``'s arguments and needs
        none of them."""
        replicate_params(mesh, model)
        return init_state(model, HGTTrainState)

    @step_span
    def train_step(state: HGTTrainState, key: torch.Tensor, rels, x_tables,
                   seeds, labels, seed_ts=None):
        own_params(model, state.params)
        k = rng.fold(key, state.step)
        holder = {"opt": state.opt_state}

        def body(rels_s, x_shards, seeds, labels, seed_ts):
            loss, acc, overflow = loss_terms(k, rels_s, x_shards, seeds,
                                             seed_ts, labels)
            with trace_span("forward"):
                # JAX differentiates a loss that varies by rank under
                # shard_map (its mask is all-gathered), so the transpose of
                # each psum sums all P ranks' cotangents: its gradient is P
                # times the one-device gradient.  P times this rank's loss
                # gives the same gradient once averaged over the ranks.
                grads = gradients(Pn * loss, state.params)
            with trace_span("update"):
                replica_update(state.params, grads, holder, learning_rate,
                               axis)
            return (pmean(loss.detach(), axis), pmean(acc, axis),
                    psum(overflow, axis))

        args, kw = arguments(rels, x_tables, seeds, labels, seed_ts)
        loss, acc, overflow = spmd(mesh, body, *args, **kw)
        return (HGTTrainState(state.params, holder["opt"], state.step + 1),
                loss[0], acc[0], overflow[0])

    @torch.no_grad()
    def eval_step(state: HGTTrainState, key: torch.Tensor, rels, x_tables,
                  seeds, labels, seed_ts=None):
        own_params(model, state.params)
        k = rng.fold(key, 1 << 20)

        def body(rels_s, x_shards, seeds, labels, seed_ts):
            loss, acc, _ = loss_terms(k, rels_s, x_shards, seeds, seed_ts,
                                      labels)
            return pmean(loss, axis), pmean(acc, axis)

        args, kw = arguments(rels, x_tables, seeds, labels, seed_ts)
        loss, acc = spmd(mesh, body, *args, **kw)
        return loss[0], acc[0]

    return DistTrainer(init_fn, train_step, eval_step)
