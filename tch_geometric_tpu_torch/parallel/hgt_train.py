"""Heterogeneous training: HGT sampling -> relation-typed attention.

Counterpart of ``tch_geometric_tpu/parallel/hgt_train.py``'s single-device
trainer, ``make_hgt_trainer``.  Each step samples with
``_hgt_sampling_impl`` on the graphs' device, gathers every type's slot
features (clamped ids, zero rows where a slot is not valid), runs the
``HGT`` model, takes the mean cross entropy on the seed slots of its
``out_type`` output and one Adam step, under the ``trace_span``s
``sample``, ``gather``, ``forward`` (the forward, the loss and the
backward) and ``update``.  The partitioned trainer is not ported.
"""
from __future__ import annotations

from typing import (Callable, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import torch
from torch.nn import functional as nnf

from ..data.graph import CscGraph
from ..models.hgt import HGT
from ..sampling import rng
from ..sampling.hgt import HGTSample, _hgt_sampling_impl
from ..sampling.neighbor import _int32
from ..utils.adam import (AdamState, LearningRate, Params, adam_update,
                          gradients, init_state, own_params)
from ..utils.metrics import trace_span
from ..utils.types import EdgeType, rel_key

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
