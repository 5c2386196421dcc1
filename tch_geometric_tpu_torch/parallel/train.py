"""Sampled serving step: sample -> gather -> tree forward.

Counterpart of the serving half of
``tch_geometric_tpu/parallel/train.py::make_gnn_trainer``: ``sample_and_gather``
and ``eval_step``.  The training half (``train_step`` with Adam, and the
multi-batch trainer) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.nn import functional as nnf

from ..data.graph import CscGraph
from ..sampling.neighbor import NeighborSample, _sample_neighbors_impl


class GnnTrainer(NamedTuple):
    sample_and_gather: Callable[..., Tuple[NeighborSample, torch.Tensor]]
    eval_step: Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def make_gnn_trainer(model, fanouts: Sequence[int], *,
                     with_replacement: bool = False) -> GnnTrainer:
    """Build the serving closures for a model with ``tree_forward``.

    ``sample_and_gather(key, graph, x_table, seeds) -> (sample, x)``
    draws the padded tree of the seeds and gathers its slot features;
    invalid slots read node 0's row, which no seed logit depends on.

    ``eval_step(params, key, graph, x_table, seeds, labels) -> (loss,
    acc)`` loads ``params`` (a state dict, or None to keep the model's
    own) and returns the mean cross entropy and accuracy on the seeds.
    """
    fanouts = tuple(int(k) for k in fanouts)

    def sample_and_gather(key: torch.Tensor, graph: CscGraph,
                          x_table: torch.Tensor, seeds
                          ) -> Tuple[NeighborSample, torch.Tensor]:
        seeds = torch.as_tensor(seeds).to(graph.device).long()
        zeros = torch.zeros_like(seeds)
        sample = _sample_neighbors_impl(key, graph, seeds, zeros, fanouts,
                                        with_replacement)
        x = x_table[sample.nodes.clamp(0, x_table.shape[0] - 1)]
        return sample, x

    @torch.no_grad()
    def eval_step(params: Optional[Mapping[str, torch.Tensor]],
                  key: torch.Tensor, graph: CscGraph, x_table: torch.Tensor,
                  seeds, labels) -> Tuple[torch.Tensor, torch.Tensor]:
        if params is not None:
            model.load_state_dict(params)
        sample, x = sample_and_gather(key, graph, x_table, seeds)
        logits = model.tree_forward(sample, x)
        labels = torch.as_tensor(labels).to(logits.device).long()
        loss = nnf.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc

    return GnnTrainer(sample_and_gather, eval_step)
