"""Node2Vec skip-gram embeddings trained from random walks on the device.

Counterpart of ``tch_geometric_tpu/models/node2vec.py``: the biased walk
(``sampling.walks``) and the skip-gram negative-sampling loss in one
train step.  The embedding is a dense ``nn.Embedding`` initialised as
flax's ``nn.Embed`` (N(0, 1/D), from an explicit CPU ``torch.Generator``),
and Adam updates the whole table every step, as ``optax.adam`` does: every
row's moments decay, whether or not the step's walks reached it.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as nnf

from ..data.graph import CsrGraph
from ..sampling import rng
from ..sampling.walks import _random_walk_impl
from ..utils.adam import (AdamState, Params, adam_update, gradients,
                          init_state, own_params)
from ..utils.metrics import step_span, trace_span


class Node2Vec(nn.Module):
    """Embedding table and the skip-gram objective over walk windows."""

    def __init__(self, num_nodes: int, embedding_dim: int,
                 context_size: int, num_negative: int = 1, *,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        super().__init__()
        self.num_nodes, self.embedding_dim = num_nodes, embedding_dim
        self.context_size, self.num_negative = context_size, num_negative
        self.embedding = nn.Embedding(num_nodes, embedding_dim,
                                      device="meta")
        self.to_empty(device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """N(0, 1/embedding_dim), drawn on the CPU, then copied to the
        table's device."""
        w = torch.empty(self.embedding.weight.shape)
        self.embedding.weight.copy_(w.normal_(
            0.0, 1.0 / math.sqrt(self.embedding_dim), generator=generator))

    def loss(self, walks: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
        """walks: (B, L) node ids, -1 after a dead end; neg: (B, W,
        num_negative), W = L - context_size + 1 windows a walk.  The mean
        of -log sigmoid over the valid (target, context) pairs plus the mean
        of -log sigmoid(-.) over the valid (target, negative) pairs."""
        emb = self.embedding
        L, C = walks.shape[1], self.context_size
        W = L - C + 1
        at = (torch.arange(W, device=walks.device)[:, None]
              + torch.arange(C, device=walks.device)[None, :])
        win = walks[:, at]                                      # (B, W, C)
        target, context = win[:, :, 0], win[:, :, 1:]
        valid = (target[..., None] >= 0) & (context >= 0)
        t_emb = emb(target.clamp(min=0))                        # (B, W, D)
        c_emb = emb(context.clamp(min=0))                    # (B, W, C-1, D)
        pos = -nnf.logsigmoid((t_emb[:, :, None, :] * c_emb).sum(-1))
        pos = torch.where(valid, pos, 0.0).sum() / valid.sum().clamp(min=1)
        n_emb = emb(neg.clamp(min=0))                           # (B, W, K, D)
        nvalid = (target[..., None] >= 0) & (neg >= 0)
        negl = -nnf.logsigmoid(-(t_emb[:, :, None, :] * n_emb).sum(-1))
        negl = (torch.where(nvalid, negl, 0.0).sum()
                / nvalid.sum().clamp(min=1))
        return pos + negl

    def forward(self, nodes: torch.Tensor) -> torch.Tensor:
        return self.embedding(nodes)


class N2VState(NamedTuple):
    """``params``: the model's own parameters (``train_step`` updates them
    in place); ``opt_state``: an ``AdamState``; ``step``: a host int."""
    params: Params
    opt_state: AdamState
    step: int


class Node2VecTrainer(NamedTuple):
    """The JAX trainer's ``(init_fn, train_step)``, and the walks and
    negatives of a step key."""
    init_fn: Callable[..., N2VState]
    train_step: Callable[..., Tuple[N2VState, torch.Tensor]]
    walks_and_negs: Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def make_node2vec_trainer(model: Node2Vec, graph: CsrGraph, *,
                          walk_length: int = 10, p: float = 1.0,
                          q: float = 1.0, learning_rate: float = 0.01,
                          num_trials: int = 16) -> Node2VecTrainer:
    """Node2vec training on ``graph`` (a CSR: rows are out-neighbors).

    ``train_step(state, key, starts) -> (state, loss)``: step key
    ``fold(key, state.step)``; walks ``_random_walk_impl(fold(step_key,
    0), graph, starts, walk_length, p, q, num_trials)`` (``num_trials``
    16 whatever p and q are, as in the JAX trainer); negatives
    ``randint(fold(step_key, 1), (B, W, num_negative), 0, num_nodes)``;
    the skip-gram loss, its gradient and one dense Adam step of the table
    in place.  ``init_fn(*_)`` takes the JAX ``init_fn``'s ``(key,
    starts)`` and needs neither: the model's own parameters and a fresh
    Adam state at step 0."""

    def walks_and_negs(key: torch.Tensor, starts
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        starts = torch.as_tensor(starts).to(graph.device).long()
        walks = _random_walk_impl(rng.fold(key, 0), graph, starts,
                                  int(walk_length), p, q, int(num_trials))
        B, L = walks.shape
        W = L - model.context_size + 1
        neg = rng.randint(rng.fold(key, 1), (B, W, model.num_negative), 0,
                          model.num_nodes, device=graph.device)
        return walks, neg

    def init_fn(*_) -> N2VState:
        return init_state(model, N2VState)

    @step_span
    def train_step(state: N2VState, key: torch.Tensor, starts
                   ) -> Tuple[N2VState, torch.Tensor]:
        own_params(model, state.params)
        step_key = rng.fold(key, state.step)
        with trace_span("sample"):
            walks, neg = walks_and_negs(step_key, starts)
        with trace_span("forward"):
            loss = model.loss(walks, neg)
            grads = gradients(loss, state.params)
        with trace_span("update"):
            opt_state = adam_update(state.params, grads, state.opt_state,
                                    learning_rate)
        return N2VState(state.params, opt_state, state.step + 1), \
            loss.detach()

    return Node2VecTrainer(init_fn, train_step, walks_and_negs)
