"""Sampled training with the feature table sharded across the mesh.

Counterpart of ``tch_geometric_tpu/parallel/sharded_features.py``.  The
feature table is the big array (ogbn-products at F=1024 f32 is ~10 GB),
topology comparatively small.  Node features live interleaved across the
mesh ``axis`` (the owner of node ``i`` is ``i % P``: interleaving spreads
power-law hubs evenly, unlike blocks), each rank samples its own seed
shard with counter-based keys, and the tree's feature fetch is a
two-``all_to_all`` exchange: requests route to owners, owners gather
locally, rows route back.

Static shapes: the per-owner request capacity is ``capacity_factor *
ceil(L / P)``; requests past it get zero rows and are counted in the
returned overflow (``num_rounds > 1`` retries them first).

``axis`` may be one axis, or a tuple of axes, of a larger mesh: P
(``num_parts``) is then that axis' size, the exchanges span the caller's
group along it, and the table is interleaved over that group's ranks.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as nnf

from ..sampling import rng
from ..sampling.neighbor import _sample_neighbors_impl
from ..utils.adam import (LearningRate, Params, adam_update,
                          gradients, init_state, own_params)
from .mesh import (Axes, Mesh, ProcessGroupComm, all_to_all, any_rank,
                   axis_index, current_mesh, pmean, psum, spmd)
from .multihost import placed
from .train import TrainState


def build_interleaved_features(x, num_parts: int):
    """Rearrange (N, F) so shard p (rows ``[p*Np, (p+1)*Np)``) holds nodes
    p, p+P, p+2P, ...; numpy in, numpy out, a tensor in, a tensor out (on
    its device)."""
    n, f = x.shape
    npp = -(-n // num_parts)
    pad = npp * num_parts - n
    if torch.is_tensor(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad, f))])
        return x.reshape(npp, num_parts, f).transpose(0, 1).reshape(-1, f) \
            .contiguous()
    if pad:
        x = np.concatenate([x, np.zeros((pad, f), x.dtype)])
    return np.ascontiguousarray(
        x.reshape(npp, num_parts, f).transpose(1, 0, 2).reshape(-1, f))


def halo_gather(x_shard: torch.Tensor, ids: torch.Tensor, *, axis: Axes,
                num_parts: int, capacity: int, valid=None,
                num_rounds: int = 1):
    """Fetch rows of the interleave-sharded table (inside ``spmd``).

    ``x_shard`` (Np, F) this rank's shard, ``ids`` (L,) global node ids,
    ``valid`` optional (L,) bool: invalid slots take no request capacity,
    get zero rows and are not counted as overflow.  ``num_rounds > 1``
    retries requests whose per-owner rank passed ``capacity`` (round r
    carries ranks ``[r*capacity, (r+1)*capacity)``).  Returns ((L, F) rows,
    overflow count)."""
    owner = ids % num_parts
    local = torch.div(ids, num_parts, rounding_mode="floor")
    if valid is None:
        valid = torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
    return routed_row_fetch(x_shard, owner, local, valid, axis=axis,
                            num_parts=num_parts, capacity=capacity,
                            num_rounds=num_rounds)


def routed_row_fetch(table: torch.Tensor, owner, local, valid, *, axis: Axes,
                     num_parts: int, capacity: int, num_rounds: int = 1):
    """Owner-routed row fetch with explicit (owner, local) addressing
    (inside ``spmd``): requests route to ``owner``, owners read
    ``table[local]`` from their own table, rows route back.  Returns ((L,
    F) rows, overflow count of the valid requests no round carried).  A
    round after the first runs only if some rank still has a request."""
    from .dist_sampling import _route_to_owners
    L = owner.shape[0]
    router = _route_to_owners(owner, valid, num_parts, capacity)
    rounds = (num_rounds if router.max_rounds is None
              else min(num_rounds, router.max_rounds))
    out = torch.zeros((L, table.shape[-1]), dtype=table.dtype,
                      device=table.device)
    got = torch.zeros((L,), dtype=torch.bool, device=table.device)
    local = local.to(torch.int32)
    for rnd in range(rounds):
        if rnd and not any_rank((valid & ~got).sum()):
            break               # no rank has a request left to carry
        in_round = router.in_round(rnd)
        req = router.scatter(local, rnd)                  # (P, C)
        peer_req = all_to_all(req, axis)                  # (P, C) of me
        rows = table[peer_req.long().clamp(0, table.shape[0] - 1)]
        back = all_to_all(rows, axis)                     # (P, C, F) mine
        out = torch.where(in_round[:, None], router.pickup(back, rnd), out)
        got = got | in_round
    return out, (~got & valid).sum()


def feature_capacity(capacity_factor: float, L: int, num_parts: int) -> int:
    """The feature fetch's per-owner capacity, ``ceil(cf * L / P)``
    clamped to ``L`` (python floats, as the JAX package computes it)."""
    return min(int(math.ceil(capacity_factor * L / num_parts)), L)


# ---------------------------------------------------------------------------
# The trainers' shared step
# ---------------------------------------------------------------------------

def pmean_tree(tree: Dict[str, torch.Tensor], axis: Axes
               ) -> Dict[str, torch.Tensor]:
    """``pmean`` of every tensor of ``tree``, one collective per dtype."""
    out = {}
    by_dtype: Dict[torch.dtype, list] = {}
    for k, v in tree.items():
        by_dtype.setdefault(v.dtype, []).append(k)
    for keys in by_dtype.values():
        flat = pmean(torch.cat([tree[k].reshape(-1) for k in keys]), axis)
        for k, part in zip(keys, torch.split(
                flat, [tree[k].numel() for k in keys])):
            out[k] = part.reshape(tree[k].shape)
    return out


def replica_adam(params: Params, grads: Params, holder: dict,
                 learning_rate: LearningRate) -> None:
    """Take one Adam step of the replica's parameters (in place) with
    ``grads``, once per replica: every process of a group, one thread of
    a thread mesh (all its ranks share the parameters, whatever axes the
    gradients were reduced over); ``holder['opt']`` carries the Adam
    state."""
    def update():
        holder["opt"] = adam_update(params, grads, holder["opt"],
                                    learning_rate)

    current_mesh().comm.update_replica(update)


def replica_update(params: Params, grads: Params, holder: dict,
                   learning_rate: LearningRate, axis: Axes) -> None:
    """Average ``grads`` over ``axis``, then :func:`replica_adam`."""
    replica_adam(params, pmean_tree(grads, axis), holder, learning_rate)


def loss_and_acc(logits: torch.Tensor, labels: torch.Tensor):
    labels = labels.to(logits.device).long()
    loss = nnf.cross_entropy(logits, labels)
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    return loss, acc


def replicate_params(mesh: Mesh, model) -> None:
    """Make every process's parameters rank 0's (JAX's ``pmean`` of the
    initial parameters makes the replication explicit); a thread mesh
    shares one model."""
    comm = mesh.comm
    if isinstance(comm, ProcessGroupComm) and comm.size > 1:
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(comm.all_gather(p.detach())[0])


def replica_init_fn(mesh: Mesh, model):
    def init_fn(*_) -> TrainState:
        """The model's own parameters, made equal across processes, and a
        fresh Adam state at step 0; takes the JAX ``init_fn``'s arguments
        and needs none of them."""
        replicate_params(mesh, model)
        return init_state(model, TrainState)
    return init_fn


class DistTrainer(NamedTuple):
    """The JAX trainer's ``(init_fn, train_step, eval_step)``."""
    init_fn: Callable[..., TrainState]
    train_step: Callable
    eval_step: Callable


def make_sharded_feature_trainer(
    model,
    fanouts: Sequence[int],
    mesh: Mesh,
    *,
    axis: str = "data",
    learning_rate: LearningRate = 1e-2,
    with_replacement: bool = False,
    window: int = 256,
    capacity_factor: float = 1.3,
    num_rounds: Optional[int] = None,
) -> DistTrainer:
    """Sampled-training closures where ``x`` is interleave-sharded over
    ``mesh[axis]`` and the seed and label batches over the same axis; the
    adjacency (a ``CscGraph`` on the mesh's device) is replicated.

    ``init_fn(key, graph, x_sharded, seeds) -> TrainState``: the model's own
    parameters (made equal across processes) and a fresh Adam state.
    ``train_step(state, key, graph, x_sharded, seeds, labels) -> (state,
    loss, acc, halo_overflow)``: each rank samples with ``fold(key, step,
    rank)``, the gradients, loss and accuracy are averaged and the overflow
    summed over ``axis``; one Adam update of the model's parameters in
    place.  ``eval_step(state, key, graph, x_sharded, seeds, labels) ->
    (loss, acc)`` with dropout off and key ``fold(key, 2**20, rank)``."""
    from .dist_sampling import resolve_num_rounds
    fanouts = tuple(int(k) for k in fanouts)
    num_parts = mesh.axis_size(axis)
    num_rounds = resolve_num_rounds(num_rounds, num_parts)

    def sample_gather(key, graph, x_shard, seeds_local):
        seeds_local = seeds_local.long()
        sample = _sample_neighbors_impl(
            key, graph, seeds_local,
            torch.zeros(seeds_local.shape, dtype=torch.int32,
                        device=seeds_local.device),
            fanouts, with_replacement, window=window)
        n_rows = x_shard.shape[0] * num_parts
        ids = sample.nodes.clamp(0, n_rows - 1)
        x, overflow = halo_gather(
            x_shard, ids, axis=axis, num_parts=num_parts,
            capacity=feature_capacity(capacity_factor, ids.shape[0],
                                      num_parts),
            valid=sample.node_valid, num_rounds=num_rounds)
        return sample, x, overflow

    def logits_of(key, graph, x_shard, seeds_local, deterministic):
        sample, x, overflow = sample_gather(key, graph, x_shard, seeds_local)
        logits = model.tree_forward(
            sample, x, deterministic=deterministic,
            dropout_key=rng.fold(key, rng.DROPOUT_STREAM))
        return logits, overflow

    def train_step(state: TrainState, key, graph, x_sharded, seeds, labels):
        own_params(model, state.params)
        holder = {"opt": state.opt_state}

        def body(x_shard, seeds_local, labels_local, graph):
            k = rng.fold(key, state.step, axis_index(axis))
            logits, overflow = logits_of(k, graph, x_shard, seeds_local,
                                         False)
            loss, acc = loss_and_acc(logits, labels_local)
            grads = gradients(loss, state.params)
            replica_update(state.params, grads, holder, learning_rate, axis)
            return (pmean(loss.detach(), axis), pmean(acc, axis),
                    psum(overflow, axis))

        loss, acc, overflow = spmd(mesh, body, *(
            placed(v, mesh, (axis,)) for v in (x_sharded, seeds, labels)),
            graph=graph)
        return (TrainState(state.params, holder["opt"], state.step + 1),
                loss[0], acc[0], overflow[0])

    @torch.no_grad()
    def eval_step(state, key, graph, x_sharded, seeds, labels):
        if isinstance(state, TrainState):
            own_params(model, state.params)

        def body(x_shard, seeds_local, labels_local, graph):
            k = rng.fold(key, 1 << 20, axis_index(axis))
            logits, _ = logits_of(k, graph, x_shard, seeds_local, True)
            loss, acc = loss_and_acc(logits, labels_local)
            return pmean(loss, axis), pmean(acc, axis)

        loss, acc = spmd(mesh, body, *(
            placed(v, mesh, (axis,)) for v in (x_sharded, seeds, labels)),
            graph=graph)
        return loss[0], acc[0]

    return DistTrainer(replica_init_fn(mesh, model), train_step, eval_step)
