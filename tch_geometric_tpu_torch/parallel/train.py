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

``mesh=`` stands in for the input shardings JAX's ``jit`` reads (seeds and
labels over ``data``, Dense kernels over ``model`` by
``param_sharding_rule``): on a ``('data', 'model')`` mesh the step runs
data- and tensor-parallel, and equals the one-device step.

* Data parallelism: data rank ``d`` takes seeds ``[d*B/D, (d+1)*B/D)`` and
  draws exactly the whole batch's draws for them (``seed_block``: block
  draws of the sampler and of dropout), gathers from the replicated
  ``x_table``, and loss, accuracy and gradients are ``pmean``'d over
  ``data``.
* Tensor parallelism: a 2-d parameter whose output dim divides the
  ``model`` axis is split there.  A split linear runs column-parallel, as
  Megatron-LM's (Shoeybi et al., 2019): identity forward and ``psum``
  backward on its input (:class:`_CopyToModel`), ``x @ W[:, cols]`` on
  the rank's columns, ``all_gather`` forward and "take my columns"
  backward on its output (:class:`_GatherColumns`), then the replicated
  bias.  Another split parameter (GAT's ``a_src``/``a_dst``) is gathered
  whole before use by the same ``all_gather`` and its gradient sliced back
  (the gradient of the whole is the same on every model rank).
  Everything after a gather, dropout included, is the same on every model
  rank.
"""
from __future__ import annotations

from typing import (Callable, Dict, Mapping, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import torch
from torch import nn
from torch.nn import functional as nnf

from ..data.graph import CscGraph
from ..models.gnn import PARAM_HOOKS, dense
from ..sampling import rng
from ..sampling.neighbor import NeighborSample, _sample_neighbors_impl
from ..utils.adam import (AdamState, LearningRate, Params, adam_update,
                          gradients, init_state, own_params)
from ..utils.adam import adam_init  # noqa: F401  (importable from here too)
from ..utils.metrics import step_span, trace_span
from .mesh import (Comm, Mesh, along, axis_comm, axis_index, current_mesh,
                   param_sharding_rule, pmean, spmd)
from .multihost import placed


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
                       with_replacement: bool, seed_block=None
                       ) -> Tuple[NeighborSample, torch.Tensor]:
    with trace_span("to_device"):
        seeds = torch.as_tensor(seeds).to(graph.device).long()
    with trace_span("sample"):
        sample = _sample_neighbors_impl(key, graph, seeds,
                                        torch.zeros_like(seeds), fanouts,
                                        with_replacement,
                                        seed_block=seed_block)
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
        with trace_span("to_device"):
            labels = torch.as_tensor(labels).to(logits.device).long()
        loss = nnf.cross_entropy(logits, labels)
        grads = gradients(loss, params)
    with trace_span("update"):
        opt_state = adam_update(params, grads, opt_state, learning_rate)
    acc = (logits.detach().argmax(-1) == labels).float().mean()
    return opt_state, loss.detach(), acc


# ---------------------------------------------------------------------------
# Data and tensor parallelism on a ('data', 'model') mesh
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward the ``psum`` of the input's gradient over
    the model group (Megatron-LM's ``f``).  ``comm`` is the group's
    communicator, taken when the forward runs."""

    @staticmethod
    def forward(ctx, x, comm: Comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous(), "sum"), None


class _GatherColumns(torch.autograd.Function):
    """``all_gather`` of the rank's slice over the model group along
    ``dim``, laid side by side in rank order; backward the rank's slice of
    the gradient (Megatron-LM's ``g`` on a linear's output columns)."""

    @staticmethod
    def forward(ctx, y, comm: Comm, dim: int):
        ctx.rank, ctx.n, ctx.dim = comm.rank(), y.shape[dim], dim
        return torch.cat(comm.all_gather(y.contiguous()).unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(),
                None, None)


def _split_dims(model, mesh: Mesh, params: Params) -> Dict[str, int]:
    """The dim each tensor-parallel parameter splits over ``model``, by
    ``param_sharding_rule``: an ``nn.Linear`` weight ``(out, in)`` is read
    as the flax kernel ``(in, out)`` it stands for and splits dim 0 (its
    output columns); another 2-d parameter splits its last dim."""
    linear = {id(m.weight) for m in model.modules()
              if isinstance(m, nn.Linear)}
    out = {}
    for k, p in params.items():
        is_lin = id(p) in linear
        rule = param_sharding_rule(k, p.T if is_lin else p, mesh)
        if rule.spec == (None, "model"):
            out[k] = 0 if is_lin else p.dim() - 1
    return out


class _RankParams:
    """One rank's parameters in a DP+TP step (inside ``spmd``): a split
    parameter's slice as a leaf of its own (a view of the parameter, so
    under a thread mesh all ranks' slices share the one replica), every
    other parameter as it is.  Entered, it sets this thread's model hooks
    so the forward computes with the slices."""

    def __init__(self, params: Params, dims: Dict[str, int]):
        self.comm = axis_comm("model")
        self.dims = dims
        m, M = self.comm.rank(), self.comm.size
        self.local: Params = {}
        for k, p in params.items():
            if k in dims:
                n = p.shape[dims[k]] // M
                p = p.detach().narrow(dims[k], m * n, n).requires_grad_()
            self.local[k] = p
        self._name = {id(params[k]): k for k in dims}

    def linear(self, lin: nn.Linear, x: torch.Tensor, dtype):
        k = self._name.get(id(lin.weight))
        if k is None:
            return dense(x, lin.weight, lin.bias, dtype)
        y = dense(_CopyToModel.apply(x, self.comm), self.local[k], None,
                  dtype)
        y = _GatherColumns.apply(y, self.comm, y.dim() - 1)
        return y if lin.bias is None else y + lin.bias.to(y.dtype)

    def whole(self, p: torch.Tensor) -> torch.Tensor:
        k = self._name.get(id(p))
        if k is None:
            return p
        return _GatherColumns.apply(self.local[k], self.comm, self.dims[k])

    def whole_grads(self, grads: Params) -> Params:
        """The split parameters' gradient slices gathered whole over
        ``model`` (one collective); the others as they are."""
        split = [k for k in grads if k in self.dims]
        if not split:
            return dict(grads)
        flat = self.comm.all_gather(torch.cat([grads[k].reshape(-1)
                                               for k in split]))
        out, at = dict(grads), 0
        for k in split:
            n = grads[k].numel()
            out[k] = torch.cat([part[at: at + n].reshape(grads[k].shape)
                                for part in flat.unbind(0)], dim=self.dims[k])
            at += n
        return out

    def __enter__(self):
        PARAM_HOOKS.linear, PARAM_HOOKS.whole = self.linear, self.whole
        return self

    def __exit__(self, *exc):
        PARAM_HOOKS.linear = PARAM_HOOKS.whole = None


def _check_dp_tp_mesh(mesh: Mesh) -> None:
    if set(mesh.axis_names) != {"data", "model"}:
        raise ValueError(f"a DP+TP trainer needs a ('data', 'model') mesh, "
                         f"not {mesh.axis_names}")


def _seed_block(seeds_local: torch.Tensor) -> Tuple[int, int]:
    """This data rank's ``(first seed, seed count)`` of the whole batch
    (inside ``spmd``)."""
    n = seeds_local.shape[0]
    return axis_index("data") * n, n * current_mesh().shape["data"]


def _dp_tp_update(model, params: Params, dims: Dict[str, int], key,
                  sample: NeighborSample, x: torch.Tensor, labels,
                  learning_rate: LearningRate, holder: dict):
    """One rank's forward, backward and update of a DP+TP step (inside
    ``spmd``): the rank's parameters, gradients ``pmean``'d over ``data``
    and gathered whole over ``model``, then one Adam step of the whole
    parameters, once per replica (every process; one thread of a thread
    mesh) — equal to each slice's step, Adam being elementwise.  Returns
    the loss and accuracy averaged over ``data``."""
    from .sharded_features import loss_and_acc, pmean_tree, replica_adam
    rank = _RankParams(params, dims)
    with trace_span("forward"), rank:
        logits = model.tree_forward(
            sample, x, deterministic=False,
            dropout_key=rng.fold(key, rng.DROPOUT_STREAM))
        loss, acc = loss_and_acc(logits, labels)
        grads = gradients(loss, rank.local)
    with trace_span("update"):
        replica_adam(params, rank.whole_grads(pmean_tree(grads, "data")),
                     holder, learning_rate)
    return pmean(loss.detach(), "data"), pmean(acc, "data")


def _mesh_trainer(model, fanouts, mesh: Mesh, learning_rate,
                  with_replacement) -> "GnnTrainer":
    """:func:`make_gnn_trainer`'s closures on a ``('data', 'model')``
    mesh."""
    from .sharded_features import loss_and_acc, replica_init_fn
    _check_dp_tp_mesh(mesh)
    on_data = ("data",)

    def sample_and_gather(key, graph, x_table, seeds):
        def body(seeds_local):
            return _sample_and_gather(key, graph, x_table, seeds_local,
                                      fanouts, with_replacement,
                                      _seed_block(seeds_local))

        return along(mesh, "data", spmd(mesh, body,
                                        placed(seeds, mesh, on_data)))

    @step_span
    def train_step(state: TrainState, key, graph, x_table, seeds, labels):
        own_params(model, state.params)
        step_key = rng.fold(key, state.step)
        dims = _split_dims(model, mesh, state.params)
        holder = {"opt": state.opt_state}

        def body(seeds_local, labels_local):
            sample, x = _sample_and_gather(
                step_key, graph, x_table, seeds_local, fanouts,
                with_replacement, _seed_block(seeds_local))
            return _dp_tp_update(model, state.params, dims, step_key, sample,
                                 x, labels_local, learning_rate, holder)

        loss, acc = spmd(mesh, body, placed(seeds, mesh, on_data),
                         placed(labels, mesh, on_data))
        return (TrainState(state.params, holder["opt"], state.step + 1),
                loss[0], acc[0])

    @torch.no_grad()
    def eval_step(state, key, graph, x_table, seeds, labels):
        if isinstance(state, TrainState):
            own_params(model, state.params)
        elif state is not None:
            model.load_state_dict(state)
        params = dict(model.named_parameters())
        dims = _split_dims(model, mesh, params)

        def body(seeds_local, labels_local):
            sample, x = _sample_and_gather(
                key, graph, x_table, seeds_local, fanouts, with_replacement,
                _seed_block(seeds_local))
            with trace_span("forward"), _RankParams(params, dims):
                loss, acc = loss_and_acc(model.tree_forward(sample, x),
                                         labels_local)
            return pmean(loss, "data"), pmean(acc, "data")

        loss, acc = spmd(mesh, body, placed(seeds, mesh, on_data),
                         placed(labels, mesh, on_data))
        return loss[0], acc[0]

    return GnnTrainer(replica_init_fn(mesh, model), train_step, eval_step,
                      sample_and_gather)



def make_gnn_trainer(model, fanouts: Sequence[int], *,
                     learning_rate: LearningRate = 1e-2,
                     with_replacement: bool = False,
                     mesh: Optional[Mesh] = None) -> GnnTrainer:
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

    ``mesh``: a ``('data', 'model')`` mesh runs each step data- and
    tensor-parallel (module doc) and gives the one-device step's result;
    the graph and ``x_table`` are replicated, ``seeds`` and ``labels``
    split over ``data``, and ``sample_and_gather`` returns each data rank's
    tree and rows stacked, ``(D, ...)``.  What a rank holds: under a
    process group each process keeps the whole parameters and Adam moments
    (``init_fn`` makes them equal across processes), computes with its
    column slices only, and after the gradients' gather every process takes
    the same whole step; on a thread mesh the ranks share one model, a
    rank's slices are views of it, and one rank takes the step.  None: one
    device, as before.
    """
    fanouts = tuple(int(k) for k in fanouts)
    if mesh is not None:
        return _mesh_trainer(model, fanouts, mesh, learning_rate,
                             with_replacement)

    def sample_and_gather(key, graph, x_table, seeds):
        return _sample_and_gather(key, graph, x_table, seeds, fanouts,
                                  with_replacement)

    @step_span
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
                                 with_replacement: bool = False,
                                 mesh: Optional[Mesh] = None
                                 ) -> MultibatchTrainer:
    """Sampled-SAGE trainer that takes M minibatches per call.

    ``train_step(state, key, graph, x_table, seeds (M, B), labels (M, B))
    -> (state, losses (M,), accs (M,))``: batch i is sampled with key
    ``fold(key, step + i)`` (the key of the single-batch trainer's step
    ``step + i``); the M trees' slot features are read in one gather of
    ``M * n_total`` rows, then M forward/backward/Adam updates run in
    turn, so the trajectory is that of M single-batch steps.  The M
    samplers run one after another.  Updates ``state.params`` in place.

    ``mesh``: as in :func:`make_gnn_trainer`, each batch's B seeds split
    over ``data`` (``seeds`` and ``labels`` ``P(None, 'data')``).
    """
    fanouts = tuple(int(k) for k in fanouts)
    if mesh is not None:
        return _mesh_multibatch_trainer(model, fanouts, mesh, learning_rate,
                                        with_replacement)

    @step_span
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


def _mesh_multibatch_trainer(model, fanouts, mesh: Mesh, learning_rate,
                             with_replacement) -> MultibatchTrainer:
    """:func:`make_multibatch_sage_trainer`'s closures on a ``('data',
    'model')`` mesh: each data rank samples its block of each batch with
    that batch's key, then M DP+TP updates in turn."""
    from .sharded_features import replica_init_fn
    _check_dp_tp_mesh(mesh)
    stripes = (None, "data")

    @step_span
    def train_step(state: TrainState, key, graph, x_table, seeds, labels):
        own_params(model, state.params)
        dims = _split_dims(model, mesh, state.params)
        holder = {"opt": state.opt_state}

        def body(seeds_local, labels_local):
            keys = [rng.fold(key, state.step + i)
                    for i in range(seeds_local.shape[0])]
            blocks = [_sample_and_gather(
                k, graph, x_table, s, fanouts, with_replacement,
                _seed_block(s)) for k, s in zip(keys, seeds_local)]
            out = [_dp_tp_update(model, state.params, dims, keys[i], sample,
                                 x, labels_local[i], learning_rate, holder)
                   for i, (sample, x) in enumerate(blocks)]
            return (torch.stack([o[0] for o in out]),
                    torch.stack([o[1] for o in out]))

        losses, accs = spmd(mesh, body, placed(seeds, mesh, stripes),
                            placed(labels, mesh, stripes))
        return (TrainState(state.params, holder["opt"],
                           state.step + losses.shape[1]), losses[0], accs[0])

    return MultibatchTrainer(replica_init_fn(mesh, model), train_step)
