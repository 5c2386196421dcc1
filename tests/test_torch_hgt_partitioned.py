"""The distributed HGT model (``HGT(psum_axis=)``) and the partitioned HGT
trainer of the torch port against the JAX package, on the CPU.

* The model, in both layouts (per relation and relation-batched), two
  layers, on every node's features and each rank's block of destination
  slots of a random typed COO: its logits and the pmean of the ranks'
  first-step gradients equal JAX's under ``shard_map`` at P = 2 (flax's
  parameters carried in), and the one-device model's on the whole COO.
* ``make_partitioned_hgt_trainer`` at ``tests/test_dist_hgt.py``'s
  fast-tier configuration (2 relations, 1 hop, 1 layer, hidden 8, 2
  steps): the losses at P = 1, 2 and 4 equal JAX's (P = 2; JAX's losses do
  not depend on P) within 1e-5, overflow 0, and the pmean'd gradients of
  the first step equal those of a ``shard_map`` over the JAX trainer's own
  loss at P = 2.  JAX differentiates a loss that varies by device there,
  so its gradient is P times the one-device gradient; the port's matches
  that scale, which the test pins.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tch_geometric_tpu.models.hgt import HGT as JHGT
from tch_geometric_tpu.parallel import dist_hgt as jdh
from tch_geometric_tpu.parallel.hgt_train import HGTTrainState as JState
from tch_geometric_tpu.parallel.hgt_train import \
    make_partitioned_hgt_trainer as jmake_trainer
from tch_geometric_tpu.parallel.sharded_features import \
    build_interleaved_features as jinterleave
from tch_geometric_tpu.parallel.sharded_features import halo_gather as jhalo
from tch_geometric_tpu.sampling import rng as jrng
from tch_geometric_tpu.utils.types import rel_key
from tch_geometric_tpu_torch.models import HGT
from tch_geometric_tpu_torch.parallel import (build_interleaved_features,
                                              build_partitioned_hetero,
                                              make_mesh,
                                              make_partitioned_hgt_trainer,
                                              put_stacked_rels)
from tch_geometric_tpu_torch.parallel import hgt_train
from tch_geometric_tpu_torch.parallel.mesh import Split, spmd
from tch_geometric_tpu_torch.parallel.sharded_features import pmean_tree
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils.adam import gradients
from tch_geometric_tpu_torch.utils.params import (hgt_params_from_flax,
                                                  load_flax_params)

TOL = dict(rtol=1e-5, atol=1e-5)


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def _assert_params_close(got, want_flax, rel_specs, stacked, what):
    want = hgt_params_from_flax(want_flax, rel_specs, stacked_rels=stacked)
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **TOL,
                                   err_msg=f"{what}: {k}")


# ---------------------------------------------------------------------------
# HGT(psum_axis=)
# ---------------------------------------------------------------------------

N = {"a": 12, "b": 10}
F_IN, HIDDEN, OUT, HEADS, LAYERS = 6, 8, 3, 2, 2
REL_SPECS = (("a__r0__a", "a", "a"), ("a__r2__b", "a", "b"),
             ("b__r1__a", "b", "a"))


def _model_inputs():
    """Every node's features, the whole COO, and its two rank blocks of
    destination slots (padded with invalid edges to one length)."""
    r = np.random.default_rng(7)
    x = {t: r.normal(size=(n, F_IN)).astype(np.float32)
         for t, n in N.items()}
    whole, blocks = {}, {}
    for rel, s, d in REL_SPECS:
        E = 30
        rows = r.integers(0, N[s], E).astype(np.int32)
        cols = np.sort(r.integers(0, N[d], E)).astype(np.int32)
        valid = r.random(E) < 0.8
        whole[rel] = (rows, cols, valid)
        half = N[d] // 2
        parts = [cols < half, cols >= half]
        Eb = max(int(p.sum()) for p in parts)
        out = []
        for a, fill in ((rows, 0), (cols, 0), (valid, False)):
            out.append(np.stack([np.concatenate(
                [a[p], np.full(Eb - int(p.sum()), fill, a.dtype)])
                for p in parts]))
        blocks[rel] = tuple(out)
    labels = r.integers(0, OUT, N["a"]).astype(np.int32)
    return x, whole, blocks, labels


@pytest.mark.parametrize("stacked", [False, True], ids=["per_rel", "stacked"])
def test_psum_model_matches_jax(stacked):
    x, whole, blocks, labels = _model_inputs()
    jmodel = JHGT(hidden=HIDDEN, out=OUT, num_layers=LAYERS,
                  node_types=tuple(N), rel_specs=REL_SPECS, out_type="a",
                  heads=HEADS, stacked_rels=stacked)
    params = jmodel.init(jax.random.key(3), x, whole)
    dist = jmodel.clone(psum_axis="data")

    @jax.jit
    @functools.partial(shard_map, mesh=_jmesh(2),
                       in_specs=(JP(), JP(), JP("data"), JP()),
                       out_specs=(JP(), JP()))
    def jstep(params, x, blocks, labels):
        edges = {r: tuple(a[0] for a in e) for r, e in blocks.items()}

        def loss_fn(p):
            logits = dist.apply(p, x, edges)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean(), logits

        (_l, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        return logits, jax.lax.pmean(grads, "data")

    jlogits, jgrads = jstep(params, x, blocks, labels)

    def port_model(psum_axis):
        m = HGT(F_IN, HIDDEN, OUT, LAYERS, tuple(N), REL_SPECS, "a",
                heads=HEADS, stacked_rels=stacked, psum_axis=psum_axis,
                device="cpu")
        load_flax_params(m, hgt_params_from_flax(params, REL_SPECS,
                                                 stacked_rels=stacked))
        return m

    xt = {t: torch.from_numpy(v) for t, v in x.items()}
    yt = torch.from_numpy(labels).long()
    model = port_model("data")
    ps = dict(model.named_parameters())

    def body(blk, x, y):
        edges = {r: (e[0][0].long(), e[1][0].long(), e[2][0])
                 for r, e in blk.items()}
        logits = model(x, edges)
        loss = torch.nn.functional.cross_entropy(logits, y)
        return logits.detach(), pmean_tree(gradients(loss, ps), "data")

    tblocks = {r: tuple(torch.from_numpy(a) for a in e)
               for r, e in blocks.items()}
    logits, grads = spmd(make_mesh((2, 1), device="cpu"), body,
                         Split(tblocks, ("data",)), x=xt, y=yt)
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(jlogits),
                               **TOL)
    _assert_params_close({k: v[0] for k, v in grads.items()}, jgrads,
                         REL_SPECS, stacked, "pmean'd gradients")

    # the one-device model on the whole COO: the same logits and gradients
    one = port_model(None)
    tw = {r: (torch.from_numpy(a).long(), torch.from_numpy(b).long(),
              torch.from_numpy(c)) for r, (a, b, c) in whole.items()}
    lo = one(xt, tw)
    g1 = gradients(torch.nn.functional.cross_entropy(lo, yt),
                   dict(one.named_parameters()))
    np.testing.assert_allclose(logits[0].numpy(), lo.detach().numpy(), **TOL)
    for k, g in g1.items():
        np.testing.assert_allclose(grads[k][0].numpy(), g.numpy(), **TOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# make_partitioned_hgt_trainer
# ---------------------------------------------------------------------------

def _trainer_data():
    """``tests/test_dist_hgt.py::_hgt_trainer_invariance``'s graph at its
    fast tier: 2 relations, 12 features, 8 seeds of type a."""
    r = np.random.default_rng(0)
    counts = {"a": 40, "b": 36}
    edge_types = [("a", "r0", "a"), ("b", "r1", "a")]
    col_ptrs, row_indices = {}, {}
    for s, rel, d in edge_types:
        k = rel_key((s, rel, d))
        src = r.integers(0, counts[s], 160)
        dst = np.sort(r.integers(0, counts[d], 160))
        col_ptrs[k] = np.searchsorted(dst, np.arange(counts[d] + 1))
        row_indices[k] = src.astype(np.int64)
    x = {t: r.normal(size=(n, 12)).astype(np.float32)
         for t, n in counts.items()}
    labels = r.integers(0, 4, 8).astype(np.int32)
    return counts, edge_types, col_ptrs, row_indices, x, labels


COUNTS, EDGE_TYPES, CP, RI, X, LABELS = _trainer_data()
SEEDS = np.arange(8, dtype=np.int32)
T_RELS = tuple(sorted((rel_key(e), e[0], e[2]) for e in EDGE_TYPES))
FANOUTS = {t: [4] for t in COUNTS}
CF, LR, STEPS = 8.0, 1e-2, 2


def _jax_trainer(params):
    """The JAX trainer at P = 2: its losses, and the pmean'd first-step
    gradients of a shard_map over its own loss (the engine, the feature
    fetch, ``HGT(psum_axis=).apply``, the masked cross entropy)."""
    model = JHGT(hidden=8, out=4, num_layers=1, node_types=("a", "b"),
                 rel_specs=T_RELS, out_type="a", heads=1, stacked_rels=True)
    mesh, P = _jmesh(2), 2
    rels = jdh.build_partitioned_hetero(CP, RI, EDGE_TYPES, P,
                                        node_counts=COUNTS)
    _init, train_step, _eval = jmake_trainer(
        model, EDGE_TYPES, FANOUTS, 1, COUNTS, mesh, seed_type="a",
        learning_rate=LR, capacity_factor=CF)
    dist = model.clone(psum_axis="data")
    meta = (("a", "b"), T_RELS, (("a", (4,)), ("b", (4,))), 1, None,
            (("a", 40), ("b", 36)), (("a", 8), ("b", 0)), CF, 2, P)

    @jax.jit
    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(JP(), JP("data"), JP("data"), JP(), JP()),
                       out_specs=JP())
    def first_grads(params, rels_s, xs, seeds, labels):
        dev = jax.lax.axis_index("data")

        def loss_fn(p):
            nodes, _ts, nv, rows, cols, _e, ev, _o = jdh._dist_hgt_device(
                jrng.fold(jax.random.key(0), jnp.zeros((), jnp.int32)),
                rels_s, {"a": seeds, "b": jnp.zeros((0,), jnp.int32)},
                {"a": jnp.full((8,), -1, jnp.int32),
                 "b": jnp.zeros((0,), jnp.int32)},
                dev=dev, meta=meta, axis="data", fused=True)
            feats = {}
            for t in ("a", "b"):
                ids = jnp.clip(nodes[t], 0, xs[t].shape[0] * P - 1)
                cap = max(1, min(int(np.ceil(CF * ids.shape[0] / P)),
                                 ids.shape[0]))
                f, _ = jhalo(xs[t], ids, axis="data", num_parts=P,
                             capacity=cap, valid=nv[t], num_rounds=2)
                feats[t] = jnp.where(nv[t][:, None], f, 0.0)
            logits = dist.apply(p, feats, {r: (rows[r], cols[r], ev[r])
                                           for r in rows})[:8]
            ok = nv["a"][:8]
            ce = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                 labels)
            return (ce * ok).sum() / jnp.maximum(ok.sum(), 1)

        return jax.lax.pmean(jax.grad(loss_fn)(params), "data")

    with mesh:
        sh = NamedSharding(mesh, JP("data"))
        rels_put = jdh.put_stacked_rels(rels, [r for r, _s, _d in T_RELS],
                                        mesh, "data")
        x_put = {t: jax.device_put(jnp.asarray(jinterleave(X[t], P)), sh)
                 for t in COUNTS}
        grads = first_grads(params, rels_put, x_put, jnp.asarray(SEEDS),
                            jnp.asarray(LABELS))
        state = JState(params, optax.adam(LR).init(params),
                       jnp.zeros((), jnp.int32))
        losses = []
        for _ in range(STEPS):
            state, loss, _acc, ovf = train_step(state, jax.random.key(0),
                                                rels_put, x_put, SEEDS,
                                                LABELS)
            losses.append(float(loss))
            assert int(np.asarray(ovf).sum()) == 0
    return losses, grads


def _port_trainer(params, P, monkeypatch):
    """The port's trainer at P thread ranks: its losses and its pmean'd
    first-step gradients (read where the replica takes its update)."""
    model = HGT(12, 8, 4, 1, ("a", "b"), T_RELS, "a", heads=1,
                stacked_rels=True, device="cpu")
    load_flax_params(model, hgt_params_from_flax(params, T_RELS,
                                                 stacked_rels=True))
    mesh = make_mesh((P, 1), device="cpu")
    rels = put_stacked_rels(build_partitioned_hetero(
        CP, RI, EDGE_TYPES, P, node_counts=COUNTS, device="cpu"),
        [r for r, _s, _d in T_RELS], mesh)
    x = {t: torch.from_numpy(build_interleaved_features(v, P))
         for t, v in X.items()}
    seen = []
    update = hgt_train.replica_update

    def spy(params_, grads, holder, lr, axis):
        seen.append(pmean_tree(grads, axis))
        update(params_, grads, holder, lr, axis)

    monkeypatch.setattr(hgt_train, "replica_update", spy)
    init_fn, train_step, eval_step = make_partitioned_hgt_trainer(
        model, EDGE_TYPES, FANOUTS, 1, COUNTS, mesh, seed_type="a",
        learning_rate=LR, capacity_factor=CF)
    state = init_fn(rng.key(0), rels, x, SEEDS)
    losses = []
    for _ in range(STEPS):
        state, loss, acc, ovf = train_step(state, rng.key(0), rels, x, SEEDS,
                                           LABELS)
        losses.append(float(loss))
        assert int(ovf) == 0 and 0.0 <= float(acc) <= 1.0
    eloss, eacc = eval_step(state, rng.key(0), rels, x, SEEDS, LABELS)
    assert np.isfinite(float(eloss)) and 0.0 <= float(eacc) <= 1.0
    return losses, seen[0]


def test_partitioned_hgt_trainer_matches_jax(monkeypatch):
    jmodel = JHGT(hidden=8, out=4, num_layers=1, node_types=("a", "b"),
                  rel_specs=T_RELS, out_type="a", heads=1, stacked_rels=True)
    dummy_x = {t: jnp.zeros((12, 12), jnp.float32) for t in COUNTS}
    dummy_e = {r: (jnp.zeros((4,), jnp.int32), jnp.zeros((4,), jnp.int32),
                   jnp.zeros((4,), bool)) for r, _s, _d in T_RELS}
    params = jmodel.init(jax.random.key(0), dummy_x, dummy_e)
    jlosses, jgrads = _jax_trainer(params)
    assert jlosses[-1] < jlosses[0]
    grads = {}
    for P in (1, 2, 4):
        losses, grads[P] = _port_trainer(params, P, monkeypatch)
        np.testing.assert_allclose(losses, jlosses, rtol=1e-5,
                                   err_msg=f"P={P}")
    _assert_params_close(grads[2], jgrads, T_RELS, True,
                         "first-step gradients, P=2")
    for P in (2, 4):
        for k, g in grads[1].items():
            np.testing.assert_allclose(grads[P][k].numpy(), P * g.numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"P={P} {k}")
