"""The partitioned trainers of the torch port against the JAX package, on
the CPU: flax parameters carried in, dropout 0, float32, the JAX side on
``Mesh(jax.devices()[:P])``, the port on a thread mesh of P ranks.

* ``make_partitioned_trainer``: the K = 3 step loss curve and the last
  accuracy against JAX's (1e-5), uniform and weighted with the RELATIVE
  temporal filter and per-seed root timestamps; ``eval_step`` too; the
  port's curves at P = 1, 2 and 4 agree (1e-5), also with bf16 feature
  rows in the exchange;
* ``make_partitioned_multibatch_trainer`` (M = 2) against JAX's (1e-5)
  and across P;
* both trainers with bf16 rows in the exchange against JAX's at P = 2
  (1e-5; averaging those rows in float32 misses by about 4e-4);
* ``make_sharded_feature_trainer`` against JAX's (1e-5);
* karate trains to the JAX tests' accuracy through the partitioned
  trainer with dropout on.  ``hier=`` is held in ``test_torch_hier.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tch_geometric_tpu.data import csc_graph_from_coo as jcsc_graph
from tch_geometric_tpu.data.io import load_karate_graph as jload_karate
from tch_geometric_tpu.data.storage import to_csc as jto_csc
from tch_geometric_tpu.models import GraphSAGE as JSAGE
from tch_geometric_tpu.parallel import dist_sampling as jds
from tch_geometric_tpu.parallel import sharded_features as jsf
from tch_geometric_tpu.parallel.train import TrainState as JTrainState
from tch_geometric_tpu_torch.data import csc_graph_from_coo
from tch_geometric_tpu_torch.models import GraphSAGE
from tch_geometric_tpu_torch.parallel import (build_interleaved_features,
                                              build_partitioned_graph,
                                              make_mesh,
                                              make_partitioned_multibatch_trainer,
                                              make_partitioned_trainer,
                                              make_sharded_feature_trainer)
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils.config import TEMPORAL_SAMPLE_RELATIVE
from tch_geometric_tpu_torch.utils.params import sage_params_from_flax

F, HIDDEN, OUT, LR, STEPS = 8, 16, 4, 1e-2, 3
FANOUTS = [3, 2]


@pytest.fixture(scope="module")
def karate_setup():
    _x, y, ei = jload_karate()
    cp, ri, _ = jto_csc(np.asarray(ei), 34)
    x = np.random.default_rng(0).normal(size=(34, F)).astype(np.float32)
    r = np.random.default_rng(3)
    E = np.asarray(ri).shape[0]
    return dict(cp=np.asarray(cp), ri=np.asarray(ri), x=x, y=np.asarray(y),
                ei=np.asarray(ei),
                w=r.uniform(0.1, 2.0, E).astype(np.float32),
                ts=r.integers(0, 100, E).astype(np.int64),
                seed_ts=r.integers(20, 80, 16).astype(np.int32))


def _flax_params(seed=0):
    """A flax GraphSAGE(hidden 16, out 4, 2 layers) parameter tree."""
    r = np.random.default_rng(seed)
    dims = [F, HIDDEN, OUT]
    p = {}
    for i in range(2):
        p[f"conv{i}"] = {
            "lin_self": {
                "kernel": r.normal(size=dims[i:i + 2]).astype(np.float32)
                * 0.4,
                "bias": r.normal(size=dims[i + 1]).astype(np.float32) * 0.1},
            "lin_neigh": {
                "kernel": r.normal(size=dims[i:i + 2]).astype(np.float32)
                * 0.4}}
    return jax.tree_util.tree_map(jnp.asarray, {"params": p})


def _jstate(params):
    return JTrainState(params, optax.adam(LR).init(params),
                       jnp.zeros((), jnp.int32))


def _model(params=None, dropout=0.0):
    m = GraphSAGE(F, HIDDEN, OUT, 2, dropout=dropout, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    if params is not None:
        m.load_state_dict(sage_params_from_flax(params))
    return m


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def _tmesh(n):
    return make_mesh((n, 1), device="cpu")


def _jput(mesh, *values, spec=JP("data")):
    sh = NamedSharding(mesh, spec)
    return [jax.device_put(v, sh) for v in values]


def _port_curve(ks, P, params, filtered=False, exchange_dtype=None,
                with_eval=False):
    kw = {}
    if filtered:
        kw = dict(weighted=True, filter=((-40, 40), True,
                                         TEMPORAL_SAMPLE_RELATIVE))
    m = _model(params)
    tr = make_partitioned_trainer(m, FANOUTS, _tmesh(P), learning_rate=LR,
                                  capacity_factor=2.0,
                                  exchange_dtype=exchange_dtype, **kw)
    g = build_partitioned_graph(ks["cp"], ks["ri"], P, edge_weights=ks["w"],
                                edge_timestamps=ks["ts"], device="cpu")
    xi = torch.from_numpy(build_interleaved_features(ks["x"], P))
    seeds, labels = np.arange(16), ks["y"][:16]
    extra = dict(seed_ts=ks["seed_ts"]) if filtered else {}
    state = tr.init_fn()
    losses, accs = [], []
    for _ in range(STEPS):
        state, loss, acc, ovf = tr.train_step(state, rng.key(1), g, xi,
                                              seeds, labels, **extra)
        assert int(ovf) == 0
        losses.append(float(loss))
        accs.append(float(acc))
    assert state.step == STEPS
    ev = (tr.eval_step(state, rng.key(1), g, xi, seeds, labels, **extra)
          if with_eval else None)
    return np.array(losses), np.array(accs), ev


@pytest.mark.parametrize("filtered,P", [(False, 2), (True, 1)])
def test_partitioned_trainer_matches_jax(karate_setup, filtered, P):
    ks = karate_setup
    params = _flax_params()
    kw = {}
    if filtered:
        kw = dict(weighted=True, filter=((-40, 40), True,
                                         TEMPORAL_SAMPLE_RELATIVE))
    jm = _jmesh(P)
    _, jstep, jeval = jds.make_partitioned_trainer(
        JSAGE(hidden=HIDDEN, out=OUT, num_layers=2), FANOUTS, jm,
        learning_rate=LR, capacity_factor=2.0, **kw)
    jg = jds.build_partitioned_graph(ks["cp"], ks["ri"], P,
                                     edge_weights=ks["w"],
                                     edge_timestamps=ks["ts"])
    extra = {}
    with jm:
        gput, xput, sput, lput, tput = _jput(
            jm, jg, jnp.asarray(jsf.build_interleaved_features(ks["x"], P)),
            jnp.arange(16, dtype=jnp.int32), jnp.asarray(ks["y"][:16]),
            jnp.asarray(ks["seed_ts"]))
        if filtered:
            extra = dict(seed_ts=tput)
        state = _jstate(params)
        jl, ja = [], []
        for _ in range(STEPS):
            state, loss, acc, ovf = jstep(state, jax.random.key(1), gput,
                                          xput, sput, lput, **extra)
            jl.append(float(loss))
            ja.append(float(acc))
        jev = jeval(state, jax.random.key(1), gput, xput, sput, lput,
                    **extra)
    tl, ta, tev = _port_curve(ks, P, params, filtered, with_eval=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(ta, ja, atol=1e-7)
    np.testing.assert_allclose(float(tev[0]), float(jev[0]), rtol=1e-5)
    np.testing.assert_allclose(float(tev[1]), float(jev[1]), atol=1e-7)


@pytest.mark.parametrize("exchange_dtype", [None, torch.bfloat16])
def test_partitioned_trainer_rank_count_invariant(karate_setup,
                                                  exchange_dtype):
    ks = karate_setup
    params = _flax_params(1)
    curves = [_port_curve(ks, P, params, exchange_dtype=exchange_dtype)[0]
              for P in (1, 2, 4)]
    for c in curves[1:]:
        np.testing.assert_allclose(c, curves[0], rtol=1e-5)
    assert curves[0][-1] < curves[0][0]


def test_partitioned_multibatch_trainer_matches_jax(karate_setup):
    ks = karate_setup
    M, B = 2, 16
    params = _flax_params(2)
    seeds = (np.arange(M * B).reshape(M, B) * 7 % 34).astype(np.int32)
    labels = ks["y"][seeds]
    P = 2
    jm = _jmesh(P)
    _, jstep = jds.make_partitioned_multibatch_trainer(
        JSAGE(hidden=HIDDEN, out=OUT, num_layers=2), FANOUTS, jm,
        learning_rate=LR, capacity_factor=4.0)
    jg = jds.build_partitioned_graph(ks["cp"], ks["ri"], P)
    with jm:
        gput, xput = _jput(jm, jg, jnp.asarray(
            jsf.build_interleaved_features(ks["x"], P)))
        sput, lput = _jput(jm, jnp.asarray(seeds), jnp.asarray(labels),
                           spec=JP(None, "data"))
        state = _jstate(params)
        jl = []
        for s in range(STEPS):
            state, losses, _, ovf = jstep(
                state, jax.random.fold_in(jax.random.key(0), s), gput, xput,
                sput, lput)
            jl.append(np.asarray(losses))
    curves = {}
    for p in (1, 2, 4):
        m = _model(params)
        tr = make_partitioned_multibatch_trainer(
            m, FANOUTS, _tmesh(p), learning_rate=LR, capacity_factor=4.0)
        g = build_partitioned_graph(ks["cp"], ks["ri"], p, device="cpu")
        xi = torch.from_numpy(build_interleaved_features(ks["x"], p))
        st, tl = tr.init_fn(), []
        for s in range(STEPS):
            st, losses, accs, ovf = tr.train_step(
                st, rng.fold_in(rng.key(0), s), g, xi, seeds, labels)
            assert losses.shape == accs.shape == (M,) and int(ovf) == 0
            tl.append(losses.numpy())
        assert st.step == STEPS
        curves[p] = np.stack(tl)
    np.testing.assert_allclose(curves[P], np.stack(jl), rtol=1e-5)
    for p in (1, 4):
        np.testing.assert_allclose(curves[p], curves[P], rtol=1e-5)


@pytest.mark.parametrize("trainer", ["flat", "multibatch"])
def test_partitioned_trainers_bf16_exchange_match_jax(karate_setup, trainer):
    """``exchange_dtype=bfloat16`` at P = 2: the rows reach the model in
    bfloat16, the first layer averages the children in bfloat16 and its
    linears promote to float32, as the JAX model does.  Averaging the same
    rows in float32 misses JAX's curve by more than 1e-5."""
    ks = karate_setup
    P, M, B = 2, 2, 16
    params = _flax_params(4)
    seeds = (np.arange(M * B).reshape(M, B) * 5 % 34).astype(np.int32)
    labels = ks["y"][seeds]
    jm = _jmesh(P)
    jg = jds.build_partitioned_graph(ks["cp"], ks["ri"], P)
    jmodel = JSAGE(hidden=HIDDEN, out=OUT, num_layers=2)
    if trainer == "flat":
        _, jstep, _ = jds.make_partitioned_trainer(
            jmodel, FANOUTS, jm, learning_rate=LR, capacity_factor=2.0,
            exchange_dtype=jnp.bfloat16)
        jseeds, spec = seeds[0], JP("data")
    else:
        _, jstep = jds.make_partitioned_multibatch_trainer(
            jmodel, FANOUTS, jm, learning_rate=LR, capacity_factor=4.0,
            exchange_dtype=jnp.bfloat16)
        jseeds, spec = seeds, JP(None, "data")
    with jm:
        gput, xput = _jput(jm, jg, jnp.asarray(
            jsf.build_interleaved_features(ks["x"], P)))
        sput, lput = _jput(jm, jnp.asarray(jseeds),
                           jnp.asarray(ks["y"][jseeds]), spec=spec)
        state = _jstate(params)
        jl = []
        for s in range(STEPS):
            state, loss, _, ovf = jstep(
                state, jax.random.fold_in(jax.random.key(5), s), gput, xput,
                sput, lput)
            assert int(ovf) == 0
            jl.append(np.asarray(loss))
    if trainer == "flat":
        tr = make_partitioned_trainer(
            _model(params), FANOUTS, _tmesh(P), learning_rate=LR,
            capacity_factor=2.0, exchange_dtype=torch.bfloat16)
        tseeds, tlabels = seeds[0], labels[0]
    else:
        tr = make_partitioned_multibatch_trainer(
            _model(params), FANOUTS, _tmesh(P), learning_rate=LR,
            capacity_factor=4.0, exchange_dtype=torch.bfloat16)
        tseeds, tlabels = seeds, labels
    g = build_partitioned_graph(ks["cp"], ks["ri"], P, device="cpu")
    xi = torch.from_numpy(build_interleaved_features(ks["x"], P))
    st, tl = tr.init_fn(), []
    for s in range(STEPS):
        st, loss, _, ovf = tr.train_step(st, rng.fold_in(rng.key(5), s), g,
                                         xi, tseeds, tlabels)
        assert int(ovf) == 0
        tl.append(loss.numpy())
    np.testing.assert_allclose(np.stack(tl), np.stack(jl), rtol=1e-5)


def test_sharded_feature_trainer_matches_jax(karate_setup):
    ks = karate_setup
    P = 2
    params = _flax_params(3)
    jm = _jmesh(P)
    _, jstep, _ = jsf.make_sharded_feature_trainer(
        JSAGE(hidden=HIDDEN, out=OUT, num_layers=2), FANOUTS, jm,
        learning_rate=LR, capacity_factor=2.0)
    jg = jcsc_graph(ks["ei"], 34)
    with jm:
        xput, sput, lput = _jput(
            jm, jnp.asarray(jsf.build_interleaved_features(ks["x"], P)),
            jnp.arange(16, dtype=jnp.int32), jnp.asarray(ks["y"][:16]))
        state = _jstate(params)
        jl = []
        for _ in range(STEPS):
            state, loss, _, ovf = jstep(state, jax.random.key(2), jg, xput,
                                        sput, lput)
            jl.append(float(loss))
    m = _model(params)
    tr = make_sharded_feature_trainer(m, FANOUTS, _tmesh(P),
                                      learning_rate=LR, capacity_factor=2.0)
    g = csc_graph_from_coo(ks["ei"], 34, device="cpu")
    xi = torch.from_numpy(build_interleaved_features(ks["x"], P))
    st, tl = tr.init_fn(), []
    for _ in range(STEPS):
        st, loss, _, ovf = tr.train_step(st, rng.key(2), g, xi,
                                         np.arange(16), ks["y"][:16])
        assert int(ovf) == 0
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    loss, acc = tr.eval_step(st, rng.key(2), g, xi, np.arange(16),
                             ks["y"][:16])
    assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0


def test_partitioned_trainer_learns_karate_with_dropout():
    from tch_geometric_tpu_torch.data import load_karate_graph
    x, y, ei = load_karate_graph()
    cp, ri, _ = jto_csc(np.asarray(ei), 34)
    P = 4
    m = GraphSAGE(34, 32, int(y.max()) + 1, 2, dropout=0.3, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    tr = make_partitioned_trainer(m, [4, 3], _tmesh(P), learning_rate=1e-2,
                                  capacity_factor=6.0)
    g = build_partitioned_graph(cp, ri, P, device="cpu")
    xi = torch.from_numpy(build_interleaved_features(
        np.asarray(x, np.float32), P))
    seeds, labels = np.arange(32), np.asarray(y)[:32]
    st = tr.init_fn()
    for _ in range(40):
        st, loss, acc, ovf = tr.train_step(st, rng.key(0), g, xi, seeds,
                                           labels)
    assert int(ovf) == 0
    loss, acc = tr.eval_step(st, rng.key(0), g, xi, seeds, labels)
    assert float(acc) >= 0.85, (float(loss), float(acc))

