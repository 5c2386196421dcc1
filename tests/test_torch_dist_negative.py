"""Distributed negative sampling and the partitioned link trainer of the
torch port against the JAX package, on the CPU.

* ``dist_negative_sample``, outbound and inbound, on karate's CSR with and
  without the ELL table (the window probe): one JAX run per case on a
  2-device virtual mesh
  (its negatives do not depend on the device count), the port on thread
  meshes of 1, 2 and 4 ranks, negatives, accepts and overflow bit-equal;
  a tight capacity at P = 4, overflow counts equal to JAX's;
* ``dist_negative_sample_hetero`` on fakeheterodataset's CSRs, JAX's
  relations built by ``build_partitioned_hetero``, the port's one
  ``build_partitioned_graph`` a relation, inbound and outbound;
* ``make_partitioned_link_trainer`` (GraphSAGE, 2 layers, flax parameters
  carried across by ``sage_params_from_flax``) at P = 1, 2 and 4: three
  steps' losses and the ``eval_step``'s loss and rank within 1e-5 of
  JAX's, with dropout 0 and with a temporal filter and edge timestamps.
  Without dropout the trees and negatives do not depend on P, so one JAX
  run at P = 2 is held against every P.  The dropout-on runs, where each
  rank masks its own tree under the shared key as a ``shard_map`` body
  does and each P is held against JAX at that P, are in
  ``test_torch_flax_dropout.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tch_geometric_tpu.data.io import load_fake_hetero_graph as jload_hetero
from tch_geometric_tpu.data.io import load_karate_graph as jload_karate
from tch_geometric_tpu.data.storage import to_csr as jto_csr
from tch_geometric_tpu.models.sage import GraphSAGE as JSAGE
from tch_geometric_tpu.parallel import dist_negative as jdn
from tch_geometric_tpu.parallel import dist_sampling as jds
from tch_geometric_tpu.parallel.dist_hgt import build_partitioned_hetero
from tch_geometric_tpu.parallel.link_train import \
    make_partitioned_link_trainer as jlink_trainer
from tch_geometric_tpu.parallel.multihost import put_partitioned
from tch_geometric_tpu.parallel.sharded_features import \
    build_interleaved_features as jinterleave
from tch_geometric_tpu.parallel.train import TrainState as JTrainState
from tch_geometric_tpu.sampling.neighbor import NeighborSample as JSample
from tch_geometric_tpu.sampling.neighbor import _layer_layout
from tch_geometric_tpu.utils.types import rel_key
from tch_geometric_tpu_torch.models import GraphSAGE
from tch_geometric_tpu_torch.parallel import (build_interleaved_features,
                                              build_partitioned_graph,
                                              dist_negative_sample,
                                              dist_negative_sample_hetero,
                                              make_mesh,
                                              make_partitioned_link_trainer)
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils.params import sage_params_from_flax

B, NUM_NEG, TRIES = 16, 3, 4


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def _tmesh(n):
    return make_mesh((n, 1), device="cpu")


def _karate():
    _x, _y, ei = jload_karate()
    rp, ci, _ = jto_csr(np.asarray(ei), 34)
    return np.asarray(rp), np.asarray(ci)


GRAPHS = {"karate": _karate()}

# name -> (graph, ell_table, inbound)
CASES = {"karate_ell_out": ("karate", True, False),
         "karate_ell_in": ("karate", True, True),
         "karate_csr_out": ("karate", False, False),
         "karate_csr_in": ("karate", False, True)}


def _inputs(name):
    n = GRAPHS[name][0].shape[0] - 1
    return np.random.default_rng(2).integers(0, n, B).astype(np.int32)


def _negatives(lib, case, P, **kw):
    name, ell, inbound = CASES[case]
    ptr, ind = GRAPHS[name]
    kw = {"capacity_factor": 8.0, "inbound": inbound, **kw}
    if lib == "jax":
        g = jds.build_partitioned_graph(ptr, ind, P, ell_table=ell)
        out = jdn.dist_negative_sample(jax.random.key(3), g, _inputs(name),
                                       NUM_NEG, TRIES, _jmesh(P), **kw)
    else:
        g = build_partitioned_graph(ptr, ind, P, ell_table=ell, device="cpu")
        out = dist_negative_sample(rng.key(3), g, _inputs(name), NUM_NEG,
                                   TRIES, _tmesh(P), **kw)
    w, acc, ovf = (np.asarray(o) for o in out)
    return w.reshape(B, NUM_NEG), acc.reshape(B, NUM_NEG), ovf


@pytest.fixture(scope="module")
def jax_negatives():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _negatives("jax", case, 2)
        return cache[case]
    return get


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_negatives_match_jax(jax_negatives, case, P):
    jw, jacc, jovf = jax_negatives(case)
    w, acc, ovf = _negatives("port", case, P)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(np.where(acc, w, -1),
                                  np.where(jacc, jw, -1))
    np.testing.assert_array_equal(w, jw)
    assert ovf.shape == (P,) and int(ovf.sum()) == int(jovf.sum()) == 0
    # every accepted negative is a non-edge and not the input itself
    name = CASES[case][0]
    ptr, ind = GRAPHS[name]
    v = _inputs(name)
    for i, n in zip(*np.nonzero(acc)):
        a, b = (v[i], w[i, n]) if not CASES[case][2] else (w[i, n], v[i])
        assert b not in ind[ptr[a]: ptr[a + 1]] and w[i, n] != v[i]
    assert acc.any()


@pytest.mark.parametrize("case", ["karate_csr_out", "karate_ell_in"])
def test_tight_capacity_overflow_matches_jax(case):
    kw = dict(capacity_factor=0.2, num_rounds=1)
    jw, jacc, jovf = _negatives("jax", case, 4, **kw)
    w, acc, ovf = _negatives("port", case, 4, **kw)
    np.testing.assert_array_equal(w, jw)
    np.testing.assert_array_equal(acc, jacc)
    np.testing.assert_array_equal(ovf, jovf)
    assert int(ovf.sum()) > 0


# ---------------------------------------------------------------------------
# Typed negatives
# ---------------------------------------------------------------------------

def _hetero():
    xs, coo = jload_hetero()
    counts = {t: int(x.shape[0]) for t, x in xs.items()}
    edge_types = sorted(coo)
    csr = {}
    for e in edge_types:
        a, b, _ = jto_csr(np.asarray(coo[e]), (counts[e[0]], counts[e[2]]))
        csr[rel_key(e)] = (np.asarray(a), np.asarray(b))
    types = sorted(counts)
    inputs = {types[0]: np.arange(8, dtype=np.int64),
              types[1]: np.arange(4, 12, dtype=np.int64)}
    return counts, edge_types, csr, inputs


@pytest.fixture(scope="module")
def hetero():
    return _hetero()


@pytest.mark.parametrize("inbound", [False, True])
def test_hetero_negatives_match_jax(hetero, inbound):
    counts, edge_types, csr, inputs = hetero
    kw = dict(node_counts=counts, capacity_factor=8.0, inbound=inbound)
    rels = build_partitioned_hetero({r: c[0] for r, c in csr.items()},
                                    {r: c[1] for r, c in csr.items()},
                                    edge_types, 2, node_counts=counts)
    want = jdn.dist_negative_sample_hetero(jax.random.key(11), rels,
                                           edge_types, inputs, NUM_NEG, TRIES,
                                           _jmesh(2), **kw)
    for P in (1, 2, 4):
        trels = {r: build_partitioned_graph(a, b, P, device="cpu")
                 for r, (a, b) in csr.items()}
        got = dist_negative_sample_hetero(rng.key(11), trels, edge_types,
                                          inputs, NUM_NEG, TRIES, _tmesh(P),
                                          **kw)
        for d_got, d_want in zip(got[:3], want[:3]):
            assert sorted(d_got) == sorted(d_want)
            for t in d_want:
                np.testing.assert_array_equal(
                    d_got[t].numpy().reshape(-1, NUM_NEG),
                    np.asarray(d_want[t]).reshape(-1, NUM_NEG), err_msg=t)
        assert int(got[3].sum()) == int(np.asarray(want[3]).sum()) == 0
    assert any(got[1][t].any() for t in got[1])


# ---------------------------------------------------------------------------
# The partitioned link trainer
# ---------------------------------------------------------------------------

F, HIDDEN, OUT, STEPS, LR = 16, 16, 8, 3, 1e-2
DYNAMIC = 2
LINK = {"plain": dict(dropout=0.0), "dropout": dict(dropout=0.5),
        "temporal": dict(dropout=0.0, temporal=True)}


def _link_data():
    ptr, ind = GRAPHS["karate"]
    r = np.random.default_rng(0)
    x = r.normal(size=(34, F)).astype(np.float32)
    src = np.empty((STEPS, 8), np.int32)
    dst = np.empty((STEPS, 8), np.int32)
    for s in range(STEPS):
        for i in range(8):
            u = r.integers(0, 34)
            while ptr[u + 1] == ptr[u]:
                u = r.integers(0, 34)
            src[s, i] = u
            dst[s, i] = ind[r.integers(ptr[u], ptr[u + 1])]
    ts = r.integers(0, 100, ind.shape[0]).astype(np.int32)
    edge_ts = r.integers(20, 80, (STEPS, 8)).astype(np.int32)
    return x, src, dst, ts, edge_ts


def _trainer_kw(config):
    kw = dict(num_neg=2, try_count=8, learning_rate=LR, capacity_factor=8.0)
    if LINK[config].get("temporal"):
        kw["filter"] = ((-40, 40), True, DYNAMIC)
    return kw


@functools.lru_cache(maxsize=None)
def _flax_params():
    """The flax SAGE's parameters under key 0 (they depend on the feature
    and layer widths only), initialised on a dummy tree: the JAX
    trainer's ``init_fn`` would run its shard_map eagerly."""
    nb, eb = _layer_layout(8, (3, 2))
    n, e = nb[-1], eb[-1]
    zi = jnp.zeros((e,), jnp.int32)
    sample = JSample(jnp.zeros((n,), jnp.int32), jnp.ones((n,), bool),
                     jnp.zeros((n,), jnp.int32), zi, zi, zi,
                     jnp.ones((e,), bool), nb, eb, (3, 2))
    return JSAGE(hidden=HIDDEN, out=OUT, num_layers=2).init(
        jax.random.key(0), sample, jnp.zeros((n, F), jnp.float32),
        method=JSAGE.tree_forward)


def jax_link(config, P, evaluate=True):
    """JAX's three losses at P from ``_flax_params`` and, with
    ``evaluate``, its ``eval_step``'s (loss, rank) after them."""
    ptr, ind = GRAPHS["karate"]
    x, src, dst, ts, edge_ts = _link_data()
    temporal = LINK[config].get("temporal")
    mesh = _jmesh(P)
    g = jds.build_partitioned_graph(ptr, ind, P,
                                    edge_timestamps=ts if temporal else None)
    model = JSAGE(hidden=HIDDEN, out=OUT, num_layers=2,
                  dropout=LINK[config]["dropout"])
    _init, step, evaluate_fn = jlink_trainer(model, [3, 2], mesh,
                                             **_trainer_kw(config))
    put = lambda a: put_partitioned(jnp.asarray(a), mesh, JP("data"))  # noqa
    params = _flax_params()
    # replicated as the step's outputs are: one compile of the step
    state = jax.device_put(
        JTrainState(params, optax.adam(LR).init(params),
                    jnp.zeros((), jnp.int32)), NamedSharding(mesh, JP()))
    key = jax.random.key(0)
    losses, ev = [], None
    with mesh:
        gput = put_partitioned(g, mesh, JP("data"))
        xput = put(jinterleave(x, P))
        ets = (lambda s: put(edge_ts[s])) if temporal else (lambda s: None)
        for s in range(STEPS):
            state, loss, ovf = step(state, key, gput, xput, put(src[s]),
                                    put(dst[s]), ets(s))
            losses.append(float(loss))
            assert int(np.asarray(ovf).sum()) == 0
        if evaluate:
            ev = tuple(float(v) for v in evaluate_fn(
                state, key, gput, xput, put(src[0]), put(dst[0]), ets(0)))
    return losses, ev


def port_link(config, P):
    """The port's three losses at P from ``_flax_params`` and its
    ``eval_step``'s (loss, rank) after them."""
    ptr, ind = GRAPHS["karate"]
    x, src, dst, ts, edge_ts = _link_data()
    temporal = LINK[config].get("temporal")
    g = build_partitioned_graph(ptr, ind, P, device="cpu",
                                edge_timestamps=ts if temporal else None)
    m = GraphSAGE(F, HIDDEN, OUT, 2, dropout=LINK[config]["dropout"],
                  device="cpu")
    m.load_state_dict(sage_params_from_flax(_flax_params()))
    tr = make_partitioned_link_trainer(m, [3, 2], _tmesh(P),
                                       **_trainer_kw(config))
    xi = build_interleaved_features(x, P)
    ets = (lambda s: edge_ts[s]) if temporal else (lambda s: None)
    state = tr.init_fn(rng.key(0), g, xi, src[0], dst[0], ets(0))
    losses = []
    for s in range(STEPS):
        state, loss, ovf = tr.train_step(state, rng.key(0), g, xi, src[s],
                                         dst[s], ets(s))
        losses.append(float(loss))
        assert int(ovf) == 0
    assert state.step == STEPS
    ev = tr.eval_step(state, rng.key(0), g, xi, src[0], dst[0], ets(0))
    return losses, tuple(float(v) for v in ev)


@pytest.fixture(scope="module")
def jax_link_p2():
    """JAX at P = 2 per dropout-free configuration, shared by every P."""
    cache = {}

    def get(config):
        if config not in cache:
            cache[config] = jax_link(config, 2)
        return cache[config]
    return get


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("config", ["plain", "temporal"])
def test_partitioned_link_trainer_matches_jax(jax_link_p2, config, P):
    want, want_eval = jax_link_p2(config)
    got, got_eval = port_link(config, P)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got_eval, want_eval, rtol=1e-5, atol=1e-7)
