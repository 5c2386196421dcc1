"""Distributed random walks of the torch port against the JAX package, on
the CPU: every case runs once in JAX on a 2-device virtual mesh (its walks
do not depend on the device count) and in the port on thread meshes of 1,
2 and 4 ranks, walks, timestamps and overflow counts bit-equal.

* node2vec at (p, q) = (1, 1) and (0.5, 2) on karate's CSR with and
  without the ELL table, and on a 200-node graph whose hub row (about 160
  neighbors) is past every ELL width: the window engines, whose loop the
  port bounds by the largest degree the owner received;
* the tempo walk with NaN edge, node and start timestamps (the effective
  timestamps of ``effective_edge_ts``, equal to JAX's) on both engines;
* CTDNE in the uniform, linear and exponential biases, forward and
  backward, on the ELL table, and two biases on the hub graph;
* a tight capacity at P = 4 (one round), overflow counts equal to JAX's;
* ``rng.gumbel_each`` equal to ``jax.vmap(jax.random.gumbel)``: its
  uniforms bit for bit, the noise within the last ulp of ``log``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tch_geometric_tpu.data.io import load_karate_graph as jload_karate
from tch_geometric_tpu.data.storage import to_csc as jto_csc
from tch_geometric_tpu.data.storage import to_csr as jto_csr
from tch_geometric_tpu.parallel import dist_sampling as jds
from tch_geometric_tpu.parallel import dist_walks as jdw
from tch_geometric_tpu_torch.parallel import (build_partitioned_graph,
                                              dist_biased_tempo_random_walk,
                                              dist_random_walk,
                                              dist_tempo_random_walk,
                                              effective_edge_ts, make_mesh)
from tch_geometric_tpu_torch.sampling import rng

B, NAN = 8, -1


def _karate():
    _x, _y, ei = jload_karate()
    rp, ci, _ = jto_csr(np.asarray(ei), 34)
    return np.asarray(rp), np.asarray(ci)


def _hub():
    """200 nodes, 1,600 random edges and node 0 with 150 more neighbors:
    no ELL table, the window engines."""
    r = np.random.default_rng(11)
    src = np.concatenate([r.integers(0, 200, 1600), r.integers(1, 200, 150)])
    dst = np.concatenate([r.integers(0, 200, 1600), np.zeros(150, np.int64)])
    cp, ri, _ = jto_csc(np.stack([src, dst]), 200)
    return np.asarray(cp), np.asarray(ri)


GRAPHS = {"karate": _karate(), "hub": _hub()}


def _times(name):
    """(effective edge timestamps, start timestamps) with NaNs in the
    edge, node and start timestamps."""
    ptr, ind = GRAPHS[name]
    n, e = ptr.shape[0] - 1, ind.shape[0]
    r = np.random.default_rng(5)
    edge_ts = r.integers(0, 100, e)
    edge_ts[r.random(e) < 0.15] = NAN
    node_ts = r.integers(0, 100, n)
    node_ts[r.random(n) < 0.1] = NAN
    start_ts = r.integers(0, 40, B).astype(np.int32)
    start_ts[[1, 6]] = NAN
    return effective_edge_ts(ind, edge_ts, node_ts), start_ts, (
        ind, edge_ts, node_ts)


def _starts(name):
    if name == "hub":   # the hub and nodes whose rows hold it
        ptr, ind = GRAPHS[name]
        near = np.flatnonzero(np.diff(ptr) > 0)[:B - 1]
        return np.concatenate([[0], near]).astype(np.int32)
    return np.arange(0, 4 * B, 4, dtype=np.int32) % 34


# name -> (kind, graph, ell_table, walk kwargs)
CASES = {
    "n2v_11_ell": ("node2vec", "karate", True, dict(p=1.0, q=1.0)),
    "n2v_11_csr": ("node2vec", "karate", False, dict(p=1.0, q=1.0)),
    "n2v_pq_ell": ("node2vec", "karate", True, dict(p=0.5, q=2.0)),
    "n2v_pq_csr": ("node2vec", "karate", False, dict(p=0.5, q=2.0)),
    "n2v_pq_hub": ("node2vec", "hub", None, dict(p=0.5, q=2.0, window=64)),
    "tempo_ell": ("tempo", "karate", True, {}),
    "tempo_csr": ("tempo", "karate", False, {}),
    "tempo_hub": ("tempo", "hub", None, dict(window=64)),
    **{f"ctdne_{b}_{'fw' if fw else 'bw'}": (
        "ctdne", "karate", True, dict(walk_bias=b, forward=fw))
       for b in ("uniform", "linear", "exponential") for fw in (True, False)},
    "ctdne_exponential_hub": ("ctdne", "hub", None,
                              dict(walk_bias="exponential", window=64)),
    "ctdne_uniform_hub_bw": ("ctdne", "hub", None,
                             dict(walk_bias="uniform", forward=False,
                                  window=64)),
}
LENGTH = {"node2vec": 6, "tempo": 6, "ctdne": 5}


def _run(lib, case, P, mesh=None, **extra):
    """The case's walks in JAX (``lib == "jax"``) or the port at P (on
    ``mesh`` when given)."""
    kind, name, ell, kw = CASES[case]
    kw = {"capacity_factor": 8.0, **kw, **extra}
    ptr, ind = GRAPHS[name]
    ts_eff, start_ts, _ = _times(name)
    timed = kind != "node2vec"
    gkw = dict(ell_table=ell, edge_timestamps=ts_eff if timed else None)
    start = _starts(name)
    L = LENGTH[kind]
    if lib == "jax":
        g = jds.build_partitioned_graph(ptr, ind, P, **gkw)
        mesh, key = JMesh(np.array(jax.devices()[:P]), ("data",)), \
            jax.random.key(7)
        walk, tempo, ctdne = (jdw.dist_random_walk, jdw.dist_tempo_random_walk,
                              jdw.dist_biased_tempo_random_walk)
    else:
        g = build_partitioned_graph(ptr, ind, P, device="cpu", **gkw)
        mesh, key = mesh or make_mesh((P, 1), device="cpu"), rng.key(7)
        walk, tempo, ctdne = (dist_random_walk, dist_tempo_random_walk,
                              dist_biased_tempo_random_walk)
    if kind == "node2vec":
        w, ovf = walk(key, g, start, L, mesh, **kw)
        out = (w, ovf)
    elif kind == "tempo":
        out = tempo(key, g, start, start_ts, L, (0, 60), mesh, **kw)
    else:
        bias = kw.pop("walk_bias")
        out = ctdne(key, g, start, start_ts, L, bias, mesh, **kw)
    out = [np.asarray(o) for o in out]
    walks = [o.reshape(B, -1) for o in out[:-1]]
    return walks, out[-1]


@pytest.fixture(scope="module")
def jax_walks():
    """One JAX run per case at P = 2, shared by the three port meshes."""
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _run("jax", case, 2)
        return cache[case]
    return get


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_walks_match_jax(jax_walks, case, P):
    want, wovf = jax_walks(case)
    got, ovf = _run("port", case, P)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ovf.shape == (P,) and int(ovf.sum()) == int(wovf.sum()) == 0
    kind, name = CASES[case][:2]
    w = got[0]
    np.testing.assert_array_equal(w[:, 0], _starts(name))
    if kind != "node2vec":       # the walks' timestamps start at the roots
        np.testing.assert_array_equal(got[1][:, 0], _times(name)[1])


@pytest.mark.parametrize("case", ["n2v_pq_hub", "ctdne_exponential_hub"])
def test_walks_on_one_axis_of_a_2d_mesh_match_jax(jax_walks, case):
    """On a ('data', 'model') = (2, 2) thread mesh, walks over ``data``
    (replicated over ``model``) are JAX's at P = 2."""
    want, _ = jax_walks(case)
    got, ovf = _run("port", case, 2, mesh=make_mesh((2, 2), device="cpu"),
                    axis="data")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ovf.shape == (2,) and int(ovf.sum()) == 0


@pytest.mark.parametrize("case",
                         ["n2v_pq_hub", "tempo_csr", "ctdne_uniform_fw"])
def test_tight_capacity_overflow_matches_jax(case):
    kw = dict(capacity_factor=0.3, num_rounds=1)
    want, wovf = _run("jax", case, 4, **kw)
    got, ovf = _run("port", case, 4, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ovf, wovf)
    assert int(ovf.sum()) > 0


def test_effective_edge_ts_matches_jax():
    for name in GRAPHS:
        ts_eff, _, (ind, edge_ts, node_ts) = _times(name)
        want = jdw.effective_edge_ts(ind, edge_ts, node_ts)
        np.testing.assert_array_equal(ts_eff, want)
        assert ts_eff.dtype == want.dtype
        assert (ts_eff == NAN).sum() < (edge_ts == NAN).sum()


def test_gumbel_each_matches_vmap():
    """The uniforms under the tiny minimum bit-equal, the Gumbel noise
    within the last ulp of the two libms' ``log`` (as ``rng.gumbel``)."""
    key = jax.random.fold_in(jax.random.key(5), 3)
    uids = np.random.default_rng(0).integers(0, 2**31, 64).astype(np.int32)
    jk = jax.vmap(lambda u: jax.random.fold_in(key, u))(
        jnp.asarray(uids).astype(jnp.uint32))
    tk = rng.fold_in_many(rng.fold_in(rng.key(5), 3), torch.from_numpy(uids))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    np.testing.assert_array_equal(
        rng.uniform_each(tk, (3, 40), tiny, 1.0).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (3, 40), jnp.float32, minval=tiny))(jk)))
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (3, 40), jnp.float32))(jk))
    np.testing.assert_allclose(rng.gumbel_each(tk, (3, 40)).numpy(), want,
                               rtol=4e-7, atol=1e-6)
