"""Distributed sampling of the torch port against the JAX package, on the
CPU, with the JAX side on ``Mesh(jax.devices()[:P])`` and the port on a
thread mesh of P ranks:

* ``build_partitioned_graph``: every array exactly JAX's, with and without
  the ELL table, edge weights and timestamps, at P = 1, 2 and 4;
* the batched-key draws (``rng.fold_in_many``, ``uniform_each``,
  ``randint_each``) bit-equal to ``jax.vmap`` of the single-key draws;
* ``dist_sample_neighbors`` bit-exact against JAX in every mode (uniform,
  with replacement, weighted without and with replacement, the three
  temporal modes) on karate's ELL table and on a 200-node graph past the
  ELL widths (the Floyd and chunked window engines), at P = 1, 2 and 4 and
  with tight capacities (overflow counts equal); and the port's own law:
  the P = 1, 2 and 4 trees are bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tch_geometric_tpu.data.io import load_karate_graph as jload_karate
from tch_geometric_tpu.data.storage import to_csc as jto_csc
from tch_geometric_tpu.parallel import dist_sampling as jds
from tch_geometric_tpu_torch.parallel import (PartitionedGraph,
                                              build_partitioned_graph,
                                              dist_sample_neighbors,
                                              make_mesh)
from tch_geometric_tpu_torch.sampling import rng

GRAPH_FIELDS = ("ldeg", "lstart", "gstart", "lindices", "ell", "llogw",
                "lts", "ell_logw", "ell_ts")
SAMPLE_FIELDS = ("nodes", "node_valid", "node_state", "rows", "cols", "eptr",
                 "edge_valid")
STATIC, RELATIVE, DYNAMIC = 0, 1, 2


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def _tmesh(n):
    return make_mesh((n, 1), device="cpu")


def _karate():
    _x, _y, ei = jload_karate()
    cp, ri, _ = jto_csc(np.asarray(ei), 34)
    return np.asarray(cp), np.asarray(ri)


def _hub_graph():
    """200 nodes, 1,600 random edges and node 0 with 150 more in-edges:
    max degree past both ELL widths (no table; Floyd and window engines)."""
    r = np.random.default_rng(11)
    src = np.concatenate([r.integers(0, 200, 1600), r.integers(1, 200, 150)])
    dst = np.concatenate([r.integers(0, 200, 1600), np.zeros(150, np.int64)])
    cp, ri, _ = jto_csc(np.stack([src, dst]), 200)
    return np.asarray(cp), np.asarray(ri)


GRAPHS = {"karate": _karate(), "hub": _hub_graph()}


def _edge_values(num_edges, seed=3):
    r = np.random.default_rng(seed)
    return (r.uniform(0.1, 2.0, num_edges).astype(np.float32),
            r.integers(0, 100, num_edges).astype(np.int64))


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("name,attrs,ell_table",
                         [("karate", True, None), ("karate", False, False),
                          ("hub", True, True)])
def test_partitioned_graph_matches_jax(P, name, attrs, ell_table):
    cp, ri = GRAPHS[name]
    kw = dict(ell_table=ell_table)
    if attrs:
        w, ts = _edge_values(ri.shape[0])
        kw.update(edge_weights=w, edge_timestamps=ts)
    jg = jds.build_partitioned_graph(cp, ri, P, **kw)
    tg = build_partitioned_graph(cp, ri, P, device="cpu", **kw)
    assert isinstance(tg, PartitionedGraph)
    for f in GRAPH_FIELDS:
        a, b = getattr(jg, f), getattr(tg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == torch.from_numpy(np.array(a)).dtype, f
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), f)
    for f in ("num_nodes", "num_parts", "rows_per_part", "local_edge_cap",
              "max_degree"):
        assert getattr(tg, f) == getattr(jg, f), f
    assert tg.nbytes() > 0


def test_batched_key_draws_match_vmap():
    key = jax.random.fold_in(jax.random.key(5), 3)
    tkey = rng.fold_in(rng.key(5), 3)
    uids = np.random.default_rng(0).integers(0, 2**31, 64).astype(np.int32)
    jk = jax.vmap(lambda u: jax.random.fold_in(key, u))(
        jnp.asarray(uids).astype(jnp.uint32))
    tk = rng.fold_in_many(tkey, torch.from_numpy(uids))
    np.testing.assert_array_equal(
        tk.numpy(), np.asarray(jax.random.key_data(jk)).astype(np.int64))
    np.testing.assert_array_equal(
        rng.fold_in_each(tk, 9).numpy(),
        np.asarray(jax.random.key_data(
            jax.vmap(lambda k: jax.random.fold_in(k, 9))(jk))))
    np.testing.assert_array_equal(
        rng.uniform_each(tk, (3, 5), 1e-12).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (3, 5), jnp.float32, minval=1e-12))(jk)))
    hi = np.random.default_rng(1).integers(1, 1000, 64).astype(np.int32)
    np.testing.assert_array_equal(
        rng.randint_each(tk, (7,), 0, torch.from_numpy(hi)[:, None]).numpy(),
        np.asarray(jax.vmap(lambda k, h: jax.random.randint(
            k, (7,), 0, h, dtype=jnp.int32))(jk, jnp.asarray(hi))))


MODES = {
    "uniform": {},
    "replace": dict(with_replacement=True),
    "weighted": dict(weighted=True),
    "weighted_replace": dict(weighted=True, with_replacement=True),
    "static": dict(filter=((0, 50), True, STATIC)),
    "relative": dict(filter=((-40, 40), True, RELATIVE)),
    "dynamic": dict(filter=((-60, 60), False, DYNAMIC)),
}
CASES = [  # (graph, mode, P of the JAX comparison, capacity factor)
    ("karate", "uniform", 1, 1.3), ("karate", "uniform", 4, 0.6),
    ("karate", "replace", 2, 1.3), ("karate", "weighted", 4, 1.3),
    ("karate", "weighted_replace", 2, 1.3), ("karate", "static", 4, 1.3),
    ("karate", "relative", 1, 1.3), ("karate", "dynamic", 2, 1.3),
    ("hub", "uniform", 4, 1.3), ("hub", "weighted", 2, 1.3),
    ("hub", "weighted_replace", 4, 0.5), ("hub", "dynamic", 1, 1.3),
]


def _layers(sample, P):
    """Per-layer concatenation of the rank blocks (the P = 1 layout), with
    invalid slots' values masked."""
    nb, eb = sample.node_base, sample.edge_base
    out = {}
    for f, base, mask in (("nodes", nb, "node_valid"),
                          ("node_state", nb, "node_valid"),
                          ("node_valid", nb, None),
                          ("eptr", eb, "edge_valid"),
                          ("edge_valid", eb, None)):
        a = getattr(sample, f)
        if mask is not None:
            a = torch.where(getattr(sample, mask), a, -1)
        out[f] = torch.cat([torch.cat([a[d][base[l]: base[l + 1]]
                                       for d in range(P)])
                            for l in range(len(base) - 1)])
    return out


@pytest.mark.parametrize("name,mode,P,cf", CASES)
def test_dist_sample_neighbors_matches_jax(name, mode, P, cf):
    cp, ri = GRAPHS[name]
    w, ts = _edge_values(ri.shape[0])
    B = 8
    seeds = np.arange(0, 2 * B, 2, dtype=np.int32) % (cp.shape[0] - 1)
    kw = dict(MODES[mode], capacity_factor=cf,
              window=64 if name == "hub" else 256)
    if "filter" in kw:
        kw["filter"] = (kw["filter"], np.random.default_rng(7).integers(
            20, 80, B).astype(np.int32))
    fanouts = (4, 3)
    key = 4 + P
    jg = jds.build_partitioned_graph(cp, ri, P, edge_weights=w,
                                     edge_timestamps=ts)
    js, jovf = jds.dist_sample_neighbors(jax.random.key(key), jg, seeds,
                                         fanouts, _jmesh(P), **kw)
    tg = build_partitioned_graph(cp, ri, P, edge_weights=w,
                                 edge_timestamps=ts, device="cpu")
    ts_, tovf = dist_sample_neighbors(rng.key(key), tg, seeds, fanouts,
                                      _tmesh(P), **kw)
    for f in SAMPLE_FIELDS:
        np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
    assert ts_.node_base == tuple(js.node_base)
    # the port's own law, where capacity drops nothing
    kw.update(capacity_factor=8.0, num_rounds=4)
    trees = []
    for p in (1, 2, 4):
        tg = build_partitioned_graph(cp, ri, p, edge_weights=w,
                                     edge_timestamps=ts, device="cpu")
        ts_, tovf = dist_sample_neighbors(rng.key(key), tg, seeds, fanouts,
                                          _tmesh(p), **kw)
        assert int(tovf.sum()) == 0
        trees.append(_layers(ts_, p))
    for t in trees[1:]:
        for f in t:
            assert torch.equal(t[f], trees[0][f]), f


def test_skewed_frontier_retries_match_jax():
    """Every seed the same hub: a tight single round overflows, retry
    rounds lose nothing, and the retried trees are the P = 1 tree."""
    cp, ri = GRAPHS["karate"]
    hub = int(np.argmax(np.diff(cp)))
    seeds = np.full((8,), hub, dtype=np.int32)
    kw = dict(capacity_factor=0.5)
    jg = jds.build_partitioned_graph(cp, ri, 4)
    tg = build_partitioned_graph(cp, ri, 4, device="cpu")
    for rounds in (1, 16):
        js, jovf = jds.dist_sample_neighbors(jax.random.key(11), jg, seeds,
                                             (4, 3), _jmesh(4),
                                             num_rounds=rounds, **kw)
        ts_, tovf = dist_sample_neighbors(rng.key(11), tg, seeds, (4, 3),
                                          _tmesh(4), num_rounds=rounds, **kw)
        np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
        for f in SAMPLE_FIELDS:
            np.testing.assert_array_equal(getattr(ts_, f).numpy(),
                                          np.asarray(getattr(js, f)))
        assert (int(tovf.sum()) > 0) == (rounds == 1)
    one, _ = dist_sample_neighbors(rng.key(11), build_partitioned_graph(
        cp, ri, 1, device="cpu"), seeds, (4, 3), _tmesh(1), num_rounds=16,
        **kw)
    a, b = _layers(ts_, 4), _layers(one, 1)
    for f in a:
        assert torch.equal(a[f], b[f]), f


def test_sampler_checks_its_inputs():
    cp, ri = GRAPHS["karate"]
    g2 = build_partitioned_graph(cp, ri, 2, device="cpu")
    with pytest.raises(ValueError, match="partitioned for 2"):
        dist_sample_neighbors(rng.key(0), g2, np.arange(4), (2,), _tmesh(4))
    with pytest.raises(ValueError, match="edge_weights"):
        dist_sample_neighbors(rng.key(0), g2, np.arange(4), (2,), _tmesh(2),
                              weighted=True)
    with pytest.raises(ValueError, match="divide"):
        dist_sample_neighbors(rng.key(0), g2, np.arange(3), (2,), _tmesh(2))
