"""Uniform neighbor sampling of the torch port against the JAX package:
bit-exact array for array on every engine (ELL lane top-k, aligned window,
Floyd, with replacement), and valid under tests/validators.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tch_geometric_tpu as tgt
from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.sampling import primitives as jprim
from tch_geometric_tpu.sampling.neighbor import compact_sample as jcompact
from tch_geometric_tpu.sampling.neighbor import sample_neighbors as jsample
from tch_geometric_tpu_torch.data import io as tio
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.sampling import primitives, rng
from tch_geometric_tpu_torch.sampling.neighbor import (
    compact_sample, neighbor_sampling_homogenous, sample_neighbors)
from tch_geometric_tpu_torch.utils.config import (TemporalEdgeFilter,
                                                  UniformEdgeSampler,
                                                  WeightedEdgeSampler)

from validators import validate_neighbor_samples

FIELDS = ("nodes", "node_valid", "node_state", "rows", "cols", "eptr",
          "edge_valid")
ENGINES = {
    "ell": {},
    "window": {"ell_table": False},
    "floyd": {"ell_table": False, "window_table": False},
}


def _load(name):
    x, _, ei = (tio.load_karate_graph() if name == "karate"
                else tio.load_fake_dataset())
    n = x.shape[0]
    cp, ri, _ = to_csc(ei, n)
    return n, cp, ri


def _assert_same(ts, js):
    assert ts.node_base == js.node_base and ts.edge_base == js.edge_base
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("name", ["karate", "fakedataset"])
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("replace", [False, True])
def test_sample_neighbors_bit_exact(name, engine, replace):
    n, cp, ri = _load(name)
    kw = ENGINES[engine]
    g = make_graph(cp, ri, num_src=n, num_dst=n, device="cpu", **kw)
    jg = jmake_graph(cp, ri, num_src=n, num_dst=n, **kw)
    assert (g.ell is not None) == (engine == "ell")
    assert (g.indices_win is not None) == (engine == "window")
    seeds = np.arange(0, n, max(1, n // 37))
    fanouts = [6, 3, 2] if name == "karate" else [5, 3]
    for s in (0, 17):
        ts = sample_neighbors(g, seeds, fanouts, key=rng.key(s),
                              sampler=UniformEdgeSampler(replace))
        js = jsample(jg, seeds, fanouts, key=jax.random.key(s),
                     sampler=tgt.UniformEdgeSampler(replace))
        _assert_same(ts, js)
        samples, rows, cols, _, offs = compact_sample(ts)
        validate_neighbor_samples(cp, ri, samples, samples, rows, cols,
                                  offs, fanouts)


def test_compact_and_reference_api_exact(karate):
    x, _, ei = karate
    n = x.shape[0]
    cp, ri, _ = to_csc(ei, n)
    seeds = np.array([0, 1, 4, 5, 33])
    g = make_graph(cp, ri, num_src=n, num_dst=n, device="cpu")
    jg = jmake_graph(cp, ri, num_src=n, num_dst=n)
    ts = sample_neighbors(g, seeds, [4, 3], key=rng.key(2))
    js = jsample(jg, seeds, [4, 3], key=jax.random.key(2))
    ours, theirs = compact_sample(ts), jcompact(js)
    for a, b in zip(ours[:4], theirs[:4]):
        np.testing.assert_array_equal(a, b)
    assert ours[4] == theirs[4]
    a = neighbor_sampling_homogenous(cp, ri, seeds, [4, 3],
                                     UniformEdgeSampler(False),
                                     key=rng.key(4), device="cpu")
    b = tgt.neighbor_sampling_homogenous(cp, ri, seeds, [4, 3],
                                         tgt.UniformEdgeSampler(False),
                                         key=jax.random.key(4))
    for u, v in zip(a[:4], b[:4]):
        np.testing.assert_array_equal(u, v)
    assert a[4] == b[4]


DEGS = np.array([0, 1, 2, 3, 4, 5, 9, 30, 62, 0, 7])


@pytest.mark.parametrize("k", [1, 4, 10])
def test_engines_bit_exact_and_zeroed(k):
    key, tkey = jax.random.key(6), rng.key(6)
    tdeg = torch.from_numpy(DEGS)
    for ours, theirs in (
            (primitives.floyd_sample(tkey, tdeg, k),
             jprim.floyd_sample(key, jnp.asarray(DEGS), k)),
            (primitives.uniform_lane_topk(tkey, tdeg, 62, k),
             jprim.uniform_lane_topk(key, jnp.asarray(DEGS), 62, k)),
            (primitives.uniform_lane_topk(tkey, tdeg, 8, k),
             jprim.uniform_lane_topk(key, jnp.asarray(DEGS), 8, k)),
            (primitives.replacement_positions(tkey, tdeg, k),
             jprim.replacement_positions(key, jnp.asarray(DEGS), k))):
        pos, valid = ours
        np.testing.assert_array_equal(pos.numpy(), np.asarray(theirs[0]))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(theirs[1]))
        # invalid slots hold position 0 (ties among the -inf lanes of the
        # top-k are never exposed)
        assert (pos[~valid] == 0).all()


def test_top_k_ties_follow_lax():
    vals = np.array([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf, 0.5],
                     [-np.inf] * 7], np.float32)
    tv, ti = primitives.top_k(torch.from_numpy(vals), 6)
    jv, ji = jax.lax.top_k(jnp.asarray(vals), 6)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_unported_samplers_raise(karate):
    x, _, ei = karate
    n = x.shape[0]
    cp, ri, _ = to_csc(ei, n)
    g = make_graph(cp, ri, num_src=n, num_dst=n, device="cpu")
    with pytest.raises(NotImplementedError):
        sample_neighbors(g, [0], [2], key=rng.key(0),
                         sampler=WeightedEdgeSampler(np.ones(len(ri))))
    with pytest.raises(NotImplementedError):
        sample_neighbors(g, [0], [2], key=rng.key(0),
                         filter=TemporalEdgeFilter((0, 1),
                                                   np.zeros(len(ri), np.int64)))
