"""The data layer of the torch port against the JAX package, exactly equal:
``SparseGraph.find_edge`` / ``has_edge`` (karate, a graph with hubs and
empty rows, pointers out of range; on a graph without edges, where JAX's
gather raises, every lookup is -1), both
``ind2ptr``s, ``coo_to_csc_device``, the native C++ sort (against the
JAX package's native build and the numpy sort, and its numpy fallback),
``load_ogbn_dir`` on the checked-in ogbn-products miniature in both
layouts, and ``planted_hetero`` array for array."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tch_geometric_tpu as tgt
from tch_geometric_tpu import native as jnative
from tch_geometric_tpu.data import ogb as jogb
from tch_geometric_tpu.data import storage as jstorage
from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu_torch import native
from tch_geometric_tpu_torch.data import (coo_to_csc_device, ind2ptr,
                                          ind2ptr_np, io, load_ogbn_dir,
                                          make_graph, planted_hetero,
                                          storage, to_csc, to_csr)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _hub_graph(seed=0, n=300):
    """Two hubs of in-degree 150 and 260, a third of the rows empty, the
    rest Poisson(3): no ELL table fits, and the search takes 9 steps."""
    r = np.random.default_rng(seed)
    deg = r.poisson(3, n)
    deg[r.choice(n, n // 3, replace=False)] = 0
    deg[:2] = (150, 260)
    dst = np.repeat(np.arange(n), deg)
    src = r.integers(0, n, dst.shape[0])
    return n, np.stack([src, dst])


def _graph(name):
    if name == "karate":
        x, _, ei = io.load_karate_graph()
        return x.shape[0], ei
    if name == "hubs":
        return _hub_graph()
    return 12, np.zeros((2, 0), np.int64)          # no edges


@pytest.mark.parametrize("name", ["karate", "hubs", "edgeless"])
def test_find_edge_has_edge_exact(name):
    n, ei = _graph(name)
    cp, ri, _ = to_csc(ei, n)
    g = make_graph(cp, ri, num_src=n, num_dst=n, device="cpu")
    jg = jmake_graph(cp, ri, num_src=n, num_dst=n)
    r = np.random.default_rng(1)
    # every real edge, random pairs, u at num_ptr_nodes and beyond
    real_u = np.repeat(np.arange(n), np.diff(cp))
    u = np.concatenate([real_u, r.integers(0, n, 2000), [n, n, n + 5]])
    v = np.concatenate([ri, r.integers(-1, n + 1, 2000), [0, n - 1, 3]])
    ours = g.find_edge(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    if not len(ri):
        # JAX's gather from the empty index array raises: no edge, -1
        np.testing.assert_array_equal(ours, -1)
        assert not g.has_edge(u, v).any()
        return
    theirs = np.asarray(jg.find_edge(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        g.has_edge(u, v).numpy(), np.asarray(jg.has_edge(u, v)))
    # a real edge's lookup is its own pointer (rows hold no duplicates
    # here, or the first of equal neighbors)
    hit = ours[: len(ri)]
    assert (hit >= 0).all()
    np.testing.assert_array_equal(ri[hit], ri)
    # 2-D queries keep their shape
    assert g.find_edge(u[:6].reshape(2, 3), v[:6].reshape(2, 3)).shape \
        == (2, 3)


def test_ind2ptr_both_versions():
    ind = np.array([0, 0, 2, 2, 2, 5])
    np.testing.assert_array_equal(ind2ptr_np(ind, 6),
                                  jstorage.ind2ptr_np(ind, 6))
    ours = ind2ptr(torch.from_numpy(ind), 6)
    assert torch.is_tensor(ours) and ours.dtype == torch.long
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jstorage.ind2ptr(jnp.asarray(ind), 6)))
    empty = np.zeros(0, np.int64)
    np.testing.assert_array_equal(ind2ptr(torch.from_numpy(empty), 3)
                                  .numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(ind2ptr_np(empty, 3), [0, 0, 0, 0])
    # the top level keeps the numpy version, as the JAX package does
    import tch_geometric_tpu_torch as tt
    assert tt.ind2ptr is ind2ptr_np


@pytest.mark.parametrize("name", ["karate", "hubs", "edgeless"])
def test_coo_to_csc_device_exact(name):
    n, ei = _graph(name)
    for size in ((n, n), (n + 3, n + 7)):
        ours = coo_to_csc_device(torch.from_numpy(ei[0]),
                                 torch.from_numpy(ei[1]), *size)
        theirs = jstorage.coo_to_csc_device(jnp.asarray(ei[0]),
                                            jnp.asarray(ei[1]), *size)
        host = to_csc(ei, size)
        for a, b, c in zip(ours, theirs, host):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), c)


@pytest.mark.parametrize("csc", [True, False])
def test_native_csx_exact(csc):
    """The port's C++ build (its own copy of the source, built into
    build/native) against the JAX package's build and the numpy sort,
    on a rectangular graph with empty rows and repeated edges."""
    assert native.available()
    r = np.random.default_rng(2)
    n_r, n_c, E = 500, 300, 20000
    row, col = r.integers(0, n_r, E), r.integers(0, n_c, E)
    row[:50] = row[50:100]
    col[:50] = col[50:100]
    ours = native.coo_to_csx(row, col, n_r, n_c, csc)
    numpy_ = storage._numpy_csx(np.stack([row, col]), n_r, n_c, csc)
    for a, c in zip(ours, numpy_):
        np.testing.assert_array_equal(a, c)
    if jnative.available():
        for a, b in zip(ours, jnative.coo_to_csx(row, col, n_r, n_c, csc)):
            np.testing.assert_array_equal(a, b)
    ind = np.sort(r.integers(0, 40, 200))
    np.testing.assert_array_equal(native.ind2ptr(ind, 45),
                                  ind2ptr_np(ind, 45))
    assert native.lib_path().parent.name == "native"
    assert native.lib_path().parent.parent.name == "build"


def test_native_oracles_match_jax_build():
    """The golden sampler and node2vec oracle of the port's build give
    the JAX build's outputs for the same seed (the same C++ code)."""
    if not jnative.available():
        pytest.skip("the JAX package's native build is unavailable")
    x, _, ei = io.load_karate_graph()
    cp, ri, _ = to_csc(ei, 34)
    for kw in ({}, {"with_replacement": False},
               {"weights": np.linspace(0.5, 2.0, len(ri))}):
        ours = native.neighbor_sample_golden(cp, ri, [0, 1, 4, 5], [4, 3],
                                             seed=7, **kw)
        theirs = jnative.neighbor_sample_golden(cp, ri, np.array(
            [0, 1, 4, 5]), np.array([4, 3]), seed=7, **kw)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
    rp, ci, _ = to_csr(ei, 34)
    np.testing.assert_array_equal(
        native.random_walk_golden(rp, ci, np.arange(34), 10, 0.5, 2.0, 3),
        jnative.random_walk_golden(rp, ci, np.arange(34), 10, 0.5, 2.0, 3))


def test_to_csc_uses_native_and_falls_back(monkeypatch, capsys, tmp_path):
    x, _, ei = io.load_karate_graph()
    with_native = to_csc(ei, 34)
    monkeypatch.setattr(native, "available", lambda: False)
    for a, b in zip(with_native, to_csc(ei, 34)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(to_csr(ei, 34), tgt.to_csr(ei, 34)):
        np.testing.assert_array_equal(a, b)
    # a failed build says so on stderr and gives None, leaving no file
    native.lib_path()                  # the toolchain's key, read once
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)

    def no_compiler(*a, **k):
        raise FileNotFoundError("g++")
    monkeypatch.setattr(native.subprocess, "run", no_compiler)
    assert native._build() is None
    assert "numpy fallback" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(ValueError):
        to_csc(np.array([[0, 9], [1, 2]]), 5)


def test_load_ogbn_dir_both_layouts(tmp_path):
    fix = os.path.join(FIXTURES, "ogbn_products_mini")
    data, split = load_ogbn_dir(fix)
    jdata, jsplit = jogb.load_ogbn_dir(fix)
    for f in ("x", "edge_index", "y"):
        np.testing.assert_array_equal(getattr(data, f), getattr(jdata, f))
        assert getattr(data, f).dtype == getattr(jdata, f).dtype
    assert sorted(split) == sorted(jsplit) == ["test", "train", "valid"]
    for k in split:
        np.testing.assert_array_equal(split[k], jsplit[k])
    np.savez(tmp_path / "graph.npz", x=data.x, edge_index=data.edge_index,
             y=data.y, train_idx=split["train"])
    d2, s2 = load_ogbn_dir(str(tmp_path))
    j2, js2 = jogb.load_ogbn_dir(str(tmp_path))
    np.testing.assert_array_equal(d2.x, j2.x)
    np.testing.assert_array_equal(d2.edge_index, j2.edge_index)
    assert list(s2) == list(js2) == ["train"]
    with pytest.raises(FileNotFoundError):
        load_ogbn_dir(str(tmp_path / "missing"))


@pytest.mark.parametrize("anti_paired", [False, True])
def test_planted_hetero_exact(anti_paired):
    kw = dict(num_types=3, num_rels=4, nodes_per_type=300,
              edges_per_rel=1500, feat_dim=8, num_classes=4, seed=5,
              anti_paired=anti_paired)
    ours, theirs = planted_hetero(**kw), jogb.planted_hetero(**kw)
    for a, b in zip(ours, theirs):
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)
