"""Weighted and temporal neighbor sampling of the torch port against the
JAX package, bit-exact array for array on every engine (ELL windowed
values, aligned window table, plain window), with ``node_state`` compared
under ``node_valid`` (JAX leaves padding at invalid slots); and the plain
ops of the slice: ``sample_edges_uniform``, ``csc_sort_edges``,
``csc_edge_cumsum`` and ``spmm(edge_weight=, agg="max")``.

The port's Gumbel noise equals ``jax.random.gumbel`` up to the last ulp of
``log``, so a sampled position could differ only where two candidates'
keys lie within a few ulps; on these fixtures and seeds every output is
exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tch_geometric_tpu as tgt
from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.ops.segment import csc_edge_cumsum as jcumsum
from tch_geometric_tpu.ops.segment import csc_sort_edges as jsort
from tch_geometric_tpu.ops.spmm import spmm as jspmm
from tch_geometric_tpu.sampling import primitives as jprim
from tch_geometric_tpu.sampling.neighbor import (_sample_neighbors_impl as
                                                 jimpl)
from tch_geometric_tpu.sampling.neighbor import sample_edges_uniform as jseu
from tch_geometric_tpu.sampling.neighbor import sample_neighbors as jsample
from tch_geometric_tpu_torch.data import io as tio
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.ops import csc_edge_cumsum, csc_sort_edges, spmm
from tch_geometric_tpu_torch.sampling import primitives, rng
from tch_geometric_tpu_torch.sampling.neighbor import (
    compact_sample, neighbor_sampling_homogenous, sample_edges_uniform,
    sample_neighbors)
from tch_geometric_tpu_torch.utils.config import (TEMPORAL_SAMPLE_DYNAMIC,
                                                  TemporalEdgeFilter,
                                                  UniformEdgeSampler,
                                                  WeightedEdgeSampler)

from test_golden_mirrors import golden_weighted_neighbor
from validators import validate_neighbor_samples

FIELDS = ("nodes", "node_valid", "node_state", "rows", "cols", "eptr",
          "edge_valid")
ENGINES = {
    "ell": {},
    "window": {"ell_table": False},
    "plain": {"ell_table": False, "window_table": False},
}


def _dense_graph(seed=0, n=40, max_deg=200):
    """<= 4,000 edges with degrees up to ``max_deg``: wider than any ELL
    table, so it runs the window engines over several chunks."""
    r = np.random.default_rng(seed)
    deg = np.minimum(r.integers(0, max_deg, n), max_deg)
    deg[:3] = (0, 1, max_deg)
    dst = np.repeat(np.arange(n), deg)
    src = r.integers(0, n, dst.shape[0])
    cp, ri, _ = to_csc(np.stack([src, dst]), n)
    return n, cp, ri


def _load(name):
    if name == "dense":
        return _dense_graph()
    x, _, ei = (tio.load_karate_graph() if name == "karate"
                else tio.load_fake_dataset())
    n = x.shape[0]
    cp, ri, _ = to_csc(ei, n)
    return n, cp, ri


def _graphs(name, engine):
    n, cp, ri = _load(name)
    kw = ENGINES[engine]
    g = make_graph(cp, ri, num_src=n, num_dst=n, device="cpu", **kw)
    jg = jmake_graph(cp, ri, num_src=n, num_dst=n, **kw)
    return n, cp, ri, g, jg


def _assert_same(ts, js):
    assert ts.node_base == js.node_base and ts.edge_base == js.edge_base
    valid = ts.node_valid.numpy()
    for f in FIELDS:
        ours, theirs = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        if f == "node_state":
            # JAX's state at an invalid slot is padding (DYNAMIC: the
            # lane-0 timestamp of a clipped row read)
            ours, theirs = ours[valid], theirs[valid]
        np.testing.assert_array_equal(ours, theirs, err_msg=f)


def _validate(cp, ri, ts, fanouts):
    samples, rows, cols, _, offs = compact_sample(ts)
    validate_neighbor_samples(cp, ri, samples, samples, rows, cols, offs,
                              fanouts)


def _seeds(n):
    return np.arange(0, n, max(1, n // 31))


DEGS = np.array([0, 1, 2, 3, 5, 9, 17, 30, 41, 0, 7])


@pytest.mark.parametrize("choice", [False, True], ids=["topk", "choice"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("window", [8, 256])
def test_window_engines_bit_exact(choice, weighted, masked, window):
    r = np.random.default_rng(3)
    starts = np.concatenate([[0], np.cumsum(DEGS)[:-1]])
    E = int(DEGS.sum())
    logw = np.log(r.uniform(0.1, 4.0, E).astype(np.float32))
    ok = r.random(E) < 0.6
    kw = dict(max_degree=int(DEGS.max()), num_edges=E, window=window)
    tkw, jkw = dict(kw), dict(kw)
    if weighted:
        tkw["logw_at"] = torch.from_numpy(logw).__getitem__
        jkw["logw_at"] = lambda e: jnp.asarray(logw)[e]
    if masked:
        tkw["mask_at"] = torch.from_numpy(ok).__getitem__
        jkw["mask_at"] = lambda e: jnp.asarray(ok)[e]
    ours_f = (primitives.window_choice_sample if choice
              else primitives.window_topk_sample)
    theirs_f = (jprim.window_choice_sample if choice
                else jprim.window_topk_sample)
    for k in (1, 4, 12):
        pos, valid = ours_f(rng.key(k), torch.from_numpy(starts),
                            torch.from_numpy(DEGS), k, **tkw)
        jpos, jvalid = theirs_f(jax.random.key(k), jnp.asarray(starts),
                                jnp.asarray(DEGS), k, **jkw)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        assert (pos[~valid] == 0).all()


@pytest.mark.parametrize("k", [1, 5])
def test_masked_gumbel_topk_bit_exact(k):
    r = np.random.default_rng(4)
    logits = r.normal(size=(6, 9)).astype(np.float32)
    logits[r.random(logits.shape) < 0.4] = -np.inf
    logits[0] = -np.inf
    ours = primitives.masked_gumbel_topk(rng.key(9), torch.from_numpy(logits),
                                         k)
    theirs = jprim.masked_gumbel_topk(jax.random.key(9), jnp.asarray(logits),
                                      k)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert primitives.cdiv(7, 3) == jprim.cdiv(7, 3) == 3


def test_argmax_first_maximum():
    vals = np.array([[1.0, 3.0, 3.0, -np.inf], [-np.inf] * 4], np.float32)
    np.testing.assert_array_equal(
        primitives.argmax(torch.from_numpy(vals)).numpy(),
        np.asarray(jnp.argmax(jnp.asarray(vals), axis=-1)))


# the dense graph's degrees exceed every ELL width, so it has no ELL case
@pytest.mark.parametrize("name,engine", [
    (name, engine) for name in ("karate", "fakedataset", "dense")
    for engine in ENGINES if (name, engine) != ("dense", "ell")])
@pytest.mark.parametrize("replace", [False, True])
def test_weighted_bit_exact(name, engine, replace):
    n, cp, ri, g, jg = _graphs(name, engine)
    assert (g.ell is not None) == (engine == "ell")
    w = np.abs(np.random.default_rng(5).normal(size=len(ri))) + 0.1
    seeds = _seeds(n)
    fanouts = [6, 3, 2] if name == "karate" else [5, 3]
    for s in (0, 11):
        ts = sample_neighbors(g, seeds, fanouts, key=rng.key(s),
                              sampler=WeightedEdgeSampler(w, replace))
        if replace:
            # the JAX package reaches weighted draws with replacement
            # through its implementation's arguments
            js = jimpl(jax.random.key(s), jg, jnp.asarray(seeds),
                       jnp.zeros(len(seeds), jnp.int32),
                       jnp.log(jnp.asarray(w, jnp.float32)), None,
                       tuple(fanouts), True, None, 256)
        else:
            js = jsample(jg, seeds, fanouts, key=jax.random.key(s),
                         sampler=tgt.WeightedEdgeSampler(w))
        _assert_same(ts, js)
        _validate(cp, ri, ts, fanouts)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["static", "relative",
                                                 "dynamic"])
@pytest.mark.parametrize("forward", [True, False])
def test_temporal_bit_exact(engine, mode, forward):
    n, cp, ri, g, jg = _graphs("fakedataset", engine)
    r = np.random.default_rng(6)
    ts = r.integers(0, 100, len(ri)).astype(np.int64)
    seeds = _seeds(n)
    state = r.integers(0, 100, len(seeds)).astype(np.int64)
    window = (0, 60) if mode == 0 else (-30, 40)
    filt = TemporalEdgeFilter(window, ts, forward, mode)
    jfilt = tgt.TemporalEdgeFilter(window, ts, forward, mode)
    for s, replace in ((1, False), (2, True)):
        out = sample_neighbors(g, seeds, [5, 3], key=rng.key(s),
                               sampler=UniformEdgeSampler(replace),
                               filter=(filt, state))
        js = jsample(jg, seeds, [5, 3], key=jax.random.key(s),
                     sampler=tgt.UniformEdgeSampler(replace),
                     filter=(jfilt, state))
        _assert_same(out, js)
        _validate(cp, ri, out, [5, 3])
        # every valid edge satisfies the window against its parent's state
        ev, e = out.edge_valid.numpy(), out.eptr.numpy()
        parent_state = out.node_state.numpy()[out.cols.numpy()]
        d = ts[e] if mode == 0 else (ts[e] - parent_state) * (1 if forward
                                                               else -1)
        assert ((d[ev] >= window[0]) & (d[ev] <= window[1])).all()
        if mode == TEMPORAL_SAMPLE_DYNAMIC:
            child = out.node_state.numpy()[out.rows.numpy()]
            np.testing.assert_array_equal(child[ev], ts[e][ev])


@pytest.mark.parametrize("engine", ["ell", "plain"])
def test_bare_filter_and_small_window(engine):
    """A bare filter starts from zero states; ``window`` below the degree
    scans several chunks."""
    name = "fakedataset" if engine == "ell" else "dense"
    n, cp, ri, g, jg = _graphs(name, engine)
    ts = np.random.default_rng(7).integers(-50, 50, len(ri)).astype(np.int64)
    filt = TemporalEdgeFilter((-20, 30), ts, True, 1)
    jfilt = tgt.TemporalEdgeFilter((-20, 30), ts, True, 1)
    seeds = _seeds(n)
    for replace in (False, True):
        ts_ = sample_neighbors(g, seeds, [4, 2], key=rng.key(3), filter=filt,
                               sampler=UniformEdgeSampler(replace), window=16)
        js = jsample(jg, seeds, [4, 2], key=jax.random.key(3), filter=jfilt,
                     sampler=tgt.UniformEdgeSampler(replace), window=16)
        _assert_same(ts_, js)
    assert not ts_.node_state.numpy()[: len(seeds)].any()


def test_golden_weighted_neighbor_mirror(karate):
    """The JAX package's NumPy mirror of the weighted ELL engine holds the
    port too."""
    _x, _y, ei = karate
    cp, ri, _ = to_csc(ei, 34)
    g = make_graph(cp, ri, num_src=34, num_dst=34, device="cpu")
    w = np.random.default_rng(0).uniform(0.1, 5.0, len(ri)).astype(np.float32)
    seeds = np.array([0, 1, 4, 5])
    out = sample_neighbors(g, seeds, [4, 3], key=rng.key(7),
                           sampler=WeightedEdgeSampler(w))
    n_g, v_g, e_g, ev_g = golden_weighted_neighbor(
        jax.random.key(7), cp, ri, np.log(w), seeds, [4, 3], g.max_degree)
    np.testing.assert_array_equal(out.node_valid.numpy(), v_g)
    np.testing.assert_array_equal(np.where(v_g, out.nodes.numpy(), -1),
                                  np.where(v_g, n_g, -1))
    np.testing.assert_array_equal(out.edge_valid.numpy(), ev_g)
    np.testing.assert_array_equal(out.eptr.numpy()[ev_g], e_g[ev_g])


def test_parity_api_compact_tuple(karate):
    x, _, ei = karate
    cp, ri, _ = to_csc(ei, 34)
    seeds = np.array([0, 1, 4, 5, 33])
    r = np.random.default_rng(8)
    w = r.uniform(0.1, 3.0, len(ri))
    ts = r.integers(0, 10, len(ri)).astype(np.int64)
    state = r.integers(0, 10, len(seeds)).astype(np.int64)
    for ours_kw, theirs_kw in (
            (dict(sampler=WeightedEdgeSampler(w)),
             dict(sampler=tgt.WeightedEdgeSampler(w))),
            (dict(filter=(TemporalEdgeFilter((0, 5), ts, True, 2), state)),
             dict(filter=(tgt.TemporalEdgeFilter((0, 5), ts, True, 2),
                          state)))):
        a = neighbor_sampling_homogenous(cp, ri, seeds, [4, 3],
                                         key=rng.key(4), device="cpu",
                                         **ours_kw)
        b = tgt.neighbor_sampling_homogenous(cp, ri, seeds, [4, 3],
                                             key=jax.random.key(4),
                                             **theirs_kw)
        for u, v in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(u, v)
        assert a[4] == b[4]
        validate_neighbor_samples(cp, ri, a[0], a[0], a[1], a[2], a[4],
                                  [4, 3])


@pytest.mark.parametrize("engine", ["ell", "plain"])
def test_sample_edges_uniform_bit_exact(engine):
    n, cp, ri, g, jg = _graphs("fakedataset", engine)
    frontier = np.arange(0, n, 7)
    fvalid = np.arange(len(frontier)) % 5 != 3
    for k in (3, 50):
        ours = sample_edges_uniform(rng.key(k), g, torch.from_numpy(frontier),
                                    torch.from_numpy(fvalid), k)
        theirs = jseu(jax.random.key(k), jg, jnp.asarray(frontier),
                      jnp.asarray(fvalid), k)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("descending", [False, True])
def test_csc_sort_edges(descending):
    r = np.random.default_rng(9)
    cp = np.array([0, 3, 3, 7, 12, 12])
    perm = r.permutation(12)
    w = r.integers(0, 4, 12).astype(np.float64)     # ties: stable order
    np.testing.assert_array_equal(csc_sort_edges(cp, perm, w, descending),
                                  jsort(cp, perm, w, descending))
    # pointer tails past the edge count are clamped
    cp2 = np.array([0, 5, 9, 14])
    np.testing.assert_array_equal(csc_sort_edges(cp2, perm, w, descending),
                                  jsort(cp2, perm, w, descending))


def test_csc_edge_cumsum():
    r = np.random.default_rng(10)
    cp = np.array([0, 2, 2, 6, 11, 13])
    for x in (r.integers(-5, 9, 12), r.random(12).astype(np.float32)):
        ours, theirs = csc_edge_cumsum(cp, x), jcumsum(cp, x)
        assert ours.dtype == theirs.dtype
        np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_spmm_edge_weight_and_max(agg):
    n, cp, ri = _dense_graph(seed=1, n=30, max_deg=40)   # node 0: no edges
    r = np.random.default_rng(11)
    x = r.normal(size=(n, 7)).astype(np.float32)
    w = r.uniform(0.2, 2.0, len(ri)).astype(np.float32)
    g = make_graph(cp, ri, num_src=n, num_dst=n, device="cpu")
    jg = jmake_graph(cp, ri, num_src=n, num_dst=n)
    for ew in (None, w):
        ours = spmm(g, torch.from_numpy(x), agg=agg,
                    edge_weight=None if ew is None else torch.from_numpy(ew))
        theirs = jspmm(jg, jnp.asarray(x), agg=agg,
                       edge_weight=None if ew is None else jnp.asarray(ew))
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-6, atol=1e-6)
    assert not ours[0].any()          # the empty row gives 0


def test_fanout_above_max_degree(karate):
    """On an ELL graph, a weighted fanout above ``max_degree`` (which
    JAX's ``lax.top_k`` refuses) gives the ``max_degree`` fanout's draws
    followed by invalid slots, as the window engines leave them."""
    _x, _y, ei = karate
    cp, ri, _ = to_csc(ei, 34)
    g = make_graph(cp, ri, num_src=34, num_dst=34, device="cpu")
    jg = jmake_graph(cp, ri, num_src=34, num_dst=34)
    P = g.max_degree
    w = np.random.default_rng(12).uniform(0.1, 5.0, len(ri))
    seeds = np.arange(34)
    ours = sample_neighbors(g, seeds, [P + 3], key=rng.key(2),
                            sampler=WeightedEdgeSampler(w))
    theirs = jsample(jg, seeds, [P], key=jax.random.key(2),
                     sampler=tgt.WeightedEdgeSampler(w))
    valid = ours.edge_valid.numpy().reshape(34, P + 3)
    eptr = ours.eptr.numpy().reshape(34, P + 3)
    assert not valid[:, P:].any()
    np.testing.assert_array_equal(
        valid[:, :P], np.asarray(theirs.edge_valid).reshape(34, P))
    np.testing.assert_array_equal(
        eptr[:, :P], np.asarray(theirs.eptr).reshape(34, P))
