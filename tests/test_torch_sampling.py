"""Uniform neighbor sampling of the torch port against the JAX package:
bit-exact array for array on every engine (ELL lane top-k, aligned window,
Floyd, with replacement), and valid under tests/validators.py; the hop
wrapper ``primitives.floyd_hop`` on the CPU against the composition of
engines it replaced and the JAX package's hop."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tch_geometric_tpu as tgt
from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.sampling import primitives as jprim
from tch_geometric_tpu.sampling.neighbor import _sample_one_hop as jhop
from tch_geometric_tpu.sampling.neighbor import compact_sample as jcompact
from tch_geometric_tpu.sampling.neighbor import sample_edges_uniform as jseu
from tch_geometric_tpu.sampling.neighbor import sample_neighbors as jsample
from tch_geometric_tpu_torch.data import io as tio
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.sampling import primitives, rng
from tch_geometric_tpu_torch.sampling.neighbor import (
    compact_sample, neighbor_sampling_homogenous, sample_neighbors)
from tch_geometric_tpu_torch.utils.config import UniformEdgeSampler

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


def _composition(key, g, frontier, fvalid, k, row0, window_table):
    """The hop as the sampler composed it before ``floyd_hop``: the degree
    from ``indptr``, ``floyd_sample``, the clamped edge pointers and the
    neighbor ids by the window table's gather or by ``indices``."""
    node = frontier.clamp(0, g.num_ptr_nodes - 1)
    starts, ends = g.neighbors_range(node)
    deg = torch.where(fvalid, ends - starts, 0)
    pos, valid = primitives.floyd_sample(key, deg, k, row0)
    eptr = (starts.long()[:, None] + pos).clamp(0, max(g.num_edges - 1, 0))
    if window_table and g.indices_win is not None:
        win, off = g.gather_neighbor_windows_rows(starts.long())
        neighbor = torch.gather(win, -1, off[..., None] + pos).long()
    else:
        neighbor = g.gather_neighbors(eptr)
    return deg, pos, valid, eptr, neighbor


def _hop_graphs(name, engine):
    n, cp, ri = _load(name)
    kw = ENGINES[engine]
    return (n, make_graph(cp, ri, num_src=n, num_dst=n, device="cpu", **kw),
            jmake_graph(cp, ri, num_src=n, num_dst=n, **kw))


def _hop_frontier(n):
    """Every node, ids past both ends, and every fifth row invalid."""
    frontier = np.concatenate([np.arange(n), [-3, n, n + 7, 0]])
    return frontier, np.arange(len(frontier)) % 5 != 3


@pytest.mark.parametrize("name", ["karate", "fakedataset"])
@pytest.mark.parametrize("engine", ["window", "floyd"])
@pytest.mark.parametrize("k", [1, 4, 10, 40])
def test_floyd_hop_plain_equals_the_composition_and_jax(name, engine, k):
    n, g, jg = _hop_graphs(name, engine)
    frontier, fvalid = _hop_frontier(n)
    tf, tv = torch.from_numpy(frontier), torch.from_numpy(fvalid)
    key = rng.key(k)
    before = rng.threefry_cuda.launches
    for window_table in (False, True):
        got = primitives.floyd_hop(key, g, tf, tv, k,
                                   window_table=window_table)
        want = _composition(key, g, tf, tv, k, 0, window_table)
        for f, a, b in zip(("deg", "pos", "valid", "eptr", "neighbor"),
                           got, want):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=f)
    assert rng.threefry_cuda.launches == before
    jkey = jax.random.key(k)
    theirs = jseu(jkey, jg, jnp.asarray(frontier), jnp.asarray(fvalid), k)
    ours = primitives.floyd_hop(key, g, tf, tv, k)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    state = np.zeros(len(frontier), np.int32)
    eptr, neighbor, valid, _ = jhop(jkey, jg, jnp.asarray(frontier),
                                    jnp.asarray(fvalid), jnp.asarray(state),
                                    k, with_replacement=False,
                                    log_weights=None, filter_cfg=None,
                                    timestamps=None, window=256)
    _, _, ovalid, oeptr, oneighbor = primitives.floyd_hop(
        key, g, tf, tv, k, window_table=True)
    for a, b in ((oeptr, eptr), (oneighbor, neighbor), (ovalid, valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("row0", [1, 37, 2**32 - 5])
def test_floyd_hop_block_is_the_whole_frontiers_rows(row0):
    """A block from frontier row ``row0`` draws that block of the whole
    frontier's draw, also where the counters cross ``2**32``."""
    n, g, _ = _hop_graphs("fakedataset", "floyd")
    frontier, fvalid = _hop_frontier(n)
    tf, tv = torch.from_numpy(frontier), torch.from_numpy(fvalid)
    key = torch.tensor([0x80000001, 0xFFFFFFFE])   # top bits set
    lead = 3
    whole = primitives.floyd_hop(
        key, g, torch.cat([tf[:lead], tf]), torch.cat([tv[:lead], tv]), 5,
        row0 - lead)
    block = primitives.floyd_hop(key, g, tf, tv, 5, row0)
    for a, b in zip(block, whole):
        np.testing.assert_array_equal(a.numpy(), b[lead:].numpy())
    assert block[2].any() and not block[2].all()
