"""Random walks of the torch port against the JAX package, exactly equal
from the same key: node2vec (p = q = 1, and p = 0.5, q = 2) on the ELL
carried-row path and on the binary-search path, temporal walks on both
paths, and CTDNE walks with each bias in both directions, with retries on a
graph where walks die; every step of every walk follows a real edge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tch_geometric_tpu as tgt
from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.sampling import walks as jwalks
from tch_geometric_tpu_torch import (biased_tempo_random_walk, random_walk,
                                     tempo_random_walk)
from tch_geometric_tpu_torch.data import io, make_graph, to_csr
from tch_geometric_tpu_torch.sampling import rng, walks

ENGINES = {"ell": {}, "plain": {"ell_table": False, "window_table": False}}


@pytest.fixture(scope="module")
def karate():
    _x, _y, ei = io.load_karate_graph()
    rp, ci, _ = to_csr(ei, 34)
    return rp, ci


def _dead_ends(n=60, seed=3):
    """Edges only from lower to higher ids, stamped with their target's id
    (so time moves forward along any path), out-degree 0-4 with a sixth of
    the nodes sinks: some attempts die and retry, some walks finish."""
    r = np.random.default_rng(seed)
    deg = r.integers(1, 5, n - 1)
    deg[r.random(n - 1) < 1 / 6] = 0
    src = np.repeat(np.arange(n - 1), deg)
    dst = src + 1 + r.integers(0, 6, src.shape[0])
    keep = dst < n
    rp, ci, perm = to_csr(np.stack([src[keep], dst[keep]]), n)
    return rp, ci, dst[keep][perm]


def _check_steps(rp, ci, walks_):
    edges = set(zip(np.repeat(np.arange(len(rp) - 1), np.diff(rp)), ci))
    for w in walks_:
        for a, b in zip(w, w[1:]):
            if b < 0:
                break
            assert (a, b) in edges, (a, b)


def _timestamps(n, e, seed):
    r = np.random.default_rng(seed)
    return r.integers(-1, 8, n), r.integers(-1, 8, e), r.integers(-1, 5, n)


@pytest.mark.parametrize("pq", [(1.0, 1.0), (0.5, 2.0)])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_node2vec_exact(karate, pq, engine):
    rp, ci = karate
    kw = ENGINES[engine]
    g = make_graph(rp, ci, num_src=34, num_dst=34, device="cpu", **kw)
    jg = jmake_graph(rp, ci, num_src=34, num_dst=34, **kw)
    assert (g.ell is None) == (engine == "plain")
    start = np.tile(np.arange(34), 2)
    trials = 1 if pq == (1.0, 1.0) else walks.NUM_TRIALS
    ours = walks._random_walk_impl(rng.key(3), g, torch.from_numpy(start),
                                   12, *pq, trials).numpy()
    theirs = np.asarray(jwalks._random_walk_impl(
        jax.random.key(3), jg, jnp.asarray(start), 12, jnp.float32(pq[0]),
        jnp.float32(pq[1]), trials))
    np.testing.assert_array_equal(ours, theirs)
    _check_steps(rp, ci, ours)
    # the parity API (ELL by default) from the same key
    api = random_walk(rp, ci, start, 12, *pq, key=rng.key(3), device="cpu")
    np.testing.assert_array_equal(
        api, tgt.random_walk(rp, ci, start, 12, *pq, key=jax.random.key(3)))
    assert api.dtype == np.int64 and api.shape == (68, 13)


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("window", [(0, 2), (-3, 6)])
def test_tempo_walk_exact(karate, engine, window):
    rp, ci = karate
    kw = ENGINES[engine]
    node_ts, edge_ts, start_ts = _timestamps(34, len(ci), 0)
    g = make_graph(rp, ci, num_src=34, num_dst=34, device="cpu", **kw)
    jg = jmake_graph(rp, ci, num_src=34, num_dst=34, **kw)
    start = np.arange(34)
    i32 = torch.int32
    ours = walks._tempo_walk_impl(
        rng.key(4), g, torch.from_numpy(node_ts).to(i32),
        torch.from_numpy(edge_ts).to(i32), torch.from_numpy(start),
        torch.from_numpy(start_ts).to(i32), 10, *window, 8)
    theirs = jwalks._tempo_walk_impl(
        jax.random.key(4), jg, jnp.asarray(node_ts, jnp.int32),
        jnp.asarray(edge_ts, jnp.int32), jnp.asarray(start),
        jnp.asarray(start_ts), 10, jnp.int32(window[0]),
        jnp.int32(window[1]), 8)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    w, t = (a.numpy() for a in ours)
    for i in range(34):                     # in the root's window, or none
        if start_ts[i] >= 0:
            ok = ((t[i] == -1) | ((t[i] >= start_ts[i] + window[0])
                                  & (t[i] < start_ts[i] + window[1])))
            assert ok.all()
    api = tempo_random_walk(rp, ci, node_ts, edge_ts, start, start_ts, 10,
                            window, key=rng.key(4), device="cpu")
    japi = tgt.tempo_random_walk(rp, ci, node_ts, edge_ts, start, start_ts,
                                 10, window, key=jax.random.key(4))
    for a, b in zip(api, japi):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bias", ["uniform", "linear", "exponential"])
@pytest.mark.parametrize("forward", [True, False])
def test_ctdne_walk_exact(karate, bias, forward):
    rp, ci = karate
    node_ts, edge_ts, start_ts = _timestamps(34, len(ci), 1)
    start = np.arange(34)
    args = (rp, ci, node_ts, edge_ts, start, start_ts, 8, bias, forward, 5)
    ours = biased_tempo_random_walk(*args, key=rng.key(5), device="cpu")
    theirs = tgt.biased_tempo_random_walk(*args, key=jax.random.key(5))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    _check_steps(rp, ci, ours[0])
    # the binary-search path gives the same walks
    g = make_graph(rp, ci, num_src=34, num_dst=34, device="cpu",
                   **ENGINES["plain"])
    i32 = torch.int32
    plain = walks._biased_tempo_walk_impl(
        rng.key(5), g, torch.from_numpy(node_ts).to(i32),
        torch.from_numpy(edge_ts).to(i32), torch.from_numpy(start),
        torch.from_numpy(start_ts).to(i32), 8, bias, forward, 5)
    np.testing.assert_array_equal(plain[0].numpy(), ours[0])
    np.testing.assert_array_equal(plain[1].numpy(), ours[1])


@pytest.mark.parametrize("retry_count", [1, 10])
def test_ctdne_retries_on_dead_ends(retry_count):
    rp, ci, edge_ts = _dead_ends()
    n = len(rp) - 1
    node_ts = np.arange(n)
    start = np.arange(n)
    start_ts = np.zeros(n, np.int64)
    args = (rp, ci, node_ts, edge_ts, start, start_ts, 6, "exponential",
            True, retry_count)
    ours = biased_tempo_random_walk(*args, key=rng.key(7), device="cpu")
    theirs = tgt.biased_tempo_random_walk(*args, key=jax.random.key(7))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    w, t = ours
    assert (w == -1).any() and (w[:, -1] >= 0).any()   # both kinds occur
    if retry_count > 1:                                 # retries finish more
        once = biased_tempo_random_walk(*args[:-1], 1, key=rng.key(7),
                                        device="cpu")[0]
        assert (w[:, -1] >= 0).sum() > (once[:, -1] >= 0).sum()
    for i in range(n):                                  # time moves forward
        ts = t[i][t[i] >= 0]
        assert (np.diff(ts) >= 0).all()
    _check_steps(rp, ci, w)


@pytest.mark.parametrize("walk", ["node2vec", "node2vec_pq", "tempo",
                                  "uniform", "linear", "exponential"])
def test_walks_on_a_graph_without_edges(walk):
    """Every walk on an edgeless graph dead-ends at its first step.  The JAX
    package's gathers reject an empty edge array, so its walks run on the
    same nodes plus one edge between two extra nodes, which no walk from
    the original nodes reaches: no draw of theirs depends on that edge."""
    n, start, start_ts = 3, np.array([0, 2, 1, 0]), np.array([3, 4, 0, 9])
    rp, ci = np.zeros(n + 1, np.int64), np.zeros(0, np.int64)
    jrp, jci = np.array([0, 0, 0, 0, 1, 1]), np.array([n + 1])
    node_ts = np.array([5, 7, -1])
    jnode_ts = np.concatenate([node_ts, [2, 2]])
    if walk.startswith("node2vec"):
        pq = (1.0, 1.0) if walk == "node2vec" else (0.5, 2.0)
        ours = (random_walk(rp, ci, start, 3, *pq, key=rng.key(8),
                            device="cpu"),)
        theirs = (tgt.random_walk(jrp, jci, start, 3, *pq,
                                  key=jax.random.key(8)),)
        want = np.full((4, 4), -1)
    elif walk == "tempo":
        args = (start, start_ts, 4, (0, 10))
        ours = tempo_random_walk(rp, ci, node_ts, ci, *args, key=rng.key(8),
                                 device="cpu")
        theirs = tgt.tempo_random_walk(jrp, jci, jnode_ts, [1], *args,
                                       key=jax.random.key(8))
        want = np.tile(start[:, None], 4)     # every step restarts
    else:
        args = (start, start_ts, 4, walk, True, 3)
        ours = biased_tempo_random_walk(rp, ci, node_ts, ci, *args,
                                        key=rng.key(8), device="cpu")
        theirs = tgt.biased_tempo_random_walk(jrp, jci, jnode_ts, [1], *args,
                                              key=jax.random.key(8))
        want = np.full((4, 4), -1)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    want[:, 0] = start
    np.testing.assert_array_equal(ours[0], want)


def test_walks_default_to_the_card(karate):
    """The parity walks default to ``device="cuda"`` and never fall back to
    the CPU: without a card the default call raises."""
    import inspect
    for f in (random_walk, tempo_random_walk, biased_tempo_random_walk):
        assert inspect.signature(f).parameters["device"].default == "cuda"
    rp, ci = karate
    if torch.cuda.is_available():
        assert random_walk(rp, ci, [0, 1], 3, key=rng.key(0)).shape == (2, 4)
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            random_walk(rp, ci, [0, 1], 3, key=rng.key(0))
    with pytest.raises(ValueError):
        biased_tempo_random_walk([0, 0], [], [0], [], [0], [0], 3, "cubic",
                                 device="cpu")
