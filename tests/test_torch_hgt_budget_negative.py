"""HGT, budget and negative sampling of the torch port against the JAX
package, exactly equal from the same key and inputs: the padded samples
field by field and the parity APIs' compact outputs, on fakeheterodataset
and on karate (one node type), uniform and temporal; HGT with repeated
seeds and colliding timestamp writes (the last write wins, as XLA's CPU
scatter keeps it); both negative samplers, with repeated inputs and
inbound both ways."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tch_geometric_tpu as tgt
from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.sampling import budget as jbudget
from tch_geometric_tpu.sampling import hgt as jhgt
from tch_geometric_tpu_torch import (budget_sampling, hgt_sampling,
                                     negative_sample_neighbors_heterogenous,
                                     negative_sample_neighbors_homogenous)
from tch_geometric_tpu_torch.data import io, make_graph, to_csc, to_csr
from tch_geometric_tpu_torch.sampling import budget, hgt, rng
from tch_geometric_tpu_torch.utils.types import rel_key

FIELDS = ("nodes", "node_ts", "node_valid", "rows", "cols", "eptr",
          "edge_valid")


def _hetero(name):
    """``(counts, edge_types, csc, csr, sizes)`` of a fixture."""
    if name == "karate":
        x, _, ei = io.load_karate_graph()
        xs, coo = {"v": x}, {("v", "to", "v"): ei}
    else:
        xs, coo = io.load_fake_hetero_graph()
    counts = {t: v.shape[0] for t, v in xs.items()}
    csc, csr, sizes = {}, {}, {}
    for e, ei in coo.items():
        r, size = rel_key(e), (counts[e[0]], counts[e[2]])
        csc[r], csr[r], sizes[r] = to_csc(ei, size), to_csr(ei, size), size
    return counts, sorted(coo), csc, csr, sizes


@pytest.fixture(scope="module", params=["fakehetero", "karate"])
def graph(request):
    return _hetero(request.param)


def _graphs(counts, edge_types, csc):
    ours, theirs = {}, {}
    for e in edge_types:
        r = rel_key(e)
        cp, ri, _ = csc[r]
        kw = dict(num_src=counts[e[0]], num_dst=counts[e[2]])
        ours[r] = make_graph(cp, ri, device="cpu", **kw)
        theirs[r] = jmake_graph(cp, ri, **kw)
    return ours, theirs


def _temporal(counts, csc, seed=0):
    r = np.random.default_rng(seed)
    ets = {k: r.integers(-1, 12, len(v[1])) for k, v in sorted(csc.items())}
    its = {t: r.integers(-1, 8, 5) for t in sorted(counts)}
    return ets, its


def _same(ours, theirs):
    for f in FIELDS:
        a, b = getattr(ours, f), getattr(theirs, f)
        assert list(a) == list(b), f
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]),
                                          err_msg=f"{f}[{k}]")


def _same_compact(a, b):
    for x, y in zip(a, b):
        assert list(x) == list(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def _kept_edges_real(compact, csc, edge_types):
    nodes, _ts, rows, cols, eptr = compact[:5]
    for src, rel, dst in edge_types:
        r = rel_key((src, rel, dst))
        cp, ri, _ = csc[r]
        v, w = nodes[src][rows[r]], nodes[dst][cols[r]]
        np.testing.assert_array_equal(ri[eptr[r]], v)
        assert ((eptr[r] >= cp[w]) & (eptr[r] < cp[w + 1])).all()


@pytest.mark.parametrize("temporal", [False, True])
def test_hgt_exact(graph, temporal):
    counts, edge_types, csc, _, _ = graph
    nt = sorted(counts)
    inputs = {t: np.array([0, 1, 4, 5, 9]) for t in nt}
    ns = {t: [20, 15] for t in nt}
    ets, its = _temporal(counts, csc) if temporal else (None, None)
    kw = dict(node_counts=counts, edge_timestamps=ets, input_timestamps=its,
              timerange=(0, 9) if temporal else None, node_types=nt)
    g, jg = _graphs(counts, edge_types, csc)
    ours = hgt.sample_hgt(g, edge_types, inputs, ns, 2, key=rng.key(1), **kw)
    theirs = jhgt.sample_hgt(jg, edge_types, inputs, ns, 2,
                             key=jax.random.key(1), **kw)
    _same(ours, theirs)
    compact = hgt.compact_hgt_sample(ours)
    _same_compact(compact, jhgt.compact_hgt_sample(theirs))
    _kept_edges_real(compact, csc, edge_types)
    for t in nt:                            # a node is sampled once
        assert len(set(compact[0][t])) == len(compact[0][t])
    cp = {r: v[0] for r, v in csc.items()}
    ri = {r: v[1] for r, v in csc.items()}
    args = (nt, edge_types, cp, ri, ets, inputs, its, ns, 2,
            (0, 9) if temporal else None)
    _same_compact(hgt_sampling(*args, key=rng.key(2), node_counts=counts,
                               device="cpu"),
                  tgt.hgt_sampling(*args, key=jax.random.key(2),
                                   node_counts=counts))


def test_hgt_repeated_seeds_and_colliding_writes():
    """Repeated seeds (a repeated seed's local id is its last position)
    and many targets sharing sources whose edges carry distinct
    timestamps: each source's timestamp is the last write in flat order."""
    counts, edge_types, csc, _, _ = _hetero("karate")
    g, jg = _graphs(counts, edge_types, csc)
    ets = {r: np.arange(len(v[1])) for r, v in csc.items()}
    inputs = {"v": np.array([0, 0, 33, 2, 33, 5, 1, 0])}
    its = {"v": np.array([1, 2, 3, 4, 5, 6, 7, 8])}
    kw = dict(node_counts=counts, edge_timestamps=ets, input_timestamps=its,
              timerange=(0, 200))
    ours = hgt.sample_hgt(g, edge_types, inputs, {"v": [10, 10]}, 2,
                          key=rng.key(3), **kw)
    theirs = jhgt.sample_hgt(jg, edge_types, inputs, {"v": [10, 10]}, 2,
                             key=jax.random.key(3), **kw)
    _same(ours, theirs)
    # the writes collide: the sampled nodes' timestamps come from edges
    ts = ours.node_ts["v"][8:][ours.node_valid["v"][8:]]
    assert len(ts) > 10 and (ts >= 0).all()


def test_last_write_wins_scatter():
    r = np.random.default_rng(4)
    idx = r.integers(0, 12, (40, 7))          # 12 is the dropped slot
    vals = r.integers(0, 1000, (40, 7)).astype(np.int32)
    table = np.full(13, -1, np.int32)
    ours = hgt._set_last(torch.from_numpy(table), torch.from_numpy(idx),
                         torch.from_numpy(vals))
    theirs = jnp.asarray(table[:12]).at[jnp.asarray(idx)].set(
        jnp.asarray(vals), mode="drop")
    np.testing.assert_array_equal(ours[:12].numpy(), np.asarray(theirs))


@pytest.mark.parametrize("filt", [None, ((0, 6), True, False),
                                  ((-4, 1), False, True)],
                         ids=["uniform", "forward", "backward_relative"])
def test_budget_exact(graph, filt):
    counts, edge_types, csc, _, _ = graph
    nt = sorted(counts)
    inputs = {t: np.array([0, 1, 4, 5, 9]) for t in nt}
    nn = {t: [4, 3] for t in nt}
    ets, its = _temporal(counts, csc, 1)
    kw = dict(edge_timestamps=ets, input_timestamps=its, node_types=nt)
    if filt is not None:
        kw.update(window=filt[0], forward=filt[1], relative=filt[2])
    g, jg = _graphs(counts, edge_types, csc)
    ours = budget.sample_budget(g, edge_types, inputs, nn, 2,
                                key=rng.key(5), **kw)
    theirs = jbudget.sample_budget(jg, edge_types, inputs, nn, 2,
                                   key=jax.random.key(5), **kw)
    _same(ours, theirs)
    compact = budget.compact_budget_sample(ours)
    _same_compact(compact[:5], jbudget.compact_budget_sample(theirs)[:5])
    assert compact[5] == jbudget.compact_budget_sample(theirs)[5]
    _kept_edges_real(compact, csc, edge_types)
    cp = {r: v[0] for r, v in csc.items()}
    ri = {r: v[1] for r, v in csc.items()}
    args = (nt, edge_types, cp, ri, ets, inputs, its, nn, 2)
    fkw = ({} if filt is None else
           dict(window=filt[0], forward=filt[1], relative=filt[2]))
    a = budget_sampling(*args, key=rng.key(6), device="cpu", **fkw)
    b = tgt.budget_sampling(*args, key=jax.random.key(6), **fkw)
    _same_compact(a[:5], b[:5])
    assert a[5] == b[5]


@pytest.mark.parametrize("name", ["karate", "dense"])
def test_negative_homogenous_exact(name):
    if name == "karate":
        _x, _y, ei = io.load_karate_graph()
        n = 34
    else:                       # 60% of all pairs: many rejections
        n = 20
        r = np.random.default_rng(7)
        ei = np.argwhere(r.random((n, n)) < 0.6).T
    rp, ci, _ = to_csr(ei, n)
    inputs = np.array([0, 1, 2, 2, 5, n - 1, 0])
    for num_neg, tries in ((5, 5), (3, 1)):
        ours = negative_sample_neighbors_homogenous(
            rp, ci, (n, n), inputs, num_neg, tries, key=rng.key(8),
            device="cpu")
        theirs = tgt.negative_sample_neighbors_homogenous(
            rp, ci, (n, n), inputs, num_neg, tries, key=jax.random.key(8))
        for a, b in zip(ours[:3], theirs[:3]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int64
        assert ours[3] == theirs[3] == len(inputs)
        samples, rows, cols, _ = ours
        edges = set(map(tuple, ei.T.tolist()))
        for i, j in zip(rows, cols):
            u, w = inputs[i], samples[j]
            assert u != w and (u, w) not in edges
        assert len(rows) < len(inputs) * num_neg or name == "karate"


@pytest.mark.parametrize("inbound", [False, True])
def test_negative_heterogenous_exact(inbound):
    counts, edge_types, _, csr, sizes = _hetero("fakehetero")
    nt = sorted(counts)
    rp = {r: v[0] for r, v in csr.items()}
    ci = {r: v[1] for r, v in csr.items()}
    inputs = {nt[0]: np.array([0, 1, 4, 5, 1]), nt[-1]: np.array([2, 3])}
    args = (nt, edge_types, rp, ci, sizes, inputs, 4, 3, inbound)
    ours = negative_sample_neighbors_heterogenous(*args, key=rng.key(9),
                                                  device="cpu")
    theirs = tgt.negative_sample_neighbors_heterogenous(
        *args, key=jax.random.key(9))
    _same_compact(ours[:3], theirs[:3])
    assert ours[3] == theirs[3]
    assert sum(len(v) for v in ours[1].values()) > 0
