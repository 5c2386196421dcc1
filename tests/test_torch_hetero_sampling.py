"""Heterogeneous neighbor sampling of the torch port against the JAX
package on ``fakeheterodataset.npz``: uniform (fused over relations that
share a dst type, and unfused when one relation has no ELL table),
weighted and temporal, bit-exact array for array (``node_state`` under
``node_valid``); the compact reference format and the parity API; and
``HeteroData``."""
import jax
import numpy as np
import pytest
import torch

import tch_geometric_tpu as tgt
from tch_geometric_tpu.data.dataset import HeteroData as JHeteroData
from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.sampling.hetero_neighbor import \
    compact_hetero_sample as jcompact
from tch_geometric_tpu.sampling.hetero_neighbor import \
    sample_hetero_neighbors as jsample
from tch_geometric_tpu_torch import (TemporalEdgeFilter, UniformEdgeSampler,
                                     WeightedEdgeSampler,
                                     neighbor_sampling_heterogenous,
                                     sample_hetero_neighbors)
from tch_geometric_tpu_torch.data import HeteroData, make_graph, to_csc
from tch_geometric_tpu_torch.data.io import _fixture_path
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.sampling.hetero_neighbor import (
    HeteroLayout, compact_hetero_sample)
from tch_geometric_tpu_torch.utils.types import rel_key

from validators import validate_neighbor_samples

FIELDS = ("nodes", "node_valid", "node_state", "rows", "cols", "eptr",
          "edge_valid")
SEEDS = np.array([0, 1, 4, 5, 9])
FANOUTS = [4, 3]


@pytest.fixture(scope="module")
def hetero():
    xs, coo = tgt.data.load_fake_hetero_graph()
    counts = {t: x.shape[0] for t, x in xs.items()}
    edge_types = sorted(coo)
    csc = {rel_key(e): to_csc(coo[e], (counts[e[0]], counts[e[2]]))
           for e in edge_types}
    return counts, edge_types, csc


def _graphs(hetero, no_ell=()):
    counts, edge_types, csc = hetero
    ours, theirs = {}, {}
    for e in edge_types:
        r = rel_key(e)
        cp, ri, _ = csc[r]
        kw = dict(num_src=counts[e[0]], num_dst=counts[e[2]])
        if r in no_ell:
            kw["ell_table"] = False
        ours[r] = make_graph(cp, ri, device="cpu", **kw)
        theirs[r] = jmake_graph(cp, ri, **kw)
    return ours, theirs


def _assert_same(ts, js):
    assert ts.meta == js.meta
    for f in FIELDS:
        ours, theirs = getattr(ts, f), getattr(js, f)
        assert ours.keys() == theirs.keys()
        for k in ours:
            a, b = ours[k].numpy(), np.asarray(theirs[k])
            if f == "node_state":
                # padding at invalid slots in JAX
                valid = ts.node_valid[k].numpy()
                a, b = a[valid], b[valid]
            np.testing.assert_array_equal(a, b, err_msg=f"{f}[{k}]")


def _validate(hetero, sample):
    _, edge_types, csc = hetero
    samples, rows, cols, _, offsets = compact_hetero_sample(sample)
    for e in edge_types:
        r = rel_key(e)
        validate_neighbor_samples(csc[r][0], csc[r][1], samples[e[0]],
                                  samples[e[2]], rows[r], cols[r],
                                  offsets[r], FANOUTS)


def _configs(hetero):
    """(name, port kwargs, JAX kwargs) of every sampler configuration."""
    _, edge_types, csc = hetero
    r = np.random.default_rng(0)
    w = {k: r.uniform(0.1, 3.0, len(v[1])) for k, v in csc.items()}
    ts = {k: r.integers(0, 50, len(v[1])).astype(np.int64)
          for k, v in csc.items()}
    state = {t: r.integers(0, 50, len(SEEDS)).astype(np.int64)
             for t in ("v0", "v1", "v2")}
    out = [("uniform", dict(sampler=UniformEdgeSampler(False)),
            dict(sampler=tgt.UniformEdgeSampler(False))),
           ("uniform_replace", dict(sampler=UniformEdgeSampler(True)),
            dict(sampler=tgt.UniformEdgeSampler(True))),
           ("weighted", dict(sampler=WeightedEdgeSampler(w)),
            dict(sampler=tgt.WeightedEdgeSampler(w)))]
    for mode in (0, 1, 2):
        out.append((f"temporal{mode}",
                    dict(filter=(TemporalEdgeFilter((0, 20), ts, True, mode),
                                 state)),
                    dict(filter=(tgt.TemporalEdgeFilter((0, 20), ts, True,
                                                        mode), state))))
    return out


CONFIGS = ["uniform", "uniform_replace", "weighted", "temporal0",
           "temporal1", "temporal2"]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("fused", [True, False], ids=["ell", "one_no_ell"])
def test_sample_hetero_neighbors_bit_exact(hetero, config, fused):
    counts, edge_types, _ = hetero
    no_ell = () if fused else (rel_key(edge_types[0]),)
    g, jg = _graphs(hetero, no_ell)
    _, ours_kw, theirs_kw = next(c for c in _configs(hetero)
                                 if c[0] == config)
    inputs = {t: SEEDS for t in counts}
    nn = {rel_key(e): FANOUTS for e in edge_types}
    for s in (3, 8):
        ts = sample_hetero_neighbors(g, edge_types, inputs, nn, 2,
                                     key=rng.key(s), **ours_kw)
        js = jsample(jg, edge_types, inputs, nn, 2, key=jax.random.key(s),
                     **theirs_kw)
        _assert_same(ts, js)
        _validate(hetero, ts)


def test_fused_group_runs(hetero, monkeypatch):
    """Uniform sampling with every ELL table takes the fused hop; one
    relation without ELL turns fusion off."""
    from tch_geometric_tpu_torch.sampling import hetero_neighbor as hn
    counts, edge_types, _ = hetero
    calls = []
    real = hn._fused_uniform_group
    monkeypatch.setattr(hn, "_fused_uniform_group",
                        lambda *a: calls.append(1) or real(*a))
    nn = {rel_key(e): FANOUTS for e in edge_types}
    for no_ell, expect in (((), True), ((rel_key(edge_types[0]),), False)):
        calls.clear()
        g, _ = _graphs(hetero, no_ell)
        sample_hetero_neighbors(g, edge_types, {"v0": SEEDS}, nn, 2,
                                key=rng.key(0))
        assert bool(calls) == expect


def test_compact_and_parity_api(hetero):
    counts, edge_types, csc = hetero
    g, jg = _graphs(hetero)
    inputs = {"v1": SEEDS, "v2": SEEDS[:3]}
    nn = {rel_key(e): [3, 2] for e in edge_types}
    ts = sample_hetero_neighbors(g, edge_types, inputs, nn, 2, key=rng.key(5))
    js = jsample(jg, edge_types, inputs, nn, 2, key=jax.random.key(5))
    ours, theirs = compact_hetero_sample(ts), jcompact(js)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    cp = {r: v[0] for r, v in csc.items()}
    ri = {r: v[1] for r, v in csc.items()}
    w = {r: np.random.default_rng(1).uniform(0.5, 2.0, len(v))
         for r, v in ri.items()}
    a = neighbor_sampling_heterogenous(
        sorted(counts), edge_types, cp, ri, inputs, nn, 2,
        WeightedEdgeSampler(w), key=rng.key(6), node_counts=counts,
        device="cpu")
    b = tgt.neighbor_sampling_heterogenous(
        sorted(counts), edge_types, cp, ri, inputs, nn, 2,
        tgt.WeightedEdgeSampler(w), key=jax.random.key(6),
        node_counts=counts)
    for u, v in zip(a, b):
        assert u.keys() == v.keys()
        for k in u:
            np.testing.assert_array_equal(np.asarray(u[k]), np.asarray(v[k]))
    layout = ts.layout()
    assert isinstance(layout, HeteroLayout)
    for t in counts:
        assert layout.total_nodes(t) == ts.nodes[t].shape[0]


def test_hetero_data_from_npz_and_csc():
    path = _fixture_path("fakeheterodataset.npz")
    ours, theirs = HeteroData.from_npz(path), JHeteroData.from_npz(path)
    assert ours.node_types == theirs.node_types
    assert ours.edge_types == theirs.edge_types
    assert ours.node_counts == theirs.node_counts
    for t in ours.node_types:
        np.testing.assert_array_equal(ours.x[t], theirs.x[t])
    for e in ours.edge_types:
        assert ours.size(e) == theirs.size(e)
        for fn in ("csc", "csr"):
            a, b = getattr(ours, fn)(e, device="cpu"), getattr(theirs, fn)(e)
            for f in ("indptr", "indices", "perm"):
                np.testing.assert_array_equal(getattr(a, f).numpy(),
                                              np.asarray(getattr(b, f)))
            assert a.max_degree == b.max_degree
            # cached per device
            assert getattr(ours, fn)(e, device="cpu") is a
    assert isinstance(ours.csc(ours.edge_types[0], device="cpu").indptr,
                      torch.Tensor)
