"""Distributed budget sampling of the torch port against the JAX package,
on the CPU.

* ``dist_budget_sample`` on karate's CSC with the ELL table (the lane
  top-k fill) and without it (Floyd's fill), with no filter, with the
  temporal filter (``relative`` False and True, forward and backward) and
  with a fanout past the 50-candidate budget (the padded picks);
* ``dist_budget_sample_hetero`` on fakeheterodataset's CSCs (one relation
  without its ELL table), with no filter and with the temporal filter on
  every relation but one (whose candidates carry no timestamp), one seed
  invalid (-1) and one type's second hop at fanout 0 (the empty branch).

Each case runs JAX once on a 2-device virtual mesh (its sample does not
depend on the device count) and the port on thread meshes of 1, 2 and 4
ranks: at P = 2 every array equals JAX's as it stands, invalid slots
included; at every P the rank blocks merged into the one-rank layout equal
JAX's merged.  Under a tight capacity at P = 4 (one round), the arrays and
the overflow counts equal JAX's at P = 4.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tch_geometric_tpu.data.io import load_fake_hetero_graph as jload_hetero
from tch_geometric_tpu.data.io import load_karate_graph as jload_karate
from tch_geometric_tpu.data.storage import to_csc as jto_csc
from tch_geometric_tpu.parallel import dist_budget as jdb
from tch_geometric_tpu.parallel import dist_sampling as jds
from tch_geometric_tpu.parallel.dist_hgt import \
    build_partitioned_hetero as jbuild_hetero
from tch_geometric_tpu.utils.types import rel_key
from tch_geometric_tpu_torch.parallel import (build_partitioned_graph,
                                              build_partitioned_hetero,
                                              dist_budget_sample,
                                              dist_budget_sample_hetero,
                                              make_mesh, merge_rank_blocks)
from tch_geometric_tpu_torch.sampling import rng

B = 8
FIELDS = ("nodes", "node_valid", "node_state", "rows", "cols", "eptr",
          "edge_valid")


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def _tmesh(n):
    return make_mesh((n, 1), device="cpu")


def _karate():
    _x, _y, ei = jload_karate()
    cp, ri, _ = jto_csc(np.asarray(ei), 34)
    return np.asarray(cp), np.asarray(ri)


CP, RI = _karate()
TS = np.random.default_rng(3).integers(0, 100, RI.shape[0])
SEEDS = np.random.default_rng(4).integers(0, 34, B).astype(np.int32)
SEED_TS = np.random.default_rng(5).integers(20, 80, B).astype(np.int32)

# name -> (ell_table, fanouts, filter keywords or None)
CASES = {
    "ell": (True, (4, 3), None),
    "floyd": (False, (4, 3), None),
    "ell_k_past_budget": (True, (55,), None),
    "floyd_temporal": (False, (6, 3),
                       dict(window=(0, 30), forward=True, relative=False)),
    "ell_temporal_relative": (True, (6, 3),
                              dict(window=(-20, 30), forward=False,
                                   relative=True)),
}


def _homogeneous(lib, case, P, **kw):
    ell, fanouts, filt = CASES[case]
    ts = TS if filt else None
    kw = {"capacity_factor": 8.0, **kw, **(filt or {})}
    if filt:
        kw["input_timestamps"] = SEED_TS
    if lib == "jax":
        g = jds.build_partitioned_graph(CP, RI, P, ell_table=ell,
                                        edge_timestamps=ts)
        s, ovf = jdb.dist_budget_sample(jax.random.key(13), g, SEEDS,
                                        fanouts, _jmesh(P), **kw)
    else:
        g = build_partitioned_graph(CP, RI, P, ell_table=ell,
                                    edge_timestamps=ts, device="cpu")
        s, ovf = dist_budget_sample(rng.key(13), g, SEEDS, fanouts,
                                    _tmesh(P), **kw)
    out = {f: np.asarray(getattr(s, f)) for f in FIELDS}
    return out, s.node_base, s.edge_base, np.asarray(ovf)


def _merged(out, node_base, edge_base):
    """Rank blocks -> the one-rank layout, layer by layer; rows and cols
    renumbered to the one-rank slots."""
    P = out["nodes"].shape[0]
    gslot = np.concatenate([
        P * node_base[i] + np.arange(P)[:, None] * (node_base[i + 1]
                                                     - node_base[i])
        + np.arange(node_base[i + 1] - node_base[i])[None, :]
        for i in range(len(node_base) - 1)], axis=1)        # (P, L)
    res = {}
    for f in FIELDS:
        a = out[f]
        if f in ("rows", "cols"):
            a = np.take_along_axis(gslot, a.astype(np.int64), axis=1)
        base = node_base if f.startswith("node") else edge_base
        res[f] = np.concatenate([a[:, base[i]: base[i + 1]].reshape(-1)
                                 for i in range(len(base) - 1)])
    return res


@pytest.fixture(scope="module")
def jax_samples():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _homogeneous("jax", case, 2)
        return cache[case]
    return get


@pytest.mark.parametrize("case", list(CASES))
def test_budget_matches_jax(jax_samples, case):
    want, nb, eb, jovf = jax_samples(case)
    want_merged = _merged(want, nb, eb)
    for P in (1, 2, 4):
        got, gnb, geb, ovf = _homogeneous("port", case, P)
        assert ovf.shape == (P,) and int(ovf.sum()) == int(jovf.sum()) == 0
        if P == 2:
            assert (gnb, geb) == (nb, eb)
            for f in FIELDS:
                np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        merged = _merged(got, gnb, geb)
        for f in FIELDS:
            np.testing.assert_array_equal(merged[f], want_merged[f],
                                          err_msg=f"P={P} {f}")
    # the sample is not empty, and every valid edge is real
    ev = want_merged["edge_valid"]
    assert ev.any()
    e = want_merged["eptr"][ev]
    child = want_merged["nodes"][want_merged["rows"][ev]]
    parent = want_merged["nodes"][want_merged["cols"][ev]]
    np.testing.assert_array_equal(RI[e], child)
    assert np.all((CP[parent] <= e) & (e < CP[parent + 1]))


@pytest.mark.parametrize("case", ["floyd", "ell_temporal_relative"])
def test_budget_tight_capacity_overflow_matches_jax(case):
    kw = dict(capacity_factor=0.3, num_rounds=1)
    want, _nb, _eb, jovf = _homogeneous("jax", case, 4, **kw)
    got, _gnb, _geb, ovf = _homogeneous("port", case, 4, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(ovf, jovf)
    assert int(ovf.sum()) > 0


# ---------------------------------------------------------------------------
# Typed budget sampling
# ---------------------------------------------------------------------------

def _hetero():
    xs, coo = jload_hetero()
    counts = {t: int(x.shape[0]) for t, x in xs.items()}
    edge_types = sorted(coo)
    csc = {}
    for e in edge_types:
        a, b, _ = jto_csc(np.asarray(coo[e]), (counts[e[0]], counts[e[2]]))
        csc[rel_key(e)] = (np.asarray(a), np.asarray(b))
    return counts, edge_types, csc


COUNTS, EDGE_TYPES, CSC = _hetero()
RELS = sorted(CSC)
NO_ELL = RELS[1]          # its fill runs Floyd's
NO_TS = RELS[2]           # under the filter, its candidates carry no ts
HTS = {r: np.random.default_rng(20 + i).integers(0, 100, CSC[r][1].shape[0])
       for i, r in enumerate(RELS) if r != NO_TS}
HSEEDS = {"v0": np.array([3, 17, -1, 40, 5, 88, 120, 7]),
          "v1": np.arange(4, 8)}
HSEED_TS = {"v0": np.random.default_rng(6).integers(20, 80, 8),
            "v1": np.random.default_rng(7).integers(20, 80, 4)}
HFANOUTS = {"v0": [3, 2], "v1": [2, 0], "v2": [2, 2]}
HCASES = {
    "plain": None,
    "temporal": dict(window=(0, 40), forward=True, relative=False),
    "temporal_relative": dict(window=(-30, 30), forward=False,
                              relative=True),
}


def _hetero_budget(lib, case, P, **kw):
    filt = HCASES[case]
    ts = HTS if filt else None
    kw = {"capacity_factor": 8.0, **kw, **(filt or {})}
    if filt:
        kw["input_timestamps"] = HSEED_TS
    cp = {r: c[0] for r, c in CSC.items()}
    ri = {r: c[1] for r, c in CSC.items()}
    if lib == "jax":
        rels = jbuild_hetero(cp, ri, EDGE_TYPES, P, edge_timestamps=ts,
                             node_counts=COUNTS)
        rels[NO_ELL] = jds.build_partitioned_graph(
            cp[NO_ELL], ri[NO_ELL], P, ell_table=False,
            edge_timestamps=None if ts is None else ts.get(NO_ELL))
        out, ovf = jdb.dist_budget_sample_hetero(
            jax.random.key(31), rels, EDGE_TYPES, HSEEDS, HFANOUTS, 2,
            _jmesh(P), **kw)
        out = tuple({k: torch.from_numpy(np.array(v)) for k, v in d.items()}
                    for d in out)
    else:
        rels = build_partitioned_hetero(cp, ri, EDGE_TYPES, P,
                                        edge_timestamps=ts,
                                        node_counts=COUNTS, device="cpu")
        rels[NO_ELL] = build_partitioned_graph(
            cp[NO_ELL], ri[NO_ELL], P, ell_table=False,
            edge_timestamps=None if ts is None else ts.get(NO_ELL),
            device="cpu")
        out, ovf = dist_budget_sample_hetero(
            rng.key(31), rels, EDGE_TYPES, HSEEDS, HFANOUTS, 2, _tmesh(P),
            **kw)
    return out, np.asarray(ovf)


def _assert_typed_equal(got, want, what):
    for i, (dg, dw) in enumerate(zip(got, want)):
        assert sorted(dg) == sorted(dw)
        for k in dw:
            np.testing.assert_array_equal(dg[k].numpy(), dw[k].numpy(),
                                          err_msg=f"{what} output {i} {k}")


def _merge(out):
    seeds = {t: len(v) for t, v in HSEEDS.items()}
    return merge_rank_blocks(out, EDGE_TYPES, seeds, HFANOUTS, 2,
                             budget=True)


@pytest.mark.parametrize("case", list(HCASES))
def test_hetero_budget_matches_jax(case):
    want, jovf = _hetero_budget("jax", case, 2)
    want_merged = _merge(want)
    for P in (1, 2, 4):
        got, ovf = _hetero_budget("port", case, P)
        assert ovf.shape == (P,) and int(ovf.sum()) == int(jovf.sum()) == 0
        if P == 2:
            _assert_typed_equal(got, want, f"{case} P=2")
        _assert_typed_equal(_merge(got), want_merged, f"{case} P={P} merged")
    nodes, node_ts, valid, rows, cols, eptr, ev = want_merged
    assert not valid["v0"][2] and valid["v0"][:2].all()   # seed -1 invalid
    assert sum(int(v.sum()) for v in ev.values()) > 0
    for r, (cp, ri) in CSC.items():
        src, _rel, dst = r.split("__")
        e = eptr[r][ev[r]].numpy()
        child = nodes[src][rows[r][ev[r]]].numpy()
        parent = nodes[dst][cols[r][ev[r]]].numpy()
        np.testing.assert_array_equal(ri[e], child)
        assert np.all((cp[parent] <= e) & (e < cp[parent + 1]))


def test_hetero_budget_tight_capacity_overflow_matches_jax():
    kw = dict(capacity_factor=0.5, num_rounds=1)
    want, jovf = _hetero_budget("jax", "temporal", 4, **kw)
    got, ovf = _hetero_budget("port", "temporal", 4, **kw)
    _assert_typed_equal(got, want, "tight")
    np.testing.assert_array_equal(ovf, jovf)
    assert int(ovf.sum()) > 0
