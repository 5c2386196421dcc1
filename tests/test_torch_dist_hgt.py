"""Distributed HGT sampling of the torch port against the JAX package, on
the CPU.

``dist_hgt_sample`` on fakeheterodataset's CSCs, one relation rebuilt
without its ELL table (its subsets run Floyd's draw; the stacked layouts
then drop every relation's ELL table, as the JAX package's do), in all
three program structures (one exchange pair a relation, the relations
fused into one exchange a phase, one stacked relation at a time), with no
time range and with one over edge timestamps (one relation without
timestamps: its edges take the target's time).  Seeds of two types with
their timestamps, one of them invalid (-1); the seeds are distinct, since
a repeated seed's slot follows the scatter order of the backend.

Each case runs JAX once, on one device (the sample does not depend on the
device count: the rank blocks of the COO concatenate into the same arrays
at every P, which ``tests/test_dist_hgt.py`` pins for JAX; one device
compiles the smallest program), and the port on thread meshes of 1, 2 and
4 ranks: every array, invalid slots included, equals JAX's.  Under a tight
capacity at P = 4 (one round, one hop), each structure's arrays and
overflow counts equal JAX's at P = 4.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from tch_geometric_tpu.data.io import load_fake_hetero_graph as jload_hetero
from tch_geometric_tpu.data.storage import to_csc as jto_csc
from tch_geometric_tpu.parallel import dist_hgt as jdh
from tch_geometric_tpu.parallel import dist_sampling as jds
from tch_geometric_tpu.utils.types import rel_key
from tch_geometric_tpu_torch.parallel import (build_partitioned_graph,
                                              build_partitioned_hetero,
                                              dist_hgt_sample, make_mesh)
from tch_geometric_tpu_torch.sampling import rng

NAMES = ("nodes", "node_ts", "node_valid", "rows", "cols", "eptr",
         "edge_valid")


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
NO_ELL = RELS[1]
NO_TS = RELS[2]
TS = {r: np.random.default_rng(40 + i).integers(0, 100, CSC[r][1].shape[0])
      for i, r in enumerate(RELS) if r != NO_TS}
SEEDS = {"v0": np.array([3, 17, -1, 40, 5, 88, 120, 7]),
         "v1": np.array([4, 9, 2, 30])}
SEED_TS = {"v0": np.random.default_rng(41).integers(20, 90, 8),
           "v1": np.random.default_rng(42).integers(20, 90, 4)}
# seed counts and fanouts are multiples of 4: the sampler pads each to a
# multiple of P, so only then is the sample the same at P = 1, 2 and 4
NUM_SAMPLES = {"v0": [8, 4], "v1": [4, 8], "v2": [8, 4]}
STRUCTURES = (False, True, "scan")
TIMERANGE = (10, 70)


def _rels(lib, P, timed):
    cp = {r: c[0] for r, c in CSC.items()}
    ri = {r: c[1] for r, c in CSC.items()}
    ts = TS if timed else None
    no_ell_ts = None if ts is None else ts.get(NO_ELL)
    if lib == "jax":
        rels = jdh.build_partitioned_hetero(cp, ri, EDGE_TYPES, P,
                                            edge_timestamps=ts,
                                            node_counts=COUNTS)
        rels[NO_ELL] = jds.build_partitioned_graph(
            cp[NO_ELL], ri[NO_ELL], P, ell_table=False,
            edge_timestamps=no_ell_ts)
        return rels
    rels = build_partitioned_hetero(cp, ri, EDGE_TYPES, P, edge_timestamps=ts,
                                    node_counts=COUNTS, device="cpu")
    rels[NO_ELL] = build_partitioned_graph(cp[NO_ELL], ri[NO_ELL], P,
                                           ell_table=False,
                                           edge_timestamps=no_ell_ts,
                                           device="cpu")
    return rels


def _sample(lib, P, stacked, timed, hops=2, **kw):
    """One call; returns the seven outputs as numpy dicts (the COO's rank
    blocks concatenated) and the overflow (P,)."""
    kw = {"capacity_factor": 8.0, "input_timestamps": SEED_TS,
          "timerange": TIMERANGE if timed else None, "stacked": stacked, **kw}
    rels = _rels(lib, P, timed)
    fanouts = {t: f[:hops] for t, f in NUM_SAMPLES.items()}
    if lib == "jax":
        mesh = JMesh(np.array(jax.devices()[:P]), ("data",))
        out, ovf = jdh.dist_hgt_sample(jax.random.key(23), rels, EDGE_TYPES,
                                       SEEDS, fanouts, hops, mesh,
                                       node_counts=COUNTS, **kw)
    else:
        out, ovf = dist_hgt_sample(rng.key(23), rels, EDGE_TYPES, SEEDS,
                                   fanouts, hops,
                                   make_mesh((P, 1), device="cpu"),
                                   node_counts=COUNTS, **kw)
    res = {}
    for name, d in zip(NAMES, out):
        for k, v in d.items():
            res[name, k] = np.asarray(v).reshape(-1)
    return res, np.asarray(ovf)


def _assert_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def jax_samples():
    cache = {}

    def get(stacked, timed):
        if (stacked, timed) not in cache:
            cache[stacked, timed] = _sample("jax", 1, stacked, timed)
        return cache[stacked, timed]
    return get


def _check_sample(s, timed):
    """The sample is not empty; every kept edge is real (its pointer lies
    in the destination's CSC window and reads the source), joins two valid
    slots, and each type's valid nodes are distinct; under the time range
    every sampled node's time passes it (or is missing)."""
    assert sum(int(s["edge_valid", r].sum()) for r in RELS) > 0
    for r, (cp, ri) in CSC.items():
        src, _rel, dst = r.split("__")
        ev = s["edge_valid", r]
        e, rr, cc = s["eptr", r][ev], s["rows", r][ev], s["cols", r][ev]
        assert s["node_valid", src][rr].all() and s["node_valid", dst][cc].all()
        child, parent = s["nodes", src][rr], s["nodes", dst][cc]
        np.testing.assert_array_equal(ri[e], child)
        assert np.all((cp[parent] <= e) & (e < cp[parent + 1]))
    for t in COUNTS:
        v = s["nodes", t][s["node_valid", t]]
        assert np.unique(v).shape == v.shape, t
        if timed:
            n = len(SEEDS.get(t, ()))
            ts = s["node_ts", t][n:][s["node_valid", t][n:]]
            assert np.all((ts == -1) | ((ts >= TIMERANGE[0])
                                        & (ts < TIMERANGE[1]))), t


@pytest.mark.parametrize("timed", [False, True], ids=["plain", "timerange"])
@pytest.mark.parametrize("stacked", STRUCTURES, ids=str)
def test_dist_hgt_matches_jax(jax_samples, stacked, timed):
    want, jovf = jax_samples(stacked, timed)
    assert int(jovf.sum()) == 0
    _check_sample(want, timed)
    for P in (1, 2, 4):
        got, ovf = _sample("port", P, stacked, timed)
        assert ovf.shape == (P,) and int(ovf.sum()) == 0
        _assert_equal(got, want, f"stacked={stacked} P={P}")


@pytest.mark.parametrize("stacked", STRUCTURES, ids=str)
def test_dist_hgt_tight_capacity_overflow_matches_jax(stacked):
    kw = dict(capacity_factor=0.5, num_rounds=1, hops=1)
    want, jovf = _sample("jax", 4, stacked, True, **kw)
    got, ovf = _sample("port", 4, stacked, True, **kw)
    _assert_equal(got, want, f"tight stacked={stacked}")
    np.testing.assert_array_equal(ovf, jovf)
    assert int(ovf.sum()) > 0
