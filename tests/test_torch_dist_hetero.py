"""Typed distributed neighbor sampling and the partitioned heterogeneous
layouts of the torch port against the JAX package, on the CPU.

* ``dist_hetero_neighbor_sample`` on fakeheterodataset's CSCs, one seed
  invalid (-1) and one relation at fanout 0 on its second hop: uniform
  without and with replacement; a weighted relation rebuilt with
  ``edge_weights`` (JAX's ``test_hetero_neighbor_weighted_relation``: one
  heavy edge a row), without and with replacement; the temporal filter in
  STATIC, RELATIVE and DYNAMIC modes over timestamps on every relation but
  one (which samples unfiltered); and a weighted relation without its ELL
  table, whose owners run the window engines in chunks of 4.  Each case
  runs JAX once on a 2-device virtual mesh and the port on thread meshes
  of 1, 2 and 4 ranks: at P = 2 every array equals JAX's as it stands,
  invalid slots included; at every P the rank blocks merged by
  ``merge_rank_blocks`` equal JAX's merged.  Under a tight capacity at
  P = 4 (one round) the arrays and overflow counts equal JAX's at P = 4.
* ``build_partitioned_hetero`` and ``stack_partitioned_rels`` (with the ELL
  tables of all relations, and with one relation without, which drops
  them for all) equal JAX's arrays exactly; ``put_stacked_rels`` on a
  thread mesh holds the same; each relation's slice of the stack is its
  own graph, its padded rows of degree 0.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tch_geometric_tpu.data.io import load_fake_hetero_graph as jload_hetero
from tch_geometric_tpu.data.storage import to_csc as jto_csc
from tch_geometric_tpu.parallel import dist_hetero as jdh
from tch_geometric_tpu.parallel import dist_hgt as jdhgt
from tch_geometric_tpu.parallel import dist_sampling as jds
from tch_geometric_tpu.utils.config import (TEMPORAL_SAMPLE_DYNAMIC,
                                            TEMPORAL_SAMPLE_RELATIVE,
                                            TEMPORAL_SAMPLE_STATIC)
from tch_geometric_tpu.utils.types import rel_key
from tch_geometric_tpu_torch.parallel import (build_partitioned_graph,
                                              build_partitioned_hetero,
                                              dist_hetero_neighbor_sample,
                                              make_mesh, merge_rank_blocks,
                                              put_stacked_rels,
                                              stack_partitioned_rels)
from tch_geometric_tpu_torch.parallel.dist_hgt import _pad_to
from tch_geometric_tpu_torch.sampling import rng


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("data",))


def _tmesh(n):
    return make_mesh((n, 1), device="cpu")


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
R0 = RELS[0]              # the weighted relation
NO_TS = RELS[3]           # samples unfiltered under the filter
TS = {r: np.random.default_rng(40 + i).integers(0, 100, CSC[r][1].shape[0])
      for i, r in enumerate(RELS) if r != NO_TS}
SEEDS = {"v0": np.array([3, 17, -1, 40, 5, 88, 120, 7]),
         "v2": np.arange(10, 14)}
SEED_TS = {"v0": np.random.default_rng(8).integers(20, 80, 8),
           "v2": np.random.default_rng(9).integers(20, 80, 4)}
FANOUTS = {r: [3, 2] for r in RELS}
FANOUTS[RELS[4]] = [2, 0]


def _heavy_weights():
    """One heavy edge in each non-empty row of R0, the rest 1e-25."""
    cp = CSC[R0][0]
    w = np.full((CSC[R0][1].shape[0],), 1e-25)
    r = np.random.default_rng(7)
    heavy = [cp[v] + r.integers(cp[v + 1] - cp[v])
             for v in range(len(cp) - 1) if cp[v + 1] > cp[v]]
    w[np.asarray(heavy)] = 1.0
    return w, np.asarray(heavy)


W, HEAVY = _heavy_weights()

# name -> (R0 rebuilt with weights, its ELL table, keywords)
CASES = {
    "uniform": (False, True, {}),
    "replace": (False, True, dict(with_replacement=True)),
    "weighted": (True, True, dict(weighted={R0})),
    "weighted_replace": (True, True, dict(weighted={R0},
                                          with_replacement=True)),
    "weighted_window": (True, False, dict(weighted={R0}, window=4)),
    "static": (False, True, dict(filter=((20, 70), True,
                                         TEMPORAL_SAMPLE_STATIC))),
    "relative": (False, True, dict(filter=((-30, 30), False,
                                           TEMPORAL_SAMPLE_RELATIVE))),
    "dynamic": (False, False, dict(filter=((0, 40), True,
                                           TEMPORAL_SAMPLE_DYNAMIC))),
}


def _sample(lib, case, P, **extra):
    weights, ell, kw = CASES[case]
    kw = {"capacity_factor": 8.0, **kw, **extra}
    ts = TS if "filter" in kw else None
    if ts is not None:
        kw["input_timestamps"] = SEED_TS
    cp = {r: c[0] for r, c in CSC.items()}
    ri = {r: c[1] for r, c in CSC.items()}
    r0 = dict(edge_weights=W if weights else None,
              edge_timestamps=None if ts is None else ts[R0],
              ell_table=None if ell else False)
    if lib == "jax":
        rels = jdhgt.build_partitioned_hetero(cp, ri, EDGE_TYPES, P,
                                              edge_timestamps=ts,
                                              node_counts=COUNTS)
        rels[R0] = jds.build_partitioned_graph(cp[R0], ri[R0], P, **r0)
        out, ovf = jdh.dist_hetero_neighbor_sample(
            jax.random.key(41), rels, EDGE_TYPES, SEEDS, FANOUTS, 2,
            _jmesh(P), **kw)
        out = tuple({k: torch.from_numpy(np.array(v)) for k, v in d.items()}
                    for d in out)
    else:
        rels = build_partitioned_hetero(cp, ri, EDGE_TYPES, P,
                                        edge_timestamps=ts,
                                        node_counts=COUNTS, device="cpu")
        rels[R0] = build_partitioned_graph(cp[R0], ri[R0], P, device="cpu",
                                           **r0)
        out, ovf = dist_hetero_neighbor_sample(
            rng.key(41), rels, EDGE_TYPES, SEEDS, FANOUTS, 2, _tmesh(P), **kw)
    return out, np.asarray(ovf)


def _assert_typed_equal(got, want, what):
    for i, (dg, dw) in enumerate(zip(got, want)):
        assert sorted(dg) == sorted(dw)
        for k in dw:
            np.testing.assert_array_equal(dg[k].numpy(), dw[k].numpy(),
                                          err_msg=f"{what} output {i} {k}")


def _merge(out):
    return merge_rank_blocks(out, EDGE_TYPES,
                             {t: len(v) for t, v in SEEDS.items()}, FANOUTS,
                             2)


@pytest.mark.parametrize("case", list(CASES))
def test_hetero_neighbor_matches_jax(case):
    want, jovf = _sample("jax", case, 2)
    want_merged = _merge(want)
    for P in (1, 2, 4):
        got, ovf = _sample("port", case, P)
        assert ovf.shape == (P,) and int(ovf.sum()) == int(jovf.sum()) == 0
        if P == 2:
            _assert_typed_equal(got, want, f"{case} P=2")
        _assert_typed_equal(_merge(got), want_merged, f"{case} P={P} merged")
    nodes, _ts, valid, rows, cols, eptr, ev = want_merged
    assert not valid["v0"][2] and valid["v0"][:2].all()   # seed -1 invalid
    for r, (cp, ri) in CSC.items():
        src, _rel, dst = r.split("__")
        e = eptr[r][ev[r]].numpy()
        np.testing.assert_array_equal(ri[e], nodes[src][rows[r][ev[r]]])
        parent = nodes[dst][cols[r][ev[r]]].numpy()
        assert np.all((cp[parent] <= e) & (e < cp[parent + 1]))
    if CASES[case][0]:
        # hop 0 of R0: a seed's best pick (every pick, with replacement)
        # is its row's heavy edge
        k = FANOUTS[R0][0]
        n = len(SEEDS[R0.split("__")[2]]) * k
        e, ok = eptr[R0][:n].numpy(), ev[R0][:n].numpy()
        if not CASES[case][2].get("with_replacement"):
            e, ok = e[::k], ok[::k]
        assert ok.sum() >= 4 and np.isin(e[ok], HEAVY).all()


def test_hetero_neighbor_tight_capacity_overflow_matches_jax():
    kw = dict(capacity_factor=0.5, num_rounds=1)
    want, jovf = _sample("jax", "dynamic", 4, **kw)
    got, ovf = _sample("port", "dynamic", 4, **kw)
    _assert_typed_equal(got, want, "tight")
    np.testing.assert_array_equal(ovf, jovf)
    assert int(ovf.sum()) > 0


# ---------------------------------------------------------------------------
# The partitioned heterogeneous layouts
# ---------------------------------------------------------------------------

GRAPH_FIELDS = ("ldeg", "lstart", "gstart", "lindices", "ell", "lts",
                "ell_ts")
STACK_INTS = ("num_rels", "num_parts", "rows_per_part", "local_edge_cap",
              "max_degree")


def _assert_same(got, want, fields, what):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f"{what} {f}"
        if b is not None:
            np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b),
                                          err_msg=f"{what} {f}")


@pytest.mark.parametrize("mixed_ell", [False, True])
def test_partitioned_hetero_layouts_match_jax(mixed_ell):
    P = 2
    cp = {r: c[0] for r, c in CSC.items()}
    ri = {r: c[1] for r, c in CSC.items()}
    jrels = jdhgt.build_partitioned_hetero(cp, ri, EDGE_TYPES, P,
                                           edge_timestamps=TS,
                                           node_counts=COUNTS)
    rels = build_partitioned_hetero(cp, ri, EDGE_TYPES, P, edge_timestamps=TS,
                                    node_counts=COUNTS, device="cpu")
    assert sorted(rels) == sorted(jrels)
    for r in jrels:
        _assert_same(rels[r], jrels[r], GRAPH_FIELDS, r)
        assert (rels[r].num_nodes, rels[r].rows_per_part,
                rels[r].local_edge_cap) == (jrels[r].num_nodes,
                                            jrels[r].rows_per_part,
                                            jrels[r].local_edge_cap)
    if mixed_ell:                        # one relation without its table
        jrels[R0] = jds.build_partitioned_graph(
            cp[R0], ri[R0], P, edge_timestamps=TS[R0], ell_table=False)
        rels[R0] = build_partitioned_graph(cp[R0], ri[R0], P,
                                           edge_timestamps=TS[R0],
                                           ell_table=False, device="cpu")
    jst = jdhgt.stack_partitioned_rels(jrels, RELS)
    st = stack_partitioned_rels(rels, RELS)
    _assert_same(st, jst, GRAPH_FIELDS, "stacked")
    assert (st.ell is None) == mixed_ell
    assert [getattr(st, f) for f in STACK_INTS] == \
        [getattr(jst, f) for f in STACK_INTS]
    # on a thread mesh the placed stack is the whole stack
    _assert_same(put_stacked_rels(rels, RELS, _tmesh(P)), jst, GRAPH_FIELDS,
                 "put")
    # each relation's slice is its own graph; padded rows have degree 0
    Npm = st.rows_per_part
    for i, r in enumerate(RELS):
        g = rels[r]
        deg = st.ldeg[:, i].reshape(P, Npm)
        np.testing.assert_array_equal(
            deg[:, : g.rows_per_part].reshape(-1).numpy(), g.ldeg.numpy())
        assert not deg[:, g.rows_per_part:].any()
        lind = st.lindices[:, i].reshape(P, st.local_edge_cap)
        np.testing.assert_array_equal(
            lind[:, : g.local_edge_cap].reshape(-1).numpy(),
            g.lindices.numpy())
    x = np.arange(5, dtype=np.int32)
    np.testing.assert_array_equal(_pad_to(torch.from_numpy(x), 8, -1).numpy(),
                                  jdhgt._pad_to(x, 8, fill=-1))
