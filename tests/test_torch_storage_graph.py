"""CSC/CSR build and device graph tables of the torch port against the JAX
package: exactly equal on the reference fixtures and a power-law graph."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tch_geometric_tpu as tgt
from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu_torch.data import io as tio
from tch_geometric_tpu_torch.data import ogb as togb
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import ind2ptr, to_csc, to_csr


def _powerlaw(n=900, e=9000, seed=0):
    r = np.random.default_rng(seed)
    pop = (1.0 / (np.arange(n) + 10.0)) ** 0.8
    pop /= pop.sum()
    src = r.choice(n, size=e, p=pop)
    dst = r.integers(0, n, e)
    return n, np.stack([src, dst]).astype(np.int64)


def _graph(name):
    if name == "karate":
        x, _, ei = tio.load_karate_graph()
        return x.shape[0], ei
    if name == "fakedataset":
        x, _, ei = tio.load_fake_dataset()
        return x.shape[0], ei
    return _powerlaw()


GRAPHS = ["karate", "fakedataset", "powerlaw"]


@pytest.mark.parametrize("name", GRAPHS)
def test_to_csc_to_csr_exact(name):
    n, ei = _graph(name)
    for ours, theirs in ((to_csc, tgt.to_csc), (to_csr, tgt.to_csr)):
        for a, b in zip(ours(ei, n), theirs(ei, n)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # rectangular size
    rect = (n + 3, n + 7)
    for a, b in zip(to_csc(ei, rect), tgt.to_csc(ei, rect)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ind2ptr_and_bounds():
    ind = np.array([0, 0, 2, 2, 2, 5])
    np.testing.assert_array_equal(ind2ptr(ind, 6), tgt.ind2ptr(ind, 6))
    with pytest.raises(ValueError):
        to_csc(np.array([[0, 9], [1, 2]]), 5)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("tables", [{}, {"ell_table": False},
                                    {"ell_table": False,
                                     "window_table": False},
                                    {"ell_table": True, "window_table": True}])
def test_graph_tables_exact(name, tables):
    n, ei = _graph(name)
    cp, ri, perm = to_csc(ei, n)
    jg = jmake_graph(cp, ri, perm, num_src=n, num_dst=n, **tables)
    g = make_graph(cp, ri, perm, num_src=n, num_dst=n, device="cpu",
                   **tables)
    assert g.max_degree == jg.max_degree
    assert g.num_edges == jg.num_edges
    assert g.num_ptr_nodes == jg.num_ptr_nodes
    for f in ("indptr", "indices", "perm", "ell", "indices_win"):
        a, b = getattr(g, f), getattr(jg, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)

    nodes = np.random.default_rng(1).integers(0, n, 64)
    tn, jn = torch.from_numpy(nodes), jnp.asarray(nodes)
    for a, b in zip(g.neighbors_range(tn), jg.neighbors_range(jn)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    eptr = np.random.default_rng(2).integers(-3, g.num_edges + 3, 64)
    np.testing.assert_array_equal(
        g.gather_neighbors(torch.from_numpy(eptr)).numpy(),
        np.asarray(jg.gather_neighbors(jnp.asarray(eptr))))
    if g.ell is not None:
        for a, b in zip(g.ell_rows(tn), jg.ell_rows(jn)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if g.indices_win is not None:
        starts = g.indptr[tn]
        a_win, a_off = g.gather_neighbor_windows_rows(starts)
        b_win, b_off = jg.gather_neighbor_windows_rows(jnp.asarray(starts))
        np.testing.assert_array_equal(a_off.numpy(), np.asarray(b_off))
        deg = (g.indptr[tn + 1] - starts).numpy()
        for i in range(len(nodes)):   # lanes past the degree are arbitrary
            o, d = int(a_off[i]), int(deg[i])
            np.testing.assert_array_equal(a_win[i, o:o + d].numpy(),
                                          np.asarray(b_win)[i, o:o + d])


def test_synthetic_and_planted_ogbn_exact():
    from tch_geometric_tpu.data.ogb import planted_ogbn, synthetic_ogbn
    a = togb.synthetic_ogbn("ogbn-arxiv", scale=0.005, seed=3)
    b = synthetic_ogbn("ogbn-arxiv", scale=0.005, seed=3)
    for f in ("x", "edge_index", "y"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    (a, sa), (b, sb) = (togb.planted_ogbn("ogbn-arxiv", scale=0.005),
                        planted_ogbn("ogbn-arxiv", scale=0.005))
    np.testing.assert_array_equal(a.y, b.y)
    for k in ("train", "valid", "test"):
        np.testing.assert_array_equal(sa[k], sb[k])
