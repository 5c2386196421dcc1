"""GAT, GCN and GIN of the torch port against the flax models, with the flax
parameters carried over by gnn_params_from_flax: tree_forward and the
full-graph __call__ at 1e-5, GATConv(blocked=...) in float32 at 5e-4 (the
port's plain B3 against the JAX kernel in interpret mode, and against the
segment-op path), eval_step's loss and accuracy for GAT, and the parameter
round trip."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as nnf

from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.models import gnn as jgnn
from tch_geometric_tpu.parallel.train import make_gnn_trainer as jtrainer
from tch_geometric_tpu.sampling.neighbor import sample_neighbors as jsample
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.models import gnn
from tch_geometric_tpu_torch.ops.attention_blocked import \
    gat_attend_blocked_packed_cuda
from tch_geometric_tpu_torch.parallel.train import make_gnn_trainer
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.sampling.neighbor import sample_neighbors
from tch_geometric_tpu_torch.utils.params import gnn_params_from_flax

jsb = importlib.import_module("tch_geometric_tpu.ops.spmm_blocked")
tsb = importlib.import_module("tch_geometric_tpu_torch.ops.spmm_blocked")

KINDS = {"GAT": (jgnn.GAT, gnn.GAT), "GCN": (jgnn.GCN, gnn.GCN),
         "GIN": (jgnn.GIN, gnn.GIN)}


def _graphs(data):
    x, y, ei = data
    n = x.shape[0]
    cp, ri, _ = to_csc(ei, n)
    g = make_graph(cp, ri, num_src=n, num_dst=n, device="cpu")
    jg = jmake_graph(cp, ri, num_src=n, num_dst=n)
    return x.astype(np.float32), y, cp, ri, g, jg


def _port(kind, jparams, in_f, hidden, out, layers):
    m = KINDS[kind][1](in_f, hidden, out, layers, device="cpu")
    m.load_state_dict(gnn_params_from_flax(jparams))
    return m


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("layers,fanouts", [(2, [4, 3]), (3, [5, 3, 2])])
def test_tree_forward_matches_flax(fake_dataset, kind, layers, fanouts):
    x, _, cp, ri, g, jg = _graphs(fake_dataset)
    seeds = np.arange(0, x.shape[0], 29)
    ts = sample_neighbors(g, seeds, fanouts, key=rng.key(1))
    js = jsample(jg, seeds, fanouts, key=jax.random.key(1))
    xj = jnp.asarray(x)[jnp.clip(js.nodes, 0, x.shape[0] - 1)]
    xt = torch.from_numpy(x)[ts.nodes.clamp(0, x.shape[0] - 1)]
    J = KINDS[kind][0]
    jm = J(hidden=16, out=5, num_layers=layers)
    jp = jm.init(jax.random.key(0), js, xj, method=J.tree_forward)
    if kind == "GIN":      # eps starts at 0: move it so it is exercised
        jp = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.25 if p[-1].key == "eps" else v, jp)
    ref = np.asarray(jm.apply(jp, js, xj, method=J.tree_forward))
    m = _port(kind, jp, x.shape[1], 16, 5, layers)
    with torch.no_grad():
        out = m.tree_forward(ts, xt).numpy()
    assert out.shape == ref.shape == (len(seeds), 5)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_full_graph_matches_flax(fake_dataset, kind):
    x, _, cp, ri, g, jg = _graphs(fake_dataset)
    xj = jnp.asarray(x)
    jm = KINDS[kind][0](hidden=16, out=5, num_layers=2)
    jp = jm.init(jax.random.key(2), xj, jg)
    ref = np.asarray(jm.apply(jp, xj, jg))
    m = _port(kind, jp, x.shape[1], 16, 5, 2)
    with torch.no_grad():
        out = m(torch.from_numpy(x), g).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_gatconv_blocked_matches_flax(fake_dataset):
    """GATConv(blocked=...) in float32: the port's plain B3 against the JAX
    kernel (interpret mode) and against the segment-op path; and the
    three-layer blocked composition (ELU between layers) against flax
    GAT.__call__ over the graph."""
    x, _, cp, ri, g, jg = _graphs(fake_dataset)
    n = x.shape[0]
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    kw = dict(rows_per_block=128)
    jb = jsb.build_blocked(cp, ri, **kw)
    tb = tsb.build_blocked(cp, ri, device="cpu", **kw)
    jconv = jgnn.GATConv(16, heads=4)
    jp = jconv.init(jax.random.key(3), xj, jg)
    ref_b = np.asarray(jconv.apply(jp, xj, None, jb))
    ref_g = np.asarray(jconv.apply(jp, xj, jg))
    conv = gnn.GATConv(x.shape[1], 16, heads=4, device="cpu")
    conv.load_state_dict({k.split(".", 2)[2]: v for k, v in
                          gnn_params_from_flax({"GATConv_0": jp["params"]})
                          .items()})
    before = gat_attend_blocked_packed_cuda.launches
    with torch.no_grad():
        out_b = conv(xt, blocked=tb).numpy()
        out_g = conv(xt, g).numpy()
    assert gat_attend_blocked_packed_cuda.launches == before    # CPU
    assert out_b.shape == (n, 16)
    np.testing.assert_allclose(out_b, ref_b, atol=5e-4)
    np.testing.assert_allclose(out_b, ref_g, atol=5e-4)
    np.testing.assert_allclose(out_g, ref_g, rtol=1e-5, atol=1e-5)

    jm = jgnn.GAT(hidden=16, out=5, num_layers=3)
    jpm = jm.init(jax.random.key(4), xj, jg)
    ref = np.asarray(jm.apply(jpm, xj, jg))
    m = _port("GAT", jpm, x.shape[1], 16, 5, 3)
    with torch.no_grad():
        h = xt
        for i, c in enumerate(m.convs):
            h = c(h, blocked=tb)
            if i < len(m.convs) - 1:
                h = nnf.elu(h)
    np.testing.assert_allclose(h.numpy(), ref, atol=5e-4)


def test_gat_eval_step_matches_flax(karate):
    x, y, cp, ri, g, jg = _graphs(karate)
    seeds = np.arange(x.shape[0])
    labels = y[seeds]
    fanouts = [4, 3]
    out = int(y.max()) + 1
    jm = jgnn.GAT(hidden=16, out=out, num_layers=2)
    init_fn, _, jeval = jtrainer(jm, fanouts)
    state = init_fn(jax.random.key(0), jg, jnp.asarray(x), jnp.asarray(seeds))
    jl, ja = jeval(state, jax.random.key(5), jg, jnp.asarray(x),
                   jnp.asarray(seeds), jnp.asarray(labels))
    m = gnn.GAT(x.shape[1], 16, out, 2, device="cpu")
    loss, acc = make_gnn_trainer(m, fanouts).eval_step(
        gnn_params_from_flax(state.params), rng.key(5), g,
        torch.from_numpy(x), seeds, labels)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(acc), float(ja), atol=1e-7)


@pytest.mark.parametrize("kind", list(KINDS))
def test_params_round_trip(kind):
    """Every flax leaf lands in exactly one state-dict key of the port's
    model, with the key's shape, and no key is left unfilled."""
    J, P = KINDS[kind]
    jp = J(hidden=8, out=3, num_layers=3).init(
        jax.random.key(0), jnp.zeros((5, 10)),
        jmake_graph(np.arange(6), np.zeros(5, np.int64), num_src=5,
                    num_dst=5))
    # distinct values in every leaf (GIN's eps all start at 0)
    draws = np.random.default_rng(0)
    jp = jax.tree_util.tree_map(
        lambda v: draws.normal(size=v.shape).astype(np.float32), jp)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    sd = gnn_params_from_flax(jp)
    assert gnn_params_from_flax(jp["params"]).keys() == sd.keys()
    m = P(10, 8, 3, 3, device="cpu")
    assert set(sd) == set(m.state_dict())
    assert len(sd) == len(leaves)
    for k, v in m.state_dict().items():
        assert sd[k].shape == v.shape, k
    # each leaf's values appear in exactly one key (Dense kernels transposed)
    for path, leaf in leaves:
        a = np.asarray(leaf)
        hits = [k for k, v in sd.items()
                if v.shape == (a.T.shape if a.ndim == 2 and
                               path[-1].key == "kernel" else a.shape)
                and np.array_equal(v.numpy(), a.T if path[-1].key == "kernel"
                                   else a)]
        assert len(hits) == 1, (path, hits)
    m.load_state_dict(sd)


@pytest.mark.parametrize("kind", list(KINDS))
def test_init_is_seeded(kind):
    P = KINDS[kind][1]
    a = P(10, 8, 4, 3, generator=torch.Generator().manual_seed(3),
          device="cpu")
    b = P(10, 8, 4, 3, generator=torch.Generator().manual_seed(3),
          device="cpu")
    for p, q in zip(a.state_dict().values(), b.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
    for k, p in a.state_dict().items():
        if k.endswith("eps"):
            assert float(p) == 0.0
        elif k.endswith(("a_src", "a_dst")):
            # lecun_normal: truncated at 2 std, std sqrt(1/H) / 0.8796
            std = (1.0 / p.shape[0]) ** 0.5 / 0.87962566103423978
            assert p.abs().max() <= 2 * std + 1e-6
        else:
            fan_in = p.shape[-1] if k.endswith("weight") else None
            if fan_in is not None:
                assert p.abs().max() <= fan_in ** -0.5


def test_tree_child_counts_and_degree(fake_dataset):
    x, _, cp, ri, g, jg = _graphs(fake_dataset)
    seeds = np.arange(0, x.shape[0], 13)
    ts = sample_neighbors(g, seeds, [5, 3], key=rng.key(2))
    js = jsample(jg, seeds, [5, 3], key=jax.random.key(2))
    np.testing.assert_array_equal(gnn.tree_child_counts(ts).numpy(),
                                  np.asarray(jgnn.tree_child_counts(js)))
    nodes = np.array([0, 5, 17, x.shape[0] - 1])
    np.testing.assert_array_equal(g.degree(nodes).numpy(),
                                  np.asarray(jg.degree(nodes)))


def test_gatconv_rejects_uneven_heads():
    with pytest.raises(ValueError):
        gnn.GATConv(8, 10, heads=4, device="cpu")
