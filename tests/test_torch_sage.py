"""GraphSAGE of the torch port against the flax model, with the flax
parameters carried over by sage_params_from_flax: tree_forward at 1e-5,
full-graph __call__ and blocked_forward (float32 compute) at 5e-4, and
eval_step's loss and accuracy."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.models.sage import GraphSAGE as JSAGE
from tch_geometric_tpu.parallel.train import make_gnn_trainer as jtrainer
from tch_geometric_tpu.sampling.neighbor import sample_neighbors as jsample
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.models.sage import GraphSAGE
from tch_geometric_tpu_torch.parallel.train import make_gnn_trainer
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.sampling.neighbor import sample_neighbors
from tch_geometric_tpu_torch.utils.params import sage_params_from_flax

jsb = importlib.import_module("tch_geometric_tpu.ops.spmm_blocked")
tsb = importlib.import_module("tch_geometric_tpu_torch.ops.spmm_blocked")


def _graphs(data):
    x, y, ei = data
    n = x.shape[0]
    cp, ri, _ = to_csc(ei, n)
    g = make_graph(cp, ri, num_src=n, num_dst=n, device="cpu")
    jg = jmake_graph(cp, ri, num_src=n, num_dst=n)
    return x.astype(np.float32), y, cp, ri, g, jg


def _port(jparams, in_f, hidden, out, layers):
    m = GraphSAGE(in_f, hidden, out, layers, device="cpu")
    m.load_state_dict(sage_params_from_flax(jparams))
    return m


@pytest.mark.parametrize("layers,fanouts", [(2, [4, 3]), (3, [5, 3, 2])])
def test_tree_forward_matches_flax(fake_dataset, layers, fanouts):
    x, _, cp, ri, g, jg = _graphs(fake_dataset)
    seeds = np.arange(0, x.shape[0], 29)
    ts = sample_neighbors(g, seeds, fanouts, key=rng.key(1))
    js = jsample(jg, seeds, fanouts, key=jax.random.key(1))
    xj = jnp.asarray(x)[jnp.clip(js.nodes, 0, x.shape[0] - 1)]
    xt = torch.from_numpy(x)[ts.nodes.clamp(0, x.shape[0] - 1)]
    jm = JSAGE(hidden=16, out=5, num_layers=layers)
    jp = jm.init(jax.random.key(0), js, xj, method=JSAGE.tree_forward)
    ref = np.asarray(jm.apply(jp, js, xj, method=JSAGE.tree_forward))
    m = _port(jp, x.shape[1], 16, 5, layers)
    with torch.no_grad():
        out = m.tree_forward(ts, xt).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["blocked", "hot", "segmented",
                                    "hot_segmented"])
def test_full_graph_and_blocked_forward_match_flax(fake_dataset, layout):
    x, _, cp, ri, g, jg = _graphs(fake_dataset)
    jm = JSAGE(hidden=16, out=5, num_layers=2)
    xj = jnp.asarray(x)
    jp = jm.init(jax.random.key(2), xj, jg)
    ref = np.asarray(jm.apply(jp, xj, jg))
    m = _port(jp, x.shape[1], 16, 5, 2)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(m(xt, g).numpy(), ref, atol=5e-4)
        kw = dict(rows_per_block=128)
        tb = {"blocked": lambda: tsb.build_blocked(cp, ri, device="cpu",
                                                   **kw),
              "hot": lambda: tsb.build_blocked_hot(cp, ri, hot_k=64,
                                                   device="cpu", **kw),
              "segmented": lambda: tsb.build_blocked_segmented(
                  cp, ri, num_segments=3, device="cpu", **kw),
              "hot_segmented": lambda: tsb.build_blocked_hot_segmented(
                  cp, ri, hot_k=64, num_segments=3, device="cpu",
                  **kw)}[layout]()
        out = m.blocked_forward(xt, tb, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(out, ref, atol=5e-4)
    if layout == "blocked":
        jb = jsb.build_blocked(cp, ri, **kw)
        jref = np.asarray(jm.apply(jp, xj, jb, compute_dtype=jnp.float32,
                                   method=JSAGE.blocked_forward))
        np.testing.assert_allclose(out, jref, atol=5e-4)


def test_eval_step_matches_flax(karate):
    x, y, cp, ri, g, jg = _graphs(karate)
    seeds = np.arange(x.shape[0])
    labels = y[seeds]
    fanouts = [4, 3]
    jm = JSAGE(hidden=16, out=int(y.max()) + 1, num_layers=2)
    init_fn, _, jeval = jtrainer(jm, fanouts)
    state = init_fn(jax.random.key(0), jg, jnp.asarray(x), jnp.asarray(seeds))
    jl, ja = jeval(state, jax.random.key(5), jg, jnp.asarray(x),
                   jnp.asarray(seeds), jnp.asarray(labels))
    m = GraphSAGE(x.shape[1], 16, int(y.max()) + 1, 2, device="cpu")
    trainer = make_gnn_trainer(m, fanouts)
    loss, acc = trainer.eval_step(sage_params_from_flax(state.params),
                                  rng.key(5), g, torch.from_numpy(x), seeds,
                                  labels)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(acc), float(ja), atol=1e-7)
    sample, xs = trainer.sample_and_gather(rng.key(5), g, torch.from_numpy(x),
                                           seeds)
    assert xs.shape == (sample.nodes.shape[0], x.shape[1])


def test_init_is_torch_linear_and_seeded():
    gen = torch.Generator().manual_seed(3)
    a = GraphSAGE(10, 8, 4, 3, generator=gen, device="cpu")
    b = GraphSAGE(10, 8, 4, 3, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    for (k, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
        fan_in = 10 if k.startswith("convs.0.") else 8
        assert p.abs().max() <= fan_in ** -0.5
    keys = set(a.state_dict())
    assert keys == {f"convs.{i}.{n}" for i in range(3)
                    for n in ("lin_self.weight", "lin_self.bias",
                              "lin_neigh.weight")}
    jp = JSAGE(hidden=8, out=4, num_layers=3).init(
        jax.random.key(0), jnp.zeros((5, 10)),
        jmake_graph(np.arange(6), np.zeros(5, np.int64), num_src=5,
                    num_dst=5))
    sd = sage_params_from_flax(jp)
    assert set(sd) == keys
    assert all(sd[k].shape == v.shape for k, v in a.state_dict().items())
