"""Sampled training of the torch port against the JAX package's trainers,
on the CPU: flax parameters carried in, dropout 0, float32.

* one step of ``train_step`` for SAGE, GCN, GIN and GAT: parameters at rtol
  1e-5, atol 1e-6; the loss curve of K = 6 steps at rtol 1e-4;
* ``make_multibatch_sage_trainer`` at M = 3 equals three single steps
  (rtol 1e-5, atol 1e-6, dropout on) and JAX's multibatch losses (1e-4);
* keyed dropout: keep share, scale, one mask per key, identity when
  deterministic, dropout on in every model;
* ``split_sample_batches`` equal to JAX's, the optax Adam state carried
  across, checkpoint resume bit-equal, ``MetricsLogger`` records with
  JAX's keys, ``trace_span`` in a profiler trace, karate trained to the JAX
  test's accuracy, ``Data.csc()``.
"""
import copy
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.models import gnn as jgnn
from tch_geometric_tpu.models.sage import GraphSAGE as JSAGE
from tch_geometric_tpu.parallel.train import (
    make_gnn_trainer as jtrainer,
    make_multibatch_sage_trainer as jmultibatch)
from tch_geometric_tpu.sampling.neighbor import (
    _sample_neighbors_impl as j_sample_impl,
    split_sample_batches as jsplit)
from tch_geometric_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from tch_geometric_tpu_torch.data import Data, csc_graph_from_coo
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.io import _fixture_path
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.models import gnn
from tch_geometric_tpu_torch.models.dropout import keyed_dropout
from tch_geometric_tpu_torch.models.sage import GraphSAGE
from tch_geometric_tpu_torch.parallel import (TrainState, make_gnn_trainer,
                                              make_multibatch_sage_trainer,
                                              make_sage_trainer)
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.sampling.neighbor import (
    _sample_neighbors_impl, split_sample_batches)
from tch_geometric_tpu_torch.utils import (MetricsLogger, latest_step,
                                           profile, restore_checkpoint,
                                           save_checkpoint, trace_span,
                                           train_state_from_flax)
from tch_geometric_tpu_torch.utils.params import (gnn_params_from_flax,
                                                  sage_params_from_flax)

FANOUTS = [4, 3]
HIDDEN = 16
KINDS = {"SAGE": (JSAGE, GraphSAGE, sage_params_from_flax),
         "GCN": (jgnn.GCN, gnn.GCN, gnn_params_from_flax),
         "GIN": (jgnn.GIN, gnn.GIN, gnn_params_from_flax),
         "GAT": (jgnn.GAT, gnn.GAT, gnn_params_from_flax)}


def _graphs(data):
    x, y, ei = data
    n = x.shape[0]
    cp, ri, _ = to_csc(ei, n)
    return dict(x=x.astype(np.float32), y=y, n=n,
                g=make_graph(cp, ri, num_src=n, num_dst=n, device="cpu"),
                jg=jmake_graph(cp, ri, num_src=n, num_dst=n))


@pytest.fixture(scope="module")
def karate_graphs(karate):
    return _graphs(karate)


@pytest.fixture(scope="module")
def fake_graphs(fake_dataset):
    """The JAX comparisons of Adam steps run on these dense features: on
    karate's one-hot features, GAT's gradient has whole columns that are 0
    in exact arithmetic (a seed's own row reaches the loss only through
    a_dst, which shifts all its children's logits alike) and rounding noise
    of 1e-11 in float32 in both packages, of either sign, which Adam's
    first step turns into moves of about lr * |g| / (|g| + eps)."""
    return _graphs(fake_dataset)


def _seeds(n_batches, batch, seed=0, n=34):
    return np.random.default_rng(seed).integers(0, n, (n_batches, batch))


def _jax_setup(kind, kg, seeds0, **trainer_kw):
    """The flax model, JAX trainer and its initial state, and the port's
    model holding the same parameters."""
    J, P, conv = KINDS[kind]
    out = int(kg["y"].max()) + 1
    jm = J(hidden=HIDDEN, out=out, num_layers=2)
    trainer = jtrainer(jm, FANOUTS, **trainer_kw)
    state = trainer[0](jax.random.key(0), kg["jg"], jnp.asarray(kg["x"]),
                       jnp.asarray(seeds0))
    m = P(kg["x"].shape[1], HIDDEN, out, 2, device="cpu")
    m.load_state_dict(conv(state.params))
    return trainer, state, m, conv


def _assert_params(model, jparams, conv, **tol):
    want = conv(jparams)
    got = model.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


@pytest.mark.parametrize("kind", list(KINDS))
def test_train_step_matches_jax(fake_graphs, kind):
    """Parameters after one step, then the K-step loss curve."""
    kg = fake_graphs
    K = 6
    seeds = _seeds(K, 32, n=kg["n"])
    labels = kg["y"][seeds]
    (_, jstep, _), js, m, conv = _jax_setup(kind, kg, seeds[0])
    trainer = make_gnn_trainer(m, FANOUTS)
    ts = trainer.init_fn(rng.key(0), kg["g"], torch.from_numpy(kg["x"]),
                         seeds[0])
    xj, xt = jnp.asarray(kg["x"]), torch.from_numpy(kg["x"])
    jl, tl = [], []
    for i in range(K):
        js, loss_j, acc_j = jstep(js, jax.random.key(3), kg["jg"], xj,
                                  jnp.asarray(seeds[i]),
                                  jnp.asarray(labels[i]))
        ts, loss_t, acc_t = trainer.train_step(ts, rng.key(3), kg["g"], xt,
                                               seeds[i], labels[i])
        assert loss_t.device.type == "cpu" and loss_t.shape == ()
        jl.append(float(loss_j))
        tl.append(float(loss_t))
        np.testing.assert_allclose(float(acc_t), float(acc_j), atol=1e-7)
        if i == 0:
            _assert_params(m, js.params, conv, rtol=1e-5, atol=1e-6)
    assert ts.step == int(js.step) == K
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_multibatch_equals_single_steps_and_jax(karate_graphs):
    kg = karate_graphs
    M, B = 3, 8
    seeds = _seeds(M, B, seed=1)
    labels = kg["y"][seeds]
    xt = torch.from_numpy(kg["x"])
    # the port against itself, dropout on: M single steps == one M-step
    single = GraphSAGE(34, HIDDEN, 4, 2, dropout=0.5, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    multi = copy.deepcopy(single)
    t1 = make_sage_trainer(single, FANOUTS)
    tm = make_multibatch_sage_trainer(multi, FANOUTS)
    s1, sm = t1.init_fn(), tm.init_fn()
    key = rng.key(42)
    losses1 = []
    for i in range(M):
        s1, loss, _ = t1.train_step(s1, key, kg["g"], xt, seeds[i], labels[i])
        losses1.append(float(loss))
    sm, losses_m, accs_m = tm.train_step(sm, key, kg["g"], xt, seeds, labels)
    assert s1.step == sm.step == M and losses_m.shape == accs_m.shape == (M,)
    for k, p in single.state_dict().items():
        np.testing.assert_allclose(multi.state_dict()[k].numpy(), p.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(losses_m.numpy(), losses1, rtol=1e-5)

    # against JAX's multibatch trainer, dropout 0
    jm = JSAGE(hidden=HIDDEN, out=4, num_layers=2)
    jinit, jstep = jmultibatch(jm, FANOUTS)
    js = jinit(jax.random.key(0), kg["jg"], jnp.asarray(kg["x"]),
               jnp.asarray(seeds[0]))
    js, jlosses, jaccs = jstep(js, jax.random.key(42), kg["jg"],
                               jnp.asarray(kg["x"]), jnp.asarray(seeds),
                               jnp.asarray(labels))
    m = GraphSAGE(34, HIDDEN, 4, 2, device="cpu")
    m.load_state_dict(sage_params_from_flax(
        jinit(jax.random.key(0), kg["jg"], jnp.asarray(kg["x"]),
              jnp.asarray(seeds[0])).params))
    tm = make_multibatch_sage_trainer(m, FANOUTS)
    _, losses, accs = tm.train_step(tm.init_fn(), rng.key(42), kg["g"], xt,
                                    seeds, labels)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    np.testing.assert_allclose(accs.numpy(), np.asarray(jaccs), atol=1e-7)
    _assert_params(m, js.params, sage_params_from_flax, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.8])
def test_keyed_dropout_law(rate):
    h = torch.rand((400, 300)) + 0.5           # >= 1e5 elements, none zero
    out = keyed_dropout(h, rng.key(7), rate, 1)
    kept = out != 0
    n = h.numel()
    p = 1.0 - rate
    assert abs(kept.float().mean().item() - p) <= 4 * (p * (1 - p) / n) ** 0.5
    torch.testing.assert_close(out[kept], h[kept] / p, rtol=0, atol=0)
    # one key, one mask; another step's key, another mask; another layer too
    again = keyed_dropout(h, rng.key(7), rate, 1)
    assert torch.equal(again, out)
    for other in (keyed_dropout(h, rng.fold(rng.key(7), 1), rate, 1),
                  keyed_dropout(h, rng.key(7), rate, 2)):
        assert not torch.equal(other != 0, kept)
    assert keyed_dropout(h, rng.key(7), rate, 1, deterministic=True) is h
    assert keyed_dropout(h, None, 0.0, 1) is h
    with pytest.raises(ValueError):
        keyed_dropout(h, None, rate, 1)


@pytest.mark.parametrize("kind", list(KINDS))
def test_dropout_trains_in_every_model(karate_graphs, kind):
    """dropout > 0 draws a mask in tree_forward (so the step's logits differ
    from the deterministic ones) and a train step runs; without a key the
    forward raises."""
    kg = karate_graphs
    P = KINDS[kind][1]
    m = P(34, HIDDEN, 4, 2, dropout=0.5, device="cpu",
          generator=torch.Generator().manual_seed(0))
    trainer = make_gnn_trainer(m, FANOUTS)
    xt = torch.from_numpy(kg["x"])
    sample, x = trainer.sample_and_gather(rng.key(1), kg["g"], xt,
                                          np.arange(34))
    with torch.no_grad():
        det = m.tree_forward(sample, x)
        drop = m.tree_forward(sample, x, deterministic=False,
                              dropout_key=rng.key(2))
        assert not torch.allclose(det, drop)
        with pytest.raises(ValueError):
            m.tree_forward(sample, x, deterministic=False)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    state, loss, acc = trainer.train_step(trainer.init_fn(), rng.key(1),
                                          kg["g"], xt, np.arange(34), kg["y"])
    assert state.step == 1 and bool(torch.isfinite(loss))
    assert any(not torch.equal(before[k], v)
               for k, v in m.state_dict().items())


def test_split_sample_batches_matches_jax(karate_graphs):
    """Mirror of tests/test_multibatch_split.py on the port: the same tree,
    split by both packages, array for array."""
    kg = karate_graphs
    M, B = 4, 8
    r = np.random.default_rng(0)
    seeds = r.integers(0, 34, M * B)
    fanouts = (3, 2)
    js = j_sample_impl(jax.random.key(0), kg["jg"],
                       jnp.asarray(seeds.astype(np.int32)),
                       jnp.zeros((M * B,), jnp.int32), None, None, fanouts,
                       False, None, 256)
    ts = _sample_neighbors_impl(rng.key(0), kg["g"], torch.from_numpy(seeds),
                                torch.zeros(M * B, dtype=torch.long), fanouts,
                                False)
    xt = r.normal(size=(34, 5)).astype(np.float32)
    jx = jnp.asarray(xt)[jnp.clip(js.nodes, 0, 33)]
    tx = torch.from_numpy(xt)[ts.nodes.clamp(0, 33)]
    jsp, jxs = jsplit(js, M, jx)
    tsp, txs = split_sample_batches(ts, M, tx)
    assert tsp.node_base == tuple(jsp.node_base)
    assert tsp.edge_base == tuple(jsp.edge_base)
    for f in ("nodes", "node_valid", "node_state", "rows", "cols", "eptr",
              "edge_valid"):
        a, b = getattr(tsp, f).numpy(), np.asarray(getattr(jsp, f))
        assert a.shape == b.shape and (a == b).all(), f
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    assert split_sample_batches(ts, M).nodes.shape == (M, tsp.node_base[-1])
    with pytest.raises(ValueError):
        split_sample_batches(ts, 5)


def test_optax_state_carried_across(fake_graphs):
    """K steps in JAX; params and the optax Adam state carried into the
    port; K more steps in both agree."""
    kg = fake_graphs
    K = 3
    seeds = _seeds(2 * K, 32, seed=2, n=kg["n"])
    labels = kg["y"][seeds]
    (_, jstep, _), js, m, conv = _jax_setup("SAGE", kg, seeds[0])
    xj = jnp.asarray(kg["x"])
    for i in range(K):
        js, _, _ = jstep(js, jax.random.key(5), kg["jg"], xj,
                         jnp.asarray(seeds[i]), jnp.asarray(labels[i]))
    ts = train_state_from_flax(m, js, sage_params_from_flax)
    assert ts.step == K and ts.opt_state.count == K
    trainer = make_sage_trainer(m, FANOUTS)
    xt = torch.from_numpy(kg["x"])
    jl, tl = [], []
    for i in range(K, 2 * K):
        js, loss_j, _ = jstep(js, jax.random.key(5), kg["jg"], xj,
                              jnp.asarray(seeds[i]), jnp.asarray(labels[i]))
        ts, loss_t, _ = trainer.train_step(ts, rng.key(5), kg["g"], xt,
                                           seeds[i], labels[i])
        jl.append(float(loss_j))
        tl.append(float(loss_t))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_params(m, js.params, conv, rtol=1e-4, atol=1e-5)


def test_checkpoint_resume_bit_equal(karate_graphs, tmp_path):
    kg = karate_graphs
    seeds = _seeds(4, 8, seed=3)
    labels = kg["y"][seeds]
    xt = torch.from_numpy(kg["x"])
    base = GraphSAGE(34, HIDDEN, 4, 2, dropout=0.5, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    key = rng.key(0)

    def run(model, state, steps):
        trainer = make_sage_trainer(model, FANOUTS)
        state = state if state is not None else trainer.init_fn()
        losses = []
        for i in steps:
            state, loss, _ = trainer.train_step(state, key, kg["g"], xt,
                                                seeds[i], labels[i])
            losses.append(loss)
        return state, losses

    full_model = copy.deepcopy(base)
    _, full = run(full_model, None, range(4))
    half_model = copy.deepcopy(base)
    half, _ = run(half_model, None, range(2))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, {"state": half, "key": key}, step=half.step)
    assert latest_step(ckpt) == 2
    resumed_model = copy.deepcopy(base)
    template = {"state": make_sage_trainer(resumed_model, FANOUTS).init_fn(),
                "key": rng.key(99)}
    restored = restore_checkpoint(ckpt, template, step=2)
    assert isinstance(restored["state"], TrainState)
    assert restored["state"].step == 2 and torch.equal(restored["key"], key)
    assert restored["state"].opt_state.count == 2
    _, rest = run(resumed_model, restored["state"], range(2, 4))
    for a, b in zip(rest, full[2:]):
        assert torch.equal(a, b)
    for k, p in full_model.state_dict().items():
        assert torch.equal(resumed_model.state_dict()[k], p), k


def test_latest_step_empty(tmp_path):
    assert latest_step(str(tmp_path / "nope")) is None
    (tmp_path / "empty").mkdir()
    assert latest_step(str(tmp_path / "empty")) is None


def test_metrics_logger_keys_match_jax():
    """The same calls give records with the same keys (the times differ)."""
    def records(cls):
        buf = io.StringIO()
        m = cls(stream=buf)
        m.step(0, loss=1.5)
        m.step(1, edges=1000, batch_size=32, loss=1.2,
               acc=torch.tensor(0.5) if cls is MetricsLogger else 0.5)
        m.event(phase="eval", ms=3.0)
        return [json.loads(line) for line in buf.getvalue().splitlines()]
    got, want = records(MetricsLogger), records(JMetricsLogger)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert got[0] == want[0] == {"step": 0, "loss": 1.5}
    assert got[1]["acc"] == 0.5 and got[2] == want[2]


def test_trace_span_in_profiler_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    with profile(logdir) as prof:
        with trace_span("unit-test-span"):
            torch.zeros(4).add_(1.0)
    assert "unit-test-span" in {e.name for e in prof.events()}
    with open(os.path.join(logdir, "trace.json")) as f:
        assert "unit-test-span" in f.read()


def test_karate_trains_to_jax_threshold(karate_graphs):
    """tests/test_models_train.py::test_sage_train_karate_e2e on the port:
    hidden 32, lr 5e-3, 60 steps over all 34 seeds, eval acc >= 0.9."""
    kg = karate_graphs
    model = GraphSAGE(34, 32, int(kg["y"].max()) + 1, 2, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    trainer = make_sage_trainer(model, FANOUTS, learning_rate=5e-3)
    xt = torch.from_numpy(kg["x"])
    seeds = np.arange(34)
    key = rng.key(0)
    state = trainer.init_fn(key, kg["g"], xt, seeds)
    for _ in range(60):
        state, loss, acc = trainer.train_step(state, key, kg["g"], xt, seeds,
                                              kg["y"])
    loss, acc = trainer.eval_step(state, key, kg["g"], xt, seeds, kg["y"])
    assert float(acc) >= 0.9, (float(loss), float(acc))


def test_data_csc_matches_make_graph():
    data = Data.from_npz(_fixture_path("fakedataset.npz"))
    n = data.num_nodes
    cp, ri, perm = to_csc(data.edge_index, n)
    ref = make_graph(cp, ri, perm, num_src=n, num_dst=n, device="cpu")
    got = data.csc(device="cpu")
    assert data.csc(device="cpu") is got and data.y is not None
    for f in ("indptr", "indices", "perm", "indices_win", "ell"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        assert a is None or torch.equal(a, b), f
    assert (got.num_src, got.num_dst, got.max_degree) == (
        ref.num_src, ref.num_dst, ref.max_degree)
    csr = data.csr(device="cpu")
    assert torch.equal(csr.indptr, torch.from_numpy(np.searchsorted(
        np.sort(data.edge_index[0]), np.arange(n + 1))))
    direct = csc_graph_from_coo(data.edge_index, n, device="cpu")
    assert torch.equal(direct.indices, ref.indices)


def test_sage_bf16_tree_forward_matches_flax(fake_graphs):
    """``GraphSAGE(dtype=bfloat16)``: the linears cast inputs and weights
    to bfloat16 as flax's ``Dense(dtype=...)`` does, so the activations and
    the next layer's masked mean are bfloat16; the parameters stay
    float32.  Held against flax at bfloat16's resolution (2e-2 of the
    largest logit)."""
    kg = fake_graphs
    seeds = np.arange(0, kg["n"], 17)
    ts = _sample_neighbors_impl(rng.key(4), kg["g"], torch.from_numpy(seeds),
                                torch.zeros(len(seeds), dtype=torch.long),
                                (5, 3), False)
    js = j_sample_impl(jax.random.key(4), kg["jg"],
                       jnp.asarray(seeds.astype(np.int32)),
                       jnp.zeros((len(seeds),), jnp.int32), None, None,
                       (5, 3), False, None, 256)
    xj = jnp.asarray(kg["x"])[jnp.clip(js.nodes, 0, kg["n"] - 1)]
    jm = JSAGE(hidden=HIDDEN, out=5, num_layers=2, dtype=jnp.bfloat16)
    jp = jm.init(jax.random.key(0), js, xj, method=JSAGE.tree_forward)
    ref = np.asarray(jm.apply(jp, js, xj, method=JSAGE.tree_forward)
                     .astype(jnp.float32))
    m = GraphSAGE(kg["x"].shape[1], HIDDEN, 5, 2, dtype=torch.bfloat16,
                  device="cpu")
    m.load_state_dict(sage_params_from_flax(jp))
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        out = m.tree_forward(ts, torch.from_numpy(kg["x"])[
            ts.nodes.clamp(0, kg["n"] - 1)])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("schedule", [False, True])
def test_adam_update_matches_optax(schedule):
    """``adam_update`` against ``optax.adam`` on the same gradients for five
    updates, with a constant rate and with a schedule of the count (optax
    calls it with the count before the update)."""
    import optax
    from tch_geometric_tpu_torch.parallel.train import adam_init, adam_update
    r = np.random.default_rng(5)
    shapes = {"w": (7, 5), "b": (5,)}
    params = {k: r.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    lr = (optax.cosine_decay_schedule(1e-2, 10) if schedule else 1e-2)
    tx = optax.adam(lr)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = adam_init(tp)
    tlr = ((lambda c: float(optax.cosine_decay_schedule(1e-2, 10)(c)))
           if schedule else 1e-2)
    for _ in range(5):
        g = {k: r.normal(size=s).astype(np.float32) * 1e-3
             for k, s in shapes.items()}
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = adam_update(tp, {k: torch.from_numpy(v)
                                  for k, v in g.items()}, tstate, tlr)
    assert tstate.count == 5
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tstate.mu[k].numpy(),
                                   np.asarray(jstate[0].mu[k]), rtol=1e-6)
        np.testing.assert_allclose(tstate.nu[k].numpy(),
                                   np.asarray(jstate[0].nu[k]), rtol=1e-6)
