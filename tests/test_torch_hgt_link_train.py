"""The torch port's HGT and link-prediction trainers against the JAX
package's, on the CPU, with flax parameters carried in:

* ``make_hgt_trainer`` on fakeheterodataset (16 v0 seeds, [8, 8] per type,
  2 hops, seeded labels), both layouts and a temporal run: K = 4 steps,
  losses at rtol 1e-4, accuracies at 1e-7, parameters after K at rtol 1e-4,
  atol 1e-5 (the SAGE trainer tests' limits), and once from a JAX state
  stopped at step 2 (parameters and optax state carried across); save the
  key linears' biases: a bias adds one score to all of a destination's
  in-edges of a relation, which the softmax cancels, so their gradient is
  zero in exact arithmetic and Adam moves them by rounding noise (under
  lr a step) on both sides;
* ``make_link_trainer`` with a 2-layer SAGE at dropout 0.5 on
  fakedataset's CSC: K = 4 steps (same limits; rank accuracies at 1e-7)
  and an ``eval_step``.  The port draws flax's own dropout masks
  (``models/dropout.py``), so the JAX side is the plain flax GraphSAGE
  and the masks, and the trainer's key for them, are held too;
* the link trainer on a complete graph, where every candidate is
  rejected: the loss is the positives' alone, equal to JAX's, and
  ``first_accepted`` equals ``jnp.argmax`` of bool rows, all-False ones
  included;
* a checkpoint round trip of an ``HGTTrainState``.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.models.hgt import HGT as JHGT
from tch_geometric_tpu.models.sage import GraphSAGE as JSAGE
from tch_geometric_tpu.parallel.hgt_train import \
    make_hgt_trainer as jhgt_trainer
from tch_geometric_tpu.parallel.link_train import \
    make_link_trainer as jlink_trainer
from tch_geometric_tpu_torch.data import io
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.models import HGT, GraphSAGE
from tch_geometric_tpu_torch.parallel import (HGTTrainState, TrainState,
                                              make_hgt_trainer,
                                              make_link_trainer)
from tch_geometric_tpu_torch.parallel.link_train import first_accepted
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils import (restore_checkpoint,
                                           save_checkpoint)
from tch_geometric_tpu_torch.utils.params import (hgt_params_from_flax,
                                                  load_flax_params,
                                                  sage_params_from_flax,
                                                  train_state_from_flax)
from tch_geometric_tpu_torch.utils.types import rel_key

K = 4
LR = 1e-2
SEEDS, SAMPLES, HOPS, CLASSES = 16, [8, 8], 2, 4
HIDDEN = 8


@pytest.fixture(scope="module")
def hetero():
    xs, coo = io.load_fake_hetero_graph()
    counts = {t: v.shape[0] for t, v in xs.items()}
    edge_types = sorted(coo)
    graphs, jgraphs, ts = {}, {}, {}
    r = np.random.default_rng(0)
    for e in edge_types:
        k = rel_key(e)
        cp, ri, _ = to_csc(coo[e], (counts[e[0]], counts[e[2]]))
        kw = dict(num_src=counts[e[0]], num_dst=counts[e[2]])
        graphs[k] = make_graph(cp, ri, device="cpu", **kw)
        jgraphs[k] = jmake_graph(cp, ri, **kw)
        ts[k] = r.integers(0, 100, len(ri))
    xs = {t: v.astype(np.float32) for t, v in xs.items()}
    return dict(xs=xs, counts=counts, edge_types=edge_types, g=graphs,
                jg=jgraphs, ts=ts)


def _hgt_batches(counts):
    r = np.random.default_rng(3)
    seeds = r.integers(0, counts["v0"], (K, SEEDS))
    return seeds, r.integers(0, CLASSES, (K, SEEDS))


def _hgt_run(h, stacked, timerange=None, carry_at=0):
    """K steps of the JAX trainer and of the port's from the same
    parameters (with ``carry_at``, the port starts from the JAX state after
    that many steps, parameters and optax state carried by
    ``train_state_from_flax``); returns both loss and accuracy curves from
    there and the final parameters."""
    node_types = tuple(sorted(h["counts"]))
    rel_specs = tuple(sorted((rel_key(e), e[0], e[2])
                             for e in h["edge_types"]))
    num_samples = {t: SAMPLES for t in node_types}
    ts = h["ts"] if timerange is not None else None
    seeds, labels = _hgt_batches(h["counts"])
    jm = JHGT(hidden=HIDDEN, out=CLASSES, num_layers=2,
              node_types=node_types, rel_specs=rel_specs, out_type="v0",
              heads=2, stacked_rels=stacked)
    jinit, jstep = jhgt_trainer(
        jm, h["jg"], h["edge_types"], num_samples, HOPS, h["counts"],
        {t: jnp.asarray(v) for t, v in h["xs"].items()}, seed_type="v0",
        learning_rate=LR,
        edge_timestamps=None if ts is None else {
            k: jnp.asarray(v, jnp.int32) for k, v in ts.items()},
        timerange=timerange)
    js = jinit(jax.random.key(0), jnp.asarray(seeds[0]))
    for i in range(carry_at):
        js, _, _ = jstep(js, jax.random.key(5), jnp.asarray(seeds[i]),
                         jnp.asarray(labels[i]))
    m = HGT({t: v.shape[1] for t, v in h["xs"].items()}, HIDDEN, CLASSES, 2,
            node_types, rel_specs, "v0", heads=2, stacked_rels=stacked,
            device="cpu")
    carry = functools.partial(hgt_params_from_flax, rel_specs=rel_specs,
                              stacked_rels=stacked)
    trainer = make_hgt_trainer(
        m, h["g"], h["edge_types"], num_samples, HOPS, h["counts"],
        {t: torch.from_numpy(v) for t, v in h["xs"].items()},
        seed_type="v0", learning_rate=LR, edge_timestamps=ts,
        timerange=timerange)
    if carry_at:
        state = train_state_from_flax(m, js, carry, HGTTrainState)
        assert state.step == state.opt_state.count == carry_at
    else:
        load_flax_params(m, carry(js.params))
        state = trainer.init_fn()
    out = {"jl": [], "ja": [], "tl": [], "ta": []}
    for i in range(carry_at, K):
        js, jl, ja = jstep(js, jax.random.key(5), jnp.asarray(seeds[i]),
                           jnp.asarray(labels[i]))
        state, tl, ta = trainer.train_step(state, rng.key(5), seeds[i],
                                           labels[i])
        out["jl"].append(float(jl))
        out["ja"].append(float(ja))
        out["tl"].append(float(tl))
        out["ta"].append(float(ta))
    assert isinstance(state, HGTTrainState) and state.step == K
    return out, m, hgt_params_from_flax(js.params, rel_specs, stacked)


@pytest.mark.parametrize("stacked,timerange,carry_at",
                         [(False, None, 0), (True, None, 0),
                          (False, (20, 80), 0), (True, None, 2)],
                         ids=["per_rel", "stacked", "per_rel_temporal",
                              "stacked_carried_at_2"])
def test_hgt_trainer_matches_jax(hetero, stacked, timerange, carry_at):
    out, m, want = _hgt_run(hetero, stacked, timerange, carry_at)
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-4)
    np.testing.assert_allclose(out["ta"], out["ja"], atol=1e-7)
    got = m.state_dict()
    assert set(got) == set(want)
    for k in want:
        if ".k." in k and k.endswith(".bias"):
            for side in (got[k], want[k]):
                assert float(side.abs().max()) < K * LR, k
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_hgt_checkpoint_round_trip(hetero, tmp_path):
    h = hetero
    node_types = tuple(sorted(h["counts"]))
    rel_specs = tuple(sorted((rel_key(e), e[0], e[2])
                             for e in h["edge_types"]))
    seeds, labels = _hgt_batches(h["counts"])
    base = HGT({t: v.shape[1] for t, v in h["xs"].items()}, HIDDEN, CLASSES,
               2, node_types, rel_specs, "v0", device="cpu",
               generator=torch.Generator().manual_seed(2))
    xs = {t: torch.from_numpy(v) for t, v in h["xs"].items()}

    def trainer_of(model):
        return make_hgt_trainer(model, h["g"], h["edge_types"],
                                {t: SAMPLES for t in node_types}, HOPS,
                                h["counts"], xs, seed_type="v0")

    def run(model, state, steps):
        tr = trainer_of(model)
        state = state if state is not None else tr.init_fn()
        losses = []
        for i in steps:
            state, loss, _ = tr.train_step(state, rng.key(1), seeds[i],
                                           labels[i])
            losses.append(loss)
        return state, losses

    full = copy.deepcopy(base)
    _, want = run(full, None, range(K))
    half_model = copy.deepcopy(base)
    half, _ = run(half_model, None, range(2))
    save_checkpoint(str(tmp_path), {"state": half}, step=2)
    resumed = copy.deepcopy(base)
    restored = restore_checkpoint(
        str(tmp_path), {"state": trainer_of(resumed).init_fn()},
        step=2)["state"]
    assert isinstance(restored, HGTTrainState) and restored.step == 2
    _, rest = run(resumed, restored, range(2, K))
    assert all(torch.equal(a, b) for a, b in zip(rest, want[2:]))
    for k, p in full.state_dict().items():
        assert torch.equal(resumed.state_dict()[k], p), k


def _link_graphs(x, ei):
    n = x.shape[0]
    cp, ri, _ = to_csc(ei, n)
    return (make_graph(cp, ri, num_src=n, num_dst=n, device="cpu"),
            jmake_graph(cp, ri, num_src=n, num_dst=n))


def _link_run(x, ei, src, dst, *, dropout, steps=K, **kw):
    g, jg = _link_graphs(x, ei)
    jm = JSAGE(hidden=HIDDEN, out=HIDDEN, num_layers=2, dropout=dropout)
    jinit, jstep, jeval = jlink_trainer(jm, [3, 2], **kw)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    js = jinit(jax.random.key(0), jg, xj, jnp.asarray(src[0]),
               jnp.asarray(dst[0]))
    m = GraphSAGE(x.shape[1], HIDDEN, HIDDEN, 2, dropout=dropout,
                  device="cpu")
    m.load_state_dict(sage_params_from_flax(js.params))
    trainer = make_link_trainer(m, [3, 2], **kw)
    state = trainer.init_fn()
    out = {"jl": [], "jr": [], "tl": [], "tr": []}
    for i in range(steps):
        js, jl, jr = jstep(js, jax.random.key(9), jg, xj,
                           jnp.asarray(src[i]), jnp.asarray(dst[i]))
        state, tl, tr = trainer.train_step(state, rng.key(9), g, xt, src[i],
                                           dst[i])
        out["jl"].append(float(jl))
        out["jr"].append(float(jr))
        out["tl"].append(float(tl))
        out["tr"].append(float(tr))
    assert isinstance(state, TrainState) and state.step == steps
    out["eval"] = (jeval(js, jax.random.key(4), jg, xj, jnp.asarray(src[0]),
                         jnp.asarray(dst[0])),
                   trainer.eval_step(state, rng.key(4), g, xt, src[0],
                                     dst[0]))
    return out, m, sage_params_from_flax(js.params)


def test_link_trainer_matches_jax(fake_dataset):
    x, _, ei = fake_dataset
    x = x.astype(np.float32)
    pick = np.random.default_rng(4).integers(0, ei.shape[1], (K, 24))
    out, m, want = _link_run(x, ei, ei[0][pick], ei[1][pick], dropout=0.5,
                             num_neg=2, try_count=4, learning_rate=1e-2)
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-4)
    np.testing.assert_allclose(out["tr"], out["jr"], atol=1e-7)
    (jl, jr), (tl, tr) = out["eval"]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tr), float(jr), atol=1e-7)
    for k, p in m.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_link_trainer_all_negatives_rejected():
    """On the complete graph every candidate is an edge from its source
    (or the source itself): no negative is accepted, and the loss is the
    positives' binary cross entropy alone."""
    n = 6
    u, v = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    off = u != v
    ei = np.stack([u[off], v[off]])
    x = np.random.default_rng(5).normal(size=(n, 5)).astype(np.float32)
    src = np.array([[0, 1, 2, 3, 4, 5]] * 2)
    dst = (src + 1) % n
    out, _, _ = _link_run(x, ei, src, dst, dropout=0.0, steps=2, num_neg=3,
                          try_count=2)
    np.testing.assert_allclose(out["tl"], out["jl"], rtol=1e-4)
    assert out["tr"] == out["jr"] == [0.0, 0.0]


def test_first_accepted_is_jnp_argmax():
    ok = np.random.default_rng(6).random((50, 3, 5)) < 0.2
    ok[0] = False                               # every row all rejected
    got = first_accepted(torch.from_numpy(ok)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(ok, axis=-1)))
    assert (got[0] == 0).all() and not ok.any(axis=-1).all()
