"""The torch port's node2vec against the JAX package's, on the CPU, with
the flax embedding carried in by ``node2vec_params_from_flax``:

* ``Node2Vec.loss`` on walks with dead ends (-1) and negatives, and its
  gradient (rtol 1e-5 and 1e-4, atol 1e-7);
* K = 4 steps of ``make_node2vec_trainer`` on fakedataset's out-edge CSR
  (walks of 6 steps, context 3, p = 0.5, q = 2): the walks and negatives of
  each step exactly equal, the loss curve at rtol 1e-4 and the table after K
  steps at rtol 1e-4, atol 1e-5 (dense Adam, as ``optax.adam``);
* the optax state of a JAX run stopped at step 2 carried across, 2 more
  steps in both (same limits);
* the table's init std against flax's ``nn.Embed`` (2%), and a checkpoint
  round trip of an ``N2VState``.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.models.node2vec import Node2Vec as JNode2Vec
from tch_geometric_tpu.models.node2vec import \
    make_node2vec_trainer as jtrainer
from tch_geometric_tpu.sampling import rng as jrng
from tch_geometric_tpu.sampling.walks import _random_walk_impl as jwalk
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import to_csr
from tch_geometric_tpu_torch.models import (N2VState, Node2Vec,
                                            make_node2vec_trainer)
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils import (restore_checkpoint,
                                           save_checkpoint)
from tch_geometric_tpu_torch.utils.params import (node2vec_params_from_flax,
                                                  train_state_from_flax)

DIM, CONTEXT, NEG = 16, 3, 2
WALK, P, Q = 6, 0.5, 2.0
K = 4


@pytest.fixture(scope="module")
def csr(fake_dataset):
    x, _, ei = fake_dataset
    n = x.shape[0]
    rp, ci, _ = to_csr(ei, n)
    return dict(n=n, g=make_graph(rp, ci, num_src=n, num_dst=n,
                                  device="cpu"),
                jg=jmake_graph(rp, ci, num_src=n, num_dst=n))


def _walks_negs(n, seed=0, B=5, L=7):
    r = np.random.default_rng(seed)
    walks = r.integers(0, n, (B, L))
    walks[1, 4:] = -1                     # dead ends
    walks[3, 2:] = -1
    neg = r.integers(0, n, (B, L - CONTEXT + 1, NEG))
    neg[0, 0, 0] = -1
    return walks, neg


def _pair(n, seed=0):
    jm = JNode2Vec(n, DIM, CONTEXT, NEG)
    walks, neg = _walks_negs(n)
    params = jm.init(jax.random.key(seed), jnp.asarray(walks),
                     jnp.asarray(neg), method=JNode2Vec.loss)
    m = Node2Vec(n, DIM, CONTEXT, NEG, device="cpu")
    m.load_state_dict(node2vec_params_from_flax(params))
    return jm, params, m


def test_loss_and_gradient_match_flax(csr):
    jm, params, m = _pair(csr["n"])
    walks, neg = _walks_negs(csr["n"], seed=1)

    def jloss(p):
        return jm.apply(p, jnp.asarray(walks), jnp.asarray(neg),
                        method=JNode2Vec.loss)

    loss = m.loss(torch.from_numpy(walks), torch.from_numpy(neg))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss(params)),
                               rtol=1e-5)
    want = node2vec_params_from_flax(jax.grad(jloss)(params))
    np.testing.assert_allclose(m.embedding.weight.grad.numpy(),
                               want["embedding.weight"].numpy(), rtol=1e-4,
                               atol=1e-7)
    nodes = torch.tensor([0, 5, 7])
    np.testing.assert_array_equal(
        m(nodes).detach().numpy(),
        np.asarray(jm.apply(params, jnp.asarray([0, 5, 7]))))


def _starts(n, step):
    return np.random.default_rng(10 + step).integers(0, n, 12)


def _run_jax(csr, steps, state=None, first=0):
    n = csr["n"]
    jm = JNode2Vec(n, DIM, CONTEXT, NEG)
    init, step = jtrainer(jm, csr["jg"], walk_length=WALK, p=P, q=Q,
                          learning_rate=0.05)
    if state is None:
        state = init(jax.random.key(0), jnp.asarray(_starts(n, 0)))
    losses = []
    for i in range(first, first + steps):
        state, loss = step(state, jax.random.key(7),
                           jnp.asarray(_starts(n, i)))
        losses.append(float(loss))
    return state, losses


def test_trainer_matches_jax(csr):
    n = csr["n"]
    jinit, _ = jtrainer(JNode2Vec(n, DIM, CONTEXT, NEG), csr["jg"],
                        walk_length=WALK, p=P, q=Q, learning_rate=0.05)
    js0 = jinit(jax.random.key(0), jnp.asarray(_starts(n, 0)))
    m = Node2Vec(n, DIM, CONTEXT, NEG, device="cpu")
    m.load_state_dict(node2vec_params_from_flax(js0.params))
    trainer = make_node2vec_trainer(m, csr["g"], walk_length=WALK, p=P, q=Q,
                                    learning_rate=0.05)
    # the walks and negatives of one step key: JAX's, exactly
    key = rng.fold(rng.key(7), 0)
    walks, neg = trainer.walks_and_negs(key, _starts(n, 0))
    jkey = jrng.fold(jax.random.key(7), 0)
    jw = jwalk(jrng.fold(jkey, 0), csr["jg"], jnp.asarray(_starts(n, 0)),
               WALK, jnp.float32(P), jnp.float32(Q), 16)
    np.testing.assert_array_equal(walks.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(jax.random.randint(
        jrng.fold(jkey, 1), neg.shape, 0, n)))

    js, jl = _run_jax(csr, K, js0)
    state, tl = trainer.init_fn(), []
    for i in range(K):
        state, loss = trainer.train_step(state, rng.key(7), _starts(n, i))
        tl.append(float(loss))
    assert state.step == K and state.opt_state.count == K
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(
        m.embedding.weight.detach().numpy(),
        node2vec_params_from_flax(js.params)["embedding.weight"].numpy(),
        rtol=1e-4, atol=1e-5)


def test_optax_state_carried_across(csr):
    n = csr["n"]
    js, _ = _run_jax(csr, 2)
    m = Node2Vec(n, DIM, CONTEXT, NEG, device="cpu")
    state = train_state_from_flax(m, js, node2vec_params_from_flax, N2VState)
    assert isinstance(state, N2VState) and state.step == 2
    js, jl = _run_jax(csr, 2, js, first=2)
    trainer = make_node2vec_trainer(m, csr["g"], walk_length=WALK, p=P, q=Q,
                                    learning_rate=0.05)
    tl = []
    for i in range(2, 4):
        state, loss = trainer.train_step(state, rng.key(7), _starts(n, i))
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(
        m.embedding.weight.detach().numpy(),
        node2vec_params_from_flax(js.params)["embedding.weight"].numpy(),
        rtol=1e-4, atol=1e-5)


def test_init_std_matches_flax_embed():
    import flax.linen as nn
    N, D = 4096, 64
    want = float(np.asarray(nn.Embed(N, D).init(
        jax.random.key(0), jnp.zeros((1,), jnp.int32))["params"]
        ["embedding"]).std())
    m = Node2Vec(N, D, CONTEXT, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    std = float(m.embedding.weight.detach().std())
    np.testing.assert_allclose(std, want, rtol=2e-2)
    np.testing.assert_allclose(std, D ** -0.5, rtol=2e-2)


def test_checkpoint_round_trip(csr, tmp_path):
    n = csr["n"]
    base = Node2Vec(n, DIM, CONTEXT, NEG, device="cpu",
                    generator=torch.Generator().manual_seed(1))

    def run(model, state, steps):
        trainer = make_node2vec_trainer(model, csr["g"], walk_length=WALK)
        state = state if state is not None else trainer.init_fn()
        losses = []
        for i in steps:
            state, loss = trainer.train_step(state, rng.key(3),
                                             _starts(n, i))
            losses.append(loss)
        return state, losses

    full = copy.deepcopy(base)
    _, want = run(full, None, range(4))
    half_model = copy.deepcopy(base)
    half, _ = run(half_model, None, range(2))
    save_checkpoint(str(tmp_path), half, step=2)
    resumed = copy.deepcopy(base)
    template = make_node2vec_trainer(resumed, csr["g"]).init_fn()
    restored = restore_checkpoint(str(tmp_path), template, step=2)
    assert isinstance(restored, N2VState) and restored.step == 2
    assert restored.opt_state.count == 2
    _, rest = run(resumed, restored, range(2, 4))
    assert all(torch.equal(a, b) for a, b in zip(rest, want[2:]))
    assert torch.equal(resumed.embedding.weight, full.embedding.weight)
