"""The torch port's dropout masks against flax's, on the CPU.

* ``keyed_dropout``'s mask of hidden layer i is the one flax's
  ``nn.Dropout`` named ``drop`` draws at its (i + 1)-th call in one
  ``apply``, bit for bit, for calls 1 and 2, on a whole batch and on row
  blocks (``rows=``);
* with dropout 0.5 the one-device SAGE and GAT trainers give three steps'
  losses within 1e-5 (relative) of JAX's ``make_gnn_trainer``;
* with dropout 0.5 the data- and tensor-parallel trainer on a (2, 2)
  thread mesh gives losses within 1e-5 of JAX's DP+TP step on a (2, 2)
  virtual mesh (``shard_params``);
* with dropout 0.5 ``make_partitioned_link_trainer`` at P = 1, 2 and 4
  gives three steps' losses within 1e-5 of JAX's at the same P (each rank
  masks its own tree under the shared key, as a ``shard_map`` body does),
  and at P = 2 its ``eval_step``'s loss and rank too (the harness is
  ``test_torch_dist_negative.py``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.data.io import load_karate_graph as jload_karate
from tch_geometric_tpu.data.storage import to_csc as jto_csc
from tch_geometric_tpu.models import gnn as jgnn
from tch_geometric_tpu.models.sage import GraphSAGE as JSAGE
from tch_geometric_tpu.parallel import shard_params as jshard_params
from tch_geometric_tpu.parallel.train import TrainState as JTrainState
from tch_geometric_tpu.parallel.train import (
    make_gnn_trainer as jmake_gnn_trainer)
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.models import gnn
from tch_geometric_tpu_torch.models.dropout import (flax_drop_tag,
                                                    keyed_dropout)
from tch_geometric_tpu_torch.models.sage import GraphSAGE
from tch_geometric_tpu_torch.parallel import make_gnn_trainer, make_mesh
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils.params import (gnn_params_from_flax,
                                                  sage_params_from_flax)
from test_torch_dist_negative import jax_link, port_link

F, HIDDEN, LR, STEPS, B, RATE = 8, 16, 1e-2, 3, 16, 0.5
FANOUTS = [3, 2]
KINDS = {"SAGE": (JSAGE, GraphSAGE, sage_params_from_flax),
         "GAT": (jgnn.GAT, gnn.GAT, gnn_params_from_flax)}


class _TwoCalls(nn.Module):
    """One ``nn.Dropout`` named ``drop`` called twice, as every model of
    the JAX package calls it once per hidden layer."""

    @nn.compact
    def __call__(self, a, b):
        drop = nn.Dropout(rate=RATE, name="drop")
        return (drop(a, deterministic=False), drop(b, deterministic=False))


def test_masks_equal_flax_calls_one_and_two():
    r = np.random.default_rng(0)
    a = r.uniform(0.5, 1.5, (37, 11)).astype(np.float32)
    b = r.uniform(0.5, 1.5, (23, 5)).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.key(3), 0x64726F70)
    ja, jb = _TwoCalls().apply({}, jnp.asarray(a), jnp.asarray(b),
                               rngs={"dropout": jkey})
    key = rng.fold_in(rng.key(3), 0x64726F70)
    for layer, (h, want) in enumerate(((a, ja), (b, jb))):
        got = keyed_dropout(torch.from_numpy(h), key, RATE, layer)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # a block of rows takes the whole draw's rows
        rows = [(3, 7), (15, 4)]
        blk = keyed_dropout(torch.from_numpy(np.concatenate(
            [h[s: s + n] for s, n in rows])), key, RATE, layer, rows=rows)
        np.testing.assert_array_equal(blk.numpy(), np.concatenate(
            [np.asarray(want)[s: s + n] for s, n in rows]))
    assert [flax_drop_tag(n) for n in (1, 2)] == [4184814907, 3346511832]


@pytest.fixture(scope="module")
def kg():
    _x, y, ei = jload_karate()
    cp, ri, _ = jto_csc(np.asarray(ei), 34)
    cp, ri = np.asarray(cp), np.asarray(ri)
    x = np.random.default_rng(0).normal(size=(34, F)).astype(np.float32)
    return dict(x=x, y=np.asarray(y), out=int(y.max()) + 1,
                g=make_graph(cp, ri, num_src=34, num_dst=34, device="cpu"),
                jg=jmake_graph(cp, ri, num_src=34, num_dst=34))


def _seeds():
    return np.random.default_rng(1).integers(0, 34, (STEPS, B))


def _jax_curve(kind, kg, seeds, mesh_shape=None):
    """JAX's dropout-on curve (one device, or DP+TP on a virtual mesh with
    ``shard_params``) and the flax parameters it started from."""
    jm = KINDS[kind][0](hidden=HIDDEN, out=kg["out"], num_layers=2,
                        dropout=RATE)
    x = jnp.asarray(kg["x"])
    init_fn, jstep, _ = jmake_gnn_trainer(jm, FANOUTS, learning_rate=LR)
    state = init_fn(jax.random.key(0), kg["jg"], x, jnp.asarray(seeds[0]))
    params, out = state.params, []
    if mesh_shape is None:
        for s in seeds:
            state, loss, _ = jstep(state, jax.random.key(4), kg["jg"], x,
                                   jnp.asarray(s), jnp.asarray(kg["y"][s]))
            out.append(np.asarray(loss))
        return np.stack(out), params
    D, M = mesh_shape
    mesh = JMesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                 ("data", "model"))
    data, repl = NamedSharding(mesh, JP("data")), NamedSharding(mesh, JP())
    with mesh:
        state = JTrainState(jshard_params(params, mesh),
                            jax.device_put(state.opt_state, repl),
                            jax.device_put(state.step, repl))
        g, xr = jax.device_put(kg["jg"], repl), jax.device_put(x, repl)
        for s in seeds:
            state, loss, _ = jstep(
                state, jax.random.key(4), g, xr,
                jax.device_put(jnp.asarray(s), data),
                jax.device_put(jnp.asarray(kg["y"][s]), data))
            out.append(np.asarray(loss))
    return np.stack(out), params


def _port_curve(kind, kg, params, seeds, mesh=None):
    m = KINDS[kind][1](F, HIDDEN, kg["out"], 2, dropout=RATE, device="cpu")
    m.load_state_dict(KINDS[kind][2](params))
    tr = make_gnn_trainer(m, FANOUTS, learning_rate=LR, mesh=mesh)
    st, out = tr.init_fn(), []
    x = torch.from_numpy(kg["x"])
    for s in seeds:
        st, loss, _ = tr.train_step(st, rng.key(4), kg["g"], x, s,
                                    kg["y"][s])
        out.append(loss.numpy())
    return np.stack(out)


@pytest.mark.parametrize("kind", list(KINDS))
def test_one_device_dropout_losses_match_jax(kg, kind):
    seeds = _seeds()
    want, params = _jax_curve(kind, kg, seeds)
    got = _port_curve(kind, kg, params, seeds)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_dp_tp_dropout_losses_match_jax(kg):
    seeds = _seeds()
    want, params = _jax_curve("SAGE", kg, seeds, (2, 2))
    got = _port_curve("SAGE", kg, params, seeds,
                      make_mesh((2, 2), device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("P", [1, 2, 4])
def test_partitioned_link_trainer_dropout_matches_jax(P):
    want, want_eval = jax_link("dropout", P, evaluate=P == 2)
    got, got_eval = port_link("dropout", P)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if want_eval is not None:
        np.testing.assert_allclose(got_eval, want_eval, rtol=1e-5,
                                   atol=1e-7)
    assert not np.allclose(got, port_link("plain", P)[0], rtol=1e-3)
