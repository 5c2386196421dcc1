"""Data- and tensor-parallel training in the torch port against the JAX
package, on the CPU (karate's topology with seeded dense features).

* Block draws: a data rank's tree, drawn from its seed block at the
  block's offset in each hop's draw (``seed_block``), equals the matching
  slots of the whole batch's tree exactly, and its dropout mask (rows by
  ``tree_rows``) the matching rows of the whole batch's mask, for B = 16
  over 2 and 4 data ranks, on every engine of the sampler: uniform on ELL
  rows and by Floyd's algorithm, with replacement, weighted on ELL rows
  and chunked windows (weighted and temporally filtered);
* ``make_gnn_trainer(mesh=)`` on (2, 2) and (4, 2) ``('data', 'model')``
  thread meshes against JAX's ``make_sage_trainer`` on a (2, 2) virtual
  mesh with ``shard_params`` (``dryrun_multichip``'s setup; one compile,
  which both shapes read) and against the port's one-device trainer:
  three steps' losses within 1e-5 relative, dropout 0.  With dropout 0.5 the port's
  DP+TP losses are held against its one-device trainer (1e-5), and in
  ``test_torch_flax_dropout.py`` against JAX's;
* GCN, GIN and GAT at (2, 2), two steps each, against JAX's DP+TP step;
* ``make_multibatch_sage_trainer(mesh=)`` at (2, 2) against JAX's on the
  same mesh (dropout 0) and against the port's one-device trainer
  (dropout 0.5);
* the tensor-parallel plan: which parameters split, each rank's slices,
  the column-parallel forward's collectives, ``sample_and_gather``'s
  per-data-rank trees and ``eval_step`` on the mesh.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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
from tch_geometric_tpu.parallel.train import (
    make_multibatch_sage_trainer as jmake_multibatch)
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.models import gnn
from tch_geometric_tpu_torch.models.dropout import keyed_dropout, tree_rows
from tch_geometric_tpu_torch.models.sage import GraphSAGE
from tch_geometric_tpu_torch.parallel import (make_gnn_trainer, make_mesh,
                                              make_multibatch_sage_trainer)
from tch_geometric_tpu_torch.parallel import train as ttrain
from tch_geometric_tpu_torch.parallel.mesh import Split, spmd
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.sampling.neighbor import (_layer_layout,
                                                       _log_weights,
                                                       _sample_neighbors_impl)
from tch_geometric_tpu_torch.utils.config import (TEMPORAL_SAMPLE_DYNAMIC,
                                                  TemporalEdgeFilter)
from tch_geometric_tpu_torch.utils.params import (gnn_params_from_flax,
                                                  sage_params_from_flax)

F, HIDDEN, LR, STEPS, B = 8, 16, 1e-2, 3, 16
FANOUTS = [3, 2]
KINDS = {"SAGE": (JSAGE, GraphSAGE, sage_params_from_flax),
         "GCN": (jgnn.GCN, gnn.GCN, gnn_params_from_flax),
         "GIN": (jgnn.GIN, gnn.GIN, gnn_params_from_flax),
         "GAT": (jgnn.GAT, gnn.GAT, gnn_params_from_flax)}


@pytest.fixture(scope="module")
def kg():
    _x, y, ei = jload_karate()
    cp, ri, _ = jto_csc(np.asarray(ei), 34)
    cp, ri = np.asarray(cp), np.asarray(ri)
    x = np.random.default_rng(0).normal(size=(34, F)).astype(np.float32)
    r = np.random.default_rng(3)
    return dict(cp=cp, ri=ri, x=x, y=np.asarray(y), out=int(y.max()) + 1,
                w=r.uniform(0.1, 2.0, len(ri)).astype(np.float32),
                ts=r.integers(0, 100, len(ri)).astype(np.int32),
                g=make_graph(cp, ri, num_src=34, num_dst=34, device="cpu"),
                jg=jmake_graph(cp, ri, num_src=34, num_dst=34))


def _seeds(steps=STEPS, seed=0):
    return np.random.default_rng(seed).integers(0, 34, (steps, B))


# ---------------------------------------------------------------------------
# Block draws
# ---------------------------------------------------------------------------

PATHS = {
    "uniform_ell": dict(ell=True),
    "uniform_floyd": dict(ell=False),
    "replacement": dict(ell=True, with_replacement=True),
    "weighted_ell": dict(ell=True, weighted=True),
    "weighted_ell_replacement": dict(ell=True, weighted=True,
                                     with_replacement=True),
    "chunked_filtered": dict(ell=False, weighted=True, filtered=True),
    "chunked_replacement": dict(ell=False, weighted=True, filtered=True,
                                with_replacement=True),
}


def _tree(kg, path, seeds, seed_block=None):
    cfg = PATHS[path]
    g = make_graph(kg["cp"], kg["ri"], num_src=34, num_dst=34,
                   ell_table=cfg["ell"], window_table=False, device="cpu")
    kw = {}
    if cfg.get("weighted"):
        kw["log_weights"] = _log_weights(kg["w"], "cpu")
    if cfg.get("filtered"):
        kw.update(filter_cfg=TemporalEdgeFilter(
            window=(-60, 60), forward=True, mode=TEMPORAL_SAMPLE_DYNAMIC),
            timestamps=torch.from_numpy(kg["ts"]))
    seeds = torch.from_numpy(seeds)
    state = (seeds * 13 % 50).int()
    return _sample_neighbors_impl(
        rng.key(9), g, seeds, state, tuple(FANOUTS),
        cfg.get("with_replacement", False), window=4, seed_block=seed_block,
        **kw)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("D", [2, 4])
def test_block_draws_equal_the_whole_batch(kg, path, D):
    seeds = _seeds(1, seed=5)[0]
    whole = _tree(kg, path, seeds)
    nb, eb = whole.node_base, whole.edge_base
    Bd = B // D
    h = torch.from_numpy(np.random.default_rng(6).normal(
        size=(nb[-1], 5)).astype(np.float32))
    depths = len(FANOUTS)
    h_whole = keyed_dropout(h[: nb[depths]], rng.key(2), 0.5, 1)
    for d in range(D):
        blk = _tree(kg, path, seeds[d * Bd:(d + 1) * Bd], (d * Bd, B))
        lb, leb = blk.node_base, blk.edge_base
        per = 1
        for ell in range(depths + 1):
            lo = nb[ell] + d * Bd * per
            n = lb[ell + 1] - lb[ell]
            for f in ("nodes", "node_valid", "node_state"):
                np.testing.assert_array_equal(
                    getattr(blk, f)[lb[ell]: lb[ell + 1]].numpy(),
                    getattr(whole, f)[lo: lo + n].numpy(), err_msg=f)
            if ell < depths:
                elo = eb[ell] + d * Bd * per * FANOUTS[ell]
                en = leb[ell + 1] - leb[ell]
                for f in ("eptr", "edge_valid"):
                    np.testing.assert_array_equal(
                        getattr(blk, f)[leb[ell]: leb[ell + 1]].numpy(),
                        getattr(whole, f)[elo: elo + en].numpy(), err_msg=f)
                per *= FANOUTS[ell]
        rows = tree_rows(blk, depths)
        idx = torch.cat([torch.arange(s, s + n) for s, n in rows])
        got = keyed_dropout(h[idx], rng.key(2), 0.5, 1, rows=rows)
        np.testing.assert_array_equal(got.numpy(), h_whole[idx].numpy())
    assert tree_rows(whole, depths) is None


# ---------------------------------------------------------------------------
# DP+TP against JAX
# ---------------------------------------------------------------------------

def _jmesh(shape):
    D, M = shape
    return JMesh(np.array(jax.devices()[:D * M]).reshape(D, M),
                 ("data", "model"))


def _jax_dp_tp(kind, kg, shape, seeds, multi=False):
    """JAX's DP+TP curve (``dryrun_multichip``'s setup) and the flax
    parameters it started from."""
    J = KINDS[kind][0]
    jm = J(hidden=HIDDEN, out=kg["out"], num_layers=2)
    x = jnp.asarray(kg["x"])
    if multi:
        init_fn, jstep = jmake_multibatch(jm, FANOUTS, learning_rate=LR)
        state = init_fn(jax.random.key(0), kg["jg"], x,
                        jnp.asarray(seeds[0, 0]))
    else:
        init_fn, jstep, _ = jmake_gnn_trainer(jm, FANOUTS, learning_rate=LR)
        state = init_fn(jax.random.key(0), kg["jg"], x, jnp.asarray(seeds[0]))
    params = state.params
    mesh = _jmesh(shape)
    data = NamedSharding(mesh, JP(None, "data") if multi else JP("data"))
    repl = NamedSharding(mesh, JP())
    out = []
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


def _port_model(kind, kg, params=None, dropout=0.0):
    P, conv = KINDS[kind][1], KINDS[kind][2]
    m = P(F, HIDDEN, kg["out"], 2, dropout=dropout, device="cpu",
          generator=torch.Generator().manual_seed(0))
    if params is not None:
        m.load_state_dict(conv(params))
    return m


def _port_curve(model, kg, seeds, mesh, multi=False):
    make = make_multibatch_sage_trainer if multi else make_gnn_trainer
    tr = make(model, FANOUTS, learning_rate=LR, mesh=mesh)
    st, out = tr.init_fn(), []
    x = torch.from_numpy(kg["x"])
    for s in seeds:
        st, loss, _ = tr.train_step(st, rng.key(4), kg["g"], x, s,
                                    kg["y"][s])
        out.append(loss.numpy())
    return np.stack(out)


@pytest.fixture(scope="module")
def jax_sage_curve(kg):
    """JAX's DP+TP SAGE curve at (2, 2) and its parameters, compiled once
    for the module: the DP+TP step equals the one-device step, so the
    (4, 2) case reads the same curve."""
    return _jax_dp_tp("SAGE", kg, (2, 2), _seeds())


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
def test_dp_tp_sage_matches_jax_and_one_device(kg, jax_sage_curve, shape):
    seeds = _seeds()
    want, params = jax_sage_curve
    model = _port_model("SAGE", kg, params)
    one_model = copy.deepcopy(model)
    one = _port_curve(one_model, kg, seeds, None)
    got = _port_curve(model, kg, seeds, make_mesh(shape, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, one, rtol=1e-5)
    for k, v in one_model.state_dict().items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
@pytest.mark.parametrize("kind", ["SAGE", "GAT"])
def test_dp_tp_dropout_equals_one_device(kg, shape, kind):
    seeds = _seeds(seed=1)
    model = _port_model(kind, kg, dropout=0.5)
    one = _port_curve(copy.deepcopy(model), kg, seeds, None)
    got = _port_curve(model, kg, seeds, make_mesh(shape, device="cpu"))
    np.testing.assert_allclose(got, one, rtol=1e-5)
    assert not np.allclose(one, _port_curve(
        _port_model(kind, kg, dropout=0.0), kg, seeds, None), rtol=1e-3)


@pytest.mark.parametrize("kind", ["GCN", "GIN", "GAT"])
def test_dp_tp_gnn_kinds_match_jax(kg, kind):
    seeds = _seeds(2, seed=2)
    want, params = _jax_dp_tp(kind, kg, (2, 2), seeds)
    got = _port_curve(_port_model(kind, kg, params), kg, seeds,
                      make_mesh((2, 2), device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_dp_tp_multibatch_matches_jax_and_one_device(kg):
    seeds = _seeds(4, seed=3).reshape(2, 2, B)
    want, params = _jax_dp_tp("SAGE", kg, (2, 2), seeds, multi=True)
    got = _port_curve(_port_model("SAGE", kg, params), kg, seeds,
                      make_mesh((2, 2), device="cpu"), multi=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    model = _port_model("SAGE", kg, dropout=0.5)
    one = _port_curve(copy.deepcopy(model), kg, seeds, None, multi=True)
    got = _port_curve(model, kg, seeds, make_mesh((2, 2), device="cpu"),
                      multi=True)
    np.testing.assert_allclose(got, one, rtol=1e-5)


# ---------------------------------------------------------------------------
# The tensor-parallel plan
# ---------------------------------------------------------------------------

def test_tensor_parallel_plan_and_rank_slices(kg, monkeypatch):
    mesh = make_mesh((2, 2), device="cpu")
    model = GraphSAGE(F, HIDDEN, 5, 2, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    dims = ttrain._split_dims(model, mesh, params)
    # every kernel's output columns divide the model axis but the 5-class
    # head's; biases replicate
    assert dims == {"convs.0.lin_self.weight": 0,
                    "convs.0.lin_neigh.weight": 0}
    gat = gnn.GAT(F, HIDDEN, 4, 2, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    gdims = ttrain._split_dims(gat, mesh, dict(gat.named_parameters()))
    assert gdims["convs.0.a_src"] == 1 and gdims["convs.0.lin.weight"] == 0
    assert gdims["convs.1.a_dst"] == 1           # (1, 4) over 2: d splits
    calls = {"gather": 0, "copy": 0}
    for name, fn in (("gather", ttrain._GatherColumns),
                     ("copy", ttrain._CopyToModel)):
        orig = fn.forward

        def counted(ctx, *a, _o=orig, _n=name):
            calls[_n] += 1
            return _o(ctx, *a)

        monkeypatch.setattr(fn, "forward", staticmethod(counted))

    def body(seeds_local):
        rank = ttrain._RankParams(params, dims)
        shapes = {k: tuple(v.shape) for k, v in rank.local.items()}
        sample, x = ttrain._sample_and_gather(
            rng.key(1), kg["g"], torch.from_numpy(kg["x"]), seeds_local,
            FANOUTS, False, ttrain._seed_block(seeds_local))
        with rank:
            logits = model.tree_forward(sample, x)
        return logits, shapes

    logits, shapes = spmd(mesh, body, Split(torch.arange(B), ("data",)))
    assert shapes["convs.0.lin_self.weight"] == (HIDDEN // 2, F)
    assert shapes["convs.1.lin_self.weight"] == (5, HIDDEN)
    # 4 ranks x 2 split linears, each once in the forward
    assert calls == {"gather": 8, "copy": 8}
    tr = make_gnn_trainer(model, FANOUTS)
    whole = model.tree_forward(*tr.sample_and_gather(
        rng.key(1), kg["g"], torch.from_numpy(kg["x"]), torch.arange(B)))
    torch.testing.assert_close(logits.reshape(2, 2, B // 2, 5)[:, 0]
                               .reshape(B, 5), whole, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(logits[0], logits[1])   # model replicas
    dp = make_gnn_trainer(model, FANOUTS, mesh=mesh)
    s_blocks, x_blocks = dp.sample_and_gather(
        rng.key(1), kg["g"], torch.from_numpy(kg["x"]), torch.arange(B))
    s_whole, _ = tr.sample_and_gather(rng.key(1), kg["g"],
                                      torch.from_numpy(kg["x"]),
                                      torch.arange(B))
    nb, _ = _layer_layout(B, FANOUTS)
    lb = s_blocks.node_base
    assert s_blocks.nodes.shape[0] == 2 and x_blocks.shape[0] == 2
    for ell in range(len(FANOUTS) + 1):
        got = torch.cat([s_blocks.nodes[d, lb[ell]: lb[ell + 1]]
                         for d in range(2)])
        torch.testing.assert_close(got, s_whole.nodes[nb[ell]: nb[ell + 1]])
    for args in ((None,), (dict(model.state_dict()),)):
        e_mesh = dp.eval_step(*args, rng.key(2), kg["g"],
                              torch.from_numpy(kg["x"]), torch.arange(B),
                              kg["y"][:B])
        e_one = tr.eval_step(*args, rng.key(2), kg["g"],
                             torch.from_numpy(kg["x"]), torch.arange(B),
                             kg["y"][:B])
        for a, b in zip(e_mesh, e_one):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="'data', 'model'"):
        make_gnn_trainer(model, FANOUTS,
                         mesh=make_mesh((2, 1), ("slice", "chip"),
                                        device="cpu"))
