"""The plain reference against the program at a tiny size on the CPU.

The tests may import the program; the reference may not (see
``test_bench_imports.py``).
"""
import copy
import json

import pytest
import torch

from benchmark.conftest import scaled_graph
from benchmark.core import weights
from benchmark.core.spec import BENCH_DIR
from benchmark.graphs import products
from benchmark.models import sage
from benchmark.reference import common, threefry
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import coo_to_csc_device
from tch_geometric_tpu_torch.models.dropout import keyed_dropout
from tch_geometric_tpu_torch.parallel import make_gnn_trainer
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils.adam import adam_init, adam_update

SEED = 2**31 + 99


def _config(name, batch=8):
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["train"]["batch_size"] = batch
    return cfg


@pytest.fixture(scope="module")
def tiny():
    cfg = _config("sage-products")
    gg = products.generate(scaled_graph(cfg["graph"], 2e-4), SEED, "cpu")
    ptr, idx, perm = coo_to_csc_device(gg.src, gg.dst, gg.num_nodes,
                                       gg.num_nodes)
    graph = make_graph(ptr, idx, perm, num_src=gg.num_nodes,
                       num_dst=gg.num_nodes, device="cpu")
    return gg, graph


def test_threefry_equals_the_programs():
    k = threefry.key(SEED)
    assert k == tuple(rng.key(SEED).tolist())
    assert threefry.fold(k, 3, 7) == tuple(rng.fold(rng.key(SEED), 3,
                                                    7).tolist())
    u = threefry.uniform(threefry.fold(k, 5), (33, 7), "cpu")
    v = rng.uniform(rng.fold(rng.key(SEED), 5), (33, 7), device="cpu")
    assert torch.equal(u, v)


def test_keep_mask_equals_the_programs_dropout():
    h = torch.ones((40, 12))
    step = rng.fold(rng.key(SEED), 2)
    out = keyed_dropout(h, rng.fold(step, rng.DROPOUT_STREAM), 0.5, 1)
    m = threefry.keep_mask(threefry.fold(threefry.key(SEED), 2), 1,
                           (40, 12), 0.5, "cpu")
    assert torch.equal(out != 0, m)


def test_tree_logits_equal_the_programs(tiny):
    gg, graph = tiny
    cfg = _config("sage-products")
    model = sage.build(cfg, "cpu")
    params = weights.draw_weights(model, SEED, "cpu")
    fan = cfg["train"]["fanouts"]
    trainer = make_gnn_trainer(model, fan)
    seeds = gg.train_idx[:8]
    step_key = rng.fold(rng.key(SEED), 1)
    sample, x = trainer.sample_and_gather(step_key, graph, gg.x, seeds)
    with torch.no_grad():
        got = model.tree_forward(
            sample, x, deterministic=False,
            dropout_key=rng.fold(step_key, rng.DROPOUT_STREAM))
    rate = cfg["model"]["dropout"]
    tkey = threefry.fold(threefry.key(SEED), 1)
    want = sage.tree_reference(
        params, gg.x[sample.nodes.clamp(0, gg.num_nodes - 1)].double(),
        sample.node_valid, common.tree_layout(8, fan), fan,
        lambda j, shape: threefry.keep_mask(tkey, j, shape, rate, "cpu"),
        rate)
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) < 1e-5 * max(
        1.0, float(want.abs().max()))


def test_full_logits_equal_the_programs(tiny):
    gg, graph = tiny
    cfg = _config("sage-products")
    model = sage.build(cfg, "cpu")
    params = weights.draw_weights(model, SEED, "cpu")
    with torch.no_grad():
        got = model(gg.x, graph)
    want = sage.full_reference(params, gg, lower=False)
    assert float((got.double() - want).abs().max()) < 1e-5 * max(
        1.0, float(want.abs().max()))


def test_mean_aggregate_in_blocks(tiny, monkeypatch):
    gg, _ = tiny
    deg = torch.bincount(gg.dst, minlength=gg.num_nodes)
    whole = common.mean_aggregate(gg.x.double(), gg.src, gg.dst, deg)
    monkeypatch.setattr(common, "BLOCK_BYTES", 1000 * 8 * 100)
    assert torch.allclose(
        common.mean_aggregate(gg.x.double(), gg.src, gg.dst, deg), whole,
        rtol=1e-12, atol=1e-12)


def test_adam_equals_the_programs():
    g = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(4, generator=g)}
    mine = {k: v.double().clone() for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in mine.items()}
    nu = {k: torch.zeros_like(v) for k, v in mine.items()}
    state = adam_init(p)
    for t in range(1, 4):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
        state = adam_update(p, grads, state, 1e-2)
        common.adam_step(mine, {k: v.double() for k, v in grads.items()},
                         mu, nu, t, 1e-2)
    for k in p:
        assert torch.allclose(p[k].double(), mine[k], rtol=1e-5, atol=1e-6)


def test_tree_faults(tiny):
    gg, graph = tiny
    cfg = _config("sage-products")
    model = sage.build(cfg, "cpu")
    fan = cfg["train"]["fanouts"]
    seeds = gg.train_idx[:8]
    sample, _ = make_gnn_trainer(model, fan).sample_and_gather(
        rng.key(3), graph, gg.x, seeds)
    edges = common.EdgeSet(gg.src, gg.dst, gg.num_nodes)
    nodes, valid = sample.nodes.clone(), sample.node_valid
    assert common.tree_faults(nodes, valid, seeds, fan, edges) == 0
    # a valid child that is not a neighbour of its parent
    slot = int(torch.nonzero(valid[8:]).flatten()[0]) + 8
    bases = common.tree_layout(8, fan)
    parent = nodes[(slot - bases[1]) // fan[0]]
    ids = torch.arange(gg.num_nodes)
    stranger = ids[~edges.has(parent.expand_as(ids), ids)][0]
    nodes[slot] = stranger
    assert common.tree_faults(nodes, valid, seeds, fan, edges) >= 1
    # a repeated child
    nodes = sample.nodes.clone()
    kids = nodes[bases[1]: bases[1] + fan[0]]
    if bool(valid[bases[1] + 1]):
        nodes[bases[1] + 1] = kids[0]
        assert common.tree_faults(nodes, valid, seeds, fan, edges) >= 1
    # a wrong seed
    nodes = sample.nodes.clone()
    nodes[0] = (nodes[0] + 1) % gg.num_nodes
    assert common.tree_faults(nodes, valid, seeds, fan, edges) >= 1
    # a tree of another batch size
    assert common.tree_faults(sample.nodes, valid, seeds[:4], fan,
                              edges) > 0
