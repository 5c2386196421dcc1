"""The port's PyG-style GAT (``GAT(..., pyg=True)``, PyG's
``examples/ogbn_products_gat.py`` model) against the plain float64 reference ``tests/gat_pyg_reference.py``, and B3's
plain version at the published head widths.

A 300-node graph, 3 layers of 4 heads of 8 columns, the last layer 4 heads
of 5 averaged, every parameter drawn at random (biases too), on the three
paths: the full graph by segment ops (``GAT.forward``), the blocked layout
through B3's plain version (``GAT.blocked_forward``, W = 128: the last of
three row blocks is ragged, 44 rows) and a padded sampled tree
(``tree_forward``, the reference run on the tree's bipartite layers: slots
as nodes, targets first).  Two graphs: rows 250-259 have no in-edges (their
softmax is the self loop alone), and the second graph also holds self loops
of its own, which PyG removes before it adds one per node (B3's self-loop
mode gives the layout's own lanes no weight; on a tree a child that is its
parent's node is dropped).

Tolerances.  float32 against float64: the three layers' float32 products and
sums over at most ~20 terms a row lose a few ulps of values below ~10, so
2e-5 (relative and absolute) holds them with room, while each broken
control (self loops off, the last layer's heads summed, the skip linears
dropped) moves some logit by far more than 1e-2.  bfloat16 blocked passes
read the rows (and so the source logits) in bfloat16, 2**-9 relative a row
and layer; over three layers the logits, up to ~12 here, move by up to 0.5%
of their value (3.8e-2 at worst, RMS 5e-3): 1e-2 relative plus 2e-2
absolute.
"""
import importlib

import numpy as np
import pytest
import torch

from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.models import GAT
from tch_geometric_tpu_torch.ops import (build_blocked,
                                         gat_attend_blocked_packed)
from tch_geometric_tpu_torch.parallel import make_gnn_trainer
from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils import kernel_gates

import gat_pyg_reference as ref

N, F_IN, HEADS, D_HID, OUT = 300, 12, 4, 8, 5
F32_TOL = 2e-5
BF16_RTOL, BF16_ATOL = 1e-2, 2e-2
CONTROL_GAP = 1e-2
FANOUTS = [4, 3, 3]
EMPTY = np.arange(250, 260)          # rows with no in-edges


def _graph(with_loops: bool):
    r = np.random.default_rng(7)
    src = r.integers(0, N, 1500)
    dst = r.integers(0, N, 1500)
    keep = ~np.isin(dst, EMPTY) & (src != dst)
    src, dst = src[keep], dst[keep]
    if with_loops:
        loops = r.choice(np.setdiff1d(np.arange(N), EMPTY), 40,
                         replace=False)
        src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    return src, dst


GRAPHS = {"empty_rows": _graph(False), "own_self_loops": _graph(True)}


def _model():
    m = GAT(F_IN, HEADS * D_HID, OUT, 3, heads=HEADS, pyg=True,
            generator=torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * 0.5)
    return m


@pytest.fixture(scope="module")
def setup():
    m = _model()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(N, F_IN)).astype(np.float32))
    params = {k: v.detach().double() for k, v in m.named_parameters()}
    out = {}
    for name, (src, dst) in GRAPHS.items():
        cp, ri, perm = to_csc(np.stack([src, dst]), N)
        out[name] = dict(
            src=torch.from_numpy(src), dst=torch.from_numpy(dst),
            graph=make_graph(cp, ri, perm, num_src=N, num_dst=N,
                             device="cpu"),
            blocked=build_blocked(cp, ri, rows_per_block=128,
                                  device="cpu"))
    return m, x, params, out


def _tree_layers(sample):
    """The padded tree's bipartite layers: layer j's targets are the slots
    of depths < hops - j; an edge joins each valid child slot to its
    parent's slot."""
    hops = len(FANOUTS)
    edges = []
    for d in range(hops):
        k = FANOUTS[d]
        lo, hi = sample.node_base[d], sample.node_base[d + 1]
        parent = torch.arange(lo, hi).repeat_interleave(k)
        child = torch.arange(sample.node_base[d + 1],
                             sample.node_base[d + 2])
        ok = sample.node_valid[child]
        # PyG relabels a child that is its parent's node onto the parent
        same = sample.nodes[child] == sample.nodes[parent]
        child = torch.where(same, parent, child)
        edges.append((child[ok], parent[ok]))
    layers = []
    for j in range(hops):
        keep = hops - j
        src = torch.cat([e[0] for e in edges[:keep]])
        dst = torch.cat([e[1] for e in edges[:keep]])
        layers.append((sample.node_base[keep], src, dst))
    return layers


def _run(path, setup_, graph_name, broken=None, dtype=torch.float32):
    """(the port's logits, the reference's) on ``path``."""
    m, x, params, graphs = setup_
    gr = graphs[graph_name]
    with torch.no_grad():
        if path == "segment":
            got = m(x, gr["graph"])
            want = ref.full_graph(params, x.double(), gr["src"], gr["dst"],
                                  HEADS, broken=broken)
        elif path == "blocked":
            got = m.blocked_forward(x, gr["blocked"], compute_dtype=dtype)
            want = ref.full_graph(params, x.double(), gr["src"], gr["dst"],
                                  HEADS, broken=broken)
        else:
            tr = make_gnn_trainer(m, FANOUTS)
            sample, xs = tr.sample_and_gather(rng.key(5), gr["graph"], x,
                                              np.arange(0, 64))
            got = m.tree_forward(sample, xs)
            want = ref.gat_forward(params, xs.double(), _tree_layers(sample),
                                   HEADS, broken=broken)[: got.shape[0]]
    return got.double(), want


PATHS = ["segment", "blocked", "tree"]


@pytest.mark.parametrize("graph_name", list(GRAPHS))
@pytest.mark.parametrize("path", PATHS)
def test_matches_the_pyg_reference(setup, path, graph_name):
    got, want = _run(path, setup, graph_name)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("graph_name", list(GRAPHS))
def test_blocked_bf16_matches_the_pyg_reference(setup, graph_name):
    got, want = _run("blocked", setup, graph_name, dtype=torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("broken", ["no_self_loops", "sum_heads", "no_skip"])
@pytest.mark.parametrize("path", PATHS)
def test_broken_controls_fail(setup, path, broken):
    got, want = _run(path, setup, "empty_rows", broken=broken)
    assert float((got - want).abs().max()) > CONTROL_GAP


def test_rows_without_edges_read_their_own_row(setup):
    """A row with no in-edges attends only its self loop: B3's plain version
    gives its own projected row, in every head."""
    m, x, _, graphs = setup
    conv = m.convs[0]
    with torch.no_grad():
        h = conv.project(x)
        out = conv.attend_blocked(h, graphs["empty_rows"]["blocked"],
                                  torch.float32)
    torch.testing.assert_close(out[EMPTY], h[EMPTY], rtol=1e-6, atol=1e-6)


def test_layout_self_loops_weigh_nothing(setup):
    """A layout built from a graph that holds self loops of its own, as it
    is: B3's self-loop mode gives the same rows as on the layout of the
    graph without them (its own loop lanes weigh nothing), and
    ``blocked_forward`` on it matches the segment path, which removes them
    as PyG does."""
    m, x, _, graphs = setup
    src, dst = GRAPHS["own_self_loops"]
    assert int((src == dst).sum()) > 0
    keep = src != dst
    cp, ri, _ = to_csc(np.stack([src[keep], dst[keep]]), N)
    clean = build_blocked(cp, ri, rows_per_block=128, device="cpu")
    raw = graphs["own_self_loops"]["blocked"]
    conv = m.convs[0]
    with torch.no_grad():
        h = conv.project(x)
        got = conv.attend_blocked(h, raw, torch.float32)
        want = conv.attend_blocked(h, clean, torch.float32)
        fast = m.blocked_forward(x, raw, compute_dtype=torch.float32)
        full = m(x, graphs["own_self_loops"]["graph"])
    # both sums take the same terms, in another order: float32 ulps
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(fast, full, rtol=F32_TOL, atol=F32_TOL)


def test_default_gat_has_no_new_parameters():
    """The flax model's GAT keeps its parameters, and their draws."""
    a = GAT(F_IN, 16, 3, 2, generator=torch.Generator().manual_seed(0),
            device="cpu")
    assert sorted(dict(a.named_parameters())) == [
        "convs.0.a_dst", "convs.0.a_src", "convs.0.lin.weight",
        "convs.1.a_dst", "convs.1.a_src", "convs.1.lin.weight"]
    b = GAT(F_IN, 16, 3, 2, generator=torch.Generator().manual_seed(0),
            device="cpu", pyg=True)
    pb = dict(b.named_parameters())
    for k, v in a.named_parameters():
        if k.startswith("convs.0."):           # the same first layer
            assert torch.equal(v, pb[k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["table", "vec"])
def test_b3_plain_at_four_heads_of_128_matches_jax(mode, dtype):
    """B3's plain version with the self-loop mode off against the JAX
    kernel in interpret mode at H=4, D=128 (layers 1-2 of the ogbn-products
    GAT; 2e-4 in float32, 1e-2 in bfloat16: the tolerances of
    ``tests/test_torch_gat_blocked.py``, whose reasons hold here)."""
    import jax.numpy as jnp
    jab = importlib.import_module("tch_geometric_tpu.ops.attention_blocked")
    jsb = importlib.import_module("tch_geometric_tpu.ops.spmm_blocked")
    ip, src, _, _, _, _ = kernel_gates.build_gat_testbed(n=512, e=4096)
    h, a_s, a_d, vec = kernel_gates._gat_inputs(
        np.random.default_rng(128), len(ip) - 1, 4, 128)
    bt = build_blocked(ip, src, rows_per_block=128, device="cpu")
    bj = jsb.build_blocked(ip, src.astype(np.int32), rows_per_block=128)
    table = mode == "table"
    tdt, jdt, tol = {"float32": (torch.float32, jnp.float32, 2e-4),
                     "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-2)}[dtype]
    out = gat_attend_blocked_packed(
        bt, torch.from_numpy(h), torch.from_numpy(a_s) if table else None,
        torch.from_numpy(a_d),
        alpha_src_vec=None if table else torch.from_numpy(vec),
        compute_dtype=tdt).numpy()
    want = np.asarray(jab.gat_attend_blocked_packed(
        bj, jnp.asarray(h), jnp.asarray(a_s) if table else None,
        jnp.asarray(a_d), alpha_src_vec=None if table else jnp.asarray(vec),
        compute_dtype=jdt, interpret=True))
    np.testing.assert_allclose(out, want, rtol=tol, atol=tol)
