"""The composed and flash multi-head GAT routes of the torch port against the
JAX package.

Each plain port function — ``edge_softmax_blocked_multihead`` (B7),
``spmm_blocked_multiweighted`` (B8), ``gat_attend_blocked`` (logits, B7,
B8) and ``gat_attend_blocked_flash`` (B9) — against its JAX counterpart,
the Pallas kernels run with ``interpret=True`` as
``tests/test_attention_blocked.py`` runs them, on the same numpy inputs: the
GAT gates' testbed (cut to 512 nodes and 4096 edges, W=128), the three
layout edge cases of ``kernel_gates.edge_case_graphs()`` (W=128 and 256) and
the hub row of ``kernel_gates.hub_row_graph()`` (1,000 lanes over several
chunks, W = C = 128) at H=4, D=32, and the testbed at one head of 47
columns (GAT's last layer); B7 also on the GAT logits of the (N, H)
tables (its logits-in entry's plain composition), once with another
negative slope and a short ``alpha_dst``.  The head-packed GAT's plain
version (B3,
``gat_attend_blocked_packed``) likewise on the same cases, and B3 and B9 on
``kernel_gates.far_logits_case()``, where B3's chunk-max shift underflows.

Tolerances: float32 at 2e-4, the JAX package's own.  In bfloat16 both sides
round at the same points (rows, ``bf16(x * w)`` in B8, ``alpha_src`` and
``bf16(e)`` in B9, float32 sums), but a weight that differs in its last
float32 bit (torch's ``exp`` against XLA's, another summation order) can
round its bfloat16 term the other way: one bfloat16 ulp of the term, at
most 2**-5 for the |h| < 5 of these inputs divided by the row's weight sum.
So the limit is 1e-2; these seeds read well under it.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.ops import attention_blocked as jab
from tch_geometric_tpu_torch.ops import attention_blocked as tab
from tch_geometric_tpu_torch.utils import kernel_gates

jsb = importlib.import_module("tch_geometric_tpu.ops.spmm_blocked")
tsb = importlib.import_module("tch_geometric_tpu_torch.ops.spmm_blocked")

F32_TOL = 2e-4
BF16_TOL = 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _cases():
    ip, src, h, a_s, a_d, _ = kernel_gates.build_gat_testbed(n=512, e=4096)
    cases = {"testbed": (ip, src, 128, None, (h, a_s, a_d))}
    for name, eip, esrc, _, W, C in kernel_gates.edge_case_graphs():
        r = np.random.default_rng(len(eip))
        h_, a_s_, a_d_, _ = kernel_gates._gat_inputs(r, len(eip) - 1, 4, 32)
        cases[name] = (eip, esrc, W, C, (h_, a_s_, a_d_))
    r = np.random.default_rng(47)
    h_, a_s_, a_d_, _ = kernel_gates._gat_inputs(r, len(ip) - 1, 1, 47)
    cases["testbed_h1_d47"] = (ip, src, 256, None, (h_, a_s_, a_d_))
    _, hip, hsrc, _, W, C = kernel_gates.hub_row_graph()
    r = np.random.default_rng(70)
    h_, a_s_, a_d_, _ = kernel_gates._gat_inputs(r, len(hip) - 1, 4, 32)
    cases["hub_row"] = (hip, hsrc, W, C, (h_, a_s_, a_d_))
    return cases


CASES = _cases()


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    indptr, src, W, C, arrays = CASES[request.param]
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    return dict(name=request.param, indptr=indptr, b_t=b_t, b_j=b_j,
                arrays=arrays)


def test_edge_softmax_multihead_matches_pallas(case):
    b_t, b_j = case["b_t"], case["b_j"]
    H = case["arrays"][0].shape[1]
    rng = np.random.default_rng(11)
    scores = (rng.normal(size=(H,) + tuple(b_t.edge_src.shape)) * 3).astype(
        np.float32)
    pads = ~b_t.edge_valid.numpy()
    scores[:, pads] = np.nan                # ignored by both
    ref = np.asarray(jab.edge_softmax_blocked_multihead(
        b_j, jnp.asarray(scores), interpret=True))
    out = tab.edge_softmax_blocked_multihead(b_t, torch.from_numpy(scores))
    out = out.numpy()
    assert out.shape == ref.shape == scores.shape
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)
    assert (out[:, pads] == 0).all()
    # per head, the weights of every row with edges sum to 1
    rows = tab.blocked_dst_rows(b_t).numpy()[~pads]
    has = np.bincount(rows) > 0
    for hd in range(H):
        sums = np.bincount(rows, weights=out[hd][~pads])
        np.testing.assert_allclose(sums[has], 1.0, rtol=1e-5)


def _logits_softmax_both(b_t, b_j, a_s, a_d, slope):
    """(port, JAX) of B7's logits-in entry as its plain version composes it:
    ``gat_edge_logits_blocked`` on the (N, H) tables, then the multi-head
    edge softmax (the JAX kernel in interpret mode)."""
    logits = tab.gat_edge_logits_blocked(b_t, torch.from_numpy(a_s),
                                         torch.from_numpy(a_d),
                                         negative_slope=slope)
    out = tab.edge_softmax_blocked_multihead(b_t, logits.movedim(-1, 0))
    jl = jab.gat_edge_logits_blocked(b_j, jnp.asarray(a_s), jnp.asarray(a_d),
                                     negative_slope=slope)
    ref = jab.edge_softmax_blocked_multihead(b_j, jnp.moveaxis(jl, -1, 0),
                                             interpret=True)
    return out.numpy(), np.asarray(ref)


def test_gat_logits_softmax_matches_jax(case):
    """B7 on the GAT logits (the composed route's first step): the port's
    plain composition against the JAX package's, float32."""
    _, a_s, a_d = case["arrays"]
    out, ref = _logits_softmax_both(case["b_t"], case["b_j"], a_s, a_d, 0.2)
    assert out.shape == ref.shape == (a_s.shape[1],) + tuple(
        case["b_t"].edge_src.shape)
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)
    assert (out[:, ~case["b_t"].edge_valid.numpy()] == 0).all()


def test_gat_logits_softmax_slope_and_short_dst_match_jax():
    """The same with a negative slope of 0.05 and an alpha_dst 37 rows
    short of the graph's rows, so that the last rows' logits take its last
    row (both packages clamp the row)."""
    indptr, src, W, C, (_, a_s, a_d) = CASES["ragged_rows"]
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    out, ref = _logits_softmax_both(b_t, b_j, a_s, a_d[:-37], 0.05)
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)


def test_gat_logits_softmax_wrapper_runs_plain_on_cpu():
    """B7's logits-in wrapper on CPU tensors: its plain composition's
    result, bit for bit, and no launch counted."""
    indptr, src, W, C, (_, a_s, a_d) = CASES["ragged_rows"]
    b = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                          device="cpu")
    a_s, a_d = torch.from_numpy(a_s), torch.from_numpy(a_d)
    before = tab.edge_softmax_blocked_multihead_cuda.launches
    out = tab._gat_edge_softmax_blocked_cuda(b, a_s, a_d,
                                             negative_slope=0.1)
    ref = tab.edge_softmax_blocked_multihead(
        b, tab.gat_edge_logits_blocked(b, a_s, a_d,
                                       negative_slope=0.1).movedim(-1, 0))
    assert tab.edge_softmax_blocked_multihead_cuda.launches == before
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["scores", "logits"])
def test_one_head_wrappers_run_plain_on_cpu(entry):
    """At one head B7's two wrappers launch B6's kernel on the card; on CPU
    tensors they return their plain versions' results, bit for bit, and no
    launch counter moves (B7's nor B6's)."""
    indptr, src, W, C, (_, a_s, a_d) = CASES["testbed_h1_d47"]
    b = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                          device="cpu")
    a_s, a_d = torch.from_numpy(a_s), torch.from_numpy(a_d)
    logits = tab.gat_edge_logits_blocked(b, a_s, a_d).movedim(-1, 0)
    assert logits.shape[0] == 1
    counters = (tab.edge_softmax_blocked_multihead_cuda,
                tab.edge_softmax_blocked_cuda)
    before = [c.launches for c in counters]
    if entry == "scores":
        out = tab.edge_softmax_blocked_multihead_cuda(b, logits)
    else:
        out = tab._gat_edge_softmax_blocked_cuda(b, a_s, a_d)
    assert [c.launches for c in counters] == before
    ref = tab.edge_softmax_blocked_multihead(b, logits)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    torch.testing.assert_close(out[0], tab.edge_softmax_blocked(b, logits[0]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spmm_multiweighted_matches_pallas(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    b_t, b_j = case["b_t"], case["b_j"]
    h = case["arrays"][0]
    N, H, D = h.shape
    x = h.reshape(N, H * D)
    w = np.random.default_rng(5).random(
        (H,) + tuple(b_t.edge_src.shape)).astype(np.float32)
    ref = np.asarray(jab.spmm_blocked_multiweighted_pallas(
        b_j, jnp.asarray(x), jnp.asarray(w), compute_dtype=jdt,
        interpret=True))
    out = tab.spmm_blocked_multiweighted(b_t, torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         compute_dtype=tdt).numpy()
    assert out.shape == ref.shape == (N, H * D)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def _d36_cases():
    ip, src, *_ = kernel_gates.build_gat_testbed(n=512, e=4096)
    _, hub_ip, hub_src, _, W, C = kernel_gates.hub_row_graph()
    return {"testbed": (ip, src, 128, None),
            "hub_row": (hub_ip, hub_src, W, C)}


D36_CASES = _d36_cases()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(D36_CASES))
def test_spmm_multiweighted_d36_matches_pallas(name, dtype):
    """B8's plain version at H=4 heads of D=36 columns (the width at which
    the kernel's bfloat16 loads drop to 4 elements, so that none straddles
    two heads), on the GAT testbed and on the hub row of 1,000 lanes
    (W = C = 128), against the JAX Pallas kernel in interpret mode."""
    jdt, tdt, tol = DTYPES[dtype]
    indptr, src, W, C = D36_CASES[name]
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    rng = np.random.default_rng(36)
    n = len(indptr) - 1
    x = rng.normal(size=(n, 4 * 36)).astype(np.float32)
    w = rng.random((4,) + tuple(b_t.edge_src.shape)).astype(np.float32)
    ref = np.asarray(jab.spmm_blocked_multiweighted_pallas(
        b_j, jnp.asarray(x), jnp.asarray(w), compute_dtype=jdt,
        interpret=True))
    out = tab.spmm_blocked_multiweighted(b_t, torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         compute_dtype=tdt).numpy()
    assert out.shape == ref.shape == (n, 4 * 36)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


ROUTES = ["gat_attend_blocked", "gat_attend_blocked_flash"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", ROUTES)
def test_gat_route_matches_jax(case, route, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    h, a_s, a_d = case["arrays"]
    ref = np.asarray(getattr(jab, route)(
        case["b_j"], jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d),
        compute_dtype=jdt, interpret=True))
    out = getattr(tab, route)(
        case["b_t"], torch.from_numpy(h), torch.from_numpy(a_s),
        torch.from_numpy(a_d), compute_dtype=tdt).numpy()
    n = len(case["indptr"]) - 1
    assert out.shape == ref.shape == (n,) + h.shape[1:]
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    empty = np.diff(case["indptr"]) == 0
    assert not out[empty].any()


def test_gat_flash_debug_stats_match_jax(case):
    """The undivided accumulator and the final (m, z) of every row and
    head, as the JAX kernel leaves them (m is -inf on rows with no
    edges)."""
    h, a_s, a_d = case["arrays"]
    _, *ref = jab.gat_attend_blocked_flash(
        case["b_j"], jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d),
        compute_dtype=jnp.float32, interpret=True, debug_stats=True)
    _, *out = tab.gat_attend_blocked_flash(
        case["b_t"], torch.from_numpy(h), torch.from_numpy(a_s),
        torch.from_numpy(a_d), compute_dtype=torch.float32, debug_stats=True)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=F32_TOL,
                                   atol=F32_TOL)


def _packed_both(b_t, b_j, h, a_s, a_d, vec, mode, jdt, tdt):
    """(port, JAX) outputs of the plain head-packed GAT (B3) in ``mode``
    (``table``: the (N, H) alpha_src; ``vec``: the GATv1 projection)."""
    table = mode == "table"
    out = tab.gat_attend_blocked_packed(
        b_t, torch.from_numpy(h), torch.from_numpy(a_s) if table else None,
        torch.from_numpy(a_d),
        alpha_src_vec=None if table else torch.from_numpy(vec),
        compute_dtype=tdt).numpy()
    ref = np.asarray(jab.gat_attend_blocked_packed(
        b_j, jnp.asarray(h), jnp.asarray(a_s) if table else None,
        jnp.asarray(a_d), alpha_src_vec=None if table else jnp.asarray(vec),
        compute_dtype=jdt, interpret=True))
    return out, ref


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["table", "vec"])
def test_plain_packed_gat_matches_jax(case, mode, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    h, a_s, a_d = case["arrays"]
    H, D = h.shape[1:]
    vec = (np.random.default_rng(D).normal(size=(H, D))
           / np.sqrt(D)).astype(np.float32)
    out, ref = _packed_both(case["b_t"], case["b_j"], h, a_s, a_d, vec, mode,
                            jdt, tdt)
    assert out.shape == ref.shape == h.shape
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


FAR_ROUTES = ["packed_table", "packed_vec", "flash"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", FAR_ROUTES)
def test_far_logits_match_jax(route, dtype):
    """Three rows' logits 150 above the rest of their row block: the plain
    B3 reads 0 on every other row of the block (its chunk-max shift
    underflows), as the JAX kernel does, and B9 keeps every row's softmax,
    as its JAX kernel does."""
    jdt, tdt, tol = DTYPES[dtype]
    _, indptr, src, W, C, (h, a_s, a_d, vec), far = \
        kernel_gates.far_logits_case()
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    if route == "flash":
        ref = np.asarray(jab.gat_attend_blocked_flash(
            b_j, jnp.asarray(h), jnp.asarray(a_s), jnp.asarray(a_d),
            compute_dtype=jdt, interpret=True))
        out = tab.gat_attend_blocked_flash(
            b_t, torch.from_numpy(h), torch.from_numpy(a_s),
            torch.from_numpy(a_d), compute_dtype=tdt).numpy()
    else:
        out, ref = _packed_both(b_t, b_j, h, a_s, a_d, vec,
                                route.split("_")[1], jdt, tdt)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    others = np.setdiff1d(np.arange(W), far)
    zero_rows = int((np.abs(out[others]).sum((1, 2)) == 0).sum())
    assert zero_rows == (0 if route == "flash" else len(others))


def test_routes_agree_with_packed(case):
    """The composed and flash routes compute B3's function: in float32 they
    agree with the port's plain head-packed GAT."""
    h, a_s, a_d = (torch.from_numpy(a) for a in case["arrays"])
    kw = dict(compute_dtype=torch.float32)
    ref = tab.gat_attend_blocked_packed(case["b_t"], h, a_s, a_d, **kw)
    for route in ROUTES:
        torch.testing.assert_close(
            getattr(tab, route)(case["b_t"], h, a_s, a_d, **kw), ref,
            rtol=F32_TOL, atol=F32_TOL)


WRAPPERS = {
    "edge_softmax_blocked_multihead_cuda": (
        "edge_softmax_blocked_multihead",
        ["edge_softmax_blocked_multihead_cuda"]),
    "spmm_blocked_multiweighted_cuda": (
        "spmm_blocked_multiweighted", ["spmm_blocked_multiweighted_cuda"]),
    "gat_attend_blocked_cuda": (
        "gat_attend_blocked", ["edge_softmax_blocked_multihead_cuda",
                               "spmm_blocked_multiweighted_cuda"]),
    "gat_attend_blocked_flash_cuda": (
        "gat_attend_blocked_flash", ["gat_attend_blocked_flash_cuda"]),
}


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_cuda_wrappers_run_plain_on_cpu(wrapper):
    """On CPU tensors every wrapper returns its plain version's result and
    launches nothing: no launch counter moves."""
    plain, counters = WRAPPERS[wrapper]
    indptr, src, W, C, arrays = CASES["ragged_rows"]
    b = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                          device="cpu")
    h, a_s, a_d = (torch.from_numpy(a) for a in arrays)
    N, H, D = h.shape
    att = torch.rand((H,) + tuple(b.edge_src.shape),
                     generator=torch.Generator().manual_seed(0))
    args = {"edge_softmax_blocked_multihead": (att,),
            "spmm_blocked_multiweighted": (h.reshape(N, H * D), att)}.get(
                plain, (h, a_s, a_d))
    before = {c: getattr(tab, c).launches for c in counters}
    out = getattr(tab, wrapper)(b, *args)
    assert {c: getattr(tab, c).launches for c in counters} == before
    torch.testing.assert_close(out, getattr(tab, plain)(b, *args),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype,threshold", [
    (torch.float32, kernel_gates.F32_THRESHOLD),
    (torch.bfloat16, kernel_gates.BF16_THRESHOLDS)])
def test_gat_route_gates_harness_on_cpu(dtype, threshold):
    errs = kernel_gates.run_gat_route_gates(dtype, device="cpu")
    # B7's two entries, B8, the composed route and B9 on five cases, B7's
    # two entries with a short alpha_dst, and at one head (B6's kernel)
    # both entries on its looped path, on the testbed and with a short
    # alpha_dst
    assert len(errs) == 5 * 5 + 2 + 2 + 4
    key = "edge_softmax_blocked_multihead_cuda"
    assert {f"testbed_h1_d47[looped]/{key}",
            f"testbed_h1_d47[logits,looped]/{key}",
            f"ragged_rows[short_dst,H=1]/{key}",
            f"ragged_rows[short_dst,H=1][logits]/{key}",
            f"ragged_rows[short_dst,H=1][looped]/{key}",
            f"ragged_rows[short_dst,H=1][logits,looped]/{key}"} < set(errs)
    kernels = {k.rsplit("/", 1)[1] for k in errs}
    assert kernels == {"edge_softmax_blocked_multihead_cuda",
                       "spmm_blocked_multiweighted_cuda",
                       "gat_attend_blocked_cuda",
                       "gat_attend_blocked_flash_cuda"}
    ok, worst = kernel_gates.gate(errs, threshold)
    assert ok, worst


@pytest.mark.parametrize("dtype,threshold", [
    (torch.float32, kernel_gates.F32_THRESHOLD),
    (torch.bfloat16, kernel_gates.BF16_THRESHOLDS)])
def test_gat_mode_gates_harness_on_cpu(dtype, threshold):
    """B3's and B9's gates of the new design's paths run on the CPU (plain
    against plain): six cases, B3 in both modes and B9, B9's debug
    statistics on the hub row, B7's two entries on the hub row and at
    C=8192, and at one head (B6's kernel, also on its looped path) on the
    hub row."""
    errs = kernel_gates.run_gat_mode_gates(dtype, device="cpu")
    assert len(errs) == 6 * 3 + 1 + 2 * 2 + 4
    one_head = {k.rsplit("/", 1)[0] for k in errs if "hub_row[H=1]" in k}
    assert one_head == {"hub_row[H=1]", "hub_row[H=1][logits]",
                        "hub_row[H=1][looped]", "hub_row[H=1][logits,looped]"}
    kernels = {k.rsplit("/", 1)[1] for k in errs}
    assert kernels == {"gat_attend_blocked_packed_cuda",
                       "gat_attend_blocked_flash_cuda",
                       "edge_softmax_blocked_multihead_cuda"}
    ok, worst = kernel_gates.gate(errs, threshold)
    assert ok, worst


@pytest.mark.parametrize("heads,features", [(4, 128), (1, 47)])
@pytest.mark.parametrize("route", ROUTES)
def test_gatconv_inputs_through_routes(route, heads, features):
    """``GATConv.project`` and ``logit_tables`` are what the composed and
    flash routes take: through either route the layer gives its own
    ``forward(blocked=...)`` (B3's plain version) in float32."""
    from tch_geometric_tpu_torch.models.gnn import GATConv
    indptr, src, _, _, _ = CASES["testbed"]
    b = tsb.build_blocked(indptr, src, rows_per_block=128, device="cpu")
    conv = GATConv(16, features, heads, device="cpu")
    conv.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(len(indptr) - 1, 16)).astype(np.float32))
    with torch.no_grad():
        h = conv.project(x)
        out = getattr(tab, route)(b, h, *conv.logit_tables(h),
                                  compute_dtype=conv.compute_dtype)
        ref = conv(x, blocked=b)
    torch.testing.assert_close(out.reshape(-1, features), ref, rtol=F32_TOL,
                               atol=F32_TOL)
