"""Single-head blocked dot-product attention of the torch port against the
JAX package.

Each plain port function (``sddmm``, ``sddmm_blocked``,
``edge_softmax_blocked``, ``attend_blocked``, ``attend_blocked_fused``,
``attend_blocked_flash`` in both stat modes) against its JAX counterpart,
the Pallas kernels run with ``interpret=True`` as
``tests/test_attention_blocked.py`` runs them, on the same numpy inputs.

Tolerances: float32 at 2e-4, the JAX package's own tolerance for these
functions.  In bfloat16 the scores match as in float32 (products of
bfloat16 rows are exact in float32, sums are float32 on both sides), so
they keep 2e-4.  The attend routes round at the JAX functions' points, but
a weight that differs in its last float32 bit (torch's ``exp`` against
XLA's, another summation order) can round its bfloat16 term the other way:
``bf16(x * w)`` in the composed and fused routes, ``bf16(e)`` in flash.
One such flip moves a result by one bfloat16 ulp of the term, at most
2**-6 for the |x| < 4 of these inputs; these seeds read at most 9.8e-4
(rows up to 4), so the limit is 1e-2.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.data.io import load_karate_graph
from tch_geometric_tpu.ops import attention_blocked as jab
from tch_geometric_tpu.ops.spmm import sddmm as jsddmm
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.ops import attention_blocked as tab
from tch_geometric_tpu_torch.ops.spmm import sddmm
from tch_geometric_tpu_torch.utils import kernel_gates

jsb = importlib.import_module("tch_geometric_tpu.ops.spmm_blocked")
tsb = importlib.import_module("tch_geometric_tpu_torch.ops.spmm_blocked")

F32_TOL = 2e-4
BF16_TOL = 1e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _uniform_graph():
    rng = np.random.default_rng(7)
    n, e = 300, 4000
    dst = np.sort(rng.integers(0, n, e))
    src = rng.integers(0, n, e)
    indptr = np.searchsorted(dst, np.arange(n + 1))
    return ("uniform", indptr, src,
            rng.normal(size=(n, 128)).astype(np.float32), 128, None)


# uniform rows; rows and whole blocks with no edges; one block of 40
# chunks; num_rows % W != 0 with an odd feature width (37)
GRAPHS = {g[0]: g for g in [_uniform_graph()]
          + list(kernel_gates.edge_case_graphs())}


@pytest.fixture(scope="module", params=list(GRAPHS))
def case(request):
    name, indptr, src, x, W, C = GRAPHS[request.param]
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    rng = np.random.default_rng(len(indptr))
    x_dst = rng.normal(size=x.shape).astype(np.float32)
    return dict(name=name, indptr=indptr, src=src, b_t=b_t, b_j=b_j,
                x_src=x, x_dst=x_dst)


def _tol(dtype):
    return F32_TOL if dtype == "float32" else BF16_TOL


def test_sddmm_segment_matches_jax():
    _, indptr, src, x, _, _ = GRAPHS["uniform"]
    n = len(indptr) - 1
    rng = np.random.default_rng(3)
    x_dst = rng.normal(size=x.shape).astype(np.float32)
    g_t = make_graph(indptr, src, num_src=n, num_dst=n, device="cpu")
    g_j = jmake_graph(indptr, src.astype(np.int32), num_src=n, num_dst=n)
    out = sddmm(g_t, torch.from_numpy(x_dst), torch.from_numpy(x)).numpy()
    ref = np.asarray(jsddmm(g_j, jnp.asarray(x_dst), jnp.asarray(x)))
    assert out.shape == ref.shape == (len(src),)
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_sddmm_blocked_matches_pallas(case, version, dtype):
    jdt, tdt = DTYPES[dtype]
    fn = (jab.sddmm_blocked_pallas if version == "v1"
          else jab.sddmm_blocked_pallas_v2)
    ref = np.asarray(fn(case["b_j"], jnp.asarray(case["x_dst"]),
                        jnp.asarray(case["x_src"]), compute_dtype=jdt,
                        interpret=True))
    out = tab.sddmm_blocked(case["b_t"], torch.from_numpy(case["x_dst"]),
                            torch.from_numpy(case["x_src"]),
                            compute_dtype=tdt).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)
    pads = ~case["b_t"].edge_valid.numpy()
    assert (out[pads] == 0).all()


def test_edge_softmax_blocked_matches_pallas(case):
    b_t, b_j = case["b_t"], case["b_j"]
    rng = np.random.default_rng(11)
    scores = (rng.normal(size=tuple(b_t.edge_src.shape)) * 3).astype(
        np.float32)
    pads = ~b_t.edge_valid.numpy()
    scores[pads] = np.nan                   # ignored by both
    ref = np.asarray(jab.edge_softmax_blocked(b_j, jnp.asarray(scores),
                                              interpret=True))
    out = tab.edge_softmax_blocked(b_t, torch.from_numpy(scores)).numpy()
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)
    assert (out[pads] == 0).all()
    # the weights of every row with edges sum to 1
    rows = tab.blocked_dst_rows(b_t).numpy()[~pads]
    sums = np.bincount(rows, weights=out[~pads])
    has = np.bincount(rows) > 0
    np.testing.assert_allclose(sums[has], 1.0, rtol=1e-5)


def _b6_case(name):
    """(b_t, b_j, scores with NaN in the pad lanes) of the hub row or the
    far scores: scores of N(0, 3) on the hub row, the scaled far scores
    (near 150 on rows 16-18, near 0 elsewhere) on the other."""
    if name == "hub_row":
        _, indptr, src, _, W, C = kernel_gates.hub_row_graph()
    else:
        _, indptr, src, x_dst, x_src, W, C, _ = kernel_gates.far_scores_case()
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    if name == "hub_row":
        rng = np.random.default_rng(70)
        scores = (rng.normal(size=tuple(b_t.edge_src.shape)) * 3).astype(
            np.float32)
    else:
        xd = torch.from_numpy(x_dst) / x_dst.shape[1] ** 0.5
        scores = tab.sddmm_blocked(b_t, xd, torch.from_numpy(x_src),
                                   compute_dtype=torch.float32).numpy()
    scores[~b_t.edge_valid.numpy()] = np.nan
    return b_t, b_j, scores


@pytest.mark.parametrize("name", ["hub_row", "far_scores"])
def test_edge_softmax_hub_and_far_match_pallas(name):
    """B6's plain version against the JAX kernels in interpret mode on the
    hub row (a row of 1,000 lanes over several chunks of 128) and on the
    far scores (three rows near 150 in a block of 40 chunks): every row
    keeps its softmax, pads read 0, and each row's weights sum to 1."""
    b_t, b_j, scores = _b6_case(name)
    ref = np.asarray(jab.edge_softmax_blocked(b_j, jnp.asarray(scores),
                                              interpret=True))
    out = tab.edge_softmax_blocked(b_t, torch.from_numpy(scores)).numpy()
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)
    pads = ~b_t.edge_valid.numpy()
    assert (out[pads] == 0).all()
    rows = tab.blocked_dst_rows(b_t).numpy()[~pads]
    sums = np.bincount(rows, weights=out[~pads])
    has = np.bincount(rows) > 0
    np.testing.assert_allclose(sums[has], 1.0, rtol=1e-5)


ATTEND = {
    "attend_blocked": {},
    "attend_blocked_fused": {},
    "attend_blocked_flash[row]": dict(row_stats=True),
    "attend_blocked_flash[scalar]": dict(row_stats=False),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("route", list(ATTEND))
def test_attend_matches_jax(case, route, dtype):
    jdt, tdt = DTYPES[dtype]
    name, kw = route.split("[")[0], ATTEND[route]
    ref = np.asarray(getattr(jab, name)(
        case["b_j"], jnp.asarray(case["x_dst"]), jnp.asarray(case["x_src"]),
        compute_dtype=jdt, interpret=True, **kw))
    out = getattr(tab, name)(
        case["b_t"], torch.from_numpy(case["x_dst"]),
        torch.from_numpy(case["x_src"]), compute_dtype=tdt, **kw).numpy()
    n = len(case["indptr"]) - 1
    assert out.shape == ref.shape == (n, case["x_src"].shape[1])
    np.testing.assert_allclose(out, ref, rtol=_tol(dtype), atol=_tol(dtype))
    empty = np.diff(case["indptr"]) == 0
    assert not out[empty].any()


def test_example_flow_karate():
    """``examples/gat_attention.py``'s attention on the karate graph
    (rows_per_block=128, chunk_edges=256, x_dst = x_src, float32): the
    composed and fused routes, port against JAX, and against each other."""
    x, _, edge_index = load_karate_graph()
    cp, ri, _ = to_csc(edge_index, 34)
    kw = dict(rows_per_block=128, chunk_edges=256)
    b_t = tsb.build_blocked(cp, ri, device="cpu", **kw)
    b_j = jsb.build_blocked(cp, ri.astype(np.int32), **kw)
    xf = np.asarray(x, np.float32)
    xt, xj = torch.from_numpy(xf), jnp.asarray(xf)
    outs = {}
    for name in ("attend_blocked", "attend_blocked_fused"):
        ref = np.asarray(getattr(jab, name)(b_j, xj, xj,
                                            compute_dtype=jnp.float32,
                                            interpret=True))
        outs[name] = getattr(tab, name)(b_t, xt, xt,
                                        compute_dtype=torch.float32).numpy()
        assert outs[name].shape == (34, xf.shape[1])
        np.testing.assert_allclose(outs[name], ref, rtol=F32_TOL,
                                   atol=F32_TOL)
    np.testing.assert_allclose(outs["attend_blocked"],
                               outs["attend_blocked_fused"], rtol=F32_TOL,
                               atol=F32_TOL)


WRAPPERS = {
    "sddmm_blocked_cuda": ("sddmm_blocked", {}, ["sddmm_blocked_cuda"]),
    "edge_softmax_blocked_cuda": ("edge_softmax_blocked", {},
                                  ["edge_softmax_blocked_cuda"]),
    "attend_blocked_cuda": ("attend_blocked", {},
                            ["sddmm_blocked_cuda",
                             "edge_softmax_blocked_cuda",
                             "spmm_blocked_multiweighted_cuda"]),
    "attend_blocked_fused_cuda": ("attend_blocked_fused", {},
                                  ["attend_blocked_fused_cuda"]),
    "attend_blocked_flash_cuda[row]": ("attend_blocked_flash",
                                       dict(row_stats=True),
                                       ["attend_blocked_flash_cuda"]),
    "attend_blocked_flash_cuda[scalar]": ("attend_blocked_flash",
                                          dict(row_stats=False),
                                          ["attend_blocked_flash_cuda"]),
}


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_cuda_wrappers_run_plain_on_cpu(wrapper):
    """On CPU tensors every wrapper returns its plain version's result and
    launches nothing: no launch counter moves."""
    plain, kw, counters = WRAPPERS[wrapper]
    _, indptr, src, x_np, W, C = GRAPHS["ragged_rows"]
    b = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                          device="cpu")
    x = torch.from_numpy(x_np)
    if plain == "edge_softmax_blocked":
        args = (tab.sddmm_blocked(b, x, x),)
    else:
        args = (x, x)
    before = {c: getattr(tab, c).launches for c in counters}
    out = getattr(tab, wrapper.split("[")[0])(b, *args, **kw)
    assert {c: getattr(tab, c).launches for c in counters} == before
    torch.testing.assert_close(out, getattr(tab, plain)(b, *args, **kw),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_weighted_sum_rounded_matches_pallas(dtype):
    """The plain attend routes' last step, one head of
    ``spmm_blocked_multiweighted``, is the JAX Pallas B2 (``bf16(x * w)``
    terms); B2's wrapper on CPU tensors keeps the
    weight-rounding plain version that ``spmm_hot_split`` is held to and
    launches nothing."""
    jdt, tdt = DTYPES[dtype]
    _, indptr, src, x_np, W, C = GRAPHS["uniform"]
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    w = np.random.default_rng(2).random(tuple(b_t.edge_src.shape)).astype(
        np.float32)
    x, wt = torch.from_numpy(x_np), torch.from_numpy(w)
    out = tab.spmm_blocked_multiweighted(b_t, x, wt[None],
                                         compute_dtype=tdt)
    ref = np.asarray(jab.spmm_blocked_weighted_pallas(
        b_j, jnp.asarray(x_np), jnp.asarray(w), compute_dtype=jdt,
        interpret=True))
    np.testing.assert_allclose(out.numpy(), ref, rtol=_tol(dtype),
                               atol=_tol(dtype))
    before = tab.spmm_blocked_weighted_cuda.launches
    torch.testing.assert_close(
        tab.spmm_blocked_weighted_cuda(b_t, x, wt, compute_dtype=tdt),
        tsb.spmm_blocked(b_t, x, edge_weight=wt, compute_dtype=tdt),
        rtol=0, atol=0)
    assert tab.spmm_blocked_weighted_cuda.launches == before


@pytest.mark.parametrize("row_stats", [True, False])
def test_flash_plain_grouping(monkeypatch, row_stats):
    """The plain flash version splits the blocks into groups; a tiny group
    budget gives the same result as one group."""
    _, indptr, src, x_np, W, C = GRAPHS["many_chunks"]
    b = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                          device="cpu")
    x = torch.from_numpy(x_np)
    kw = dict(compute_dtype=torch.float32, row_stats=row_stats)
    whole = tab.attend_blocked_flash(b, x, x, **kw)
    monkeypatch.setattr(tab, "PLAIN_GROUP_LANES", 3 * b.edge_src.shape[1])
    assert len(tab._groups(b)) > 1
    torch.testing.assert_close(tab.attend_blocked_flash(b, x, x, **kw),
                               whole, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,threshold", [
    (torch.float32, kernel_gates.F32_THRESHOLD),
    (torch.bfloat16, kernel_gates.BF16_THRESHOLDS)])
def test_attend_gates_harness_on_cpu(dtype, threshold):
    errs = kernel_gates.run_attend_gates(dtype, device="cpu")
    assert len(errs) == 4 * 6
    kernels = {k.rsplit("/", 1)[1] for k in errs}
    assert kernels == {"sddmm_blocked_cuda", "edge_softmax_blocked_cuda",
                       "attend_blocked_cuda", "attend_blocked_fused_cuda",
                       "attend_blocked_flash_cuda"}
    ok, worst = kernel_gates.gate(errs, threshold)
    assert ok, worst


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("row_stats", [True, False])
def test_flash_far_scores_matches_jax(row_stats, dtype):
    """The "far scores" case (``kernel_gates.far_scores_case``): rows 16-18
    score near 150, every other lane near 0.  The plain flash attention
    matches the JAX kernel in interpret mode, and with chunk-max stats
    every other row of block 0 reads exactly 0 (its weights exp(s - 150)
    underflow: row 19 against its chunk's max, the rest against the
    block's), while the rows of the other blocks and, with row stats,
    every row with edges keep their softmax."""
    jdt, tdt = DTYPES[dtype]
    _, indptr, src, x_dst, x_src, W, C, far = kernel_gates.far_scores_case()
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    ref = np.asarray(jab.attend_blocked_flash(
        b_j, jnp.asarray(x_dst), jnp.asarray(x_src), compute_dtype=jdt,
        row_stats=row_stats, interpret=True))
    out = tab.attend_blocked_flash(
        b_t, torch.from_numpy(x_dst), torch.from_numpy(x_src),
        compute_dtype=tdt, row_stats=row_stats).numpy()
    np.testing.assert_allclose(out, ref, rtol=_tol(dtype), atol=_tol(dtype))
    zero = ~out.any(axis=1)
    expect = np.zeros(len(indptr) - 1, bool)
    if not row_stats:
        expect[:W] = True
        expect[far] = False
    np.testing.assert_array_equal(zero, expect)
    np.testing.assert_array_equal(~ref.any(axis=1), expect)


@pytest.mark.parametrize("dtype,threshold", [
    (torch.float32, kernel_gates.F32_THRESHOLD),
    (torch.bfloat16, kernel_gates.BF16_THRESHOLDS)])
def test_attend_mode_gates_harness_on_cpu(dtype, threshold):
    """B5 and B4 (both stat modes) on five cases, and B6 on three of them
    through its wrapper and on its looped path."""
    errs = kernel_gates.run_attend_mode_gates(dtype, device="cpu")
    assert len(errs) == 5 * 3 + 3 * 2
    cases = {k.rsplit("/", 1)[0].split("[row_stats")[0].replace("[looped]", "")
             for k in errs}
    assert cases == {"hub_row", "testbed[C=8192]", "testbed_f320",
                     "testbed_short_dst", "far_scores"}
    kernels = {k.rsplit("/", 1)[1] for k in errs}
    assert kernels == {"sddmm_blocked_cuda", "attend_blocked_flash_cuda",
                       "edge_softmax_blocked_cuda"}
    b6 = {k.rsplit("/", 1)[0] for k in errs
          if k.endswith("/edge_softmax_blocked_cuda")}
    assert b6 == {f"{c}{p}" for c in ("hub_row", "testbed[C=8192]",
                                      "far_scores") for p in ("", "[looped]")}
    ok, worst = kernel_gates.gate(errs, threshold)
    assert ok, worst


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_hub_row_matches_jax(dtype):
    """The plain fused attention (B10's function) on the hub row of 1,000
    lanes (W = C = 128: the row fills several chunks) with a distinct
    x_dst, against the JAX kernels in interpret mode."""
    jdt, tdt = DTYPES[dtype]
    _, indptr, src, x_src, W, C = kernel_gates.hub_row_graph()
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    x_dst = np.random.default_rng(70).normal(size=x_src.shape).astype(
        np.float32)
    ref = np.asarray(jab.attend_blocked_fused(
        b_j, jnp.asarray(x_dst), jnp.asarray(x_src), compute_dtype=jdt,
        interpret=True))
    out = tab.attend_blocked_fused(
        b_t, torch.from_numpy(x_dst), torch.from_numpy(x_src),
        compute_dtype=tdt).numpy()
    assert out.shape == ref.shape == x_src.shape
    np.testing.assert_allclose(out, ref, rtol=_tol(dtype), atol=_tol(dtype))
    empty = np.diff(indptr) == 0
    assert not out[empty].any()


@pytest.mark.parametrize("dtype,threshold", [
    (torch.float32, kernel_gates.F32_THRESHOLD),
    (torch.bfloat16, kernel_gates.BF16_THRESHOLDS)])
def test_weighted_mode_gates_harness_on_cpu(dtype, threshold):
    errs = kernel_gates.run_weighted_mode_gates(dtype, device="cpu")
    assert len(errs) == 5 + 6
    cases = {k.rsplit("/", 1)[0].split("[H=")[0] for k in errs}
    assert cases == {"hub_row", "testbed[C=8192]", "testbed_f320",
                     "testbed_short_dst", "far_scores"}
    kernels = {k.rsplit("/", 1)[1] for k in errs}
    assert kernels == {"attend_blocked_fused_cuda",
                       "spmm_blocked_multiweighted_cuda"}
    ok, worst = kernel_gates.gate(errs, threshold)
    assert ok, worst
