"""Blocked-ELL layouts and SpMM of the torch port against the JAX package.

The layouts must be exactly equal.  On CPU tensors the port's kernel
wrappers (B1 ``spmm_blocked_cuda``, B2 ``spmm_blocked_weighted_cuda``) run
their plain version; it must match the JAX Pallas kernels run with
``interpret=True`` at atol 5e-4 in float32 (summation order differs)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.data.graph import make_graph as jmake_graph
from tch_geometric_tpu.ops.attention_blocked import \
    spmm_blocked_weighted_pallas
from tch_geometric_tpu.ops.spmm import spmm as jspmm
from tch_geometric_tpu.ops.spmm_pallas import (spmm_blocked_pallas,
                                               spmm_hot_split as jhot,
                                               spmm_blocked_segmented as jseg,
                                               spmm_hot_split_segmented as
                                               jhotseg)
from tch_geometric_tpu_torch.data.graph import make_graph
from tch_geometric_tpu_torch.ops.attention_blocked import \
    spmm_blocked_weighted_cuda
from tch_geometric_tpu_torch.ops.spmm import spmm
from tch_geometric_tpu_torch.ops.spmm_kernels import (
    spmm_blocked_auto, spmm_blocked_cuda, spmm_blocked_segmented,
    spmm_hot_split, spmm_hot_split_segmented)
from tch_geometric_tpu_torch.utils import kernel_gates

# the ops packages re-export a function named spmm_blocked over the module
jsb = importlib.import_module("tch_geometric_tpu.ops.spmm_blocked")
tsb = importlib.import_module("tch_geometric_tpu_torch.ops.spmm_blocked")

ATOL = 5e-4
F32 = dict(compute_dtype=jnp.float32)
T32 = dict(compute_dtype=torch.float32)


def _cases():
    r = np.random.default_rng(0)
    n, e = 1000, 12000
    pop = (1.0 / (np.arange(n) + 10.0)) ** 0.8
    pop /= pop.sum()
    src = r.choice(n, size=e, p=pop)
    dst = np.sort(r.integers(0, n, e))
    indptr = np.searchsorted(dst, np.arange(n + 1))
    x = r.normal(size=(n, 16)).astype(np.float32)
    out = {"powerlaw": (indptr, src, x, 128, None)}
    for name, ip, s, xx, W, C in kernel_gates.edge_case_graphs(f=16):
        out[name] = (ip, s, xx, W, C)
    name, ip, s, xx, W, C = kernel_gates.hub_row_graph(f=16)
    out[name] = (ip, s, xx, W, C)
    return out


CASES = _cases()


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_fields_equal(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)),
                                      err_msg=f)


BLK_FIELDS = ("edge_src", "edge_local_row", "edge_valid", "chunk_block",
              "block_start", "degree", "edge_ptr", "num_rows",
              "rows_per_block", "chunk_edges")
SEG_FIELDS = ("edge_src", "edge_local_row", "chunk_block", "block_start",
              "degree", "num_rows", "rows_per_block", "chunk_edges",
              "blocks_per_segment")


@pytest.mark.parametrize("case", list(CASES))
def test_builders_exact(case):
    indptr, src, _, W, C = CASES[case]
    kw = dict(rows_per_block=W, chunk_edges=C)
    _assert_fields_equal(tsb.build_blocked(indptr, src, device="cpu", **kw),
                         jsb.build_blocked(indptr, src, **kw), BLK_FIELDS)
    _assert_fields_equal(
        tsb.build_blocked(indptr, src, sort_chunk_sources=False,
                          device="cpu", **kw),
        jsb.build_blocked(indptr, src, sort_chunk_sources=False, **kw),
        BLK_FIELDS)
    attr = np.arange(len(src), dtype=np.float32) % 5
    for ea in (None, attr):
        a = tsb.build_blocked_segmented(indptr, src, num_segments=3,
                                        edge_attr=ea, device="cpu", **kw)
        b = jsb.build_blocked_segmented(indptr, src, num_segments=3,
                                        edge_attr=ea, **kw)
        _assert_fields_equal(a, b, SEG_FIELDS + (
            ("edge_weight",) if ea is not None else ()))
    a = tsb.build_blocked_hot(indptr, src, hot_k=64, device="cpu", **kw)
    b = jsb.build_blocked_hot(indptr, src, hot_k=64, **kw)
    _assert_fields_equal(a.cold, b.cold, BLK_FIELDS)
    _assert_fields_equal(a.hot, b.hot, BLK_FIELDS)
    _assert_fields_equal(a, b, ("hot_ids", "hot_count", "degree",
                                "num_rows"))
    a = tsb.build_blocked_hot_segmented(indptr, src, hot_k=64,
                                        num_segments=2, device="cpu", **kw)
    b = jsb.build_blocked_hot_segmented(indptr, src, hot_k=64,
                                        num_segments=2, **kw)
    _assert_fields_equal(a.cold, b.cold, SEG_FIELDS)
    _assert_fields_equal(a.hot, b.hot, SEG_FIELDS + ("edge_weight",))
    _assert_fields_equal(a, b, ("hot_ids", "degree", "num_rows"))
    tb = tsb.build_blocked(indptr, src, device="cpu", **kw)
    jb = jsb.build_blocked(indptr, src, **kw)
    np.testing.assert_array_equal(
        tsb.edge_attr_to_blocked(tb, torch.from_numpy(attr)).numpy(),
        np.asarray(jsb.edge_attr_to_blocked(jb, jnp.asarray(attr))))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_spmm_blocked_matches_pallas(case, agg):
    indptr, src, x, W, C = CASES[case]
    kw = dict(rows_per_block=W, chunk_edges=C)
    tb = tsb.build_blocked(indptr, src, device="cpu", **kw)
    jb = jsb.build_blocked(indptr, src, **kw)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ref = np.asarray(spmm_blocked_pallas(jb, xj, agg=agg, interpret=True,
                                         **F32))
    before = spmm_blocked_cuda.launches
    np.testing.assert_allclose(
        spmm_blocked_auto(tb, xt, agg=agg, **T32).numpy(), ref, atol=ATOL)
    assert spmm_blocked_cuda.launches == before   # CPU: plain version only
    # weighted (B2) against the weighted Pallas kernel
    w = np.random.default_rng(3).random(tb.edge_src.shape).astype(np.float32)
    refw = np.asarray(spmm_blocked_weighted_pallas(
        jb, xj, jnp.asarray(w), interpret=True, **F32))
    if agg == "mean":
        refw = refw / np.maximum(np.diff(indptr), 1)[:, None]
        outw = (spmm_blocked_weighted_cuda(tb, xt, torch.from_numpy(w), **T32)
                / tb.degree.clamp(min=1)[:, None])
    else:
        outw = spmm_blocked_weighted_cuda(tb, xt, torch.from_numpy(w), **T32)
    np.testing.assert_allclose(outw.numpy(), refw, atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_hot_split_and_segmented_match(case, agg):
    indptr, src, x, W, C = CASES[case]
    kw = dict(rows_per_block=W, chunk_edges=C)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    ths = tsb.build_blocked_hot(indptr, src, hot_k=64, device="cpu", **kw)
    jhs = jsb.build_blocked_hot(indptr, src, hot_k=64, **kw)
    np.testing.assert_allclose(
        spmm_hot_split(ths, xt, agg=agg, **T32).numpy(),
        np.asarray(jhot(jhs, xj, agg=agg, interpret=True, **F32)), atol=ATOL)
    attr = (np.arange(len(src)) % 3 + 1).astype(np.float32)
    for ea in (None, attr):
        ts = tsb.build_blocked_segmented(indptr, src, num_segments=3,
                                         edge_attr=ea, device="cpu", **kw)
        js = jsb.build_blocked_segmented(indptr, src, num_segments=3,
                                         edge_attr=ea, **kw)
        np.testing.assert_allclose(
            spmm_blocked_segmented(ts, xt, agg=agg, **T32).numpy(),
            np.asarray(jseg(js, xj, agg=agg, interpret=True, **F32)),
            atol=ATOL)
    ths = tsb.build_blocked_hot_segmented(indptr, src, hot_k=64,
                                          num_segments=2, device="cpu", **kw)
    jhs = jsb.build_blocked_hot_segmented(indptr, src, hot_k=64,
                                          num_segments=2, **kw)
    np.testing.assert_allclose(
        spmm_hot_split_segmented(ths, xt, agg=agg, **T32).numpy(),
        np.asarray(jhotseg(jhs, xj, agg=agg, interpret=True, **F32)),
        atol=ATOL)


def test_plain_grouping_and_bf16(monkeypatch):
    """The plain version splits a large graph into block groups; a tiny
    group budget must give the same result as one group."""
    indptr, src, x, W, C = CASES["many_chunks"]
    tb = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                           device="cpu")
    xt = torch.from_numpy(x)
    whole = tsb.spmm_blocked(tb, xt, agg="mean", **T32)
    monkeypatch.setattr(tsb, "PLAIN_GROUP_LANES", 3 * C)
    assert len(tsb._block_groups(tb.block_start.tolist(), 3)) > 1
    np.testing.assert_allclose(
        tsb.spmm_blocked(tb, xt, agg="mean", **T32).numpy(), whole.numpy(),
        atol=1e-5)
    # bf16 compute: rows are rounded to bf16, accumulation stays f32
    jb = jsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C)
    ref = np.asarray(spmm_blocked_pallas(jb, jnp.asarray(x), agg="mean",
                                         interpret=True))
    np.testing.assert_allclose(
        tsb.spmm_blocked(tb, xt, agg="mean").numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_plain_spmm_matches(agg):
    indptr, src, x, _, _ = CASES["powerlaw"]
    n = indptr.shape[0] - 1
    g = make_graph(indptr, src, num_src=n, num_dst=n, device="cpu")
    jg = jmake_graph(indptr, src, num_src=n, num_dst=n)
    np.testing.assert_allclose(spmm(g, torch.from_numpy(x), agg=agg).numpy(),
                               np.asarray(jspmm(jg, jnp.asarray(x), agg=agg)),
                               atol=1e-5)


@pytest.mark.parametrize("dtype,threshold", [
    (torch.float32, kernel_gates.F32_THRESHOLD),
    (torch.bfloat16, kernel_gates.BF16_THRESHOLDS)])
def test_kernel_gates_harness_on_cpu(dtype, threshold):
    errs = kernel_gates.run_kernel_gates(dtype, device="cpu")
    assert len(errs) == 15
    ok, worst = kernel_gates.gate(errs, threshold)
    assert ok, worst


@pytest.mark.parametrize("dtype,threshold", [
    (torch.float32, kernel_gates.F32_THRESHOLD),
    (torch.bfloat16, kernel_gates.BF16_THRESHOLDS)])
def test_spmm_mode_gates_harness_on_cpu(dtype, threshold):
    errs = kernel_gates.run_spmm_mode_gates(dtype, device="cpu")
    assert len(errs) == 4
    ok, worst = kernel_gates.gate(errs, threshold)
    assert ok, worst


def test_kernel_gate_limits_per_kernel():
    errs = {"a/spmm_blocked_cuda": 8e-4, "a/attend_blocked_cuda": 3e-2}
    ok, worst = kernel_gates.gate(errs, kernel_gates.BF16_THRESHOLDS)
    assert ok and worst.startswith("a/spmm_blocked_cuda")
    errs["b/spmm_hot_split"] = 2e-3
    ok, worst = kernel_gates.gate(errs, kernel_gates.BF16_THRESHOLDS)
    assert not ok and worst.startswith("b/spmm_hot_split")
