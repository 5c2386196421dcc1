"""Blocked attention and segment softmax of the torch port against the JAX
package.

The port's plain ``gat_attend_blocked_packed`` (and its B3 wrapper, which
runs the plain version on CPU tensors) against the JAX head-packed GAT
kernel run with ``interpret=True``: both modes (alpha_src table and the
in-kernel GATv1 projection), in float32 at 2e-4 (the JAX package's own
tolerance for this kernel) and bfloat16 at 1e-4.  The bfloat16 limit: both
sides round at the same points (h, each lane's weight ``e`` and the term
``h * e`` to bfloat16, every sum in float32), and on these inputs they read
at most 9.5e-7 apart (N(0, 1) rows, results up to 3.0).  A term would round
the other way only where the JAX kernel's chunk max, which includes the pad
lanes, differs from the port's, which does not; that would read up to about
1e-2 and does not happen at these seeds.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.ops import attention_blocked as jab
from tch_geometric_tpu.ops.segment import segment_max as jseg_max
from tch_geometric_tpu.ops.segment import segment_softmax as jseg_softmax
from tch_geometric_tpu_torch.ops import attention_blocked as tab
from tch_geometric_tpu_torch.ops.segment import segment_max, segment_softmax
from tch_geometric_tpu_torch.utils import kernel_gates

jsb = importlib.import_module("tch_geometric_tpu.ops.spmm_blocked")
tsb = importlib.import_module("tch_geometric_tpu_torch.ops.spmm_blocked")

F32_TOL = 2e-4
BF16_TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _graph(seed, n=512, e=4096, empty_rows=False):
    rng = np.random.default_rng(seed)
    if empty_rows:
        # every 7th row of the first half has edges: whole blocks are empty
        deg = np.zeros(n, np.int64)
        deg[: n // 2: 7] = rng.integers(1, 40, len(deg[: n // 2: 7]))
        indptr = np.concatenate([[0], np.cumsum(deg)])
        src = rng.integers(0, n, int(indptr[-1]))
    else:
        dst = np.sort(rng.integers(0, n, e))
        src = rng.integers(0, n, e)
        indptr = np.searchsorted(dst, np.arange(n + 1))
    return rng, indptr, src


def _inputs(rng, n, heads, d):
    h = rng.normal(size=(n, heads, d)).astype(np.float32)
    a_s = rng.normal(size=(n, heads)).astype(np.float32)
    a_d = rng.normal(size=(n, heads)).astype(np.float32)
    vec = (rng.normal(size=(heads, d)) / np.sqrt(d)).astype(np.float32)
    return h, a_s, a_d, vec


def _both(b_t, b_j, h, a_s, a_d, vec, mode, jdt, tdt):
    """(port, JAX) outputs of the head-packed GAT in ``mode``."""
    if mode == "table":
        ta, ja, tv, jv = torch.from_numpy(a_s), jnp.asarray(a_s), None, None
    else:
        ta, ja, tv, jv = None, None, torch.from_numpy(vec), jnp.asarray(vec)
    before = tab.gat_attend_blocked_packed_cuda.launches
    out = tab.gat_attend_blocked_packed_cuda(
        b_t, torch.from_numpy(h), ta, torch.from_numpy(a_d),
        alpha_src_vec=tv, compute_dtype=tdt).numpy()
    assert tab.gat_attend_blocked_packed_cuda.launches == before  # CPU
    ref = np.asarray(jab.gat_attend_blocked_packed(
        b_j, jnp.asarray(h), ja, jnp.asarray(a_d), alpha_src_vec=jv,
        compute_dtype=jdt, interpret=True))
    return out, ref


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["table", "vec"])
def test_plain_packed_gat_matches_pallas(mode, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    rng, indptr, src = _graph(5)
    n = indptr.shape[0] - 1
    kw = dict(rows_per_block=128)
    b_t = tsb.build_blocked(indptr, src, device="cpu", **kw)
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), **kw)
    h, a_s, a_d, vec = _inputs(rng, n, 4, 32)
    out, ref = _both(b_t, b_j, h, a_s, a_d, vec, mode, jdt, tdt)
    assert out.shape == ref.shape == (n, 4, 32)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["table", "vec"])
def test_packed_gat_empty_rows_and_odd_width(mode):
    """Rows and whole blocks with no edges read 0; one head of 47 columns
    (GAT's last layer at ogbn-products width) matches too."""
    rng, indptr, src = _graph(7, n=1024, empty_rows=True)
    n = indptr.shape[0] - 1
    kw = dict(rows_per_block=128, chunk_edges=128)
    b_t = tsb.build_blocked(indptr, src, device="cpu", **kw)
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), **kw)
    for heads, d in ((4, 32), (1, 47)):
        h, a_s, a_d, vec = _inputs(rng, n, heads, d)
        out, ref = _both(b_t, b_j, h, a_s, a_d, vec, mode, jnp.float32,
                         torch.float32)
        np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)
        empty = np.diff(indptr) == 0
        assert empty.sum() > n // 2
        assert not out[empty].any()


def test_packed_gat_argument_checks():
    _, indptr, src = _graph(1, n=256, e=1024)
    b = tsb.build_blocked(indptr, src, rows_per_block=128, device="cpu")
    h = torch.zeros((256, 2, 8))
    a = torch.zeros((256, 2))
    vec = torch.zeros((2, 8))
    for fn in (tab.gat_attend_blocked_packed,
               tab.gat_attend_blocked_packed_cuda):
        with pytest.raises(ValueError):
            fn(b, h, a, a, alpha_src_vec=vec)
        with pytest.raises(ValueError):
            fn(b, h, None, a)
    b64 = tsb.build_blocked(indptr, src, rows_per_block=64, device="cpu")
    with pytest.raises(ValueError):
        tab.gat_attend_blocked_packed(b64, h, a, a)


def test_packed_gat_plain_grouping(monkeypatch):
    """The plain version splits a large graph into block groups; a tiny
    group budget gives the same result as one group."""
    rng, indptr, src = _graph(3, n=1024, e=20000)
    b = tsb.build_blocked(indptr, src, rows_per_block=128, chunk_edges=256,
                          device="cpu")
    h, a_s, a_d, vec = (torch.from_numpy(v)
                        for v in _inputs(rng, 1024, 2, 16))
    kw = dict(alpha_src_vec=vec, compute_dtype=torch.float32)
    whole = tab.gat_attend_blocked_packed(b, h, None, a_d, **kw)
    monkeypatch.setattr(tab, "PLAIN_GROUP_LANES", 3 * 256)
    assert len(tsb._block_groups(b.block_start.tolist(), 3)) > 1
    np.testing.assert_allclose(
        tab.gat_attend_blocked_packed(b, h, None, a_d, **kw).numpy(),
        whole.numpy(), rtol=1e-5, atol=1e-6)


def test_blocked_logit_helpers_exact():
    rng, indptr, src = _graph(4)
    n = indptr.shape[0] - 1
    b_t = tsb.build_blocked(indptr, src, rows_per_block=128, device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=128)
    np.testing.assert_array_equal(tab.blocked_dst_rows(b_t).numpy(),
                                  np.asarray(jab.blocked_dst_rows(b_j)))
    a_s = rng.normal(size=n).astype(np.float32)
    a_d = rng.normal(size=n).astype(np.float32)
    np.testing.assert_array_equal(
        tab.gat_edge_logits_blocked(b_t, torch.from_numpy(a_s),
                                    torch.from_numpy(a_d)).numpy(),
        np.asarray(jab.gat_edge_logits_blocked(b_j, jnp.asarray(a_s),
                                               jnp.asarray(a_d))))
    x = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        tab._pad_dst(b_t, x).numpy(),
        np.asarray(jab._pad_dst(b_j, jnp.asarray(x.numpy()))))


@pytest.mark.parametrize("heads", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(heads, masked):
    rng = np.random.default_rng(11)
    e, nseg = 300, 40
    ids = np.sort(rng.integers(0, nseg, e))
    ids[ids == 7] = 8                        # segment 7 has no entries
    shape = (e,) if heads is None else (e, heads)
    scores = (rng.normal(size=shape) * 3).astype(np.float32)
    mask = rng.random(e) < 0.7 if masked else None
    mask_t = None if mask is None else torch.from_numpy(mask)
    mask_j = None if mask is None else jnp.asarray(mask)
    out = segment_softmax(torch.from_numpy(scores), torch.from_numpy(ids),
                          nseg, mask=mask_t).numpy()
    ref = np.asarray(jseg_softmax(jnp.asarray(scores), jnp.asarray(ids),
                                  nseg, mask=mask_j))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        segment_max(torch.from_numpy(scores), torch.from_numpy(ids),
                    nseg).numpy(),
        np.asarray(jseg_max(jnp.asarray(scores), jnp.asarray(ids), nseg)))


@pytest.mark.parametrize("dtype,threshold", [
    (torch.float32, kernel_gates.F32_THRESHOLD),
    (torch.bfloat16, kernel_gates.BF16_THRESHOLDS)])
def test_gat_gates_harness_on_cpu(dtype, threshold):
    errs = kernel_gates.run_gat_gates(dtype, device="cpu")
    assert len(errs) == 24
    assert all(k.endswith(("/gat_attend_blocked_packed_cuda",
                           "/" + kernel_gates.WIDE_VEC_B3)) for k in errs)
    ok, worst = kernel_gates.gate(errs, threshold)
    assert ok, worst


def test_gat_testbed_is_the_jax_gates_testbed():
    from tch_geometric_tpu.utils.kernel_gates import _build_testbed
    indptr, src, _, _, h, a_s, a_d = _build_testbed()
    ours = kernel_gates.build_gat_testbed()
    for a, b in zip((indptr, src, h, a_s, a_d), ours[:5]):
        np.testing.assert_array_equal(a, b)
