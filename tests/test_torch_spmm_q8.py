"""The int8 blocked SpMM of the torch port against the JAX package.

``quantize_rows`` must give bit-equal ``q`` and ``scale`` (both round half
to even).  The plain ``spmm_blocked_q8`` (B11's plain version, and its
wrapper on CPU tensors) against ``spmm_blocked_pallas_q8`` run with
``interpret=True`` as ``tests/test_models_train.py`` runs it: each term is
``q * bf16(scale[src])`` on both sides, exact in float32, so only the
summation order differs and float32's 2e-4 holds.  Against the float32
SpMM of the unquantised rows the limit is the JAX test's quantisation
limit, 2e-2 of the largest value.  The cases: the testbed at the JAX
test's W=64, C=256, the three layout edge cases and the hub row of 1,000
lanes over several chunks.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tch_geometric_tpu.ops import spmm_pallas as jsp
from tch_geometric_tpu_torch.ops import spmm_kernels as tsk
from tch_geometric_tpu_torch.utils import kernel_gates

jsb = importlib.import_module("tch_geometric_tpu.ops.spmm_blocked")
tsb = importlib.import_module("tch_geometric_tpu_torch.ops.spmm_blocked")

F32_TOL = 2e-4


def _testbed():
    ip, src, x = kernel_gates.build_testbed(n=512, e=4096, f=32)
    return ("testbed", ip, src, x, 64, 256)    # the JAX test's W and C


CASES = {c[0]: c for c in [_testbed()] + list(kernel_gates.edge_case_graphs())
         + [kernel_gates.hub_row_graph()]}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    name, indptr, src, x, W, C = CASES[request.param]
    b_t = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                            device="cpu")
    b_j = jsb.build_blocked(indptr, src.astype(np.int32), rows_per_block=W,
                            chunk_edges=C)
    return dict(name=name, indptr=indptr, b_t=b_t, b_j=b_j, x=x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_equal(dtype):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(300, 37)) * rng.uniform(0.01, 50, (300, 1)))
    x[7] = 0.0                              # an all-zero row: scale 0
    x[11, :4] = [0.5, 1.5, 2.5, -0.5]       # exact halves after the divide
    x[11, 4] = 127.0
    x = x.astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = jsp.quantize_rows(jx)
    qt, st = tsk.quantize_rows(tx)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("agg", ["sum", "mean"])
def test_spmm_q8_matches_pallas(case, agg):
    q, s = jsp.quantize_rows(jnp.asarray(case["x"]))
    ref = np.asarray(jsp.spmm_blocked_pallas_q8(case["b_j"], q, s, agg=agg,
                                                interpret=True))
    out = tsk.spmm_blocked_q8(case["b_t"], torch.from_numpy(np.array(q)),
                              torch.from_numpy(np.array(s)),
                              agg=agg).numpy()
    n = len(case["indptr"]) - 1
    assert out.shape == ref.shape == (n, case["x"].shape[1])
    np.testing.assert_allclose(out, ref, rtol=F32_TOL, atol=F32_TOL)


def test_spmm_q8_quantisation_error(case):
    """Against the float32 SpMM of the unquantised rows, within the JAX
    test's limit of 2e-2 of the largest value."""
    x = torch.from_numpy(case["x"])
    q, s = tsk.quantize_rows(x)
    got = tsk.spmm_blocked_q8(case["b_t"], q, s, agg="sum")
    want = tsb.spmm_blocked(case["b_t"], x, agg="sum",
                            compute_dtype=torch.float32)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < kernel_gates.Q8_REL_THRESHOLD, rel


def test_q8_cuda_wrapper_runs_plain_on_cpu():
    """On CPU tensors the wrapper returns the plain result and launches
    nothing."""
    _, indptr, src, x, W, C = CASES["ragged_rows"]
    b = tsb.build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                          device="cpu")
    q, s = tsk.quantize_rows(torch.from_numpy(x))
    before = tsk.spmm_blocked_q8_cuda.launches
    for agg in ("sum", "mean"):
        torch.testing.assert_close(
            tsk.spmm_blocked_q8_cuda(b, q, s, agg=agg),
            tsk.spmm_blocked_q8(b, q, s, agg=agg), rtol=0, atol=0)
    assert tsk.spmm_blocked_q8_cuda.launches == before


@pytest.mark.parametrize("dtype,threshold", [
    (torch.float32, kernel_gates.F32_THRESHOLD),
    (torch.bfloat16, kernel_gates.BF16_THRESHOLDS)])
def test_q8_gates_harness_on_cpu(dtype, threshold):
    errs = kernel_gates.run_q8_gates(dtype, device="cpu")
    assert len(errs) == 9 * 2
    assert all(k.endswith("/spmm_blocked_q8_cuda") for k in errs)
    ok, worst = kernel_gates.gate(errs, threshold)
    assert ok, worst
