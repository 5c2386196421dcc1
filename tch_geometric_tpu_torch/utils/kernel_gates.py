"""Numerical gates for the port's CUDA kernels.

Mirror of ``tch_geometric_tpu/utils/kernel_gates.py`` for the kernels ported
so far: B1 (``spmm_blocked_cuda``, alone and as the cold half of the hot
split) and B2 (``spmm_blocked_weighted_cuda``, alone and as the hot half).
Each kernel runs on the given device and is compared with its plain version
(``spmm_blocked``) on the same inputs, computed on the same device.  On a
CPU device both sides are the plain version; the gates matter on the card.

Layouts: the power-law testbed of the JAX gates (n=4096, e=65536, F=128,
W=256) and three edge cases — rows (and whole blocks) with no edges, one
block spanning many chunks, and ``num_rows % W != 0``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Tuple, Union

import numpy as np
import torch

# Thresholds.  In float32 a kernel differs from the plain version only by
# summation order.  In bfloat16 both sides round the same gathered rows, so
# B1 and the hot split (integer multiplicities, exact in bfloat16) again
# differ only by summation order; B2 multiplies its float32 weight in
# float32 while the plain version rounds it to bfloat16 first (2**-9
# relative), which with U(0, 1) weights over ~16 mean-degree rows of N(0, 1)
# features reaches about 2e-2.  Each limit sits well above the card's reading
# and well below the values compared (PERF.md, PR 1).
F32_THRESHOLD = 5e-4
BF16_THRESHOLDS = {"spmm_blocked_cuda": 1e-3, "spmm_hot_split": 1e-3,
                   "spmm_blocked_weighted_cuda": 5e-2}
# Whole bfloat16 forwards (logits of a 3-layer SAGE): blocked against hot
# split, and blocked against the plain forward.
FORWARD_BF16_THRESHOLD = 1e-2


def build_testbed(n: int = 4096, e: int = 65536, f: int = 128,
                  seed: int = 0):
    """Power-law sources, uniform sorted destinations: ``(indptr, src, x)``
    (the JAX gates' testbed)."""
    rng = np.random.default_rng(seed)
    pop = (1.0 / (np.arange(n) + 10.0)) ** 0.8
    pop /= pop.sum()
    src = rng.choice(n, size=e, p=pop).astype(np.int64)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int64)
    indptr = np.searchsorted(dst, np.arange(n + 1)).astype(np.int64)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return indptr, src, x


def edge_case_graphs(f: int = 32, seed: int = 1
                     ) -> Iterator[Tuple[str, np.ndarray, np.ndarray,
                                         np.ndarray, int, int]]:
    """``(name, indptr, src, x, rows_per_block, chunk_edges)`` for the
    three layout edge cases."""
    rng = np.random.default_rng(seed)

    # rows with no edges: only every 7th row of the first half has edges,
    # so whole blocks of the second half are pad chunks only
    n = 1024
    deg = np.zeros(n, np.int64)
    deg[: n // 2: 7] = rng.integers(1, 9, len(deg[: n // 2: 7]))
    indptr = np.concatenate([[0], np.cumsum(deg)])
    src = rng.integers(0, n, int(indptr[-1]))
    yield ("empty_rows", indptr, src,
           rng.normal(size=(n, f)).astype(np.float32), 128, 128)

    # one block spanning many chunks: block 0 holds 40 chunks of 128 lanes
    n = 512
    deg = np.ones(n, np.int64)
    deg[:128] = 40
    indptr = np.concatenate([[0], np.cumsum(deg)])
    src = rng.integers(0, n, int(indptr[-1]))
    yield ("many_chunks", indptr, src,
           rng.normal(size=(n, f)).astype(np.float32), 128, 128)

    # num_rows % W != 0, odd feature width
    n = 1000
    dst = np.sort(rng.integers(0, n, 9000))
    indptr = np.searchsorted(dst, np.arange(n + 1))
    src = rng.integers(0, n, 9000)
    yield ("ragged_rows", indptr, src,
           rng.normal(size=(n, f + 5)).astype(np.float32), 256, None)


def _maxerr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


@contextlib.contextmanager
def _strict_f32():
    """Full-float32 matmuls in the plain version (no TF32)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def run_kernel_gates(compute_dtype=torch.float32, device="cuda"
                     ) -> Dict[str, float]:
    """``{case/kernel: max_abs_err}`` of each kernel against its plain
    version on ``device``."""
    from ..ops.attention_blocked import spmm_blocked_weighted_cuda
    from ..ops.spmm_blocked import (build_blocked, build_blocked_hot,
                                    spmm_blocked)
    from ..ops.spmm_kernels import spmm_blocked_cuda, spmm_hot_split

    indptr, src, x_np = build_testbed()
    cases = [("testbed", indptr, src, x_np, 256, None)]
    cases += list(edge_case_graphs())
    errs: Dict[str, float] = {}
    cd = compute_dtype
    with _strict_f32():
        for name, indptr, src, x_np, W, C in cases:
            x = torch.from_numpy(x_np).to(device)
            b = build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                              device=device)
            hs = build_blocked_hot(indptr, src, hot_k=256, rows_per_block=W,
                                   chunk_edges=C, device=device)
            gen = torch.Generator().manual_seed(0)
            w = torch.rand(b.edge_src.shape, generator=gen).to(device)
            ref = spmm_blocked(b, x, agg="mean", compute_dtype=cd)
            errs[f"{name}/spmm_blocked_cuda"] = _maxerr(
                spmm_blocked_cuda(b, x, agg="mean", compute_dtype=cd), ref)
            errs[f"{name}/spmm_blocked_weighted_cuda"] = _maxerr(
                spmm_blocked_weighted_cuda(b, x, w, compute_dtype=cd),
                spmm_blocked(b, x, edge_weight=w, compute_dtype=cd))
            errs[f"{name}/spmm_hot_split"] = _maxerr(
                spmm_hot_split(hs, x, agg="mean", compute_dtype=cd), ref)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs


def gate(errs: Dict[str, float], threshold: Union[float, Dict[str, float]]
         ) -> Tuple[bool, str]:
    """(all_pass, worst_description).  ``threshold`` is one limit for every
    ``case/kernel`` entry or a ``{kernel: limit}`` dict; the worst entry is
    the one nearest its limit."""
    def limit(k: str) -> float:
        if isinstance(threshold, dict):
            return threshold[k.rsplit("/", 1)[-1]]
        return threshold
    worst = max(errs, key=lambda k: errs[k] / limit(k))
    ok = all(v <= limit(k) for k, v in errs.items())
    return ok, f"{worst}={errs[worst]:.2e} (limit {limit(worst):g})"
