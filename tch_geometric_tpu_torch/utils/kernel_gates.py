"""Numerical gates for the port's CUDA kernels.

Mirror of ``tch_geometric_tpu/utils/kernel_gates.py`` for every kernel of
the port: B1 (``spmm_blocked_cuda``, alone and as the cold half of the hot
split), B2 (``spmm_blocked_weighted_cuda``, alone and as the hot half) —
:func:`run_kernel_gates` — B3 (``gat_attend_blocked_packed_cuda``) —
:func:`run_gat_gates` — B7 (``edge_softmax_blocked_multihead_cuda``), B8
(``spmm_blocked_multiweighted_cuda``), the composed
``gat_attend_blocked_cuda`` (B7, B8) and B9
(``gat_attend_blocked_flash_cuda``) — :func:`run_gat_route_gates` — the
single-head attention kernels B5 (``sddmm_blocked_cuda``), B6
(``edge_softmax_blocked_cuda``), B10 (``attend_blocked_fused_cuda``), B4
(``attend_blocked_flash_cuda``, both stat modes) and the composed
``attend_blocked_cuda`` (B5, B6, B8) — :func:`run_attend_gates` — and B11
(``spmm_blocked_q8_cuda``, sum and mean) — :func:`run_q8_gates` — and B5
and B4 again on the cases that reach their row-grouped kernels' other
paths — :func:`run_attend_mode_gates` — B10 and B8 likewise —
:func:`run_weighted_mode_gates` — and B3 and B9 likewise —
:func:`run_gat_mode_gates`.  Each
kernel runs on the given device and is compared with its plain version
(``spmm_blocked``, ``gat_attend_blocked_packed``, ``sddmm_blocked``, ...)
on the same inputs, computed on the same device.  On a CPU device both sides are the plain
version; the gates matter on the card.

Layouts: the power-law testbed of the JAX gates (n=4096, e=65536, F=128 or
H=4 heads of D=32, W=256) and three edge cases — rows (and whole blocks)
with no edges, one block spanning many chunks, and ``num_rows % W != 0``;
the SpMM gates (B1, B2, the hot split) also a hub row of 1,000 in-edges
(:func:`hub_row_graph`), and :func:`run_spmm_mode_gates` holds B1 and B2
in their multi-pass mode (chunks wider than the kernel's stage);
the GAT kernels B3, B7, B8 and B9 also run one head of D=47 on the testbed
(GAT's last layer at ogbn-products width, an odd row width); the ragged
case's rows are 37 columns wide.  B7 runs both its entries (scores in, and
the GAT logits computed from the (N, H) tables), and B11 also the hub row,
the multi-pass layout, the JAX test's W=64, C=256 and rows of 100 columns
(:func:`run_q8_gates`).
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
# features reaches about 2e-2, and over the hub row's 1,000 lanes about
# 6e-2, so the bfloat16 SpMM gates draw weights that bfloat16 holds exactly
# and B2 too differs only by summation order (the float32 gates keep U(0, 1)
# float32 weights, which hold B2's float32 product; :func:`_lane_weights`).
# B1's, B2's and B11's summation order changes from run to run:
# shared-memory atomics order each row's lanes and global atomics add a row
# split over several pieces (csrc/spmm_blocked.cu).  B3 rounds at the
# same points as its plain version (h, each lane's weight and their
# product in bfloat16, every sum in float32), each weight against the same
# chunk max, which a pre-pass takes before any row is read, so it differs
# by summation order and the rare term whose rounding flips.  B4 rounds
# each lane's
# weight bf16(e) against its piece's running max (a piece: at most 32 lanes
# of one row in one chunk; the max moves once per batch of rows in flight,
# or is the piece's max for rows wider than 256 columns), where the plain
# version rounds it against the row's running max after each chunk (row
# stats) or the chunk's max (chunk-max stats): the same weight in exact
# arithmetic, but any term's bfloat16 rounding can fall the other way, 2**-9
# of the term.  B5's products of bfloat16 rows are exact in float32, so
# in bfloat16 too it differs only by summation order (1.5e-5 on scores up
# to about 60 on the card); B6 and B7 are float32 throughout (2.4e-7 and
# 1.8e-7; B7 sums each row's z per piece of 32 lanes in registers and
# merges the pieces, and computes the same f32 logits as
# gat_edge_logits_blocked when it takes the tables).  B8 rounds each term bf16(x * w) from the same float32 weight as
# its plain version, so the terms match bit for bit and only the sums'
# order differs (the kernel rounds the float32 product on its own, never
# fused into its add); B11's int8 rows times a bfloat16 scale are exact in
# float32, likewise.  B9 takes the exact per-row running max (a pre-pass
# takes the max of each chunk's first and last row, the only rows that span
# chunks, before any row is read), so the kernel's
# expf and torch's exp on the card see the same float32 arguments and
# bf16(e) matches too; a B9 or B8 that rounded at another point would be
# off by up to 2**-9 of a term, about 6e-3 at |h| near 3, and fails the
# 1e-5 limit.  The composed attend and GAT routes and the fused and flash
# attend routes round at their plain versions' points, but a weight from
# B6's atomically summed z, B7's z summed by pieces, or B10's or B4's
# (chunk max) stats, lies an ulp or so from the plain version's and can
# round its bfloat16 term (bf16(x * w) or bf16(e)) the other way: one
# bfloat16 ulp of the heaviest term, at most 2**-5 for |x| < 8.  On these
# gates an NVIDIA H100 80GB HBM3 at 700 W read up to 3.9e-3 (fused: B10 on
# its row-grouped kernels, the testbed and the short x_dst), 2.0e-3
# (composed attend), 3.9e-3 (composed GAT, B7 summing z by pieces in
# registers: no tighter than with its former shared atomics), 1.4e-2
# (flash, chunk max), 3.6e-3 (flash, row max), 6.0e-8 (B8, also at H=4
# heads of 36 columns, over the hub row and in chunks of 8,192 lanes),
# 7.2e-7 (B3 and B9 on one CUDA block per chunk for all heads, also over
# the hub row, in chunks of 8,192 lanes, at H=4 heads of 80 and 36
# columns and on far logits), 1.8e-7 (B7, both entries, also over the hub
# row and in chunks of 8,192 lanes) and 0 (B11 on rows_kernel, every
# case) in bfloat16, and at most 8.8e-6 in float32 (B10 and B4 on the far
# scores); at ogbn-products size 7.8e-3 (composed GAT, fused), 2.4e-7 (B8) and 9.5e-7 (B9) on outputs
# up to 3.2 (PERF.md, Findings).  Each limit sits well above the card's
# reading and well below the values compared.
F32_THRESHOLD = 5e-4
BF16_THRESHOLDS = {"spmm_blocked_cuda": 1e-3, "spmm_hot_split": 1e-3,
                   "spmm_blocked_weighted_cuda": 1e-3,
                   "gat_attend_blocked_packed_cuda": 1e-3,
                   "sddmm_blocked_cuda": 1e-3,
                   "edge_softmax_blocked_cuda": 1e-5,
                   "attend_blocked_cuda": 5e-2,
                   "attend_blocked_fused_cuda": 5e-2,
                   "attend_blocked_flash_cuda": 5e-2,
                   "edge_softmax_blocked_multihead_cuda": 1e-5,
                   "spmm_blocked_multiweighted_cuda": 1e-5,
                   "gat_attend_blocked_cuda": 5e-2,
                   "gat_attend_blocked_flash_cuda": 1e-5,
                   "spmm_blocked_q8_cuda": 1e-3}
# B5's scores at full width reach a few hundred (a self loop at F=256 is
# |x|^2); there kernel and plain, float32 sums of exact products in another
# order, are held to this fraction of the largest score, in both dtypes.
SDDMM_REL_THRESHOLD = 1e-5
# B11 against B1 on the unquantised float32 rows, as a fraction of the
# largest value: the JAX package's quantisation limit (its test of
# spmm_blocked_pallas_q8).
Q8_REL_THRESHOLD = 2e-2
# Whole bfloat16 forwards (logits of a 3-layer SAGE): blocked against hot
# split, and blocked against the plain forward.
FORWARD_BF16_THRESHOLD = 1e-2


def build_testbed(n: int = 4096, e: int = 65536, f: int = 128,
                  seed: int = 0):
    """Power-law sources, uniform sorted destinations: ``(indptr, src, x)``
    (the JAX gates' testbed)."""
    rng = np.random.default_rng(seed)
    indptr, src = _powerlaw_graph(rng, n, e)
    return indptr, src, rng.normal(size=(n, f)).astype(np.float32)


def _powerlaw_graph(rng, n: int, e: int):
    pop = (1.0 / (np.arange(n) + 10.0)) ** 0.8
    pop /= pop.sum()
    src = rng.choice(n, size=e, p=pop).astype(np.int64)
    dst = np.sort(rng.integers(0, n, e)).astype(np.int64)
    return np.searchsorted(dst, np.arange(n + 1)).astype(np.int64), src


def build_gat_testbed(n: int = 4096, e: int = 65536, heads: int = 4,
                      d: int = 32, seed: int = 0):
    """``(indptr, src, h (n, heads, d), alpha_src (n, heads), alpha_dst,
    vec (heads, d))``: the JAX gates' GAT testbed (the same draws), and a
    GATv1 projection vector scaled so its logits are N(0, 1)."""
    rng = np.random.default_rng(seed)
    indptr, src = _powerlaw_graph(rng, n, e)
    rng.normal(size=(n, 128))                       # the JAX testbed's x
    return (indptr, src) + _gat_inputs(rng, n, heads, d)


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


def hub_row_graph(f: int = 32, seed: int = 2
                  ) -> Tuple[str, np.ndarray, np.ndarray, np.ndarray, int,
                             int]:
    """``(name, indptr, src, x, rows_per_block, chunk_edges)`` of the hub-row
    case of the SpMM gates: row 70 has 1,000 in-edges, every other row 0-3,
    at W = C = 128, so the hub row fills several whole chunks and B1/B2 cut
    it into many pieces.  The rows are ``f + 2`` wide, 2 mod 4 for the
    default ``f``, so B1 and B2 take their 8-byte (float32) and 4-byte
    (bfloat16) loads and float2 reductions."""
    rng = np.random.default_rng(seed)
    n = 512
    deg = rng.integers(0, 4, n)
    deg[70] = 1000
    indptr = np.concatenate([[0], np.cumsum(deg)])
    src = rng.integers(0, n, int(indptr[-1]))
    return ("hub_row", indptr, src,
            rng.normal(size=(n, f + 2)).astype(np.float32), 128, 128)


def far_scores_case(f: int = 32, seed: int = 3):
    """``(name, indptr, src, x_dst, x_src, rows_per_block, chunk_edges,
    far_rows)`` of the "far scores" case of the attention gates: the
    many-chunks layout (rows 0-127 of 40 in-edges each fill block 0's 40
    chunks of 128 lanes, every other row has one; W = C = 128), with
    ``x_src``'s column 0 set to 1 and ``x_dst``'s column 0 set to
    ``150 * sqrt(f)`` on rows 16-18, whose lanes all lie in chunk 5.  Their
    scaled scores (``1/sqrt(f)``) sit near 150, every other lane's near 0:
    with chunk-max stats (``row_stats=False``) each other row of block 0
    weighs its lanes by ``exp(s - 150)``, which is 0 in float32, and reads
    0 (row 19, which shares chunk 5, through its chunk's max, the rest
    through the block's), while with row stats every row keeps its
    softmax."""
    rng = np.random.default_rng(seed)
    n = 512
    deg = np.ones(n, np.int64)
    deg[:128] = 40
    indptr = np.concatenate([[0], np.cumsum(deg)])
    src = rng.integers(0, n, int(indptr[-1]))
    x_src = rng.normal(size=(n, f)).astype(np.float32)
    x_src[:, 0] = 1.0
    x_dst = rng.normal(size=(n, f)).astype(np.float32)
    far = np.array([16, 17, 18])
    x_dst[far, 0] = 150.0 * np.sqrt(f)
    return ("far_scores", indptr, src, x_dst, x_src, 128, 128, far)


def far_logits_case(heads: int = 4, d: int = 32, seed: int = 4):
    """``(name, indptr, src, rows_per_block, chunk_edges, (h, alpha_src,
    alpha_dst, vec), far_rows)`` of the "far logits" case of the GAT gates:
    the layout of :func:`far_scores_case` (rows 0-127 of 40 in-edges each
    fill block 0's 40 chunks of 128 lanes, W = C = 128) with ``alpha_dst``
    set to 150 on rows 16-18, whose lanes all lie in chunk 5.  Their logits
    sit near 150, every other lane's near 0: B3 (a chunk-max shift) weighs
    every other row of block 0 by ``exp(M_chunk - M_block)`` or, for row 19
    which shares chunk 5, by ``exp(s - 150)``, both 0 in float32, so they
    read 0; B9 (a per-row running max) keeps every row's softmax."""
    rng = np.random.default_rng(seed)
    n = 512
    deg = np.ones(n, np.int64)
    deg[:128] = 40
    indptr = np.concatenate([[0], np.cumsum(deg)])
    src = rng.integers(0, n, int(indptr[-1]))
    h, a_s, a_d, vec = _gat_inputs(rng, n, heads, d)
    far = np.array([16, 17, 18])
    a_d[far] = 150.0
    return ("far_logits", indptr, src, 128, 128, (h, a_s, a_d, vec), far)


def _lane_weights(b, compute_dtype) -> torch.Tensor:
    """U(0, 1) float32 weights of the lanes of ``b``, seeded; for bfloat16
    gates rounded to values that bfloat16 holds exactly."""
    gen = torch.Generator().manual_seed(0)
    w = torch.rand(b.edge_src.shape, generator=gen)
    if compute_dtype == torch.bfloat16:
        w = w.to(torch.bfloat16).float()
    return w.to(b.edge_src.device)


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
    cases += list(edge_case_graphs()) + [hub_row_graph()]
    errs: Dict[str, float] = {}
    cd = compute_dtype
    with _strict_f32():
        for name, indptr, src, x_np, W, C in cases:
            x = torch.from_numpy(x_np).to(device)
            b = build_blocked(indptr, src, rows_per_block=W, chunk_edges=C,
                              device=device)
            hs = build_blocked_hot(indptr, src, hot_k=256, rows_per_block=W,
                                   chunk_edges=C, device=device)
            w = _lane_weights(b, cd)
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


def run_spmm_mode_gates(compute_dtype=torch.float32, device="cuda"
                        ) -> Dict[str, float]:
    """``{case[C=8192]/kernel: max_abs_err}`` of B1 and B2 against their
    plain version on the testbed and the hub-row case laid out in chunks of
    8,192 lanes: wider than the lanes the kernel stages at once (4,096), so
    it zeroes the whole output, stages each chunk in passes and adds every
    piece (on the testbed a row's lanes fall in both passes)."""
    from ..ops.attention_blocked import spmm_blocked_weighted_cuda
    from ..ops.spmm_blocked import build_blocked, spmm_blocked
    from ..ops.spmm_kernels import spmm_blocked_cuda

    indptr, src, x_np = build_testbed()
    hub = hub_row_graph()
    cases = [("testbed", indptr, src, x_np, 256), hub[:5]]
    errs: Dict[str, float] = {}
    cd = compute_dtype
    with _strict_f32():
        for name, indptr, src, x_np, W in cases:
            x = torch.from_numpy(x_np).to(device)
            b = build_blocked(indptr, src, rows_per_block=W, chunk_edges=8192,
                              device=device)
            w = _lane_weights(b, cd)
            errs[f"{name}[C=8192]/spmm_blocked_cuda"] = _maxerr(
                spmm_blocked_cuda(b, x, agg="mean", compute_dtype=cd),
                spmm_blocked(b, x, agg="mean", compute_dtype=cd))
            errs[f"{name}[C=8192]/spmm_blocked_weighted_cuda"] = _maxerr(
                spmm_blocked_weighted_cuda(b, x, w, compute_dtype=cd),
                spmm_blocked(b, x, edge_weight=w, compute_dtype=cd))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs


def run_gat_gates(compute_dtype=torch.float32, device="cuda"
                  ) -> Dict[str, float]:
    """``{case[mode]/gat_attend_blocked_packed_cuda: max_abs_err}`` of B3
    against its plain version on ``device``, in both modes (``table``: an
    (N, H) alpha_src; ``vec``: the GATv1 projection GATConv uses)."""
    from ..ops.attention_blocked import (gat_attend_blocked_packed,
                                         gat_attend_blocked_packed_cuda)
    from ..ops.spmm_blocked import build_blocked

    errs: Dict[str, float] = {}
    with _strict_f32():
        for name, ip, s, W, C, arrays in _gat_cases():
            b = build_blocked(ip, s, rows_per_block=W, chunk_edges=C,
                              device=device)
            hh, asrc, adst, v = (torch.from_numpy(a).to(device)
                                 for a in arrays)
            for mode, table, vv in (("table", asrc, None), ("vec", None, v)):
                kw = dict(alpha_src_vec=vv, compute_dtype=compute_dtype)
                errs[f"{name}[{mode}]/gat_attend_blocked_packed_cuda"] = \
                    _maxerr(gat_attend_blocked_packed_cuda(b, hh, table,
                                                           adst, **kw),
                            gat_attend_blocked_packed(b, hh, table, adst,
                                                      **kw))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs


def _gat_cases():
    """``(name, indptr, src, rows_per_block, chunk_edges, (h, alpha_src,
    alpha_dst, vec))`` of the GAT gates: the testbed (H=4, D=32), the three
    edge cases and the testbed at one head of 47 columns."""
    indptr, src, h, a_s, a_d, vec = build_gat_testbed()
    cases = [("testbed", indptr, src, 256, None, (h, a_s, a_d, vec))]
    for name, ip, s, _, W, C in edge_case_graphs():
        r = np.random.default_rng(len(ip))
        cases.append((name, ip, s, W, C, _gat_inputs(r, len(ip) - 1, 4, 32)))
    r = np.random.default_rng(47)
    cases.append(("testbed_h1_d47", indptr, src, 256, None,
                  _gat_inputs(r, len(indptr) - 1, 1, 47)))
    return cases


def _gat_mode_cases():
    """``(name, indptr, src, rows_per_block, chunk_edges, (h, alpha_src,
    alpha_dst, vec))`` of :func:`run_gat_mode_gates`."""
    indptr, src, _ = build_testbed()
    n = len(indptr) - 1
    _, hub_ip, hub_src, _, hub_w, hub_c = hub_row_graph()

    def inputs(seed, nodes, heads, d):
        return _gat_inputs(np.random.default_rng(seed), nodes, heads, d)

    return [
        ("hub_row", hub_ip, hub_src, hub_w, hub_c,
         inputs(70, len(hub_ip) - 1, 4, 32)),
        ("testbed[C=8192]", indptr, src, 256, 8192, inputs(8192, n, 4, 32)),
        ("testbed_h4_d80", indptr, src, 256, None, inputs(80, n, 4, 80)),
        ("testbed_h4_d36", indptr, src, 256, None, inputs(36, n, 4, 36)),
        ("testbed_h1_d47", indptr, src, 256, None, inputs(47, n, 1, 47)),
        far_logits_case()[:6]]


def _stats_err(got, ref) -> float:
    """B9's ``debug_stats`` (undivided accumulator, m, z) against the plain
    version's: the largest of |m - m_ref| (infinite m must match, the rows
    with no edges) and the accumulator's and z's differences as fractions
    of their largest values."""
    _, acc, m, z = got
    _, acc_r, m_r, z_r = ref
    fin = torch.isfinite(m_r)
    if not torch.equal(fin, torch.isfinite(m)) or not torch.equal(
            m[~fin], m_r[~fin]):
        return float("inf")
    err = _maxerr(m[fin], m_r[fin]) if bool(fin.any()) else 0.0
    for a, r in ((acc, acc_r), (z, z_r)):
        err = max(err, _maxerr(a, r) / max(float(r.abs().max()), 1.0))
    return err


def run_gat_mode_gates(compute_dtype=torch.float32, device="cuda"
                       ) -> Dict[str, float]:
    """``{case/kernel: max_abs_err}`` of B3 (table and vec modes) and B9
    against their plain versions on ``device``, on the cases that reach the
    GAT kernels' other paths: the hub row of 1,000 lanes (split over pieces
    and chunks), the testbed in chunks of 8,192 lanes (more than the kernel
    stages at once, so every piece is a split one, and B9 takes its row
    maxima in a first sweep), H=4 heads of 80 columns (320, wider than one
    256-column register slab), of 36 (a bfloat16 vector of 8 would straddle
    two heads), one head of 47 and :func:`far_logits_case` (B3's chunk-max
    underflow).  On the hub row also B9's ``debug_stats`` (``_stats_err``:
    m exactly, the accumulator and z relative to their largest values).
    On the hub row and at C=8192 also B7's two entries (``_b7_errs``: a
    row over many chunks, and B7's two reads of a chunk of several
    passes)."""
    from ..ops import attention_blocked as ab
    from ..ops.spmm_blocked import build_blocked

    errs: Dict[str, float] = {}
    kw = dict(compute_dtype=compute_dtype)
    with _strict_f32():
        for name, ip, s, W, C, arrays in _gat_mode_cases():
            b = build_blocked(ip, s, rows_per_block=W, chunk_edges=C,
                              device=device)
            hh, asrc, adst, v = (torch.from_numpy(a).to(device)
                                 for a in arrays)
            for mode, table, vv in (("table", asrc, None), ("vec", None, v)):
                errs[f"{name}[{mode}]/gat_attend_blocked_packed_cuda"] = \
                    _maxerr(ab.gat_attend_blocked_packed_cuda(
                                b, hh, table, adst, alpha_src_vec=vv, **kw),
                            ab.gat_attend_blocked_packed(
                                b, hh, table, adst, alpha_src_vec=vv, **kw))
            errs[f"{name}/gat_attend_blocked_flash_cuda"] = _maxerr(
                ab.gat_attend_blocked_flash_cuda(b, hh, asrc, adst, **kw),
                ab.gat_attend_blocked_flash(b, hh, asrc, adst, **kw))
            if name in ("hub_row", "testbed[C=8192]"):
                errs.update(_b7_errs(b, asrc, adst, name))
            if name == "hub_row":
                errs[f"{name}[debug_stats]/gat_attend_blocked_flash_cuda"] = \
                    _stats_err(
                        ab.gat_attend_blocked_flash_cuda(
                            b, hh, asrc, adst, debug_stats=True, **kw),
                        ab.gat_attend_blocked_flash(
                            b, hh, asrc, adst, debug_stats=True, **kw))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs


def _b7_errs(b, asrc, adst, name: str) -> Dict[str, float]:
    """B7's two entries against their plain versions: entry (a) on the
    (H, T, C) logits of ``asrc``, ``adst`` with NaN in the pad lanes, entry
    (b) (``[logits]``) on the tables themselves."""
    from ..ops import attention_blocked as ab
    W = b.rows_per_block
    logits = ab.gat_edge_logits_blocked(b, asrc, adst).movedim(-1, 0)
    logits = torch.where(b.edge_local_row < W, logits, float("nan"))
    ref = ab.edge_softmax_blocked_multihead(b, logits)
    key = "edge_softmax_blocked_multihead_cuda"
    return {f"{name}/{key}": _maxerr(
                ab.edge_softmax_blocked_multihead_cuda(b, logits), ref),
            f"{name}[logits]/{key}": _maxerr(
                ab._gat_edge_softmax_blocked_cuda(b, asrc, adst), ref)}


def run_gat_route_gates(compute_dtype=torch.float32, device="cuda"
                        ) -> Dict[str, float]:
    """``{case/kernel: max_abs_err}`` of the composed and flash GAT routes'
    kernels against their plain versions on ``device``, on the GAT gates'
    cases: B7 on the (H, T, C) logits with NaN in the pad lanes (entry (a))
    and on the logit tables (entry (b), ``[logits]``), B8 on the rows and
    B7's weights, the composed ``gat_attend_blocked_cuda`` (B7's entry
    (b), B8) and B9."""
    from ..ops import attention_blocked as ab
    from ..ops.spmm_blocked import build_blocked

    errs: Dict[str, float] = {}
    kw = dict(compute_dtype=compute_dtype)
    with _strict_f32():
        for name, ip, s, W, C, arrays in _gat_cases():
            b = build_blocked(ip, s, rows_per_block=W, chunk_edges=C,
                              device=device)
            hh, asrc, adst = (torch.from_numpy(a).to(device)
                              for a in arrays[:3])
            N, H, D = hh.shape
            errs.update(_b7_errs(b, asrc, adst, name))
            if name == "ragged_rows":   # alpha_dst short of the rows: clamped
                errs.update(_b7_errs(b, asrc, adst[:-37], name + "[short_dst]"))
            logits = ab.gat_edge_logits_blocked(b, asrc, adst).movedim(-1, 0)
            att = ab.edge_softmax_blocked_multihead(b, logits)
            x = hh.reshape(N, H * D)
            errs[f"{name}/spmm_blocked_multiweighted_cuda"] = _maxerr(
                ab.spmm_blocked_multiweighted_cuda(b, x, att, **kw),
                ab.spmm_blocked_multiweighted(b, x, att, **kw))
            for route in ("gat_attend_blocked", "gat_attend_blocked_flash"):
                errs[f"{name}/{route}_cuda"] = _maxerr(
                    getattr(ab, route + "_cuda")(b, hh, asrc, adst, **kw),
                    getattr(ab, route)(b, hh, asrc, adst, **kw))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs


def run_q8_gates(compute_dtype=torch.float32, device="cuda"
                 ) -> Dict[str, float]:
    """``{case[agg]/spmm_blocked_q8_cuda: max_abs_err}`` of B11 against its
    plain version on ``device``, with sum and mean, on the testbed (F=128,
    8-byte loads), the three edge cases (the ragged case's odd F=37 takes
    1-byte loads), the hub row (F=34, 2-byte loads, a row over many pieces
    and chunks), the testbed and the hub row in chunks of 8,192 lanes (the
    output zeroed whole, every piece added), the testbed at W=64, C=256
    (the JAX test's layout) and the testbed at F=100 (4-byte loads).  The
    rows are rounded to ``compute_dtype`` before ``quantize_rows``."""
    from ..ops.spmm_blocked import build_blocked
    from ..ops.spmm_kernels import (quantize_rows, spmm_blocked_q8,
                                    spmm_blocked_q8_cuda)

    indptr, src, x_np = build_testbed()
    hub = hub_row_graph()
    x100 = np.random.default_rng(100).normal(
        size=(len(indptr) - 1, 100)).astype(np.float32)
    cases = [("testbed", indptr, src, x_np, 256, None)]
    cases += list(edge_case_graphs()) + [hub]
    cases += [("testbed[C=8192]", indptr, src, x_np, 256, 8192),
              ("hub_row[C=8192]",) + hub[1:5] + (8192,),
              ("testbed[W=64,C=256]", indptr, src, x_np, 64, 256),
              ("testbed_f100", indptr, src, x100, 256, None)]
    errs: Dict[str, float] = {}
    for name, ip, s, x_np, W, C in cases:
        b = build_blocked(ip, s, rows_per_block=W, chunk_edges=C,
                          device=device)
        x = torch.from_numpy(x_np).to(device).to(compute_dtype).float()
        q, scale = quantize_rows(x)
        for agg in ("sum", "mean"):
            errs[f"{name}[{agg}]/spmm_blocked_q8_cuda"] = _maxerr(
                spmm_blocked_q8_cuda(b, q, scale, agg=agg),
                spmm_blocked_q8(b, q, scale, agg=agg))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs


def _gat_inputs(rng, n: int, heads: int, d: int):
    return (rng.normal(size=(n, heads, d)).astype(np.float32),
            rng.normal(size=(n, heads)).astype(np.float32),
            rng.normal(size=(n, heads)).astype(np.float32),
            (rng.normal(size=(heads, d)) / np.sqrt(d)).astype(np.float32))


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


def run_attend_gates(compute_dtype=torch.float32, device="cuda"
                     ) -> Dict[str, float]:
    """``{case/kernel: max_abs_err}`` of the single-head attention kernels
    against their plain versions on ``device``: B5 (the JAX gates' SDDMM
    section), B6 on scores with NaN in the pad lanes, the composed attend
    (B5, B6, B2), B10, and B4 in both stat modes (the JAX gates' flash
    section), with x_dst = x_src as the JAX gates run them."""
    from ..ops import attention_blocked as ab
    from ..ops.spmm_blocked import build_blocked

    indptr, src, x_np = build_testbed()
    cases = [("testbed", indptr, src, x_np, 256, None)]
    cases += list(edge_case_graphs())
    errs: Dict[str, float] = {}
    kw = dict(compute_dtype=compute_dtype)
    with _strict_f32():
        for name, ip, s, x_np, W, C in cases:
            b = build_blocked(ip, s, rows_per_block=W, chunk_edges=C,
                              device=device)
            x = torch.from_numpy(x_np).to(device)
            errs[f"{name}/sddmm_blocked_cuda"] = _maxerr(
                ab.sddmm_blocked_cuda(b, x, x, **kw),
                ab.sddmm_blocked(b, x, x, **kw))
            scores = ab.sddmm_blocked(b, x, x, **kw) / x.shape[1] ** 0.5
            scores = torch.where(b.edge_local_row < W, scores, float("nan"))
            errs[f"{name}/edge_softmax_blocked_cuda"] = _maxerr(
                ab.edge_softmax_blocked_cuda(b, scores),
                ab.edge_softmax_blocked(b, scores))
            errs[f"{name}/attend_blocked_cuda"] = _maxerr(
                ab.attend_blocked_cuda(b, x, x, **kw),
                ab.attend_blocked(b, x, x, **kw))
            errs[f"{name}/attend_blocked_fused_cuda"] = _maxerr(
                ab.attend_blocked_fused_cuda(b, x, x, **kw),
                ab.attend_blocked_fused(b, x, x, **kw))
            for rs in (True, False):
                errs[f"{name}[row_stats={rs}]/attend_blocked_flash_cuda"] = \
                    _maxerr(ab.attend_blocked_flash_cuda(b, x, x,
                                                         row_stats=rs, **kw),
                            ab.attend_blocked_flash(b, x, x, row_stats=rs,
                                                    **kw))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs


def run_attend_mode_gates(compute_dtype=torch.float32, device="cuda"
                          ) -> Dict[str, float]:
    """``{case/kernel: max_abs_err}`` of B5 and B4 (both stat modes)
    against their plain versions on ``device``, on the cases that reach the
    row-grouped kernels' other paths: the hub row of 1,000 lanes (split
    over pieces and chunks), the testbed in chunks of 8,192 lanes (more
    than the kernels stage at once, so every piece is a split one), the
    testbed at 320 columns (wider than one 256-column register slab: B4's
    two-sweep path), the testbed with a distinct ``x_dst`` of 300 rows fewer
    than B*W (rows past it read as zeros), and :func:`far_scores_case`
    (chunk-max underflow).  B5 scores the scaled ``x_dst`` that B4 sees."""
    from ..ops import attention_blocked as ab
    from ..ops.spmm_blocked import build_blocked

    indptr, src, x_np = build_testbed()
    rng = np.random.default_rng(320)
    x320 = rng.normal(size=(len(indptr) - 1, 320)).astype(np.float32)
    short = rng.normal(size=(len(indptr) - 301, 128)).astype(np.float32)
    hub = hub_row_graph()
    far = far_scores_case()
    # (name, indptr, src, x_dst, x_src, rows_per_block, chunk_edges)
    cases = [hub[:3] + (hub[3],) + hub[3:],
             ("testbed[C=8192]", indptr, src, x_np, x_np, 256, 8192),
             ("testbed_f320", indptr, src, x320, x320, 256, None),
             ("testbed_short_dst", indptr, src, short, x_np, 256, None),
             far[:7]]
    errs: Dict[str, float] = {}
    kw = dict(compute_dtype=compute_dtype)
    with _strict_f32():
        for name, ip, s, xd_np, xs_np, W, C in cases:
            b = build_blocked(ip, s, rows_per_block=W, chunk_edges=C,
                              device=device)
            xd = torch.from_numpy(xd_np).to(device)
            xs = torch.from_numpy(xs_np).to(device)
            xd_scaled = xd / xs.shape[1] ** 0.5
            errs[f"{name}/sddmm_blocked_cuda"] = _maxerr(
                ab.sddmm_blocked_cuda(b, xd_scaled, xs, **kw),
                ab.sddmm_blocked(b, xd_scaled, xs, **kw))
            for rs in (True, False):
                errs[f"{name}[row_stats={rs}]/attend_blocked_flash_cuda"] = \
                    _maxerr(ab.attend_blocked_flash_cuda(b, xd, xs,
                                                         row_stats=rs, **kw),
                            ab.attend_blocked_flash(b, xd, xs, row_stats=rs,
                                                    **kw))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs


def _softmax_weights(b, heads: int, seed: int) -> torch.Tensor:
    """(heads, T, C) float32 weights of the lanes of ``b``: the plain
    per-row, per-head softmax of seeded N(0, 1) logits, as B8 takes them
    from B7 (each row's weights sum to 1, 0 on pad lanes)."""
    from ..ops.attention_blocked import edge_softmax_blocked_multihead
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn((heads,) + tuple(b.edge_src.shape), generator=gen)
    return edge_softmax_blocked_multihead(b, logits.to(b.edge_src.device))


def run_weighted_mode_gates(compute_dtype=torch.float32, device="cuda"
                            ) -> Dict[str, float]:
    """``{case/kernel: max_abs_err}`` of B10 (``attend_blocked_fused_cuda``)
    and B8 (``spmm_blocked_multiweighted_cuda``) against their plain
    versions on ``device``, on the cases that reach their row-grouped
    kernels' other paths: the hub row of 1,000 lanes (split over pieces and
    chunks), the testbed in chunks of 8,192 lanes (more than the kernels
    stage at once: the output is zeroed whole and every piece adds), the
    testbed at 320 columns (wider than one 256-column slab), B10 with a
    distinct ``x_dst`` 300 rows short of B*W and on
    :func:`far_scores_case`, and B8 with one head (the rows as they are)
    and with H=4 heads: D=36 on the hub row and at C=8192 (a bfloat16
    vector of 8 would straddle two heads, so the kernel loads 4), D=80 at
    320 columns.  B8 takes per-row softmax weights, as B7 gives them."""
    from ..ops import attention_blocked as ab
    from ..ops.spmm_blocked import build_blocked

    indptr, src, x_np = build_testbed()
    rng = np.random.default_rng(320)
    x320 = rng.normal(size=(len(indptr) - 1, 320)).astype(np.float32)
    short = rng.normal(size=(len(indptr) - 301, 128)).astype(np.float32)
    hub = hub_row_graph()
    far = far_scores_case()
    # (name, indptr, src, x_dst, x_src, rows_per_block, chunk_edges, B8's
    # head widths D; None: no B8 case)
    cases = [hub[:3] + (hub[3],) + hub[3:] + ((34, 36),),
             ("testbed[C=8192]", indptr, src, x_np, x_np, 256, 8192,
              (128, 36)),
             ("testbed_f320", indptr, src, x320, x320, 256, None, (320, 80)),
             ("testbed_short_dst", indptr, src, short, x_np, 256, None, None),
             far[:7] + (None,)]
    errs: Dict[str, float] = {}
    kw = dict(compute_dtype=compute_dtype)
    with _strict_f32():
        for name, ip, s, xd_np, xs_np, W, C, widths in cases:
            b = build_blocked(ip, s, rows_per_block=W, chunk_edges=C,
                              device=device)
            xd = torch.from_numpy(xd_np).to(device)
            xs = torch.from_numpy(xs_np).to(device)
            errs[f"{name}/attend_blocked_fused_cuda"] = _maxerr(
                ab.attend_blocked_fused_cuda(b, xd, xs, **kw),
                ab.attend_blocked_fused(b, xd, xs, **kw))
            for D in widths or ():
                H = 1 if D == xs.shape[1] else 4
                x = xs if H == 1 else torch.from_numpy(
                    np.random.default_rng(D).normal(
                        size=(len(ip) - 1, H * D)).astype(np.float32)
                ).to(device)
                w = _softmax_weights(b, H, seed=D)
                errs[f"{name}[H={H},D={D}]/spmm_blocked_multiweighted_cuda"] \
                    = _maxerr(ab.spmm_blocked_multiweighted_cuda(b, x, w, **kw),
                              ab.spmm_blocked_multiweighted(b, x, w, **kw))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return errs
