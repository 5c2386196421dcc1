#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tch_geometric_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--scale S]

``--scale`` below 1 cuts the graph for a quick rehearsal; such a run prints
no kernels line.

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. build the CUDA kernels from ``tch_geometric_tpu_torch/csrc`` (nvcc);
2. kernel checks: B1, B2 and the hot split against their plain versions on
   the card, on the kernel-gate testbed and three layout edge cases, in
   float32 (5e-4, TF32 off) and bfloat16 (per-kernel limits of
   ``utils/kernel_gates.py``);
3. the GraphSAGE serving path at ogbn-products size (synthetic graph with
   the dataset's node/edge counts, 100 features, 47 classes; model
   hidden=256, 3 layers, random weights from a seed):
   (a) COO -> CSC -> device graph, 8 requests of 1024 seeds through
   ``sample_and_gather`` + ``tree_forward`` with fanouts [15, 10, 5];
   (b) ``build_blocked`` (W=256) and one full-graph ``blocked_forward``;
   (c) ``build_blocked_hot`` and one ``blocked_forward`` over it.
   The kernels' launch counts are zeroed just before (a)-(c) and read just
   after; each kernel must have run.  Then each kernel's wrapper is checked
   against its plain version at the main path's shapes (F=100 and F=256,
   bfloat16 and float32), and the kernel is timed there, beside its bound
   and one PyTorch library call computing the same function (a yardstick
   only; the port never calls it), and the serving outputs are checked:
   finite, (b) and (c) agree, and on a 5% node subgraph ``blocked_forward``
   agrees with the plain ``forward`` and the card's sampler with the CPU's.

Output: human-readable lines, then one JSON line of kernel numbers, one
line with the card's name and power limit (nvidia-smi), and as the last
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
PRODUCTS = "ogbn-products"
FANOUTS = [15, 10, 5]
REQUESTS = 8
SEEDS_PER_REQUEST = 1024
W = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (after one warm-up),
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def maxerr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_build():
    from tch_geometric_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (sec, out) in built.items():
        log(f"build: {name} {sec:.1f}s\n{out.strip()}")
    log(f"build: total {time.perf_counter() - t0:.1f}s "
        f"({len(built)} libraries compiled)")


def phase_kernel_checks(device):
    from tch_geometric_tpu_torch.utils import kernel_gates as kg
    for dtype, thr in ((torch.float32, kg.F32_THRESHOLD),
                       (torch.bfloat16, kg.BF16_THRESHOLDS)):
        errs = kg.run_kernel_gates(dtype, device=device)
        ok, worst = kg.gate(errs, thr)
        log(f"kernel checks {str(dtype)[6:]} (limits {thr}): "
            f"nearest its limit {worst}")
        for k, v in errs.items():
            log(f"  {k}: {v:.3e}")
        check(ok, f"kernel checks {dtype}: {worst}")


def host_prep(scale: float, device):
    """Graph, features, model and both blocked layouts; returns a dict and
    the host seconds of each step."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.ogb import synthetic_ogbn
    from tch_geometric_tpu_torch.data.storage import to_csc
    from tch_geometric_tpu_torch.models.sage import GraphSAGE
    from tch_geometric_tpu_torch.ops.spmm_blocked import (build_blocked,
                                                          build_blocked_hot)
    sec = {}
    t = time.perf_counter()
    data = synthetic_ogbn(PRODUCTS, seed=0, scale=scale)
    sec["synthetic_graph"] = time.perf_counter() - t
    n = data.num_nodes
    t = time.perf_counter()
    col_ptrs, row_indices, perm = to_csc(data.edge_index, n)
    sec["to_csc"] = time.perf_counter() - t
    t = time.perf_counter()
    graph = make_graph(col_ptrs, row_indices, perm, num_src=n, num_dst=n,
                       device=device)
    x_table = torch.from_numpy(data.x).to(device)
    sec["make_graph"] = time.perf_counter() - t
    t = time.perf_counter()
    blocked = build_blocked(col_ptrs, row_indices, rows_per_block=W,
                            device=device)
    sec["build_blocked"] = time.perf_counter() - t
    t = time.perf_counter()
    hot = build_blocked_hot(col_ptrs, row_indices, rows_per_block=W,
                            device=device)
    sec["build_blocked_hot"] = time.perf_counter() - t
    model = GraphSAGE(data.x.shape[1], 256, 47, 3,
                      generator=torch.Generator().manual_seed(0),
                      device=device)
    return dict(data=data, col_ptrs=col_ptrs, row_indices=row_indices,
                graph=graph, x_table=x_table, blocked=blocked, hot=hot,
                model=model), sec


def serve(p, device, timer):
    """The main path: (a) sampled requests, (b) blocked forward, (c) hot
    split forward.  ``timer(fn)`` returns (result, milliseconds)."""
    from tch_geometric_tpu_torch.parallel.train import make_gnn_trainer
    from tch_geometric_tpu_torch.sampling import rng
    model, graph, x_table = p["model"], p["graph"], p["x_table"]
    n = x_table.shape[0]
    trainer = make_gnn_trainer(model, FANOUTS)
    gen = torch.Generator().manual_seed(1)
    req_ms, logits = [], []
    with torch.no_grad():
        for r in range(REQUESTS):
            seeds = torch.randint(0, n, (SEEDS_PER_REQUEST,), generator=gen)
            key = rng.fold(rng.key(0), r)

            def request():
                sample, x = trainer.sample_and_gather(key, graph, x_table,
                                                      seeds)
                return model.tree_forward(sample, x)
            out, ms = timer(request)
            req_ms.append(ms)
            logits.append(out)
        out_b, ms_b = timer(lambda: model.blocked_forward(x_table,
                                                          p["blocked"]))
        out_c, ms_c = timer(lambda: model.blocked_forward(x_table, p["hot"]))
    return dict(req_ms=req_ms, logits=logits, out_b=out_b, out_c=out_c,
                ms_b=ms_b, ms_c=ms_c)


FORWARD_REPS = 3


def steady_forward_ms(p, timer):
    """Warm full-graph forward times, plain and hot-split layouts in turns
    (after the main path, so not counted in its launches)."""
    model, x_table = p["model"], p["x_table"]
    out = {"blocked": [], "hot_split": []}
    with torch.no_grad():
        for _ in range(FORWARD_REPS):
            for k, layout in (("blocked", p["blocked"]),
                              ("hot_split", p["hot"])):
                out[k].append(timer(
                    lambda: model.blocked_forward(x_table, layout))[1])
    return out


def check_serving(res, n):
    from tch_geometric_tpu_torch.utils.kernel_gates import \
        FORWARD_BF16_THRESHOLD
    for lg in res["logits"]:
        check(lg.shape == (SEEDS_PER_REQUEST, 47), f"request shape {lg.shape}")
        check(bool(torch.isfinite(lg).all()), "request logits finite")
    for k in ("out_b", "out_c"):
        check(res[k].shape == (n, 47), f"{k} shape {tuple(res[k].shape)}")
        check(bool(torch.isfinite(res[k]).all()), f"{k} finite")
    err = maxerr(res["out_b"], res["out_c"])
    log(f"check: blocked vs hot-split forward max |diff| {err:.3e} "
        f"(bf16 limit {FORWARD_BF16_THRESHOLD}; logits max |value| "
        f"{float(res['out_b'].abs().max()):.3e})")
    check(err <= FORWARD_BF16_THRESHOLD,
          "blocked and hot-split forwards agree")
    return err


def check_subgraph(p, device, frac=0.05):
    """On a random 5% node subgraph: blocked_forward (f32 and bf16) against
    the plain forward, and the card's sampled request against the CPU's
    (same key -> identical sample; logits allclose)."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.storage import to_csc
    from tch_geometric_tpu_torch.ops.spmm_blocked import build_blocked
    from tch_geometric_tpu_torch.parallel.train import make_gnn_trainer
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.utils.kernel_gates import (
        F32_THRESHOLD, FORWARD_BF16_THRESHOLD)
    data, model = p["data"], p["model"]
    n = data.num_nodes
    r = np.random.default_rng(2)
    keep = np.sort(r.choice(n, size=max(int(n * frac), 64), replace=False))
    new_id = np.full(n, -1, np.int64)
    new_id[keep] = np.arange(len(keep))
    ei = new_id[data.edge_index]
    ei = ei[:, (ei >= 0).all(axis=0)]
    ns = len(keep)
    cp, ri, _ = to_csc(ei, ns)
    xs = torch.from_numpy(data.x[keep]).to(device)
    g = make_graph(cp, ri, num_src=ns, num_dst=ns, device=device)
    b = build_blocked(cp, ri, rows_per_block=W, device=device)
    out = {}
    with torch.no_grad():
        ref = model(xs, g)
        e32 = maxerr(model.blocked_forward(xs, b, compute_dtype=torch.float32),
                     ref)
        e16 = maxerr(model.blocked_forward(xs, b), ref)
        log(f"check: {ns} nodes / {ei.shape[1]} edges subgraph: "
            f"blocked_forward vs forward f32 {e32:.3e} bf16 {e16:.3e} "
            f"(limits {F32_THRESHOLD}, {FORWARD_BF16_THRESHOLD}; logits max "
            f"|value| {float(ref.abs().max()):.3e})")
        check(e32 <= F32_THRESHOLD, "subgraph blocked f32 vs plain")
        check(e16 <= FORWARD_BF16_THRESHOLD, "subgraph blocked bf16 vs plain")
        out.update(subgraph_nodes=ns, subgraph_edges=int(ei.shape[1]),
                   blocked_vs_plain_f32=e32, blocked_vs_plain_bf16=e16)

        cpu_model = copy.deepcopy(model).cpu()
        g_cpu = make_graph(cp, ri, num_src=ns, num_dst=ns, device="cpu")
        seeds = torch.from_numpy(r.choice(ns, SEEDS_PER_REQUEST))
        key = rng.key(7)
        sa, xa = make_gnn_trainer(model, FANOUTS).sample_and_gather(
            key, g, xs, seeds)
        sb, xb = make_gnn_trainer(cpu_model, FANOUTS).sample_and_gather(
            key, g_cpu, xs.cpu(), seeds)
        for f in ("nodes", "node_valid", "rows", "cols", "eptr",
                  "edge_valid"):
            check(torch.equal(getattr(sa, f).cpu(), getattr(sb, f)),
                  f"card and CPU samples agree on {f}")
        e = maxerr(model.tree_forward(sa, xa).cpu(),
                   cpu_model.tree_forward(sb, xb))
        log(f"check: sampled request card vs CPU: samples identical, "
            f"logits max |diff| {e:.3e}")
        check(e <= 1e-4, "sampled logits card vs CPU")
        out["request_card_vs_cpu"] = e
    return out


def kernel_numbers(p, launches, device):
    """Each kernel at the main path's shapes.  Its wrapper, called as the
    forward calls it, is held against the plain version at both feature
    widths the forward aggregates (F=100: the float32 input features; F=256:
    the hidden layers), in bfloat16 (the main path's compute dtype) and in
    float32.  Then the kernel alone, its plain version and one library call
    computing the same function are timed at F=256 in bfloat16, beside the
    bound.  Returns the kernels' JSON rows and each kernel's lane-gather
    time (every lane reads its row; derived, not measured)."""
    from tch_geometric_tpu_torch.ops.attention_blocked import \
        spmm_blocked_weighted_cuda
    from tch_geometric_tpu_torch.ops.spmm_blocked import spmm_blocked
    from tch_geometric_tpu_torch.ops.spmm_kernels import (_launch,
                                                          spmm_blocked_cuda)
    from tch_geometric_tpu_torch.utils.kernel_gates import (BF16_THRESHOLDS,
                                                            F32_THRESHOLD)
    blocked, hot, x_table = p["blocked"], p["hot"], p["x_table"]
    n = x_table.shape[0]
    gen = torch.Generator().manual_seed(3)
    x32 = torch.randn((n, 256), generator=gen).to(device)
    xb = x32.to(torch.bfloat16)
    x_hot32 = x32[hot.hot_ids]
    xb_hot = x_hot32.to(torch.bfloat16)
    # the library yardstick: torch.sparse.mm on a CSR matrix holding the
    # same edges, once in bfloat16 (the kernels' inputs; its output is
    # rounded to bfloat16) and once in float32 (the kernels' output dtype)
    csr = _csr(*_coalesced_csr(p["col_ptrs"], p["row_indices"], n, device),
               (n, n))
    hb = hot.hot
    hot_csr = _csr(*_lanes_to_csr(hb, hot.hot_count, n),
                   (n, x_hot32.shape[0]))

    rows, gather_bound = [], {}
    specs = [
        dict(name="spmm_blocked_cuda (B1)",
             source="tch_geometric_tpu_torch/csrc/spmm_blocked.cu",
             replaces="tch_geometric_tpu/ops/spmm_pallas.py:28",
             key="spmm_blocked_cuda", b=blocked, w=None, xb=xb, csr=csr,
             widths={100: x_table, 256: x32},
             run=lambda b, x, w, dt: spmm_blocked_cuda(
                 b, x, agg="mean", compute_dtype=dt),
             plain=lambda b, x, w, dt: spmm_blocked(
                 b, x, agg="mean", compute_dtype=dt)),
        dict(name="spmm_blocked_weighted_cuda (B2)",
             source="tch_geometric_tpu_torch/csrc/spmm_blocked.cu",
             replaces="tch_geometric_tpu/ops/attention_blocked.py:418",
             key="spmm_blocked_weighted_cuda", b=hb, w=hot.hot_count,
             xb=xb_hot, csr=hot_csr,
             widths={100: x_table[hot.hot_ids], 256: x_hot32},
             run=lambda b, x, w, dt: spmm_blocked_weighted_cuda(
                 b, x, w, compute_dtype=dt),
             plain=lambda b, x, w, dt: spmm_blocked(
                 b, x, edge_weight=w, compute_dtype=dt)),
    ]
    for s in specs:
        b, w = s["b"], s["w"]
        T, C = b.edge_src.shape
        errs = {}
        for width, xx in s["widths"].items():
            for dt, thr in ((torch.bfloat16, BF16_THRESHOLDS[s["key"]]),
                            (torch.float32, F32_THRESHOLD)):
                got = s["run"](b, xx, w, dt)
                ref = s["plain"](b, xx, w, dt)
                check(got.shape == ref.shape == (b.num_rows, width),
                      f"{s['name']} F={width} output shape {tuple(got.shape)}")
                e = errs[width, dt] = maxerr(got, ref)
                log(f"check: {s['name']} wrapper vs plain at F={width} "
                    f"{str(dt)[6:]}: max |diff| {e:.3e} (limit {thr})")
                check(e <= thr, f"{s['name']} F={width} {dt}: {e:.3e} > {thr}")
                del got, ref
        err16 = max(v for (_, dt), v in errs.items() if dt == torch.bfloat16)
        err32 = max(v for (_, dt), v in errs.items() if dt == torch.float32)
        F = 256
        ms = cuda_ms(lambda: _launch(b, s["xb"], w), 10)
        plain_ms = cuda_ms(lambda: spmm_blocked(
            b, s["xb"], agg="sum", edge_weight=w,
            compute_dtype=torch.bfloat16), 2)
        csr32, csr16 = s["csr"]
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr16, s["xb"]), 10)
        library_f32_ms = cuda_ms(
            lambda: torch.sparse.mm(csr32, s["widths"][F]), 10)
        valid = int(b.edge_valid.sum()) if b.edge_valid is not None else T * C
        # bytes bound: the kernel's own inputs read once — x, and the
        # blocked layout's per-lane edge_src and local_row (and weight),
        # pad lanes included — and the (B*W, F) float32 output written once
        meta = 12 if w is not None else 8
        in_bytes = (s["xb"].numel() * 2 + T * C * meta
                    + b.block_start.numel() * 4)
        out_bytes = b.num_blocks * b.rows_per_block * F * 4
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = valid * F * (2 if w is not None else 1) / F32_FLOP_PER_S * 1e3
        gather_ms = (T * C * (F * 2 + meta) + out_bytes) / HBM_BYTES_PER_S * 1e3
        gather_bound[s["key"]] = gather_ms
        rows.append(dict(
            name=s["name"], route="cuda", source=s["source"],
            replaces=s["replaces"], launches=launches[s["key"]],
            max_abs_err=err16, ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms,
            max_abs_err_f32=err32,
            shape=dict(T=T, C=C, W=b.rows_per_block, F=F, N=int(s["xb"].shape[0]),
                       valid_lanes=valid, dtype="bfloat16"),
            library_call="torch.sparse.mm(CSR bfloat16, dense bfloat16)",
            library_f32_ms=library_f32_ms))
        log(f"kernel {s['name']}: T={T} C={C} F={F} lanes valid {valid}: "
            f"{ms:.3f} ms (bound {max(t_bytes, t_ops):.3f} ms by bytes; "
            f"derived lane-gather time {gather_ms:.3f} ms), plain "
            f"{plain_ms:.3f} ms, library {library_ms:.3f} ms (float32 "
            f"{library_f32_ms:.3f} ms), launches on main path "
            f"{launches[s['key']]}, worst wrapper err bf16 {err16:.2e} "
            f"f32 {err32:.2e}")
    return rows, gather_bound


def _csr(ptr, col, val, size):
    """(float32, bfloat16) torch CSR matrices of the same entries."""
    return tuple(torch.sparse_csr_tensor(ptr, col, val.to(dt), size=size,
                                         check_invariants=True)
                 for dt in (torch.float32, torch.bfloat16))


def _coalesced_csr(col_ptrs, row_indices, n, device):
    """The graph as CSR arrays of A[dst, src] = edge multiplicity (torch's
    CSR needs distinct column indices per row)."""
    cp = torch.from_numpy(col_ptrs).to(device)
    ri = torch.from_numpy(row_indices).to(device)
    dst = torch.repeat_interleave(torch.arange(n, device=device), cp.diff())
    uk, cnt = torch.unique_consecutive(dst * n + ri, return_counts=True)
    ptr = torch.zeros(n + 1, dtype=torch.long, device=device)
    ptr[1:] = torch.bincount(uk // n, minlength=n).cumsum(0)
    return ptr, uk % n, cnt.float()


def _lanes_to_csr(b, values, n):
    """A BlockedCsr's valid lanes as (n, K) CSR arrays ``(ptr, col, val)``:
    lane values go back to CSR edge order through ``edge_ptr``; row counts
    are the layout's degrees."""
    valid = b.edge_valid
    ep = b.edge_ptr[valid].long()
    col = torch.empty_like(ep)
    col[ep] = b.edge_src[valid].long()
    val = torch.empty(ep.shape, dtype=torch.float32, device=ep.device)
    val[ep] = values[valid]
    ptr = torch.zeros(n + 1, dtype=torch.long, device=ep.device)
    ptr[1:] = b.degree.long().cumsum(0)
    return ptr, col, val


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of ogbn-products' nodes and edges, for a "
                         "quick rehearsal; below 1 no kernels line is printed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import tch_geometric_tpu_torch  # noqa: F401  (fails outside a checkout)
    from tch_geometric_tpu_torch.ops.attention_blocked import \
        spmm_blocked_weighted_cuda
    from tch_geometric_tpu_torch.ops.spmm_kernels import spmm_blocked_cuda

    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks need IEEE
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_all = time.perf_counter()

    phase_build()
    phase_kernel_checks(device)

    t = time.perf_counter()
    p, prep = host_prep(args.scale, device)
    torch.cuda.synchronize()
    prep_total = time.perf_counter() - t
    n = p["x_table"].shape[0]
    log(f"host prep {prep_total:.1f}s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in prep.items())
        + f"; N={n} E={p['graph'].num_edges} max_degree="
        f"{p['graph'].max_degree} ELL={p['graph'].ell is not None}; "
        f"blocked T={p['blocked'].num_chunks} C={p['blocked'].chunk_edges}; "
        f"hot cold T={p['hot'].cold.num_chunks} hot T={p['hot'].hot.num_chunks}")

    def timer(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    spmm_blocked_cuda.launches = 0
    spmm_blocked_weighted_cuda.launches = 0
    res = serve(p, device, timer)
    launches = {"spmm_blocked_cuda": spmm_blocked_cuda.launches,
                "spmm_blocked_weighted_cuda":
                    spmm_blocked_weighted_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path launches: {launches}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} ran on the main path")
    log("requests ms: " + ", ".join(f"{m:.1f}" for m in res["req_ms"]))
    log(f"full-graph blocked_forward {res['ms_b']:.1f} ms, hot split "
        f"{res['ms_c']:.1f} ms (first calls); peak device memory "
        f"{peak_gb:.2f} GiB")
    steady = steady_forward_ms(p, timer)
    log(f"full-graph forward, warm, {FORWARD_REPS} runs each in turns: "
        + "; ".join(f"{k} " + ", ".join(f"{m:.1f}" for m in v)
                    for k, v in steady.items()))

    serving_err = check_serving(res, n)
    sub = check_subgraph(p, device)
    kernels, gather_bound = kernel_numbers(p, launches, device)

    summary = dict(
        card=card, scale=args.scale, nodes=n, edges=p["graph"].num_edges,
        host_prep_s=prep_total, host_prep_steps_s=prep,
        request_ms=res["req_ms"],
        request_ms_steady_mean=float(np.mean(res["req_ms"][1:])),
        blocked_forward_ms=res["ms_b"], hot_split_forward_ms=res["ms_c"],
        forward_ms_warm=steady,
        blocked_vs_hot_max_diff=serving_err, peak_device_gib=peak_gb,
        lane_gather_ms_derived=gather_bound,
        total_s=time.perf_counter() - t_all, **sub)
    log("serving: " + json.dumps(summary))
    if args.scale == 1.0:
        print(json.dumps({"kernels": kernels}), flush=True)
    else:
        log(f"rehearsal at scale {args.scale}: no kernels line")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
