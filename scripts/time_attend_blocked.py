#!/usr/bin/env python3
"""Time the attention kernels B5, B4, B6, B10 and B8, the attend routes, and the kernels and passes beside them.

Times the ``tch_geometric_tpu_torch`` package that comes first on
``sys.path``, through its public wrappers only, so the same script times an
older tree of the package as well.  An A/B of two trees runs it in turns, one
process each, in the order parent, change, change, parent, on one machine;
from the root of a checkout, with the parent's package unpacked under a
git-ignored directory:

    mkdir -p build/parent
    git archive <parent> tch_geometric_tpu_torch | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        PYTHONPATH=$t:. python3 scripts/time_attend_blocked.py
    done

On chip_smoke's ogbn-products graph and layout (``host_prep``, W=256) and its
attend inputs (the 100 features and a seeded 256-column embedding), each case
is timed by chip_smoke's ``cuda_ms`` (CUDA events over 10 calls after a
warm-up; the passes over 3): B5 at F=256 in bfloat16 and float32 and at
F=100 in bfloat16, beside ``torch.sparse.sampled_addmm`` on float32 rows; B4
with row and chunk-max stats at F=256 in bfloat16 and float32 and at F=100
in bfloat16; B6 at F=256 in bfloat16; B10 at F=256 in bfloat16 and float32
and at F=100 in bfloat16; the three attend routes (composed, fused, flash
with row stats) at F=256 in bfloat16; B8 at the GAT's layer 1 (H=4, D=64)
in float32 and bfloat16, at its layer 3 (H=1, D=47) in float32 and with
one head at F=256 in bfloat16.  Then B1,
B2, B11 and the SAGE forwards of ``scripts/time_spmm_blocked.py`` and the
full-graph GAT pass through each of its three routes (B3; B7 + B8; B9), so
that one process covers every kernel.
Each output's float64 sum is printed beside its time, so the turns can be
compared, and the device time of each kernel of one B4 call (row stats)
and one B5 call at F=256 bfloat16 under ``torch.profiler``.  Prints one JSON
object (also written to ``--out`` when given) and the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import chip_smoke
from time_spmm_blocked import spmm_cases, time_cases


def attend_cases(p, xs, device):
    """``{name: (fn, calls)}`` of the attention kernels and routes."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab

    b = p["blocked"]
    x256 = xs[256].to(torch.bfloat16)
    x256f = xs[256].float()
    x100 = xs[100].to(torch.bfloat16)
    s16 = chip_smoke._nan_pads(
        b, ab.sddmm_blocked_cuda(b, x256, x256) / 256 ** 0.5)

    def b5(x):
        return lambda: ab.sddmm_blocked_cuda(b, x, x, compute_dtype=x.dtype)

    def b4(x, rs):
        return lambda: ab.attend_blocked_flash_cuda(
            b, x, x, compute_dtype=x.dtype, row_stats=rs)

    cases = {
        "B5_F256_bf16": b5(x256),
        "B5_F256_f32": b5(x256f),
        "B5_F100_bf16": b5(x100),
        "B4_row_F256_bf16": b4(x256, True),
        "B4_chunkmax_F256_bf16": b4(x256, False),
        "B4_row_F256_f32": b4(x256f, True),
        "B4_chunkmax_F256_f32": b4(x256f, False),
        "B4_row_F100_bf16": b4(x100, True),
        "B4_chunkmax_F100_bf16": b4(x100, False),
        "B6_F256": lambda: ab.edge_softmax_blocked_cuda(b, s16),
        "B10_F256_bf16": lambda: ab.attend_blocked_fused_cuda(b, x256, x256),
        "B10_F256_f32": lambda: ab.attend_blocked_fused_cuda(
            b, x256f, x256f, compute_dtype=torch.float32),
        "B10_F100_bf16": lambda: ab.attend_blocked_fused_cuda(b, x100, x100),
    }
    out = {k: (fn, 10) for k, fn in cases.items()}
    routes = chip_smoke.attend_routes()
    for name in ("composed", "fused", "flash_row"):
        out[f"attend_{name}_F256_bf16"] = (
            lambda fn=routes[name]: fn(b, x256, torch.bfloat16), 10)
    # the library yardstick of B5, on float32 rows (it refuses bfloat16)
    n = x256f.shape[0]
    ptr, col, _ = chip_smoke._coalesced_csr(p["col_ptrs"], p["row_indices"],
                                            n, device)
    pattern = torch.sparse_csr_tensor(
        ptr, col, torch.zeros(col.shape, device=device), size=(n, n))
    out["sampled_addmm_F256_f32"] = (
        lambda: torch.sparse.sampled_addmm(pattern, x256f, x256f.t(),
                                           beta=0.0).values(), 10)
    return out


def b8_cases(p, xs, device):
    """``{name: (fn, calls)}`` of B8 at the shapes its paths give it: the
    GAT's layer 1 (H=4, D=64) in float32 and bfloat16 and layer 3 (H=1,
    D=47) in float32, on seeded rows and B7's softmax of seeded logits, and
    one head at F=256 in bfloat16 (the composed attend route's last step) on
    B6's weights of the scaled scores."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab

    b = p["blocked"]
    n = p["x_table"].shape[0]
    gen = torch.Generator().manual_seed(9)

    def weights(heads):
        logits = torch.randn((heads,) + tuple(b.edge_src.shape),
                             generator=gen).to(device)
        return ab.edge_softmax_blocked_multihead_cuda(b, logits)

    x1 = torch.randn((n, 256), generator=gen).to(device)
    w1 = weights(4)
    x3 = torch.randn((n, 47), generator=gen).to(device)
    w3 = weights(1)
    x256 = xs[256].to(torch.bfloat16)
    s16 = ab.sddmm_blocked_cuda(b, x256, x256) / 256 ** 0.5
    w256 = ab.edge_softmax_blocked_cuda(b, s16)[None]
    del s16

    def b8(x, w, dt):
        x = x.to(dt)
        return lambda: ab.spmm_blocked_multiweighted_cuda(b, x, w,
                                                          compute_dtype=dt)

    return {"B8_H4_D64_f32": (b8(x1, w1, torch.float32), 10),
            "B8_H4_D64_bf16": (b8(x1, w1, torch.bfloat16), 10),
            "B8_H1_D47_f32": (b8(x3, w3, torch.float32), 10),
            "B8_H1_F256_bf16": (b8(x256, w256, torch.bfloat16), 10)}


def kernel_split(fn):
    """``{kernel name: device ms}`` of one call of ``fn`` under
    ``torch.profiler`` (empty where the profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:          # a sandbox may refuse the tracer
        return {"error": str(exc).splitlines()[0]}
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and getattr(ev, "device_type", None) is not None and \
                "CUDA" in str(ev.device_type):
            out[ev.key[:80]] = us / 1e3
    return out


def gat_cases(p, device):
    """``{name: (fn, calls)}``: the float32 full-graph GAT pass through
    each of its routes (chip_smoke's ``gat_route_pass``), 3 calls each."""
    gat = chip_smoke.gat_models(p, device)["gat"]
    return {f"gat_pass_{r}": (lambda r=r: chip_smoke.gat_route_pass(
        gat, p["x_table"], p["blocked"], r), 3) for r in chip_smoke.GAT_ROUTES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_attend_blocked: CUDA is not available", file=sys.stderr)
        return 2
    import tch_geometric_tpu_torch as pkg
    from tch_geometric_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke runs
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = chip_smoke.gpu_line()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    p, _ = chip_smoke.host_prep(args.scale, device)
    b = p["blocked"]
    res = {"package": str(Path(pkg.__file__).parent), "card": card,
           "scale": args.scale, "build_s": build_s,
           "shape": dict(N=p["x_table"].shape[0], T=b.num_chunks,
                         C=b.chunk_edges, W=b.rows_per_block,
                         valid_lanes=int(b.edge_valid.sum())),
           "ms": {}, "sum": {}}
    xs = chip_smoke.attend_inputs(p, device)
    cases = attend_cases(p, xs, device)
    time_cases(cases, res)
    # the kernels of one B4 call (count, main, merge) and of one B5 call
    res["profile"] = {k: kernel_split(cases[k][0])
                      for k in ("B4_row_F256_bf16", "B5_F256_bf16")}
    print("profile", json.dumps(res["profile"]), flush=True)
    slots = getattr(sys.modules["tch_geometric_tpu_torch.ops.attention_blocked"]
                    .attend_blocked_flash_cuda, "last_slots", None)
    res["b4_split_slots_last_call"] = slots
    time_cases(b8_cases(p, xs, device), res)
    del xs
    torch.cuda.empty_cache()
    time_cases(spmm_cases(p, device), res)
    torch.cuda.empty_cache()
    time_cases(gat_cases(p, device), res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
