#!/usr/bin/env python3
"""Time the attention kernels B5, B4, B6, B10, B8, B7, B3 and B9, the attend routes, and the kernels and passes beside them.

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
warm-up; the passes over 3): B5 at F=256 in bfloat16 and float32 and at F=100
in bfloat16, beside ``torch.sparse.sampled_addmm`` on float32 rows; B4 with
row and chunk-max stats at F=256 in bfloat16 and float32 and at F=100 in
bfloat16; B6 on the scaled scores at F=256 of bfloat16 and float32 rows, and
with every row block on its looped path where the tree has it; B10 at F=256
in bfloat16 and float32 and at F=100 in bfloat16; the three attend routes
(composed, fused, flash with row stats) at F=256 in bfloat16; B8 at the GAT's
layer 1 (H=4, D=64) in float32 and bfloat16, at its layer 3 (H=1, D=47) in
float32 and with one head at F=256 in bfloat16; B7 on scores and on the logit
tables at H=4 and H=1 (``b7_cases``), with
the kernels of one call of each entry at H=4 and H=1 under
``torch.profiler``; B3 (vec mode) at H=4, D=64 in float32 and bfloat16 and at
H=1, D=47 in float32, and B9 at H=4, D=64 in float32 and bfloat16, with the
kernels of one B3 call and one B9 call (float32, H=4) under
``torch.profiler``, the host clock of that call (its synchronisation on the
slot count included) and its split-row slot count. Then B1, B2, B11 and the
SAGE forwards of ``scripts/time_spmm_blocked.py`` and the full-graph GAT pass
through each of its three routes (B3; B7 + B8; B9), so that one process
covers every kernel.
Each output's float64 sum is printed beside its time, so the turns can be
compared, and the device time of each kernel of one B4 call (row stats), one
B5 call, one B6 call and one B10 call (also in float32) at F=256 bfloat16
under ``torch.profiler``. Prints one JSON object (also written to ``--out``
when given) and the card's name and power limit.
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
    s32 = chip_smoke._nan_pads(b, ab.sddmm_blocked_cuda(
        b, x256f, x256f, compute_dtype=torch.float32) / 256 ** 0.5)

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
        "B6_F256_f32": lambda: ab.edge_softmax_blocked_cuda(b, s32),
        "B10_F256_bf16": lambda: ab.attend_blocked_fused_cuda(b, x256, x256),
        "B10_F256_f32": lambda: ab.attend_blocked_fused_cuda(
            b, x256f, x256f, compute_dtype=torch.float32),
        "B10_F100_bf16": lambda: ab.attend_blocked_fused_cuda(b, x100, x100),
    }
    if hasattr(ab, "_edge_softmax_launch"):
        # B6 with every row block on its looped path (the first design's
        # three sweeps), in trees that have it
        cases["B6_F256_looped"] = lambda: ab._edge_softmax_launch(
            b, "tgt_edge_softmax_blocked", device, s16.data_ptr(),
            looped=True)
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


def b7_cases(p, device):
    """``{name: (fn, calls)}`` of B7 at the GAT's layer shapes (H=4, layers
    1-2; H=1, layer 3) on seeded (N, H) logit tables: on their (H, T, C)
    logits with NaN in the pad lanes (the scores-in entry) and on the
    tables themselves (the logits-in entry; a tree without it times what
    its composed route ran instead: the torch gathers of the logits, then
    the scores-in entry).  At H=1 a parent's turn times B7's own kernels
    and a tree whose wrappers take B6's kernel at one head times that, so
    the A/B compares the two."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab

    b = p["blocked"]
    n = p["x_table"].shape[0]
    gen = torch.Generator().manual_seed(7)
    logits_in = getattr(ab, "_gat_edge_softmax_blocked_cuda", None)

    def torch_logits(a_s, a_d):
        return ab.edge_softmax_blocked_multihead_cuda(
            b, ab.gat_edge_logits_blocked(b, a_s, a_d).movedim(-1, 0))

    out = {}
    for H in (4, 1):
        a_s = torch.randn((n, H), generator=gen).to(device)
        a_d = torch.randn((n, H), generator=gen).to(device)
        s = chip_smoke._nan_pads(b, ab.gat_edge_logits_blocked(
            b, a_s, a_d).movedim(-1, 0).contiguous())
        out[f"B7_scores_H{H}"] = (
            lambda s=s: ab.edge_softmax_blocked_multihead_cuda(b, s), 10)
        out[f"B7_logits_H{H}"] = (
            (lambda a_s=a_s, a_d=a_d: logits_in(b, a_s, a_d))
            if logits_in is not None else
            (lambda a_s=a_s, a_d=a_d: torch_logits(a_s, a_d)), 10)
    return out


def gat_kernel_cases(p, device):
    """``{name: (fn, calls)}`` of B3 and B9 at the shapes the GAT gives
    them, on seeded rows and logit tables: B3 in the vec mode (the GATv1
    projection GATConv uses) at layers 1-2 (H=4, D=64) in float32 and
    bfloat16 and at layer 3 (H=1, D=47) in float32; B9 at H=4, D=64 in
    float32 and bfloat16."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab

    b = p["blocked"]
    n = p["x_table"].shape[0]
    gen = torch.Generator().manual_seed(5)
    out = {}
    for H, D in ((4, 64), (1, 47)):
        h = torch.randn((n, H, D), generator=gen).to(device)
        a_s = torch.randn((n, H), generator=gen).to(device)
        a_d = torch.randn((n, H), generator=gen).to(device)
        vec = (torch.randn((H, D), generator=gen) / D ** 0.5).to(device)
        for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            if H == 1 and dt == torch.bfloat16:
                continue
            hc = h.to(dt)
            out[f"B3_vec_H{H}_D{D}_{tag}"] = (
                lambda hc=hc, a_d=a_d, vec=vec, dt=dt:
                ab.gat_attend_blocked_packed_cuda(
                    b, hc, None, a_d, alpha_src_vec=vec, compute_dtype=dt),
                10)
            if H == 4:
                out[f"B9_H{H}_D{D}_{tag}"] = (
                    lambda hc=hc, a_s=a_s, a_d=a_d, dt=dt:
                    ab.gat_attend_blocked_flash_cuda(
                        b, hc, a_s, a_d, compute_dtype=dt), 10)
    return out


def host_ms(fn) -> float:
    """Host clock of one call of ``fn`` ending in a synchronise, after one
    warm-up call: what a caller waits, the wrapper's host work and its
    synchronisations included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def kernel_split(fn):
    """``{kernel name: device ms}`` of one call of ``fn`` under
    ``torch.profiler`` (empty where the profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the tracer can miss the first kernel of its window: a short
            # spin kernel goes first and is left out below
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:          # a sandbox may refuse the tracer
        return {"error": str(exc).splitlines()[0]}
    out = {}
    for ev in prof.key_averages():
        if "spin_kernel" in ev.key:
            continue
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
    # the kernels of one B4 call (count, main, merge), of one B5 call, of
    # one B6 call and of one B10 call (B5's kernel, the row stats,
    # rows_kernel)
    res["profile"] = {k: kernel_split(cases[k][0])
                      for k in ("B4_row_F256_bf16", "B5_F256_bf16", "B6_F256",
                                "B10_F256_bf16", "B10_F256_f32")}
    print("profile", json.dumps(res["profile"]), flush=True)
    slots = getattr(sys.modules["tch_geometric_tpu_torch.ops.attention_blocked"]
                    .attend_blocked_flash_cuda, "last_slots", None)
    res["b4_split_slots_last_call"] = slots
    time_cases(b8_cases(p, xs, device), res)
    del xs
    torch.cuda.empty_cache()
    # B7's two entries, and the kernels of one call of each at H=4
    # (pre-pass, main kernel; the parent's one kernel, or its torch
    # logits and kernel)
    b7 = b7_cases(p, device)
    time_cases(b7, res)
    for k in ("B7_scores_H4", "B7_logits_H4", "B7_scores_H1",
              "B7_logits_H1"):
        res["profile"][k] = kernel_split(b7[k][0])
    print("profile", json.dumps({k: res["profile"][k] for k in
                                 ("B7_scores_H4", "B7_logits_H4",
                                  "B7_scores_H1", "B7_logits_H1")}),
          flush=True)
    del b7
    torch.cuda.empty_cache()
    # B3 and B9: times, the kernels of one call of each (projection,
    # pre-pass, main, merge; the slot count's copy to the host), the host
    # clock of that call and the split-row slot counts
    gcases = gat_kernel_cases(p, device)
    time_cases(gcases, res)
    ab_mod = sys.modules["tch_geometric_tpu_torch.ops.attention_blocked"]
    for k, wrapper in (("B3_vec_H4_D64_f32", "gat_attend_blocked_packed_cuda"),
                       ("B9_H4_D64_f32", "gat_attend_blocked_flash_cuda")):
        res["profile"][k] = kernel_split(gcases[k][0])
        res.setdefault("host_ms", {})[k] = host_ms(gcases[k][0])
        res.setdefault("split_slots_last_call", {})[k] = getattr(
            getattr(ab_mod, wrapper), "last_slots", None)
    print("profile", json.dumps({k: res["profile"][k] for k in
                                 ("B3_vec_H4_D64_f32", "B9_H4_D64_f32")}),
          "host_ms", res["host_ms"], "slots", res["split_slots_last_call"],
          flush=True)
    del gcases
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
