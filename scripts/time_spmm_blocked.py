#!/usr/bin/env python3
"""Time the blocked SpMM kernels B1, B2 and B11 and the SAGE forward they carry.

Times the ``tch_geometric_tpu_torch`` package that comes first on
``sys.path``, through its public wrappers only, so the same script times an
older tree of the package as well.  An A/B of two trees runs it in turns, one
process each, in the order parent, change, change, parent, on one machine;
from the root of a checkout, with the parent's package unpacked under a
git-ignored directory:

    mkdir -p build/parent
    git archive <parent> tch_geometric_tpu_torch | tar -x -C build/parent
    for t in build/parent . . build/parent; do
        PYTHONPATH=$t:. python3 scripts/time_spmm_blocked.py
    done

On chip_smoke's ogbn-products graph and layouts (``host_prep``, W=256), each
case is timed by chip_smoke's ``cuda_ms`` (CUDA events over 10 calls after a
warm-up): B1 at F=256 in bfloat16 and float32 and at F=100 in bfloat16, B2 on
the hot half of the hot split at F=256 and F=100 in bfloat16, B11 at F=256
and F=100, and the full-graph SAGE ``blocked_forward`` over the plain and the hot-split
layout (3 calls each).  Each output's float64 sum is printed beside its time,
so the turns can be compared.  Prints one JSON object (also written to
``--out`` when given) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

import chip_smoke


def spmm_cases(p, device):
    """``{name: (fn, calls)}``: B1, B2 and B11 (F=256 and F=100) at
    chip_smoke's shapes (10 calls each) and the SAGE forward over both
    layouts (3 calls each), on
    the layouts and model of ``chip_smoke.host_prep``."""
    from tch_geometric_tpu_torch.ops.attention_blocked import \
        spmm_blocked_weighted_cuda
    from tch_geometric_tpu_torch.ops.spmm_kernels import (
        quantize_rows, spmm_blocked_cuda, spmm_blocked_q8_cuda)

    blocked, hot, x_table = p["blocked"], p["hot"], p["x_table"]
    n = x_table.shape[0]
    x32 = torch.randn((n, 256), generator=torch.Generator().manual_seed(3)
                      ).to(device)
    hb, hw = hot.hot, hot.hot_count

    def b1(x):
        return lambda: spmm_blocked_cuda(blocked, x, agg="sum",
                                         compute_dtype=x.dtype)

    def b2(x):
        return lambda: spmm_blocked_weighted_cuda(hb, x, hw,
                                                  compute_dtype=x.dtype)

    q, s = quantize_rows(x32)
    q100, s100 = quantize_rows(x_table)
    cases = {
        "B1_F256_bf16": b1(x32.to(torch.bfloat16)),
        "B1_F256_f32": b1(x32),
        "B1_F100_bf16": b1(x_table.to(torch.bfloat16)),
        "B2_hot_F256_bf16": b2(x32[hot.hot_ids].to(torch.bfloat16)),
        "B2_hot_F100_bf16": b2(x_table[hot.hot_ids].to(torch.bfloat16)),
        "B11_F256": lambda: spmm_blocked_q8_cuda(blocked, q, s, agg="sum"),
        "B11_F100": lambda: spmm_blocked_q8_cuda(blocked, q100, s100,
                                                 agg="sum"),
    }
    out = {k: (fn, 10) for k, fn in cases.items()}
    model = p["model"]
    for name, layout in (("blocked", blocked), ("hot_split", hot)):
        out[f"forward_{name}"] = (
            lambda layout=layout: model.blocked_forward(x_table, layout), 3)
    return out


def time_cases(cases, res):
    """Times each ``(fn, calls)`` of ``cases`` by ``chip_smoke.cuda_ms``
    into ``res["ms"]``, beside its output's float64 sum in ``res["sum"]``."""
    with torch.no_grad():
        for name, (fn, calls) in cases.items():
            res["sum"][name] = float(fn().double().sum())
            res["ms"][name] = chip_smoke.cuda_ms(fn, calls)
            print(name, res["ms"][name], res["sum"][name], flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_spmm_blocked: CUDA is not available", file=sys.stderr)
        return 2
    import tch_geometric_tpu_torch as pkg
    from tch_geometric_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    card = chip_smoke.gpu_line()
    t0 = time.perf_counter()
    _build.build_all(["spmm_blocked"])
    build_s = time.perf_counter() - t0
    p, _ = chip_smoke.host_prep(args.scale, device)
    blocked, hb = p["blocked"], p["hot"].hot
    res = {"package": str(Path(pkg.__file__).parent), "card": card,
           "scale": args.scale, "build_s": build_s,
           "shape": dict(N=p["x_table"].shape[0], T=blocked.num_chunks,
                         C=blocked.chunk_edges, hot_T=hb.num_chunks,
                         hot_C=hb.chunk_edges, W=blocked.rows_per_block),
           "ms": {}, "sum": {}}
    time_cases(spmm_cases(p, device), res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
