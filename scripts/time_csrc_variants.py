#!/usr/bin/env python3
"""Time the row-grouped kernels (B1-B3, B5, B7-B11) built from several copies of the kernel sources, in one process.

A variant is a copy of ``tch_geometric_tpu_torch/csrc`` with one change (a
launch bound, another way to read the weights).  Each is built from its own
directory (``_build`` names a library by the hash of its sources, so the
builds do not mix) and timed on the same inputs, in the turns given, on one
card: from the root of a checkout,

    cp -r tch_geometric_tpu_torch/csrc build/v1    # then edit build/v1
    python3 scripts/time_csrc_variants.py --csrc v1=build/v1 \\
        --turns base,v1,base,v1

``base`` is the package's own ``csrc``.  On chip_smoke's ogbn-products
graph and layout (``host_prep``, W=256), prepared once: B5 at F=256 in
bfloat16, B10 at F=256 in bfloat16 and float32 and at F=100 in bfloat16, B8
at the shapes of ``time_attend_blocked.b8_cases``, B7 at those of
``time_attend_blocked.b7_cases``, B3 and B9 at those of
``time_attend_blocked.gat_kernel_cases``, and B1, B2, B11 and the SAGE
forwards of ``time_spmm_blocked.spmm_cases`` (``--only B3,B9`` keeps the
cases whose names start so), each by chip_smoke's
``cuda_ms`` (CUDA events over 10 calls after a warm-up, the forwards over
3) beside its output's float64 sum.  Prints one line
a case with its time in each turn, and the card's name and power limit;
writes the JSON to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from time_attend_blocked import (b7_cases, b8_cases,  # noqa: E402
                                 gat_kernel_cases)
from time_spmm_blocked import spmm_cases  # noqa: E402


def cases(p, device):
    """``{name: (fn, calls)}`` of the timed calls."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab

    b = p["blocked"]
    xs = chip_smoke.attend_inputs(p, device)
    bf, f32 = torch.bfloat16, torch.float32
    x256, x256f, x100 = xs[256].to(bf), xs[256].float(), xs[100].to(bf)
    out = {
        "B5_F256_bf16": lambda: ab.sddmm_blocked_cuda(b, x256, x256),
        "B10_F256_bf16": lambda: ab.attend_blocked_fused_cuda(b, x256, x256),
        "B10_F256_f32": lambda: ab.attend_blocked_fused_cuda(
            b, x256f, x256f, compute_dtype=f32),
        "B10_F100_bf16": lambda: ab.attend_blocked_fused_cuda(b, x100, x100),
    }
    out = {k: (fn, 10) for k, fn in out.items()}
    out.update(b8_cases(p, xs, device))
    out.update(b7_cases(p, device))
    out.update(gat_kernel_cases(p, device))
    out.update(spmm_cases(p, device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", action="append", default=[],
                    metavar="NAME=DIR", help="a variant's source directory")
    ap.add_argument("--turns", default=None,
                    help="comma-separated variant names in timing order "
                         "(default: base, then each variant, then base)")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--only", default=None,
                    help="comma-separated prefixes of the cases to time")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_csrc_variants: CUDA is not available", file=sys.stderr)
        return 2
    from tch_geometric_tpu_torch.ops import _build

    dirs = {"base": _build.CSRC}
    for spec in args.csrc:
        name, _, d = spec.partition("=")
        dirs[name] = Path(d).resolve()
    turns = (args.turns.split(",") if args.turns
             else ["base", *[n for n in dirs if n != "base"], "base"])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.gpu_line()
    p, _ = chip_smoke.host_prep(args.scale, device)
    fns = cases(p, device)
    if args.only:
        keep = tuple(args.only.split(","))
        fns = {k: v for k, v in fns.items() if k.startswith(keep)}
    res = {"card": card, "turns": turns, "ms": {}, "sum": {}}
    for turn in turns:
        _build.CSRC = dirs[turn]
        _build._loaded.clear()
        _build.build_all(["spmm_blocked", "gat_blocked", "attend_blocked"])
        with torch.no_grad():
            for k, (fn, calls) in fns.items():
                res["sum"].setdefault(k, []).append(float(fn().double().sum()))
                res["ms"].setdefault(k, []).append(
                    chip_smoke.cuda_ms(fn, calls))
    for k, v in res["ms"].items():
        print(k, " ".join(f"{t}={ms:.3f}" for t, ms in zip(turns, v)),
              flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(res, indent=1))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
