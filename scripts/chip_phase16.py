#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 16 alone on one GPU, after its host prep.

Phase 16 drives the distributed HGT sampler, ``HGT(psum_axis=)`` and the
partitioned HGT trainer; none needs a CUDA kernel of the port, so this
skips the kernel build and phases 1-15: it builds chip_smoke's mag-shaped
graph, then runs ``chip_smoke.phase16``.
From the root of a checkout:

    python3 scripts/chip_phase16.py [--out build/phase16.json]

Prints the phase's lines and the card's name and power limit; writes its
numbers as JSON to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="write the phase's numbers here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_phase16: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.gpu_line()
    cs.log(f"card: {card}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    t = time.perf_counter()
    mag = cs.mag_graph(1.0, dev)
    cs.log(f"prep (the mag-shaped graph) {time.perf_counter() - t:.1f}s")

    def timer(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    res = dict(card=card, phase16=cs.phase16(mag, dev, timer))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, default=str)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
