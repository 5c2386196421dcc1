#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phases 12 and 13 alone on one GPU, after their
host prep.

Phase 12 drives the partitioned graph, the owner-routed exchanges and the
flat partitioned SAGE trainers, phase 13 the 2-axis mesh (the ``hier``
trainers and the DP+TP trainer, held against phase 12's losses); neither
needs a CUDA kernel of the port, so this skips the kernel build and
phases 1-11: it builds chip_smoke's products graph (``host_prep``) and
its 5% subgraph, then runs ``chip_smoke.phase12`` and
``chip_smoke.phase13``, which needs phase 12's losses.  From the root of a
checkout:

    python3 scripts/chip_phase12.py [--out build/phase12.json]

Prints the phases' lines and the card's name and power limit; writes
their numbers as JSON to ``--out`` when given.
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
    ap.add_argument("--out", help="write the phases' numbers here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_phase12: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.gpu_line()
    cs.log(f"card: {card}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    t = time.perf_counter()
    p, prep = cs.host_prep(1.0, dev)
    sg = cs.subgraph(p["data"], dev)
    cs.log(f"prep {time.perf_counter() - t:.1f}s: "
           + ", ".join(f"{k} {v:.1f}s" for k, v in prep.items()))

    def timer(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    res = dict(card=card, phase12=cs.phase12(p, sg, dev, timer))
    res["phase13"] = cs.phase13(p, sg, res["phase12"], dev, timer)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, default=str)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
