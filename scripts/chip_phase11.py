#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 11 alone on one GPU, after its host prep.

Phase 11 trains the HGT, node2vec and link-prediction models at full width
and needs no CUDA kernel of the port, so this skips the kernel build and
phases 1-10: it builds chip_smoke's products graph (``host_prep``), its 5%
subgraph, the ogbn-mag-shaped graph and the products out-edge CSR, then
runs ``chip_smoke.phase11``.  From the root of a checkout:

    python3 scripts/chip_phase11.py [--out build/phase11.json]

Prints phase 11's lines and the card's name and power limit; writes the
phase's numbers as JSON to ``--out`` when given.
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
        print("chip_phase11: CUDA is not available", file=sys.stderr)
        return 2
    from tch_geometric_tpu_torch.data.storage import to_csr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.gpu_line()
    cs.log(f"card: {card}; torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    t = time.perf_counter()
    p, _prep = cs.host_prep(1.0, dev)
    sg = cs.subgraph(p["data"], dev)
    mag = cs.mag_graph(1.0)
    csr = to_csr(p["data"].edge_index, p["data"].num_nodes)[:2]
    cs.log(f"prep {time.perf_counter() - t:.1f}s")

    def timer(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    res = cs.phase11(p, mag, csr, sg, dev, timer)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(card=card, phase11=res), f, default=str)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
