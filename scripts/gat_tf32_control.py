"""Read what ``correct`` compares in ``gat-products.infer`` with the program's
float32 linears (projections, skips) in TF32, beside the program as the
configuration states it (TF32 off), on the same seeds.

    python3 scripts/gat_tf32_control.py --seeds 11 12 13 [--out f.jsonl]

For each seed and each setting, in one process: the cell's set-up, a short
window, then the check against the float64 reference; one JSON line each
(``"tf32": false|true``) on standard output, and in ``--out`` if given.
The configuration states TF32 off; this shows whether the cell's limits
tell the two apart.  Needs a CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="gat-products.infer")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark.core import harness, spec
    cell = spec.load_cell(spec.load_spec(ROOT), args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        for tf32 in (False, True):
            t0 = time.perf_counter()
            gg, loop, _ = harness.prepare(
                cell, seed, "cuda",
                log=lambda m: print(m, file=sys.stderr, flush=True))
            # prepare turns TF32 off, as the configuration states
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            loop.setup()
            units, window_s = loop.window(args.seconds)
            loop.release()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.cuda.empty_cache()
            rec = {"workload": cell.name, "seed": seed, "tf32": tf32,
                   "units": units, "window_s": window_s,
                   "program": loop.check(),
                   "seconds": time.perf_counter() - t0}
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del gg, loop
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
