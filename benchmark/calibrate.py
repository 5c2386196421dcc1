"""Read the numbers that decide ``correct`` over many seeds, for setting
a cell's limits: the program's readings, and the control's and faults'
in the program's place.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--controls 3] [--seconds 2] [--out <file.jsonl>]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, then the check.  On the first ``--controls`` seeds also
each control of the cell's loop (training: the reference in float32
with TF32 products, and the loss over half of each batch; inference: the
reference in the precision below the configuration's) read against the
same reference.  One JSON line per seed on standard output, and in
``--out`` if given.  The benchmark's own runs never run this.
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from benchmark.core import harness, spec
    cell = spec.load_cell(spec.load_spec(ROOT), args.workload)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        gg, loop, _ = harness.prepare(cell, seed, "cuda", log=log)
        loop.setup()
        units, window_s = loop.window(args.seconds)
        loop.release()
        torch.cuda.empty_cache()
        rec = {"workload": cell.name, "seed": seed, "units": units,
               "window_s": window_s, "program": loop.check()}
        if i < args.controls:
            for c in loop.controls:
                rec[c] = loop.check(c)
        rec["seconds"] = time.perf_counter() - t0
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
