"""Run one cell of the benchmark on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``tch_geometric_tpu_torch``).  One process: it makes the
graph and the weights from ``--seed`` on the card, warms up, measures for
``--seconds``, checks the window's output against the plain reference in
``benchmark/reference``, and prints one JSON object as the last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiled segment after the
window.  The numbers compared, each beside its limit, are the last lines
on standard error and the result's last key.  Without a CUDA card it
exits 2 and prints no result; it never falls back to the CPU.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the build and kernel caches: fixed directories inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
# one host thread for the CPU ops: the launch-bound train steps run
# steadier without a pool of intra-op threads beside the main one
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))


def _finite(v):
    """JSON numbers only: an infinite reading prints as 1e300."""
    if isinstance(v, float) and not math.isfinite(v):
        return 1e300
    if isinstance(v, dict):
        return {k: _finite(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_finite(x) for x in v]
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA card: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    from benchmark.core import harness, spec
    cell = spec.load_cell(spec.load_spec(ROOT), args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", t_start=T_START, log=log)
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(_finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
