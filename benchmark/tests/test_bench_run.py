"""``benchmark/run.py`` as the benchmark's command runs it: no result without a card
or without the program, and the controls failing the limits on the card
(``card``-marked: skipped here with a reason)."""
import json
import math
import shutil
import subprocess
import sys

import pytest

from benchmark.core import harness, spec

ROOT = spec.BENCH_DIR.parent
ARGS = ["--workload", "sage-products.train", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would measure")
    out = _run(ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    """A directory that holds only ``BENCHMARK.json`` and the benchmark's
    folder has no program to measure."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("name", ["sage-products.train",
                                  "sage-products.infer"])
def test_controls_fail_at_the_cells_size(card, name):
    """The control (and, for training, the loss over half a batch) in the
    program's place reads past at least one limit; the program does not."""
    cell = spec.load_cell(spec.load_spec(ROOT), name)
    _, loop, _ = harness.prepare(cell, 3000000077, card,
                                   log=lambda *_: None)
    loop.setup()
    loop.window(1.0)
    loop.release()
    limits = cell.limits

    def ok(checks):
        return all(math.isfinite(checks[k]) and checks[k] <= limits[k]
                   for k in limits)

    assert ok(loop.check()), json.dumps(loop.check())
    for c in loop.controls:
        assert not ok(loop.check(c)), c
