"""``BENCHMARK.json`` against the benchmark's contract, and the
data-driven layout: a new configuration, traffic mix and per-layer
metric are files and entries, with no code changed."""
import json
import re
import shutil

import pytest

from benchmark.core import spec

ROOT = spec.BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_spec(ROOT)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_loads_with_its_metrics(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(bench, w["name"])
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_module(m.name).read)
        assert cell.limits and all(v >= 0 for v in cell.limits.values())


LOOP = '''"""Two full-graph passes a unit of work."""
import torch

from benchmark.loops.infer import SPANS, Loop as _Infer


class Loop(_Infer):
    unit = "double passes"

    @torch.no_grad()
    def _pass(self):
        super()._pass()
        return super()._pass()

    def work(self, units):
        return 2 * super().work(units)
'''

KIND = '''"""GraphSAGE under a kind name of its own."""
from benchmark.models.sage import *  # noqa: F401,F403
'''

GENERATOR = '''"""The products generator with half its training split."""
from benchmark.graphs.products import generate as _generate


def generate(cfg, seed, device):
    gg = _generate(cfg, seed, device)
    gg.train_idx = gg.train_idx[: max(1, gg.train_idx.shape[0] // 2)]
    return gg
'''


def test_adding_a_cell_is_files_and_entries(tmp_path, bench):
    """On a copy: a new configuration, traffic mix, limit file, metric
    reader, loop, graph generator and model kind, each a new file, and
    their entries in ``BENCHMARK.json`` drive a whole run of a new cell on
    the CPU with no existing file changed and the accepted cells as they
    were."""
    import subprocess
    import sys
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    (root / "benchmark/loops/twice.py").write_text(LOOP)
    (root / "benchmark/models/sage_alias.py").write_text(KIND)
    (root / "benchmark/graphs/half_train.py").write_text(GENERATOR)
    cfg = json.loads((ROOT / "benchmark/configs/sage-products.json")
                     .read_text())
    cfg["name"] = "alias-products"
    cfg["model"]["kind"] = "sage_alias"
    cfg["graph"]["generator"] = "half_train"
    (root / "benchmark/configs/alias-products.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((ROOT / "benchmark/traffic/infer.json").read_text())
    traffic.update(loop="twice", warmup_passes=1)
    (root / "benchmark/traffic/twice.json").write_text(json.dumps(traffic))
    (root / "benchmark/limits/alias-products.twice.json").write_text(
        (ROOT / "benchmark/limits/sage-products.infer.json").read_text())
    (root / "benchmark/metrics/passes_per_s.twice.py").write_text(
        "def read(r):\n    return 2 * r.units / r.window_s\n")
    b = json.loads(json.dumps(bench))
    b["configs"].append({"name": "alias-products", "source": "x",
                         "file": "benchmark/configs/alias-products.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "alias-products.twice",
                           "config": "alias-products", "traffic": "twice",
                           "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "infer_nodes_per_s":
            m["workloads"].append("alias-products.twice")
    b["per_layer"].append({"name": "passes_per_s.twice", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "infer_nodes_per_s",
                           "workloads": ["alias-products.twice"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    code = f"""
import json, sys
sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]
from benchmark.conftest import scaled_graph
from benchmark.core import harness, spec
cell = spec.load_cell(spec.load_spec(spec.BENCH_DIR.parent),
                      "alias-products.twice")
cell.config["graph"] = scaled_graph(cell.config["graph"], 2e-3)
runs = [harness.run(cell, 2**31 + 11, 0.2, t, "cpu", log=lambda *_: None)
        for t in (False, True)]
import benchmark.loops.twice as d, benchmark.models.sage_alias as k
import benchmark.graphs.half_train as g
print(json.dumps({{"runs": runs, "files": [d.__file__, k.__file__,
                                          g.__file__]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert all(f.startswith(str(root)) for f in res["files"])
    plain, traced = res["runs"]
    assert plain["correct"] and traced["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"setup_s", "infer_nodes_per_s"}
    assert set(traced["metrics"]) == {"passes_per_s.twice"}
    rate = plain["metrics"]["infer_nodes_per_s"]["value"]
    assert rate > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before
    old = spec.load_cell(spec.load_spec(root), "sage-products.infer",
                         root / "benchmark")
    assert old.per_layer == spec.load_cell(bench, "sage-products.infer"
                                           ).per_layer
