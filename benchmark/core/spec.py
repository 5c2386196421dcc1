"""The benchmark's data: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, limit set,
model kind, loop or per-layer metric sits in a file of its own, found by
name:

* ``benchmark/configs/<config>.json``: the model, its widths, the graph's
  shape, the precision, its source and what was assumed; its
  ``model.kind`` names a model module and its ``graph.generator`` a
  graph generator;
* ``benchmark/traffic/<mix>.json``: the parameters of one traffic mix;
  its ``loop`` names the loop that drives the program;
* ``benchmark/limits/<cell>.json``: the limit of each number that decides
  ``correct`` in that cell;
* ``benchmark/metrics/<metric>.py``: the reader of one per-layer metric;
* ``benchmark/loops/<loop>.py``: a loop (set-up, window, check);
* ``benchmark/graphs/<generator>.py``: a graph generator;
* ``benchmark/models/<kind>.py``: the program's model of one kind paired
  with its plain reference and its operation counts.

So a new cell, configuration, mix, loop, model kind or metric is new
files and entries in ``BENCHMARK.json``; no existing file changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
# the folders whose modules a configuration or a traffic mix names
COMPONENTS = ("loops", "graphs", "models")
_MODULE = re.compile(r"^[a-z_][a-z0-9_]*$")


@dataclass
class Metric:
    name: str
    unit: str
    workloads: Optional[List[str]]


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    chips: int
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _metric(entry: dict) -> Metric:
    return Metric(entry["name"], entry["unit"], entry.get("workloads"))


def load_spec(root: Path) -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return _read_json(root / "BENCHMARK.json")


def _in_cell(m: Metric, cell: str) -> bool:
    return m.workloads is None or cell in m.workloads


def load_cell(spec: dict, name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration, traffic mix,
    limits and metrics read from their files."""
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _read_json(bench_dir.parent / configs[w["config"]]["file"])
    traffic = _read_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _read_json(bench_dir / "limits" / f"{name}.json")
    cell = Cell(name, config, traffic, limits, int(w["chips"]))
    cell.end_to_end = [m for m in map(_metric, spec["end_to_end"])
                       if _in_cell(m, name)]
    cell.per_layer = [m for m in map(_metric, spec["per_layer"])
                      if _in_cell(m, name)]
    return cell


def metric_module(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module ``benchmark/metrics/<name>.py`` (a metric's name
    may hold dots, so it is loaded by path)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def component(folder: str, name: str):
    """The module ``benchmark/<folder>/<name>.py`` of a loop, a graph
    generator or a model kind, imported by name."""
    if folder not in COMPONENTS or not _MODULE.match(name):
        raise ValueError(f"no {folder} module may be called {name!r}")
    return importlib.import_module(f"benchmark.{folder}.{name}")
