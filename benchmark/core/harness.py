"""One run of one cell: set-up, the measured window, the optional traced
segment, the check against the reference, and the result line.

``run`` takes the device so that the tests can drive the whole of it on
the CPU, on a configuration whose graph they have shrunk;
``benchmark/run.py`` runs it on the card and refuses to run without one.
The cell's loop, graph generator and model kind are modules found by the
names its configuration and traffic mix give (``spec.component``).
"""
from __future__ import annotations

import contextlib
import importlib
import math
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from . import spec as spec_mod
from . import trace as trace_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "tch_geometric_tpu")


@dataclass
class Readings:
    """What a per-layer metric's reader may read."""
    cell: spec_mod.Cell
    kind: object                  # the model kind's module
    num_nodes: int
    num_edges: int
    build_s: Dict[str, float]
    units: int                    # steps or passes in the measured window
    window_s: float
    trace: Optional[dict] = None  # trace.split of the traced segment
    traced_units: int = 0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def _entry_spans(modules):
    """Wrap each metric's program entry ``(module, function)`` in a
    profiler span of the metric's ``SPAN`` name while tracing."""
    undo = []
    try:
        for m in modules:
            entry = getattr(m, "ENTRY", None)
            if entry is None:
                continue
            mod = importlib.import_module(entry[0])
            fn = getattr(mod, entry[1])

            def wrapped(*a, _fn=fn, _span=m.SPAN, **k):
                with torch.profiler.record_function(_span):
                    return _fn(*a, **k)

            setattr(mod, entry[1], wrapped)
            undo.append((mod, entry[1], fn))
        yield
    finally:
        for mod, name, fn in reversed(undo):
            setattr(mod, name, fn)


def _trace(loop, units: int, modules, device, log=print) -> dict:
    spans = set(loop.spans)
    for m in modules:
        spans.update(getattr(m, "SPANS", ()))
        if getattr(m, "ENTRY", None) is not None:
            spans.add(m.SPAN)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        with _entry_spans(modules), torch.profiler.profile(
                activities=acts) as prof:
            with torch.profiler.record_function("bench_window"):
                loop.traced(units)
                _sync(device)
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        t1 = time.perf_counter()
        host, dev = trace_mod.read_chrome_trace(path)
        out = trace_mod.split(host, dev, "bench_window", sorted(spans))
    log(f"trace: {units} {loop.unit}, {len(host)} host and {len(dev)} "
        f"device events; export {t1 - t0:.1f} s, read "
        f"{time.perf_counter() - t1:.1f} s")
    check_entries(out, modules)
    return out


def check_entries(split: dict, modules) -> None:
    """Raise where a reader's program entry recorded no device time in
    the traced work: its cell lists the metric, so an entry that the
    program no longer calls by that name fails the run rather than
    leaving the metric out."""
    for m in modules:
        entry = getattr(m, "ENTRY", None)
        if entry is not None and split["device_s_by_span"].get(m.SPAN,
                                                                0) <= 0:
            raise RuntimeError(
                f"the span {m.SPAN!r} around {'.'.join(entry)} recorded no "
                f"device time: the traced work no longer calls that entry")


def _fmt(v: float) -> str:
    return repr(float(v))


def prepare(cell: spec_mod.Cell, seed: int, device, log=print):
    """The generated graph, the program's device graph and the cell's
    loop, not yet set up; and the seconds the device graph took."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.storage import coo_to_csc_device
    device = torch.device(device)
    if device.type == "cuda":
        # the configurations state float32 products without TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gcfg = cell.config["graph"]
    gen = spec_mod.component("graphs", gcfg["generator"])
    gg = gen.generate(gcfg, seed, device)
    _sync(device)
    t0 = time.perf_counter()
    ptr, idx, perm = coo_to_csc_device(gg.src, gg.dst, gg.num_nodes,
                                       gg.num_nodes)
    graph = make_graph(ptr, idx, perm, num_src=gg.num_nodes,
                       num_dst=gg.num_nodes, device=device)
    _sync(device)
    build_s = {"graph": time.perf_counter() - t0}
    deg = (ptr[1:] - ptr[:-1]).float()
    log(f"graph: {gg.num_nodes} nodes, {gg.num_edges} edges, in-degree "
        f"max {int(deg.max())} median {float(deg.median())}")
    del ptr, idx, perm, deg
    loop_mod = spec_mod.component("loops", cell.traffic["loop"])
    loop = loop_mod.Loop(cell, gg, graph, seed, device)
    return gg, loop, build_s


def run(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool,
        device, *, t_start: Optional[float] = None, log=print) -> dict:
    """One run; returns the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    gg, loop, build_s = prepare(cell, seed, device, log)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loop.setup()
    build_s.update(getattr(loop, "build_s", {}))
    _sync(device)
    setup_s = time.perf_counter() - t_start

    units, window_s = loop.window(seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    readings = Readings(cell, loop.kind, gg.num_nodes, gg.num_edges,
                        build_s, units, window_s)
    modules = [spec_mod.metric_module(m.name) for m in cell.per_layer]
    if trace:
        readings.traced_units = int(cell.traffic["trace_units"])
        readings.trace = _trace(loop, readings.traced_units, modules,
                                device, log)
    loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = loop.check()
    limits = cell.limits
    correct = all(math.isfinite(checks[k]) and checks[k] <= limits[k]
                  for k in limits)

    if trace:
        metrics = {}
        for m, mod in zip(cell.per_layer, modules):
            v = mod.read(readings)
            if v is not None:
                metrics[m.name] = {"value": float(v), "unit": m.unit}
    else:
        # besides setup_s, a cell's end-to-end metric is its rate of work
        rate = loop.work(units) / window_s
        metrics = {m.name: {"value": float(setup_s if m.name == "setup_s"
                                           else rate), "unit": m.unit}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power_limit"] = power_limit()
    result = {"correct": bool(correct), "attempted": int(units),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        t = readings.trace
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    log(f"cell {cell.name} seed {seed}: {units} {loop.unit} in "
        f"{window_s:.3f} s; setup {setup_s:.3f} s; build {build_s}")
    for k in limits:
        log(f"check {k} {_fmt(checks[k])} limit {_fmt(limits[k])}")
    return result
