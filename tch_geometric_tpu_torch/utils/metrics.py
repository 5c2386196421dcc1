"""Structured per-step metrics and profiling hooks.

Counterpart of ``tch_geometric_tpu/utils/metrics.py``: ``MetricsLogger``
writes JSON-lines step records (step time, edges/s, minibatches/s) with the
same keys; ``trace_span`` names a region in a ``torch.profiler`` trace (the
trainers' ``sample``, ``gather``, ``forward`` and ``update`` phases), and
``profile`` records one and writes it as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, TextIO

import torch


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Named profiler span (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile(logdir: str) -> Iterator[torch.profiler.profile]:
    """Record the enclosed region with ``torch.profiler`` (CPU, and CUDA
    when a card is present) and write it to ``logdir/trace.json`` as a
    Chrome trace.  Yields the profiler, whose ``events()`` and
    ``key_averages()`` are readable after the block."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class MetricsLogger:
    """JSON-lines step metrics with throughput derivation."""

    stream: TextIO = field(default_factory=lambda: sys.stderr)
    _t_last: Optional[float] = None

    def step(self, step: int, *, edges: Optional[int] = None,
             batch_size: Optional[int] = None, **scalars):
        now = time.perf_counter()
        rec: Dict[str, object] = {"step": int(step)}
        if self._t_last is not None:
            dt = now - self._t_last
            rec["step_time_s"] = round(dt, 6)
            if edges:
                rec["edges_per_s"] = round(edges / dt, 1)
            if batch_size:
                rec["batches_per_s"] = round(1.0 / dt, 3)
        self._t_last = now
        for k, v in scalars.items():
            rec[k] = float(v)
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()
        return rec

    def event(self, **fields):
        """One structured JSON-lines record outside the step cadence
        (benchmark results, phase summaries)."""
        self.stream.write(json.dumps(fields) + "\n")
        self.stream.flush()
        return fields
