"""Structured per-step metrics, step records and profiling hooks.

Counterpart of ``tch_geometric_tpu/utils/metrics.py``: ``MetricsLogger``
writes JSON-lines step records (step time, edges/s, minibatches/s) with the
same keys; ``profile`` records a ``torch.profiler`` trace and writes it as a
Chrome trace.

``trace_span`` is the port's step recorder.  A span records its name, its
parent and its start and end on the host clock, always.  A span opened on a
thread with no open span is a root: it opens a record (``id=``, e.g. the
train step's number), and when it closes the record joins a ring of the
last ``RING`` records of that root name, read by :func:`span_records`
(in memory; nothing is written).  A record keeps its first ``SPANS``
spans and counts the rest in ``dropped``.  A span opened while a
``torch.profiler`` records (looked up at each span) is also a
``record_function`` of its name in the trace, and, where CUDA is
initialised, a pair of timing events on the current stream, read as the
span's ``device_ms``; its record is then ``profiled``.  The host stamps
are Unix nanoseconds, the clock the profiler's Chrome trace counts from
its ``baseTimeNanoseconds``: the monotonic ``perf_counter_ns`` plus the
Unix clock's offset from it, read when the root opens, so durations
never run backwards.

The ranks of a thread mesh run on threads of their own, where the phases
they open are roots of their own: a ``step`` record holds the phases of
the single-device trainers.

The trainers' spans: ``step`` (the root, id the state's step), ``sample``,
``gather``, ``forward`` (forward, loss and backward), ``update`` and
``to_device`` (blocking copies to the card); ``sampling/rng.py``'s
``rng_keys`` (key derivation on the host) and ``rng_bits`` (threefry over
counters on the draw's device); ``models/dropout.py``'s ``dropout`` (the
masks); ``GraphSAGE.blocked_forward``'s ``blocked_forward`` and one
``aggregate`` a layer.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, Iterator, List, Optional, TextIO

import torch
import torch.autograd.profiler as _autograd_profiler

RING = 256          # records kept of each root name
SPANS = 4096        # spans kept in one record


class Span:
    """One span of a record: ``parent`` is the index in ``Record.spans`` of
    the nearest kept span that encloses it (None for the root);
    ``start_ns`` and ``end_ns`` are Unix nanoseconds; ``device_ms`` the
    stream's time between its two events (None unless opened under a
    profiler on CUDA): its kernels and any wait of the stream for the
    host's launches inside the span."""
    __slots__ = ("name", "parent", "start_ns", "end_ns", "device_ms",
                 "_events")

    def __init__(self, name: str, parent: Optional[int]):
        self.name, self.parent = name, parent
        self.start_ns = self.end_ns = 0
        self.device_ms: Optional[float] = None
        self._events = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Record:
    """The spans of one root, root first, in the order they opened; the
    spans past the first ``SPANS`` are not kept, only counted in
    ``dropped``.  ``profiled``: a profiler recorded while one of its spans
    opened."""
    __slots__ = ("name", "id", "profiled", "spans", "dropped")

    def __init__(self, name: str, id):
        self.name, self.id, self.profiled = name, id, False
        self.spans: List[Span] = []
        self.dropped = 0


class _Open(threading.local):
    """This thread's open record, the indices of its open spans and the
    Unix clock's offset from ``perf_counter_ns`` (the thread meshes run
    their ranks as threads)."""

    def __init__(self):
        self.record: Optional[Record] = None
        self.stack: List[int] = []
        self.offset = 0


_open = _Open()
_rings: Dict[str, Deque[Record]] = {}


class trace_span:
    """``with trace_span(name, id=None):`` a span of the step recorder
    (module doc); ``id`` names the record when the span is a root."""
    __slots__ = ("name", "id", "_span", "_rf")

    def __init__(self, name: str, id=None):
        self.name, self.id = name, id

    def __enter__(self) -> "trace_span":
        th = _open
        stack = th.stack
        if stack:
            rec, parent = th.record, stack[-1]
        else:
            th.offset = time.time_ns() - time.perf_counter_ns()
            rec = th.record = Record(self.name, self.id)
            parent = None
        span = self._span = None
        if len(rec.spans) < SPANS:
            span = self._span = Span(self.name, parent)
            stack.append(len(rec.spans))
            rec.spans.append(span)
            # the host stamps bracket the span's event in a profiler's trace
            span.start_ns = time.perf_counter_ns() + th.offset
        else:
            rec.dropped += 1
            stack.append(parent)
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            rec.profiled = True
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            if span is not None and torch.cuda.is_initialized():
                span._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                span._events[0].record()
        return self

    def __exit__(self, *exc) -> None:
        span = self._span
        if self._rf is not None:
            if span is not None and span._events is not None:
                span._events[1].record()
            self._rf.__exit__(*exc)
        th = _open
        if span is not None:
            span.end_ns = time.perf_counter_ns() + th.offset
        th.stack.pop()
        if not th.stack:
            rec, th.record = th.record, None
            ring = _rings.get(rec.name)
            if ring is None:
                ring = _rings.setdefault(rec.name,
                                         collections.deque(maxlen=RING))
            ring.append(rec)


def step_span(train_step):
    """Run ``train_step(state, ...)`` inside the root span ``step`` whose
    id is ``state.step``."""
    @functools.wraps(train_step)
    def stepped(state, *args, **kwargs):
        with trace_span("step", id=state.step):
            return train_step(state, *args, **kwargs)
    return stepped


def span_records(root: str) -> List[Record]:
    """The ring's records of the root span ``root``, oldest first.  The
    spans' device times are resolved here, each after its end event has
    completed."""
    records = list(_rings.get(root, ()))
    for r in records:
        for s in r.spans:
            if s._events is not None:
                start, end = s._events
                end.synchronize()
                s.device_ms, s._events = start.elapsed_time(end), None
    return records


def span_ms(record: Record, name: str, device: bool = False
            ) -> Optional[float]:
    """Inclusive milliseconds of the spans ``name`` in ``record`` (a span
    inside another of the same name counted once), host or, with
    ``device``, the spans' ``device_ms``: 0.0 where there is no such span,
    None where one of them has no device time.  A span's self time is its
    time less its children's (the spans whose ``parent`` is its index)."""
    spans = record.spans
    total = 0.0
    for s in spans:
        if s.name != name:
            continue
        p = s.parent
        while p is not None and spans[p].name != name:
            p = spans[p].parent
        if p is None:
            v = s.device_ms if device else s.host_ms
            if v is None:
                return None
            total += v
    return total


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
