"""Device time by span, busy time and idle gaps, from a profiler's Chrome
trace.

The arithmetic of the program's ``chip_smoke.trace_split``, copied here so
that the yardstick does not change with the program: each device event
(kernel, copy, memset) is assigned to the innermost named span whose host
interval holds its launch (the host runtime call with the same
correlation id, on any thread: autograd launches the backward on its
own), else to ``other``.  Busy time is the union of the device intervals
inside the traced window; idle gaps are the holes in that union, each
named after the innermost host operation running at its middle.
"""
from __future__ import annotations

import heapq
import json
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")

Host = Tuple[str, float, float, object, str]     # name, t0, t1, corr, cat
Device = Tuple[str, float, float, object]        # name, t0, t1, corr


def read_chrome_trace(path: str) -> Tuple[List[Host], List[Device]]:
    """Host and device records of a Chrome trace, times in microseconds."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    host, dev = [], []
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, t0 = e.get("cat"), float(e["ts"])
        t1 = t0 + float(e["dur"])
        corr = e.get("args", {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((e["name"], t0, t1, corr))
        elif cat in HOST_CATS:
            host.append((e["name"], t0, t1, corr, cat))
    return host, dev


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, t in sorted(intervals):
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t))
        else:
            out.append((s, t))
    return out


def _innermost(spans, t: float):
    inner = [s for s in spans if s[0] <= t <= s[1]]
    return min(inner, key=lambda s: s[1] - s[0]) if inner else None


def _innermost_at(spans, times) -> List[object]:
    """For each of the sorted ``times``, the name of the span ``(start,
    end, name)`` that holds it and started last (the innermost of nested
    spans), or None: one sweep over the spans sorted by start."""
    order = sorted(spans)
    heap: List[Tuple[float, float, str]] = []
    out, i = [], 0
    for t in times:
        while i < len(order) and order[i][0] <= t:
            s, e, name = order[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def split(host: Sequence[Host], dev: Sequence[Device], window: str,
          spans: Sequence[str]) -> Dict[str, object]:
    """Device time of the one host span named ``window``, by the spans
    named ``spans``; its busy time, idle share, top device operations and
    longest idle gaps.  Times out in seconds."""
    win = [h for h in host if h[0] == window]
    if len(win) != 1:
        raise ValueError(f"trace: one {window!r} span expected, found "
                         f"{len(win)}")
    w0, w1 = win[0][1], win[0][2]
    launch = {h[3]: h[1] for h in host
              if h[4] in ("cuda_runtime", "cuda_driver")}
    named = sorted((h[1], h[2], h[0]) for h in host if h[0] in spans)
    by_span = {s: 0.0 for s in tuple(spans) + ("other", "unattributed")}
    ops: Dict[str, float] = {}
    inside = []
    for name, t0, t1, corr in dev:
        if t1 <= w0 or t0 >= w1:
            continue
        d = t1 - t0
        t = launch.get(corr)
        if t is None:
            where = "unattributed"
        else:
            s = _innermost(named, t)
            where = s[2] if s else "other"
        by_span[where] += d
        ops[name] = ops.get(name, 0.0) + d
        inside.append((max(t0, w0), min(t1, w1)))
    busy_iv = _union(inside)
    busy = sum(t - s for s, t in busy_iv)
    wall = w1 - w0
    ops_host = [(h[1], h[2], h[0]) for h in host
                if h[4] in ("cpu_op", "user_annotation") and h[0] != window]
    edges = [w0] + [x for iv in busy_iv for x in iv] + [w1]
    holes = [(s, t) for s, t in zip(edges[0::2], edges[1::2]) if t > s]
    names = _innermost_at(ops_host, [(s + t) / 2 for s, t in holes])
    gaps: Dict[str, float] = {}
    for (s, t), name in zip(holes, names):
        name = name or "host idle"
        gaps[name] = gaps.get(name, 0.0) + (t - s)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=wall / 1e6, busy_s=busy / 1e6,
                idle_share=1.0 - busy / wall if wall > 0 else 0.0,
                device_events=len(inside),
                device_s_by_span={k: v / 1e6 for k, v in by_span.items()},
                device_ops=[[k, v / 1e6] for k, v in top],
                idle_gaps=[[k, v / 1e6] for k, v in top_gaps])
