"""Readings of the program's own spans: its step records, read in memory
(``tch_geometric_tpu_torch.utils.metrics.span_records``), for the host,
and the traced segment's Chrome trace, for the device.

A host reading is a span name's inclusive host milliseconds in one record
of a root, the median over the records taken with no profiler running
(set-up's check steps and the window's: no profiler stretch).

A device reading is the device time of the operations launched inside the
program's spans of a name (under the profiler each span is a
``record_function`` of its name), over the traced units: ``trace.split``'s
arithmetic, run apart from the harness's split with that one name, so the
split and the readers that list spans read what they read before.  The
harness hands the readers no raw events, so this module keeps the events
of the last trace ``trace.read_chrome_trace`` read, by wrapping that
function when imported; the wrapped function returns what it returned.

A program without the step recorder gives no reading (None), so these
readers laid over an older program leave their metrics out.  With the
recorder, a reading that finds no records, or no time in the span it
reads, fails the run: the cell lists the metric, so a span renamed or
moved out of its root fails rather than leaving the metric out.
"""
from __future__ import annotations

import statistics
from typing import Optional

from . import trace as trace_mod

# the harness's name for the traced segment's window span
WINDOW = "bench_window"

_read_chrome_trace = trace_mod.read_chrome_trace
_last_events = None


def _read_and_keep(path):
    global _last_events
    _last_events = _read_chrome_trace(path)
    return _last_events


trace_mod.read_chrome_trace = _read_and_keep


def _recorder():
    """The program's metrics module where it has the step recorder."""
    from tch_geometric_tpu_torch.utils import metrics
    return metrics if hasattr(metrics, "span_records") else None


def host_ms(root: str, name: str) -> Optional[float]:
    """Median host ms of ``name`` a record of ``root``, unprofiled."""
    metrics = _recorder()
    if metrics is None:
        return None
    values = [metrics.span_ms(r, name) for r in metrics.span_records(root)
              if not r.profiled]
    if not values:
        raise RuntimeError(f"the program recorded no unprofiled {root!r} "
                           f"record")
    median = statistics.median(values)
    if median <= 0:
        raise RuntimeError(f"the program's {root!r} records hold no span "
                           f"{name!r}")
    return median


def device_ms(r, name: str) -> Optional[float]:
    """Device ms a traced unit of the operations launched inside the
    program's spans ``name``; None without a device or a recorder."""
    if (_recorder() is None or r.trace is None or not r.traced_units
            or not r.trace["device_events"]):
        return None
    host, dev = _last_events
    s = trace_mod.split(host, dev, WINDOW, [name])["device_s_by_span"][name]
    if s <= 0:
        raise RuntimeError(f"the program's spans {name!r} launched no device "
                           f"work in the traced segment")
    return s * 1e3 / r.traced_units
