"""Percent of the measured window's time in which no operation ran on the
device: one less the device's busy seconds a step, read from the traced
steps, times the window's steps, over the window's seconds.

The traced steps' own idle share is not used: the profiler's host
overhead on this launch-bound step stretches the traced window (the run's
``device`` still reports that window's ``busy_s`` and ``window_s``), while
the device's busy time a step is what it is without the profiler.
"""


def read(r):
    if r.trace is None or r.trace["busy_s"] <= 0 or not r.traced_units:
        return None
    busy = r.trace["busy_s"] / r.traced_units * r.units
    return 100.0 * (1.0 - busy / r.window_s)
