"""Percent of the traced full-graph passes' wall time in which no
operation ran on the device (the profiler adds little to a pass of a few
hundred large launches)."""


def read(r):
    if r.trace is None or r.trace["busy_s"] <= 0:
        return None
    return 100.0 * r.trace["idle_share"]
