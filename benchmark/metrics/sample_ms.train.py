"""Device milliseconds a train step spends under the trainer's ``sample``
span (``sampling/``: the neighbour engines and their threefry draws), from
the traced steps."""

SPANS = ("sample",)


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    s = r.trace["device_s_by_span"].get("sample", 0.0)
    return s * 1e3 / r.traced_units if s > 0 else None
