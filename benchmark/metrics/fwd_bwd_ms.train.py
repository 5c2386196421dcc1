"""Device milliseconds a train step spends under the trainer's ``forward``
span: the tree forward (``models/{sage,gnn}.py::tree_forward``) with its
dropout, the loss and the backward, from the traced steps."""

SPANS = ("forward",)


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    s = r.trace["device_s_by_span"].get("forward", 0.0)
    return s * 1e3 / r.traced_units if s > 0 else None
