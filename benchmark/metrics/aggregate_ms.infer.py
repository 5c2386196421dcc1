"""Device milliseconds a full-graph pass spends in its aggregations: the
device operations launched inside the program's spans ``aggregate``
(``GraphSAGE.blocked_forward``, one a layer: kernel B1 with its cast of
the rows and its division), from the traced passes' Chrome trace
(``benchmark/core/records.py``)."""
from benchmark.core import records


def read(r):
    return records.device_ms(r, "aggregate")
