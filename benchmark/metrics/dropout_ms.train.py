"""Device milliseconds a train step spends in the dropout masks: the
device operations launched inside the program's spans ``dropout``
(``models/dropout.py::keyed_dropout``: the masks' threefry and their
product; the product's backward runs outside them), from the traced
steps' Chrome trace (``benchmark/core/records.py``)."""
from benchmark.core import records


def read(r):
    return records.device_ms(r, "dropout")
