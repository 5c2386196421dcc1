"""Host milliseconds a train step spends in the program's spans
``to_device`` (``parallel/train.py``: the seeds' and the labels' copies to
the card, which wait for the stream), summed over the step, the median
over the unprofiled ``step`` records (``benchmark/core/records.py``)."""
from benchmark.core import records


def read(r):
    return records.host_ms("step", "to_device")
