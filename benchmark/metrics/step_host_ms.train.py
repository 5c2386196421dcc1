"""Host milliseconds of a train step: the program's root span ``step``
(``parallel/train.py``, around ``train_step``), the median over the
window's and set-up's steps, recorded with no profiler running
(``benchmark/core/records.py``)."""
from benchmark.core import records


def read(r):
    return records.host_ms("step", "step")
