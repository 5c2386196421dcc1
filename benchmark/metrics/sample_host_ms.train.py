"""Host milliseconds a train step spends in the program's span ``sample``
(the neighbour sampler, its key derivation and its threefry launches),
inclusive, the median over the unprofiled ``step`` records
(``benchmark/core/records.py``)."""
from benchmark.core import records


def read(r):
    return records.host_ms("step", "sample")
