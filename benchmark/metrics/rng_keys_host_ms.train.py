"""Host milliseconds a train step spends in the program's spans
``rng_keys`` (``sampling/rng.py``: ``fold_in`` and ``split``, threefry
key derivation on the host, for the step, each hop and draw of the
sampler, and each dropout mask), summed over the step, the median over the
unprofiled ``step`` records (``benchmark/core/records.py``)."""
from benchmark.core import records


def read(r):
    return records.host_ms("step", "rng_keys")
