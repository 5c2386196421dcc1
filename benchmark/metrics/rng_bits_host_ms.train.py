"""Host milliseconds a train step spends in the program's spans
``rng_bits`` (``sampling/rng.py``: ``random_bits`` and
``random_bits_each``, launching threefry over counters on the card, for
the sampler's draws and the dropout masks), summed over the step, the
median over the unprofiled ``step`` records
(``benchmark/core/records.py``)."""
from benchmark.core import records


def read(r):
    return records.host_ms("step", "rng_bits")
