"""The whole train step's share of the card's float32 peak: the sampled
tree's forward matrix-product operations, three times over for forward
and backward, times the steps of the measured window, over the window's
seconds times 67 TFLOP/s.

The operations are counted by the model kind's ``tree_forward_flops``
from the padded tree the configuration fixes (seeds, fanouts, widths),
whatever computes them.
"""
from benchmark.core.peaks import F32_FLOPS


def read(r):
    if r.window_s <= 0 or not r.units:
        return None
    flops = 3 * r.kind.tree_forward_flops(r.cell.config) * r.units
    return 100.0 * flops / (r.window_s * F32_FLOPS)
