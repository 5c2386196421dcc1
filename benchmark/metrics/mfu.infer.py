"""The whole full-graph pass's share of the card's float32 peak: the
pass's matrix-product and aggregation operations, counted by the model
kind's ``pass_flops`` from the graph's nodes and edges and the model's
widths, times the passes of the measured window, over the window's
seconds times 67 TFLOP/s.
"""
from benchmark.core.peaks import F32_FLOPS


def read(r):
    if r.window_s <= 0 or not r.units:
        return None
    flops = (r.kind.pass_flops(r.cell.config, r.num_nodes, r.num_edges)
             * r.units)
    return 100.0 * flops / (r.window_s * F32_FLOPS)
