"""Share of its roofline that the full-graph SAGE pass's mean aggregation
reaches: the least time the card could take for the aggregations of one
pass, over the device time under the program's entry
``ops.spmm_kernels.spmm_blocked_auto`` (kernel B1, with its cast of the
rows and its division by the degree), per traced pass.

The least time counts the graph's work, not the layout's: per layer, the
edge indices (int32) and row offsets (int32) read once, every input row
read once in the compute dtype, the float32 output written once, and one
add an edge and feature; the larger of bytes over 3.35 TB/s and
operations over 67 TFLOP/s.
"""
from benchmark.core.peaks import least_seconds

ENTRY = ("tch_geometric_tpu_torch.ops.spmm_kernels", "spmm_blocked_auto")
SPAN = "spmm_agg"
ROW_BYTES = {"bfloat16": 2, "float32": 4}


def layer_counts(num_nodes, num_edges, width, row_bytes):
    """(operations, bytes) of one mean aggregation."""
    nbytes = (4 * num_edges + 4 * (num_nodes + 1)
              + row_bytes * num_nodes * width + 4 * num_nodes * width)
    return num_edges * width, nbytes


def least_pass_seconds(config, num_nodes, num_edges):
    m, g = config["model"], config["graph"]
    widths = [g["num_features"]] + [m["hidden"]] * (m["num_layers"] - 1)
    rb = ROW_BYTES[config["infer"]["agg_dtype"]]
    return sum(least_seconds(*layer_counts(num_nodes, num_edges, w, rb))
               for w in widths)


def read(r):
    if r.trace is None or not r.traced_units:
        return None
    s = r.trace["device_s_by_span"].get(SPAN, 0.0)
    if s <= 0:
        return None
    least = least_pass_seconds(r.cell.config, r.num_nodes, r.num_edges)
    return 100.0 * least * r.traced_units / s
