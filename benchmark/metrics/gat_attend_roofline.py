"""Share of its roofline that the full-graph GAT pass's attention reaches:
the least time the card could take for the attention of one pass's three
layers, over the device time of the operations launched inside the
program's spans ``aggregate`` (``GAT.blocked_forward``, one a layer: the
alpha_dst table, kernel B3 with self loops and its cast of the rows, the
heads joined), per traced pass (``benchmark/core/records.py``).

The least time counts the graph's work, not the layout's: per layer the
int32 edge indices and row offsets once, each input row once in the
compute dtype, the two (N, H) float32 logit tables, the float32 output
(N, H*D) once, and per edge and self loop and head the logit, its
exponential, the sums (6 operations) and a multiply-add per column; the
larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s.
"""
from benchmark.core import records
from benchmark.core.peaks import least_seconds

ROW_BYTES = {"bfloat16": 2, "float32": 4}


def layer_counts(num_nodes, num_edges, heads, width, row_bytes):
    """(operations, bytes) of one layer's attention over ``heads`` heads
    of ``width`` columns."""
    cols = heads * width
    nbytes = (4 * num_edges + 4 * (num_nodes + 1)
              + row_bytes * num_nodes * cols + 2 * 4 * num_nodes * heads
              + 4 * num_nodes * cols)
    return (num_edges + num_nodes) * heads * (2 * width + 6), nbytes


def least_pass_seconds(config, num_nodes, num_edges):
    m, g = config["model"], config["graph"]
    widths = ([m["hidden"]] * (m["num_layers"] - 1) + [g["num_classes"]])
    rb = ROW_BYTES[config["infer"]["agg_dtype"]]
    return sum(least_seconds(*layer_counts(num_nodes, num_edges, m["heads"],
                                           w, rb))
               for w in widths)


def read(r):
    ms = records.device_ms(r, "aggregate")
    if ms is None:
        return None
    least = least_pass_seconds(r.cell.config, r.num_nodes, r.num_edges)
    return 100.0 * least * 1e3 / ms
