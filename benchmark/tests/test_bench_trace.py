"""The copied trace arithmetic on a hand-made Chrome trace, and each
metric's operation and byte counts on hand-counted tiny shapes."""
import json
from types import SimpleNamespace

import pytest

from benchmark.core import harness, peaks, trace
from benchmark.core.spec import metric_module
from benchmark.models import sage


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


@pytest.fixture
def chrome(tmp_path):
    """A 100 us window: a ``sample`` span launching two kernels, a
    ``forward`` span launching one, a kernel launched outside any span,
    an idle stretch under ``aten::add``."""
    evs = [
        _x("bench_window", "user_annotation", 0, 100),
        _x("sample", "user_annotation", 0, 30),
        _x("aten::add", "cpu_op", 30, 20),
        _x("forward", "user_annotation", 50, 40),
        _x("cudaLaunchKernel", "cuda_runtime", 2, 1, 1),
        _x("cudaLaunchKernel", "cuda_runtime", 10, 1, 2),
        _x("cudaLaunchKernel", "cuda_runtime", 55, 1, 3),
        _x("cudaLaunchKernel", "cuda_runtime", 95, 1, 4),
        _x("k_a", "kernel", 5, 10, 1),      # sample, 5-15
        _x("k_b", "kernel", 12, 8, 2),      # sample, 12-20 (overlaps)
        _x("k_c", "kernel", 60, 20, 3),     # forward, 60-80
        _x("k_a", "kernel", 96, 10, 4),     # other, 96-106, cut at 100
        _x("k_z", "kernel", 150, 5, 9),     # outside the window
        {"ph": "M", "name": "process_name"},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    return str(path)


def test_split_by_span(chrome):
    host, dev = trace.read_chrome_trace(chrome)
    out = trace.split(host, dev, "bench_window", ["sample", "forward"])
    by = out["device_s_by_span"]
    assert by["sample"] == pytest.approx(18e-6)
    assert by["forward"] == pytest.approx(20e-6)
    assert by["other"] == pytest.approx(10e-6)
    assert by["unattributed"] == 0
    # busy: 5-20, 60-80, 96-100
    assert out["busy_s"] == pytest.approx(39e-6)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["idle_share"] == pytest.approx(0.61)
    assert out["device_events"] == 4
    assert out["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    gaps = dict(out["idle_gaps"])
    # 0-5 under sample, 20-60: middle 40 under aten::add, 80-96 under
    # forward (middle 88)
    assert gaps["aten::add"] == pytest.approx(40e-6)
    assert gaps["sample"] == pytest.approx(5e-6)
    assert gaps["forward"] == pytest.approx(16e-6)


def test_split_needs_one_window(chrome):
    host, dev = trace.read_chrome_trace(chrome)
    with pytest.raises(ValueError):
        trace.split(host, dev, "nope", ["sample"])


SAGE = {"model": {"kind": "sage", "hidden": 4, "num_layers": 2},
        "graph": {"num_features": 3, "num_classes": 2},
        "train": {"batch_size": 2, "fanouts": [2, 3]},
        "infer": {"agg_dtype": "bfloat16"}}


def test_train_flops_by_hand():
    m = metric_module("mfu.train")
    # tree slots: 2 seeds, 4 at depth 1, 12 at depth 2; layer 0 over
    # depths 0-1 (6 slots), 2 linears 3->4; layer 1 over the 2 seeds, 2
    # linears 4->2
    assert sage.tree_forward_flops(SAGE) == (2 * 2 * 6 * 3 * 4
                                             + 2 * 2 * 2 * 4 * 2)
    r = SimpleNamespace(cell=SimpleNamespace(config=SAGE), kind=sage,
                        units=10, window_s=2.0)
    assert m.read(r) == pytest.approx(
        100 * 3 * sage.tree_forward_flops(SAGE) * 10
        / (2.0 * peaks.F32_FLOPS))


def test_infer_flops_by_hand():
    m = metric_module("mfu.infer")
    # N=5 nodes, E=7 edges; SAGE 3->4->2
    want = 4 * 5 * 3 * 4 + 7 * 3 + 4 * 5 * 4 * 2 + 7 * 4
    assert sage.pass_flops(SAGE, 5, 7) == want
    r = SimpleNamespace(cell=SimpleNamespace(config=SAGE), kind=sage,
                        num_nodes=5, num_edges=7, units=3, window_s=2.0)
    assert m.read(r) == pytest.approx(
        100 * want * 3 / (2.0 * peaks.F32_FLOPS))


def test_roofline_counts_by_hand():
    spmm = metric_module("spmm_agg_roofline")
    # 5 nodes, 7 edges, width 3, bf16 rows
    assert spmm.layer_counts(5, 7, 3, 2) == (
        7 * 3, 4 * 7 + 4 * 6 + 2 * 5 * 3 + 4 * 5 * 3)
    assert spmm.least_pass_seconds(SAGE, 5, 7) == pytest.approx(
        peaks.least_seconds(*spmm.layer_counts(5, 7, 3, 2))
        + peaks.least_seconds(*spmm.layer_counts(5, 7, 4, 2)))
    r = SimpleNamespace(cell=SimpleNamespace(config=SAGE), num_nodes=5,
                        num_edges=7, traced_units=2,
                        trace={"device_s_by_span": {"spmm_agg": 1e-3}})
    assert spmm.read(r) == pytest.approx(
        100 * spmm.least_pass_seconds(SAGE, 5, 7) * 2 / 1e-3)
    assert peaks.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_an_entry_with_no_device_time_fails_the_run():
    """A roofline whose entry span recorded nothing is not left out: the
    run fails, naming the entry."""
    spmm = metric_module("spmm_agg_roofline")
    harness.check_entries({"device_s_by_span": {"spmm_agg": 1e-3}}, [spmm])
    for split in ({"device_s_by_span": {}},
                  {"device_s_by_span": {"spmm_agg": 0.0}}):
        with pytest.raises(RuntimeError, match="spmm_blocked_auto"):
            harness.check_entries(split, [spmm])
    # readers without an entry are not concerned
    harness.check_entries({"device_s_by_span": {}},
                          [metric_module("idle.infer")])


def test_idle_readers():
    t = {"busy_s": 0.3, "window_s": 1.0, "idle_share": 0.7}
    r = SimpleNamespace(trace=t, traced_units=3, units=10, window_s=2.0)
    assert metric_module("idle.infer").read(r) == pytest.approx(70.0)
    # 0.1 s busy a step, 10 steps in a 2 s window
    assert metric_module("idle.train").read(r) == pytest.approx(50.0)
    r.trace = None
    assert metric_module("idle.train").read(r) is None
    assert metric_module("sample_ms.train").read(r) is None
