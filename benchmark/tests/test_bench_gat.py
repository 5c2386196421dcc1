"""``gat-products.infer`` at a small size on the CPU: a whole run plain and
traced is ``correct``, with the path broken underneath it is not; the
program's spans and B3 calls a pass; the attention roofline's counts by
hand; and on the card, B3's launch counter (``card``-marked: skipped here
with a reason)."""
import collections
import json
from types import SimpleNamespace

import pytest
import torch

import tch_geometric_tpu_torch.models.gnn as gnn
from benchmark.core import harness, peaks, records
from benchmark.core.spec import metric_module
from benchmark.models import gat

NAME = "gat-products.infer"
SEED = 2**31 + 5151


def _run(cell, trace=False):
    return harness.run(cell, SEED, 0.2, trace, "cpu", log=lambda *_: None)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(small_cell, trace):
    out = _run(small_cell(NAME), trace)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    if not trace:
        assert set(out["metrics"]) == {"setup_s", "infer_nodes_per_s"}
    else:
        # no device on the CPU: the device readers give nothing
        assert {"build_s.graph", "build_s.blocked", "mfu.infer"} <= set(
            out["metrics"])
        host, _ = records._last_events
        names = collections.Counter(e[0] for e in host)
        units = 3                            # the infer mix's trace_units
        assert names["blocked_forward"] == units
        assert names["aggregate"] == 3 * units


def _no_self_loops(monkeypatch):
    inner = gnn.gat_attend_blocked_packed_cuda

    def dropped(*a, **k):
        k["self_loops"] = False
        return inner(*a, **k)
    monkeypatch.setattr(gnn, "gat_attend_blocked_packed_cuda", dropped)


def _row_altered(monkeypatch):
    inner = gnn.GAT.blocked_forward

    def altered(self, *a, **k):
        out = inner(self, *a, **k).clone()
        out[3] += 1.0
        return out
    monkeypatch.setattr(gnn.GAT, "blocked_forward", altered)


@pytest.mark.parametrize("fault", [_no_self_loops, _row_altered])
def test_fault_is_not_correct(small_cell, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(small_cell(NAME))
    assert not out["correct"], out["checks"]


def test_b3_runs_once_a_layer_with_self_loops(small_cell, monkeypatch):
    calls = []
    inner = gnn.gat_attend_blocked_packed_cuda

    def counted(*a, **k):
        calls.append(k.get("self_loops"))
        return inner(*a, **k)
    monkeypatch.setattr(gnn, "gat_attend_blocked_packed_cuda", counted)
    cell = small_cell(NAME)
    gg, loop, _ = harness.prepare(cell, SEED, "cpu", log=lambda *_: None)
    loop.setup()
    del calls[:]
    loop.traced(2)
    assert calls == [True] * 6


def test_roofline_counts_by_hand(monkeypatch):
    """One layer of 2 heads of 3 columns over 10 nodes and 20 edges in
    bfloat16: bytes 80 (edges) + 44 (offsets) + 120 (rows) + 160 (logit
    tables) + 240 (output) = 644; operations (20 + 10) x 2 x 12 = 720."""
    mod = metric_module("gat_attend_roofline")
    assert mod.layer_counts(10, 20, 2, 3, 2) == (720, 644)
    cfg = {"model": {"hidden": 3, "heads": 2, "num_layers": 2},
           "graph": {"num_classes": 5},
           "infer": {"agg_dtype": "bfloat16"}}
    want = (peaks.least_seconds(*mod.layer_counts(10, 20, 2, 3, 2))
            + peaks.least_seconds(*mod.layer_counts(10, 20, 2, 5, 2)))
    assert mod.least_pass_seconds(cfg, 10, 20) == pytest.approx(want)
    # 2 ms of device time inside ``aggregate`` over 2 traced passes
    host = [(records.WINDOW, 0.0, 100.0, None, "user_annotation"),
            ("aggregate", 10.0, 20.0, None, "user_annotation"),
            ("cudaLaunchKernel", 12.0, 13.0, 1, "cuda_runtime")]
    dev = [("k1", 40.0, 2040.0, 1)]
    monkeypatch.setattr(records, "_last_events", (host, dev))
    r = SimpleNamespace(trace={"device_events": 1}, traced_units=2,
                        cell=SimpleNamespace(config=cfg), num_nodes=10,
                        num_edges=20)
    assert mod.read(r) == pytest.approx(100.0 * want / 1e-3)


@pytest.mark.parametrize("key,value", [
    (None, None), ("last_heads", 1), ("negative_slope", 0.1),
    ("activation", "relu"), ("attention_dropout", 0.1), ("skip", False),
    ("residual", True)])
def test_build_takes_only_the_model_it_builds(key, value):
    """The stated configuration builds; a model key changed to a value that
    ``GAT(..., pyg=True)`` does not build, or one it does not know, is
    refused rather than ignored."""
    from benchmark.core import spec
    cfg = json.loads(json.dumps(spec.load_cell(
        spec.load_spec(spec.BENCH_DIR.parent), NAME).config))
    if key is None:
        assert len(gat.build(cfg, "cpu").convs) == 3
        return
    cfg["model"][key] = value
    with pytest.raises(ValueError, match=key):
        gat.build(cfg, "cpu")


def test_pass_flops_by_hand():
    """Layers (in, heads, head width, out) (3, 2, 4, 8) and (8, 2, 5, 5) over
    10 nodes and 20 edges: projection, skip, logit tables, attention."""
    cfg = {"model": {"hidden": 4, "heads": 2, "num_layers": 2,
                     "last_concat": False},
           "graph": {"num_features": 3, "num_classes": 5}}
    assert gat.layer_shapes(cfg) == [(3, 2, 4, 8), (8, 2, 5, 5)]
    want = (2 * 10 * 3 * 8 + 2 * 10 * 3 * 8 + 4 * 10 * 8 + 30 * 2 * 14
            + 2 * 10 * 8 * 10 + 2 * 10 * 8 * 5 + 4 * 10 * 10 + 30 * 2 * 16)
    assert gat.pass_flops(cfg, 10, 20) == want


@pytest.mark.card
def test_b3_launches_three_a_pass_on_the_card(card):
    from benchmark.core import spec
    from tch_geometric_tpu_torch.ops.attention_blocked import \
        gat_attend_blocked_packed_cuda as b3
    cell = spec.load_cell(spec.load_spec(spec.BENCH_DIR.parent), NAME)
    _, loop, _ = harness.prepare(cell, SEED, card, log=lambda *_: None)
    loop.setup()
    before = b3.launches
    loop.traced(2)
    torch.cuda.synchronize()
    assert b3.launches - before == 6
    assert b3.last_slots >= 0
