"""The port's step recorder (``utils/metrics.py::trace_span``) on the CPU:
records, their nesting, ids, ring and span cap; the ``record_function``
and the host stamps only under a profiler, also one started inside a
root, on the Chrome trace's clock; the spans one train step and one
full-graph pass record; and the same results with and without a
profiler."""
import contextlib
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from tch_geometric_tpu_torch.data import load_karate_graph, make_graph
from tch_geometric_tpu_torch.data.storage import to_csc
from tch_geometric_tpu_torch.models.sage import GraphSAGE
from tch_geometric_tpu_torch.ops import build_blocked
from tch_geometric_tpu_torch.parallel import make_gnn_trainer
from tch_geometric_tpu_torch.sampling import primitives, rng
from tch_geometric_tpu_torch.utils import metrics
from tch_geometric_tpu_torch.utils.metrics import (RING, SPANS, profile,
                                                   span_ms, span_records,
                                                   trace_span)


def _names(record):
    return [s.name for s in record.spans]


def test_nesting_parent_and_id():
    """A root opens a record with its id; each span names the index of the
    span around it; a span on another thread is a root of its own."""
    seen = {}

    def other_thread():
        with trace_span("nest-thread"):
            pass
        seen["records"] = span_records("nest-thread")

    with trace_span("nest-root", id=7):
        with trace_span("a"):
            with trace_span("b"):
                with trace_span("a"):
                    pass
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=30)
        with trace_span("c"):
            pass
    assert not t.is_alive()
    rec = span_records("nest-root")[-1]
    assert rec.id == 7 and not rec.profiled
    assert [(s.name, s.parent) for s in rec.spans] == [
        ("nest-root", None), ("a", 0), ("b", 1), ("a", 2), ("c", 0)]
    assert [r.id for r in seen["records"]][-1] is None
    assert _names(seen["records"][-1]) == ["nest-thread"]
    a, b, a2 = rec.spans[1:4]
    assert 0 <= a2.host_ms <= b.host_ms <= a.host_ms <= rec.spans[0].host_ms
    # inclusive: the inner ``a`` is counted inside the outer one
    assert span_ms(rec, "a") == a.host_ms
    assert span_ms(rec, "absent") == 0.0
    assert span_ms(rec, "a", device=True) is None
    assert all(s.device_ms is None for s in rec.spans)


def test_threads_closing_roots_at_once_lose_no_record():
    """Threads that close roots of one new name together all land in one
    ring: 8 threads of 30 records each, fewer than the ring holds."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def roots(t):
            for i in range(30):
                with trace_span("race-root", id=(t, i)):
                    with trace_span("race-child"):
                        pass

        threads = [threading.Thread(target=roots, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = span_records("race-root")
    assert sorted(r.id for r in recs) == [(t, i) for t in range(8)
                                          for i in range(30)]
    assert all(_names(r) == ["race-root", "race-child"] for r in recs)


def test_ring_keeps_the_last_records_of_each_root():
    for i in range(RING + 5):
        with trace_span("ring-root", id=i):
            pass
    with trace_span("ring-other", id=-1):
        pass
    ids = [r.id for r in span_records("ring-root")]
    assert ids == list(range(5, RING + 5))
    assert [r.id for r in span_records("ring-other")] == [-1]


def test_a_record_keeps_its_first_spans_and_counts_the_rest():
    with trace_span("cap-root", id=1):
        with trace_span("cap-outer"):
            for _ in range(SPANS + 10):
                with trace_span("cap-inner"):
                    pass
        with trace_span("cap-last"):
            pass
    rec = span_records("cap-root")[-1]
    assert len(rec.spans) == SPANS and rec.dropped == 13
    assert _names(rec)[:2] == ["cap-root", "cap-outer"]
    assert all(s.parent == 1 for s in rec.spans[2:])
    assert metrics._open.stack == [] and metrics._open.record is None


def test_host_stamps_do_not_follow_the_unix_clock_back(monkeypatch):
    """Durations come from the monotonic clock: a Unix clock stepped back
    inside a record moves no span's length below zero."""
    unix = iter(range(10**18, 0, -10**9))
    monkeypatch.setattr(metrics.time, "time_ns", lambda: next(unix))
    with trace_span("mono-root"):
        with trace_span("mono-child"):
            with trace_span("mono-root-inner"):
                pass
    root, child, inner = span_records("mono-root")[-1].spans
    assert 0 <= inner.host_ms <= child.host_ms <= root.host_ms
    assert root.start_ns <= child.start_ns <= inner.start_ns


def test_no_record_function_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    with trace_span("off-root", id=0):
        with trace_span("off-child"):
            pass
    assert not span_records("off-root")[-1].profiled


def test_profiled_stamps_match_the_chrome_trace(tmp_path):
    """Under a profiler each span is a ``record_function`` of its name, the
    record is marked ``profiled``, and a span's host stamps fall within
    0.1 ms of its event in the exported trace."""
    logdir = str(tmp_path / "prof")
    with profile(logdir):
        with trace_span("stamp-warm"):
            torch.zeros(4).add_(1.0)
        with trace_span("stamp-root", id=3):
            torch.zeros(64).add_(1.0)
            with trace_span("stamp-child"):
                torch.zeros(64).mul_(2.0)
    rec = span_records("stamp-root")[-1]
    assert rec.profiled and rec.id == 3
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"}
    for span in rec.spans:
        e = events[span.name]
        t0 = base + float(e["ts"]) * 1e3
        t1 = t0 + float(e["dur"]) * 1e3
        assert abs(span.start_ns - t0) < 1e5, span.name
        assert abs(span.end_ns - t1) < 1e5, span.name
    assert span_ms(rec, "stamp-child", device=True) is None  # no card


def test_a_profiler_started_inside_a_root_records_the_spans_after_it(
        tmp_path):
    logdir = str(tmp_path / "prof")
    with trace_span("late-root", id=4):
        with trace_span("late-before"):
            pass
        with profile(logdir):
            with trace_span("late-inside"):
                torch.zeros(8).add_(1.0)
    rec = span_records("late-root")[-1]
    assert rec.profiled
    with open(os.path.join(logdir, "trace.json")) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert "late-inside" in names
    assert not names & {"late-root", "late-before"}


@pytest.fixture(scope="module")
def karate():
    x, y, ei = load_karate_graph()
    cp, ri, perm = to_csc(ei, 34)
    return dict(x=torch.from_numpy(x).float(), y=y, cp=cp, ri=ri,
                graph=make_graph(cp, ri, perm, num_src=34, num_dst=34,
                                 ell_table=False, window_table=False,
                                 device="cpu"))


@pytest.fixture
def card():
    """The CUDA card of a ``card``-marked test; skips it without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


def _model(num_layers):
    return GraphSAGE(34, 8, 4, num_layers, dropout=0.5, device="cpu",
                     generator=torch.Generator().manual_seed(0))


def test_train_step_records_and_results_with_and_without_profiler(
        karate, tmp_path):
    """One ``train_step`` gives one ``step`` record holding the spans its
    fanouts and layers imply, and the same loss and parameters with a
    profiler running as without."""
    fanouts, L = [3, 2], 2
    seeds = np.array([0, 1, 4, 5, 9, 33])
    out = {}
    for profiled in (False, True):
        model = _model(L)
        trainer = make_gnn_trainer(model, fanouts)
        state = trainer.init_fn()
        before = len(span_records("step"))
        ctx = (profile(str(tmp_path / "p")) if profiled
               else contextlib.nullcontext())
        with ctx:
            state, loss, _ = trainer.train_step(
                state, rng.key(5), karate["graph"], karate["x"], seeds,
                karate["y"][seeds])
        recs = span_records("step")
        assert len(recs) == min(before + 1, RING)
        rec = recs[-1]
        assert rec.id == 0 and rec.profiled == profiled
        count = {n: _names(rec).count(n) for n in set(_names(rec))}
        # rng_keys: the step key; per hop its key, then per Floyd draw a
        # fold_in and the split of randint; the dropout stream's key; one
        # key a mask.  rng_bits: randint's two draws per Floyd draw; one
        # draw a mask.  A mask after every layer but the last; two copies
        # to the card (seeds, labels).
        assert count["rng_keys"] == (1 + sum(1 + 2 * k for k in fanouts)
                                     + 1 + (L - 1))
        assert count["rng_bits"] == sum(2 * k for k in fanouts) + (L - 1)
        assert count["dropout"] == L - 1
        assert count["to_device"] == 2
        for name in ("sample", "gather", "forward", "update"):
            assert count[name] == 1
        parent = {s.name: rec.spans[s.parent].name for s in rec.spans[1:]
                  if s.name in ("sample", "forward", "dropout")}
        assert parent == {"sample": "step", "forward": "step",
                          "dropout": "forward"}
        assert span_ms(rec, "sample") <= span_ms(rec, "step")
        out[profiled] = (loss, {k: v.detach().clone()
                                for k, v in state.params.items()})
    (l0, p0), (l1, p1) = out[False], out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


@pytest.mark.card
def test_train_step_launches_the_threefry_kernel_once_a_draw(karate, card):
    """On the card every draw of a train step is one launch: each hop of
    the Floyd sampler one of the hop kernel (``floyd_hop_cuda``), which
    derives its draws' keys itself, and each mask one of the threefry
    kernel; the ``rng_bits`` spans count both (3 at fanouts [3, 2] with 2
    layers; 5 at [15, 10, 5] with 3), and inside ``sample`` the only
    ``rng_keys`` span is each hop's fold."""
    fanouts, L = [3, 2], 2
    seeds = np.array([0, 1, 4, 5, 9, 33])
    graph = make_graph(karate["cp"], karate["ri"], num_src=34, num_dst=34,
                       ell_table=False, window_table=False, device=card)
    model = GraphSAGE(34, 8, 4, L, dropout=0.5, device=card,
                      generator=torch.Generator().manual_seed(0))
    trainer = make_gnn_trainer(model, fanouts)
    state = trainer.init_fn()
    x = karate["x"].to(card)
    before = rng.threefry_cuda.launches
    hops_before = primitives.floyd_hop_cuda.launches
    state, loss, _ = trainer.train_step(state, rng.key(5), graph, x, seeds,
                                        karate["y"][seeds])
    torch.cuda.synchronize()
    launches = rng.threefry_cuda.launches - before
    hops = primitives.floyd_hop_cuda.launches - hops_before
    assert launches == L - 1 == 1
    assert hops == len(fanouts) == 2
    rec = span_records("step")[-1]
    assert launches + hops == _names(rec).count("rng_bits") == 3

    def inside_sample(i):
        while i is not None:
            if rec.spans[i].name == "sample":
                return True
            i = rec.spans[i].parent
        return False

    assert sum(s.name == "rng_keys" and inside_sample(s.parent)
               for s in rec.spans) == len(fanouts)
    assert torch.isfinite(loss)


def test_blocked_forward_records_one_aggregate_a_layer(karate):
    model = _model(3)
    blocked = build_blocked(karate["cp"], karate["ri"], rows_per_block=16,
                            device="cpu")
    with torch.no_grad():
        model.blocked_forward(karate["x"], blocked,
                              compute_dtype=torch.float32)
    rec = span_records("blocked_forward")[-1]
    assert _names(rec) == ["blocked_forward"] + ["aggregate"] * 3
    assert all(s.parent == 0 for s in rec.spans[1:])
    assert "dropout" not in _names(rec)
    assert 0 < span_ms(rec, "aggregate") <= rec.spans[0].host_ms
