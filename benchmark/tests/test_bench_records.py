"""The readers of the program's step records in a traced run on the CPU at
a small size: the host readings come out positive, the device readings
none (no card), and the split reads the spans it read before them; and
the readers' faults."""
import pytest

from benchmark.core import harness
from benchmark.core import trace as trace_mod

SEED = 2**31 + 977
HOST = ("step_host_ms.train", "sample_host_ms.train",
        "rng_keys_host_ms.train", "rng_bits_host_ms.train",
        "to_device_host_ms.train")
DEVICE = ("dropout_ms.train", "aggregate_ms.infer")
# what the split assigned device time to before the readers of the records
SPLIT_KEYS = {
    "sage-products.train": {"sample", "gather", "forward", "update", "other",
                            "unattributed"},
    "sage-products.infer": {"spmm_agg", "other", "unattributed"},
}


@pytest.mark.parametrize("name", ["sage-products.train",
                                  "sage-products.infer"])
def test_traced_run_reads_the_records(small_cell, monkeypatch, name):
    splits = []
    split = trace_mod.split

    def recorded(*a, **k):
        splits.append(split(*a, **k))
        return splits[-1]

    monkeypatch.setattr(trace_mod, "split", recorded)
    # no device time on the CPU: the roofline's entry check would fail
    monkeypatch.setattr(harness, "check_entries", lambda *a: None)
    cell = small_cell(name)
    out = harness.run(cell, SEED, 0.2, True, "cpu", log=lambda *_: None)
    assert out["correct"], out["checks"]
    listed = {m.name for m in cell.per_layer}
    for m in HOST:
        if m in listed:
            assert out["metrics"][m]["value"] > 0, m
    assert listed & set(DEVICE)
    assert not set(out["metrics"]) & set(DEVICE)
    assert set(splits[0]["device_s_by_span"]) == SPLIT_KEYS[name]
    if name.endswith(".train"):
        v = {m: out["metrics"][m]["value"] for m in HOST}
        assert v["sample_host_ms.train"] <= v["step_host_ms.train"]
        assert (v["rng_keys_host_ms.train"] + v["rng_bits_host_ms.train"]
                <= v["step_host_ms.train"])


def test_readers_fail_on_a_missing_span_and_skip_an_older_program(
        monkeypatch):
    """With the program's recorder, a record reading that finds no record
    or no span, and a device reading whose span launched nothing, fail
    the run; a program without the recorder gives no reading."""
    from types import SimpleNamespace

    from benchmark.core import records
    from tch_geometric_tpu_torch.utils import metrics
    with metrics.trace_span("records-root"):
        with metrics.trace_span("records-child"):
            pass
    assert records.host_ms("records-root", "records-child") > 0
    for root, name in (("records-root", "absent"), ("absent", "absent")):
        with pytest.raises(RuntimeError):
            records.host_ms(root, name)
    # one kernel launched inside ``records-span``, one outside it
    host = [(records.WINDOW, 0.0, 100.0, None, "user_annotation"),
            ("records-span", 10.0, 20.0, None, "user_annotation"),
            ("cudaLaunchKernel", 12.0, 13.0, 1, "cuda_runtime"),
            ("cudaLaunchKernel", 30.0, 31.0, 2, "cuda_runtime")]
    dev = [("k1", 40.0, 43.0, 1), ("k2", 50.0, 57.0, 2)]
    monkeypatch.setattr(records, "_last_events", (host, dev))
    r = SimpleNamespace(trace={"device_events": 2}, traced_units=3)
    assert records.device_ms(r, "records-span") == pytest.approx(1e-3)
    with pytest.raises(RuntimeError):
        records.device_ms(r, "absent")
    monkeypatch.delattr(metrics, "span_records")
    assert records.host_ms("records-root", "absent") is None
    assert records.device_ms(r, "absent") is None
