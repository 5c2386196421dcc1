"""A whole run on the CPU at a small size, past the look for a card, with
the timed path sound and then broken underneath: ``correct`` has to come
out true, then false once for each fault the cell can have.  (No cell
runs on more than one chip, so none can leave out an exchange between
chips; inference keeps no state a step could leave unchanged.)"""
import types

import pytest
import torch

import tch_geometric_tpu_torch.ops.spmm_kernels as spmm_kernels
import tch_geometric_tpu_torch.parallel.train as ptrain
from benchmark.core import harness

SEED = 2**31 + 4242


def _run(cell):
    return harness.run(cell, SEED, 0.2, False, "cpu", log=lambda *_: None)


@pytest.mark.parametrize("name", ["sage-products.train",
                                  "sage-products.infer"])
def test_sound_run_is_correct(small_cell, name):
    out = _run(small_cell(name))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(ptrain, "adam_update",
                        lambda params, grads, state, lr: state)


def _half_batch(monkeypatch):
    def half_ce(logits, labels):
        n = logits.shape[0] // 2
        return torch.nn.functional.cross_entropy(logits[:n], labels[:n])
    monkeypatch.setattr(ptrain, "nnf", types.SimpleNamespace(
        cross_entropy=half_ce))


def _tree_altered(monkeypatch):
    inner = ptrain._sample_and_gather

    def altered(*a, **k):
        sample, x = inner(*a, **k)
        b = sample.node_base[1]
        # the first valid child of seed 0 becomes seed 0 itself: no node is
        # its own in-neighbour
        slot = b + int(torch.nonzero(sample.node_valid[b:]).flatten()[0])
        sample.nodes[slot] = sample.nodes[0]
        return sample, x
    monkeypatch.setattr(ptrain, "_sample_and_gather", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _tree_altered])
@pytest.mark.parametrize("name", ["sage-products.train"])
def test_train_fault_is_not_correct(small_cell, monkeypatch, name, fault):
    fault(monkeypatch)
    out = _run(small_cell(name))
    assert not out["correct"], out["checks"]


def _broken(fn, how):
    def wrapper(*a, **k):
        out = fn(*a, **k)
        if how == "half":
            out = out.clone()
            out[out.shape[0] // 2:] = 0
        else:
            out = out.clone()
            out[3] += 1.0
        return out
    return wrapper


@pytest.mark.parametrize("how", ["half", "altered"])
@pytest.mark.parametrize("name", ["sage-products.infer"])
def test_infer_fault_is_not_correct(small_cell, monkeypatch, name, how):
    monkeypatch.setattr(spmm_kernels, "spmm_blocked_auto",
                        _broken(spmm_kernels.spmm_blocked_auto, how))
    out = _run(small_cell(name))
    assert not out["correct"], out["checks"]
