"""The hop kernel (``csrc/floyd.cu``, ``primitives.floyd_hop_cuda``, F1):
its gate (``utils/kernel_gates.py::run_floyd_gates``) on the card,
bit-equal to the plain version there and on CPU copies of the inputs, and
the gate's cases on the CPU, where both sides are the plain version.
Imports neither JAX nor the JAX package, so the card test runs on a
machine without them (``python -m pytest --noconftest
tests/test_torch_floyd_kernel.py -q -m card``)."""
import pytest
import torch

from tch_geometric_tpu_torch.sampling import primitives
from tch_geometric_tpu_torch.utils.kernel_gates import (FLOYD_KS,
                                                        FLOYD_STAGE_K,
                                                        run_floyd_gates)


@pytest.fixture
def card():
    """The CUDA card of a ``card``-marked test; skips it without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


def test_floyd_gate_cases_on_the_cpu():
    before = primitives.floyd_hop_cuda.launches
    errs = run_floyd_gates("cpu", stage_k=None)
    assert "sample_neighbors[15,10,5]/cpu" in errs
    assert all(f"k={k}/cpu" in errs for k in FLOYD_KS)
    assert all(v == 0 for v in errs.values()), errs
    assert primitives.floyd_hop_cuda.launches == before


@pytest.mark.card
def test_floyd_gates_on_the_card(card):
    errs = run_floyd_gates(card)
    assert f"k={FLOYD_STAGE_K}/cpu" in errs and "launches" in errs
    assert "window[E%64=37]/k=15/cpu" in errs
    assert all(v == 0 for v in errs.values()), {
        k: v for k, v in errs.items() if v}
