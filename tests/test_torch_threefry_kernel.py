"""The threefry kernel (``csrc/threefry.cu``, ``rng.threefry_cuda``):
its gate (``utils/kernel_gates.py::run_rng_gates``) on the card, bit-equal
to the plain version there and to the CPU's bits, and the gate's cases on
the CPU, where both sides are the plain version.  Imports neither JAX nor
the JAX package, so the card test runs on a machine without them
(``python -m pytest --noconftest tests/test_torch_threefry_kernel.py
tests/test_torch_tracing.py -q -m card``)."""
import pytest
import torch

from tch_geometric_tpu_torch.sampling import rng
from tch_geometric_tpu_torch.utils.kernel_gates import run_rng_gates


@pytest.fixture
def card():
    """The CUDA card of a ``card``-marked test; skips it without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


def test_rng_gate_cases_on_the_cpu():
    before = rng.threefry_cuda.launches
    errs = run_rng_gates("cpu", mask_shapes=((48, 256), (16, 256)))
    assert errs and all(v == 0 for v in errs.values()), errs
    assert rng.threefry_cuda.launches == before


@pytest.mark.card
def test_rng_gates_on_the_card(card):
    errs = run_rng_gates(card)
    assert "launches" in errs and "mask_layer1/cpu" in errs
    assert all(v == 0 for v in errs.values()), {
        k: v for k, v in errs.items() if v}
