"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests -q``): the ``card`` marker, and the fixture that skips a
card test where no CUDA card is present.  Whether there is a card is
decided inside the fixture, never while a module is imported."""
import copy
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped with a reason without "
        "one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


# a small size of every cell for the CPU: the graph's counts at this share
# of the published ones, training batches of this many seeds
SCALE = 2e-3
BATCH = 16


def scaled_graph(graph: dict, scale: float) -> dict:
    """A copy of a configuration's graph section with its node, edge and
    training counts at ``scale`` of the published ones."""
    g = dict(graph)
    g["num_nodes"] = max(2, round(g["num_nodes"] * scale))
    g["num_undirected_edges"] = max(1, round(g["num_undirected_edges"]
                                             * scale))
    g["train_size"] = max(1, round(g["train_size"] * scale))
    return g


@pytest.fixture
def small_cell():
    """``small_cell(name)``: the cell ``name`` of ``BENCHMARK.json`` with
    its graph at ``SCALE`` and a CPU-sized training batch."""
    from benchmark.core import spec

    def make(name):
        cell = spec.load_cell(spec.load_spec(spec.BENCH_DIR.parent), name)
        cell.config = copy.deepcopy(cell.config)
        cell.config["graph"] = scaled_graph(cell.config["graph"], SCALE)
        if "train" in cell.config:
            cell.config["train"]["batch_size"] = BATCH
        return cell

    return make
