"""The benchmark's graph generator at a small scale on the CPU."""
import json

import numpy as np
import pytest
import torch

from benchmark.conftest import scaled_graph
from benchmark.core.spec import BENCH_DIR
from benchmark.graphs import products

CFG = json.loads((BENCH_DIR / "configs" / "sage-products.json").read_text())
SMALL = scaled_graph(CFG["graph"], 2e-3)


@pytest.fixture(scope="module")
def graph():
    return products.generate(SMALL, 2**31 + 7, "cpu")


def test_counts(graph):
    n, e, t = products.sizes(SMALL)
    assert graph.num_nodes == n == round(2449029 * 2e-3)
    assert graph.num_edges == 2 * e == 2 * round(61859140 * 2e-3)
    assert graph.x.shape == (n, 100) and graph.x.dtype == torch.float32
    assert graph.y.shape == (n,) and int(graph.y.max()) < 47
    assert graph.train_idx.shape == (t,)
    assert graph.train_idx.unique().numel() == t


def test_full_size_counts():
    n, e, t = products.sizes(CFG["graph"])
    assert (n, 2 * e, t) == (2449029, 123718280, 196615)


def test_stored_both_ways_without_repeats(graph):
    n = graph.num_nodes
    fwd = graph.src * n + graph.dst
    back = graph.dst * n + graph.src
    assert torch.equal(torch.sort(fwd).values, torch.sort(back).values)
    assert bool((graph.src != graph.dst).all())
    assert fwd.unique().numel() == fwd.numel()


def test_ids_depend_only_on_the_seed(graph):
    again = products.generate(SMALL, 2**31 + 7, "cpu")
    other = products.generate(SMALL, 2**31 + 8, "cpu")
    for a, b in ((graph.src, again.src), (graph.dst, again.dst),
                 (graph.x, again.x), (graph.y, again.y),
                 (graph.train_idx, again.train_idx)):
        assert torch.equal(a, b)
    assert not torch.equal(graph.src, other.src)


def test_degree_statistics_as_assumed(graph):
    """The configuration's ``assumed`` degrees are the generator's
    expectation at full size; the same formula holds at a small size."""
    assumed = CFG["assumed"]["expected_in_degree"]
    full = products.expected_degrees(2449029, 61859140, 0.44)
    assert full["max"] == pytest.approx(assumed["max"], rel=1e-3)
    assert full["median"] == pytest.approx(assumed["median"], rel=1e-2)
    assert full["mean"] == pytest.approx(assumed["mean"], rel=1e-3)
    n, e, _ = products.sizes(SMALL)
    want = products.expected_degrees(n, e, 0.44)
    deg = torch.bincount(graph.dst, minlength=n).double()
    assert float(deg.mean()) == pytest.approx(want["mean"], rel=1e-9)
    assert float(deg.median()) == pytest.approx(want["median"], rel=0.15)
    # the hub loses some repeated pairs with other hubs, drawn again
    assert float(deg.max()) == pytest.approx(want["max"], rel=0.2)
    assert np.isfinite(want["min"]) and want["min"] > 0
