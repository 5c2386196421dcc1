"""A graph of ogbn-products' published shape, made on the device from a seed.

ogbn-products (Hu et al., 2020, "Open Graph Benchmark"): 2,449,029 nodes,
61,859,140 undirected edges, which PyG stores both ways (123,718,280
directed), 100 float32 features, 47 classes, 196,615 training nodes.

Both endpoints of each undirected edge are drawn from one heavy-tailed
popularity, ``p(rank r) ~ r ** -exponent``, laid over a random permutation
of the ids, so in-degrees are skewed as the real co-purchase graph's are
(hubs of many thousands).  Self loops and repeated pairs are dropped and
drawn again until exactly the published number of distinct pairs is left;
every pair is stored both ways.  Features are standard normal, labels
uniform over the classes, the training split a uniform draw of the
published size.

Every draw is made by one ``torch.Generator`` on ``device``, seeded by the
run's seed, in a few large calls: the same seed gives the same graph.

A configuration names this generator by ``"graph": {"generator":
"products", ...}``; a generator module exports ``generate(cfg, seed,
device)``, which returns a ``GeneratedGraph``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# headroom of the first draw of pairs over the pairs needed
_OVERDRAW = 1.08


@dataclass
class GeneratedGraph:
    src: torch.Tensor        # (E,) int64, E = 2 * undirected edges
    dst: torch.Tensor        # (E,) int64
    num_nodes: int
    x: torch.Tensor          # (N, F) float32
    y: torch.Tensor          # (N,) int64
    train_idx: torch.Tensor  # (train_size,) int64

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def sizes(cfg: dict):
    """``(nodes, undirected edges, training nodes)`` of the graph section
    ``cfg`` of a configuration."""
    return (int(cfg["num_nodes"]), int(cfg["num_undirected_edges"]),
            int(cfg["train_size"]))


def popularity(num_nodes: int, exponent: float, device) -> torch.Tensor:
    """The float64 popularity of ranks ``1..num_nodes``, summing to 1."""
    r = torch.arange(1, num_nodes + 1, dtype=torch.float64, device=device)
    w = r.pow(-exponent)
    return w / w.sum()


def expected_degrees(num_nodes: int, num_undirected: int,
                     exponent: float) -> dict:
    """The expected largest, median and smallest in-degree: a node of
    popularity ``p`` is an endpoint of ``2 * E * p`` pairs in expectation
    (before repeated pairs are drawn again)."""
    p = popularity(num_nodes, exponent, "cpu").numpy()
    d = 2 * num_undirected * p
    return {"max": float(d[0]), "median": float(np.median(d)),
            "min": float(d[-1]), "mean": 2 * num_undirected / num_nodes}


def _draw_pairs(g: torch.Generator, cdf: torch.Tensor, perm: torch.Tensor,
                m: int) -> torch.Tensor:
    """``m`` pair keys ``min * N + max`` of two endpoints drawn by
    popularity, self loops dropped."""
    n = perm.shape[0]
    u = torch.rand((2, m), dtype=torch.float64, generator=g,
                   device=cdf.device)
    ends = perm[torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)]
    a, b = ends[0], ends[1]
    keep = a != b
    a, b = a[keep], b[keep]
    return torch.minimum(a, b) * n + torch.maximum(a, b)


def generate(cfg: dict, seed: int, device) -> GeneratedGraph:
    """The graph of the graph section ``cfg`` of a configuration under
    ``seed``, made on ``device``."""
    n, e_und, n_train = sizes(cfg)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    perm = torch.randperm(n, generator=g, device=device)
    cdf = popularity(n, float(cfg["popularity_exponent"]), device).cumsum(0)
    keys = torch.zeros((0,), dtype=torch.int64, device=device)
    need = e_und
    while need > 0:
        m = math.ceil(need * _OVERDRAW) + 1024
        keys = torch.unique(torch.cat([keys, _draw_pairs(g, cdf, perm, m)]))
        need = e_und - keys.shape[0]
    keys = keys[torch.randperm(keys.shape[0], generator=g,
                               device=device)[:e_und]]
    u, v = keys // n, keys % n
    del keys
    x = torch.randn((n, int(cfg["num_features"])), generator=g,
                    device=device)
    y = torch.randint(0, int(cfg["num_classes"]), (n,), generator=g,
                      device=device)
    train_idx = torch.randperm(n, generator=g, device=device)[:n_train]
    return GeneratedGraph(torch.cat([u, v]), torch.cat([v, u]), n, x, y,
                          train_idx)
