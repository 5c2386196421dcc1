"""Scale-matched synthetic stand-ins for the OGB node-property datasets.

A copy of ``synthetic_ogbn``, ``planted_ogbn`` and ``OGBN_SPECS`` from
``tch_geometric_tpu/data/ogb.py`` (numpy only): the same seed gives the same
graph in both packages.  The loaders of real OGB data are not ported yet.
"""
from __future__ import annotations

import numpy as np

from .dataset import Data

# (num_nodes, num_edges, feat_dim, num_classes) of the real datasets
OGBN_SPECS = {
    "ogbn-arxiv": (169_343, 1_166_243, 128, 40),
    "ogbn-products": (2_449_029, 61_859_140, 100, 47),
    "ogbn-mag-paper": (736_389, 5_416_271, 128, 349),
}


def synthetic_ogbn(name: str, *, seed: int = 0,
                   scale: float = 1.0) -> Data:
    """Scale-matched synthetic stand-in: power-law-ish degree profile via
    preferential-attachment-style sampling, matching node/edge counts and
    feature dims of the named dataset (optionally down-scaled)."""
    n, e, f, c = OGBN_SPECS[name]
    n = max(int(n * scale), 1000)
    e = max(int(e * scale), 10 * n)
    rng = np.random.default_rng(seed)
    # heavy-tailed source popularity: zipf-like via pareto ranks
    pop = (1.0 / (np.arange(n) + 10.0)) ** 0.8
    pop /= pop.sum()
    src = rng.choice(n, size=e, p=pop)
    dst = rng.integers(0, n, size=e)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = rng.integers(0, c, size=n).astype(np.int64)
    return Data(x=x, edge_index=np.stack([src, dst]).astype(np.int64), y=y)


def _mean_in_neighbors(h: np.ndarray, src: np.ndarray, dst: np.ndarray,
                       num_nodes: int,
                       chunk_edges: int = 8_000_000) -> np.ndarray:
    """Row i of the result = mean of h[src[e]] over in-edges e with
    dst[e] == i (zero for isolated nodes).  Vectorized via sort+reduceat,
    chunked over edges so the gathered intermediate stays bounded
    (products scale: 62M edges x 47 classes would be ~12 GB unchunked)."""
    order = np.argsort(dst, kind="stable")
    counts = np.bincount(dst, minlength=num_nodes)
    sums = np.zeros((num_nodes, h.shape[1]), dtype=h.dtype)
    e = len(order)
    for lo in range(0, e, chunk_edges):
        sel = order[lo:lo + chunk_edges]
        d = dst[sel]
        gathered = h[src[sel]]
        # segment boundaries within this sorted-dst chunk
        row_ids, starts_local = np.unique(d, return_index=True)
        sums[row_ids] += np.add.reduceat(gathered, starts_local, axis=0)
    # divide in h's dtype: float32/int64 would silently promote the whole
    # propagation to float64 (2x memory at products scale)
    return sums / np.maximum(counts, 1)[:, None].astype(h.dtype)


def planted_ogbn(name: str, *, seed: int = 0, scale: float = 1.0,
                 teacher_hops: int = 2, noise: float = 1.0,
                 split=(0.6, 0.2, 0.2)):
    """Synthetic OGB stand-in with LEARNABLE, graph-structure-dependent
    labels from a planted teacher.

    ``synthetic_ogbn``'s labels are uniform-random (fine for throughput,
    meaningless for accuracy); here labels come from a fixed random linear
    probe over ``teacher_hops`` rounds of in-neighbor mean propagation of the
    node features — exactly the aggregation family GraphSAGE expresses — plus
    Gaussian label noise setting the accuracy ceiling.  A feature-only model
    (MLP) provably cannot reach a propagation-aware model's accuracy on this
    task, so it measures message passing, not memorization.

    Returns ``(data, split_dict)`` with ``split_dict`` =
    ``{"train": idx, "valid": idx, "test": idx}`` (disjoint, seeded).
    """
    n, e, f, c = OGBN_SPECS[name]
    n = max(int(n * scale), 1000)
    e = max(int(e * scale), 10 * n)
    rng = np.random.default_rng(seed)
    pop = (1.0 / (np.arange(n) + 10.0)) ** 0.8
    pop /= pop.sum()
    src = rng.choice(n, size=e, p=pop)
    dst = rng.integers(0, n, size=e)
    x = rng.normal(size=(n, f)).astype(np.float32)

    w = (rng.normal(size=(f, c)) / np.sqrt(f)).astype(np.float32)
    h = x @ w
    for _ in range(teacher_hops):
        h = 0.5 * h + 0.5 * _mean_in_neighbors(h, src, dst, n)
    # scale class scores to unit variance so `noise` is in signal units
    h = h / max(h.std(), 1e-6)
    logits = h * 3.0 + noise * rng.normal(size=h.shape).astype(np.float32)
    y = logits.argmax(axis=1).astype(np.int64)

    perm = rng.permutation(n)
    n_tr = int(split[0] * n)
    n_va = int(split[1] * n)
    split_dict = {
        "train": np.sort(perm[:n_tr]),
        "valid": np.sort(perm[n_tr:n_tr + n_va]),
        "test": np.sort(perm[n_tr + n_va:]),
    }
    data = Data(x=x, edge_index=np.stack([src, dst]).astype(np.int64), y=y)
    return data, split_dict
