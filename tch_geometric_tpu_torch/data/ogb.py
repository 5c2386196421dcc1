"""OGB datasets from a local directory, and scale-matched synthetic
stand-ins.

A copy of ``load_ogbn_dir``, ``synthetic_ogbn``, ``planted_ogbn``,
``planted_hetero`` and ``OGBN_SPECS`` from ``tch_geometric_tpu/data/ogb.py``
(numpy only): the same files or seed give the same arrays in both packages.
``load_ogbn``, which needs the ``ogb`` package and a download, is not
ported: ``load_ogbn_dir`` reads the same data from a directory.
"""
from __future__ import annotations

import numpy as np
import torch

from .dataset import Data

# (num_nodes, num_edges, feat_dim, num_classes) of the real datasets
OGBN_SPECS = {
    "ogbn-arxiv": (169_343, 1_166_243, 128, 40),
    "ogbn-products": (2_449_029, 61_859_140, 100, 47),
    "ogbn-mag-paper": (736_389, 5_416_271, 128, 349),
}


def load_ogbn_dir(path: str):
    """Load a real OGB node-property dataset from a LOCAL directory — no
    ``ogb`` package, no network.

    Two layouts are accepted, probed in order:

    1. ``<path>/graph.npz`` — a single npz with ``x (N, F) float``,
       ``edge_index (2, E) int``, ``y (N,) int`` and optional
       ``train_idx``/``valid_idx``/``test_idx``.  Convert once from any
       source; fastest to load.  From a machine WITH the ogb package::

           from ogb.nodeproppred import NodePropPredDataset
           g, lab = NodePropPredDataset("ogbn-arxiv", root=r)[0]
           s = NodePropPredDataset("ogbn-arxiv", root=r).get_idx_split()
           np.savez(f"{d}/graph.npz", x=g["node_feat"],
                    edge_index=g["edge_index"], y=lab.reshape(-1),
                    train_idx=s["train"], valid_idx=s["valid"],
                    test_idx=s["test"])

    2. the OGB download's standard raw layout (package-independent
       csv.gz files)::

           <path>/raw/edge.csv.gz            # E rows "src,dst"
           <path>/raw/node-feat.csv.gz       # N rows of F floats
           <path>/raw/node-label.csv.gz      # N rows
           <path>/split/<scheme>/{train,valid,test}.csv.gz

       (<scheme> is e.g. ``time`` for arxiv, ``sales_ranking`` for
       products; the first directory found is used.)

    Returns ``(Data, split)`` where split maps
    ``{"train","valid","test"}`` to int64 index arrays (empty dict if no
    split files exist).
    """
    import glob
    import os

    npz = os.path.join(path, "graph.npz")
    if os.path.exists(npz):
        d = np.load(npz)
        data = Data(x=d["x"].astype(np.float32),
                    edge_index=d["edge_index"].astype(np.int64),
                    y=d["y"].reshape(-1).astype(np.int64))
        split = {k: d[f"{k}_idx"].reshape(-1).astype(np.int64)
                 for k in ("train", "valid", "test")
                 if f"{k}_idx" in d.files}
        return data, split

    raw = os.path.join(path, "raw")
    if not os.path.isdir(raw):
        raise FileNotFoundError(
            f"{path!r} has neither graph.npz nor a raw/ OGB layout; see "
            "load_ogbn_dir's docstring for the expected files")
    # np.loadtxt decompresses .gz transparently; OGB CSVs carry NO header
    # row (the ogb package reads them with pandas header=None)
    edge = np.loadtxt(os.path.join(raw, "edge.csv.gz"), delimiter=",",
                      dtype=np.int64, ndmin=2)
    x = np.loadtxt(os.path.join(raw, "node-feat.csv.gz"), delimiter=",",
                   dtype=np.float32, ndmin=2)
    y = np.loadtxt(os.path.join(raw, "node-label.csv.gz"), delimiter=",",
                   dtype=np.int64).reshape(-1)
    # schema guards: the real download ships num-node-list / num-edge-list
    # (single-count files); when present they must agree with the data
    # files, so a truncated or mismatched copy fails loudly here rather
    # than as a silent accuracy anomaly
    for fname, expect, what in (
            ("num-node-list.csv.gz", x.shape[0], "node-feat rows"),
            ("num-edge-list.csv.gz", edge.shape[0], "edge rows")):
        f = os.path.join(raw, fname)
        if os.path.exists(f):
            n_declared = int(np.loadtxt(f, dtype=np.int64).reshape(-1)[0])
            if n_declared != expect:
                raise ValueError(
                    f"{fname} declares {n_declared} but {what} = {expect}: "
                    f"the dataset copy under {path!r} is inconsistent")
    if y.shape[0] != x.shape[0]:
        raise ValueError(
            f"node-label rows ({y.shape[0]}) != node-feat rows "
            f"({x.shape[0]}) under {path!r}")
    if edge.size and int(edge.max()) >= x.shape[0]:
        raise ValueError(
            f"edge.csv.gz references node {int(edge.max())} but only "
            f"{x.shape[0]} nodes have features under {path!r}")
    split = {}
    for sdir in sorted(glob.glob(os.path.join(path, "split", "*"))):
        got = {}
        for k in ("train", "valid", "test"):
            f = os.path.join(sdir, f"{k}.csv.gz")
            if os.path.exists(f):
                got[k] = np.loadtxt(f, delimiter=",",
                                    dtype=np.int64).reshape(-1)
        if got:
            split = got
            break
    return Data(x=x, edge_index=edge.T.copy(), y=y), split


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
    # ``rng.choice(n, size=e, p=pop)``, as numpy draws it (the normalised
    # cdf searched right of e uniforms), with torch's multi-threaded search
    cdf = pop.cumsum()
    cdf /= cdf[-1]
    src = torch.searchsorted(torch.from_numpy(cdf),
                             torch.from_numpy(rng.random(e)),
                             right=True).numpy()
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


def planted_hetero(*, num_types: int = 3, num_rels: int = 6,
                   nodes_per_type: int = 20_000, edges_per_rel: int = 120_000,
                   feat_dim: int = 64, num_classes: int = 16, seed: int = 0,
                   teacher_hops: int = 2, noise: float = 1.0,
                   anti_paired: bool = False,
                   split=(0.6, 0.2, 0.2)):
    """Heterogeneous planted-teacher dataset (typed analogue of
    :func:`planted_ogbn`).

    Node types ``v0..v{T-1}`` with Gaussian features; relations ``r0..r{R-1}``
    wire type ``i % T`` -> ``(i + 1 + i // T) % T`` (a mix including
    self-type edges, mirroring the reference's FakeHeteroDataset fixture
    scheme, the reference's src/data/io.rs:21-65).  The teacher propagates
    class scores through each relation with a DISTINCT random class-mixing
    matrix, so the label signal on the seed type ``v0`` is typed: a model
    that collapses relation types mixes incompatible transforms and loses
    accuracy.

    Returns ``(xs, edge_index, y, split_dict)``: per-type features, per-
    relation ``(src_type, rel, dst_type) -> (2, E)`` COO, labels on v0, and
    train/valid/test indices into v0.
    """
    if anti_paired and num_rels % 2:
        raise ValueError("anti_paired needs an even num_rels: every +mix "
                         "relation must have its -mix partner or untyped "
                         "aggregation no longer cancels the signal")
    rng = np.random.default_rng(seed)
    T, R, n = num_types, num_rels, nodes_per_type
    types = [f"v{i}" for i in range(T)]
    xs = {t: rng.normal(size=(n, feat_dim)).astype(np.float32)
          for t in types}
    c = num_classes
    edge_index, mix = {}, {}
    for i in range(R):
        if anti_paired:
            # relations 2j and 2j+1 share (src, dst) but mix with OPPOSITE
            # sign: untyped (relation-blind) aggregation cancels the label
            # signal in expectation, typed models recover it — the clean
            # demonstration of what relation typing buys
            pair, sign = i // 2, (1.0 if i % 2 == 0 else -1.0)
            s, d = pair % T, (pair + 1) % T
        else:
            s, d = i % T, (i + 1 + i // T) % T
        key = (f"v{s}", f"r{i}", f"v{d}")
        src = rng.integers(0, n, edges_per_rel)
        dst = rng.integers(0, n, edges_per_rel)
        edge_index[key] = np.stack([src, dst]).astype(np.int64)
        if anti_paired:
            if i % 2 == 0:
                base = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(
                    np.float32)
            mix[key] = sign * base
        else:
            mix[key] = (rng.normal(size=(c, c)) / np.sqrt(c)).astype(
                np.float32)

    w = {t: (rng.normal(size=(feat_dim, c)) / np.sqrt(feat_dim))
         .astype(np.float32) for t in types}
    h = {t: xs[t] @ w[t] for t in types}
    for _ in range(teacher_hops):
        agg = {t: np.zeros_like(h[t]) for t in types}
        cnt = {t: 0 for t in types}
        for (s, _r, d), ei in edge_index.items():
            agg[d] += _mean_in_neighbors(h[s], ei[0], ei[1], n) \
                @ mix[(s, _r, d)]
            cnt[d] += 1
        h = {t: 0.5 * h[t] + 0.5 * agg[t] / max(cnt[t], 1) for t in types}

    hv = h["v0"] / max(h["v0"].std(), 1e-6)
    logits = hv * 3.0 + noise * rng.normal(size=hv.shape).astype(np.float32)
    y = logits.argmax(axis=1).astype(np.int64)

    perm = rng.permutation(n)
    n_tr, n_va = int(split[0] * n), int(split[1] * n)
    split_dict = {"train": np.sort(perm[:n_tr]),
                  "valid": np.sort(perm[n_tr:n_tr + n_va]),
                  "test": np.sort(perm[n_tr + n_va:])}
    return xs, edge_index, y, split_dict


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
