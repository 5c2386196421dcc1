"""Fixture and dataset loaders.

Mirrors the reference's NPZ loaders (reference src/data/io.rs:7-65):
``karate.npz`` (x, y, edge_index) and ``fakeheterodataset.npz`` with the key
scheme ``node_{type}_x`` / ``edge_{src-rel-dst}_edge_index``.  The fixture
files themselves are copied verbatim from the reference test suite, as
SURVEY.md §4 prescribes.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..utils.types import EdgeType, NodeType

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "fixtures")


def _fixture_path(name: str) -> str:
    return os.path.join(FIXTURE_DIR, name)


def load_karate_graph(path: str | None = None):
    """Karate club: (x, y, edge_index) — io.rs:7-19. 34 nodes, 156 edges."""
    data = np.load(path or _fixture_path("karate.npz"))
    x = data["x"].astype(np.float32)
    y = data["y"].astype(np.int64)
    edge_index = data["edge_index"].astype(np.int64)
    return x, y, edge_index


def load_fake_dataset(path: str | None = None):
    """PyG FakeDataset export: 1144 nodes, 22648 edges."""
    data = np.load(path or _fixture_path("fakedataset.npz"))
    x = data["x"].astype(np.float32)
    y = data["y"].astype(np.int64)
    edge_index = data["edge_index"].astype(np.int64)
    return x, y, edge_index


def load_fake_hetero_graph(path: str | None = None) -> Tuple[
    Dict[NodeType, np.ndarray], Dict[EdgeType, np.ndarray]
]:
    """FakeHeteroDataset export — io.rs:21-65 key scheme.

    Returns (xs: node_type -> features, coo: edge_type -> (2, E) edge_index).
    """
    data = np.load(path or _fixture_path("fakeheterodataset.npz"))
    xs: Dict[NodeType, np.ndarray] = {}
    coo: Dict[EdgeType, np.ndarray] = {}
    for key in data.files:
        if key.startswith("node_") and key.endswith("_x"):
            node_type = key[len("node_"):-len("_x")]
            xs[node_type] = data[key].astype(np.float32)
        elif key.startswith("edge_") and key.endswith("_edge_index"):
            spec = key[len("edge_"):-len("_edge_index")]
            src, rel, dst = spec.split("-")
            coo[(src, rel, dst)] = data[key].astype(np.int64)
    return xs, coo
