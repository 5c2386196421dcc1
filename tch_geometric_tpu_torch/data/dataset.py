"""Homogeneous graph container (the ``Data`` half of
``tch_geometric_tpu/data/dataset.py``): host numpy payload, with the CSC and
CSR device graphs built at first use and cached per device."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from .graph import SparseGraph
from .storage import csc_graph_from_coo, csr_graph_from_coo


@dataclass
class Data:
    """Homogeneous graph: x (N, F), optional y (N,), edge_index (2, E),
    optional per-edge attrs keyed by name (original COO order)."""

    x: np.ndarray
    edge_index: np.ndarray
    y: Optional[np.ndarray] = None
    edge_attrs: Dict[str, np.ndarray] = field(default_factory=dict)

    _csc: Dict[str, SparseGraph] = field(default_factory=dict, repr=False)
    _csr: Dict[str, SparseGraph] = field(default_factory=dict, repr=False)

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    def csc(self, device="cuda") -> SparseGraph:
        """In-neighbor adjacency on ``device`` (built once per device)."""
        k = str(device)
        if k not in self._csc:
            self._csc[k] = csc_graph_from_coo(self.edge_index, self.num_nodes,
                                              device=device)
        return self._csc[k]

    def csr(self, device="cuda") -> SparseGraph:
        """Out-neighbor adjacency on ``device`` (built once per device)."""
        k = str(device)
        if k not in self._csr:
            self._csr[k] = csr_graph_from_coo(self.edge_index, self.num_nodes,
                                              device=device)
        return self._csr[k]

    @staticmethod
    def from_npz(path: str) -> "Data":
        """x, edge_index and, where present, y of an ``.npz`` file."""
        d = np.load(path)
        return Data(x=d["x"].astype(np.float32),
                    y=d["y"].astype(np.int64) if "y" in d.files else None,
                    edge_index=d["edge_index"].astype(np.int64))
