"""Graph containers of ``tch_geometric_tpu/data/dataset.py``: ``Data``
(homogeneous) and ``HeteroData`` (per-type features, per-edge-type COO).
The payload is host numpy; the CSC and CSR device graphs are built at first
use and cached per device (and per edge type)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ..utils.types import EdgeType, NodeType, rel_key
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


@dataclass
class HeteroData:
    """Heterogeneous graph: per-type features, per-edge-type COO."""

    x: Dict[NodeType, np.ndarray]
    edge_index: Dict[EdgeType, np.ndarray]
    y: Dict[NodeType, np.ndarray] = field(default_factory=dict)
    edge_attrs: Dict[EdgeType, Dict[str, np.ndarray]] = field(
        default_factory=dict)

    _csc: Dict[Tuple[str, str], SparseGraph] = field(default_factory=dict,
                                                     repr=False)
    _csr: Dict[Tuple[str, str], SparseGraph] = field(default_factory=dict,
                                                     repr=False)

    @property
    def node_types(self):
        return sorted(self.x.keys())

    @property
    def edge_types(self):
        return sorted(self.edge_index.keys())

    def num_nodes(self, t: NodeType) -> int:
        return int(self.x[t].shape[0])

    @property
    def node_counts(self) -> Dict[NodeType, int]:
        return {t: self.num_nodes(t) for t in self.x}

    def size(self, e: EdgeType) -> Tuple[int, int]:
        return (self.num_nodes(e[0]), self.num_nodes(e[2]))

    def csc(self, e: EdgeType, device="cuda") -> SparseGraph:
        """In-neighbor adjacency of edge type ``e`` on ``device`` (built
        once per device)."""
        k = (rel_key(e), str(device))
        if k not in self._csc:
            self._csc[k] = csc_graph_from_coo(self.edge_index[e], self.size(e),
                                              device=device)
        return self._csc[k]

    def csr(self, e: EdgeType, device="cuda") -> SparseGraph:
        """Out-neighbor adjacency of edge type ``e`` on ``device`` (built
        once per device)."""
        k = (rel_key(e), str(device))
        if k not in self._csr:
            self._csr[k] = csr_graph_from_coo(self.edge_index[e], self.size(e),
                                              device=device)
        return self._csr[k]

    @staticmethod
    def from_npz(path: str) -> "HeteroData":
        """The fixture key scheme: ``node_{t}_x``, ``node_{t}_y``,
        ``edge_{src-rel-dst}_edge_index``."""
        d = np.load(path)
        x: Dict[str, np.ndarray] = {}
        y: Dict[str, np.ndarray] = {}
        ei: Dict[EdgeType, np.ndarray] = {}
        for k in d.files:
            if k.startswith("node_") and k.endswith("_x"):
                x[k[5:-2]] = d[k].astype(np.float32)
            elif k.startswith("node_") and k.endswith("_y"):
                y[k[5:-2]] = d[k].astype(np.int64)
            elif k.startswith("edge_") and k.endswith("_edge_index"):
                s, r, t = k[5:-11].split("-")
                ei[(s, r, t)] = d[k].astype(np.int64)
        return HeteroData(x=x, y=y, edge_index=ei)
