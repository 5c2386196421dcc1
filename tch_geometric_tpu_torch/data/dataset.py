"""Homogeneous graph container (the ``Data`` half of
``tch_geometric_tpu/data/dataset.py``): host numpy payload only.  Device
structures are built explicitly with ``to_csc`` + ``make_graph``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class Data:
    """Homogeneous graph: x (N, F), optional y (N,), edge_index (2, E),
    optional per-edge attrs keyed by name (original COO order)."""

    x: np.ndarray
    edge_index: np.ndarray
    y: Optional[np.ndarray] = None
    edge_attrs: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])
