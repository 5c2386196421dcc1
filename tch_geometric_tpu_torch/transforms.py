"""Transform-level API: dataset-wrapped callable samplers.

Counterpart of ``tch_geometric_tpu/transforms.py``.  A transform wraps a
``Data`` / ``HeteroData`` object, builds its CSC (or CSR) graphs once on
``device`` (cached per device by the data object) and, called on a batch of
input nodes, samples there and returns a filtered batch: the sample
compacted on the host, features and labels gathered by node id and
original-order edge ids through ``perm`` — the role PyG's ``filter_data``
plays for the reference's examples.  The gathers stay on the host, as in
the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from .data.dataset import Data, HeteroData
from .sampling import rng as _rng
from .sampling.hetero_neighbor import (compact_hetero_sample,
                                       sample_hetero_neighbors)
from .sampling.hgt import compact_hgt_sample, sample_hgt
from .sampling.negative import _heterogenous as _negative_hetero
from .sampling.negative import _homogenous as _negative_homo
from .sampling.neighbor import compact_sample, sample_neighbors
from .utils.config import EdgeSampler
from .utils.types import NodeType, RelType, rel_key


@dataclass
class Batch:
    """Homogeneous sampled batch (the ``filter_data`` output analogue)."""

    x: np.ndarray                 # (n, F) gathered features
    edge_index: np.ndarray        # (2, e) local-id COO
    n_id: np.ndarray              # (n,) global node ids
    e_id: np.ndarray              # (e,) original COO edge ids (-1 = none)
    y: Optional[np.ndarray] = None
    layer_offsets: Optional[List[Tuple[int, int, int]]] = None
    edge_attrs: Dict[str, np.ndarray] = field(default_factory=dict)


@dataclass
class HeteroBatch:
    x: Dict[NodeType, np.ndarray]
    edge_index: Dict[RelType, np.ndarray]
    n_id: Dict[NodeType, np.ndarray]
    e_id: Dict[RelType, np.ndarray]
    y: Dict[NodeType, np.ndarray] = field(default_factory=dict)
    node_timestamps: Dict[NodeType, np.ndarray] = field(default_factory=dict)
    layer_offsets: Dict[RelType, list] = field(default_factory=dict)


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


class NeighborSamplerTransform:
    """GraphSAGE-style neighbor sampling over Data or HeteroData."""

    def __init__(self, data: Union[Data, HeteroData],
                 num_neighbors: Union[List[int], Dict],
                 sampler: Optional[EdgeSampler] = None,
                 filter: Optional[tuple] = None,
                 num_hops: Optional[int] = None, *, device="cuda"):
        self.data = data
        self.num_neighbors = num_neighbors
        self.sampler = sampler
        self.filter = filter
        self.hetero = isinstance(data, HeteroData)
        if self.hetero:
            self.graphs = {rel_key(e): data.csc(e, device)
                           for e in data.edge_types}
            self.perms = {r: _host(g.perm) for r, g in self.graphs.items()}
            if isinstance(num_neighbors, list):
                self.num_neighbors = {rel_key(e): list(num_neighbors)
                                      for e in data.edge_types}
            self.num_hops = num_hops or len(
                next(iter(self.num_neighbors.values())))
        else:
            self.graph = data.csc(device)
            self.perm = _host(self.graph.perm)    # host copy, once

    def __call__(self, inputs, key=None):
        if key is None:
            key = _rng.next_key()
        if self.hetero:
            return self._call_hetero(inputs, key)
        out = sample_neighbors(self.graph, np.asarray(inputs),
                               self.num_neighbors, key=key,
                               sampler=self.sampler, filter=self.filter)
        samples, rows, cols, eptr, offs = compact_sample(out)
        e_id = self.perm[eptr]
        data = self.data
        return Batch(
            x=data.x[samples],
            edge_index=np.stack([rows, cols]),
            n_id=samples,
            e_id=e_id,
            y=None if data.y is None else data.y[samples],
            layer_offsets=offs,
            edge_attrs={k: v[e_id] for k, v in data.edge_attrs.items()},
        )

    def _call_hetero(self, inputs, key):
        data: HeteroData = self.data
        out = sample_hetero_neighbors(
            self.graphs, data.edge_types,
            {t: np.asarray(v) for t, v in inputs.items()},
            self.num_neighbors, self.num_hops, node_types=data.node_types,
            key=key, sampler=self.sampler, filter=self.filter)
        samples, rows, cols, eptr, offs = compact_hetero_sample(out)
        e_id, edge_index = {}, {}
        for e in data.edge_types:
            r = rel_key(e)
            e_id[r] = self.perms[r][eptr[r]]
            edge_index[r] = np.stack([rows[r], cols[r]])
        return HeteroBatch(
            x={t: data.x[t][samples[t]] for t in samples},
            edge_index=edge_index,
            n_id=samples,
            e_id=e_id,
            y={t: data.y[t][samples[t]] for t in data.y if t in samples},
            layer_offsets=offs,
        )


class HGTSamplerTransform:
    """Budget-based (temporal) HGT sampling over HeteroData."""

    def __init__(self, data: HeteroData, num_samples: Union[List[int], Dict],
                 num_hops: Optional[int] = None, temporal: bool = False, *,
                 device="cuda"):
        self.data = data
        if isinstance(num_samples, list):
            num_samples = {t: list(num_samples) for t in data.node_types}
        self.num_samples = num_samples
        self.num_hops = num_hops or len(next(iter(num_samples.values())))
        self.temporal = temporal
        self.graphs = {rel_key(e): data.csc(e, device)
                       for e in data.edge_types}
        self.perms = {r: _host(g.perm) for r, g in self.graphs.items()}
        # edge timestamps by sorted edge, once
        self.edge_ts = None
        if temporal:
            self.edge_ts = {}
            for e in data.edge_types:
                attrs = data.edge_attrs.get(e, {})
                if "timestamps" in attrs:
                    self.edge_ts[rel_key(e)] = np.asarray(
                        attrs["timestamps"])[self.perms[rel_key(e)]].astype(
                            np.int64)

    def __call__(self, inputs, input_timestamps=None, timerange=None,
                 key=None):
        if key is None:
            key = _rng.next_key()
        data = self.data
        out = sample_hgt(
            self.graphs, data.edge_types,
            {t: np.asarray(v) for t, v in inputs.items()},
            self.num_samples, self.num_hops, node_counts=data.node_counts,
            edge_timestamps=self.edge_ts,
            input_timestamps=None if input_timestamps is None else
            {t: np.asarray(v) for t, v in input_timestamps.items()},
            timerange=timerange, node_types=data.node_types, key=key)
        nodes, ts, rows, cols, eptr = compact_hgt_sample(out)
        edge_index, e_id = {}, {}
        for e in data.edge_types:
            r = rel_key(e)
            edge_index[r] = np.stack([rows[r], cols[r]])
            e_id[r] = self.perms[r][eptr[r]]
        return HeteroBatch(
            x={t: data.x[t][nodes[t]] for t in nodes},
            edge_index=edge_index,
            n_id=nodes,
            e_id=e_id,
            y={t: data.y[t][nodes[t]] for t in data.y if t in nodes},
            node_timestamps=ts,
        )


class NegativeSamplerTransform:
    """Neighbor-aware negative sampling over Data or HeteroData, on the
    data's cached CSR graphs (the parity functions' draws and probes without
    rebuilding a graph per call)."""

    def __init__(self, data: Union[Data, HeteroData], num_neg: int,
                 try_count: int, inbound: bool = False, *, device="cuda"):
        self.data = data
        self.num_neg = num_neg
        self.try_count = try_count
        self.inbound = inbound
        self.device = device
        self.hetero = isinstance(data, HeteroData)

    def __call__(self, inputs, key=None):
        if key is None:
            key = _rng.next_key()
        dev = self.device
        if self.hetero:
            data: HeteroData = self.data
            samples, rows, cols, _counts = _negative_hetero(
                key, {rel_key(e): data.csr(e, dev) for e in data.edge_types},
                data.node_types, data.edge_types,
                {rel_key(e): data.size(e) for e in data.edge_types},
                {t: np.asarray(v) for t, v in inputs.items()},
                self.num_neg, self.try_count, self.inbound)
            return HeteroBatch(
                x={t: data.x[t][samples[t]] for t in samples},
                edge_index={r: np.stack([rows[r], cols[r]]) for r in rows},
                n_id=samples,
                e_id={r: np.full(rows[r].shape, -1, np.int64) for r in rows},
            )
        data: Data = self.data
        samples, rows, cols, _count = _negative_homo(
            key, data.csr(dev), np.asarray(inputs), data.num_nodes,
            self.num_neg, self.try_count)
        return Batch(
            x=data.x[samples],
            edge_index=np.stack([rows, cols]),
            n_id=samples,
            e_id=np.full(rows.shape, -1, np.int64),
            y=None if data.y is None else data.y[samples],
        )
