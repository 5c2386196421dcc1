"""Sampler / filter configuration dataclasses.

API-parity with the reference's Python config layer
(reference tch_geometric/utils.py:17-67): ``UniformEdgeSampler``,
``WeightedEdgeSampler``, ``TemporalEdgeFilter`` plus ``validate_mixeddata``.
Where the reference structurally matches these into PyO3 enums and
monomorphises per (sampler x filter-mode x direction) via a macro
(src/python.rs:107-185), here the sampler branches on the config in Python
and the array payloads (weights/timestamps) are tensors.  A copy of
``tch_geometric_tpu/utils/config.py`` (the torch package imports nothing
from the JAX package), plus ``WeightedEdgeSampler.with_replacement``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import numpy as np

MixedData = Union[np.ndarray, "torch.Tensor", Dict[str, np.ndarray]]  # noqa: F821

TEMPORAL_SAMPLE_STATIC: int = 0
TEMPORAL_SAMPLE_RELATIVE: int = 1
TEMPORAL_SAMPLE_DYNAMIC: int = 2


def validate_mixeddata(data, hetero: bool = False, dtype=None) -> None:
    """Strict boundary validation (tch_geometric/utils.py:17-23)."""
    if hetero:
        assert isinstance(data, dict), "hetero MixedData must be a dict"
        for v in data.values():
            assert np.asarray(v).dtype == dtype, f"expected dtype {dtype}"
    else:
        assert np.asarray(data).dtype == dtype, f"expected dtype {dtype}"


@dataclass
class EdgeSampler:
    def validate(self, hetero: bool = False) -> None:
        raise NotImplementedError


@dataclass
class UniformEdgeSampler(EdgeSampler):
    """Uniform neighbor sampling, with or without replacement
    (UnweightedSampler<REPLACE>, neighbor_sampling.rs:93-129)."""

    with_replacement: bool = False

    def validate(self, hetero: bool = False) -> None:
        pass


@dataclass
class WeightedEdgeSampler(EdgeSampler):
    """Per-edge-weight sampling (WeightedSampler, neighbor_sampling.rs:131-158).

    ``weights`` is addressed by *sorted* (CSC) edge position, matching the
    reference's ``EdgeAttr`` addressing by global edge ptr (graph.rs:104-120).
    ``with_replacement`` draws ``k`` independent weighted picks per node:
    the JAX package's ``_sample_neighbors_impl(with_replacement=True,
    log_weights=...)``, which its ``WeightedEdgeSampler`` has no field for.
    """

    weights: MixedData = None
    with_replacement: bool = False

    def validate(self, hetero: bool = False) -> None:
        validate_mixeddata(self.weights, hetero=hetero, dtype=np.float64)


@dataclass
class TemporalEdgeFilter:
    """3-mode temporal window filter (TemporalFilter, neighbor_sampling.rs:36-77).

    mode=STATIC: absolute window on edge timestamp.
    mode=RELATIVE: window on (t - root_state); state frozen along the path.
    mode=DYNAMIC: window on (t - prev_state); state := edge timestamp.
    ``forward=False`` negates the delta (backward-in-time window).
    Window bounds are INCLUSIVE on both ends (RangeInclusive, rs:55-66).
    """

    window: Tuple[int, int] = (0, 0)
    timestamps: MixedData = None
    forward: bool = False
    mode: int = TEMPORAL_SAMPLE_STATIC

    def validate(self, hetero: bool = False) -> None:
        validate_mixeddata(self.timestamps, hetero=hetero, dtype=np.int64)
