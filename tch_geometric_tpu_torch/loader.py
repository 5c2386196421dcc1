"""Seed-node batch loaders.

Counterpart of ``tch_geometric_tpu/loader.py``: batching is a seed iterator
(sampling runs on the device per batch), and ``to_csc`` / ``to_csr`` take a
``Data`` object or raw COO.  ``SeedLoader`` shuffles with numpy's
``default_rng(seed)``, so both packages give the same batches.
"""
from __future__ import annotations

from typing import Iterator, Union

import numpy as np

from .data.dataset import Data
from .data.storage import to_csc as _to_csc
from .data.storage import to_csr as _to_csr


def to_csc(data: Union[Data, np.ndarray], size=None):
    """``(col_ptrs, row_indices, perm)`` of a Data object or raw COO."""
    if isinstance(data, Data):
        return _to_csc(data.edge_index, data.num_nodes)
    return _to_csc(data, size)


def to_csr(data: Union[Data, np.ndarray], size=None):
    """``(row_ptrs, col_indices, perm)`` of a Data object or raw COO."""
    if isinstance(data, Data):
        return _to_csr(data.edge_index, data.num_nodes)
    return _to_csr(data, size)


class SeedLoader:
    """Shuffled fixed-size seed-node batches.

    ``drop_last`` (default) keeps every batch the same size; otherwise the
    remainder is a last short batch, or with ``pad_last`` one padded to the
    batch size by repeating it.
    """

    def __init__(self, seeds: np.ndarray, batch_size: int, *,
                 shuffle: bool = True, drop_last: bool = True,
                 pad_last: bool = False, seed: int = 0):
        self.seeds = np.asarray(seeds)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.seeds) // self.batch_size
        if not self.drop_last and len(self.seeds) % self.batch_size:
            n += 1
        return n

    def __iter__(self) -> Iterator[np.ndarray]:
        order = np.arange(len(self.seeds))
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        full = len(self.seeds) // bs * bs
        for i in range(0, full, bs):
            yield self.seeds[order[i:i + bs]]
        rem = len(self.seeds) - full
        if rem and not self.drop_last:
            tail = self.seeds[order[full:]]
            yield np.resize(tail, bs) if self.pad_last else tail
