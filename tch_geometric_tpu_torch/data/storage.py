"""COO <-> CSC/CSR conversion with edge permutation.

Counterpart of ``tch_geometric_tpu/data/storage.py`` on its numpy path:
edges are stably sorted by ``(col * num_rows + row)`` (CSC) or
``(row * num_cols + col)`` (CSR), the pointer array is a prefix build over
the sorted leading indices (``ind2ptr``), and ``perm`` maps sorted-edge
position -> original COO edge id.  Conversion happens once at ingest, on the
host; ``make_graph`` moves the result to a device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def ind2ptr(ind: np.ndarray, m: int) -> np.ndarray:
    """Sorted leading-index array -> pointer array:
    ``ptr[i] = #entries < i``."""
    ind = np.asarray(ind)
    return np.searchsorted(ind, np.arange(m + 1), side="left").astype(
        ind.dtype if ind.size else np.int64)


def _coo_sort(row: np.ndarray, col: np.ndarray, num_rows: int,
              num_cols: int, csc: bool
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable argsort of edges by the (col, row) or (row, col) key."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    key = col * num_rows + row if csc else row * num_cols + col
    perm = np.argsort(key, kind="stable")
    return row[perm], col[perm], perm


def _check_coo_bounds(row_col, num_rows, num_cols):
    """Reject out-of-range node ids.  A frequent trigger is an int ``size``
    for a rectangular COO — pass ``(num_rows, num_cols)``."""
    row_col = np.asarray(row_col)
    if row_col.ndim != 2 or row_col.shape[0] != 2:
        raise ValueError(f"row_col must be (2, E), got {row_col.shape}")
    if row_col.shape[1] == 0:
        return row_col
    rmin, rmax = row_col[0].min(), row_col[0].max()
    cmin, cmax = row_col[1].min(), row_col[1].max()
    if rmin < 0 or rmax >= num_rows or cmin < 0 or cmax >= num_cols:
        raise ValueError(
            f"COO indices out of range: rows in [{rmin}, {rmax}] vs "
            f"num_rows={num_rows}, cols in [{cmin}, {cmax}] vs "
            f"num_cols={num_cols}; for rectangular graphs pass "
            "size=(num_rows, num_cols)")
    return row_col


def _norm_size(size) -> Tuple[int, int]:
    """GraphSize: int or (rows, cols) pair."""
    if isinstance(size, (tuple, list)):
        return int(size[0]), int(size[1])
    return int(size), int(size)


def to_csc(row_col, size) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO (2, E) -> ``(col_ptrs, row_indices, perm)`` as host arrays."""
    num_rows, num_cols = _norm_size(size)
    row_col = _check_coo_bounds(row_col, num_rows, num_cols)
    row, col, perm = _coo_sort(row_col[0], row_col[1], num_rows, num_cols,
                               csc=True)
    return ind2ptr(col, num_cols), row, perm


def to_csr(row_col, size) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO (2, E) -> ``(row_ptrs, col_indices, perm)`` as host arrays."""
    num_rows, num_cols = _norm_size(size)
    row_col = _check_coo_bounds(row_col, num_rows, num_cols)
    row, col, perm = _coo_sort(row_col[0], row_col[1], num_rows, num_cols,
                               csc=False)
    return ind2ptr(row, num_rows), col, perm
