"""COO <-> CSC/CSR conversion with edge permutation.

Counterpart of ``tch_geometric_tpu/data/storage.py``: edges are stably
sorted by ``(col * num_rows + row)`` (CSC) or ``(row * num_cols + col)``
(CSR), the pointer array is a prefix build over the sorted leading indices
(``ind2ptr``), and ``perm`` maps sorted-edge position -> original COO edge
id.  Three builds give the same arrays:

* ``to_csc`` / ``to_csr`` on the host: the native C++ counting sort
  (``tch_geometric_tpu_torch.native``) when it builds, else numpy's stable
  argsort;
* :func:`coo_to_csc_device`: a stable ``torch.sort`` of the int64 keys on
  the inputs' device.

``make_graph`` moves a host build to a device; ``csc_graph_from_coo`` /
``csr_graph_from_coo`` (and so ``Data.csc()`` / ``csr()``) build on the
device they are given.  ``ind2ptr_np`` is the numpy pointer build
and ``ind2ptr`` the torch one, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .graph import SparseGraph, make_graph


def ind2ptr_np(ind: np.ndarray, m: int) -> np.ndarray:
    """Sorted leading-index array -> pointer array:
    ``ptr[i] = #entries < i``."""
    ind = np.asarray(ind)
    return np.searchsorted(ind, np.arange(m + 1), side="left").astype(
        ind.dtype if ind.size else np.int64)


def ind2ptr(ind: torch.Tensor, m: int) -> torch.Tensor:
    """``ind2ptr_np`` on ``ind``'s device: ``searchsorted(ind, arange(m +
    1), side="left")``, int64."""
    ind = torch.as_tensor(ind)
    return torch.searchsorted(
        ind, torch.arange(m + 1, dtype=ind.dtype, device=ind.device),
        side="left")


def _coo_sort(row: np.ndarray, col: np.ndarray, num_rows: int,
              num_cols: int, csc: bool
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable argsort of edges by the (col, row) or (row, col) key."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    key = col * num_rows + row if csc else row * num_cols + col
    perm = np.argsort(key, kind="stable")
    return row[perm], col[perm], perm


def _numpy_csx(row_col, num_rows: int, num_cols: int, csc: bool
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The numpy build: ``(ptrs, indices, perm)``."""
    row_col = np.asarray(row_col)
    row, col, perm = _coo_sort(row_col[0], row_col[1], num_rows, num_cols,
                               csc)
    if csc:
        return ind2ptr_np(col, num_cols), row, perm
    return ind2ptr_np(row, num_rows), col, perm


def _native_csx(row_col, num_rows: int, num_cols: int, csc: bool):
    """The C++ counting-sort build, or None when the library cannot be
    built (``native`` has then said so on stderr)."""
    from .. import native
    if not native.available():
        return None
    row_col = np.asarray(row_col)
    return native.coo_to_csx(row_col[0], row_col[1], num_rows, num_cols, csc)


def _check_coo_bounds(row_col, num_rows, num_cols):
    """Reject out-of-range node ids before the native counting sort (its
    histogram would write out of bounds).  A frequent trigger is an int
    ``size`` for a rectangular COO — pass ``(num_rows, num_cols)``."""
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


def _to_csx(row_col, size, csc: bool):
    num_rows, num_cols = _norm_size(size)
    row_col = _check_coo_bounds(row_col, num_rows, num_cols)
    out = _native_csx(row_col, num_rows, num_cols, csc)
    return out if out is not None else _numpy_csx(row_col, num_rows,
                                                  num_cols, csc)


def to_csc(row_col, size) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO (2, E) -> ``(col_ptrs, row_indices, perm)`` as host arrays."""
    return _to_csx(row_col, size, csc=True)


def to_csr(row_col, size) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO (2, E) -> ``(row_ptrs, col_indices, perm)`` as host arrays."""
    return _to_csx(row_col, size, csc=False)


def coo_to_csc_device(row: torch.Tensor, col: torch.Tensor, num_rows: int,
                      num_cols: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """COO -> ``(col_ptrs, row_indices, perm)`` on ``row``'s device: a
    stable sort of the int64 keys ``col * num_rows + row`` (torch's default
    sort is not stable on CUDA).  The same arrays as ``to_csc``."""
    row, col = torch.as_tensor(row), torch.as_tensor(col)
    key = col.long() * num_rows + row.long()
    perm = torch.sort(key, stable=True).indices
    return ind2ptr(col[perm].long(), num_cols), row[perm], perm


def _graph_from_coo(row_col, size, csc: bool, device) -> SparseGraph:
    num_rows, num_cols = _norm_size(size)
    row_col = _check_coo_bounds(row_col, num_rows, num_cols)
    row = torch.from_numpy(np.asarray(row_col[0], dtype=np.int64)).to(device)
    col = torch.from_numpy(np.asarray(row_col[1], dtype=np.int64)).to(device)
    ptrs, indices, perm = (coo_to_csc_device(row, col, num_rows, num_cols)
                           if csc else
                           coo_to_csc_device(col, row, num_cols, num_rows))
    return make_graph(ptrs, indices, perm, num_src=num_rows,
                      num_dst=num_cols, device=device)


def csc_graph_from_coo(row_col, size, *, device="cuda") -> SparseGraph:
    """COO -> CSC graph (in-neighbor adjacency) with perm, built on
    ``device`` by ``coo_to_csc_device`` (the arrays of ``to_csc``)."""
    return _graph_from_coo(row_col, size, True, device)


def csr_graph_from_coo(row_col, size, *, device="cuda") -> SparseGraph:
    """COO -> CSR graph (out-neighbor adjacency) with perm, built on
    ``device`` (the CSC build of the transposed COO: the arrays of
    ``to_csr``)."""
    return _graph_from_coo(row_col, size, False, device)
