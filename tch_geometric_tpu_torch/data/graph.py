"""Device-resident sparse graph containers.

Counterpart of ``tch_geometric_tpu/data/graph.py``: the adjacency lives in
device tensors and every lookup (neighbor window, degree) is a batched
gather over a whole frontier.  The two sampling tables are built on the host
exactly as the JAX package builds them and then moved to the device:

* the ELL table — one row per node: ``W-2`` padded neighbor ids, the degree
  and the window start, so a uniform hop costs one row read per node;
* the aligned-window table — ``indices`` padded to 64-lane rows, for graphs
  whose ``max_degree`` does not fit an ELL width.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# Aligned-window gather table: `indices` reshaped to 64-lane rows.  A window
# of <= max_degree elements starting anywhere is covered by
# `window_row_count` consecutive rows.
WINDOW_LANES = 64
# The row table is built only when a window fits in this many rows.
MAX_WINDOW_ROWS = 8
# ELL row widths (int32 lanes): [0, W-2) neighbor ids, W-2 degree, W-1 start.
ELL_WIDTHS = (64, 128)


def window_row_count(max_degree: int) -> int:
    """Rows of WINDOW_LANES covering any window of <= max_degree lanes."""
    return -(-(WINDOW_LANES - 1 + max(int(max_degree), 1)) // WINDOW_LANES)


def ell_width_for(max_degree: int) -> Optional[int]:
    for w in ELL_WIDTHS:
        if max_degree <= w - 2:
            return w
    return None


@dataclass
class SparseGraph:
    """CSR- or CSC-shaped adjacency; orientation is by convention.

    * As **CSR**: ``indptr`` over source rows, ``indices`` destination
      columns (out-neighbors).
    * As **CSC**: ``indptr`` over destination columns, ``indices`` source
      rows (in-neighbors).

    ``indptr``/``indices``/``perm`` are int64; ``ell`` and ``indices_win``
    int32, as in the JAX package.
    """

    indptr: torch.Tensor                        # (N+1,)
    indices: torch.Tensor                       # (E,) sorted within each row
    perm: Optional[torch.Tensor] = None         # (E,) sorted -> original id
    indices_win: Optional[torch.Tensor] = None  # (ceil(E/64), 64)
    ell: Optional[torch.Tensor] = None          # (N, W)
    num_src: int = 0
    num_dst: int = 0
    max_degree: int = 0

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def num_ptr_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    def neighbors_range(self, nodes: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched (start, end) edge-pointer windows."""
        return self.indptr[nodes], self.indptr[nodes + 1]

    def gather_neighbors(self, edge_ptrs: torch.Tensor) -> torch.Tensor:
        """Edge pointer -> neighbor node id (clipped to the edge range)."""
        return self.indices[edge_ptrs.clamp(0, self.num_edges - 1)]

    def gather_neighbor_windows_rows(self, starts: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Whole neighbor windows via the aligned row table.

        Returns ``(win (B, R*64), off (B,))`` with
        ``win[i, off[i] + j] == indices[starts[i] + j]`` for ``j < deg(i)``.
        """
        if self.indices_win is None:
            raise ValueError("graph was built without the window table")
        R = window_row_count(self.max_degree)
        starts = starts.long()
        r0 = starts // WINDOW_LANES
        rows = r0[:, None] + torch.arange(R, device=starts.device)[None, :]
        rows = rows.clamp(0, self.indices_win.shape[0] - 1)
        win = self.indices_win[rows].reshape(starts.shape[0], R * WINDOW_LANES)
        return win, starts % WINDOW_LANES

    def ell_rows(self, nodes: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(neigh (B, W-2), deg (B,), start (B,))`` from one row each."""
        if self.ell is None:
            raise ValueError("graph was built without the ELL table")
        row = self.ell[nodes.clamp(0, self.ell.shape[0] - 1)]
        return row[..., :-2], row[..., -2], row[..., -1]


CsrGraph = SparseGraph
CscGraph = SparseGraph


def _ell_rows(indptr: np.ndarray, indices: np.ndarray, width: int
              ) -> np.ndarray:
    """Host build of the (N, width) int32 ELL rows."""
    E = indices.shape[0]
    N = indptr.shape[0] - 1
    starts = indptr[:-1].astype(np.int64)
    rows = np.empty((N, width), dtype=np.int32)
    lane = np.arange(width - 2, dtype=np.int64)[None, :]
    CH = 1 << 19                       # chunk rows: bounds host temporaries
    for lo in range(0, N, CH):
        hi = min(lo + CH, N)
        offs = starts[lo:hi, None] + lane
        rows[lo:hi, : width - 2] = indices[np.minimum(offs, max(E - 1, 0))]
    rows[:, width - 2] = np.diff(indptr)
    rows[:, width - 1] = starts
    return rows


def make_graph(indptr, indices, perm=None, *, num_src: int, num_dst: int,
               window_table: Optional[bool] = None,
               ell_table: Optional[bool] = None,
               device="cuda") -> SparseGraph:
    """Build a graph container on ``device``; ``max_degree`` on the host.

    ``ell_table=None`` builds the ELL rows when ``max_degree`` fits an ELL
    width; ``window_table=None`` builds the aligned-window table when ELL
    does not apply but windows fit ``MAX_WINDOW_ROWS`` rows.  True/False
    forces either.
    """
    indptr_np = np.asarray(indptr)
    indices_np = np.asarray(indices)
    E = indices_np.shape[0]
    max_deg = int(np.max(np.diff(indptr_np))) if indptr_np.shape[0] > 1 else 0

    ell = None
    W = ell_width_for(max_deg)
    if ell_table is None:
        ell_table = E > 0 and W is not None
    if ell_table and E > 0 and W is not None:
        ell = torch.from_numpy(_ell_rows(indptr_np, indices_np, W)).to(device)

    indices_win = None
    if window_table is None:
        window_table = (ell is None and E > 0
                        and window_row_count(max_deg) <= MAX_WINDOW_ROWS)
    if window_table and E > 0:
        pad = -E % WINDOW_LANES
        flat = np.pad(indices_np.astype(np.int32), (0, pad))
        indices_win = torch.from_numpy(flat.reshape(-1, WINDOW_LANES)).to(device)

    def _long(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)

    return SparseGraph(
        indptr=_long(indptr_np),
        indices=_long(indices_np),
        perm=None if perm is None else _long(perm),
        indices_win=indices_win,
        ell=ell,
        num_src=int(num_src),
        num_dst=int(num_dst),
        max_degree=max_deg,
    )
