"""Device-resident sparse graph containers.

Counterpart of ``tch_geometric_tpu/data/graph.py``: the adjacency lives in
device tensors and every lookup (neighbor window, degree) is a batched
gather over a whole frontier.  The two sampling tables hold what the JAX
package's host build holds, built by torch ops on the graph's device:

* the ELL table — one row per node: ``W-2`` padded neighbor ids, the degree
  and the window start, so a uniform hop costs one row read per node;
* the aligned-window table — ``indices`` padded to 64-lane rows, for graphs
  whose ``max_degree`` does not fit an ELL width.

Edge membership (``find_edge`` / ``has_edge``) is a branchless binary search
over each row's sorted neighbors with ``_bisect_iters(max_degree)`` steps,
vectorised over a whole batch of queries.
"""
from __future__ import annotations

import math
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


def take_clamped(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``values[idx]`` with every index clamped into range; an empty
    ``values`` (a graph with no edges) reads 0, a value the caller masks by
    the degree."""
    if values.shape[0] == 0:
        return torch.zeros(idx.shape, dtype=values.dtype,
                           device=values.device)
    return values[idx.clamp(0, values.shape[0] - 1)]


def _bisect_iters(max_degree: int) -> int:
    """Binary-search steps that settle any row of <= max_degree entries."""
    return max(1, math.ceil(math.log2(max(int(max_degree), 1) + 1)))


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

    def degree(self, nodes) -> torch.Tensor:
        """Batched row degree."""
        nodes = torch.as_tensor(nodes, device=self.device)
        return self.indptr[nodes + 1] - self.indptr[nodes]

    def neighbors_range(self, nodes: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched (start, end) edge-pointer windows."""
        return self.indptr[nodes], self.indptr[nodes + 1]

    def gather_neighbors(self, edge_ptrs: torch.Tensor) -> torch.Tensor:
        """Edge pointer -> neighbor node id (clipped to the edge range)."""
        return take_clamped(self.indices, edge_ptrs)

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

    def _ptr(self, u: torch.Tensor) -> torch.Tensor:
        """``indptr[u]`` with JAX's gather rule: a negative index counts
        from the end once, then every index is clamped into range."""
        n = self.indptr.shape[0]
        return self.indptr[torch.where(u < 0, u + n, u).clamp(0, n - 1)]

    def find_edge(self, u, v) -> torch.Tensor:
        """Batched edge lookup: the global edge pointer of ``(u, v)`` or -1.
        ``u`` indexes the pointer axis, ``v`` is searched in ``u``'s sorted
        row by a branchless binary search of ``_bisect_iters(max_degree)``
        steps.  Equal to the JAX package's result for any ``u`` (its gathers
        clamp) and on a graph without edges."""
        u = torch.as_tensor(u, device=self.device).long()
        v = torch.as_tensor(v, device=self.device).long()
        lo, end = self._ptr(u), self._ptr(u + 1)
        E = self.num_edges
        if E == 0:
            return torch.full(torch.broadcast_shapes(u.shape, v.shape), -1,
                              dtype=torch.long, device=self.device)
        hi = end
        for _ in range(_bisect_iters(self.max_degree)):
            mid = (lo + hi) // 2
            go_right = (lo < hi) & (self.indices[mid.clamp(0, E - 1)] < v)
            lo, hi = (torch.where(go_right, mid + 1, lo),
                      torch.where(go_right | (lo >= hi), hi, mid))
        hit = (lo < end) & (self.indices[lo.clamp(0, E - 1)] == v)
        return torch.where(hit, lo, -1)

    def has_edge(self, u, v) -> torch.Tensor:
        """Batched edge membership: ``find_edge(u, v) >= 0``."""
        return self.find_edge(u, v) >= 0


CsrGraph = SparseGraph
CscGraph = SparseGraph


def _ell_rows(indptr: torch.Tensor, indices: torch.Tensor, width: int
              ) -> torch.Tensor:
    """The (N, width) int32 ELL rows, built on the tensors' device: lanes
    ``[0, width-2)`` the row's neighbors (past its end, the following ids,
    clamped to the last edge), then its degree and window start."""
    E = indices.shape[0]
    N = indptr.shape[0] - 1
    starts = indptr[:-1]
    rows = torch.empty((N, width), dtype=torch.int32, device=indptr.device)
    lane = torch.arange(width - 2, device=indptr.device)[None, :]
    CH = 1 << 19                       # chunk rows: bounds the temporaries
    for lo in range(0, N, CH):
        hi = min(lo + CH, N)
        offs = (starts[lo:hi, None] + lane).clamp(max=max(E - 1, 0))
        rows[lo:hi, : width - 2] = indices[offs].int()
    rows[:, width - 2] = (indptr[1:] - starts).int()
    rows[:, width - 1] = starts.int()
    return rows


def _long(a, device) -> torch.Tensor:
    a = a if torch.is_tensor(a) else torch.from_numpy(
        np.asarray(a, dtype=np.int64))
    return a.to(device=device, dtype=torch.long)


def make_graph(indptr, indices, perm=None, *, num_src: int, num_dst: int,
               window_table: Optional[bool] = None,
               ell_table: Optional[bool] = None,
               device="cuda") -> SparseGraph:
    """Build a graph container on ``device`` from host arrays or tensors;
    the sampling tables are built there too.

    ``ell_table=None`` builds the ELL rows when ``max_degree`` fits an ELL
    width; ``window_table=None`` builds the aligned-window table when ELL
    does not apply but windows fit ``MAX_WINDOW_ROWS`` rows.  True/False
    forces either.
    """
    indptr_t, indices_t = _long(indptr, device), _long(indices, device)
    E = indices_t.shape[0]
    max_deg = (int((indptr_t[1:] - indptr_t[:-1]).max())
               if indptr_t.shape[0] > 1 else 0)

    ell = None
    W = ell_width_for(max_deg)
    if ell_table is None:
        ell_table = E > 0 and W is not None
    if ell_table and E > 0 and W is not None:
        ell = _ell_rows(indptr_t, indices_t, W)

    indices_win = None
    if window_table is None:
        window_table = (ell is None and E > 0
                        and window_row_count(max_deg) <= MAX_WINDOW_ROWS)
    if window_table and E > 0:
        pad = indices_t.new_zeros(-E % WINDOW_LANES)
        indices_win = torch.cat([indices_t, pad]).int().reshape(
            -1, WINDOW_LANES)

    return SparseGraph(
        indptr=indptr_t,
        indices=indices_t,
        perm=None if perm is None else _long(perm, device),
        indices_win=indices_win,
        ell=ell,
        num_src=int(num_src),
        num_dst=int(num_dst),
        max_degree=max_deg,
    )
