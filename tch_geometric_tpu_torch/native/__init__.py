"""ctypes bindings for the native (C++) host components.

Counterpart of ``tch_geometric_tpu/native/__init__.py``.  ``graph_builder.cpp``
(a copy of the JAX package's source) is compiled with ``g++`` at first use
into ``build/native/`` at the root of the checkout (git-ignored), never next
to the source.  The library's name carries a hash of the source, the flags,
the compiler's version and the machine's C library, so an edited source or
another toolchain gets its own build, never a stale one (the build directory
may travel with a copy of the checkout to another machine; for the same
reason there is no ``-march=native``).

When the build fails (no compiler), :func:`available` is False, one line on
stderr says so, and ``data.storage`` falls back to its numpy sort.  The
boundary is plain ctypes over numpy buffers.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "graph_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_lib = None
_tried = False


@functools.lru_cache(maxsize=None)
def _toolchain() -> str:
    """``g++``'s version, the machine and its C library ('' without g++)."""
    try:
        out = subprocess.run(["g++", "-dumpfullversion", "-dumpmachine"],
                             capture_output=True, text=True, timeout=60)
        cxx = out.stdout
    except (OSError, subprocess.SubprocessError):
        cxx = ""
    return " ".join([cxx, platform.machine(), *platform.libc_ver()])


def lib_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes()
                       + " ".join(FLAGS + [_toolchain()]).encode())
    return BUILD_DIR / f"libgraph_builder-{h.hexdigest()[:12]}.so"


def _build() -> Optional[Path]:
    """Compile the library unless it is built; None if ``g++`` fails."""
    so = lib_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        print(f"tch_geometric_tpu_torch.native: build failed ({e}); "
              "using the numpy fallback", file=sys.stderr)
        return None
    os.replace(tmp, so)      # atomic: concurrent builds race harmlessly
    return so


def get_lib():
    """The loaded library, built first if needed; None if it cannot be."""
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        so = _build()
        if so is not None:
            lib = ctypes.CDLL(str(so))
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i64, u64 = ctypes.c_int64, ctypes.c_uint64
            sample_args = [i64p, i64p, i64p, i64, i64p, i64, u64, i64p, i64p,
                           i64p, i64p, i64p]
            for name, restype, argtypes in (
                    ("tgt_ind2ptr", None, [i64p, i64, i64, i64p]),
                    ("tgt_coo_to_csx", None, [i64p, i64p, i64, i64, i64,
                                              ctypes.c_int, i64p, i64p,
                                              i64p]),
                    ("tgt_neighbor_sample_golden", i64, sample_args),
                    ("tgt_neighbor_sample_golden_wor", i64, sample_args),
                    ("tgt_neighbor_sample_golden_weighted", i64,
                     sample_args[:2] + [f64p] + sample_args[2:]),
                    ("tgt_random_walk_golden", None,
                     [i64p, i64p, i64p, i64, i64, ctypes.c_double,
                      ctypes.c_double, u64, i64p])):
                f = getattr(lib, name)
                f.restype = restype
                f.argtypes = argtypes
            _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def ind2ptr(ind: np.ndarray, m: int) -> np.ndarray:
    """Sorted leading-index array -> pointer array (``m + 1`` entries)."""
    ind = _i64(ind)
    out = np.empty(m + 1, dtype=np.int64)
    get_lib().tgt_ind2ptr(ind, ind.shape[0], m, out)
    return out


def coo_to_csx(row: np.ndarray, col: np.ndarray, num_rows: int,
               num_cols: int, csc: bool
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stable two-pass counting sort: ``(ptrs, indices, perm)`` of the CSC
    (``csc``) or CSR layout.  Ids must lie in range (the caller checks)."""
    row, col = _i64(row), _i64(col)
    E = row.shape[0]
    ptrs = np.empty((num_cols if csc else num_rows) + 1, dtype=np.int64)
    indices = np.empty(E, dtype=np.int64)
    perm = np.empty(E, dtype=np.int64)
    get_lib().tgt_coo_to_csx(row, col, E, num_rows, num_cols, int(csc),
                             ptrs, indices, perm)
    return ptrs, indices, perm


def neighbor_sample_golden(col_ptrs, row_indices, inputs, fanouts, seed=1,
                           *, with_replacement=True, weights=None):
    """Sequential CPU oracle sampler: uniform with replacement, without
    (Algorithm-R reservoir) or weighted (A-Chao reservoir).  Returns
    ``(samples, rows, cols, eptr)``."""
    lib = get_lib()
    col_ptrs, row_indices = _i64(col_ptrs), _i64(row_indices)
    inputs, fanouts = _i64(inputs), _i64(fanouts)
    cap = layer = int(inputs.shape[0])
    for k in fanouts:
        layer *= int(k)
        cap += layer
    samples, rows, cols, eptr = (np.empty(cap, dtype=np.int64)
                                 for _ in range(4))
    n_edges = np.zeros(1, dtype=np.int64)
    common = (inputs, inputs.shape[0], fanouts, fanouts.shape[0], seed,
              samples, rows, cols, eptr, n_edges)
    if weights is not None:
        n = lib.tgt_neighbor_sample_golden_weighted(
            col_ptrs, row_indices,
            np.ascontiguousarray(weights, dtype=np.float64), *common)
    elif with_replacement:
        n = lib.tgt_neighbor_sample_golden(col_ptrs, row_indices, *common)
    else:
        n = lib.tgt_neighbor_sample_golden_wor(col_ptrs, row_indices,
                                               *common)
    m = int(n_edges[0])
    return samples[:n], rows[:m], cols[:m], eptr[:m]


def random_walk_golden(row_ptrs, col_indices, start, walk_length,
                       p=1.0, q=1.0, seed=1):
    """Sequential node2vec oracle: the reference's unbounded rejection loop
    with a binary-search ``has_edge``.  Returns ``(len(start),
    walk_length + 1)`` walks, -1 after a dead end."""
    row_ptrs, col_indices, start = (_i64(row_ptrs), _i64(col_indices),
                                    _i64(start))
    walks = np.empty((start.shape[0], walk_length + 1), dtype=np.int64)
    get_lib().tgt_random_walk_golden(row_ptrs, col_indices, start,
                                     start.shape[0], walk_length, float(p),
                                     float(q), seed, walks.reshape(-1))
    return walks
