"""Build the port's CUDA kernels with ``nvcc`` at first use, load them with
ctypes.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) into ``build/kernels/`` at the
root of the checkout (git-ignored).  The library name carries a hash of the
source, the shared headers and the flags, so an edited source or header is
rebuilt and never mixed with a stale build.  All missing libraries are
compiled together, one ``nvcc`` process per source.  There is no fallback: a missing ``nvcc`` or a failed
build raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_vp, _i, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# library -> {C function: (restype, argtypes)}
SIGNATURES: Dict[str, Dict[str, Tuple[object, List[object]]]] = {
    "spmm_blocked": {
        "tgt_spmm_blocked": (_i, [_vp, _i, _vp, _vp, _vp, _vp, _vp,
                                  _i, _i, _i, _i, _i, _vp, _vp]),
        "tgt_spmm_blocked_q8": (_i, [_vp, _vp, _vp, _vp, _vp, _vp,
                                     _i, _i, _i, _i, _i, _vp, _vp]),
        "tgt_cuda_error_string": (ctypes.c_char_p, [_i]),
    },
    "gat_blocked": {
        "tgt_edge_softmax_multihead": (_i, [_vp, _vp, _vp, _vp, _i, _i, _i,
                                            _i, _vp, _vp, _vp, _vp]),
        "tgt_gat_edge_softmax": (_i, [_vp, _vp, _i, ctypes.c_float, _vp, _vp,
                                      _vp, _vp, _i, _i, _i, _i, _vp, _vp,
                                      _vp, _vp]),
        "tgt_spmm_multiweighted": (_i, [_vp, _i, _vp, _vp, _vp, _vp, _vp,
                                        _i, _i, _i, _i, _i, _i, _vp, _vp]),
        "tgt_gat_count": (_i, [_vp, _i, _i, _i, _vp, _vp, _vp, _i, _vp, _vp,
                               _vp, _i, _i, _i, _i, _i, _i, ctypes.c_float,
                               _i, _vp, _vp, _vp, _vp, _vp, _vp]),
        "tgt_gat_attend": (_i, [_vp, _i, _i, _i, _vp, _vp, _i, _vp, _vp, _vp,
                                _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i, _i,
                                ctypes.c_float, _vp, _vp, _vp, _vp, _vp, _vp,
                                _vp, _vp, _i, _vp]),
        "tgt_cuda_error_string": (ctypes.c_char_p, [_i]),
    },
    "attend_blocked": {
        "tgt_sddmm_blocked": (_i, [_vp, _i64, _vp, _i, _vp, _vp, _vp,
                                   _i, _i, _i, _i, _vp, _vp]),
        "tgt_edge_softmax_blocked": (_i, [_vp, _vp, _vp, _i, _i, _i, _i,
                                          _vp, _vp]),
        "tgt_edge_softmax_logits": (_i, [_vp, _vp, _i, ctypes.c_float, _vp,
                                         _vp, _vp, _i, _i, _i, _i, _vp,
                                         _vp]),
        "tgt_edge_softmax_fast_lanes": (_i, []),
        "tgt_attend_fused": (_i, [_vp, _i64, _vp, _i, _vp, _vp, _vp, _vp,
                                  _i, _i, _i, _i, _i, _vp, _vp, _vp, _vp,
                                  _vp]),
        "tgt_attend_flash_count": (_i, [_vp, _vp, _i, _i, _i, _vp, _vp, _vp,
                                        _vp]),
        "tgt_attend_flash": (_i, [_vp, _i64, _vp, _i, _i, _vp, _vp, _vp, _vp,
                                  _vp, _i, _i, _i, _i, _i, _vp, _vp, _vp, _vp,
                                  _vp, _vp, _vp, _vp]),
        "tgt_cuda_error_string": (ctypes.c_char_p, [_i]),
    },
    "threefry": {
        "tgt_threefry": (_i, [_vp, _i64, _i64, _vp, ctypes.c_uint64, _i64,
                              _i64, _i, _vp, _vp]),
        "tgt_cuda_error_string": (ctypes.c_char_p, [_i]),
    },
    "floyd": {
        "tgt_floyd_hop": (_i, [_vp, _vp, _vp, _vp, _vp, _i64, _i64, _i64,
                               _i64, _i64, _i64, ctypes.c_uint64, _i64, _i64,
                               _vp, _vp, _vp, _vp, _vp, _vp]),
        "tgt_cuda_error_string": (ctypes.c_char_p, [_i]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> Path:
    # every source includes at most the shared headers of csrc/
    src = b"".join(f.read_bytes() for f in [CSRC / f"{name}.cu"]
                   + sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def build_all(names=None) -> Dict[str, Tuple[float, str]]:
    """Compile every library in ``names`` (default: all) that is not built
    yet, all ``nvcc`` processes at once.  Returns ``{name: (seconds,
    compiler output)}`` for the libraries compiled by this call."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    done = {}
    failed = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{log}")
            continue
        os.replace(tmp, lib_path(n))
        done[n] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _loaded[name] = lib
    return lib


def launch(name: str, fn: str, dev: torch.device, *args) -> None:
    """Call the C function ``fn`` of library ``name`` with ``args`` and the
    current stream of the CUDA device ``dev``; raise on a launch error.
    The device's context is entered only when ``dev`` is not the current
    device: entering it costs a launch's time."""
    lib = load(name)
    current = torch.cuda.current_device()
    index = current if dev.index is None else dev.index
    with (contextlib.nullcontext() if index == current
          else torch.cuda.device(index)):
        rc = getattr(lib, fn)(*args,
                              torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        msg = lib.tgt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn} launch failed: {msg} ({rc})")
