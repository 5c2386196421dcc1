"""Failure detection, barriers and fault injection.

Counterpart of ``tch_geometric_tpu/parallel/resilience.py``: a mesh-wide
barrier with a host-side timeout for failure detection (checkpoint-restart,
``utils/checkpoint.py``, is the recovery unit), per-shard checksums, and a
fault-injection hook for the data-exchange step so tests can exercise
corruption detection.  Each takes any one axis, or tuple of axes, of a
multi-axis mesh: the values split over ``axis`` and replicate over the
other axes, as ``P(axis)`` places them in JAX.
"""
from __future__ import annotations

import concurrent.futures

import torch

from .mesh import Mesh, Split, along, axis_index, psum, spmd


def barrier(mesh: Mesh, *, axis: str = "data",
            timeout_s: float = 60.0) -> bool:
    """Mesh-wide barrier with a host-side timeout: True when every rank
    joined a ``psum`` of ones within ``timeout_s``; False signals a hung or
    failed rank (the caller should checkpoint-restart)."""
    n = mesh.axis_size(axis)
    ones = torch.ones((n,), dtype=torch.int32, device=mesh.device)

    def total():
        out = spmd(mesh, lambda x: psum(x.sum(), axis),
                   Split(ones, (axis,)))
        return int(out[0])

    ex = concurrent.futures.ThreadPoolExecutor(1)
    try:
        return ex.submit(total).result(timeout=timeout_s) == n
    except concurrent.futures.TimeoutError:
        return False
    finally:
        ex.shutdown(wait=False)


def shard_checksums(x: torch.Tensor, mesh: Mesh, *,
                    axis: str = "data") -> torch.Tensor:
    """One float32 checksum per shard, ``sum |x|`` over its block:
    comparing vectors across runs, or before and after an exchange, finds
    a corrupted shard."""
    return along(mesh, axis, spmd(mesh, lambda xs: xs.float().abs().sum(),
                                  Split(x, (axis,))))


def inject_shard_fault(x: torch.Tensor, device_index: int, mesh: Mesh, *,
                       axis: str = "data", mode: str = "zero"
                       ) -> torch.Tensor:
    """Corrupt one rank's shard (a test hook for the exchange step):
    ``'zero'`` wipes it, ``'flip'`` negates it.  Returns the blocks this
    process holds, concatenated."""
    if mode not in ("zero", "flip"):
        raise ValueError(mode)

    def corrupt(xs):
        if axis_index(axis) != device_index:
            return xs.clone()
        return torch.zeros_like(xs) if mode == "zero" else -xs

    out = along(mesh, axis, spmd(mesh, corrupt, Split(x, (axis,))))
    return out.reshape((-1,) + tuple(out.shape[2:]))
