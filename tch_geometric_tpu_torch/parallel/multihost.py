"""Multi-process execution plumbing over ``torch.distributed``.

Counterpart of ``tch_geometric_tpu/parallel/multihost.py``: the thin layer
between a launcher and the rank-count-agnostic distributed functions
(``dist_sampling``, ``sharded_features``, ``partition``), which run
unchanged on one process of P thread ranks or on P processes.

* :func:`initialize` — bring the process group up: NCCL for a CUDA device,
  gloo for the CPU, from an explicit ``file://`` or ``tcp://`` address with
  the world size and rank, or from the usual environment variables
  (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); idempotent.
* :func:`make_mesh` — a mesh over every process of the group (one rank per
  process, ``ici_shape`` tiling each host's processes and the DCN axis
  striding over hosts, as JAX's); without a group, a thread mesh of
  ``ici_shape``'s ranks.
* :func:`global_from_local`, :func:`replicated`, :func:`local_seed_shard`,
  :func:`put_partitioned`, :func:`placed` — per-process data: each process
  materialises only its block of a sharded value under its spec and hands
  it to :func:`.mesh.spmd` as a :class:`~.mesh.LocalShard`.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import (LocalShard, Mesh, ProcessGroupComm, Split, _tree_map,
                   local_block)
from .mesh import make_mesh as _mesh_of


def _dist():
    import torch.distributed as dist
    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               timeout_s: float = 600.0) -> None:
    """Bring the process group up (idempotent).

    ``coordinator_address``: a ``file://`` store path, a ``tcp://host:port``
    or a bare ``host:port``, with ``num_processes`` and ``process_id``;
    None reads the environment (``env://``).  A CUDA ``device`` selects
    the process's card (``LOCAL_RANK``, else the rank modulo the cards) and
    the NCCL backend; a CPU one gloo."""
    if is_initialized():
        return
    dist = _dist()
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {}
    if coordinator_address is None:
        init_method = "env://"
        rank = int(os.environ.get("RANK", 0))
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        rank = int(process_id)
        kw = dict(world_size=int(num_processes), rank=rank)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(device.index if device.index is not None
                              else local)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)


def shutdown() -> None:
    """Tear the process group down (no-op without one)."""
    if is_initialized():
        _dist().destroy_process_group()


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def make_mesh(axis_names: Sequence[str] = ("data",),
              ici_shape: Optional[Sequence[int]] = None,
              dcn_axis: Optional[str] = None, *, device="cuda") -> Mesh:
    """A mesh over every rank.

    One process (no group): a thread mesh of ``ici_shape`` (default one
    rank).  A process group (one rank a process, each driving one device):
    ``ici_shape`` None puts every process on ``dcn_axis`` (default the
    first axis name), every other axis of size 1.  Else a host is
    ``prod(ici_shape)`` consecutive processes tiled by ``ici_shape``, and
    ``dcn_axis`` strides over the hosts (its size times the host count),
    JAX's hybrid layout with processes for devices; the ranks stay
    row-major, so no axis before ``dcn_axis`` may tile a host."""
    axis_names = tuple(axis_names)
    if not is_initialized():
        shape = tuple(ici_shape) if ici_shape else (1,)
        return _mesh_of(shape, axis_names, device=device)
    dcn_axis = dcn_axis or axis_names[0]
    di = axis_names.index(dcn_axis)
    n_proc = process_count()
    if ici_shape is None:
        shape = tuple(n_proc if n == dcn_axis else 1 for n in axis_names)
    else:
        ici = list(ici_shape)
        ici = [1] * (len(axis_names) - len(ici)) + ici
        per_host = int(np.prod(ici))
        if n_proc % per_host:
            raise ValueError(f"ici_shape {tuple(ici)} does not tile "
                             f"{n_proc} processes")
        hosts = n_proc // per_host
        if hosts > 1 and int(np.prod(ici[:di])) > 1:
            raise ValueError(f"axes before the DCN axis {dcn_axis!r} tile "
                             f"a host: put {dcn_axis!r} first")
        ici[di] *= hosts
        shape = tuple(ici)
    return _mesh_of(shape, axis_names, device=device,
                    comm=ProcessGroupComm(device))


def _as_tensor(x, device) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device)


def global_from_local(local, mesh: Mesh, spec: Tuple = ("data",)):
    """The value whose block under ``spec`` this process holds (per-process
    data loading: no process holds the whole).  Under a process group, a
    :class:`~.mesh.LocalShard` of ``local`` on the mesh's device (checked
    against the spec's axes); with an empty spec, or on a thread mesh (one
    process holds every block), ``local`` itself."""
    t = _as_tensor(local, mesh.device)
    if isinstance(mesh.comm, ProcessGroupComm) and tuple(spec):
        for entry in spec:
            if entry is not None:
                mesh.axes(entry)
        return LocalShard(t)
    return t


def replicated(value, mesh: Mesh) -> torch.Tensor:
    """Identical host data on the mesh's device."""
    return _as_tensor(value, mesh.device)


def local_seed_shard(total: int, *, batch: Optional[int] = None
                     ) -> Tuple[int, int]:
    """This process's contiguous [lo, hi) share of a global seed range."""
    n, i = process_count(), process_index()
    per = -(-total // n)
    lo = min(i * per, total)
    return lo, min(lo + per, total)


def put_partitioned(tree, mesh: Mesh, spec: Tuple = ("data",)):
    """Move a host-replicated tree (every process holds the same copy) to
    the mesh's device, split by ``spec`` (:func:`~.mesh.local_block`;
    ``()`` replicated): on a thread mesh the whole tree (:func:`~.mesh.spmd`
    splits it, given ``Split(tree, spec)``), under a process group only
    this process's block of each array (0-d arrays whole), as a
    :class:`~.mesh.LocalShard`."""
    if isinstance(tree, LocalShard):
        return tree
    if not isinstance(mesh.comm, ProcessGroupComm) or not tuple(spec):
        return _tree_map(lambda x: x.to(mesh.device), tree)

    def local(x):
        if x.dim() == 0:
            return x.to(mesh.device)
        return local_block(x, mesh, tuple(spec)).to(mesh.device)

    return LocalShard(_tree_map(local, tree))



def placed(tree, mesh: Mesh, spec: Tuple = ("data",)) -> Split:
    """:func:`put_partitioned`'s result as an argument of
    :func:`~.mesh.spmd`, split by the same ``spec``."""
    return Split(put_partitioned(tree, mesh, spec), tuple(spec))
