"""The mesh, its collectives and the SPMD runner.

Counterpart of ``tch_geometric_tpu/parallel/mesh.py`` and of the
``shard_map`` bodies the JAX package writes its distributed functions as.
The port keeps those per-rank bodies and runs them through one small
collective interface, :class:`Comm`:

* ``all_to_all(x)`` — ``x`` has leading dim P; block ``j`` goes to rank
  ``j`` and the result's block ``i`` came from rank ``i``
  (``lax.all_to_all(x, axis, 0, 0)``);
* ``all_reduce(x, op)`` — ``"sum"`` (``psum``) or ``"mean"`` (``pmean``:
  the sum, then divided by P);
* ``all_gather(x)`` — ``(P,) + x.shape``;
* ``ppermute(x, perm)`` — ``perm`` a list of ``(src, dst)``; a rank no
  pair sends to gets zeros;
* ``barrier()``, ``rank()``, ``size``.

Two backends:

* :class:`ProcessGroupComm` — ``torch.distributed``, one rank per process:
  NCCL when the mesh's device is CUDA, gloo on the CPU, never one for the
  other.  :mod:`.multihost` brings the group up.
* :class:`ThreadComm` — P ranks as threads of one process on one device,
  the counterpart of the JAX tests' virtual CPU mesh.  Collectives go
  through shared slots and a barrier whose every wait has a timeout,
  counted from the last rank's arrival at it (so it bounds one rank's
  work between two collectives, whatever P); the first exception in any
  rank aborts the barrier and
  :func:`spmd` re-raises it, so a failing rank fails its caller instead of
  hanging it.  One rank runs at a time: a rank holds a baton (a lock)
  from one collective to the next and hands it on while it waits, since P
  threads issuing small torch ops at once pass the GIL back and forth and
  run several times slower than the same ops in turn.  Every rank issues
  its kernels on the device's one current stream, so the host order the
  barrier imposes is the device order too, and each rank runs its
  backward passes on its own thread (no autograd device threads), so a
  collective inside a backward meets the other ranks' as in a forward.

Collectives by axis.  A mesh names its axes (row-major over the ranks).
A collective over an axis, or over a tuple of axes in mesh order (their
product, as ``psum(x, (a, b))`` and ``P((a, b))`` mean in JAX), spans the
ranks that share every other coordinate with the caller: its group.  The
tuple of all the axes is the whole mesh, the backend itself.  Any other
axis set's groups are

* under a process group, ``dist.new_group``s, one a group, which every
  process creates in the same order once, when the mesh is built
  (:func:`make_mesh`);
* on a thread mesh, a :class:`ThreadGroup` view: every rank of an SPMD
  body calls the same collectives in the same order, so each collective
  stays one rendezvous of the whole mesh in which each rank reads only its
  group's slots, under the same baton and the same barrier.

:func:`spmd` plays ``shard_map``: ``spmd(mesh, fn, *sharded, **replicated)``
gives each rank its block of every ``sharded`` argument (a tensor, or a
dataclass, tuple, list or dict of them) and every ``replicated`` keyword as
it is, runs ``fn`` on each rank and stacks the ranks' results, JAX's
``(P, ...)`` outputs.  A bare argument splits its leading dim over every
rank; :class:`Split` gives an argument a ``PartitionSpec``-like spec, e.g.
``Split(graph, ("chip",))`` (split over ``chip``, replicated over the
other axes) or ``Split(x, (("slice", "chip"),))``.  Under a process group
it runs ``fn`` on this process's block and returns ``(1, ...)``, as a
process's addressable shard is in JAX multihost.  Inside ``fn`` the module
functions :func:`axis_index`, :func:`all_to_all`, :func:`psum`,
:func:`pmean`, :func:`all_gather` and :func:`ppermute` reach the running
mesh's collectives by axis name, as ``jax.lax``'s do inside ``shard_map``.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import (Any, Callable, Dict, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

DEFAULT_TIMEOUT_S = 300.0

Axes = Union[str, Tuple[str, ...]]


# ---------------------------------------------------------------------------
# Communicators
# ---------------------------------------------------------------------------

class Comm:
    """The collective interface a per-rank body calls (see module doc)."""

    size: int

    def rank(self) -> int:
        raise NotImplementedError

    def update_replica(self, fn: Callable[[], None]) -> None:
        """Run ``fn``, an in-place update of this rank's parameter replica,
        once per replica: in every process of a process group, in one
        thread of a :class:`ThreadComm` (its ranks share one replica) while
        the others wait."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        raise NotImplementedError

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError


def _check_op(op: str) -> None:
    if op not in ("sum", "mean"):
        raise ValueError(f"all_reduce op {op!r}: 'sum' or 'mean'")


def _mean(total: torch.Tensor, n: int) -> torch.Tensor:
    return total / n if total.is_floating_point() else total // n


def _slot_all_to_all(vals: list, me: int) -> torch.Tensor:
    return torch.stack([v[me] for v in vals])


def _slot_reduce(vals: list, op: str) -> torch.Tensor:
    _check_op(op)
    total = vals[0].clone()
    for v in vals[1:]:
        total = total + v
    return _mean(total, len(vals)) if op == "mean" else total


def _slot_permute(vals: list, me: int, perm, like: torch.Tensor
                  ) -> torch.Tensor:
    src = [s for s, d in perm if d == me]
    return vals[src[0]].clone() if src else torch.zeros_like(like)


class _Barrier:
    """A ``threading.Barrier`` whose waits time out ``timeout_s`` after the
    last arrival of any rank rather than after their own: under the baton
    the ranks work in turn, so a rank's wait spans the others' segments,
    and only a stretch with no arrival at all is a hang.  A timeout or
    :meth:`abort` breaks it for every rank (``BrokenBarrierError``)."""

    def __init__(self, parties: int, timeout_s: float):
        self.parties = parties
        self.timeout_s = timeout_s
        self._cond = threading.Condition()
        self._count = 0
        self._generation = 0
        self._broken = False
        self._last_arrival = time.monotonic()

    def wait(self) -> None:
        with self._cond:
            if self._broken:
                raise threading.BrokenBarrierError
            gen = self._generation
            self._count += 1
            self._last_arrival = time.monotonic()
            if self._count == self.parties:
                self._count = 0
                self._generation += 1
                self._cond.notify_all()
                return
            while gen == self._generation and not self._broken:
                left = self._last_arrival + self.timeout_s - time.monotonic()
                if left <= 0:
                    self._broken = True
                    self._cond.notify_all()
                    break
                self._cond.wait(left)
            if gen == self._generation:
                raise threading.BrokenBarrierError

    def abort(self) -> None:
        with self._cond:
            self._broken = True
            self._cond.notify_all()


class ThreadComm(Comm):
    """P ranks as threads of this process (see module doc).

    ``timeout_s`` bounds every barrier wait from the last arrival of any
    rank at it: one rank's work between two collectives, whatever P.  A
    wait that times out breaks the barrier for every rank."""

    def __init__(self, size: int, *, timeout_s: float = DEFAULT_TIMEOUT_S):
        if size < 1:
            raise ValueError(f"ThreadComm of {size} ranks")
        self.size = int(size)
        self.timeout_s = float(timeout_s)
        self._local = threading.local()
        self._slots = [None] * self.size
        self._barrier = _Barrier(self.size, self.timeout_s)
        self._baton = threading.Lock()

    def rank(self) -> int:
        return getattr(self._local, "rank", 0)

    def update_replica(self, fn):
        if self.rank() == 0:
            fn()
        self._wait()

    def _wait(self) -> None:
        if self.size > 1:
            # hand the baton on while waiting: one rank runs at a time
            self._baton.release()
            try:
                self._barrier.wait()
            finally:
                self._baton.acquire()

    def _exchange(self, value, rank: Optional[int] = None) -> list:
        """Every rank's ``value``, in rank order."""
        self._slots[self.rank() if rank is None else rank] = value
        self._wait()
        vals = list(self._slots)
        self._wait()            # no rank refills a slot before all read
        return vals

    def all_to_all(self, x):
        return _slot_all_to_all(self._exchange(x), self.rank())

    def all_reduce(self, x, op="sum"):
        return _slot_reduce(self._exchange(x), op)

    def all_gather(self, x):
        return torch.stack(self._exchange(x))

    def ppermute(self, x, perm):
        return _slot_permute(self._exchange(x), self.rank(), perm, x)

    def barrier(self):
        self._wait()

    def run(self, fn: Callable[[int], Any]) -> list:
        """``[fn(0), ..., fn(P-1)]``, rank ``r`` on a thread of its own
        (inline at P = 1), one at a time between collectives.  The first
        exception of any rank aborts the barrier, and is re-raised here once
        every rank has stopped."""
        if self.size == 1:
            self._local.rank = 0
            return [fn(0)]
        self._barrier = _Barrier(self.size, self.timeout_s)
        self._baton = threading.Lock()
        self._slots = [None] * self.size
        results = [None] * self.size
        errors = [None] * self.size
        grad = torch.is_grad_enabled()
        cuda_dev = (torch.cuda.current_device()
                    if torch.cuda.is_available() else None)

        def worker(r):
            self._local.rank = r
            self._baton.acquire()
            try:
                if cuda_dev is not None:
                    torch.cuda.set_device(cuda_dev)
                # backward on this thread: a collective in a backward pass
                # must run on its rank's thread, not a shared device thread
                with torch.set_grad_enabled(grad), \
                        torch.autograd.set_multithreading_enabled(False):
                    results[r] = fn(r)
            except BaseException as e:   # noqa: BLE001  (re-raised below)
                errors[r] = e
                self._barrier.abort()
            finally:
                self._baton.release()

        threads = [threading.Thread(target=worker, args=(r,), daemon=True,
                                    name=f"spmd-rank-{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            # each rank's waits are bounded; a rank that computes without
            # reaching a collective is not, and is waited for
            t.join()
        raised = [e for e in errors if e is not None]
        if raised:
            real = [e for e in raised
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or raised)[0]
        return results


class ThreadGroup(Comm):
    """The ranks ``ranks`` (in group order) of a :class:`ThreadComm`, as
    the communicator of rank ``me``'s group along some axes.  Each
    collective is a rendezvous of the whole mesh (every rank of the body
    calls it) in which ``me`` reads its group's slots; the replica stays
    the mesh's one."""

    def __init__(self, comm: ThreadComm, ranks: Sequence[int], me: int):
        self.comm = comm
        self.ranks = tuple(int(r) for r in ranks)
        self.me = int(me)
        self.size = len(self.ranks)

    def rank(self) -> int:
        return self.ranks.index(self.me)

    def update_replica(self, fn):
        self.comm.update_replica(fn)

    def _vals(self, x) -> list:
        vals = self.comm._exchange(x, self.me)
        return [vals[r] for r in self.ranks]

    def all_to_all(self, x):
        return _slot_all_to_all(self._vals(x), self.rank())

    def all_reduce(self, x, op="sum"):
        return _slot_reduce(self._vals(x), op)

    def all_gather(self, x):
        return torch.stack(self._vals(x))

    def ppermute(self, x, perm):
        return _slot_permute(self._vals(x), self.rank(), perm, x)

    def barrier(self):
        self.comm.barrier()


class ProcessGroupComm(Comm):
    """One rank per process over a ``torch.distributed`` group: NCCL for a
    CUDA mesh, gloo for a CPU one (the group's backend must be that one).
    ``group`` None is the world; a sub-group names its global ``ranks`` in
    group order."""

    def __init__(self, device, group=None,
                 ranks: Optional[Sequence[int]] = None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "parallel.multihost.initialize first")
        self.device = torch.device(device)
        self.group = group
        backend = str(dist.get_backend(group)).lower()
        want = "nccl" if self.device.type == "cuda" else "gloo"
        if backend != want:
            raise RuntimeError(f"a {self.device.type} mesh needs a {want} "
                               f"process group, not {backend}")
        self.size = dist.get_world_size(group)
        self._rank = dist.get_rank(group)
        self._peers = None if ranks is None else [int(r) for r in ranks]

    def rank(self) -> int:
        return self._rank

    def update_replica(self, fn):
        fn()

    def all_to_all(self, x):
        import torch.distributed as dist
        src = x.contiguous()
        wire = src.view(torch.uint8) if src.dtype == torch.bool else src
        out = torch.empty_like(wire)
        dist.all_to_all_single(out, wire, group=self.group)
        return out.view(torch.bool) if src.dtype == torch.bool else out

    def all_reduce(self, x, op="sum"):
        import torch.distributed as dist
        _check_op(op)
        total = x.clone().contiguous()
        dist.all_reduce(total, group=self.group)
        return _mean(total, self.size) if op == "mean" else total

    def all_gather(self, x):
        import torch.distributed as dist
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.stack(parts)

    def ppermute(self, x, perm):
        import torch.distributed as dist
        me = self._rank
        out = torch.zeros_like(x)
        ops = []
        src = x.contiguous()
        for s, d in perm:
            if s == me and d == me:
                out.copy_(src)
            elif s == me:
                ops.append(dist.P2POp(dist.isend, src, self._global(d),
                                      self.group))
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, self._global(s),
                                      self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def _global(self, r: int) -> int:
        """The global rank of group rank ``r`` (P2P peers are global)."""
        return r if self._peers is None else self._peers[r]

    def barrier(self):
        self.all_reduce(torch.ones((1,), device=self.device))


# ---------------------------------------------------------------------------
# The mesh and its placements
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """Named axes over the ranks of ``comm`` on ``device``; ``shape`` maps
    each axis name to its size (row-major over the ranks).  ``groups``:
    under a process group, this process's communicator for each axis set
    other than the whole mesh (:func:`make_mesh` creates them)."""

    comm: Comm
    device: torch.device
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    groups: Dict[Tuple[str, ...], Comm] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return self.comm.size

    def axes(self, axis: Axes) -> Tuple[str, ...]:
        """``axis`` as a tuple of the mesh's axis names, in mesh order."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"no axis {a!r} in the mesh's "
                                 f"{self.axis_names}")
        if list(axes) != sorted(axes, key=self.axis_names.index) or \
                len(set(axes)) != len(axes):
            raise ValueError(f"axes {axes} must be distinct and in the "
                             f"mesh's order {self.axis_names}")
        return axes

    def axis_size(self, axis: Axes) -> int:
        """The size of ``axis``: the product of the named axes' sizes."""
        n = 1
        for a in self.axes(axis):
            n *= self.shape[a]
        return n

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """This rank's index along each axis."""
        r = self.comm.rank() if rank is None else rank
        out = {}
        for name in reversed(self.axis_names):
            out[name] = r % self.shape[name]
            r //= self.shape[name]
        return {n: out[n] for n in self.axis_names}

    def axis_index(self, axis: Axes, rank: Optional[int] = None) -> int:
        """The rank's index along ``axis`` (row-major over a tuple)."""
        c = self.coords(rank)
        i = 0
        for a in self.axes(axis):
            i = i * self.shape[a] + c[a]
        return i

    def group_ranks(self, axis: Axes, rank: Optional[int] = None
                    ) -> Tuple[int, ...]:
        """The ranks of ``rank``'s group along ``axis`` (those sharing its
        other coordinates), in ``axis_index`` order, which is rank order."""
        axes = self.axes(axis)
        c = self.coords(rank)
        out = []
        for idx in itertools.product(*(range(self.shape[a]) for a in axes)):
            c.update(zip(axes, idx))
            r = 0
            for n in self.axis_names:
                r = r * self.shape[n] + c[n]
            out.append(r)
        return tuple(out)

    def axis_comm(self, axis: Axes) -> Comm:
        """The communicator of this rank's group along ``axis``: the
        backend itself for the whole mesh's axes (and, on a thread mesh,
        for any group of every rank)."""
        axes = self.axes(axis)
        if set(axes) == set(self.axis_names):
            return self.comm
        if isinstance(self.comm, ThreadComm):
            if self.axis_size(axes) == self.size:
                return self.comm
            me = self.comm.rank()
            return ThreadGroup(self.comm, self.group_ranks(axes, me), me)
        return self.groups[axes]


def _axis_sets(names: Tuple[str, ...]):
    """Every axis set but the whole mesh's, in one fixed order."""
    for k in range(1, len(names)):
        yield from itertools.combinations(names, k)


def _process_groups(mesh: Mesh) -> None:
    """One ``dist.new_group`` per group of every axis set but the whole
    mesh's, created by every process in the same order; keeps this
    process's."""
    import torch.distributed as dist
    me = mesh.comm.rank()
    for axes in _axis_sets(mesh.axis_names):
        seen = []
        for r in range(mesh.size):
            ranks = mesh.group_ranks(axes, r)
            if ranks in seen:
                continue
            seen.append(ranks)
            pg = dist.new_group(list(ranks))
            if me in ranks:
                mesh.groups[axes] = ProcessGroupComm(mesh.device, pg, ranks)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              names: Tuple[str, ...] = ("data", "model"), *,
              device="cuda", comm: Optional[Comm] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A mesh, by default ``('data', 'model')``.  ``comm`` None: the
    process group when ``torch.distributed`` is initialized (P = its world
    size), else a :class:`ThreadComm` of ``prod(shape)`` ranks (1 when
    ``shape`` is None).  ``shape`` None: all ranks on the first axis.  Over
    a process group, every process must build the same meshes in the same
    order (each creates its sub-axis groups)."""
    device = torch.device(device)
    if comm is None:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            comm = ProcessGroupComm(device)
        else:
            n = 1
            for s in shape or (1,):
                n *= int(s)
            comm = ThreadComm(n, timeout_s=timeout_s)
    names = tuple(names)
    if shape is None:
        shape = (comm.size,) + (1,) * (len(names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) < len(names):
        shape = (1,) * (len(names) - len(shape)) + shape
    n = 1
    for s in shape:
        n *= s
    if n != comm.size or len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} over axes {names} does not "
                         f"hold the {comm.size} ranks of {comm}")
    mesh = Mesh(comm, device, names, dict(zip(names, shape)))
    if isinstance(comm, ProcessGroupComm):
        _process_groups(mesh)
    return mesh


Spec = Tuple[Optional[Axes], ...]


def local_block(x: torch.Tensor, mesh: Mesh, spec: Spec,
                rank: Optional[int] = None) -> torch.Tensor:
    """The block of ``x`` that ``rank`` (this rank) holds under ``spec``:
    per dimension None (whole), an axis name or a tuple of names (split
    over their product, row-major)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n = mesh.axis_size(entry)
        if x.dim() <= dim or x.shape[dim] % n:
            raise ValueError(f"an argument of shape {tuple(x.shape)} does "
                             f"not split into {n} blocks on dim {dim}")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(entry, rank) * step, step)
    return x


class Placement(NamedTuple):
    """Where a value lives on a mesh: ``spec`` names, per dimension, the
    axis (or tuple of axes) it is split over (None: whole),
    ``PartitionSpec``'s meaning; ``()`` is replicated."""
    mesh: Mesh
    spec: Spec

    def local(self, x: torch.Tensor, rank: Optional[int] = None
              ) -> torch.Tensor:
        """The block of ``x`` that ``rank`` (this rank) holds."""
        return local_block(x, self.mesh, self.spec, rank)


def data_sharding(mesh: Mesh) -> Placement:
    return Placement(mesh, ("data",))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def param_sharding_rule(path, value, mesh: Mesh) -> Placement:
    """Tensor-parallel rule: a 2-d kernel splits its output (last) dim over
    ``model`` when it divides; biases and 1-d parameters replicate.  A
    torch ``nn.Linear`` weight is ``(out, in)``: pass ``weight.T`` views,
    or read the rule's spec as naming the output dimension."""
    if getattr(value, "ndim", 0) == 2 and \
            value.shape[-1] % mesh.shape["model"] == 0:
        return Placement(mesh, (None, "model"))
    return Placement(mesh, ())


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                 rank: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """This rank's slice of every parameter under the tensor-parallel rule
    (views; the 2-d kernels' last dim over ``model``)."""
    return {k: param_sharding_rule(k, v, mesh).local(v, rank)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# The SPMD runner and the collectives by axis name
# ---------------------------------------------------------------------------

class LocalShard:
    """A value that already is this process's block (what
    :func:`.multihost.put_partitioned` returns under a process group):
    :func:`spmd` passes it to ``fn`` as it is."""

    def __init__(self, value):
        self.value = value


_CTX = threading.local()


def _tree_map(fn, tree):
    """``fn`` of every tensor leaf (numpy arrays taken as tensors)."""
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.ascontiguousarray(tree))
    if torch.is_tensor(tree):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _tree_stack(trees: list):
    """Stack the ranks' results leaf by leaf; non-tensor leaves are rank
    0's."""
    first = trees[0]
    if torch.is_tensor(first):
        return torch.stack(trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: _tree_stack([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_stack(list(v)) for v in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_stack(list(v)) for v in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return first


class Split(NamedTuple):
    """An argument of :func:`spmd` split by ``spec`` (see
    :func:`local_block`) and replicated over the axes ``spec`` leaves out;
    ``value`` may be a :class:`LocalShard` (this process's block)."""
    value: Any
    spec: Spec


def spmd(mesh: Mesh, fn: Callable, *sharded, **replicated_kw):
    """Run ``fn(*blocks, **replicated_kw)`` on every rank of ``mesh`` and
    stack the results (see module doc)."""
    comm = mesh.comm
    every = (mesh.axis_names,)

    def on_rank(r):
        def take(arg):
            spec = every
            if isinstance(arg, Split):
                arg, spec = arg.value, tuple(arg.spec)
            if isinstance(arg, LocalShard):
                if isinstance(comm, ThreadComm):
                    raise ValueError("a LocalShard is one process's block; "
                                     "a thread mesh takes the whole value")
                return arg.value
            return _tree_map(lambda x: local_block(x, mesh, spec, r), arg)

        blocks = [take(a) for a in sharded]
        prev = getattr(_CTX, "mesh", None)
        _CTX.mesh = mesh
        try:
            return fn(*blocks, **replicated_kw)
        finally:
            _CTX.mesh = prev

    if isinstance(comm, ThreadComm):
        return _tree_stack(comm.run(on_rank))
    return _tree_stack([on_rank(comm.rank())])


def along(mesh: Mesh, axis: Axes, stacked):
    """Of a stacked :func:`spmd` result, the ranks' results along ``axis``
    (the group of rank 0), JAX's ``out_specs=P(axis)`` of values that are
    replicated over the other axes; under a process group the process's
    own ``(1, ...)`` as it is."""
    if not isinstance(mesh.comm, ThreadComm):
        return stacked
    idx = torch.tensor(mesh.group_ranks(axis, 0))
    return _tree_map(lambda x: x[idx.to(x.device)], stacked)


def current_mesh() -> Mesh:
    mesh = getattr(_CTX, "mesh", None)
    if mesh is None:
        raise RuntimeError("no mesh is running: call this inside spmd")
    return mesh


def axis_comm(axis: Axes) -> Comm:
    """The running mesh's communicator for a collective over ``axis``."""
    return current_mesh().axis_comm(axis)


def axis_index(axis: Axes) -> int:
    """``lax.axis_index``: this rank's index along ``axis``."""
    return current_mesh().axis_index(axis)


def all_to_all(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """``lax.all_to_all(x, axis, 0, 0)``."""
    return axis_comm(axis).all_to_all(x)


def psum(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    return axis_comm(axis).all_reduce(x, "sum")


def pmean(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    return axis_comm(axis).all_reduce(x, "mean")


class _PSum(torch.autograd.Function):
    """``psum`` over the group of ``comm``; backward the ``psum`` of the
    cotangent, so the ranks' gradients summed are the gradient of their
    losses' sum.  ``comm`` is the group's communicator, taken when the
    forward runs; the backward runs on the rank's own thread."""

    @staticmethod
    def forward(ctx, x, comm: Comm):
        ctx.comm = comm
        return comm.all_reduce(x.contiguous(), "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous(), "sum"), None


def psum_grad(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    """:func:`psum` that takes part in autograd (see :class:`_PSum`)."""
    return _PSum.apply(x, axis_comm(axis))


def any_rank(count: torch.Tensor) -> bool:
    """Whether ``count`` summed over every rank of the running mesh is
    positive (one host read).  Control flow that depends on data around
    collectives asks the whole mesh, not its own axis' group: on a thread
    mesh each collective is one rendezvous of all the ranks, so every rank
    must take the same branch."""
    mesh = current_mesh()
    return int(psum(count.to(mesh.device), mesh.axis_names)) > 0


def all_gather(x: torch.Tensor, axis: Axes) -> torch.Tensor:
    return axis_comm(axis).all_gather(x)


def ppermute(x: torch.Tensor, axis: Axes,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    return axis_comm(axis).ppermute(x, perm)
