"""Counter-based RNG: a torch threefry2x32 bit-equal to ``jax.random``.

Counterpart of ``tch_geometric_tpu/sampling/rng.py``.  A key is a host-side
``(2,)`` int64 tensor holding the two uint32 words of a ``jax.random`` key
(``jax.random.key_data``).  Keys are derived on the host (a few scalar ops);
random bits are drawn on whatever device the caller names, so a key never
forces a device sync.  ``split`` and ``fold_in`` run in a ``trace_span``
``rng_keys``, ``random_bits`` and ``random_bits_each`` in one ``rng_bits``.

The construction follows jax 0.9.0 with ``jax_threefry_partitionable=True``:

* ``threefry2x32`` — 20 rounds in 5 groups of 4 with key injection
  (``jax/_src/prng.py::_threefry2x32_lowering``);
* ``split`` / ``fold_in`` / ``random_bits`` — the partitionable layouts: the
  counter of element ``i`` is the uint64 ``i`` split into (hi, lo) words,
  and 32-bit bits are ``out_hi ^ out_lo``;
* ``uniform`` / ``randint`` / ``gumbel`` — exactly as ``jax.random`` builds
  them from those bits (mantissa fill, two-draw range folding, -log(-log u)).

Block draws: since element ``i``'s bits depend only on ``i``, a draw of
``shape`` with ``row0=r`` gives rows ``[r, r + shape[0])`` of the same
draw over more rows (the counters start at ``r * prod(shape[1:])``).  A
data-parallel rank draws its block of a batch so, and gets exactly the
whole-batch draw's rows, as a rank's shard of a ``jax.random`` draw under
``jax_threefry_partitionable=True`` is.

Where the hash runs.  Host keys (``split``, ``fold_in``) are hashed on
python ints, ~130 integer operations a key, and the result tensor is built
once.  Every draw on a CUDA tensor (the bits of ``random_bits`` and
``random_bits_each``, and the device-side keys of ``fold_in_many``,
``fold_in_each`` and ``split_each``) is one launch of the hand-written
kernel ``csrc/threefry.cu`` through :func:`threefry_cuda`, which counts
its launches in ``threefry_cuda.launches``; on a CPU tensor the same
function runs the plain torch :func:`threefry2x32`.  The three give the
same bits.

uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` masks: torch on the
CPU has no uint32 ``<<``.  Products of two 32-bit words are split into
16-bit halves so no intermediate leaves the int64 range.
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from ..ops import _build
from ..utils.metrics import trace_span

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

DeviceLike = Union[str, torch.device, None]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 hash of the counter pairs ``(x0, x1)`` under key
    ``(k0, k1)``: the plain version.  Keys and counters are python ints or
    broadcastable int64 tensors of uint32 values; on python ints it is the
    host keys' hash."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k = key.tolist()
    return int(k[0]), int(k[1])


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` with 32-bit seeds: words ``(0, seed)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def _draw_device(key: torch.Tensor, data: Optional[torch.Tensor],
                 device: DeviceLike, words: bool) -> torch.device:
    """A draw's device: ``data``'s, else a key table's, else ``device``."""
    if data is not None:
        dev = data.device
    elif key.dim() == 2:
        dev = key.device
    else:
        dev = torch.device(device)
    if key.shape[-1] != 2 or key.dim() > 2:
        raise ValueError(f"a key is (2,) and a key table (B, 2), got "
                         f"{tuple(key.shape)}")
    if key.dim() == 2 and key.device != dev:
        raise ValueError(f"keys are on {key.device}, data on {dev}")
    if data is not None and not words:
        raise ValueError("counters from data give keys: pass words=True")
    return dev


def threefry_plain(key: torch.Tensor, n: int, device: DeviceLike = None, *,
                   offset: int = 0, data: Optional[torch.Tensor] = None,
                   words: bool = False) -> torch.Tensor:
    """:func:`threefry_cuda`'s function as torch ops on any device: the
    plain version."""
    dev = _draw_device(key, data, device, words)
    table = key.dim() == 2
    rows = key.shape[0] if table else 1
    k0, k1 = (key[:, :1], key[:, 1:]) if table else _words(key)
    if data is None:
        c = torch.arange(offset, offset + n, dtype=torch.int64, device=dev)
    else:
        c = (data.long().reshape(rows, n) & MASK32) + offset
    o0, o1 = threefry2x32(k0, k1, c >> 32, c & MASK32)
    o0, o1 = torch.broadcast_tensors(o0, o1)
    if words:
        return torch.stack([o0, o1], dim=-1).reshape(rows * n, 2)
    return (o0 ^ o1).reshape(rows * n)


def threefry_cuda(key: torch.Tensor, n: int, device: DeviceLike = None, *,
                  offset: int = 0, data: Optional[torch.Tensor] = None,
                  words: bool = False) -> torch.Tensor:
    """Threefry over the counters of ``rows`` rows of ``n`` elements: the
    ``(rows * n,)`` bits ``out0 ^ out1`` as int64 values in ``[0, 2**32)``,
    or with ``words`` the ``(rows * n, 2)`` output words (keys).

    ``key`` is one host key ``(2,)`` (``rows`` = 1), or a ``(rows, 2)`` key
    table (row ``b`` under key ``b``).  Element ``i`` of a row hashes the
    partitionable counter ``offset + i``, or given ``data`` (``rows * n``
    ints; keys only, so ``words``) ``offset + (data[e] mod 2**32)``.  It runs on ``data``'s device,
    else the table's, else ``device``: on a CPU tensor the plain version
    (:func:`threefry_plain`), on a CUDA tensor one launch of the kernel
    (``csrc/threefry.cu``) or an error."""
    dev = _draw_device(key, data, device, words)
    table = key.dim() == 2
    rows = key.shape[0] if table else 1
    if data is not None and data.numel() != rows * n:
        raise ValueError(f"data has {data.numel()} elements, expected "
                         f"{rows} x {n}")
    if dev.type == "cpu":
        return threefry_plain(key, n, dev, offset=offset, data=data,
                              words=words)
    return _launch_threefry(key if table else None,
                            (0, 0) if table else _words(key), data, offset,
                            rows, n, words, dev)


def _launch_threefry(keys: Optional[torch.Tensor], k: Tuple[int, int],
                     data: Optional[torch.Tensor], offset: int, rows: int,
                     n: int, words: bool, dev: torch.device) -> torch.Tensor:
    """Launch ``tgt_threefry`` on the current stream of ``dev``."""
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA device, got {dev}")
    if not 0 <= offset < 2 ** 64:
        raise ValueError(f"counter offset {offset} outside uint64")
    out = torch.empty((rows * n, 2) if words else (rows * n,),
                      dtype=torch.int64, device=dev)
    if out.numel() == 0:
        return out
    if keys is not None:
        keys = keys.to(torch.int64).contiguous()
    if data is not None:
        data = data.to(torch.int64).contiguous()
    _build.launch("threefry", "tgt_threefry", dev,
                  None if keys is None else keys.data_ptr(), k[0], k[1],
                  None if data is None else data.data_ptr(), offset, rows, n,
                  int(words), out.data_ptr())
    threefry_cuda.launches += 1
    return out


threefry_cuda.launches = 0


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(num, 2)`` keys, hashed on python ints."""
    with trace_span("rng_keys"):
        k0, k1 = _words(key)
        return torch.tensor([threefry2x32(k0, k1, j >> 32, j & MASK32)
                             for j in range(num)],
                            dtype=torch.int64).reshape(num, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with ``data`` taken as uint32, hashed on
    python ints."""
    with trace_span("rng_keys"):
        k0, k1 = _words(key)
        return torch.tensor(threefry2x32(k0, k1, 0, int(data) & MASK32),
                            dtype=torch.int64)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device: DeviceLike = "cuda", row0: int = 0) -> torch.Tensor:
    """32 random bits per element as int64 values in ``[0, 2**32)``;
    ``row0`` the block's first row in a larger draw (module doc)."""
    shape = tuple(int(s) for s in shape)
    with trace_span("rng_bits"):
        return threefry_cuda(key, _numel(shape), device,
                             offset=int(row0) * _numel(shape[1:])
                             ).reshape(shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device: DeviceLike = "cuda",
            row0: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (``row0``: a block draw)."""
    return _uniform_from_bits(random_bits(key, shape, device, row0), minval,
                              maxval)


def _uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float
                       ) -> torch.Tensor:
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    # XLA contracts floats * span + lo into one fused multiply-add; the
    # float64 product of two float32 values is exact, so one rounding of the
    # float64 sum reproduces it
    span = (hi - lo).double()
    scaled = (floats.double() * span + lo.double()).float()
    return torch.maximum(lo, scaled)


def _mulmod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a * b) mod 2**32`` for uint32 values held in int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def randint(key: torch.Tensor, shape: Sequence[int], minval, maxval,
            device: DeviceLike = "cuda", row0: int = 0) -> torch.Tensor:
    """``jax.random.randint`` for int32 ranges; returns int64 values.

    ``minval``/``maxval`` are ints or int tensors broadcastable to
    ``shape``.  Two 32-bit draws are folded into the span as jax does,
    including its uint32 wraparound of the ``2**32 % span`` multiplier.
    ``row0``: a block draw (module doc).
    """
    k = split(key)
    return _randint_from_bits(random_bits(k[0], shape, device, row0),
                              random_bits(k[1], shape, device, row0), minval,
                              maxval)


def _randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, minval,
                       maxval) -> torch.Tensor:
    minval = torch.as_tensor(minval, dtype=torch.int64, device=higher.device)
    maxval = torch.as_tensor(maxval, dtype=torch.int64, device=higher.device)
    span = (maxval - minval) & MASK32
    span = torch.where(maxval <= minval, torch.ones_like(span), span)
    mult = torch.remainder(torch.full_like(span, 1 << 16), span)
    mult = torch.remainder(_mulmod32(mult, mult), span)
    off = _mulmod32(torch.remainder(higher, span), mult)
    off = (off + torch.remainder(lower, span)) & MASK32
    off = torch.remainder(off, span)
    return minval + off


_TINY32 = float(torch.finfo(torch.float32).tiny)


def gumbel(key: torch.Tensor, shape: Sequence[int],
           device: DeviceLike = "cuda", row0: int = 0) -> torch.Tensor:
    """``jax.random.gumbel`` (low mode) in float32: -log(-log(u)),
    u ~ U[tiny, 1).  Equal to jax up to the last ulp of ``log``.  ``row0``:
    a block draw (module doc)."""
    u = uniform(key, shape, _TINY32, 1.0, device, row0)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# One key per row: the draws of ``jax.vmap`` over a batch of keys
# ---------------------------------------------------------------------------
#
# A batch of keys is a ``(B, 2)`` int64 tensor on the device of the draws
# (one row per key, the two uint32 words), so a frontier of many keys never
# leaves the device.  Row ``b`` of each draw equals the single-key function
# under key ``b``.

def fold_in_many(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``vmap(lambda d: fold_in(key, d))(data)``: ``(B, 2)`` keys, ``data``
    taken as uint32, on ``data``'s device."""
    return threefry_cuda(key, data.numel(), data=data,
                         words=True).reshape(tuple(data.shape) + (2,))


def fold_in_each(keys: torch.Tensor, data) -> torch.Tensor:
    """``vmap(lambda k: fold_in(k, data))(keys)``; ``data`` an int, or a
    ``(B,)`` tensor for ``vmap(fold_in)(keys, data)``."""
    if isinstance(data, torch.Tensor):
        out = threefry_cuda(keys, 1, data=data, words=True)
    else:
        out = threefry_cuda(keys, 1, offset=int(data) & MASK32, words=True)
    return out.reshape(keys.shape[0], 2)


def random_bits_each(keys: torch.Tensor, shape: Sequence[int]
                     ) -> torch.Tensor:
    """``(B,) + shape`` bits, row ``b`` under key ``b``."""
    shape = tuple(int(s) for s in shape)
    with trace_span("rng_bits"):
        return threefry_cuda(keys, _numel(shape)).reshape(
            (keys.shape[0],) + shape)


def split_each(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``vmap(lambda k: split(k, num))(keys)``: ``(B, num, 2)``."""
    return threefry_cuda(keys, num, words=True).reshape(keys.shape[0], num,
                                                        2)


def uniform_each(keys: torch.Tensor, shape: Sequence[int],
                 minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``vmap(lambda k: uniform(k, shape, minval, maxval))(keys)``."""
    return _uniform_from_bits(random_bits_each(keys, shape), minval, maxval)


def gumbel_each(keys: torch.Tensor, shape: Sequence[int], *,
                rounded_log: bool = False) -> torch.Tensor:
    """``vmap(lambda k: gumbel(k, shape))(keys)``: -log(-log(u)), u ~
    U[tiny, 1) under each row's key.  ``rounded_log``: each ``log`` taken
    in float64 and rounded to float32, which gives the same bits on the
    CPU and the card (a float32 ``log`` may differ in its last bit between
    them)."""
    log = log_rounded if rounded_log else torch.log
    return -log(-log(uniform_each(keys, shape, _TINY32, 1.0)))


def log_rounded(x: torch.Tensor) -> torch.Tensor:
    """``log`` of float32 ``x`` in float64, rounded to float32: the same
    bits on every device."""
    return torch.log(x.double()).float()


def randint_each(keys: torch.Tensor, shape: Sequence[int], minval, maxval
                 ) -> torch.Tensor:
    """``vmap(lambda k, lo, hi: randint(k, shape, lo, hi))``: ``minval`` /
    ``maxval`` broadcast to ``(B,) + shape``."""
    k = split_each(keys)
    return _randint_from_bits(random_bits_each(k[:, 0], shape),
                              random_bits_each(k[:, 1], shape), minval,
                              maxval)


# ---------------------------------------------------------------------------
# Key discipline (sampling/rng.py of the JAX package)
# ---------------------------------------------------------------------------

_state = threading.local()


def seed(value: int = 0) -> torch.Tensor:
    """Set the thread's root key (convenience paths only; every entry
    point also takes an explicit ``key=``)."""
    _state.key = key(value)
    return _state.key


def next_key() -> torch.Tensor:
    """Split one key off the thread's root key."""
    if not hasattr(_state, "key"):
        seed(0)
    ks = split(_state.key)
    _state.key, out = ks[0], ks[1]
    return out


# Samplers fold small structural coordinates (hop index, batch offset) into
# their keys, so other random consumers sharing a base key fold this large
# tag first: dropout with fold(key, 1) would equal hop 1's sampling key.
DROPOUT_STREAM = 0x64726F70  # "drop"


def fold(key: torch.Tensor, *coords: int) -> torch.Tensor:
    """``fold(key, epoch, batch, hop)``: fold each coordinate in turn."""
    for c in coords:
        key = fold_in(key, c)
    return key
