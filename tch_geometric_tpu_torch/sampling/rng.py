"""Counter-based RNG: a torch threefry2x32 bit-equal to ``jax.random``.

Counterpart of ``tch_geometric_tpu/sampling/rng.py``.  A key is a host-side
``(2,)`` int64 tensor holding the two uint32 words of a ``jax.random`` key
(``jax.random.key_data``).  Keys are derived on the host (a few scalar ops);
random bits are drawn on whatever device the caller names, so a key never
forces a device sync.

The construction follows jax 0.9.0 with ``jax_threefry_partitionable=True``:

* ``threefry2x32`` — 20 rounds in 5 groups of 4 with key injection
  (``jax/_src/prng.py::_threefry2x32_lowering``);
* ``split`` / ``fold_in`` / ``random_bits`` — the partitionable layouts: the
  counter of element ``i`` is the uint64 ``i`` split into (hi, lo) words,
  and 32-bit bits are ``out_hi ^ out_lo``;
* ``uniform`` / ``randint`` / ``gumbel`` — exactly as ``jax.random`` builds
  them from those bits (mantissa fill, two-draw range folding, -log(-log u)).

uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` masks: torch on the
CPU has no uint32 ``<<``.  Products of two 32-bit words are split into
16-bit halves so no intermediate leaves the int64 range.
"""
from __future__ import annotations

import threading
from typing import Sequence, Tuple, Union

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

DeviceLike = Union[str, torch.device, None]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 hash of the counter pairs ``(x0, x1)`` under key
    ``(k0, k1)``.  Keys are python ints or broadcastable int64 tensors;
    counters are int64 tensors of uint32 values."""
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


def _hash_counters(key: torch.Tensor, n: int, device: DeviceLike
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry over the partitionable counters ``0..n-1``."""
    k0, k1 = _words(key)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return threefry2x32(k0, k1, idx >> 32, idx & MASK32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(num, 2)`` keys."""
    b0, b1 = _hash_counters(key, num, "cpu")
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with ``data`` taken as uint32."""
    k0, k1 = _words(key)
    o0, o1 = threefry2x32(k0, k1, torch.tensor([0]),
                          torch.tensor([int(data) & MASK32]))
    return torch.cat([o0, o1])


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device: DeviceLike = "cuda") -> torch.Tensor:
    """32 random bits per element as int64 values in ``[0, 2**32)``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    b0, b1 = _hash_counters(key, n, device)
    return (b0 ^ b1).reshape(shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.uniform`` in float32."""
    bits = random_bits(key, shape, device)
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
            device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.randint`` for int32 ranges; returns int64 values.

    ``minval``/``maxval`` are ints or int tensors broadcastable to
    ``shape``.  Two 32-bit draws are folded into the span as jax does,
    including its uint32 wraparound of the ``2**32 % span`` multiplier.
    """
    k = split(key)
    higher = random_bits(k[0], shape, device)
    lower = random_bits(k[1], shape, device)
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
           device: DeviceLike = "cuda") -> torch.Tensor:
    """``jax.random.gumbel`` (low mode) in float32: -log(-log(u)),
    u ~ U[tiny, 1).  Equal to jax up to the last ulp of ``log``."""
    u = uniform(key, shape, _TINY32, 1.0, device)
    return -torch.log(-torch.log(u))


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
