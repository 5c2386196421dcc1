"""A frozen copy of the threefry draws that the dropout masks need.

The program keys dropout as flax does on ``jax.random`` with
``jax_threefry_partitionable=True``: threefry-2x32 (20 rounds, Salmon et
al., 2011), ``fold_in(key, d)`` the hash of the counter ``(0, d)``, 32
random bits of element ``i`` the two output words of counter ``(i >> 32,
i & 0xFFFFFFFF)`` xor-ed, a uniform float the bits' top 23 as a mantissa in
[1, 2) minus 1.  The n-th call of a dropout module named ``drop`` folds
in the first four bytes of ``sha1(b"drop" + n)``.  Written here from those
definitions; uint32 arithmetic runs in int64 under a mask.
"""
from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
DROPOUT_STREAM = 0x64726F70          # "drop", folded in before the masks


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def hash2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int) -> Tuple[int, int]:
    """``jax.random.key(seed)`` of a 32-bit seed."""
    return 0, int(seed) & MASK32


def fold_in(k: Tuple[int, int], data: int) -> Tuple[int, int]:
    o0, o1 = hash2x32(k[0], k[1], torch.tensor([0]),
                      torch.tensor([int(data) & MASK32]))
    return int(o0), int(o1)


def fold(k: Tuple[int, int], *coords: int) -> Tuple[int, int]:
    for c in coords:
        k = fold_in(k, c)
    return k


def uniform(k: Tuple[int, int], shape: Sequence[int], device
            ) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape``."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = hash2x32(k[0], k[1], idx >> 32, idx & MASK32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(
        tuple(shape))


def drop_tag(n: int) -> int:
    """The uint32 that flax folds in at the n-th call (1-based) of a
    module named ``drop``."""
    data = b"drop" + n.to_bytes((n.bit_length() + 7) // 8, "big")
    return int.from_bytes(hashlib.sha1(data).digest()[:4], "big")


def keep_mask(step_key: Tuple[int, int], layer: int, shape, rate: float,
              device) -> torch.Tensor:
    """The dropout keep mask of hidden layer ``layer`` (0-based) of a
    train step keyed ``step_key``."""
    dkey = fold_in(fold_in(step_key, DROPOUT_STREAM), drop_tag(layer + 1))
    return uniform(dkey, shape, device) < (1.0 - rate)
