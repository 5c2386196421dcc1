"""Keyed dropout: flax ``nn.Dropout``'s masks on the port's threefry.

Keep where ``u < 1 - rate`` for ``u`` uniform in [0, 1), scale the kept
values by ``1 / (1 - rate)`` and zero the rest.  The key is flax's: every
model calls one ``nn.Dropout`` named ``drop`` once per hidden layer, and
flax keys the n-th call (1-based) of a module ``drop`` in one ``apply`` by
``fold_in(rngs["dropout"], sha1(b"drop" + n)[:4])``, the call count as
big-endian bytes and the digest's first four bytes a big-endian uint32
(``flax.core.scope._fold_in_static`` with the scope's per-name counter).
So layer ``i`` draws under ``fold_in(key, flax_drop_tag(i + 1))``, the
hash taken once per call count on the host.  The threefry is computed on
``h``'s device and gives the same bits on any device: one key gives one
mask on the CPU, on the card and in flax.

A data-parallel rank's tree (``NeighborSample.seed_block``) holds, in each
depth segment, one contiguous block of the whole batch's segment; ``rows``
names those blocks (:func:`tree_rows`) and the mask takes the whole
batch's mask rows there (``rng``'s block draws), so the ranks together
drop exactly what one device dropping over the whole batch drops.
"""
from __future__ import annotations

import functools
import hashlib
from typing import List, Optional, Sequence, Tuple

import torch

from ..sampling import rng
from ..sampling.neighbor import NeighborSample, _layer_layout
from ..utils.metrics import trace_span

Rows = Optional[Sequence[Tuple[int, int]]]


def tree_rows(sample: NeighborSample, depths: int) -> Rows:
    """The rows, in the whole batch's tree, of the tree's depth segments
    ``0..depths-1`` laid end to end: ``[(first row, count), ...]`` a
    segment; None for a whole batch's tree (its rows are its own)."""
    if sample.seed_block is None:
        return None
    first, total = sample.seed_block
    whole, _ = _layer_layout(total, sample.fanouts)
    out: List[Tuple[int, int]] = []
    per = 1
    for d in range(depths):
        n = sample.node_base[d + 1] - sample.node_base[d]
        out.append((whole[d] + first * per, n))
        if d < len(sample.fanouts):
            per *= sample.fanouts[d]
    return out


@functools.lru_cache(maxsize=None)
def flax_drop_tag(n: int) -> int:
    """The uint32 flax folds into the dropout key at the n-th call
    (1-based) of a module named ``drop``: the first four bytes, big-endian,
    of ``sha1(b"drop" + n.to_bytes(...))``."""
    data = b"drop" + n.to_bytes((n.bit_length() + 7) // 8, "big")
    return int.from_bytes(hashlib.sha1(data).digest()[:4], "big")


def keyed_dropout(h: torch.Tensor, key: Optional[torch.Tensor], rate: float,
                  layer: int, *, deterministic: bool = False,
                  rows: Rows = None) -> torch.Tensor:
    """Dropout of ``h`` at ``rate`` with flax's mask of hidden layer
    ``layer`` (the ``layer + 1``-th dropout call, module doc);
    the identity when ``deterministic`` or ``rate <= 0``.  Raises if dropout
    is on and ``key`` is None.  ``rows`` (:func:`tree_rows`): ``h``'s rows
    are those of a larger ``h``, whose mask rows they take.  The mask and
    its product run in a ``trace_span`` ``dropout``."""
    if deterministic or rate <= 0.0:
        return h
    if key is None:
        raise ValueError("dropout is on (deterministic=False): pass "
                         "dropout_key")
    if rate >= 1.0:
        return torch.zeros_like(h)
    keep = 1.0 - rate
    with trace_span("dropout"):
        lkey = rng.fold_in(key, flax_drop_tag(layer + 1))
        if rows is None:
            u = rng.uniform(lkey, h.shape, device=h.device)
        else:
            u = torch.cat([rng.uniform(lkey, (n,) + tuple(h.shape[1:]),
                                       device=h.device, row0=first)
                           for first, n in rows])
        return torch.where(u < keep, h / keep,
                           torch.zeros((), dtype=h.dtype, device=h.device))
