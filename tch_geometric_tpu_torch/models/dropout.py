"""Keyed dropout: flax ``nn.Dropout`` semantics on the port's threefry.

Keep where ``u < 1 - rate`` for ``u`` uniform in [0, 1), scale the kept
values by ``1 / (1 - rate)`` and zero the rest.  ``u`` comes from
``rng.uniform(rng.fold(key, layer), h.shape)``: the threefry is computed on
``h``'s device and gives the same bits on any device, so one key gives one
mask on the CPU and on the card.  The bits are not flax's (flax folds the
module path into its dropout key), only the law is.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..sampling import rng


def keyed_dropout(h: torch.Tensor, key: Optional[torch.Tensor], rate: float,
                  layer: int, *, deterministic: bool = False
                  ) -> torch.Tensor:
    """Dropout of ``h`` at ``rate`` with the mask of ``fold(key, layer)``;
    the identity when ``deterministic`` or ``rate <= 0``.  Raises if dropout
    is on and ``key`` is None."""
    if deterministic or rate <= 0.0:
        return h
    if key is None:
        raise ValueError("dropout is on (deterministic=False): pass "
                         "dropout_key")
    if rate >= 1.0:
        return torch.zeros_like(h)
    keep = 1.0 - rate
    u = rng.uniform(rng.fold(key, layer), h.shape, device=h.device)
    return torch.where(u < keep, h / keep,
                       torch.zeros((), dtype=h.dtype, device=h.device))
