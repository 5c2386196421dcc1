"""The weights the benchmark draws for the program's model.

The model is built by its kind's module (``benchmark/models/<kind>.py``)
through the program's own constructors; its parameters are then
overwritten from one draw on the device, so the benchmark, not the
program, makes the weights, and the reference is handed the same values.
Every leaf is U(-1/sqrt(fan_in), 1/sqrt(fan_in)), ``fan_in`` its linear's
input width, as ``torch.nn.Linear`` draws.
"""
from __future__ import annotations

from typing import Dict

import torch

# the weights' generator stream, apart from the graph's
WEIGHT_STREAM = 1 << 40


def _fan_in(name: str, p: torch.Tensor, params: Dict[str, torch.Tensor]
            ) -> int:
    if name.endswith(".bias"):
        return params[name[: -len("bias")] + "weight"].shape[-1]
    return p.shape[-1]


@torch.no_grad()
def draw_weights(model, seed: int, device) -> Dict[str, torch.Tensor]:
    """Overwrite ``model``'s parameters from one uniform draw on
    ``device`` under ``seed``; returns a float64 copy of them, keyed as
    ``named_parameters()``."""
    params = dict(model.named_parameters())
    total = sum(p.numel() for p in params.values())
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) + WEIGHT_STREAM)
    flat = torch.rand(total, generator=g, device=device) * 2 - 1
    at = 0
    for k, p in params.items():
        n = p.numel()
        bound = _fan_in(k, p, params) ** -0.5
        p.copy_((flat[at: at + n] * bound).reshape(p.shape))
        at += n
    return {k: p.detach().double().clone() for k, p in params.items()}
