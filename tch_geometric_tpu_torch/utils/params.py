"""Carry parameters from the JAX package's flax models into the port.

Takes the flax parameter tree as nested mappings of array-likes (numpy
arrays, or anything ``numpy.asarray`` accepts), so this module needs no
JAX import.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def sage_params_from_flax(flax_params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``GraphSAGE`` params -> ``GraphSAGE.state_dict()`` keys.

    Each flax ``Dense`` kernel ``(in, out)`` becomes a ``Linear.weight``
    ``(out, in)``; biases carry over as they are.  Accepts the tree with or
    without its top-level ``"params"`` entry."""
    p = flax_params.get("params", flax_params)
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"conv{i}" in p:
        conv = p[f"conv{i}"]
        for lin in ("lin_self", "lin_neigh"):
            dense = conv[lin]
            out[f"convs.{i}.{lin}.weight"] = torch.from_numpy(
                np.array(np.asarray(dense["kernel"]).T, dtype=np.float32))
            if "bias" in dense:
                out[f"convs.{i}.{lin}.bias"] = torch.from_numpy(
                    np.array(dense["bias"], dtype=np.float32))
        i += 1
    return out
