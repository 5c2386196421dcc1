"""GraphSAGE with mean aggregation: the program's model (``models.GraphSAGE``)
paired with its plain reference (``benchmark/reference/sage.py``) and the
operations its tree forward and full-graph pass count.

A model module gives what the loops and readers ask of a model kind:
``build``, ``full_pass``, ``tree_reference``, ``full_reference``,
``tree_forward_flops`` and ``pass_flops``.  A configuration names it by
``model.kind``.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..reference import sage as reference
from ..reference.common import tree_layout

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the plain reference's seed logits of a padded tree
tree_reference = reference.tree_logits


def build(config: dict, device):
    """The program's model of ``config`` on ``device`` (weights not yet
    drawn)."""
    from tch_geometric_tpu_torch.models import GraphSAGE
    m, g = config["model"], config["graph"]
    return GraphSAGE(g["num_features"], m["hidden"], g["num_classes"],
                     m["num_layers"], dropout=m["dropout"],
                     generator=torch.Generator().manual_seed(0),
                     device=device)


def full_pass(model, x: torch.Tensor, blocked, config: dict
              ) -> torch.Tensor:
    """One full-graph pass by the program: ``blocked_forward`` on the
    blocked layout (kernel B1)."""
    return model.blocked_forward(
        x, blocked, compute_dtype=DTYPES[config["infer"]["agg_dtype"]])


def fp8_rows(h: torch.Tensor) -> torch.Tensor:
    """Rows rounded to float8 e4m3: the precision below bfloat16."""
    return h.to(torch.float8_e4m3fn).to(h.dtype)


def full_reference(params: Dict[str, torch.Tensor], gg, lower: bool
                   ) -> torch.Tensor:
    """Every node's logits by the plain reference in float64 over the
    generated COO; ``lower``: the rows the aggregation reads rounded to
    float8, the precision below the configuration's bfloat16 rows."""
    deg = torch.bincount(gg.dst, minlength=gg.num_nodes)
    return reference.full_logits(params, gg.x.double(), gg.src, gg.dst, deg,
                                 fp8_rows if lower else None)


def _dims(config: dict):
    m, g = config["model"], config["graph"]
    return ([g["num_features"]] + [m["hidden"]] * (m["num_layers"] - 1)
            + [g["num_classes"]])


def tree_forward_flops(config: dict) -> int:
    """Matrix-product operations of one forward over the padded tree the
    configuration fixes: layer ``j`` runs its two linears over the slots
    of depths ``0 .. hops - 1 - j``."""
    t = config["train"]
    dims = _dims(config)
    bases = tree_layout(t["batch_size"], t["fanouts"])
    hops = len(t["fanouts"])
    return sum(2 * 2 * bases[hops - j] * dims[j] * dims[j + 1]
               for j in range(config["model"]["num_layers"]))


def pass_flops(config: dict, num_nodes: int, num_edges: int) -> int:
    """Operations of one full-graph pass: two linears a layer over every
    node, one add an edge and feature for the mean."""
    dims = _dims(config)
    return sum(2 * 2 * num_nodes * dims[j] * dims[j + 1]
               + num_edges * dims[j]
               for j in range(config["model"]["num_layers"]))
