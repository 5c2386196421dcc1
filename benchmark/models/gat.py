"""GAT as PyG's ``examples/ogbn_products_gat.py`` builds it: the program's
model (``models.GAT`` with skip linears, bias, self loops and a last layer of
averaged heads) paired with its plain reference
(``benchmark/reference/gat.py``) and the operations its full-graph pass
counts.

The kind serves the inference loop: ``build``, ``full_pass``,
``full_reference`` and ``pass_flops`` (no training cell takes it yet, so it
has no tree reference).  A configuration names it by ``model.kind``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..reference import gat as reference
from .sage import DTYPES, fp8_rows


# The keys of ``model`` that ``GAT(..., pyg=True)`` fixes, at the values it
# builds: the last layer's heads as many as the others' and averaged, bias,
# self loops, skips, ELU, attention dropout 0 and LeakyReLU's slope 0.2
# (``GATConv``'s).  ``build`` reads the others: hidden, heads, num_layers,
# dropout.
PYG_FIXED = {"last_concat": False, "skip": True, "bias": True,
             "self_loops": True, "activation": "elu",
             "attention_dropout": 0.0, "negative_slope": 0.2}
READ = ("kind", "hidden", "heads", "num_layers", "dropout")


def build(config: dict, device):
    """The program's model of ``config`` on ``device`` (weights not yet
    drawn).  Raises ``ValueError`` on a model key that the program's GAT
    does not build as stated, or does not know."""
    from tch_geometric_tpu_torch.models import GAT
    m, g = config["model"], config["graph"]
    fixed = dict(PYG_FIXED, last_heads=m["heads"])
    unknown = sorted(set(m) - set(fixed) - set(READ))
    wrong = {k: m[k] for k in fixed if m.get(k) != fixed[k]}
    if unknown or wrong:
        raise ValueError(f"the program's GAT builds PyG's model, "
                         f"{fixed}: model keys {wrong or ''} "
                         f"{unknown or ''} are not what it builds")
    return GAT(g["num_features"], m["hidden"] * m["heads"],
               g["num_classes"], m["num_layers"], heads=m["heads"],
               dropout=m["dropout"], pyg=True,
               generator=torch.Generator().manual_seed(0), device=device)


def full_pass(model, x: torch.Tensor, blocked, config: dict
              ) -> torch.Tensor:
    """One full-graph pass by the program: ``GAT.blocked_forward`` on the
    blocked layout (kernel B3 with self loops, once a layer)."""
    return model.blocked_forward(
        x, blocked, compute_dtype=DTYPES[config["infer"]["agg_dtype"]])


def full_reference(params: Dict[str, torch.Tensor], gg, lower: bool
                   ) -> torch.Tensor:
    """Every node's logits by the plain reference in float64 over the
    generated COO; ``lower``: the rows the attention reads rounded to
    float8, the precision below the configuration's bfloat16 rows."""
    heads = params["convs.0.a_src"].shape[0]
    return reference.full_logits(params, gg.x.double(), gg.src, gg.dst,
                                 heads, fp8_rows if lower else None)


def layer_shapes(config: dict) -> List[Tuple[int, int, int, int]]:
    """``(in width, heads, head width, out width)`` of each layer."""
    m, g = config["model"], config["graph"]
    H, L = m["heads"], m["num_layers"]
    shapes, fin = [], g["num_features"]
    for i in range(L):
        last = i == L - 1
        d = g["num_classes"] if last else m["hidden"]
        fout = d if last and not m["last_concat"] else H * d
        shapes.append((fin, H, d, fout))
        fin = fout
    return shapes


def attention_ops(num_nodes: int, num_edges: int, heads: int, d: int
                  ) -> int:
    """Operations of one layer's attention: per edge and self loop and head
    the logit (add, leaky_relu), its exp against the max, the sum, the
    division, the max (6) and a multiply-add per column."""
    return (num_edges + num_nodes) * heads * (2 * d + 6)


def pass_flops(config: dict, num_nodes: int, num_edges: int) -> int:
    """Operations of one full-graph pass: per layer the projection and the
    skip linear over every node, the two logit tables, and the
    attention."""
    total = 0
    for fin, H, d, fout in layer_shapes(config):
        total += (2 * num_nodes * fin * H * d + 2 * num_nodes * fin * fout
                  + 2 * 2 * num_nodes * H * d
                  + attention_ops(num_nodes, num_edges, H, d))
    return total
