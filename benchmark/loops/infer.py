"""Full-graph inference: a closed loop of passes over every node.

Set-up builds the program's blocked layout of the CSC
(``ops.build_blocked``) and the model, and warms every shape up with
whole passes.  A pass is the model kind's ``full_pass`` without
gradients (SAGE: ``GraphSAGE.blocked_forward``, kernel B1).  The window
runs passes one after another and keeps the last pass's logits, which the
reference checks once the window has closed.

A traffic mix names this loop by ``"loop": "infer"``; its parameters
are ``warmup_passes`` and ``trace_units`` (the passes of the traced
segment).
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from ..core import spec, weights

# no span of the program's own: the per-layer readers add theirs
SPANS = ()


class Loop:
    unit = "passes"
    spans = SPANS
    controls = ("lower",)

    def __init__(self, cell, gg, graph, seed: int, device):
        self.cell, self.gg, self.graph = cell, gg, graph
        self.seed, self.device = int(seed), torch.device(device)
        self.cfg = cell.config
        self.infer = self.cfg["infer"]
        self.kind = spec.component("models", self.cfg["model"]["kind"])
        self.build_s: Dict[str, float] = {}
        self._ref = None

    def setup(self) -> None:
        from tch_geometric_tpu_torch.ops import build_blocked
        self.model = self.kind.build(self.cfg, self.device)
        self.params0 = weights.draw_weights(self.model, self.seed,
                                            self.device)
        t0 = time.perf_counter()
        self.blocked = build_blocked(
            self.graph.indptr.cpu().numpy(), self.graph.indices.cpu().numpy(),
            rows_per_block=int(self.infer["rows_per_block"]),
            device=self.device)
        self._sync()
        self.build_s["blocked"] = time.perf_counter() - t0
        for _ in range(int(self.cell.traffic["warmup_passes"])):
            self.out = self._pass()
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    @torch.no_grad()
    def _pass(self) -> torch.Tensor:
        return self.kind.full_pass(self.model, self.gg.x, self.blocked,
                                   self.cfg)

    def window(self, seconds: float):
        t0 = time.perf_counter()
        n = 0
        while True:
            self.out = self._pass()
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        return n, time.perf_counter() - t0

    def work(self, units: int) -> float:
        return units * self.gg.num_nodes

    def traced(self, units: int) -> None:
        for _ in range(units):
            self.out = self._pass()

    def release(self) -> None:
        """Free the program's state; keep the last pass's logits."""
        del self.model, self.blocked, self.graph

    @torch.no_grad()
    def check(self, control: str = "") -> Dict[str, float]:
        """The numbers compared, on every node's logits: ``logit_rms_gap``
        (RMS of the gap over the reference's RMS) and ``logit_max_gap``
        (largest gap over the reference's RMS).  ``control``: in the
        program's place the reference in the precision below the
        configuration's, as the model kind's ``full_reference`` gives
        it)."""
        if self._ref is None:
            self._ref = self.kind.full_reference(self.params0, self.gg, False)
        ref = self._ref
        out = (self.kind.full_reference(self.params0, self.gg, True)
               if control == "lower" else self.out).double()
        if out.shape != ref.shape:
            return dict(logit_rms_gap=float("inf"),
                        logit_max_gap=float("inf"))
        rms = float(ref.pow(2).mean().sqrt())
        gap = (out - ref).abs_()
        bad = ~torch.isfinite(gap)
        if bool(bad.any()):
            return dict(logit_rms_gap=float("inf"),
                        logit_max_gap=float("inf"))
        return dict(logit_rms_gap=float(gap.pow(2).mean().sqrt()) / rms,
                    logit_max_gap=float(gap.max()) / rms)
