"""Sampled training: a closed loop of the program's train step.

Set-up builds one trainer (``make_gnn_trainer``) with its model and Adam
state, and drives it through its first ``check_steps`` steps by the same
call and feed as the window: shuffled batches of the training split from
the program's ``SeedLoader``.  Those steps' losses, the Adam state after
the first and the parameters after the last are kept, with the tree each
step drew (``sample_and_gather`` under the step's key), for the reference
to follow once the window has closed.  The window then runs the same
trainer on, one step after another, with no read-back, and ends in a
synchronise.

A traffic mix names this loop by ``"loop": "train"``; its parameters
are ``check_steps`` (the steps the reference follows) and ``trace_units``
(the steps of the traced segment).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..core import spec, weights
from ..reference import common, threefry

# the trainer's own profiler spans
SPANS = ("sample", "gather", "forward", "update")


def _endless(loader):
    """The loader's batches, epoch after epoch (each reshuffled)."""
    while True:
        yield from loader


def _norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in t.items()}


class Loop:
    unit = "steps"
    spans = SPANS
    controls = ("tf32", "half")

    def __init__(self, cell, gg, graph, seed: int, device):
        self.cell, self.gg, self.graph = cell, gg, graph
        self.seed, self.device = int(seed), torch.device(device)
        self.cfg = cell.config
        self.train = self.cfg["train"]
        self.kind = spec.component("models", self.cfg["model"]["kind"])
        self._ref = None

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from tch_geometric_tpu_torch.loader import SeedLoader
        from tch_geometric_tpu_torch.parallel import make_gnn_trainer
        from tch_geometric_tpu_torch.sampling import rng
        self.model = self.kind.build(self.cfg, self.device)
        self.params0 = weights.draw_weights(self.model, self.seed,
                                            self.device)
        self.trainer = make_gnn_trainer(
            self.model, self.train["fanouts"],
            learning_rate=self.train["learning_rate"])
        self.state = self.trainer.init_fn()
        self.key = rng.key(self.seed)
        self.labels = self.gg.y.cpu().numpy()
        train_idx = self.gg.train_idx.cpu().numpy()
        if len(train_idx) < self.train["batch_size"]:
            raise ValueError("the training split is smaller than a batch")
        loader = SeedLoader(train_idx, self.train["batch_size"],
                            seed=self.seed)
        self.batches = _endless(loader)
        self.losses: List[float] = []
        self.trees = []
        for t in range(int(self.cell.traffic["check_steps"])):
            seeds = next(self.batches)
            step_key = rng.fold(self.key, self.state.step)
            self.state, loss, _ = self._step(seeds)
            self.losses.append(float(loss))
            if t == 0:
                self.mu1 = {k: v.detach().clone()
                            for k, v in self.state.opt_state.mu.items()}
            sample, _ = self.trainer.sample_and_gather(
                step_key, self.graph, self.gg.x, seeds)
            self.trees.append((torch.as_tensor(seeds, device=self.device),
                               sample.nodes.clone(),
                               sample.node_valid.clone()))
        self.params_end = {k: p.detach().clone()
                           for k, p in self.state.params.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _step(self, seeds: np.ndarray):
        return self.trainer.train_step(self.state, self.key, self.graph,
                                       self.gg.x, seeds, self.labels[seeds])

    # -- the window ----------------------------------------------------------
    def window(self, seconds: float):
        """Steps until ``seconds`` have passed, then a synchronise: ``(steps,
        seconds)`` over all the work and all the time."""
        t0 = time.perf_counter()
        n = 0
        while True:
            self.state, _, _ = self._step(next(self.batches))
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return n, time.perf_counter() - t0

    def work(self, units: int) -> float:
        return units * self.train["batch_size"]

    def traced(self, units: int) -> None:
        for _ in range(units):
            self.state, _, _ = self._step(next(self.batches))

    def release(self) -> None:
        """Free the program's state; keep what the check reads."""
        del self.trainer, self.state, self.model, self.graph
        self.batches = None

    # -- the check -----------------------------------------------------------
    def _reference(self, dtype, tf32: bool, half: bool = False):
        """The reference's losses, first gradient and end parameters over
        the captured trees, in ``dtype`` (TF32 products if ``tf32``;
        ``half``: the loss over the first half of each batch only)."""
        fan = self.train["fanouts"]
        rate = float(self.cfg["model"]["dropout"])
        lr = float(self.train["learning_rate"])
        params = {k: v.to(dtype).clone().requires_grad_()
                  for k, v in self.params0.items()}
        mu = {k: torch.zeros_like(v) for k, v in params.items()}
        nu = {k: torch.zeros_like(v) for k, v in params.items()}
        losses, g1 = [], None
        base = threefry.key(self.seed)
        with common.tf32(tf32):
            for t, (seeds, nodes, valid) in enumerate(self.trees):
                bases = common.tree_layout(seeds.shape[0], fan)
                x = self.gg.x[nodes.clamp(0, self.gg.num_nodes - 1)].to(dtype)
                step_key = threefry.fold(base, t)

                def mask(j, shape, step_key=step_key):
                    return threefry.keep_mask(step_key, j, shape, rate,
                                              self.device)

                logits = self.kind.tree_reference(params, x, valid, bases,
                                                  fan, mask, rate)
                labels = self.gg.y[seeds]
                if half:
                    logits, labels = (logits[: len(labels) // 2],
                                      labels[: len(labels) // 2])
                loss = common.cross_entropy(logits, labels)
                grads = dict(zip(params, torch.autograd.grad(
                    loss, list(params.values()))))
                losses.append(float(loss.detach()))
                if t == 0:
                    g1 = {k: g.detach() for k, g in grads.items()}
                with torch.no_grad():
                    common.adam_step(params, grads, mu, nu, t + 1, lr)
        return losses, g1, {k: p.detach() for k, p in params.items()}

    def check(self, control: str = "") -> Dict[str, float]:
        """The numbers compared: ``tree_faults`` (slots breaking uniform
        sampling), ``loss1_gap`` (the first step's relative loss gap:
        before any update, so steady from seed to seed), ``loss_gap``
        (worst step's),
        ``grad_gap`` and ``change_gap`` (worst leaf's gap between the
        norms of the first gradient, and of the parameters' change over
        the steps, against the reference leaf's norm or the median
        leaf's, whichever is larger).  ``control``: in the program's place
        the reference in float32 with TF32 products (``"tf32"``), or with
        its loss over half of each batch (``"half"``)."""
        n = self.gg.num_nodes
        edges = common.EdgeSet(self.gg.src, self.gg.dst, n)
        faults = sum(common.tree_faults(nodes, valid, seeds,
                                        self.train["fanouts"], edges)
                     for seeds, nodes, valid in self.trees)
        del edges
        if faults:
            return dict(tree_faults=float(faults), loss1_gap=float("inf"),
                        loss_gap=float("inf"), grad_gap=float("inf"),
                        change_gap=float("inf"))
        if self._ref is None:
            # float32 products without TF32, as the configuration states:
            # against float64, a ReLU unit whose pre-activation float32
            # rounds across zero (one or two a step in 4.2M) moves a
            # leaf's gradient by up to 1e-4 of its norm
            self._ref = self._reference(torch.float32, False)
        r_loss, r_g1, r_end = self._ref
        if control == "tf32":
            losses, g1, end = self._reference(torch.float32, True)
        elif control == "half":
            losses, g1, end = self._reference(torch.float32, False, half=True)
        else:
            losses = self.losses
            g1 = {k: v / (1 - common.B1) for k, v in self.mu1.items()}
            end = self.params_end
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, r_loss)]
        rg = _norms(r_g1)
        med_g = float(np.median(list(rg.values())))
        pg = _norms(g1)
        grad_gap = max(abs(pg[k] - rg[k]) / max(rg[k], med_g) for k in rg)
        # leaves whose reference gradient is nought to rounding move by
        # round-off alone under Adam: not compared
        moved = [k for k in rg if rg[k] >= 1e-3 * med_g]
        rc = _norms({k: r_end[k] - self.params0[k] for k in moved})
        pc = _norms({k: end[k].double() - self.params0[k] for k in moved})
        med_c = float(np.median(list(rc.values())))
        change_gap = max(abs(pc[k] - rc[k]) / max(rc[k], med_c)
                         for k in moved)
        return dict(tree_faults=float(faults), loss1_gap=gaps[0],
                    loss_gap=max(gaps), grad_gap=grad_gap,
                    change_gap=change_gap)
