"""Plain PyTorch pieces shared by the reference models: the padded tree's
layout and its validity check, mean aggregation over the COO by
``index_add`` in blocks of edges, cross entropy and Adam.

Nothing here imports the program: the reference works out again, from the
generated COO and the weights the benchmark drew, whatever the program
derives (CSC, blocked layout, tree layout, masks).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

Params = Dict[str, torch.Tensor]

# bytes of one block's gathered rows in the COO aggregations
BLOCK_BYTES = 1 << 31


@contextlib.contextmanager
def tf32(enabled: bool) -> Iterator[None]:
    """float32 matrix products in TF32 (``enabled``) or in full float32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tree_layout(num_seeds: int, fanouts: Sequence[int]) -> List[int]:
    """First slot of each depth of the padded tree, and its end: depth 0
    holds the seeds, each slot of depth ``l`` has ``fanouts[l]`` child
    slots at depth ``l + 1``, laid out parent by parent."""
    bases = [0, num_seeds]
    for k in fanouts:
        bases.append(bases[-1] + (bases[-1] - bases[-2]) * k)
    return bases


class EdgeSet:
    """The graph's directed edges ``src -> dst`` as sorted keys
    ``dst * N + src``, and each node's in-degree."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor,
                 num_nodes: int):
        self.n = num_nodes
        self.keys = torch.sort(dst.long() * num_nodes + src.long()).values
        self.deg = torch.bincount(dst.long(), minlength=num_nodes)

    def has(self, dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        q = dst.long() * self.n + src.long()
        at = torch.searchsorted(self.keys, q).clamp_(max=self.keys.numel() - 1)
        return self.keys[at] == q


def tree_faults(nodes: torch.Tensor, valid: torch.Tensor,
                seeds: torch.Tensor, fanouts: Sequence[int],
                edges: EdgeSet) -> int:
    """Slots of a padded tree that break uniform sampling without
    replacement: a seed slot that is not its seed; a parent whose valid
    children number other than ``min(k, in-degree)``; a valid child that
    is not an in-neighbour of its parent; two valid children of one
    parent that are the same node (the graph has no repeated edges)."""
    bases = tree_layout(seeds.shape[0], fanouts)
    if nodes.shape[0] != bases[-1] or valid.shape[0] != bases[-1]:
        return bases[-1]
    B = seeds.shape[0]
    bad = int((nodes[:B] != seeds).sum()) + int((~valid[:B]).sum())
    for ell, k in enumerate(fanouts):
        par = nodes[bases[ell]: bases[ell + 1]]
        pv = valid[bases[ell]: bases[ell + 1]]
        ch = nodes[bases[ell + 1]: bases[ell + 2]].reshape(-1, k)
        cv = valid[bases[ell + 1]: bases[ell + 2]].reshape(-1, k)
        deg = edges.deg[par.clamp(0, edges.n - 1)]
        want = torch.where(pv, deg.clamp(max=k), 0)
        bad += int((cv.sum(1) != want).sum())
        ok = cv & (ch >= 0) & (ch < edges.n)
        hit = edges.has(par[:, None].expand_as(ch).clamp(0, edges.n - 1),
                        ch.clamp(0, edges.n - 1))
        bad += int((cv & ~(ok & hit)).sum())
        lane = torch.arange(k, device=ch.device)
        s = torch.sort(torch.where(cv, ch, -1 - lane), dim=1).values
        bad += int(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).sum())
    return bad


def edge_blocks(num_edges: int, row_bytes: int) -> Iterator[Tuple[int, int]]:
    step = max(1, BLOCK_BYTES // max(row_bytes, 1))
    for lo in range(0, num_edges, step):
        yield lo, min(lo + step, num_edges)


def mean_aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   deg: torch.Tensor) -> torch.Tensor:
    """``out[i] = mean of h[j]`` over the edges ``j -> i``; 0 where ``i``
    has none."""
    out = torch.zeros_like(h)
    for lo, hi in edge_blocks(src.shape[0], h[0].numel() * h.element_size()):
        out.index_add_(0, dst[lo:hi].long(), h[src[lo:hi].long()])
    return out / deg.clamp(min=1).to(h.dtype)[:, None]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean over rows of ``logsumexp(logits) - logits[label]``."""
    picked = logits.gather(1, labels.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=1) - picked).mean()


B1, B2, EPS = 0.9, 0.999, 1e-8


def adam_step(params: Params, grads: Params, mu: Params, nu: Params,
              t: int, lr: float) -> None:
    """Adam (Kingma and Ba, 2015) with bias correction, step ``t``
    (1-based), in place."""
    for k, p in params.items():
        g = grads[k]
        mu[k] = B1 * mu[k] + (1 - B1) * g
        nu[k] = B2 * nu[k] + (1 - B2) * g * g
        mhat = mu[k] / (1 - B1 ** t)
        vhat = nu[k] / (1 - B2 ** t)
        p.sub_(lr * mhat / (vhat.sqrt() + EPS))
