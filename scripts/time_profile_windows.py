#!/usr/bin/env python3
"""Time the stages of a ``torch.profiler`` window over HGT and node2vec
train steps, and list the window's top device ops by their full names.

For ``chip_smoke.py`` phase 11 (e)'s windows: builds phase 11's HGT trainer
on the ogbn-mag-shaped graph and its node2vec trainer on the products
out-edge CSR, takes one step of each, then per model times ``--steps``
steps unprofiled, the same steps in a ``utils.metrics.profile`` window, the
Chrome-trace export, ``prof.events()`` and ``chip_smoke.profile_split``,
then ``chip_smoke.trace_split`` of the exported trace, which must give the
same split, and prints the event count, the trace's size and the top 10
device ops.
From the root of a checkout, on one GPU:

    python3 scripts/time_profile_windows.py [--steps 3]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_profile_windows: CUDA is not available", file=sys.stderr)
        return 2
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.ogb import synthetic_ogbn
    from tch_geometric_tpu_torch.data.storage import to_csr
    from tch_geometric_tpu_torch.models import (Node2Vec,
                                                make_node2vec_trainer)
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.utils.metrics import profile, trace_span
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.gpu_line()
    print(card, flush=True)

    counts, edge_types, csc = cs.mag_graph(1.0, dev)
    graphs = cs.hetero_graphs(counts, edge_types, csc, dev)
    x = cs.mag_features(counts, dev)
    labels = torch.randint(0, cs.HGT_OUT, (counts["paper"],), device=dev)
    hgt = cs.hgt_model(counts, edge_types, False, dev)
    tr = cs.hgt_trainer(hgt, counts, edge_types, graphs, x)
    seeds = torch.randint(0, counts["paper"], (cs.HGT_TRAIN_SEEDS,),
                          device=dev)
    data = synthetic_ogbn(cs.PRODUCTS, seed=0, scale=1.0)
    n = data.num_nodes
    rp, ci = to_csr(data.edge_index, n)[:2]
    g = make_graph(rp, ci, num_src=n, num_dst=n, device=dev)
    n2v = Node2Vec(n, cs.N2V_DIM, cs.N2V_CONTEXT, cs.N2V_NEG, device=dev)
    tr2 = make_node2vec_trainer(n2v, g, walk_length=cs.WALK_LENGTH,
                                learning_rate=cs.N2V_LR,
                                num_trials=cs.N2V_TRIALS)
    starts = torch.randint(0, n, (cs.WALK_STARTS,), device=dev)
    state = {"hgt": tr.init_fn(), "node2vec": tr2.init_fn()}

    def steps(name, k):
        for _ in range(k):
            if name == "hgt":
                state[name] = tr.train_step(state[name], rng.key(1), seeds,
                                            labels[seeds])[0]
            else:
                state[name] = tr2.train_step(state[name], rng.key(1),
                                             starts)[0]

    for name in ("hgt", "node2vec"):
        steps(name, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(name, args.steps)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logdir = os.path.join(cs.PROFILE_DIR, f"windows_{name}")
        with profile(logdir) as prof:
            with trace_span("window"):
                steps(name, args.steps)
                torch.cuda.synchronize()
            t2 = time.perf_counter()
        t3 = time.perf_counter()
        evs = prof.events()
        t4 = time.perf_counter()
        r = cs.profile_split(prof, "window")
        t5 = time.perf_counter()
        rt = cs.trace_split(logdir, "window")
        t6 = time.perf_counter()
        cs.check_same_split(rt, r, name)
        mib = os.path.getsize(os.path.join(logdir, "trace.json")) / 2**20
        print(f"{name}, {args.steps} steps: unprofiled {t1 - t0:.1f} s, "
              f"window {t2 - t1:.1f} s, export {t3 - t2:.1f} s ({mib:.0f} "
              f"MiB), events() {t4 - t3:.1f} s ({len(evs)} events), split "
              f"{t5 - t4:.1f} s, trace read and split {t6 - t5:.1f} s "
              f"(equal); device ms by span "
              f"{r['device_ms_by_span']}, idle share {r['idle_share']:.3f}",
              flush=True)
        for o in r["top10"]:
            print(f"  {o['ms']:.3f} ms x{o['count']}: {o['name'][:300]}",
                  flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
