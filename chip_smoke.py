#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tch_geometric_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py [--scale S]

``--scale`` below 1 cuts the graph for a quick rehearsal; such a run prints
no kernels line.

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. build the CUDA kernels from ``tch_geometric_tpu_torch/csrc`` (nvcc, one
   process per source, all at once);
2. kernel checks: B1, B2, the hot split, B3 (both modes), B7 (scores in,
   and the GAT logits computed from the (N, H) tables), B8, the composed
   GAT route (B7, B8), B9, B5, B6, the composed attend (B5, B6, B8), B10,
   B4 (both stat modes) and B11 (sum and mean) against their plain
   versions on the card, on the kernel-gate testbed and three layout edge
   cases (the GAT kernels also at one head of 47 columns, B7's logits also
   with a short alpha_dst; the ragged case at 37 columns; B1, B2, B11 and
   the hot split also on a hub row of 1,000 lanes at 34 columns, and B1,
   B2 and B11 in their multi-pass mode on chunks of 8,192 lanes; B11 also
   at W=64, C=256 and F=100; B5 and B4 (both stat modes) also on the hub row, the
   multi-pass layout, rows of 320 columns, a distinct x_dst with fewer rows
   than the layout and a "far scores" case in which one chunk's scores sit
   150 above the rest of its row block; B6, through its wrapper and with
   every row block on its looped path, on the hub row, the multi-pass
   layout and the far scores; B10 on the same five cases, and B8
   on the hub row, the multi-pass layout and rows of 320 columns with one
   head and with four, of 36 columns (80 at 320), softmax weights; B3
   (both modes) and B9 on the hub row, the multi-pass layout, four heads
   of 80 and of 36 columns, one head of 47 and a "far logits" case in
   which three rows' logits sit 150 above the rest of their row block,
   B9's debug statistics on the hub row, and B7's two entries on the hub
   row and the multi-pass layout, and at one head, where they run B6's
   kernel, on both its paths on the hub row and the testbed), in float32
   (5e-4, TF32 off) and
   bfloat16 (per-kernel limits of ``utils/kernel_gates.py``); then the
   threefry kernel (``run_rng_gates``) bit-equal to its plain version on
   the card and to the CPU's bits, and the Floyd hop kernel
   (``run_floyd_gates``) bit-equal to its plain version on the card and on
   CPU copies of its inputs;
3. the GraphSAGE serving path at ogbn-products size (synthetic graph with
   the dataset's node/edge counts, 100 features, 47 classes; model
   hidden=256, 3 layers, random weights from a seed):
   (a) COO -> CSC -> device graph, 8 requests of 1024 seeds through
   ``sample_and_gather`` + ``tree_forward`` with fanouts [15, 10, 5];
   (b) ``build_blocked`` (W=256) and one full-graph ``blocked_forward``;
   (c) ``build_blocked_hot`` and one ``blocked_forward`` over it.
   The kernels' launch counts are zeroed just before (a)-(c) and read just
   after; each kernel must have run.  Then each kernel's wrapper is checked
   against its plain version at the main path's shapes (F=100 and F=256,
   bfloat16 and float32), and the kernel is timed there, beside its bound
   and one PyTorch library call computing the same function (a yardstick
   only; the port never calls it), and the serving outputs are checked:
   finite, (b) and (c) agree, and on a 5% node subgraph ``blocked_forward``
   agrees with the plain ``forward`` and the card's sampler with the CPU's.
4. the GAT serving path on the same graph and layout (model
   ``GAT(100, 256, 47, 3 layers, 4 heads)``: H=4, D=64, then one head of
   47; random weights from a seed): (a) 8 requests of 1024 seeds through
   ``sample_and_gather`` + ``tree_forward``, and one request each through
   GCN and GIN (hidden 256, 3 layers); (b) the full-graph pass,
   ``GAT.blocked_forward`` (B3 a layer, ELU between them), in float32.
   B3's launch count is zeroed just before (a)-(b) and read just after.
   Then B3's wrapper is checked against its plain version at both layer
   shapes and at PyG's ogbn-products GAT's (H=4 of D=128 and of D=47), in
   three modes (table, vec, vec with self loops) and both dtypes, and
   timed (with self loops too at PyG's shapes); the outputs are checked
   finite.
   Then the GAT routes: the same float32 full-graph pass three ways, each
   layer's attention through B3, through the composed route
   (``gat_attend_blocked_cuda``: B7 computing the logits from the (N, H)
   tables, then B8) and through the flash route
   (``gat_attend_blocked_flash_cuda``, B9).  The
   launch counts of B3, B7, B8 and B9 are zeroed just before and read just
   after; each must have run.  The three passes' logits agree within 5e-4,
   and on a 5% node subgraph each agrees with ``GAT.forward`` (segment ops)
   within 5e-4.  B7 (both entries), B8, the composed route and B9 are held
   against their plain versions at both layer shapes (H=4, D=64 and H=1,
   D=47) in both dtypes, and timed at layer 1's shape beside their bounds,
   plain versions and, for B7 and B8, one PyTorch library call; the torch
   gathers of the logits that B7's second entry replaced are timed beside
   it.
5. single-head dot-product attention (``examples/gat_attention.py``'s
   function, x_dst = x_src) on the same graph and layout: the routes
   ``attend_blocked_cuda`` (B5, B6, B8), ``attend_blocked_fused_cuda`` (B10)
   and ``attend_blocked_flash_cuda`` (B4, both stat modes), each on the 100
   features and on a seeded 256-column embedding, in bfloat16 and float32.
   The launch counts of B4, B5, B6, B8 and B10 are zeroed just before and
   read just after; each must have run.  The outputs are checked finite and
   (N, F), the routes agree with one another in float32, and on the 5%
   subgraph each agrees in float32 with ``sddmm`` -> ``segment_softmax`` ->
   ``segment_sum``.  Then each kernel's wrapper is held against its plain
   version at both widths and dtypes, and timed at F=256 bfloat16.
6. the int8 SpMM on the SAGE layout: ``quantize_rows`` and
   ``spmm_blocked_q8_cuda(agg="mean")`` (B11) on the 100 features and a
   seeded 256-column embedding, its launch count zeroed before and read
   after.  The output is held against the plain version (float32, 5e-4) and
   against B1 on the unquantised rows in float32 (2e-2 of the largest
   value, the quantisation limit), and B11 is timed beside B1 at both
   widths.
7. sampled training at the serving width on the same graph, features and
   labels (47 classes), TF32 off: (a) ``GraphSAGE(100, 256, 47, 3 layers,
   dropout 0.5)`` through ``make_gnn_trainer(..., [15, 10, 5],
   learning_rate=1e-3)``, one warm-up step, then 10 steps of 1024 random
   seeds, each timed on the host's clock up to a synchronise, with peak
   device memory; then 20 steps on one fixed batch, whose loss by
   ``eval_step`` (dropout off, one key) must fall; (b) the same with
   ``GAT(100, 256, 47, 3 layers, 4 heads, dropout 0.5)``; (c)
   ``make_multibatch_sage_trainer`` at M=8 on bfloat16 features with a
   bfloat16 SAGE (``scripts/bench_sampled_training.py``'s configuration),
   ms per minibatch; (d) card against CPU: on the 5% node subgraph, 3
   steps of (a)'s trainer from the same parameters, key and seeds on each;
   the samples and dropout masks are bit-equal, so the losses must agree
   within 1e-3 relative (the largest parameter difference is printed).  No
   kernel of B1-B11 lies on this path; the launch counts are zeroed before
   (a)-(c) and printed after.  The threefry kernel (T1) does: every draw of
   the ELL sampler and the dropout masks is one launch of it; and on a
   graph with no ELL table each hop of the uniform sampler is one launch of
   the Floyd hop kernel (F1).  Their counts, zeroed before the serving path
   (3), the train path (7) and every later phase, are printed after each;
   T1's must be above 0 on 3, 7, 9 and 11; F1's must be 0 on 7 (its graph
   has an ELL table) and above 0 on 9, 10 and 11 (relations of
   ogbn-mag's shape past the ELL widths, and graphs built without one).
   Then T1's kernel row: the kernel alone and its plain version at the
   dropout masks' shapes (``kernel_gates.RNG_MASK_SHAPES``), bit-equal,
   timed beside the bound, with the train path's launches and the host's
   microseconds a call of ``random_bits`` at a Floyd draw's widest shape,
   ``split`` and ``fold_in``.  Then F1's kernel row, on the benchmark's
   products graph (``benchmark/graphs/products.py``, no ELL table): the
   launches of F1 and T1 in each of ``F1_STEPS`` steps of (a)'s SAGE
   trainer there, the train cell's path (3 and 2 a step: one a hop, one a
   mask); then, at the three hops of a 1,024-seed tree at [15, 10, 5],
   the hop kernel beside its bound and its plain version on the card,
   bit-equal.
8. ``torch.profiler`` (``utils.metrics.profile``, a Chrome trace each under
   ``build/profile/``) over 3 SAGE train steps, 3 sampled SAGE requests and
   one SAGE ``blocked_forward``: for each, the device time of the kernels
   launched under each of the trainer's spans (``sample``, ``gather``,
   ``forward`` with the loss and the backward, ``update``), the top 10
   device operations by their own time with counts, and the device idle
   share of the window (1 - union of the device intervals / wall time).
9. weighted, temporal and heterogeneous neighbor sampling (no kernel of
   B1-B11 lies on it; the launch counts are zeroed before (a)-(b) and
   printed after): (a) on the products graph with phase 3's SAGE, 8
   requests of 1024 seeds (``sample_neighbors``, gather, ``tree_forward``,
   fanouts [15, 10, 5]) under ``WeightedEdgeSampler`` (weights |N(0,1)| +
   0.1 from a seed) without and with replacement, and under
   ``TemporalEdgeFilter`` in STATIC, RELATIVE and DYNAMIC modes (edge
   timestamps and seed states in [0, 1000) from a seed, window (0, 400),
   forward): ms per request, the valid share per hop, peak device memory;
   every valid edge is real and lies in its parent's window, every
   temporal edge passes the window against its parent's state, in DYNAMIC
   mode a child's state is its edge's timestamp, the logits are finite;
   (b) ``sample_hetero_neighbors`` on a graph of ogbn-mag's shape (4 node
   types, 7 relations, 36.8M edges, endpoints uniform from a seed), 1024
   paper seeds, [15, 10] per relation, uniform, weighted (without and with
   replacement) and temporal DYNAMIC, where the field_of_study relation
   has no ELL table and runs the window engines; and uniform at
   ``scripts/bench_samplers.py``'s hetero configuration (3 types x 6
   relations of 300k edges, [5, 5], 256 seeds a type; the fused hop): ms
   per request, valid slots per type, (a)'s edge checks per relation; (c)
   card against CPU, same seeds, states and key: every configuration of
   (a) and uniform on the 5% node subgraph, on its ELL table and on the
   window engines (16-lane chunks), every configuration of (b) on (b)'s
   graph cut to 5% of each type's nodes, each relation on its full-size
   engine; uniform exactly equal, the
   seeds' hop-0 validity (the filter masks) exactly equal, Gumbel-ranked
   samples differing in at most 1e-4 of the valid slots (the count is
   printed); and ``rng.gumbel`` on 1M draws within rtol 4e-7.
10. the rest of the reference-parity API (no kernel of B1-B11 lies on it;
   the launch counts are zeroed before (a)-(g), printed after and must all
   be 0; the phase prints its wall time): (a) ``to_csc`` and ``to_csr`` of
   the products COO three ways, each timed: numpy's stable sort, the native
   C++ counting sort (asserted built: no numpy fallback) and
   ``coo_to_csc_device`` on the card, exactly equal; ``ind2ptr`` on the
   card against ``ind2ptr_np``; ``find_edge`` on 1M pairs, half real edges
   and half random, against a numpy search of the sorted edge keys; (b)
   walks from 2,560 starts (OGB's products node2vec example: 256 nodes x 10
   walks), length 40: node2vec at (p, q) = (1, 1) and (1, 1.5) on the
   products out-edge CSR of (a)'s card build (the binary-search path; max
   degree 113,135), ``tempo_random_walk`` (edge and node timestamps in [0,
   1000), window (0, 400)) and ``biased_tempo_random_walk`` (uniform,
   linear, exponential; forward, ``retry_count`` 10) on the in-edge
   adjacency (the CSC as the reversed graph's CSR, max degree 56: the ELL
   path; on the out-edge CSR their draws per step would be walks x max
   degree), and one node2vec call of 262,144 starts; ms per request; every
   step an edge, or -1 after a dead end (a temporal walk's restart returns
   to an earlier position), temporal steps in the window, CTDNE timestamps
   never decreasing; (c) negative sampling: homogeneous on the products CSR
   (65,536 inputs, 5 negatives, 5 tries), heterogeneous on phase 9's
   mag-shaped graph (1,024 papers, 1,024 authors; inbound False and True),
   no accepted negative an edge (in the probe's direction) or a self-loop;
   (d) HGT sampling on the mag shape, 128 paper seeds, [512] x 4 per node
   type, uniform and temporal (timerange (0, 400)), through
   ``hgt_sampling`` and ``HGTSamplerTransform``: ms per request, valid
   nodes per type, every kept edge real with both ends in the sample; (e)
   budget sampling on the mag shape, 1,024 papers, [15, 10] per type, with
   no filter and with the temporal filter (window (0, 400), forward,
   ``relative`` False and True): ms per request, valid slots, every edge
   real and through the filter; (f) ``NeighborSamplerTransform`` on
   products and on the mag shape, ``NegativeSamplerTransform`` on products,
   ``SeedLoader`` over 65,536 seeds: ms per call; (g) card against CPU on
   phase 9's 5% cuts, same key and inputs, on ELL tables and again without
   tables (the products cut's in-edge adjacency for the walks): node2vec at
   (1, 1.5), both negative samplers and ``coo_to_csc_device`` exactly
   equal, temporal and CTDNE walks (4,096 of length 12) differing in at
   most 1e-3 of the walks, HGT (two layers of [512]) and budget (uniform,
   temporal) in at most 1e-3 of the valid slots (each count printed). Each
   part's wall time and the phase's are printed.
11. the HGT, node2vec and link-prediction models and trainers (no kernel of
   B1-B11 lies on them; the launch counts are zeroed before (a)-(e),
   printed after and must all be 0; each part prints its wall time and
   peak device memory, each trainer its ms per step, host clock to a
   synchronise, one warm-up then 5 steps, with its peak device memory):
   (a) ``HGT(128 features, hidden 128, out 349, 2 layers, 4 heads)`` (the
   repo's HGT training configuration, scripts/bench_partitioned_hgt.py;
   349 ogbn-mag venues) through ``make_hgt_trainer`` on phase 9's
   mag-shaped graph, 128 seeded N(0, 1) feature columns a type, seeded
   paper labels, 512 papers a step, [128, 128] per type, Adam at 1e-3, per
   relation and relation-batched; 20 steps on one batch, whose loss on one
   fixed sample must fall; one temporal step (timerange (0, 400)); (b)
   ``Node2Vec(2,449,029, 128, context 20, 1 negative)`` (OGB's products
   node2vec example) through ``make_node2vec_trainer`` on the products
   out-edge CSR, walks of 40 from 2,560 starts a step, p = q = 1, Adam at
   0.01 over the dense table, one trial a step (the walks of the default
   16, which is checked and timed); 20 steps on one fixed batch of walks
   and negatives, whose loss must fall; (c) ``make_link_trainer`` with
   ``GraphSAGE(100, 256, 256, 3 layers, dropout 0.5)``, [15, 10, 5], 1
   negative of 8 tries, Adam at 1e-3, on the products CSC, 1,024 edges a
   step: the accepted share, no accepted negative an edge from its source
   or an endpoint; (d) card against CPU, same parameters, keys and inputs:
   (c) on phase 3's 5% subgraph (3 steps of 256 edges, losses within
   1e-3), (b) on its out-edge CSR (3 steps, draws equal, losses within
   1e-5), HGT on the mag cut (one CPU sample on both, forward and
   gradients within 1e-4 of the largest, both layouts; 3 trainer steps,
   differing sample slots at most 1e-3 of the valid ones, losses within
   1e-3 when none differs); (e) ``torch.profiler`` over one HGT and one
   node2vec step, read as phase 8 reads its windows.
12. the partitioned graph, the owner-routed exchanges and the partitioned
   SAGE trainers (no kernel of B1-B11 lies on them; their launch counts
   must stay 0): (a) ``build_partitioned_graph`` of phase 3's CSC at P = 1
   and P = 4, 1,000 seeded rows checked against the CSC; (b)
   ``dist_sample_neighbors`` of 1,024 seeds, [15, 10, 5], capacity factor
   1.3, at P = 1 over a process group of world size 1 (NCCL, a
   ``file://`` store under ``build/``) and at P = 4 thread ranks on the
   card: trees bit-identical, overflow 0; (c) ``make_partitioned_trainer``
   with ``scripts/bench_partitioned_products.py``'s GraphSAGE(256, 47, 3
   layers), 1,024 seeds a step, at P = 1 and P = 4: losses within 1e-5;
   (d) ``make_partitioned_multibatch_trainer``, 8 minibatches of 512
   seeds, P = 1; (e) card against CPU on phase 3's 5% subgraph: a
   1,024-seed request (the card at P = 4 threads, the CPU at P = 1) and a
   256-seed request at P = 4 on both differ in 0 slots, and 3 trainer
   steps of 256 seeds at P = 4 give losses within 1e-5.  P = 4 on one
   card is a structural check: four threads share the card and the GIL.
13. the 2-axis mesh (no kernel of B1-B11 lies on it; their launch counts
   must stay 0): (a) ``make_partitioned_trainer(hier=("slice", "chip"))``
   with phase 12 (c)'s model, key and seeds on (S, C) = (2, 2) thread
   ranks (the graph at ``num_parts = 2``, the features interleaved over
   4): ms per step, peak device memory, overflow 0, 3 losses within 1e-5
   of phase 12 (c)'s flat P = 4 trainer's; its multibatch trainer at M = 8
   x 512, ms per minibatch; (b) the same at (1, 1) over a process group of
   world size 1 (NCCL; each axis a ``dist.new_group``), losses against
   (a); (c) ``make_gnn_trainer(mesh=)`` (data-parallel over ``data`` with
   block draws, column-parallel over ``model``) with phase 7 (a)'s SAGE
   (dropout 0.5), key and seeds at (2, 2) threads and (1, 1) over NCCL: 3
   losses within 1e-5 of phase 7's one-device trainer, and each data
   rank's share of tree slots equal to the whole 1,024-seed batch's, 1.0;
   (d) card against CPU on phase 3's 5% subgraph: 3 steps of (a) and of
   (c) at (2, 2), 256 seeds, losses within 1e-5.  The thread meshes are
   structural checks, as in phase 12.
14. distributed walks, distributed negatives and the partitioned link
   trainer (no kernel of B1-B11 lies on them; their launch counts must
   stay 0), at P = 1 over a process group of world size 1 (NCCL) and P =
   4 thread ranks, on the products out-edge CSR (no ELL table: the window
   engines) and in-edge adjacency (ELL) partitioned with effective edge
   timestamps in [0, 1000): (a) ``dist_random_walk``, 2,560 starts of 40
   at (p, q) = (1, 1) and (1, 1.5); (b) ``dist_tempo_random_walk`` (window
   (0, 400)) and ``dist_biased_tempo_random_walk`` (uniform, linear,
   exponential; forward, retry 10; at P = 4 the exponential only) on the
   in-edge ELL, and one tempo call of 256 starts of 5 on the out-edge
   CSR; (c) ``dist_negative_sample`` (65,536 inputs, 5 negatives, 5
   tries, outbound and inbound) and ``dist_negative_sample_hetero`` on the
   mag shape (1,024 papers and authors): ms per call, overflow 0, the two
   P bit-equal, every step an edge, temporal windows and CTDNE time order
   held, no accepted negative an edge or a self-loop; (d)
   ``make_partitioned_link_trainer`` with phase 11 (c)'s SAGE (dropout
   0.5), 1 negative of 8 tries, 1,024 edges a step: ms per step and peak
   device memory (P = 1: one warm-up then 5; P = 4: the cross-P steps),
   3 dropout-0 losses within 1e-5 across P (with dropout on each rank
   masks its own tree, so those losses depend on P); (e) card against
   CPU at P = 4 on phase 3's 5% cut: node2vec and the negatives equal,
   tempo and CTDNE walks within 1e-3 of the walks, 3 link steps of 256
   edges (dropout 0) within 1e-5.  Each part's wall time and the phase's
   are printed.
15. distributed budget sampling, typed distributed neighbor sampling and
   the partitioned heterogeneous layouts (no kernel of B1-B11 lies on
   them; their launch counts must stay 0), at P = 1 over a process group
   of world size 1 (NCCL) and, one configuration a sampler, at P = 4
   thread ranks: (a) ``dist_budget_sample`` at
   ``scripts/bench_partitioned_products.py``'s configuration (512 seeds,
   [15, 10, 5], capacity factor 1.3) on the products CSC (the ELL table:
   lane top-k fills) and its out-edge CSR (max degree 113,135: Floyd's
   fills), and with the temporal filter on the CSC (edge timestamps and
   seed states in [0, 1000) from a seed, window (0, 400), forward,
   ``relative`` False and True), each at the default rounds at P = 1, and
   the CSC at one round at P = 4: ms per call (host clock to a
   synchronise; at P = 1 one warm-up then one, at P = 4 one call), the
   overflow rate, the valid share per hop; every valid edge real and in
   its parent's window, a parent's picks distinct, every edge through the
   filter against its parent's state, a child's state its edge's (its
   root's with ``relative``); (b) ``dist_budget_sample_hetero`` on phase
   9's mag shape (1,024 papers, [15, 10] per type; no filter and the
   temporal filter; P = 4: temporal) and (c)
   ``dist_hetero_neighbor_sample`` there ([15, 10] per relation; uniform,
   weighted without and with replacement, temporal DYNAMIC; P = 4:
   DYNAMIC; the relations without an ELL table run the window engines),
   each edge checked as phases 9 (b) and 10 (e) check theirs; (d) each
   P = 4 sample, its rank blocks in the one-rank layout
   (``merge_rank_blocks`` for the typed ones), equal to P = 1's on every
   valid slot and validity bit with overflow 0 (at one round, if some
   request overflowed, on the slots it carried), and
   ``put_stacked_rels`` of the mag relations at P = 4: each relation's
   slice its own graph, padded rows of degree 0; (e) card against CPU on
   phase 3's 5% cut and the mag cut, 256 seeds or papers, each sampler's
   P = 4 configuration at P = 4 and the others at P = 1 on both: (a)-(c)
   equal, a Gumbel-ranked configuration within 1e-3 of the valid slots
   (each count printed).  Each part's wall time and the phase's are
   printed.
16. distributed HGT sampling, ``HGT(psum_axis=)`` and the partitioned HGT
   trainer (no kernel of B1-B11 lies on them; their launch counts must
   stay 0), at P = 1 over a process group of world size 1 (NCCL) and P =
   4 thread ranks, on phase 9's mag shape at
   ``scripts/bench_partitioned_hgt.py``'s configuration (512 papers,
   [128, 128] per type, capacity factor 2.0): (a) ``dist_hgt_sample`` at
   P = 1 in its three structures (per relation, relations fused, one
   stacked relation at a time; the relations without ELL tables, so that
   all three draw alike) and fused with ``timerange`` (0, 400) on edge
   timestamps in [0, 1000): ms per call (one warm-up, then one), overflow
   0, valid slots by type and hop; every kept edge real, between valid
   slots, each node sampled at most once a type, every sampled node's time
   in the range; the three structures bit-equal; (b)
   ``make_partitioned_hgt_trainer`` with phase 11 (a)'s
   ``HGT(128, 128, 349, 2 layers, 4 heads)`` on interleave-sharded
   feature tables, 512 papers a step: at P = 1 per relation and
   relation-batched (one warm-up, then 5 steps), at P = 4 relation-batched
   (3 steps): ms per step, peak device memory, overflow 0, the 3 losses
   within 1e-5 across P; (c) the P = 4 sample, its blocks concatenated,
   equal to P = 1's on every valid slot and validity bit; (d) card against
   CPU at P = 4 on the mag cut (256 papers): the samples within 1e-3 of
   the valid slots (each count printed), 3 trainer steps' losses within
   1e-5 when no slot of their samples differs.  Each part's wall time and
   the phase's are printed.

Output: human-readable lines, then one JSON line of kernel numbers (B1-B11,
T1 and F1), one
line with the card's name and power limit (nvidia-smi), and as the last
line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
# T1's bound: an element of threefry takes 20 funnel shifts and 21 xors (the
# rounds' and the output's), which only the ALU pipe issues, 64 lanes an SM
# (its 32 adds can go to the FMA pipe as IMAD), and writes 8 bytes.  H100
# SXM: 132 SMs at 1.98 GHz.
T1_ALU_OPS_PER_ELEMENT = 20 + 21
ALU_OPS_PER_S = 132 * 64 * 1.98e9
FLOYD_DRAW = (15360,)          # the widest hop's draw at 1,024 seeds
PRODUCTS = "ogbn-products"
FANOUTS = [15, 10, 5]
REQUESTS = 8
SEEDS_PER_REQUEST = 1024
W = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (after one warm-up),
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def maxerr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_build():
    from tch_geometric_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (sec, out) in built.items():
        log(f"build: {name} {sec:.1f}s\n{out.strip()}")
    log(f"build: total {time.perf_counter() - t0:.1f}s "
        f"({len(built)} libraries compiled)")


def phase_kernel_checks(device):
    from tch_geometric_tpu_torch.utils import kernel_gates as kg
    for dtype, thr in ((torch.float32, kg.F32_THRESHOLD),
                       (torch.bfloat16, kg.BF16_THRESHOLDS)):
        errs = kg.run_kernel_gates(dtype, device=device)
        errs.update(kg.run_spmm_mode_gates(dtype, device=device))
        errs.update(kg.run_gat_gates(dtype, device=device))
        errs.update(kg.run_gat_route_gates(dtype, device=device))
        errs.update(kg.run_attend_gates(dtype, device=device))
        errs.update(kg.run_attend_mode_gates(dtype, device=device))
        errs.update(kg.run_weighted_mode_gates(dtype, device=device))
        errs.update(kg.run_gat_mode_gates(dtype, device=device))
        errs.update(kg.run_q8_gates(dtype, device=device))
        ok, worst = kg.gate(errs, thr)
        log(f"kernel checks {str(dtype)[6:]} (limits {thr}): "
            f"nearest its limit {worst}")
        for k, v in errs.items():
            log(f"  {k}: {v:.3e}")
        check(ok, f"kernel checks {dtype}: {worst}")
    # the threefry kernel: bit-equal to the plain version and the CPU
    errs = kg.run_rng_gates(device)
    bad = {k: v for k, v in errs.items() if v}
    log(f"rng gates ({len(errs)} entries, mismatched elements): "
        f"{bad or 'none'}")
    check(not bad, f"rng gates: {bad}")
    # the hop kernel: bit-equal to the plain version on the card and the CPU
    errs = kg.run_floyd_gates(device)
    bad = {k: v for k, v in errs.items() if v}
    log(f"floyd gates ({len(errs)} entries, mismatched elements): "
        f"{bad or 'none'}")
    check(not bad, f"floyd gates: {bad}")


def host_prep(scale: float, device):
    """Graph, features, model and both blocked layouts; returns a dict and
    the host seconds of each step."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.ogb import synthetic_ogbn
    from tch_geometric_tpu_torch.data.storage import coo_to_csc_device
    from tch_geometric_tpu_torch.models.sage import GraphSAGE
    from tch_geometric_tpu_torch.ops.spmm_blocked import (build_blocked,
                                                          build_blocked_hot)
    sec = {}
    t = time.perf_counter()
    data = synthetic_ogbn(PRODUCTS, seed=0, scale=scale)
    sec["synthetic_graph"] = time.perf_counter() - t
    n = data.num_nodes
    t = time.perf_counter()
    # the CSC by the card's stable sort (phase 10 (a) holds it exactly
    # against the native ``to_csc``), copied back for the host builders
    ei = torch.from_numpy(data.edge_index).to(device)
    col_ptrs, row_indices, perm = (
        x.cpu().numpy() for x in coo_to_csc_device(ei[0], ei[1], n, n))
    del ei
    sec["csc_on_card"] = time.perf_counter() - t
    t = time.perf_counter()
    graph = make_graph(col_ptrs, row_indices, perm, num_src=n, num_dst=n,
                       device=device)
    x_table = torch.from_numpy(data.x).to(device)
    sec["make_graph"] = time.perf_counter() - t
    t = time.perf_counter()
    blocked = build_blocked(col_ptrs, row_indices, rows_per_block=W,
                            device=device)
    sec["build_blocked"] = time.perf_counter() - t
    t = time.perf_counter()
    hot = build_blocked_hot(col_ptrs, row_indices, rows_per_block=W,
                            device=device)
    sec["build_blocked_hot"] = time.perf_counter() - t
    model = GraphSAGE(data.x.shape[1], 256, 47, 3,
                      generator=torch.Generator().manual_seed(0),
                      device=device)
    return dict(data=data, col_ptrs=col_ptrs, row_indices=row_indices,
                graph=graph, x_table=x_table, blocked=blocked, hot=hot,
                model=model), sec


def serve(p, device, timer):
    """The main path: (a) sampled requests, (b) blocked forward, (c) hot
    split forward.  ``timer(fn)`` returns (result, milliseconds)."""
    from tch_geometric_tpu_torch.parallel.train import make_gnn_trainer
    from tch_geometric_tpu_torch.sampling import rng
    model, graph, x_table = p["model"], p["graph"], p["x_table"]
    n = x_table.shape[0]
    trainer = make_gnn_trainer(model, FANOUTS)
    gen = torch.Generator().manual_seed(1)
    req_ms, logits = [], []
    with torch.no_grad():
        for r in range(REQUESTS):
            seeds = torch.randint(0, n, (SEEDS_PER_REQUEST,), generator=gen)
            key = rng.fold(rng.key(0), r)

            def request():
                sample, x = trainer.sample_and_gather(key, graph, x_table,
                                                      seeds)
                return model.tree_forward(sample, x)
            out, ms = timer(request)
            req_ms.append(ms)
            logits.append(out)
        out_b, ms_b = timer(lambda: model.blocked_forward(x_table,
                                                          p["blocked"]))
        out_c, ms_c = timer(lambda: model.blocked_forward(x_table, p["hot"]))
    return dict(req_ms=req_ms, logits=logits, out_b=out_b, out_c=out_c,
                ms_b=ms_b, ms_c=ms_c)


FORWARD_REPS = 3


def steady_forward_ms(p, timer):
    """Warm full-graph forward times, plain and hot-split layouts in turns
    (after the main path, so not counted in its launches)."""
    model, x_table = p["model"], p["x_table"]
    out = {"blocked": [], "hot_split": []}
    with torch.no_grad():
        for _ in range(FORWARD_REPS):
            for k, layout in (("blocked", p["blocked"]),
                              ("hot_split", p["hot"])):
                out[k].append(timer(
                    lambda: model.blocked_forward(x_table, layout))[1])
    return out


def check_serving(res, n):
    from tch_geometric_tpu_torch.utils.kernel_gates import \
        FORWARD_BF16_THRESHOLD
    for lg in res["logits"]:
        check(lg.shape == (SEEDS_PER_REQUEST, 47), f"request shape {lg.shape}")
        check(bool(torch.isfinite(lg).all()), "request logits finite")
    for k in ("out_b", "out_c"):
        check(res[k].shape == (n, 47), f"{k} shape {tuple(res[k].shape)}")
        check(bool(torch.isfinite(res[k]).all()), f"{k} finite")
    err = maxerr(res["out_b"], res["out_c"])
    log(f"check: blocked vs hot-split forward max |diff| {err:.3e} "
        f"(bf16 limit {FORWARD_BF16_THRESHOLD}; logits max |value| "
        f"{float(res['out_b'].abs().max()):.3e})")
    check(err <= FORWARD_BF16_THRESHOLD,
          "blocked and hot-split forwards agree")
    return err


def subgraph(data, device, frac=0.05):
    """A random ``frac`` node subgraph: its node ids, CSC arrays, features,
    graph and blocked layout on ``device``, and the numpy generator that
    drew it."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.storage import to_csc
    from tch_geometric_tpu_torch.ops.spmm_blocked import build_blocked
    n = data.num_nodes
    r = np.random.default_rng(2)
    keep = np.sort(r.choice(n, size=max(int(n * frac), 64), replace=False))
    new_id = np.full(n, -1, np.int64)
    new_id[keep] = np.arange(len(keep))
    ei = new_id[data.edge_index]
    ei = ei[:, (ei >= 0).all(axis=0)]
    ns = len(keep)
    cp, ri, _ = to_csc(ei, ns)
    return dict(cp=cp, ri=ri, ns=ns, edges=int(ei.shape[1]), ei=ei, r=r,
                keep=keep,
                xs=torch.from_numpy(data.x[keep]).to(device),
                g=make_graph(cp, ri, num_src=ns, num_dst=ns, device=device),
                b=build_blocked(cp, ri, rows_per_block=W, device=device))


def check_subgraph(p, sub):
    """On a random 5% node subgraph: blocked_forward (f32 and bf16) against
    the plain forward, and the card's sampled request against the CPU's
    (same key -> identical sample; logits allclose)."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.parallel.train import make_gnn_trainer
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.utils.kernel_gates import (
        F32_THRESHOLD, FORWARD_BF16_THRESHOLD)
    model = p["model"]
    cp, ri, ns, r, xs, g, b = (sub[k] for k in
                               ("cp", "ri", "ns", "r", "xs", "g", "b"))
    out = {}
    with torch.no_grad():
        ref = model(xs, g)
        e32 = maxerr(model.blocked_forward(xs, b, compute_dtype=torch.float32),
                     ref)
        e16 = maxerr(model.blocked_forward(xs, b), ref)
        log(f"check: {ns} nodes / {sub['edges']} edges subgraph: "
            f"blocked_forward vs forward f32 {e32:.3e} bf16 {e16:.3e} "
            f"(limits {F32_THRESHOLD}, {FORWARD_BF16_THRESHOLD}; logits max "
            f"|value| {float(ref.abs().max()):.3e})")
        check(e32 <= F32_THRESHOLD, "subgraph blocked f32 vs plain")
        check(e16 <= FORWARD_BF16_THRESHOLD, "subgraph blocked bf16 vs plain")
        out.update(subgraph_nodes=ns, subgraph_edges=sub["edges"],
                   blocked_vs_plain_f32=e32, blocked_vs_plain_bf16=e16)

        cpu_model = copy.deepcopy(model).cpu()
        g_cpu = make_graph(cp, ri, num_src=ns, num_dst=ns, device="cpu")
        seeds = torch.from_numpy(r.choice(ns, SEEDS_PER_REQUEST))
        key = rng.key(7)
        sa, xa = make_gnn_trainer(model, FANOUTS).sample_and_gather(
            key, g, xs, seeds)
        sb, xb = make_gnn_trainer(cpu_model, FANOUTS).sample_and_gather(
            key, g_cpu, xs.cpu(), seeds)
        for f in ("nodes", "node_valid", "rows", "cols", "eptr",
                  "edge_valid"):
            check(torch.equal(getattr(sa, f).cpu(), getattr(sb, f)),
                  f"card and CPU samples agree on {f}")
        e = maxerr(model.tree_forward(sa, xa).cpu(),
                   cpu_model.tree_forward(sb, xb))
        log(f"check: sampled request card vs CPU: samples identical, "
            f"logits max |diff| {e:.3e}")
        check(e <= 1e-4, "sampled logits card vs CPU")
        out["request_card_vs_cpu"] = e
    return out


def kernel_numbers(p, launches, device):
    """Each kernel at the main path's shapes.  Its wrapper, called as the
    forward calls it, is held against the plain version at both feature
    widths the forward aggregates (F=100: the float32 input features; F=256:
    the hidden layers), in bfloat16 (the main path's compute dtype) and in
    float32.  Then the kernel alone, its plain version and one library call
    computing the same function are timed at F=256 in bfloat16, beside the
    bound; the kernel also at F=100 in bfloat16 and at F=256 in float32
    (beside the library call in float32).  Returns the kernels' JSON rows
    and each kernel's lane-gather time (every lane reads its row; derived,
    not measured)."""
    from tch_geometric_tpu_torch.ops.attention_blocked import \
        spmm_blocked_weighted_cuda
    from tch_geometric_tpu_torch.ops.spmm_blocked import spmm_blocked
    from tch_geometric_tpu_torch.ops.spmm_kernels import (_launch,
                                                          spmm_blocked_cuda)
    from tch_geometric_tpu_torch.utils.kernel_gates import (BF16_THRESHOLDS,
                                                            F32_THRESHOLD)
    blocked, hot, x_table = p["blocked"], p["hot"], p["x_table"]
    n = x_table.shape[0]
    gen = torch.Generator().manual_seed(3)
    x32 = torch.randn((n, 256), generator=gen).to(device)
    xb = x32.to(torch.bfloat16)
    x_hot32 = x32[hot.hot_ids]
    xb_hot = x_hot32.to(torch.bfloat16)
    # the library yardstick: torch.sparse.mm on a CSR matrix holding the
    # same edges, once in bfloat16 (the kernels' inputs; its output is
    # rounded to bfloat16) and once in float32 (the kernels' output dtype)
    csr = _csr(*_coalesced_csr(p["col_ptrs"], p["row_indices"], n, device),
               (n, n))
    hb = hot.hot
    hot_csr = _csr(*_lanes_to_csr(hb, hot.hot_count, n),
                   (n, x_hot32.shape[0]))

    rows, gather_bound = [], {}
    specs = [
        dict(name="spmm_blocked_cuda (B1)",
             source="tch_geometric_tpu_torch/csrc/spmm_blocked.cu",
             replaces="tch_geometric_tpu/ops/spmm_pallas.py:28",
             key="spmm_blocked_cuda", b=blocked, w=None, xb=xb, csr=csr,
             widths={100: x_table, 256: x32},
             run=lambda b, x, w, dt: spmm_blocked_cuda(
                 b, x, agg="mean", compute_dtype=dt),
             plain=lambda b, x, w, dt: spmm_blocked(
                 b, x, agg="mean", compute_dtype=dt)),
        dict(name="spmm_blocked_weighted_cuda (B2)",
             source="tch_geometric_tpu_torch/csrc/spmm_blocked.cu",
             replaces="tch_geometric_tpu/ops/attention_blocked.py:418",
             key="spmm_blocked_weighted_cuda", b=hb, w=hot.hot_count,
             xb=xb_hot, csr=hot_csr,
             widths={100: x_table[hot.hot_ids], 256: x_hot32},
             run=lambda b, x, w, dt: spmm_blocked_weighted_cuda(
                 b, x, w, compute_dtype=dt),
             plain=lambda b, x, w, dt: spmm_blocked(
                 b, x, edge_weight=w, compute_dtype=dt)),
    ]
    for s in specs:
        b, w = s["b"], s["w"]
        T, C = b.edge_src.shape
        errs = {}
        for width, xx in s["widths"].items():
            for dt, thr in ((torch.bfloat16, BF16_THRESHOLDS[s["key"]]),
                            (torch.float32, F32_THRESHOLD)):
                got = s["run"](b, xx, w, dt)
                ref = s["plain"](b, xx, w, dt)
                check(got.shape == ref.shape == (b.num_rows, width),
                      f"{s['name']} F={width} output shape {tuple(got.shape)}")
                e = errs[width, dt] = maxerr(got, ref)
                log(f"check: {s['name']} wrapper vs plain at F={width} "
                    f"{str(dt)[6:]}: max |diff| {e:.3e} (limit {thr})")
                check(e <= thr, f"{s['name']} F={width} {dt}: {e:.3e} > {thr}")
                del got, ref
        err16 = max(v for (_, dt), v in errs.items() if dt == torch.bfloat16)
        err32 = max(v for (_, dt), v in errs.items() if dt == torch.float32)
        # the kernel alone on rows already in its dtype: F=256 bfloat16 (the
        # row's headline), F=100 bfloat16 and F=256 float32
        timed = {"F256_bf16": s["xb"],
                 "F100_bf16": s["widths"][100].to(torch.bfloat16),
                 "F256_f32": s["widths"][256]}
        ms_by = {k: cuda_ms(lambda: _launch(b, xx, w), 10)
                 for k, xx in timed.items()}
        ms = ms_by["F256_bf16"]
        plain_ms = cuda_ms(lambda: spmm_blocked(
            b, s["xb"], agg="sum", edge_weight=w,
            compute_dtype=torch.bfloat16), 2)
        csr32, csr16 = s["csr"]
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr16, s["xb"]), 10)
        library_f32_ms = cuda_ms(
            lambda: torch.sparse.mm(csr32, s["widths"][256]), 10)
        valid = int(b.edge_valid.sum()) if b.edge_valid is not None else T * C
        # bytes bound: the kernel's own inputs read once — x, the blocked
        # layout's per-lane edge_src and local_row (and weight), pad lanes
        # included, chunk_block, and block_start (read by the zero pass) —
        # and the (B*W, F) float32 output written once; operations: an add
        # (B2: a multiply-add) per valid lane and column
        meta = 12 if w is not None else 8
        bound = {}
        for k, xx in timed.items():
            f = xx.shape[1]
            out_bytes = b.num_blocks * b.rows_per_block * f * 4
            t_bytes = (xx.numel() * xx.element_size() + T * C * meta + T * 4
                       + b.block_start.numel() * 4 + out_bytes
                       ) / HBM_BYTES_PER_S * 1e3
            t_ops = valid * f * (2 if w is not None else 1) / F32_FLOP_PER_S * 1e3
            bound[k] = (max(t_bytes, t_ops),
                        "bytes" if t_bytes >= t_ops else "operations")
        F = 256
        out_bytes = b.num_blocks * b.rows_per_block * F * 4
        gather_ms = (T * C * (F * 2 + meta) + out_bytes) / HBM_BYTES_PER_S * 1e3
        gather_bound[s["key"]] = gather_ms
        rows.append(dict(
            name=s["name"], route="cuda", source=s["source"],
            replaces=s["replaces"], launches=launches[s["key"]],
            max_abs_err=err16, ms=ms, plain_ms=plain_ms,
            bound_ms=bound["F256_bf16"][0], bound_by=bound["F256_bf16"][1],
            library_ms=library_ms,
            max_abs_err_f32=err32, ms_by_case=ms_by,
            bound_ms_by_case={k: v[0] for k, v in bound.items()},
            shape=dict(T=T, C=C, W=b.rows_per_block, F=F, N=int(s["xb"].shape[0]),
                       valid_lanes=valid, dtype="bfloat16"),
            library_call="torch.sparse.mm(CSR bfloat16, dense bfloat16)",
            library_f32_ms=library_f32_ms))
        log(f"kernel {s['name']}: T={T} C={C} F={F} lanes valid {valid}: "
            f"{ms:.3f} ms (bound {bound['F256_bf16'][0]:.3f} ms by "
            f"{bound['F256_bf16'][1]}; derived lane-gather time "
            f"{gather_ms:.3f} ms), by case "
            + ", ".join(f"{k} {v:.3f} ms (bound {bound[k][0]:.3f})"
                        for k, v in ms_by.items())
            + f"; plain {plain_ms:.3f} ms, library {library_ms:.3f} ms (float32 "
            f"{library_f32_ms:.3f} ms), launches on main path "
            f"{launches[s['key']]}, worst wrapper err bf16 {err16:.2e} "
            f"f32 {err32:.2e}")
    return rows, gather_bound


def host_us(fn, reps: int) -> float:
    """Host microseconds a call of ``fn`` over ``reps`` calls (after one
    warm-up), with no synchronise inside the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def rng_kernel_numbers(launches, device):
    """T1, the threefry kernel, at the dropout masks' shapes of a sampled
    SAGE train step: ``rng.threefry_cuda`` (the kernel) and
    ``rng.threefry_plain`` (the torch ops on the card), bit-equal, each
    timed beside the bound (the kernel's device time by the profiler, and
    by CUDA events around back-to-back calls); then the host's
    microseconds a call of ``random_bits`` at a Floyd draw's widest shape,
    ``split`` and ``fold_in``.  ``launches``: the train path's.  Returns
    the JSON row."""
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.utils.kernel_gates import RNG_MASK_SHAPES
    key = rng.key(2024)
    ms_by, events_by, plain_by, bound_by = {}, {}, {}, {}
    for name, shape in zip(("mask_layer1", "mask_layer2"), RNG_MASK_SHAPES):
        n = shape[0] * shape[1]
        kernel = lambda n=n: rng.threefry_cuda(key, n, device)  # noqa: E731
        plain = lambda n=n: rng.threefry_plain(key, n, device)  # noqa: E731
        check(torch.equal(kernel(), plain()), f"T1 {name} bits vs plain")
        # the kernel's device time by the profiler; CUDA events around
        # back-to-back calls read the host's pace where a call's host side
        # outlasts its kernel (the second mask's)
        ms_by[name] = kernel_device_ms(kernel, "threefry_kernel", 50)
        events_by[name] = cuda_ms(kernel, 50)
        plain_by[name] = cuda_ms(plain, 3)
        t_ops = n * T1_ALU_OPS_PER_ELEMENT / ALU_OPS_PER_S * 1e3
        t_bytes = n * 8 / HBM_BYTES_PER_S * 1e3
        bound_by[name] = (max(t_ops, t_bytes),
                          "operations" if t_ops >= t_bytes else "bytes")
    host = dict(
        random_bits=host_us(lambda: rng.random_bits(key, FLOYD_DRAW, device),
                            2000),
        split=host_us(lambda: rng.split(key), 2000),
        fold_in=host_us(lambda: rng.fold_in(key, 7), 2000))
    steps = ("mask_layer1", "mask_layer2")
    row = dict(
        name="threefry_cuda (T1)", route="cuda",
        source="tch_geometric_tpu_torch/csrc/threefry.cu",
        replaces="none: the JAX package's threefry is XLA's "
                 "(jax/_src/prng.py::_threefry2x32_lowering)",
        launches=launches, mismatched_bits=0, ms=ms_by["mask_layer1"],
        plain_ms=plain_by["mask_layer1"],
        bound_ms=bound_by["mask_layer1"][0],
        bound_by=bound_by["mask_layer1"][1], library_ms=None,
        ms_by_case=dict(ms_by, mask_step=sum(ms_by[k] for k in steps)),
        events_ms_by_case=events_by,
        plain_ms_by_case=dict(plain_by,
                              mask_step=sum(plain_by[k] for k in steps)),
        bound_ms_by_case={k: v[0] for k, v in bound_by.items()},
        shape=dict(masks=[list(s) for s in RNG_MASK_SHAPES],
                   dtype="int64 bits"),
        host_us=host)
    log(f"kernel {row['name']}: masks "
        + ", ".join(f"{k} {ms_by[k]:.3f} ms (bound {bound_by[k][0]:.3f} ms "
                    f"by {bound_by[k][1]}; by CUDA events around "
                    f"back-to-back calls {events_by[k]:.3f} ms; plain "
                    f"{plain_by[k]:.3f} ms)" for k in steps)
        + "; host us a call: "
        + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
        + f"; launches on the train path {launches}")
    return row


# F1's bound: a row-draw takes two threefry hashes (T1's 41 ALU operations
# each); a slot writes pos, valid, eptr and neighbor (25 bytes) and reads
# one neighbor id (8), a row reads its frontier id, validity and indptr pair
# (25) and writes its degree (8).
F1_ALU_OPS_PER_DRAW = 2 * T1_ALU_OPS_PER_ELEMENT
F1_BYTES_PER_SLOT, F1_BYTES_PER_ROW = 25 + 8, 25 + 8
F1_STEPS = 3            # counted train steps on the products graph


def kernel_device_ms(fn, kernel: str, reps: int) -> float:
    """Mean device time a call of ``fn`` spends in the kernels whose name
    holds ``kernel``, over ``reps`` calls under ``torch.profiler`` (after
    one warm-up): a call whose host side outlasts its kernel is timed by
    the kernel, not by the host's pace, as CUDA events around the calls
    would time it."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if kernel in e.key)
    check(us > 0, f"the profiler saw no device time of {kernel}")
    return us / reps / 1e3


def floyd_kernel_numbers(device, seed=2025):
    """F1, the hop kernel, on the benchmark's products graph
    (``benchmark/graphs/products.py`` with ``sage-products``' settings, no
    ELL table: in-degrees past 18k).  First the train cell's path: after
    a warm-up step, ``F1_STEPS`` steps of phase 7 (a)'s SAGE trainer there,
    each of which must launch F1 once a hop and T1 once a mask (the row's
    ``launches`` and ``t1_launches``, a step).  Then the sampled train
    step's three hop shapes (1,024 seeds at fanouts [15, 10, 5]), the
    frontiers of one ``sample_neighbors`` tree: each hop's
    ``floyd_hop_cuda`` (the kernel) and ``floyd_hop_plain`` (torch ops on
    the card), bit-equal, timed beside the bound: the kernel's device time
    by the profiler, a call's host time (CUDA events around back-to-back
    calls, which the host paces) and the plain version's.  Returns the
    JSON row."""
    from benchmark.graphs import products
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.storage import coo_to_csc_device
    from tch_geometric_tpu_torch.parallel import make_gnn_trainer
    from tch_geometric_tpu_torch.sampling import primitives, rng
    from tch_geometric_tpu_torch.sampling.neighbor import sample_neighbors
    with open("benchmark/configs/sage-products.json") as f:
        gcfg = json.load(f)["graph"]
    gg = products.generate(gcfg, seed, device)
    ptr, idx, perm = coo_to_csc_device(gg.src, gg.dst, gg.num_nodes,
                                       gg.num_nodes)
    graph = make_graph(ptr, idx, perm, num_src=gg.num_nodes,
                       num_dst=gg.num_nodes, device=device)
    del ptr, idx, perm
    check(graph.ell is None and graph.indices_win is None,
          f"the products graph has no sampling table (max in-degree "
          f"{graph.max_degree})")
    model = train_model("sage", gg.x.shape[1], device)
    trainer = make_gnn_trainer(model, FANOUTS, learning_rate=TRAIN_LR)
    state = trainer.init_fn()
    key = rng.key(seed)
    batches = gg.train_idx[:(1 + F1_STEPS) * SEEDS_PER_REQUEST].view(
        1 + F1_STEPS, SEEDS_PER_REQUEST)
    f1, t1 = [], []
    for seeds in batches:
        f0, t0 = primitives.floyd_hop_cuda.launches, rng.threefry_cuda.launches
        state, loss, _ = trainer.train_step(state, key, graph, gg.x, seeds,
                                            gg.y[seeds])
        torch.cuda.synchronize()
        check(bool(torch.isfinite(loss)), "F1's train steps: loss finite")
        f1.append(primitives.floyd_hop_cuda.launches - f0)
        t1.append(rng.threefry_cuda.launches - t0)
    log(f"train steps on the products graph: F1 launches {f1}, T1 "
        f"launches {t1} a step (the first a warm-up)")
    check(f1 == [len(FANOUTS)] * len(f1),
          f"F1 launches {f1} a train step, one a hop")
    check(t1 == [model.num_layers - 1] * len(t1),
          f"T1 launches {t1} a train step, one a dropout mask")
    del trainer, state, model
    seeds = gg.train_idx[:SEEDS_PER_REQUEST].cpu().numpy()
    del gg
    tree = sample_neighbors(graph, seeds, FANOUTS, key=key)
    torch.cuda.synchronize()
    ms_by, host_by, plain_by, bound_by, shapes = {}, {}, {}, {}, {}
    nb = tree.node_base
    for hop, k in enumerate(FANOUTS):
        frontier = tree.nodes[nb[hop]:nb[hop + 1]]
        fvalid = tree.node_valid[nb[hop]:nb[hop + 1]]
        hkey = rng.fold(key, hop)
        name = f"hop{hop}"
        kernel = lambda f=frontier, v=fvalid, k=k, hk=hkey: (  # noqa: E731
            primitives.floyd_hop_cuda(hk, graph, f, v, k))
        plain = lambda f=frontier, v=fvalid, k=k, hk=hkey: (  # noqa: E731
            primitives.floyd_hop_plain(hk, graph, f, v, k))
        got, want = kernel(), plain()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"F1 {name} vs plain")
        B = frontier.shape[0]
        drawing = int((got[0] > k).sum())
        ms_by[name] = kernel_device_ms(kernel, "floyd_kernel", 50)
        host_by[name] = cuda_ms(kernel, 200) * 1e3
        plain_by[name] = cuda_ms(plain, 3)
        t_ops = drawing * k * F1_ALU_OPS_PER_DRAW / ALU_OPS_PER_S * 1e3
        t_bytes = (B * k * F1_BYTES_PER_SLOT
                   + B * F1_BYTES_PER_ROW) / HBM_BYTES_PER_S * 1e3
        bound_by[name] = (max(t_ops, t_bytes),
                          "operations" if t_ops >= t_bytes else "bytes")
        shapes[name] = dict(rows=B, k=k, drawing_rows=drawing)
    del graph, tree
    steps = tuple(ms_by)
    row = dict(
        name="floyd_hop_cuda (F1)", route="cuda",
        source="tch_geometric_tpu_torch/csrc/floyd.cu",
        replaces="none: the JAX package's Floyd loop is XLA's fusion "
                 "(sampling/primitives.py::floyd_sample)",
        launches=f1[-1], t1_launches=t1[-1], mismatched=0, ms=ms_by["hop2"],
        plain_ms=plain_by["hop2"], bound_ms=bound_by["hop2"][0],
        bound_by=bound_by["hop2"][1], library_ms=None,
        ms_by_case=dict(ms_by, step=sum(ms_by[k] for k in steps)),
        plain_ms_by_case=dict(plain_by,
                              step=sum(plain_by[k] for k in steps)),
        bound_ms_by_case={k: v[0] for k, v in bound_by.items()},
        host_us_by_case=host_by, shape=shapes)
    log(f"kernel {row['name']}: "
        + ", ".join(f"{k} [{shapes[k]['rows']} x {shapes[k]['k']}] "
                    f"{ms_by[k] * 1e3:.1f} us (bound "
                    f"{bound_by[k][0] * 1e3:.1f} us by {bound_by[k][1]}; "
                    f"a call on the host "
                    f"{host_by[k]:.1f} us; plain {plain_by[k]:.2f} ms)"
                    for k in steps)
        + f"; launches a train step: F1 {f1[-1]}, T1 {t1[-1]}")
    return row


GAT_HEADS = 4
OTHER_MODELS = ("gcn", "gin")


def gat_models(p, device):
    """GAT (4 heads), GCN and GIN, each hidden 256, 3 layers, 47 outputs,
    with weights from ``torch.Generator().manual_seed(0)``."""
    from tch_geometric_tpu_torch.models.gnn import GAT, GCN, GIN
    f = p["data"].x.shape[1]

    def make(cls, **kw):
        return cls(f, 256, 47, 3, generator=torch.Generator().manual_seed(0),
                   device=device, **kw)
    return dict(gat=make(GAT, heads=GAT_HEADS), gcn=make(GCN), gin=make(GIN))


GAT_ROUTES = ("packed", "composed", "flash")


def gat_route_pass(gat, x, blocked, route="packed"):
    """``GAT.forward``'s composition over the blocked layout, ELU between
    layers, each layer's attention step through one route: ``packed``,
    ``GAT.blocked_forward`` (B3 a layer); ``composed``, ``gat_attend_blocked_cuda``
    (B7 on the logit tables, B8); ``flash``,
    ``gat_attend_blocked_flash_cuda`` (B9).  The last two take the
    layer's ``project`` and ``logit_tables`` (alpha_src as an (N, H)
    table) in its compute dtype."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab
    attend = {"composed": ab.gat_attend_blocked_cuda,
              "flash": ab.gat_attend_blocked_flash_cuda}.get(route)
    if attend is None:
        return gat.blocked_forward(x, blocked,
                                   compute_dtype=gat.convs[0].compute_dtype)
    h = x
    for i, conv in enumerate(gat.convs):
        hh = conv.project(h)
        out = attend(blocked, hh, *conv.logit_tables(hh),
                     compute_dtype=conv.compute_dtype).reshape(
                         -1, conv.features)
        h = gat._act(out, i, True)
    return h


def serve_gat(p, models, timer):
    """The GAT path: (a) sampled GAT requests, one GCN and one GIN request;
    (b) the full-graph blocked GAT pass."""
    from tch_geometric_tpu_torch.parallel.train import make_gnn_trainer
    from tch_geometric_tpu_torch.sampling import rng
    graph, x_table = p["graph"], p["x_table"]
    n = x_table.shape[0]
    gen = torch.Generator().manual_seed(4)
    req_ms, logits, other = [], [], {}
    with torch.no_grad():
        for name in ("gat",) * REQUESTS + OTHER_MODELS:
            model = models[name]
            trainer = make_gnn_trainer(model, FANOUTS)
            seeds = torch.randint(0, n, (SEEDS_PER_REQUEST,), generator=gen)
            key = rng.fold(rng.key(1), len(req_ms) + len(other))

            def request():
                sample, x = trainer.sample_and_gather(key, graph, x_table,
                                                      seeds)
                return model.tree_forward(sample, x)
            out, ms = timer(request)
            if name == "gat":
                req_ms.append(ms)
                logits.append(out)
            else:
                other[name] = (out, ms)
        out_full, ms_full = timer(lambda: gat_route_pass(
            models["gat"], x_table, p["blocked"]))
    return dict(req_ms=req_ms, logits=logits, other=other, out=out_full,
                ms=ms_full)


def steady_gat_ms(p, models, timer):
    """Warm full-graph GAT passes (after the main path, so not counted in
    its launches)."""
    with torch.no_grad():
        return [timer(lambda: gat_route_pass(models["gat"], p["x_table"],
                                             p["blocked"]))[1]
                for _ in range(FORWARD_REPS)]


def check_gat_serving(res, n):
    for lg in res["logits"] + [o for o, _ in res["other"].values()]:
        check(lg.shape == (SEEDS_PER_REQUEST, 47), f"request shape {lg.shape}")
        check(bool(torch.isfinite(lg).all()), "request logits finite")
    check(res["out"].shape == (n, 47), f"GAT pass shape {res['out'].shape}")
    check(bool(torch.isfinite(res["out"]).all()), "GAT pass finite")


def check_gat_subgraph(models, sub):
    """On the 5% node subgraph: the blocked GAT pass through each route
    (float32) against ``GAT.forward`` (gather + segment softmax + segment
    sum)."""
    from tch_geometric_tpu_torch.utils.kernel_gates import F32_THRESHOLD
    gat = models["gat"]
    with torch.no_grad():
        ref = gat(sub["xs"], sub["g"])
        errs = {route: maxerr(gat_route_pass(gat, sub["xs"], sub["b"], route),
                              ref) for route in GAT_ROUTES}
    log(f"check: subgraph blocked GAT pass vs GAT.forward f32 (limit "
        f"{F32_THRESHOLD}; logits max |value| {float(ref.abs().max()):.3e}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for route, e in errs.items():
        check(e <= F32_THRESHOLD,
              f"subgraph blocked GAT ({route}) vs segment-op GAT")
    return errs


def serve_gat_routes(p, models, timer):
    """The GAT routes phase: the float32 full-graph GAT pass through each
    route.  Each output is checked finite and (N, 47)."""
    n = p["x_table"].shape[0]
    outs, ms = {}, {}
    with torch.no_grad():
        for route in GAT_ROUTES:
            out, ms[route] = timer(lambda: gat_route_pass(
                models["gat"], p["x_table"], p["blocked"], route))
            check(out.shape == (n, 47), f"GAT {route} pass shape "
                  f"{tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"GAT {route} finite")
            outs[route] = out
    return outs, ms


def check_gat_routes(outs):
    """The three full-graph passes agree in float32."""
    from tch_geometric_tpu_torch.utils.kernel_gates import F32_THRESHOLD
    errs = {f"{r}_vs_packed": maxerr(outs[r], outs["packed"])
            for r in ("composed", "flash")}
    errs["flash_vs_composed"] = maxerr(outs["flash"], outs["composed"])
    log(f"check: GAT routes agree in float32 (limit {F32_THRESHOLD}; logits "
        f"max |value| {float(outs['packed'].abs().max()):.3e}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= F32_THRESHOLD, f"GAT routes {k}: {v:.3e}")
    return errs


# (H, D) of the products GAT's layers: layers 1 and 2, then layer 3
GAT_LAYER_SHAPES = ((GAT_HEADS, 256 // GAT_HEADS), (1, 47))


def _route_inputs(b, n, H, D, device):
    """Seeded h (N, H, D), alpha_src and alpha_dst (N, H); their logits
    (H, T, C) with NaN in the pad lanes and B7's plain weights of them; h's
    rows in each compute dtype, as (N, H, D) and as (N, H*D)."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab
    gen = torch.Generator().manual_seed(9)
    h = torch.randn((n, H, D), generator=gen).to(device)
    a_s = torch.randn((n, H), generator=gen).to(device)
    a_d = torch.randn((n, H), generator=gen).to(device)
    logits = _nan_pads(b, ab.gat_edge_logits_blocked(b, a_s, a_d)
                       .movedim(-1, 0).contiguous())
    # rows already in each compute dtype, so that the timed calls do not
    # cast (the wrappers' and plain versions' cast is then the identity)
    hs = {dt: h.to(dt) for dt in (torch.float32, torch.bfloat16)}
    return dict(a_s=a_s, a_d=a_d, logits=logits, hs=hs,
                att=ab.edge_softmax_blocked_multihead(b, logits),
                xs={dt: v.reshape(n, H * D) for dt, v in hs.items()})


def gat_route_kernel_numbers(p, launches, device):
    """B7, B8, the composed route and B9 on the products layout, on seeded
    h, alpha_src and alpha_dst (B7 on their logits with NaN in the pad
    lanes, B8 on B7's weights).  Each wrapper is held against its plain
    version at both layer shapes of the GAT (H=4, D=64 and H=1, D=47) in
    float32 and bfloat16, then timed at layer 1's shape in both dtypes
    beside its bound, its plain version (float32, the GAT routes' dtype)
    and, for B7 and B8, one library call.  Returns the kernels' JSON rows
    (times in float32, bfloat16 beside them; errors the worst of both
    shapes)."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab
    from tch_geometric_tpu_torch.utils.kernel_gates import (BF16_THRESHOLDS,
                                                            F32_THRESHOLD)
    b = p["blocked"]
    n = p["x_table"].shape[0]
    T, C = b.edge_src.shape
    W, B = b.rows_per_block, b.num_blocks
    valid = int(b.edge_valid.sum())
    f32, b16 = torch.float32, torch.bfloat16
    specs = {
        "edge_softmax_blocked_multihead_cuda": (
            lambda v, dt: ab.edge_softmax_blocked_multihead_cuda(
                b, v["logits"]),
            lambda v, dt: ab.edge_softmax_blocked_multihead(b, v["logits"])),
        # B7's second entry: the logits computed from the tables
        "edge_softmax_blocked_multihead_cuda[logits]": (
            lambda v, dt: ab._gat_edge_softmax_blocked_cuda(
                b, v["a_s"], v["a_d"]),
            lambda v, dt: ab.edge_softmax_blocked_multihead(
                b, ab.gat_edge_logits_blocked(b, v["a_s"], v["a_d"])
                .movedim(-1, 0))),
        "spmm_blocked_multiweighted_cuda": (
            lambda v, dt: ab.spmm_blocked_multiweighted_cuda(
                b, v["xs"][dt], v["att"], compute_dtype=dt),
            lambda v, dt: ab.spmm_blocked_multiweighted(
                b, v["xs"][dt], v["att"], compute_dtype=dt)),
        "gat_attend_blocked_cuda": (
            lambda v, dt: ab.gat_attend_blocked_cuda(
                b, v["hs"][dt], v["a_s"], v["a_d"], compute_dtype=dt),
            lambda v, dt: ab.gat_attend_blocked(
                b, v["hs"][dt], v["a_s"], v["a_d"], compute_dtype=dt)),
        "gat_attend_blocked_flash_cuda": (
            lambda v, dt: ab.gat_attend_blocked_flash_cuda(
                b, v["hs"][dt], v["a_s"], v["a_d"], compute_dtype=dt),
            lambda v, dt: ab.gat_attend_blocked_flash(
                b, v["hs"][dt], v["a_s"], v["a_d"], compute_dtype=dt)),
    }
    errs = {k: {} for k in specs}
    with torch.no_grad():
        # layer 3's shape first, so that layer 1's inputs stay for the
        # timings
        for H, D in GAT_LAYER_SHAPES[::-1]:
            v = None                # the previous shape's inputs go first
            v = _route_inputs(b, n, H, D, device)
            for dt in (f32, b16):
                for key, (run, plain) in specs.items():
                    thr = (F32_THRESHOLD if dt == f32 else
                           BF16_THRESHOLDS[key.split("[")[0]])
                    got, ref = run(v, dt), plain(v, dt)
                    check(got.shape == ref.shape,
                          f"{key} shape {tuple(got.shape)}")
                    e = errs[key][f"H{H}_D{D}_{str(dt)[6:]}"] = maxerr(got,
                                                                      ref)
                    log(f"check: {key} wrapper vs plain at H={H} D={D} "
                        f"{str(dt)[6:]}: max |diff| {e:.3e} (limit {thr}; "
                        f"max |value| {float(ref.abs().max()):.3e})")
                    check(e <= thr, f"{key} H={H} D={D} {dt}: {e:.3e} > {thr}")
                    del got, ref
        ms = {k: {str(dt)[6:]: cuda_ms(lambda: run(v, dt), 10)
                  for dt in (f32, b16)} for k, (run, _) in specs.items()}
        plain_ms = {k: cuda_ms(lambda: plain(v, f32), 2)
                    for k, (_, plain) in specs.items()}
        # the composed route's logits as its wrapper made them before B7
        # took them in: torch gathers, then the (H, T, C) copy B7's first
        # entry reads (no kernel of the port; a yardstick)
        logits_ms = cuda_ms(lambda: ab.gat_edge_logits_blocked(
            b, v["a_s"], v["a_d"]).movedim(-1, 0).contiguous(), 10)
        logits, x = v["logits"], v["xs"][f32]
        del v
        lib_ms, lib_call = _gat_library_ms(p, logits, x, device)
        del logits, x
    worst = {k: {dt: max(e for s, e in errs[k].items() if s.endswith(dt))
                 for dt in ("float32", "bfloat16")} for k in specs}
    H, D = GAT_LAYER_SHAPES[0]

    # bytes bounds, counted as B1's: the function's inputs read once and its
    # output written once; operations on this run's valid lanes
    lanes, out_bytes = T * C, B * W * H * D * 4
    meta = lanes * 8 + (B + 1) * 4
    bounds = {
        "edge_softmax_blocked_multihead_cuda": lambda eb: (
            H * lanes * 4 + lanes * 4 + T * 4 + (B + 1) * 4 + H * lanes * 4,
            valid * H * 6),
        # the two (N, H) tables, edge_src and local_row, chunk_block and
        # block_start in; the weights out; a logit is an add, a compare and
        # a multiply more
        "edge_softmax_blocked_multihead_cuda[logits]": lambda eb: (
            2 * n * H * 4 + lanes * 8 + T * 4 + (B + 1) * 4 + H * lanes * 4,
            valid * H * 9),
        "spmm_blocked_multiweighted_cuda": lambda eb: (
            n * H * D * eb + meta + T * 4 + H * lanes * 4 + out_bytes,
            valid * H * D * 2),
        "gat_attend_blocked_flash_cuda": lambda eb: (
            n * H * D * eb + meta + 2 * n * H * 4 + out_bytes,
            valid * H * (7 + 2 * D)),
    }
    info = {"edge_softmax_blocked_multihead_cuda": ("B7", ":289"),
            "spmm_blocked_multiweighted_cuda": ("B8", ":485"),
            "gat_attend_blocked_flash_cuda": ("B9", ":621")}
    def bound_ms(key, eb):
        by, ops = bounds[key](eb)
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOP_PER_S * 1e3
        return (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")

    b7l = "edge_softmax_blocked_multihead_cuda[logits]"
    log(f"composed GAT route (B7 on the logit tables, B8) at H={H} D={D}: "
        f"{ms['gat_attend_blocked_cuda']} ms, of which B7 {ms[b7l]} ms; the "
        f"torch logits B7 replaced {logits_ms:.3f} ms; plain "
        f"{plain_ms['gat_attend_blocked_cuda']:.3f} ms; wrapper err "
        f"{errs['gat_attend_blocked_cuda']}")
    rows = []
    for key, (label, line) in info.items():
        t = {dt: bound_ms(key, eb) for dt, eb in (("float32", 4),
                                                    ("bfloat16", 2))}
        rows.append(dict(
            name=f"{key} ({label})", route="cuda",
            source="tch_geometric_tpu_torch/csrc/gat_blocked.cu",
            replaces=f"tch_geometric_tpu/ops/attention_blocked.py{line}",
            launches=launches[key], max_abs_err=worst[key]["float32"],
            ms=ms[key]["float32"], plain_ms=plain_ms[key],
            bound_ms=t["float32"][0], bound_by=t["float32"][1],
            library_ms=lib_ms.get(key), library_call=lib_call.get(key),
            max_abs_err_bf16=worst[key]["bfloat16"],
            ms_bf16=ms[key]["bfloat16"], bound_ms_bf16=t["bfloat16"][0],
            shape=dict(T=T, C=C, W=W, H=H, D=D, N=n, valid_lanes=valid,
                       dtype="float32")))
        if key == "edge_softmax_blocked_multihead_cuda":
            # the second entry, on the (N, H) logit tables
            rows[-1].update(ms_logits=ms[b7l]["float32"],
                            plain_ms_logits=plain_ms[b7l],
                            bound_ms_logits=bound_ms(b7l, 4)[0],
                            max_abs_err_logits=max(worst[b7l].values()),
                            torch_logits_ms=logits_ms)
            log(f"kernel {key} (B7) on the logit tables: {ms[b7l]} ms (bound "
                f"{bound_ms(b7l, 4)[0]:.3f} ms), plain {plain_ms[b7l]:.3f} ms, "
                f"worst wrapper err {errs[b7l]}")
        log(f"kernel {key} ({label}): T={T} C={C} H={H} D={D} lanes valid "
            f"{valid}: {ms[key]} ms (bound f32 {t['float32'][0]:.3f} ms, "
            f"bf16 {t['bfloat16'][0]:.3f} ms, by {t['float32'][1]}), plain "
            f"{plain_ms[key]:.3f} ms (f32), library {lib_ms.get(key)} "
            f"({lib_call.get(key)}), launches on the GAT routes path "
            f"{launches[key]}, worst wrapper err {errs[key]}")
    return rows, dict(ms=ms["gat_attend_blocked_cuda"], logits_ms=logits_ms,
                      plain_ms=plain_ms["gat_attend_blocked_cuda"],
                      errs=errs["gat_attend_blocked_cuda"])


def _gat_library_ms(p, logits, x, device):
    """Library yardsticks on the graph's coalesced edges (A[dst, src]), in
    float32: ``torch.sparse.softmax`` of a COO tensor with the heads as a
    dense dimension for B7 (one call per head if refused), and
    ``torch.bmm`` of an (H, N, N) COO tensor and the (H, N, D) rows for B8
    (``torch.sparse.mm`` per head if refused).  Returns ({kernel: ms},
    {kernel: call})."""
    H = logits.shape[0]
    n = x.shape[0]
    D = x.shape[1] // H
    ptr, col, _ = _coalesced_csr(p["col_ptrs"], p["row_indices"], n, device)
    rows = torch.repeat_interleave(torch.arange(n, device=device), ptr.diff())
    idx = torch.stack([rows, col])
    del rows
    vals = torch.randn((col.shape[0], H),
                       generator=torch.Generator().manual_seed(11)).to(device)
    ms, call = {}, {}
    key = "edge_softmax_blocked_multihead_cuda"
    try:
        coo = torch.sparse_coo_tensor(idx, vals, (n, n, H), is_coalesced=True)
        ms[key] = cuda_ms(lambda: torch.sparse.softmax(coo, dim=1), 10)
        call[key] = "torch.sparse.softmax(COO float32 (N, N, H), dim=1)"
    except RuntimeError as exc:
        log(f"library: hybrid sparse softmax refused: "
            f"{str(exc).splitlines()[0]}")
        heads = [torch.sparse_coo_tensor(idx, vals[:, k].contiguous(), (n, n),
                                         is_coalesced=True) for k in range(H)]
        ms[key] = cuda_ms(lambda: [torch.sparse.softmax(c, dim=1)
                                   for c in heads], 10)
        call[key] = (f"torch.sparse.softmax(COO float32 (N, N), dim=1), "
                     f"once per head ({H} calls)")
    torch.cuda.empty_cache()
    key = "spmm_blocked_multiweighted_cuda"
    xh = x.reshape(n, H, D).permute(1, 0, 2).contiguous()
    try:
        hidx = torch.cat([torch.cat([torch.full_like(idx[:1], k), idx])
                          for k in range(H)], dim=1)
        coo3 = torch.sparse_coo_tensor(hidx, vals.t().reshape(-1), (H, n, n),
                                       is_coalesced=True)
        del hidx
        ms[key] = cuda_ms(lambda: torch.bmm(coo3, xh), 10)
        call[key] = "torch.bmm(COO float32 (H, N, N), dense (H, N, D))"
        del coo3
    except RuntimeError as exc:
        log(f"library: sparse bmm refused: {str(exc).splitlines()[0]}")
        torch.cuda.empty_cache()
        csrs = [torch.sparse_csr_tensor(ptr, col, vals[:, k].contiguous(),
                                        size=(n, n)) for k in range(H)]
        ms[key] = cuda_ms(lambda: [torch.sparse.mm(c, xh[k])
                                   for k, c in enumerate(csrs)], 10)
        call[key] = (f"torch.sparse.mm(CSR float32, dense), once per head "
                     f"({H} calls)")
    torch.cuda.empty_cache()
    return ms, call


def gat_kernel_numbers(p, launches, device):
    """B3 at the main path's shapes, layers 1-2 (H=4, D=64) and layer 3
    (H=1, D=47) of the products GAT, and at PyG's ogbn-products GAT's
    (H=4 heads of D=128 in layers 1-2, of D=47 averaged in layer 3).  The
    wrapper is held against the plain version in three modes (alpha_src
    table; the in-kernel GATv1 projection, which GATConv uses; that with
    self loops, PyG's) and both dtypes; then the vec mode is timed at every
    shape in both dtypes, with self loops too at PyG's shapes, and the plain
    version at H=4, D=64 in float32 (the main path's widest call).  Returns
    the JSON row."""
    from tch_geometric_tpu_torch.ops.attention_blocked import (
        gat_attend_blocked_packed, gat_attend_blocked_packed_cuda)
    from tch_geometric_tpu_torch.utils.kernel_gates import (BF16_THRESHOLDS,
                                                            F32_THRESHOLD,
                                                            WIDE_VEC_B3)
    key = "gat_attend_blocked_packed_cuda"
    b = p["blocked"]
    n = p["x_table"].shape[0]
    T, C = b.edge_src.shape
    valid = int(b.edge_valid.sum())
    gen = torch.Generator().manual_seed(5)
    errs, ms, shapes = {}, {}, {}
    pyg = ((GAT_HEADS, 128), (GAT_HEADS, 47))
    for H, D in ((GAT_HEADS, 256 // GAT_HEADS), (1, 47)) + pyg:
        h = torch.randn((n, H, D), generator=gen).to(device)
        a_s = torch.randn((n, H), generator=gen).to(device)
        a_d = torch.randn((n, H), generator=gen).to(device)
        vec = (torch.randn((H, D), generator=gen) / D ** 0.5).to(device)
        for dt, thr in ((torch.float32, F32_THRESHOLD),
                        (torch.bfloat16, BF16_THRESHOLDS[key])):
            for mode, table, v in (("table", a_s, None), ("vec", None, vec),
                                   ("vec+self", None, vec)):
                if (dt == torch.bfloat16 and v is not None
                        and (H, D) in pyg):
                    thr = BF16_THRESHOLDS[WIDE_VEC_B3]
                kw = dict(alpha_src_vec=v, compute_dtype=dt,
                          self_loops=mode == "vec+self")
                got = gat_attend_blocked_packed_cuda(b, h, table, a_d, **kw)
                ref = gat_attend_blocked_packed(b, h, table, a_d, **kw)
                check(got.shape == ref.shape == (n, H, D),
                      f"B3 output shape {tuple(got.shape)}")
                e = errs[H, D, mode, str(dt)[6:]] = maxerr(got, ref)
                log(f"check: B3 wrapper vs plain at H={H} D={D} {mode} "
                    f"{str(dt)[6:]}: max |diff| {e:.3e} (limit {thr}; "
                    f"max |value| {float(ref.abs().max()):.3e})")
                check(e <= thr, f"B3 H={H} D={D} {mode} {dt}: {e:.3e}")
                del got, ref
            hc = h.to(dt)
            for self_loops in ((False, True) if (H, D) in pyg else (False,)):
                k = f"H{H}_D{D}_{str(dt)[6:]}" + ("_self" if self_loops
                                                  else "")
                shapes[k] = (H, D, hc.element_size())
                ms[k] = cuda_ms(
                    lambda: gat_attend_blocked_packed_cuda(
                        b, hc, None, a_d, alpha_src_vec=vec,
                        compute_dtype=dt, self_loops=self_loops), 10)
            del hc
        if H == GAT_HEADS and D == 256 // GAT_HEADS:
            main = (h, a_d, vec)
        del h, a_s, a_d
        torch.cuda.empty_cache()
    # split-row slots of the last call (the layout's, whatever H and D)
    slots = getattr(gat_attend_blocked_packed_cuda, "last_slots", None)
    h, a_d, vec = main
    H, D = h.shape[1:]
    plain_ms = cuda_ms(lambda: gat_attend_blocked_packed(
        b, h, None, a_d, alpha_src_vec=vec, compute_dtype=torch.float32), 2)
    def bound(H, D, eb):
        # bytes bound, counted as B1's: the kernel's inputs read once — h
        # in the compute dtype (eb bytes), the lane metadata (edge_src,
        # local_row; pad lanes included) and block_start, alpha_dst and the
        # projection vector — and the (B*W, H*D) float32 output written
        # once; operations on this run's data: per valid lane and head the
        # logit (add, leaky_relu, subtract, exp, the z add) and a
        # multiply-add per column, the projection's per node and column
        out_bytes = b.num_blocks * b.rows_per_block * H * D * 4
        in_bytes = (n * H * D * eb + T * C * 8 + b.block_start.numel() * 4
                    + n * H * 4 + H * D * 4)
        return ((in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3,
                (valid * H * (5 + 2 * D) + 2 * n * H * D) / F32_FLOP_PER_S
                * 1e3)

    bounds = {k: max(bound(*shapes[k])) for k in ms}
    t_bytes, t_ops = bound(H, D, 4)
    main_ms = ms[f"H{H}_D{D}_float32"]
    err32 = max(v for k, v in errs.items() if k[3] == "float32")
    err16 = max(v for k, v in errs.items() if k[3] == "bfloat16")
    log(f"kernel {key} (B3): T={T} C={C} H={H} D={D} lanes valid {valid}: "
        f"{main_ms:.3f} ms in float32 (bound {max(t_bytes, t_ops):.3f} ms "
        f"by {'bytes' if t_bytes >= t_ops else 'operations'}), plain "
        f"{plain_ms:.3f} ms; all timings (vec mode) {ms}, their bounds "
        f"{ {k: round(v, 3) for k, v in bounds.items()} }; launches on the "
        f"GAT path {launches[key]}; worst wrapper err f32 {err32:.2e} bf16 "
        f"{err16:.2e}; split-row slots {slots}")
    return dict(
        name=f"{key} (B3)", route="cuda",
        source="tch_geometric_tpu_torch/csrc/gat_blocked.cu",
        replaces="tch_geometric_tpu/ops/attention_blocked.py:765",
        launches=launches[key], max_abs_err=err32, ms=main_ms,
        plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, max_abs_err_bf16=err16, ms_by_shape=ms,
        bound_ms_by_shape=bounds, split_slots=slots,
        shape=dict(T=T, C=C, W=b.rows_per_block, H=H, D=D, N=n,
                   valid_lanes=valid, dtype="float32", mode="vec"),
        library_call=None)


ATTEND_WIDTHS = (100, 256)


def attend_routes():
    """The four single-head attention routes, each called as
    ``examples/gat_attention.py`` calls attention (x_dst = x_src)."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab
    return {
        "composed": lambda b, x, dt: ab.attend_blocked_cuda(
            b, x, x, compute_dtype=dt),
        "fused": lambda b, x, dt: ab.attend_blocked_fused_cuda(
            b, x, x, compute_dtype=dt),
        "flash_row": lambda b, x, dt: ab.attend_blocked_flash_cuda(
            b, x, x, compute_dtype=dt, row_stats=True),
        "flash_scalar": lambda b, x, dt: ab.attend_blocked_flash_cuda(
            b, x, x, compute_dtype=dt, row_stats=False),
    }


def attend_inputs(p, device):
    """The attend phase's features: the 100-column table and a seeded
    256-column embedding (the served models' hidden width)."""
    gen = torch.Generator().manual_seed(6)
    n = p["x_table"].shape[0]
    return {100: p["x_table"],
            256: torch.randn((n, 256), generator=gen).to(device)}


def serve_attend(p, xs, timer):
    """The attend path: every route over the full blocked layout, at both
    widths, in bfloat16 (the default compute dtype) and float32.  Each
    output is checked finite and (N, F); the float32 outputs are kept for
    the cross-route check."""
    b = p["blocked"]
    n = p["x_table"].shape[0]
    ms, outs = {}, {}
    with torch.no_grad():
        for width, x in xs.items():
            for dt in (torch.bfloat16, torch.float32):
                for name, fn in attend_routes().items():
                    out, t = timer(lambda: fn(b, x, dt))
                    check(out.shape == (n, width),
                          f"attend {name} F={width} shape {tuple(out.shape)}")
                    check(bool(torch.isfinite(out).all()),
                          f"attend {name} F={width} {dt} finite")
                    ms[f"{name}_F{width}_{str(dt)[6:]}"] = t
                    if dt == torch.float32:
                        outs[width, name] = out
    return dict(ms=ms, outs=outs)


def check_attend_routes(res):
    """The four routes agree with one another in float32."""
    from tch_geometric_tpu_torch.utils.kernel_gates import F32_THRESHOLD
    errs = {}
    for width in ATTEND_WIDTHS:
        ref = res["outs"][width, "composed"]
        for name in ("fused", "flash_row", "flash_scalar"):
            e = errs[f"{name}_vs_composed_F{width}"] = maxerr(
                res["outs"][width, name], ref)
            check(e <= F32_THRESHOLD,
                  f"attend {name} vs composed F={width}: {e:.3e}")
    log(f"check: attend routes agree in float32 (limit {F32_THRESHOLD}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return errs


def check_attend_subgraph(sub):
    """On the 5% node subgraph, each route in float32 against the segment-op
    reference: ``sddmm`` -> ``segment_softmax`` -> ``segment_sum``."""
    from tch_geometric_tpu_torch.ops.segment import (csr_row_ids,
                                                     segment_softmax,
                                                     segment_sum)
    from tch_geometric_tpu_torch.ops.spmm import sddmm
    from tch_geometric_tpu_torch.utils.kernel_gates import F32_THRESHOLD
    g, x, ns = sub["g"], sub["xs"], sub["ns"]
    rows = csr_row_ids(g.indptr, g.num_edges)
    with torch.no_grad():
        s = sddmm(g, x, x) / x.shape[1] ** 0.5
        att = segment_softmax(s, rows, ns)
        ref = segment_sum(x[g.indices] * att[:, None], rows, ns)
        errs = {name: maxerr(fn(sub["b"], x, torch.float32), ref)
                for name, fn in attend_routes().items()}
    log(f"check: subgraph attend vs segment ops f32 (limit {F32_THRESHOLD}; "
        f"max |value| {float(ref.abs().max()):.3e}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        check(v <= F32_THRESHOLD, f"subgraph attend {k} vs segment ops")
    return errs


def _nan_pads(b, s):
    return torch.where(b.edge_local_row < b.rows_per_block, s, float("nan"))


def attend_kernel_numbers(p, xs, launches, device):
    """B5, B6, B10 and B4 at the attend path's shapes.  Each wrapper is held
    against its plain version at F=100 and F=256 in bfloat16 and float32
    (B6 on the scaled scores of the same features, NaN in the pad lanes;
    B4 in both stat modes).  Then each is timed at F=256 in bfloat16 beside
    its bound, its plain version and, for B5 and B6, one PyTorch library
    call computing the same function (B5 also in float32, the dtype the
    library call takes; B6 also with every row block on its looped path,
    and the count of row blocks too large for its one-read path).  Returns
    the kernels' JSON rows."""
    from tch_geometric_tpu_torch.ops import attention_blocked as ab
    from tch_geometric_tpu_torch.utils.kernel_gates import (
        BF16_THRESHOLDS, F32_THRESHOLD, SDDMM_REL_THRESHOLD)
    b = p["blocked"]
    n = p["x_table"].shape[0]
    T, C = b.edge_src.shape
    W, B = b.rows_per_block, b.num_blocks
    valid = int(b.edge_valid.sum())
    specs = {
        "sddmm_blocked_cuda": (
            lambda x, dt, s: ab.sddmm_blocked_cuda(b, x, x, compute_dtype=dt),
            lambda x, dt, s: ab.sddmm_blocked(b, x, x, compute_dtype=dt)),
        "edge_softmax_blocked_cuda": (
            lambda x, dt, s: ab.edge_softmax_blocked_cuda(b, s),
            lambda x, dt, s: ab.edge_softmax_blocked(b, s)),
        "attend_blocked_fused_cuda": (
            lambda x, dt, s: ab.attend_blocked_fused_cuda(
                b, x, x, compute_dtype=dt),
            lambda x, dt, s: ab.attend_blocked_fused(
                b, x, x, compute_dtype=dt)),
        "attend_blocked_flash_cuda": (
            lambda x, dt, s: ab.attend_blocked_flash_cuda(
                b, x, x, compute_dtype=dt, row_stats=True),
            lambda x, dt, s: ab.attend_blocked_flash(
                b, x, x, compute_dtype=dt, row_stats=True)),
        "attend_blocked_flash_cuda[scalar]": (
            lambda x, dt, s: ab.attend_blocked_flash_cuda(
                b, x, x, compute_dtype=dt, row_stats=False),
            lambda x, dt, s: ab.attend_blocked_flash(
                b, x, x, compute_dtype=dt, row_stats=False)),
    }
    errs = {k: {} for k in specs}
    with torch.no_grad():
        for width, x in xs.items():
            for dt in (torch.bfloat16, torch.float32):
                s = _nan_pads(b, ab.sddmm_blocked(b, x, x, compute_dtype=dt)
                              / width ** 0.5)
                for key, (run, plain) in specs.items():
                    thr = (F32_THRESHOLD if dt == torch.float32 else
                           BF16_THRESHOLDS[key.split("[")[0]])
                    got, ref = run(x, dt, s), plain(x, dt, s)
                    check(got.shape == ref.shape,
                          f"{key} F={width} shape {tuple(got.shape)}")
                    e = errs[key][width, str(dt)[6:]] = maxerr(got, ref)
                    top = float(ref.abs().max())
                    if key == "sddmm_blocked_cuda":
                        # scores reach a few hundred (self loops at F=256):
                        # held relative to the largest score
                        thr = SDDMM_REL_THRESHOLD * max(top, 1.0)
                    log(f"check: {key} wrapper vs plain at F={width} "
                        f"{str(dt)[6:]}: max |diff| {e:.3e} (limit {thr:.3g}; "
                        f"max |value| {top:.3e})")
                    check(e <= thr, f"{key} F={width} {dt}: {e:.3e} > {thr}")
                    del got, ref
        F = 256
        xb = xs[F].to(torch.bfloat16)
        s16 = _nan_pads(b, ab.sddmm_blocked_cuda(b, xb, xb) / F ** 0.5)
        ms = {k: cuda_ms(lambda: run(xb, torch.bfloat16, s16), 10)
              for k, (run, _) in specs.items()}
        plain_ms = {k: cuda_ms(lambda: plain(xb, torch.bfloat16, s16), 2)
                    for k, (_, plain) in specs.items()}
        lib_ms, lib_call = _attend_library_ms(p, xb, s16, device)
        # B5 in float32 too, beside a library call that refuses bfloat16
        xf = xs[F].float()
        ms_b5_f32 = cuda_ms(lambda: ab.sddmm_blocked_cuda(
            b, xf, xf, compute_dtype=torch.float32), 10)
        del xf
        # B6 with every row block on its looped path (the first design's
        # three sweeps), and the row blocks too large for its one-read path
        ms_b6_looped = cuda_ms(lambda: ab._edge_softmax_launch(
            b, "tgt_edge_softmax_blocked", device, s16.data_ptr(),
            looped=True), 10)
        fast_lanes = ab.edge_softmax_fast_lanes()
        block_lanes = b.block_start.diff().long() * C
        oversized = int((block_lanes > fast_lanes).sum())

    # bytes bounds, counted as B1's: the function's inputs read once (x, the
    # one (N, F) bf16 input every timed call passes as both x_dst and x_src;
    # the lane metadata edge_src and local_row of every padded lane;
    # chunk_block, block_start or both) and its output written once; operations
    # on this run's valid lanes
    lanes, x_bytes = T * C, n * F * 2
    bound = {
        "sddmm_blocked_cuda": (x_bytes + lanes * 8 + T * 4 + lanes * 4,
                               valid * 2 * F),
        "edge_softmax_blocked_cuda": (lanes * 8 + (B + 1) * 4 + lanes * 4,
                                      valid * 6),
        "attend_blocked_fused_cuda": (
            x_bytes + lanes * 8 + T * 4 + (B + 1) * 4 + B * W * F * 4,
            valid * (4 * F + 6)),
        "attend_blocked_flash_cuda": (
            x_bytes + lanes * 8 + (B + 1) * 4 + B * W * F * 4,
            valid * (4 * F + 6)),
    }
    info = {
        "sddmm_blocked_cuda": ("B5", ":54"),
        "edge_softmax_blocked_cuda": ("B6", ":177"),
        "attend_blocked_fused_cuda": ("B10", ":1057"),
        "attend_blocked_flash_cuda": ("B4", ":1147"),
    }
    rows = []
    for key, (label, line) in info.items():
        by, ops = bound[key]
        t_bytes = by / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_FLOP_PER_S * 1e3
        both = [errs[k] for k in (key, key + "[scalar]") if k in errs]
        e16, e32 = (max(v for e in both for (_, d), v in e.items() if d == dt)
                    for dt in ("bfloat16", "float32"))
        row = dict(
            name=f"{key} ({label})", route="cuda",
            source="tch_geometric_tpu_torch/csrc/attend_blocked.cu",
            replaces=f"tch_geometric_tpu/ops/attention_blocked.py{line}",
            launches=launches[key], max_abs_err=e16, ms=ms[key],
            plain_ms=plain_ms[key], bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=lib_ms.get(key), library_call=lib_call.get(key),
            max_abs_err_f32=e32,
            shape=dict(T=T, C=C, W=W, F=F, N=n, valid_lanes=valid,
                       dtype="bfloat16"))
        if key == "attend_blocked_flash_cuda":
            # the split-row slots of the last timed call (F=256 bf16): each
            # holds its row, m, z and F float32 sums
            slots = ab.attend_blocked_flash_cuda.last_slots
            row.update(ms_scalar=ms[key + "[scalar]"],
                       plain_ms_scalar=plain_ms[key + "[scalar]"],
                       split_slots=slots,
                       split_scratch_bytes=slots * (F + 3) * 4)
        if key == "sddmm_blocked_cuda":
            # float32 rows: x read as 4 bytes an element
            row.update(ms_f32=ms_b5_f32, bound_ms_f32=max(
                (by + n * F * 2) / HBM_BYTES_PER_S * 1e3, t_ops))
        if key == "edge_softmax_blocked_cuda":
            row.update(ms_looped=ms_b6_looped, fast_lanes=fast_lanes,
                       oversized_blocks=oversized,
                       max_block_lanes=int(block_lanes.max()))
        rows.append(row)
        log(f"kernel {key} ({label}): T={T} C={C} F={F} lanes valid {valid}: "
            f"{ms[key]:.3f} ms (bound {max(t_bytes, t_ops):.3f} ms), plain "
            f"{plain_ms[key]:.3f} ms, library {lib_ms.get(key)} "
            f"({lib_call.get(key)}), launches on the attend path "
            f"{launches[key]}, worst wrapper err bf16 {e16:.2e} f32 "
            f"{e32:.2e}"
            + (f"; scalar stats {ms[key + '[scalar]']:.3f} ms, plain "
               f"{plain_ms[key + '[scalar]']:.3f} ms; split-row slots "
               f"{row['split_slots']} ({row['split_scratch_bytes'] / 1e9:.3f}"
               f" GB)" if key == "attend_blocked_flash_cuda" else "")
            + (f"; float32 rows {ms_b5_f32:.3f} ms (bound "
               f"{row['bound_ms_f32']:.3f} ms)"
               if key == "sddmm_blocked_cuda" else "")
            + (f"; every row block looped {ms_b6_looped:.3f} ms; row blocks "
               f"over the one-read path's {fast_lanes} lanes: {oversized} of "
               f"{B} (largest {int(block_lanes.max())} lanes)"
               if key == "edge_softmax_blocked_cuda" else ""))
    return rows


def _attend_library_ms(p, xb, s16, device):
    """Library yardsticks on the graph's coalesced edges (A[dst, src]):
    ``torch.sparse.sampled_addmm`` for B5 (bfloat16, or float32 where
    bfloat16 is refused) and ``torch.sparse.softmax`` of a COO tensor of
    float32 scores for B6.  Returns ({kernel: ms}, {kernel: call})."""
    n = xb.shape[0]
    ptr, col, _ = _coalesced_csr(p["col_ptrs"], p["row_indices"], n, device)
    ms, call = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        x = xb.to(dt)
        pattern = torch.sparse_csr_tensor(
            ptr, col, torch.zeros(col.shape, dtype=dt, device=device),
            size=(n, n))
        try:
            ms["sddmm_blocked_cuda"] = cuda_ms(
                lambda: torch.sparse.sampled_addmm(pattern, x, x.t(),
                                                   beta=0.0), 10)
            call["sddmm_blocked_cuda"] = (
                f"torch.sparse.sampled_addmm(CSR {str(dt)[6:]}, x, x.T)")
            break
        except RuntimeError as exc:
            log(f"library: sampled_addmm in {dt} refused: "
                f"{str(exc).splitlines()[0]}")
    rows = torch.repeat_interleave(torch.arange(n, device=device), ptr.diff())
    vals = torch.randn(col.shape, generator=torch.Generator().manual_seed(8)
                       ).to(device)
    coo = torch.sparse_coo_tensor(torch.stack([rows, col]), vals, (n, n),
                                  is_coalesced=True)
    try:
        ms["edge_softmax_blocked_cuda"] = cuda_ms(
            lambda: torch.sparse.softmax(coo, dim=1), 10)
        call["edge_softmax_blocked_cuda"] = \
            "torch.sparse.softmax(COO float32, dim=1)"
    except RuntimeError as exc:
        log(f"library: sparse softmax refused: {str(exc).splitlines()[0]}")
    return ms, call


def _csr(ptr, col, val, size):
    """(float32, bfloat16) torch CSR matrices of the same entries."""
    return tuple(torch.sparse_csr_tensor(ptr, col, val.to(dt), size=size,
                                         check_invariants=True)
                 for dt in (torch.float32, torch.bfloat16))


def _coalesced_csr(col_ptrs, row_indices, n, device):
    """The graph as CSR arrays of A[dst, src] = edge multiplicity (torch's
    CSR needs distinct column indices per row)."""
    cp = torch.from_numpy(col_ptrs).to(device)
    ri = torch.from_numpy(row_indices).to(device)
    dst = torch.repeat_interleave(torch.arange(n, device=device), cp.diff())
    uk, cnt = torch.unique_consecutive(dst * n + ri, return_counts=True)
    ptr = torch.zeros(n + 1, dtype=torch.long, device=device)
    ptr[1:] = torch.bincount(uk // n, minlength=n).cumsum(0)
    return ptr, uk % n, cnt.float()


def _lanes_to_csr(b, values, n):
    """A BlockedCsr's valid lanes as (n, K) CSR arrays ``(ptr, col, val)``:
    lane values go back to CSR edge order through ``edge_ptr``; row counts
    are the layout's degrees."""
    valid = b.edge_valid
    ep = b.edge_ptr[valid].long()
    col = torch.empty_like(ep)
    col[ep] = b.edge_src[valid].long()
    val = torch.empty(ep.shape, dtype=torch.float32, device=ep.device)
    val[ep] = values[valid]
    ptr = torch.zeros(n + 1, dtype=torch.long, device=ep.device)
    ptr[1:] = b.degree.long().cumsum(0)
    return ptr, col, val


Q8_WIDTHS = (100, 256)


def serve_q8(p, device, timer):
    """B11's path on the SAGE layout: ``quantize_rows`` and
    ``spmm_blocked_q8_cuda(agg="mean")`` on the 100 features and a seeded
    256-column embedding.  Returns ``{F: (x, q, scale, out, quantize ms,
    spmm ms)}``."""
    from tch_geometric_tpu_torch.ops.spmm_kernels import (quantize_rows,
                                                          spmm_blocked_q8_cuda)
    n = p["x_table"].shape[0]
    gen = torch.Generator().manual_seed(10)
    xs = {100: p["x_table"],
          256: torch.randn((n, 256), generator=gen).to(device)}
    res = {}
    with torch.no_grad():
        for F, x in xs.items():
            (q, s), t_q = timer(lambda: quantize_rows(x))
            out, t = timer(lambda: spmm_blocked_q8_cuda(p["blocked"], q, s,
                                                        agg="mean"))
            res[F] = (x, q, s, out, t_q, t)
    return res


def q8_kernel_numbers(p, res, launches):
    """B11 at both widths: the output checked finite and (N, F), held
    against the plain version (float32, 5e-4) and against B1 on the
    unquantised rows in float32 (``Q8_REL_THRESHOLD`` of the largest
    value); then B11, B1 (bfloat16 and float32 rows) and B11's plain
    version timed at each width.  Returns the JSON row (F=256)."""
    from tch_geometric_tpu_torch.ops.spmm_kernels import (_launch,
                                                          spmm_blocked_cuda,
                                                          spmm_blocked_q8)
    from tch_geometric_tpu_torch.utils.kernel_gates import (
        F32_THRESHOLD, Q8_REL_THRESHOLD)
    key = "spmm_blocked_q8_cuda"
    b = p["blocked"]
    n = p["x_table"].shape[0]
    T, C = b.edge_src.shape
    W, B = b.rows_per_block, b.num_blocks
    valid = int(b.edge_valid.sum())
    errs, rel, ms, b1_ms, plain_ms = {}, {}, {}, {}, {}
    with torch.no_grad():
        for F, (x, q, s, out, t_q, t) in res.items():
            check(out.shape == (n, F), f"B11 F={F} shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"B11 F={F} finite")
            e = errs[F] = maxerr(out, spmm_blocked_q8(b, q, s, agg="mean"))
            b1 = spmm_blocked_cuda(b, x, agg="mean",
                                   compute_dtype=torch.float32)
            top = float(b1.abs().max())
            r = rel[F] = maxerr(out, b1) / top
            del b1
            log(f"check: B11 at F={F}: vs plain max |diff| {e:.3e} (limit "
                f"{F32_THRESHOLD}); vs B1 f32 on the unquantised rows "
                f"{r:.3e} of the largest value {top:.3e} (limit "
                f"{Q8_REL_THRESHOLD}); quantize_rows {t_q:.1f} ms, first "
                f"call {t:.1f} ms")
            check(e <= F32_THRESHOLD, f"B11 F={F} vs plain: {e:.3e}")
            check(r <= Q8_REL_THRESHOLD, f"B11 F={F} vs B1: {r:.3e}")
            ms[F] = cuda_ms(lambda: _launch(b, q, None, s), 10)
            for dt in (torch.bfloat16, torch.float32):
                xc = x.to(dt)
                b1_ms[F, str(dt)[6:]] = cuda_ms(lambda: _launch(b, xc, None),
                                                10)
                del xc
            plain_ms[F] = cuda_ms(lambda: spmm_blocked_q8(b, q, s, agg="sum"),
                                  2)
    def bound(F):
        # bytes bound: q and its scales, the lane metadata and block_start
        # read once, the (B*W, F) float32 output written once; operations:
        # a multiply-add per valid lane and column
        by = n * F + n * 4 + T * C * 8 + (B + 1) * 4 + B * W * F * 4
        return (by / HBM_BYTES_PER_S * 1e3,
                valid * F * 2 / F32_FLOP_PER_S * 1e3)

    bounds = {f: max(bound(f)) for f in ms}
    F = 256
    t_bytes, t_ops = bound(F)
    log(f"kernel {key} (B11): T={T} C={C} lanes valid {valid}: "
        + ", ".join(f"F={f} {ms[f]:.3f} ms (B1 bf16 {b1_ms[f, 'bfloat16']:.3f}"
                    f", f32 {b1_ms[f, 'float32']:.3f}; plain "
                    f"{plain_ms[f]:.3f}; bound {bounds[f]:.3f})" for f in ms)
        + f"; launches on the int8 path {launches[key]}")
    return dict(
        name=f"{key} (B11)", route="cuda",
        source="tch_geometric_tpu_torch/csrc/spmm_blocked.cu",
        replaces="tch_geometric_tpu/ops/spmm_pallas.py:230",
        launches=launches[key], max_abs_err=max(errs.values()), ms=ms[F],
        plain_ms=plain_ms[F], bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, library_call=None,
        rel_err_vs_b1_f32=max(rel.values()),
        ms_by_width={f: v for f, v in ms.items()}, bound_ms_by_width=bounds,
        plain_ms_by_width={f: v for f, v in plain_ms.items()},
        b1_ms_by_width={f"{f}_{d}": v for (f, d), v in b1_ms.items()},
        shape=dict(T=T, C=C, W=W, F=F, N=n, valid_lanes=valid, dtype="int8"))


TRAIN_LR = 1e-3
TRAIN_DROPOUT = 0.5
TRAIN_STEPS = 10
FIT_STEPS = 20
MULTIBATCH_M = 8
MULTIBATCH_CALLS = 3
CARD_VS_CPU_STEPS = 3
TRAIN_REL_THRESHOLD = 1e-3
SPANS = ("sample", "gather", "forward", "update")
PROFILE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")


def train_model(kind, f, device):
    """Phase 7's models at the serving width (hidden 256, 3 layers, 47
    classes, dropout 0.5), weights from ``torch.Generator().manual_seed(0)``:
    ``kind`` "sage" or "gat" (4 heads)."""
    from tch_geometric_tpu_torch.models import GAT, GraphSAGE
    kw = dict(dropout=TRAIN_DROPOUT, device=device,
              generator=torch.Generator().manual_seed(0))
    if kind == "gat":
        return GAT(f, 256, 47, 3, heads=GAT_HEADS, **kw)
    return GraphSAGE(f, 256, 47, 3, **kw)


def train(p, device, timer):
    """Phase 7 (a), (b): for SAGE and GAT (dropout 0.5, Adam at 1e-3), one
    warm-up step and ``TRAIN_STEPS`` timed steps of 1024 random seeds, each
    ending in a synchronise; peak device memory over them; then
    ``FIT_STEPS`` steps on one fixed batch, whose deterministic loss
    (``eval_step``, one key) must fall.  Returns the per-model results and
    the trainers with their states (phase 8 profiles SAGE's)."""
    from tch_geometric_tpu_torch.parallel import make_gnn_trainer
    from tch_geometric_tpu_torch.sampling import rng
    graph, x_table = p["graph"], p["x_table"]
    n = x_table.shape[0]
    labels = torch.from_numpy(p["data"].y).to(device)
    gen = torch.Generator().manual_seed(12)
    key = rng.key(11)
    out, trainers = {}, {}
    for name in ("sage", "gat"):
        model = train_model(name, x_table.shape[1], device)
        trainer = make_gnn_trainer(model, FANOUTS, learning_rate=TRAIN_LR)
        state = trainer.init_fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses = [], []
        for _ in range(1 + TRAIN_STEPS):
            seeds = torch.randint(0, n, (SEEDS_PER_REQUEST,),
                                  generator=gen).to(device)
            (state, loss, acc), t = timer(lambda: trainer.train_step(
                state, key, graph, x_table, seeds, labels[seeds]))
            ms.append(t)
            losses.append(float(loss))
            check(np.isfinite(losses[-1]), f"{name} train loss finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        seeds = torch.randint(0, n, (SEEDS_PER_REQUEST,),
                              generator=gen).to(device)
        fit_key = rng.key(13)
        before = float(trainer.eval_step(state, fit_key, graph, x_table,
                                         seeds, labels[seeds])[0])
        for _ in range(FIT_STEPS):
            state, _, _ = trainer.train_step(state, key, graph, x_table,
                                             seeds, labels[seeds])
        after = float(trainer.eval_step(state, fit_key, graph, x_table,
                                        seeds, labels[seeds])[0])
        steady = float(np.mean(ms[1:]))
        log(f"train {name}: step ms (first, warm-up) {ms[0]:.1f}, then "
            + ", ".join(f"{m:.1f}" for m in ms[1:])
            + f"; mean {steady:.2f} ms a step of {SEEDS_PER_REQUEST} seeds; "
            f"peak device memory {peak:.2f} GiB; losses "
            + ", ".join(f"{v:.3f}" for v in losses)
            + f"; {FIT_STEPS} steps on one batch: eval loss {before:.4f} -> "
            f"{after:.4f}")
        check(after < before, f"{name}: {FIT_STEPS} steps on one batch lower "
              f"its loss ({before:.4f} -> {after:.4f})")
        out[name] = dict(step_ms=ms[1:], first_step_ms=ms[0],
                         step_ms_mean=steady, peak_device_gib=peak,
                         losses=losses, fit_loss_before=before,
                         fit_loss_after=after)
        trainers[name] = (trainer, state)
    return out, trainers


def train_multibatch(p, device, timer):
    """Phase 7 (c): ``make_multibatch_sage_trainer`` at M=8 on bfloat16
    features and a bfloat16 SAGE (``scripts/bench_sampled_training.py``'s
    configuration: no dropout, Adam at 1e-3), one warm-up call, then
    ``MULTIBATCH_CALLS`` timed calls of 8 x 1024 seeds."""
    from tch_geometric_tpu_torch.models import GraphSAGE
    from tch_geometric_tpu_torch.parallel import make_multibatch_sage_trainer
    from tch_geometric_tpu_torch.sampling import rng
    graph = p["graph"]
    x16 = p["x_table"].to(torch.bfloat16)
    n = x16.shape[0]
    labels = torch.from_numpy(p["data"].y).to(device)
    model = GraphSAGE(x16.shape[1], 256, 47, 3, dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(0),
                      device=device)
    trainer = make_multibatch_sage_trainer(model, FANOUTS,
                                           learning_rate=TRAIN_LR)
    state = trainer.init_fn()
    gen = torch.Generator().manual_seed(14)
    key = rng.key(15)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(1 + MULTIBATCH_CALLS):
        seeds = torch.randint(0, n, (MULTIBATCH_M, SEEDS_PER_REQUEST),
                              generator=gen).to(device)
        (state, ls, _), t = timer(lambda: trainer.train_step(
            state, key, graph, x16, seeds, labels[seeds]))
        check(ls.shape == (MULTIBATCH_M,) and ls.dtype == torch.bfloat16,
              f"multibatch losses {tuple(ls.shape)} {ls.dtype}")
        check(bool(torch.isfinite(ls).all()), "multibatch losses finite")
        ms.append(t)
        losses += ls.float().tolist()
    peak = torch.cuda.max_memory_allocated() / 2**30
    per = [t / MULTIBATCH_M for t in ms[1:]]
    log(f"train multibatch M={MULTIBATCH_M} bf16: call ms (first, warm-up) "
        f"{ms[0]:.1f}, then " + ", ".join(f"{t:.1f}" for t in ms[1:])
        + f"; {float(np.mean(per)):.2f} ms a minibatch of "
        f"{SEEDS_PER_REQUEST} seeds; peak device memory {peak:.2f} GiB; "
        f"losses {losses[0]:.3f} .. {losses[-1]:.3f}")
    return dict(call_ms=ms[1:], first_call_ms=ms[0],
                ms_per_minibatch=float(np.mean(per)), peak_device_gib=peak,
                losses=losses)


def check_train_card_vs_cpu(data, sub, device):
    """Phase 7 (d): on the 5% node subgraph, ``CARD_VS_CPU_STEPS`` steps of
    phase 7 (a)'s SAGE trainer from the same parameters, key and seeds on
    the card and on the CPU.  The samples and dropout masks are bit-equal
    (threefry on either device), so the losses agree within
    ``TRAIN_REL_THRESHOLD`` relative; the largest parameter difference is
    printed."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.parallel import make_sage_trainer
    from tch_geometric_tpu_torch.sampling import rng
    ns = sub["ns"]
    card = train_model("sage", data.x.shape[1], device)
    cpu = copy.deepcopy(card).cpu()
    g_cpu = make_graph(sub["cp"], sub["ri"], num_src=ns, num_dst=ns,
                       device="cpu")
    ys = torch.from_numpy(data.y[sub["keep"]])
    seeds = torch.from_numpy(np.random.default_rng(16).integers(
        0, ns, (CARD_VS_CPU_STEPS, SEEDS_PER_REQUEST)))
    key = rng.key(17)
    res = {}
    for side, model, g, xs, dev in (("card", card, sub["g"], sub["xs"], device),
                                    ("cpu", cpu, g_cpu, sub["xs"].cpu(),
                                     torch.device("cpu"))):
        trainer = make_sage_trainer(model, FANOUTS, learning_rate=TRAIN_LR)
        state = trainer.init_fn()
        y, losses = ys.to(dev), []
        t = time.perf_counter()
        for s in seeds:
            s = s.to(dev)
            state, loss, _ = trainer.train_step(state, key, g, xs, s, y[s])
            losses.append(float(loss))
        res[side] = (losses, time.perf_counter() - t)
    (lc, tc), (lh, th) = res["card"], res["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    pdiff = max(maxerr(a, b.to(device)) for a, b in
                zip(card.state_dict().values(), cpu.state_dict().values()))
    log(f"check: train card vs CPU on the {ns}-node subgraph, "
        f"{CARD_VS_CPU_STEPS} steps of {SEEDS_PER_REQUEST} seeds (dropout "
        f"{TRAIN_DROPOUT}): losses card {lc}, CPU {lh}; largest relative "
        f"difference {rel:.3e} (limit {TRAIN_REL_THRESHOLD}); parameters max "
        f"|diff| {pdiff:.3e}; card {tc:.2f} s, CPU {th:.2f} s")
    check(rel <= TRAIN_REL_THRESHOLD, f"train losses card vs CPU: {rel:.3e}")
    return dict(losses_card=lc, losses_cpu=lh, max_rel_loss_diff=rel,
                max_param_diff=pdiff, card_s=tc, cpu_s=th)


def profile_split(prof, window: str):
    """Device time of the profiled ``window`` span: each kernel (and copy)
    is assigned to the innermost ``SPANS`` span whose host interval holds
    its launch (any thread: autograd runs the backward on its own), else
    to "other"; the top 10 device operations by their own time, with
    counts; and the device idle share, 1 - (union of the device intervals
    in the window) / (the window's wall time).  Read from the profiler's
    ``events()``, whose parse takes minutes over an HGT step; phase 8
    holds :func:`trace_split`, which every window uses, against it."""
    from torch.autograd import DeviceType
    evs = prof.events()
    cpu = [(e.name, e.time_range.start, e.time_range.end, e.id,
            getattr(e, "is_user_annotation", False))
           for e in evs if e.device_type == DeviceType.CPU]
    annotations = {c[0] for c in cpu if c[4]}
    annotations.update(SPANS + (window,))
    dev = [(e.name, e.time_range.start, e.time_range.end, e.id) for e in evs
           if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and e.name not in annotations]
    return _split(cpu, dev, window)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def trace_split(logdir: str, window: str):
    """:func:`profile_split`'s numbers from the Chrome trace that
    ``utils.metrics.profile`` wrote to ``logdir``: the device events are
    its kernel, memcpy and memset records, a launch is the host runtime
    call with the same correlation id."""
    with open(os.path.join(logdir, "trace.json")) as f:
        evs = json.load(f)["traceEvents"]
    cpu, dev = [], []
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, t0 = e.get("cat"), float(e["ts"])
        t1 = t0 + float(e["dur"])
        corr = e.get("args", {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((e["name"], t0, t1, corr))
        elif cat in HOST_CATS:
            cpu.append((e["name"], t0, t1, corr, cat == "user_annotation"))
    return _split(cpu, dev, window)


def _split(cpu, dev, window: str):
    """The split of :func:`profile_split` from host records ``(name,
    start, end, correlation, is_annotation)`` and device records ``(name,
    start, end, correlation)``, times in microseconds."""
    win = [c for c in cpu if c[0] == window]
    check(len(win) == 1, f"profile: one {window} span, found {len(win)}")
    w0, w1 = win[0][1], win[0][2]
    check(len(dev) > 0, "profile: the profiler recorded device activity")
    launch = {c[3]: c[1] for c in cpu if c[0].startswith("cu")}
    spans = sorted(((c[1], c[2], c[0]) for c in cpu if c[0] in SPANS),
                   key=lambda s: s[0])
    by_span = {s: 0.0 for s in SPANS + ("other", "unattributed")}
    ops = {}
    for name, start, end, corr in dev:
        d = end - start
        t = launch.get(corr)
        if t is None:
            where = "unattributed"
        else:
            inner = [s for s in spans if s[0] <= t <= s[1]]
            where = (min(inner, key=lambda s: s[1] - s[0])[2] if inner
                     else "other")
        by_span[where] += d
        tot, cnt = ops.get(name, (0.0, 0))
        ops[name] = (tot + d, cnt + 1)
    iv = sorted((max(start, w0), min(end, w1)) for _, start, end, _ in dev)
    busy, cur_s, cur_e = 0.0, None, None
    for s, t in iv:
        if t <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        busy += cur_e - cur_s
    wall = w1 - w0
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])[:10]
    return dict(window_ms=wall / 1e3, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / wall, device_events=len(dev),
                device_ms_by_span={k: v / 1e3 for k, v in by_span.items()},
                device_ms_total=sum(by_span.values()) / 1e3,
                top10=[dict(name=k, ms=v[0] / 1e3, count=v[1])
                       for k, v in top])


SPLIT_RTOL = 1e-4               # trace vs events split, of the device total


def check_same_split(a, b, name: str) -> None:
    """The trace's split equals the events' split: the same window, busy
    time, device time in all and by span, within 1 us plus ``SPLIT_RTOL``
    of the device total (an HGT step's split differed by 4 us of 100-odd
    ms: `PERF.md` §5)."""
    keys = ["window_ms", "device_busy_ms", "device_ms_total"]
    pairs = [(k, a[k], b[k]) for k in keys] + [
        (k, a["device_ms_by_span"][k], b["device_ms_by_span"][k])
        for k in b["device_ms_by_span"]]
    worst = max(pairs, key=lambda t: abs(t[1] - t[2]))
    diff = abs(worst[1] - worst[2])
    limit = 1e-3 + SPLIT_RTOL * b["device_ms_total"]
    log(f"check: profile {name}, the Chrome trace's split against "
        f"prof.events()': largest difference {diff:.2e} ms ({worst[0]}: "
        f"{worst[1]:.4f} / {worst[2]:.4f}; limit {limit:.2e}); device "
        f"events {a['device_events']} / {b['device_events']}")
    check(diff <= limit, f"profile {name}: trace and events splits agree "
          f"({diff:.2e} ms)")


def short_op(name: str) -> str:
    """A kernel's name without its template noise: the kernel and, for
    PyTorch's elementwise kernels, the functor it applies."""
    base = (name.replace("void ", "").replace("(anonymous namespace)::", "")
            .split("(")[0].split("<")[0])
    inner = re.findall(r"([A-Za-z_]\w*(?:Functor|_kernel_cuda)\w*(?:<\w+>)?)",
                       name)
    return f"{base}[{inner[-1]}]" if inner else base[:90]


def profile_phase(p, trainers, device):
    """Phase 8: ``torch.profiler`` (through ``utils.metrics.profile``) over
    3 SAGE train steps (phase 7's trainer and state), 3 sampled SAGE
    requests and one SAGE ``blocked_forward``, each its own profile with
    its Chrome trace under ``build/profile/``.  Each window ends in a
    synchronise."""
    from tch_geometric_tpu_torch.parallel import make_gnn_trainer
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.utils.metrics import profile, trace_span
    graph, x_table, model = p["graph"], p["x_table"], p["model"]
    n = x_table.shape[0]
    labels = torch.from_numpy(p["data"].y).to(device)
    gen = torch.Generator().manual_seed(18)
    trainer, state = trainers["sage"]
    serve_trainer = make_gnn_trainer(model, FANOUTS)

    def train_steps():
        nonlocal state
        for i in range(3):
            seeds = torch.randint(0, n, (SEEDS_PER_REQUEST,),
                                  generator=gen).to(device)
            state, _, _ = trainer.train_step(state, rng.key(19), graph,
                                             x_table, seeds, labels[seeds])

    @torch.no_grad()
    def requests():
        for i in range(3):
            seeds = torch.randint(0, n, (SEEDS_PER_REQUEST,), generator=gen)
            sample, x = serve_trainer.sample_and_gather(
                rng.fold(rng.key(20), i), graph, x_table, seeds)
            with trace_span("forward"):
                model.tree_forward(sample, x)

    @torch.no_grad()
    def blocked():
        with trace_span("forward"):
            model.blocked_forward(x_table, p["blocked"])

    out = {}
    for name, fn in (("sage_train_3_steps", train_steps),
                     ("sage_requests_3", requests),
                     ("sage_blocked_forward", blocked)):
        torch.cuda.synchronize()
        logdir = os.path.join(PROFILE_DIR, name)
        with profile(logdir) as prof:
            with trace_span("window"):
                fn()
                torch.cuda.synchronize()
        r = out[name] = trace_split(logdir, "window")
        if name == "sage_train_3_steps":
            check_same_split(r, profile_split(prof, "window"), name)
        log(f"profile {name}: window {r['window_ms']:.2f} ms, device busy "
            f"{r['device_busy_ms']:.2f} ms, idle share {r['idle_share']:.3f}; "
            "device ms by span: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["device_ms_by_span"].items())
            + "; top 10 device ops by own time: " + "; ".join(
                f"{short_op(o['name'])} x{o['count']} {o['ms']:.3f} ms"
                for o in r["top10"]))
    return out


# ---------------------------------------------------------------------------
# Phase 9: weighted, temporal and heterogeneous neighbor sampling
# ---------------------------------------------------------------------------

SAMPLER_CONFIGS = ("weighted", "weighted_replace", "temporal_static",
                   "temporal_relative", "temporal_dynamic")
TEMPORAL_WINDOW = (0, 400)
TIME_RANGE = 1000               # edge timestamps and seed states in [0, 1000)
GUMBEL_RATE_LIMIT = 1e-4        # card vs CPU: differing valid slots / valid
GUMBEL_RTOL = 4e-7              # tests/test_torch_rng.py's limit
GUMBEL_ATOL = 1e-6
CUT_WINDOW = 16                 # (c)'s window engines: several chunks
# ogbn-mag as OGB publishes it: node counts, and the four relations with
# their edge counts; each relation but cites also runs reversed
MAG_NODES = {"paper": 736_389, "author": 1_134_649, "institution": 8_740,
             "field_of_study": 59_965}
MAG_RELATIONS = ((("author", "writes", "paper"), 7_145_660),
                 (("paper", "cites", "paper"), 5_416_271),
                 (("paper", "has_topic", "field_of_study"), 7_505_078),
                 (("author", "affiliated_with", "institution"), 1_043_998))
MAG_FANOUTS = [15, 10]
HETERO_CONFIGS = ("uniform", "weighted", "weighted_replace",
                  "temporal_dynamic")
# scripts/bench_samplers.py's hetero configuration
BENCH_TYPES, BENCH_NODES, BENCH_EDGES = ("v0", "v1", "v2"), 50_000, 300_000
BENCH_PAIRS = (("v0", "v1"), ("v1", "v0"), ("v1", "v2"), ("v2", "v1"),
               ("v0", "v2"), ("v2", "v0"))
BENCH_FANOUTS, BENCH_SEEDS = [5, 5], 256


def sampler_kwargs(cfg, weights, timestamps, states):
    """``sample_neighbors`` / ``sample_hetero_neighbors`` keyword arguments
    of configuration ``cfg``: "uniform" (without replacement), "weighted"
    (``weights``, with or without replacement) or "temporal_<mode>"
    (uniform draws among the edges whose ``timestamps`` pass the forward
    window ``TEMPORAL_WINDOW`` against the parents' ``states``)."""
    from tch_geometric_tpu_torch.utils import config as c
    if cfg == "uniform":
        return dict(sampler=c.UniformEdgeSampler(False))
    if cfg.startswith("weighted"):
        return dict(sampler=c.WeightedEdgeSampler(
            weights, with_replacement=cfg == "weighted_replace"))
    mode = {"temporal_static": c.TEMPORAL_SAMPLE_STATIC,
            "temporal_relative": c.TEMPORAL_SAMPLE_RELATIVE,
            "temporal_dynamic": c.TEMPORAL_SAMPLE_DYNAMIC}[cfg]
    return dict(filter=(c.TemporalEdgeFilter(TEMPORAL_WINDOW, timestamps,
                                             True, mode), states))


def edge_values(num_edges, seed, device):
    """Per-edge weights ``|N(0, 1)| + 0.1`` (float32, as
    ``scripts/bench_samplers.py`` makes them) and int64 timestamps in
    ``[0, TIME_RANGE)``, from ``seed``."""
    r = np.random.default_rng(seed)
    w = np.abs(r.normal(size=num_edges)).astype(np.float32) + 0.1
    ts = r.integers(0, TIME_RANGE, num_edges)
    return torch.from_numpy(w).to(device), torch.from_numpy(ts).to(device)


def check_edges(what, cfg, indptr, indices, src_nodes, dst_nodes, src_state,
                dst_state, rows, cols, eptr, edge_valid, timestamps):
    """Every valid edge of one relation is real (``indices[eptr]`` is its
    child, ``eptr`` in its parent's window); a temporal edge passes the
    window against its parent's state; in DYNAMIC mode the child's state
    is the edge's timestamp.  Returns the number of valid edges."""
    e = eptr[edge_valid]
    child, parent = src_nodes[rows[edge_valid]], dst_nodes[cols[edge_valid]]
    check(torch.equal(indices[e], child), f"{what}: every valid edge is real")
    check(bool(((e >= indptr[parent]) & (e < indptr[parent + 1])).all()),
          f"{what}: every edge lies in its parent's window")
    if cfg.startswith("temporal"):
        t = timestamps[e]
        d = t if cfg == "temporal_static" else t - dst_state[cols[edge_valid]]
        lo, hi = TEMPORAL_WINDOW
        check(bool(((d >= lo) & (d <= hi)).all()),
              f"{what}: every edge passes the temporal window")
        if cfg == "temporal_dynamic":
            check(torch.equal(src_state[rows[edge_valid]], t),
                  f"{what}: a child's state is its edge's timestamp")
    return int(e.shape[0])


def hop_valid_shares(sample):
    nb = sample.node_base
    return [float(sample.node_valid[nb[i + 1]:nb[i + 2]].float().mean())
            for i in range(len(nb) - 2)]


def sampling_requests(p, device, timer):
    """Phase 9 (a): for each configuration of ``SAMPLER_CONFIGS`` on the
    products graph, ``REQUESTS`` requests of 1024 seeds (the first a
    warm-up): ``sample_neighbors``, feature gather, ``tree_forward``; ms per
    request, the valid share per hop, peak device memory; each request's
    edges checked and its logits finite."""
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.sampling.neighbor import sample_neighbors
    model, graph, x_table = p["model"], p["graph"], p["x_table"]
    n = x_table.shape[0]
    weights, ts = edge_values(graph.num_edges, 21, device)
    out = {}
    with torch.no_grad():
        for cfg in SAMPLER_CONFIGS:
            gen = torch.Generator().manual_seed(22)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, shares = [], []
            for r in range(REQUESTS):
                seeds = torch.randint(0, n, (SEEDS_PER_REQUEST,),
                                      generator=gen).to(device)
                states = torch.randint(0, TIME_RANGE, (SEEDS_PER_REQUEST,),
                                       generator=gen).to(device)
                kw = sampler_kwargs(cfg, weights, ts, states)
                key = rng.fold(rng.key(23), r)

                def request():
                    s = sample_neighbors(graph, seeds, FANOUTS, key=key, **kw)
                    x = x_table[s.nodes.clamp(0, n - 1)]
                    return s, model.tree_forward(s, x)
                (s, logits), t = timer(request)
                ms.append(t)
                check(logits.shape == (SEEDS_PER_REQUEST, 47)
                      and bool(torch.isfinite(logits).all()),
                      f"{cfg} request logits finite, (1024, 47)")
                check_edges(f"{cfg} request {r}", cfg, graph.indptr,
                            graph.indices, s.nodes, s.nodes, s.node_state,
                            s.node_state, s.rows, s.cols, s.eptr,
                            s.edge_valid, ts)
                shares.append(hop_valid_shares(s))
            peak = torch.cuda.max_memory_allocated() / 2**30
            share = np.mean(shares, axis=0).tolist()
            mean = float(np.mean(ms[1:]))
            log(f"sampling {cfg}: request ms (first, warm-up) {ms[0]:.1f}, "
                "then " + ", ".join(f"{m:.1f}" for m in ms[1:])
                + f"; mean {mean:.2f} ms; valid share per hop "
                + ", ".join(f"{v:.4f}" for v in share)
                + f"; peak device memory {peak:.2f} GiB; edges checked")
            out[cfg] = dict(request_ms=ms[1:], first_request_ms=ms[0],
                            request_ms_mean=mean, valid_share_per_hop=share,
                            peak_device_gib=peak)
    return out


def mag_graph(scale, device, seed=30):
    """A graph of ogbn-mag's shape: ``MAG_NODES`` and ``MAG_RELATIONS``
    (with the reverses of writes, has_topic and affiliated_with) at
    ``scale``, endpoints uniform from ``seed``.  Returns the node counts,
    edge types and per-relation host CSC ``(col_ptrs, row_indices)``,
    built on ``device`` by ``coo_to_csc_device`` and copied back."""
    from tch_geometric_tpu_torch.data.storage import coo_to_csc_device
    from tch_geometric_tpu_torch.utils.types import rel_key

    def csc_of(ei, size):
        t = torch.from_numpy(np.ascontiguousarray(ei)).to(device)
        return tuple(x.cpu().numpy()
                     for x in coo_to_csc_device(t[0], t[1], *size)[:2])

    r = np.random.default_rng(seed)
    counts = {t: max(int(c * scale), 16) for t, c in MAG_NODES.items()}
    coo = {}
    for (s, rel, d), e in MAG_RELATIONS:
        e = max(int(e * scale), 64)
        ei = np.stack([r.integers(0, counts[s], e),
                       r.integers(0, counts[d], e)])
        coo[(s, rel, d)] = ei
        if rel != "cites":
            coo[(d, f"rev_{rel}", s)] = ei[::-1]
    csc = {rel_key(e): csc_of(ei, (counts[e[0]], counts[e[2]]))
           for e, ei in coo.items()}
    return counts, sorted(coo), csc


def hetero_graphs(counts, edge_types, csc, device, no_ell=()):
    """Device graphs of host CSC arrays; relations in ``no_ell`` get no
    ELL table."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.utils.types import rel_key
    return {rel_key(e): make_graph(*csc[rel_key(e)], num_src=counts[e[0]],
                                   num_dst=counts[e[2]], device=device,
                                   ell_table=False if rel_key(e) in no_ell
                                   else None)
            for e in edge_types}


def hetero_edge_values(graphs, seed, device):
    vals = {r: edge_values(g.num_edges, seed + i, device)
            for i, (r, g) in enumerate(sorted(graphs.items()))}
    return ({r: v[0] for r, v in vals.items()},
            {r: v[1] for r, v in vals.items()})


def check_hetero_sample(what, cfg, s, graphs, edge_types, timestamps):
    """(a)'s edge checks on every relation of a hetero sample; returns the
    valid edges per relation."""
    from tch_geometric_tpu_torch.utils.types import rel_key
    out = {}
    for src, rel, dst in edge_types:
        r, g = rel_key((src, rel, dst)), graphs[rel_key((src, rel, dst))]
        out[r] = check_edges(
            f"{what} {r}", cfg, g.indptr, g.indices, s.nodes[src],
            s.nodes[dst], s.node_state[src], s.node_state[dst], s.rows[r],
            s.cols[r], s.eptr[r], s.edge_valid[r],
            None if timestamps is None else timestamps[r])
    return out


def hetero_requests(mag, scale, device, timer):
    """Phase 9 (b): the ogbn-mag-shaped graph ``mag`` (``mag_graph``'s
    host arrays), 1024 paper seeds, 2 hops of
    ``MAG_FANOUTS`` per relation, under each of ``HETERO_CONFIGS``; then
    uniform sampling at ``scripts/bench_samplers.py``'s hetero
    configuration.  ``REQUESTS`` requests each (the first a warm-up): ms per
    request, valid slots per type, (a)'s edge checks per relation."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.storage import to_csc
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.sampling.hetero_neighbor import \
        sample_hetero_neighbors
    from tch_geometric_tpu_torch.utils.types import rel_key
    t0 = time.perf_counter()
    counts, edge_types, csc = mag
    graphs = hetero_graphs(counts, edge_types, csc, device)
    weights, ts = hetero_edge_values(graphs, 31, device)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    log(f"hetero mag graph: device tables and edge values {prep_s:.1f}s; "
        + ", ".join(f"{t} {c}" for t, c in counts.items()) + "; "
        + "; ".join(f"{r} E={g.num_edges} max_degree={g.max_degree} "
                    f"ELL={g.ell is not None}" for r, g in graphs.items()))
    nn = {r: MAG_FANOUTS for r in graphs}
    out = {"mag_prep_s": prep_s}

    def run(name, cfg, graphs, edge_types, nn, make_inputs, num_hops,
            weights=None, ts=None):
        gen = torch.Generator().manual_seed(32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, valid = [], {}
        for r in range(REQUESTS):
            inputs, states = make_inputs(gen)
            kw = sampler_kwargs(cfg, weights, ts, states)
            key = rng.fold(rng.key(33), r)
            s, t = timer(lambda: sample_hetero_neighbors(
                graphs, edge_types, inputs, nn, num_hops, key=key, **kw))
            ms.append(t)
            check_hetero_sample(f"{name} {cfg} request {r}", cfg, s, graphs,
                                edge_types,
                                ts if cfg.startswith("temporal") else None)
            for k, v in s.node_valid.items():
                valid.setdefault(k, []).append(int(v.sum()))
        peak = torch.cuda.max_memory_allocated() / 2**30
        mean = float(np.mean(ms[1:]))
        valid = {k: float(np.mean(v)) for k, v in valid.items()}
        log(f"hetero {name} {cfg}: request ms (first, warm-up) {ms[0]:.1f}, "
            "then " + ", ".join(f"{m:.1f}" for m in ms[1:])
            + f"; mean {mean:.2f} ms; valid slots per type (mean) "
            + ", ".join(f"{k} {v:.0f}" for k, v in valid.items())
            + f"; peak device memory {peak:.2f} GiB; edges checked")
        return dict(request_ms=ms[1:], first_request_ms=ms[0],
                    request_ms_mean=mean, valid_slots=valid,
                    peak_device_gib=peak)

    def mag_inputs(gen):
        seeds = torch.randint(0, counts["paper"], (SEEDS_PER_REQUEST,),
                              generator=gen).to(device)
        states = torch.randint(0, TIME_RANGE, (SEEDS_PER_REQUEST,),
                               generator=gen).to(device)
        return {"paper": seeds}, {"paper": states}

    with torch.no_grad():
        for cfg in HETERO_CONFIGS:
            out[f"mag_{cfg}"] = run("mag", cfg, graphs, edge_types, nn,
                                    mag_inputs, len(MAG_FANOUTS), weights, ts)
        del graphs, weights, ts
        torch.cuda.empty_cache()

        r = np.random.default_rng(34)
        nt = max(int(BENCH_NODES * scale), 64)
        er = max(int(BENCH_EDGES * scale), 256)
        b_types = [(a, f"r{i}", b) for i, (a, b) in enumerate(BENCH_PAIRS)]
        b_graphs = {}
        for e in b_types:
            ei = np.stack([r.integers(0, nt, er), r.integers(0, nt, er)])
            cp, ri, _ = to_csc(ei, nt)
            b_graphs[rel_key(e)] = make_graph(cp, ri, num_src=nt, num_dst=nt,
                                              device=device)
        b_seeds = {t: torch.from_numpy(r.integers(0, nt, BENCH_SEEDS)).to(
            device) for t in BENCH_TYPES}
        out["bench_uniform"] = run(
            "bench_samplers", "uniform", b_graphs, b_types,
            {k: BENCH_FANOUTS for k in b_graphs},
            lambda gen: (b_seeds, {}), len(BENCH_FANOUTS))
    return out


def tree_diff(a, b):
    """Valid node slots where two homogeneous samples differ (validity,
    node id, state, or the eptr of the edge that made the slot), and the
    card's valid slots."""
    va, vb = a.node_valid.cpu(), b.node_valid
    ea = torch.cat([torch.zeros(a.node_base[1], dtype=torch.long),
                    a.eptr.cpu()])
    eb = torch.cat([torch.zeros(b.node_base[1], dtype=torch.long), b.eptr])
    both = va & vb
    diff = (va != vb) | (both & ((a.nodes.cpu() != b.nodes)
                                 | (a.node_state.cpu() != b.node_state)
                                 | (ea != eb)))
    return int(diff.sum()), int(va.sum())


def hetero_diff(a, b):
    d, v = 0, 0
    for t in a.nodes:
        va, vb = a.node_valid[t].cpu(), b.node_valid[t]
        both = va & vb
        d += int(((va != vb) | (both & ((a.nodes[t].cpu() != b.nodes[t])
                  | (a.node_state[t].cpu() != b.node_state[t])))).sum())
        v += int(va.sum())
    for r in a.eptr:
        va, vb = a.edge_valid[r].cpu(), b.edge_valid[r]
        d += int(((va != vb) | (va & vb & (a.eptr[r].cpu() != b.eptr[r])))
                 .sum())
    return d, v


def check_card_vs_cpu_outputs(what, cfg, diff, valid, exact):
    """The uniform configuration must agree exactly; a Gumbel-ranked one
    may differ where two candidates' keys lie within an ulp of ``log``
    (torch's log on the card and on the CPU), at most
    ``GUMBEL_RATE_LIMIT`` of the valid slots."""
    rate = diff / max(valid, 1)
    log(f"check: {what} {cfg} card vs CPU: {diff} of {valid} valid slots "
        f"differ ({rate:.2e}; limit {'0' if exact else GUMBEL_RATE_LIMIT})")
    if exact:
        check(diff == 0, f"{what} {cfg}: card and CPU samples agree")
    else:
        check(rate <= GUMBEL_RATE_LIMIT,
              f"{what} {cfg}: card and CPU samples differ at {rate:.2e}")
    return dict(differing_slots=diff, valid_slots=valid, rate=rate)


def check_sampling_card_vs_cpu(sg, mag, device):
    """Phase 9 (c): the same seeds, states and key on the card and on the
    CPU, for "uniform" and every configuration of (a) on the 5% node
    subgraph, on its ELL table and, with ``window=CUT_WINDOW``, on the
    window engines; for every configuration of (b) on (b)'s graph cut to
    5% of each type's nodes, each relation on the engine it has at full
    size (``window=CUT_WINDOW``); the seeds' hop-0 validity (the filter
    masks) exactly equal; and ``rng.gumbel`` on 1M draws."""
    from tch_geometric_tpu_torch.data.graph import ell_width_for, make_graph
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.sampling.hetero_neighbor import \
        sample_hetero_neighbors
    from tch_geometric_tpu_torch.sampling.neighbor import sample_neighbors
    cpu = torch.device("cpu")
    out = {}
    ns = sg["ns"]
    w, ts = edge_values(len(sg["ri"]), 24, cpu)
    r = np.random.default_rng(25)
    seeds = torch.from_numpy(r.integers(0, ns, SEEDS_PER_REQUEST))
    states = torch.from_numpy(r.integers(0, TIME_RANGE, SEEDS_PER_REQUEST))
    k0 = SEEDS_PER_REQUEST * FANOUTS[0]
    for engine, ell, window, cfgs in (
            ("ELL", None, 256, ("uniform",) + SAMPLER_CONFIGS),
            ("window", False, CUT_WINDOW, SAMPLER_CONFIGS)):
        g = {dev: make_graph(sg["cp"], sg["ri"], num_src=ns, num_dst=ns,
                             ell_table=ell, device=dev)
             for dev in (device, cpu)}
        check((g[cpu].ell is None) == (ell is False),
              f"the subgraph's {engine} engine")
        for cfg in cfgs:
            s = {dev: sample_neighbors(
                g[dev], seeds.to(dev), FANOUTS, key=rng.key(26),
                window=window, **sampler_kwargs(cfg, w.to(dev), ts.to(dev),
                                                states.to(dev)))
                for dev in (device, cpu)}
            check(torch.equal(s[device].edge_valid[:k0].cpu(),
                              s[cpu].edge_valid[:k0]),
                  f"{cfg}: the seeds' hop-0 validity agrees card vs CPU")
            out[f"homogeneous_{engine}_{cfg}"] = check_card_vs_cpu_outputs(
                f"{ns}-node subgraph, {engine}", cfg,
                *tree_diff(s[device], s[cpu]), exact=cfg == "uniform")

    edge_types, csc = mag[1], mag[2]
    sub_counts, sub_csc, r = mag_cut(mag)
    no_ell = {rk for rk, (cp, _) in csc.items()
              if ell_width_for(int(np.diff(cp).max())) is None}
    graphs = {dev: hetero_graphs(sub_counts, edge_types, sub_csc, dev,
                                 no_ell)
              for dev in (device, cpu)}
    hw, hts = hetero_edge_values(graphs[cpu], 28, cpu)
    seeds = torch.from_numpy(r.integers(0, sub_counts["paper"],
                                        SEEDS_PER_REQUEST))
    states = torch.from_numpy(r.integers(0, TIME_RANGE, SEEDS_PER_REQUEST))
    nn = {k: MAG_FANOUTS for k in graphs[cpu]}
    for cfg in HETERO_CONFIGS:
        s = {dev: sample_hetero_neighbors(
            graphs[dev], edge_types, {"paper": seeds.to(dev)}, nn,
            len(MAG_FANOUTS), key=rng.key(29), window=CUT_WINDOW,
            **sampler_kwargs(
                cfg, {k: v.to(dev) for k, v in hw.items()},
                {k: v.to(dev) for k, v in hts.items()},
                {"paper": states.to(dev)}))
            for dev in (device, cpu)}
        base = s[cpu].layout().rel_edge_base
        check(all(torch.equal(s[device].edge_valid[rk][:base[rk][1]].cpu(),
                              ev[:base[rk][1]])
                  for rk, ev in s[cpu].edge_valid.items()),
              f"{cfg}: the seeds' hop-0 validity agrees card vs CPU")
        out[f"hetero_{cfg}"] = check_card_vs_cpu_outputs(
            "5% mag cut", cfg, *hetero_diff(s[device], s[cpu]),
            exact=cfg == "uniform")

    k = rng.key(35)
    a = rng.gumbel(k, (1 << 20,), device=device).cpu()
    b = rng.gumbel(k, (1 << 20,), device="cpu")
    err = float(((a - b).abs() - GUMBEL_RTOL * b.abs()).max())
    log(f"check: rng.gumbel 1M draws card vs CPU: max |diff| "
        f"{maxerr(a, b):.3e}, {int((a != b).sum())} draws differ "
        f"(rtol {GUMBEL_RTOL}, atol {GUMBEL_ATOL})")
    check(err <= GUMBEL_ATOL, "rng.gumbel card vs CPU within rtol")
    out["gumbel_card_vs_cpu_max_diff"] = maxerr(a, b)
    return out


# ---------------------------------------------------------------------------
# Phase 10: the rest of the reference-parity API on the data layer
# ---------------------------------------------------------------------------

FIND_EDGE_PAIRS = 1 << 20
WALK_STARTS = 256 * 10          # OGB's products node2vec: 256 nodes x 10 walks
WALK_LENGTH = 40
WALK_PQ = ((1.0, 1.0), (1.0, 1.5))   # examples/random_walk.py
WALK_BIASES = ("uniform", "linear", "exponential")
WALK_RETRIES = 10
BULK_WALKS = 262_144
OUT_TEMPO_CHUNK = 2048          # (b)'s tempo walk on the out-edge CSR: 56
                                # chunks a step, not 442 of the default 256
PHASE10_REQUESTS = 2            # per configuration, the first a warm-up
NEG_INPUTS, NEG_NUM, NEG_TRIES = 65_536, 5, 5   # examples/negative_sampling.py
HETERO_NEG_INPUTS = 1024
HGT_SEEDS, HGT_SAMPLES = 128, [512] * 4         # PyG's HGTLoader docstring
BUDGET_SEEDS, BUDGET_FANOUTS = 1024, [15, 10]
MAG_FEATURES = 128
LOADER_SEEDS, LOADER_BATCH = 65_536, 1024
CUT_WALKS, CUT_WALK_LENGTH = 4096, 12
CUT_HGT_SAMPLES = HGT_SAMPLES[:2]      # (g): two layers of (d)'s picks
CUT_BUDGET_CONFIGS = 2                 # (g): (e)'s uniform and temporal
CUT_DIFF_LIMIT = 1e-3           # card vs CPU: differing walks or valid slots


def requests(name, timer, fn, n=PHASE10_REQUESTS):
    """``n`` calls of ``fn(i)`` on the timer; logs and returns the last
    result and the times (the first a warm-up; a request of a second or
    more runs once: torch compiles nothing, so a warm-up would only time
    the same launches again)."""
    ms, out = [], None
    for i in range(n):
        out, t = timer(lambda: fn(i))
        ms.append(t)
    mean = float(np.mean(ms[1:])) if n > 1 else ms[0]
    if n > 1:
        log(f"phase 10 {name}: ms per request (first, warm-up) {ms[0]:.1f}, "
            "then " + ", ".join(f"{m:.1f}" for m in ms[1:])
            + f"; mean {mean:.2f}")
    else:
        log(f"phase 10 {name}: ms per request {ms[0]:.1f} (one run)")
    return out, dict(request_ms=ms[1:], first_request_ms=ms[0],
                     request_ms_mean=mean)


def data_layer(p, sg, device, timer):
    """Phase 10 (a): ``to_csc`` and ``to_csr`` of the products COO by the
    native C++ sort and by ``coo_to_csc_device`` on the card, exactly equal
    (the CSC also to host prep's); on the 5% cut's COO three ways (numpy
    too), exactly equal, each timed; ``ind2ptr`` on the card against
    ``ind2ptr_np``; ``find_edge`` on 1M pairs, half real edges, half
    random, against a numpy search of the sorted edge keys.  Returns the
    numbers and the device build's host CSR arrays."""
    from tch_geometric_tpu_torch import native
    from tch_geometric_tpu_torch.data import storage
    check(native.available(), "the native C++ library is built (no numpy "
          "fallback)")
    ei, n = p["data"].edge_index, p["data"].num_nodes
    out = {}
    csr = None

    def card_build(coo, csc, nn):
        major, minor = (coo[1], coo[0]) if csc else (coo[0], coo[1])
        return timer(lambda: storage.coo_to_csc_device(minor, major, nn, nn))

    for layout, csc in (("csc", True), ("csr", False)):
        b, t_nat = timer(lambda: storage._native_csx(ei, n, n, csc))
        coo, t_h2d = timer(lambda: (torch.from_numpy(ei[0]).to(device),
                                    torch.from_numpy(ei[1]).to(device)))
        d, t_dev = card_build(coo, csc, n)
        d_host = [x.cpu().numpy() for x in d]
        for name, y, z in zip(("ptrs", "indices", "perm"), b, d_host):
            check(np.array_equal(y, z),
                  f"to_{layout} {name}: native and card builds equal")
        if csc:
            for name, y, z in zip(("ptrs", "indices"), b,
                                  (p["col_ptrs"], p["row_indices"])):
                check(np.array_equal(y, z), f"host prep's CSC {name} equals "
                      "the native to_csc")
        major = coo[1] if csc else coo[0]
        ptr, t_ptr = timer(lambda: storage.ind2ptr(major[d[2]], n))
        check(np.array_equal(ptr.cpu().numpy(), storage.ind2ptr_np(
            ei[1 if csc else 0][b[2]], n)), f"{layout}: ind2ptr on the card "
              "equals ind2ptr_np")
        # numpy's stable sort, timed on the 5% cut (the full graph took
        # 17.6 / 20.2 s of host time, PERF.md)
        sei, sn = sg["ei"], sg["ns"]
        a, t_np = timer(lambda: storage._numpy_csx(sei, sn, sn, csc))
        b_cut, t_nat_cut = timer(lambda: storage._native_csx(sei, sn, sn,
                                                             csc))
        d_cut, t_dev_cut = card_build(
            (torch.from_numpy(sei[0]).to(device),
             torch.from_numpy(sei[1]).to(device)), csc, sn)
        for name, x, y, z in zip(("ptrs", "indices", "perm"), a, b_cut,
                                 d_cut):
            check(np.array_equal(x, y) and np.array_equal(
                x, z.cpu().numpy()), f"to_{layout} {name} of the cut: "
                  "numpy, native and card builds equal")
        log(f"phase 10 (a) to_{layout} of {ei.shape[1]} edges: native "
            f"{t_nat:.1f} ms, card {t_dev:.1f} ms (+ {t_h2d:.1f} ms to copy "
            f"the COO there), ind2ptr on the card {t_ptr:.2f} ms, exactly "
            f"equal; the cut's {sei.shape[1]} edges: numpy {t_np:.1f} ms, "
            f"native {t_nat_cut:.1f} ms, card {t_dev_cut:.1f} ms, exactly "
            "equal")
        out[layout] = dict(native_ms=t_nat, card_ms=t_dev,
                           card_copy_ms=t_h2d, ind2ptr_card_ms=t_ptr,
                           cut_edges=int(sei.shape[1]), cut_numpy_ms=t_np,
                           cut_native_ms=t_nat_cut, cut_card_ms=t_dev_cut)
        if not csc:
            csr = (d_host[0], d_host[1])
        del a, b, d, d_host, coo, major, b_cut, d_cut

    # find_edge on the CSC graph: u on the pointer axis (dst), v the src
    g, cp, ri = p["graph"], p["col_ptrs"], p["row_indices"]
    E, half = ri.shape[0], FIND_EDGE_PAIRS // 2
    r = np.random.default_rng(40)
    e = r.integers(0, E, half)
    u = np.concatenate([np.searchsorted(cp, e, side="right") - 1,
                        r.integers(0, n, half)])
    v = np.concatenate([ri[e], r.integers(0, n, half)])
    found, t_find = timer(lambda: g.find_edge(torch.from_numpy(u).to(device),
                                              torch.from_numpy(v).to(device)))
    keys = np.repeat(np.arange(n, dtype=np.int64), np.diff(cp)) * n + ri
    q = u * n + v
    at = np.searchsorted(keys, q)
    hit = keys[np.minimum(at, E - 1)] == q
    want = np.where(hit, at, -1)         # the first pointer of (u, v)
    found = found.cpu().numpy()
    check(np.array_equal(found, want), "find_edge equals the numpy search")
    check(bool((found[:half] >= 0).all()) and np.array_equal(
        ri[found[:half]], ri[e]), "find_edge finds every real edge")
    log(f"phase 10 (a) find_edge of {FIND_EDGE_PAIRS} pairs (half real): "
        f"{t_find:.2f} ms; {int(hit[half:].sum())} of the random half are "
        "edges; equal to the numpy search")
    out.update(find_edge_ms=t_find, random_pairs_found=int(hit[half:].sum()))
    return out, csr


def _walk_edges_ok(g, w):
    """Every live step of ``w`` (B, L) follows an edge of ``g``, and a -1
    stays -1."""
    a, b = w[:, :-1], w[:, 1:]
    live = b >= 0
    ok = g.has_edge(a.clamp(min=0), b.clamp(min=0))
    return bool((ok | ~live).all()) and not bool((~live[:, :-1]
                                                  & live[:, 1:]).any())


def _tempo_walks_ok(what, g, w, ts, start_ts):
    """A temporal walk's step follows an edge of ``g`` or restarts at an
    earlier position of its walk, and every step's timestamp lies in the
    root's window."""
    a, b = w[:, :-1], w[:, 1:]
    L = w.shape[1]
    earlier = ((w[:, None, :] == b[:, :, None])
               & (torch.arange(L, device=w.device)[None, None, :]
                  <= torch.arange(L - 1, device=w.device)[None, :, None])
               ).any(dim=-1)
    is_edge = g.has_edge(a, b)
    check(bool((is_edge | earlier).all()),
          f"{what}: every step is an edge or a restart")
    lo, hi = TEMPORAL_WINDOW
    d = ts - start_ts[:, None]
    check(bool(((d >= lo) & (d < hi)).all()),
          f"{what}: every step lies in the root's window")
    return int((~is_edge).sum())


def walk_requests(p, csr, device, timer):
    """Phase 10 (b), through the public walk entry points on host arrays,
    as a user calls them (each call builds its device graph, so its time
    includes that build): node2vec at (1, 1) and (1, 1.5) on the products
    out-edge CSR from (a)'s card build (no table fits its max degree: the
    binary-search path), and one call of 262,144 starts; the temporal walk
    on the out-edge CSR once (``window_choice_sample`` over the max degree
    in chunks of ``OUT_TEMPO_CHUNK``) and on the in-edge adjacency (the
    CSC read as the CSR of the reversed graph: the ELL path, where the
    chunk width is unused); the CTDNE walks on the in-edge
    adjacency (on the out-edge CSR their dense (walks, max_degree) step
    tensors would hold 2,560 x 113,135 = 290M draws a step: ROADMAP §C).
    Each walk's steps are checked on a device graph of the same arrays."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.sampling import rng, walks
    n = p["data"].num_nodes
    out_g, t = timer(lambda: make_graph(csr[0], csr[1], num_src=n,
                                        num_dst=n, device=device))
    in_g, in_csr = p["graph"], (p["col_ptrs"], p["row_indices"])
    log(f"phase 10 (b) out-edge CSR: max degree {out_g.max_degree}, ELL "
        f"{out_g.ell is not None}, {t:.1f} ms to the card; in-edge "
        f"adjacency: max degree {in_g.max_degree}, ELL {in_g.ell is not None}")
    r = np.random.default_rng(43)
    starts = r.integers(0, n, WALK_STARTS)
    node_ts = r.integers(0, TIME_RANGE, n)
    edge_ts = r.integers(0, TIME_RANGE, in_g.num_edges)
    start_ts = r.integers(0, TIME_RANGE, WALK_STARTS)
    start_ts_d = torch.from_numpy(start_ts).to(device)

    def on(a):
        return torch.from_numpy(a).to(device)

    res = {"out_max_degree": out_g.max_degree}
    with torch.no_grad():
        for pq in WALK_PQ:
            w, res[f"node2vec {pq}"] = requests(
                f"(b) random_walk out-edge CSR p,q={pq}", timer,
                lambda i: walks.random_walk(
                    *csr, starts, WALK_LENGTH, *pq,
                    key=rng.fold(rng.key(44), i), device=device),
                n=PHASE10_REQUESTS if pq == (1.0, 1.0) else 1)
            check(w.shape == (WALK_STARTS, WALK_LENGTH + 1)
                  and _walk_edges_ok(out_g, on(w)),
                  f"node2vec {pq}: every step is an edge")
        w, res["node2vec bulk"] = requests(
            f"(b) random_walk out-edge CSR, {BULK_WALKS} starts", timer,
            lambda i: walks.random_walk(
                *csr, r.integers(0, n, BULK_WALKS), WALK_LENGTH,
                key=rng.key(45), device=device), n=1)
        check(_walk_edges_ok(out_g, on(w)), "bulk node2vec: every step is "
              "an edge")

        for name, g, arrays, nreq in (("in-edge ELL", in_g, in_csr,
                                       PHASE10_REQUESTS),
                                      ("out-edge CSR", out_g, csr, 1)):
            chunk = 256 if g.ell is not None else OUT_TEMPO_CHUNK
            (w, ts), res[f"tempo {name}"] = requests(
                f"(b) tempo_random_walk {name}, window {TEMPORAL_WINDOW}, "
                f"window_chunk {chunk}", timer,
                lambda i: walks.tempo_random_walk(
                    *arrays, node_ts, edge_ts, starts, start_ts, WALK_LENGTH,
                    TEMPORAL_WINDOW, key=rng.fold(rng.key(46), i),
                    window_chunk=chunk, device=device), n=nreq)
            res[f"tempo {name}"]["restarted_steps"] = _tempo_walks_ok(
                f"tempo {name}", g, on(w), on(ts), start_ts_d)
        for bias in WALK_BIASES:
            (w, ts), res[f"ctdne {bias}"] = requests(
                f"(b) biased_tempo_random_walk {bias}, forward, "
                f"retry_count {WALK_RETRIES}, in-edge ELL", timer,
                lambda i: walks.biased_tempo_random_walk(
                    *in_csr, node_ts, edge_ts, starts, start_ts, WALK_LENGTH,
                    bias, True, WALK_RETRIES, key=rng.fold(rng.key(47), i),
                    device=device), n=1)
            w, ts = on(w), on(ts)
            live = w[:, 1:] >= 0
            check(_walk_edges_ok(in_g, w), f"ctdne {bias}: every step is "
                  "an edge")
            check(bool(((ts[:, 1:] >= ts[:, :-1]) | ~live).all()),
                  f"ctdne {bias}: timestamps never decrease")
            res[f"ctdne {bias}"]["complete_walks"] = int(live.all(dim=1).sum())
            log(f"  ctdne {bias}: {res[f'ctdne {bias}']['complete_walks']} "
                f"of {WALK_STARTS} walks complete")
    return res, out_g


def _assert_not_edges(what, g, u, w):
    u, w = torch.as_tensor(u), torch.as_tensor(w)
    check(bool((u != w).all()), f"{what}: no negative is a self-loop")
    check(not bool(g.has_edge(u.to(g.device), w.to(g.device)).any()),
          f"{what}: no negative is an edge")


def mag_csr(counts, edge_types, csc):
    """Host CSR ``(row_ptrs, col_indices)`` and sizes per relation of the
    mag-shaped graph's CSC arrays."""
    from tch_geometric_tpu_torch.data.storage import to_csr
    from tch_geometric_tpu_torch.utils.types import rel_key
    out, sizes = {}, {}
    for e in edge_types:
        cp, ri = csc[rel_key(e)]
        sizes[rel_key(e)] = (counts[e[0]], counts[e[2]])
        dst = np.repeat(np.arange(len(cp) - 1), np.diff(cp))
        out[rel_key(e)] = to_csr(np.stack([ri, dst]), sizes[rel_key(e)])[:2]
    return out, sizes


def negative_requests(p, csr, out_g, mag, device, timer):
    """Phase 10 (c): homogeneous negatives on the products CSR (65,536
    inputs, 5 negatives, 5 tries) through the parity API (which builds its
    device graph per call); heterogeneous on the mag-shaped graph (1,024
    papers and 1,024 authors), inbound False and True.  No accepted
    negative may be an edge (in the probe's direction) or a self-loop."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.sampling.negative import (
        negative_sample_neighbors_heterogenous,
        negative_sample_neighbors_homogenous)
    n = p["data"].num_nodes
    r = np.random.default_rng(48)
    inputs = r.integers(0, n, NEG_INPUTS)
    (samples, rows, cols, count), res = requests(
        f"(c) negative homogeneous, {NEG_INPUTS} inputs", timer,
        lambda i: negative_sample_neighbors_homogenous(
            csr[0], csr[1], (n, n), inputs, NEG_NUM, NEG_TRIES,
            key=rng.fold(rng.key(49), i), device=device), n=2)
    check(count == NEG_INPUTS, "sample_count is the input count")
    _assert_not_edges("negative homogeneous", out_g, inputs[rows],
                      samples[cols])
    res["accepted_share"] = len(rows) / (NEG_INPUTS * NEG_NUM)
    log(f"  accepted {len(rows)} of {NEG_INPUTS * NEG_NUM} slots, "
        f"{len(samples) - NEG_INPUTS} new samples")

    counts, edge_types, csc = mag
    csr_m, sizes = mag_csr(counts, edge_types, csc)
    node_types = sorted(counts)
    graphs = {k: make_graph(*v, num_src=sizes[k][0], num_dst=sizes[k][1],
                            ell_table=False, window_table=False,
                            device=device) for k, v in csr_m.items()}
    hin = {"paper": r.integers(0, counts["paper"], HETERO_NEG_INPUTS),
           "author": r.integers(0, counts["author"], HETERO_NEG_INPUTS)}
    out = {"homogeneous": res}
    for inbound in (False, True):
        (s, rows, cols, _c), out[f"hetero_inbound_{inbound}"] = requests(
            f"(c) negative heterogeneous, inbound {inbound}", timer,
            lambda i: negative_sample_neighbors_heterogenous(
                node_types, edge_types, {k: v[0] for k, v in csr_m.items()},
                {k: v[1] for k, v in csr_m.items()}, sizes, hin, NEG_NUM,
                NEG_TRIES, inbound, key=rng.fold(rng.key(50), i),
                device=device), n=1)
        total = 0
        for src, rel, dst in edge_types:
            k = f"{src}__{rel}__{dst}"
            if src not in hin or not len(rows[k]):
                continue
            u, w = hin[src][rows[k]], s[dst][cols[k]]
            _assert_not_edges(f"negative {k} inbound {inbound}", graphs[k],
                              w if inbound else u, u if inbound else w)
            total += len(rows[k])
        log(f"  inbound {inbound}: {total} accepted negatives, checked")
    return out


def mag_hetero_data(mag, seed=51):
    """A ``HeteroData`` of the mag-shaped graph: zero features of
    ``MAG_FEATURES`` columns, the COO in sorted-CSC order, and per-edge
    timestamps in ``[0, TIME_RANGE)``; returns it and the timestamps by
    sorted edge per relation."""
    from tch_geometric_tpu_torch.data import HeteroData
    from tch_geometric_tpu_torch.utils.types import rel_key
    counts, edge_types, csc = mag
    r = np.random.default_rng(seed)
    ei, attrs, ts = {}, {}, {}
    for e in edge_types:
        cp, ri = csc[rel_key(e)]
        ei[e] = np.stack([ri, np.repeat(np.arange(len(cp) - 1),
                                        np.diff(cp))])
        ts[rel_key(e)] = r.integers(0, TIME_RANGE, len(ri))
        attrs[e] = {"timestamps": ts[rel_key(e)]}
    x = {t: np.zeros((c, MAG_FEATURES), np.float32)
         for t, c in counts.items()}
    return HeteroData(x=x, edge_index=ei, edge_attrs=attrs), ts


def _hetero_batch_edges_ok(what, batch, hdata):
    """Every edge of a hetero batch is real: its original COO edge joins
    the batch nodes its local ids name."""
    from tch_geometric_tpu_torch.utils.types import rel_key
    n_edges = 0
    for e in hdata.edge_types:
        k = rel_key(e)
        rows, cols = batch.edge_index[k]
        coo = hdata.edge_index[e][:, batch.e_id[k]]
        check(np.array_equal(coo[0], batch.n_id[e[0]][rows])
              and np.array_equal(coo[1], batch.n_id[e[2]][cols]),
              f"{what} {k}: every edge is real, both ends in the batch")
        n_edges += len(rows)
    return n_edges


def hgt_requests(mag, hdata, ts, device, timer):
    """Phase 10 (d): HGT sampling on the mag-shaped graph, 128 paper seeds,
    [512] x 4 per node type, uniform and temporal (timerange (0, 400)),
    through ``hgt_sampling`` (which builds its device graphs per call) and
    ``HGTSamplerTransform``; valid nodes per type; every kept edge real with
    both ends in the sample, every node sampled once."""
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.sampling.hgt import hgt_sampling
    from tch_geometric_tpu_torch.transforms import HGTSamplerTransform
    counts, edge_types, csc = mag
    node_types = sorted(counts)
    r = np.random.default_rng(52)
    seeds = {"paper": r.integers(0, counts["paper"], HGT_SEEDS)}
    seed_ts = {"paper": r.integers(0, TIME_RANGE, HGT_SEEDS)}
    ns = {t: HGT_SAMPLES for t in node_types}
    out = {}
    for temporal in (False, True):
        mode = "temporal" if temporal else "uniform"
        tkw = dict(input_timestamps=seed_ts if temporal else None,
                   timerange=TEMPORAL_WINDOW if temporal else None)
        (nodes, nts, rows, cols, eptr), t = timer(lambda: hgt_sampling(
            node_types, edge_types, {k: v[0] for k, v in csc.items()},
            {k: v[1] for k, v in csc.items()}, ts if temporal else None,
            seeds, tkw["input_timestamps"], ns, len(HGT_SAMPLES),
            tkw["timerange"], key=rng.key(53), node_counts=counts,
            device=device))
        for src, rel, dst in edge_types:
            k = f"{src}__{rel}__{dst}"
            cp, ri = csc[k]
            v, w = nodes[src][rows[k]], nodes[dst][cols[k]]
            check(np.array_equal(ri[eptr[k]], v) and bool(
                ((eptr[k] >= cp[w]) & (eptr[k] < cp[w + 1])).all()),
                f"hgt_sampling {mode} {k}: every kept edge is real")
        for tt in node_types:
            check(len(np.unique(nodes[tt])) == len(nodes[tt]),
                  f"hgt_sampling {mode} {tt}: each node sampled once")
        valid = {tt: len(v) for tt, v in nodes.items()}
        log(f"phase 10 (d) hgt_sampling {mode}: {t:.1f} ms (with the "
            f"device graphs' build); valid nodes per type {valid}; "
            f"{sum(len(v) for v in rows.values())} kept edges, checked")
        tf = HGTSamplerTransform(hdata, HGT_SAMPLES, temporal=temporal,
                                 device=device)
        batch, res = requests(
            f"(d) HGTSamplerTransform {mode}", timer,
            lambda i: tf(seeds, key=rng.fold(rng.key(54), i), **tkw), n=1)
        kept = _hetero_batch_edges_ok(f"HGTSamplerTransform {mode}", batch,
                                      hdata)
        res.update(parity_api_ms=t, parity_valid_nodes=valid,
                   transform_valid_nodes={k: len(v) for k, v in
                                          batch.n_id.items()},
                   transform_kept_edges=kept)
        log(f"  transform valid nodes per type "
            f"{res['transform_valid_nodes']}; {kept} kept edges, checked")
        out[mode] = res
    return out


BUDGET_CONFIGS = (("uniform", None, False), ("temporal", TEMPORAL_WINDOW,
                                              False),
                  ("temporal_relative", TEMPORAL_WINDOW, True))


def check_budget_sample(what, s, graphs, ts, window, relative):
    """Every valid budget edge is real; under the filter its timestamp
    passes the half-open forward window against its parent's, and the
    child's timestamp is the edge's (the parent's when ``relative``)."""
    n_edges = 0
    for k, g in graphs.items():
        src, _rel, dst = k.split("__")
        ev = s.edge_valid[k]
        e, rr, cc = s.eptr[k][ev], s.rows[k][ev], s.cols[k][ev]
        child, parent = s.nodes[src][rr], s.nodes[dst][cc]
        check(torch.equal(g.indices[e], child) and bool(
            ((e >= g.indptr[parent]) & (e < g.indptr[parent + 1])).all()),
            f"{what} {k}: every edge is real")
        if window is not None:
            t, pt = ts[k][e], s.node_ts[dst][cc]
            d = t - pt
            check(bool(((d >= window[0]) & (d < window[1])).all()),
                  f"{what} {k}: every edge passes the window")
            check(torch.equal(s.node_ts[src][rr], pt if relative else t),
                  f"{what} {k}: the child's timestamp")
        n_edges += int(ev.sum())
    return n_edges


def budget_requests(mag, hdata, ts, device, timer):
    """Phase 10 (e): budget sampling on the mag-shaped graph, 1,024 papers,
    [15, 10] per type, with no filter and with the temporal filter (window
    (0, 400), forward), ``relative`` False and True: ``sample_budget`` on
    the transform's device graphs per request, and ``budget_sampling``
    once (which builds its own); valid slots; edges checked."""
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.sampling.budget import (budget_sampling,
                                                         sample_budget)
    from tch_geometric_tpu_torch.utils.types import rel_key
    counts, edge_types, csc = mag
    node_types = sorted(counts)
    graphs = {rel_key(e): hdata.csc(e, device) for e in edge_types}
    dts = {k: torch.from_numpy(v).to(device).int() for k, v in ts.items()}
    r = np.random.default_rng(55)
    seeds = {"paper": r.integers(0, counts["paper"], BUDGET_SEEDS)}
    seed_ts = {"paper": r.integers(0, TIME_RANGE, BUDGET_SEEDS)}
    nn = {t: BUDGET_FANOUTS for t in node_types}
    out = {}
    for name, window, relative in BUDGET_CONFIGS:
        s, res = requests(
            f"(e) sample_budget {name}", timer,
            lambda i: sample_budget(
                graphs, edge_types, seeds, nn, len(BUDGET_FANOUTS),
                edge_timestamps=dts, input_timestamps=seed_ts, window=window,
                forward=True, relative=relative, node_types=node_types,
                key=rng.fold(rng.key(56), i)))
        res["valid_slots"] = {t: int(v.sum()) for t, v in
                              s.node_valid.items()}
        res["edges"] = check_budget_sample(f"budget {name}", s, graphs, dts,
                                           window, relative)
        log(f"  valid slots per type {res['valid_slots']}; {res['edges']} "
            "edges, checked")
        out[name] = res
    compact, t = timer(lambda: budget_sampling(
        node_types, edge_types, {k: v[0] for k, v in csc.items()},
        {k: v[1] for k, v in csc.items()}, None, seeds, None, nn,
        len(BUDGET_FANOUTS), key=rng.key(57), node_counts=counts,
        device=device))
    log(f"phase 10 (e) budget_sampling (parity API, with the device "
        f"graphs' build): {t:.1f} ms; "
        f"{sum(len(v) for v in compact[0].values())} nodes")
    out["parity_api_ms"] = t
    return out


def transform_requests(p, hdata, device, timer):
    """Phase 10 (f): ``NeighborSamplerTransform`` on products (``Data``,
    1024 seeds, [15, 10, 5]) and on the mag shape (``HeteroData``, 1024
    papers, [15, 10] per relation), ``NegativeSamplerTransform`` on products
    (65,536 inputs) and ``SeedLoader`` over 65,536 seeds; the transforms'
    set-up (device graphs) timed apart; batches checked."""
    from tch_geometric_tpu_torch.loader import SeedLoader
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.transforms import (NegativeSamplerTransform,
                                                    NeighborSamplerTransform)
    data, n = p["data"], p["data"].num_nodes
    r = np.random.default_rng(58)
    out = {}
    tf, t = timer(lambda: NeighborSamplerTransform(data, FANOUTS,
                                                   device=device))
    b, out["neighbor_products"] = requests(
        "(f) NeighborSamplerTransform products", timer,
        lambda i: tf(r.integers(0, n, SEEDS_PER_REQUEST),
                     key=rng.fold(rng.key(59), i)))
    check(b.x.shape == (len(b.n_id), data.x.shape[1]) and np.array_equal(
        data.edge_index[:, b.e_id], b.n_id[b.edge_index]),
        "products batch: features gathered, every edge real")
    out["neighbor_products"]["setup_ms"] = t

    tf, t = timer(lambda: NeighborSamplerTransform(hdata, BUDGET_FANOUTS,
                                                   device=device))
    b, out["neighbor_mag"] = requests(
        "(f) NeighborSamplerTransform mag", timer,
        lambda i: tf({"paper": r.integers(0, hdata.num_nodes("paper"),
                                          SEEDS_PER_REQUEST)},
                     key=rng.fold(rng.key(60), i)))
    _hetero_batch_edges_ok("mag batch", b, hdata)
    out["neighbor_mag"]["setup_ms"] = t

    _, t = timer(lambda: data.csr(device))
    tf = NegativeSamplerTransform(data, NEG_NUM, NEG_TRIES, device=device)
    b, out["negative_products"] = requests(
        "(f) NegativeSamplerTransform products", timer,
        lambda i: tf(r.integers(0, n, NEG_INPUTS),
                     key=rng.fold(rng.key(61), i)))
    src, dst = b.n_id[b.edge_index]
    _assert_not_edges("negative transform", data.csr(device), src, dst)
    out["negative_products"]["setup_ms"] = t

    seeds = r.integers(0, n, LOADER_SEEDS)
    loader = SeedLoader(seeds, LOADER_BATCH, seed=62)
    batches, t = timer(lambda: list(loader))
    check(len(batches) == LOADER_SEEDS // LOADER_BATCH and np.array_equal(
        np.sort(np.concatenate(batches)), np.sort(seeds)),
        "SeedLoader: one epoch covers the seeds")
    log(f"phase 10 (f) SeedLoader over {LOADER_SEEDS} seeds: one epoch of "
        f"{len(batches)} batches {t:.2f} ms")
    out["seed_loader_epoch_ms"] = t
    return out


def mag_cut(mag, frac=0.05, seed=27):
    """The mag-shaped graph cut to ``frac`` of each type's nodes (phase 9
    (c)'s cut): node counts, host CSC per relation, and the generator that
    drew it (later draws continue from it)."""
    from tch_geometric_tpu_torch.data.storage import to_csc
    from tch_geometric_tpu_torch.utils.types import rel_key
    counts, edge_types, csc = mag
    r = np.random.default_rng(seed)
    keep = {t: np.sort(r.choice(c, max(int(c * frac), 16), replace=False))
            for t, c in counts.items()}
    new_id = {}
    for t, k in keep.items():
        new_id[t] = np.full(counts[t], -1, np.int64)
        new_id[t][k] = np.arange(len(k))
    sub_csc = {}
    for e in edge_types:
        cp, ri = csc[rel_key(e)]
        dst = np.repeat(np.arange(len(cp) - 1), np.diff(cp))
        ei = np.stack([new_id[e[0]][ri], new_id[e[2]][dst]])
        ei = ei[:, (ei >= 0).all(axis=0)]
        sub_csc[rel_key(e)] = to_csc(ei, (len(keep[e[0]]),
                                          len(keep[e[2]])))[:2]
    return {t: len(k) for t, k in keep.items()}, sub_csc, r


def sample_diff(a, b, ts_field):
    """Valid node slots where two padded hetero samples (card, CPU) differ
    in validity, id or timestamp, plus edge slots differing in validity or
    pointer; and the CPU's valid node slots."""
    d, v = 0, 0
    for t in a.nodes:
        va, vb = a.node_valid[t].cpu(), b.node_valid[t]
        both = va & vb
        d += int(((va != vb) | (both & (
            (a.nodes[t].cpu() != b.nodes[t])
            | (getattr(a, ts_field)[t].cpu() != getattr(b, ts_field)[t]))))
            .sum())
        v += int(vb.sum())
    for k in a.eptr:
        va, vb = a.edge_valid[k].cpu(), b.edge_valid[k]
        d += int(((va != vb) | (va & vb & ((a.eptr[k].cpu() != b.eptr[k])
                                          | (a.rows[k].cpu() != b.rows[k]))))
                 .sum())
    return d, v


def check_rate(what, diff, total, limit, where="phase 10 (g)"):
    rate = diff / max(total, 1)
    log(f"check: {where} {what} card vs CPU: {diff} of {total} differ "
        f"({rate:.2e}; limit {limit})")
    check(rate <= limit, f"{what}: card and CPU differ at {rate:.2e}")
    return dict(differing=diff, total=total, rate=rate)


def check_phase10_card_vs_cpu(sg, mag, device):
    """Phase 10 (g): the same key and inputs on the card and on the CPU, on
    phase 9's 5% cuts, each graph with its ELL tables (the walks through
    their public entry points) and again with ``ell_table=False,
    window_table=False``: node2vec, both negative
    samplers and ``coo_to_csc_device`` exactly equal; temporal and CTDNE
    walks differing in at most 1e-3 of the walks; HGT (two layers of
    (d)'s picks) and budget ((e)'s uniform and temporal) samples in at
    most 1e-3 of the valid slots.  Without tables every relation runs
    Floyd's 50 draws, so the cut keeps these few configurations."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.storage import coo_to_csc_device, to_csr
    from tch_geometric_tpu_torch.sampling import rng, walks
    from tch_geometric_tpu_torch.sampling.budget import sample_budget
    from tch_geometric_tpu_torch.sampling.hgt import sample_hgt
    from tch_geometric_tpu_torch.sampling.negative import (
        negative_sample_neighbors_heterogenous,
        negative_sample_neighbors_homogenous)
    from tch_geometric_tpu_torch.utils.types import rel_key
    cpu = torch.device("cpu")
    devs = (device, cpu)
    out = {}
    cp, ri, ns = sg["cp"], sg["ri"], sg["ns"]
    r = np.random.default_rng(63)
    starts = r.integers(0, ns, CUT_WALKS)
    start_ts = r.integers(0, TIME_RANGE, CUT_WALKS)
    node_ts = r.integers(0, TIME_RANGE, ns)
    edge_ts = r.integers(0, TIME_RANGE, len(ri))

    # the cut's in-edge adjacency, read as a CSR: the public entry points
    # (which build the ELL tables), then the impls on table-less graphs
    # (the entry points take no table option, as in the JAX package)
    pq = WALK_PQ[1]                      # the accept test's path
    tempo_args = (node_ts, edge_ts, starts, start_ts, CUT_WALK_LENGTH,
                  TEMPORAL_WINDOW)
    ctdne_args = (node_ts, edge_ts, starts, start_ts, CUT_WALK_LENGTH)
    api = dict(
        node2vec=lambda d: torch.from_numpy(walks.random_walk(
            cp, ri, starts, CUT_WALK_LENGTH, *pq, key=rng.key(64),
            device=d)),
        tempo=lambda d: tuple(map(torch.from_numpy, walks.tempo_random_walk(
            cp, ri, *tempo_args, key=rng.key(65), window_chunk=CUT_WINDOW,
            device=d))),
        ctdne=lambda d, bias: tuple(map(
            torch.from_numpy, walks.biased_tempo_random_walk(
                cp, ri, *ctdne_args, bias, True, WALK_RETRIES,
                key=rng.key(66), device=d))))
    plain = {d: make_graph(cp, ri, num_src=ns, num_dst=ns, device=d,
                           ell_table=False, window_table=False) for d in devs}
    check(plain[cpu].ell is None and walks._csr_from_parts(
        cp, ri, cpu).ell is not None, "the cut's ELL and plain engines")

    def on(dev, a, dtype=torch.long):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    args = {d: (on(d, node_ts, torch.int32), on(d, edge_ts, torch.int32),
                on(d, starts), on(d, start_ts, torch.int32)) for d in devs}
    impl = dict(
        node2vec=lambda d: walks._random_walk_impl(
            rng.key(64), plain[d], on(d, starts), CUT_WALK_LENGTH, *pq,
            walks.NUM_TRIALS).cpu(),
        tempo=lambda d: walks._tempo_walk_impl(
            rng.key(65), plain[d], *args[d], CUT_WALK_LENGTH,
            *TEMPORAL_WINDOW, CUT_WINDOW),
        ctdne=lambda d, bias: walks._biased_tempo_walk_impl(
            rng.key(66), plain[d], *args[d], CUT_WALK_LENGTH, bias, True,
            WALK_RETRIES))
    for engine, fns in (("ELL", api), ("plain", impl)):
        w = {d: fns["node2vec"](d) for d in devs}
        check(torch.equal(w[device], w[cpu]),
              f"node2vec {engine} {pq}: card and CPU walks equal")
        log(f"check: phase 10 (g) node2vec {engine} p,q={pq}: "
            f"{CUT_WALKS} walks equal card vs CPU")
        res = {d: fns["tempo"](d) for d in devs}
        out[f"tempo_{engine}"] = check_rate(
            f"tempo walks {engine}", _walk_diff(res, device, cpu),
            CUT_WALKS, CUT_DIFF_LIMIT)
        for bias in WALK_BIASES:
            res = {d: fns["ctdne"](d, bias) for d in devs}
            out[f"ctdne_{bias}_{engine}"] = check_rate(
                f"ctdne {bias} walks {engine}", _walk_diff(res, device, cpu),
                CUT_WALKS, CUT_DIFF_LIMIT)
    del plain, args

    # the cut's COO: the card's CSC build and the CPU's
    dst = np.repeat(np.arange(ns), np.diff(cp))
    c = {d: coo_to_csc_device(on(d, ri), on(d, dst), ns, ns) for d in devs}
    check(all(torch.equal(x.cpu(), y) for x, y in zip(c[device], c[cpu])),
          "coo_to_csc_device: card and CPU builds equal")
    rp_o, ci_o = to_csr(np.stack([ri, dst]), ns)[:2]
    inputs = r.integers(0, ns, CUT_WALKS)
    neg = {d: negative_sample_neighbors_homogenous(
        rp_o, ci_o, (ns, ns), inputs, NEG_NUM, NEG_TRIES, key=rng.key(67),
        device=d) for d in devs}
    check(all(np.array_equal(x, y) for x, y in zip(neg[device][:3],
                                                   neg[cpu][:3])),
          "negative homogeneous: card and CPU equal")
    log("check: phase 10 (g) coo_to_csc_device and negative homogeneous: "
        "card and CPU equal")

    edge_types = mag[1]
    sub_counts, sub_csc, r = mag_cut(mag)
    node_types = sorted(sub_counts)
    csr_m, sizes = mag_csr(sub_counts, edge_types, sub_csc)
    hin = {"paper": r.integers(0, sub_counts["paper"], HETERO_NEG_INPUTS),
           "author": r.integers(0, sub_counts["author"], HETERO_NEG_INPUTS)}
    for inbound in (False, True):
        res = {d: negative_sample_neighbors_heterogenous(
            node_types, edge_types, {k: v[0] for k, v in csr_m.items()},
            {k: v[1] for k, v in csr_m.items()}, sizes, hin, NEG_NUM,
            NEG_TRIES, inbound, key=rng.key(68), device=d) for d in devs}
        check(all(np.array_equal(res[device][i][k], res[cpu][i][k])
                  for i in range(3) for k in res[cpu][i]),
              f"negative heterogeneous inbound {inbound}: card and CPU equal")
    log("check: phase 10 (g) negative heterogeneous (inbound both ways): "
        "card and CPU equal")

    ts = {rel_key(e): r.integers(0, TIME_RANGE, len(sub_csc[rel_key(e)][1]))
          for e in edge_types}
    seeds = {"paper": r.integers(0, sub_counts["paper"], HGT_SEEDS)}
    bseeds = {"paper": r.integers(0, sub_counts["paper"], BUDGET_SEEDS)}
    seed_ts = {"paper": r.integers(0, TIME_RANGE, BUDGET_SEEDS)}
    engines = (("ELL", {}), ("plain", dict(ell_table=False,
                                           window_table=False)))
    for engine, kw in engines:
        graphs = {d: {rel_key(e): make_graph(
            *sub_csc[rel_key(e)], num_src=sub_counts[e[0]],
            num_dst=sub_counts[e[2]], device=d, **kw) for e in edge_types}
            for d in devs}
        for temporal in (False, True):
            mode = "temporal" if temporal else "uniform"
            s = {d: sample_hgt(
                graphs[d], edge_types, seeds,
                {t: CUT_HGT_SAMPLES for t in node_types},
                len(CUT_HGT_SAMPLES),
                node_counts=sub_counts,
                edge_timestamps=ts if temporal else None,
                input_timestamps={"paper": seed_ts["paper"][:HGT_SEEDS]}
                if temporal else None,
                timerange=TEMPORAL_WINDOW if temporal else None,
                node_types=node_types, key=rng.key(69)) for d in devs}
            out[f"hgt_{mode}_{engine}"] = check_rate(
                f"HGT {mode} {engine} (valid slots)",
                *sample_diff(s[device], s[cpu], "node_ts"), CUT_DIFF_LIMIT)
        for name, window, relative in BUDGET_CONFIGS[:CUT_BUDGET_CONFIGS]:
            s = {d: sample_budget(
                graphs[d], edge_types, bseeds,
                {t: BUDGET_FANOUTS for t in node_types},
                len(BUDGET_FANOUTS), edge_timestamps=ts,
                input_timestamps=seed_ts, window=window, forward=True,
                relative=relative, node_types=node_types, key=rng.key(70))
                for d in devs}
            out[f"budget_{name}_{engine}"] = check_rate(
                f"budget {name} {engine} (valid slots)",
                *sample_diff(s[device], s[cpu], "node_ts"), CUT_DIFF_LIMIT)
    return out


def _walk_diff(res, device, cpu):
    """Walks (rows) whose nodes or timestamps differ card vs CPU."""
    (wa, ta), (wb, tb) = res[device], res[cpu]
    return int(((wa.cpu() != wb) | (ta.cpu() != tb)).any(dim=1).sum())


def phase10(p, mag, sg, device, timer):
    """Phase 10: (a)-(g), each part's wall seconds logged; returns its
    numbers and (a)'s host out-edge CSR of products."""
    t0 = time.perf_counter()
    res, secs = {}, {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        log(f"phase 10 {name}: {secs[name]:.1f}s")
        return out

    res["data_layer"], csr = part("(a)", lambda: data_layer(p, sg, device,
                                                              timer))
    res["walks"], out_g = part("(b)", lambda: walk_requests(p, csr, device,
                                                            timer))
    res["negative"] = part("(c)", lambda: negative_requests(
        p, csr, out_g, mag, device, timer))
    del out_g
    hdata, ts = part("mag HeteroData", lambda: mag_hetero_data(mag))
    res["hgt"] = part("(d)", lambda: hgt_requests(mag, hdata, ts, device,
                                                  timer))
    res["budget"] = part("(e)", lambda: budget_requests(mag, hdata, ts,
                                                        device, timer))
    res["transforms"] = part("(f)", lambda: transform_requests(
        p, hdata, device, timer))
    del hdata
    res["card_vs_cpu"] = part("(g)", lambda: check_phase10_card_vs_cpu(
        sg, mag, device))
    res["part_s"] = secs
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 10 wall time {res['wall_s']:.1f}s")
    return res, csr


# ---------------------------------------------------------------------------
# Phase 11: the HGT, node2vec and link-prediction models and trainers
# ---------------------------------------------------------------------------

# scripts/bench_partitioned_hgt.py:47-52 (BASELINE.md "Round-4"); 349 is
# ogbn-mag's venue classes
HGT_HIDDEN, HGT_OUT, HGT_LAYERS, HGT_HEADS = 128, 349, 2, 4
HGT_TRAIN_SEEDS, HGT_TRAIN_SAMPLES = 512, [128, 128]
TIMED_STEPS = 5                 # after one warm-up step
# OGB's examples/nodeproppred/products/node2vec.py
N2V_DIM, N2V_CONTEXT, N2V_NEG, N2V_LR = 128, 20, 1, 0.01
# at p = q = 1 a walk's first draw is always accepted, so one trial gives
# the walks of the trainer's default 16 (checked on the card, and the 16
# trials' walk is timed beside it)
N2V_TRIALS = 1
LINK_EDGES, LINK_NEG, LINK_TRIES = 1024, 1, 8
# (d)'s link steps on the 5% cut: 768 seeds to the sampler (the CPU takes
# about 25 s a step for phase 7 (d)'s 1,024)
LINK_CUT_EDGES = 256
CUT_STEPS = 3
CUT_FORWARD_RTOL = 1e-4         # HGT forward and gradients, card vs CPU
N2V_CUT_RTOL = 1e-5             # node2vec losses, card vs CPU
# (e)'s windows: an HGT step is ~480k profiler events (the samplers' int64
# threefry), whose parse by ``prof.events()`` took 120 s for 3 steps on
# the H100's host, and the node2vec window's 42 s
PROFILE_STEPS = 1


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the largest |b|."""
    return maxerr(a, b) / max(float(b.float().abs().max()), 1e-30)


def mag_features(counts, device, seed=80):
    """``MAG_FEATURES`` seeded N(0, 1) columns for every node type."""
    gen = torch.Generator().manual_seed(seed)
    return {t: torch.randn(c, MAG_FEATURES, generator=gen).to(device)
            for t, c in sorted(counts.items())}


def hgt_model(counts, edge_types, stacked, device, seed=81):
    from tch_geometric_tpu_torch.models import HGT
    from tch_geometric_tpu_torch.utils.types import rel_key
    return HGT(MAG_FEATURES, HGT_HIDDEN, HGT_OUT, HGT_LAYERS, sorted(counts),
               sorted((rel_key(e), e[0], e[2]) for e in edge_types), "paper",
               heads=HGT_HEADS, stacked_rels=stacked, device=device,
               generator=torch.Generator().manual_seed(seed))


def hgt_trainer(model, counts, edge_types, graphs, x, **kw):
    from tch_geometric_tpu_torch.parallel import make_hgt_trainer
    return make_hgt_trainer(model, graphs, edge_types,
                            {t: HGT_TRAIN_SAMPLES for t in counts},
                            len(HGT_TRAIN_SAMPLES), counts, x,
                            seed_type="paper", learning_rate=TRAIN_LR, **kw)


def sample_loss(model, batch, labels):
    """Mean cross entropy of the model on one drawn ``(sample, feats,
    edges)``: a fixed batch's loss."""
    with torch.no_grad():
        _s, feats, edges = batch
        logits = model(feats, edges)[: labels.shape[0]]
        return float(torch.nn.functional.cross_entropy(logits, labels))


def timed_steps(timer, step, what):
    """One warm-up and ``TIMED_STEPS`` calls of ``step()``, which returns
    its loss, on the timer, with peak device memory; each loss must be
    finite.  Returns the numbers."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for _ in range(1 + TIMED_STEPS):
        loss, t = timer(step)
        ms.append(t)
        losses.append(float(loss))
        check(np.isfinite(losses[-1]), f"{what}: loss finite")
    res = dict(step_ms=ms[1:], first_step_ms=ms[0],
               step_ms_mean=float(np.mean(ms[1:])),
               peak_device_gib=peak_gib(), losses=losses)
    log(f"phase 11 {what}: step ms (first, warm-up) {ms[0]:.1f}, then "
        + ", ".join(f"{m:.1f}" for m in ms[1:])
        + f"; mean {res['step_ms_mean']:.2f} ms; peak device memory "
        f"{res['peak_device_gib']:.2f} GiB; losses "
        + ", ".join(f"{v:.4f}" for v in losses))
    return res


def hgt_phase(mag, device, timer):
    """Phase 11 (a): ``HGT(hidden 128, out 349, 2 layers, 4 heads)`` on the
    mag-shaped graph, 128 seeded N(0, 1) feature columns a type, seeded
    paper labels, 512 paper seeds a step, [128, 128] per type, Adam at
    1e-3: per layout (per relation, relation-batched) a warm-up and
    ``TIMED_STEPS`` timed steps; then ``FIT_STEPS`` steps on one fixed
    batch of seeds (per relation; each step draws its own sample), whose
    loss on one fixed sample of them must fall; one temporal step (edge
    timestamps in [0, 1000), timerange (0, 400)).
    Returns the numbers and the per-relation trainer for (e)."""
    from tch_geometric_tpu_torch.sampling import rng
    counts, edge_types, csc = mag
    graphs = hetero_graphs(counts, edge_types, csc, device)
    x = mag_features(counts, device)
    labels = torch.from_numpy(np.random.default_rng(82).integers(
        0, HGT_OUT, counts["paper"])).to(device)
    r = np.random.default_rng(83)
    key = rng.key(84)
    out, trainers = {}, {}
    for stacked in (False, True):
        name = "stacked" if stacked else "per_rel"
        model = hgt_model(counts, edge_types, stacked, device)
        tr = hgt_trainer(model, counts, edge_types, graphs, x)
        state = tr.init_fn()

        def step():
            nonlocal state
            seeds = torch.from_numpy(r.integers(
                0, counts["paper"], HGT_TRAIN_SEEDS)).to(device)
            state, loss, _acc = tr.train_step(state, key, seeds,
                                              labels[seeds])
            return loss
        out[name] = timed_steps(timer, step, f"(a) HGT {name}, "
                                f"{HGT_TRAIN_SEEDS} papers a step")
        trainers[name] = (tr, state, model)
        del model

    tr, state, model = trainers["per_rel"]
    seeds = torch.from_numpy(r.integers(0, counts["paper"],
                                        HGT_TRAIN_SEEDS)).to(device)
    batch = tr.sample_and_gather(rng.key(85), seeds)
    before = sample_loss(model, batch, labels[seeds])
    for _ in range(FIT_STEPS):
        state, _, _ = tr.train_step(state, key, seeds, labels[seeds])
    after = sample_loss(model, batch, labels[seeds])
    log(f"phase 11 (a) HGT per_rel: {FIT_STEPS} steps on one batch: loss "
        f"of one fixed sample {before:.4f} -> {after:.4f}")
    check(after < before, f"HGT: {FIT_STEPS} steps on one batch lower its "
          f"loss ({before:.4f} -> {after:.4f})")
    out["fit_loss_before"], out["fit_loss_after"] = before, after
    del batch

    _w, ts = hetero_edge_values(graphs, 86, device)
    model_t = hgt_model(counts, edge_types, False, device)
    tr_t = hgt_trainer(model_t, counts, edge_types, graphs, x,
                       edge_timestamps=ts, timerange=TEMPORAL_WINDOW)
    (_st, loss, _acc), t = timer(lambda: tr_t.train_step(
        tr_t.init_fn(), key, seeds, labels[seeds]))
    check(np.isfinite(float(loss)), "HGT temporal: loss finite")
    log(f"phase 11 (a) HGT per_rel temporal, timerange {TEMPORAL_WINDOW}: "
        f"one step {t:.1f} ms (the first of its trainer), loss "
        f"{float(loss):.4f}")
    out["temporal_step_ms"] = t
    return out, dict(trainer=tr, state=state, seeds=seeds,
                     labels=labels[seeds], key=key)


def node2vec_phase(csr, n, device, timer):
    """Phase 11 (b): ``Node2Vec(num_nodes, 128, context 20, 1 negative)`` on
    the products out-edge CSR, walks of 40 from 2,560 starts a step (256
    nodes x 10 walks), p = q = 1, Adam at 0.01 over the dense table: a
    warm-up and ``TIMED_STEPS`` timed steps, then ``FIT_STEPS`` steps on
    one fixed batch of walks and negatives, whose loss must fall.  One step
    key's walks and negatives at ``N2V_TRIALS`` trials equal the trainer's
    default 16 trials', whose draw is timed."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.models import (Node2Vec,
                                                make_node2vec_trainer)
    from tch_geometric_tpu_torch.sampling import rng
    g = make_graph(csr[0], csr[1], num_src=n, num_dst=n, device=device)
    model = Node2Vec(n, N2V_DIM, N2V_CONTEXT, N2V_NEG, device=device,
                     generator=torch.Generator().manual_seed(87))
    tr = make_node2vec_trainer(model, g, walk_length=WALK_LENGTH,
                               learning_rate=N2V_LR, num_trials=N2V_TRIALS)
    r = np.random.default_rng(88)
    key = rng.key(89)
    starts = torch.from_numpy(r.integers(0, n, WALK_STARTS)).to(device)
    one, t1 = timer(lambda: tr.walks_and_negs(key, starts))
    default = make_node2vec_trainer(model, g, walk_length=WALK_LENGTH)
    full, t16 = timer(lambda: default.walks_and_negs(key, starts))
    check(all(torch.equal(a, b) for a, b in zip(one, full)),
          f"node2vec at p = q = 1: {N2V_TRIALS} and 16 trials draw the same "
          "walks and negatives")
    log(f"phase 11 (b) node2vec walks and negatives of one step key: "
        f"{N2V_TRIALS} trial {t1:.1f} ms, the default 16 trials {t16:.1f} "
        "ms, equal")
    del one, full
    state = tr.init_fn()

    def step():
        nonlocal state
        s = torch.from_numpy(r.integers(0, n, WALK_STARTS)).to(device)
        state, loss = tr.train_step(state, key, s)
        return loss
    out = timed_steps(timer, step, f"(b) node2vec, {WALK_STARTS} walks a "
                      "step")
    out.update(walks_1_trial_ms=t1, walks_16_trials_ms=t16,
               out_max_degree=g.max_degree, ell=g.ell is not None)
    # one fixed batch: the step count pinned at 0, so each step draws the
    # walks and negatives of fold(fit_key, 0) from the same starts
    fit_key = rng.key(90)
    walks, neg = tr.walks_and_negs(rng.fold(fit_key, 0), starts)
    with torch.no_grad():
        before = float(model.loss(walks, neg))
    steps = state.step
    for _ in range(FIT_STEPS):
        state, _ = tr.train_step(state._replace(step=0), fit_key, starts)
    state = state._replace(step=steps + FIT_STEPS)
    with torch.no_grad():
        after = float(model.loss(walks, neg))
    log(f"phase 11 (b) node2vec: {FIT_STEPS} steps on one fixed batch of "
        f"walks and negatives: its loss {before:.4f} -> {after:.4f}")
    check(after < before, f"node2vec: {FIT_STEPS} steps on one batch lower "
          f"its loss ({before:.4f} -> {after:.4f})")
    out.update(fit_loss_before=before, fit_loss_after=after)
    return out, dict(trainer=tr, state=state, key=key, r=r, n=n)


def link_edges(col_ptrs, row_indices, m, r):
    """``m`` edges of a host CSC drawn uniformly: (src, dst)."""
    e = r.integers(0, len(row_indices), m)
    return row_indices[e], np.searchsorted(col_ptrs, e, side="right") - 1


def link_model(f, device):
    from tch_geometric_tpu_torch.models import GraphSAGE
    return GraphSAGE(f, 256, 256, 3, dropout=TRAIN_DROPOUT, device=device,
                     generator=torch.Generator().manual_seed(91))


def link_trainer(model):
    from tch_geometric_tpu_torch.parallel import make_link_trainer
    return make_link_trainer(model, FANOUTS, num_neg=LINK_NEG,
                             try_count=LINK_TRIES, learning_rate=TRAIN_LR)


def link_phase(p, device, timer):
    """Phase 11 (c): ``make_link_trainer(GraphSAGE(100, 256, 256, 3 layers,
    dropout 0.5), [15, 10, 5], 1 negative, 8 tries, Adam at 1e-3)`` on the
    products CSC and features, 1,024 positive edges a step (3,072 seeds to
    the sampler): a warm-up and ``TIMED_STEPS`` timed steps; each step's
    negatives drawn again from its key: the accepted share, and no accepted
    negative is an edge from its source (the probe's direction) or equals
    either endpoint."""
    from tch_geometric_tpu_torch.sampling import rng
    g, x = p["graph"], p["x_table"]
    model = link_model(x.shape[1], device)
    tr = link_trainer(model)
    state = tr.init_fn()
    key = rng.key(92)
    r = np.random.default_rng(93)
    batches = []

    def step():
        nonlocal state
        src, dst = (torch.from_numpy(a).to(device) for a in link_edges(
            p["col_ptrs"], p["row_indices"], LINK_EDGES, r))
        batches.append((state.step, src, dst))
        state, loss, _rank = tr.train_step(state, key, g, x, src, dst)
        return loss
    out = timed_steps(timer, step, f"(c) link, {LINK_EDGES} edges a step")
    shares = []
    for i, src, dst in batches:
        neg, ok = tr.negatives(rng.fold(key, i), g, src, dst)
        s, d = src[:, None].expand_as(neg)[ok], dst[:, None].expand_as(neg)[ok]
        check(bool((neg[ok] != s).all() & (neg[ok] != d).all()),
              "link: no accepted negative equals an endpoint")
        check(not bool(g.has_edge(neg[ok], s).any()),
              "link: no accepted negative is an edge from its source")
        shares.append(float(ok.float().mean()))
    out["accepted_share"] = shares
    log("phase 11 (c) link: accepted negatives per step "
        + ", ".join(f"{v:.4f}" for v in shares) + "; none an edge from its "
        "source or an endpoint")
    return out


def check_link_card_vs_cpu(sg, device):
    """Phase 11 (d), link: (c)'s trainer on the 5% products subgraph,
    ``CUT_STEPS`` steps of ``LINK_CUT_EDGES`` edges from the same
    parameters, key and edges on the card and the CPU (samples, negatives
    and dropout masks bit-equal); losses within ``TRAIN_REL_THRESHOLD``
    relative."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.sampling import rng
    ns = sg["ns"]
    card = link_model(sg["xs"].shape[1], device)
    cpu = copy.deepcopy(card).cpu()
    g_cpu = make_graph(sg["cp"], sg["ri"], num_src=ns, num_dst=ns,
                       device="cpu")
    r = np.random.default_rng(94)
    edges = [link_edges(sg["cp"], sg["ri"], LINK_CUT_EDGES, r)
             for _ in range(CUT_STEPS)]
    res = {}
    for side, model, g, xs in (("card", card, sg["g"], sg["xs"]),
                               ("cpu", cpu, g_cpu, sg["xs"].cpu())):
        tr = link_trainer(model)
        state, losses = tr.init_fn(), []
        for src, dst in edges:
            state, loss, _ = tr.train_step(state, rng.key(95), g, xs, src,
                                           dst)
            losses.append(float(loss))
        res[side] = losses
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["card"], res["cpu"]))
    log(f"check: phase 11 (d) link card vs CPU on the {ns}-node subgraph, "
        f"{CUT_STEPS} steps: losses card {res['card']}, CPU {res['cpu']}; "
        f"largest relative difference {rel:.3e} (limit "
        f"{TRAIN_REL_THRESHOLD})")
    check(rel <= TRAIN_REL_THRESHOLD, f"link losses card vs CPU: {rel:.3e}")
    return dict(losses_card=res["card"], losses_cpu=res["cpu"],
                max_rel_loss_diff=rel)


def check_node2vec_card_vs_cpu(sg, device):
    """Phase 11 (d), node2vec: (b)'s trainer on the 5% cut's out-edge CSR,
    ``CUT_STEPS`` steps from the same table, key and starts on the card
    and the CPU: each step's walks and negatives exactly equal, losses
    within ``N2V_CUT_RTOL`` relative."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.data.storage import to_csr
    from tch_geometric_tpu_torch.models import (Node2Vec,
                                                make_node2vec_trainer)
    from tch_geometric_tpu_torch.sampling import rng
    ns, cp, ri = sg["ns"], sg["cp"], sg["ri"]
    rp, ci, _ = to_csr(np.stack([ri, np.repeat(np.arange(ns),
                                               np.diff(cp))]), ns)
    card = Node2Vec(ns, N2V_DIM, N2V_CONTEXT, N2V_NEG, device=device,
                    generator=torch.Generator().manual_seed(96))
    cpu = copy.deepcopy(card).cpu()
    starts = np.random.default_rng(97).integers(0, ns, (CUT_STEPS,
                                                        WALK_STARTS))
    res, draws = {}, {}
    for side, model, dev in (("card", card, device), ("cpu", cpu, "cpu")):
        g = make_graph(rp, ci, num_src=ns, num_dst=ns, device=dev)
        tr = make_node2vec_trainer(model, g, walk_length=WALK_LENGTH,
                                   learning_rate=N2V_LR,
                                   num_trials=N2V_TRIALS)
        state, losses, draws[side] = tr.init_fn(), [], []
        for i, s in enumerate(starts):
            draws[side].append([a.cpu() for a in tr.walks_and_negs(
                rng.fold(rng.key(98), i), s)])
            state, loss = tr.train_step(state, rng.key(98), s)
            losses.append(float(loss))
        res[side] = losses
    check(all(torch.equal(a, b) for x, y in zip(draws["card"], draws["cpu"])
              for a, b in zip(x, y)),
          "node2vec card vs CPU: every step's walks and negatives equal")
    rel = max(abs(a - b) / abs(b) for a, b in zip(res["card"], res["cpu"]))
    pdiff = rel_err(card.embedding.weight.detach(),
                    cpu.embedding.weight.detach().to(device))
    log(f"check: phase 11 (d) node2vec card vs CPU on the cut's out-edge "
        f"CSR, {CUT_STEPS} steps: walks and negatives equal; losses card "
        f"{res['card']}, CPU {res['cpu']}; largest relative difference "
        f"{rel:.3e} (limit {N2V_CUT_RTOL}); table relative difference "
        f"{pdiff:.3e}")
    check(rel <= N2V_CUT_RTOL, f"node2vec losses card vs CPU: {rel:.3e}")
    return dict(losses_card=res["card"], losses_cpu=res["cpu"],
                max_rel_loss_diff=rel, table_rel_diff=pdiff)


def hgt_grad_errs(card, cpu):
    """HGT gradients, card against CPU: the largest per-tensor relative
    difference and its tensor, save the key linears' biases, whose gradient
    is zero in exact arithmetic (a bias adds one score to all of a
    destination's in-edges of a relation, and the softmax cancels it): for
    those, the largest value on either side over the largest gradient."""
    scale = max(float(g.abs().max()) for g in cpu.values())
    err, worst, noise = 0.0, "", 0.0
    for k, g in cpu.items():
        a = card[k]
        if ".k." in k and k.endswith(".bias"):
            noise = max(noise, float(a.abs().max()) / scale,
                        float(g.abs().max()) / scale)
            continue
        e = rel_err(a, g.to(a.device))
        if e >= err:
            err, worst = e, k
    return err, worst, noise


def check_hgt_card_vs_cpu(mag, device):
    """Phase 11 (d), HGT on ``mag_cut``: (i) per layout, the model's
    forward and gradients on one sample drawn on the CPU and copied to the
    card, within ``CUT_FORWARD_RTOL`` of the largest value of each (the
    key biases' gradients, zero in exact arithmetic, within it of the
    largest gradient: ``hgt_grad_errs``); (ii)
    ``CUT_STEPS`` trainer steps (per relation) on both: each step's sample
    redrawn from its key, the differing slots at most ``CUT_DIFF_LIMIT`` of
    the valid ones, and the losses within ``TRAIN_REL_THRESHOLD`` relative
    when no slot differs."""
    from tch_geometric_tpu_torch.sampling import rng
    cpu = torch.device("cpu")
    edge_types = mag[1]
    sub_counts, sub_csc, r = mag_cut(mag)
    x = {cpu: mag_features(sub_counts, cpu, seed=99)}
    x[device] = {t: v.to(device) for t, v in x[cpu].items()}
    graphs = {d: hetero_graphs(sub_counts, edge_types, sub_csc, d)
              for d in (device, cpu)}
    labels = torch.from_numpy(r.integers(0, HGT_OUT, sub_counts["paper"]))
    seeds = torch.from_numpy(r.integers(0, sub_counts["paper"],
                                        (CUT_STEPS, HGT_TRAIN_SEEDS)))
    out = {}
    for stacked in (False, True):
        name = "stacked" if stacked else "per_rel"
        models = {device: hgt_model(sub_counts, edge_types, stacked, device)}
        models[cpu] = copy.deepcopy(models[device]).cpu()
        tr_cpu = hgt_trainer(models[cpu], sub_counts, edge_types,
                             graphs[cpu], x[cpu])
        _s, feats, edges = tr_cpu.sample_and_gather(rng.key(100), seeds[0])
        y = labels[seeds[0]]
        res = {}
        for d in (device, cpu):
            f = {t: v.to(d) for t, v in feats.items()}
            e = {k: tuple(a.to(d) for a in v) for k, v in edges.items()}
            logits = models[d](f, e)
            loss = torch.nn.functional.cross_entropy(
                logits[: y.shape[0]], y.to(d))
            params = dict(models[d].named_parameters())
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            res[d] = (logits.detach(), {k: g for k, g in zip(params, grads)
                                        if g is not None})
        lerr = rel_err(res[device][0], res[cpu][0].to(device))
        gerr, worst, noise = hgt_grad_errs(res[device][1], res[cpu][1])
        log(f"check: phase 11 (d) HGT {name} on the cut, one CPU sample on "
            f"both: logits relative difference {lerr:.3e}, gradients "
            f"{gerr:.3e} ({worst}; limit {CUT_FORWARD_RTOL} each); the key "
            "biases' gradients, zero in exact arithmetic, at most "
            f"{noise:.3e} of the largest gradient")
        check(lerr <= CUT_FORWARD_RTOL and gerr <= CUT_FORWARD_RTOL
              and noise <= CUT_FORWARD_RTOL,
              f"HGT {name} forward and gradients card vs CPU: {lerr:.3e}, "
              f"{gerr:.3e}, {noise:.3e}")
        out[name] = dict(logits_rel_diff=lerr, grads_rel_diff=gerr,
                         grads_worst=worst, key_bias_grad_share=noise)

        if stacked:
            continue
        key = rng.key(101)
        losses, diffs = {}, []
        trainers = {d: hgt_trainer(models[d], sub_counts, edge_types,
                                   graphs[d], x[d]) for d in (device, cpu)}
        states = {d: tr.init_fn() for d, tr in trainers.items()}
        for i in range(CUT_STEPS):
            s = {d: trainers[d].sample_and_gather(rng.fold(key, i), seeds[i])
                 [0] for d in (device, cpu)}
            diffs.append(sample_diff(s[device], s[cpu], "node_ts"))
            for d, tr in trainers.items():
                states[d], loss, _ = tr.train_step(states[d], key, seeds[i],
                                                   labels[seeds[i]])
                losses.setdefault(d, []).append(float(loss))
        differ = sum(dd for dd, _v in diffs)
        valid = sum(v for _d, v in diffs)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[device],
                                                      losses[cpu]))
        out["steps"] = check_rate(
            "HGT trainer samples (valid slots)", differ, valid,
            CUT_DIFF_LIMIT, where="phase 11 (d)")
        log(f"check: phase 11 (d) HGT {CUT_STEPS} trainer steps: losses card "
            f"{losses[device]}, CPU {losses[cpu]}; largest relative "
            f"difference {rel:.3e} (limit {TRAIN_REL_THRESHOLD} when no slot "
            "differs)")
        if differ == 0:
            check(rel <= TRAIN_REL_THRESHOLD,
                  f"HGT losses card vs CPU: {rel:.3e}")
        out["steps"].update(losses_card=losses[device], losses_cpu=losses[cpu],
                            max_rel_loss_diff=rel)
    return out


def profile_phase11(hgt, n2v, device):
    """Phase 11 (e): ``torch.profiler`` windows over ``PROFILE_STEPS`` HGT
    steps and as many node2vec steps ((a)'s and (b)'s trainers and
    states), read as phase 8 reads its windows."""
    from tch_geometric_tpu_torch.utils.metrics import profile, trace_span
    out = {}

    def hgt_steps():
        for _ in range(PROFILE_STEPS):
            hgt["state"], _, _ = hgt["trainer"].train_step(
                hgt["state"], hgt["key"], hgt["seeds"], hgt["labels"])

    def n2v_steps():
        for _ in range(PROFILE_STEPS):
            s = torch.from_numpy(n2v["r"].integers(0, n2v["n"], WALK_STARTS))
            n2v["state"], _ = n2v["trainer"].train_step(
                n2v["state"], n2v["key"], s.to(device))

    for name, fn in ((f"hgt_train_{PROFILE_STEPS}_steps", hgt_steps),
                     (f"node2vec_train_{PROFILE_STEPS}_steps", n2v_steps)):
        torch.cuda.synchronize()
        logdir = os.path.join(PROFILE_DIR, name)
        with profile(logdir):
            with trace_span("window"):
                fn()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
        t1 = time.perf_counter()
        r = out[name] = trace_split(logdir, "window")
        r.update(export_s=t1 - t0, split_s=time.perf_counter() - t1)
        log(f"profile {name}: window {r['window_ms']:.2f} ms, device busy "
            f"{r['device_busy_ms']:.2f} ms, idle share {r['idle_share']:.3f}; "
            "device ms by span: " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["device_ms_by_span"].items())
            + "; top 10 device ops by own time: " + "; ".join(
                f"{short_op(o['name'])} x{o['count']} {o['ms']:.3f} ms"
                for o in r["top10"])
            + f"; trace export {r['export_s']:.1f} s, trace read and split "
            f"{r['split_s']:.1f} s")
    return out


def phase11(p, mag, csr, sg, device, timer):
    """Phase 11: (a)-(e), each part's wall seconds and the peak device
    memory since the part began logged; returns its numbers."""
    t0 = time.perf_counter()
    res, secs = {}, {}

    def part(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        log(f"phase 11 {name}: {secs[name]:.1f}s, peak device memory "
            f"{peak_gib():.2f} GiB")
        return out

    res["hgt"], hgt = part("(a)", lambda: hgt_phase(mag, device, timer))
    res["node2vec"], n2v = part("(b)", lambda: node2vec_phase(
        csr, p["data"].num_nodes, device, timer))
    res["link"] = part("(c)", lambda: link_phase(p, device, timer))
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = part("(d)", lambda: dict(
        link=check_link_card_vs_cpu(sg, device),
        node2vec=check_node2vec_card_vs_cpu(sg, device),
        hgt=check_hgt_card_vs_cpu(mag, device)))
    res["profile"] = part("(e)", lambda: profile_phase11(hgt, n2v, device))
    res["part_s"] = secs
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 11 wall time {res['wall_s']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# Phase 12: the partitioned graph, owner-routed exchanges, partitioned SAGE
# ---------------------------------------------------------------------------

DIST_PARTS = 4                  # thread ranks sharing the one card
DIST_CF = 1.3                   # scripts/bench_partitioned_products.py:85
DIST_CHECK_ROWS = 1000
DIST_TIMED = 5                  # requests or steps after one warm-up
DIST_LOSS_STEPS = 3             # (c)'s losses compared across P
DIST_MB_M = 8                   # bench_partitioned_products.py:139-140
DIST_MB_B = 512                 # its seeds a minibatch (:72)
DIST_MB_CALLS = 3               # after one warm-up
DIST_CUT_SEEDS = 256            # (e): seeds a request or step on the 5% cut
DIST_LOSS_RTOL = 1e-5
DIST_STORE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build", "dist_store")


def dist_meshes(device, store=DIST_STORE, what="phase 12"):
    """P = 1 over a real process group of world size 1 (NCCL on the card,
    a fresh ``file://`` store under ``build/``) and P = ``DIST_PARTS``
    thread ranks on the same device."""
    from tch_geometric_tpu_torch.parallel import make_mesh, multihost
    from tch_geometric_tpu_torch.parallel.mesh import (ProcessGroupComm,
                                                       ThreadComm)
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    multihost.initialize("file://" + store, 1, 0, device=device)
    one = multihost.make_mesh(("data",), device=device)
    check(isinstance(one.comm, ProcessGroupComm) and one.size == 1,
          "P = 1 runs over the process group")
    import torch.distributed as dist
    log(f"{what}: process group backend {dist.get_backend()}, world "
        f"size {dist.get_world_size()}; {DIST_PARTS} thread ranks on "
        f"{device}")
    return {1: one, DIST_PARTS: make_mesh((DIST_PARTS, 1), device=device,
                                          comm=ThreadComm(DIST_PARTS))}


def check_partitioned_rows(g, cp, ri, P, seed=60):
    """``DIST_CHECK_ROWS`` seeded rows of the partitioned graph against the
    CSC: degree, global start, the owner's neighbor window and the ELL
    row.  Returns the count of rows that disagree."""
    N, E = cp.shape[0] - 1, ri.shape[0]
    v = torch.from_numpy(np.random.default_rng(seed).choice(
        N, min(DIST_CHECK_ROWS, N), replace=False)).to(cp.device)
    deg, start = cp[v + 1] - cp[v], cp[v]
    row = (v % P) * g.rows_per_part + torch.div(v, P, rounding_mode="floor")
    lanes = torch.arange(max(g.max_degree, 1), device=cp.device)
    live = lanes[None, :] < deg[:, None]
    want = ri[(start[:, None] + lanes).clamp(max=E - 1)]
    lptr = ((v % P) * g.local_edge_cap + g.lstart[row].long())[:, None] + lanes
    got = g.lindices[lptr.clamp(max=g.lindices.shape[0] - 1)].long()
    ok = ((g.ldeg[row].long() == deg) & (g.gstart[row].long() == start)
          & ((got == want) | ~live).all(1))
    if g.ell is not None:
        W = g.ell.shape[1]
        ell = g.ell[row].long()
        k = min(W - 2, lanes.shape[0])
        ok &= ((ell[:, :k] == want[:, :k]) | ~live[:, :k]).all(1)
        ok &= (ell[:, W - 2] == deg) & (ell[:, W - 1] == start)
    return int((~ok).sum())


def dist_graphs(p, device, timer):
    """Phase 12 (a): ``build_partitioned_graph`` of phase 3's CSC at P = 1
    and P = ``DIST_PARTS`` on the card, each timed with its device bytes
    and ``DIST_CHECK_ROWS`` seeded rows checked against the CSC."""
    from tch_geometric_tpu_torch.parallel import build_partitioned_graph
    cp = torch.from_numpy(p["col_ptrs"]).to(device)
    ri = torch.from_numpy(p["row_indices"]).to(device)
    graphs, out = {}, {}
    for P in (1, DIST_PARTS):
        g, ms = timer(lambda: build_partitioned_graph(cp, ri, P,
                                                      device=device))
        bad = check_partitioned_rows(g, cp, ri, P)
        gib = g.nbytes() / 2**30
        log(f"phase 12 (a) build_partitioned_graph P={P}: {ms:.1f} ms, "
            f"{gib:.3f} GiB on the device (rows a part {g.rows_per_part}, "
            f"edge cap a part {g.local_edge_cap}, ELL "
            f"{'yes' if g.ell is not None else 'no'}); {bad} of "
            f"{DIST_CHECK_ROWS} checked rows differ from the CSC")
        check(bad == 0, f"partitioned graph P={P} rows equal the CSC")
        graphs[P] = g
        out[P] = dict(build_ms=ms, device_gib=gib, bad_rows=bad)
    return graphs, out


def dist_layers(s, P):
    """The per-layer concatenation of a distributed sample's rank blocks
    (the P = 1 layout), ids, edge pointers and states masked by validity,
    and that layout's node bases."""
    nb, eb = s.node_base, s.edge_base
    out = {}
    for f, base, mask in (("nodes", nb, "node_valid"),
                          ("node_state", nb, "node_valid"),
                          ("node_valid", nb, None),
                          ("eptr", eb, "edge_valid"),
                          ("edge_valid", eb, None)):
        a = getattr(s, f)
        if mask is not None:
            a = torch.where(getattr(s, mask), a, -1)
        out[f] = torch.cat([torch.cat([a[d][base[i]: base[i + 1]]
                                       for d in range(P)])
                            for i in range(len(base) - 1)])
    return out, tuple(P * b for b in nb)


def dist_diff(a, b) -> int:
    """Slots in which two layer dicts of :func:`dist_layers` differ."""
    return sum(int((a[f] != b[f].to(a[f].device)).sum()) for f in a)


def dist_requests(graphs, meshes, n, device, timer):
    """Phase 12 (b): ``dist_sample_neighbors`` of ``SEEDS_PER_REQUEST``
    global seeds, ``FANOUTS``, capacity factor ``DIST_CF``, default rounds,
    one warm-up and ``DIST_TIMED`` requests at each P: ms per request, the
    valid share per hop, overflow 0, and the P = 1 and P = ``DIST_PARTS``
    trees bit-identical."""
    from tch_geometric_tpu_torch.parallel import dist_sample_neighbors
    from tch_geometric_tpu_torch.sampling import rng
    seeds = torch.from_numpy(np.random.default_rng(61).integers(
        0, n, (1 + DIST_TIMED, SEEDS_PER_REQUEST))).to(device)
    trees, out = {}, {}
    for P in (1, DIST_PARTS):
        ms, trees[P], ovf = [], [], 0
        for i in range(1 + DIST_TIMED):
            (s, o), t = timer(lambda: dist_sample_neighbors(
                rng.fold(rng.key(62), i), graphs[P], seeds[i], FANOUTS,
                meshes[P], capacity_factor=DIST_CF))
            ms.append(t)
            ovf += int(o.sum())
            layers, nb = dist_layers(s, P)
            trees[P].append(layers)
        share = [float(layers["node_valid"][nb[h + 1]: nb[h + 2]].float()
                       .mean()) for h in range(len(FANOUTS))]
        out[P] = dict(request_ms=ms[1:], first_ms=ms[0],
                      request_ms_mean=float(np.mean(ms[1:])), overflow=ovf,
                      valid_share_by_hop=share)
        log(f"phase 12 (b) dist_sample_neighbors P={P}: ms per request "
            f"(first {ms[0]:.1f}) " + ", ".join(f"{m:.1f}" for m in ms[1:])
            + f"; mean {out[P]['request_ms_mean']:.2f}; overflow {ovf}; "
            "valid share by hop " + ", ".join(f"{v:.4f}" for v in share))
        check(ovf == 0, f"dist sampler P={P}: overflow 0")
    diff = sum(dist_diff(a, b) for a, b in zip(trees[1], trees[DIST_PARTS]))
    log(f"check: phase 12 (b) the P=1 and P={DIST_PARTS} trees of "
        f"{1 + DIST_TIMED} requests differ in {diff} slots")
    check(diff == 0, "P=1 and P=4 sample trees bit-identical")
    out["differing_slots"] = diff
    return out


def dist_model(device, f, dropout=0.0):
    """``scripts/bench_partitioned_products.py``'s model: GraphSAGE(hidden
    256, 47 classes, 3 layers), dropout 0, weights from a seed."""
    from tch_geometric_tpu_torch.models import GraphSAGE
    return GraphSAGE(f, 256, 47, 3, dropout=dropout, device=device,
                     generator=torch.Generator().manual_seed(63))


def dist_train(p, graphs, meshes, device, timer):
    """Phase 12 (c): ``make_partitioned_trainer`` with the bench's model,
    ``FANOUTS``, Adam at ``TRAIN_LR``, capacity factor ``DIST_CF``,
    ``SEEDS_PER_REQUEST`` global seeds a step, from the same parameters at
    each P: one warm-up and ``DIST_TIMED`` timed steps, ms per step, peak
    device memory, overflow 0; the first ``DIST_LOSS_STEPS`` losses of the
    two P agree within ``DIST_LOSS_RTOL`` relative."""
    from tch_geometric_tpu_torch.parallel import (build_interleaved_features,
                                                  make_partitioned_trainer)
    from tch_geometric_tpu_torch.sampling import rng
    n = p["x_table"].shape[0]
    labels = torch.from_numpy(p["data"].y).to(device)
    seeds = torch.from_numpy(np.random.default_rng(64).integers(
        0, n, (1 + DIST_TIMED, SEEDS_PER_REQUEST))).to(device)
    model0 = dist_model(device, p["x_table"].shape[1])
    out, losses = {}, {}
    for P in (1, DIST_PARTS):
        xi = build_interleaved_features(p["x_table"], P)
        tr = make_partitioned_trainer(copy.deepcopy(model0), FANOUTS,
                                      meshes[P], learning_rate=TRAIN_LR,
                                      capacity_factor=DIST_CF)
        box = {"state": tr.init_fn()}

        def step(i):
            box["state"], loss, acc, ovf = tr.train_step(
                box["state"], rng.key(65), graphs[P], xi, seeds[i],
                labels[seeds[i]])
            return float(loss), int(ovf)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses[P], ovf = [], [], 0
        for i in range(1 + DIST_TIMED):
            (loss, o), t = timer(lambda: step(i))
            ms.append(t)
            losses[P].append(loss)
            ovf += o
            check(np.isfinite(loss), f"partitioned step P={P}: loss finite")
        out[P] = dict(step_ms=ms[1:], first_ms=ms[0],
                      step_ms_mean=float(np.mean(ms[1:])), overflow=ovf,
                      peak_device_gib=peak_gib(), losses=losses[P])
        log(f"phase 12 (c) make_partitioned_trainer P={P}: step ms (first "
            f"{ms[0]:.1f}) " + ", ".join(f"{m:.1f}" for m in ms[1:])
            + f"; mean {out[P]['step_ms_mean']:.2f}; peak device memory "
            f"{out[P]['peak_device_gib']:.2f} GiB; overflow {ovf}; losses "
            + ", ".join(f"{v:.6f}" for v in losses[P]))
        check(ovf == 0, f"partitioned trainer P={P}: overflow 0")
        del xi, tr, box
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        losses[DIST_PARTS][:DIST_LOSS_STEPS], losses[1][:DIST_LOSS_STEPS]))
    log(f"check: phase 12 (c) losses P={DIST_PARTS} against P=1 over "
        f"{DIST_LOSS_STEPS} steps (dropout 0): largest relative difference "
        f"{rel:.3e} (limit {DIST_LOSS_RTOL})")
    check(rel <= DIST_LOSS_RTOL, f"partitioned losses across P: {rel:.3e}")
    out["max_rel_loss_diff"] = rel
    return out


def dist_multibatch(p, g, x, mesh, device, timer, hier=None,
                    what="phase 12 (d)", seed=66):
    """Phase 12 (d): ``make_partitioned_multibatch_trainer`` at M =
    ``DIST_MB_M`` minibatches of ``DIST_MB_B`` seeds (the bench's), P = 1,
    on graph ``g`` and features ``x`` (phase 13 (a): ``hier`` on its (2, 2)
    mesh): one warm-up and ``DIST_MB_CALLS`` calls, ms per minibatch."""
    from tch_geometric_tpu_torch.parallel import (
        make_partitioned_multibatch_trainer)
    from tch_geometric_tpu_torch.sampling import rng
    n = p["x_table"].shape[0]
    labels = torch.from_numpy(p["data"].y).to(device)
    tr = make_partitioned_multibatch_trainer(
        dist_model(device, p["x_table"].shape[1]), FANOUTS, mesh,
        learning_rate=TRAIN_LR, capacity_factor=DIST_CF, hier=hier)
    box = {"state": tr.init_fn()}
    r = np.random.default_rng(seed)

    def call(i):
        s = torch.from_numpy(r.integers(0, n, (DIST_MB_M, DIST_MB_B))).to(
            device)
        box["state"], losses, _, ovf = tr.train_step(
            box["state"], rng.fold(rng.key(seed + 1), i), g, x, s, labels[s])
        return losses.cpu().numpy(), int(ovf)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, ovf = [], 0
    for i in range(1 + DIST_MB_CALLS):
        (losses, o), t = timer(lambda: call(i))
        ms.append(t / DIST_MB_M)
        ovf += o
        check(bool(np.isfinite(losses).all()), "multibatch losses finite")
    out = dict(ms_per_minibatch=ms[1:], first_ms_per_minibatch=ms[0],
               ms_per_minibatch_mean=float(np.mean(ms[1:])), overflow=ovf,
               peak_device_gib=peak_gib())
    shape = tuple(mesh.shape.values())
    log(f"{what} make_partitioned_multibatch_trainer M={DIST_MB_M} x "
        f"{DIST_MB_B} seeds, "
        + (f"P={mesh.size}" if hier is None else f"hier {shape} "
           f"({ranks13(mesh.size)})")
        + f": ms per minibatch (first {ms[0]:.1f}) "
        + ", ".join(f"{m:.1f}" for m in ms[1:])
        + f"; mean {out['ms_per_minibatch_mean']:.2f}; overflow {ovf}; peak "
        f"device memory {out['peak_device_gib']:.2f} GiB")
    check(ovf == 0, f"{what} partitioned multibatch trainer: overflow 0")
    return out


def dist_card_vs_cpu(data, sg, device):
    """Phase 12 (e): on the 5% cut, card against CPU, same keys and seeds:
    (b)'s request at its ``SEEDS_PER_REQUEST`` seeds, the card at P =
    ``DIST_PARTS`` thread ranks and the CPU at P = 1 (the trees do not
    depend on P), differs in 0 slots; at P = ``DIST_PARTS`` on both, a
    request of ``DIST_CUT_SEEDS`` seeds differs in 0 slots, and
    ``DIST_LOSS_STEPS`` steps of (c)'s trainer (same parameters) give
    losses within ``DIST_LOSS_RTOL`` relative."""
    from tch_geometric_tpu_torch.parallel import (build_interleaved_features,
                                                  build_partitioned_graph,
                                                  dist_sample_neighbors,
                                                  make_mesh,
                                                  make_partitioned_trainer)
    from tch_geometric_tpu_torch.parallel.mesh import ThreadComm
    from tch_geometric_tpu_torch.sampling import rng
    cpu = torch.device("cpu")
    ns, P = sg["ns"], DIST_PARTS
    seeds = np.random.default_rng(68).integers(
        0, ns, (DIST_LOSS_STEPS, DIST_CUT_SEEDS))
    full = np.random.default_rng(71).integers(0, ns, SEEDS_PER_REQUEST)
    ys = torch.from_numpy(data.y[sg["keep"]])
    model = dist_model(cpu, data.x.shape[1])
    res, full_trees, full_s = {}, {}, {}
    for side, dev in (("card", device), ("cpu", cpu)):
        t = time.perf_counter()
        mesh = make_mesh((P, 1), device=dev, comm=ThreadComm(P))
        g = build_partitioned_graph(sg["cp"], sg["ri"], P, device=dev)
        pf = P if side == "card" else 1
        mf = mesh if pf == P else make_mesh((1, 1), device=dev,
                                            comm=ThreadComm(1))
        gf = g if pf == P else build_partitioned_graph(sg["cp"], sg["ri"], 1,
                                                       device=dev)
        s, ovf = dist_sample_neighbors(rng.key(72), gf, full, FANOUTS, mf,
                                       capacity_factor=DIST_CF)
        check(int(ovf.sum()) == 0, f"(e) {side}: full request overflow 0")
        full_trees[side] = dist_layers(s, pf)[0]
        full_s[side] = time.perf_counter() - t
        s, ovf = dist_sample_neighbors(rng.key(69), g, seeds[0], FANOUTS,
                                       mesh, capacity_factor=DIST_CF)
        check(int(ovf.sum()) == 0, f"(e) {side}: overflow 0")
        tr = make_partitioned_trainer(copy.deepcopy(model).to(dev), FANOUTS,
                                      mesh, learning_rate=TRAIN_LR,
                                      capacity_factor=DIST_CF)
        xi = build_interleaved_features(sg["xs"].to(dev), P)
        st, losses, y = tr.init_fn(), [], ys.to(dev)
        for i in range(DIST_LOSS_STEPS):
            sd = torch.from_numpy(seeds[i]).to(dev)
            st, loss, _, o = tr.train_step(st, rng.key(70), g, xi, sd, y[sd])
            check(int(o) == 0, f"(e) {side}: trainer overflow 0")
            losses.append(float(loss))
        res[side] = (dist_layers(s, P)[0], losses, time.perf_counter() - t)
    (tc, lc, sc), (th, lh, sh) = res["card"], res["cpu"]
    full_diff = dist_diff(full_trees["card"], full_trees["cpu"])
    diff = dist_diff(tc, th)
    rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    log(f"check: phase 12 (e) card vs CPU on the {ns}-node cut: the "
        f"{SEEDS_PER_REQUEST}-seed trees (card P={P} threads, CPU P=1) "
        f"differ in {full_diff} slots (card {full_s['card']:.1f} s, CPU "
        f"{full_s['cpu']:.1f} s, each with its graph build); at P={P} "
        f"threads the "
        f"{DIST_CUT_SEEDS}-seed trees differ in {diff} slots; losses card "
        f"{lc}, CPU {lh}, largest relative difference {rel:.3e} (limit "
        f"{DIST_LOSS_RTOL}); card {sc:.1f} s, CPU {sh:.1f} s in all")
    check(full_diff == 0, "(e) card and CPU full-size trees equal")
    check(diff == 0, "(e) card and CPU trees equal")
    check(rel <= DIST_LOSS_RTOL, f"(e) card vs CPU losses: {rel:.3e}")
    return dict(full_request_differing_slots=full_diff,
                full_request_s=full_s, differing_slots=diff, losses_card=lc,
                losses_cpu=lh, max_rel_loss_diff=rel, card_s=sc, cpu_s=sh)


def phase12(p, sg, device, timer):
    """Phase 12: (a)-(e), each part's wall seconds logged; returns its
    numbers.  Tears the process group down at the end."""
    from tch_geometric_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    res, secs = {}, {}

    def part(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        log(f"phase 12 {name}: {secs[name]:.1f}s")
        return out

    meshes = dist_meshes(device)
    graphs, res["graphs"] = part("(a)", lambda: dist_graphs(p, device,
                                                            timer))
    n = p["x_table"].shape[0]
    res["requests"] = part("(b)", lambda: dist_requests(graphs, meshes, n,
                                                        device, timer))
    res["train"] = part("(c)", lambda: dist_train(p, graphs, meshes, device,
                                                  timer))
    res["multibatch"] = part("(d)", lambda: dist_multibatch(
        p, graphs[1], p["x_table"], meshes[1], device, timer))
    del graphs
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = part("(e)", lambda: dist_card_vs_cpu(
        p["data"], sg, device))
    multihost.shutdown()
    res["part_s"] = secs
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 12 wall time {res['wall_s']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# Phase 13: the 2-axis mesh: hier= partitioned trainers, the DP+TP trainer
# ---------------------------------------------------------------------------

HIER = ("slice", "chip")
MESH2 = (2, 2)                  # (S, C) and (data, model): 4 thread ranks
DPTP_KEY = 11                   # phase 7 (a)'s key and seed generator
DPTP_SEEDS = 12
CUT_HIER_KEY, CUT_DPTP_KEY = 74, 75
DIST_STORE13 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "dist_store13")


def meshes13(device):
    """Four thread ranks on the card as (S, C) = (2, 2) and ('data',
    'model') = (2, 2) meshes, and (1, 1) meshes of both over a process
    group of world size 1 (NCCL on the card, a ``file://`` store under
    ``build/``), whose single axes run over ``dist.new_group`` groups."""
    from tch_geometric_tpu_torch.parallel import make_mesh, multihost
    from tch_geometric_tpu_torch.parallel.mesh import (ProcessGroupComm,
                                                       ThreadComm)
    os.makedirs(os.path.dirname(DIST_STORE13), exist_ok=True)
    if os.path.exists(DIST_STORE13):
        os.remove(DIST_STORE13)
    multihost.initialize("file://" + DIST_STORE13, 1, 0, device=device)
    out = {}
    for kind, names in (("hier", HIER), ("dptp", ("data", "model"))):
        one = multihost.make_mesh(names, ici_shape=(1, 1), device=device)
        check(isinstance(one.comm, ProcessGroupComm)
              and sorted(one.groups) == sorted((n,) for n in names)
              and all(isinstance(c, ProcessGroupComm)
                      for c in one.groups.values()),
              f"(1, 1) {kind} mesh: a new_group for each axis")
        out[kind] = {1: one, 4: make_mesh(MESH2, names, device=device,
                                          comm=ThreadComm(4))}
    import torch.distributed as dist
    log(f"phase 13: process group backend {dist.get_backend()}, world size "
        f"{dist.get_world_size()}, {len(out['hier'][1].groups)} sub-axis "
        f"groups a (1, 1) mesh; 4 thread ranks on {device} as (2, 2)")
    return out


def steps13(timer, step, what):
    """One warm-up and ``DIST_TIMED`` timed calls of ``step(i) -> (loss,
    overflow)`` with peak device memory: (ms, first ms, losses, overflow,
    peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses, ovf = [], [], 0
    for i in range(1 + DIST_TIMED):
        (loss, o), t = timer(lambda: step(i))
        ms.append(t)
        losses.append(loss)
        ovf += o
        check(np.isfinite(loss), f"{what}: loss finite")
    return ms[1:], ms[0], losses, ovf, peak_gib()


def rel_max(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def ranks13(P: int) -> str:
    """Where a phase 13 mesh's ranks run (four thread ranks on one card are
    a structural check, not a scaling number)."""
    return ("4 thread ranks sharing the card: a structural check" if P > 1
            else "NCCL, world size 1")


def hier13(p, meshes, flat_losses, device, timer):
    """Phase 13 (a), (b): ``make_partitioned_trainer(hier=("slice",
    "chip"))`` with phase 12 (c)'s model, key and seeds, on (2, 2) thread
    ranks (the graph at ``num_parts = 2``, the features interleaved over
    4) and at (1, 1) over the process group: ms per step, peak device
    memory, overflow 0; the first ``DIST_LOSS_STEPS`` losses within
    ``DIST_LOSS_RTOL`` of phase 12 (c)'s flat P = 4 trainer's, and (b)'s of
    (a)'s."""
    from tch_geometric_tpu_torch.parallel import (build_interleaved_features,
                                                  build_partitioned_graph,
                                                  make_partitioned_trainer)
    from tch_geometric_tpu_torch.sampling import rng
    n, f = p["x_table"].shape
    cp = torch.from_numpy(p["col_ptrs"]).to(device)
    ri = torch.from_numpy(p["row_indices"]).to(device)
    labels = torch.from_numpy(p["data"].y).to(device)
    seeds = torch.from_numpy(np.random.default_rng(64).integers(
        0, n, (1 + DIST_TIMED, SEEDS_PER_REQUEST))).to(device)
    model0 = dist_model(device, f)
    out, losses = {}, {}
    for part, P in (("(a)", 4), ("(b)", 1)):
        mesh = meshes[P]
        C = mesh.shape["chip"]
        g = build_partitioned_graph(cp, ri, C, device=device)
        xi = build_interleaved_features(p["x_table"], P)
        tr = make_partitioned_trainer(copy.deepcopy(model0), FANOUTS, mesh,
                                      learning_rate=TRAIN_LR,
                                      capacity_factor=DIST_CF, hier=HIER)
        box = {"state": tr.init_fn()}

        def step(i):
            box["state"], loss, _, ovf = tr.train_step(
                box["state"], rng.key(65), g, xi, seeds[i], labels[seeds[i]])
            return float(loss), int(ovf)

        shape = tuple(mesh.shape.values())
        ms, first, losses[P], ovf, peak = steps13(timer, step,
                                                  f"hier {shape}")
        out[P] = dict(shape=shape, step_ms=ms, first_ms=first,
                      step_ms_mean=float(np.mean(ms)), overflow=ovf,
                      peak_device_gib=peak, losses=losses[P])
        log(f"phase 13 {part} hier {shape} ({ranks13(P)}): step ms (first "
            f"{first:.1f}) " + ", ".join(f"{m:.1f}" for m in ms)
            + f"; mean {out[P]['step_ms_mean']:.2f}; peak device memory "
            f"{peak:.2f} GiB; overflow {ovf}; losses "
            + ", ".join(f"{v:.6f}" for v in losses[P]))
        check(ovf == 0, f"hier trainer {shape}: overflow 0")
        del g, xi, tr, box
        torch.cuda.empty_cache()
    k = DIST_LOSS_STEPS
    out["rel_vs_flat_p4"] = rel_max(losses[4][:k], flat_losses[:k])
    out["rel_11_vs_22"] = rel_max(losses[1][:k], losses[4][:k])
    log(f"check: phase 13 (a) hier (2, 2) losses against phase 12 (c)'s flat "
        f"P={DIST_PARTS} over {k} steps: largest relative difference "
        f"{out['rel_vs_flat_p4']:.3e}; (b) (1, 1) against (a): "
        f"{out['rel_11_vs_22']:.3e} (limit {DIST_LOSS_RTOL})")
    check(out["rel_vs_flat_p4"] <= DIST_LOSS_RTOL,
          f"hier losses vs flat P=4: {out['rel_vs_flat_p4']:.3e}")
    check(out["rel_11_vs_22"] <= DIST_LOSS_RTOL,
          f"hier (1, 1) losses vs (2, 2): {out['rel_11_vs_22']:.3e}")
    return out


def hier_multibatch13(p, mesh, device, timer):
    """Phase 13 (a), multibatch: phase 12 (d)'s trainer with ``hier=`` on
    the (2, 2) thread ranks (the graph at ``num_parts = 2``, the features
    interleaved over 4): ms per minibatch, overflow 0."""
    from tch_geometric_tpu_torch.parallel import (build_interleaved_features,
                                                  build_partitioned_graph)
    g = build_partitioned_graph(torch.from_numpy(p["col_ptrs"]).to(device),
                                torch.from_numpy(p["row_indices"]).to(device),
                                mesh.shape["chip"], device=device)
    return dist_multibatch(p, g, build_interleaved_features(p["x_table"],
                                                            mesh.size),
                           mesh, device, timer, hier=HIER,
                           what="phase 13 (a)", seed=76)


def block_shares(blocks, whole, D):
    """Each data rank's share of its tree slots (nodes, validity, edge
    pointers and edge validity) equal to the whole batch's matching
    slots."""
    nb, eb = whole.node_base, whole.edge_base
    lb, leb = blocks.node_base, blocks.edge_base
    shares = []
    for d in range(D):
        eq = tot = 0
        for base, wbase, fields in ((lb, nb, ("nodes", "node_valid")),
                                    (leb, eb, ("eptr", "edge_valid"))):
            for i in range(len(base) - 1):
                m = base[i + 1] - base[i]
                for fld in fields:
                    a = getattr(blocks, fld)[d, base[i]: base[i + 1]]
                    b = getattr(whole, fld)[wbase[i] + d * m:
                                            wbase[i] + (d + 1) * m]
                    eq += int((a == b).sum())
                    tot += m
        shares.append(eq / tot)
    return shares


def dptp13(p, meshes, device, timer):
    """Phase 13 (c): ``make_gnn_trainer(mesh=)`` with phase 7 (a)'s SAGE
    (hidden 256, 3 layers, 47 classes, dropout 0.5; the hidden layers'
    kernels split over ``model``, the 47-class head replicated), key and
    seeds, on the (2, 2) thread ranks and the (1, 1) NCCL mesh: ms per
    step, peak device memory; the first ``DIST_LOSS_STEPS`` losses within
    ``DIST_LOSS_RTOL`` of phase 7 (a)'s one-device trainer from the same
    parameters; each data rank's 512-seed tree against the whole
    1,024-seed batch's: the share of equal slots must be 1.0."""
    from tch_geometric_tpu_torch.parallel import make_gnn_trainer
    from tch_geometric_tpu_torch.sampling import rng
    graph, x_table = p["graph"], p["x_table"]
    n, f = x_table.shape
    labels = torch.from_numpy(p["data"].y).to(device)
    gen = torch.Generator().manual_seed(DPTP_SEEDS)
    seeds = [torch.randint(0, n, (SEEDS_PER_REQUEST,), generator=gen).to(
        device) for _ in range(1 + DIST_TIMED)]
    key = rng.key(DPTP_KEY)
    model0 = train_model("sage", f, device)
    one = make_gnn_trainer(copy.deepcopy(model0), FANOUTS,
                           learning_rate=TRAIN_LR)
    st, ref = one.init_fn(), []
    for s in seeds[:DIST_LOSS_STEPS]:
        st, loss, _ = one.train_step(st, key, graph, x_table, s, labels[s])
        ref.append(float(loss))
    whole, _ = one.sample_and_gather(key, graph, x_table, seeds[0])
    out = {"one_device_losses": ref}
    for P in (4, 1):
        mesh = meshes[P]
        shape = tuple(mesh.shape.values())
        tr = make_gnn_trainer(copy.deepcopy(model0), FANOUTS,
                              learning_rate=TRAIN_LR, mesh=mesh)
        box = {"state": tr.init_fn()}

        def step(i):
            box["state"], loss, _ = tr.train_step(
                box["state"], key, graph, x_table, seeds[i],
                labels[seeds[i]])
            return float(loss), 0

        ms, first, losses, _, peak = steps13(timer, step, f"DP+TP {shape}")
        rel = rel_max(losses[:DIST_LOSS_STEPS], ref)
        blocks, _ = tr.sample_and_gather(key, graph, x_table, seeds[0])
        shares = block_shares(blocks, whole, mesh.shape["data"])
        out[P] = dict(shape=shape, step_ms=ms, first_ms=first,
                      step_ms_mean=float(np.mean(ms)), peak_device_gib=peak,
                      losses=losses, max_rel_loss_diff=rel,
                      equal_slot_shares=shares)
        log(f"phase 13 (c) DP+TP {shape} ({ranks13(P)}): "
            f"step ms (first {first:.1f}) "
            + ", ".join(f"{m:.1f}" for m in ms)
            + f"; mean {out[P]['step_ms_mean']:.2f}; peak device memory "
            f"{peak:.2f} GiB; losses " + ", ".join(f"{v:.6f}" for v in losses)
            + f"; against the one-device trainer over {DIST_LOSS_STEPS} steps "
            f"(dropout {TRAIN_DROPOUT}) {rel:.3e} (limit {DIST_LOSS_RTOL}); "
            f"share of each data rank's tree slots equal to the whole "
            f"batch's: " + ", ".join(f"{v:.6f}" for v in shares))
        check(rel <= DIST_LOSS_RTOL, f"DP+TP {shape} losses: {rel:.3e}")
        check(all(v == 1.0 for v in shares),
              f"DP+TP {shape}: every data rank's tree is the whole batch's")
        del tr, box, blocks
        torch.cuda.empty_cache()
    return out


def card_vs_cpu13(data, sg, device):
    """Phase 13 (d): on phase 3's 5% cut, card against CPU, same
    parameters, keys and seeds: ``DIST_LOSS_STEPS`` steps of (a)'s hier
    trainer at (2, 2) and of (c)'s DP+TP trainer at (2, 2), each of
    ``DIST_CUT_SEEDS`` seeds; losses within ``DIST_LOSS_RTOL``."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.parallel import (build_interleaved_features,
                                                  build_partitioned_graph,
                                                  make_gnn_trainer, make_mesh,
                                                  make_partitioned_trainer)
    from tch_geometric_tpu_torch.parallel.mesh import ThreadComm
    from tch_geometric_tpu_torch.sampling import rng
    cpu = torch.device("cpu")
    ns, f = sg["ns"], data.x.shape[1]
    seeds = np.random.default_rng(73).integers(
        0, ns, (DIST_LOSS_STEPS, DIST_CUT_SEEDS))
    ys = torch.from_numpy(data.y[sg["keep"]])
    hier_model, dptp_model = dist_model(cpu, f), train_model("sage", f, cpu)
    res = {}
    for side, dev in (("card", device), ("cpu", cpu)):
        t = time.perf_counter()
        y = ys.to(dev)
        mesh = make_mesh(MESH2, HIER, device=dev, comm=ThreadComm(4))
        g = build_partitioned_graph(sg["cp"], sg["ri"], MESH2[1], device=dev)
        xi = build_interleaved_features(sg["xs"].to(dev), 4)
        tr = make_partitioned_trainer(copy.deepcopy(hier_model).to(dev),
                                      FANOUTS, mesh, learning_rate=TRAIN_LR,
                                      capacity_factor=DIST_CF, hier=HIER)
        st, hl = tr.init_fn(), []
        for i in range(DIST_LOSS_STEPS):
            sd = torch.from_numpy(seeds[i]).to(dev)
            st, loss, _, o = tr.train_step(st, rng.key(CUT_HIER_KEY), g, xi,
                                           sd, y[sd])
            check(int(o) == 0, f"(d) {side}: hier overflow 0")
            hl.append(float(loss))
        cg = (sg["g"] if side == "card" else
              make_graph(sg["cp"], sg["ri"], num_src=ns, num_dst=ns,
                         device=cpu))
        dm = make_mesh(MESH2, device=dev, comm=ThreadComm(4))
        tr = make_gnn_trainer(copy.deepcopy(dptp_model).to(dev), FANOUTS,
                              learning_rate=TRAIN_LR, mesh=dm)
        st, dl, xs = tr.init_fn(), [], sg["xs"].to(dev)
        for i in range(DIST_LOSS_STEPS):
            sd = torch.from_numpy(seeds[i]).to(dev)
            st, loss, _ = tr.train_step(st, rng.key(CUT_DPTP_KEY), cg, xs,
                                        sd, y[sd])
            dl.append(float(loss))
        res[side] = (hl, dl, time.perf_counter() - t)
    (hc, dc, tc), (hh, dh, th) = res["card"], res["cpu"]
    rh, rd = rel_max(hc, hh), rel_max(dc, dh)
    log(f"check: phase 13 (d) card vs CPU on the {ns}-node cut, "
        f"{DIST_LOSS_STEPS} steps of {DIST_CUT_SEEDS} seeds at (2, 2): hier "
        f"losses card {hc}, CPU {hh}, largest relative difference {rh:.3e}; "
        f"DP+TP (dropout {TRAIN_DROPOUT}) card {dc}, CPU {dh}, {rd:.3e} "
        f"(limit {DIST_LOSS_RTOL}); card {tc:.1f} s, CPU {th:.1f} s")
    check(rh <= DIST_LOSS_RTOL, f"(d) hier card vs CPU: {rh:.3e}")
    check(rd <= DIST_LOSS_RTOL, f"(d) DP+TP card vs CPU: {rd:.3e}")
    return dict(hier_losses_card=hc, hier_losses_cpu=hh, hier_max_rel=rh,
                dptp_losses_card=dc, dptp_losses_cpu=dh, dptp_max_rel=rd,
                card_s=tc, cpu_s=th)


def phase13(p, sg, dist_res, device, timer):
    """Phase 13: (a)-(d), each part's wall seconds logged; returns its
    numbers.  Tears the process group down at the end."""
    from tch_geometric_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    res, secs = {}, {}

    def part(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        log(f"phase 13 {name}: {secs[name]:.1f}s")
        return out

    meshes = meshes13(device)
    flat = dist_res["train"][DIST_PARTS]["losses"]
    res["hier"] = part("(a), (b)", lambda: hier13(p, meshes["hier"], flat,
                                                  device, timer))
    res["hier_multibatch"] = part("(a) multibatch", lambda: hier_multibatch13(
        p, meshes["hier"][4], device, timer))
    res["dptp"] = part("(c)", lambda: dptp13(p, meshes["dptp"], device,
                                             timer))
    res["card_vs_cpu"] = part("(d)", lambda: card_vs_cpu13(p["data"], sg,
                                                           device))
    multihost.shutdown()
    res["part_s"] = secs
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 13 wall time {res['wall_s']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# Phase 14: distributed walks, distributed negatives, partitioned link
# ---------------------------------------------------------------------------

DIST_STORE14 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "dist_store14")
OUT_TEMPO_STARTS, OUT_TEMPO_LENGTH = 256, 5   # (b)'s window-engine call
CUT14_WALKS, CUT14_LENGTH = 1024, 12          # (e)'s walks on the 5% cut
CUT14_NEG_INPUTS = 4096
# the P = 4 thread runs cut to fit the phase's time: CTDNE's other biases
# run the same owner engine (each bias 12-18 s at P = 4 on the card)
CTDNE_P4_BIASES = ("exponential",)


def timed_ts(indices, n, seed):
    """Effective edge timestamps of an adjacency's edges (``indices``):
    edge and node timestamps in ``[0, TIME_RANGE)`` from ``seed``."""
    from tch_geometric_tpu_torch.parallel import effective_edge_ts
    r = np.random.default_rng(seed)
    return effective_edge_ts(indices, r.integers(0, TIME_RANGE, len(indices)),
                             r.integers(0, TIME_RANGE, n))


def graphs14(p, csr, device, timer):
    """The partitioned products graphs at P = 1 and ``DIST_PARTS``: the
    out-edge CSR (no ELL table: max degree 113,135; the window engines)
    and the in-edge adjacency (the CSC read as the reversed graph's CSR,
    max degree 56: the ELL table), each with effective edge timestamps;
    and the out-edge CSR as a device graph for the edge checks."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.parallel import build_partitioned_graph
    n = p["data"].num_nodes
    arrays = {"out": (csr, 140),
              "in": ((p["col_ptrs"], p["row_indices"]), 141)}
    graphs, out = {}, {}
    for k, ((ptr, ind), seed) in arrays.items():
        ts = timed_ts(ind, n, seed)
        ptr_d = torch.from_numpy(ptr).to(device)
        ind_d = torch.from_numpy(ind).to(device)
        for P in (1, DIST_PARTS):
            g, ms = timer(lambda: build_partitioned_graph(
                ptr_d, ind_d, P, edge_timestamps=ts, device=device))
            graphs[k, P] = g
            out[f"{k} P={P}"] = dict(build_ms=ms,
                                     device_gib=g.nbytes() / 2**30,
                                     ell=g.ell is not None,
                                     max_degree=g.max_degree)
            log(f"phase 14 partitioned {k}-edge graph P={P}: {ms:.1f} ms, "
                f"{g.nbytes() / 2**30:.3f} GiB, ELL "
                f"{'yes' if g.ell is not None else 'no'}, max degree "
                f"{g.max_degree}")
    out_g = make_graph(*csr, num_src=n, num_dst=n, device=device)
    return graphs, out_g, out


def _blocks(a):
    """(P, B/P, ...) rank blocks -> the one-device (B, ...) layout."""
    return a.reshape((-1,) + tuple(a.shape[2:]))


def walks14(p, graphs, out_g, meshes, device, timer):
    """Phase 14 (a), (b): ``dist_random_walk`` (OGB's products node2vec
    request, ``WALK_STARTS`` starts of ``WALK_LENGTH``, ``WALK_PQ``) on the
    out-edge CSR, the tempo and CTDNE walks (``WALK_BIASES``, forward,
    ``WALK_RETRIES``; window ``TEMPORAL_WINDOW``) on the in-edge ELL
    adjacency, and one tempo call of ``OUT_TEMPO_STARTS`` starts of
    ``OUT_TEMPO_LENGTH`` on the out-edge CSR (the window engines), at P =
    1 and ``DIST_PARTS`` (CTDNE at ``DIST_PARTS`` in
    ``CTDNE_P4_BIASES`` only): ms per call, overflow 0, the two P
    bit-equal, every step an edge (or -1, or a temporal restart), temporal
    steps in the window, CTDNE timestamps never decreasing."""
    from tch_geometric_tpu_torch.parallel import (
        dist_biased_tempo_random_walk, dist_random_walk,
        dist_tempo_random_walk)
    from tch_geometric_tpu_torch.sampling import rng
    n = p["data"].num_nodes
    in_g = p["graph"]
    r = np.random.default_rng(142)
    starts = r.integers(0, n, WALK_STARTS)
    start_ts = r.integers(0, TIME_RANGE, WALK_STARTS)
    start_ts_d = torch.from_numpy(start_ts).to(device)
    res = {}

    def both(name, fn, parts=(1, DIST_PARTS)):
        """``fn(P)`` -> outputs (the last the overflow) at each of
        ``parts``, timed; the outputs but the overflow equal across P."""
        outs, ms = {}, {}
        for P in parts:
            outs[P], ms[P] = timer(lambda: fn(P))
            check(int(outs[P][-1].sum()) == 0, f"{name} P={P}: overflow 0")
        same = all(torch.equal(_blocks(a), _blocks(b)) for P in parts[1:]
                   for a, b in zip(outs[1][:-1], outs[P][:-1]))
        log(f"phase 14 {name}: " + ", ".join(
            f"P={P} {ms[P]:.1f} ms" for P in parts) + " a call; overflow 0"
            + ("; the two P " + ("bit-equal" if same else "DIFFER")
               if len(parts) > 1 else ""))
        check(same, f"{name}: P=1 and P={DIST_PARTS} bit-equal")
        res[name] = dict(ms={str(k): v for k, v in ms.items()})
        return [_blocks(a) for a in outs[1][:-1]]

    with torch.no_grad():
        for pq in WALK_PQ:
            (w,) = both(f"(a) dist_random_walk p,q={pq}",
                        lambda P: dist_random_walk(
                            rng.key(143), graphs["out", P], starts,
                            WALK_LENGTH, meshes[P], p=pq[0], q=pq[1],
                            capacity_factor=DIST_CF))
            check(w.shape == (WALK_STARTS, WALK_LENGTH + 1)
                  and _walk_edges_ok(out_g, w.long()),
                  f"dist node2vec {pq}: every step an edge or -1")
        w, ts = both("(b) dist_tempo_random_walk in-edge ELL",
                     lambda P: dist_tempo_random_walk(
                         rng.key(144), graphs["in", P], starts, start_ts,
                         WALK_LENGTH, TEMPORAL_WINDOW, meshes[P],
                         capacity_factor=DIST_CF))
        res["(b) dist_tempo_random_walk in-edge ELL"]["restarted_steps"] = \
            _tempo_walks_ok("dist tempo in-edge", in_g, w.long(), ts.long(),
                            start_ts_d)
        for bias in WALK_BIASES:
            name = f"(b) dist_biased_tempo_random_walk {bias}"
            w, ts = both(name, lambda P: dist_biased_tempo_random_walk(
                rng.key(145), graphs["in", P], starts, start_ts, WALK_LENGTH,
                bias, meshes[P], forward=True, retry_count=WALK_RETRIES,
                capacity_factor=DIST_CF),
                parts=(1, DIST_PARTS) if bias in CTDNE_P4_BIASES else (1,))
            w, ts = w.long(), ts.long()
            live = w[:, 1:] >= 0
            check(_walk_edges_ok(in_g, w), f"dist ctdne {bias}: every step "
                  "an edge")
            check(bool(((ts[:, 1:] >= ts[:, :-1]) | ~live).all()),
                  f"dist ctdne {bias}: timestamps never decrease")
            res[name]["complete_walks"] = int(live.all(dim=1).sum())
        few = starts[:OUT_TEMPO_STARTS]
        w, ts = both("(b) dist_tempo_random_walk out-edge CSR, "
                     f"{OUT_TEMPO_STARTS} starts, length {OUT_TEMPO_LENGTH}",
                     lambda P: dist_tempo_random_walk(
                         rng.key(146), graphs["out", P], few,
                         start_ts[:OUT_TEMPO_STARTS], OUT_TEMPO_LENGTH,
                         TEMPORAL_WINDOW, meshes[P], capacity_factor=DIST_CF))
        _tempo_walks_ok("dist tempo out-edge", out_g, w.long(), ts.long(),
                        start_ts_d[:OUT_TEMPO_STARTS])
    return res


def _hetero_not_edges(what, w, acc, rc, inputs, type_rels, graphs, inbound):
    """No accepted typed negative is an edge of its chosen relation in the
    probe's direction (inbound: only candidates that are rows of the
    relation's CSR) or a self-loop."""
    checked = 0
    for t, v in inputs.items():
        wt, at, rt = (_blocks(d[t]).long() for d in (w, acc, rc))
        u = torch.as_tensor(v, device=wt.device)[:, None].expand_as(wt)
        for ri, (k, _dst) in enumerate(type_rels[t]):
            m = at.bool() & (rt == ri)
            a, b = u[m], wt[m]
            g = graphs[k]
            if inbound:
                keep = b < g.num_ptr_nodes
                a, b = b[keep], a[keep]
            _assert_not_edges(f"{what} {k}", g, a, b)
            checked += int(m.sum())
    return checked


def negatives14(p, graphs, out_g, mag, meshes, device, timer):
    """Phase 14 (c): ``dist_negative_sample`` on the out-edge CSR
    (``NEG_INPUTS`` inputs, ``NEG_NUM`` negatives of ``NEG_TRIES`` tries,
    inbound False and True) and ``dist_negative_sample_hetero`` on the
    mag shape (``HETERO_NEG_INPUTS`` papers and authors, each relation's
    CSR partitioned), at P = 1 and ``DIST_PARTS``: ms per call, overflow
    0, the two P bit-equal, no accepted negative an edge (in the probe's
    direction) or a self-loop."""
    from tch_geometric_tpu_torch.data.graph import make_graph
    from tch_geometric_tpu_torch.parallel import (build_partitioned_graph,
                                                  dist_negative_sample,
                                                  dist_negative_sample_hetero)
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.utils.types import rel_key
    n = p["data"].num_nodes
    r = np.random.default_rng(147)
    inputs = r.integers(0, n, NEG_INPUTS)
    u = torch.from_numpy(inputs).to(device)[:, None].expand(-1, NEG_NUM)
    res = {}
    with torch.no_grad():
        for inbound in (False, True):
            outs, ms = {}, {}
            for P in (1, DIST_PARTS):
                outs[P], ms[P] = timer(lambda: dist_negative_sample(
                    rng.key(148), graphs["out", P], inputs, NEG_NUM,
                    NEG_TRIES, meshes[P], inbound=inbound,
                    capacity_factor=DIST_CF))
                check(int(outs[P][2].sum()) == 0, "dist negatives overflow 0")
            w, acc = (_blocks(a) for a in outs[1][:2])
            same = all(torch.equal(_blocks(a), b) for a, b in
                       zip(outs[DIST_PARTS][:2], (w, acc)))
            check(same, f"dist negatives inbound {inbound}: P equal")
            a, b = u[acc], w[acc].long()
            _assert_not_edges(f"dist negatives inbound {inbound}", out_g,
                              b if inbound else a, a if inbound else b)
            share = float(acc.float().mean())
            res[f"homogeneous inbound {inbound}"] = dict(
                ms={str(k): v for k, v in ms.items()}, accepted_share=share)
            log(f"phase 14 (c) dist_negative_sample inbound {inbound}, "
                f"{NEG_INPUTS} inputs: P=1 {ms[1]:.1f} ms, P={DIST_PARTS} "
                f"{ms[DIST_PARTS]:.1f} ms; accepted share {share:.4f}; the "
                "two P bit-equal; none an edge or a self-loop")

        counts, edge_types, csc = mag
        csr_m, sizes = mag_csr(counts, edge_types, csc)
        rels = {P: {k: build_partitioned_graph(*v, P, device=device)
                    for k, v in csr_m.items()} for P in (1, DIST_PARTS)}
        checks = {k: make_graph(*v, num_src=sizes[k][0], num_dst=sizes[k][1],
                                ell_table=False, window_table=False,
                                device=device) for k, v in csr_m.items()}
        type_rels = {}
        for e in edge_types:
            type_rels.setdefault(e[0], []).append((rel_key(e), e[2]))
        hin = {"paper": r.integers(0, counts["paper"], HETERO_NEG_INPUTS),
               "author": r.integers(0, counts["author"], HETERO_NEG_INPUTS)}
        for inbound in (False, True):
            outs, ms = {}, {}
            for P in (1, DIST_PARTS):
                outs[P], ms[P] = timer(lambda: dist_negative_sample_hetero(
                    rng.key(149), rels[P], edge_types, hin, NEG_NUM,
                    NEG_TRIES, meshes[P], node_counts=counts,
                    inbound=inbound, capacity_factor=DIST_CF))
                check(int(outs[P][3].sum()) == 0, "typed negatives overflow 0")
            same = all(torch.equal(_blocks(outs[1][i][t]),
                                   _blocks(outs[DIST_PARTS][i][t]))
                       for i in range(3) for t in outs[1][i])
            check(same, f"typed negatives inbound {inbound}: P equal")
            checked = _hetero_not_edges(
                f"dist typed negatives inbound {inbound}", *outs[1][:3], hin,
                type_rels, checks, inbound)
            res[f"hetero inbound {inbound}"] = dict(
                ms={str(k): v for k, v in ms.items()}, accepted=checked)
            log(f"phase 14 (c) dist_negative_sample_hetero inbound "
                f"{inbound}, {HETERO_NEG_INPUTS} papers and authors: P=1 "
                f"{ms[1]:.1f} ms, P={DIST_PARTS} {ms[DIST_PARTS]:.1f} ms; "
                f"{checked} accepted negatives checked; the two P bit-equal")
    return res


def link14_trainer(model, mesh):
    from tch_geometric_tpu_torch.parallel import make_partitioned_link_trainer
    return make_partitioned_link_trainer(
        model, FANOUTS, mesh, num_neg=LINK_NEG, try_count=LINK_TRIES,
        learning_rate=TRAIN_LR, capacity_factor=DIST_CF)


def link14(p, graphs, meshes, device, timer):
    """Phase 14 (d): ``make_partitioned_link_trainer`` with phase 11 (c)'s
    ``GraphSAGE(100, 256, 256, 3 layers, dropout 0.5)``, ``FANOUTS``,
    ``LINK_NEG`` negative of ``LINK_TRIES`` tries, Adam at ``TRAIN_LR``,
    ``LINK_EDGES`` positive edges a step, on the out-edge CSR with the
    features interleaved: at P = 1 one warm-up and ``TIMED_STEPS`` steps,
    ms per step, peak device memory, overflow 0.  With dropout on each
    rank masks its own tree under the shared key (as a ``shard_map`` body
    does), so the losses depend on P; ``DIST_LOSS_STEPS`` steps at dropout
    0 from the same parameters at P = 1 and ``DIST_PARTS`` give losses
    within ``DIST_LOSS_RTOL``; at ``DIST_PARTS`` those steps are the timed
    ones (the first a warm-up), with the peak device memory."""
    from tch_geometric_tpu_torch.parallel import build_interleaved_features
    from tch_geometric_tpu_torch.sampling import rng
    x = p["x_table"]
    model0 = link_model(x.shape[1], device)
    r = np.random.default_rng(150)
    edges = [tuple(torch.from_numpy(a).to(device) for a in link_edges(
        p["col_ptrs"], p["row_indices"], LINK_EDGES, r))
        for _ in range(1 + TIMED_STEPS)]
    out, flat = {}, {}

    def run(P, dropout, steps, what):
        """``steps`` timed steps at P from ``model0``'s parameters."""
        m = copy.deepcopy(model0)
        m.dropout = dropout
        tr = link14_trainer(m, meshes[P])
        xi = build_interleaved_features(x, P)
        box = {"state": tr.init_fn()}

        def step(i):
            box["state"], loss, ovf = tr.train_step(
                box["state"], rng.key(151), graphs["out", P], xi, *edges[i])
            return float(loss), int(ovf)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, losses, ovf = [], [], 0
        for i in range(steps):
            (loss, o), t = timer(lambda: step(i))
            ms.append(t)
            losses.append(loss)
            ovf += o
            check(np.isfinite(loss), f"partitioned link P={P}: loss finite")
        check(ovf == 0, f"partitioned link P={P}: overflow 0")
        res = dict(step_ms=ms[1:], first_ms=ms[0],
                   step_ms_mean=float(np.mean(ms[1:])),
                   peak_device_gib=peak_gib(), losses=losses)
        log(f"phase 14 (d) make_partitioned_link_trainer P={P}, dropout "
            f"{dropout}, {LINK_EDGES} edges a step ({what}): step ms (first "
            f"{ms[0]:.1f}) " + ", ".join(f"{m:.1f}" for m in ms[1:])
            + f"; mean {res['step_ms_mean']:.2f}; peak device memory "
            f"{res['peak_device_gib']:.2f} GiB; overflow 0; losses "
            + ", ".join(f"{v:.6f}" for v in losses))
        del xi, tr, box
        torch.cuda.empty_cache()
        return res

    out[1] = run(1, model0.dropout, 1 + TIMED_STEPS, "timed")
    flat[1] = run(1, 0.0, DIST_LOSS_STEPS, "the cross-P check")["losses"]
    out[DIST_PARTS] = run(DIST_PARTS, 0.0, DIST_LOSS_STEPS,
                          "the cross-P check, timed")
    flat[DIST_PARTS] = out[DIST_PARTS]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(flat[DIST_PARTS], flat[1]))
    log(f"check: phase 14 (d) dropout-0 losses P={DIST_PARTS} against P=1 "
        f"over {DIST_LOSS_STEPS} steps: {flat[DIST_PARTS]} vs {flat[1]}, "
        f"largest relative difference {rel:.3e} (limit {DIST_LOSS_RTOL})")
    check(rel <= DIST_LOSS_RTOL,
          f"partitioned link losses across P: {rel:.3e}")
    out["dropout0_losses"] = {str(k): v for k, v in flat.items()}
    out["max_rel_loss_diff"] = rel
    return out


def card_vs_cpu14(sg, device):
    """Phase 14 (e): on phase 3's 5% cut, card against CPU, same keys and
    inputs, the card at P = ``DIST_PARTS`` thread ranks and the CPU at P =
    1 (the walks and negatives do not depend on P): ``CUT14_WALKS``
    node2vec walks of ``CUT14_LENGTH`` at (1, 1.5) on the cut's out-edge
    CSR differ in 0 steps; the negatives (``CUT14_NEG_INPUTS`` inputs,
    outbound and inbound) are equal; the tempo and CTDNE walks (the
    in-edge ELL adjacency; CTDNE in ``CTDNE_P4_BIASES``) differ in at most
    ``CUT_DIFF_LIMIT`` of the walks (the last ulp of ``log`` may move a
    Gumbel argmax); ``CUT_STEPS`` steps of (d)'s link trainer at P = 1 on
    both, on ``LINK_CUT_EDGES`` edges, give losses within
    ``DIST_LOSS_RTOL``.  Those steps run at dropout 0: the masks' threefry
    took most of the CPU's 50 s here, and phases 7, 11 and 13 already hold
    dropout masks card against CPU; what (e) adds is the partitioned
    link path (owner-probed negatives, three segments, the global
    loss)."""
    from tch_geometric_tpu_torch.data.storage import to_csr
    from tch_geometric_tpu_torch.parallel import (
        build_partitioned_graph, dist_biased_tempo_random_walk,
        dist_negative_sample, dist_random_walk, dist_tempo_random_walk,
        make_mesh)
    from tch_geometric_tpu_torch.parallel.mesh import ThreadComm
    from tch_geometric_tpu_torch.sampling import rng
    cpu = torch.device("cpu")
    ns = sg["ns"]
    out_csr = to_csr(sg["ei"], ns)[:2]
    r = np.random.default_rng(152)
    starts = r.integers(0, ns, CUT14_WALKS)
    start_ts = r.integers(0, TIME_RANGE, CUT14_WALKS)
    neg_in = r.integers(0, ns, CUT14_NEG_INPUTS)
    edges = [link_edges(sg["cp"], sg["ri"], LINK_CUT_EDGES, r)
             for _ in range(CUT_STEPS)]
    model = link_model(sg["xs"].shape[1], cpu)
    res, secs = {}, {}
    for side, dev, P in (("card", device, DIST_PARTS), ("cpu", cpu, 1)):
        t = time.perf_counter()
        mesh = make_mesh((P, 1), device=dev, comm=ThreadComm(P))
        g_out = build_partitioned_graph(
            *out_csr, P, edge_timestamps=timed_ts(out_csr[1], ns, 153),
            device=dev)
        g_in = build_partitioned_graph(
            sg["cp"], sg["ri"], P, edge_timestamps=timed_ts(sg["ri"], ns, 154),
            device=dev)
        o = {}
        with torch.no_grad():
            o["node2vec"] = dist_random_walk(
                rng.key(155), g_out, starts, CUT14_LENGTH, mesh, p=1.0,
                q=1.5, capacity_factor=DIST_CF)
            for inbound in (False, True):
                o[f"negatives {inbound}"] = dist_negative_sample(
                    rng.key(156), g_out, neg_in, NEG_NUM, NEG_TRIES, mesh,
                    inbound=inbound, capacity_factor=DIST_CF)
            o["tempo"] = dist_tempo_random_walk(
                rng.key(157), g_in, starts, start_ts, CUT14_LENGTH,
                TEMPORAL_WINDOW, mesh, capacity_factor=DIST_CF)
            for bias in CTDNE_P4_BIASES:
                o[f"ctdne {bias}"] = dist_biased_tempo_random_walk(
                    rng.key(158), g_in, starts, start_ts, CUT14_LENGTH, bias,
                    mesh, retry_count=WALK_RETRIES, capacity_factor=DIST_CF)
        for k, v in o.items():
            check(int(v[-1].sum()) == 0, f"(e) {side} {k}: overflow 0")
            o[k] = [_blocks(a).cpu() for a in v[:-1]]
        walk_s = time.perf_counter() - t
        one = make_mesh((1, 1), device=dev, comm=ThreadComm(1))
        g1 = g_out if P == 1 else build_partitioned_graph(*out_csr, 1,
                                                          device=dev)
        m = copy.deepcopy(model).to(dev)
        m.dropout = 0.0
        tr = link14_trainer(m, one)
        st, losses, xs = tr.init_fn(), [], sg["xs"].to(dev)
        for src, dst in edges:
            st, loss, ovf = tr.train_step(st, rng.key(159), g1, xs, src,
                                          dst)
            check(int(ovf) == 0, f"(e) {side} link: overflow 0")
            losses.append(float(loss))
        o["link"] = losses
        res[side] = o
        secs[side] = (walk_s, time.perf_counter() - t - walk_s)
    card, host = res["card"], res["cpu"]
    n2v = int((card["node2vec"][0] != host["node2vec"][0]).sum())
    neg = {k: sum(int((a != b).sum()) for a, b in zip(card[k], host[k]))
           for k in card if k.startswith("negatives")}
    walk_diff = {k: int(((card[k][0] != host[k][0]).any(1)
                         | (card[k][1] != host[k][1]).any(1)).sum())
                 for k in card if k == "tempo" or k.startswith("ctdne")}
    rel = max(abs(a - b) / abs(b) for a, b in zip(card["link"], host["link"]))
    log(f"check: phase 14 (e) card vs CPU on the {ns}-node cut (card "
        f"P={DIST_PARTS} threads, CPU P=1; the link steps at P=1 on both, "
        "dropout 0): "
        f"node2vec (1, 1.5) {CUT14_WALKS} x {CUT14_LENGTH} differ "
        f"in {n2v} steps; negatives differing slots {neg}; walks differing "
        f"(of {CUT14_WALKS}) {walk_diff}; link losses card {card['link']}, "
        f"CPU {host['link']}, largest relative difference {rel:.3e}; "
        "seconds (walks and negatives, link) card "
        f"{secs['card'][0]:.1f}, {secs['card'][1]:.1f}, CPU "
        f"{secs['cpu'][0]:.1f}, {secs['cpu'][1]:.1f}")
    check(n2v == 0, "(e) node2vec card and CPU equal")
    check(not any(neg.values()), "(e) negatives card and CPU equal")
    for k, v in walk_diff.items():
        check(v <= CUT_DIFF_LIMIT * CUT14_WALKS, f"(e) {k}: {v} walks differ")
    check(rel <= DIST_LOSS_RTOL, f"(e) link card vs CPU: {rel:.3e}")
    return dict(node2vec_differing_steps=n2v, negatives_differing=neg,
                walks_differing=walk_diff, link_losses_card=card["link"],
                link_losses_cpu=host["link"], link_max_rel_diff=rel,
                card_s=secs["card"], cpu_s=secs["cpu"])


def phase14(p, csr, mag, sg, device, timer):
    """Phase 14: (a)-(e), each part's wall seconds logged; returns its
    numbers.  Tears the process group down at the end."""
    from tch_geometric_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    res, secs = {}, {}

    def part(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        log(f"phase 14 {name}: {secs[name]:.1f}s")
        return out

    meshes = dist_meshes(device, DIST_STORE14, "phase 14")
    graphs, out_g, res["graphs"] = part(
        "graphs", lambda: graphs14(p, csr, device, timer))
    res["walks"] = part("(a), (b)", lambda: walks14(p, graphs, out_g, meshes,
                                                    device, timer))
    res["negatives"] = part("(c)", lambda: negatives14(
        p, graphs, out_g, mag, meshes, device, timer))
    del out_g
    res["link"] = part("(d)", lambda: link14(p, graphs, meshes, device,
                                             timer))
    del graphs
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = part("(e)", lambda: card_vs_cpu14(sg, device))
    multihost.shutdown()
    res["part_s"] = secs
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 14 wall time {res['wall_s']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# Phase 15: distributed budget sampling, typed distributed neighbor sampling
# and the partitioned heterogeneous layouts
# ---------------------------------------------------------------------------

DIST_STORE15 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "dist_store15")
# scripts/bench_partitioned_products.py:175-214: BASELINE config 5's budget
# sampler at products scale, B = 512, capacity factor 1.3, 1 and 2 rounds
BUDGET15_SEEDS = 512
CUT15_SEEDS = 256               # (e): seeds (papers) a call on the 5% cuts
TYPED15_BUDGET = (("uniform", None), ("temporal", TEMPORAL_WINDOW))
# with every configuration at P = 4 too the script took 1,000.4 s (phase
# 15 100.6 s) on an H100 80GB HBM3 at 700 W, past its 1,000 s aim, so
# P = 4 runs one configuration a sampler: the CSC at one round (its
# overflow rate; at P = 1 one round is the default), the typed samplers'
# temporal ones
P4_BUDGET, P4_TYPED = ("csc", 1, None), ("temporal", "temporal_dynamic")


def budget_layers(s):
    """A distributed homogeneous sample's rank blocks in the one-rank
    layout, layer by layer, rows and cols renumbered to its slots."""
    P = s.nodes.shape[0]
    nb, eb = s.node_base, s.edge_base
    ar = lambda n: torch.arange(n, device=s.nodes.device)  # noqa: E731
    gslot = torch.cat([P * nb[i] + ar(P)[:, None] * (nb[i + 1] - nb[i])
                       + ar(nb[i + 1] - nb[i])[None, :]
                       for i in range(len(nb) - 1)], dim=1)
    out = {}
    for f in ("nodes", "node_state", "node_valid", "rows", "cols", "eptr",
              "edge_valid"):
        a = getattr(s, f)
        if f in ("rows", "cols"):
            a = torch.gather(gslot, 1, a.long())
        base = nb if f.startswith("node") else eb
        out[f] = torch.cat([a[:, base[i]: base[i + 1]].reshape(-1)
                            for i in range(len(base) - 1)])
    return out


def whole_diff(a, b):
    """Slots in which two samples differ, every array compared whole
    (invalid slots too): dicts of arrays, or tuples of dicts of arrays."""
    if isinstance(a, dict):
        return sum(whole_diff(a[k], b[k]) for k in b)
    if isinstance(a, (tuple, list)):
        return sum(whole_diff(x, y) for x, y in zip(a, b))
    return int((a.cpu() != b.cpu()).sum())


def valid_only(s):
    """A one-rank sample with its invalid slots' ids, states and edge
    pointers set to -1: an invalid Floyd pick's id reads the owner's edge
    list at a row of degree 0, whose neighbor there depends on P."""
    m = lambda ok, a: torch.where(ok, a, -1)  # noqa: E731
    if isinstance(s, dict):
        nv, ev = s["node_valid"], s["edge_valid"]
        return dict(s, nodes=m(nv, s["nodes"]),
                    node_state=m(nv, s["node_state"]),
                    eptr=m(ev, s["eptr"]))
    nodes, node_ts, nv, rows, cols, eptr, ev = s
    return ({t: m(nv[t], v) for t, v in nodes.items()},
            {t: m(nv[t], v) for t, v in node_ts.items()}, nv, rows, cols,
            {k: m(ev[k], v) for k, v in eptr.items()}, ev)


def carried_diff(a, ref):
    """Valid slots of the one-round layout ``a`` that differ from the
    default rounds' ``ref`` (id, state or edge pointer)."""
    nv, ev = a["node_valid"], a["edge_valid"]
    return (int((nv & ((a["nodes"] != ref["nodes"])
                       | (a["node_state"] != ref["node_state"]))).sum())
            + int((ev & (a["eptr"] != ref["eptr"])).sum()))


def check_budget_layers(what, s, indptr, indices, ts, window, relative):
    """(a)'s checks on a one-rank budget layout: every valid edge is real
    and lies in its parent's window; a parent's valid picks are distinct
    edges; under the filter every edge's timestamp passes the half-open
    forward window against its parent's state, and a child's state is the
    edge's timestamp or, with ``relative``, its parent's (so its root's).
    Returns the valid edges."""
    ev = s["edge_valid"]
    e, rr, cc = s["eptr"][ev], s["rows"][ev], s["cols"][ev]
    child, parent = s["nodes"][rr], s["nodes"][cc]
    check(torch.equal(indices[e].long(), child)
          and bool(((e >= indptr[parent]) & (e < indptr[parent + 1])).all()),
          f"{what}: every valid edge is real")
    pairs = torch.stack([cc, e], dim=1)
    check(torch.unique(pairs, dim=0).shape[0] == pairs.shape[0],
          f"{what}: a parent's picks are distinct edges")
    if window is not None:
        t, pt = ts[e].long(), s["node_state"][cc]
        d = t - pt
        check(bool(((d >= window[0]) & (d < window[1])).all()),
              f"{what}: every edge passes the window")
        check(torch.equal(s["node_state"][rr], pt if relative else t),
              f"{what}: the child's state")
    return int(ev.sum())


def graphs15(p, csr, device, timer):
    """(a)'s partitioned products graphs at P = 1 and ``DIST_PARTS``: the
    CSC (max in-degree 56: the ELL table, lane top-k fills) with edge
    timestamps in ``[0, TIME_RANGE)`` from a seed, and the out-edge CSR
    (max degree 113,135, no ELL table: Floyd's fills); each build timed."""
    from tch_geometric_tpu_torch.parallel import build_partitioned_graph
    ts = edge_values(len(p["row_indices"]), 160, device)[1]
    arrays = {"csc": (p["col_ptrs"], p["row_indices"], ts),
              "csr": (csr[0], csr[1], None)}
    graphs, out = {"ts": ts}, {}
    for k, (ptr, ind, t) in arrays.items():
        graphs[k] = tuple(torch.from_numpy(a).to(device) for a in (ptr, ind))
        for P in (1, DIST_PARTS):
            g, ms = timer(lambda: build_partitioned_graph(
                *graphs[k], P, edge_timestamps=t, device=device))
            graphs[k, P] = g
            out[f"{k} P={P}"] = dict(build_ms=ms,
                                     device_gib=g.nbytes() / 2**30)
            log(f"phase 15 partitioned products {k} P={P}: {ms:.1f} ms, "
                f"{g.nbytes() / 2**30:.3f} GiB, ELL "
                f"{'yes' if g.ell is not None else 'no'}, max degree "
                f"{g.max_degree}")
    return graphs, out


def calls15(timer, fn, P):
    """At P = 1 one warm-up and one timed call of ``fn``, at P > 1 one
    call: the last output and the times (the first a warm-up at P = 1)."""
    ms = []
    for _ in range(2 if P == 1 else 1):
        out, t = timer(fn)
        ms.append(t)
    return out, ms


def budget15(graphs, meshes, timer):
    """Phase 15 (a): ``dist_budget_sample`` of ``BUDGET15_SEEDS`` seeds,
    ``FANOUTS``, capacity factor ``DIST_CF``, default rounds, at P = 1 on
    the CSC (lane top-k fills) and the out-edge CSR (Floyd's), and with
    the temporal filter on the CSC (window ``TEMPORAL_WINDOW``, forward,
    ``relative`` False and True, seed states in ``[0, TIME_RANGE)``); at
    P = ``DIST_PARTS`` ``P4_BUDGET`` (the CSC at one round): ms per call,
    the overflow rate (of the requests), the valid share per hop; (a)'s
    edge checks on every sample; the P = 4 sample's carried slots equal
    P = 1's (every valid slot when nothing overflowed)."""
    from tch_geometric_tpu_torch.parallel import dist_budget_sample
    from tch_geometric_tpu_torch.sampling import rng
    n = graphs["csc"][0].shape[0] - 1
    r = np.random.default_rng(161)
    seeds = r.integers(0, n, BUDGET15_SEEDS)
    seed_ts = r.integers(0, TIME_RANGE, BUDGET15_SEEDS)
    n_req = sum(BUDGET15_SEEDS * int(np.prod(FANOUTS[:i]))
                for i in range(len(FANOUTS)))
    runs = [(1, "csc", None, None), (1, "csr", None, None),
            (1, "csc", None, False), (1, "csc", None, True),
            (DIST_PARTS,) + P4_BUDGET]
    res, p1 = {}, {}
    with torch.no_grad():
        for P, k, nr, rel in runs:
            name = (f"{k} rounds {nr or 'default'}" if rel is None
                    else f"{k} temporal relative {rel}")
            kw = dict(capacity_factor=DIST_CF, num_rounds=nr)
            if rel is not None:
                kw.update(input_timestamps=seed_ts, window=TEMPORAL_WINDOW,
                          forward=True, relative=rel)
            (s, o), ms = calls15(timer, lambda: dist_budget_sample(
                rng.key(162), graphs[k, P], seeds, FANOUTS, meshes[P], **kw),
                P)
            out, ovf = budget_layers(s), int(o.sum())
            edges = check_budget_layers(f"phase 15 (a) {name} P={P}", out,
                                        *graphs[k], graphs["ts"],
                                        kw.get("window"), rel)
            nb = [P * b for b in s.node_base]         # the one-rank layers
            shares = [float(out["node_valid"][nb[i]: nb[i + 1]].float()
                            .mean()) for i in range(1, len(nb) - 1)]
            if P == 1:
                check(ovf == 0, f"(a) {name}: overflow 0")
                p1.setdefault((k, rel), out)
                across = ""
            else:
                ref = p1[k, rel]
                diff = carried_diff(out, ref)
                if ovf == 0:
                    diff += whole_diff(valid_only(out), valid_only(ref))
                check(diff == 0, f"(a) {name} P={P}: {diff} slots differ "
                      "from P=1's")
                across = ("; bit-equal to P=1" if ovf == 0 else
                          "; the carried slots equal P=1's")
            log(f"phase 15 (a) dist_budget_sample {name} P={P}: ms "
                + (f"(first, warm-up) {ms[0]:.1f}, then {ms[1]:.1f}"
                   if P == 1 else f"{ms[0]:.1f} (one call)")
                + f"; overflow rate {ovf / n_req:.2e}; valid share per hop "
                + ", ".join(f"{v:.4f}" for v in shares)
                + f"; {edges} edges checked{across}")
            res[f"{name} P={P}"] = dict(ms=ms[-1], first_ms=ms[0],
                                        overflow_rate=ovf / n_req,
                                        valid_share_per_hop=shares,
                                        edges=edges)
    return res


def mag_rels15(counts, edge_types, csc, P, device, seed):
    """The mag-shaped relations partitioned for P ranks: (b)'s by
    ``build_partitioned_hetero`` with edge timestamps, (c)'s one
    ``build_partitioned_graph`` a relation with edge weights and
    timestamps (``edge_values``, seeded per relation); and the
    timestamps by sorted edge."""
    from tch_geometric_tpu_torch.parallel import (build_partitioned_graph,
                                                  build_partitioned_hetero)
    w, ts = {}, {}
    for i, k in enumerate(sorted(csc)):
        w[k], ts[k] = edge_values(len(csc[k][1]), seed + i, device)
    cp = {k: torch.from_numpy(v[0]).to(device) for k, v in csc.items()}
    ri = {k: torch.from_numpy(v[1]).to(device) for k, v in csc.items()}
    budget = build_partitioned_hetero(cp, ri, edge_types, P,
                                      edge_timestamps=ts, node_counts=counts,
                                      device=device)
    neighbor = {k: build_partitioned_graph(cp[k], ri[k], P, edge_weights=w[k],
                                           edge_timestamps=ts[k],
                                           device=device) for k in csc}
    return budget, neighbor, {k: v.int() for k, v in ts.items()}


def typed15(kind, cfg, rels, edge_types, seeds, states, mesh):
    """One typed call of ``kind`` ("budget" or "neighbor") under
    configuration ``cfg`` (``TYPED15_BUDGET``'s or ``HETERO_CONFIGS``'),
    ``MAG_FANOUTS`` per type or relation: (sample, overflow)."""
    from tch_geometric_tpu_torch.parallel import (dist_budget_sample_hetero,
                                                  dist_hetero_neighbor_sample)
    from tch_geometric_tpu_torch.sampling import rng
    from tch_geometric_tpu_torch.utils import config as c
    hops = len(MAG_FANOUTS)
    if kind == "budget":
        node_types = sorted({t for e in edge_types for t in (e[0], e[2])})
        window = dict(TYPED15_BUDGET)[cfg]
        return dist_budget_sample_hetero(
            rng.key(163), rels, edge_types, seeds,
            {t: MAG_FANOUTS for t in node_types}, hops, mesh,
            input_timestamps=states, window=window, forward=True)
    kw = {}
    if cfg.startswith("weighted"):
        kw = dict(weighted=set(rels),
                  with_replacement=cfg == "weighted_replace")
    elif cfg == "temporal_dynamic":
        kw = dict(filter=(TEMPORAL_WINDOW, True, c.TEMPORAL_SAMPLE_DYNAMIC),
                  input_timestamps=states)
    return dist_hetero_neighbor_sample(
        rng.key(164), rels, edge_types, seeds,
        {k: MAG_FANOUTS for k in rels}, hops, mesh, **kw)


def merged15(kind, out, edge_types, seeds):
    """A typed sample's rank blocks in the one-rank layout."""
    from tch_geometric_tpu_torch.parallel import merge_rank_blocks
    node_types = sorted({t for e in edge_types for t in (e[0], e[2])})
    fan = ({t: MAG_FANOUTS for t in node_types} if kind == "budget"
           else {k: MAG_FANOUTS for k in out[3]})
    return merge_rank_blocks(out, edge_types,
                             {t: len(v) for t, v in seeds.items()}, fan,
                             len(MAG_FANOUTS), budget=kind == "budget")


def typed_requests15(mag, rels, meshes, device, timer):
    """Phase 15 (b), (c): ``dist_budget_sample_hetero`` (``TYPED15_BUDGET``,
    [15, 10] per type) and ``dist_hetero_neighbor_sample``
    (``HETERO_CONFIGS``, [15, 10] per relation) on the mag shape,
    ``BUDGET_SEEDS`` papers with states in ``[0, TIME_RANGE)``, at P = 1,
    and each sampler's ``P4_TYPED`` configuration at ``DIST_PARTS``: ms per
    call, valid slots per type, overflow 0, every edge checked as phases 9
    (b) and 10 (e) check theirs, and the P = 4 sample merged into the
    one-rank layout equal to P = 1's."""
    from types import SimpleNamespace
    counts, edge_types, csc = mag
    r = np.random.default_rng(165)
    seeds = {"paper": r.integers(0, counts["paper"], BUDGET_SEEDS)}
    states = {"paper": r.integers(0, TIME_RANGE, BUDGET_SEEDS)}
    check_g = {k: SimpleNamespace(indptr=torch.from_numpy(v[0]).to(device),
                                  indices=torch.from_numpy(v[1]).to(device))
               for k, v in csc.items()}
    ts = rels["ts"]
    res, p1 = {}, {}
    runs = [(1, "budget", cfg) for cfg, _w in TYPED15_BUDGET]
    runs += [(1, "neighbor", cfg) for cfg in HETERO_CONFIGS]
    runs += [(DIST_PARTS, kind, cfg)
             for kind, cfg in zip(("budget", "neighbor"), P4_TYPED)]
    with torch.no_grad():
        for P, kind, cfg in runs:
            (s, o), ms = calls15(timer, lambda: typed15(
                kind, cfg, rels[kind, P], edge_types, seeds, states,
                meshes[P]), P)
            what = f"phase 15 dist typed {kind} {cfg} P={P}"
            check(int(o.sum()) == 0, f"{what}: overflow 0")
            out = merged15(kind, s, edge_types, seeds)
            nodes, node_ts, valid, rows, cols, eptr, ev = out
            if kind == "budget":
                edges = check_budget_sample(
                    what, SimpleNamespace(
                        nodes=nodes, node_ts=node_ts, rows=rows, cols=cols,
                        eptr=eptr, edge_valid=ev), check_g, ts,
                    dict(TYPED15_BUDGET)[cfg], False)
            else:
                edges = sum(check_hetero_sample(what, cfg, SimpleNamespace(
                    nodes=nodes, node_state=node_ts, rows=rows, cols=cols,
                    eptr=eptr, edge_valid=ev), check_g, edge_types,
                    ts).values())
            across = ""
            if P == 1:
                p1[kind, cfg] = out
            else:
                diff = whole_diff(valid_only(out), valid_only(p1[kind, cfg]))
                check(diff == 0, f"{what}: merged, {diff} slots differ from "
                      "P=1's")
                across = "; merged, bit-equal to P=1"
            vs = {t: int(v.sum()) for t, v in valid.items()}
            log(f"{what}: ms "
                + (f"(first, warm-up) {ms[0]:.1f}, then {ms[1]:.1f}"
                   if P == 1 else f"{ms[0]:.1f} (one call)")
                + f"; overflow 0; valid slots {vs}; {edges} edges checked"
                + across)
            res[f"{kind} {cfg} P={P}"] = dict(ms=ms[-1], first_ms=ms[0],
                                              valid_slots=vs, edges=edges)
    return res


def stacked15(rels, meshes):
    """Phase 15 (d), the layouts: ``put_stacked_rels`` of (b)'s mag
    relations on the ``DIST_PARTS`` thread mesh: each relation's slice,
    owner block by owner block, equals its own partitioned graph and its
    padded rows have degree 0; ELL tables kept only when every relation
    has one."""
    from tch_geometric_tpu_torch.parallel import put_stacked_rels
    order = sorted(rels)
    st = put_stacked_rels(rels, order, meshes[DIST_PARTS])
    P, Npm, Em = st.num_parts, st.rows_per_part, st.local_edge_cap
    bad = []
    for i, k in enumerate(order):
        g = rels[k]
        for f, n, m in (("ldeg", g.rows_per_part, Npm),
                        ("lstart", g.rows_per_part, Npm),
                        ("gstart", g.rows_per_part, Npm),
                        ("lindices", g.local_edge_cap, Em),
                        ("lts", g.local_edge_cap, Em)):
            a = getattr(st, f)[:, i].reshape(P, m)
            if not torch.equal(a[:, :n].reshape(-1), getattr(g, f)):
                bad.append(f"{k} {f}")
        if st.ldeg[:, i].reshape(P, Npm)[:, g.rows_per_part:].any():
            bad.append(f"{k} padded degree")
    no_ell = [k for k in order if rels[k].ell is None]
    check((st.ell is None) == bool(no_ell), "stacked ELL only when every "
          "relation has one")
    check(not bad, f"stacked relations differ: {bad}")
    log(f"phase 15 (d) put_stacked_rels of {len(order)} mag relations at "
        f"P={P}: rows a part {Npm}, edges a part {Em}, "
        f"{sum(t.numel() * t.element_size() for t in (st.ldeg, st.lstart, st.gstart, st.lindices, st.lts)) / 2**30:.3f} "
        f"GiB; ELL {'kept' if st.ell is not None else 'dropped'} "
        f"(no table: {no_ell}); every relation's slice equals its graph, "
        "padded rows of degree 0")
    return dict(rows_per_part=Npm, local_edge_cap=Em, no_ell=no_ell)


def card_vs_cpu15(sg, mag, device):
    """Phase 15 (e): the card against the CPU, same keys and inputs
    (``CUT15_SEEDS`` seeds or papers), (a) on phase 3's 5% cut (the CSC
    with seeded timestamps, and its out-edge CSR), (b) and (c) on the mag
    cut: each sampler's P = 4 configuration at ``DIST_PARTS`` thread ranks
    on both (the CSC with the temporal filter, relative, and
    ``P4_TYPED``), every other one at P = 1: equal, a Gumbel-ranked
    configuration (every budget pick, the weighted neighbor draws) within
    ``CUT_DIFF_LIMIT`` of the valid slots (each count printed; the last
    ulp of ``log`` may move a pick)."""
    from tch_geometric_tpu_torch.data.storage import to_csr
    from tch_geometric_tpu_torch.parallel import (build_partitioned_graph,
                                                  dist_budget_sample,
                                                  make_mesh)
    from tch_geometric_tpu_torch.parallel.mesh import ThreadComm
    from tch_geometric_tpu_torch.sampling import rng
    cpu = torch.device("cpu")
    ns = sg["ns"]
    out_csr = to_csr(sg["ei"], ns)[:2]
    counts, sub_csc, _r = mag_cut(mag)
    edge_types = mag[1]
    r = np.random.default_rng(166)
    seeds = r.integers(0, ns, CUT15_SEEDS)
    seed_ts = r.integers(0, TIME_RANGE, CUT15_SEEDS)
    papers = {"paper": r.integers(0, counts["paper"], CUT15_SEEDS)}
    states = {"paper": r.integers(0, TIME_RANGE, CUT15_SEEDS)}
    homogeneous = ((1, "csc", None), (1, "csr", None),
                   (DIST_PARTS, "csc", True))
    typed = ([(1, "budget", c) for c, _w in TYPED15_BUDGET
              if c != P4_TYPED[0]]
             + [(1, "neighbor", c) for c in HETERO_CONFIGS
                if c != P4_TYPED[1]]
             + [(DIST_PARTS, kind, c)
                for kind, c in zip(("budget", "neighbor"), P4_TYPED)])
    res, secs = {}, {}
    for side, dev in (("card", device), ("cpu", cpu)):
        t = time.perf_counter()
        ts = edge_values(len(sg["ri"]), 167, dev)[1]
        o = {}
        for P in (1, DIST_PARTS):
            mesh = make_mesh((P, 1), device=dev, comm=ThreadComm(P))
            g = {"csc": build_partitioned_graph(sg["cp"], sg["ri"], P,
                                                edge_timestamps=ts,
                                                device=dev),
                 "csr": build_partitioned_graph(*out_csr, P, device=dev)}
            budget_rels, neighbor_rels, _ts = mag_rels15(
                counts, edge_types, sub_csc, P, dev, 168)
            rels = {"budget": budget_rels, "neighbor": neighbor_rels}
            with torch.no_grad():
                for _p, k, rel in (h for h in homogeneous if h[0] == P):
                    kw = dict(capacity_factor=DIST_CF)
                    if rel is not None:
                        kw.update(input_timestamps=seed_ts,
                                  window=TEMPORAL_WINDOW, forward=True,
                                  relative=rel)
                    s, ovf = dist_budget_sample(rng.key(169), g[k], seeds,
                                                FANOUTS, mesh, **kw)
                    name = k if rel is None else f"{k} temporal relative"
                    o[f"budget {name} P={P}"] = (budget_layers(s), ovf)
                for _p, kind, cfg in (x for x in typed if x[0] == P):
                    o[f"typed {kind} {cfg} P={P}"] = typed15(
                        kind, cfg, rels[kind], edge_types, papers, states,
                        mesh)
        for k, (s, ovf) in o.items():
            check(int(ovf.sum()) == 0, f"(e) {side} {k}: overflow 0")
            o[k] = s
        res[side] = o
        secs[side] = time.perf_counter() - t
    out = {}
    for k in res["card"]:
        a, b = res["card"][k], res["cpu"][k]
        diff = whole_diff(a, b)
        valid = (int(b["node_valid"].sum()) if isinstance(b, dict)
                 else sum(int(v.sum()) for v in b[2].values()))
        exact = k.startswith("typed neighbor uniform")
        rate = diff / max(valid, 1)
        log(f"check: phase 15 (e) {k} card vs CPU: {diff} slots differ of "
            f"{valid} valid ({rate:.2e}; limit "
            f"{0 if exact else CUT_DIFF_LIMIT})")
        check(diff == 0 if exact else rate <= CUT_DIFF_LIMIT,
              f"(e) {k}: card and CPU differ in {diff} slots")
        out[k] = dict(differing=diff, valid=valid, rate=rate)
    log(f"phase 15 (e) seconds: card {secs['card']:.1f}, CPU "
        f"{secs['cpu']:.1f}")
    out["seconds"] = secs
    return out


def phase15(p, csr, mag, sg, device, timer):
    """Phase 15: (a)-(e), each part's wall seconds logged; returns its
    numbers.  Tears the process group down at the end."""
    from tch_geometric_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    res, secs = {}, {}

    def part(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        log(f"phase 15 {name}: {secs[name]:.1f}s")
        return out

    meshes = dist_meshes(device, DIST_STORE15, "phase 15")
    graphs, res["graphs"] = part("products graphs", lambda: graphs15(
        p, csr, device, timer))
    res["budget"] = part("(a)", lambda: budget15(graphs, meshes, timer))
    del graphs
    torch.cuda.empty_cache()

    def mag_rels():
        rels = {}
        for P in (1, DIST_PARTS):
            b, n, ts = mag_rels15(*mag, P, device, 170)
            rels["budget", P], rels["neighbor", P], rels["ts"] = b, n, ts
        return rels
    rels = part("mag relations", mag_rels)
    res["typed"] = part("(b), (c)", lambda: typed_requests15(
        mag, rels, meshes, device, timer))
    res["stacked"] = part("(d) layouts", lambda: stacked15(
        rels["budget", DIST_PARTS], meshes))
    del rels
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = part("(e)", lambda: card_vs_cpu15(sg, mag, device))
    multihost.shutdown()
    res["part_s"] = secs
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 15 wall time {res['wall_s']:.1f}s")
    return res


# ---------------------------------------------------------------------------
# Phase 16: distributed HGT sampling, HGT(psum_axis=) and the partitioned
# HGT trainer
# ---------------------------------------------------------------------------

DIST_STORE16 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "dist_store16")
# scripts/bench_partitioned_hgt.py:47-52, 178: 512 seeds a step, [128, 128]
# per type, capacity factor 2.0, HGT(128, 128, 2 layers, 4 heads)
HGT16_CF = 2.0
HGT16_STRUCTURES = (False, True, "scan")
HGT16_P4_STEPS = 3              # (b) at P = 4: the cross-P losses
CUT16_SEEDS = 256               # (d): papers a call or step on the mag cut
HGT16_LOSS_RTOL = 1e-5


def hgt16_rels(mag, P, device, ts=None, ell=None):
    """The mag-shaped relations partitioned for P ranks, one
    ``build_partitioned_graph`` a relation as ``build_partitioned_hetero``
    builds them (edge timestamps ``ts`` by sorted edge where given;
    ``ell=False``: no ELL table for any relation, so every structure draws
    its subsets alike)."""
    from tch_geometric_tpu_torch.parallel import build_partitioned_graph
    _counts, _edge_types, csc = mag
    return {k: build_partitioned_graph(
        torch.from_numpy(v[0]).to(device), torch.from_numpy(v[1]).to(device),
        P, edge_timestamps=None if ts is None else ts[k], ell_table=ell,
        device=device) for k, v in csc.items()}


def hgt16_sample(mag, rels, seeds, mesh, stacked, key, timerange=None):
    """One ``dist_hgt_sample`` of ``seeds`` papers, ``HGT_TRAIN_SAMPLES``
    per type, capacity factor ``HGT16_CF``: the outputs with the COO's
    rank blocks concatenated, and the overflow (P,)."""
    from tch_geometric_tpu_torch.parallel import dist_hgt_sample
    counts, edge_types, _csc = mag
    out, ovf = dist_hgt_sample(
        key, rels, edge_types, {"paper": seeds},
        {t: HGT_TRAIN_SAMPLES for t in counts}, len(HGT_TRAIN_SAMPLES), mesh,
        node_counts=counts, timerange=timerange, capacity_factor=HGT16_CF,
        stacked=stacked)
    nodes, node_ts, valid, rows, cols, eptr, ev = out
    flat = lambda d: {k: v.reshape(-1) for k, v in d.items()}  # noqa: E731
    return (nodes, node_ts, valid, flat(rows), flat(cols), flat(eptr),
            flat(ev)), ovf


def hgt16_valid_only(s):
    """A sample with its invalid slots set to -1 (nodes, times) or 0
    (edges): what (c) compares."""
    nodes, node_ts, nv, rows, cols, eptr, ev = s
    m = lambda ok, d: {k: torch.where(ok[k], v, -1)  # noqa: E731
                       for k, v in d.items()}
    return (m(nv, nodes), m(nv, node_ts), nv, m(ev, rows), m(ev, cols),
            m(ev, eptr), ev)


def hgt16_hops(s, counts, n_seeds):
    """Valid slots by type, in the order seeds, hop 1, hop 2."""
    nv = s[2]
    out = {}
    for t in sorted(counts):
        caps = [n_seeds if t == "paper" else 0] + list(HGT_TRAIN_SAMPLES)
        b = np.cumsum([0] + caps)
        out[t] = [int(nv[t][b[i]: b[i + 1]].sum()) for i in range(len(caps))]
    return out


def check_hgt16(what, s, check_g, counts, n_seeds, timerange=None):
    """(a)'s checks: every kept edge is real (its pointer in the
    destination's CSC window, reading the source) between two valid slots;
    each node is sampled at most once a type; under ``timerange`` every
    sampled node's time (its budget's, the max over the in-edges that
    passed) lies in it.  Returns the kept edges."""
    nodes, node_ts, nv, rows, cols, eptr, ev = s
    edges = 0
    for k, g in check_g.items():
        src, _r, dst = k.split("__")
        m = ev[k]
        e, rr, cc = eptr[k][m], rows[k][m], cols[k][m]
        parent = nodes[dst][cc]
        check(bool(nv[src][rr].all()) and bool(nv[dst][cc].all())
              and torch.equal(g.indices[e].long(), nodes[src][rr])
              and bool(((e >= g.indptr[parent])
                        & (e < g.indptr[parent + 1])).all()),
              f"{what}: every kept {k} edge is real, between valid slots")
        edges += int(m.sum())
    for t in counts:
        v = nodes[t][nv[t]]
        check(torch.unique(v).numel() == v.numel(),
              f"{what}: each {t} node sampled at most once")
        if timerange is not None:
            n = n_seeds if t == "paper" else 0
            ts = node_ts[t][n:][nv[t][n:]]
            check(bool(((ts == -1) | ((ts >= timerange[0])
                                      & (ts < timerange[1]))).all()),
                  f"{what}: every sampled {t} node's time passes the gate")
    return edges


def sampler16(mag, meshes, device, timer):
    """Phase 16 (a) and (c): ``dist_hgt_sample`` of ``HGT_TRAIN_SEEDS``
    papers at P = 1 in the three structures (one warm-up, one timed call
    each), bit-equal to one another, and fused once with ``timerange`` =
    ``TEMPORAL_WINDOW`` on edge timestamps in [0, 1000); then fused at
    P = 4 (one call), equal to P = 1's on every valid slot and validity
    bit.  The relations carry no ELL table: the has_topic relation into
    field_of_study has none (its largest in-degree is past the widest),
    so the stacked layouts drop every relation's, and the per-relation
    structure draws alike only without them.  Each sample checked by
    ``check_hgt16``, overflow 0.  Returns the numbers and (b)'s relations
    (ELL tables where they fit) at P = 1 and ``DIST_PARTS``."""
    from types import SimpleNamespace
    from tch_geometric_tpu_torch.sampling import rng
    counts, edge_types, csc = mag
    r = np.random.default_rng(173)
    seeds = r.choice(counts["paper"], HGT_TRAIN_SEEDS, replace=False)
    check_g = {k: SimpleNamespace(indptr=torch.from_numpy(v[0]).to(device),
                                  indices=torch.from_numpy(v[1]).to(device))
               for k, v in csc.items()}
    key = rng.key(174)
    res, outs = {}, {}
    rels = {1: hgt16_rels(mag, 1, device, ell=False)}

    def report(name, s, ovf, ms, timerange=None):
        what = f"phase 16 (a) dist_hgt_sample {name}"
        check(int(ovf.sum()) == 0, f"{what}: overflow 0")
        edges = check_hgt16(what, s, check_g, counts, HGT_TRAIN_SEEDS,
                            timerange)
        hops = hgt16_hops(s, counts, HGT_TRAIN_SEEDS)
        log(f"{what}: ms "
            + (f"(first, warm-up) {ms[0]:.1f}, then {ms[1]:.1f}"
               if len(ms) > 1 else f"{ms[0]:.1f} (one call)")
            + f"; overflow 0; valid slots by type (seeds, hop 1, hop 2) "
            f"{hops}; {edges} kept edges checked")
        res[name] = dict(ms=ms[-1], first_ms=ms[0], valid_by_hop=hops,
                         edges=edges)

    with torch.no_grad():
        for stacked in HGT16_STRUCTURES:
            (s, ovf), ms = calls15(timer, lambda: hgt16_sample(
                mag, rels[1], seeds, meshes[1], stacked, key), 1)
            report(f"stacked={stacked} P=1", s, ovf, ms)
            outs[stacked] = s
        for stacked in HGT16_STRUCTURES[1:]:
            diff = whole_diff(outs[stacked], outs[False])
            check(diff == 0, f"phase 16 (a) stacked={stacked}: {diff} slots "
                  "differ from the per-relation structure's")
        log("check: phase 16 (a) the three structures' samples are "
            "bit-equal, every array whole")

        ts = {k: edge_values(len(v[1]), 175 + i, device)[1]
              for i, (k, v) in enumerate(sorted(csc.items()))}
        rels_t = hgt16_rels(mag, 1, device, ts, ell=False)
        (s, ovf), ms = calls15(timer, lambda: hgt16_sample(
            mag, rels_t, seeds, meshes[1], True, key, TEMPORAL_WINDOW), 1)
        report(f"fused P=1 timerange {TEMPORAL_WINDOW}", s, ovf, ms,
               TEMPORAL_WINDOW)
        del rels_t, ts

        rels[DIST_PARTS] = hgt16_rels(mag, DIST_PARTS, device, ell=False)
        (s, ovf), ms = calls15(timer, lambda: hgt16_sample(
            mag, rels[DIST_PARTS], seeds, meshes[DIST_PARTS], True, key),
            DIST_PARTS)
        report(f"fused P={DIST_PARTS}", s, ovf, ms)
        diff = whole_diff(hgt16_valid_only(s), hgt16_valid_only(outs[True]))
        check(diff == 0, f"phase 16 (c) P={DIST_PARTS}: {diff} slots differ "
              "from P=1's")
        log(f"check: phase 16 (c) the P={DIST_PARTS} sample, its blocks "
            "concatenated, equals P=1's on every valid slot and validity bit")
    del rels
    return res, {P: hgt16_rels(mag, P, device) for P in (1, DIST_PARTS)}


def hgt16_trainer(mag, model, mesh):
    from tch_geometric_tpu_torch.parallel import make_partitioned_hgt_trainer
    counts, edge_types, _csc = mag
    return make_partitioned_hgt_trainer(
        model, edge_types, {t: HGT_TRAIN_SAMPLES for t in counts},
        len(HGT_TRAIN_SAMPLES), counts, mesh, seed_type="paper",
        learning_rate=TRAIN_LR, capacity_factor=HGT16_CF)


def hgt16_steps(mag, rels, mesh, x, labels, batches, stacked, device, timer,
                key):
    """``len(batches)`` steps of the partitioned HGT trainer (model
    ``hgt_model``, stacked relations fused when ``stacked``, else the
    per-relation dict) from the same initial parameters: ms per step,
    losses, overflow 0, peak device memory."""
    from tch_geometric_tpu_torch.parallel import (build_interleaved_features,
                                                  put_stacked_rels)
    counts, edge_types, _csc = mag
    P = mesh.size
    model = hgt_model(counts, edge_types, stacked, device)
    tr = hgt16_trainer(mag, model, mesh)
    rels_in = (put_stacked_rels(rels, sorted(rels), mesh) if stacked
               else rels)
    xi = {t: build_interleaved_features(v, P) for t, v in x.items()}
    state = tr.init_fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for seeds in batches:
        (state, loss, _acc, ovf), t = timer(lambda: tr.train_step(
            state, key, rels_in, xi, seeds, labels[seeds]))
        check(int(ovf) == 0, f"phase 16 (b) P={P}: overflow 0")
        check(np.isfinite(float(loss)), f"phase 16 (b) P={P}: loss finite")
        ms.append(t)
        losses.append(float(loss))
    return dict(step_ms=ms, losses=losses, peak_device_gib=peak_gib())


def trainer16(mag, rels, meshes, device, timer):
    """Phase 16 (b): ``make_partitioned_hgt_trainer`` with phase 11 (a)'s
    model, 128 seeded N(0, 1) feature columns a type (interleave-sharded),
    seeded paper labels, ``HGT_TRAIN_SEEDS`` papers a step: at P = 1 per
    relation (the per-relation dict) and relation-batched (stacked
    relations, fused), one warm-up then ``TIMED_STEPS``; at ``DIST_PARTS``
    relation-batched, ``HGT16_P4_STEPS`` steps, whose losses must agree with
    P = 1's first within ``HGT16_LOSS_RTOL``."""
    from tch_geometric_tpu_torch.sampling import rng
    counts = mag[0]
    x = mag_features(counts, device)
    labels = torch.from_numpy(np.random.default_rng(176).integers(
        0, HGT_OUT, counts["paper"])).to(device)
    r = np.random.default_rng(177)
    batches = [torch.from_numpy(r.choice(counts["paper"], HGT_TRAIN_SEEDS,
                                         replace=False)).to(device)
               for _ in range(1 + TIMED_STEPS)]
    key = rng.key(178)
    out = {}
    runs = [(1, False, batches), (1, True, batches),
            (DIST_PARTS, True, batches[:HGT16_P4_STEPS])]
    for P, stacked, b in runs:
        name = f"{'stacked' if stacked else 'per_rel'} P={P}"
        res = hgt16_steps(mag, rels[P], meshes[P], x, labels, b, stacked,
                          device, timer, key)
        ms = res["step_ms"]
        timed = ms[1:] if P == 1 else ms
        res["step_ms_mean"] = float(np.mean(timed))
        log(f"phase 16 (b) partitioned HGT {name}, {HGT_TRAIN_SEEDS} papers "
            "a step: step ms "
            + (f"(first, warm-up) {ms[0]:.1f}, then " if P == 1 else "")
            + ", ".join(f"{m:.1f}" for m in timed)
            + f"; mean {res['step_ms_mean']:.1f} ms; peak device memory "
            f"{res['peak_device_gib']:.2f} GiB; overflow 0; losses "
            + ", ".join(f"{v:.6f}" for v in res["losses"]))
        out[name] = res
        torch.cuda.empty_cache()
    a = out[f"stacked P={DIST_PARTS}"]["losses"]
    b = out["stacked P=1"]["losses"][:HGT16_P4_STEPS]
    rel = max(abs(u - v) / abs(v) for u, v in zip(a, b))
    log(f"check: phase 16 (b) {HGT16_P4_STEPS} losses P={DIST_PARTS} vs "
        f"P=1: largest relative difference {rel:.3e} (limit "
        f"{HGT16_LOSS_RTOL})")
    check(rel <= HGT16_LOSS_RTOL, f"phase 16 (b) losses across P: {rel:.3e}")
    out["cross_p_rel_diff"] = rel
    return out


def card_vs_cpu16(mag, device):
    """Phase 16 (d): the card against the CPU at ``DIST_PARTS`` thread
    ranks on the mag cut, same keys and inputs: one fused sample of
    ``CUT16_SEEDS`` papers, and ``HGT16_P4_STEPS`` steps of (b)'s
    relation-batched trainer (each step's sample redrawn from its key on
    both).  The samples equal, or, where a Gumbel-ranked slot differs (the
    last ulp of ``log``), at most ``CUT_DIFF_LIMIT`` of the valid slots
    (each count printed); the losses within ``HGT16_LOSS_RTOL`` relative
    when no slot of the steps' samples differs."""
    from tch_geometric_tpu_torch.parallel import make_mesh
    from tch_geometric_tpu_torch.parallel.mesh import ThreadComm
    from tch_geometric_tpu_torch.sampling import rng
    cpu = torch.device("cpu")
    counts, sub_csc, r = mag_cut(mag)
    cut = (counts, mag[1], sub_csc)
    seeds = r.choice(counts["paper"], CUT16_SEEDS, replace=False)
    batches = [torch.from_numpy(r.choice(counts["paper"], CUT16_SEEDS,
                                         replace=False))
               for _ in range(HGT16_P4_STEPS)]
    labels = torch.from_numpy(r.integers(0, HGT_OUT, counts["paper"]))
    x_cpu = mag_features(counts, cpu, seed=179)
    key = rng.key(180)
    res, secs = {}, {}
    for side, dev in (("card", device), ("cpu", cpu)):
        t = time.perf_counter()
        mesh = make_mesh((DIST_PARTS, 1), device=dev,
                         comm=ThreadComm(DIST_PARTS))
        rels = hgt16_rels(cut, DIST_PARTS, dev)
        with torch.no_grad():
            s, ovf = hgt16_sample(cut, rels, seeds, mesh, True, key)
            steps = [hgt16_sample(cut, rels, b, mesh, True,
                                  rng.fold(key, i))
                     for i, b in enumerate(batches)]
        check(int(ovf.sum()) == 0 and all(int(o.sum()) == 0
                                          for _s, o in steps),
              f"phase 16 (d) {side}: overflow 0")
        tr = hgt16_steps(cut, rels, mesh, {k: v.to(dev)
                                           for k, v in x_cpu.items()},
                         labels.to(dev), [b.to(dev) for b in batches], True,
                         dev, lambda fn: (fn(), 0.0), key)
        res[side] = (s, [a for a, _o in steps], tr["losses"])
        secs[side] = time.perf_counter() - t
    out = {}
    (s_card, st_card, l_card), (s_cpu, st_cpu, l_cpu) = res["card"], \
        res["cpu"]
    valid = sum(int(v.sum()) for v in s_cpu[2].values())
    diff = whole_diff(s_card, s_cpu)
    out["sample"] = check_rate("dist_hgt_sample fused (slots, of the valid)",
                               diff, valid, CUT_DIFF_LIMIT,
                               where="phase 16 (d)")
    sdiff = sum(whole_diff(a, b) for a, b in zip(st_card, st_cpu))
    svalid = sum(sum(int(v.sum()) for v in b[2].values()) for b in st_cpu)
    out["steps"] = check_rate("trainer steps' samples (slots, of the valid)",
                              sdiff, svalid, CUT_DIFF_LIMIT,
                              where="phase 16 (d)")
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    log(f"check: phase 16 (d) {HGT16_P4_STEPS} trainer steps at "
        f"P={DIST_PARTS}: losses card {l_card}, CPU {l_cpu}; largest "
        f"relative difference {rel:.3e} (limit {HGT16_LOSS_RTOL} when no "
        "slot differs)")
    if sdiff == 0:
        check(rel <= HGT16_LOSS_RTOL,
              f"phase 16 (d) losses card vs CPU: {rel:.3e}")
    out["steps"].update(losses_card=l_card, losses_cpu=l_cpu,
                        max_rel_loss_diff=rel)
    log(f"phase 16 (d) seconds: card {secs['card']:.1f}, CPU "
        f"{secs['cpu']:.1f}")
    out["seconds"] = secs
    return out


def phase16(mag, device, timer):
    """Phase 16: (a)-(d), each part's wall seconds logged; returns its
    numbers.  Tears the process group down at the end."""
    from tch_geometric_tpu_torch.parallel import multihost
    t0 = time.perf_counter()
    res, secs = {}, {}

    def part(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t
        log(f"phase 16 {name}: {secs[name]:.1f}s")
        return out

    meshes = dist_meshes(device, DIST_STORE16, "phase 16")
    res["sampler"], rels = part("(a), (c) sampler", lambda: sampler16(
        mag, meshes, device, timer))
    torch.cuda.empty_cache()
    res["trainer"] = part("(b) trainer", lambda: trainer16(
        mag, rels, meshes, device, timer))
    del rels
    torch.cuda.empty_cache()
    res["card_vs_cpu"] = part("(d)", lambda: card_vs_cpu16(mag, device))
    multihost.shutdown()
    res["part_s"] = secs
    res["wall_s"] = time.perf_counter() - t0
    log(f"phase 16 wall time {res['wall_s']:.1f}s")
    return res


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of ogbn-products' nodes and edges, for a "
                         "quick rehearsal; below 1 no kernels line is printed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import tch_geometric_tpu_torch  # noqa: F401  (fails outside a checkout)
    from tch_geometric_tpu_torch.ops import attention_blocked as ab
    from tch_geometric_tpu_torch.ops.spmm_kernels import spmm_blocked_cuda
    from tch_geometric_tpu_torch.ops.spmm_kernels import spmm_blocked_q8_cuda
    gat_attend_blocked_packed_cuda = ab.gat_attend_blocked_packed_cuda
    spmm_blocked_weighted_cuda = ab.spmm_blocked_weighted_cuda
    attend_kernels = (ab.sddmm_blocked_cuda, ab.edge_softmax_blocked_cuda,
                      ab.attend_blocked_fused_cuda,
                      ab.attend_blocked_flash_cuda)
    route_kernels = (gat_attend_blocked_packed_cuda,
                     ab.edge_softmax_blocked_multihead_cuda,
                     ab.spmm_blocked_multiweighted_cuda,
                     ab.gat_attend_blocked_flash_cuda)
    wrappers = ((spmm_blocked_cuda, spmm_blocked_weighted_cuda,
                 spmm_blocked_q8_cuda) + attend_kernels + route_kernels)
    from tch_geometric_tpu_torch.sampling import primitives, rng
    threefry, floyd = rng.threefry_cuda, primitives.floyd_hop_cuda
    counted = wrappers + (threefry, floyd)    # zeroed before each phase

    def t1_launches(where, ran, f1_ran=None):
        """T1's launches since the last zeroing, above 0 where ``ran``;
        F1's printed beside them, above 0 where ``f1_ran`` and 0 where it
        is False."""
        log(f"{where}: threefry_cuda (T1) launches {threefry.launches}, "
            f"floyd_hop_cuda (F1) launches {floyd.launches}")
        if ran:
            check(threefry.launches > 0, f"kernel threefry_cuda (T1) ran on "
                  f"{where}")
        if f1_ran is not None:
            check((floyd.launches > 0) == f1_ran, f"kernel floyd_hop_cuda "
                  f"(F1) {'ran' if f1_ran else 'did not run'} on {where}")
        return threefry.launches

    warnings.filterwarnings("ignore", message="Sparse CSR tensor support")
    warnings.filterwarnings("ignore", message="Sparse invariant checks")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 checks need IEEE
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_all = time.perf_counter()

    phase_build()
    phase_kernel_checks(device)

    t = time.perf_counter()
    p, prep = host_prep(args.scale, device)
    torch.cuda.synchronize()
    prep_total = time.perf_counter() - t
    n = p["x_table"].shape[0]
    log(f"host prep {prep_total:.1f}s: "
        + ", ".join(f"{k} {v:.1f}s" for k, v in prep.items())
        + f"; N={n} E={p['graph'].num_edges} max_degree="
        f"{p['graph'].max_degree} ELL={p['graph'].ell is not None}; "
        f"blocked T={p['blocked'].num_chunks} C={p['blocked'].chunk_edges}; "
        f"hot cold T={p['hot'].cold.num_chunks} hot T={p['hot'].hot.num_chunks}")

    def timer(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    res = serve(p, device, timer)
    launches = {"spmm_blocked_cuda": spmm_blocked_cuda.launches,
                "spmm_blocked_weighted_cuda":
                    spmm_blocked_weighted_cuda.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"main path launches: {launches}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} ran on the main path")
    t1_launches("main path", True)
    log("requests ms: " + ", ".join(f"{m:.1f}" for m in res["req_ms"]))
    log(f"full-graph blocked_forward {res['ms_b']:.1f} ms, hot split "
        f"{res['ms_c']:.1f} ms (first calls); peak device memory "
        f"{peak_gb:.2f} GiB")
    steady = steady_forward_ms(p, timer)
    log(f"full-graph forward, warm, {FORWARD_REPS} runs each in turns: "
        + "; ".join(f"{k} " + ", ".join(f"{m:.1f}" for m in v)
                    for k, v in steady.items()))

    serving_err = check_serving(res, n)

    models = gat_models(p, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    gres = serve_gat(p, models, timer)
    gat_launches = {"gat_attend_blocked_packed_cuda":
                    gat_attend_blocked_packed_cuda.launches}
    gat_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"GAT path launches: {gat_launches}")
    for k, v in gat_launches.items():
        check(v > 0, f"kernel {k} ran on the GAT path")
    log("GAT requests ms: " + ", ".join(f"{m:.1f}" for m in gres["req_ms"])
        + "; " + ", ".join(f"{k.upper()} request {ms:.1f} ms"
                           for k, (_, ms) in gres["other"].items()))
    log(f"full-graph blocked GAT pass {gres['ms']:.1f} ms (first call); "
        f"peak device memory {gat_peak_gb:.2f} GiB")
    gat_steady = steady_gat_ms(p, models, timer)
    log(f"full-graph blocked GAT pass, warm, {FORWARD_REPS} runs: "
        + ", ".join(f"{m:.1f}" for m in gat_steady))
    check_gat_serving(gres, n)
    del gres["out"]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    route_outs, route_ms = serve_gat_routes(p, models, timer)
    route_launches = {fn.__name__: fn.launches for fn in route_kernels}
    route_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"GAT routes launches: {route_launches}")
    for k, v in route_launches.items():
        check(v > 0, f"kernel {k} ran on the GAT routes path")
    with torch.no_grad():
        route_warm = {r: timer(lambda: gat_route_pass(
            models["gat"], p["x_table"], p["blocked"], r))[1]
            for r in GAT_ROUTES}
    log("full-graph GAT pass by route, ms (first call / warm): "
        + ", ".join(f"{r} {route_ms[r]:.1f} / {route_warm[r]:.1f}"
                    for r in GAT_ROUTES)
        + f"; peak device memory {route_peak_gb:.2f} GiB")
    route_errs = check_gat_routes(route_outs)
    del route_outs
    torch.cuda.empty_cache()

    sg = subgraph(p["data"], device)
    sub = check_subgraph(p, sg)
    gat_sub_err = check_gat_subgraph(models, sg)
    kernels, gather_bound = kernel_numbers(p, launches, device)
    kernels.append(gat_kernel_numbers(p, gat_launches, device))
    del models
    torch.cuda.empty_cache()
    route_rows, composed = gat_route_kernel_numbers(p, route_launches, device)
    kernels += route_rows
    torch.cuda.empty_cache()

    xs = attend_inputs(p, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counted:
        fn.launches = 0
    ares = serve_attend(p, xs, timer)
    attend_launches = {fn.__name__: fn.launches
                       for fn in (ab.spmm_blocked_multiweighted_cuda,)
                       + attend_kernels}
    attend_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    log(f"attend path launches: {attend_launches}")
    for k, v in attend_launches.items():
        check(v > 0, f"kernel {k} ran on the attend path")
    log("attend path ms (first calls): " + ", ".join(
        f"{k} {v:.1f}" for k, v in ares["ms"].items())
        + f"; peak device memory {attend_peak_gb:.2f} GiB")
    attend_route_errs = check_attend_routes(ares)
    del ares
    torch.cuda.empty_cache()
    attend_sub = check_attend_subgraph(sg)
    kernels += attend_kernel_numbers(p, xs, attend_launches, device)
    del xs
    torch.cuda.empty_cache()

    for fn in counted:
        fn.launches = 0
    qres = serve_q8(p, device, timer)
    q8_launches = {"spmm_blocked_q8_cuda": spmm_blocked_q8_cuda.launches}
    log(f"int8 path launches: {q8_launches}")
    check(q8_launches["spmm_blocked_q8_cuda"] > 0,
          "kernel spmm_blocked_q8_cuda ran on the int8 path")
    kernels.append(q8_kernel_numbers(p, qres, q8_launches))
    del qres
    torch.cuda.empty_cache()

    for fn in counted:
        fn.launches = 0
    train_res, trainers = train(p, device, timer)
    train_res["multibatch"] = train_multibatch(p, device, timer)
    train_launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"train path launches (no kernel of B1-B11 lies on it): "
        f"{train_launches}")
    # the train path's graph has an ELL table: its hops take the ELL
    # engine, whose draws are T1's, and F1 stays off it
    kernels.append(rng_kernel_numbers(t1_launches(
        "train path", True, f1_ran=p["graph"].ell is None), device))
    torch.cuda.empty_cache()
    kernels.append(floyd_kernel_numbers(device))
    check(len(kernels) == 13, f"{len(kernels)} kernel rows, expected 13")
    torch.cuda.empty_cache()
    train_res["card_vs_cpu"] = check_train_card_vs_cpu(p["data"], sg, device)
    prof = profile_phase(p, trainers, device)
    del trainers
    torch.cuda.empty_cache()

    for fn in counted:
        fn.launches = 0
    sampling_res = sampling_requests(p, device, timer)
    t = time.perf_counter()
    mag = mag_graph(args.scale, device)
    sampling_res["mag_host_s"] = time.perf_counter() - t
    log(f"hetero mag graph: host COO and CSC "
        f"{sampling_res['mag_host_s']:.1f}s")
    sampling_res["hetero"] = hetero_requests(mag, args.scale, device, timer)
    sampling_launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"sampling path launches (no kernel of B1-B11 lies on it): "
        f"{sampling_launches}")
    t1_launches("phase 9", True, f1_ran=True)
    torch.cuda.empty_cache()
    sampling_res["card_vs_cpu"] = check_sampling_card_vs_cpu(sg, mag, device)
    torch.cuda.empty_cache()

    for fn in counted:
        fn.launches = 0
    parity_res, csr = phase10(p, mag, sg, device, timer)
    parity_launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"phase 10 launches (no kernel of B1-B11 lies on it): "
        f"{parity_launches}")
    check(not any(parity_launches.values()),
          "no kernel of B1-B11 ran in phase 10")
    t1_launches("phase 10", False, f1_ran=True)
    torch.cuda.empty_cache()

    for fn in counted:
        fn.launches = 0
    models_res = phase11(p, mag, csr, sg, device, timer)
    models_launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"phase 11 launches (no kernel of B1-B11 lies on it): "
        f"{models_launches}")
    check(not any(models_launches.values()),
          "no kernel of B1-B11 ran in phase 11")
    t1_launches("phase 11", True, f1_ran=True)
    torch.cuda.empty_cache()

    for fn in counted:
        fn.launches = 0
    dist_res = phase12(p, sg, device, timer)
    dist_launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"phase 12 launches (no kernel of B1-B11 lies on it): "
        f"{dist_launches}")
    check(not any(dist_launches.values()),
          "no kernel of B1-B11 ran in phase 12")
    t1_launches("phase 12", False)
    torch.cuda.empty_cache()

    for fn in counted:
        fn.launches = 0
    mesh_res = phase13(p, sg, dist_res, device, timer)
    mesh_launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"phase 13 launches (no kernel of B1-B11 lies on it): "
        f"{mesh_launches}")
    check(not any(mesh_launches.values()),
          "no kernel of B1-B11 ran in phase 13")
    t1_launches("phase 13", False)
    torch.cuda.empty_cache()

    for fn in counted:
        fn.launches = 0
    walk_res = phase14(p, csr, mag, sg, device, timer)
    walk_launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"phase 14 launches (no kernel of B1-B11 lies on it): "
        f"{walk_launches}")
    check(not any(walk_launches.values()),
          "no kernel of B1-B11 ran in phase 14")
    t1_launches("phase 14", False)

    for fn in counted:
        fn.launches = 0
    budget_res = phase15(p, csr, mag, sg, device, timer)
    budget_launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"phase 15 launches (no kernel of B1-B11 lies on it): "
        f"{budget_launches}")
    check(not any(budget_launches.values()),
          "no kernel of B1-B11 ran in phase 15")
    t1_launches("phase 15", False)
    del csr

    for fn in counted:
        fn.launches = 0
    hgt_res = phase16(mag, device, timer)
    hgt_launches = {fn.__name__: fn.launches for fn in wrappers}
    log(f"phase 16 launches (no kernel of B1-B11 lies on it): "
        f"{hgt_launches}")
    check(not any(hgt_launches.values()),
          "no kernel of B1-B11 ran in phase 16")
    t1_launches("phase 16", False)
    del mag

    summary = dict(
        card=card, scale=args.scale, nodes=n, edges=p["graph"].num_edges,
        host_prep_s=prep_total, host_prep_steps_s=prep,
        request_ms=res["req_ms"],
        request_ms_steady_mean=float(np.mean(res["req_ms"][1:])),
        blocked_forward_ms=res["ms_b"], hot_split_forward_ms=res["ms_c"],
        forward_ms_warm=steady,
        blocked_vs_hot_max_diff=serving_err, peak_device_gib=peak_gb,
        lane_gather_ms_derived=gather_bound,
        gat_request_ms=gres["req_ms"],
        gat_request_ms_steady_mean=float(np.mean(gres["req_ms"][1:])),
        other_request_ms={k: ms for k, (_, ms) in gres["other"].items()},
        gat_blocked_pass_ms=gres["ms"], gat_blocked_pass_ms_warm=gat_steady,
        gat_peak_device_gib=gat_peak_gb,
        gat_blocked_vs_segment_f32=gat_sub_err,
        gat_route_pass_ms=route_ms, gat_route_pass_ms_warm=route_warm,
        gat_routes_agree_f32=route_errs,
        gat_routes_peak_device_gib=route_peak_gb,
        gat_composed_route_layer1=composed,
        attend_routes_vs_composed_f32=attend_route_errs,
        attend_vs_segment_f32=attend_sub,
        attend_peak_device_gib=attend_peak_gb,
        train=train_res, profile=prof, sampling=sampling_res,
        parity=parity_res, models=models_res, dist=dist_res,
        mesh2=mesh_res, dist_walks=walk_res, dist_budget=budget_res,
        dist_hgt=hgt_res,
        total_s=time.perf_counter() - t_all, **sub)
    log("serving: " + json.dumps(summary))
    if args.scale == 1.0:
        print(json.dumps({"kernels": kernels}), flush=True)
    else:
        log(f"rehearsal at scale {args.scale}: no kernels line")
    log(f"chip_smoke: total {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
