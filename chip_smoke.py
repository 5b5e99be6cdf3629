#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and numpy

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   hand-written kernels from ``src/repro_torch/csrc`` (one nvcc per source,
   all started together), printing each kernel's registers, spills and
   ptxas's wgmma notes and the training kernels' shared memory a block.
   Then the tensor-core rounding phase (``check_tc_rounding``): crafted
   TF32 products on wgmma and mma.sync must round as every split-TF32
   emulation and ``FLIP_PRE`` assume (one rounding a k8 step, toward zero;
   an operand's 13 low bits dropped), bitwise.
2. DSTree, end to end through the port's entry points: RandWalk 1,000,000 ×
   256 (numpy seed 0) → ``build_leafi(LeaFiConfig(backbone="dstree",
   leaf_capacity=256, t_filter_over_t_series=20.0))`` → 256 queries at
   exact, 0.99, 0.95 and per-query targets, k = 1 and 5, with the default
   candidate pass and with ``dist_impl="pairwise"``.  Prints phase times,
   pruning, searched leaves, recall against exact search and wall time per
   batch; asserts that exact search equals a brute-force scan over the
   pairwise kernel for 64 queries, and that every kernel of the path was
   launched (the launch counters are zeroed just before the build and read
   just after the last search).  The probe and the candidate pass of every
   batch under the default pass are one launch each of the candidate-pass
   kernel (``leaf_topk``), the pass on its staged ``wgmma`` instance and
   the probe on its warp instance (the launches by instance are printed
   and the staged one asserted); the cascade replay of every batch and of
   the calibration runs as one launch of the replay kernel; every training
   step of every build is one launch each of the two training kernels and
   every validation pass one of ``filter_mlp`` (asserted from the counters:
   no step runs autograd).  Every build of the script (this one, the d =
   128 DSTree, iSAX, deep and sift) runs under ``obs.recording()``
   (``_build``): its span table printed (name, depth, lane, duration,
   args) and held by ``check_build_spans``: the seven spans in closing
   order with the reference's nesting and args, each ``build.*`` span
   within 2% or 10 ms of its ``build_report`` time, and the spans' Chrome
   trace (``chiprun_out/build_spans_<label>.json``) read back equal.
3. Breaks one DSTree search batch (k = 5, target 0.99) down by layer (the
   candidate pass and the replay timed alone on the inputs the engine hands
   them; both also held against their plain versions there, and the replay
   timed from a CUDA graph beside its kernel instance and its rows' chain,
   ``ref.chain_lengths``: a lower bound on the ring entries a row takes,
   since the kernel does not report its own count), and profiles
   it for the device's busy time, launches and idle share, then the
   candidate pass alone (asserted: one ``leaf_topk_wgmma_kernel`` launch,
   no warp-instance launch, none of the eager pass's kernels; the item
   table's torch ops printed with their launches); breaks the
   build's training-data collection (``t_collect``) down by step; profiles
   50 steps of filter training (``training_profile``: wall and device-busy
   time, launches and the top device operations per step); holds the
   training kernels against the plain (autograd) step from the build's own
   state and draws: one step, every parameter and velocity within the
   limit, and 50 steps, the validation rows' predictions within
   ``STEPS_DZ_LIMIT``; a TF32 run of the plain step beside each, the
   control.
4. Single-query early-termination search (``search_early``, paper Alg. 2 as
   written) on the same DSTree index for 32 of its queries, k = 1 and 5,
   exact and at target 0.99: per-query wall time (median, p90), searched
   leaves, pruning and recall beside the batched path's figures for the
   same queries; asserts exact ``search_early`` == brute force, that
   ``box_lb`` and ``fused_filter_mlp`` launched and the walk kernel
   (``early_walk``) once a call, and holds each of the 128 walk launches
   bitwise against the plain walk on its own arguments (top-k values and
   ids, searched, visited and filter-pruned counts).  The same phase runs
   on the iSAX float32 index after its batches (step 7).  Then the paper's
   comparison methods (``run_simulators``, ``repro_torch.core.baselines``)
   on the port's own (d_lb, d_L, d_F) matrices for the first 64 queries,
   tuned on 64 validation queries: exact, LeaFi, eps, delta-eps, ProS, LT
   and LR, each one's recall, searched leaves and pruning beside
   ``search_early``'s searched leaves at k = 1, 0.99; asserts that exact
   and LR recall 1 and that the oracle filter (d_F = d_L) searches no more
   leaves than exact, query by query, with the same final bsf.  Then DTW
   (``run_dtw``, ``repro_torch.core.dtw``) on the same index's leaf-sorted
   series at r = 8 for 8 of its queries: every series' Keogh envelope and
   each leaf's (min L, max U over its members, by contiguous segments), the
   node-level LB_Keogh (8 x L) and the point-wise LB_Keogh (8 x 1,000,000)
   through ``box_lb``, and the DTW of all 8,000,000 pairs in one launch of
   ``csrc/dtw.cu`` (asserted from the counters: one ``dtw`` launch, two
   ``box_lb``); the DTW held bitwise against its plain version on every
   pair; asserts lb_keogh <= dtw <= euclidean on every pair and the node
   bound <= the least member DTW on every (query, leaf), each within the
   reference tests' 1e-4; prints each query's DTW 1-NN beside its
   Euclidean 1-NN and the share of leaves LB_Keogh alone would prune.  Then
   the filter types (``run_filter_types``) on the same DSTree index: for the
   paper's CNN (channels 256, ksize 3) and LSTM (hidden 64) filter
   backbones, parameters from the port's ``filters.INIT`` (a CUDA generator
   seeded 0; y_mean and y_std copied from the MLP stack, so the
   predictions sit on the distance scale), the tuners refit on the index's
   calibration split (one launch of the backbone's kernel at Q = 180), 64
   queries through ``LeaFiIndex.search`` at exact and 0.99, k = 1 and 5,
   and ``search_early`` on 8 of them at k = 5, 0.99: pruning, searched
   leaves, recall against exact search and wall time per batch and per
   query, and recall@1 at 0.99 on the calibration split beside the
   tuner's knots; asserts one launch of the backbone's kernel a prediction
   call and none of the fused MLP kernel.
5. The grouped per-target search (``search_batched_grouped``) on the 256
   per-query-target queries, k = 1 and 5, beside the vectorised per-query
   batch: recall, pruning, the share of identical ids; asserts the
   reference's serving tolerances between the two, and that the replay
   kernel launched.  Then the trace and the audit (``run_trace_audit``):
   the 256 queries through ``LeaFiIndex.search(trace=True, audit=True)``,
   k = 1 and 5, exact and 0.99, the default pass and (k = 5) ``pairwise``,
   each bitwise equal to the untraced batch in its answers and counters,
   both accounting identities zero, the audit's leaf sums the trace's
   query sums; then again with the prune-only bound ``bsf_ub`` (the exact
   k-th distance, inflated): exact answers those of the unbounded batch,
   seed prunes, the bounded batches on the replay's bound instance
   (launches by instance asserted); a traced batch's median wall beside
   the untraced one's.  Every audited batch is folded into a
   ``LeafHealthBoard`` with a ``MetricsRegistry`` (``check_health_board``:
   the window's totals equal to the folded audits, the flags in the
   reference's severity order, every Prometheus sample line ``name{labels}
   value``), and a ``RecallDriftMonitor`` takes the k = 1, 0.99 batch's
   per-query hits against the exact batch.  Then serving
   (``run_serving``) on the same index: ``save_index`` to
   ``.chip_scratch/`` and ``load_index`` onto the card (every array
   bitwise, a 256-query batch at k = 5, exact and 0.99, bitwise the same
   answers and counters; the bytes and the save and load seconds
   printed); ``repro_torch.launch.serve.main`` in this process on that
   checkpoint (``--arch leafi --batch 64 --k 5 --requests 2048 --rate
   2000 --targets 0.9,0.95,0.99 --max-wait-ms 20 --warm-start
   --shadow-rate 0.05 --summary --explain 0`` with the health, metrics
   and trace dumps into ``chiprun_out/``): every request answered, each
   target group's recall printed beside its n, the Prometheus text
   parsing, the Chrome trace holding ``serve.dispatch`` and
   ``serve.harvest``; a warm-start ``ServingSession`` over 1,024 requests
   (k = 1 and 5) served serially and with ``pipeline=2`` under one
   injected clock, the batch logs, completions and results equal (``==``)
   and every served distance at least the exact one less 1e-4; and the
   served batch's time in four sessions (cold, warm start, audited, both):
   ``serve_form_s`` and ``serve_exec_s`` p50/p95/p99 beside the medians
   of ``BsfCache.seed``, ``tuner.offsets``, the board's refresh and the
   ``index.order`` copy.  The phase's launches join the paths' counts
   (warm start runs the replay's bound instance).
6. The filter-inference suite (``repro_torch.bench.filters_bench``) at its
   own sweep (F = 64 .. 4096, Q = 128, m = h = 128), then once at the DSTree
   index's shape (its F, Q = 256, m = h = 256): the per-filter
   ``filter_mlp`` kernel beside the fused kernel's three payloads, each
   against its roofline bound; asserts that all four launched.  Then a
   DSTree at 64 EAPCA segments (d = 128 box dimensions, beyond the box
   kernel's register instances) on RandWalk 100,000 × 256: exact search
   == brute force for 64 queries at k = 5, and its scan strategy with
   trace and audit (``_scan_trace_audit``: bitwise the untraced scan).
   Then the same build under ``torch.profiler`` (``profile_build``): every
   span one ``user_annotation``, the device kernels launched inside
   ``build.collect`` including ``pairwise_l2``, ``slab_l2`` and ``box_lb``
   launches and those inside ``train.sgd`` ``train_forward`` and
   ``train_backward_sgd`` (by the launching call's correlation id); its
   wall beside the unprofiled build's.
7. iSAX, end to end on the same collection: ``build_leafi(LeaFiConfig(
   backbone="isax", word_len=8, leaf_capacity=256,
   t_filter_over_t_series=20.0))`` with float32 filter weights, then
   ``requantize_leafi`` to bfloat16 and int8; for each payload 256 queries
   at the four targets, k = 1 and 5.  Prints phase times, L, F, the largest
   leaf, peak memory, and per batch pruning, recall and wall time; asserts
   exact == brute force and that all six kernels launched (counters zeroed
   just before the build, read after the last search).  Prints each
   index's recall@1 at target 0.99 on its own calibration split (DSTree's
   too) beside the tuner's quality knots.  Then the same layer and
   collection breakdowns and the trace-and-audit phase for iSAX.  Then the paper's deep- and sift-like
   collections at their own widths (m = 96 and 128, 200,000 series each,
   ``run_datasets``): a DSTree build, 64 queries exact and at 0.99, k = 1
   and 5, exact == brute force; each index's filters trained a second time
   with the plain step on the card, the mean val_rmse_z within
   ``TRAINING_RMSE_LIMIT`` (relative) and the filters' predictions on the
   queries within ``TRAINING_DZ_LIMIT``, and a third time with TF32
   allowed, the control.
8. Holds each kernel against its plain PyTorch version on the card, on the
   largest inputs the main paths gave it (the replay bitwise, its top-k and
   its three counters, each held call also through its bound and traced
   instances (five counters; ``replay_bound``) and the four timed in turns
   at the batch's and calibration's calls, also on calibration's largest
   call, each printed
   with its kernel instance and its rows' chain, each asserted to take
   the instance whose walk reads shared memory only and, at the batch, to
   put a block on every SM; and, for the
   fused filter kernel and ``box_lb``, also on its smallest-Q call:
   ``search_early``'s
   single query, which takes the weight-streaming design and the
   few-query path; the early walk bitwise on the largest k = 5 exact call
   of each ``search_early`` phase, timed, and at ``RAGGED_EARLY``, each
   held call printed with its grid, registers, its time from a CUDA graph
   and its bound; ``box_lb`` at every shape the paths gave it, with its
   launches per shape; the candidate pass in both distance forms and on
   the probe's largest call, its ids equal except at near-ties), and
   times kernel (through its
   wrapper, and replayed from a CUDA graph without the host-side enqueue),
   plain version and (for the distance kernels) ``torch.cdist``, beside
   the least time the card could take: float32 CUDA-core peak and HBM
   rate for every kernel, and for the split-TF32 kernels also the split
   design's bound (its passes x the products at the TF32 tensor-core peak)
   and the function's one-pass TF32 bound.  Holds the redesigned kernels,
   untimed, also at ragged shapes (partial tiles, m % 4 != 0, h not a
   multiple of a 16-byte vector, R and L % 4 != 0, the iSAX build's last
   slab chunk, box sides at +-inf, d = 5 .. 512, Q = 1 and 33; the replay
   at k = 1, 5, 32, 33 and 257 with ties, +-inf and NaN, shuffled orders,
   Q = 1, rows apart, a row where every position is kept (the ring stays
   full), rows whose bsf falls only near their end and a calibration-shaped
   Q = 4096 at k = kk = 1; the candidate pass at kk = 1 .. 257, max leaf 7 ..
   1000, m = 65 .. 256, Q = 1, empty lists, padding slots and the probe's
   form, and its staged instance at ``RAGGED_STAGED``: a leaf kept by 1,
   65 and all 256 queries, leaves of 0 .. 1000 rows, m = 64 .. 256, kk
   = 1 .. 8 (one register instance each) and 32; each held call prints
   the instance it took), and the
   filter kernels on their largest call's
   weights at the Q on either side of the stream design's limit, so every
   instance of both designs is held; ``filter_mlp`` is timed beside the
   fused float32 kernel at its own call.  The training kernels are held on
   one step of the largest build (every output: dpred, or the updated
   parameters and velocities) and, untimed, at F = 1 and 3, m = h = 96,
   128 and 65, h != m and batches 128, 8 and 4.  The CNN and LSTM kernels
   are held at their calibration call (F = 4096, Q = 180) and at Q = 1,
   timed (reps by their bound), a TF32 plain run beside as the control,
   each with its launch (the CNN's tile and the c2 bytes it stages from
   L2, the LSTM's instance), and untimed at ``RAGGED_CNN`` and
   ``RAGGED_RNN`` (m = 1, 33, 96 and 300, channels 40, 64, 98, 100 and
   130, ksize 1, 2, 3 and 5; hidden 32 and 64 on either side of the
   few-query limit, 100 and 2500 on the generic instance, the last two
   reading the weights through L2 and 2500 keeping its state in memory;
   F = 1 .. 3, Q = 1 .. 300), each printing its launch.  The DTW kernel is held
   bitwise and timed at the DTW phase's call and at its first query alone
   (Q = 1), and held bitwise, untimed, at ``RAGGED_DTW`` (m = 33, 96 and
   256, r = 0, 1, 3, 8, m - 1 and m + 5, Q = 1 and 8, N = 1001: both
   instances, each printed).  The build's ``-Xptxas -v`` lines
   (registers, shared memory, spills) are printed per kernel; the
   redesigned kernels must not spill.
9. Prints ``{"kernels": [...]}`` and, as the last line,
   ``{"ok": true, "device": {...}}``.  Any failure raises and exits
   non-zero before that line; so does a machine without a CUDA card.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: what the training kernels replace: no Pallas kernel
TRAIN_SOURCE = ("no Pallas kernel: the reference's jitted SGD step, "
                "src/repro/core/filter_training.py:274")
#: what the candidate-pass kernel replaces: no Pallas kernel
LEAF_TOPK_SOURCE = ("no Pallas kernel: the reference's jitted lax.fori_loop "
                    "candidate pass, src/repro/core/engine.py:271")
#: what the early-walk kernel replaces: no Pallas kernel
EARLY_SOURCE = ("no Pallas kernel: the reference's jitted lax.while_loop "
                "walk, src/repro/core/search.py:327 _search_early_core")
#: what the filter backbones' kernels replace: no Pallas kernel
CNN_SOURCE = ("no Pallas kernel: the reference's XLA convolutions, "
              "src/repro/core/filters.py:176 apply_cnn")
RNN_SOURCE = ("no Pallas kernel: the reference's lax.scan LSTM layers, "
              "src/repro/core/filters.py:233 apply_rnn (:215 _lstm_layer)")
#: what the DTW kernel replaces: no Pallas kernel
DTW_SOURCE = ("no Pallas kernel: the reference's jitted lax.scan over the "
              "table's rows, src/repro/core/dtw.py:29 dtw")
KERNELS = {
    # name: (source, TPU kernel it replaces, tolerance (atol, rtol), reason);
    # the limits are a few times the f32 reading, below what a TF32 run of
    # the plain version errs by (printed beside each check)
    "pairwise_l2": ("src/repro_torch/csrc/l2_scan.cu",
                    "src/repro/kernels/l2_scan/kernel.py:42",
                    (1e-4, 1e-5), "f32 sums of |q|^2+|s|^2-2q.s in another "
                    "order; |q|^2 = m = 256 for z-normalized series"),
    "slab_l2": ("src/repro_torch/csrc/l2_scan.cu",
                "src/repro/kernels/l2_scan/kernel.py:94",
                (1e-4, 1e-5), "as pairwise_l2"),
    "fused_filter_mlp": ("src/repro_torch/csrc/filter_mlp.cu",
                         "src/repro/kernels/filter_mlp/kernel.py:157",
                         (1e-4, 1e-5), "f32 sums over m and h in another "
                         "order"),
    "fused_filter_mlp_bf16": ("src/repro_torch/csrc/filter_mlp.cu",
                              "src/repro/kernels/filter_mlp/kernel.py:157",
                              (1e-4, 1e-5), "bf16 weights upcast exactly; "
                              "f32 sums in another order"),
    "fused_filter_mlp_int8": ("src/repro_torch/csrc/filter_mlp.cu",
                              "src/repro/kernels/filter_mlp/kernel.py:157",
                              (1e-4, 1e-5), "int8 weights upcast exactly; "
                              "the scales fold in after the sums instead "
                              "of before (one more f32 rounding)"),
    "box_lb": ("src/repro_torch/csrc/box_lb.cu",
               "src/repro/kernels/box_lb/kernel.py:31",
               (1e-4, 1e-5), "f32 sum over d in another order"),
    "filter_mlp": ("src/repro_torch/csrc/filter_mlp.cu",
                   "src/repro/kernels/filter_mlp/kernel.py:66",
                   (1e-4, 1e-5), "f32 sums over m and h in another order"),
    "replay": ("src/repro_torch/csrc/replay.cu",
               "no Pallas kernel: the reference's lax.scan replay, "
               "src/repro/core/engine.py:307",
               (0.0, 0.0), "comparisons and selection only: bitwise, the "
               "top-k and all its counters (three; five traced)"),
    # dpred carries the loss's 2·w/(F·batch) scale, so an absolute term
    # would hold nothing: within 2e-5 of its own largest value (tighter
    # than 1e-4 + 1e-5·max below max 10)
    "train_forward": ("src/repro_torch/csrc/filter_train.cu",
                      TRAIN_SOURCE, (0.0, 2e-5), "dpred: f32 layer-1 sums "
                      "over m and h in another order, relative to "
                      "max|dpred|"),
    # the velocities relative to their own max (no absolute term), beyond it
    # only by what relu flips can move (FLIP_PRE); each parameter bitwise
    # its own update p - lr·v from the kernel's velocity
    "train_backward_sgd": ("src/repro_torch/csrc/filter_train.cu",
                           TRAIN_SOURCE, (0.0, 2e-5), "v_w1, v_b1, v_w2, "
                           "v_b2: f32 sums over m and the rows in another "
                           "order, relative to max|v| each; w1, b1, w2, b2: "
                           "bitwise p - lr·v of the kernel's own v"),
    "early_walk": ("src/repro_torch/csrc/early_walk.cu", EARLY_SOURCE,
                   (0.0, 0.0), "each row's float32 sum in one fixed order, "
                   "no FMA (the plain version repeats it), then comparisons "
                   "and selection: bitwise, the top-k and all three "
                   "counters"),
    # ids: equal, or where they differ a near-tie (``_leaf_topk_errors``)
    "leaf_topk": ("src/repro_torch/csrc/leaf_topk.cu", LEAF_TOPK_SOURCE,
                  (1e-4, 1e-5), "f32 sums over m in another order (the "
                  "matmul form's |q|^2 = m = 256 for z-normalized series); "
                  "ids equal except at near-ties, where the kernel's row "
                  "lies within the limit of the plain version's at that "
                  "rank"),
    "filter_cnn": ("src/repro_torch/csrc/filter_cnn.cu", CNN_SOURCE,
                   (1e-4, 1e-5), "f32 sums over K x C inputs and the "
                   "positions in another order"),
    # relative to max|plain| alone: 1e-4 + 1e-5·max|plain| would accept a
    # TF32 run of the plain version (4.8e-5 at the calibration call on an
    # H100, the kernel 9.5e-7)
    "filter_rnn": ("src/repro_torch/csrc/filter_rnn.cu", RNN_SOURCE,
                   (0.0, 1e-6), "f32 gate sums in another order, carried "
                   "through 2 x m dependent steps; relative to max|plain|"),
    "dtw": ("src/repro_torch/csrc/dtw.cu", DTW_SOURCE, (0.0, 0.0),
            "each cell one correctly rounded operation a step in the "
            "reference's order, no FMA, minima propagating NaN, a correctly "
            "rounded root: bitwise"),
}
#: relu's derivative jumps at 0: a layer-1 sum within rounding of 0 may land
#: on the other side in the plain version and move its column of the v_b1
#: and v_w1 update by |dpred·w2| and |dpred·w2·x| (at F = 4096 a few of 168M
#: sums do).  A sum counts as within rounding of 0 when |pre| <= FLIP_PRE x
#: (|x|·|w1| + |b1|), 2.6x the split-TF32 accumulator's worst drift over m =
#: 256 (96 steps, each rounding toward zero by up to 2^-23 of the sum); the
#: elements of v_w1 and
#: v_b1 may exceed their limit by the sum of those moves and no more
#: (``_flip_room``).  v_w2 and v_b2 take relu(pre) itself, which does not jump.
FLIP_PRE = 3e-5
#: the 50-step hold's limit on max |dz| over the validation rows: the
#: kernels read 1.19e-5, a TF32 run of the plain step 1.64e-4 (an H100)
STEPS_DZ_LIMIT = 5e-5
#: the whole training's limits: on the relative difference of mean
#: val_rmse_z (the kernels read 1.1e-7 on deep and 3.1e-7 on sift, a TF32
#: run of the plain training 1.1e-6 and 4.2e-7: on sift this mean cannot
#: tell the two apart), and on max |dz| of the trained filters over the
#: phase's queries (the kernels 8.8e-5 and 1.6e-5, TF32 3.7e-3 and 2.3e-3)
TRAINING_RMSE_LIMIT = 6e-7
TRAINING_DZ_LIMIT = 4e-4
#: design of each kernel, and the tensor-core passes of the split-TF32 ones
#: (products per float32 multiply-add; bf16/int8 weights are exact in TF32;
#: the backward training kernel's 2.5 is 3 for the recomputed layer 1 and 2
#: for the w1 gradient, whose mask operand is exact)
DESIGN = {
    "pairwise_l2": ("split-TF32 mma.sync, 128x128 tile, 3-stage cp.async", 3),
    "slab_l2": ("split-TF32 mma.sync, 128 slab rows x 104 queries (queries "
                "on the n8 axis), 3-stage cp.async, slab index slowest", 3),
    "fused_filter_mlp": ("split-TF32 mma.sync 128-query tiles; f32 weight "
                         "stream for a few queries", 3),
    "fused_filter_mlp_bf16": ("split-TF32 mma.sync 128-query tiles; f32 "
                              "weight stream for a few queries", 2),
    "fused_filter_mlp_int8": ("split-TF32 mma.sync 128-query tiles; f32 "
                              "weight stream for a few queries", 2),
    "box_lb": ("f32 SIMT, 4 boxes a thread in registers, 16-byte stores, "
               "grid sized to the SMs; no query tile for a few queries",
               None),
    "filter_mlp": ("the fused float32 kernel's designs with the raw "
                   "epilogue: split-TF32 mma.sync 128-query tiles; f32 "
                   "weight stream for a few queries", 3),
    "replay": ("a walker warp and producer warps a row: the producers "
               "gather d_lb and d_F 64 positions a step, the order a step "
               "ahead, pre-test them against the walker's newest bsf in "
               "shared memory, drop the certainly lb-pruned and write the "
               "rest in visit order into a 256-entry shared-memory ring "
               "(an entry: bound, prediction, the leaf's least value and, "
               "where it may enter the top-k, its kk <= 8 slots), ordered "
               "by acquire/release flags; the walker takes 32 entries a "
               "step, re-tests them lane-parallel and merges one by one "
               "only leaves with a value below its bsf, reading shared "
               "memory only (k <= 32, kk <= 8).  A block a row of 1 + 7 "
               "warps (a batch's 256 rows fill every SM; at calibration "
               "few rows in flight on an SM); top-k in registers for k <= "
               "32, in the output row beyond.  Three instances: plain, the "
               "prune-only bound (the lb test against min(bsf, ub)) and "
               "the traced (the box/seed split; its producers drop only "
               "certain box prunes)", None),
    "early_walk": ("a persistent grid of one block of 8 warps a SM, "
                   "launched cooperatively (every block resident): scorer "
                   "warps claim (leaf, 64 rows) items in visit order, "
                   "pre-test each against the walker's published bsf, read "
                   "the rows 8 at a time (16-byte loads where m % 4 == 0) "
                   "and write the item's k smallest distances below that "
                   "bsf into a 2048-item ring in global memory, a leaf's "
                   "items counted complete with release order; one walker "
                   "warp takes 32 complete leaves a step, re-tests them "
                   "lane-parallel and merges one by one only searched "
                   "leaves that can enter the top-k; top-k in registers "
                   "for k <= 32, in the output row or the slot beyond",
                   None),
    "train_forward": ("persistent, one block of 3 warpgroups per SM over "
                      "(filter, 160-row tile) items: a producer warpgroup "
                      "(cp.async gathers of the raw rows and their lo "
                      "parts into "
                      "128-byte-swizzled stages, TMA w1 tiles, mbarriers, "
                      "3 stages of 72 KB), 2 consumer warpgroups of 80 rows "
                      "on split-TF32 wgmma m64n80k8, 4 lane tiles each (A "
                      "= w1^T split in registers); writes dpred only", 3),
    "train_backward_sgd": ("persistent over (filter, 128-lane) items: the "
                           "forward's producer and layer 1 (2 lane tiles, "
                           "recomputed bitwise), the relu mask kept as "
                           "bits, g_w1 = w2 * (X*dpred)^T.M on wgmma "
                           "m64n64k8 (2 products, M exact) per 64-column "
                           "tile of m whose raw rows serve both 64-lane "
                           "chunks, 40-row stages, the two warpgroups' "
                           "halves summed; w1 / v_w1 tiles in and out by "
                           "TMA through a 2-deep ring, SGD between; a batch "
                           "above 128 in 160-row tiles, g_w1 summed in the "
                           "velocity", 2.5),
    "leaf_topk": ("two instances by the call's shapes.  wgmma (the batch's "
                  "survivor pass, matmul form, m % 4 == 0, kk <= 32): "
                  "persistent, (leaf, 64 queries) items made on the "
                  "device; two pipelines a block, each a producer half "
                  "(TMA stages of 32 columns x 128 rows, 128-byte swizzle, "
                  "a 3-stage ring; the rows' lo and |s|^2 made in shared "
                  "memory) and a consumer warpgroup (split-TF32 wgmma "
                  "m64n128k8, A = the queries split in registers, each "
                  "32-column stage summed from zero; per-lane top-kk "
                  "lists, in registers for kk <= 8, placed by rank across "
                  "the quad).  warp (the probe, direct, m % 4 != 0, kk > "
                  "32): one warp a (query, leaf) pair, pairs leaf-major, "
                  "32 rows a step straight from the series, top-kk in "
                  "registers for kk <= 32, in the output row beyond", None),
    "filter_cnn": ("a block per (filter, query tile): its queries, each "
                   "followed by K - 1 zero columns, fill 256 columns; a "
                   "producer warpgroup and 2 consumer warpgroups, an "
                   "mbarrier ring of B tiles (a 32-channel chunk each) and "
                   "one of c2 tiles (a (chunk, shift) each); conv 2 on "
                   "split-TF32 wgmma m64n256k8, D = c2^T . h1^T (64 output "
                   "channels x 256 columns a warpgroup, 128 channels a "
                   "pass): A = c2 split in registers from a [32 input][128 "
                   "output channels] tile staged by cp.async as c2 stores "
                   "it, B = conv 1's output written by the producer, raw "
                   "and lo, K-major without swizzle in 288 lines, one tile "
                   "serving every shift by its descriptor's start; conv 1 "
                   "once per (row, channel) a pass from the staged, "
                   "zero-padded query rows; the epilogue's sums in a fixed "
                   "order", 3),
    "filter_rnn": ("three instances by (h, Q).  few (h = 32, 64, Q <= "
                   "FEW_MAX_Q): a block of 3h^2/32 threads a (filter, "
                   "query), all three h x 4h weights in registers (128 a "
                   "thread: two units' gates over 16 inputs), the slices "
                   "reduced by warp shuffles in a fixed tree; many (h = 32, "
                   "64, Q > FEW_MAX_Q): a block a (filter, 16 queries), the "
                   "weights in shared memory read once a step for all 16 "
                   "queries (a thread one unit's gates over 32 inputs), the "
                   "queries reduce-scattered over the slices; both run "
                   "layer 1's step t + 1 beside layer 2's step t, one "
                   "barrier a step; generic (any other h): a thread one "
                   "unit's 4 gates for 4 queries, the weights in shared "
                   "memory or through L2, 2 barriers a step; f32 FMA", None),
    "dtw": ("one thread a (query, series) pair, 128 threads a block of 1, "
            "2, 4 or 8 queries x 128 / that many series; for r = 2, 3, 4, 6, "
            "8 the band's frame and the series' window in registers, rows "
            "unrolled in blocks of 2r + 1 (the window's slots at "
            "compile-time indices), the queries in shared memory, each "
            "block of rows staging its next 2r + 1 columns through shared "
            "memory; any other band a resident grid, the frame in a "
            "scratch buffer", None),
}
#: the candidate pass's ``matmul`` form: its survivor pass runs on the
#: split-TF32 wgmma instance (3 passes: float32 accuracy on the tensor
#: cores), the bound its times are held against; the probe's warp instance
#: is SIMT float32, against the same passes for comparison
LEAF_TOPK_SPLIT_PASSES = 3
#: the redesigned kernels, whose ptxas report must show no spills
SPLIT_KERNELS = ("l2_tf32x3_kernel", "slab_tf32x3_kernel", "mlp_tile_kernel",
                 "mlp_stream_kernel", "box_lb_kernel", "replay_kernel",
                 "train_forward_kernel", "train_backward_sgd_kernel",
                 "leaf_topk_kernel", "leaf_topk_wgmma_kernel",
                 "tc_rounding_kernel", "early_walk_kernel",
                 "cnn_filter_kernel", "lstm_few_kernel",
                 "lstm_many_kernel", "lstm_generic_kernel",
                 "dtw_band_kernel", "dtw_any_band_kernel")
#: the kernels every build launches: training's two a step, ``filter_mlp``
#: for its validation passes
BUILD_KERNELS = ("train_forward", "train_backward_sgd", "filter_mlp")
#: the kernels each path launches
DSTREE_KERNELS = ("pairwise_l2", "slab_l2", "fused_filter_mlp", "box_lb",
                  "replay", "leaf_topk") + BUILD_KERNELS
ISAX_KERNELS = ("pairwise_l2", "slab_l2", "fused_filter_mlp",
                "fused_filter_mlp_bf16", "fused_filter_mlp_int8", "box_lb",
                "replay", "leaf_topk") + BUILD_KERNELS
#: the DTW phase's: both LB_Keogh bounds and the DP
DTW_KERNELS = ("box_lb", "dtw")
#: search_early's: the bounds, the predictions and the walk
SEARCH_KERNELS = ("box_lb", "fused_filter_mlp", "early_walk")
GROUPED_KERNELS = ("box_lb", "fused_filter_mlp", "replay", "leaf_topk")
SUITE_KERNELS = ("filter_mlp", "fused_filter_mlp", "fused_filter_mlp_bf16",
                 "fused_filter_mlp_int8")
#: the filter backbones of ``run_filter_types`` and their widths (the
#: reference's defaults at m = 256: channels = m, ksize 3; hidden 64)
FILTER_TYPES = {"cnn": {"channels": 256, "ksize": 3}, "rnn": {"hidden": 64}}
#: the eager candidate pass's device kernels (the gather of the survivor
#: slabs, the GEMV, the sort of each leaf's rows), which the kernel replaced
EAGER_PASS_KERNELS = ("vectorized_gather_kernel", "gemv", "radixSortKVInPlace")
#: ``_profile_bracketed``'s markers: ``torch.cuda._sleep``'s spin kernel,
#: ``MARKER_PAD`` short ones and one of about 1 ms at the H100's clocks
#: before the profiled work, and as many after it: the profiler can lose a
#: profile's first device events (on the card, 3 to about 35 of them late
#: in a run), so what it loses is markers.  The host's idle time at a
#: profile's edges, one entry a try: a profile whose first or last event
#: is not a marker is taken again with a longer wait
MARKER_KERNEL = "spin_kernel"
MARKER_CYCLES = 2_000_000
MARKER_PAD = 64
PROFILE_EDGES_S = (0.05, 0.5, 2.0)
PAYLOADS = ("float32", "bfloat16", "int8")
TARGETS = ("exact", "0.99", "0.95", "per-query")


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _counter_tables():
    from repro_torch.kernels.box_lb import kernel as box_kernel
    from repro_torch.kernels.dtw import kernel as dtw_kernel
    from repro_torch.kernels.early_walk import kernel as walk_kernel
    from repro_torch.kernels.filter_cnn import kernel as cnn_kernel
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    from repro_torch.kernels.filter_rnn import kernel as rnn_kernel
    from repro_torch.kernels.filter_train import kernel as train_kernel
    from repro_torch.kernels.l2_scan import kernel as l2_kernel
    from repro_torch.kernels.leaf_topk import kernel as leaf_kernel
    from repro_torch.kernels.replay import kernel as replay_kernel
    return (l2_kernel.LAUNCHES, mlp_kernel.LAUNCHES, box_kernel.LAUNCHES,
            replay_kernel.LAUNCHES, train_kernel.LAUNCHES,
            leaf_kernel.LAUNCHES, walk_kernel.LAUNCHES, cnn_kernel.LAUNCHES,
            rnn_kernel.LAUNCHES, dtw_kernel.LAUNCHES)


def _launch_counters():
    return {k: v for table in _counter_tables() for k, v in table.items()}


def _instance_launches() -> dict:
    """The candidate pass's launches by instance (``kernel.instance``)."""
    from repro_torch.kernels.leaf_topk import kernel as leaf_kernel
    return dict(leaf_kernel.INSTANCE_LAUNCHES)


def _replay_mode_launches() -> dict:
    """The replay's launches by instance (``kernel.mode``)."""
    from repro_torch.kernels.replay import kernel as replay_kernel
    return dict(replay_kernel.MODE_LAUNCHES)


def _zero_counters() -> None:
    from repro_torch.kernels.leaf_topk import kernel as leaf_kernel
    from repro_torch.kernels.replay import kernel as replay_kernel
    for table in _counter_tables() + (leaf_kernel.INSTANCE_LAUNCHES,
                                      replay_kernel.MODE_LAUNCHES):
        for name in table:
            table[name] = 0


def _call_size(name: str, args, out) -> int:
    """A call's size: output elements; for the replay, rows x positions x
    k (so a batch's k = 5 call outranks its k = 1 calls); for the candidate
    pass, list slots x kk (from shapes: no sync on the path, so of equal
    shapes the first, a k = 5 exact batch, is kept)."""
    if name.startswith("replay"):
        return args[2].numel() * args[5]
    if name.startswith("leaf_topk"):
        return args[4].numel() * args[6]
    return out.numel()


@contextlib.contextmanager
def capture_largest_inputs(captured: dict, bound: bool = False,
                           max_q: int | None = None):
    """Record, per kernel, the arguments of its largest call (by output
    elements) while the main path runs, and for the filter entries (the
    fused MLP's, the CNN's, the LSTM's) and ``box_lb`` also those of the
    call with the fewest queries (under ``<name>@min_q``); for ``box_lb`` also each distinct shape's calls
    (count and last arguments, under ``box_lb@shapes``); for the replay
    the largest call made by calibration apart (``replay@calibration``,
    the calls inside ``conformal.simulate_search``); for the candidate pass
    the probe's calls apart (``leaf_topk@probe``, rows by slot); for the
    early walk every call, in order (``early_walk@calls``).  A replay
    call with a trace (its traced instance) passes through unrecorded, and
    so does one with a bound (its bound instance) unless ``bound``: then
    the largest such call is kept as ``replay@bound``, (arguments,
    bound).  With ``max_q``, a call of more queries (rows of its queries
    argument) counts only among ``box_lb@shapes``.  The
    training kernels' calls all have one size per build; of the largest build's, the
    ``TRAIN_CAPTURE_CALL``-th is kept, with the parameters and velocities
    it was given cloned (later steps update them in place) and without the
    rows' low parts, which belong to their training alone (``None`` in
    their place: ``_with_lo`` makes them anew).  The wrappers themselves,
    and their launch counts, are unchanged."""
    from repro_torch.core import conformal
    from repro_torch.kernels.box_lb import kernel as box_kernel
    from repro_torch.kernels.dtw import kernel as dtw_kernel
    from repro_torch.kernels.early_walk import kernel as walk_kernel
    from repro_torch.kernels.filter_cnn import kernel as cnn_kernel
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    from repro_torch.kernels.filter_rnn import kernel as rnn_kernel
    from repro_torch.kernels.filter_train import kernel as train_kernel
    from repro_torch.kernels.l2_scan import kernel as l2_kernel
    from repro_torch.kernels.leaf_topk import kernel as leaf_kernel
    from repro_torch.kernels.replay import kernel as replay_kernel
    in_calibration = []
    targets = [(l2_kernel, "pairwise_l2_cuda", lambda a: "pairwise_l2"),
               (l2_kernel, "slab_l2_cuda", lambda a: "slab_l2"),
               (mlp_kernel, "fused_filter_mlp_cuda",
                lambda a: mlp_kernel.ENTRY[a[1].dtype]),
               (mlp_kernel, "filter_mlp_cuda", lambda a: "filter_mlp"),
               (box_kernel, "box_lb_cuda", lambda a: "box_lb"),
               (replay_kernel, "replay_cascade_cuda",
                lambda a: "replay@calibration" if in_calibration
                else "replay"),
               (leaf_kernel, "leaf_topk_cuda",
                lambda a: "leaf_topk" if a[11] else "leaf_topk@probe"),
               (walk_kernel, "early_walk_cuda", lambda a: "early_walk@calls"),
               (cnn_kernel, "cnn_filter_cuda", lambda a: "filter_cnn"),
               (rnn_kernel, "lstm_filter_cuda", lambda a: "filter_rnn"),
               (dtw_kernel, "dtw_cuda", lambda a: "dtw")]
    saved = [(conformal, "simulate_search", conformal.simulate_search)]

    def simulate_search(*args, _fn=conformal.simulate_search, **kw):
        in_calibration.append(True)
        try:
            return _fn(*args, **kw)
        finally:
            in_calibration.pop()
    conformal.simulate_search = simulate_search
    for mod, attr, naming in targets:
        fn = getattr(mod, attr)

        def wrapped(*args, _fn=fn, _naming=naming, **kw):
            out = _fn(*args, **kw)
            if kw.get("trace"):
                return out         # the replay's traced instance
            name = _naming(args)
            if name == "box_lb":
                shapes = captured.setdefault("box_lb@shapes", {})
                key = (args[0].shape[0], args[1].shape[0], args[0].shape[1])
                shapes[key] = (shapes.get(key, (0, None))[0] + 1, args)
            n_q = args[3 if name.startswith("leaf_topk") else 0].shape[0]
            if max_q is not None and n_q > max_q:
                return out
            if kw.get("bsf_ub") is not None:
                # the replay's bound instance
                size = _call_size("replay", args, out)
                if bound and size > captured.get("replay@bound", (0,))[0]:
                    captured["replay@bound"] = (size, (args, kw["bsf_ub"]))
                return out
            if name == "early_walk@calls":
                captured.setdefault(name, []).append(args)
                return out
            size = _call_size(name, args, out)
            if size > captured.get(name, (0, None))[0]:
                captured[name] = (size, args)
            if name.startswith("fused_filter_mlp") or name in (
                    "box_lb", "filter_cnn", "filter_rnn"):
                if n_q < captured.get(f"{name}@min_q", (math.inf, None))[0]:
                    captured[f"{name}@min_q"] = (n_q, args)
            return out
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    calls = {"train_forward": 0, "train_backward_sgd": 0}
    clones: dict = {}
    for name, n_state in (("train_forward", 4), ("train_backward_sgd", 8)):
        fn = getattr(train_kernel, f"{name}_cuda")

        def wrapped_train(*args, _fn=fn, _name=name, _n=n_state):
            calls[_name] += 1
            ig, il = args[6:8] if _name == "train_forward" else args[10:12]
            size = args[0].shape[0] * (ig.shape[0] + il.shape[0])
            if (calls[_name] == TRAIN_CAPTURE_CALL
                    and size > captured.get(_name, (0, None))[0]):
                if _name == "train_forward":
                    clones.clear()
                for a in args[:_n]:
                    if id(a) not in clones:
                        clones[id(a)] = a.clone()
                state = tuple(clones[id(a)] for a in args[:_n])
                captured[_name] = (size, state + tuple(args[_n:-2])
                                   + (None, None))
            return _fn(*args)
        saved.append((train_kernel, f"{name}_cuda", fn))
        setattr(train_kernel, f"{name}_cuda", wrapped_train)
    try:
        yield captured
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


#: the training kernels' call kept per build (a step with velocities)
TRAIN_CAPTURE_CALL = 10
#: the training kernels: their calls end with the rows' low parts
TRAIN_KERNELS = ("train_forward", "train_backward_sgd")


def _with_lo(args: tuple) -> tuple:
    """A training kernel's call with its last two arguments, the rows'
    low parts, made from its rows (``ref.x_lo``)."""
    from repro_torch.kernels.filter_train import ref as train_ref
    xg, xl = args[4:6] if len(args) == 15 else args[8:10]
    return tuple(args[:-2]) + (train_ref.x_lo(xg), train_ref.x_lo(xl))


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _recall(ids: np.ndarray, exact_ids: np.ndarray) -> float:
    k = ids.shape[1]
    hits = [len(set(a) & set(b)) for a, b in zip(ids.tolist(),
                                                 exact_ids.tolist())]
    return float(np.mean(hits)) / k


def _brute_force_check(lfi, queries: np.ndarray, exact_results,
                       n_brute: int, label: str) -> None:
    """Exact search (each result's k) equals a brute-force scan over the
    pairwise kernel for the first ``n_brute`` queries."""
    import torch
    from repro_torch.kernels.l2_scan import ops as l2_ops
    idx = lfi.index
    ks = sorted({ex.dists.shape[1] for ex in exact_results})
    qb = torch.as_tensor(queries[:n_brute], device=idx.device)
    d = l2_ops.pairwise_l2(qb, idx.series[: idx.n_series])
    bd, brow = torch.sort(d, dim=1, stable=True)
    bd, brow = bd[:, :ks[-1]].cpu().numpy(), brow[:, :ks[-1]].cpu().numpy()
    bids = idx.order.cpu().numpy()[brow]
    for ex in exact_results:
        k = ex.dists.shape[1]
        np.testing.assert_allclose(ex.dists[:n_brute], bd[:, :k], rtol=1e-4,
                                   atol=1e-3)
        assert (np.sort(ex.ids[:n_brute], 1)
                == np.sort(bids[:, :k], 1)).all(), \
            f"{label}exact search disagrees with brute force"
    log(f"{label}exact search == brute force on {n_brute} queries "
        f"(k={'/'.join(map(str, ks))}, {len(exact_results)} exact run(s))")


def _check_launches(launches: dict, by_instance: dict, expected,
                    label: str, on_card: bool) -> None:
    """Print the path's launch counts, in all and the candidate pass's by
    instance, both read together right after the path's run; on the card,
    every kernel of the path must have launched."""
    log(f"launches on the {label} path: " + json.dumps(launches))
    missing = [k for k in expected if launches.get(k, 0) <= 0]
    if "leaf_topk" in expected:         # the survivor passes' instance
        log(f"  leaf_topk launches by instance on the {label} path: "
            + json.dumps(by_instance))
        assert sum(by_instance.values()) == launches["leaf_topk"], \
            (by_instance, launches["leaf_topk"])
        if by_instance["wgmma"] <= 0:
            missing.append("leaf_topk (the wgmma instance)")
    assert not (on_card and missing), \
        f"kernels never launched on the {label} path: {missing}"


def _training_counts(lfi) -> tuple:
    """(steps, validation passes) of the index's filter training."""
    cfg = lfi.config
    n_cal = max(int(cfg.n_global * cfg.calib_fraction), 8)
    n_steps = cfg.train.epochs * max(
        (cfg.n_global - n_cal + cfg.n_local) // cfg.train.batch, 1)
    return n_steps, len(range(0, n_steps, max(n_steps // 20, 1)))


def _check_build_launches(launches: dict, lfi, label: str,
                          on_card: bool) -> None:
    """On the card, every training step of the build ran both training
    kernels (the backward one once per row tile: once at the default batch)
    and every validation pass ``filter_mlp`` once: no step took the plain
    (autograd) version."""
    from repro_torch.kernels.filter_train import ref as train_ref
    n_steps, n_val = _training_counts(lfi)
    batch = lfi.config.train.batch
    tiles = train_ref.row_tiles(batch, max(batch // 4, 1))
    want = {"train_forward": n_steps, "train_backward_sgd": n_steps * tiles,
            "filter_mlp": n_val}
    got = {k: launches.get(k, 0) for k in want}
    log(f"{label}training: {n_steps} steps, {n_val} validation passes; "
        f"launches {json.dumps(got)}")
    assert not on_card or got == want, \
        f"{label}training launches {got}, expected {want}"


def _host_marks(device) -> tuple:
    """(device memory segments the caching allocator has taken from the
    driver so far, the host's garbage collections so far): two costs a
    batch's wall can pay besides its work."""
    import gc
    import torch
    segs = (torch.cuda.memory_stats().get("segment.all.allocated", 0)
            if torch.device(device).type == "cuda" else 0)
    return segs, sum(g["collections"] for g in gc.get_stats())


def _search_line(prefix: str, r, exact, wall: float, n_queries: int) -> str:
    return (f"{prefix}: pruning={r.pruning_ratio.mean():.4f} "
            f"searched={r.searched.mean():.1f}/{r.n_leaves} "
            f"pruned_lb={r.pruned_lb.mean():.1f} "
            f"pruned_filter={r.pruned_filter.mean():.1f} "
            f"computed={r.computed.mean():.1f} "
            f"recall={_recall(r.ids, exact.ids):.4f} "
            f"wall={wall * 1e3:.1f} ms/batch "
            f"({n_queries / wall:.1f} queries/s)")


def _tail_probability(n: int, misses: int, target: float) -> float:
    """P(at least ``misses`` of ``n`` queries miss) if each query finds its
    nearest neighbour with probability ``target``."""
    p = 1.0 - target
    return sum(math.comb(n, i) * p ** i * (1 - p) ** (n - i)
               for i in range(misses, n + 1))


def _calib_recall_line(label: str, lfi, device, target: float = 0.99
                       ) -> float:
    """recall@1 at ``target`` on the index's own calibration split (the
    queries its tuners were fit on), and the quality knots either side."""
    q = lfi.calib.queries.cpu().numpy()
    exact = lfi.search_exact(q, device=device).dists[:, 0]
    got = lfi.search(q, quality_target=target, device=device).dists[:, 0]
    hit = got <= exact * (1 + 1e-5) + 1e-6
    misses = int((~hit).sum())
    knots = lfi.tuner.knots_q
    i = int(np.searchsorted(knots, target, side="right"))
    below = f"{knots[i - 1]:.6f}" if i > 0 else "none"
    above = f"{knots[i]:.6f}" if i < len(knots) else "none"
    log(f"{label}calibration split at target {target}: recall@1 "
        f"{hit.mean():.4f} ({misses} of {len(hit)} missed, P(>= that | "
        f"{target}) = {_tail_probability(len(hit), misses, target):.3f}); "
        f"{len(knots)} quality knots, {below} .. {above} around {target}")
    return float(hit.mean())


def _phase_memory(label: str) -> None:
    """Starts a phase's peak memory reading: logs what earlier phases
    still hold on the card (the captured calls' tensors among it), which
    the phase's peak includes, and resets the peak."""
    import torch
    log(f"{label}device memory held at the phase's start: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()


def _build_lines(label: str, lfi, t_build: float, on_card: bool) -> None:
    import torch
    rep = lfi.build_report
    log(f"{label}build: {t_build:.2f} s; " + ", ".join(
        f"{k}={v:.4g}" for k, v in rep.items()))
    log(f"{label}index: L={lfi.index.n_leaves} leaves, "
        f"F={len(lfi.leaf_ids)} filters, max leaf {lfi.index.max_leaf_size}")
    if on_card:
        log(f"{label}peak device memory after build: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


#: the build's spans (``repro_torch.obs.spans``) in the order they close,
#: each with its parent span (depth 1) or None (depth 0), its args and the
#: ``build_report`` time its duration must match
BUILD_SPANS = {
    "build.index": (None, ("backbone",), "t_index_build"),
    "collect.global": ("build.collect", ("n_global",), None),
    "collect.local": ("build.collect", ("n_filters", "n_local"), None),
    "build.collect": (None, ("n_filters", "n_global", "n_local"),
                      "t_collect"),
    "train.sgd": ("build.train", ("epochs", "n_filters"), None),
    "build.train": (None, ("n_filters",), "t_train"),
    "build.calibrate": (None, ("n_cal",), "t_calibrate"),
}
#: a ``build.*`` span's duration against its ``build_report`` time: within
#: this share of it, or this many seconds
SPAN_REL, SPAN_ABS_S = 0.02, 0.010
#: the device kernels of the wrappers the profiled build's spans enclose
SPAN_KERNELS = {
    "build.collect": {"pairwise_l2": ("l2_tf32x3_kernel",),
                      "slab_l2": ("slab_tf32x3_kernel",),
                      "box_lb": ("box_lb_kernel", "box_lb_any_d_kernel")},
    "train.sgd": {"train_forward": ("train_forward_kernel",),
                  "train_backward_sgd": ("train_backward_sgd_kernel",)},
}


def _span_args(lfi) -> dict:
    """The args each build span must carry, from the built index."""
    cfg = lfi.config
    want = {"backbone": cfg.backbone, "n_filters": len(lfi.leaf_ids),
            "n_global": cfg.n_global, "n_local": cfg.n_local,
            "epochs": cfg.train.epochs, "n_cal": len(lfi.calib.queries)}
    return {name: {a: want[a] for a in args}
            for name, (_, args, _) in BUILD_SPANS.items()}


def check_build_spans(spans: list, lfi, label: str,
                      trace_dir: str | None = None) -> dict:
    """A build's recorded spans: the seven names in closing order, each of
    category ``build`` on lane 0, ``collect.*`` at depth 1 inside
    ``build.collect`` and ``train.sgd`` inside ``build.train``, the rest at
    depth 0, with the reference's args (Python ints and strings); each
    ``build.*`` span's duration within ``SPAN_REL`` or ``SPAN_ABS_S`` of
    its ``build_report`` time.  Prints the span table, writes the spans as
    a Chrome trace (``export.write_chrome_trace``: under ``trace_dir``, or
    a temporary directory) and asserts that ``json.load`` reads it back
    equal.  Returns the durations by name (s)."""
    import tempfile
    from repro_torch.obs import export
    names = [s.name for s in spans]
    assert names == list(BUILD_SPANS), f"{label}build spans {names}"
    by = {s.name: s for s in spans}
    args = _span_args(lfi)
    rows = []
    for s in spans:
        parent, _, key = BUILD_SPANS[s.name]
        assert s.cat == "build" and s.lane == 0, (label, s)
        assert s.depth == (parent is not None), (label, s)
        assert s.args == args[s.name] and all(
            type(v) in (int, str) for v in s.args.values()), (label, s)
        if parent is not None:
            p = by[parent]
            assert p.t0 <= s.t0 and s.t0 + s.dur <= p.t0 + p.dur, \
                f"{label}{s.name} is not inside {parent}"
        row = (f"  {s.name:16s} depth {s.depth} lane {s.lane} "
               f"{s.dur * 1e3:10.3f} ms {json.dumps(s.args)}")
        if key is not None:
            t = lfi.build_report[key]
            assert abs(s.dur - t) <= max(SPAN_REL * t, SPAN_ABS_S), \
                f"{label}{s.name} {s.dur!r} s against {key} {t!r} s"
            row += f"  ({key} {t * 1e3:.3f} ms)"
        rows.append(row)
    log(f"{label}build spans (name, depth, lane, duration, args):\n"
        + "\n".join(rows))
    tag = label.strip().replace(" ", "_").replace("=", "") or "dstree"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(trace_dir or tmp, f"build_spans_{tag}.json")
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
        trace = export.write_chrome_trace(path, spans=spans)
        with open(path) as fh:
            assert json.load(fh) == trace, f"{label}Chrome trace round trip"
    log(f"{label}build spans as a Chrome trace: {len(trace['traceEvents'])} "
        f"events, read back equal" + (f" ({path})" if trace_dir else ""))
    return {s.name: s.dur for s in spans}


def _build(series: np.ndarray, cfg, device: str, label: str,
           on_card: bool):
    """``build_leafi`` under ``obs.recording()``: prints the build's lines
    and checks its spans (``check_build_spans``; on the card the Chrome
    trace stays under ``chiprun_out/``).  Returns the index and the
    build's wall (s)."""
    from repro_torch import obs
    from repro_torch.core import build
    t0 = time.perf_counter()
    with obs.recording() as rec:
        lfi = build.build_leafi(series, cfg, device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    _build_lines(label, lfi, wall, on_card)
    check_build_spans(rec.drain(), lfi, label or "dstree ",
                      os.path.join(ROOT, "chiprun_out") if on_card else None)
    return lfi, wall


def _annotated_kernels(trace: dict, names) -> dict:
    """From a ``torch.profiler`` Chrome trace: for each span name, its
    ``user_annotation`` events and the device kernels (by short name:
    launches) whose launching runtime or driver call, matched by
    correlation id, lies inside one of them on the same thread."""
    events = trace["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e.get("name") in names]
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "correlation" in e.get("args", {})}
    out = {n: {"annotations": 0, "kernels": {}} for n in names}
    for a in ann:
        out[a["name"]]["annotations"] += 1
    for k in events:
        if k.get("cat") != "kernel":
            continue
        call = calls.get(k.get("args", {}).get("correlation"))
        if call is None:
            continue
        for a in ann:
            if (a["pid"], a["tid"]) == (call["pid"], call["tid"]) and \
                    a["ts"] <= call["ts"] and \
                    call["ts"] + call.get("dur", 0) <= a["ts"] + a["dur"]:
                kern = out[a["name"]]["kernels"]
                short = _kernel_name(k["name"])
                kern[short] = kern.get(short, 0) + 1
    return out


def profile_build(series: np.ndarray, cfg, t_unprofiled: float, *,
                  device: str = "cuda", label: str = "") -> dict:
    """One build under ``torch.profiler`` (CPU and, on the card, CUDA
    activities) and ``obs.recording()``: its spans checked as every
    build's (``check_build_spans``), every span a ``user_annotation`` in
    the profiler's Chrome trace, and (on the card) the device kernels
    launched inside ``build.collect`` including ``pairwise_l2``,
    ``slab_l2`` and ``box_lb`` launches, those inside ``train.sgd``
    ``train_forward`` and ``train_backward_sgd`` (``SPAN_KERNELS``).
    Prints the profiled build's wall beside ``t_unprofiled``."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.core import build
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with obs.recording() as rec, profile(activities=acts) as prof:
        t0 = time.perf_counter()
        lfi = build.build_leafi(series, cfg, device=device)
        _sync(device)
        wall = time.perf_counter() - t0
    spans = check_build_spans(rec.drain(), lfi, f"{label}profiled ")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
    found = _annotated_kernels(trace, tuple(BUILD_SPANS))
    t_export = time.perf_counter() - t0
    for name, got in found.items():
        assert got["annotations"] == 1, \
            f"{label}profiled build: {name} is not one user_annotation"
    log(f"{label}profiled build: wall {wall:.3f} s under torch.profiler "
        f"against {t_unprofiled:.3f} s unprofiled; "
        f"{len(trace['traceEvents'])} trace events, exported and read in "
        f"{t_export:.2f} s; every span one user_annotation; "
        "device kernels launched inside each span: " + json.dumps(
            {n: g["kernels"] for n, g in found.items()}))
    if on_card:
        for name, wrappers in SPAN_KERNELS.items():
            got = found[name]["kernels"]
            for wrapper, kernels in wrappers.items():
                assert any(got.get(k, 0) > 0 for k in kernels), \
                    f"{label}profiled build: no {wrapper} launch in {name}"
    return {"wall_s": wall, "spans_s": spans,
            "kernels": {n: g["kernels"] for n, g in found.items()}}


def _query_setup(series: np.ndarray, n_queries: int):
    from repro_torch.data.series import make_query_set
    queries = make_query_set(series, n_queries, noise=0.2, seed=42)
    per_query = np.random.default_rng(1).choice([0.9, 0.95, 0.99], n_queries)
    return queries, dict(zip(TARGETS, (None, 0.99, 0.95, per_query)))


def make_series(n: int = 1_000_000, m: int = 256) -> np.ndarray:
    from repro_torch.data.series import randwalk
    t0 = time.perf_counter()
    series = randwalk(n, m, seed=0)
    log(f"data: RandWalk {n} x {m} ({series.nbytes / 1e9:.3f} GB) in "
        f"{time.perf_counter() - t0:.2f} s")
    return series


def run_end_to_end(*, n: int = 1_000_000, m: int = 256,
                   n_queries: int = 256, n_brute: int = 64,
                   leaf_capacity: int = 256, n_global: int = 600,
                   n_local: int = 200, epochs: int = 300,
                   device: str = "cuda", captured: dict | None = None,
                   series: np.ndarray | None = None) -> dict:
    """Build a DSTree index and answer query batches through the port's
    entry points; asserts exact == brute force and (on the card) that every
    kernel of the path launched.  Returns the launch counts and results."""
    import torch
    from repro_torch.core import build, filter_training

    series = make_series(n, m) if series is None else series
    cfg = build.LeaFiConfig(
        backbone="dstree", leaf_capacity=leaf_capacity,
        t_filter_over_t_series=20.0, n_global=n_global, n_local=n_local,
        train=filter_training.TrainConfig(epochs=epochs))
    queries, targets = _query_setup(series, n_queries)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        _phase_memory("")
    captured = {} if captured is None else captured
    _zero_counters()
    with capture_largest_inputs(captured):
        lfi, _ = _build(series, cfg, device, "", on_card)

        results, marks = {}, {}
        t0 = time.perf_counter()
        lfi.search(queries, k=1, quality_target=None, device=device)  # warm
        _sync(device)
        warm = time.perf_counter() - t0
        for impl in (None, "pairwise"):
            for k in (1, 5):
                for name, target in targets.items():
                    _sync(device)
                    before = _host_marks(device)
                    t0 = time.perf_counter()
                    r = lfi.search(queries, k=k, quality_target=target,
                                   device=device, dist_impl=impl)
                    _sync(device)
                    wall = time.perf_counter() - t0
                    results[(impl or "default", k, name)] = (r, wall)
                    marks[(impl or "default", k, name)] = tuple(
                        b - a for a, b in zip(before, _host_marks(device)))
    launches, by_instance = _launch_counters(), _instance_launches()
    log(f"the warm-up batch (default, k=1, exact) {warm * 1e3:.1f} ms; new "
        "allocator segments (cudaMalloc) and garbage collections in each "
        "timed batch: " + ", ".join(
            f"{impl} k={k} {name} +{seg}/+{gcs}"
            for (impl, k, name), (seg, gcs) in marks.items()))

    for (impl, k, name), (r, wall) in results.items():
        exact = results[(impl, k, "exact")][0]
        assert r.dists.shape == (n_queries, k), r.dists.shape
        assert np.isfinite(r.dists).all(), f"non-finite dists {impl} {k}"
        log(_search_line(f"search impl={impl:8s} k={k} target={name:9s}", r,
                         exact, wall, n_queries))
    _calib_recall_line("dstree ", lfi, device)

    _brute_force_check(lfi, queries, [results[(impl, 5, "exact")][0]
                                      for impl in ("default", "pairwise")],
                       n_brute, "")
    _check_launches(launches, by_instance, DSTREE_KERNELS, "DSTree",
                    on_card)
    _check_build_launches(launches, lfi, "dstree ", on_card)
    return {"launches": launches, "results": results, "lfi": lfi,
            "queries": queries, "targets": targets}


def run_wide_dstree(*, n: int = 100_000, m: int = 256, n_segments: int = 64,
                    n_queries: int = 64, epochs: int = 300,
                    device: str = "cuda", captured: dict | None = None
                    ) -> dict:
    """A DSTree build whose bounds are wider than the box kernel's register
    instances: ``n_segments`` EAPCA segments, so d = 2 x ``n_segments``
    (128) box dimensions, on RandWalk ``n`` x ``m`` (numpy seed 0);
    ``n_queries`` queries exact and at 0.99, k = 5.  Asserts exact ==
    brute force and (on the card) that the search kernels launched.  Then
    the same build again under ``torch.profiler`` (``profile_build``),
    after the launches are read."""
    import torch
    from repro_torch.core import build, filter_training
    series = make_series(n, m)
    cfg = build.LeaFiConfig(backbone="dstree", n_segments=n_segments,
                            leaf_capacity=256, t_filter_over_t_series=20.0,
                            train=filter_training.TrainConfig(epochs=epochs))
    queries, _ = _query_setup(series, n_queries)
    on_card = torch.device(device).type == "cuda"
    captured = {} if captured is None else captured
    _zero_counters()
    label = f"dstree d={2 * n_segments} "
    with capture_largest_inputs(captured):
        lfi, t_build = _build(series, cfg, device, label, on_card)
        results = {}
        for name, target in (("exact", None), ("0.99", 0.99)):
            _sync(device)
            t0 = time.perf_counter()
            r = lfi.search(queries, k=5, quality_target=target,
                           device=device)
            _sync(device)
            results[name] = (r, time.perf_counter() - t0)
    launches, by_instance = _launch_counters(), _instance_launches()
    for name, (r, wall) in results.items():
        assert np.isfinite(r.dists).all(), f"non-finite dists {name}"
        log(_search_line(f"dstree d={2 * n_segments} k=5 target={name:5s}",
                         r, results["exact"][0], wall, n_queries))
    _brute_force_check(lfi, queries, [results["exact"][0]], n_queries,
                       f"dstree d={2 * n_segments} ")
    _check_launches(launches, by_instance,
                    ("box_lb", "fused_filter_mlp", "replay", "leaf_topk")
                    + BUILD_KERNELS,
                    f"DSTree d={2 * n_segments}", on_card)
    _check_build_launches(launches, lfi, f"dstree d={2 * n_segments} ",
                          on_card)
    _scan_trace_audit(lfi, queries, device, f"dstree d={2 * n_segments} ")
    profiled = profile_build(series, cfg, t_build, device=device,
                             label=label)
    return {"launches": launches, "profiled_build": profiled}


def _scan_trace_audit(lfi, queries: np.ndarray, device: str,
                      label: str) -> None:
    """The scan strategy (a loop over the L positions, every leaf scored)
    with trace and audit, k = 5, exact and at 0.99: bitwise the untraced
    scan's answers and counters, both accounting residuals zero, the
    survivors the searched leaves, no probe and no seed prune."""
    for name, target in (("exact", None), ("0.99", 0.99)):
        kw = dict(k=5, quality_target=target, device=device,
                  strategy="scan")
        t0 = time.perf_counter()
        plain = lfi.search(queries, **kw)
        t1 = time.perf_counter()
        traced = lfi.search(queries, trace=True, audit=True, **kw)
        t2 = time.perf_counter()
        tag = f"{label}scan k=5 {name}"
        assert _same_answers(plain, traced), f"{tag}: the trace changed it"
        sums = _check_trace_audit(traced, lfi.index.n_leaves, tag)
        assert (traced.trace["survivors"] == traced.searched).all(), tag
        assert sums["probed"] == 0 and sums["pruned_seed"] == 0, sums
        log(f"{tag} with trace and audit: trace sums {json.dumps(sums)}; "
            f"scan {(t1 - t0) * 1e3:.0f} ms untraced, "
            f"{(t2 - t1) * 1e3:.0f} ms traced and audited")


def _stack_results(rs, n_leaves: int):
    """One SearchResult from single-query ones, in order."""
    from repro_torch.core import search
    cat = {name: np.concatenate([getattr(r, name) for r in rs])
           for name in ("dists", "ids", "searched", "pruned_lb",
                        "pruned_filter")}
    return search.SearchResult(n_leaves=n_leaves, **cat)


def run_early(lfi, queries: np.ndarray, batched: dict, *, n_early: int = 32,
              device: str = "cuda", captured: dict | None = None,
              label: str = "") -> dict:
    """``search_early`` for the first ``n_early`` queries, k = 1 and 5,
    exact (filters off) and at target 0.99, beside the batched path's
    figures for the same queries (``batched``: ``run_end_to_end``'s
    results, keyed (``"default"``, k, target)); asserts exact == brute
    force and (on the card) that the lower-bound, fused filter and walk
    kernels launched, the walk once a call, and holds every walk launch
    bitwise against the plain walk on its own arguments.  The largest k =
    5 exact call is kept in ``captured`` (``early_walk``, or
    ``early_walk@isax`` under an ``isax`` label) for the kernel checks."""
    import torch
    from repro_torch.core import search
    idx = lfi.index
    n_batch = len(queries)
    kw = dict(filter_params=lfi.filter_params, leaf_ids=lfi.leaf_ids,
              tuner=lfi.tuner, device=device)
    on_card = torch.device(device).type == "cuda"
    for target in (None, 0.99):                                     # warm
        search.search_early(idx, queries[0], quality_target=target,
                            use_filters=target is not None, **kw)
    results = {}
    captured = {} if captured is None else captured
    captured.pop("early_walk@calls", None)
    _zero_counters()
    with capture_largest_inputs(captured):
        for k in (1, 5):
            for name, target in (("exact", None), ("0.99", 0.99)):
                rs, walls = [], []
                for i in range(n_early):
                    _sync(device)
                    t0 = time.perf_counter()
                    rs.append(search.search_early(
                        idx, queries[i], k=k, quality_target=target,
                        use_filters=target is not None, **kw))
                    _sync(device)
                    walls.append(time.perf_counter() - t0)
                results[(k, name)] = (_stack_results(rs, idx.n_leaves),
                                      np.asarray(walls))
    launches, by_instance = _launch_counters(), _instance_launches()
    calls = captured.pop("early_walk@calls", [])

    for (k, name), (r, walls) in results.items():
        exact = results[(k, "exact")][0]
        b, b_wall = batched[("default", k, name)]
        b_exact = batched[("default", k, "exact")][0]
        assert r.dists.shape == (n_early, k), r.dists.shape
        assert np.isfinite(r.dists).all(), f"non-finite dists k={k} {name}"
        log(f"{label}search_early k={k} target={name:5s}: per query wall "
            f"median {np.median(walls) * 1e3:.2f} ms, p90 "
            f"{np.percentile(walls, 90) * 1e3:.2f} ms; searched="
            f"{r.searched.mean():.1f}/{r.n_leaves} pruned_lb="
            f"{r.pruned_lb.mean():.1f} pruned_filter="
            f"{r.pruned_filter.mean():.1f} pruning="
            f"{r.pruning_ratio.mean():.4f} recall={_recall(r.ids, exact.ids):.4f}"
            f" | batched, same {n_early} queries: per-query share "
            f"{b_wall / n_batch * 1e3:.2f} ms of a {n_batch}-query batch, "
            f"searched={b.searched[:n_early].mean():.1f} pruning="
            f"{b.pruning_ratio[:n_early].mean():.4f} recall="
            f"{_recall(b.ids[:n_early], b_exact.ids[:n_early]):.4f}")
    _brute_force_check(lfi, queries, [results[(k, "exact")][0]
                                      for k in (1, 5)],
                       n_early, f"{label}search_early ")
    _check_launches(launches, by_instance, SEARCH_KERNELS,
                    f"{label}search_early", on_card)
    if on_card:
        assert launches["early_walk"] == len(results) * n_early == \
            len(calls), (launches["early_walk"], len(calls))
        t0 = time.perf_counter()
        for call in calls:
            _hold_early(call, "", quiet=True)
        log(f"{label}search_early: early_walk bitwise equal to the plain "
            f"walk on all {len(calls)} calls of the path (top-k values, ids "
            f"and the three counters; {time.perf_counter() - t0:.1f} s), "
            f"one launch a call")
        # the largest k = 5 exact call, by the leaves it searched
        exact5 = results[(5, "exact")][0].searched
        first = list(results).index((5, "exact")) * n_early
        i = int(np.argmax(exact5))
        key = "early_walk@isax" if label.startswith("isax") else "early_walk"
        captured[key] = (int(exact5[i]), calls[first + i])
    return {"launches": launches, "results": results}


#: search_early's steps, as ``early_breakdown`` times them
EARLY_STEPS = ("query to the card", "bounds", "offsets (host spline)",
               "predictions", "argsort", "walk", "ids and the copy")


def early_breakdown(lfi, queries: np.ndarray, *, k: int = 5,
                    n_early: int = 32, device: str = "cuda") -> dict:
    """Where a ``search_early`` call's time goes, exact and at target 0.99:
    its steps as ``search.search_early`` takes them, each ended by a
    synchronize (host clock), medians over the first ``n_early`` queries,
    beside the median of the whole call (no synchronize inside) on the
    same queries.  A sum above the whole call is the synchronizes' cost;
    every step's result is asserted equal to the call's."""
    import torch
    from repro_torch.core import bounds, search
    from repro_torch.kernels.early_walk import kernel as walk_kernel
    from repro_torch.kernels.early_walk import ref as walk_ref
    idx = lfi.index
    dev = idx.device
    out = {}
    for name, target in (("exact", None), ("0.99", 0.99)):
        steps = {s: [] for s in EARLY_STEPS}
        whole = []
        for i in range(n_early):
            marks = [time.perf_counter()]

            def mark():
                _sync(device)
                marks.append(time.perf_counter())
            q = torch.as_tensor(np.asarray(queries[i], np.float32),
                                device=dev).reshape(1, -1)
            mark()
            d_lb = bounds.lower_bounds(idx, q)
            mark()
            off = None if target is None else lfi.tuner.offsets(target)
            mark()
            d_F = (torch.full(d_lb.shape, -math.inf, device=dev)
                   if target is None else search.predictions_for_all_leaves(
                       idx, lfi.filter_params, lfi.leaf_ids, q, off))
            mark()
            lb_row, dF_row = d_lb[0].contiguous(), d_F[0].contiguous()
            order = torch.argsort(lb_row, stable=True)
            mark()
            args = (idx.series, idx.leaf_start, idx.leaf_size, q[0], lb_row,
                    dF_row, order, k)
            walk = (walk_ref.early_walk(*args) if dev.type == "cpu" else
                    walk_kernel.early_walk_cuda(*args, idx.max_leaf_size))
            mark()
            ids = torch.where(walk[1] >= 0, idx.order[walk[1].clamp(
                0, idx.n_series - 1)], -1).cpu().numpy()
            mark()
            for s, a, b in zip(EARLY_STEPS, marks, marks[1:]):
                steps[s].append(b - a)
            _sync(device)
            t0 = time.perf_counter()
            r = search.search_early(
                idx, queries[i], k=k, quality_target=target,
                use_filters=target is not None,
                filter_params=lfi.filter_params, leaf_ids=lfi.leaf_ids,
                tuner=lfi.tuner, device=device)
            _sync(device)
            whole.append(time.perf_counter() - t0)
            assert np.array_equal(r.ids[0], ids), (r.ids, ids)
        med = {s: float(np.median(v)) * 1e3 for s, v in steps.items()}
        med["sum"] = sum(med.values())
        med["whole call"] = float(np.median(whole)) * 1e3
        out[name] = med
        log(f"search_early breakdown k={k} target={name} (ms, medians over "
            f"{n_early} queries, each step ended by a synchronize): "
            + ", ".join(f"{s} {v:.3f}" for s, v in med.items()))
    return out


def _sim_matrices(lfi, queries: np.ndarray, target: float | None):
    """(d_lb, d_L, d_F) of ``queries`` on the port's kernels, copied to the
    host: the bounds (``box_lb``), the node-wise nearest distances (the
    pairwise kernel) and the predictions (the fused filter kernel) less
    the tuner's offsets at ``target`` (``None``: no d_F)."""
    import torch
    from repro_torch.core import bounds, conformal, filter_training, search
    idx = lfi.index
    q = torch.as_tensor(np.asarray(queries, np.float32), device=idx.device)
    d_lb = bounds.lower_bounds(idx, q).cpu().numpy()
    d_L = filter_training.nodewise_nn_distances(idx, q).cpu().numpy()
    if target is None:
        return d_lb, d_L, None
    if lfi.tuner is None or len(lfi.leaf_ids) == 0:
        return d_lb, d_L, np.full_like(d_lb, -np.inf)
    pred = search.predictions_for_all_leaves(
        idx, lfi.filter_params, lfi.leaf_ids, q, None).cpu().numpy()
    off = conformal.scatter_offsets(lfi.tuner, lfi.leaf_ids, idx.n_leaves,
                                    target)
    return d_lb, d_L, pred - off[None, :]


def run_simulators(lfi, series: np.ndarray, queries: np.ndarray, *,
                   n_sim: int = 64, n_val: int = 64, target: float = 0.99,
                   device: str = "cuda") -> dict:
    """The paper's comparison methods (``repro_torch.core.baselines``) on
    the port's own matrices for the index's first ``n_sim`` queries,
    tuned on ``n_val`` validation queries (``make_query_set`` at noise 0.25,
    seed 999, as the reference's ``benchmarks/common.py:98-103``, which
    takes 120) as ``benchmarks/paper_tables.py:57-72`` tunes them: each
    one's recall, mean searched leaves and pruning, beside
    ``search_early``'s searched leaves for the same queries at k = 1,
    ``target``.  Asserts that exact and LR recall 1 and that LeaFi with the
    oracle filter (d_F = d_L) searches no more leaves than exact, query by
    query, with the same final bsf."""
    from repro_torch.core import baselines, search
    from repro_torch.data.series import make_query_set
    t0 = time.perf_counter()
    queries = np.asarray(queries[:n_sim], np.float32)
    d_lb, d_L, d_F = _sim_matrices(lfi, queries, target)
    vq = make_query_set(series, n_val, 0.25, seed=999)
    val_d_lb, val_d_L, _ = _sim_matrices(lfi, vq, None)
    t_mat = time.perf_counter() - t0
    log(f"simulators: {len(queries)} queries x {d_lb.shape[1]} leaves; "
        f"{n_val} validation queries (the reference's benchmarks take 120; "
        f"cut to keep the phase short); matrices made in "
        f"{t_mat:.2f} s on {lfi.index.device}")
    eps = baselines.tune_epsilon(val_d_lb, val_d_L, target)
    de_thr = baselines.tune_delta(val_d_lb, val_d_L, target)
    pros = baselines.train_pros(val_d_lb, val_d_L)
    lt = baselines.train_lt(val_d_lb, val_d_L, target)
    variants = {
        "exact": lambda: baselines.exact_search(d_lb, d_L),
        "leafi": lambda: baselines.leafi_search(d_lb, d_L, d_F),
        "eps": lambda: baselines.epsilon_search(d_lb, d_L, eps),
        "deps": lambda: baselines.delta_epsilon_search(d_lb, d_L, de_thr),
        "pros": lambda: baselines.pros_search(d_lb, d_L, pros),
        "lt": lambda: baselines.lt_search(d_lb, d_L, lt),
        "lr": lambda: baselines.lr_optimal_search(d_lb, d_L),
    }
    res = {name: fn() for name, fn in variants.items()}
    kw = dict(filter_params=lfi.filter_params, leaf_ids=lfi.leaf_ids,
              tuner=lfi.tuner, device=device)
    walked = np.concatenate([search.search_early(
        lfi.index, q, k=1, quality_target=target, **kw).searched
        for q in queries])
    out = {}
    for name, r in res.items():
        out[name] = r.summary()
        log(f"simulator {name:5s} (target {target}): recall="
            f"{out[name]['recall']:.4f} searched={out[name]['searched']:.1f}"
            f"/{r.n_leaves} pruning={out[name]['pruning_ratio']:.4f}")
    log(f"simulators: tuned eps={eps:g}, delta-eps threshold={de_thr:.4f}, "
        f"LT multiplier={lt.multiplier:g}; search_early at k=1, target "
        f"{target} on the same queries: searched={walked.mean():.1f} (the "
        f"leafi simulator {out['leafi']['searched']:.1f}; printed only: the "
        "walk's distances and the pairwise kernel's differ in the last "
        "ulps)")
    oracle = baselines.leafi_search(d_lb, d_L, d_F=d_L)
    assert res["exact"].recall.mean() == 1.0, out["exact"]
    assert res["lr"].recall.mean() == 1.0, out["lr"]
    assert (oracle.searched <= res["exact"].searched).all()
    assert np.array_equal(oracle.bsf, res["exact"].bsf)
    wall = time.perf_counter() - t0
    log(f"simulators: exact and LR recall 1; the oracle filter searches "
        f"{oracle.searched.mean():.1f} leaves a query against exact's "
        f"{res['exact'].searched.mean():.1f}, no query more, the same final "
        f"bsf; phase wall {wall:.1f} s")
    return {"summary": out, "walk_searched": float(walked.mean()),
            "wall_s": wall}


#: the DTW phase's queries and band (the reference's default)
DTW_QUERIES, DTW_BAND = 8, 8
#: the reference tests' margin on the LB_Keogh and Euclidean invariants
DTW_MARGIN = 1e-4


def run_dtw(lfi, queries: np.ndarray, *, n_queries: int = DTW_QUERIES,
            band: int = DTW_BAND, chunk: int = 1 << 15, device: str = "cuda",
            captured: dict | None = None) -> dict:
    """DTW (``repro_torch.core.dtw``) on the index's own leaf-sorted series
    for its first ``n_queries`` queries: the Keogh envelope of every series
    and of every leaf (min L and max U over its members, by contiguous
    segments), the node-level LB_Keogh through ``box_lb``, the point-wise
    LB_Keogh of every pair through ``box_lb`` and the DTW of every pair in
    one ``dtw`` launch.  Asserts (on the card) one ``dtw`` and two
    ``box_lb`` launches, the DTW bitwise equal to its plain version on
    every pair, lb_keogh <= dtw <= euclidean on every pair (the Euclidean
    distance summed directly, in chunks of ``chunk`` series) and the node
    bound <= the least member DTW on every (query, leaf), each within
    ``DTW_MARGIN``.  Prints each query's DTW 1-NN beside its Euclidean
    1-NN and the share of leaves whose node bound exceeds the query's DTW
    1-NN distance.  The DTW call is captured for the kernel checks; the
    box calls only under ``box_lb@shapes``, so ``box_lb``'s own row keeps
    the calls of the search paths."""
    import torch
    from repro_torch.core import dtw
    from repro_torch.kernels.dtw import kernel as dtw_kernel
    from repro_torch.kernels.dtw import ref as dtw_ref
    idx = lfi.index
    on_card = torch.device(device).type == "cuda"
    captured = {} if captured is None else captured
    t_phase = time.perf_counter()
    x = idx.series[: idx.n_series]
    sizes = idx.leaf_size.to(x.device)
    q = torch.as_tensor(np.asarray(queries[:n_queries], np.float32),
                        device=x.device)
    box_rows = {k: captured[k] for k in ("box_lb", "box_lb@min_q")
                if k in captured}
    _zero_counters()
    with capture_largest_inputs(captured):
        _sync(device)
        t0 = time.perf_counter()
        lo, hi = dtw.keogh_envelope(x, band)
        env_lo = torch.segment_reduce(lo, "min", lengths=sizes, axis=0)
        env_hi = torch.segment_reduce(hi, "max", lengths=sizes, axis=0)
        del lo, hi
        node = dtw.lb_keogh_leaves(q, env_lo, env_hi)          # (Q, L)
        lb = dtw.lb_keogh(q, x, band)                          # (Q, N)
        d = dtw.dtw(q, x, band)                                # (Q, N)
        _sync(device)
        t_path = time.perf_counter() - t0
    launches = _launch_counters()
    for k in ("box_lb", "box_lb@min_q"):
        if k in box_rows:
            captured[k] = box_rows[k]
        else:
            captured.pop(k, None)
    _check_launches(launches, _instance_launches(), DTW_KERNELS, "dtw",
                    on_card)
    if on_card:
        assert launches["dtw"] == 1 and launches["box_lb"] == 2, launches
    Q, N, L = q.shape[0], x.shape[0], env_lo.shape[0]
    assert d.shape == lb.shape == (Q, N) and node.shape == (Q, L)
    assert torch.isfinite(d).all() and torch.isfinite(lb).all()
    t0 = time.perf_counter()
    assert _bitwise_equal(d, dtw_ref.dtw(q, x, band)), \
        "dtw disagrees with its plain version"
    t_hold = time.perf_counter() - t0
    eu = torch.empty_like(d)
    for s in range(0, N, chunk):
        diff = q[:, None, :] - x[None, s:s + chunk]
        eu[:, s:s + chunk] = torch.sqrt((diff * diff).sum(-1))
    del diff
    member = torch.segment_reduce(d.t().contiguous(), "min", lengths=sizes,
                                  axis=0).t()                  # (Q, L)
    over = {"lb_keogh - dtw": (lb - d).max().item(),
            "dtw - euclidean": (d - eu).max().item(),
            "node bound - least member dtw": (node - member).max().item()}
    log(f"dtw: {Q} queries x {N} series (m = {q.shape[1]}, r = {band}, "
        f"{dtw_kernel.instance(q.shape[1], band)}), {L} leaves: envelopes, "
        f"both LB_Keogh bounds and the DTW in {t_path:.3f} s on "
        f"{x.device}; the DTW bitwise equal to its plain version on all "
        f"{Q * N} pairs (the plain run {t_hold:.2f} s); largest excess "
        + json.dumps(over) + f" (margin {DTW_MARGIN:g})")
    assert all(v <= DTW_MARGIN for v in over.values()), over
    nn_d, nn_row = d.min(1)
    eu_d, eu_row = eu.min(1)
    ids = idx.order.to(x.device)
    pruned = (node > nn_d[:, None]).float().mean(1)
    for i in range(Q):
        log(f"dtw query {i}: DTW 1-NN {nn_d[i].item():.6f} (id "
            f"{ids[nn_row[i]].item()}, euclidean there "
            f"{eu[i, nn_row[i]].item():.6f}); euclidean 1-NN "
            f"{eu_d[i].item():.6f} (id {ids[eu_row[i]].item()}, DTW there "
            f"{d[i, eu_row[i]].item():.6f}); LB_Keogh alone prunes "
            f"{pruned[i].item():.4f} of the leaves")
    wall = time.perf_counter() - t_phase
    log(f"dtw: LB_Keogh alone prunes {pruned.mean().item():.4f} of the "
        f"leaves on average (node bound > the query's DTW 1-NN); phase wall "
        f"{wall:.1f} s")
    return {"launches": launches, "pruned": pruned.cpu().numpy(),
            "nn": nn_d.cpu().numpy(), "wall_s": wall}


def run_filter_types(lfi, queries: np.ndarray, *, n_search: int = 64,
                     n_early: int = 8, widths: dict | None = None,
                     device: str = "cuda",
                     captured: dict | None = None) -> dict:
    """The paper's CNN and LSTM filter backbones (``FILTER_TYPES``, or
    ``widths``) on the index's leaves: parameters from ``filters.INIT`` (a
    generator on the device seeded 0; y_mean and y_std copied from the MLP
    stack), the tuners refit on the calibration split as
    ``requantize_leafi`` refits them, then the first ``n_search`` queries
    through ``LeaFiIndex.search`` at exact and 0.99, k = 1 and 5, and
    ``search_early`` on ``n_early`` of them at k = 5, 0.99.  Asserts finite
    results of the expected shapes, exact == brute force for the
    ``n_early`` queries and (on the card) one launch of the backbone's
    kernel a prediction call (calibration, each filtered batch, each
    ``search_early`` call) and none of the fused MLP kernel.  Prints
    recall@1 at 0.99 on the calibration split beside the tuner's knots.
    Returns the launches summed over the backbones."""
    import dataclasses
    import torch
    from repro_torch.core import conformal, filters, search
    idx = lfi.index
    on_card = torch.device(device).type == "cuda"
    widths = FILTER_TYPES if widths is None else widths
    q = np.asarray(queries[:n_search], np.float32)
    captured = {} if captured is None else captured
    total: dict = {}
    out = {}
    for ftype, kw in widths.items():
        kname = f"filter_{ftype}"
        gen = torch.Generator(device=device).manual_seed(0)
        params = filters.INIT[ftype](len(lfi.leaf_ids), idx.length, **kw,
                                     generator=gen, device=device)
        for stat in ("y_mean", "y_std"):
            params[stat] = lfi.filter_params[stat].clone()
        _zero_counters()
        with capture_largest_inputs(captured):
            _sync(device)
            t0 = time.perf_counter()
            d_pred = search.predictions_for_all_leaves(
                idx, params, lfi.leaf_ids, lfi.calib.queries, None,
                filter_type=ftype)
            tuner, _ = conformal.fit_autotuners(
                lfi.calib.d_lb, d_pred, lfi.calib.d_L, lfi.leaf_ids)
            _sync(device)
            t_fit = time.perf_counter() - t0
            lft = dataclasses.replace(
                lfi, filter_params=params, tuner=tuner,
                config=dataclasses.replace(lfi.config, filter_type=ftype))
            results = {}
            for k in (1, 5):
                for name, target in (("exact", None), ("0.99", 0.99)):
                    _sync(device)
                    t0 = time.perf_counter()
                    r = lft.search(q, k=k, quality_target=target,
                                   device=device)
                    _sync(device)
                    results[(k, name)] = (r, time.perf_counter() - t0)
            early, walls = [], []
            for i in range(n_early):
                _sync(device)
                t0 = time.perf_counter()
                early.append(search.search_early(
                    idx, q[i], k=5, quality_target=0.99,
                    filter_params=params, leaf_ids=lft.leaf_ids,
                    tuner=tuner, filter_type=ftype, device=device))
                _sync(device)
                walls.append(time.perf_counter() - t0)
        launches = _launch_counters()
        label = f"filter type {ftype} ({json.dumps(kw)})"
        log(f"{label}: {len(lfi.leaf_ids)} filters, predictions on the "
            f"{len(lfi.calib.queries)} calibration queries and tuner fit "
            f"{t_fit:.2f} s")
        for (k, name), (r, wall) in results.items():
            assert r.dists.shape == (len(q), k), r.dists.shape
            assert np.isfinite(r.dists).all(), f"non-finite dists {k} {name}"
            log(_search_line(f"{label} k={k} target={name:5s}", r,
                             results[(k, "exact")][0], wall, len(q)))
        er = _stack_results(early, idx.n_leaves)
        exact5 = results[(5, "exact")][0]
        assert er.dists.shape == (n_early, 5) and np.isfinite(er.dists).all()
        log(f"{label} search_early k=5 target=0.99: per query wall median "
            f"{np.median(walls) * 1e3:.2f} ms, p90 "
            f"{np.percentile(walls, 90) * 1e3:.2f} ms; searched="
            f"{er.searched.mean():.1f}/{er.n_leaves} pruned_lb="
            f"{er.pruned_lb.mean():.1f} pruned_filter="
            f"{er.pruned_filter.mean():.1f} pruning="
            f"{er.pruning_ratio.mean():.4f} recall="
            f"{_recall(er.ids, exact5.ids[:n_early]):.4f}")
        _brute_force_check(lft, q, [exact5], n_early, f"{label} ")
        calls = 1 + 2 + n_early       # calibration, 2 filtered, the walks
        log(f"{label}: launches " + json.dumps(
            {k: v for k, v in launches.items() if v}) + f"; {kname} "
            f"expected {calls} (one a prediction call)")
        if on_card:
            assert launches[kname] == calls, (launches[kname], calls)
            assert launches["fused_filter_mlp"] == 0, launches
        out[ftype] = {"results": results, "early": er,
                      "calib_recall": _calib_recall_line(f"{label} ", lft,
                                                         device)}
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    captured.pop("early_walk@calls", None)   # run_early keeps its own
    out["launches"] = total
    return out


def run_grouped(lfi, queries: np.ndarray, targets: dict, batched: dict, *,
                device: str = "cuda", captured: dict | None = None) -> dict:
    """``search_batched_grouped`` on the per-query-target batch, k = 1 and
    5, beside the vectorised per-query batch from ``batched``; asserts the
    reference's serving tolerances between the two and (on the card) that
    the lower-bound and fused filter kernels launched."""
    import torch
    from repro_torch.core import search
    on_card = torch.device(device).type == "cuda"
    per_query = targets["per-query"]
    results = {}
    captured = {} if captured is None else captured
    _zero_counters()
    with capture_largest_inputs(captured):
        for k in (1, 5):
            _sync(device)
            t0 = time.perf_counter()
            r = search.search_batched_grouped(
                lfi.index, queries, per_query, k=k,
                filter_params=lfi.filter_params, leaf_ids=lfi.leaf_ids,
                tuner=lfi.tuner, device=device)
            _sync(device)
            results[k] = (r, time.perf_counter() - t0)
    launches, by_instance = _launch_counters(), _instance_launches()

    n = len(queries)
    for k, (grp, wall) in results.items():
        vec, vec_wall = batched[("default", k, "per-query")]
        exact = batched[("default", k, "exact")][0]
        assert grp.dists.shape == (n, k), grp.dists.shape
        same = float((grp.ids == vec.ids).all(1).mean())
        neq = float((grp.ids != vec.ids).mean())
        log(_search_line(f"grouped    k={k} target=per-query", grp, exact,
                         wall, n)
            + f" | vectorised: pruning={vec.pruning_ratio.mean():.4f} "
            f"recall={_recall(vec.ids, exact.ids):.4f} wall="
            f"{vec_wall * 1e3:.1f} ms; identical ids on {same:.4f} of the "
            f"queries, {neq:.4f} of the ids differ")
        np.testing.assert_allclose(vec.dists, grp.dists, rtol=1e-5,
                                   atol=1e-6)
        assert np.abs(vec.searched - grp.searched).max() <= 2
        assert neq <= 0.02, f"{neq} of the ids differ beyond ties"
    _check_launches(launches, by_instance, GROUPED_KERNELS, "grouped",
                    on_card)
    return {"launches": launches, "results": results}


#: the kernels of the trace-and-audit phase's searches
TRACE_KERNELS = ("box_lb", "fused_filter_mlp", "replay", "leaf_topk")
#: the answer's fields that trace and audit must leave bitwise as they are
ANSWER_FIELDS = ("dists", "ids", "searched", "pruned_lb", "pruned_filter",
                 "computed")


def _same_answers(a, b) -> bool:
    """Two search results' answers and counters bitwise equal."""
    def bits(x):
        return x.view(np.int32) if x.dtype == np.float32 else x
    return all(np.array_equal(bits(getattr(a, f)), bits(getattr(b, f)))
               for f in ANSWER_FIELDS)


def _check_trace_audit(r, n_leaves: int, label: str) -> dict:
    """A traced and audited result's identities: the trace's accounting
    residual zero for every query, the audit's for every leaf, the audit's
    leaf sums equal to the trace's query sums for box, seed and filter,
    and the residual histogram's mass equal to its count."""
    t, a = r.trace, r.audit
    n_q = r.dists.shape[0]
    pruned = t["pruned_box"] + t["pruned_seed"] + t["pruned_filter"]
    assert not (n_leaves - t["survivors"] - t["probed"] - pruned).any(), \
        f"{label}: the trace's accounting residual is not zero"
    assert not (n_q - a["kept"] - a["pruned_box"] - a["pruned_seed"]
                - a["pruned_filter"]).any(), \
        f"{label}: the audit's accounting residual is not zero"
    for f in ("pruned_box", "pruned_seed", "pruned_filter"):
        assert a[f].sum() == t[f].sum(), (label, f, a[f].sum(), t[f].sum())
    assert (a["resid_buckets"].sum(-1) == a["resid_count"]).all(), label
    return {f: int(t[f].sum()) for f in t}


#: the audit's integer fields the health board sums over its window
BOARD_INT_FIELDS = ("violations", "resid_count", "scored", "kept",
                    "pruned_box", "pruned_seed", "pruned_filter",
                    "rows_saved")
#: a Prometheus text-exposition sample line: name{labels} value
_PROM_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_PROM_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\[\\"n])*"'
PROM_SAMPLE = re.compile(rf"^{_PROM_NAME}(?:\{{{_PROM_LABEL}"
                         rf"(?:,{_PROM_LABEL})*\}})? (\S+)$")


def check_health_board(board, registry, folded: list, label: str) -> dict:
    """A ``LeafHealthBoard`` fed ``folded`` (audit dict, queries) batches:
    ``window_totals()`` equal to the folded audits' sums (the integer
    fields and the query count exactly, ``resid_sum`` to float64 rounding,
    ``resid_min`` exactly), ``health_violations_total`` their violations,
    ``filters_needing_attention()`` the leaves the board's thresholds flag
    on those totals, with their reasons, in the reference's severity order
    (shadow misses, then violation rate descending, then worst residual,
    then leaf); every non-comment line of the registry's Prometheus text
    ``name{labels} value``.  Returns the reports and the line count."""
    tot = board.window_totals()
    assert len(folded) <= board.window, (label, len(folded))
    for f in BOARD_INT_FIELDS:
        want = np.zeros(board.n_leaves, np.int64)
        for audit, _ in folded:
            want += np.asarray(audit[f], np.int64)
        assert tot[f].dtype == np.int64 and np.array_equal(tot[f], want), \
            f"{label}board: window total of {f}"
    assert tot["n_queries"] == sum(q for _, q in folded), label
    np.testing.assert_allclose(
        tot["resid_sum"], np.sum([np.asarray(a["resid_sum"], np.float64)
                                  for a, _ in folded], axis=0),
        rtol=1e-12, atol=0, err_msg=f"{label}board: resid_sum")
    assert np.array_equal(tot["resid_min"], np.min(
        [np.asarray(a["resid_min"], np.float64) for a, _ in folded],
        axis=0)), f"{label}board: resid_min"
    assert registry.counter("health_violations_total").value() == float(
        tot["violations"].sum()), label
    reports = board.filters_needing_attention()
    rate = tot["violations"] / np.maximum(tot["resid_count"], 1)
    want = {}
    for leaf in range(board.n_leaves):
        reasons = [r for r, hit in (
            ("violation-rate", tot["resid_count"][leaf]
             >= board.min_resid_count
             and rate[leaf] > board.violation_rate_threshold),
            ("deep-violation", tot["violations"][leaf] > 0
             and tot["resid_min"][leaf] < board.resid_min_threshold),
            ("shadow-miss", tot["shadow_misses"][leaf]
             >= board.min_shadow_misses)) if hit]
        if reasons:
            want[leaf] = reasons
    assert {r.leaf: r.reasons for r in reports} == want, \
        f"{label}board: flagged leaves"
    keys = [(-r.shadow_misses, -r.violation_rate, r.resid_min, r.leaf)
            for r in reports]
    assert keys == sorted(keys), f"{label}board: severity order"
    text = registry.prometheus_text()
    return {"reports": reports, "lines": len(text.splitlines()),
            "samples": _prom_samples(text, label)}


def _prom_samples(text: str, label: str = "") -> int:
    """Every non-comment line of a Prometheus text is ``name{labels}
    value``; returns their count."""
    samples = [ln for ln in text.splitlines() if not ln.startswith("#")]
    for ln in samples:
        m = PROM_SAMPLE.match(ln)
        assert m is not None, f"{label}Prometheus line {ln!r}"
        float(m.group(1))
    return len(samples)


def run_trace_audit(lfi, queries: np.ndarray, *, device: str = "cuda",
                    impls=(None,), label: str = "", reps: int = 5) -> dict:
    """The cascade trace and the per-leaf filter audit through
    ``LeaFiIndex.search`` (``search_batched(trace=True, audit=True)``) on
    ``queries``, k = 1 and 5, exact and at 0.99, for each candidate pass
    of ``impls`` (``pairwise`` at k = 5 only): each traced and audited
    batch asserted bitwise equal to the untraced one in its answers and
    counters, its trace's and audit's accounting residuals zero, the
    audit's leaf sums the trace's query sums, the histogram's mass its
    count; then each exact batch again with the bound ``bsf_ub`` = the
    exact k-th distance x (1 + 1e-6) + 1e-6: bitwise the unbounded answer,
    no more leaves searched, and (compact) seed prunes.  The launches are
    read over the phase (the replay by instance: the bounded batches take
    its bound instance, none its traced one).  Prints each batch's
    counts and a traced and audited batch's median wall (``reps`` rounds,
    in turns with the untraced one) beside the untraced one's.  Every
    audited batch's ``SearchResult.audit`` is folded into a
    ``LeafHealthBoard`` with a ``MetricsRegistry`` attached
    (``check_health_board``), and a ``RecallDriftMonitor`` on the same
    registry is fed the k = 1, 0.99 batch's per-query hits against the
    exact batch (the default pass)."""
    import torch
    from repro_torch import obs
    on_card = torch.device(device).type == "cuda"
    n_leaves = lfi.index.n_leaves
    registry = obs.MetricsRegistry()
    board = obs.LeafHealthBoard(registry=registry)
    folded: list = []

    def fold(r):
        board.record_audit(r.audit, r.dists.shape[0])
        folded.append((r.audit, r.dists.shape[0]))

    _zero_counters()
    runs, n_bound, hits = {}, 0, None
    for impl in impls:
        for k in ((1, 5) if impl is None else (5,)):
            exact = None
            for name, target in (("exact", None), ("0.99", 0.99)):
                kw = dict(k=k, quality_target=target, device=device,
                          dist_impl=impl)
                plain = lfi.search(queries, **kw)
                traced = lfi.search(queries, trace=True, audit=True, **kw)
                tag = f"{label}trace impl={impl or 'default'} k={k} {name}"
                assert plain.trace is None and plain.audit is None
                assert _same_answers(plain, traced), \
                    f"{tag}: trace and audit changed the answer"
                sums = _check_trace_audit(traced, n_leaves, tag)
                assert sums["pruned_seed"] == 0, (tag, sums)
                runs[(impl, k, name)] = sums
                fold(traced)
                if target is None:
                    exact = plain
                elif impl is None and k == 1:
                    hits = plain.ids[:, 0] == exact.ids[:, 0]
                ub = (exact.dists[:, k - 1] * (1 + 1e-6) + 1e-6).astype(
                    np.float32)
                bounded = lfi.search(queries, bsf_ub=ub, trace=True,
                                     audit=True, **kw)
                n_bound += 1
                fold(bounded)
                bsums = _check_trace_audit(bounded, n_leaves, tag + " bound")
                assert (bounded.searched <= plain.searched).all() or \
                    target is not None, f"{tag}: the bound searched more"
                if target is None:
                    # the default pass's distances do not depend on which
                    # other leaves a query keeps; the pairwise pass's union
                    # (and on the CPU its matrix products' shapes) does
                    same = np.array_equal(bounded.dists.view(np.int32),
                                          exact.dists.view(np.int32))
                    assert np.array_equal(bounded.ids, exact.ids) and (
                        same or impl == "pairwise"), \
                        f"{tag}: the bound changed the exact answer"
                    np.testing.assert_allclose(bounded.dists, exact.dists,
                                               rtol=1e-5, atol=1e-5)
                    bsums["bitwise"] = same
                    assert bsums["pruned_seed"] > 0, (tag, bsums)
                runs[(impl, k, name, "bound")] = bsums
                log(f"{tag}: trace sums {json.dumps(sums)}; searched "
                    f"{plain.searched.mean():.2f}; with the bound: trace "
                    f"sums {json.dumps(bsums)}, searched "
                    f"{bounded.searched.mean():.2f}, computed "
                    f"{bounded.computed.mean():.2f} (unbounded "
                    f"{plain.computed.mean():.2f})")
    launches, modes = _launch_counters(), _replay_mode_launches()
    _check_launches(launches, _instance_launches(), TRACE_KERNELS,
                    f"{label}trace-and-audit", on_card)
    log(f"replay launches by instance on the {label}trace-and-audit path: "
        + json.dumps(modes))
    if on_card:
        assert modes["bound"] == n_bound and modes["traced"] == 0, modes
        assert modes["plain"] == 2 * len(runs) - 2 * n_bound, modes
    walls: dict = {"untraced": [], "traced and audited": []}
    for _ in range(reps):
        for name, extra in (("untraced", {}),
                            ("traced and audited",
                             {"trace": True, "audit": True})):
            _sync(device)
            t0 = time.perf_counter()
            r = lfi.search(queries, k=5, quality_target=0.99, device=device,
                           **extra)
            _sync(device)
            walls[name].append((time.perf_counter() - t0) * 1e3)
            if extra:
                fold(r)
    med = {n: float(np.median(v)) for n, v in walls.items()}
    log(f"{label}trace and audit: a k=5, 0.99 batch of {len(queries)} "
        f"queries, median of {reps} rounds in turns: untraced "
        f"{med['untraced']:.2f} ms [runs "
        f"{', '.join(f'{t:.2f}' for t in walls['untraced'])}], traced and "
        f"audited {med['traced and audited']:.2f} ms [runs "
        f"{', '.join(f'{t:.2f}' for t in walls['traced and audited'])}]")
    t0 = time.perf_counter()
    health = check_health_board(board, registry, folded, label)
    monitor = obs.RecallDriftMonitor(registry)
    for hit in hits.tolist():
        monitor.observe(0.99, hit)
    health.update(recall=monitor.windowed_recall(),
                  drifting=monitor.any_drifting(),
                  lines=len(registry.prometheus_text().splitlines()))
    log(f"{label}health board over {len(folded)} audited batches "
        f"({board.window_totals()['n_queries']} queries, "
        f"{n_leaves} leaves): {len(health['reports'])} leaves flagged, the "
        "first three " + json.dumps([r.to_dict() for r in
                                     health["reports"][:3]])
        + f"; windowed totals equal the folded audits, the flags in "
        f"severity order; drift monitor on the k=1, 0.99 batch's "
        f"{len(hits)} hits: windowed recall "
        f"{json.dumps(health['recall'])}, drifting {health['drifting']}; "
        f"the registry's Prometheus text {health['lines']} lines, every "
        f"sample line name{{labels}} value; "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return {"launches": launches, "replay_modes": modes, "wall_ms": med,
            "runs": {" ".join(map(str, key)): v for key, v in runs.items()},
            "health": health}


#: the kernels of every served batch (the default pass: probe and survivors
#: on ``leaf_topk``; warm start on the replay's bound instance)
SERVING_KERNELS = ("box_lb", "fused_filter_mlp", "replay", "leaf_topk")
#: the batch log's host-clock keys, stripped before logs are compared
SERVE_HOST_KEYS = ("wall", "dispatch_s", "harvest_s", "t_disp", "t_done")
#: the launcher's flags in the serving phase (the checkpoint, the device,
#: the batch, the request count, the rate and the dumps are added)
SERVE_FLAGS = ("--arch", "leafi", "--k", "5",
               "--targets", "0.9,0.95,0.99", "--max-wait-ms", "20",
               "--warm-start", "--shadow-rate", "0.05", "--summary",
               "--explain", "0")
#: the breakdown's session configurations: (label, warm_start, audit)
SERVE_CONFIGS = (("cold", False, False), ("warm start", True, False),
                 ("audited", False, True), ("both", True, True))


def _index_arrays(lfi) -> dict:
    """An index's tensors and arrays by name, for a bitwise comparison."""
    idx = lfi.index
    out = {n: getattr(idx, n) for n in ("series", "order", "leaf_start",
                                        "leaf_size")}
    out.update({f"payload/{k}": v for k, v in idx.payload.items()})
    out.update({f"filter_params/{k}": v
                for k, v in (lfi.filter_params or {}).items()})
    out["leaf_ids"] = np.asarray(lfi.leaf_ids)
    if lfi.tuner is not None:
        out.update({f"tuner/{k}": np.asarray(getattr(lfi.tuner, k))
                    for k in ("knots_q", "knots_o", "slopes", "max_offset")})
    if lfi.calib is not None:
        out.update({f"calib/{k}": getattr(lfi.calib, k)
                    for k in ("queries", "d_lb", "d_L")})
    return out


def _same_bits(a, b) -> bool:
    """Two tensors or arrays on one device, of one dtype and shape, with
    equal bits (``_bitwise_equal``)."""
    import torch
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return a.device == b.device and _bitwise_equal(a, b)


def check_checkpoint_round_trip(lfi, queries: np.ndarray, path: str,
                                device: str, label: str = "") -> dict:
    """``save_index`` of the index to ``path``, ``load_index`` onto
    ``device``: every array bitwise the built index's, the tuner's knots,
    the config and the build report equal; a batch at k = 5, exact and at
    0.99, bitwise the same answers and counters on both.  Prints the
    checkpoint's bytes and the save and load seconds; leaves the
    checkpoint at ``path``."""
    from repro_torch.serving import session as serving_session
    t0 = time.perf_counter()
    serving_session.save_index(path, lfi)
    save_s = time.perf_counter() - t0
    n_bytes = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path))
    _sync(device)
    t0 = time.perf_counter()
    loaded = serving_session.load_index(path, device=device)
    _sync(device)
    load_s = time.perf_counter() - t0
    want, got = _index_arrays(lfi), _index_arrays(loaded)
    assert set(got) == set(want), (sorted(got), sorted(want))
    bad = [k for k in want if not _same_bits(got[k], want[k])]
    assert not bad, f"{label}checkpoint: arrays differ after load: {bad}"
    for f in serving_session._CONFIG_FIELDS:
        assert getattr(loaded.config, f) == getattr(lfi.config, f), f
    assert loaded.build_report == {k: float(v) for k, v in
                                   lfi.build_report.items()}
    for target in (None, 0.99):
        a = lfi.search(queries, k=5, quality_target=target, device=device)
        b = loaded.search(queries, k=5, quality_target=target,
                          device=device)
        assert _same_answers(a, b), \
            f"{label}checkpoint: the loaded index answers otherwise " \
            f"(k=5, target={target})"
    log(f"{label}checkpoint round trip: {n_bytes} bytes "
        f"({n_bytes / 2**30:.3f} GiB, {len(want)} arrays), save "
        f"{save_s:.2f} s, load onto {device} {load_s:.2f} s; every array "
        f"bitwise, the tuner, config and build report equal, a batch of "
        f"{len(queries)} at k=5 exact and 0.99 bitwise the same answers "
        "and counters")
    del loaded
    return {"bytes": n_bytes, "save_s": save_s, "load_s": load_s}


def _serve_main(argv: list, out_path: str) -> tuple:
    """``repro_torch.launch.serve.main(argv)`` in this process, its
    standard output written to ``out_path`` (its telemetry summary lists
    every flagged leaf) and returned beside the report."""
    import io
    from repro_torch.launch import serve
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        report = serve.main(argv)
    wall = time.perf_counter() - t0
    with open(out_path, "w") as fh:
        fh.write(buf.getvalue())
    return report, buf.getvalue(), wall


def check_serving_determinism(lfi, queries: np.ndarray, *, device: str,
                              n_requests: int = 1024, batch: int = 64,
                              captured: dict | None = None,
                              label: str = "") -> dict:
    """One warm-start ``ServingSession`` over a seeded trace (ks 1 and 5,
    targets 0.9 / 0.95 / 0.99, ``max_batch`` ``batch``), served serially
    and with ``pipeline=2`` under one injected ``service_time``: the same
    batch log (host keys stripped), completions and results, compared with
    ``==``; the exact search's nearest distances those of a plain
    brute-force scan (``_plain_nearest``, rtol 1e-4, atol 1e-3, as
    ``_brute_force_check``); every served distance at least the exact one
    less 1e-4 (the warm bound prunes only); each target group's share of
    requests served their true nearest distance printed.  The two
    serving runs' kernel calls (and no others) are captured into
    ``captured``, the replay's bound instance's too."""
    from repro_torch import serving
    trace = serving.poisson_trace(queries, rate=2000.0,
                                  n_requests=n_requests,
                                  targets=(0.9, 0.95, 0.99), ks=(1, 5),
                                  seed=7)

    def service(b):
        return 4e-3 * max(b.bucket / batch, 0.25)

    reports = {}
    with (contextlib.nullcontext() if captured is None
          else capture_largest_inputs(captured, bound=True, max_q=batch)):
        for pipeline in (0, 2):
            session = serving.ServingSession(lfi, warm_start=True,
                                             device=device)
            reports[pipeline] = session.serve(
                trace, batcher=serving.MicroBatcher(max_batch=batch,
                                                    max_wait=0.02),
                service_time=service, pipeline=pipeline)
    r0, r2 = reports[0], reports[2]

    def strip(log_):
        return [{k: v for k, v in b.items() if k not in SERVE_HOST_KEYS}
                for b in log_]
    assert strip(r0["batches"]) == strip(r2["batches"]), \
        f"{label}serving: pipelined batch log differs from the serial one"
    assert r0["completions"].keys() == r2["completions"].keys()
    for rid, c0 in r0["completions"].items():
        c2 = r2["completions"][rid]
        assert c0["latency"] == c2["latency"] and \
            c0["result"] == c2["result"], (label, rid, c0, c2)
    assert len(r0["completions"]) == n_requests
    exact = lfi.search(queries, k=1, quality_target=None,
                       device=device).dists[:, 0]
    truth = _plain_nearest(lfi.index, queries)
    np.testing.assert_allclose(exact, truth, rtol=1e-4, atol=1e-3,
                               err_msg=f"{label}serving: the exact oracle")
    served = {r.rid: r0["completions"][r.rid]["result"]["dist"]
              for r in trace}
    worst = min(served[r.rid] - float(exact[r.pool_row]) for r in trace)
    assert worst >= -1e-4, f"{label}serving: a warm-start distance " \
        f"{-worst} below the exact one"
    hits: dict = {}
    for r in trace:
        t = truth[r.pool_row]
        hits.setdefault(r.quality_target, []).append(
            served[r.rid] <= t + 1e-3 + 1e-4 * t)
    share = {f"{t:g}": float(np.mean(h)) for t, h in sorted(hits.items())}
    log(f"{label}serving determinism: {n_requests} requests (k=1/5, "
        f"targets 0.9/0.95/0.99) in {len(r0['batches'])} batches of up to "
        f"{batch}, warm start, serial == pipeline=2 (batch log, latencies, "
        f"results; ==); the exact oracle == a plain float64 scan of "
        f"{truth.shape[0]} queries; served - exact distance >= {worst:.3g} "
        f"(>= -1e-4); share served the true nearest distance by target "
        + json.dumps(share))
    return {"n_batches": len(r0["batches"]), "min_margin": worst,
            "true_nearest_share": share}


def _plain_nearest(index, queries: np.ndarray,
                   chunk: int = 1 << 17) -> np.ndarray:
    """Each query's nearest Euclidean distance over the index's series, by
    a float64 scan in plain PyTorch (no kernel of the port), on the index's
    device, in chunks of ``chunk`` series."""
    import torch
    series = index.series[: index.n_series]
    q = torch.as_tensor(queries, device=series.device, dtype=torch.float64)
    qq = (q * q).sum(1, keepdim=True)
    best = torch.full((q.shape[0],), math.inf, dtype=torch.float64,
                      device=series.device)
    for i in range(0, series.shape[0], chunk):
        s = series[i:i + chunk].double()
        d2 = qq + (s * s).sum(1)[None, :] - 2.0 * q @ s.T
        best = torch.minimum(best, d2.min(1).values)
    return best.clamp_min(0).sqrt().cpu().numpy()


class _Timed:
    """Wall seconds of each call of one method of one object, set on the
    instance (``undo`` removes it)."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.calls = obj, name, []
        fn = getattr(obj, name)

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.calls.append(time.perf_counter() - t0)
            return out
        setattr(obj, name, timed)

    def undo(self) -> None:
        delattr(self.obj, self.name)

    def median_ms(self):
        return float(np.median(self.calls)) * 1e3 if self.calls else None


def serving_breakdown(lfi, trace, *, device: str, batch: int = 64,
                      label: str = "") -> dict:
    """Serve ``trace`` serially on the measured clock in four
    configurations (cold, warm start, audited, both) and print the p50,
    p95 and p99 of ``serve_form_s`` (host formation and enqueue) and
    ``serve_exec_s`` (the wait on the card and the copy back), with the
    medians, a batch, of ``BsfCache.seed``, the per-query
    ``tuner.offsets``, the health board's refresh (``record_audit``) and,
    timed alone, the 8-byte-a-series ``index.order`` copy each dispatch
    makes."""
    from repro_torch import serving
    from repro_torch.serving import latency_percentiles
    out = {}
    for name, warm, audit in SERVE_CONFIGS:
        session = serving.ServingSession(lfi, warm_start=warm, audit=audit,
                                         device=device)
        session.warmup(max_batch=batch, ks=(5,),
                       queries=np.stack([r.query for r in trace[:batch]]))
        timers = [_Timed(session.warm_cache, "seed"),
                  _Timed(lfi.tuner, "offsets"),
                  _Timed(session.telemetry.health, "record_audit")]
        try:
            t0 = time.perf_counter()
            report = session.serve(trace, batcher=serving.MicroBatcher(
                max_batch=batch, max_wait=0.02))
            wall = time.perf_counter() - t0
        finally:
            for t in timers:
                t.undo()
        tel = session.telemetry
        row = {"qps": report["throughput_qps"], "p50_ms": report["p50"] * 1e3,
               "p99_ms": report["p99"] * 1e3, "wall_s": wall,
               "n_batches": report["n_batches"],
               "form_ms": {k: v * 1e3 for k, v in latency_percentiles(
                   list(tel.form_s)).items()},
               "exec_ms": {k: v * 1e3 for k, v in latency_percentiles(
                   list(tel.exec_s)).items()},
               "seed_ms": timers[0].median_ms(),
               "offsets_ms": timers[1].median_ms(),
               "board_ms": timers[2].median_ms()}
        out[name] = row
        log(f"{label}serving breakdown [{name}]: {report['n_requests']} "
            f"requests in {row['n_batches']} batches, {row['qps']:.1f} qps "
            f"(measured clock), latency p50 {row['p50_ms']:.2f} / p99 "
            f"{row['p99_ms']:.2f} ms; serve_form_s p50/p95/p99 "
            + "/".join(f"{v:.3f}" for v in row["form_ms"].values())
            + " ms, serve_exec_s "
            + "/".join(f"{v:.3f}" for v in row["exec_ms"].values())
            + " ms; a batch's BsfCache.seed "
            + _ms(row["seed_ms"]) + ", tuner.offsets " + _ms(row["offsets_ms"])
            + ", board refresh " + _ms(row["board_ms"]))
    order = lfi.index.order
    copies = []
    for _ in range(20):
        _sync(device)
        t0 = time.perf_counter()
        order.cpu().numpy()
        copies.append(time.perf_counter() - t0)
    out["order_copy_ms"] = float(np.median(copies)) * 1e3
    log(f"{label}serving breakdown: the index.order copy each dispatch "
        f"makes ({order.numel() * order.element_size()} bytes), median of "
        f"20 alone {out['order_copy_ms']:.3f} ms")
    return out


def _ms(v) -> str:
    return "not run" if v is None else f"{v:.3f} ms"


def _merge_serving(captured: dict, served: dict) -> None:
    """The serving phase's captured calls into ``captured``: each kernel's
    largest under ``<key>@serving`` (the probe's, ``leaf_topk@probe``, and
    the replay's bound instance's, ``replay@bound``, too), its ``box_lb``
    shapes beside the other paths' (their launches added)."""
    for key, val in served.items():
        if key == "box_lb@shapes":
            shapes = captured.setdefault(key, {})
            for shape, (count, args) in val.items():
                shapes[shape] = (shapes.get(shape, (0, None))[0] + count,
                                 args)
        elif not key.endswith("@min_q"):
            captured[f"{key}@serving"] = val


def run_serving(lfi, queries: np.ndarray, *, device: str = "cuda",
                scratch: str | None = None, out_dir: str | None = None,
                n_requests: int = 2048, rate: float = 2000.0,
                n_det: int = 1024, batch: int = 64,
                captured: dict | None = None, label: str = "") -> dict:
    """The serving phase on a built index: the checkpoint round trip
    (``check_checkpoint_round_trip``), then ``launch/serve.py --arch
    leafi`` in this process on that checkpoint (cold start, warmup, a
    serial open-loop trace of ``n_requests`` at ``rate`` on the measured
    clock, shadow audit, health board, the metrics, trace and health
    dumps, one explain report): every request answered, the recall of
    each target group printed beside its n, the Prometheus text parsing,
    the Chrome trace holding ``serve.dispatch`` and ``serve.harvest``
    spans; then the pipelined/serial determinism
    (``check_serving_determinism``) and the breakdown of a served batch
    (``serving_breakdown``).  The launch counters are zeroed at the start
    and read at the end (the replay's by instance: warm start runs its
    bound instance).  The launcher's and the determinism's served
    batches' kernel calls (at most ``batch`` queries), and every
    ``box_lb`` shape of theirs, are captured into ``captured``
    (``_merge_serving``), for ``check_kernels`` to hold at the served
    shapes."""
    import shutil
    import torch
    from repro_torch import serving
    on_card = torch.device(device).type == "cuda"
    scratch = scratch or os.path.join(ROOT, ".chip_scratch")
    out_dir = out_dir or os.path.join(ROOT, "chiprun_out")
    os.makedirs(scratch, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(scratch, f"{label.strip() or 'index'}_serving_ckpt")
    tag = label.strip().replace(" ", "_") or "index"
    dumps = {k: os.path.join(out_dir, f"serving_{tag}_{k}")
             for k in ("health.json", "metrics.prom", "trace.json",
                       "main.log")}
    _zero_counters()
    t0 = time.perf_counter()
    ckpt = check_checkpoint_round_trip(lfi, queries[:256], path, device,
                                       label)
    argv = list(SERVE_FLAGS) + [
        "--ckpt", path, "--device", device, "--requests", str(n_requests),
        "--rate", str(rate), "--batch", str(batch),
        "--health-dump", dumps["health.json"],
        "--metrics-dump", dumps["metrics.prom"],
        "--trace-dump", dumps["trace.json"]]
    # the launcher's oracle and shadow searches (more rows than a bucket)
    # count only among box_lb's shapes
    served: dict = {}
    try:
        with capture_largest_inputs(served, bound=True, max_q=batch):
            report, printed, main_s = _serve_main(argv, dumps["main.log"])
    finally:
        shutil.rmtree(path, ignore_errors=True)
    assert report["n_requests"] == n_requests and sorted(
        report["completions"]) == list(range(n_requests)), \
        f"{label}serving: not every request was answered"
    recall_lines = [ln for ln in printed.splitlines()
                    if ln.strip().startswith("target ")
                    and "achieved recall" in ln and "(n=" in ln]
    groups = report["recall_by_target"]
    assert len(recall_lines) == len(groups) == 3 and sum(
        g["n"] for g in groups.values()) == n_requests, \
        (label, recall_lines, groups)
    with open(dumps["metrics.prom"]) as fh:
        n_prom = _prom_samples(fh.read(), label)
    with open(dumps["trace.json"]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"serve.dispatch", "serve.harvest"} <= names, \
        f"{label}serving: the Chrome trace lacks the serve spans"
    n_dispatch = sum(e.get("name") == "serve.dispatch" for e in events)
    with open(dumps["health.json"]) as fh:
        health = json.load(fh)
    for ln in printed.splitlines():
        if ln.startswith(("cold start", "warmed", "served", "  target",
                          "shadow audit", "filters needing")):
            log(f"{label}serve.main: {ln.strip()}")
    log(f"{label}serve.main: {main_s:.2f} s in all; every one of "
        f"{n_requests} requests answered; {n_prom} Prometheus samples "
        f"parse; the Chrome trace holds {n_dispatch} serve.dispatch and "
        f"{sum(e.get('name') == 'serve.harvest' for e in events)} "
        f"serve.harvest spans ({len(events)} events); the health dump "
        f"{health['n_leaves']} leaves, {health['window_batches']} audited "
        f"batches, {len(health['filters_needing_attention'])} flagged; "
        f"output in {dumps['main.log']}")
    det = check_serving_determinism(lfi, queries, device=device,
                                    n_requests=n_det, batch=batch,
                                    captured=served, label=label)
    _merge_serving({} if captured is None else captured, served)
    trace = serving.poisson_trace(queries, rate=rate, n_requests=n_requests,
                                  targets=(0.9, 0.95, 0.99), ks=(5,), seed=0)
    parts = serving_breakdown(lfi, trace, device=device, batch=batch,
                              label=label)
    launches, modes = _launch_counters(), _replay_mode_launches()
    _check_launches(launches, _instance_launches(), SERVING_KERNELS,
                    f"{label}serving", on_card)
    log(f"replay launches by instance on the {label}serving path: "
        + json.dumps(modes))
    if on_card:
        assert modes["bound"] > 0 and modes["traced"] == 0, modes
    log(f"{label}serving phase {time.perf_counter() - t0:.2f} s")
    return {"launches": launches, "replay_modes": modes,
            "checkpoint": ckpt, "report": {
                k: report[k] for k in ("n_requests", "n_batches",
                                       "throughput_qps", "p50", "p95",
                                       "p99", "recall_by_target")},
            "determinism": det, "breakdown": parts}


def run_filter_suite(n_filters: int, *, sweep: dict | None = None,
                     main_shape: tuple = (256, 256, 256),
                     device: str = "cuda", captured: dict | None = None
                     ) -> dict:
    """The filter-inference suite at its own sweep (``sweep``: arguments of
    ``bench_filters``, its defaults if None), then once at the main path's
    shape (``n_filters``, Q, m, h = ``main_shape``); prints each payload's
    rows, parity errors and fused-over-per-filter speedups and asserts (on
    the card) that all four filter kernels launched."""
    import torch
    from repro_torch.bench import filters_bench
    on_card = torch.device(device).type == "cuda"
    q, m, h = main_shape
    captured = {} if captured is None else captured
    payloads = []
    _zero_counters()
    with capture_largest_inputs(captured):
        for label, args in (("sweep", sweep or {}),
                            ("main shape", dict(f_values=(n_filters,), q=q,
                                                m=m, h=h))):
            t0 = time.perf_counter()
            rows, payload = filters_bench.bench_filters(**args,
                                                        device=device)
            cfg = payload["config"]
            log(f"filter suite, {label} (F={cfg['f_values']}, Q={cfg['Q']}, "
                f"m={cfg['m']}, h={cfg['h']}, {cfg['device']}) in "
                f"{time.perf_counter() - t0:.2f} s: name,us_per_call,derived")
            for row in rows:
                log(f"  {row}")
            log(f"filter suite, {label}: parity_max_abs_err "
                + json.dumps(payload["parity_max_abs_err"]))
            log(f"filter suite, {label}: fused_speedup_f32 "
                + json.dumps(payload["fused_speedup_f32"]))
            assert all(np.isfinite(v) for v in
                       payload["parity_max_abs_err"].values())
            payloads.append(payload)
    launches, by_instance = _launch_counters(), _instance_launches()
    _check_launches(launches, by_instance, SUITE_KERNELS, "filter suite",
                    on_card)
    return {"launches": launches, "payloads": payloads}


def run_isax(*, n: int = 1_000_000, m: int = 256, n_queries: int = 256,
             n_brute: int = 64, leaf_capacity: int = 256,
             n_global: int = 600, n_local: int = 200, epochs: int = 300,
             device: str = "cuda", captured: dict | None = None,
             series: np.ndarray | None = None) -> dict:
    """Build an iSAX index with float32 filters, requantize it to bfloat16
    and int8, and answer query batches with each payload; asserts exact ==
    brute force and (on the card) that all six kernels launched."""
    import torch
    from repro_torch.core import build, filter_training

    series = make_series(n, m) if series is None else series
    cfg = build.LeaFiConfig(
        backbone="isax", word_len=8, leaf_capacity=leaf_capacity,
        t_filter_over_t_series=20.0, n_global=n_global, n_local=n_local,
        train=filter_training.TrainConfig(epochs=epochs))
    queries, targets = _query_setup(series, n_queries)

    on_card = torch.device(device).type == "cuda"
    if on_card:
        _phase_memory("isax ")
    captured = {} if captured is None else captured
    _zero_counters()
    with capture_largest_inputs(captured):
        lfi, _ = _build(series, cfg, device, "isax ", on_card)
        sizes = lfi.index.leaf_size.cpu().numpy()
        log(f"isax leaves: {int((sizes > leaf_capacity).sum())} above "
            f"capacity {leaf_capacity}; median size {np.median(sizes):.0f}")
        indexes = {"float32": lfi}
        for payload in PAYLOADS[1:]:
            t0 = time.perf_counter()
            indexes[payload] = build.requantize_leafi(lfi, payload,
                                                      device=device)
            _sync(device)
            log(f"isax requantize to {payload}: "
                f"{time.perf_counter() - t0:.2f} s")

        results = {}
        lfi.search(queries, k=1, quality_target=None, device=device)  # warm
        for payload, index in indexes.items():
            for k in (1, 5):
                for name, target in targets.items():
                    _sync(device)
                    t0 = time.perf_counter()
                    r = index.search(queries, k=k, quality_target=target,
                                     device=device)
                    _sync(device)
                    results[(payload, k, name)] = (
                        r, time.perf_counter() - t0)
    launches, by_instance = _launch_counters(), _instance_launches()

    for (payload, k, name), (r, wall) in results.items():
        exact = results[(payload, k, "exact")][0]
        ref32 = results[("float32", k, name)][0]
        assert r.dists.shape == (n_queries, k), r.dists.shape
        assert np.isfinite(r.dists).all(), f"non-finite dists {payload} {k}"
        d_pruning = r.pruning_ratio.mean() - ref32.pruning_ratio.mean()
        same = float((r.ids == ref32.ids).all(1).mean())
        log(_search_line(f"isax payload={payload:8s} k={k} "
                         f"target={name:9s}", r, exact, wall, n_queries)
            + f" vs float32: pruning {d_pruning:+.4f}, same ids {same:.4f}")
    for payload, index in indexes.items():
        _calib_recall_line(f"isax payload={payload:8s} ", index, device)

    _brute_force_check(lfi, queries, [results[(p, 5, "exact")][0]
                                      for p in PAYLOADS],
                       n_brute, "isax ")
    _check_launches(launches, by_instance, ISAX_KERNELS, "iSAX", on_card)
    _check_build_launches(launches, lfi, "isax ", on_card)
    return {"launches": launches, "results": results, "lfi": lfi,
            "queries": queries}


def _kernel_name(name: str) -> str:
    """A device event's kernel name without ``void``, the anonymous
    namespace the port's kernels live in (and the candidate pass's
    ``staged`` namespace within it), template arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.removeprefix("staged::").split("<")[0].split("(")[0]


def search_breakdown(lfi, queries: np.ndarray, k: int = 5,
                     target: float = 0.99, reps: int = 5,
                     label: str = "") -> dict:
    """Where one search batch's time goes (default impl): host clock around
    a device synchronize for each layer, the layers timed in turn within
    each of ``reps`` rounds (host-side noise hits them alike), medians;
    then one profiled batch for the device's busy time and kernel count."""
    import torch
    from repro_torch.core import bounds, engine, search

    idx = lfi.index
    dev = idx.device
    q = torch.as_tensor(queries, device=dev)
    d_lb = bounds.lower_bounds(idx, q)
    offsets = lfi.tuner.offsets(target)
    d_F = search.predictions_for_all_leaves(idx, lfi.filter_params,
                                            lfi.leaf_ids, q, offsets)
    # the replay and the candidate pass alone, on the inputs the engine
    # hands them for this batch (the pass: its survivors, not the probe)
    Q, L = d_lb.shape
    replay_args, pass_args = [], []
    run_replay, run_pass = engine.replay_cascade, engine._bucket_leaf_topk
    engine.replay_cascade = lambda *a, **kw: (
        replay_args.append((a, kw)) or run_replay(*a, **kw))
    engine._bucket_leaf_topk = lambda *a, **kw: (
        (a[11] and pass_args.append(a)) or run_pass(*a, **kw))
    try:
        engine.run_cascade(idx.series, idx.leaf_start, idx.leaf_size, q, d_lb,
                           d_F, k=k, max_leaf=idx.max_leaf_size)
    finally:
        engine.replay_cascade = run_replay
        engine._bucket_leaf_topk = run_pass
    if torch.device(dev).type == "cuda":
        _hold_leaf_topk(pass_args[0], f"{label}leaf_topk (the k={k}, "
                        f"{target} batch's survivor pass)")
        # the replay alone at this batch's call: held, its chain, its time
        from repro_torch.kernels.replay import kernel as replay_kernel
        args, kw = replay_args[0]
        args = args[:2] + tuple(t.contiguous() for t in args[2:5]) + args[5:]
        call = f"{label}replay (the k={k}, {target} batch's call)"
        held = _hold_replay(args, call, **kw)
        _replay_timed_call(args)
        _replay_chain(args, call)
        graph = _graph_ms(lambda: replay_kernel.replay_cascade_cuda(*args,
                                                                    **kw))
        log(f"kernel {call} ({held['instance']}): {graph:.4f} ms replayed "
            "from a CUDA graph")
        _replay_instance_times(args, call)
    layers = {
        "search": lambda: lfi.search(queries, k=k, quality_target=target,
                                     device=dev),
        "lower_bounds": lambda: bounds.lower_bounds(idx, q),
        "predictions": lambda: search.predictions_for_all_leaves(
            idx, lfi.filter_params, lfi.leaf_ids, q, offsets),
        "engine": lambda: engine.run_cascade(
            idx.series, idx.leaf_start, idx.leaf_size, q, d_lb, d_F, k=k,
            max_leaf=idx.max_leaf_size),
        "replay": lambda: engine.replay_cascade(*replay_args[0][0],
                                                **replay_args[0][1]),
        "candidate pass": lambda: engine._bucket_leaf_topk(*pass_args[0]),
    }
    times: dict = {name: [] for name in layers}
    for _ in range(reps):
        for name, fn in layers.items():
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
    ms = {name: float(np.median(v)) for name, v in times.items()}
    log(f"{label}breakdown k={k} target={target} (median of {reps} rounds, ms): "
        f"search {ms['search']:.1f} [runs "
        f"{', '.join(f'{t:.0f}' for t in times['search'])}] = lower bounds "
        f"{ms['lower_bounds']:.2f} + filter predictions "
        f"{ms['predictions']:.2f} + engine {ms['engine']:.1f} [runs "
        f"{', '.join(f'{t:.0f}' for t in times['engine'])}] (of which the "
        f"candidate pass over {int(pass_args[0][5].sum())} (query, leaf) "
        f"pairs {ms['candidate pass']:.2f} and the cascade replay over L={L} "
        f"positions {ms['replay']:.2f}) + rest")

    def timed_search() -> float:
        t0 = time.perf_counter()
        lfi.search(queries, k=k, quality_target=target, device=dev)
        _sync(dev)
        return (time.perf_counter() - t0) * 1e3

    _sync(dev)
    wall, kernels, by_name, marks = _profile_bracketed(
        timed_search, dev, PROFILE_EDGES_S[0])
    whole = min(marks) > 0
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    edges = (f"whole: {marks[0]} and {marks[1]} of {MARKER_PAD + 1} "
             "markers before and after" if whole
             else f"lost events at its edges: markers {marks}")
    if kernels:
        log(f"{label}profiled search: wall {wall:.1f} ms under the profiler "
            f"(the profile {edges}), "
            f"{len(kernels)} kernel launches, device busy {busy:.1f} ms: "
            f"idle share {1 - busy / wall:.3f} of the profiled batch, "
            f"{1 - busy / ms['search']:.3f} of the unprofiled median; top "
            f"kernels (ms, launches): " + "; ".join(
                f"{name} {t:.2f} ({n})" for name, (t, n) in top))
    else:
        log(f"{label}profiled search: the profiler recorded no kernel events; "
            "device busy time not measured")
    # the candidate pass alone, twice: one launch of its kernel each (the
    # counter and, where the profiler recorded the device, its events),
    # beside the sort of its pair order, and none of the gathers, GEMVs and
    # row sorts the pass ran as before the kernel
    for attempt, edge in enumerate(PROFILE_EDGES_S, 1):
        _sync(dev)
        counters, instances = _launch_counters(), _instance_launches()
        _, _, alone, marks = _profile_bracketed(
            lambda: [engine._bucket_leaf_topk(*pass_args[0])
                     for _ in range(2)], dev, edge)
        whole = min(marks) > 0
        launched = {n: c - counters[n] for n, c in _launch_counters().items()
                    if c != counters[n]}
        launched_by = {n: c - instances[n]
                       for n, c in _instance_launches().items()}
        if not alone or whole:
            break
        log(f"{label}candidate pass alone: the profile holds {marks[0]} and "
            f"{marks[1]} of its {MARKER_PAD + 1} markers before and after "
            f"the passes, so it lost events at its edges (attempt "
            f"{attempt} of {len(PROFILE_EDGES_S)}, {edge} s at the edges): "
            + json.dumps({n: c for n, (_, c) in alone.items()}))
    else:
        raise AssertionError(f"no profile of the candidate pass was whole "
                             f"in {len(PROFILE_EDGES_S)} attempts")
    log(f"{label}candidate pass alone, twice (the profile holds "
        f"{marks[0]} and {marks[1]} of its {MARKER_PAD + 1} markers before "
        f"and after the passes): launches by counter "
        f"{json.dumps(launched)} (by instance {json.dumps(launched_by)}); "
        "profiled (ms, launches) "
        + (json.dumps({n: [round(t, 4), c] for n, (t, c) in alone.items()})
           if alone else "no kernel events recorded"))
    if torch.device(dev).type == "cuda":
        assert launched == {"leaf_topk": 2}, launched
        assert launched_by == {"wgmma": 2, "warp": 0}, launched_by
        assert not alone or (
            alone.get("leaf_topk_wgmma_kernel", (0.0, 0))[1] == 2
            and "leaf_topk_kernel" not in alone
            and not any(bad in n for n in alone
                        for bad in EAGER_PASS_KERNELS)), \
            f"the candidate pass launched {alone}"
        log(f"{label}candidate pass alone: the item table's and the "
            "order's torch ops (launches over the two passes): "
            + json.dumps({n: c for n, (_, c) in alone.items()
                          if n != "leaf_topk_wgmma_kernel"}))
    return {**ms, "profiled_wall_ms": wall, "profile_whole": whole,
            "device_busy_ms": busy if kernels else None,
            "kernel_launches": len(kernels),
            "pass_kernels": {n: c for n, (_, c) in alone.items()}}


def _profile_bracketed(fn, dev, edge: float) -> tuple:
    """``fn()`` run under ``torch.profiler`` between marker kernels
    (``MARKER_KERNEL``): ``MARKER_PAD`` short ones and a long one before
    it, the stream synchronized after them, and as many after ``fn``, with
    the host idle for ``edge`` seconds at the profile's edges.  Returns
    ``fn``'s result, its device events and, by short name, (ms, launches),
    both without the markers, and the markers the profile holds before and
    after them (the profile is whole where both are above 0: its first and
    its last device event are markers).  The profiler can lose the device
    events at a profile's edges; the stream runs in order, so a whole
    profile holds every kernel ``fn`` launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(dev).type == "cuda"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(edge)
        if cuda:
            for cycles in [1000] * MARKER_PAD + [MARKER_CYCLES]:
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
        out = fn()
        if cuda:
            for cycles in [MARKER_CYCLES] + [1000] * MARKER_PAD:
                torch.cuda._sleep(cycles)
        _sync(dev)
        time.sleep(edge)
    events, _ = _device_kernels(prof)
    events.sort(key=lambda e: e.time_range.start)
    marker = [MARKER_KERNEL in _kernel_name(e.name) for e in events]
    work = [i for i, m in enumerate(marker) if not m]
    before = work[0] if work else sum(marker)
    after = len(events) - 1 - work[-1] if work else 0
    kernels = [events[i] for i in work]
    return out, kernels, _by_name(kernels), (before, after)


def _device_kernels(prof) -> tuple:
    """A profile's device kernel events and, by short name, (ms, launches)."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernels, _by_name(kernels)


def _by_name(kernels: list) -> dict:
    """Device kernel events by short name: (ms, launches)."""
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(_kernel_name(e.name), (0.0, 0))
        by_name[_kernel_name(e.name)] = (t + e.time_range.elapsed_us() / 1e3,
                                         n + 1)
    return by_name


#: the functions ``collect_training_data`` reaches, timed by
#: ``collect_breakdown``: (step, module path, attribute)
COLLECT_STEPS = (
    ("global queries", "repro_torch.core.filter_training",
     "make_noisy_queries"),
    ("nodewise_nn_distances", "repro_torch.core.filter_training",
     "nodewise_nn_distances"),
    ("lower bounds", "repro_torch.core.bounds", "lower_bounds"),
    ("local queries", "repro_torch.core.filter_training",
     "make_local_queries"),
    ("local_nn_distances", "repro_torch.core.filter_training",
     "local_nn_distances"),
    ("gather", "repro_torch.kernels.l2_scan.ops", "gather_leaf_slabs"),
    ("pairwise_l2", "repro_torch.kernels.l2_scan.ops", "shared_slab_l2"),
    ("slab_l2", "repro_torch.kernels.l2_scan.ops", "slab_l2"),
    ("masked min", "repro_torch.kernels.l2_scan.ops", "slab_masked_min"))


def collect_breakdown(lfi, label: str = "") -> dict:
    """Where the build's ``t_collect`` goes.  ``filter_training.
    collect_training_data`` is called twice on the built index, warm, with
    the build's generator seed (so the same queries): once as it is, then
    with each function of ``COLLECT_STEPS`` wrapped in a host-clock timer
    around a device synchronize.  A call inside one of the two sweeps is
    filed under the sweep (``nodewise_nn_distances/gather``); the sweep's
    ``rest`` is what it spends outside the wrapped calls (the all-leaves
    masked minimum, which the engine computes inline, and the chunk loop).
    The wrappers' synchronizations make the timed call slower than the
    plain one; both are printed."""
    import torch
    from repro_torch.core import filter_training

    idx, cfg = lfi.index, lfi.config
    dev = idx.device
    times: dict = {}
    within: list = []

    def call():
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        _sync(dev)
        t0 = time.perf_counter()
        filter_training.collect_training_data(idx, lfi.leaf_ids, cfg.n_global,
                                              cfg.n_local, gen)
        _sync(dev)
        return time.perf_counter() - t0

    def timed(step, fn):
        def wrapped(*args, **kw):
            key = "/".join(within[-1:] + [step])
            within.append(step)
            _sync(dev)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                _sync(dev)
                times[key] = times.get(key, 0.0) + time.perf_counter() - t0
                within.pop()
        return wrapped

    plain = call()
    saved = []
    for step, module, attr in COLLECT_STEPS:
        mod = importlib.import_module(module)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timed(step, getattr(mod, attr)))
    try:
        wrapped_call = call()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    for sweep in ("nodewise_nn_distances", "local_nn_distances"):
        inner = sum(v for k, v in times.items()
                    if k.startswith(sweep + "/"))
        times[f"{sweep}/rest"] = times[sweep] - inner
    ms = {k: round(v * 1e3, 3) for k, v in times.items()}
    ms.update({"timed call": round(wrapped_call * 1e3, 3),
               "plain call": round(plain * 1e3, 3)})
    log(f"{label}t_collect breakdown (ms, warm, synchronized per step): "
        + json.dumps(ms) + "; the build's cold t_collect "
        f"{lfi.build_report['t_collect'] * 1e3:.3f}")
    return ms


class _StopTraining(Exception):
    """Ends ``training_profile``'s run after its measured window."""


def _training_data(lfi):
    """The index's training inputs as its build drew them: the training
    data collected again with the build's seed (the same queries), less the
    calibration split, the build's training config, and the generator in
    the state the build's ``train_filters`` found it (the same initial
    weights and minibatch draws follow)."""
    import dataclasses

    import torch
    from repro_torch.core import filter_training
    idx, cfg = lfi.index, lfi.config
    gen = torch.Generator(device=idx.device).manual_seed(cfg.seed)
    data = filter_training.collect_training_data(
        idx, lfi.leaf_ids, cfg.n_global, cfg.n_local, gen)
    n_cal = len(lfi.calib.queries)                # build_leafi's split
    data = dataclasses.replace(
        data, global_queries=data.global_queries[:-n_cal],
        global_d_L=data.global_d_L[:-n_cal],
        global_d_lb=data.global_d_lb[:-n_cal])
    return data, dataclasses.replace(cfg.train, hidden=cfg.hidden), gen


def training_profile(lfi, label: str = "", skip: int = 50,
                     window: int = 50) -> dict:
    """Where a filter-training step's time goes.  ``train_filters`` runs on
    the built index's training data (``_training_data``: the build's data,
    split, step count and draws) and stops after ``skip`` + 2 x ``window``
    steps: steps ``skip`` .. ``skip + window`` are timed on the host clock
    around a synchronize (the step's wall), the next ``window`` under
    ``torch.profiler`` (device-busy time, launches and the top device
    operations per step).  The validation pass every ``n_steps // 20``
    steps falls into each window about as often as in the build.  The
    state at step ``skip`` (parameters, velocities, inputs) and the timed
    window's draws are returned under ``state`` for ``hold_training``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import filter_training

    dev = lfi.index.device
    data, cfg_train, gen = _training_data(lfi)
    n_steps = cfg_train.epochs * max(
        (data.global_queries.shape[0] + data.local_queries.shape[1])
        // cfg_train.batch, 1)
    if n_steps <= skip + 2 * window:
        raise ValueError(f"the build trains {n_steps} steps, fewer than the "
                         f"profile's {skip + 2 * window + 1}")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks: dict = {}
    state: dict = {}
    step = [0]
    step_fn = filter_training.sgd_step

    def counted_step(tp, vel, inp, ig, il, lr, momentum):
        i = step[0]
        if i == skip:
            state.update(tp={k: v.clone() for k, v in tp.items()},
                         vel={k: v.clone() for k, v in vel.items()},
                         inp=inp, momentum=momentum, draws=[], step=i)
        if skip <= i < skip + window:
            state["draws"].append((ig, il, lr))
        if i in (skip, skip + window, skip + 2 * window):
            _sync(dev)
            marks[i] = time.perf_counter()
        if i == skip + window:
            prof.start()
        if i == skip + 2 * window:
            prof.stop()
            raise _StopTraining
        step[0] += 1
        return step_fn(tp, vel, inp, ig, il, lr, momentum)

    filter_training.sgd_step = counted_step
    try:
        filter_training.train_filters(lfi.index, data, cfg_train, gen)
    except _StopTraining:
        pass
    finally:
        filter_training.sgd_step = step_fn
    wall = (marks[skip + window] - marks[skip]) / window * 1e3
    profiled_wall = (marks[skip + 2 * window]
                     - marks[skip + window]) / window * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / window
    by_name: dict = {}
    for e in kernels:
        short = _kernel_name(e.name)
        by_name[short] = by_name.get(short, 0.0) \
            + e.time_range.elapsed_us() / 1e3 / window
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"F": len(lfi.leaf_ids), "steps_in_build": n_steps,
           "wall_ms_per_step": wall,
           "profiled_wall_ms_per_step": profiled_wall,
           "device_busy_ms_per_step": busy if kernels else None,
           "idle_share": 1 - busy / wall if kernels else None,
           "launches_per_step": len(kernels) / window,
           "top_ms_per_step": dict(top)}
    log(f"{label}training profile (F={out['F']}, steps {skip}..{skip + window}"
        f" timed, {skip + window}..{skip + 2 * window} profiled, of the "
        f"build's {n_steps}): " + json.dumps(out))
    return {**out, "state": state}


def _train_from(state: dict, step, n: int) -> tuple:
    """(parameters, velocities, ms a step) after ``n`` steps taken by
    ``step`` from a copy of ``state`` (``training_profile``'s) with its
    draws; the steps timed on the host clock between two synchronizes."""
    tp = {k: v.clone() for k, v in state["tp"].items()}
    vel = {k: v.clone() for k, v in state["vel"].items()}
    dev = tp["w1"].device
    _sync(dev)
    t0 = time.perf_counter()
    for ig, il, lr in state["draws"][:n]:
        step(tp, vel, state["inp"], ig, il, lr, state["momentum"])
    _sync(dev)
    return tp, vel, (time.perf_counter() - t0) / n * 1e3


def _step_args(state: dict) -> tuple:
    """``train_backward_sgd``'s call for the first step of ``state``'s
    window: the state before it, the plain forward pass's dpred, lr and
    momentum (what ``_errors`` and ``_flip_room`` read)."""
    from repro_torch.kernels.filter_train import ref as train_ref
    tp, vel, inp = state["tp"], state["vel"], state["inp"]
    ig, il, lr = state["draws"][0]
    params = tuple(tp[k] for k in train_ref.TRAINABLE)
    dpred = train_ref.train_forward(*params, inp.xg, inp.xl, ig, il, inp.ygz,
                                    inp.ylz, inp.vg, inp.vl, inp.w_g)
    return (params + tuple(vel[k] for k in train_ref.TRAINABLE)
            + (inp.xg, inp.xl, ig, il, dpred, lr, state["momentum"],
               inp.xg_lo, inp.xl_lo))


def _tf32(fn, *args):
    """``fn(*args)`` with TF32 matmuls allowed (the controls)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return fn(*args)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def hold_training(state: dict, label: str = "") -> dict:
    """The training kernels against the plain step on a build's own state
    and draws (``training_profile``'s): one step, every parameter and
    velocity within ``train_backward_sgd``'s limit (``_errors``); then the
    window's steps from the same state, the two sets' predictions on the
    validation rows within ``STEPS_DZ_LIMIT`` (z units).  A TF32 run of the
    plain step is read against both as the control.  The plain step is
    ``filter_train/ref.autograd_step``, what the CPU path runs."""
    from repro_torch.core import filter_training
    from repro_torch.kernels.filter_mlp import ref as mlp_ref
    from repro_torch.kernels.filter_train import ref as train_ref
    kernel_step, plain_step = filter_training.sgd_step, \
        train_ref.autograd_step
    _, _, (atol, rtol), _ = KERNELS["train_backward_sgd"]
    names = [p + k for p in ("", "v_") for k in train_ref.TRAINABLE]
    args = _step_args(state)

    def flat(trained):
        return [trained[i][k] for i in (0, 1) for k in train_ref.TRAINABLE]
    want = flat(_train_from(state, plain_step, 1))
    got = _errors("train_backward_sgd",
                  flat(_train_from(state, kernel_step, 1)), want, args)
    tf32 = _errors("train_backward_sgd", flat(_tf32(
        _train_from, state, plain_step, 1)), want, args)
    step_errs = {n: {**e, "tf32": t} for n, e, t in zip(names, got, tf32)}
    verdict = "would accept" if all(map(_within, tf32)) else "rejects"
    log(f"{label}training, one step from step {state['step']} of the "
        f"build's state, kernels vs plain (each velocity within {atol:g} + "
        f"{rtol:g} x max|plain| or, v_w1 and v_b1, beyond it by no more than "
        f"relu flips move it; each parameter bitwise p - lr·v of its own "
        f"velocity): {_train_summary(got)}; a TF32 run of the plain step, "
        f"which the limit {verdict}: {_train_summary(tf32)}")
    bad = [n for n, e in zip(names, got) if not _within(e)]
    assert not bad, f"{label}training step disagrees in {bad}"
    n = len(state["draws"])
    got, _, kernel_ms = _train_from(state, kernel_step, n)
    want, _, plain_ms = _train_from(state, plain_step, n)
    control, _, _ = _tf32(_train_from, state, plain_step, n)
    inp = state["inp"]
    val = inp.xg[inp.vg > 0]

    def z(trained):
        return mlp_ref.filter_predict(*(trained[k]
                                        for k in train_ref.TRAINABLE), val)
    dz = (z(got) - z(want)).abs().max().item()
    dz_tf32 = (z(control) - z(want)).abs().max().item()
    verdict = "would accept" if dz_tf32 <= STEPS_DZ_LIMIT else "rejects"
    log(f"{label}training, {n} steps from the same state: max |dz| on the "
        f"{val.shape[0]} validation rows {dz:.3g} (limit "
        f"{STEPS_DZ_LIMIT:g}), a TF32 run of the plain step {dz_tf32:.3g} "
        f"(which the limit {verdict}); "
        f"a step {kernel_ms:.3f} ms by the kernels, {plain_ms:.3f} ms by the "
        "plain step (host clock, no validation pass)")
    assert dz <= STEPS_DZ_LIMIT, f"{label}training drifts from the plain step"
    return {"one_step": step_errs, "steps": n, "max_dz": dz,
            "max_dz_tf32": dz_tf32, "kernel_ms_per_step": kernel_ms,
            "plain_ms_per_step": plain_ms}


def _retrain(lfi, step) -> tuple:
    """The index's filters trained again on the build's own data, initial
    weights and draws, each step taken by ``step``: (parameters, mean
    val_rmse_z)."""
    from repro_torch.core import filter_training
    data, cfg_train, gen = _training_data(lfi)
    saved = filter_training.sgd_step
    filter_training.sgd_step = step
    try:
        params, report = filter_training.train_filters(lfi.index, data,
                                                       cfg_train, gen)
    finally:
        filter_training.sgd_step = saved
    return params, float(report["val_rmse_z"].mean())


def _retrained(lfi, step):
    """``_retrain``'s index, its tuners refit on the calibration split, and
    that training's mean val_rmse_z."""
    import dataclasses

    from repro_torch.core import build, filters
    params, rmse = _retrain(lfi, step)
    params = filters.quantize_mlp(params, lfi.config.weight_dtype)
    other = build.requantize_leafi(
        dataclasses.replace(lfi, filter_params=params),
        lfi.config.weight_dtype, device=lfi.index.device)
    return other, rmse


#: the paper's collections the datasets phase builds, at their own widths
DATASETS = ("deep", "sift")


def run_datasets(*, n: int = 200_000, n_queries: int = 64,
                 leaf_capacity: int = 256, n_global: int = 600,
                 n_local: int = 200, epochs: int = 300,
                 device: str = "cuda") -> dict:
    """DSTree builds of the deep- and sift-like collections at their own
    widths (m = 96 and 128; ``n`` series, numpy seed 0), ``n_queries``
    queries exact and at 0.99, k = 1 and 5: build phases, F, pruning,
    recall; asserts exact == brute force and (on the card) that the build
    ran both training kernels at every step.  Each index's filters are then
    trained again with the plain step on the card (the same data, initial
    weights and draws): the mean val_rmse_z of the two trainings within
    ``TRAINING_RMSE_LIMIT`` of each other (relative) and the trained
    filters' raw predictions on the queries within ``TRAINING_DZ_LIMIT``,
    recall@1 at 0.99 of both indexes printed; and a third time with TF32
    allowed, whose readings are printed beside as the control."""
    import torch
    from repro_torch.core import build, filter_training
    from repro_torch.data.series import make_series_dataset
    from repro_torch.kernels.filter_mlp import ref as mlp_ref
    from repro_torch.kernels.filter_train import ref as train_ref
    on_card = torch.device(device).type == "cuda"
    out = {}
    for name in DATASETS:
        t0 = time.perf_counter()
        series = make_series_dataset(name, n)
        log(f"data: {name} {n} x {series.shape[1]} in "
            f"{time.perf_counter() - t0:.2f} s")
        cfg = build.LeaFiConfig(
            backbone="dstree", leaf_capacity=leaf_capacity,
            t_filter_over_t_series=20.0, n_global=n_global, n_local=n_local,
            train=filter_training.TrainConfig(epochs=epochs))
        queries, _ = _query_setup(series, n_queries)
        _zero_counters()
        lfi, _ = _build(series, cfg, device, f"{name} ", on_card)
        results = {}
        for k in (1, 5):
            for tname, target in (("exact", None), ("0.99", 0.99)):
                _sync(device)
                t0 = time.perf_counter()
                r = lfi.search(queries, k=k, quality_target=target,
                               device=device)
                _sync(device)
                results[(k, tname)] = (r, time.perf_counter() - t0)
        launches = _launch_counters()
        by_instance = _instance_launches()
        for (k, tname), (r, wall) in results.items():
            assert r.dists.shape == (n_queries, k), r.dists.shape
            assert np.isfinite(r.dists).all(), f"non-finite dists {name}"
            log(_search_line(f"{name} k={k} target={tname:5s}", r,
                             results[(k, "exact")][0], wall, n_queries))
        _brute_force_check(lfi, queries, [results[(k, "exact")][0]
                                          for k in (1, 5)],
                           n_queries, f"{name} ")
        _check_launches(launches, by_instance, DSTREE_KERNELS, name,
                        on_card)
        _check_build_launches(launches, lfi, f"{name} ", on_card)

        t0 = time.perf_counter()
        plain, plain_rmse = _retrained(lfi, train_ref.autograd_step)
        _sync(device)
        t_plain = time.perf_counter() - t0
        tf32_params, tf32_rmse = _tf32(_retrain, lfi, train_ref.autograd_step)
        kernel_rmse = lfi.build_report["val_rmse_z"]
        rel, rel_tf32 = (abs(r / plain_rmse - 1) for r in (kernel_rmse,
                                                           tf32_rmse))
        verdict = ("would accept" if rel_tf32 <= TRAINING_RMSE_LIMIT
                   else "rejects")
        q = torch.as_tensor(queries, dtype=torch.float32, device=device)

        def z(params, q=q):
            return mlp_ref.filter_predict(*(params[k] for k in
                                            train_ref.TRAINABLE), q)
        z_plain = z(plain.filter_params)
        dz, dz_tf32 = ((z(p) - z_plain).abs().max().item()
                       for p in (lfi.filter_params, tf32_params))
        dz_verdict = ("would accept" if dz_tf32 <= TRAINING_DZ_LIMIT
                      else "rejects")
        recall = {}
        for which, index in (("kernels", lfi), ("plain", plain)):
            r = index.search(queries, k=1, quality_target=0.99,
                             device=device)
            recall[which] = _recall(r.ids, results[(1, "exact")][0].ids)
            _calib_recall_line(f"{name} trained by the {which} step: ",
                               index, device)
        log(f"{name} training, kernels vs the plain step on the card (same "
            f"data, weights and draws): mean val_rmse_z {kernel_rmse!r} vs "
            f"{plain_rmse!r} (relative difference {rel:.3g}, limit "
            f"{TRAINING_RMSE_LIMIT:g}); a TF32 run of the plain training "
            f"{tf32_rmse!r} ({rel_tf32:.3g}, which the limit {verdict}); "
            f"the trained filters' max |dz| on the {n_queries} queries "
            f"{dz:.3g} (limit {TRAINING_DZ_LIMIT:g}), the TF32 run's "
            f"{dz_tf32:.3g} (which the limit {dz_verdict}); recall@1 at 0.99 on the {n_queries} queries "
            f"{recall['kernels']:.4f} vs {recall['plain']:.4f}; the plain "
            f"training and refit took {t_plain:.2f} s against the build's "
            f"t_train {lfi.build_report['t_train']:.2f} s")
        assert rel <= TRAINING_RMSE_LIMIT and dz <= TRAINING_DZ_LIMIT, \
            f"{name}: kernel-trained filters differ from plain-trained"
        out[name] = {"launches": launches, "lfi": lfi,
                     "val_rmse_z": (kernel_rmse, plain_rmse, tf32_rmse),
                     "max_dz": (dz, dz_tf32),
                     "recall_at_0.99": recall}
    return out


def _reps(bound_ms: float, budget_ms: float = 200.0) -> int:
    """Timed calls for a kernel whose bound is ``bound_ms``: 20, fewer
    where 20 would pass ``budget_ms`` of bound (the CNN and LSTM filters'
    calibration call takes ~1 s; at least one)."""
    return max(1, min(20, int(budget_ms / max(bound_ms, 1e-9))))


def _time_ms(fn, reps: int = 20) -> float:
    import torch
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


def _graph_ms(fn, reps: int = 20) -> float:
    """Per-call device time of ``reps`` calls captured in one CUDA graph:
    the replay launches them back to back, so unlike ``_time_ms`` no
    host-side work (checks, ctypes) sits between two kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(name: str, args, passes: int | None = None) -> tuple:
    """(least ms, "bytes"|"operations") for one call: every input read once,
    every output written once, against the H100's HBM rate and its float32
    CUDA-core peak, or, given ``passes``, ``passes`` times the operations
    at its TF32 tensor-core peak: with the split design's passes (3, or 2
    for bf16/int8 weights) the bound of that design, with 1 the function's
    own bound on the tensor cores (``repro_torch.analysis.roofline.H100``).  The filter kernels count
    ``roofline.mlp_operations``, the bound the filter suite uses too."""
    from repro_torch.analysis import roofline
    if name == "pairwise_l2":
        q, s = args
        Q, m = q.shape
        B = s.shape[0]
        flops = 2 * Q * B * m + 2 * (Q + B) * m + 4 * Q * B
        nbytes = 4 * (Q * m + B * m + Q * B)
    elif name == "slab_l2":
        q, s = args
        F, Nq, m = q.shape
        R = s.shape[1]
        flops = F * (2 * Nq * R * m + 2 * (Nq + R) * m + 4 * Nq * R)
        nbytes = 4 * F * (Nq * m + R * m + Nq * R)
    elif name == "box_lb":
        q, lo, _ = args
        Q, d = q.shape
        L = lo.shape[0]
        flops = Q * L * (6 * d + 1)      # 2 sub, 2 max, mul, add; sqrt
        nbytes = 4 * (Q * d + 2 * L * d + Q * L)
    elif name == "replay":
        return _replay_bound(args)
    elif name == "early_walk":
        return _early_bound(args)
    elif name == "leaf_topk":
        return _leaf_topk_bound(args, passes=passes)
    elif name in ("train_forward", "train_backward_sgd"):
        return _train_bound(name, args, passes)
    elif name in ("filter_cnn", "filter_rnn"):
        flops, nbytes = _backbone_work(name, args)
    elif name == "dtw":
        from repro_torch.kernels.dtw import ref as dtw_ref
        q, x, band = args
        return dtw_ref.bound(q.shape[0], x.shape[0], q.shape[1], band)
    elif name == "filter_mlp":           # raw z
        q, w1 = args[0], args[1]
        Q = q.shape[0]
        F, m, h = w1.shape
        flops = roofline.mlp_operations(F, Q, m, h)
        nbytes = 4 * (F * (m * h + 2 * h + 1) + Q * m + F * Q)
    else:                                 # the fused filter MLP, any payload
        q, w1 = args[0], args[1]
        Q = q.shape[0]
        F, m, h = w1.shape
        flops = roofline.mlp_operations(F, Q, m, h)
        n_scales = 2 if w1.dtype.itemsize == 1 else 0
        nbytes = (w1.dtype.itemsize * F * (m * h + h)
                  + 4 * (Q * m + F * (h + 4 + n_scales) + F * Q))
    t_ops = (flops / roofline.H100.peak_flops if passes is None
             else passes * flops / roofline.H100.tf32_flops)
    t_bytes = nbytes / roofline.H100.hbm_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _backbone_work(name: str, args) -> tuple:
    """(operations, bytes) of one CNN or LSTM filter call.  CNN: conv 1
    and conv 2's multiply-adds (2 m K C and 2 m K C^2 a pair), the head's
    2 m C + 2 C; LSTM: a step's 2 x 4h for the input and 3 x 2 h x 4h for
    the recurrences, m steps, the head's 2h (the cells' nonlinearities are
    not counted).  Bytes: the queries and every parameter read once, the
    (F, Q) output written once."""
    q = args[0]
    Q, m = q.shape
    if name == "filter_cnn":
        F, K, _, C = args[1].shape
        flops = F * Q * (2 * m * K * C + 2 * m * K * C * C + 2 * m * C
                         + 2 * C)
        n_params = F * (K * C + K * C * C + C + 3)
    else:
        F, h = args[5].shape
        flops = F * Q * (m * (2 * 4 * h + 3 * 2 * h * 4 * h) + 2 * h)
        n_params = F * (4 * h + 3 * h * 4 * h + h + 3)
    return flops, 4 * (Q * m + n_params + F * Q)


def _train_bound(name: str, args, passes: float | None) -> tuple:
    """The training kernels' bound.  Operations: the layer-1 products and
    the layer-2 multiply-adds (``roofline.mlp_operations`` over the step's
    rows), for the backward pass twice (the recompute and Xᵀ·dpre) plus the
    update's 4 per w1 element; ``passes`` as ``_bound`` (the backward
    design's 2.5: three for the recompute, two for the w1 gradient).
    Bytes: the parameters read once (w1, b1, w2, b2), the distinct rows
    this step gathers, the targets and masks of
    its rows and dpred written; the backward pass reads dpred and reads and
    writes every parameter and velocity instead."""
    from repro_torch.analysis import roofline
    w1, xg, xl, ig, il = (args[0], args[4], args[5], args[6], args[7]) \
        if name == "train_forward" else (args[0],) + tuple(args[8:12])
    F, m, h = w1.shape
    R = ig.numel() + il.numel()
    rows = m * (ig.unique().numel() + F * il.unique().numel())
    n_params = F * (m * h + 2 * h + 1)
    if name == "train_forward":
        flops = roofline.mlp_operations(F, R, m, h)
        nbytes = 4 * (n_params + rows + 3 * F * R) + 8 * R
    else:
        flops = 2 * roofline.mlp_operations(F, R, m, h) + 4 * F * m * h
        nbytes = 4 * (4 * n_params + rows + F * R) + 8 * R
    t_ops = (flops / roofline.H100.peak_flops if passes is None
             else passes * flops / roofline.H100.tf32_flops)
    t_bytes = nbytes / roofline.H100.hbm_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _replay_bound(args) -> tuple:
    """The replay's bytes bound (its operations are comparisons, well
    under the bytes' time): ``ref.bound_bytes`` on this run's data, which
    counts a prediction only where its position's bound does not prune it,
    and the values and ids only of the leaves searched and entering."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels.replay import ref as replay_ref
    leaf_d, _, d_lb, d_F, order, k = args
    nbytes = replay_ref.bound_bytes(leaf_d, d_lb, d_F, order, k)
    return nbytes / roofline.H100.hbm_bw * 1e3, "bytes"


def _early_bound(args, stats: dict | None = None) -> tuple:
    """The early walk's bytes bound (its operations, 3m a row read, sit
    well under the bytes' time): ``ref.bound_bytes`` on this call's data,
    the searched leaves from the plain walk (``stats``, where given, its
    ``stats``)."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels.early_walk import ref as walk_ref
    if stats is None:
        stats = {}
        out = walk_ref.early_walk(*args[:-1], stats=stats)
        stats["visited"] = int(out[3])
    nbytes = walk_ref.bound_bytes(args[2], stats["searched"],
                                  stats["visited"], args[3].shape[0],
                                  args[7])
    return nbytes / roofline.H100.hbm_bw * 1e3, "bytes"


def _leaf_topk_work(args) -> tuple:
    """(pairs, rows the pairs read, distinct rows) of a candidate-pass call:
    this run's survivors (slots below their query's count, leaf id < L)."""
    import torch
    _, leaf_start, leaf_size, _, leaves, counts = args[:6]
    L = leaf_start.shape[0]
    slot = torch.arange(leaves.shape[1], device=leaves.device)
    lf = leaves[(slot < counts[:, None]) & (leaves >= 0) & (leaves < L)]
    return (lf.numel(), int(leaf_size[lf].sum()),
            int(leaf_size[lf.unique()].sum()))


def _leaf_topk_bound(args, per_pair: bool = False,
                     passes: int | None = None) -> tuple:
    """The candidate pass's bound for this run's survivors.  Operations: q·s
    (2m) for every row of every pair, and |s|² (2m) once a distinct row for
    ``matmul``; (s − q)² summed (3m) a row of every pair for ``direct``;
    at the float32 CUDA-core peak, or, given ``passes`` (the ``matmul``
    form, whose products a tensor-core design would run), ``passes`` times
    them at the TF32 tensor-core peak (3: split TF32, float32 accuracy).
    Bytes: the queries, the survivor lists and counts, the leaf table and
    the pairs' kk outputs, and the rows: each distinct row once (a leaf's
    rows read once for every query that keeps it), or, ``per_pair``, every
    pair's rows from HBM (the design that reads them per pair)."""
    from repro_torch.analysis import roofline
    _, leaf_start, _, queries, leaves = args[:5]
    kk, impl = args[6], args[8]
    Q, m = queries.shape
    pairs, pair_rows, distinct = _leaf_topk_work(args)
    flops = (2 * m * (pair_rows + distinct) if impl == "matmul"
             else 3 * m * pair_rows)
    nbytes = (4 * m * (pair_rows if per_pair else distinct) + 4 * Q * m
              + 8 * leaves.numel() + 8 * Q + 16 * leaf_start.shape[0]
              + 12 * kk * pairs)
    t_ops = (flops / roofline.H100.peak_flops if passes is None
             else passes * flops / roofline.H100.tf32_flops)
    t_bytes = nbytes / roofline.H100.hbm_bw
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _leaf_topk_fresh(args, impl: str | None = None) -> tuple:
    """A candidate-pass call's arguments with new output rows (+inf/−1)
    and, given, another distance form."""
    import torch
    out = list(args)
    out[8] = impl or args[8]
    out[9] = torch.full_like(args[9], math.inf)
    out[10] = torch.full_like(args[10], -1)
    return tuple(out)


def _leaf_topk_errors(args, got, want) -> dict:
    """A candidate-pass call's kernel outputs ``got`` against the plain
    version's ``want`` (each (out_d, out_i)): the distances within the
    limit (``max_abs_err`` over the finite ones, ``tolerance`` = atol +
    rtol x their max|plain|), +inf at the same places with id −1 there, no
    row twice in one output row, and the ids equal except at near-ties:
    where they differ (``id_diff`` places), the kernel's row must belong to
    the pair's leaf and its plain-form distance (``gathered_leaf_l2``) lie
    within the limit of the plain version's at that rank (``near_ties``
    counts those that do)."""
    import torch
    from repro_torch.kernels.l2_scan import ops as l2_ops
    series, leaf_start, leaf_size, queries, leaves = args[:5]
    impl, scatter = args[8], args[11]
    atol, rtol = KERNELS["leaf_topk"][2]
    (gd, gi), (wd, wi) = got, want
    fin = torch.isfinite(wd)
    top = wd[fin].abs().max().item() if fin.any() else 0.0
    tol = atol + rtol * top
    err = (gd[fin] - wd[fin]).abs().max().item() if fin.any() else 0.0
    same_inf = bool(torch.equal(fin, torch.isfinite(gd)))
    empty_ids = bool(torch.equal(gi == -1, ~torch.isfinite(gd)))
    diff = gi != wi
    at = diff.nonzero()                            # (n, 3): query, row, rank
    rows = gi[diff]
    L = leaf_start.shape[0]
    leaf = at[:, 1] if scatter else leaves[at[:, 0], at[:, 1]]
    safe = leaf.clamp(0, max(L - 1, 0))
    start = leaf_start[safe]
    inside = ((rows >= start) & (rows < start + leaf_size[safe])
              & (leaf >= 0) & (leaf < L))
    d = l2_ops.gathered_leaf_l2(queries[at[:, 0]],
                                series[rows.clamp(min=0)][:, None, None],
                                impl)[:, 0, 0]
    near = inside & ((d - wd[diff]).abs() <= tol)
    srt = torch.sort(gi, dim=-1).values
    dups = int(((srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] >= 0)).sum())
    return {"max_abs_err": err, "tolerance": tol, "same_inf": same_inf,
            "empty_ids": empty_ids, "id_diff": int(diff.sum()),
            "near_ties": int(near.sum()), "duplicates": dups,
            "ok": bool(same_inf and empty_ids and err <= tol and dups == 0
                       and bool(near.all()))}


def _hold_leaf_topk(args, label: str) -> dict:
    """One candidate-pass call, kernel against plain version on fresh
    output rows each, asserted within ``_leaf_topk_errors``'s limits."""
    import torch
    kernel_fn, plain_fn, _ = _kernel_tables()
    got = kernel_fn["leaf_topk"](*_leaf_topk_fresh(args))
    torch.cuda.synchronize()
    want = plain_fn["leaf_topk"](*_leaf_topk_fresh(args))
    torch.cuda.synchronize()
    e = _leaf_topk_errors(args, got, want)
    pairs, pair_rows, _ = _leaf_topk_work(args)
    which = _leaf_topk_instance(args)
    shapes = (f"{tuple(args[3].shape)} queries x {tuple(args[4].shape)} "
              f"lists, L={args[1].shape[0]}, max_leaf={args[7]}, "
              f"kk={args[6]}, {args[8]}, {pairs} pairs, {pair_rows} rows, "
              f"the {which} instance")
    log(f"kernel {label} at {shapes}: max_abs_err={e['max_abs_err']:.3g} "
        f"(tolerance {e['tolerance']:.3g} absolute = 1e-4 + 1e-5 x "
        f"max|plain|); +inf where plain {e['same_inf']}, id -1 there "
        f"{e['empty_ids']}; ids differ at {e['id_diff']} of "
        f"{args[9].numel()} places, {e['near_ties']} of them near-ties; "
        f"{e['duplicates']} repeated rows")
    assert e["ok"], f"{label} disagrees: {e}"
    return {"shapes": shapes, "instance": which,
            "max_abs_err": e["max_abs_err"], "tolerance": e["tolerance"],
            "id_diff": e["id_diff"], "near_ties": e["near_ties"]}


def _leaf_topk_instance(args) -> str:
    """The candidate-pass instance a call takes (``kernel.instance``)."""
    from repro_torch.kernels.leaf_topk import kernel as leaf_kernel
    return leaf_kernel.instance(args[0], args[3], args[6], args[8], args[11])


def _plain_mlp(q, w1, b1, w2, b2, ym, ys, off, s1=None, s2=None):
    from repro_torch.kernels.filter_mlp import ref as mlp_ref
    return mlp_ref.filter_predict_destd(w1, b1, w2, b2, ym, ys, q, off, s1,
                                        s2)


def _plain_raw_mlp(q, w1, b1, w2, b2):
    from repro_torch.kernels.filter_mlp import ref as mlp_ref
    return mlp_ref.filter_predict(w1, b1, w2, b2, q)


def _kernel_tables():
    """(kernel wrapper, plain version, library call or None) per kernel."""
    import torch
    from repro_torch.kernels.box_lb import kernel as box_kernel
    from repro_torch.kernels.box_lb import ref as box_ref
    from repro_torch.kernels.dtw import kernel as dtw_kernel
    from repro_torch.kernels.dtw import ref as dtw_ref
    from repro_torch.kernels.early_walk import kernel as walk_kernel
    from repro_torch.kernels.early_walk import ref as walk_ref
    from repro_torch.kernels.filter_cnn import kernel as cnn_kernel
    from repro_torch.kernels.filter_cnn import ref as cnn_ref
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    from repro_torch.kernels.filter_rnn import kernel as rnn_kernel
    from repro_torch.kernels.filter_rnn import ref as rnn_ref
    from repro_torch.kernels.filter_train import kernel as train_kernel
    from repro_torch.kernels.filter_train import ref as train_ref
    from repro_torch.kernels.l2_scan import kernel as l2_kernel
    from repro_torch.kernels.l2_scan import ref as l2_ref
    from repro_torch.kernels.leaf_topk import kernel as leaf_kernel
    from repro_torch.kernels.leaf_topk import ref as leaf_ref
    from repro_torch.kernels.replay import kernel as replay_kernel
    from repro_torch.kernels.replay import ref as replay_ref

    mlp = mlp_kernel.fused_filter_mlp_cuda
    kernel_fn = {"pairwise_l2": l2_kernel.pairwise_l2_cuda,
                 "slab_l2": l2_kernel.slab_l2_cuda,
                 "fused_filter_mlp": mlp, "fused_filter_mlp_bf16": mlp,
                 "fused_filter_mlp_int8": mlp,
                 "box_lb": box_kernel.box_lb_cuda,
                 "filter_mlp": mlp_kernel.filter_mlp_cuda,
                 "replay": replay_kernel.replay_cascade_cuda,
                 "train_forward": train_kernel.train_forward_cuda,
                 "train_backward_sgd": train_kernel.train_backward_sgd_cuda,
                 "leaf_topk": leaf_kernel.leaf_topk_cuda,
                 "early_walk": walk_kernel.early_walk_cuda,
                 "filter_cnn": cnn_kernel.cnn_filter_cuda,
                 "filter_rnn": rnn_kernel.lstm_filter_cuda,
                 "dtw": dtw_kernel.dtw_cuda}
    plain_fn = {"pairwise_l2": l2_ref.pairwise_l2_matmul,
                "slab_l2": l2_ref.slab_l2_matmul,
                "fused_filter_mlp": _plain_mlp,
                "fused_filter_mlp_bf16": _plain_mlp,
                "fused_filter_mlp_int8": _plain_mlp,
                "box_lb": box_ref.box_lb,
                "filter_mlp": _plain_raw_mlp,
                "replay": replay_ref.replay_cascade,
                # the kernels' calls end with the rows' low parts
                "train_forward": lambda *a: train_ref.train_forward(*a[:-2]),
                "train_backward_sgd":
                    lambda *a: train_ref.train_backward_sgd(*a[:-2]),
                "leaf_topk": leaf_ref.leaf_topk,
                # the kernel's call ends with max_leaf, which sizes its items
                "early_walk": lambda *a: walk_ref.early_walk(*a[:-1]),
                "filter_cnn": cnn_ref.cnn_filter,
                "filter_rnn": rnn_ref.lstm_filter,
                "dtw": dtw_ref.dtw}
    library_fn = {"pairwise_l2": torch.cdist, "slab_l2": torch.cdist}
    return kernel_fn, plain_fn, library_fn


def _bitwise_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def replay_bound(args):
    """A (Q,) float32 bound for a held replay call (numpy seed 3): each
    row's bound one of its own d_lb values, drawn, so that it lb-prunes
    positions the bsf keeps (a seed prune) or not; +inf where the draw is
    not finite and on every eighth row; NaN on the second row of a call
    with more than 8 (nothing is then lb-pruned: ``torch.minimum``'s and
    ``jnp.minimum``'s NaN)."""
    import torch
    d_lb = args[2].cpu().numpy()
    Q, L = d_lb.shape
    rng = np.random.default_rng(3)
    ub = d_lb[np.arange(Q), rng.integers(0, max(L, 1), Q)] if L else \
        np.full(Q, np.inf)
    ub = np.where(np.isfinite(ub), ub, np.inf).astype(np.float32)
    ub[::8] = np.inf
    if Q > 8:
        ub[1] = np.nan
    return torch.as_tensor(ub, device=args[2].device)


#: the replay kernel's instances by their keywords (``kernel.mode``)
REPLAY_MODES = (("bound", True, False), ("traced", False, True),
                ("traced with a bound", True, True))


def _hold_replay(args, label: str, bsf_ub=None, trace: bool = False,
                 instances: bool = True) -> dict:
    """One replay call as it was made (its bound and trace keywords too),
    its outputs each asserted bitwise equal to the plain loop's; with
    ``instances``, the same call also through the bound instance (a bound
    from :func:`replay_bound`), the traced one and the traced one with
    that bound, each bitwise equal to the plain loop's seven outputs (two
    plain runs: traced without and with the bound)."""
    import torch
    from repro_torch.kernels.replay import kernel as replay_kernel
    kernel_fn, plain_fn, _ = _kernel_tables()
    shapes = (" x ".join(str(tuple(a.shape)) for a in args[:2])
              + f", k={args[5]}")
    which = _replay_instance(args)
    kw = {"bsf_ub": bsf_ub, "trace": trace}
    held = [("as called", kw)]
    if instances:
        ub = replay_bound(args)
        held += [(name, {"bsf_ub": ub if b else None, "trace": t})
                 for name, b, t in REPLAY_MODES]
    plain: dict = {}
    for name, call_kw in held:
        got = kernel_fn["replay"](*args, **call_kw)
        torch.cuda.synchronize()
        key = id(call_kw["bsf_ub"])
        if key not in plain:
            plain[key] = plain_fn["replay"](*args, bsf_ub=call_kw["bsf_ub"],
                                            trace=True)
            torch.cuda.synchronize()
        want = plain[key][:len(got)]
        same = [_bitwise_equal(g, w) for g, w in zip(got, want)]
        mode = replay_kernel.mode(call_kw["bsf_ub"], call_kw["trace"])
        log(f"kernel {label} at {shapes} ({which}; {name}: the {mode} "
            f"instance): bitwise equal per output {same} (tolerance 0: "
            f"{KERNELS['replay'][3]})")
        assert len(got) == len(want) and all(same), \
            f"{label} ({name}) disagrees"
    return {"shapes": shapes, "instance": which, "max_abs_err": 0.0,
            "tolerance": 0.0,
            "instances_held": [name for name, _ in held]}


def _replay_instance_times(args, label: str) -> dict:
    """The replay's plain, bound and traced instances at one call, each
    timed from a CUDA graph in turns (plain, bound, traced, traced with the
    bound, then the same backwards), beside each one's bytes bound
    (``ref.bound_bytes`` with the bound's prunes and the trace's two more
    counters)."""
    from repro_torch.analysis import roofline
    from repro_torch.kernels.replay import kernel as replay_kernel
    from repro_torch.kernels.replay import ref as replay_ref
    ub = replay_bound(args)
    leaf_d, _, d_lb, d_F, order, k = args
    modes = (("plain", None, False),) + tuple(
        (name, ub if b else None, t) for name, b, t in REPLAY_MODES)
    out = {name: {"graph_ms": [], "bound_ms": replay_ref.bound_bytes(
        leaf_d, d_lb, d_F, order, k, bsf_ub=b, trace=t)
        / roofline.H100.hbm_bw * 1e3} for name, b, t in modes}
    for name, b, t in modes + modes[::-1]:
        out[name]["graph_ms"].append(_graph_ms(
            lambda b=b, t=t: replay_kernel.replay_cascade_cuda(
                *args, bsf_ub=b, trace=t)))
    log(f"kernel {label}: the replay's instances from a CUDA graph, in "
        "turns (ms, first and second round; bound ms): " + "; ".join(
            f"{name} [{v['graph_ms'][0]:.4f} / {v['graph_ms'][1]:.4f}] "
            f"({v['bound_ms']:.5f})" for name, v in out.items()))
    return out


def _hold_early(args, label: str, quiet: bool = False) -> dict:
    """One early-walk call, its five outputs (top-k values and ids, the
    searched, visited and filter-pruned counts) each asserted bitwise equal
    to the plain walk's.  Unless ``quiet``, also prints the launch's layout
    (grid, threads, registers, ring) and its time from a CUDA graph beside
    its bound (``ref.bound_bytes``)."""
    import torch
    from repro_torch.kernels.early_walk import kernel as walk_kernel
    from repro_torch.kernels.early_walk import ref as walk_ref
    got = walk_kernel.early_walk_cuda(*args)
    torch.cuda.synchronize()
    stats: dict = {}
    want = walk_ref.early_walk(*args[:-1], stats=stats)
    torch.cuda.synchronize()
    same = [_bitwise_equal(g, w) for g, w in zip(got, want)]
    assert all(same), f"early_walk {label} disagrees: {same}"
    if quiet:
        return {"max_abs_err": 0.0, "tolerance": 0.0}
    series, q, k = args[0], args[3], args[7]
    m = q.shape[0]
    lay = walk_kernel.layout(k, walk_kernel.vectorized(series, q))
    stats["visited"] = int(want[3])
    bound_ms, _ = _early_bound(args, stats)
    graph_ms = _graph_ms(lambda: walk_kernel.early_walk_cuda(*args))
    counts = [int(x) for x in want[2:]]
    shapes = (f"L={args[1].shape[0]}, m={m}, max_leaf={args[8]}, k={k}, "
              f"vectorized={walk_kernel.vectorized(series, q)}")
    log(f"kernel {label} at {shapes} (grid {lay['blocks']} blocks x "
        f"{lay['threads']} threads, {lay['registers']} registers, ring "
        f"{lay['ring']} slots; searched/visited/filter-pruned {counts}): "
        f"bitwise equal per output {same} (tolerance 0: "
        f"{KERNELS['early_walk'][3]}); [{graph_ms:.4f}] ms from a CUDA "
        f"graph, bound {bound_ms:.5f} ms ({bound_ms / graph_ms:.1%})")
    return {"shapes": shapes, "layout": lay, "counts": counts,
            "graph_ms": graph_ms, "bound_ms": bound_ms, "max_abs_err": 0.0,
            "tolerance": 0.0}


def _replay_instance(args) -> str:
    """The replay's launch at a call: a block a row, and the instance the
    C entry picks by kk and k (``kernel.instance``)."""
    from repro_torch.kernels.replay import kernel as replay_kernel
    Q, _, kk = args[0].shape
    return f"{Q} blocks, a row each; {replay_kernel.instance(kk, args[5])}"


def _replay_timed_call(args, batch: bool = True) -> None:
    """A timed call takes the instance whose walk reads shared memory only
    (the top-k in registers, the leaf slots in the ring), and a batch's
    launch puts a block on every SM."""
    import torch
    from repro_torch.kernels.replay import kernel as replay_kernel
    from repro_torch.kernels.replay import ref as replay_ref
    Q, _, kk = args[0].shape
    which = replay_kernel.instance(kk, args[5])
    assert which.startswith("top-k in registers;") and 1 <= kk <= \
        replay_ref.PRE, which
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert not batch or Q >= sms, (Q, sms)


def _replay_chain(args, label: str) -> dict:
    """Per row of a replay call, the ring entries no bsf can drop and the
    leaves that enter the top-k (``ref.chain_lengths``: the walker's serial
    merges, at least), their mean and largest.  The first is a lower bound
    on the entries the kernel's ring takes: stale pre-tests keep more, and
    the kernel, whose C entry is fixed, does not report its own count."""
    from repro_torch.kernels.replay import ref as replay_ref
    leaf_d, _, d_lb, d_F, order, k = args
    entries, entering, _ = replay_ref.chain_lengths(leaf_d, d_lb, d_F,
                                                    order, k)
    out = {"ring_entries_least_mean": entries.float().mean().item(),
           "ring_entries_least_max": int(entries.max().item()),
           "entering_mean": entering.float().mean().item(),
           "entering_max": int(entering.max().item())}
    log(f"kernel {label}: per row of {order.shape[1]} positions, ring "
        f"entries no bsf can drop: mean "
        f"{out['ring_entries_least_mean']:.1f}, largest "
        f"{out['ring_entries_least_max']}; leaves entering the top-k (the "
        f"walker's serial merges, at least): mean "
        f"{out['entering_mean']:.2f}, largest {out['entering_max']}")
    return out


def _scratch(name: str, args) -> tuple:
    """``args`` with the state ``train_backward_sgd`` updates in place (its
    first 8 arguments) cloned, or the candidate pass's output rows new;
    other calls' arguments as they are."""
    if name == "leaf_topk":
        return _leaf_topk_fresh(args)
    if name != "train_backward_sgd":
        return tuple(args)
    return tuple(a.clone() for a in args[:8]) + tuple(args[8:])


def _outputs(name: str, fn, args) -> list:
    """A call's outputs: for ``train_backward_sgd`` the parameters and
    velocities it updates (on clones), else the one output."""
    if name == "train_backward_sgd":
        state = _scratch(name, args)
        fn(*state)
        return list(state[:8])
    return [fn(*args)]


def _flip_room(args) -> dict:
    """For ``train_backward_sgd``'s call ``args``: per element of v_w1 and
    v_b1, the sum of the moves |dpred·w2·x| and |dpred·w2| of the layer-1
    sums (plain float32) within ``FLIP_PRE`` of 0 in its column."""
    import torch
    from repro_torch.kernels.filter_train import ref as train_ref
    w1, b1, w2 = args[:3]
    x = train_ref._rows(*args[8:12])
    pre = torch.bmm(x, w1) + b1[:, None, :]
    scale = torch.bmm(x.abs(), w1.abs()) + b1.abs()[:, None, :]
    move = ((pre.abs() <= FLIP_PRE * scale)
            * (args[12][:, :, None] * w2[:, None, :]).abs())
    return {"v_w1": torch.bmm(x.abs().transpose(1, 2), move),
            "v_b1": move.sum(1)}


def _errors(name: str, got: list, want: list, args=None) -> list:
    """Per output: the max abs error, its tolerance (atol + rtol x the
    output's own max|plain|) and whether it holds (``ok``).  For
    ``train_backward_sgd`` (``args`` its call, with the state before the
    step) the outputs are w1, b1, w2, b2 and their velocities: each
    parameter must equal ``p - lr·v`` of the kernel's own velocity bitwise
    (``own_update``; ``dp_rel`` is max|Δp − Δp_plain| / max|Δp_plain|,
    printed) and within 1e-4 + 1e-5 x its max|plain|, each velocity must
    be within its tolerance or, for v_w1 and
    v_b1, beyond it by no more than ``_flip_room`` (``beyond`` counts those
    elements)."""
    _, _, (atol, rtol), _ = KERNELS[name]
    room = _flip_room(args) if name == "train_backward_sgd" else {}
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        diff, top = (g - w).abs(), w.abs().max().item()
        e = {"max_abs_err": diff.max().item(), "tolerance": atol + rtol * top}
        if name == "train_backward_sgd" and i < 4:
            # and within the form every other kernel is held to
            e["tolerance"] = 1e-4 + 1e-5 * top
            p_old, v = args[i], got[i + 4]
            step = (w - p_old).abs().max().item()
            e.update(own_update=_bitwise_equal(g, p_old - args[13] * v),
                     dp_rel=e["max_abs_err"] / step if step else None)
            e["ok"] = e["own_update"] and e["max_abs_err"] <= e["tolerance"]
        else:
            over = diff - e["tolerance"]
            key = ("v_w1", "v_b1", "v_w2", "v_b2")[i - 4] if room else None
            if key:
                e["beyond"] = int((over > 0).sum().item())
                over = over - room.get(key, 0.0)
            e["ok"] = bool(np.isfinite(e["max_abs_err"])
                           and over.max().item() <= 0)
        out.append(e)
    return out


def _within(e: dict) -> bool:
    return e["ok"]


def _train_summary(errs: list) -> str:
    """train_backward_sgd's per-output readings (error/tolerance), in the
    order of its outputs."""
    names = [p + k for p in ("", "v_") for k in ("w1", "b1", "w2", "b2")]
    parts = []
    for n, e in zip(names, errs):
        part = f"{n} {e['max_abs_err']:.3g}/{e['tolerance']:.3g}"
        if "own_update" in e:
            dp = "n/a" if e["dp_rel"] is None else f"{e['dp_rel']:.3g}"
            own = "bitwise" if e["own_update"] else "WRONG"
            part += f", own update {own}, |Δp − Δp_plain|/max|Δp_plain| {dp}"
        else:
            part += f", {e['beyond']} beyond"
        parts.append(part + ("" if e["ok"] else " OUT"))
    return "; ".join(parts)


def _hold(name: str, args, label: str) -> dict:
    """One kernel call against its plain version, every output asserted
    within the kernel's limit."""
    import torch
    if name == "replay":
        return _hold_replay(args, label)
    if name == "leaf_topk":
        return _hold_leaf_topk(args, label)
    if name == "early_walk":
        return _hold_early(args, label)
    _, _, (atol, rtol), why = KERNELS[name]
    kernel_fn, plain_fn, _ = _kernel_tables()
    got = _outputs(name, kernel_fn[name], args)
    torch.cuda.synchronize()
    want = _outputs(name, plain_fn[name], args)
    torch.cuda.synchronize()
    assert [g.shape for g in got] == [w.shape for w in want]
    if (atol, rtol) == (0.0, 0.0):
        assert all(_bitwise_equal(g, w) for g, w in zip(got, want)), \
            f"{label} is not bitwise equal to its plain version"
    errs = _errors(name, got, want, args)
    # the output nearest its limit
    near = max(errs, key=lambda e: e["max_abs_err"] / max(e["tolerance"],
                                                          1e-30))
    err, tol = near["max_abs_err"], near["tolerance"]
    rel = max(((g - w).abs() / (w.abs() + 1e-6)).max().item()
              for g, w in zip(got, want))
    shapes = " x ".join(str(tuple(a.shape)) for a in args[:2])
    if name.startswith("train"):
        ig, il = args[6:8] if name == "train_forward" else args[10:12]
        shapes += f", {ig.numel()} + {il.numel()} rows"
    each = ("" if len(errs) == 1 else
            f"; per output (error/tolerance): {_train_summary(errs)}")
    log(f"kernel {label} at {shapes}: max_abs_err={err:.3g} "
        f"max_rel_err={rel:.3g} (tolerance {tol:.3g} absolute = "
        f"{atol:g} + {rtol:g} x max|plain|: {why}){each}")
    assert all(_within(e) for e in errs), f"{label} disagrees"
    return {"shapes": shapes, "max_abs_err": err, "tolerance": tol}


def _check_call(name: str, args, label: str, power: str) -> dict:
    """One kernel call held against its plain version, then timed beside
    its bounds."""
    import torch
    held = _hold(name, args, label)
    kernel_fn, plain_fn, library_fn = _kernel_tables()
    if name not in ("box_lb", "replay", "leaf_topk", "early_walk", "dtw") \
            and label == name:
        # what the same check reads for a TF32 run of the plain version
        want = _outputs(name, plain_fn[name], args)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = _errors(name, _outputs(name, plain_fn[name], args), want,
                           args)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        tf32_err = max(e["max_abs_err"] for e in tf32)
        log(f"kernel {name}: a TF32 run of the plain version errs by "
            f"{tf32_err:.3g}, which the limit "
            f"{'would accept' if all(map(_within, tf32)) else 'rejects'}")
    # the training kernels' update runs in place: timed on a copy
    args = _scratch(name, args)
    bound_ms, bound_by = _bound(name, args)
    reps = _reps(bound_ms)
    ms = _time_ms(lambda f=kernel_fn[name], a=args: f(*a), reps=reps)
    graph_ms = _graph_ms(lambda f=kernel_fn[name], a=args: f(*a), reps=reps)
    # the plain replay is a host loop of ~20 launches a position, the plain
    # candidate pass a bucket loop of gathers and sorts (~0.2-0.5 s a batch),
    # the plain walk ~25 launches and a sync a searched leaf; the plain DTW,
    # ~3 launches an in-band cell of a row, takes ~1.8 s at 8 x 1M pairs
    plain_ms = _time_ms(lambda f=plain_fn[name], a=args: f(*a),
                        reps=min(reps, 1 if name == "dtw" else 2 if name in (
                            "replay", "leaf_topk", "early_walk") else 20))
    lib = library_fn.get(name)
    library_ms = (None if lib is None
                  else _time_ms(lambda f=lib, a=args: f(*a)))
    design, passes = DESIGN[name]
    whose = "split design's"
    if name == "leaf_topk" and args[8] == "matmul":
        # the survivor pass's split-TF32 wgmma instance; the probe's warp
        # instance (SIMT) is held against the same bound
        passes = LEAF_TOPK_SPLIT_PASSES
        if _leaf_topk_instance(args) == "warp":
            whose = "a split-TF32 design's"
    split_ms, split_by, tf32_ms, tf32_by = (
        (None,) * 4 if passes is None
        else _bound(name, args, passes) + _bound(name, args, 1))
    tc = ("" if passes is None else
          f", {whose} bound ({passes} TF32 passes) {split_ms:.4f} ms "
          f"by {split_by}, one-pass TF32 bound {tf32_ms:.4f} ms by {tf32_by}")
    library = ("none (no single PyTorch call)" if library_ms is None
               else f"{library_ms:.4f} ms")
    pair_ms, pair_by = ((None, None) if name != "leaf_topk"
                        else _leaf_topk_bound(args, per_pair=True))
    if pair_ms is not None:
        tc += (f", every pair's rows from HBM {pair_ms:.4f} ms by "
               f"{pair_by}")
    log(f"kernel {label} [{design}]: {ms:.4f} ms through the wrapper, "
        f"{graph_ms:.4f} ms replayed from a CUDA graph ({reps} calls; no "
        "host-side "
        f"enqueue), plain {plain_ms:.4f} ms, library {library}, "
        f"f32 CUDA-core bound {bound_ms:.4f} ms by {bound_by}{tc} "
        f"(peaks at 700 W; card limit {power})")
    return {**held, "ms": ms, "graph_ms": graph_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "split_bound_ms": split_ms, "split_bound_by": split_by,
            "tf32_bound_ms": tf32_ms, "tf32_bound_by": tf32_by,
            "pair_bound_ms": pair_ms, "library_ms": library_ms}


#: (Q, B, m) of pairwise_l2's ragged held calls: partial tiles, odd B and
#: m % 4 != 0 (the unvectorised staging)
RAGGED_L2 = ((130, 1001, 33), (7, 129, 256))
#: (F, Nq, R, m) of slab_l2's: the iSAX build's last chunk (88 slabs), Nq
#: not a multiple of the tile's 104 queries, R % 4 != 0 (unvectorised
#: stores), m % 4 != 0 (unvectorised staging), m below one 32-deep stage
RAGGED_SLAB = ((88, 200, 256, 256), (3, 130, 97, 256), (2, 50, 64, 33),
               (4, 9, 300, 12))
#: (Q, L, d) of box_lb's: the few-query path (Q = 1) and the staged one
#: (Q = 33), d = 5, 64, 65, 128 and 512 (the generic path; 128 a DSTree at
#: 64 segments, 512 one at m = 256 segments), 8 and 16 (registers), every
#: L % 4 (rows off 16 bytes); the boxes carry +-inf sides
RAGGED_BOX = ((1, 4093, 16), (33, 1001, 8), (33, 130, 5), (7, 517, 64),
              (4, 4096, 16), (40, 7479, 8), (33, 1001, 65), (2, 390, 128),
              (64, 777, 128), (9, 4095, 512))
#: (Q, L, kk, k, order, values, apart) of the replay's: k = 1, 5, 32 (the
#: last in registers), 33 and 257 (in the output row; 257 shifts it 32 at a
#: time over 8 pieces), kk above 8 (no slots in the ring) and above 32 (two
#: slot loads), kk below k, Q = 1, L off the producers' 64-position step; the
#: order "sorted" (a stable argsort of d_lb, as the callers pass) or
#: "shuffled"; the values "levels" (a few levels, so ties everywhere, with
#: +-inf and NaN among the bounds, the predictions and the leaf values;
#: leaves sorted and unsorted), "kept" (every bound -inf or NaN: no
#: position is ever dropped, so the ring stays full and the walker decides
#: every one) or "late" (the leaves' values above every bound and
#: prediction except in the last 3% of each row's visit order: the bsf
#: falls only there, stale pre-tests keep positions that the current bsf
#: prunes, and the lb/filter split is decided by the bsf just before each
#: one); with ``apart``, the call's rows apart in a larger buffer (as the
#: engine passes them); and a calibration-shaped call (Q = 4096, k = kk =
#: 1: many blocks an SM, in waves).  The first six calls draw what they
#: drew before the last four were added.
RAGGED_REPLAY = ((1, 4093, 5, 5, "sorted", "levels", False),
                 (37, 1000, 1, 1, "shuffled", "levels", False),
                 (37, 700, 5, 32, "sorted", "levels", False),
                 (20, 600, 40, 33, "shuffled", "levels", False),
                 (9, 500, 7, 257, "sorted", "levels", False),
                 (64, 129, 3, 5, "shuffled", "levels", True),
                 (24, 3000, 5, 5, "shuffled", "kept", False),
                 (16, 2500, 12, 5, "sorted", "late", False),
                 (24, 3001, 1, 1, "shuffled", "late", False),
                 (4096, 2000, 1, 1, "sorted", "levels", False))

#: (Q, L, max_leaf, m, kk, list width, scatter) of the candidate pass's: kk
#: = 1, 5, 32 (the last in registers), 33 and 257 (in the output row), max
#: leaf 7, 245, 256 and 1000 (each draw holds a leaf of size 1 and one of
#: max_leaf), m = 65 (one float a lane), 96 (a partial 16-byte block), 128
#: and 256, Q = 1, and the probe's form (one slot a query, rows by slot)
RAGGED_LEAF_TOPK = ((1, 300, 245, 256, 5, 300, True),
                    (37, 60, 7, 65, 1, 60, True),
                    (20, 90, 256, 96, 32, 90, True),
                    (9, 40, 1000, 128, 33, 40, True),
                    (5, 30, 1000, 65, 257, 12, True),
                    (64, 50, 245, 128, 5, 1, False))
#: (Q, m, kk, leaf sizes, queries keeping each leaf, queries with an empty
#: list) of the staged (wgmma) instance's held survivor passes: a leaf kept
#: by 1, by 65 (two 64-query items) and by all 256 queries, and by none;
#: leaves of 1, 7, 64 (one 64-row tile), 65, 129 (a 128-row tile, then a
#: 64-row one), 245, 300 and 1000 rows (eight tiles); m = 256, 96 (deep)
#: and 128 (sift); kk = 5, 1 and 32 (the shared-memory lists' largest);
#: padding slots inside counts, real ids past them, empty lists; then each
#: other register instance's kk (2, 3, 4, 6, 7, 8: an instance for each kk
#: <= 8) at m = 64 on leaves of 300, 8, 65 and 0 rows
RAGGED_STAGED = ((256, 256, 5, (1000, 7, 245, 1, 64, 129),
                  (1, 65, 256, 7, 0, 100), 0),
                 (200, 96, 1, (7, 1000, 65, 128, 200), (1, 65, 130, 3, 64),
                  10),
                 (100, 128, 32, (1000, 300, 7, 129), (65, 1, 33, 90), 10)) \
    + tuple((70, 64, kk, (300, 8, 65, 0), (65, 3, 20, 4), 5)
            for kk in (2, 3, 4, 6, 7, 8))


#: (F, m, h, batch) of the training kernels' held calls: one filter and
#: three; m = h = 96 and 128 (the deep and sift widths: a partial 128-lane
#: chunk, and a whole one) and 65 (m % 4 != 0, h % 4 != 0: unvectorised
#: staging, a partial 64-column pass of the w1 gradient); h != m (m = 256,
#: hidden = 128); batches 128 (160 rows, the full tile), 8 and 4 (one local
#: row), 256 (320 rows: two tiles) and 200 (250 rows: a partial second
#: tile, global and local rows in it)
RAGGED_TRAIN = ((1, 96, 96, 128), (3, 128, 128, 8), (3, 65, 65, 4),
                (1, 256, 128, 128), (3, 96, 96, 4), (2, 128, 128, 256),
                (3, 96, 96, 200))


def train_calls(device: str = "cuda") -> dict:
    """The training kernels' held calls (numpy seed 3) at
    ``RAGGED_TRAIN``: z-normalized random-walk rows, 40 global and 12
    local per filter, so the drawn indices repeat; He-normal weights,
    nonzero biases and velocities, 20% of the rows masked.  The backward
    calls take the plain forward pass's dpred."""
    import torch
    from repro_torch.kernels.filter_train import ref as train_ref
    rng = np.random.default_rng(3)

    def t(a, dtype=np.float32):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                               device=device)

    def rows(*shape):
        x = rng.standard_normal(shape).cumsum(-1)
        return (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
    calls: dict = {"train_forward": [], "train_backward_sgd": []}
    n_g, n_l = 40, 12
    for F, m, h, batch in RAGGED_TRAIN:
        bl = max(batch // 4, 1)
        params = (t(rng.standard_normal((F, m, h)) * np.sqrt(2 / m)),
                  t(rng.standard_normal((F, h)) * 0.1),
                  t(rng.standard_normal((F, h)) * np.sqrt(2 / h)),
                  t(rng.standard_normal(F) * 0.1))
        vels = tuple(t(rng.standard_normal(p.shape) * 1e-3) for p in params)
        xg, xl = t(rows(n_g, m)), t(rows(F, n_l, m))
        ig = t(rng.integers(0, n_g, batch), np.int64)
        il = t(rng.integers(0, n_l, bl), np.int64)
        rest = (t(rng.standard_normal((F, n_g))),
                t(rng.standard_normal((F, n_l))),
                t(rng.random(n_g) < 0.2), t(rng.random(n_l) < 0.2),
                n_g / (n_g + n_l))
        fwd = params + (xg, xl, ig, il) + rest
        lo = (train_ref.x_lo(xg), train_ref.x_lo(xl))
        calls["train_forward"].append(fwd + lo)
        calls["train_backward_sgd"].append(
            params + vels + (xg, xl, ig, il, train_ref.train_forward(*fwd),
                             1e-2, 0.9) + lo)
    return calls


def leaf_topk_calls(device: str = "cuda") -> list:
    """The candidate pass's held calls (numpy seed 4), at
    ``RAGGED_LEAF_TOPK``, in the engine's ``matmul`` form (``check_kernels``
    holds each in ``direct`` too): z-normalized random-walk rows, some
    repeated within their leaf (exact ties, which must go to the lower
    row), queries near rows (noise 0.2); each query a random survivor list
    with padding (id L) inside its count and, for odd queries, real leaf
    ids past it (which the pass must skip), one query's count 0 and one's
    the whole list; outputs +inf/−1."""
    import torch
    rng = np.random.default_rng(4)
    calls = []
    for Q, L, max_leaf, m, kk, C, scatter in RAGGED_LEAF_TOPK:
        sizes = rng.integers(1, max_leaf + 1, L)
        sizes[0], sizes[-1] = 1, max_leaf
        start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        n = int(sizes.sum())
        x = rng.standard_normal((n + max_leaf, m)).cumsum(-1)
        x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
        for leaf in np.flatnonzero(sizes > 2)[:L // 3]:
            r = start[leaf] + rng.integers(0, sizes[leaf] - 1)
            x[r + 1] = x[r]
        q = x[rng.integers(0, n, Q)] + 0.2 * rng.standard_normal((Q, m))
        leaves = np.full((Q, C), L, np.int64)
        counts = rng.integers(0, C + 1, Q)
        counts[0] = C
        if Q > 1:
            counts[1] = 0
        for i in range(Q):
            leaves[i, :counts[i]] = rng.choice(L, counts[i], replace=False)
            if counts[i] > 2:
                leaves[i, rng.integers(0, counts[i])] = L
            if i % 2:
                leaves[i, counts[i]:] = rng.integers(0, L, C - counts[i])
        rows = L + 1 if scatter else C

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                                   device=device)
        calls.append((t(x, np.float32), t(start, np.int64),
                      t(sizes, np.int64), t(q, np.float32), t(leaves),
                      t(counts, np.int64), kk, max_leaf, "matmul",
                      torch.full((Q, rows, kk), math.inf, device=device),
                      torch.full((Q, rows, kk), -1, dtype=torch.int64,
                                 device=device), scatter))
    return calls


def staged_leaf_topk_calls(device: str = "cuda") -> list:
    """The staged instance's held calls (numpy seed 5), at
    ``RAGGED_STAGED``, survivor passes in the ``matmul`` form: z-normalized
    random-walk rows, some repeated within their leaf (exact ties), queries
    near rows (noise 0.2); leaf l kept by the given number of queries
    (drawn from those with a list); each query's list its leaves in a random
    order, every third with a padding id (L) inside its count, odd queries
    with real ids past it; outputs +inf/−1."""
    import torch
    rng = np.random.default_rng(5)
    calls = []
    for Q, m, kk, sizes, keep, n_empty in RAGGED_STAGED:
        sizes = np.asarray(sizes)
        L = len(sizes)
        start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        n = int(sizes.sum())
        x = rng.standard_normal((n + int(sizes.max()), m)).cumsum(-1)
        x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
        for leaf in np.flatnonzero(sizes > 2):
            r = start[leaf] + rng.integers(0, sizes[leaf] - 1)
            x[r + 1] = x[r]
        q = x[rng.integers(0, n, Q)] + 0.2 * rng.standard_normal((Q, m))
        kept = np.zeros((Q, L), bool)
        for leaf, n_keep in enumerate(keep):
            kept[rng.choice(Q - n_empty, n_keep, replace=False), leaf] = True
        C = L + 2
        leaves = np.full((Q, C), L, np.int64)
        counts = np.zeros(Q, np.int64)
        for i in range(Q):
            lst = list(rng.permutation(np.flatnonzero(kept[i])))
            if lst and i % 3 == 0:
                lst.insert(int(rng.integers(0, len(lst) + 1)), L)
            counts[i] = len(lst)
            leaves[i, :len(lst)] = lst
            if i % 2:
                leaves[i, len(lst):] = rng.integers(0, L, C - len(lst))

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                                   device=device)
        calls.append((t(x, np.float32), t(start, np.int64),
                      t(sizes, np.int64), t(q, np.float32), t(leaves),
                      t(counts), kk, int(sizes.max()), "matmul",
                      torch.full((Q, L + 1, kk), math.inf, device=device),
                      torch.full((Q, L + 1, kk), -1, dtype=torch.int64,
                                 device=device), True))
    return calls


def replay_calls(device: str = "cuda") -> list:
    """The replay's held calls (numpy seed 2), at ``RAGGED_REPLAY``."""
    import torch
    rng = np.random.default_rng(2)
    levels = np.float32([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0])
    calls = []
    for n, (Q, L, kk, k, how, values, apart) in enumerate(RAGGED_REPLAY):
        leaf_d = rng.choice(levels, (Q, L + 1, kk))
        if n % 2 == 0:
            leaf_d = np.sort(leaf_d, axis=-1)
        d_lb = rng.choice(levels, (Q, L)) * 0.8
        d_F = rng.choice(levels, (Q, L)) * 0.9
        for a in (leaf_d, d_lb, d_F):
            for v in (np.inf, np.nan, -np.inf):
                a[rng.random(a.shape) < 0.02] = v
        leaf_i = rng.integers(0, 1 << 40, (Q, L + 1, kk))
        if values == "kept":
            d_lb = np.where(rng.random((Q, L)) < 0.1, np.nan, -np.inf)
        order = (np.argsort(d_lb, axis=1, kind="stable") if how == "sorted"
                 else np.stack([rng.permutation(L) for _ in range(Q)]))
        if values == "late":
            # every leaf above the bounds and predictions (at most 3.6)
            # but those visited in the last 3% of the row
            early = order[:, :L - max(L * 3 // 100, 1)]
            big = np.where(leaf_d == -np.inf, 8.0, 8.0 + leaf_d)
            rows = np.arange(Q)[:, None]
            leaf_d[rows, early] = big[rows, early]
        t = {name: torch.as_tensor(np.ascontiguousarray(a), device=device)
             for name, a in (("leaf_d", leaf_d.astype(np.float32)),
                             ("leaf_i", leaf_i),
                             ("d_lb", d_lb.astype(np.float32)),
                             ("d_F", d_F.astype(np.float32)),
                             ("order", order))}
        ld, li = t["leaf_d"][:, :L], t["leaf_i"][:, :L]
        if not apart:
            ld, li = ld.contiguous(), li.contiguous()
        calls.append((ld, li, t["d_lb"], t["d_F"], t["order"], k))
    return calls


#: (L, m, max_leaf, k, kind) of the early walk's held calls: k = 1, 5, 32
#: (the last in registers), 33 and 257 (in the output row and the slots);
#: m = 65 (no 16-byte loads), 96, 128 and 256; a leaf of 1,000 rows (16
#: items); the kind: "ties" (series and query on a 0.5 grid with rows
#: repeated, so tied distances, bounds rounded to 0.1 so tied bounds, and
#: d_F at +-inf on 10% of the leaves each), "small" (half the leaves empty or
#: smaller than k), "nofilter" (d_F = -inf: no position filter-pruned),
#: "inf" (d_F at +-inf on 20% each) or "first" (one leaf's bound 0, every
#: other above any distance: the walk stops right after its first leaf)
RAGGED_EARLY = ((400, 65, 1000, 5, "ties"), (500, 96, 100, 33, "small"),
                (300, 128, 256, 257, "nofilter"), (800, 128, 245, 32, "ties"),
                (1000, 256, 245, 1, "first"), (600, 96, 60, 5, "inf"),
                (200, 256, 256, 1, "nofilter"))


def early_walk_calls(device: str = "cuda") -> list:
    """The early walk's held calls (numpy seed 6), at ``RAGGED_EARLY``:
    (series, leaf_start, leaf_size, q, d_lb, d_F, order, k, max_leaf),
    the bounds a random share of each leaf's nearest distance, the
    predictions 0.9-1.3 times it, the order a stable argsort of the
    bounds."""
    import torch
    rng = np.random.default_rng(6)
    calls = []
    for L, m, max_leaf, k, kind in RAGGED_EARLY:
        sizes = rng.integers(0, max_leaf + 1, L)
        if kind == "small":
            sizes = np.where(rng.random(L) < 0.5, rng.integers(0, k, L),
                             sizes)
        sizes[rng.integers(L)] = max_leaf
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        n = int(sizes.sum())
        series = (rng.standard_normal((n + max_leaf, m)).cumsum(1)
                  / np.sqrt(m)).astype(np.float32)
        q = series[rng.integers(n)] + np.float32(0.05) * rng.standard_normal(
            m).astype(np.float32)
        if kind == "ties":
            series = np.round(series * 2) / 2
            q = np.round(q * 2) / 2
            rows = rng.integers(0, n, (n // 10, 2))
            series[rows[:, 0]] = series[rows[:, 1]]
        d = np.sqrt(((series[:n].astype(np.float64) - q) ** 2).sum(1))
        mins = np.full(L, np.inf)
        np.minimum.at(mins, np.repeat(np.arange(L), sizes), d)
        mins = np.where(sizes > 0, mins, rng.uniform(0.0, 3.0, L))
        d_lb = mins * rng.uniform(0.0, 1.0, L)
        d_F = mins * rng.uniform(0.9, 1.3, L)
        if kind == "ties":
            d_lb = np.round(d_lb, 1)
        if kind == "nofilter":
            d_F[:] = -np.inf
        if kind in ("ties", "inf"):
            share = 0.1 if kind == "ties" else 0.2
            for v in (np.inf, -np.inf):
                d_F[rng.random(L) < share] = v
        if kind == "first":
            leaf = int(np.argmax(sizes))
            d_lb[:] = 1e9
            d_lb[leaf] = 0.0
        order = np.argsort(d_lb.astype(np.float32), kind="stable")
        t = [torch.as_tensor(np.ascontiguousarray(a), device=device)
             for a in (series.astype(np.float32), starts.astype(np.int64),
                       sizes.astype(np.int64), q.astype(np.float32),
                       d_lb.astype(np.float32), d_F.astype(np.float32),
                       order.astype(np.int64))]
        calls.append(tuple(t) + (k, max_leaf))
    return calls


def _box_args(rng, Q: int, L: int, d: int, device: str) -> tuple:
    """Points and boxes with open sides at -inf/+inf (as the SAX extremes),
    one empty box (lo = +inf) and one with a NaN side: the last two reach
    the kernel's guarded recompute."""
    import torch
    q = rng.standard_normal((Q, d)).astype(np.float32)
    c = rng.standard_normal((L, d)).astype(np.float32)
    w = np.abs(rng.standard_normal((L, d))).astype(np.float32)
    lo, hi = c - w, c + w
    lo[rng.random((L, d)) < 0.1] = -np.inf
    hi[rng.random((L, d)) < 0.1] = np.inf
    lo[L // 2, 0] = np.inf
    hi[L // 3, d - 1] = np.nan
    return tuple(torch.as_tensor(a, device=device) for a in (q, lo, hi))


def ragged_calls(device: str = "cuda") -> dict:
    """Per kernel, argument tuples at shapes its timed calls do not cover
    (numpy seed 1; the filter weights drawn as the filter suite draws
    them)."""
    import torch
    from repro_torch.bench.filters_bench import _make_stack, _offsets
    from repro_torch.core import filters
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    rng = np.random.default_rng(1)

    def randn(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=device)
    calls = {"pairwise_l2": [(randn(q, m), randn(b, m))
                             for q, b, m in RAGGED_L2]}
    # (F, Q, m, h) of the fused entries: both designs, partial query tiles,
    # m % 4 != 0 and h not a multiple of a payload's 16-byte vector
    limit = mlp_kernel.STREAM_MAX_Q
    for F, n_q, m, h in ((7, 3, 40, 300), (9, 200, 33, 20),
                         (4, limit, 17, 37), (5, limit + 1, 17, 37)):
        q = randn(n_q, m)
        p32 = _make_stack(F, m, h, rng, device)
        off = _offsets(F, rng, device)
        for dt in ("float32", "bfloat16", "int8"):
            p = filters.quantize_mlp(p32, dt)
            calls.setdefault(mlp_kernel.ENTRY[p["w1"].dtype], []).append(
                (q, p["w1"], p["b1"], p["w2"], p["b2"], p["y_mean"],
                 p["y_std"], off, p.get("w1_scale"), p.get("w2_scale")))
    calls["slab_l2"] = [(randn(F, nq, m), randn(F, r, m))
                        for F, nq, r, m in RAGGED_SLAB]
    calls["box_lb"] = [_box_args(rng, Q, L, d, device)
                       for Q, L, d in RAGGED_BOX]
    return calls


#: (F, Q, m, channels, ksize) of the CNN kernel's ragged held calls: m =
#: 96 and 33 (a block of 2 and of 7 queries, each followed by its K - 1
#: zero columns), 300 (a query over two column tiles, its halo across
#: them) and 1 (86 queries a block, four query tiles); channels 64 (one
#: consumer warpgroup idle), 100 (a partial pass and 32-channel chunk),
#: 130 (two passes, the second of 2 channels) and 98 (C % 4 != 0: c2
#: staged element by element); ksize 1, 2 (even: one more pad after than
#: before), 3 and 5
RAGGED_CNN = ((1, 1, 96, 64, 3), (3, 33, 33, 100, 2), (3, 180, 96, 100, 5),
              (1, 33, 33, 64, 1), (3, 1, 33, 98, 5), (1, 180, 96, 64, 2),
              (2, 3, 300, 130, 2), (1, 300, 1, 40, 3))
#: (F, Q, m, hidden) of the LSTM kernel's: hidden 32 and 64 on either side
#: of the few-query limit (Q = 1 and ``FEW_MAX_Q`` take the weights in
#: registers, ``FEW_MAX_Q`` + 1 and more the 16-query tiles, 17 and 33 a
#: partial last tile), 100 (the generic instance, the weights through L2;
#: a partial last thread group) and 2500 (the state too large for shared
#: memory: kept in memory, a thread ten units), m = 96, 40 and 33
RAGGED_RNN = ((1, 1, 96, 32), (3, 33, 33, 64), (3, 180, 96, 100),
              (1, 180, 33, 64), (3, 1, 33, 100), (1, 33, 96, 32),
              (2, 8, 40, 64), (2, 9, 40, 64), (2, 8, 33, 32), (3, 9, 33, 32),
              (2, 17, 40, 64), (1, 5, 4, 2500))


def filter_type_calls(device: str = "cuda") -> dict:
    """The CNN and LSTM kernels' ragged calls (numpy seed 2; weights at the
    reference's init scales, random biases and target statistics)."""
    import torch
    rng = np.random.default_rng(2)

    def randn(*shape, scale=1.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale).astype(
            np.float32), device=device)

    def head(F):
        return (randn(F), randn(F) + 10.0,
                torch.as_tensor(rng.uniform(0.5, 2.0, F).astype(np.float32),
                                device=device))
    calls = {"filter_cnn": [], "filter_rnn": []}
    for F, Q, m, C, K in RAGGED_CNN:
        calls["filter_cnn"].append((
            randn(Q, m), randn(F, K, 1, C, scale=math.sqrt(2 / K)),
            randn(F, K, C, C, scale=math.sqrt(2 / (K * C))),
            randn(F, C, scale=math.sqrt(1 / C))) + head(F))
    for F, Q, m, h in RAGGED_RNN:
        s = math.sqrt(1 / h)
        calls["filter_rnn"].append((
            randn(Q, m), randn(F, 1, 4 * h, scale=s),
            randn(F, h, 4 * h, scale=s), randn(F, h, 4 * h, scale=s),
            randn(F, h, 4 * h, scale=s), randn(F, h, scale=s)) + head(F))
    return calls


#: (m, bands) of the DTW kernel's held calls, each at Q = 1 and 8 against
#: N = 1001 series (not a multiple of a block's series): r = 3 and 8 take
#: register instances, r = 0, 1, m - 1 and m + 5 (full DTW) the generic
RAGGED_DTW = tuple((m, (0, 1, 3, 8, m - 1, m + 5)) for m in (33, 96, 256))


def dtw_calls(device: str = "cuda") -> list:
    """The DTW kernel's held calls (numpy seed 3): random walks, z-normalized,
    with every fourth series rounded to a quarter (ties and repeated
    values) and the queries drawn beside them."""
    import torch
    rng = np.random.default_rng(3)

    def walks(n, m):
        w = rng.standard_normal((n, m)).cumsum(1)
        w = (w - w.mean(1, keepdims=True)) / (w.std(1, keepdims=True)
                                              + 1e-8)
        w[::4] = np.round(w[::4] * 4) / 4
        return torch.as_tensor(w.astype(np.float32), device=device)
    calls = []
    for m, bands in RAGGED_DTW:
        x, q = walks(1001, m), walks(8, m)
        calls += [(q[:n_q].contiguous(), x, band) for band in bands
                  for n_q in (1, 8)]
    return calls


def _rnn_layout(args) -> str:
    """The LSTM kernel's instance for a call: its instance, threads and
    queries a block, where its weights and state live, shared memory,
    registers, scratch and the few-query limit."""
    from repro_torch.kernels.filter_rnn import kernel as rnn_kernel
    F, h = args[5].shape
    return json.dumps(rnn_kernel.layout(F, args[0].shape[0], h))


def _cnn_layout(args) -> str:
    """The CNN kernel's launch for a call: queries a block, rows a tile,
    channels a pass, stages a block, how c2 is staged, shared memory,
    registers and the c2 bytes the grid stages from L2."""
    from repro_torch.kernels.filter_cnn import kernel as cnn_kernel
    Q, m = args[0].shape
    F, K, _, C = args[1].shape
    return json.dumps(cnn_kernel.layout(F, Q, m, K, C,
                                        args[2].data_ptr() % 16 == 0))


#: the backbone kernels' launch reports, by kernel
BACKBONE_LAYOUT = {"filter_cnn": _cnn_layout, "filter_rnn": _rnn_layout}


def _dtw_label(args) -> str:
    """A DTW call's length, band and kernel instance."""
    from repro_torch.kernels.dtw import kernel as dtw_kernel
    q, _, band = args
    return (f"m={q.shape[1]}, band={band}: "
            f"{dtw_kernel.instance(q.shape[1], band)}")


def _q_label(name: str, n_q: int) -> str:
    """A call's label by its query count; the fused entries' also names the
    design their Q takes."""
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    if name in mlp_kernel.LAUNCHES:
        return f"{name} (Q={n_q}, {mlp_kernel.regime(n_q)} design)"
    return f"{name} (Q={n_q})"


def _box_shapes(captured: dict, power: str) -> list:
    """``box_lb`` at every distinct shape the main paths gave it: its
    launches there, held and timed (the largest, the batches', Q = 1)."""
    rows = []
    for (Q, L, d), (count, args) in sorted(
            captured.get("box_lb@shapes", {}).items(),
            key=lambda kv: -kv[1][0]):
        res = _check_call("box_lb", args, f"box_lb (Q={Q}, L={L}, d={d})",
                          power)
        rows.append({"Q": Q, "L": L, "d": d, "launches": count,
                     **{k: res[k] for k in ("max_abs_err", "ms", "graph_ms",
                                            "plain_ms", "bound_ms")}})
    return rows


def _fused_beside_raw(args, power: str) -> dict:
    """The fused float32 kernel at ``filter_mlp``'s call (zero means and
    offsets, unit spreads): the same body, timed in the same run."""
    import torch
    q, w1, b1, w2, b2 = args
    F = w1.shape[0]
    zeros = torch.zeros(F, device=w1.device)
    res = _check_call("fused_filter_mlp",
                      (q, w1, b1, w2, b2, zeros, zeros + 1, zeros),
                      "fused_filter_mlp at filter_mlp's call", power)
    return {k: res[k] for k in ("ms", "graph_ms", "max_abs_err")}


def _serving_calls(name: str, captured: dict, power: str) -> dict:
    """Kernel ``name`` at the serving phase's served batches
    (``_merge_serving``), each call held against its plain version and
    timed: its largest, the probe's (``leaf_topk``) and the warm-start
    bound instance's (``replay``: held bitwise as called, timed from a
    CUDA graph beside its bytes bound)."""
    out = {}
    for key, what in ((f"{name}@serving", "largest"),
                      (f"{name}@probe@serving", "probe")):
        if key in captured:
            out[what] = _check_call(
                name, captured[key][1],
                f"{name} (the served batches' {what} call)", power)
    if name == "replay" and "replay@bound@serving" in captured:
        from repro_torch.analysis import roofline
        from repro_torch.kernels.replay import kernel as replay_kernel
        from repro_torch.kernels.replay import ref as replay_ref
        args, ub = captured["replay@bound@serving"][1]
        label = "replay (the served batches' largest warm-start call)"
        held = _hold_replay(args, label, bsf_ub=ub, instances=False)
        leaf_d, _, d_lb, d_F, order, k = args
        bound_ms = replay_ref.bound_bytes(leaf_d, d_lb, d_F, order, k,
                                          bsf_ub=ub) \
            / roofline.H100.hbm_bw * 1e3
        graph_ms = _graph_ms(lambda: replay_kernel.replay_cascade_cuda(
            *args, bsf_ub=ub))
        log(f"kernel {label} ({held['instance']}, the bound instance): "
            f"{graph_ms:.4f} ms from a CUDA graph, bytes bound "
            f"{bound_ms:.5f} ms (peaks at 700 W; card limit {power})")
        out["bound_instance"] = {**held, "graph_ms": graph_ms,
                                 "bound_ms": bound_ms}
    return out


def check_kernels(captured: dict, launches: dict, power: str) -> list:
    """Each kernel against its plain version on the main paths' inputs; the
    fused entries and ``box_lb`` also on their call with the fewest queries
    (``box_lb`` at every shape the paths gave it, with its launches there),
    the filter kernels on their largest call's weights at the Q on either
    side of the stream design's limit, ``filter_mlp`` beside the fused
    float32 kernel at its own call, the replay also on calibration's
    largest call, the candidate pass also in ``direct`` form and on the
    probe's largest call; the serving phase's kernels also at the served
    batches' calls (``_serving_calls``); the redesigned kernels also at
    ragged shapes (untimed)."""
    from repro_torch.kernels.filter_mlp import kernel as mlp_kernel
    from repro_torch.kernels.leaf_topk import ref as leaf_ref
    ragged = {**ragged_calls(), "replay": replay_calls(), **train_calls(),
              "early_walk": early_walk_calls(), **filter_type_calls(),
              "dtw": dtw_calls()}
    ragged["leaf_topk"] = [_leaf_topk_fresh(c, impl)
                           for c in leaf_topk_calls()
                           + staged_leaf_topk_calls()
                           for impl in leaf_ref.IMPLS]
    ragged["filter_mlp"] = [c[:5] for c in ragged["fused_filter_mlp"]]
    rows = []
    for name, (source, replaces, _, _) in KERNELS.items():
        t_row = time.perf_counter()
        if name not in captured:
            raise AssertionError(f"{name}: never called on the main path")
        args = captured[name][1]
        if name in TRAIN_KERNELS:
            args = _with_lo(args)
        res = _check_call(name, args, name, power)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               **{k: res[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "split_bound_ms", "split_bound_by",
                                      "tf32_bound_ms", "tf32_bound_by")},
               "design": DESIGN[name][0], "graph_ms": res["graph_ms"]}
        held = list(ragged.get(name, []))
        if f"{name}@min_q" in captured:
            small = captured[f"{name}@min_q"][1]
            n_q = small[0].shape[0]
            design = ({"design": mlp_kernel.regime(n_q)}
                      if name in mlp_kernel.LAUNCHES else {})
            row["smallest_q_call"] = {
                "Q": n_q, **design,
                **_check_call(name, small, _q_label(name, n_q), power)}
        if name in mlp_kernel.LAUNCHES:
            limit = mlp_kernel.STREAM_MAX_Q
            held += [(args[0][:n].contiguous(),) + tuple(args[1:])
                     for n in (1, limit, limit + 1)]
        if name == "filter_mlp":
            fused = _fused_beside_raw(args, power)
            row["fused_f32_same_call"] = fused
            log(f"kernel filter_mlp: {res['ms'] / fused['ms']:.3f} x the "
                "fused float32 kernel's time at the same call (graph: "
                f"{res['graph_ms'] / fused['graph_ms']:.3f} x), "
                f"{res['ms'] / res['plain_ms']:.3f} x its plain version's")
        if name == "replay":
            _replay_timed_call(args)
            row.update(instance=res["instance"],
                       chain=_replay_chain(args, "replay"),
                       instances=_replay_instance_times(
                           args, "replay (the largest batch call)"),
                       instances_held=res["instances_held"])
        if name == "replay" and "replay@calibration" in captured:
            cal = captured["replay@calibration"][1]
            label = "replay (calibration's largest call)"
            _replay_timed_call(cal, batch=False)
            row["calibration_call"] = {
                "rows": cal[2].shape[0], "L": cal[2].shape[1],
                **_check_call(name, cal, label, power),
                "chain": _replay_chain(cal, label),
                "instances": _replay_instance_times(cal, label)}
        if name == "box_lb":
            row["by_shape"] = _box_shapes(captured, power)
        serving_calls = _serving_calls(name, captured, power)
        if serving_calls:
            row["serving_calls"] = serving_calls
        if name == "early_walk":
            row.update(layout=res["layout"], counts=res["counts"],
                       path_calls="every call of both search_early phases "
                       "held bitwise")
            if "early_walk@isax" in captured:
                row["isax_call"] = _check_call(
                    name, captured["early_walk@isax"][1],
                    "early_walk (the iSAX phase's largest k = 5 exact call)",
                    power)
        if name == "leaf_topk":
            keep = ("instance", "max_abs_err", "id_diff", "near_ties", "ms",
                    "graph_ms", "plain_ms", "bound_ms", "bound_by",
                    "split_bound_ms", "pair_bound_ms")
            row.update(pair_bound_ms=res["pair_bound_ms"],
                       id_diff=res["id_diff"], near_ties=res["near_ties"],
                       instance=res["instance"])
            assert res["instance"] == "wgmma", res["instance"]
            direct = _check_call(name, _leaf_topk_fresh(args, "direct"),
                                 "leaf_topk (direct)", power)
            row["direct"] = {k: direct[k] for k in keep}
            if "leaf_topk@probe" in captured:
                probe = _check_call(name, captured["leaf_topk@probe"][1],
                                    "leaf_topk (the probe's largest call)",
                                    power)
                row["probe_call"] = {k: probe[k] for k in keep}
        if name in BACKBONE_LAYOUT:
            row["layout"] = BACKBONE_LAYOUT[name](args)
            log(f"kernel {name} (the largest call) launch: {row['layout']}")
            if "smallest_q_call" in row:
                row["smallest_q_call"]["layout"] = BACKBONE_LAYOUT[name](
                    captured[f"{name}@min_q"][1])
                log(f"kernel {name} (Q={row['smallest_q_call']['Q']}) "
                    f"launch: {row['smallest_q_call']['layout']}")
        if name == "dtw":
            row["instance"] = _dtw_label(args)
            row["q1_call"] = {"Q": 1, **_check_call(
                name, (args[0][:1].contiguous(),) + tuple(args[1:]),
                f"dtw (Q=1, {_dtw_label(args)})", power)}
        if held:
            row["held_calls"] = []
            for call in held:
                label = name
                if name in mlp_kernel.LAUNCHES or name in (
                        "box_lb", "filter_cnn", "filter_rnn"):
                    label = _q_label(name, call[0].shape[0])
                if name in BACKBONE_LAYOUT:
                    label += f" {BACKBONE_LAYOUT[name](call)}"
                if name == "dtw":
                    label = (f"dtw (Q={call[0].shape[0]}, N="
                             f"{call[1].shape[0]}, {_dtw_label(call)})")
                row["held_calls"].append(_hold(name, call, f"{label}, held"))
        row["check_wall_s"] = round(time.perf_counter() - t_row, 2)
        log(f"kernel checks of {name}: {row['check_wall_s']} s")
        rows.append(row)
    return rows


#: 0.75 of float32's ulp at 1.0, and 1 + 0.75 of a TF32 ulp (bits that a
#: TF32 operand drops)
_THREE_QUARTER_ULP = 1.5 * 2.0 ** -24
_LOW_BITS = 1 + 2.0 ** -11 + 2.0 ** -12


def tc_rounding_cases() -> tuple:
    """The tensor-core rounding probe's crafted cases (``csrc/
    tc_rounding.cu``): names, A (n, 64, 8), B (n, 8, 8), C (n, 64, 8)
    float32.  Each gives a different result under every rounding but the
    one the split-TF32 kernels and their emulation assume (a k8 step's
    eight exact products and the accumulator summed, then rounded once
    toward zero; an operand's 13 low mantissa bits dropped); the last case
    (small integers, exact under any rounding) checks the fragment layouts
    and the shared-memory descriptor."""
    u = _THREE_QUARTER_ULP
    plan = [
        ("step sum rounded toward zero (+)", {0: u}, {0: 1.0}, 1.0),
        ("step sum rounded toward zero (-)", {0: -u}, {0: 1.0}, -1.0),
        ("one rounding a step (k = 0, 1)", {0: u, 1: u}, {0: 1.0, 1: 1.0},
         1.0),
        ("one rounding a step (k = 0, 4)", {0: u, 4: u}, {0: 1.0, 4: 1.0},
         1.0),
        ("B's 13 low bits dropped (shared memory)", {0: 1.0},
         {0: _LOW_BITS}, 0.0),
        ("A's 13 low bits dropped (registers)", {0: _LOW_BITS}, {0: 1.0},
         0.0),
    ]
    names, A, B, C = [], [], [], []
    for name, a_cols, b_rows, c in plan:
        a, b = np.zeros((64, 8)), np.zeros((8, 8))
        for k, v in a_cols.items():
            a[:, k] = v
        for k, v in b_rows.items():
            b[k, :] = v
        names.append(name)
        A.append(a), B.append(b), C.append(np.full((64, 8), c))
    rng = np.random.default_rng(5)
    names.append("layouts (small integers, exact)")
    A.append(rng.integers(-4, 5, (64, 8)))
    B.append(rng.integers(-4, 5, (8, 8)))
    C.append(rng.integers(-64, 65, (64, 8)))
    return (names,) + tuple(np.ascontiguousarray(x, dtype=np.float32)
                            for x in (np.stack(A), np.stack(B), np.stack(C)))


def tc_rounding_expected(A, B, C, rounding: str = "zero"):
    """C + A·B per case with A and B read as TF32 (13 low bits dropped), the
    exact sum rounded once to float32 toward ``"zero"`` (the assumption) or
    to ``"nearest"``; ``"full"`` keeps every operand bit and rounds to
    nearest.  float32 (n, 64, 8)."""
    import torch
    from repro_torch.kernels.l2_scan.ref import tf32_truncate
    a, b, c = (torch.from_numpy(x) for x in (A, B, C))
    if rounding != "full":
        a, b = tf32_truncate(a), tf32_truncate(b)
    exact = c.double() + a.double() @ b.double()
    f = exact.float()
    if rounding == "zero":
        f = torch.where(f.double().abs() > exact.abs(),
                        torch.nextafter(f, torch.zeros_like(f)), f)
    return f.numpy()


def check_tc_rounding() -> dict:
    """The card's TF32 tensor cores on ``tc_rounding_cases``: wgmma (A from
    registers, B from shared memory, the training kernels' form) and
    mma.sync (tf32x3.cuh's) must both give ``tc_rounding_expected``'s
    round-toward-zero results bitwise, which ``FLIP_PRE``'s margin and
    every split-TF32 emulation assume."""
    import ctypes
    import torch
    from repro_torch.kernels import common
    names, A, B, C = tc_rounding_cases()
    lib = common.load("tc_rounding", {
        "tc_rounding_probe": [ctypes.c_void_p] * 5
        + [ctypes.c_int, ctypes.c_void_p]})
    a, b, c = (torch.from_numpy(x).cuda() for x in (A, B, C))
    dw = torch.empty_like(c)
    dm = torch.empty((len(names), 16, 8), device="cuda")
    common.check(lib.tc_rounding_probe(
        *(common.ptr(t) for t in (a, b, c, dw, dm)), len(names),
        common.stream_ptr(a)), "tc_rounding_probe")
    torch.cuda.synchronize()
    want = tc_rounding_expected(A, B, C)
    near = tc_rounding_expected(A, B, C, "nearest")
    full = tc_rounding_expected(A, B, C, "full")
    got_w, got_m = dw.cpu().numpy(), dm.cpu().numpy()
    out = {}
    for i, name in enumerate(names):
        ok_w = np.array_equal(got_w[i].view(np.int32), want[i].view(np.int32))
        ok_m = np.array_equal(got_m[i].view(np.int32),
                              want[i, :16].view(np.int32))
        out[name] = {"wgmma": ok_w, "mma.sync": ok_m}
        log(f"tensor-core rounding, {name}: expected {want[i, 0, 0]!r} "
            f"(to nearest {near[i, 0, 0]!r}, all bits {full[i, 0, 0]!r}); "
            f"wgmma {got_w[i, 0, 0]!r} {'ok' if ok_w else 'DIFFERS'}, "
            f"mma.sync {got_m[i, 0, 0]!r} {'ok' if ok_m else 'DIFFERS'}")
    bad = [n for n, v in out.items() if not all(v.values())]
    assert not bad, f"the tensor cores do not round as assumed: {bad}"
    return out


def _ptxas_report(logs: dict) -> None:
    """Print each kernel's registers, shared memory and spills from the
    build's ``-Xptxas -v`` output; the redesigned kernels must not spill."""
    for lib, text in logs.items():
        if not text:
            log(f"  {lib}: already built, no ptxas report")
        func = "?"
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                func = entry.group(1)
                continue
            if "registers" in line or "spill" in line or "wgmma" in line:
                log(f"  {lib}: {func}: "
                    f"{line.removeprefix('ptxas info    :').strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", line)
            if spill and any(k in func for k in SPLIT_KERNELS):
                assert spill.groups() == ("0", "0"), f"{func} spills: {line}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.kernels import common

    # full f32 everywhere: the reference accumulates in f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    log(card)
    power = card.split(",")[-1].strip()
    t0 = time.perf_counter()
    logs = common.build(["l2_scan", "filter_mlp", "box_lb", "replay",
                         "filter_train", "leaf_topk", "tc_rounding",
                         "early_walk", "filter_cnn", "filter_rnn", "dtw"])
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    _ptxas_report(logs)
    from repro_torch.kernels.filter_train import kernel as train_kernel
    from repro_torch.kernels.leaf_topk import kernel as leaf_kernel
    log("  dynamic shared memory a block (bytes): "
        + json.dumps(train_kernel.kernel_smem()) + "; leaf_topk_wgmma "
        "(bytes, ring stages) by kk: " + json.dumps(
            {kk: leaf_kernel.wgmma_smem(kk) for kk in (1, 5, 32)}))

    captured: dict = {}
    phases: dict = {}

    def phase(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        phases[name] = round(time.perf_counter() - t, 2)
        return out

    phase("tensor-core rounding", check_tc_rounding)
    series = make_series()
    e2e = phase("dstree", run_end_to_end, device="cuda", captured=captured,
                series=series)
    phase("dstree breakdown", search_breakdown, e2e["lfi"], e2e["queries"])
    phase("dstree collect breakdown", collect_breakdown, e2e["lfi"],
          "dstree ")
    profile = phase("dstree training profile", training_profile, e2e["lfi"],
                    "dstree ")
    phase("dstree training holds", hold_training, profile.pop("state"),
          "dstree ")
    del profile
    paths = [e2e["launches"]]
    paths.append(phase("search_early", run_early, e2e["lfi"],
                       e2e["queries"], e2e["results"], device="cuda",
                       captured=captured)["launches"])
    phase("search_early breakdown", early_breakdown, e2e["lfi"],
          e2e["queries"], device="cuda")
    phase("simulators", run_simulators, e2e["lfi"], series, e2e["queries"],
          device="cuda")
    paths.append(phase("dtw", run_dtw, e2e["lfi"], e2e["queries"],
                       device="cuda", captured=captured)["launches"])
    paths.append(phase("filter types", run_filter_types, e2e["lfi"],
                       e2e["queries"], device="cuda",
                       captured=captured)["launches"])
    paths.append(phase("grouped", run_grouped, e2e["lfi"], e2e["queries"],
                       e2e["targets"], e2e["results"], device="cuda",
                       captured=captured)["launches"])
    traced = [phase("dstree trace and audit", run_trace_audit, e2e["lfi"],
                    e2e["queries"], device="cuda", impls=(None, "pairwise"),
                    label="dstree ")]
    paths.append(traced[-1]["launches"])
    traced.append(phase("serving", run_serving, e2e["lfi"], e2e["queries"],
                        device="cuda", captured=captured, label="dstree "))
    paths.append(traced[-1]["launches"])
    n_filters = len(e2e["lfi"].leaf_ids)
    del e2e                               # the DSTree index leaves the card
    paths.append(phase("filter suite", run_filter_suite, n_filters,
                       device="cuda", captured=captured)["launches"])
    paths.append(phase("dstree d=128", run_wide_dstree, device="cuda",
                       captured=captured)["launches"])
    isax = phase("isax", run_isax, device="cuda", captured=captured,
                 series=series)
    phase("isax breakdown", search_breakdown, isax["lfi"], isax["queries"],
          reps=3, label="isax ")
    phase("isax collect breakdown", collect_breakdown, isax["lfi"], "isax ")
    paths.append(isax["launches"])
    traced.append(phase("isax trace and audit", run_trace_audit, isax["lfi"],
                        isax["queries"], device="cuda", label="isax "))
    paths.append(traced[-1]["launches"])
    paths.append(phase("isax search_early", run_early, isax["lfi"],
                       isax["queries"], {
                           ("default", k, t): isax["results"][
                               ("float32", k, t)]
                           for k in (1, 5) for t in ("exact", "0.99")},
                       device="cuda", captured=captured,
                       label="isax ")["launches"])
    del isax                              # the iSAX index leaves the card
    paths += [d["launches"] for d in
              phase("datasets", run_datasets, device="cuda").values()]
    launches = {name: sum(p.get(name, 0) for p in paths) for name in KERNELS}
    log("launches on all paths: " + json.dumps(launches))
    rows = phase("kernel checks", check_kernels, captured, launches, power)
    # the replay's launches by instance: the bound and traced ones launch
    # only in the trace-and-audit phases and (bound, under warm start) the
    # serving phase, the plain one everywhere else
    bound = sum(t["replay_modes"]["bound"] for t in traced)
    n_traced = sum(t["replay_modes"]["traced"] for t in traced)
    for row in rows:
        if row["name"] == "replay":
            row["launches_by_instance"] = {
                "plain": launches["replay"] - bound - n_traced,
                "bound": bound, "traced": n_traced}
            log("replay launches by instance on all paths: "
                + json.dumps(row["launches_by_instance"]))
    log(f"phase wall times (s): {json.dumps(phases)}; script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
