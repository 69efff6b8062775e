#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. build: compile the segsum kernel from `diffusionsat_torch/csrc/` with
   nvcc and the native SAT solver with g++ and print the build times, then
   the card's name and power limit; generate the solving eval's test split
   (2000 threshold 3-SAT instances, 16 generator shards) into `data_cache/`;
2. kernel vs plain: both directions of the planned SpMM at F = 128 on the
   sampler batch of `primes_3599_61x59.cnf`, on a 20 000-node threshold
   3-SAT batch, on the first batch of the eval split and on the flat
   uniformity battery's batch (p24 formula 0, 125 copies): max-abs error
   against `segsum_plain` (which must be 0: both sum in plan order), the
   plan's longest and mean segment, and the times of the kernel, the plain
   version and the library calls for the same function (`index_select`,
   then `index_add_`), beside the bound and the launch floor (a one-element
   kernel's device time, from 100 replayed in a graph, read once a run);
3. model: the shipped flagship `query_sat_3sat_diffusion_mlk64.npz` at full
   width on the 20 000-node batch in the solving regime (noise 1.0): 4
   noise-free rounds through the kernel against the plain path and against
   the dense model on the re-blocked batch, then 64 rounds with early exit
   (wall time, rounds, graphs solved) on both flat paths, the cost of the
   per-round early-exit sync, and a profile of 8 rounds (device busy share,
   top kernels) of the flat and the dense model;
4. solving eval (a main path): `python -m diffusionsat_torch.solve_eval` on
   the 2000-instance split, 64 rounds at noise 1.0, one try: flat (the
   kernel must have been launched) and dense; each solved fraction must lie
   in [0.88, 0.93] around the repo's pass mark of 0.906 and the two layouts
   within 0.03 of each other;
5. sampler (a main path): `DiffusionSampler` with the flagship, 32
   diffusion steps and 32 rounds, on `uf20-synth-1.cnf` (flat, and dense as
   the sampler picks by itself) and on the primes formula; every counted
   sample is checked to satisfy its formula, and the kernel must have been
   launched on the flat chain;
6. training (a main path), at full width (128 feature maps, 128 query maps,
   8 heads, 32 train rounds) on 20 000-node batches of a cut training set
   (4000 instances where a real run takes 100 000: data quantity, not width
   or depth): the kernel's backward against autograd of the plain version,
   also for sliced cotangents; one forward and backward of the flagship's
   params through the kernel against the plain path (loss, all 24 gradient
   tensors over 4 and over 32 rounds, printed beside the plain path's own
   run-to-run spread, which must read 0.0, and beside both with the head
   losses left unsorted;
   launches per step against the reckoned 128 each way); 40 optimizer
   steps each of the dense f32, the dense block-bf16 and the flat kernel
   step from a seeded init (the mean loss of the last fifth must lie below
   0.9 of the first fifth's; steps per second; peak memory; the flat step
   must launch the kernel 128 times each way per step, the flat
   self-conditioning step 256 times); `python -m
   diffusionsat_torch.diffusion_training` in-process in both layouts (20
   steps) with one eval, a checkpoint, a restore (4 steps more) and the
   exported params read back by the solving eval; the flat run's checkpoint
   directory read by the solving eval (`--model_ckpt <run>/ckpt`) must give
   exactly the accuracy and the launches of the params exported at the same
   step; and a profile of one train step per layout;
7. uniformity (a main path), with the sampling flagship
   `query_sat_3sat_diffusion_mlk64_iso45.npz` at full width, 32 diffusion
   steps x 32 rounds: `python -m diffusionsat_torch.uniformity_benchmark`
   in-process on the first 3 formulas of the p24 panel at k = 10 (uniform,
   diffusion_nofreeze and diffusion_mh_xor on the dense chain, then
   diffusion_nofreeze on formula 0 through the flat chain, which must
   launch the kernel): the formula keys must equal the recorded panel's,
   every counted sample must satisfy its formula, diffusion_mh_xor must
   find every solution and have a smaller mean entropy gap than
   diffusion_nofreeze; a cut k64 training set (2000 instances where a real
   run takes 60 000: data quantity only); `python -m
   diffusionsat_torch.measure_bank_freq` on its first 2 batches with 4
   chains each, whose SAT and outside-the-bank rates must lie in the
   window the repo's table (`freq_iso45full.npz`) reads for batches of the
   same formula sizes; and 20 dense steps of `python -m
   diffusionsat_torch.diffusion_training` with `--label_samples 64
   --label_isolation_alpha 0.45` and that table, warm-started from the
   flagship (2 batches measured, the rest isolation-only, finite loss).
8. ANF (a main path), with the SHA-1 flagship `anf_sat_sha1_r17_130k.npz`
   at full width (128 / 128 maps): the 17-round test split of `python -m
   diffusionsat_torch.anf_eval`'s defaults (256 systems, 2-20 free bits)
   and a cut training split (64 systems where the training script takes
   2000: data quantity only); the kernel on the ANF plans of test batch 0
   (node -> clause, clause -> node, the AND scatter and its transpose) at
   F = 64 and 128 against its plain version, timed as in phase 2; the
   tiled pair (f32 and bf16 operands) against the kernel route on the same
   batch; `anf_eval` in-process, 32 rounds, flat through the kernel, whose
   per-variable accuracy and systems solved must lie within 0.01 and 0.06
   of the record `ANF_EVAL_130K.json` and whose launches must equal the
   count reckoned from the code; 20 tiled and 20 flat train steps (16
   rounds) from one seeded init, whose first losses at f32 tiles agree to
   1e-4 and whose losses on a fixed batch must fall, the flat steps'
   launches as reckoned; `python -m diffusionsat_torch.anf_training`
   in-process with eval, a checkpoint and a restore; anchored CDCL
   completion of the first 8 systems; and profiles of an eval round and
   of a train step in each layout.

9. graphs (many steps per dispatch): 4 CUDA-graphed dense train steps
   against 4 eager ones at full width on four 20 000-node batches from one
   state, f32 and block-bf16 (params, optimizer state, generator and every
   loss equal bit for bit; peak memory), 4 graphed flat ANF steps on padded
   plans against 4 eager ones (the same, and two eager runs equal to each
   other), graphed inference rounds against eager ones (`DSAT_EAGER=1`) on
   the solving eval's batch 0 (flat and dense) and on the uf20 sampler
   chain in both layouts (the same results and launch counts), the plain
   path's segment sums (run twice, timed by route), the wall and device
   busy share of each graphed path beside its eager counterpart, and a
   cut `python -m diffusionsat_torch.bench` (2 steps a replay) at f32 and
   block-bf16.
10. the generic entry point (a main path): `python -m diffusionsat_torch.main
   --model query_sat --task 3-sat` in-process at full width on a cut set
   (2000 training and 2000 test instances where a real run takes 100 000
   and 10 000): 20 flat train steps through the kernel with two evals and
   a checkpoint, then every eval mode, with the sweeps cut in list length
   (16, 64 and 256 rounds; 3 node budgets; 2 variable counts): the
   launches must equal the count reckoned from the code, the loss be
   finite, each mode write its file and the cactus CSV hold one row per
   test graph after the warm-up; a restore from the checkpoint that takes
   2 more steps at exactly 128 launches each way a step; the flagship
   through the harness on the first 4 batches of the eval split at 64
   rounds, through the kernel and through the plain path on the same
   draws (solved fractions within 0.01, launches as reckoned), and the
   invariance readings (the permuted one within 4 standard errors of the
   original), and the noise sweep over the same batches (launches as
   reckoned, the solved fraction at noise 0 not below the last's); one
   full-width flat train step on one batch of every
   registry task (ksat, splot, satlib, primes, mixed, sha1, clique,
   domset, kcolor): a finite loss and 128 launches each way; the kernel at
   `main`'s training shapes.

11. the other models (a main path): NeuroSAT, NeuroCore, SimpleNeuroSAT,
   QuerySATLit and AttentionSAT at the widths `main` gives them (128 /
   128 maps, 32 train and 64 test rounds where the config has them,
   NeuroSAT 32 and AttentionSAT 16) on the 20 000-node batch, random
   params from a seed: the kernel path against the kernel's plain version
   over the same plans at full depth (test-mode logits and loss, one
   training step's loss and every parameter gradient) and against the
   unplanned path at 4 rounds (the gradients with both paths' segment sums
   in the plans' order), the launches of a forward and of a step against
   `model_launches`, the count reckoned from the code, a step's wall,
   busy time and peak memory; then `python -m diffusionsat_torch.main
   --model <name>` in-process on phase 10's split, 4 steps and
   `--evaluate`: a finite loss and launches as reckoned; and the kernel on
   the batch's four plans, AttentionSAT's edge -> literal pair included.

12. the TSP stack, the hyperparameter search and the ANF studies (main
   paths): `TSPMatrixSE` with each core (DenseGNN, MatrixSE) at the
   model's widths (64 maps, 16 rounds) on 16 Euclidean 16-node instances,
   12 AdaBelief steps on that fixed batch from a seeded init, unsupervised
   with the host subtour cuts and supervised: the loss must fall, the
   trained model's logits and loss on the card must agree with the same
   params on the CPU (for the model that takes the cuts), a step's wall,
   busy time, host finder time and peak memory, and the optimality gap of greedy and beam-128 decoding on a
   test batch (a reading); `python -m diffusionsat_torch.hyperopt`
   in-process on its own data (1000 / 500 instances where the script
   takes 5000 / 500, the 6000-node bucket), 2 TPE trials of 20 steps (a
   study takes 20 of 2000): the launches
   must equal the count reckoned from the code, each trial's solved
   fraction through the kernel lie within 0.02 of its plain version's on
   the same params and draws, and its first step's loss through the
   kernel equal that through the plain version over the same plans; the
   kernel at a hyperopt batch's shapes at F = 16 and 64; `python -m
   diffusionsat_torch.anf_error_structure` with the flagship at 64 rounds
   and the input-anchor ladder on the test batches that hold the split's
   first 32 systems, against the JAX package's two records of those 32
   systems (`ANF_ANCHOR_R64.json` and `ANF_ANCHOR_CPU_SUBSET.json`:
   per-variable accuracy within 0.005 and systems solved raw and at each
   anchor level within 2 of the span the two read), its launches as reckoned and its wall split
   into device and host; and `python -m diffusionsat_torch.anf_prior_study`
   on the host over 8 systems of `ANF_MARG_R17_M16.npz`, timed, its
   conflicts beside the record's.

13. multi-device (a main path), at the flagship's full width over 4
   ranks: NCCL with one card a rank when 4 cards are visible, else 4 gloo
   ranks sharing the one card (all math and every kernel launch on the
   card, the collectives staged through the host; the transport is
   printed). Data parallelism on a 20 000-node threshold batch a rank, 2
   steps, dense f32 and flat through the kernel, and ANF with the r17
   flagship on 4 batches of the r17 training split at 16 rounds: the
   averaged loss and every averaged gradient against rank 0's mean of the
   four single-rank steps with the same draws, the params equal on every
   rank, the flat steps' launches as reckoned (128 each way a step); the
   clause-sharded step, with the all-reduce and with the halo exchange,
   on one 20 000-node batch split 4 ways with per-shard kernel plans,
   against the single-device planned step (4 rounds to 1e-4 of each
   tensor's largest entry, 32 rounds to phase 6's 1e-2 gate, the head
   order pinned to the single-device run), its launches as reckoned; the
   halo's rows and a round's bytes against the all-reduce's, and both
   exchanges timed; the sharded sampler chain of uf20 copies, 8 diffusion
   steps x 32 rounds a rank, bit for bit equal to each rank's chain alone,
   every counted sample satisfying; and the kernel on the shard's plans
   and on the halo's send and receive plans.

14. the f32-accumulating products (`ops/lowp.py`, the dense block-bf16
   train step's MLP and incidence products) at the dense training cell's
   block shapes, each route and its plain version within
   LOWP_ROUNDING_UNITS of the exact product: the forward on bf16 tensor
   cores with an f32 result, the backward's three-part split kernel
   (`csrc/split_mm.cu`, `ops/split_mm.py`) for the activation, weight and
   incidence-operand gradients; the f32 operand rounded to bf16, and a
   sliced reduction's partials rounded to bf16, each beyond it; two
   launches equal bit for bit; what the card's routes do not take raises;
   each product timed beside its bound, its plain version and the upcast
   f32 library route it replaced, and each of the two kernels' device
   time; the routes and launches of one replay of a graphed block-bf16
   chunk of full-width train steps, counted from zero (rows
   `split_mm_kernel` and `sum_slices_kernel` of the `kernels` line).

The full run makes its cached splits (`split_jobs`) ahead of the phases
that read them, in a process of its own (`chip_smoke.py --make-splits
DIR`) beside the card's work.

`python3 chip_smoke.py --only-anf` builds and runs phase 8 alone,
`--only-graphs` phase 9, `--only-main` phase 10 (after the eval split),
`--only-models` phase 11 (generating `main`'s split when phase 10 has
not left it), `--only-studies` phase 12, `--only-multi` phase 13 and
`--only-lowp` phase 14 (building only its own kernel). `--grad-gate-study` builds
and reads phase 11's 4-round gradient gate on more batches and seeds,
sound and with faults planted (`grad_gate_study`). Inference rounds run as CUDA graphs in every
phase (the launches a graph captured are credited once per replay).

`--baseline-kernel PATH`, beside any of the above, builds PATH (another
version of `csrc/segsum.cu` with the same C interface, such as an earlier
commit's) and times it beside the kernel on every row of the kernel table,
in turns (baseline, kernel, kernel, baseline): the rows gain
`baseline_ms` and both designs' readings. Its launches are not counted.

Every line of standard output is one JSON object, except the card line of
`nvidia-smi` and the lines that the entry points run in-process print
themselves (the eval's count of test batches, the sampler's note when it
stops a formula early, the training script's, the battery's and the
measurement's progress lines). The line before the last lists the kernels; the last line is `{"ok": true,
"device": {...}}`. Without CUDA, or run outside a checkout of the
repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "pretrained" / "query_sat_3sat_diffusion_mlk64.npz"
ASSETS = ROOT / "diffusionsat_torch" / "data" / "assets"
UF20 = ASSETS / "satlib" / "uf20-synth-1.cnf"
PRIMES = ASSETS / "primes" / "primes_3599_61x59.cnf"
ISO45 = ROOT / "pretrained" / "query_sat_3sat_diffusion_mlk64_iso45.npz"
PANEL = ROOT / "benchmarks_iso45full_p24.jsonl"
FREQ_TABLE = ROOT / "freq_iso45full.npz"
KERNEL_SOURCE = "diffusionsat_torch/csrc/segsum.cu"
REPLACES = "diffusionsat_tpu/ops/pallas_segsum.py:97"

# published H100 SXM peaks at 700 W (memory rate, f32 outside the tensor
# cores); the bound is the larger of bytes / rate and operations / rate
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

# kernel vs plain: both sum each segment's columns in plan order, so they
# are gated equal bit for bit; this tolerance holds the library calls, and
# the kernel as well before the exact gate
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# 4 recurrent rounds amplify that summation-order difference
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
# 64 noisy rounds diverge per graph; the solved fractions must agree
SOLVED_FRACTION_TOL = 0.05
# one training forward and backward, kernel against plain path: the loss,
# and every gradient tensor to this share of its largest entry (floored at
# a hundredth of the largest gradient of all), with the rank order of the
# head losses pinned to the plain run's: the kernel and the plain path sum
# in two different orders, and a near-tie of two heads' losses can swap
# their rank weights. The plain path sums in one fixed order, so it must
# equal itself (it lay 6e-4 to 1.1e-2 from itself while its sums took
# atomics)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-2
# training: the mean loss of the last fifth of the steps against the first
# (150 steps until the uniformity phase joined the run, 80 until the ANF
# phase did and 64 until the multi-device phase did; cut to keep the
# script inside its time limit on a slow host)
TRAIN_STEPS = 40
LOSS_FALL_FACTOR = 0.9
# launches of each direction in one 32-round flat train step: 2 a round
# forward, and 2 a round as the backward of the other direction
LAUNCHES_PER_TRAIN_STEP = 128
# the cut training set of the smoke run, and the training script's steps
# in-process (50 until the multi-device phase joined the run), a checkpoint
# at the last, and the steps a restore adds
TRAIN_SIZE = 4000
SCRIPT_STEPS = 20
SCRIPT_RESTORE_STEPS = 4
# the solving eval: the repo's record reads 0.906 on a 2000-instance split
# (binomial standard error 0.0065); this run's split is another draw of the
# same distribution, so the window is about 3.5 standard errors wide
PASS_MARK_WINDOW = (0.88, 0.93)
LAYOUT_GAP_TOL = 0.03
# the uniformity phase: panel formulas, samples per solution, the cut k64
# training set (a real run takes 60 000 instances) and the measurement
UNIFORMITY_FORMULAS = 3
UNIFORMITY_K = 10
BANK_TRAIN_SIZE = 2000
BANK_K = 64
FREQ_BATCHES = 2
# 8 chains a batch until the ANF phase joined the run
FREQ_CHAINS = 4
# the measured rates must lie within this margin of the range the repo's
# table reads over its batches of similar graph counts (+-10 graphs a
# batch: a 20 000-node batch holds fewer graphs the larger its formulas)
FREQ_RATE_MARGIN = 0.02
FREQ_SIMILAR_GRAPHS = 10
REWEIGHTED_STEPS = 20
# the ANF phase: the flagship of the repo's ANF pass mark, read against
# ANF_EVAL_130K.json (accuracy 0.9114 over about 1M variables; systems
# solved 0.1367 over 256 systems, binomial standard error 0.021, so a
# window of about 3 standard errors)
ANF_CKPT = ROOT / "pretrained" / "anf_sat_sha1_r17_130k.npz"
ANF_PASS_MARK = {"accuracy": (0.9114, 0.01), "total_accuracy": (0.1367, 0.06)}
# the cut training split (the training script's default is 2000 systems:
# data quantity, not width or depth), its test split for the in-process
# script, the steps of each training layout and the first-loss tolerance
# between the tiled (f32 tiles) and the flat step
ANF_TRAIN_SIZE = 64
ANF_SCRIPT_TEST_SIZE = 8
ANF_TRAIN_STEPS = 20
ANF_FIRST_LOSS_RTOL = 1e-4
ANF_COMPLETION_SYSTEMS = 8
# phase 9: graphed dense train steps a replay against as many eager ones
# (8 until the multi-device phase joined the run), and the cut bench's
# steps a replay (the bench's default is 8)
GRAPHS_MEGA_STEPS = 4
GRAPHS_BENCH_MEGA_STEPS = 2
# the generic entry point (phase 10): a cut training and test set (a real run
# takes 100 000 and 10 000 instances: data quantity, not width; the test
# set holds more than the cactus's 10 warm-up batches), its steps, and
# the sweeps cut in list length (the CLI's defaults are 16..4096 rounds,
# 21 node budgets and 9 variable counts)
MAIN_TRAIN_SIZE = 2000
MAIN_TEST_SIZE = 2000
MAIN_TRAIN_STEPS = 20
MAIN_EVAL_EVERY = 10
MAIN_ROUND_GEN = (16, 64, 256)
MAIN_BATCH_GEN = (3000, 11000, 20000)
MAIN_VARIABLE_GEN = range(10, 30, 10)
# the flagship through the harness: eval batches, rounds, the gap allowed
# between the kernel's and the plain path's solved fractions on the same
# draws, and the permuted invariance reading's distance from the original
# in standard errors of the original's solved fraction
HARNESS_BATCHES = 4
HARNESS_ROUNDS = 64
HARNESS_SOLVED_TOL = 0.01
INVARIANCE_STANDARD_ERRORS = 4
# one full-width train step on one batch of every registry task
REGISTRY_TASKS = ("ksat", "splot", "satlib", "primes", "mixed", "sha1",
                  "clique", "domset", "kcolor")
# the other model family (phase 11), at the widths `main` gives it
# (feature_maps 128, query_maps 128, train_rounds 32, test_rounds 64 where
# the config has the field: NeuroSAT runs 32 rounds, AttentionSAT 16)
OTHER_MODELS = ("neuro_sat", "neurocore", "simple_neurosat", "query_sat_lit",
                "attention_sat")
OTHER_MODELS_STEPS = 4
# kernel path against the kernel's plain version over the same plans, at
# `main`'s depth: the two sum every segment in plan order, so they must
# agree to f32 summation order (in practice to the bit)
OTHER_MODELS_SAME_ORDER_TOL = dict(rtol=1e-5, atol=1e-5)
OTHER_MODELS_SAME_ORDER_GRAD_TOL = 1e-4
# kernel path against the unplanned path (gather and segment sums, no
# plans) at OTHER_MODELS_SHORT_ROUNDS rounds: these random models amplify
# f32 rounding with depth (NeuroCore's 64-round logits lie O(1) from a
# float64 run, a hundredth of that at 4 rounds), so the depth is cut;
# logits to this share of their largest entry and the loss relative, each
# path in its own summation order. Gradients are compared with every
# segment sum of both paths in row order, the plans' order
# (`sequential_segment_sums`): in any two orders the standardized states of
# NeuroCore and SimpleNeuroSAT leave them up to 0.1 of a tensor's largest
# entry apart, either path as far from float64 as the other, and a planted
# 1 % error or a plan that lost one edge in a thousand hides in that
# spread (`--grad-gate-study`). Each tensor's error is a share of its
# largest entry, floored at a hundredth of the largest gradient of all.
# The tolerance is the geometric mean of the study's largest sound reading
# (1.6e-3, NeuroCore) and its smallest reading of a planted fault (3.5e-3,
# NeuroCore with one edge in a thousand dropped), 45 cases on an H100
OTHER_MODELS_SHORT_ROUNDS = 4
OTHER_MODELS_LOGIT_SHARE = 2e-3
OTHER_MODELS_LOSS_RTOL = 1e-4
OTHER_MODELS_ORDERED_GRAD_TOL = 2.4e-3
# `--grad-gate-study`: batches and params/noise seeds per model, and the
# faults planted in the planned sums' backward (`planted_fault`)
GATE_STUDY_BATCHES = 3
GATE_STUDY_SEEDS = 3
GATE_STUDY_FAULTS = ("scale_1e-2", "drop_1000", "drop_100")

# phase 12: the TSP stack at the model's own widths (64 maps, 16 rounds,
# 16-node Euclidean instances, batch 16), each core trained on one fixed
# batch from a seeded init, unsupervised with subtour cuts and supervised
TSP_NODES = 16
TSP_BATCH = 16
TSP_FEATURES = 64
TSP_ROUNDS = 16
TSP_STEPS = 12
TSP_LR = 3e-3
# the trained model on the card against the same params on the CPU: logits
# to this share of their largest entry, losses relative
TSP_CPU_SHARE = 1e-4
TSP_CPU_LOSS_RTOL = 1e-4
TSP_BEAM_WIDTH = 128
# the hyperparameter search on its own data (500 test instances, 3-20
# variables, the 6000-node bucket) with 1000 training instances where the
# script takes 5000, 2 TPE trials of 20 steps where a study takes 20 of
# 2000: data quantity and loop length only
HYPEROPT_TRAIN_SIZE = 1000
HYPEROPT_TRIALS = 2
HYPEROPT_STEPS = 20
HYPEROPT_SOLVED_TOL = 0.02
HYPEROPT_WIDTHS = (16, 64)
# the ANF error-structure study with the flagship, 64 rounds, the input
# anchor ladder, on the test batches that hold the first 32 systems of the
# split, against those systems in the JAX package's two records of the
# study (on its TPU, and on the CPU with the same keys): the per-variable
# accuracy within 0.005 and the systems solved raw and at each anchor
# level within 2 of the span the two records read. The draws cannot be
# replayed on the card, and the two records themselves differ by up to 4
# systems a level on these 32 (PERF.md, section 6)
ANF_STUDY_SYSTEMS = 32
ANF_STUDY_RECORDS = (ROOT / "ANF_ANCHOR_R64.json",
                     ROOT / "ANF_ANCHOR_CPU_SUBSET.json")
ANF_STUDY_ACC_TOL = 0.005
ANF_STUDY_SYSTEMS_TOL = 2
# the input-prior study on the host: the first 8 systems of the repo's
# marginals of the same split, beside the record's conflicts
PRIOR_MARGINALS = ROOT / "ANF_MARG_R17_M16.npz"
PRIOR_RECORD = ROOT / "ANF_PRIOR_R17.json"
PRIOR_SYSTEMS = 8

# phase 13: multi-device at the flagship's full width (128 / 128 maps, 8
# heads, 32 train rounds) over 4 ranks, one card each under NCCL when 4
# are visible, else 4 gloo ranks sharing one card (every collective staged
# through the host). Data quantity is cut, not width: one 20 000-node
# threshold batch of CDCL-labelled formulas a DP rank (2 steps), one such
# batch split 4 ways by
# clause for the sharded steps, 4 batches of the r17 training split for
# ANF DP at 16 rounds, and 8 diffusion steps x 32 rounds of uf20 copies a
# rank for the sharded chain
MULTI_RANKS = 4
MULTI_DP_STEPS = 2
MULTI_ANF_ROUNDS = 16
MULTI_CHAIN_STEPS = 8
# the DP step's averaged gradients against rank 0's mean of the four
# single-rank gradients, to this share of each tensor's largest entry
# (floored at a hundredth of the largest gradient of all: the last
# update_gate bias has a true gradient of zero)
MULTI_DP_GRAD_TOL = 1e-5
# the sharded steps against the single-device planned step with the same
# draws and the head order pinned: the partial sums, their all-reduce and
# the ranks' shares of the backward add in other orders than the whole
# batch's plans. At 4 rounds to this share of each tensor's largest entry,
# or, where more, to MULTI_GP_ORDER_FACTOR times the distance of the
# single-device unplanned path (another summation order on one device)
# from the planned one; at 32 rounds phase 6's gate (TRAIN_GRAD_TOL) of
# kernel against plain path
MULTI_GP_SHORT_ROUNDS = 4
MULTI_GP_SHORT_TOL = 1e-4
MULTI_GP_ORDER_FACTOR = 2
MULTI_EXCHANGE_ITERS = 20

# phase 14: the f32-accumulating products of `ops/lowp.py` at the dense
# training cell's block shapes (G, Vg, Cg): its largest graph count at the
# smallest block (`portbench/drivers/train_dense.LEVELS`), its largest
# clause-row chunk and its largest block. Each route and its plain version
# lie within LOWP_ROUNDING_UNITS * 2**-24 * sum_k |a_ik||b_kj| of the exact
# product, an entry: a sum of exact products in f32 errs by a few units of
# 2**-24 of that sum of magnitudes whatever its length, as its roundings
# fall on partial sums of random sign (the split kernel read up to 16.6,
# the upcast cuBLAS product 11.3, over these shapes, reduced over 8 to
# 24 576). A product rounded below f32 lies far beyond it: the f32
# operand rounded to bf16 reads about 2**15 / sqrt(K) (200 at K = 24 576),
# as do a sliced reduction's partials rounded to bf16; both are checked
# to fail. Timed at LOWP_TIMED_BLOCK
LOWP_ROUNDING_UNITS = 32
LOWP_BLOCKS = ((512, 6, 48), (384, 12, 64), (112, 30, 136))
LOWP_TIMED_BLOCK = (384, 12, 64)


def train_argv(data_dir: Path) -> list[str]:
    """The training script's data flags for phase 6's cut training set."""
    return ["--train_size", str(TRAIN_SIZE), "--test_size", "2000",
            "--data_dir", str(data_dir)]


def bank_argv(data_dir: Path) -> list[str]:
    """The training script's data flags for phase 7's cut k64 set."""
    return ["--train_size", str(BANK_TRAIN_SIZE), "--test_size", "200",
            "--label_samples", str(BANK_K), "--data_dir", str(data_dir)]


def anf_data_args(data_dir: Path, *argv: str):
    """`anf_eval`'s data flags (its defaults: the 17-round test split)
    with `argv` on top."""
    import argparse

    from diffusionsat_torch import anf_eval

    p = argparse.ArgumentParser()
    anf_eval.add_data_args(p, train_size=8000, test_size=256)
    return p.parse_args(["--data_dir", str(data_dir), *argv])


def main_argv(data_dir: Path, run_root: Path, every: int) -> list[str]:
    """`main`'s flags for phases 10 and 11 on the cut 3-SAT set."""
    return ["--model", "query_sat", "--task", "3-sat",
            "--train_size", str(MAIN_TRAIN_SIZE),
            "--test_size", str(MAIN_TEST_SIZE), "--eval_every", str(every),
            "--ckpt_every", str(every), "--data_dir", str(data_dir),
            "--train_dir", str(run_root)]


def split_jobs(data_dir: Path, workers: int | None = None) -> dict:
    """The cached splits that the full run reads, by name, in the order its
    phases first read them: each a function that generates its split into
    `data_dir` (or reads it back from there) and returns the batches.
    `workers` caps the generator processes (None: the host's cores); the
    splits do not depend on it."""
    from diffusionsat_torch import anf_eval, build_3sat_cache, hyperopt
    from diffusionsat_torch import main as generic
    from diffusionsat_torch import solve_eval
    from diffusionsat_torch.config import parse_config
    from diffusionsat_torch.data.datasets import SatDataset
    from diffusionsat_torch.graph.batch import BucketSpec

    flags = ["--gen_workers", str(workers)] if workers else []

    def eval_split():
        return list(solve_eval.build_dataset(
            60000, 2000, 3, 30, seed=0, data_dir=data_dir,
            gen_workers=workers).test_data())

    def script_split(argv):
        # the training split, and the test split of the script's eval, as
        # the flagship's cache builder makes them
        train, test = build_3sat_cache.build(parse_config(argv + flags))
        return list(train), list(test)

    def main_split():
        cfg = parse_config(main_argv(data_dir, data_dir / "main_runs",
                                     MAIN_EVAL_EVERY) + flags)
        bucket = BucketSpec.for_node_budget(cfg.max_nodes_per_batch)
        ds = SatDataset(generic.build_instances(cfg), bucket,
                        cache_dir=data_dir,
                        name=f"3-sat_{cfg.min_vars}_{cfg.max_vars}_"
                             f"{cfg.train_size}", seed=cfg.seed,
                        gen_workers=cfg.gen_workers or None)
        # the sweeps' small splits in one process: a pool's spawned
        # workers take longer to start than these 10-50 instances take to
        # generate
        one = dataclasses.replace(cfg, gen_workers=1)
        vargen = {c: len(generic._test_split(one, bucket, f"vargen_{c}_{c}",
                                             c, c, 10))
                  for c in MAIN_VARIABLE_GEN}
        for budget in MAIN_BATCH_GEN:
            generic._test_split(one, BucketSpec.for_node_budget(budget),
                                f"batchgen_{budget}", cfg.min_vars,
                                cfg.max_vars, 50)
        return ds.train_data().batches, list(ds.test_data()), vargen

    def anf_train_split():
        # the cut training split, and the test split of the training
        # script's eval
        ds = anf_eval.build_anf_dataset(anf_data_args(
            data_dir, "--train_size", str(ANF_TRAIN_SIZE), "--test_size",
            str(ANF_SCRIPT_TEST_SIZE)))
        ds.test_data()
        return ds, ds.train_data()

    def hyperopt_split():
        # in one process: a pool's spawned workers take longer to start
        # than these instances take to label
        ds = hyperopt.build_dataset(train_size=HYPEROPT_TRAIN_SIZE,
                                    data_dir=str(data_dir), gen_workers=1)
        return ds, len(ds.train_data()), len(ds.test_data())

    return {
        "eval": eval_split,
        "train": lambda: script_split(train_argv(data_dir)),
        "bank": lambda: script_split(bank_argv(data_dir)),
        "anf_test": lambda: anf_eval.build_anf_dataset(
            anf_data_args(data_dir)).test_data(),
        "anf_train": anf_train_split,
        "main": main_split,
        "hyperopt": hyperopt_split,
    }


def make_splits(data_dir: Path) -> int:
    """`--make-splits DIR`: every split of `split_jobs` into DIR, in order,
    on all but two of the host's cores (the card's phases run beside it),
    printing `split <name> <seconds>` as each is in the cache."""
    import os

    jobs = split_jobs(data_dir, workers=max(1, (os.cpu_count() or 1) - 2))
    for name, job in jobs.items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            job()
        print(f"split {name} {time.perf_counter() - t0:.3f}", flush=True)
    return 0


class Splits:
    """The run's cached splits. With `ahead`, a process of its own
    (`chip_smoke.py --make-splits`, in a session of its own so that its
    generator pool stops with it) makes them all in `split_jobs`' order
    while the card works, and `get` waits for the one it is asked for;
    without, `get` makes it there and then."""

    def __init__(self, data_dir: Path, ahead: bool):
        self.jobs = split_jobs(data_dir)
        self.made: dict[str, float] = {}
        self.proc = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--make-splits",
             str(data_dir)], stdout=subprocess.PIPE, text=True,
            start_new_session=True) if ahead else None

    def get(self, name: str):
        """(the split's batches, timings: `made_s` the maker's seconds for
        it, `waited_s` for the maker here, `read_s` to read it back or,
        without a maker, to make it)."""
        t0 = time.perf_counter()
        while self.proc is not None and name not in self.made:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(f"the split maker stopped (exit code "
                                   f"{self.proc.wait()}) before {name}")
            if line.startswith("split "):
                _, made, seconds = line.split()
                self.made[made] = float(seconds)
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = self.jobs[name]()
        return out, dict(made_s=self.made.get(name), waited_s=t1 - t0,
                         read_s=time.perf_counter() - t1)

    def close(self) -> None:
        """Stop the maker and its pool if they still run."""
        if self.proc is None:
            return
        if self.proc.poll() is None:
            import os
            import signal

            os.killpg(self.proc.pid, signal.SIGTERM)
        self.proc.wait()
        self.proc.stdout.close()


class KernelTotal:
    """One kernel's device time over a profile: `key` its name, `count` its
    launches, `self_device_time_total` its microseconds (the fields of
    `key_averages`' rows that the readings use)."""

    def __init__(self, key: str):
        self.key = key
        self.count = 0
        self.self_device_time_total = 0.0


@contextlib.contextmanager
def plain_version():
    """Every planned sum through the kernel's plain version (the same plans,
    the same order) instead of the kernel, and no launch counted."""
    from diffusionsat_torch.ops import segsum

    kernel = segsum.gather_segsum

    def plain(x, plan):
        segsum._check(x, plan)
        return segsum.segsum_plain(x, plan)

    segsum.gather_segsum = plain
    try:
        yield
    finally:
        segsum.gather_segsum = kernel


def model_launches(name: str, rounds: int, training: bool) -> dict:
    """Kernel launches per plan direction of one forward of `rounds` rounds
    (`training=False`) or one training step (forward and backward) of a
    model of the other family with plans, reckoned from the code:

    - NeuroSAT and NeuroCore, a round: lit -> clause 3 (the messages, and
      two losses or a loss and the SAT check), clause -> lit 1; backward 1
      and 2 (every aggregation but the rounded count's feeds the loss);
    - SimpleNeuroSAT: one more each way for the query's clause loss;
    - QuerySATLit: 3 and 2 forward (the closed-form query gradient takes
      one each way), 2 and 2 backward;
    - AttentionSAT: 5 and 2 forward and the attention's edge -> literal sum,
      backward 2 and 4 and the transpose of the edge sum, less one clause
      -> literal in the first round, whose literal state is the constant
      zero state."""
    per_round = {"neuro_sat": ((3, 1), (4, 3)),
                 "neurocore": ((3, 1), (4, 3)),
                 "simple_neurosat": ((4, 1), (5, 4)),
                 "query_sat_lit": ((3, 2), (5, 4)),
                 "attention_sat": ((5, 2), (7, 6))}
    l2c, c2l = per_round[name][training]
    out = {"lit_to_clause": l2c * rounds, "clause_to_lit": c2l * rounds}
    if name == "attention_sat":
        out["edge_to_lit"] = rounds
        if training:
            out["clause_to_lit"] -= 1
            out["lit_to_edge"] = rounds
    return out


def hyperopt_launches(cfg, steps: int, eval_batches: int) -> dict:
    """Kernel launches per CNF direction of a hyperopt trial's `steps`
    train steps and its eval over `eval_batches` batches, reckoned from the
    code: a flat QuerySAT training round launches 4 each way (2 forward:
    the message pass and the query's clause loss, whose gradient is closed
    form; 2 backward), an inference round 2 each way, every round of the
    fixed-count loops."""
    n = 4 * cfg.train_rounds * steps + 2 * cfg.test_rounds * eval_batches
    return {d: n for d in ("lit_to_clause", "clause_to_lit")}


def grads_err(ga, gb) -> float:
    """Largest gradient error as a share of its tensor's largest entry,
    floored at a hundredth of the largest gradient of all."""
    floor = max(g.abs().max().item() for g in gb) / 100
    return max((a - b).abs().max().item() /
               max(b.abs().max().item(), floor) for a, b in zip(ga, gb))


def other_model(name: str, cfg, batch, dev, params_seed: int = 0,
                noise_seed: int = 1):
    """One model of the other family at the widths `cfg` (main's config)
    gives it, random params from `params_seed`, and the calls phase 11 and
    the gradient-gate study make of it on `batch`: `rounds(training)`,
    `forward(plans, rounds)` (test mode), `train_step(plans, rounds)` ->
    (loss, parameter gradients) and `train_step_f64(rounds)`, the
    unplanned path's gradients in float64. Every call draws its round
    noise anew from `noise_seed`."""
    import dataclasses
    import types

    import torch
    from torch.utils import _pytree as pytree

    from diffusionsat_torch.nn import mlp as mlp_module
    from diffusionsat_torch.registry import MODEL_REGISTRY

    def seeded(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    cls, init, apply = MODEL_REGISTRY.resolve(name)
    fields = {f.name for f in dataclasses.fields(cls)}
    model_cfg = cls(**{k: getattr(cfg, k) for k in (
        "feature_maps", "query_maps", "train_rounds", "test_rounds")
        if k in fields})
    params = init(seeded(params_seed), model_cfg)

    def rounds(training):
        if "rounds" in fields:
            return model_cfg.rounds
        return model_cfg.train_rounds if training else model_cfg.test_rounds

    def noise_of(n):
        noise_rows = {"query_sat_lit": batch.V, "attention_sat": 2 * batch.V}
        if name not in noise_rows:
            return {}
        return {"round_noise": torch.randn(
            (n, noise_rows[name], 4), generator=seeded(noise_seed),
            device=dev, dtype=torch.float32)}

    def forward(plans, n):
        return apply(params, model_cfg, batch, None, training=False,
                     rounds=n, plans=plans, device=dev, **noise_of(n))

    def grads_of(loss, leaves):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return [torch.zeros_like(t) if g is None else g
                for g, t in zip(grads, leaves)]

    def train_step(plans, n):
        leaves = [t.detach().requires_grad_(True)
                  for t in pytree.tree_leaves(params)]
        tree = pytree.tree_unflatten(leaves, pytree.tree_structure(params))
        loss = apply(tree, model_cfg, batch, None, training=True, rounds=n,
                     plans=plans, device=dev, **noise_of(n))[1]
        return loss.detach(), grads_of(loss, leaves)

    def train_step_f64(n):
        noise = {k: v.double() for k, v in noise_of(n).items()}
        p64 = pytree.tree_map(lambda t: t.double(), params)
        b64 = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name).double()
            for f in dataclasses.fields(batch)
            if isinstance(getattr(batch, f.name), torch.Tensor) and
            getattr(batch, f.name).is_floating_point()})
        leaves = pytree.tree_leaves(p64)
        for t in leaves:
            t.requires_grad_(True)
        f32acc = mlp_module.linear_f32acc
        mlp_module.linear_f32acc = torch.matmul  # products in float64 too
        torch.set_default_dtype(torch.float64)
        try:
            loss = apply(p64, model_cfg, b64, None, training=True, rounds=n,
                         device=dev, **noise)[1]
            return grads_of(loss, leaves)
        finally:
            torch.set_default_dtype(torch.float32)
            mlp_module.linear_f32acc = f32acc

    return types.SimpleNamespace(name=name, cfg=model_cfg, params=params,
                                 rounds=rounds, forward=forward,
                                 train_step=train_step,
                                 train_step_f64=train_step_f64)


@contextlib.contextmanager
def sequential_segment_sums():
    """The plain path's segment sums in row order on the card too (one
    pass of `torch.segment_reduce`, as on the CPU), instead of blocks of
    `graph_ops.BLOCK_ROWS` rows first: the literal-clause sums then add
    each segment's terms in the order the kernel's plans do."""
    from diffusionsat_torch.ops import graph_ops

    blocked = graph_ops._sorted_sum
    graph_ops._sorted_sum = functools.partial(blocked, blocked=False)
    try:
        yield
    finally:
        graph_ops._sorted_sum = blocked


def _dropping(plan, every: int):
    """`plan` without every `every`-th real edge (a plan built wrong)."""
    import torch

    E, M = int(plan.row_ptr[-1]), plan.num_segments
    keep = torch.ones(E, dtype=torch.bool, device=plan.gather.device)
    keep[::every] = False
    seg = torch.repeat_interleave(
        torch.arange(M, device=keep.device), plan.row_ptr.diff().long(),
        output_size=E)
    row_ptr = torch.zeros(M + 1, dtype=torch.int32, device=keep.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(seg[keep], minlength=M), 0)
    return dataclasses.replace(plan, row_ptr=row_ptr,
                               gather=plan.gather[:E][keep].contiguous())


@contextlib.contextmanager
def planted_fault(kind: str):
    """A fault planted in the planned sums' backward, for the gradient
    gate to see: "scale_1e-2" scales every planned backward by 1 + 1e-2;
    "drop_1000" / "drop_100" run it over plans that lost every 1000th /
    100th real edge. The forward stays sound."""
    from diffusionsat_torch.ops import segsum

    fn = segsum._PlannedSpMM
    sound = fn.__dict__["backward"]
    dropped: dict = {}

    def backward(ctx, grad):
        if kind == "scale_1e-2":
            gx, a, b = sound.__func__(ctx, grad)
            return gx * (1 + 1e-2), a, b
        every = int(kind.split("_")[1])
        key = id(ctx.bwd)
        if key not in dropped:
            dropped[key] = (ctx.bwd, _dropping(ctx.bwd, every))
        grad = grad.contiguous()
        return fn.apply(grad, dropped[key][1], ctx.fwd), None, None

    fn.backward = staticmethod(backward)
    try:
        yield
    finally:
        fn.backward = sound


T0 = time.perf_counter()


def ptxas_lines(build_log: str) -> list[str]:
    """What `-Xptxas -v` said of each kernel instantiation: its name, its
    registers, and its stack and spills."""
    return [ln.strip() for ln in build_log.splitlines()
            if "Compiling entry function" in ln or "Used" in ln or
            "spill" in ln]


def emit(**obj):
    """One JSON line, with the script's seconds so far (`t`)."""
    print(json.dumps({**obj, "t": round(time.perf_counter() - T0, 1)}),
          flush=True)


def uniformity_phase(dev, data_dir: Path, sync, busy_seconds,
                     splits: Splits) -> dict:
    """Phase 7: the uniformity battery, the cut k64 bank, the bank-frequency
    measurement and reweighted training. `busy_seconds(fn)` runs `fn` under
    the profiler and returns the device's busy seconds. Returns the segsum
    launches of the flat battery."""
    import numpy as np

    from diffusionsat_torch import (
        diffusion_training,
        measure_bank_freq,
        uniformity_benchmark,
    )
    from diffusionsat_torch.diffusion.sampler import (
        make_dense_diffusion_chain,
    )
    from diffusionsat_torch.graph.dense_batch import densify_batches_quantized
    from diffusionsat_torch.ops import segsum
    from diffusionsat_torch.sat.cnf import VariableAssignment
    from diffusionsat_torch.train.checkpoint import load_model
    from diffusionsat_torch.uniformity import reweight
    from diffusionsat_torch.uniformity.benchmarks_file import formula_key

    uni_dir = ROOT / "runs" / "chip_smoke_uniformity"
    shutil.rmtree(uni_dir, ignore_errors=True)
    uni_dir.mkdir(parents=True)
    recorded = [json.loads(ln) for ln in
                PANEL.read_text().splitlines()][:UNIFORMITY_FORMULAS]
    panel = uniformity_benchmark.gen_benchmark_formulas(UNIFORMITY_FORMULAS)
    keys = [formula_key(clauses) for _, clauses, _ in panel]
    if keys != [r["key"] for r in recorded]:
        raise RuntimeError("the panel's formula keys differ from the "
                           "recorded panel's")

    def run_battery(name, variants, layout, n_formulas):
        out = uni_dir / f"{name}.jsonl"
        segsum.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        uniformity_benchmark.main([
            "--model_ckpt", str(ISO45), "--n_formulas", str(n_formulas),
            "--k", str(UNIFORMITY_K), "--variants", ",".join(variants),
            "--layout", layout, "--device", str(dev), "--out", str(out)])
        sync()
        wall = time.perf_counter() - t0
        launched = dict(segsum.LAUNCHES)
        recs = [json.loads(ln) for ln in out.read_text().splitlines()]
        for rec, (n, clauses, _) in zip(recs, panel):
            for variant in variants:
                for key in rec[variant]["counts"]:
                    asgn = VariableAssignment(n, clauses)
                    asgn.assign_all_from_int(int(key))
                    if not asgn.satisfiable():
                        raise RuntimeError(f"{name}: {variant} counted an "
                                           f"UNSAT sample on formula "
                                           f"{rec['formula']}")
        return recs, launched, wall

    def battery_row(rec, variant):
        r = rec[variant]
        row = dict(chi2_p=r["chi2_p"], diversity=r["diversity"],
                   entropy_gap=r["uniform_entropy"] - r["count_entropy"],
                   seconds=r["elapsed_s"], ms_per_distinct=r["ms_per_distinct"],
                   success_rate=r.get("success_rate"))
        if "refine_s" in r:
            row.update(refine_host_s=r["refine_s"],
                       chain_s=r["elapsed_s"] - r["refine_s"])
        return row

    variants = ("uniform", "diffusion_nofreeze", "diffusion_mh_xor")
    recs, dense_launches, wall = run_battery(
        "battery_dense", variants, "dense", UNIFORMITY_FORMULAS)
    if any(dense_launches.values()):
        raise RuntimeError("the dense battery launched the segsum kernel")
    gaps = {v: [] for v in variants}
    for rec, rec_tpu in zip(recs, recorded):
        for v in variants:
            gaps[v].append(rec[v]["uniform_entropy"] -
                           rec[v]["count_entropy"])
        emit(phase="uniformity_battery", formula=rec["formula"],
             key=rec["key"], n_vars=rec["n_vars"],
             n_solutions=rec["n_solutions"], n_samples=rec["n_samples"],
             layout="dense", k=UNIFORMITY_K,
             **{v: battery_row(rec, v) for v in variants},
             recorded_k40={v: battery_row(rec_tpu, v) for v in variants},
             note="recorded_k40: the repo's records of the same formula at "
                  "k = 40; their seconds are TPU times, not targets")
        if rec["diffusion_mh_xor"]["diversity"] != 1.0:
            raise RuntimeError(f"diffusion_mh_xor missed solutions of "
                               f"formula {rec['formula']}")
    mean_gap = {v: float(np.mean(g)) for v, g in gaps.items()}
    flat_recs, uni_launches, flat_wall = run_battery(
        "battery_flat", ("diffusion_nofreeze",), "flat", 1)
    emit(phase="uniformity_battery_flat", formula=0, layout="flat",
         k=UNIFORMITY_K, diffusion_nofreeze=battery_row(
             flat_recs[0], "diffusion_nofreeze"),
         dense_diffusion_nofreeze=battery_row(recs[0], "diffusion_nofreeze"),
         launches=uni_launches, wall_s=flat_wall)
    emit(phase="uniformity_summary", formulas=UNIFORMITY_FORMULAS,
         k=UNIFORMITY_K, mean_entropy_gap=mean_gap, dense_wall_s=wall,
         recorded_k40_mean_entropy_gap={
             v: float(np.mean([r[v]["uniform_entropy"] -
                               r[v]["count_entropy"] for r in recorded]))
             for v in variants})
    if not mean_gap["diffusion_mh_xor"] < mean_gap["diffusion_nofreeze"]:
        raise RuntimeError(f"diffusion_mh_xor's mean entropy gap is not "
                           f"below diffusion_nofreeze's: {mean_gap}")
    for direction, count in uni_launches.items():
        if count <= 0:
            raise RuntimeError(f"segsum kernel ({direction}) was not "
                               "launched on the flat uniformity battery")

    # the cut k64 training set, its test split, and the measurement of the
    # sampler's bank frequencies on its first batches
    (bank_batches, bank_test), timing = splits.get("bank")
    emit(phase="bank_split", **timing,
         instances=sum(int(b.n_graphs) for b in bank_batches),
         batches=len(bank_batches), test_batches=len(bank_test), K=BANK_K,
         graphs_per_batch=[int(b.n_graphs) for b in bank_batches],
         cut_from=60000, note="data quantity is cut, not width or depth")
    table_path = uni_dir / "freq.npz"
    sync()
    t0 = time.perf_counter()
    agg = measure_bank_freq.main([
        "--model_ckpt", str(ISO45), "--chains", str(FREQ_CHAINS),
        "--max_batches", str(FREQ_BATCHES), "--train_size",
        str(BANK_TRAIN_SIZE), "--label_samples", str(BANK_K), "--data_dir",
        str(data_dir), "--device", str(dev), "--out", str(table_path)])
    sync()
    freq_wall = time.perf_counter() - t0
    # one chain more on batch 0, profiled
    params, cfg = load_model(ISO45, dev, test_rounds=32)
    chain = make_dense_diffusion_chain(cfg, diffusion_steps=32,
                                       test_rounds=32, freeze_sat=False)
    dense0 = densify_batches_quantized([bank_batches[0]])[0].to(dev)

    def one_chain():
        chain(params, dense0, measure_bank_freq.chain_generator(0, 0, 0, dev))
        sync()

    chain_busy = busy_seconds(one_chain)
    wall_per_chain = agg["wall_s"] / (FREQ_BATCHES * FREQ_CHAINS)
    # the window: the repo's table over its batches of similar graph counts
    with np.load(FREQ_TABLE) as z:
        ref = [(len(z[f"sat_{i}"]),
                z[f"sat_{i}"].sum() / (len(z[f"sat_{i}"]) * int(z["n_chains"])),
                z[f"outside_{i}"].sum() /
                (len(z[f"sat_{i}"]) * int(z["n_chains"])))
               for i in range(int(z["n_batches"]))]
    measured_ng = [int(b.n_graphs) for b in bank_batches[:FREQ_BATCHES]]
    similar = [r for r in ref if min(measured_ng) - FREQ_SIMILAR_GRAPHS
               <= r[0] <= max(measured_ng) + FREQ_SIMILAR_GRAPHS]
    if not similar:
        raise RuntimeError("no batch of the repo's table has a similar "
                           "graph count")
    sat_window = (min(r[1] for r in similar) - FREQ_RATE_MARGIN,
                  max(r[1] for r in similar) + FREQ_RATE_MARGIN)
    outside_max = max(r[2] for r in similar) + FREQ_RATE_MARGIN
    emit(phase="measure_bank_freq", **agg, wall_s_measured=freq_wall,
         graphs_per_batch=measured_ng,
         wall_s_per_chain=wall_per_chain,
         one_chain_device_busy_s=chain_busy,
         busy_share_per_chain=chain_busy / wall_per_chain,
         reference_batches=len(similar), sat_rate_window=sat_window,
         outside_rate_max=outside_max,
         reference_whole_table=dict(
             sat_rate=float(np.mean([r[1] for r in ref])),
             outside_rate=float(np.mean([r[2] for r in ref]))))
    if not sat_window[0] <= agg["sat_rate"] <= sat_window[1]:
        raise RuntimeError(f"measure_bank_freq: sat_rate {agg['sat_rate']} "
                           f"outside {sat_window}")
    if agg["outside_rate"] > outside_max:
        raise RuntimeError(f"measure_bank_freq: outside_rate "
                           f"{agg['outside_rate']} above {outside_max}")

    # closed-loop reweighted training: the table attaches to the batches it
    # was measured on, the rest get the isolation-only logits
    with np.load(table_path) as z:
        table = dict(z)
    for i in range(FREQ_BATCHES):
        b = bank_batches[i]
        if str(table[f"fingerprint_{i}"]) != reweight.batch_fingerprint(b) \
                or str(table[f"content_fingerprint_{i}"]) != \
                reweight.content_fingerprint(b):
            raise RuntimeError(f"the table's fingerprints of batch {i} "
                               "differ from the cache's")
    log = io.StringIO()
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        final = diffusion_training.main(bank_argv(data_dir) + [
            "--train_steps", str(REWEIGHTED_STEPS), "--label_isolation_alpha",
            "0.45", "--label_logit_table", str(table_path), "--init_npz",
            str(ISO45), "--train_dir", str(uni_dir / "runs"), "--device",
            str(dev), "--eval_every", str(REWEIGHTED_STEPS), "--ckpt_every",
            str(REWEIGHTED_STEPS)])
    sync()
    reweighted_wall = time.perf_counter() - t0
    sys.stdout.write(log.getvalue())
    attached = [ln for ln in log.getvalue().splitlines()
                if ln.startswith("label logits attached:")]
    run_dir = Path(final["run_dir"])
    losses = [json.loads(ln)["loss"] for ln in (
        run_dir / "train_log.jsonl").read_text().splitlines()
        if "steps_per_sec" in ln]
    with np.load(run_dir / "params.npz") as z:
        meta_rw = json.loads(str(z["__meta__"]))
    emit(phase="train_reweighted", steps=REWEIGHTED_STEPS, wall_s=reweighted_wall,
         attached=attached, losses=losses, diag_loss=final["diag_loss"],
         eval_total_accuracy=final["total_accuracy"],
         label_isolation_alpha=meta_rw["config"]["label_isolation_alpha"],
         train_batches=len(bank_batches), measured_batches=FREQ_BATCHES)
    want = (f"label logits attached: {FREQ_BATCHES}/{len(bank_batches)} "
            "batches measured")
    if len(attached) != 1 or not attached[0].startswith(want):
        raise RuntimeError(f"train_reweighted: {attached}")
    if not losses or not np.isfinite(losses + [final["diag_loss"]]).all():
        raise RuntimeError("train_reweighted: non-finite loss")
    if meta_rw["config"]["label_isolation_alpha"] != 1.0:
        raise RuntimeError("train_reweighted: the composed logits were not "
                           "read with isolation_alpha 1.0")
    shutil.rmtree(uni_dir)
    return uni_launches


def anf_phase(dev, data_dir: Path, tools: dict) -> dict:
    """Phase 8: the ANF path. The 17-round SHA-1 test split and a cut
    training split; the segsum kernel on ANF plans against its plain
    version; the tiled pair against the kernel route; the flagship's eval
    against its pass mark with the launches reckoned from the code; tiled
    and flat training (first losses equal at f32 tiles, both losses fall,
    the flat steps' launches as reckoned) and the training script in-process
    with eval, a checkpoint and a restore; anchored CDCL completion; and
    profiles of an eval round and of a train step in each layout. Returns
    the kernels line's ANF rows."""
    import argparse

    import numpy as np
    import torch

    from diffusionsat_torch import anf_eval, anf_training
    from diffusionsat_torch.models.anf_sat import (
        ANFSATConfig,
        anf_sat_apply,
        anf_sat_init,
    )
    from diffusionsat_torch.ops import segsum, tiled_ops
    from diffusionsat_torch.sat.anf_completion import (
        extract_graph_equations,
        input_anchored_complete,
    )
    from diffusionsat_torch.train.adabelief import adabelief
    from diffusionsat_torch.train.checkpoint import restore_model_params
    from diffusionsat_torch.train.loop import (
        TrainState,
        make_planned_train_step_for,
        plan_batches,
    )

    sync, device_ms = tools["sync"], tools["device_ms"]
    cuda_kernels, dev_us = tools["cuda_kernels"], tools["dev_us"]

    def seeded(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def data_args(*argv):
        p = argparse.ArgumentParser()
        anf_eval.add_data_args(p, train_size=8000, test_size=256)
        return p.parse_args(["--data_dir", str(data_dir), *argv])

    def profiled(fn, reps=3):
        walls = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(time.perf_counter() - t0)
        with tools["profile"](activities=tools["activities"]) as prof:
            fn()
            sync()
        kernels = cuda_kernels(prof)
        busy = sum(dev_us(e) for e in kernels) / 1e3
        top = sorted(kernels, key=dev_us, reverse=True)[:8]
        return min(walls) * 1e3, busy, kernels, top

    def shape_of(b):
        return dict(V=b.V, A=b.A, C=b.C, E=b.E, G=b.G,
                    systems=int(b.n_graphs), vars=int(b.n_vars),
                    clauses=int(b.n_clauses), ands=int(b.and_mask.sum()),
                    edges=int(b.edge_mask_c.sum()))

    # -- the splits: the eval's (anf_eval's defaults) and a cut training set
    test_batches, test_timing = tools["splits"].get("anf_test")
    (train_ds, train_batches), train_timing = tools["splits"].get("anf_train")
    edges = [int(b.edge_mask_c.sum()) for b in test_batches]
    emit(phase="anf_split", **test_timing, batches=len(test_batches),
         systems=sum(int(b.n_graphs) for b in test_batches),
         batch_0=shape_of(test_batches[0]), edges_min_max=[min(edges),
                                                          max(edges)],
         train_timing=train_timing, train_batches=len(train_batches),
         train_systems=sum(int(b.n_graphs) for b in train_batches),
         train_cut_from=2000,
         note="the training split's quantity is cut, not its width")

    # -- the kernel on ANF plans against its plain version ----------------
    b0 = test_batches[0].to(dev)
    plans0 = segsum.build_anf_plans(test_batches[0]).to(dev)
    gen = seeded(0)
    rows = {}
    for F in (64, 128):
        for name in segsum.ANF_DIRECTIONS:
            row, shape = tools["kernel_row"](getattr(plans0, name), F, gen)
            emit(phase="anf_kernel_vs_plain", batch="anf_test_batch_0",
                 direction=name, **shape, **row)
            rows[(name, F)] = row

    # -- the tiled pair against the kernel route, F = 128 -----------------
    t0 = time.perf_counter()
    tiles0 = tiled_ops.build_anf_tiles(test_batches[0])
    tile_build_s = time.perf_counter() - t0
    tiles0 = tiles0.to(dev)
    T, Tp = tiles0.n_real_tiles, tiles0.n_tiles
    blocks = tiles0.blocks
    deg = max(float(blocks.sum(2).max()), float(blocks.sum(1).max()))
    F = 128
    tiled_rows = {}
    with torch.no_grad():
        for name, tiled_fn, kernel_fn, n_in, n_out in (
                ("node_to_clause", tiled_ops.tiled_lit_to_clause,
                 segsum.plan_node_to_clause, b0.n_value_nodes, b0.C),
                ("clause_to_node", tiled_ops.tiled_clause_to_lit,
                 segsum.plan_clause_to_node, b0.C, b0.n_value_nodes)):
            x = torch.randn((n_in, F), generator=gen, device=dev)
            ref = kernel_fn(x, plans0)
            errs, times = {}, {}
            for mode in ("highest", "default"):
                got = tiled_fn(x, tiles0, mode)
                sync()
                errs[mode] = (got - ref).abs().max().item()
                times[mode] = device_ms(lambda: tiled_fn(x, tiles0, mode))
            kernel_ms = device_ms(lambda: kernel_fn(x, plans0))
            # the tile products' work on this batch: 2 T tc tl F operations
            # on the f32 pipe (TF32 off; the bf16 setting's products run
            # on tensor cores, under a lower bound than this), and the
            # blocks, each tile's input rows and the output moved once
            ops = 2 * T * tiles0.tc * tiles0.tl * F
            nbytes = 4 * (T * tiles0.tc * tiles0.tl + T * tiles0.tl * F +
                          n_out * F)
            bound_by = "operations" if ops / H100_F32_OPS_PER_S >= \
                nbytes / H100_BYTES_PER_S else "bytes"
            row = dict(f32_ms=times["highest"], bf16_operands_ms=times[
                "default"], kernel_route_ms=kernel_ms,
                bound_ms=max(ops / H100_F32_OPS_PER_S,
                             nbytes / H100_BYTES_PER_S) * 1e3,
                bound_by=bound_by, max_abs_err_f32=errs["highest"],
                max_abs_err_bf16=errs["default"])
            emit(phase="anf_tiled_vs_flat", direction=name, F=F, tiles=T,
                 padded_tiles=Tp, tile_mbytes=Tp * tiles0.tc * tiles0.tl *
                 4 / 1e6, tile_build_s=tile_build_s, operations=ops,
                 bytes=nbytes, **row)
            if errs["highest"] > 1e-4 * max(1.0, ref.abs().max().item()):
                raise RuntimeError(f"tiled {name} at f32 differs from the "
                                   f"kernel route by {errs['highest']}")
            if errs["default"] > 2.0 ** -8 * x.abs().max().item() * deg:
                raise RuntimeError(f"tiled {name} at bf16 operands differs "
                                   f"by {errs['default']}")
            tiled_rows[name] = row
    del tiles0, blocks

    # -- the CNF flat backends of the training script (DSAT_FLAT_BACKEND):
    # the pair and one full-width QuerySAT train step on the 20 000-node
    # batch, through the kernel plans and through tiles
    from diffusionsat_torch.data.bench_workloads import threshold_3sat_batch
    from diffusionsat_torch.models.query_sat import (
        QuerySATConfig,
        query_sat_init,
    )
    from diffusionsat_torch.train.loop import make_planned_train_step

    cnf_batch, _ = threshold_3sat_batch(np.random.default_rng(0), 20000)
    cnf_plans = segsum.build_batch_plans(cnf_batch).to(dev)
    t0 = time.perf_counter()
    cnf_tiles = tiled_ops.build_tiled_incidence(cnf_batch)
    cnf_tile_s = time.perf_counter() - t0
    cnf_tiles = cnf_tiles.to(dev)
    cnf_batch = cnf_batch.to(dev)
    with torch.no_grad():
        for name, tiled_fn, kernel_fn, n_in in (
                ("lit_to_clause", tiled_ops.tiled_lit_to_clause,
                 segsum.plan_lit_to_clause, 2 * cnf_batch.V),
                ("clause_to_lit", tiled_ops.tiled_clause_to_lit,
                 segsum.plan_clause_to_lit, cnf_batch.C)):
            x = torch.randn((n_in, F), generator=gen, device=dev)
            ref = kernel_fn(x, cnf_plans)
            emit(phase="cnf_tiled_vs_flat", direction=name, F=F,
                 tiles=cnf_tiles.n_real_tiles,
                 padded_tiles=cnf_tiles.n_tiles, tile_build_s=cnf_tile_s,
                 f32_ms=device_ms(lambda: tiled_fn(x, cnf_tiles, "highest")),
                 bf16_operands_ms=device_ms(
                     lambda: tiled_fn(x, cnf_tiles, "default")),
                 kernel_route_ms=device_ms(lambda: kernel_fn(x, cnf_plans)),
                 max_abs_err_f32=(tiled_fn(x, cnf_tiles, "highest") -
                                  ref).abs().max().item())
    qcfg = QuerySATConfig()
    for backend, plan in (("segsum", cnf_plans), ("tiled", cnf_tiles)):
        opt = adabelief(learning_rate=1e-3, clip_gradients=True)
        p = query_sat_init(seeded(0), qcfg)
        holder = {"state": TrainState(params=p, opt_state=opt.init(p),
                                      step=0, generator=seeded(1))}
        qstep = make_planned_train_step(qcfg, opt, dev)

        def one_cnf_step():
            holder["state"], _ = qstep(holder["state"], cnf_batch, plan)

        wall, busy, kernels, top = profiled(one_cnf_step)
        emit(phase="cnf_flat_backend_step", backend=backend,
             tile_precision=tiled_ops.TILE_PRECISION, wall_ms=wall,
             device_busy_ms=busy, device_busy_share=busy / wall,
             kernels_per_step=sum(e.count for e in kernels),
             top=[(e.key[:60], dev_us(e) / 1e3, e.count) for e in top])
    del cnf_tiles, cnf_plans, cnf_batch

    # -- the flagship's eval, flat through the kernel: a main path --------
    rounds = ANFSATConfig().test_rounds
    out_path = ROOT / "runs" / "chip_smoke_anf_eval.json"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    segsum.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    res = anf_eval.main(["--ckpt", str(ANF_CKPT), "--device", str(dev),
                         "--data_dir", str(data_dir), "--out",
                         str(out_path)])
    sync()
    eval_wall = time.perf_counter() - t0
    eval_launches = dict(segsum.LAUNCHES)
    out_path.unlink()
    nb = len(test_batches)
    # a round without labels: the query's value sums, the messages and the
    # unsupervised loss's value sums (node -> clause), one reply (clause ->
    # node), one AND scatter
    reckoned = {"lit_to_clause": 0, "clause_to_lit": 0,
                "node_to_clause": 3 * rounds * nb,
                "clause_to_node": rounds * nb, "and_to_var": rounds * nb}
    emit(phase="anf_eval", ckpt=ANF_CKPT.name, rounds=rounds, batches=nb,
         **res, wall_s=eval_wall, launches=eval_launches,
         reckoned_launches=reckoned,
         pass_mark={k: dict(record=v[0], window=v[1])
                    for k, v in ANF_PASS_MARK.items()})
    for key, (record, window) in ANF_PASS_MARK.items():
        if abs(res[key] - record) > window:
            raise RuntimeError(f"anf_eval: {key} {res[key]} outside "
                               f"{record} +- {window}")
    if eval_launches != reckoned:
        raise RuntimeError(f"anf_eval launches {eval_launches}, reckoned "
                           f"{reckoned}")

    # -- training, tiled and flat, at full width --------------------------
    cfg = ANFSATConfig()
    t0 = time.perf_counter()
    tiled_train = [(b.to(dev), tiled_ops.build_anf_tiles(b).to(dev))
                   for b in train_batches]
    tiles_s = time.perf_counter() - t0
    flat_train = plan_batches(train_batches, dev)
    tb0, tp0 = flat_train[0]
    noise = torch.randn((cfg.train_rounds, tb0.V, 4), generator=seeded(1),
                        device=dev)
    params0 = anf_sat_init(seeded(0), cfg)
    first = {}
    for name, kw, mode in (("flat", {"plans": tp0}, "highest"),
                           ("tiled_f32", {"tiles": tiled_train[0][1]},
                            "highest"),
                           ("tiled_bf16", {"tiles": tiled_train[0][1]},
                            "default")):
        with tiled_ops.tile_precision(mode):
            first[name] = anf_sat_apply(
                params0, cfg, tb0, training=True, labels=tb0.solutions,
                round_noise=noise, device=dev, **kw)[1].item()
    emit(phase="anf_train_first_loss", **first, tile_build_s=tiles_s,
         tolerance=ANF_FIRST_LOSS_RTOL)
    if abs(first["tiled_f32"] - first["flat"]) > \
            ANF_FIRST_LOSS_RTOL * abs(first["flat"]):
        raise RuntimeError(f"first tiled and flat losses differ: {first}")

    @torch.no_grad()
    def fixed_loss(params):
        return anf_sat_apply(params, cfg, tb0, training=False,
                             labels=tb0.solutions, rounds=cfg.train_rounds,
                             round_noise=noise, plans=tp0,
                             device=dev)[1].item()

    def fresh(layout):
        opt = adabelief(learning_rate=1e-3, clip_gradients=True)
        p = anf_sat_init(seeded(0), cfg)
        state = TrainState(params=p, opt_state=opt.init(p), step=0,
                           generator=seeded(1))
        step = make_planned_train_step_for(
            anf_sat_apply, cfg, opt, device=dev,
            plan_kw="tiles" if layout == "tiled" else "plans")
        return state, step

    train_launches = {}
    steps_of = {}
    for layout, items in (("tiled", tiled_train), ("flat", flat_train)):
        state, step = fresh(layout)
        before = fixed_loss(state.params)
        stream = train_ds.repeat_shuffled(items)
        torch.cuda.reset_peak_memory_stats()
        segsum.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        losses = []
        for _ in range(ANF_TRAIN_STEPS):
            state, out = step(state, *next(stream))
            losses.append(out["loss"])
        losses = torch.stack(losses).cpu().tolist()
        sync()
        wall = time.perf_counter() - t0
        launched = dict(segsum.LAUNCHES)
        after = fixed_loss(state.params)
        steps_of[layout] = (step, items)
        emit(phase="anf_train", layout=layout, steps=ANF_TRAIN_STEPS,
             train_rounds=cfg.train_rounds, losses=losses,
             fixed_batch_loss_before=before, fixed_batch_loss_after=after,
             wall_s=wall, steps_per_s=ANF_TRAIN_STEPS / wall,
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             launches=launched,
             tile_precision=tiled_ops.TILE_PRECISION if layout == "tiled"
             else None)
        if not np.isfinite(losses).all() or not after < before:
            raise RuntimeError(f"anf_train ({layout}): the loss did not "
                               f"fall ({before} -> {after})")
        if layout == "tiled":
            if sum(launched.values()):
                raise RuntimeError(f"tiled steps launched {launched}")
            continue
        r = ANF_TRAIN_STEPS * cfg.train_rounds
        # a round: 2 node -> clause sums forward, again when the round is
        # recomputed, 1 as the reply's backward; the reply forward,
        # recomputed, and as the 2 sums' backward; the AND scatter forward,
        # recomputed, and its transpose backward
        want = {"lit_to_clause": 0, "clause_to_lit": 0,
                "node_to_clause": 5 * r, "clause_to_node": 4 * r,
                "and_to_var": 2 * r, "var_to_and": r}
        if launched != want:
            raise RuntimeError(f"flat ANF steps launched {launched}, "
                               f"reckoned {want}")
        train_launches = launched

    # -- the tiled step sums in one fixed order: run twice, equal ----------
    from torch.utils import _pytree as pytree
    repeats = []
    for _ in range(2):
        state, step = fresh("tiled")
        for items in tiled_train[:2]:
            state, out = step(state, *items)
        repeats.append((pytree.tree_leaves(state.params), out["loss"]))
    sync()
    differ = sum(not torch.equal(a, b) for a, b in
                 zip(repeats[0][0], repeats[1][0]))
    emit(phase="anf_tiled_repeat", steps=2, params=len(repeats[0][0]),
         params_differing=differ,
         losses=[r[1].item() for r in repeats],
         tile_precision=tiled_ops.TILE_PRECISION)
    if differ or not torch.equal(repeats[0][1], repeats[1][1]):
        raise RuntimeError(f"two tiled ANF runs differ: {differ} params")

    # -- the training script in-process: eval, checkpoint, restore ---------
    run_root = ROOT / "runs" / "chip_smoke_anf"
    shutil.rmtree(run_root, ignore_errors=True)
    argv = ["--train_size", str(ANF_TRAIN_SIZE), "--test_size",
            str(ANF_SCRIPT_TEST_SIZE), "--data_dir", str(data_dir),
            "--train_dir", str(run_root), "--device", str(dev),
            "--eval_every", "5"]
    sync()
    t0 = time.perf_counter()
    final = anf_training.main(argv + ["--train_steps", "10"])
    script_wall = time.perf_counter() - t0
    run_dir = Path(final["run_dir"])
    ckpts = sorted(p.name for p in (run_dir / "ckpt").iterdir())
    final2 = anf_training.main(argv + ["--train_steps", "12", "--restore",
                                       str(run_dir / "ckpt"), "--label",
                                       "resumed"])
    resumed = [json.loads(ln)["step"] for ln in (
        Path(final2["run_dir"]) / "train_log.jsonl").read_text().splitlines()
        if "steps_per_sec" in ln]
    exported = restore_model_params(run_dir / "params.npz", anf_sat_init,
                                    cfg, dev)
    emit(phase="anf_train_script", steps=10, wall_s=script_wall,
         eval=final, checkpoints=ckpts, resumed_to=resumed,
         exported_modules=len(exported))
    if ckpts != ["ckpt_10.npz"] or resumed != [12]:
        raise RuntimeError(f"anf_train_script: {ckpts} {resumed}")
    shutil.rmtree(run_root)

    # -- anchored CDCL completion on the first systems of the split --------
    params = restore_model_params(ANF_CKPT, anf_sat_init, cfg, dev)
    planned_test = plan_batches(test_batches[:ANF_COMPLETION_SYSTEMS], dev)
    gen = seeded(9)
    solved = total = 0
    solved_at = {}
    host_s = 0.0
    for batch, plans in planned_test:
        if total >= ANF_COMPLETION_SYSTEMS:
            break
        with torch.no_grad():
            head = anf_sat_apply(params, cfg, batch, gen, training=False,
                                 plans=plans, device=dev)[0][:, 0].cpu()
        head = head.numpy()
        t0 = time.perf_counter()
        geqs = extract_graph_equations(batch)
        var_graph = batch.var_graph.cpu().numpy()
        for g in sorted(geqs):
            if total >= ANF_COMPLETION_SYSTEMS:
                break
            vids = np.flatnonzero(var_graph == g)
            total += 1
            ok, spec, _ = input_anchored_complete(
                geqs[g], vids, (head > 0).astype(np.int8), np.abs(head))
            if ok:
                solved += 1
                solved_at[str(spec)] = solved_at.get(str(spec), 0) + 1
        host_s += time.perf_counter() - t0
    emit(phase="anf_completion", systems=total, solved=solved,
         solved_at_release=solved_at, host_seconds=host_s,
         host_seconds_per_system=host_s / max(total, 1))

    # -- where an eval round and a train step spend their time -----------
    batch, plans = planned_test[0]

    def eval_rounds():
        with torch.no_grad():
            anf_sat_apply(params, cfg, batch, seeded(3), training=False,
                          rounds=8, plans=plans, device=dev)

    wall, busy, kernels, top = profiled(eval_rounds)
    emit(phase="profile_anf", what="eval_round", rounds=8,
         wall_ms_per_round=wall / 8, device_busy_ms_per_round=busy / 8,
         device_busy_share=busy / wall,
         kernels_per_round=sum(e.count for e in kernels) / 8,
         segsum_share_of_busy=sum(dev_us(e) for e in kernels
                                  if "gather_segsum" in e.key) / 1e3 /
         max(busy, 1e-9),
         top=[(e.key[:60], dev_us(e) / 1e3, e.count) for e in top])
    for layout, (step, items) in steps_of.items():
        state, _ = fresh(layout)
        holder = {"state": state}

        def one_step():
            holder["state"], _ = step(holder["state"], *items[0])

        with tiled_ops.tile_precision("default"):
            wall, busy, kernels, top = profiled(one_step)
        emit(phase="profile_anf", what=f"train_step_{layout}",
             train_rounds=cfg.train_rounds, wall_ms=wall,
             device_busy_ms=busy, device_busy_share=busy / wall,
             kernels_per_step=sum(e.count for e in kernels),
             segsum_share_of_busy=sum(dev_us(e) for e in kernels
                                      if "gather_segsum" in e.key) / 1e3 /
             max(busy, 1e-9),
             top=[(e.key[:60], dev_us(e) / 1e3, e.count) for e in top])

    # the kernels line's ANF rows: times at F = 128 on test batch 0, the
    # launches of the eval and of the flat training steps (the main paths)
    kernels_line = []
    for name in segsum.ANF_DIRECTIONS:
        r = rows[(name, 128)]
        n_eval, n_train = eval_launches.get(name, 0), train_launches[name]
        if n_eval + n_train <= 0:
            raise RuntimeError(f"segsum kernel ({name}) was not launched on "
                               "the ANF paths")
        kernels_line.append(dict(
            name=f"gather_segsum:{name}", route="cuda",
            source=KERNEL_SOURCE, replaces=REPLACES,
            launches=n_eval + n_train, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            launches_anf_eval=n_eval, launches_anf_train_flat=n_train,
            shapes="anf_test_batch_0, F=128", F64=rows[(name, 64)],
            tiled_pair=tiled_rows.get(name)))
    return {"kernels": kernels_line}


def graphs_phase(dev, data_dir: Path, tools: dict) -> None:
    """Phase 9: many steps per dispatch, as CUDA graphs. At full width (128
    / 128 maps, 32 train rounds; ANF 16): GRAPHS_MEGA_STEPS graphed dense
    train steps against as many eager ones on as many 20 000-node
    threshold batches from one state, f32 and block-bf16 (params,
    optimizer state, generator and every loss equal bit for bit; peak
    memory); 4 graphed flat ANF steps on
    padded plans against 4 eager ones (the same comparison); graphed
    inference rounds against eager ones (`DSAT_EAGER=1`) on the solving
    eval's batch 0, flat and dense, and on the sampler's chain in both
    layouts: the same logits, samples and launch counts; the plain
    segment sums' reductions timed and run twice; the wall and device busy
    share of every graphed path beside its eager counterpart; and a cut
    `python -m diffusionsat_torch.bench` (one window, one pass over the
    batches, GRAPHS_BENCH_MEGA_STEPS steps a replay) at f32 and
    block-bf16."""
    import os

    import numpy as np
    import torch

    from diffusionsat_torch import bench, cuda_graphs
    from diffusionsat_torch.data.bench_workloads import threshold_3sat_batch
    from diffusionsat_torch.diffusion.sampler import DiffusionSampler
    from diffusionsat_torch.graph.dense_batch import densify_batches
    from diffusionsat_torch.models.anf_sat import (
        ANFSATConfig,
        anf_sat_apply,
        anf_sat_init,
    )
    from diffusionsat_torch.models.query_sat import (
        QuerySATConfig,
        query_sat_apply,
        query_sat_init,
    )
    from diffusionsat_torch.models.query_sat_dense import (
        query_sat_dense_apply,
    )
    from diffusionsat_torch.ops import dense_ops, graph_ops, segsum
    from diffusionsat_torch.graph.dense_batch import (
        densify_batches_quantized,
    )
    from diffusionsat_torch.sat.cnf import CNF
    from diffusionsat_torch.train.adabelief import (
        adabelief,
        cosine_decay_schedule,
    )
    from diffusionsat_torch.train.checkpoint import (
        load_params,
        params_from_numpy,
    )
    from diffusionsat_torch.train.loop import (
        TrainState,
        build_plans,
        make_planned_train_step_for,
        make_predict_step,
        make_scanned_train_step_for,
        make_train_step_for,
        stack_batches,
    )

    sync = tools["sync"]
    cuda_kernels, dev_us = tools["cuda_kernels"], tools["dev_us"]

    def seeded(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return time.perf_counter() - t0, out

    def busy_of(fn):
        """(busy s, kernels) of one profiled call of fn: the share is taken
        over the same call's wall without the profiler."""
        with tools["profile"](activities=tools["activities"]) as prof:
            timed(fn)
        kernels = cuda_kernels(prof)
        return sum(dev_us(e) for e in kernels) / 1e6, \
            sum(e.count for e in kernels)

    def clone_state(st):
        gen = torch.Generator(device=dev)
        gen.set_state(st.generator.get_state())
        return TrainState(
            params=cuda_graphs.tree_map(torch.clone, st.params),
            opt_state=cuda_graphs.tree_map(torch.clone, st.opt_state),
            step=st.step, generator=gen)

    def state_diffs(a, b):
        """Entries that differ, over params and optimizer state, and
        whether the generators' states are equal."""
        la = cuda_graphs.tree_leaves((a.params, a.opt_state))
        lb = cuda_graphs.tree_leaves((b.params, b.opt_state))
        n = sum(int((x != y).sum()) for x, y in zip(la, lb, strict=True))
        gen = torch.equal(a.generator.get_state(), b.generator.get_state())
        top = max(float((x.float() - y.float()).abs().max())
                  for x, y in zip(la, lb))
        return n, gen, top

    # -- the plain segment sums: one fixed order, and its price ------------
    rng = np.random.default_rng(0)
    flat20k, _ = threshold_3sat_batch(np.random.default_rng(0), 20000)
    plans20k = segsum.build_batch_plans(flat20k).to(dev)
    f20 = flat20k.to(dev)
    x = torch.randn((2 * f20.V, 128), generator=seeded(0), device=dev)
    gathered = x.index_select(0, f20.edge_lit_c) * f20.edge_mask_c[:, None]

    def by_index_add():
        return torch.zeros((f20.C, 128), device=dev).index_add_(
            0, f20.edge_clause_c, gathered)

    def by_cumsum():
        ends = torch.searchsorted(f20.edge_clause_c, torch.arange(
            f20.C + 1, dtype=torch.int32, device=dev))
        c = torch.cat([torch.zeros((1, 128), device=dev),
                       torch.cumsum(gathered, 0)])
        return c[ends[1:]] - c[ends[:-1]]

    def by_segment_reduce():
        offsets = torch.searchsorted(f20.edge_clause_c, torch.arange(
            f20.C + 1, dtype=torch.int32, device=dev))
        return torch.segment_reduce(gathered, "sum", offsets=offsets,
                                    axis=0, unsafe=True)

    def by_blocks():
        return graph_ops.segment_sum(gathered, f20.edge_clause_c, f20.C)

    # the per-graph sums of the pair norms: few long segments
    clause_rows = torch.randn((f20.C, 128), generator=seeded(1), device=dev)
    cg = f20.clause_graph
    n_seg = f20.G + 1

    def graphs_by_index_add():
        return torch.zeros((n_seg, 128), device=dev).index_add_(
            0, cg, clause_rows)

    def graphs_by_segment_reduce():
        offsets = torch.searchsorted(cg, torch.arange(
            n_seg + 1, dtype=cg.dtype, device=dev))
        return torch.segment_reduce(clause_rows, "sum", offsets=offsets,
                                    axis=0, unsafe=True)

    def graphs_by_one_hot():
        one_hot = (cg[None, :] == torch.arange(
            n_seg, dtype=cg.dtype, device=dev)[:, None]).float()
        return one_hot @ clause_rows

    def graphs_by_blocks():
        return graph_ops.segment_sum(clause_rows, cg, n_seg)

    reductions = {}
    for name, fn, ref in (
            ("edges_index_add_", by_index_add, by_segment_reduce),
            ("edges_segment_reduce", by_segment_reduce, by_segment_reduce),
            ("edges_cumsum", by_cumsum, by_segment_reduce),
            ("edges_blocks", by_blocks, by_segment_reduce),
            ("graphs_index_add_", graphs_by_index_add,
             graphs_by_segment_reduce),
            ("graphs_segment_reduce", graphs_by_segment_reduce,
             graphs_by_segment_reduce),
            ("graphs_one_hot_mm", graphs_by_one_hot,
             graphs_by_segment_reduce),
            ("graphs_blocks", graphs_by_blocks, graphs_by_segment_reduce)):
        a, b = fn(), fn()
        reductions[name] = dict(
            ms=tools["device_ms"](fn), runs_equal=bool(torch.equal(a, b)),
            max_abs_err=float((a - ref()).abs().max()))
    p1 = segsum.segsum_plain(x, plans20k.lit_to_clause)
    p2 = segsum.segsum_plain(x, plans20k.lit_to_clause)
    emit(phase="graphs_plain_reductions", batch="threshold3sat_20k",
         F=128, edges=int(f20.edge_mask_c.sum()), clauses=f20.C,
         graphs=int(f20.n_graphs), reductions=reductions,
         segsum_plain_runs_equal=bool(torch.equal(p1, p2)))
    if not reductions["edges_blocks"]["runs_equal"] or \
            not reductions["graphs_blocks"]["runs_equal"] or \
            not torch.equal(p1, p2):
        raise RuntimeError("the plain segment sums differ between runs")

    # -- dense mega-step: graphed steps against eager steps ----------------
    n = GRAPHS_MEGA_STEPS
    dense_n = [d.to(dev) for d in densify_batches(
        [threshold_3sat_batch(rng, 20000)[0] for _ in range(n)])]
    chunk = stack_batches(dense_n)
    for bf16 in (False, True):
        cfg = QuerySATConfig(block_bf16=bf16)
        g = seeded(0)
        p0 = query_sat_init(g, cfg)
        opt = adabelief(learning_rate=cosine_decay_schedule(
            1e-3, 167_000, 0.5), eps=1e-8, clip_gradients=True)
        start = TrainState(params=p0, opt_state=opt.init(p0), step=0,
                           generator=seeded(1))
        with dense_ops.incidence_precision("default" if bf16 else
                                           "highest"):
            step = make_train_step_for(query_sat_dense_apply, cfg, opt, dev)
            eager_state = clone_state(start)

            def eager_n():
                nonlocal eager_state
                losses = []
                for b in dense_n:
                    eager_state, out = step(eager_state, b)
                    losses.append(out["loss"])
                return torch.stack(losses)

            eager_wall, eager_losses = timed(eager_n)
            mega = make_scanned_train_step_for(query_sat_dense_apply, cfg,
                                               opt, dev)
            torch.cuda.reset_peak_memory_stats()
            first_wall, (graph_state, out) = timed(
                lambda: mega(clone_state(start), chunk))
            peak = torch.cuda.max_memory_allocated()
            n_diff, gen_equal, top = state_diffs(eager_state, graph_state)
            loss_equal = bool(torch.equal(eager_losses,
                                          out["loss_per_step"]))
            # the eager steps above and one replay; the busy time of one
            # eager step and of one replay
            walls = {"eager": eager_wall / n,
                     "graph": timed(lambda: mega(graph_state, chunk))[0] / n}
            eager_prof = busy_of(lambda: step(clone_state(eager_state),
                                              dense_n[0]))
            graph_prof = [x / n for x in
                          busy_of(lambda: mega(graph_state, chunk))]
        emit(phase="graphs_dense_mega_step", block_bf16=bf16, steps=n,
             batch_shape=(dense_n[0].G, dense_n[0].Vg, dense_n[0].Cg),
             differing_entries=n_diff, max_abs_diff=top,
             generator_equal=gen_equal, losses_equal=loss_equal,
             losses=out["loss_per_step"].tolist(),
             eager_first_wall_s=eager_wall,
             graph_first_call_s=first_wall,
             wall_ms_per_step={k: v * 1e3 for k, v in walls.items()},
             busy_ms_per_step={"eager": eager_prof[0] * 1e3,
                               "graph": graph_prof[0] * 1e3},
             busy_share={"eager": eager_prof[0] / walls["eager"],
                         "graph": graph_prof[0] / walls["graph"]},
             kernels_per_step={"eager": eager_prof[1],
                               "graph": graph_prof[1]},
             peak_memory_gib=peak / 2 ** 30)
        if n_diff or not gen_equal or not loss_equal:
            raise RuntimeError(f"dense mega-step (bf16={bf16}) differs from "
                               f"{n} eager steps: {n_diff} entries, generator "
                               f"equal {gen_equal}, losses equal "
                               f"{loss_equal}")
        del mega, graph_state, eager_state, start

    # -- ANF flat mega-step: 4 graphed steps against 4 eager ones ----------
    anf_batches = tools["splits"].get("anf_train")[0][1][:4]
    anf_cfg = ANFSATConfig()
    pairs = [(b, build_plans(b, pad=True)) for b in anf_batches]
    anf_chunk = tuple(t.to(dev) for t in stack_batches(pairs))
    pairs = [(b.to(dev), pl.to(dev)) for b, pl in pairs]
    opt = adabelief(learning_rate=1e-3, clip_gradients=True)
    a0 = anf_sat_init(seeded(0), anf_cfg)
    start = TrainState(params=a0, opt_state=opt.init(a0), step=0,
                       generator=seeded(1))
    step = make_planned_train_step_for(anf_sat_apply, anf_cfg, opt,
                                       device=dev)
    eager_state = clone_state(start)

    def eager4():
        nonlocal eager_state
        losses = []
        for b, pl in pairs:
            eager_state, out = step(eager_state, b, pl)
            losses.append(out["loss"])
        return torch.stack(losses)

    # two eager runs from one state: every sum of the flat step takes one
    # fixed order, so they must agree bit for bit, and the graph with them
    _, again_losses = timed(eager4)
    again, eager_state = eager_state, clone_state(start)
    segsum.reset_launch_counts()
    eager_wall, eager_losses = timed(eager4)
    eager_launches = dict(segsum.LAUNCHES)
    eager_spread = state_diffs(eager_state, again)
    mega = make_scanned_train_step_for(anf_sat_apply, anf_cfg, opt, dev)
    segsum.reset_launch_counts()
    first_wall, (graph_state, out) = timed(
        lambda: mega(clone_state(start), anf_chunk))
    graph_launches = dict(segsum.LAUNCHES)
    n_diff, gen_equal, top = state_diffs(eager_state, graph_state)
    loss_equal = bool(torch.equal(eager_losses, out["loss_per_step"]))
    walls = {"eager": eager_wall / 4,
             "graph": timed(lambda: mega(graph_state, anf_chunk))[0] / 4}
    eager_prof = busy_of(lambda: step(clone_state(eager_state), *pairs[0]))
    graph_prof = [x / 4 for x in
                  busy_of(lambda: mega(graph_state, anf_chunk))]
    emit(phase="graphs_anf_mega_step", steps=4,
         train_rounds=anf_cfg.train_rounds, differing_entries=n_diff,
         max_abs_diff=top, generator_equal=gen_equal,
         losses_equal=loss_equal, losses=out["loss_per_step"].tolist(),
         eager_losses=eager_losses.tolist(),
         eager_against_eager=dict(differing_entries=eager_spread[0],
                                  max_abs_diff=eager_spread[2],
                                  losses_equal=bool(torch.equal(
                                      again_losses, eager_losses))),
         launches_eager=eager_launches,
         launches_graph=graph_launches, graph_first_call_s=first_wall,
         wall_ms_per_step={k: v * 1e3 for k, v in walls.items()},
         busy_ms_per_step={"eager": eager_prof[0] * 1e3,
                           "graph": graph_prof[0] * 1e3},
         busy_share={"eager": eager_prof[0] / walls["eager"],
                     "graph": graph_prof[0] / walls["graph"]})
    if n_diff or eager_spread[0] or not gen_equal or not loss_equal:
        raise RuntimeError(f"ANF mega-step differs from 4 eager steps: "
                           f"{n_diff} entries up to {top} (eager from "
                           f"eager: {eager_spread[0]}), generator equal "
                           f"{gen_equal}, losses equal {loss_equal}")
    if graph_launches != eager_launches:
        raise RuntimeError(f"ANF mega-step launches {graph_launches}, "
                           f"eager {eager_launches}")
    del mega, graph_state, eager_state

    # -- graphed rounds against eager rounds -------------------------------
    tree, meta = load_params(CKPT)
    params = params_from_numpy(tree, dev)
    cfg64 = QuerySATConfig(test_rounds=64)
    eval_batch = tools["splits"].get("eval")[0][0]
    cases = {"solve_eval_flat": (query_sat_apply, eval_batch.to(dev),
                                 build_plans(eval_batch, pad=True).to(dev)),
             "solve_eval_dense": (query_sat_dense_apply,
                                  densify_batches_quantized([eval_batch])[0]
                                  .to(dev), None)}

    def compare(name, run, profiled):
        """run() eagerly and graphed: results and launches must be equal;
        walls, and with `profiled` the busy shares."""
        outs, launches, walls, profs = {}, {}, {}, {}
        for mode in ("eager", "graph"):
            ctx = cuda_graphs.eager() if mode == "eager" else \
                contextlib.nullcontext()
            with ctx:
                segsum.reset_launch_counts()
                walls[mode] = [timed(run)[0]]
                launches[mode] = dict(segsum.LAUNCHES)
                wall, outs[mode] = timed(run)     # the graph captured
                walls[mode].append(wall)
                if profiled:
                    profs[mode] = busy_of(run)
        same = all(torch.equal(a, b) for a, b in zip(
            cuda_graphs.tree_leaves(outs["eager"]),
            cuda_graphs.tree_leaves(outs["graph"]), strict=True))
        emit(phase="graphs_rounds", case=name, equal=same,
             launches=launches, wall_s=walls,
             busy_ms={m: p[0] * 1e3 for m, p in profs.items()},
             busy_share={m: p[0] / walls[m][1] for m, p in profs.items()},
             kernels={m: p[1] for m, p in profs.items()})
        if not same:
            raise RuntimeError(f"graphed rounds ({name}) differ from eager")
        if launches["eager"] != launches["graph"]:
            raise RuntimeError(f"graphed rounds ({name}) launched "
                               f"{launches['graph']}, eager "
                               f"{launches['eager']}")

    for name, (apply, batch, plans) in cases.items():
        predict = make_predict_step(cfg64, apply, noise_scale=1.0,
                                    device=dev)

        def run(predict=predict, batch=batch, plans=plans):
            out = predict(params, batch, seeded(1), plans=plans)
            return out["prediction"], out["loss"], out["steps_taken"]

        compare(name, run, profiled=True)
    cfg32 = QuerySATConfig.from_meta(meta["config"], test_rounds=32)
    for dense in (False, True):
        def run(dense=dense):
            sampler = DiffusionSampler(params, cfg32, CNF.load(UF20),
                                       diffusion_steps=4, test_rounds=32,
                                       dense=dense, seed=0, device=dev)
            counts = sampler.samples(64, max_batches=1)
            return [torch.tensor(sorted(counts.items()))]

        compare(f"sampler_uf20_{'dense' if dense else 'flat'}", run,
                profiled=False)
    cuda_graphs.clear_round_graphs()

    # -- a cut bench run: one window, one pass, a short replay -------------
    env = {"DSAT_MEGA_STEPS": str(GRAPHS_BENCH_MEGA_STEPS),
           "DSAT_BENCH_WINDOWS": "1"}
    old = {k: os.environ.get(k) for k in (*env, "DSAT_BLOCK_BF16")}
    try:
        os.environ.update(env)
        for bf16 in ("0", "1"):
            os.environ["DSAT_BLOCK_BF16"] = bf16
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = bench.main(["--cycles", "1", "--n_batches", "1"])
            emit(phase="graphs_bench",
                 cut=f"1 window of 1 pass over 1 batch's worth, "
                     f"{GRAPHS_BENCH_MEGA_STEPS} steps a replay", **res)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def main_phase(dev, data_dir: Path, tools: dict, eval_batches) -> dict:
    """Phase 10: the generic entry point. `python -m diffusionsat_torch.main`
    in-process at full width on a cut 3-SAT set: 20 flat train steps
    through the kernel with two evals, a checkpoint, every eval mode (the
    sweeps' lists cut), and the launches reckoned from the code; a restore
    that takes 2 more steps at exactly 128 launches each way a step; the
    flagship through the harness on the first 4 batches of the eval split,
    kernel against plain path on the same draws, the invariance readings
    and the noise sweep; one full-width train step on one batch of every
    registry task. Returns the launch counts and the kernels line's rows at the
    shapes of `main`'s first training batch."""
    import csv
    import dataclasses

    import numpy as np
    import torch

    from diffusionsat_torch import main as generic
    from diffusionsat_torch.config import parse_config
    from diffusionsat_torch.data.datasets import SatDataset
    from diffusionsat_torch.evaluation import harness
    from diffusionsat_torch.evaluation.noise_sweep import noise_sweep
    from diffusionsat_torch.graph.batch import BucketSpec
    from diffusionsat_torch.models.query_sat import (
        QuerySATConfig,
        query_sat_apply,
        query_sat_init,
    )
    from diffusionsat_torch.ops import segsum
    from diffusionsat_torch.train.adabelief import adabelief
    from diffusionsat_torch.train.checkpoint import (
        load_params,
        params_from_numpy,
    )
    from diffusionsat_torch.train.loop import (
        TrainState,
        build_plans,
        evaluate_metrics,
        make_train_step_for,
        plan_batches,
    )
    from diffusionsat_torch.train.metrics import SATAccuracy, StepStatistics

    sync = tools["sync"]
    t_phase = time.perf_counter()

    def seeded(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def counted(fn):
        """fn() with the launch counts set to 0 just before and read just
        after: (result, launches, seconds)."""
        segsum.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, dict(segsum.LAUNCHES), time.perf_counter() - t0

    # -- `main`'s splits, generated before the counted run ----------------
    run_root = data_dir / "main_runs"
    shutil.rmtree(run_root, ignore_errors=True)
    argv = main_argv(data_dir, run_root, MAIN_EVAL_EVERY)
    cfg = parse_config(argv)
    bucket = BucketSpec.for_node_budget(cfg.max_nodes_per_batch)
    (train_batches, test, vargen), timing = tools["splits"].get("main")
    emit(phase="main_split", **timing,
         train_batches=len(train_batches), test_batches=len(test),
         test_graphs=[int(b.n_graphs) for b in test],
         vargen_batches=vargen)

    # -- main in-process: train, then every eval mode -----------------------
    rounds = cfg.test_rounds
    n_test = len(test)
    per_round = 2      # launches of each direction in one inference round
    expected = (MAIN_TRAIN_STEPS * LAUNCHES_PER_TRAIN_STEP +
                per_round * rounds * (
                    MAIN_TRAIN_STEPS // MAIN_EVAL_EVERY * min(8, n_test) +
                    n_test +                       # --evaluate
                    3 * min(5, n_test) +           # --test_invariance
                    n_test +                       # --make_cactus
                    sum(vargen.values()) +         # --evaluate_variable_gen
                    2 * len(MAIN_BATCH_GEN)) +     # --evaluate_batch_gen
                per_round * n_test * sum(MAIN_ROUND_GEN))
    flags = ["--" + f for f in generic.EVAL_FLAGS]
    res, launched, main_s = counted(lambda: generic.main(
        argv + ["--train_steps", str(MAIN_TRAIN_STEPS)] + flags,
        round_gen_rounds=MAIN_ROUND_GEN, batch_gen_budgets=MAIN_BATCH_GEN,
        variable_gen_counts=MAIN_VARIABLE_GEN))
    if launched != {d: expected for d in segsum.CNF_DIRECTIONS}:
        raise RuntimeError(f"main: launches {launched}, reckoned "
                           f"{expected} each way")
    run_dir = Path(res["run_dir"])
    log = [json.loads(x) for x in
           (run_dir / "train_log.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in log if "loss" in r]
    evals = [r for r in log if "total_accuracy" in r]
    if not losses or not np.isfinite(losses).all() or len(evals) != 2:
        raise RuntimeError(f"main: train log {log}")
    files = ("gen_steps_result.txt", "gen_batch_size_results.txt",
             "gen_variables_size_result.txt", "query_sat_cactus.csv")
    for name in files:
        if not (run_dir / name).read_text().strip():
            raise RuntimeError(f"main: {name} empty")
    with open(run_dir / "query_sat_cactus.csv") as f:
        cactus_rows = len(list(csv.reader(f))) - 1
    graphs_after_warmup = sum(int(b.n_graphs) for b in test[10:])
    if cactus_rows != graphs_after_warmup or cactus_rows == 0:
        raise RuntimeError(f"main: cactus rows {cactus_rows}, test graphs "
                           f"after the warm-up {graphs_after_warmup}")
    roundgen = {r: v["total_accuracy"]
                for r, v in res["evaluate_round_gen"].items()}
    emit(phase="main", seconds=main_s, launches=launched,
         launches_reckoned=expected, steps=res["state"].step,
         losses=losses, evals=evals,
         mode_seconds=res["seconds"], evaluate=res["evaluate"],
         invariance=res["test_invariance"],
         classic_solver_s_per_batch=res["test_classic_solver"],
         cactus_rows=cactus_rows, round_gen_total_accuracy=roundgen,
         round_gen_seconds={r: v["elapsed"] for r, v in
                            res["evaluate_round_gen"].items()},
         batch_gen_warm_s=res["evaluate_batch_gen"],
         variable_gen={c: v["total_accuracy"] for c, v in
                       res["evaluate_variable_gen"].items()})

    # -- restore: 2 more steps from the checkpoint the run left -------------
    ckpt_dir = run_dir / "ckpt"
    res2, restore_launched, restore_s = counted(lambda: generic.main(
        argv + ["--train_steps", str(MAIN_TRAIN_STEPS + 2), "--restore",
                str(ckpt_dir), "--eval_every", "1000"]))
    if res2["state"].step != MAIN_TRAIN_STEPS + 2 or restore_launched != {
            d: 2 * LAUNCHES_PER_TRAIN_STEP for d in segsum.CNF_DIRECTIONS}:
        raise RuntimeError(f"main restore: step {res2['state'].step}, "
                           f"launches {restore_launched}")
    emit(phase="main_restore", seconds=restore_s,
         step=res2["state"].step, launches=restore_launched,
         checkpoints=sorted(p.name for p in ckpt_dir.iterdir()))

    # -- the flagship through the harness: kernel and plain path ------------
    tree, meta = load_params(CKPT)
    params = params_from_numpy(tree, dev)
    cfg64 = QuerySATConfig.from_meta(meta["config"],
                                     test_rounds=HARNESS_ROUNDS)
    batches = eval_batches[:HARNESS_BATCHES]
    n_graphs = sum(int(b.n_graphs) for b in batches)
    kernel, kernel_launched, kernel_s = counted(
        lambda: harness.evaluate_round_generalization(
            params, lambda r: dataclasses.replace(cfg64, test_rounds=r),
            batches, run_root / "flagship_rounds.txt",
            rounds_list=[HARNESS_ROUNDS], device=dev)[HARNESS_ROUNDS])

    def plain_apply(params, cfg, batch, generator, training, **kw):
        # no `plans` argument: the predict step runs the plain sums
        return query_sat_apply(params, cfg, batch, generator, training, **kw)

    plain, plain_launched, plain_s = counted(lambda: evaluate_metrics(
        params, cfg64, [b.to(dev) for b in batches],
        [SATAccuracy(), StepStatistics()], seeded(0), apply_fn=plain_apply,
        device=dev))
    reckoned = per_round * HARNESS_ROUNDS * len(batches)
    gap = abs(kernel["total_accuracy"] - plain["total_accuracy"])
    if kernel_launched != {d: reckoned for d in segsum.CNF_DIRECTIONS} or \
            sum(plain_launched.values()) != 0 or gap > HARNESS_SOLVED_TOL:
        raise RuntimeError(f"harness flagship: kernel {kernel} launches "
                           f"{kernel_launched} (reckoned {reckoned}), plain "
                           f"{plain} launches {plain_launched}")
    invariance, inv_launched, inv_s = counted(lambda: harness.test_invariance(
        params, cfg64, batches, steps=len(batches), device=dev))
    p_orig = invariance["original"]
    se = max(float(np.sqrt(p_orig * (1 - p_orig) / n_graphs)), 1 / n_graphs)
    if abs(invariance["permuted"] - p_orig) > INVARIANCE_STANDARD_ERRORS * se \
            or inv_launched != {d: 3 * reckoned for d in segsum.CNF_DIRECTIONS}:
        raise RuntimeError(f"invariance: {invariance}, standard error {se}, "
                           f"launches {inv_launched}")
    curve, sweep_launched, sweep_s = counted(lambda: noise_sweep(
        params, cfg64, batches, steps=len(batches), device=dev))
    if sweep_launched != {d: reckoned for d in segsum.CNF_DIRECTIONS} or \
            not np.isfinite(curve["loss"]).all() or \
            curve["total_accuracy"][0] < curve["total_accuracy"][-1]:
        raise RuntimeError(f"noise sweep: {curve}, launches "
                           f"{sweep_launched}")
    emit(phase="harness_flagship", batches=len(batches), graphs=n_graphs,
         rounds=HARNESS_ROUNDS, kernel=kernel, plain=plain,
         solved_gap=gap, launches=kernel_launched,
         launches_reckoned=reckoned, kernel_seconds=kernel_s,
         plain_seconds=plain_s, invariance=invariance,
         invariance_standard_error=se, invariance_seconds=inv_s,
         invariance_launches=inv_launched, noise_sweep=curve,
         noise_sweep_seconds=sweep_s, noise_sweep_launches=sweep_launched)

    # -- one full-width flat train step on every registry task --------------
    model_cfg = QuerySATConfig()
    opt = adabelief(learning_rate=1e-3, eps=1e-8, clip_gradients=True)
    step = make_train_step_for(query_sat_apply, model_cfg, opt, dev)
    tasks = {}
    for task in REGISTRY_TASKS:
        t0 = time.perf_counter()
        # 16 instances, generated in this process and labelled by CDCL
        # (uniform labels of the larger formulas take minutes)
        task_cfg = parse_config(
            ["--task", task, "--train_size", "16", "--test_size", "1",
             "--use_unigen", "false", "--gen_workers", "1", "--max_vars",
             "200" if task == "primes" else "20"])
        batch = SatDataset(generic.build_instances(task_cfg), bucket,
                           cache_dir=data_dir, name=f"smoke_{task}",
                           seed=0, gen_workers=task_cfg.gen_workers or None
                           ).train_data().batches[0]
        data_s = time.perf_counter() - t0
        (batch, plans), = plan_batches([batch], dev)
        params0 = query_sat_init(seeded(0), model_cfg)
        state = TrainState(params=params0, opt_state=opt.init(params0),
                           step=0, generator=seeded(1))
        (state, out), task_launched, step_s = counted(
            lambda: step(state, batch, plans))
        loss = float(out["loss"])
        if not np.isfinite(loss) or task_launched != {
                d: LAUNCHES_PER_TRAIN_STEP for d in segsum.CNF_DIRECTIONS}:
            raise RuntimeError(f"registry task {task}: loss {loss}, "
                               f"launches {task_launched}")
        tasks[task] = dict(loss=loss, graphs=int(batch.n_graphs),
                           vars=int(batch.n_vars),
                           clauses=int(batch.n_clauses),
                           data_seconds=data_s, step_seconds=step_s)
    emit(phase="registry_tasks", tasks=tasks,
         launches_per_step=LAUNCHES_PER_TRAIN_STEP)

    # -- the kernel at `main`'s training shapes -----------------------------
    gen = seeded(0)
    rows = {}
    first = build_plans(train_batches[0]).to(dev)
    for plan in (first.lit_to_clause, first.clause_to_lit):
        row, shape = tools["kernel_row"](plan, model_cfg.query_maps, gen)
        emit(phase="kernel_vs_plain", batch="main_train_batch_0",
             direction=plan.name, **shape, **row)
        rows[plan.name] = row
    shutil.rmtree(run_root)
    seconds = time.perf_counter() - t_phase
    emit(phase="main_phase", seconds=seconds)
    return {"rows": rows, "seconds": seconds,
            "launches_main": launched,
            "launches_main_restore": restore_launched,
            "launches_harness": {d: kernel_launched[d] + inv_launched[d] +
                                 sweep_launched[d]
                                 for d in segsum.CNF_DIRECTIONS}}


def models_phase(dev, data_dir: Path, tools: dict) -> dict:
    """Phase 11: the other model family at `main`'s widths on the 20 000-node
    threshold batch. For each model: the kernel path against the kernel's
    plain version at full depth and against the unplanned path at 4 rounds
    (test-mode logits and loss, one training step's loss and parameter
    gradients, the gradients with both paths' segment sums in the plans'
    order), the launches of a forward and of a step against the count
    reckoned from the code, the wall, busy time and peak memory of a step,
    then `python -m diffusionsat_torch.main --model <name>` in-process on
    phase 10's split (4 steps and `--evaluate`: a finite loss, launches as
    reckoned). Returns the launch counts and the kernel rows of the
    batch's four plans."""
    import numpy as np
    import torch

    from diffusionsat_torch import main as generic
    from diffusionsat_torch.config import parse_config
    from diffusionsat_torch.data.bench_workloads import threshold_3sat_batch
    from diffusionsat_torch.ops import segsum

    sync = tools["sync"]
    t_phase = time.perf_counter()

    def seeded(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def counted(fn):
        segsum.reset_launch_counts()
        out = fn()
        sync()
        return out, {k: v for k, v in segsum.LAUNCHES.items() if v}

    def rel_err(a, b):
        return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)

    # -- the 20k batch and phase 10's split --------------------------------
    batch, _ = threshold_3sat_batch(np.random.default_rng(0), 20000)
    plans = segsum.build_batch_plans(batch, edges=True).to(dev)
    batch = batch.to(dev)
    run_root = data_dir / "models_runs"
    shutil.rmtree(run_root, ignore_errors=True)
    argv = ["--task", "3-sat", "--train_size", str(MAIN_TRAIN_SIZE),
            "--test_size", str(MAIN_TEST_SIZE), "--eval_every", "1000",
            "--ckpt_every", "1000", "--data_dir", str(data_dir),
            "--train_dir", str(run_root)]
    cfg = parse_config(argv)
    (_, test, _), timing = tools["splits"].get("main")
    n_test = len(test)
    emit(phase="models_split", **timing,
         test_batches=n_test, vars=batch.V, clauses=batch.C,
         edges=plans.lit_to_clause.gather.shape[0])

    launches_main: dict[str, dict] = {}
    rows: dict[str, dict] = {}
    for name in OTHER_MODELS:
        t_model = time.perf_counter()
        m = other_model(name, cfg, batch, dev)

        # (a1) full depth: the kernel against its plain version
        rf, rt = m.rounds(False), m.rounds(True)
        fwd_k, fwd_launched = counted(lambda: m.forward(plans, rf))
        with plain_version():
            fwd_p = m.forward(plans, rf)
        (loss_k, grads_k), step_launched = counted(
            lambda: m.train_step(plans, rt))
        with plain_version():
            loss_p, grads_p = m.train_step(plans, rt)
        sync()
        torch.testing.assert_close(fwd_k[0], fwd_p[0],
                                   **OTHER_MODELS_SAME_ORDER_TOL)
        torch.testing.assert_close(fwd_k[1], fwd_p[1],
                                   **OTHER_MODELS_SAME_ORDER_TOL)
        torch.testing.assert_close(loss_k, loss_p,
                                   **OTHER_MODELS_SAME_ORDER_TOL)
        same_order_grad = grads_err(grads_k, grads_p)
        if int(fwd_k[2]) != int(fwd_p[2]) or \
                same_order_grad > OTHER_MODELS_SAME_ORDER_GRAD_TOL:
            raise RuntimeError(f"{name}: steps {int(fwd_k[2])} / "
                               f"{int(fwd_p[2])}, gradient error "
                               f"{same_order_grad}")
        # (b) the launches of one forward and one step, as reckoned
        if fwd_launched != model_launches(name, rf, False) or \
                step_launched != model_launches(name, rt, True):
            raise RuntimeError(
                f"{name}: launches {fwd_launched} / {step_launched}, "
                f"reckoned {model_launches(name, rf, False)} / "
                f"{model_launches(name, rt, True)}")

        # (a2) 4 rounds: the kernel against the unplanned path, each in its
        # own order (logits and loss) and both in the plans' order
        # (gradients)
        short = OTHER_MODELS_SHORT_ROUNDS
        s_k, s_p = (m.forward(p, short) for p in (plans, None))
        (sl_k, sg_k), (sl_p, sg_p) = (m.train_step(p, short)
                                      for p in (plans, None))
        with sequential_segment_sums():
            og_k, og_p = (m.train_step(p, short)[1] for p in (plans, None))
        short_logits = rel_err(s_k[0], s_p[0])
        short_loss = abs(float(s_k[1]) / float(s_p[1]) - 1)
        short_train_loss = abs(float(sl_k) / float(sl_p) - 1)
        short_grad = grads_err(sg_k, sg_p)
        ordered_grad = grads_err(og_k, og_p)
        if short_logits > OTHER_MODELS_LOGIT_SHARE or \
                max(short_loss, short_train_loss) > OTHER_MODELS_LOSS_RTOL \
                or ordered_grad > OTHER_MODELS_ORDERED_GRAD_TOL:
            raise RuntimeError(
                f"{name} at {short} rounds, kernel against unplanned: "
                f"logits {short_logits}, loss {short_loss} / "
                f"{short_train_loss}, gradients {short_grad}, in the "
                f"plans' order {ordered_grad}")

        # a step's wall, busy time and peak memory
        walls = []
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            m.train_step(plans, rt)
            sync()
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated(dev)
        with tools["profile"](activities=tools["activities"]) as prof:
            m.train_step(plans, rt)
            sync()
        busy = sum(tools["dev_us"](e) for e in tools["cuda_kernels"](prof))
        emit(phase="model_kernel_vs_plain", model=name,
             test_rounds=rf, train_rounds=rt,
             max_abs_err_logits=(fwd_k[0] - fwd_p[0]).abs().max().item(),
             loss_kernel=float(fwd_k[1]), loss_plain=float(fwd_p[1]),
             train_loss=float(loss_k), grad_err_same_order=same_order_grad,
             short_rounds=short, short_logit_share=short_logits,
             short_loss_rel=short_loss, short_train_loss_rel=short_train_loss,
             short_grad_err=short_grad, short_grad_err_ordered=ordered_grad,
             steps=int(fwd_k[2]),
             solved=bool(fwd_k[3]["solved"]),
             launches_forward=fwd_launched, launches_step=step_launched,
             step_wall_ms=min(walls) * 1e3,
             step_walls_ms=[w * 1e3 for w in walls],
             step_busy_ms=busy / 1e3, peak_gib=peak / 2 ** 30)

        # (c) main --model <name>: a few steps, then --evaluate
        res, main_launched = counted(lambda: generic.main(
            argv + ["--model", name, "--train_steps",
                    str(OTHER_MODELS_STEPS), "--evaluate"]))
        reckoned = {}
        for d, n in model_launches(name, rt, True).items():
            reckoned[d] = reckoned.get(d, 0) + OTHER_MODELS_STEPS * n
        for d, n in model_launches(name, rf, False).items():
            reckoned[d] = reckoned.get(d, 0) + n_test * n
        run_dir = Path(res["run_dir"])
        losses = [r["loss"] for r in (json.loads(x) for x in (
            run_dir / "train_log.jsonl").read_text().splitlines())
            if "loss" in r]
        if main_launched != reckoned or not losses or \
                not np.isfinite(losses).all() or \
                res["state"].step != OTHER_MODELS_STEPS:
            raise RuntimeError(f"main --model {name}: launches "
                               f"{main_launched} (reckoned {reckoned}), "
                               f"losses {losses}")
        launches_main[name] = main_launched
        emit(phase="model_main", model=name, launches=main_launched,
             losses=losses, evaluate=res["evaluate"],
             train_seconds=res["seconds"]["train"],
             wall_ms_per_step=res["seconds"]["train"] /
             OTHER_MODELS_STEPS * 1e3,
             evaluate_seconds=res["seconds"]["evaluate"],
             seconds=time.perf_counter() - t_model)

    # -- the kernel on every plan of the 20k batch, the edge plans new ------
    gen = seeded(0)
    for plan in (plans.lit_to_clause, plans.clause_to_lit, plans.edge_to_lit,
                 plans.lit_to_edge):
        row, shape = tools["kernel_row"](plan, cfg.feature_maps, gen)
        emit(phase="kernel_vs_plain", batch="threshold3sat_20k",
             direction=plan.name, **shape, **row)
        rows[plan.name] = row
    shutil.rmtree(run_root)
    seconds = time.perf_counter() - t_phase
    emit(phase="models_phase", seconds=seconds)
    total: dict[str, int] = {}
    for counts in launches_main.values():
        for d, n in counts.items():
            total[d] = total.get(d, 0) + n
    return {"rows": rows, "seconds": seconds, "launches_main": total,
            "launches_by_model": launches_main}


def tsp_part(dev, tools) -> dict:
    """Phase 12, TSP: each core (DenseGNN, MatrixSE) at the model's widths,
    unsupervised with subtour cuts and supervised, trained `TSP_STEPS`
    AdaBelief steps on one fixed batch from a seeded init: the loss must
    fall; the trained model's logits and losses on the card against the
    same params on the CPU; a step's wall, busy time, host finder time and
    peak memory; the optimality gap of greedy and beam decoding on a test
    batch (a reading: the repo holds no TSP model mark)."""
    import numpy as np
    import torch
    from torch.utils import _pytree as pytree

    from diffusionsat_torch.train.adabelief import adabelief
    from diffusionsat_torch.tsp import loss as tsp_loss_module
    from diffusionsat_torch.tsp.data import EuclideanTSP
    from diffusionsat_torch.tsp.metrics import TSPMetrics
    from diffusionsat_torch.tsp.model import (
        TSPMatrixSEConfig,
        tsp_matrix_se_apply,
        tsp_matrix_se_init,
    )

    sync = tools["sync"]
    data = EuclideanTSP(min_node_count=TSP_NODES, max_node_count=TSP_NODES,
                        padded_size=TSP_NODES, train_size=TSP_BATCH,
                        test_size=TSP_BATCH, seed=0)
    t0 = time.perf_counter()
    train = next(data.batches("train", TSP_BATCH))
    test = next(data.batches("test", TSP_BATCH))
    emit(phase="tsp_data", seconds=time.perf_counter() - t0,
         instances=2 * TSP_BATCH, nodes=TSP_NODES)
    host = {k: torch.from_numpy(train[k]) for k in ("adj_matrix", "labels")}
    adj, labels = (host[k].to(dev) for k in ("adj_matrix", "labels"))
    test_adj = torch.from_numpy(test["adj_matrix"]).to(dev)
    test_labels = torch.from_numpy(test["labels"]).to(dev)

    # the host finder's seconds (its device sync included)
    finder = {"calls": 0, "seconds": 0.0}
    real_pairs = tsp_loss_module.subtour_pairs

    def timed_pairs(*args, **kw):
        t = time.perf_counter()
        out = real_pairs(*args, **kw)
        finder["calls"] += 1
        finder["seconds"] += time.perf_counter() - t
        return out

    tsp_loss_module.subtour_pairs = timed_pairs
    out = {}
    try:
        for core in ("dense_gnn", "matrix_se"):
            for supervised in (False, True):
                name = f"{core}_{'supervised' if supervised else 'cuts'}"
                cfg = TSPMatrixSEConfig(
                    feature_maps=TSP_FEATURES, rounds=TSP_ROUNDS,
                    use_matrix_se=core == "matrix_se",
                    supervised=supervised, n_vertices_prior=TSP_NODES)
                g = torch.Generator(device=dev)
                g.manual_seed(0)
                params = tsp_matrix_se_init(g, cfg)
                opt = adabelief(learning_rate=TSP_LR, eps=1e-8,
                                clip_gradients=True)
                opt_state = opt.init(params)

                def step(params, opt_state):
                    leaves, spec = pytree.tree_flatten(params)
                    leaves = [p.detach().requires_grad_(True)
                              for p in leaves]
                    _, total, _ = tsp_matrix_se_apply(
                        pytree.tree_unflatten(leaves, spec), cfg, adj,
                        labels, device=dev)
                    grads = torch.autograd.grad(total, leaves,
                                                allow_unused=True)
                    grads = [torch.zeros_like(p) if gr is None else gr
                             for gr, p in zip(grads, leaves)]
                    params, opt_state = opt.update(
                        pytree.tree_unflatten(grads, spec), opt_state,
                        params)
                    return params, opt_state, total.detach()

                torch.cuda.reset_peak_memory_stats(dev)
                losses, walls = [], []
                finder.update(calls=0, seconds=0.0)
                for _ in range(TSP_STEPS):
                    sync()
                    t0 = time.perf_counter()
                    params, opt_state, loss = step(params, opt_state)
                    losses.append(float(loss))
                    walls.append(time.perf_counter() - t0)
                peak = torch.cuda.max_memory_allocated(dev)
                finder_s = finder["seconds"] / TSP_STEPS
                finder_calls = finder["calls"] / TSP_STEPS
                with tools["profile"](activities=tools["activities"]) as prof:
                    step(params, opt_state)
                    sync()
                kernels = tools["cuda_kernels"](prof)
                busy = sum(tools["dev_us"](e) for e in kernels) / 1e3
                if busy <= 0:
                    raise RuntimeError(f"tsp {name}: the profile shows no "
                                       "device time")
                fifth = max(1, TSP_STEPS // 5)
                first, last = (float(np.mean(losses[:fifth])),
                               float(np.mean(losses[-fifth:])))
                if not np.isfinite(losses).all() or \
                        not last < LOSS_FALL_FACTOR * first:
                    raise RuntimeError(f"tsp {name}: losses {losses}")

                # the trained params on the card and on the CPU, for each
                # core on the model that takes the host cuts
                share = loss_rel = None
                t0 = time.perf_counter()
                if not supervised:
                    with torch.no_grad():
                        lc, tc, _ = tsp_matrix_se_apply(params, cfg, adj,
                                                        labels, device=dev)
                        lh, th, _ = tsp_matrix_se_apply(
                            pytree.tree_map(lambda t: t.cpu(), params), cfg,
                            host["adj_matrix"], host["labels"],
                            device="cpu")
                    share = (lc.cpu() - lh).abs().max().item() / \
                        lh.abs().max().item()
                    loss_rel = abs(float(tc) / float(th) - 1)
                    if share > TSP_CPU_SHARE or \
                            loss_rel > TSP_CPU_LOSS_RTOL:
                        raise RuntimeError(
                            f"tsp {name}: card against CPU: logits "
                            f"{share}, loss {loss_rel}")
                cpu_seconds = time.perf_counter() - t0

                # decoding the test batch: the optimality gap, a reading
                with torch.no_grad():
                    test_logits = tsp_matrix_se_apply(
                        params, cfg, test_adj, test_labels, training=False,
                        device=dev)[0][..., 0]
                gaps = {}
                for decoder, beam in (("greedy", False), ("beam", True)):
                    m = TSPMetrics(beam_width=TSP_BEAM_WIDTH, use_beam=beam)
                    t0 = time.perf_counter()
                    m.update_state({"prediction": test_logits}, test)
                    gaps[decoder] = dict(m.get_values(),
                                         seconds=time.perf_counter() - t0)
                out[name] = dict(step_wall_ms=float(np.median(walls[1:]))
                                 * 1e3, step_busy_ms=busy,
                                 finder_ms_per_step=finder_s * 1e3,
                                 host_syncs_per_step=finder_calls,
                                 peak_gib=peak / 2 ** 30)
                emit(phase="tsp_train", model=name, steps=TSP_STEPS,
                     losses=losses, first_fifth=first, last_fifth=last,
                     card_vs_cpu_logit_share=share,
                     card_vs_cpu_loss_rel=loss_rel,
                     card_vs_cpu_seconds=cpu_seconds,
                     step_walls_ms=[w * 1e3 for w in walls],
                     kernels_per_step=sum(e.count for e in kernels),
                     gaps=gaps, **out[name])
    finally:
        tsp_loss_module.subtour_pairs = real_pairs
    return out


def hyperopt_part(dev, data_dir: Path, tools: dict) -> dict:
    """Phase 12, hyperparameter search: `python -m
    diffusionsat_torch.hyperopt` in-process, 2 TPE trials on its own data
    at the space's widths. Each trial, as the script runs it, is also
    scored through the kernel's plain version on the same params and draws
    (within 0.02); the whole run's launches must equal the count reckoned
    from the code; and afterwards each trial's first step through the
    kernel and through its plain version over the same plans, from the same
    init and batch, must give the same loss. Returns the launches and the
    kernels line's rows at the trials' shapes."""
    import numpy as np
    import torch

    from diffusionsat_torch import cuda_graphs
    from diffusionsat_torch import hyperopt
    from diffusionsat_torch.ops import segsum

    sync = tools["sync"]
    (dataset, n_train, n_test), timing = tools["splits"].get("hyperopt")
    emit(phase="hyperopt_split", **timing,
         train_batches=n_train, test_batches=n_test)

    trials = []
    real_run = hyperopt.run_trial

    def run_trial(hp, dataset, steps, seed, device, planned):
        train, test = planned
        sync()
        t0 = time.perf_counter()
        cfg, state, losses = hyperopt.train_trial(hp, train, steps, seed,
                                                  device)
        sync()
        t1 = time.perf_counter()
        score = hyperopt.score_trial(state.params, cfg, test, device)
        sync()
        t2 = time.perf_counter()
        # the same params and draws through the plain version, eager (a
        # graph replays the launches it captured); no launch is counted
        with plain_version(), cuda_graphs.eager():
            plain = hyperopt.score_trial(state.params, cfg, test, device)
        trials.append(dict(hp=hp, seed=seed, cfg=cfg, planned=planned,
                           losses=[float(x) for x in losses], score=score,
                           plain_score=plain, train_seconds=t1 - t0,
                           eval_seconds=t2 - t1))
        return score

    out_file = data_dir / "hyperopt_trials.jsonl"
    out_file.unlink(missing_ok=True)
    hyperopt.run_trial = run_trial
    try:
        segsum.reset_launch_counts()
        t0 = time.perf_counter()
        hyperopt.main(["--trials", str(HYPEROPT_TRIALS),
                       "--steps_per_trial", str(HYPEROPT_STEPS),
                       "--train_size", str(HYPEROPT_TRAIN_SIZE),
                       "--data_dir", str(data_dir), "--out", str(out_file)])
        sync()
        seconds = time.perf_counter() - t0
        launched = dict(segsum.LAUNCHES)
    finally:
        hyperopt.run_trial = real_run
    records = [json.loads(x) for x in out_file.read_text().splitlines()]
    n_eval = min(hyperopt.EVAL_BATCHES, n_test)
    reckoned = {d: 0 for d in segsum.CNF_DIRECTIONS}
    for t in trials:
        t["launches"] = hyperopt_launches(t["cfg"], HYPEROPT_STEPS, n_eval)
        for d, n in t["launches"].items():
            reckoned[d] += n
    if launched != reckoned or len(records) != HYPEROPT_TRIALS or \
            [r["accuracy"] for r in records] != [t["score"] for t in trials]:
        raise RuntimeError(f"hyperopt: launches {launched}, reckoned "
                           f"{reckoned}; records {records}")

    # each trial's first step, through the kernel and its plain version
    for t in trials:
        train = t["planned"][0]
        _, _, (loss_k,) = hyperopt.train_trial(t["hp"], train, 1, t["seed"],
                                               dev)
        with plain_version():
            _, _, (loss_p,) = hyperopt.train_trial(t["hp"], train, 1,
                                                   t["seed"], dev)
        t["first_loss_kernel"], t["first_loss_plain"] = \
            float(loss_k), float(loss_p)
        gap = abs(t["score"] - t["plain_score"])
        if float(loss_k) != float(loss_p) or gap > HYPEROPT_SOLVED_TOL or \
                not np.isfinite(t["losses"]).all():
            raise RuntimeError(f"hyperopt trial {t['seed']}: first loss "
                               f"{float(loss_k)} / {float(loss_p)}, solved "
                               f"{t['score']} / {t['plain_score']}")
        emit(phase="hyperopt_trial", trial=t["seed"], hp=t["hp"],
             feature_maps=t["cfg"].feature_maps,
             query_maps=t["cfg"].query_maps, steps=HYPEROPT_STEPS,
             losses=t["losses"], first_loss_kernel=t["first_loss_kernel"],
             first_loss_plain=t["first_loss_plain"],
             solved_kernel=t["score"], solved_plain=t["plain_score"],
             launches=t["launches"], train_seconds=t["train_seconds"],
             step_ms=t["train_seconds"] / HYPEROPT_STEPS * 1e3,
             eval_seconds=t["eval_seconds"])
    emit(phase="hyperopt", seconds=seconds, trials=HYPEROPT_TRIALS,
         launches=launched, launches_reckoned=reckoned, eval_batches=n_eval)

    # the kernel at the trials' shapes: the first training batch's plans
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    plans = segsum.build_batch_plans(dataset.train_data().batches[0]).to(dev)
    rows = []
    for F in HYPEROPT_WIDTHS:
        for plan in (plans.lit_to_clause, plans.clause_to_lit):
            row, shape = tools["kernel_row"](plan, F, gen)
            emit(phase="kernel_vs_plain", batch="hyperopt_train_batch_0",
                 direction=plan.name, **shape, **row)
            rows.append(dict(name=f"gather_segsum:{plan.name}",
                             route="cuda", source=KERNEL_SOURCE,
                             replaces=REPLACES, launches=launched[plan.name],
                             max_abs_err=row["max_abs_err"], ms=row["ms"],
                             plain_ms=row["plain_ms"],
                             bound_ms=row["bound_ms"],
                             bound_by=row["bound_by"],
                             library_ms=row["library_ms"],
                             shapes=f"hyperopt_train_batch_0, F={F}"))
    out_file.unlink()
    return {"launches": launched, "rows": rows}


def anf_studies_part(dev, data_dir: Path, tools: dict) -> dict:
    """Phase 12, the ANF studies: `python -m
    diffusionsat_torch.anf_error_structure` in-process with the flagship
    at 64 rounds and the input-anchor ladder on the test batches holding
    the split's first 32 systems, held against the record's first 32
    (per-variable accuracy within 0.005, systems solved raw and at each
    anchor level within 2), its launches as reckoned, its wall split into
    device and host; and `python -m diffusionsat_torch.anf_prior_study` on
    the host over the first 8 systems of the repo's marginals, timed, its
    conflicts beside the record's. Returns the study's launches."""
    from diffusionsat_torch import anf_error_structure, anf_prior_study
    from diffusionsat_torch.ops import segsum

    sync = tools["sync"]
    batches, timing = tools["splits"].get("anf_test")
    n_batches, covered = 0, 0
    while covered < ANF_STUDY_SYSTEMS:
        covered += int(batches[n_batches].n_graphs)
        n_batches += 1
    emit(phase="anf_study_split", **timing, batches=n_batches,
         systems=covered)

    device_s = [0.0]
    real_apply = anf_error_structure.anf_sat_apply

    def timed_apply(*args, **kw):
        sync()
        t = time.perf_counter()
        out = real_apply(*args, **kw)
        sync()
        device_s[0] += time.perf_counter() - t
        return out

    out_file = data_dir / "anf_structure.json"
    anf_error_structure.anf_sat_apply = timed_apply
    try:
        segsum.reset_launch_counts()
        t0 = time.perf_counter()
        summary = anf_error_structure.main([
            "--ckpt", str(ANF_CKPT), "--test_rounds", "64",
            "--input_anchor", "--skip_frac_ladder", "--max_batches",
            str(n_batches), "--data_dir", str(data_dir), "--out",
            str(out_file)])
        sync()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in segsum.LAUNCHES.items() if v}
    finally:
        anf_error_structure.anf_sat_apply = real_apply
    reckoned = {"node_to_clause": 3 * 64 * n_batches,
                "clause_to_node": 64 * n_batches,
                "and_to_var": 64 * n_batches}
    mine = json.loads(out_file.read_text())["systems"][:ANF_STUDY_SYSTEMS]
    records = [json.loads(p.read_text()) for p in ANF_STUDY_RECORDS]
    ladder = list(records[0]["summary"]["input_anchor_solved_at"])

    def readings(systems):
        """accuracy, raw solved, and solved at each anchor level"""
        out = {"per_var_accuracy": 1.0 - sum(r["n_wrong"] for r in systems)
               / sum(r["n_vars"] for r in systems),
               "raw_solved": sum(r["already_solved"] for r in systems)}
        for i, spec in enumerate(ladder):
            out[f"anchor_{spec}"] = sum(
                1 for r in systems
                if r.get("anchor_solved_at") in ladder[:i + 1])
        return out

    got = readings(mine)
    theirs = [readings(r["systems"][:ANF_STUDY_SYSTEMS]) for r in records]
    outside = {}
    for k, v in got.items():
        tol = ANF_STUDY_ACC_TOL if k == "per_var_accuracy" else \
            ANF_STUDY_SYSTEMS_TOL
        lo, hi = min(t[k] for t in theirs), max(t[k] for t in theirs)
        if not lo - tol <= v <= hi + tol:
            outside[k] = (v, lo, hi)
    if launched != reckoned or len(mine) != ANF_STUDY_SYSTEMS or outside:
        raise RuntimeError(f"anf error structure: launches {launched} "
                           f"(reckoned {reckoned}); outside the records' "
                           f"span: {outside}; {got} against {theirs}")
    emit(phase="anf_error_structure", batches=n_batches,
         systems=summary["n_systems"], compared=ANF_STUDY_SYSTEMS,
         readings=got, records={p.name: t for p, t in
                                zip(ANF_STUDY_RECORDS, theirs)},
         launches=launched, launches_reckoned=reckoned, wall_seconds=wall,
         device_seconds=device_s[0], host_seconds=wall - device_s[0],
         summary=summary)
    out_file.unlink()

    # the input-prior study: host CDCL only, timed
    t0 = time.perf_counter()
    prior, per = anf_prior_study.main([
        "--marginals", str(PRIOR_MARGINALS), "--max_systems",
        str(PRIOR_SYSTEMS), "--data_dir", str(data_dir)])
    seconds = time.perf_counter() - t0
    arms = ("plain", "seed_free", "seed_all", "input_first", "oracle")
    rec = json.loads(PRIOR_RECORD.read_text())["per_system"]
    same = sum(all(a[arm]["conflicts"] == b[arm]["conflicts"]
                   for arm in arms) for a, b in zip(per, rec))
    if len(per) != PRIOR_SYSTEMS or not all(
            r[arm]["solved"] for r in per for arm in arms):
        raise RuntimeError(f"anf prior study: {prior}")
    emit(phase="anf_prior_study", systems=len(per), seconds=seconds,
         systems_equal_to_record=same,
         ms_by_arm={arm: prior[arm]["total_ms"] for arm in arms},
         conflicts_median={arm: prior[arm]["conflicts_median"]
                           for arm in arms})
    return {"launches": launched}


def studies_phase(dev, data_dir: Path, tools: dict) -> dict:
    """Phase 12: the TSP stack, the hyperparameter search and the ANF
    studies (`tsp_part`, `hyperopt_part`, `anf_studies_part`). Returns the
    hyperopt rows of the kernels line and the ANF study's launches."""
    t0 = time.perf_counter()
    tsp = tsp_part(dev, tools)
    search = hyperopt_part(dev, data_dir, tools)
    anf = anf_studies_part(dev, data_dir, tools)
    seconds = time.perf_counter() - t0
    emit(phase="studies_phase", seconds=seconds)
    return {"tsp": tsp, "rows": search["rows"],
            "launches_hyperopt": search["launches"],
            "launches_anf_structure": anf["launches"], "seconds": seconds}


class PinnedHeadOrder:
    """`_head_weighted_loss` with the rank order of a reference run:
    `record()` sorts as the model does and keeps each round's order,
    `replay()` weights the heads in the kept order."""

    def __init__(self):
        self.orders, self.at = [], None

    def record(self):
        self.orders, self.at = [], None

    def replay(self):
        self.at = 0

    def __call__(self, per_graph_loss, logit_maps):
        import torch

        costs = torch.square(torch.arange(
            1, logit_maps + 1, dtype=torch.float32,
            device=per_graph_loss.device))
        if self.at is None:
            order = torch.argsort(per_graph_loss, dim=-1, descending=True)
            self.orders.append(order)
        else:
            order = self.orders[self.at]
            self.at += 1
        ranked = torch.gather(per_graph_loss, -1, order)
        return torch.sum(ranked * costs) / torch.sum(costs)


def labeled_threshold_batch(rng, budget: int, min_vars: int = 3,
                            max_vars: int = 30):
    """A batch packed to `budget` nodes as `threshold_3sat_batch` packs
    it, of satisfiable threshold 3-SAT formulas labelled with a CDCL
    solution each (an unsatisfiable draw is skipped): the trained model's
    regime. (With random labels the flagship's 32-round loss is over 200
    and its f32 gradient lies 0.14 of a tensor's largest entry from
    float64.)"""
    from diffusionsat_torch.graph.batch import BucketSpec, build_batch
    from diffusionsat_torch.sat.solvers import solve

    bucket = BucketSpec.for_node_budget(budget, max_graphs=512)
    formulas, sols = [], []
    v_tot = c_tot = e_tot = 0
    while True:
        n = int(rng.integers(min_vars, max_vars + 1))
        m = int(4.258 * n + 58.26 * n ** (-2.0 / 3.0))
        clauses = [[int(v) if rng.random() < 0.5 else -int(v)
                    for v in rng.choice(n, size=3, replace=False) + 1]
                   for _ in range(m)]
        if (2 * (v_tot + n) + c_tot + m > budget
                or v_tot + n > bucket.max_vars
                or c_tot + m > bucket.max_clauses
                or e_tot + 3 * m > bucket.max_edges
                or len(formulas) >= bucket.max_graphs):
            break
        sat, model = solve(clauses, n)
        if not sat:
            continue
        formulas.append((n, clauses))
        sols.append([int(x > 0) for x in model])
        v_tot += n
        c_tot += m
        e_tot += 3 * m
    return build_batch(formulas, bucket, solutions=sols)


class CaptureGrads:
    """An optimizer that keeps the gradients it is handed as its state and
    leaves the params as they are: a step's gradients, read back."""

    def init(self, params):
        return None

    def update(self, grads, state, params):
        return params, grads


def multi_rank(ctx, spec: dict) -> dict:
    """Phase 13 on one rank (a spawned process: torch and the port only).
    Returns host data: readings, checks' errors and launch counts."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from diffusionsat_torch.diffusion.sampler import make_diffusion_chain
    from diffusionsat_torch.graph.dense_batch import densify_batches_quantized
    from diffusionsat_torch.models import query_sat as qs
    from diffusionsat_torch.models.anf_sat import ANFSATConfig, anf_sat_apply
    from diffusionsat_torch.models.query_sat_dense import (
        query_sat_dense_apply,
    )
    from diffusionsat_torch.ops import segsum
    from diffusionsat_torch.parallel import dp, graph_partition, halo
    from diffusionsat_torch.parallel.comm import all_reduce_sum, transport
    from diffusionsat_torch.sat.cnf import VariableAssignment
    from diffusionsat_torch.train.adabelief import adabelief
    from diffusionsat_torch.train.checkpoint import params_from_numpy
    from diffusionsat_torch.train.loop import (
        TrainState,
        _grad_leaves,
        _grads_of,
        build_plans,
    )

    dev = ctx.device
    mesh = ctx.mesh(n_data=ctx.world)
    gp_mesh = ctx.mesh(n_data=1, n_graph=ctx.world)
    rank, n = ctx.rank, ctx.world

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    out: dict = {"rank": rank, "transport": transport(mesh.data_group, dev)}
    params = params_from_numpy(spec["params"], dev)
    cfg = qs.QuerySATConfig.from_meta(spec["config"])

    def gen(seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return g

    def state_of(p, opt, seed=0):
        return TrainState(params=p, opt_state=opt.init(p), step=0,
                          generator=gen(seed))

    def leaves(tree):
        return pytree.tree_leaves(tree)

    def grad_share(got, want):
        """Largest error as a share of its tensor's largest entry,
        floored at a hundredth of the largest gradient of all."""
        top = max(w.abs().max().item() for w in want)
        return max((g - w).abs().max().item() /
                   max(w.abs().max().item(), top / 100)
                   for g, w in zip(got, want))

    def params_hash(p):
        h = hashlib.sha1()
        for t in leaves(p):
            h.update(t.detach().cpu().numpy().tobytes())
        return h.hexdigest()

    def single_grads(apply_fn, model_cfg, p, batch, g, plans=None, **kw):
        tree, lv, spec_ = _grad_leaves(p)
        if plans is not None:
            kw["plans"] = plans
        _, loss, _, _ = apply_fn(tree, model_cfg, batch, g, training=True,
                                 labels=batch.solutions, device=dev, **kw)
        return loss.detach(), _grads_of(loss, lv, spec_)[1]

    def barrier_ms(fn, iters):
        fn()
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        return (time.perf_counter() - t0) / iters * 1e3

    # -- DP: dense f32, flat through the kernel, ANF flat --------------
    seed = spec["seed"]
    cnf = [b for b in spec["dp_batches"]]
    dense = [densify_batches_quantized([b])[0] for b in cnf]
    anf_cfg = ANFSATConfig.from_meta(spec["anf_config"],
                                     train_rounds=MULTI_ANF_ROUNDS)
    anf_params = params_from_numpy(spec["anf_params"], dev)
    for name, apply_fn, model_cfg, p, batches in (
            ("dp_dense", query_sat_dense_apply, cfg, params, dense),
            ("dp_flat", qs.query_sat_apply, cfg, params, cnf),
            ("dp_anf", anf_sat_apply, anf_cfg, anf_params,
             spec["anf_batches"])):
        mine = batches[mesh.data_index].to(dev)
        plans = build_plans(batches[mesh.data_index])
        plans = None if plans is None else plans.to(dev)
        step = dp.make_dp_train_step(model_cfg, CaptureGrads(), mesh,
                                     apply_fn)
        st, o = step(state_of(p, CaptureGrads(), seed), mine, plans)
        got = leaves(st.opt_state)
        rec = {"loss": o["loss"].item(), "gradnorm": o["gradnorm"].item()}
        if rank == 0:
            # every rank's gradient again, here, with that rank's draws
            refs, losses = [], []
            for r, b in enumerate(batches):
                bp = build_plans(b)
                loss, g = single_grads(
                    apply_fn, model_cfg, p, b.to(dev),
                    dp.rank_generator(seed, r, 0, dev),
                    None if bp is None else bp.to(dev))
                losses.append(loss.item())
                refs.append(g)
            mean = [torch.stack(gs).mean(0) for gs in zip(*refs)]
            rec.update(single_losses=losses,
                       loss_error=abs(rec["loss"] - float(np.mean(losses))),
                       grad_error=grad_share(got, mean))
            del refs, mean
        opt = adabelief(learning_rate=1e-3)
        step = dp.make_dp_train_step(model_cfg, opt, mesh, apply_fn)
        st = state_of(p, opt, seed)
        segsum.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        losses = []
        for _ in range(MULTI_DP_STEPS):
            st, o = step(st, mine, plans)
            losses.append(o["loss"].item())
        sync()
        rec.update(step_wall_s=(time.perf_counter() - t0) / MULTI_DP_STEPS,
                   launches=dict(segsum.LAUNCHES), losses=losses,
                   hash=params_hash(st.params))
        out[name] = rec
        del st, step, got
    del dense

    # -- GP (all-reduce) and halo on one batch, 4 clause shards --------
    whole = spec["gp_batch"]
    local, local_plans = graph_partition.place_local_batch(
        graph_partition.build_local_batches(whole, n), gp_mesh)
    whole_plans = segsum.build_batch_plans(whole).to(dev)
    whole = whole.to(dev)
    plan = halo.build_halo_plan(spec["gp_batch"], n)
    out["halo_rows"] = plan.halo_rows
    out["literal_rows"] = plan.literal_rows
    pinned = PinnedHeadOrder()
    sorted_loss = qs._head_weighted_loss
    qs._head_weighted_loss = pinned
    gp = {}
    try:
        for rounds in (MULTI_GP_SHORT_ROUNDS, cfg.train_rounds):
            rcfg = dataclasses.replace(cfg, train_rounds=rounds)
            pinned.record()
            ref_loss, ref = single_grads(qs.query_sat_apply, rcfg, params,
                                         whole, gen(seed), whole_plans)
            if rounds == MULTI_GP_SHORT_ROUNDS:
                # the same step in another summation order on one device
                # (the unplanned path): how far order alone moves the
                # gradients
                pinned.replay()
                plain_loss, plain = single_grads(qs.query_sat_apply, rcfg,
                                                 params, whole, gen(seed))
                gp[f"plain_{rounds}"] = dict(
                    loss=plain_loss.item(), ref_loss=ref_loss.item(),
                    grad_error=grad_share(plain, ref))
                del plain
            for mode in ("gp", "halo"):
                step = graph_partition.make_gp_train_step(
                    rcfg, CaptureGrads(), gp_mesh,
                    halo=plan.view(gp_mesh.graph_index)
                    if mode == "halo" else None)
                pinned.replay()
                segsum.reset_launch_counts()
                sync()
                t0 = time.perf_counter()
                st, o = step(state_of(params, CaptureGrads(), seed), local,
                             local_plans)
                sync()
                wall = time.perf_counter() - t0
                gp[f"{mode}_{rounds}"] = dict(
                    loss=o["loss"].item(), ref_loss=ref_loss.item(),
                    grad_error=grad_share(leaves(st.opt_state), ref),
                    wall_s=wall, launches=dict(segsum.LAUNCHES))
                del st
            del ref
    finally:
        qs._head_weighted_loss = sorted_loss
    out["gp"] = gp

    # -- a round's exchanges, timed: [2V, Q] all-reduce against halo ----
    x = torch.randn((2 * whole.V, cfg.query_maps), generator=gen(rank),
                    device=dev)
    view = plan.view(gp_mesh.graph_index).to(dev)
    out["exchange_ms"] = {
        "all_reduce": barrier_ms(lambda: all_reduce_sum(
            x, gp_mesh.graph_group), MULTI_EXCHANGE_ITERS),
        "halo": barrier_ms(lambda: halo.halo_exchange(
            x, view, gp_mesh.graph_group), MULTI_EXCHANGE_ITERS)}
    del x, local, whole, whole_plans

    # -- the sharded sampler chain ------------------------------------------
    cfg32 = qs.QuerySATConfig.from_meta(spec["config"], test_rounds=32)
    chain = make_diffusion_chain(cfg32, diffusion_steps=MULTI_CHAIN_STEPS,
                                 test_rounds=32)
    cb = spec["chain_batch"].to(dev)
    cplans = segsum.build_batch_plans(spec["chain_batch"]).to(dev)
    sync()
    t0 = time.perf_counter()
    got = dp.dp_chain(chain, params, cb, gen(100 + mesh.data_index), mesh,
                      cplans)
    sync()
    rec = {"wall_s": time.perf_counter() - t0}
    if got is not None:
        bits, solved = (t.cpu().numpy() for t in got)
        alone = [chain(params, cb, gen(100 + r), plans=cplans)
                 for r in range(n)]
        rec["bitwise_equal"] = all(
            np.array_equal(bits[r], a[0].cpu().numpy()) and
            np.array_equal(solved[r], a[1].cpu().numpy())
            for r, a in enumerate(alone))
        nv, clauses = spec["chain_formula"]
        counted = unsat = 0
        for r in range(n):
            for g in np.flatnonzero(solved[r][:spec["chain_graphs"]]):
                asgn = VariableAssignment(nv, clauses)
                asgn.assign_all(bits[r][g * nv:(g + 1) * nv].astype(bool))
                counted += 1
                unsat += not asgn.satisfiable()
        rec.update(counted=counted, unsat=unsat,
                   solved_fraction=float(solved[:, :spec[
                       "chain_graphs"]].mean()))
    out["chain"] = rec
    return out


def multi_phase(dev, data_dir: Path, tools: dict) -> list[dict]:
    """Phase 13: multi-device. Four ranks (NCCL, one card each, with 4
    cards visible; else 4 gloo ranks on one card): DP at full width dense
    f32 and flat through the kernel, ANF DP with the r17 flagship's config,
    the clause-sharded step with the all-reduce and with the halo exchange
    against the single-device planned step, a round's exchanges timed, and
    the sharded sampler chain against each rank's chain alone. Then the
    kernel on the per-shard plans (and the halo's send and receive plans)
    of the 20 000-node batch split 4 ways. Returns the kernels line's
    rows."""
    import numpy as np
    import torch

    from diffusionsat_torch.diffusion.sampler import DiffusionSampler
    from diffusionsat_torch.models.query_sat import QuerySATConfig
    from diffusionsat_torch.ops import segsum
    from diffusionsat_torch.parallel import graph_partition, halo
    from diffusionsat_torch.parallel.mesh import launch
    from diffusionsat_torch.sat.cnf import CNF
    from diffusionsat_torch.train.checkpoint import (
        load_params,
        params_from_numpy,
    )

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= MULTI_RANKS else "gloo"
    devices = None if backend == "nccl" else ["cuda:0"] * MULTI_RANKS
    emit(multi={"ranks": MULTI_RANKS, "transport": "nccl" if backend ==
                "nccl" else "gloo-host", "cards": cards})

    # the host inputs, built once here and handed to the ranks
    t0 = time.perf_counter()
    tree, meta = load_params(CKPT)
    anf_tree, anf_meta = load_params(ANF_CKPT)
    dp_batches = [labeled_threshold_batch(np.random.default_rng(10 + r),
                                          20000)
                  for r in range(MULTI_RANKS)]
    gp_batch = labeled_threshold_batch(np.random.default_rng(0), 20000)
    (_, anf_train), _ = tools["splits"].get("anf_train")
    cfg32 = QuerySATConfig.from_meta(meta["config"], test_rounds=32)
    sampler = DiffusionSampler(params_from_numpy(tree, "cpu"), cfg32,
                               CNF.load(UF20),
                               diffusion_steps=MULTI_CHAIN_STEPS,
                               test_rounds=32, dense=False, device="cpu")
    spec = dict(params=tree, config=meta["config"], anf_params=anf_tree,
                anf_config=anf_meta["config"], seed=5,
                dp_batches=dp_batches,
                anf_batches=list(anf_train)[:MULTI_RANKS],
                gp_batch=gp_batch, chain_batch=sampler.batch,
                chain_formula=(sampler.n_vars, sampler.clauses),
                chain_graphs=sampler.graphs_per_batch)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = launch(multi_rank, MULTI_RANKS, backend, devices, spec)
    ranks_s = time.perf_counter() - t0
    r0 = res[0]
    transports = {r["transport"] for r in res}

    # DP: the averaged loss and gradients, replicated params, launches
    for name in ("dp_dense", "dp_flat", "dp_anf"):
        recs = [r[name] for r in res]
        a = recs[0]
        emit(phase="multi_" + name, ranks=MULTI_RANKS,
             transport=sorted(transports), loss=a["loss"],
             single_losses=a["single_losses"], loss_error=a["loss_error"],
             grad_error=a["grad_error"], tolerance=MULTI_DP_GRAD_TOL,
             gradnorm=a["gradnorm"], steps=MULTI_DP_STEPS,
             step_wall_s=[r["step_wall_s"] for r in recs],
             losses=a["losses"], launches=[r["launches"] for r in recs],
             params_replicated=len({r["hash"] for r in recs}) == 1)
        if a["grad_error"] > MULTI_DP_GRAD_TOL or \
                a["loss_error"] > 1e-5 * abs(a["loss"]):
            raise RuntimeError(f"{name}: the DP step is not the mean of the "
                               f"single-rank steps: {a}")
        if len({r["hash"] for r in recs}) != 1:
            raise RuntimeError(f"{name}: params differ across ranks")
        if not np.all(np.isfinite(a["losses"])):
            raise RuntimeError(f"{name}: non-finite loss")
    for r in res:
        want = {d: MULTI_DP_STEPS * LAUNCHES_PER_TRAIN_STEP
                for d in ("lit_to_clause", "clause_to_lit")}
        if {d: r["dp_flat"]["launches"].get(d, 0) for d in want} != want:
            raise RuntimeError(f"dp_flat launches on rank {r['rank']}: "
                               f"{r['dp_flat']['launches']}")
        if any(r["dp_dense"]["launches"].values()):
            raise RuntimeError("dp_dense launched the segsum kernel")
        if min(r["dp_anf"]["launches"].get(d, 0) for d in (
                "node_to_clause", "clause_to_node")) <= 0:
            raise RuntimeError(f"dp_anf launches: {r['dp_anf']['launches']}")

    # GP and halo against the single-device planned step
    bytes_round = halo.comm_bytes_per_round(
        halo.build_halo_plan(gp_batch, MULTI_RANKS),
        QuerySATConfig.from_meta(meta["config"]).query_maps)
    failed = []
    for key, g in r0["gp"].items():
        mode, rounds = key.split("_")
        if mode == "plain":
            continue
        spread = r0["gp"][f"plain_{MULTI_GP_SHORT_ROUNDS}"]["grad_error"]
        tol = max(MULTI_GP_SHORT_TOL, MULTI_GP_ORDER_FACTOR * spread) \
            if int(rounds) == MULTI_GP_SHORT_ROUNDS else TRAIN_GRAD_TOL
        emit(phase="multi_" + mode, rounds=int(rounds), shards=MULTI_RANKS,
             transport=sorted(transports), loss=g["loss"],
             single_device_loss=g["ref_loss"], grad_error=g["grad_error"],
             tolerance=tol,
             single_device_order_spread_4_rounds=spread,
             head_order="pinned to the single-device run",
             step_wall_s=[r["gp"][key]["wall_s"] for r in res],
             launches=[r["gp"][key]["launches"] for r in res])
        if g["grad_error"] > tol or abs(g["loss"] - g["ref_loss"]) > \
                TRAIN_LOSS_RTOL * abs(g["ref_loss"]):
            failed.append(f"{key}: the sharded step is not the single-"
                          f"device step: {g}")
        n_launch = LAUNCHES_PER_TRAIN_STEP * int(rounds) // 32
        for r in res:
            got = r["gp"][key]["launches"]
            want = {"lit_to_clause": n_launch, "clause_to_lit": n_launch}
            if mode == "halo":
                # 2 exchanges a round forward, their backwards, and the
                # backward of the state's balancing from the second round
                # on (parallel/halo.HaloView.balance_copies)
                n_halo = n_launch + int(rounds) - 1
                want.update(halo_send=n_halo, halo_recv=n_halo)
            if {d: got.get(d, 0) for d in want} != want:
                failed.append(f"{key} launches on rank {r['rank']}: "
                              f"{got}, reckoned {want}")
    if failed:
        raise RuntimeError("; ".join(failed))
    emit(phase="multi_exchange", halo_rows=r0["halo_rows"],
         literal_rows=r0["literal_rows"], bytes_per_round=bytes_round,
         width=QuerySATConfig.from_meta(meta["config"]).query_maps,
         exchange_ms={k: [r["exchange_ms"][k] for r in res]
                      for k in r0["exchange_ms"]},
         transport=sorted(transports))

    # the sharded chain
    c = r0["chain"]
    emit(phase="multi_chain", ranks=MULTI_RANKS,
         diffusion_steps=MULTI_CHAIN_STEPS, rounds=32,
         graphs_per_rank=spec["chain_graphs"], **c)
    if not c["bitwise_equal"]:
        raise RuntimeError("the sharded chain differs from the ranks' "
                           "chains run alone")
    if c["unsat"] or c["counted"] < 1:
        raise RuntimeError(f"multi_chain: {c['unsat']} of {c['counted']} "
                           "counted samples unsat")

    # the kernel on the per-shard plans and the halo's plans
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    local = graph_partition.local_batch(
        graph_partition.build_local_batches(gp_batch, MULTI_RANKS), 0)
    shard_plans = segsum.build_batch_plans(local).to(dev)
    view = halo.build_halo_plan(gp_batch, MULTI_RANKS).view(0).to(dev)
    rows = []
    for plan, launches_of in (
            (shard_plans.lit_to_clause, "gp_32"),
            (shard_plans.clause_to_lit, "gp_32"),
            (view.send, "halo_32"), (view.recv, "halo_32")):
        row, shape = tools["kernel_row"](plan, 128, gen)
        emit(phase="multi_kernel_vs_plain",
             batch="labelled_threshold3sat_20k/4",
             direction=plan.name, **shape, **row)
        rows.append(dict(
            name=f"gather_segsum:{plan.name}@shard", route="cuda",
            source=KERNEL_SOURCE, replaces=REPLACES,
            launches=r0["gp"][launches_of]["launches"].get(plan.name, 0),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shapes=f"labelled threshold 20k shard 0 of {MULTI_RANKS}, "
                   "F=128",
            launches_run=f"rank 0, one {launches_of.split('_')[0]} "
                         "step of 32 rounds"))
    emit(phase="multi_time", setup_s=setup_s, ranks_s=ranks_s,
         seconds=time.perf_counter() - t_phase)
    return rows


def lowp_phase(dev, tools: dict) -> list[dict]:
    """Phase 14: the f32-accumulating products of the dense block-bf16
    train step at the dense cell's block shapes (LOWP_BLOCKS), at full
    width: every MLP layer's forward (`lowp.linear_f32acc`: a bf16
    tensor-core GEMM with an f32 result), its activation and weight
    gradients (`split_mm`, f32 cotangent with the bf16 operand), and both
    incidence products with the features' gradient: the route and its
    plain versions (the upcast f32 product; for the split kernel also
    `split_mm_plain`) each within LOWP_ROUNDING_UNITS of the exact
    product, the route launched twice and equal bit for bit; for each
    split product the same product with the f32 operand rounded to bf16,
    and where the reduction is sliced with the slices' partials rounded to
    bf16, each beyond it. At LOWP_TIMED_BLOCK each is timed (device ms of
    its main-path call) beside its bound (the operands read once and the
    output written once at 3.35 TB/s, or its bf16 multiply-adds, three
    times over for the split, at 989 TFLOP/s), the plain version's time
    and the upcast f32 library route (`library_ms`: both operands cast to
    f32, an f32 GEMM, the cast of the result), and the round's split
    products are profiled for each of the two kernels' device time. Then
    what the card's routes do not take raises, and a graphed block-bf16
    chunk of GRAPHS_MEGA_STEPS full-width train steps on 20 000-node
    batches (the `--mega_steps` path that the dense cell times) counts,
    from zero, the products by route and the kernels' launches of one
    replay. Returns the two kernels' rows of the `kernels` line."""
    import numpy as np
    import torch

    from diffusionsat_torch import tracing
    from diffusionsat_torch.data.bench_workloads import threshold_3sat_batch
    from diffusionsat_torch.graph.dense_batch import densify_batches
    from diffusionsat_torch.models.query_sat import (
        QuerySATConfig,
        query_sat_init,
    )
    from diffusionsat_torch.models.query_sat_dense import (
        query_sat_dense_apply,
    )
    from diffusionsat_torch.ops import dense_ops, lowp, split_mm
    from diffusionsat_torch.train.adabelief import adabelief
    from diffusionsat_torch.train.loop import (
        TrainState,
        make_scanned_train_step_for,
        stack_batches,
    )

    sync, device_ms = tools["sync"], tools["device_ms"]
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = QuerySATConfig(block_bf16=True)

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def bound(a, b):
        return LOWP_ROUNDING_UNITS * 2.0 ** -24 * (a.double().abs() @
                                                   b.double().abs())

    def share(got, exact, a, b):
        """The largest share of the bound that `got` lies from the exact
        product (float64: exact for these operands' products, and far
        closer than the bound in its sums)."""
        err = (got.double() - exact).abs()
        return float((err / bound(a, b).clamp_min(1e-300)).max())

    def held(name, got, exact, a, b):
        s = share(got, exact, a, b)
        if not s <= 1:
            raise RuntimeError(f"lowp {name}: {s} of the bound")
        return s

    def missed(name, got, exact, a, b):
        """A product rounded below f32 has to lie beyond the bound."""
        s = share(got, exact, a, b)
        if not s > 1:
            raise RuntimeError(f"lowp {name}: a rounding below f32 lies "
                               f"within the bound ({s})")
        return s

    def sliced_bf16(a, b):
        """`a @ b` with each of the kernel's reduction slices summed
        exactly and rounded to bf16, then the slices summed exactly."""
        a3, b3 = (a[None], b[None]) if a.dim() == 2 else (a, b)
        wide = 0 if a3.dtype == f32 else 1
        m, n = (a3.shape[1], b3.shape[2])
        if wide == 1:
            m, n = n, m
        p = split_mm.plan(a3.shape[0], m, n, a3.shape[2])
        ks = p["k_slice"]
        out = sum((a3[..., i:i + ks].double() @ b3[..., i:i + ks, :]
                   .double()).to(bf16).double()
                  for i in range(0, a3.shape[2], ks))
        return out[0] if a.dim() == 2 else out, p["slices"]

    timed_split = []

    def product(name, block, a, b, split, timed):
        """One product through its card route, held to its plain versions;
        timed where asked."""
        if split:
            def route(dtype=bf16):
                return split_mm.split_mm(a, b, dtype)
        elif a.dim() == 2:
            def route(dtype=f32):
                return lowp.linear_f32acc(a, b)
        else:
            def route(dtype=f32):
                return lowp.bmm_f32acc(a, b)
        got = route(f32)
        again = route(f32)
        exact = a.double() @ b.double()
        sync()
        if not torch.equal(got, again):
            raise RuntimeError(f"lowp {name}: two launches differ")
        # the route and its plain versions, each within the bound of the
        # exact product
        row = dict(product=name, block=block, shape=[list(a.shape),
                                                     list(b.shape)],
                   route="split" if split else "tensor_core",
                   bound_share=held(name, got, exact, a, b),
                   bound_share_upcast=held(f"{name} (upcast)",
                                           a.float() @ b.float(), exact, a,
                                           b))
        if split:
            row["bound_share_plain"] = held(
                f"{name} (plain)", split_mm.split_mm_plain(a, b), exact, a,
                b)
            wide_a = a.dtype == f32
            rounded = (a.to(bf16).double() @ b.double() if wide_a else
                       a.double() @ b.to(bf16).double())
            row["bound_share_bf16_operand"] = missed(
                f"{name} (f32 operand in bf16)", rounded, exact, a, b)
            partials, slices = sliced_bf16(a, b)
            row["slices"] = slices
            if slices > 1:
                row["bound_share_bf16_partials"] = missed(
                    f"{name} (partials in bf16)", partials, exact, a, b)
        if timed:
            out_bytes = got.numel() * (2 if split else 4)
            nbytes = a.numel() * a.element_size() + \
                b.numel() * b.element_size() + out_bytes
            macs = a.numel() * b.shape[-1]
            ops = 2 * macs * (3 if split else 1)
            out_dtype = bf16 if split else f32
            row.update(
                ms=device_ms(route),
                plain_ms=(device_ms(lambda: split_mm.split_mm_plain(
                    a, b, bf16)) if split else None),
                library_ms=device_ms(
                    lambda: (a.float() @ b.float()).to(out_dtype)),
                bound_ms=max(nbytes / H100_BYTES_PER_S, ops / 989e12) * 1e3,
                bound_by=("bytes" if nbytes / H100_BYTES_PER_S >=
                          ops / 989e12 else "operations"))
            row["roofline_share"] = row["bound_ms"] / row["ms"]
            if split:
                timed_split.append((route, row))
        emit(phase="lowp", **row)

    for block in LOWP_BLOCKS:
        G, Vg, Cg = block
        timed = block == LOWP_TIMED_BLOCK
        rows = {"vars": G * Vg, "clauses": G * Cg}
        for mlp, (mcfg, in_dim) in cfg.mlp_configs().items():
            r = rows["clauses" if mlp == "clause_mlp" else "vars"]
            dims = [in_dim] + [mcfg.hidden] * (mcfg.layer_count - 1) + \
                [mcfg.out]
            for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
                x = randn(r, k, dtype=bf16)
                w = (randn(k, n) / k ** 0.5).to(bf16)
                g = randn(r, n)
                tag = f"{mlp}.{i}"
                product(f"{tag}.forward", block, x, w, False, timed)
                product(f"{tag}.gx", block, g, w.t(), True, timed)
                product(f"{tag}.gw", block, x.t(), g, True, timed)
        inc = (torch.rand((G, Cg, 2 * Vg), generator=gen, device=dev) <
               3.0 / (2 * Vg)).to(bf16)
        lits = randn(G, 2 * Vg, cfg.query_maps, dtype=bf16)
        clauses = randn(G, Cg, cfg.query_maps, dtype=bf16)
        g_clauses = randn(G, Cg, cfg.query_maps)
        g_lits = randn(G, 2 * Vg, cfg.query_maps)
        product("lit_to_clause.forward", block, inc, lits, False, timed)
        product("lit_to_clause.gb", block, inc.transpose(1, 2), g_clauses,
                True, timed)
        product("clause_to_lit.forward", block, inc.transpose(1, 2),
                clauses, False, timed)
        product("clause_to_lit.gb", block, inc, g_lits, True, timed)

    # the timed block's split products, profiled: each kernel's device time
    # for one round of them
    rounds = 5
    with tools["profile"](activities=tools["activities"]) as prof:
        for _ in range(rounds):
            for route, _ in timed_split:
                route()
        sync()
    by_kernel = {"split_mm_kernel": 0.0, "sum_slices_kernel": 0.0}
    for e in tools["cuda_kernels"](prof):
        for name in by_kernel:
            if name in e.key:
                by_kernel[name] += tools["dev_us"](e) / 1e3 / rounds
    sliced = [row for _, row in timed_split if row["slices"] > 1]
    sum_bytes = sum(row["slices"] * 4 * np.prod(row["shape"][0][:-1]) *
                    row["shape"][1][-1] * (1 + 0.5 / row["slices"])
                    for row in sliced)
    emit(phase="lowp_kernels", block=LOWP_TIMED_BLOCK, ms=by_kernel,
         products=len(timed_split), sliced=len(sliced))

    # what the card's routes do not take
    refused = {}
    bf = randn(8, 8, dtype=bf16)
    for name, call in (
            ("f32 operand forward", lambda: lowp.linear_f32acc(bf.float(),
                                                               bf)),
            ("f16 operand forward", lambda: lowp.bmm_f32acc(
                bf.half()[None], bf[None])),
            ("two bf16 operands split", lambda: split_mm.split_mm(bf, bf)),
            ("two f32 operands split", lambda: split_mm.split_mm(
                bf.float(), bf.float()))):
        try:
            call()
        except TypeError as e:
            refused[name] = str(e)[:80]
        else:
            raise RuntimeError(f"lowp: {name} ran on the card")
    emit(phase="lowp_refused", refused=refused)

    # one replay of a graphed block-bf16 chunk, the main path's run: its
    # products by route and the kernels' launches, counted from zero
    rng = np.random.default_rng(0)
    chunk = stack_batches(densify_batches(
        [threshold_3sat_batch(rng, 20000)[0]
         for _ in range(GRAPHS_MEGA_STEPS)])).to(dev)
    params = query_sat_init(gen, cfg)
    opt = adabelief(learning_rate=1e-3)
    state = TrainState(params=params, opt_state=opt.init(params), step=0,
                       generator=gen)
    with dense_ops.incidence_precision("default"):
        mega = make_scanned_train_step_for(query_sat_dense_apply, cfg, opt,
                                           dev)
        state, _ = mega(state, chunk)   # warm-up and capture
        sync()
        for fam in (lowp.ROUTES, split_mm.LAUNCHES):
            for key in fam:
                fam[key] = 0
        state, out = mega(state, chunk)
        sync()
    routes, launches = dict(lowp.ROUTES), dict(split_mm.LAUNCHES)
    if routes.get("plain") or not routes.get("split") or \
            not routes.get("tensor_core"):
        raise RuntimeError(f"lowp: a graphed chunk took the routes {routes}")
    emit(phase="lowp_graphed_chunk", steps=GRAPHS_MEGA_STEPS,
         block=(chunk.G, chunk.Vg, chunk.Cg), routes=routes,
         launches=launches, loss=out["loss_per_step"].tolist())

    def total(key):
        return sum(row[key] for _, row in timed_split)

    common = dict(route="cuda", source="diffusionsat_torch/csrc/split_mm.cu",
                  replaces=None, shapes=f"one round's {len(timed_split)} "
                  f"split products at the block {LOWP_TIMED_BLOCK}",
                  launches_graphed_chunk_steps=GRAPHS_MEGA_STEPS)
    return [dict(name="split_mm_kernel", ms=by_kernel["split_mm_kernel"],
                 plain_ms=total("plain_ms"), library_ms=total("library_ms"),
                 bound_ms=total("bound_ms"), launches=launches["product"],
                 **common),
            dict(name="sum_slices_kernel", ms=by_kernel["sum_slices_kernel"],
                 plain_ms=None, library_ms=None,
                 bound_ms=sum_bytes / H100_BYTES_PER_S * 1e3,
                 launches=launches["sum"], sliced_products=len(sliced),
                 **common)]


def grad_gate_study(dev) -> dict:
    """`--grad-gate-study`: phase 11's 4-round gradient check read on
    GATE_STUDY_BATCHES 20 000-node batches x GATE_STUDY_SEEDS params and
    noise seeds for each model, sound and with each fault of
    GATE_STUDY_FAULTS planted in the planned sums' backward. Each case
    prints two gates' readings:

    - against float64: the distance (`grads_err`) from the unplanned
      path's float64 gradients of the kernel path, of the unplanned f32
      path (blocked segment sums, as the card runs it by default) and of
      that path in the plans' order (`sequential_segment_sums`), with the
      ratio kernel (or fault) over unplanned;
    - order-matched, the gate phase 11 applies: the kernel path (or the
      fault) against the unplanned path, both with every segment sum in
      row order.

    Returns the largest sound reading and, per fault, the smallest of
    each gate."""
    import numpy as np

    from diffusionsat_torch.config import parse_config
    from diffusionsat_torch.data.bench_workloads import threshold_3sat_batch
    from diffusionsat_torch.ops import segsum

    cfg = parse_config(["--task", "3-sat"])
    short = OTHER_MODELS_SHORT_ROUNDS
    ratios, ordered = [], []
    fault_ratios = {f: [] for f in GATE_STUDY_FAULTS}
    fault_ordered = {f: [] for f in GATE_STUDY_FAULTS}
    for b in range(GATE_STUDY_BATCHES):
        batch, _ = threshold_3sat_batch(np.random.default_rng(b), 20000)
        plans = segsum.build_batch_plans(batch, edges=True).to(dev)
        batch = batch.to(dev)
        for name in OTHER_MODELS:
            for seed in range(GATE_STUDY_SEEDS):
                m = other_model(name, cfg, batch, dev, params_seed=seed,
                                noise_seed=seed + 1)
                g64 = m.train_step_f64(short)

                def dist(grads):
                    return grads_err([g.double() for g in grads], g64)

                kernel = m.train_step(plans, short)[1]
                unplanned = m.train_step(None, short)[1]
                with sequential_segment_sums():
                    kernel_o = m.train_step(plans, short)[1]
                    unplanned_o = m.train_step(None, short)[1]
                f64_faults, ordered_faults = {}, {}
                for f in GATE_STUDY_FAULTS:
                    with planted_fault(f):
                        f64_faults[f] = dist(m.train_step(plans, short)[1])
                        with sequential_segment_sums():
                            ordered_faults[f] = grads_err(
                                m.train_step(plans, short)[1], unplanned_o)
                base = dist(unplanned)
                ratio = dist(kernel) / base
                ratios.append(ratio)
                ordered.append(grads_err(kernel_o, unplanned_o))
                for f in GATE_STUDY_FAULTS:
                    fault_ratios[f].append(f64_faults[f] / base)
                    fault_ordered[f].append(ordered_faults[f])
                emit(phase="grad_gate_case", batch=b, model=name, seed=seed,
                     kernel=dist(kernel), unplanned=base,
                     unplanned_in_plan_order=dist(unplanned_o),
                     ratio=ratio, faults=f64_faults,
                     fault_ratios={f: d / base
                                   for f, d in f64_faults.items()},
                     ordered=ordered[-1], faults_ordered=ordered_faults)
    out = dict(cases=len(ratios), largest_sound_ratio=max(ratios),
               sound_ratios=sorted(ratios),
               smallest_fault_ratio={f: min(r)
                                     for f, r in fault_ratios.items()},
               largest_sound_ordered=max(ordered),
               smallest_fault_ordered={f: min(r)
                                       for f, r in fault_ordered.items()},
               ordered_tol=OTHER_MODELS_ORDERED_GRAD_TOL)
    emit(phase="grad_gate_study", **out)
    return out


EDGE_DIRECTIONS = ("edge_to_lit", "lit_to_edge")


def models_kernel_rows(models: dict) -> list[dict]:
    """The kernels line's rows of phase 11: each direction at the 20k
    batch's shapes, F = 128, with its launches summed over the models'
    `main` runs."""
    return [dict(name=f"gather_segsum:{d}", route="cuda",
                 source=KERNEL_SOURCE, replaces=REPLACES,
                 launches=models["launches_main"].get(d, 0),
                 max_abs_err=r["max_abs_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"],
                 shapes="threshold3sat_20k, F=128",
                 launches_by_model={m: n.get(d, 0) for m, n in
                                    models["launches_by_model"].items()})
            for d, r in models["rows"].items()]


def main(argv: list[str]) -> int:
    import torch

    if len(argv) == 2 and argv[0] == "--make-splits":
        sys.path.insert(0, str(ROOT))
        return make_splits(Path(argv[1]))
    baseline = None
    if "--baseline-kernel" in argv:
        at = argv.index("--baseline-kernel")
        if at + 1 >= len(argv):
            print("chip_smoke: --baseline-kernel needs a path",
                  file=sys.stderr)
            return 2
        baseline = Path(argv[at + 1]).resolve()
        argv = argv[:at] + argv[at + 2:]
    if argv not in ([], ["--only-anf"], ["--only-graphs"], ["--only-main"],
                    ["--only-models"], ["--only-studies"], ["--only-multi"],
                    ["--only-lowp"], ["--grad-gate-study"]):
        print("usage: chip_smoke.py [--only-anf | --only-graphs | "
              "--only-main | --only-models | --only-studies | "
              "--only-multi | --only-lowp | --grad-gate-study] "
              "[--baseline-kernel PATH]", file=sys.stderr)
        return 2

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "diffusionsat_torch").is_dir() or not CKPT.exists():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    # the full run makes its splits ahead, beside the card's work
    splits = Splits(ROOT / "data_cache", ahead=not argv)
    try:
        return run(argv, splits, baseline)
    finally:
        splits.close()


def run(argv: list[str], splits: Splits, baseline: Path | None = None
        ) -> int:
    """The phases that `argv` asks for (all of them without arguments);
    `baseline`, a version of the kernel's source timed beside it."""
    import numpy as np
    import torch

    only_anf = argv == ["--only-anf"]
    only_graphs = argv == ["--only-graphs"]
    only_main = argv == ["--only-main"]
    only_models = argv == ["--only-models"]

    from diffusionsat_torch import diffusion_training, solve_eval
    from diffusionsat_torch.data.bench_workloads import threshold_3sat_batch
    from diffusionsat_torch.data.datasets import PackedBatches
    from diffusionsat_torch.device import resolve_device
    from diffusionsat_torch.diffusion.sampler import DiffusionSampler
    from diffusionsat_torch.diffusion.schedule import (
        construct_training_input,
    )
    from diffusionsat_torch.graph.dense_batch import (
        DenseSatBatch,
        densify_batches_quantized,
    )
    from diffusionsat_torch.losses.sat import is_graph_sat
    from diffusionsat_torch.models import query_sat as query_sat_module
    from diffusionsat_torch.models.query_sat import (
        QuerySATConfig,
        query_sat_apply,
        query_sat_init,
    )
    from diffusionsat_torch.models.query_sat_dense import (
        query_sat_dense_apply,
    )
    from diffusionsat_torch.ops import dense_ops, segsum
    from diffusionsat_torch.sat.native.build import build as build_solver
    from diffusionsat_torch.sat.cnf import CNF, VariableAssignment
    from diffusionsat_torch.train.adabelief import (
        adabelief,
        cosine_decay_schedule,
    )
    from diffusionsat_torch.train.checkpoint import (
        load_params,
        params_from_numpy,
    )
    from diffusionsat_torch.train.loop import (
        TrainState,
        make_planned_train_step,
        make_selfsupervised_train_step,
        make_train_step_for,
        plan_batches,
    )
    from diffusionsat_torch.uniformity_benchmark import (
        gen_benchmark_formulas,
    )

    dev = resolve_device("cuda")  # also switches TF32 off
    sync = torch.cuda.synchronize

    def device_ms(fn, iters=20, reps=5):
        """Mean device ms per call: `iters` calls captured in one CUDA graph
        and replayed, so host launch cost drops out."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection while capturing: a collected graph of an
        # earlier call (an exception's frames keep one alive) destroyed in
        # the middle of this capture would invalidate it
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                for _ in range(iters):
                    fn()
        finally:
            gc.enable()
        graph.replay()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (iters * reps)

    def event_ms(fn, iters=20, reps=5):
        """Mean ms per call from CUDA events around back-to-back calls,
        launch cost included: for a library call that a graph cannot
        capture."""
        for _ in range(3):
            fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters * reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (iters * reps)

    def library_times(fn):
        """`library_ms` of one library call, from a graph where the call
        can be captured, else from events (`library_timing` says which)."""
        try:
            return dict(library_ms=device_ms(fn), library_timing="graph")
        except RuntimeError as e:
            sync()
            return dict(library_ms=event_ms(fn), library_timing="events",
                        library_capture_error=str(e)[:200])

    floor = {}

    def launch_floor_ms():
        """The device time of one launch of a one-element kernel, from 100
        replayed in a CUDA graph: what a launch costs whatever it does
        (read once a run)."""
        if "ms" not in floor:
            one = torch.zeros(1, device=dev)
            floor["ms"] = device_ms(lambda: one.add_(1.0), iters=100)
        return floor["ms"]

    baseline_lib = None
    if baseline is not None:
        baseline_lib = segsum.build_library(baseline)
        emit(phase="baseline_build", source=str(baseline),
             nvcc_seconds=baseline_lib.build_seconds,
             ptxas=ptxas_lines(baseline_lib.build_log))

    def baseline_segsum(x, plan):
        """`gather_segsum` through the baseline library (not counted)."""
        out = torch.empty((plan.num_segments, x.shape[1]), device=dev)
        rc = baseline_lib.lib.dsat_gather_segsum(
            x.data_ptr(), x.stride(0), plan.row_ptr.data_ptr(),
            plan.gather.data_ptr(), out.data_ptr(), plan.num_segments,
            x.shape[1], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline kernel launch failed ({rc})")
        return out

    def kernel_row(plan, F, gen):
        """The kernel against its plain version on `plan` at width F, on a
        random input: the max-abs error (which must be 0), the device
        times of the kernel, the plain version and the library calls for
        the same function, beside the bound and the launch floor; with a
        baseline kernel, its times in turns with the kernel's. Returns
        (row, shape)."""
        x = torch.randn((plan.num_sources, F), generator=gen, device=dev)
        got = segsum.gather_segsum(x, plan)
        want = segsum.segsum_plain(x, plan)
        sync()
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        err = (got - want).abs().max().item()
        if not torch.equal(got, want):
            raise RuntimeError(f"{plan.name} at F = {F}: the kernel differs "
                               f"from its plain version by {err}; both sum "
                               "in plan order and must agree bit for bit")
        # the real edges (a padded plan's tail is never read) and the
        # distinct rows of x they gather
        M, E = plan.num_segments, int(plan.row_ptr[-1])
        N = int(torch.unique(plan.gather[:E]).numel())
        lengths = plan.row_ptr.diff()
        seg = torch.repeat_interleave(
            torch.arange(M, device=dev, dtype=torch.int32), lengths,
            output_size=E)
        acc = torch.zeros((M, F), device=dev)

        def library_call():
            # the same function from library calls: the gather, then one
            # index_add_ into the segments
            acc.zero_().index_add_(0, seg, x.index_select(0, plan.gather))

        # the same function as one library call: the plan as a CSR matrix
        # of ones, times x (cuSPARSE's SpMM)
        csr = torch.sparse_csr_tensor(
            plan.row_ptr.long(), plan.gather[:E].long(),
            torch.ones(E, device=dev), size=(M, plan.num_sources))
        sparse = torch.sparse.mm(csr, x)
        torch.testing.assert_close(sparse, want, **KERNEL_TOL)

        # each input read once (the N rows of x the plan gathers, row_ptr,
        # the E gather entries), the output written once; E * F additions
        nbytes = N * F * 4 + M * F * 4 + E * 4 + (M + 1) * 4
        ops = E * F
        bound_s = max(nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S)

        def kernel():
            return segsum.gather_segsum(x, plan)

        if baseline_lib is None:
            timed = dict(ms=device_ms(kernel))
        else:
            base_out = baseline_segsum(x, plan)
            sync()
            base = [device_ms(lambda: baseline_segsum(x, plan))]
            ms = [device_ms(kernel), device_ms(kernel)]
            base.append(device_ms(lambda: baseline_segsum(x, plan)))
            timed = dict(ms=sum(ms) / 2, ms_readings=ms,
                         baseline_ms=sum(base) / 2,
                         baseline_readings=base,
                         baseline_max_abs_err=(base_out - want).abs().max()
                         .item())
        floor_ms = launch_floor_ms()
        row = dict(
            **timed,
            plain_ms=device_ms(lambda: segsum.segsum_plain(x, plan)),
            **library_times(lambda: torch.sparse.mm(csr, x)),
            library_index_ms=device_ms(library_call),
            bound_ms=bound_s * 1e3,
            bound_by=("bytes" if nbytes / H100_BYTES_PER_S >=
                      ops / H100_F32_OPS_PER_S else "operations"),
            launch_floor_ms=floor_ms,
            floor_share=max(bound_s * 1e3, floor_ms) / timed["ms"],
            max_abs_err=err)
        return row, dict(segments=M, edges=E, sources=plan.num_sources,
                         rows_read=N, F=F, bytes=nbytes,
                         max_segment=int(lengths.max()) if M else 0,
                         mean_segment=E / max(M, 1))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: every reading below is of CUDA kernels, and
    # recording the host side of a step's 13-18 thousand small ops costs
    # seconds a profile
    activities = [ProfilerActivity.CUDA]

    def dev_us(e):
        return e.self_device_time_total

    def cuda_kernels(prof):
        """The device's kernels (and copies) of a profile, their time summed
        by name as `key_averages` sums it, read from the profiler's raw
        events: `key_averages` first builds the host's event tree, tens of
        seconds for the 10^5 kernels of a profiled chain or mega-step."""
        totals: dict[str, KernelTotal] = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
                continue
            total = totals.setdefault(e.name(), KernelTotal(e.name()))
            total.count += 1
            total.self_device_time_total += e.duration_ns() / 1e3
        return list(totals.values())

    def segsum_us(kernels):
        return sum(dev_us(e) for e in kernels if "gather_segsum" in e.key)

    def busy_seconds(fn):
        with profile(activities=activities) as prof:
            fn()
        return sum(dev_us(e) for e in cuda_kernels(prof)) / 1e6

    if argv == ["--only-lowp"]:
        print(json.dumps({"kernels": lowp_phase(dev, dict(
            sync=sync, device_ms=device_ms, profile=profile,
            activities=activities, cuda_kernels=cuda_kernels,
            dev_us=dev_us))}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # -- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    lib = segsum.build_library()
    emit(phase="build", seconds=time.perf_counter() - t0,
         nvcc_seconds=lib.build_seconds, library=lib.path.name,
         ptxas=ptxas_lines(lib.build_log))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    solver_lib = build_solver()
    emit(phase="native_build", seconds=time.perf_counter() - t0,
         library=solver_lib.name)
    data_dir = ROOT / "data_cache"
    tools = dict(sync=sync, device_ms=device_ms, kernel_row=kernel_row,
                 splits=splits,
                 profile=profile, activities=activities,
                 cuda_kernels=cuda_kernels, dev_us=dev_us)
    if only_graphs:
        graphs_phase(dev, data_dir, tools)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if only_anf:
        anf = anf_phase(dev, data_dir, tools)
        print(json.dumps({"kernels": anf["kernels"]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if argv == ["--grad-gate-study"]:
        grad_gate_study(dev)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if argv == ["--only-multi"]:
        rows = multi_phase(dev, data_dir, tools)
        print(json.dumps({"kernels": rows}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if argv == ["--only-studies"]:
        studies = studies_phase(dev, data_dir, tools)
        print(json.dumps({"kernels": studies["rows"]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if only_models:
        models = models_phase(dev, data_dir, tools)
        print(json.dumps({"kernels": models_kernel_rows(models)}),
              flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # the eval's test split, generated here by the native solver unless an
    # earlier run left it in the cache directory
    eval_batches, timing = splits.get("eval")
    emit(phase="eval_split", **timing, batches=len(eval_batches),
         instances=sum(int(b.n_graphs) for b in eval_batches))
    if only_main:
        generic = main_phase(dev, data_dir, tools, eval_batches)
        print(json.dumps({"kernels": [dict(
            name=f"gather_segsum:{d}", route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES, launches=generic["launches_main"][d],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shapes="main_train_batch_0, F=128",
            launches_main_restore=generic["launches_main_restore"][d],
            launches_harness=generic["launches_harness"][d])
            for d, r in generic["rows"].items()]}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # the flagship's params and the 20 000-node batch, flat with its plans
    # and re-blocked, shared by the phases below
    tree, meta = load_params(CKPT)
    params = params_from_numpy(tree, dev)
    big_batch, _ = threshold_3sat_batch(np.random.default_rng(0), 20000)
    big_plans = segsum.build_batch_plans(big_batch).to(dev)
    big_dense = densify_batches_quantized([big_batch])[0].to(dev)
    big_offsets = np.concatenate([[0], np.cumsum(
        big_batch.n_vars_per_graph.numpy().astype(np.int64)[
            :int(big_batch.n_graphs)])])
    big_batch = big_batch.to(dev)

    # -- phase 2: kernel vs plain at the main path's shapes ----------------
    cfg32 = QuerySATConfig.from_meta(meta["config"], test_rounds=32)
    primes_sampler = DiffusionSampler(params, cfg32, CNF.load(PRIMES),
                                      diffusion_steps=32, test_rounds=32,
                                      dense=False, seed=1, device=dev)
    eval_plans = segsum.build_batch_plans(eval_batches[0]).to(dev)
    # the flat uniformity battery's batch: p24 formula 0, 125 copies
    (p24_vars, p24_clauses, _), = gen_benchmark_formulas(1)
    p24_sampler = DiffusionSampler(
        params, cfg32, CNF(n_vars=p24_vars, clauses=p24_clauses),
        diffusion_steps=32, test_rounds=32, dense=False, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    F = cfg32.query_maps
    kernel_rows = {}
    for batch_name, batch, plans in (
            ("primes_3599_x15", primes_sampler.batch, primes_sampler.plans),
            ("threshold3sat_20k", big_batch, big_plans),
            ("eval_split_batch_0", eval_batches[0].to(dev), eval_plans),
            ("p24_formula_0_x125", p24_sampler.batch, p24_sampler.plans)):
        for plan in (plans.lit_to_clause, plans.clause_to_lit):
            row, shape = kernel_row(plan, F, gen)
            emit(phase="kernel_vs_plain", batch=batch_name,
                 direction=plan.name, **shape, **row)
            kernel_rows.setdefault(batch_name, {})[plan.name] = row

    # -- phase 3: the model at full width on the 20k-node batch -----------
    rng = np.random.default_rng(1)
    V = big_batch.V
    labels = torch.from_numpy(rng.integers(0, 2, V).astype(np.int32))
    noisy = torch.nn.functional.one_hot(
        torch.from_numpy(rng.integers(0, 2, V)), 2).to(torch.float32)
    cfg_det = QuerySATConfig.from_meta(meta["config"], debug_zero_noise=True)
    common = dict(labels=labels.to(dev), noise_scale=1.0,
                  noisy_num=noisy.to(dev), device=dev)
    query_sat_apply(params, cfg_det, big_batch, rounds=2, plans=big_plans,
                    **common)  # warm-up
    outs = {}
    for path, plans in (("kernel", big_plans), ("plain", None)):
        out, loss, steps, aux = query_sat_apply(
            params, cfg_det, big_batch, rounds=4, plans=plans, **common)
        outs[path] = (out, loss, steps, aux["logits_all_heads"])
    sync()
    (ok_, lk, sk, hk), (op_, lp, sp, hp) = outs["kernel"], outs["plain"]
    torch.testing.assert_close(hk, hp, **MODEL_TOL)
    torch.testing.assert_close(ok_, op_, **MODEL_TOL)
    if int(sk) != int(sp):
        raise RuntimeError(f"steps differ: kernel {int(sk)} plain {int(sp)}")
    emit(phase="model_4_rounds", vars=V, clauses=big_batch.C,
         graphs=int(big_batch.n_graphs),
         edges=big_plans.lit_to_clause.gather.shape[0],
         max_abs_err_logits=(hk - hp).abs().max().item(),
         loss_kernel=float(lk), loss_plain=float(lp), steps=int(sk))

    # the same 4 rounds on the dense model: the batch re-blocked per graph,
    # the same inputs carried through the per-graph variable offsets, and
    # the all-head logits carried back
    def to_dense(x_flat):
        out = torch.zeros((big_dense.G, big_dense.Vg) + x_flat.shape[1:],
                          dtype=x_flat.dtype, device=dev)
        for g in range(len(big_offsets) - 1):
            lo, hi = big_offsets[g], big_offsets[g + 1]
            out[g, :hi - lo] = x_flat[lo:hi]
        return out

    dense_common = dict(labels=to_dense(common["labels"]), noise_scale=1.0,
                        noisy_num=to_dense(common["noisy_num"]), device=dev)
    _, ld, sd, auxd = query_sat_dense_apply(params, cfg_det, big_dense,
                                            rounds=4, **dense_common)
    hd = torch.cat([auxd["logits_all_heads"][g, :big_offsets[g + 1] -
                                             big_offsets[g]]
                    for g in range(len(big_offsets) - 1)])
    n_real = int(big_offsets[-1])
    torch.testing.assert_close(hd, hk[:n_real], **MODEL_TOL)
    if int(sd) != int(sk):
        raise RuntimeError(f"steps differ: dense {int(sd)} flat {int(sk)}")
    emit(phase="dense_vs_flat", graphs=big_dense.G, Vg=big_dense.Vg,
         Cg=big_dense.Cg, rounds=4,
         max_abs_err_logits=(hd - hk[:n_real]).abs().max().item(),
         loss_dense=float(ld), loss_flat=float(lk), steps=int(sd))

    cfg = QuerySATConfig.from_meta(meta["config"])

    def run_rounds(batch, plans, rounds=64, early_exit=True, inputs=common):
        g = torch.Generator(device=dev)
        g.manual_seed(7)
        dense = isinstance(batch, DenseSatBatch)
        sync()
        t = time.perf_counter()
        if dense:
            out, _, steps, _ = query_sat_dense_apply(
                params, cfg, batch, g, rounds=rounds, early_exit=early_exit,
                **inputs)
        else:
            out, _, steps, _ = query_sat_apply(
                params, cfg, batch, g, rounds=rounds, early_exit=early_exit,
                plans=plans, **inputs)
        sync()
        wall = time.perf_counter() - t
        graph_sat = dense_ops.is_graph_sat if dense else is_graph_sat
        solved = graph_sat(out, batch)[:int(batch.n_graphs), 0]
        return wall, int(steps) + 1, solved.mean().item()

    res = {}
    for path, plans in (("kernel", big_plans), ("plain", None),
                        ("kernel", big_plans), ("plain", None)):
        res.setdefault(path, []).append(run_rounds(big_batch, plans))
    for path, runs in res.items():
        emit(phase="model_64_rounds", path=path,
             wall_s=[r[0] for r in runs], rounds=runs[-1][1],
             solved_fraction=runs[-1][2])
    gap = abs(res["kernel"][-1][2] - res["plain"][-1][2])
    if gap > SOLVED_FRACTION_TOL:
        raise RuntimeError(f"solved fraction differs by {gap}")

    # cost of reading the early-exit flag every round: the same rounds with
    # and without the per-round host sync, in turns, on the 20k batch and on
    # the sampler batch (which the flagship does not solve, so every run
    # takes all its rounds)
    pb = primes_sampler.batch
    primes_inputs = dict(
        labels=torch.zeros(pb.V, dtype=torch.int32, device=dev),
        noise_scale=1.0, noisy_num=torch.full((pb.V, 2), 0.5, device=dev),
        device=dev)
    for name, batch, plans, inputs, rounds in (
            ("threshold3sat_20k", big_batch, big_plans, common, 64),
            ("primes_3599_x15", pb, primes_sampler.plans, primes_inputs, 32)):
        walls = {"check_every_round": [], "no_check": []}
        taken = set()
        for _ in range(3):
            for mode, kw in (("check_every_round", {}),
                             ("no_check", {"early_exit": False})):
                wall, steps, _ = run_rounds(batch, plans, rounds,
                                            inputs=inputs, **kw)
                walls[mode].append(wall)
                taken.add(steps)
        med = {k: float(np.median(v)) for k, v in walls.items()}
        emit(phase="early_exit_sync", batch=name, rounds=rounds,
             rounds_taken=sorted(taken), wall_s=walls, median_wall_s=med,
             per_round_sync_ms=(med["check_every_round"] -
                                med["no_check"]) / rounds * 1e3)

    # where a round's time goes: device busy time and the top kernels over
    # 8 rounds on each batch (torch.profiler, CUDA kernel events), against
    # the wall time of the same 8 rounds without the profiler
    uf20_dense = DiffusionSampler(params, cfg32, CNF.load(UF20),
                                  diffusion_steps=32, test_rounds=32, seed=0,
                                  device=dev)
    if not uf20_dense.dense:
        raise RuntimeError("the sampler did not pick the dense chain for "
                           "uf20-synth-1")
    ub = uf20_dense.batch
    uf20_dense_inputs = dict(
        labels=torch.zeros((ub.G, ub.Vg), dtype=torch.int32, device=dev),
        noise_scale=1.0, noisy_num=torch.full((ub.G, ub.Vg, 2), 0.5,
                                              device=dev), device=dev)
    # the flagship solves the 256 uf20 copies within two rounds, so that
    # batch runs its 8 rounds without the early exit (rounds after solving
    # are masked, and launch the same kernels)
    for name, batch, plans, inputs, kw in (
            ("threshold3sat_20k", big_batch, big_plans, common, {}),
            ("primes_3599_x15", pb, primes_sampler.plans, primes_inputs, {}),
            ("threshold3sat_20k_dense", big_dense, None, dense_common, {}),
            ("uf20_x256_dense", ub, None, uf20_dense_inputs,
             {"early_exit": False})):
        runs = [run_rounds(batch, plans, 8, inputs=inputs, **kw)
                for _ in range(3)]
        wall = min(r[0] for r in runs)
        with profile(activities=activities) as prof:
            prof_wall, rounds_run, _ = run_rounds(batch, plans, 8,
                                                  inputs=inputs, **kw)
        if not kw and ({r[1] for r in runs} != {8} or rounds_run != 8):
            raise RuntimeError(f"profile of {name}: the early exit cut a "
                               "run short of 8 rounds")
        kernels = cuda_kernels(prof)
        busy_us = sum(dev_us(e) for e in kernels)
        top = sorted(kernels, key=dev_us, reverse=True)[:8]
        emit(phase="profile_8_rounds", batch=name, wall_ms=wall * 1e3,
             profiled_wall_ms=prof_wall * 1e3,
             device_busy_ms=busy_us / 1e3,
             device_busy_share=busy_us / 1e3 / (wall * 1e3),
             kernels_per_round=sum(e.count for e in kernels) / 8,
             segsum_busy_ms=segsum_us(kernels) / 1e3,
             top=[(e.key[:60], dev_us(e) / 1e3, e.count) for e in top])

    # -- phase 4: the solving eval, a main path ---------------------------
    eval_res = {}
    eval_launches = {}
    for layout in ("flat", "dense"):
        segsum.reset_launch_counts()
        res = solve_eval.main([
            "--model_ckpt", str(CKPT), "--layout", layout, "--device",
            str(dev), "--data_dir", str(data_dir)])
        launched = dict(segsum.LAUNCHES)
        if layout == "flat":
            eval_launches = launched
        emit(phase="solve_eval", layout=layout,
             total_accuracy=res["total_accuracy"], accuracy=res["accuracy"],
             mean_steps=res["mean_steps"], batches=res["n_test_batches"],
             wall_s=res["eval_seconds"], launches=launched)
        lo, hi = PASS_MARK_WINDOW
        if not lo <= res["total_accuracy"] <= hi:
            raise RuntimeError(
                f"solve_eval ({layout}): total_accuracy "
                f"{res['total_accuracy']} outside [{lo}, {hi}]")
        eval_res[layout] = res
    for direction, count in eval_launches.items():
        if count <= 0:
            raise RuntimeError(f"segsum kernel ({direction}) was not "
                               "launched on the flat solving eval")
    gap = abs(eval_res["flat"]["total_accuracy"] -
              eval_res["dense"]["total_accuracy"])
    if gap > LAYOUT_GAP_TOL:
        raise RuntimeError(f"flat and dense solved fractions differ by {gap}")

    # -- phase 5: the sampler, a main path --------------------------------
    uf20_sampler = DiffusionSampler(params, cfg32, CNF.load(UF20),
                                    diffusion_steps=32, test_rounds=32,
                                    dense=False, seed=0, device=dev)
    def run_sampler(name, sampler, n):
        sync()
        t = time.perf_counter()
        counts = sampler.samples(n, max_batches=2)
        sync()
        wall = time.perf_counter() - t
        for sol in counts:
            asgn = VariableAssignment(sampler.n_vars, sampler.clauses)
            asgn.assign_all_from_int(sol)
            if not asgn.satisfiable():
                raise RuntimeError(f"{name}: counted sample {sol} is UNSAT")
        n_sat = sum(counts.values())
        emit(phase="sampler_dense" if sampler.dense else "sampler",
             formula=name, vars=sampler.n_vars, clauses=len(sampler.clauses),
             graphs_per_batch=sampler.graphs_per_batch, wall_s=wall,
             sat_samples=n_sat, samples_per_s=n_sat / wall,
             distinct_solutions=len(counts),
             success_rate=sampler.success_rate)
        if name == "uf20-synth-1" and n_sat < 1:
            raise RuntimeError("no satisfying sample for uf20-synth-1")

    segsum.reset_launch_counts()
    run_sampler("uf20-synth-1", uf20_sampler, 100)
    run_sampler("primes_3599_61x59", primes_sampler, 15)
    launches = dict(segsum.LAUNCHES)
    # the sampler's own choice of layout for uf20: the dense chain, which
    # runs no segsum kernel
    run_sampler("uf20-synth-1", uf20_dense, 100)
    if dict(segsum.LAUNCHES) != launches:
        raise RuntimeError("the dense chain launched the segsum kernel")
    emit(phase="sampler_launches", **launches)
    for direction, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"segsum kernel ({direction}) was not "
                               "launched on the sampler path")

    # -- phase 6: training, a main path -----------------------------------
    launches_of = {}
    F = 128

    # -- the kernel's backward against autograd of the plain version --
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    for fwd_name, fn, plain_plan in (
            ("lit_to_clause", segsum.plan_lit_to_clause,
             big_plans.lit_to_clause),
            ("clause_to_lit", segsum.plan_clause_to_lit,
             big_plans.clause_to_lit)):
        bwd_name = ("clause_to_lit" if fwd_name == "lit_to_clause"
                    else "lit_to_clause")
        x0 = torch.randn((plain_plan.num_sources, F), generator=gen,
                         device=dev)
        w = torch.randn((F, plain_plan.num_segments), generator=gen,
                        device=dev)
        half = plain_plan.num_segments // 2
        cotangents = {
            "contiguous": lambda o: (o * w.t()).sum(),
            # column stride M: the wrapper makes it contiguous
            "transposed": lambda o: (o.t() * w).sum(),
            "expanded": lambda o: o.sum(),
            "sliced": lambda o: (o[:, :F // 2] ** 2).sum() -
            o[half:].sum() + (o[:half, F // 2:] * 3.0).sum(),
        }
        for cot_name, loss_of in cotangents.items():
            grads = {}
            for path in ("kernel", "plain"):
                x = x0.clone().requires_grad_(True)
                segsum.reset_launch_counts()
                out = fn(x, big_plans) if path == "kernel" else \
                    segsum.segsum_plain(x, plain_plan)
                loss_of(out).backward()
                grads[path] = x.grad
                if path == "kernel":
                    counted = dict(segsum.LAUNCHES)
            sync()
            torch.testing.assert_close(grads["kernel"], grads["plain"],
                                       **KERNEL_TOL)
            if counted != {fwd_name: 1, bwd_name: 1}:
                raise RuntimeError(
                    f"backward of {fwd_name}: launches {counted}")
            emit(phase="kernel_backward_vs_plain", forward=fwd_name,
                 backward=bwd_name, cotangent=cot_name, F=F,
                 rows=plain_plan.num_sources,
                 max_abs_err=(grads["kernel"] - grads["plain"]
                              ).abs().max().item(),
                 launches=counted)

    # -- the cut training set ---------------------------------------
    (train_batches, _), timing = splits.get("train")
    emit(phase="train_split", **timing,
         instances=sum(int(b.n_graphs) for b in train_batches),
         batches=len(train_batches), cut_from=100000,
         note="data quantity is cut, not width or depth")
    dense_train = [b.to(dev) for b in
                   densify_batches_quantized(train_batches)]
    flat_train = plan_batches(train_batches, dev)
    plans_of = {id(b): p for b, p in flat_train}

    # -- one training forward and backward, kernel against plain path --
    # The flagship's params on the first training batch, with the draws
    # of a training step pinned: the batch's own solutions as labels,
    # noise level 0.5, the noisy input drawn from the labels at that
    # level, and the per-round noise, over 4 and over 32 rounds. The loss
    # weights each graph's head losses by their rank, so where two heads
    # of a graph nearly tie, a last-bit difference of the sums swaps their
    # weights and moves the gradient by a step; the plain path, whose
    # atomics sum in no fixed order, does that to itself between two runs.
    # So the gate pins the rank order: a plain run sorts and keeps each
    # round's order, and the kernel run (and a second plain run, the
    # spread) weight the heads in that kept order. The kernel path must
    # lie within TRAIN_GRAD_TOL of the plain path so pinned; the errors
    # with each run sorting for itself are printed beside it.
    cfg_train = QuerySATConfig.from_meta(meta["config"])
    grad_batch, grad_plans = flat_train[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    V = grad_batch.V
    ns = torch.tensor(0.5, device=dev)
    draws = dict(
        labels=grad_batch.solutions, noise_scale=ns,
        noisy_num=construct_training_input(grad_batch.solutions, ns, gen),
        round_noise=torch.randn((cfg_train.train_rounds, V, 4),
                                generator=gen, device=dev))
    leaves = [p for m in params.values() for k in ("w", "b")
              for p in m[k]]

    def loss_and_grads(plans, rounds):
        for p in leaves:
            p.requires_grad_(True)
        segsum.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        _, loss, steps, _ = query_sat_apply(
            params, cfg_train, grad_batch, None, training=True,
            rounds=rounds, plans=plans, device=dev, **draws)
        sync()
        fwd_launches = dict(segsum.LAUNCHES)
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves)
        sync()
        t2 = time.perf_counter()
        for p in leaves:
            p.requires_grad_(False)
        return dict(
            loss=loss.item(), steps=int(steps), grads=grads,
            forward_launches=fwd_launches,
            backward_launches={d: segsum.LAUNCHES[d] - fwd_launches[d]
                               for d in fwd_launches},
            forward_s=t1 - t0, backward_s=t2 - t1)

    def grad_err(ra, rb):
        """Largest error of any tensor, as a share of that tensor's
        largest entry (floored at a hundredth of the largest of all)."""
        top = max(g.abs().max().item() for g in rb["grads"])
        return max((ga - gb).abs().max().item() /
                   max(gb.abs().max().item(), 1e-2 * top)
                   for ga, gb in zip(ra["grads"], rb["grads"])), top

    loss_and_grads(grad_plans, 2)        # warm-up
    loss_and_grads(None, 2)
    free, pinned, tops = {}, {}, {}
    for rounds in (4, cfg_train.train_rounds):
        rp = loss_and_grads(None, rounds)
        rk = loss_and_grads(grad_plans, rounds)
        free[rounds] = (grad_err(rk, rp)[0],
                        grad_err(loss_and_grads(None, rounds), rp)[0])
        order = PinnedHeadOrder()
        sorted_loss = query_sat_module._head_weighted_loss
        query_sat_module._head_weighted_loss = order
        try:
            order.record()
            ref = loss_and_grads(None, rounds)
            order.replay()
            pk = loss_and_grads(grad_plans, rounds)
            order.replay()
            pp = loss_and_grads(None, rounds)
        finally:
            query_sat_module._head_weighted_loss = sorted_loss
        err, tops[rounds] = grad_err(pk, ref)
        pinned[rounds] = (err, grad_err(pp, ref)[0])
        for a, b in ((rk, rp), (pk, ref), (pp, ref)):
            if abs(a["loss"] - b["loss"]) > TRAIN_LOSS_RTOL * abs(b["loss"]) \
                    or a["steps"] != b["steps"]:
                raise RuntimeError(f"{rounds}-round training loss differs "
                                   "between the kernel and the plain path")
        del ref, pk, pp, order
    per_step = {d: rk["forward_launches"][d] + rk["backward_launches"][d]
                for d in rk["forward_launches"]}
    emit(phase="train_grads_flat", rounds=cfg_train.train_rounds,
         tensors=len(leaves), loss_kernel=rk["loss"], loss_plain=rp["loss"],
         steps=rk["steps"], tolerance=TRAIN_GRAD_TOL,
         **{f"{kind}_{r}_rounds": dict(kernel_against_plain=v[0],
                                       plain_against_itself=v[1])
            for kind, errs in (("head_order_pinned", pinned),
                               ("head_order_free", free))
            for r, v in errs.items()},
         largest_gradient={r: t for r, t in tops.items()},
         forward_launches=rk["forward_launches"],
         backward_launches=rk["backward_launches"],
         launches_per_step=per_step,
         predicted_per_step=LAUNCHES_PER_TRAIN_STEP,
         plain_path_launches=rp["forward_launches"],
         forward_s={"kernel": rk["forward_s"], "plain": rp["forward_s"]},
         backward_s={"kernel": rk["backward_s"], "plain": rp["backward_s"]})
    for rounds, (err, _) in pinned.items():
        if err > TRAIN_GRAD_TOL:
            raise RuntimeError(
                f"{rounds}-round training gradients differ: {err}")
    # the plain path sums in one fixed order: it must equal itself
    for kind, errs in (("pinned", pinned), ("free", free)):
        for rounds, (_, spread) in errs.items():
            if spread != 0.0:
                raise RuntimeError(f"the plain path differs from itself "
                                   f"({kind}, {rounds} rounds): {spread}")
    if any(rp["forward_launches"].values()) or \
            any(rp["backward_launches"].values()):
        raise RuntimeError("the plain path launched the kernel")
    for d, n in per_step.items():
        if n != LAUNCHES_PER_TRAIN_STEP or \
                rk["forward_launches"][d] <= 0 or \
                rk["backward_launches"][d] <= 0:
            raise RuntimeError(f"train step launches ({d}): {n}")
    launches_of["per_step"] = per_step
    del rk, rp

    # -- optimizer steps from a seeded init --------------------------
    def fresh_state(cfg_model):
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        p0 = query_sat_init(g, cfg_model)
        opt = adabelief(learning_rate=cosine_decay_schedule(
            1e-3, 167_000, 0.5), eps=1e-8, clip_gradients=True)
        g2 = torch.Generator(device=dev)
        g2.manual_seed(1)
        return opt, TrainState(params=p0, opt_state=opt.init(p0),
                               step=0, generator=g2)

    def precision_of(block_bf16):
        # a block-bf16 run takes the training script's defaults: bf16
        # operands in the incidence products as well
        return dense_ops.incidence_precision(
            "default" if block_bf16 else "highest")

    def run_training(name, layout, block_bf16):
        cfg_model = QuerySATConfig(block_bf16=block_bf16)
        opt, state = fresh_state(cfg_model)
        if layout == "dense":
            step = make_train_step_for(query_sat_dense_apply, cfg_model,
                                       opt, dev)
            stream = PackedBatches(dense_train).repeat_shuffled()
        else:
            planned = make_planned_train_step(cfg_model, opt, dev)
            step = lambda s, b: planned(s, b, plans_of[id(b)])  # noqa: E731
            stream = PackedBatches(
                [b for b, _ in flat_train]).repeat_shuffled()
        state, _ = step(state, next(stream))      # warm-up
        _, state = fresh_state(cfg_model)
        segsum.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        losses = []
        for _ in range(TRAIN_STEPS):
            state, out = step(state, next(stream))
            losses.append(out["loss"])
        losses = torch.stack(losses).cpu().numpy()
        sync()
        wall = time.perf_counter() - t0
        fifth = TRAIN_STEPS // 5
        first, last = losses[:fifth].mean(), losses[-fifth:].mean()
        launched = dict(segsum.LAUNCHES)
        emit(phase=name, layout=layout, block_bf16=block_bf16,
             incidence_precision=dense_ops.INCIDENCE_PRECISION,
             steps=TRAIN_STEPS, first_fifth_loss=float(first),
             last_fifth_loss=float(last), required=LOSS_FALL_FACTOR,
             steps_per_s=TRAIN_STEPS / wall, wall_s=wall,
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
             launches=launched,
             losses=[float(x) for x in losses])
        if not np.isfinite(losses).all():
            raise RuntimeError(f"{name}: non-finite loss")
        if not last < LOSS_FALL_FACTOR * first:
            raise RuntimeError(f"{name}: the loss did not fall "
                               f"({first} -> {last})")
        return launched

    for name, layout, bf16 in (("train_dense", "dense", False),
                               ("train_dense_bf16", "dense", True)):
        with precision_of(bf16):
            launched = run_training(name, layout, bf16)
        if any(launched.values()):
            raise RuntimeError(f"{name} launched the segsum kernel")
    launches_of["train_flat_kernel"] = run_training(
        "train_flat_kernel", "flat", False)
    for d, n in launches_of["train_flat_kernel"].items():
        if n != TRAIN_STEPS * LAUNCHES_PER_TRAIN_STEP:
            raise RuntimeError(
                f"train_flat_kernel: {n} launches of {d}, reckoned "
                f"{TRAIN_STEPS * LAUNCHES_PER_TRAIN_STEP}")

    # the self-conditioning step on a flat batch makes two passes, each
    # through the kernel forward and backward
    cfg_model = QuerySATConfig()
    opt, state = fresh_state(cfg_model)
    selfsup = make_selfsupervised_train_step(cfg_model, opt, device=dev)
    segsum.reset_launch_counts()
    state, out = selfsup(state, *flat_train[0])
    sync()
    launched = dict(segsum.LAUNCHES)
    emit(phase="train_selfsup_flat", steps=1, loss=out["loss"].item(),
         loss1=out["loss1"].item(), loss2=out["loss2"].item(),
         launches=launched, predicted=2 * LAUNCHES_PER_TRAIN_STEP)
    if not np.isfinite(out["loss"].item()) or launched != dict.fromkeys(
            launched, 2 * LAUNCHES_PER_TRAIN_STEP):
        raise RuntimeError(f"train_selfsup_flat: launches {launched}")

    def script_ckpt_dir(ckpt_dir, exported):
        """The solving eval of a run's checkpoint directory (its newest
        checkpoint, which the restore run wrote) against the params that
        run exported at the same step: the same accuracies (per graph and
        per variable: 24 steps solve few graphs), the same launches."""
        step = max(int(p.stem.split("_")[1])
                   for p in ckpt_dir.glob("ckpt_*.npz"))
        exported_step = load_params(exported)[1]["step"]
        got = {}
        for form, path in (("ckpt_dir", ckpt_dir), ("npz", exported)):
            segsum.reset_launch_counts()
            t0 = time.perf_counter()
            res = solve_eval.main([
                "--model_ckpt", str(path), "--train_size", str(TRAIN_SIZE),
                "--test_size", "2000", "--max_batches", "2", "--data_dir",
                str(data_dir), "--device", str(dev)])
            got[form] = dict(total_accuracy=res["total_accuracy"],
                             accuracy=res["accuracy"],
                             launches=dict(segsum.LAUNCHES),
                             wall_s=time.perf_counter() - t0)
        emit(phase="train_script_ckpt_dir", step=step,
             exported_step=exported_step, **got)
        if step != exported_step or \
                step != SCRIPT_STEPS + SCRIPT_RESTORE_STEPS:
            raise RuntimeError(f"train_script_ckpt_dir: newest checkpoint "
                               f"{step}, exported {exported_step}")
        for key in ("total_accuracy", "accuracy", "launches"):
            if got["ckpt_dir"][key] != got["npz"][key]:
                raise RuntimeError(f"train_script_ckpt_dir: {key} differs")
        if min(got["ckpt_dir"]["launches"].values()) <= 0:
            raise RuntimeError("train_script_ckpt_dir: no kernel launch")

    # -- the training script, in-process, both layouts -------------------------
    # the runs' files go under the checkout and are removed afterwards
    train_dir = ROOT / "runs" / "chip_smoke"
    shutil.rmtree(train_dir, ignore_errors=True)
    common_argv = train_argv(data_dir) + [
        "--train_dir", str(train_dir), "--device", str(dev), "--ckpt_every",
        str(SCRIPT_STEPS)]
    script_launches = {"lit_to_clause": 0, "clause_to_lit": 0}
    n_steps = SCRIPT_STEPS
    for layout in ("dense", "flat"):
        argv_l = common_argv + [
            "--dense", "true" if layout == "dense" else "false",
            "--label", f"smoke_{layout}", "--eval_every", str(n_steps)]
        segsum.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        final = diffusion_training.main(
            argv_l + ["--train_steps", str(n_steps)])
        first_s = time.perf_counter() - t0
        run_dir = Path(final["run_dir"])
        ckpts = [f"ckpt_{n}.npz" for n in sorted(
            int(p.stem.split("_")[1])
            for p in (run_dir / "ckpt").iterdir())]
        # a second run restores the newest checkpoint and trains on
        final2 = diffusion_training.main(
            argv_l + ["--train_steps", str(n_steps + SCRIPT_RESTORE_STEPS),
                      "--restore", str(run_dir / "ckpt")])
        launched = dict(segsum.LAUNCHES)
        log = [json.loads(ln) for ln in (
            Path(final2["run_dir"]) / "train_log.jsonl"
        ).read_text().splitlines()]
        resumed = [r["step"] for r in log if "steps_per_sec" in r]
        # the exported params, read back by the solving eval
        segsum.reset_launch_counts()
        res = solve_eval.main([
            "--model_ckpt", str(run_dir / "params.npz"), "--train_size",
            str(TRAIN_SIZE), "--test_size", "2000", "--max_batches", "2",
            "--data_dir", str(data_dir), "--device", str(dev)])
        emit(phase="train_script", layout=layout, steps=n_steps,
             train_instances=TRAIN_SIZE, cut_from=100000,
             note="data quantity is cut, not width or depth",
             wall_s=first_s, eval_total_accuracy=final["total_accuracy"],
             diag_loss=final["diag_loss"], checkpoints=ckpts,
             resumed_to=resumed, launches=launched,
             npz_total_accuracy=res["total_accuracy"],
             files=sorted(p.name for p in run_dir.iterdir()))
        if ckpts != [f"ckpt_{n_steps}.npz"]:
            raise RuntimeError(f"train_script: checkpoints {ckpts}")
        if resumed != [n_steps + SCRIPT_RESTORE_STEPS]:
            raise RuntimeError(f"train_script: resumed to {resumed}")
        if not np.isfinite(final["diag_loss"]) or \
                not 0.0 <= res["total_accuracy"] <= 1.0:
            raise RuntimeError("train_script: bad eval")
        for name in ("config.json", "train_log.jsonl", "params.npz"):
            if not (run_dir / name).exists():
                raise RuntimeError(f"train_script: {name} missing")
        if layout == "flat":
            script_launches = launched
            if min(launched.values()) < n_steps * LAUNCHES_PER_TRAIN_STEP:
                raise RuntimeError(
                    f"train_script (flat): launches {launched}")
            script_ckpt_dir(run_dir / "ckpt",
                            Path(final2["run_dir"]) / "params.npz")
    launches_of["train_script"] = script_launches
    shutil.rmtree(train_dir)

    # -- where a train step's time goes -------------------------------
    def profile_train_step(name, layout, bf16):
        cfg_model = QuerySATConfig(block_bf16=bf16)
        opt, state = fresh_state(cfg_model)
        if layout == "dense":
            batch, plans = dense_train[0], None
            step = make_train_step_for(query_sat_dense_apply, cfg_model,
                                       opt, dev)
            run = functools.partial(step, batch=batch)
            apply = functools.partial(query_sat_dense_apply,
                                      batch=batch)
        else:
            batch, plans = flat_train[0]
            planned = make_planned_train_step(cfg_model, opt, dev)
            run = functools.partial(planned, batch=batch, plan=plans)
            apply = functools.partial(query_sat_apply, batch=batch,
                                      plans=plans)
        walls = []
        for _ in range(4):
            sync()
            t0 = time.perf_counter()
            state, _ = run(state)
            sync()
            walls.append(time.perf_counter() - t0)
        wall = min(walls[1:])
        with profile(activities=activities) as prof:
            state, _ = run(state)
            sync()
        step_k = cuda_kernels(prof)
        # the forward alone, to split the segsum time of the step
        with profile(activities=activities) as prof_f:
            g = torch.Generator(device=dev)
            g.manual_seed(3)
            tree_f = {m: {k: [p.detach().requires_grad_(True)
                              for p in v] for k, v in mlp.items()}
                      for m, mlp in state.params.items()}
            out = apply(params=tree_f, cfg=cfg_model, generator=g,
                        training=True, device=dev)
            sync()
        del out
        fwd_k = cuda_kernels(prof_f)
        busy = sum(dev_us(e) for e in step_k)
        top = sorted(step_k, key=dev_us, reverse=True)[:8]
        emit(phase="profile_train_step", layout=name,
             incidence_precision=dense_ops.INCIDENCE_PRECISION,
             wall_ms=wall * 1e3, walls_ms=[w * 1e3 for w in walls],
             device_busy_ms=busy / 1e3,
             device_busy_share=busy / 1e3 / (wall * 1e3),
             kernels_per_step=sum(e.count for e in step_k),
             forward_kernels=sum(e.count for e in fwd_k),
             forward_busy_ms=sum(dev_us(e) for e in fwd_k) / 1e3,
             segsum_busy_ms=segsum_us(step_k) / 1e3,
             segsum_forward_ms=segsum_us(fwd_k) / 1e3,
             segsum_backward_ms=(segsum_us(step_k) -
                                 segsum_us(fwd_k)) / 1e3,
             segsum_share_of_busy=segsum_us(step_k) / max(busy, 1),
             top=[(e.key[:60], dev_us(e) / 1e3, e.count) for e in top])

    for name, layout, bf16 in (("dense_f32", "dense", False),
                               ("dense_block_bf16", "dense", True),
                               ("flat_kernel", "flat", False)):
        with precision_of(bf16):
            profile_train_step(name, layout, bf16)
    train_launches = launches_of

    uni_launches = uniformity_phase(dev, data_dir, sync, busy_seconds,
                                    splits)
    anf = anf_phase(dev, data_dir, tools)
    graphs_phase(dev, data_dir, tools)
    generic = main_phase(dev, data_dir, tools, eval_batches)
    models = models_phase(dev, data_dir, tools)
    studies = studies_phase(dev, data_dir, tools)
    multi_rows = multi_phase(dev, data_dir, tools)
    lowp_rows = lowp_phase(dev, tools)

    # one row per kernel: times at the sampler's shapes, launches of the
    # sampler run; the solving eval's and the training paths' launches and
    # the times at the eval batch's and the 20k training batch's shapes ride
    # along (a backward launch is the same kernel at the same shapes)
    kernels = [dict(name=f"gather_segsum:{d}", route="cuda",
                    source=KERNEL_SOURCE, replaces=REPLACES,
                    launches=launches[d], max_abs_err=r["max_abs_err"],
                    ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"],
                    launches_solve_eval=eval_launches[d],
                    solve_eval_shapes=kernel_rows["eval_split_batch_0"][d],
                    launches_train_flat=train_launches["train_flat_kernel"][d],
                    launches_train_script=train_launches["train_script"][d],
                    launches_per_train_step=train_launches["per_step"][d],
                    launches_uniformity_flat=uni_launches[d],
                    uniformity_shapes=kernel_rows["p24_formula_0_x125"][d],
                    train_shapes=kernel_rows["threshold3sat_20k"][d],
                    launches_main=generic["launches_main"][d],
                    launches_main_restore=generic[
                        "launches_main_restore"][d],
                    launches_harness=generic["launches_harness"][d],
                    main_shapes=generic["rows"][d],
                    launches_models=models["launches_main"].get(d, 0),
                    models_shapes=models["rows"][d])
               for d, r in kernel_rows["primes_3599_x15"].items()]
    edge_rows = [row for row in models_kernel_rows(models)
                 if row["name"].split(":")[1] in EDGE_DIRECTIONS]
    for row in anf["kernels"]:
        row["launches_anf_structure"] = studies[
            "launches_anf_structure"].get(row["name"].split(":")[1], 0)
    print(json.dumps({"kernels": kernels + anf["kernels"] + edge_rows +
                      studies["rows"] + multi_rows + lowp_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
