"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py                 # every phase (what a check runs)
    python3 chip_smoke.py --phases device,kernel

Run from the root of a checkout: the kernels are built from its sources
(``lightgbm_tpu_torch/csrc``) into ``lightgbm_tpu_torch/_build``.  Imports
torch, numpy and ``lightgbm_tpu_torch`` only.  Phases, each printing one JSON
line and each raising (exit code 1) on any failure:

  device     card name and power limit (nvidia-smi), torch, the ten kernel
             builds (one nvcc each, started together)
  kernel     packed histogram kernel vs its plain torch version at full width
             (Fw=8, N=1,000,448, 255 bins): bitwise on dyadic inputs at the
             full window and at a strided window view, within rtol=1e-5 and
             atol=1e-5*sum|w| on random float32 (summation order), bitwise
             equal across two launches
  segments   segment histogram kernel vs its plain version at the same width
             over 64 members tiling a wave (unaligned starts, four frozen
             spans shared by two members each): bitwise on dyadic inputs,
             on random float32 within rtol=1e-5 and an atol of 1e-5 times
             each bin's own sum of |w|, bitwise across two launches
  partition  partition kernel vs its plain version at the same width, 64
             windows with random split flags: bitwise on every lane,
             NaN and negative-zero weight bits included; the windowed
             partition kernel (the compact learner's split) vs its plain
             version at windows of 1,024 rows, 2,048 (the default sort
             cutoff), all 1,000,000 rows and 250,001 rows from row 333,333,
             in sort and in mask mode, for a NaN-typed numerical, a bundled
             (EFB) and a categorical feature: every lane and the result
             bitwise, a do = 0 split a no-op
  scan       split-scan kernel vs its plain version at K=128, F=28, B=255:
             every field exact on dyadic histograms; on random float32 every
             field bitwise equal to the plain version run on the CPU (whose
             cumulative sums the kernel's carries reproduce), and against the
             plain version on the card (another summation order) the gain
             within 1e-3 of the pre-shift gain, threshold and default_left
             equal wherever the best two candidates differ by more than that;
             constrained (per-leaf value bounds that bind, a monotone sign
             and a gain penalty per feature) on the random fixture: every
             field bitwise equal to the CPU plain version, other winners
             than the unconstrained scan
  multislot  multislot histogram kernel (the level-wise opening's) vs its
             plain version on the full-width rows, a slot per row in root
             order (slot K and -1 dropped): bitwise on dyadic inputs at K = 1,
             3, 16 and 64 slots, and at K = 16 with the dataset's four
             padding features (code 0 in every row) on dyadic and quant
             inputs; at K = 16 on random float32 (padding features too)
             within rtol=1e-5 and an atol of 1e-5 times each bin's own sum
             of |w|, bitwise across two launches, and the quant mode
             bitwise
  hist_full  full-pass histogram kernel (the masked learner's) vs its plain
             version at full width (28 used of 32 code rows, N=1,000,448):
             uint16 codes with 1,023 bins and uint8 codes with 255 bins,
             bitwise on dyadic inputs, within rtol=1e-5 and an atol of 1e-5
             times each bin's own sum of |w| on random float32, bitwise across
             two launches; codes at or past num_bins dropped; 2,047 bins (two
             bin tiles) and 65,536 bins on small inputs
  fused_scan fused child-scan kernel vs the unfused path at K=64, F=28,
             B=255 over a 574-slot histogram pool: on quant-grid histograms
             and on random float32 every field and both pool rows bitwise
             equal to the plain version on the CPU; on quant-grid histograms
             also to the plain version on the card, on random float32 to
             the learner's unfused step on the card (torch subtraction and
             fix_histogram, then the split-scan kernel)
  replay     the replay-pass kernel vs its plain version run on the CPU, at
             the bench configuration's 1,145 node slots, 254 splits and
             stall batch 4: over random forests whose gains come from a
             small set (exact ties), half grown and grown to the budget
             (one with a vector cap that binds), every pass's carried
             state, members and counters bitwise, each stall's members
             split on both sides before the next pass; and at the sizing of
             num_leaves=4095 (M = 16,505: the table in global memory),
             4,097 (the list buffers in global memory) and 8,191 (both),
             over forests grown in the replay's order with one node in 500
             left unsplit
  split_cat  categorical split kernel vs its plain version at K=128 leaves,
             8 features of which 6 categorical (a one-hot one of 4 bins,
             many-vs-many ones, a NaN-typed one, a Zero-missing one, one
             with two bins of equal CTR), B=256, 1,023 and 2,047, and
             on dyadic inputs B=4,096 and 10,000 (over 2,048 and 8,192
             eligible bins: the shared-memory sort and its cut rounds): at
             the defaults, max_cat_threshold=3, min_data_per_group=1, a
             cat_smooth that leaves no bin eligible, and a (K, F) feature
             mask; every field and bitset (the numerical columns carried
             untouched) bitwise equal to the plain version run on the CPU
             on random float32 and dyadic inputs, to the plain version on
             the card on dyadic ones, bitwise across two launches; at
             B=256 with per-leaf value bounds and a gain penalty per
             feature (monotone constraints), bitwise to the CPU plain
             version on both inputs, the bounds binding
  bin_predict the predict binner kernel vs its plain version on the card
             and bin_host, at 100,000 raw rows over mappers fitted on
             10,000: 28 features at 255 and 1,023 bins (a NaN-typed
             feature; NaN, +-inf, -0.0, 1e30, every bound and its ulp
             neighbours), the Expo-shaped categorical rows (unseen,
             negative, fractional categories, NaN), 4 features with 9,999
             bounds (the row searched in global memory), the whole Higgs
             set (11,000,000 rows) and MS LTR's 137 features (two feature
             groups): codes bitwise, two launches bitwise; each shape's
             plan (groups, grid, shared memory, bytes moved against the
             bound's), the wrapper, the kernel alone, the plain version
             and torch.searchsorted; at the first shape the kernel's
             device time and the host-to-card upload of the rows
  tree       one 255-leaf tree from dyadic gradients on 1M x 28 Higgs-shaped
             rows, grown by the compact learner's device step through its
             kernels (eagerly, then as the learner's second tree through the
             captured step graph) and through every plain version: records,
             counts, leaf ids and outputs bitwise equal
  wave_tree  the same tree grown by the wave learner through its kernels
             (the learner's second tree: its split passes replayed as CUDA
             graphs), by the wave learner through every plain version, and
             by the compact learner: records, counts and leaf ids bitwise
             equal
  masked_tree one 255-leaf dyadic tree of the masked learner on the same
             rows: at 255 bins through hist_full, through the plain version
             and by the compact learner (records, counts, leaf ids and leaf
             outputs bitwise equal); at 1,023 bins (uint16 codes) through
             hist_full and through the plain version, bitwise
  opening_tree one full-width 255-leaf tree of the default learner with
             tpu_wave_open_levels=5 and boost_from_average=false (round-1
             gradients are exact): model text equal to the opening off, five
             opening levels through the multislot kernel
  categorical_tree one 255-leaf dyadic tree on the Expo-shaped rows of
             categorical_train, grown by the wave learner through its kernels
             (its second, graphed tree), through every plain version, by
             the compact and by the masked learner: records, counts,
             bitsets, leaf ids and leaf outputs bitwise equal
  train      lightgbm_tpu_torch.train with tpu_learner=compact at the bench
             width (1M x 28, 255 leaves, 255 bins, 5 iterations, 100,000
             held-out rows): 1 host sync per tree, 254 steps per tree, the
             first tree eager and every later tree's steps graph replays,
             launches per 5 trees: hist_packed 5 (the roots), hist_segments
             (K = 1) and partition_window 5 x 254; device residency,
             training logloss falling every iteration, held-out AUC,
             seconds per iteration, peak device memory, Booster.predict
             agreeing with the device-side held-out scores; one more tree
             grown eagerly on the run's last gradients records every
             windowed partition's window (sort or mask mode) and every K = 1
             launch's rows, and their distribution
  wave_train the same with the default tpu_learner (auto -> the wave
             learner): launches per kernel (replay included; a graph replay
             counts the launches captured in it) equal to the calls the
             learner recorded, host syncs (at most 2), lagged flag waits,
             graph launches, waves and stall events per tree, held-out AUC
             within 1e-4 of the compact phase's; the shape of every
             hist_segments launch (K, sum and max of cnt, the row bound)
             and split_scan launch (K) of one more tree grown eagerly on
             the run's last gradients, and their distribution; that tree's
             replay passes, each held bitwise against the plain version run
             on the CPU from the state the kernel started from
  wave_pipelined wave_train's params without the held-out set: the
             pipelined boosting loop, 5 iterations; no blocking read of
             records in the loop, record waits only at the flush, launches
             equal to the learner's calls, the first tree's model text
             equal to wave_train's, the held-out AUC of Booster.predict
             within 1e-4 of wave_train's, the loop's host seconds and the
             wall time to the last synchronisation
  quant_train the wave_train run with tpu_quantized_grad=on and
             tpu_wave_open_levels=5, the path of the multislot and fused
             kernels and of the histograms' quant modes: launches per kernel
             (quant-mode launches too) equal to the learner's calls, held-out
             AUC within 1e-3 of wave_train's, one tree fused against unfused
             bitwise, quantize_gradients on the card bitwise equal to the CPU,
             wave_train's per-tree counters; the shape of every
             hist_multislot launch (K and the rows in a slot) and fused_scan
             launch (K) of one more tree grown eagerly, and their
             distribution
  constrained_train the wave_train run with monotone_constraints +1 on
             feature 0 and -1 on feature 1 and feature_contri 0.5 on
             feature 2: every split_scan launch a constrained one, launches
             equal to the learner's calls, 1 host sync per tree, graphs from
             the second tree, the plain split search never called, the model
             monotone along features 0 and 1 over a grid of 256 values at 64
             held-out rows, seconds per iteration beside wave_train's; then
             3 iterations with tpu_quantized_grad=on and
             tpu_wave_open_levels=5: no fused_scan launch (the constrained
             split_scan instead), quant hist_segments, 1 host sync per tree,
             steps against the sign reported (the quantized recipe renews
             leaf outputs without the bounds, as the JAX package does);
             then the categorical_train cell with DepTime +1, Distance -1
             and Origin at 0.5, 5 iterations: every split_scan and
             split_cat launch constrained, 1 host sync per tree, monotone
  masked_train the wave_train run with max_bin=1023 (auto -> the masked
             learner, uint16 codes): hist_full launches equal to the calls the
             learner recorded (num_leaves per tree), host syncs per tree <= 2,
             training logloss falling, held-out AUC, Booster.predict through
             the DevicePredictor agreeing with the device-side held-out
             scores; every hist_full launch's weighted rows (rows with a
             weight not zero, a device count read after the run) and their
             distribution
  forced_train a three-node forcedsplits_filename tree (feature 25 at its
             median, then feature 26 at its median on both sides), written
             to a temporary directory: 3 iterations with the default
             learner (moved to the compact learner) at 255 bins and 3 with
             max_bin=1023 (the masked learner): every tree's first three
             splits the forced ones, in BFS order; the compact half as
             train's checks with 3 + 254 steps a tree
  observe_train training observability and crash-safe resume: the wave
             cell (1M x 28, 255 leaves, held-out set) for 4 iterations with
             telemetry, trace_out, telemetry_sync_every=2 and
             profile_trace_dir: the report valid against schema.json, 4
             iterations, the sampled legs' coverage within 0.1 of 1, every
             kernel the run launched found in the torch.profiler trace and
             attributed to a leg (hist, scan, partition, replay), the phase
             spans in the trace, the device counters; then for the wave and
             the compact learner a bagged pipelined run (bagging 0.8,
             feature_fraction 0.9) killed by train.crash:nth=3 with
             snapshot_freq=2 and resumed: the model text equal to the
             uninterrupted run's
  predict    DevicePredictor on the card for the wave_train model on the
             held-out rows, the raw rows uploaded and binned by the
             bin_predict kernel (one launch, bin_host never called, codes
             equal to bin_host's): against the host trees within 1e-9; with
             pred_early_stop the same frozen rows and scores within 1e-9 as
             the same call on the CPU; the model saved to text and reloaded
             (a bin schema rebuilt from the text) within 1e-9; rows per second
             with device binning, the upload, binning and traversal times
  serve      the prediction server on the card for the wave_train model
             (Booster.serve: 32- to 1,024-row buckets, one CUDA graph of
             bin_predict + the traversal captured per bucket at warmup,
             deadline 2 ms, tracing on): 8 client threads for 10 s, requests
             of 1 to 1,024 held-out rows (one in ten with NaN values and a
             NaN row), a second model (3 trees, num_leaves=63) swapped in
             over the wire halfway; every response within rtol = atol =
             1e-6 of the host trees and of Booster.predict(raw_score=True)
             of the model that served it; no fallback, error or shed; 6
             compile-cache misses per model version, 6 graphs throughout,
             graph replays equal to the batches, no eager batch;
             bin_predict launches equal to the warmup's eager runs plus the
             replays; the report valid, the metrics page rendered; each
             bucket's replay bitwise equal to bin_predict + the traversal
             run eagerly on the card and to bin_plain + the traversal,
             for both models; qps, rows/s, client and server latency
             percentiles (the clients are threads of this process, beside
             the server's), stage means, occupancy, each bucket's replay
             and eager ms (the wave model), and bin_predict at 32, 37 and
             1,024 rows over the wave model's arrays (wrapper, alone,
             device, plain, torch.searchsorted, bound)
  fleet      the serving fleet on the card for the wave_train model
             (FleetServer, 2 replicas on cuda:0, each with one CUDA graph
             of bin_predict + the traversal per 32- to 1,024-row bucket):
             8 client threads (4 binary, 4 pickle framing) sending 1 to
             1,024 held-out rows rounded to float32 (one in ten with NaN)
             and a GET /metrics scrape; serving.replica_fault on replica 1
             (its batches re-scored on the host, the replica ejected,
             replica 0 taking the traffic, re-admitted after 2 s); a 3-tree
             63-leaf model rolled out with promote_rolling under traffic
             and rolled back; one Autopilot cycle on traffic with feature 0
             moved by 6 standard deviations: a 3-round refit on the card
             from the 1M training rows (a FindBin sample of 50,000 rows, for
             the time limit; the wave kernels launched, its split
             passes captured while the replicas replay), shadowed and
             rolled out to both replicas; every response within rtol =
             atol = 1e-6 of the host trees of a version live while it was
             in flight; no error or shed, health ready; each replica's
             graphs and no eager batch; bin_predict and the five wave
             kernels launched; the refit model's bucket replays bitwise
             against bin_predict run eagerly and bin_plain; qps, latency
             percentiles, per-replica dispatch and ejections, graph
             replays, the refit's binning and seconds per iteration, the
             promotion's and the phase's seconds
  cli        the bench's first 100,000 training rows (a tenth, for the
             time limit) and 100,000 held-out rows written as
             CSV (repr floats, eight spawned writers), 5 iterations of the
             default config with a FindBin sample of 50,000 rows through
             lightgbm_tpu_torch.cli.main (the wave
             learner's kernels launched; parse, bin and train seconds),
             task=predict on the held-out file equal to Booster.predict
             written the same way, task=convert_model (five PredictTree
             functions), a binary cache of 20,000 held-out rows (equal
             codes, the same first tree) and their two_round stream (equal
             codes and labels),
             pred_contrib on 100 rows summing to the raw score within 1e-9
  small      a small input trained on the card and on the CPU (the path the
             tests hold against lightgbm_tpu): held-out metrics within 1e-4
  multiclass_train  objective=multiclass, num_class=5 (classes cut at the
             quintiles of the bench data's latent score, the rows and width
             kept), 5 iterations (25 trees) with the 100,000 held-out rows
             through the default (wave) learner: launches per kernel equal
             to the learner's calls, kernel calls and host syncs per tree
             (1), held-out multi_logloss falling every iteration, seconds per
             iteration; Booster.predict (the DevicePredictor) (100000, 5)
             probabilities whose rows sum to 1 within 1e-6, raw scores equal
             to the host trees within 1e-9; the card's joint softmax
             gradients within 1e-6 (relative) of the CPU objective's on the
             same scores; then the same without the held-out set, through
             the pipelined loop: no record read in the loop, the first
             iteration's five trees' text equal to the synchronous run's
  objectives_train  reg_sqrt, regression_l1, huber, fair, poisson, quantile,
             mape, gamma, tweedie, multiclassova (3 classes), cross_entropy
             and cross_entropy_lambda on the same rows, each with a label
             made valid for it from the latent score, 2 iterations each:
             the wave kernels launched, host syncs per tree (2 for the
             renewing L1, quantile and MAPE: the records and the renewal's
             read; 1 for the others), the held-out metric, seconds per
             iteration, the card's gradients within 1e-6 (relative) of the
             CPU objective's on the same scores
  rank_train lambdarank at MS LTR's width (137 features: the reference's
             docs/Experiments.rst; 567,574 rows, a quarter of its 2,270,296
             training rows, and a FindBin sample of 50,000, for the time
             limit), synthetic from a seed,
             queries of 120 documents, relevance 0-4 from a latent score;
             num_leaves=255, eval_at=1,3,5,10, 5 iterations, 1,000 held-out
             queries: the wave kernels launched, host syncs per tree (1),
             ndcg per iteration, seconds per iteration and the share of it
             in the lambdarank gradients (CUDA events around every gradient
             call), the card's gradients within 1e-5 of the CPU version's
             on one query batch of the trained scores
  categorical_train a synthetic Expo/airline-shaped binary problem (the
             reference's docs/Experiments.rst:112): 1M training and 100,000
             held-out rows from RandomState(11), six categorical columns
             (Month 12, DayofMonth 31, DayOfWeek 7, UniqueCarrier 22, Origin
             and Dest 300, Zipf) and two numerical ones, num_leaves=255,
             max_bin=255, 5 iterations through the default (wave) learner:
             the wave kernels and split_cat launched as often as the learner
             counted (and, in one graphed tree, as the device's records say),
             1 host sync per tree, graphs from the second tree, every tree
             with categorical splits, held-out AUC rising, the
             DevicePredictor's held-out scores equal to the host trees'
             within 1e-9 (the loop's float32 scores within 1e-5); then the
             same without the held-out set (pipelined): no record read in
             the loop, the first tree's model text equal, AUC within 1e-3,
             the flush's host assembly of the categorical trees timed
  categorical_2047 categorical data past 1,024 bins: 100,000 Expo-shaped
             rows whose Origin column has 2,500 categories, max_bin=2047
             (the masked learner, uint16 codes, B > 1,024), trained 3
             iterations on the card with split_cat launched, its first 256
             launches (over 2,048 eligible bins at the root: the
             shared-memory sort) each bitwise equal to the plain version
             run on the CPU on the recorded inputs; one more
             iteration with gpu_use_dp on the card and on the CPU (round 1
             without boost_from_average: exact sums): the same tree
             (structure, thresholds, bitsets, counts exactly; leaf values
             within 1e-9)
  wave_4095  a wave tree past the old shared-memory limit: num_leaves=4095
             (M = 16,505 node slots) on 100,000 Higgs-shaped rows, trained
             3 iterations on the card through the wave learner (replay
             kernel launched, no change of learner); the same gpu_use_dp
             check against the CPU as categorical_2047 (the replay kernel
             on float64 gains); then, under the default learner and
             tpu_wave_max_bytes, the wave learner's byte estimate at or
             above the card's peak allocation over three trees (eager,
             capturing, replaying) at 1,000,000 rows with 4,095 leaves
             and at Higgs's 11,000,000 rows (the bench rows repeated
             through Dataset.subset) with 31 and 255 leaves
  multihost_train pods of emulated hosts on the card, every rank a
             process (``--rank-job``): 2 hosts x 2 ranks (LGBT_*,
             LOCAL_WORLD_SIZE=2) train sharded_train's quant data mode 3
             iterations on the bench rows (texts equal, equal to a 4-rank
             RankPool's and in structure to serial's, launches equal to
             the pool's, gloo on one card; heartbeat ms, exchange_probe_ms,
             the merged pod trace); a 2-host two_round load of 100,000
             bench rows as CSV (FindBin sample 25,000; mappers and codes
             equal one host's); 3
             hosts heartbeating with net.crash on rank 1 (named within the
             deadline); elastic.run_host on 3 hosts over the CSV, host 1
             killed at its 5th collective (every round
             done, the survivors' models equal, held-out AUC within 2e-3 of
             serial); the same on 3 hosts x 2 ranks (LOCAL_WORLD_SIZE=2, a
             worker a rank), host 1's local rank 1 (global rank 3) killed:
             host 1 gone whole with no process left, 2 x 2 after the
             shrink, the same checks; every rank's backend, the rank that
             named the death, each host's recovery seconds
  analysis   the analysis gate's recompile sentinel (``python -m
             lightgbm_tpu_torch.analysis``'s ``recompile`` pass) on the
             card: tiny wave, quantized and compact boosters warmed two
             iterations, a serving model warmed at buckets 32 and 64, the
             capture counters armed, two more iterations each and requests
             of 1, b/2 and b rows in each bucket; fails unless the pass ran
             (not skipped), the wave, quant, compact and serving counters
             were registered and had captured during warm-up, and not one
             graph was captured after arming (before and after printed)
  timing     each of nine kernels' (bin_predict's in its own phase), its
             plain version's and (where one PyTorch call computes the same
             function) the library call's
             times from CUDA events, L2 flushed before each launch, beside
             the bound; each kernel alone (``kernel_ms``: its C entry point
             called again on the buffers one wrapper call staged, no torch
             work around it); hist_segments and split_scan also at the
             median and largest launch shape wave_train recorded, and
             hist_segments at train's median and largest K = 1 launch;
             the windowed partition at all 1,000,000 rows (sort mode, with
             its plain version) and at train's median and largest window in
             the mode it ran, each with its bound (no PyTorch call computes
             it); hist_full
             also with every weight zero, 5% of the rows weighted and the
             weighted share of masked_train's median and largest launch (a
             seeded random mask), each with its bound (the weight rows, the
             code sectors that hold a weighted row, the output) beside the
             all-rows bound; hist_packed at the full window and 65,536 rows
             with random and with zero weights; hist_multislot and fused_scan at the median and
             largest launch quant_train recorded (hist_multislot also at its
             median K = 1 launch, the recorded share of rows in a slot
             reproduced by seeded random slots over rows whose padding
             features hold one code, the bound counting only the rows in a
             slot); the replay kernel on a pass of all 254 pops (each
             launch on its own fresh state), on a pass after the end and
             on one whose budget is spent (its fixed cost: the node
             table's load and the list), the time per pop, wave_train's
             median and largest pass by pops (its eager tree's pass inputs
             replayed) and a pass of 4,094 pops at M = 16,505; split_cat at
             the fixture (K = 128, B = 256), at B = 2,047 and at
             categorical_train's median and largest launch K; split_scan and
             split_cat also constrained at K = 128 (bounds, signs, penalty)

Then a ``kernels`` line, the card's ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager

import numpy as np
import torch

from expo_data import EXPO_CATEGORICAL, EXPO_CATS, expo_like

PHASES = ("device", "kernel", "segments", "partition", "scan", "multislot",
          "hist_full", "fused_scan", "replay", "split_cat", "bin_predict",
          "tree",
          "wave_tree", "masked_tree", "opening_tree", "categorical_tree",
          "train", "wave_train", "wave_pipelined", "quant_train",
          "constrained_train", "masked_train", "forced_train",
          "observe_train", "predict",
          "serve", "fleet", "cli", "small", "multiclass_train",
          "objectives_train", "rank_train", "categorical_train",
          "categorical_2047", "wave_4095", "goss_train", "dart_train",
          "rf_train", "surface", "sharded_train", "multihost_train",
          "analysis", "timing")
FW, N_FULL, NUM_BINS = 8, 1_000_448, 255
ROWS, FEATURES, VALID_ROWS = 1_000_000, 28, 100_000
#: the FindBin sample of the cli and fleet refit loads, for the time limit
#: (host FindBin over the default 200,000 rows takes 18-38 s a load)
FINDBIN_SAMPLE = 50_000
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS = 67e12                # H100 SXM float32, outside the tensor cores
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
                "learning_rate": 0.1, "min_data_in_leaf": 20,
                "verbosity": -1, "metric": "auc,binary_logloss",
                "tpu_learner": "compact"}
#: the main path's params: TRAIN_PARAMS with the default tpu_learner (auto)
WAVE_PARAMS = {k: v for k, v in TRAIN_PARAMS.items() if k != "tpu_learner"}
#: this slice's path: quantized gradients with the level-wise opening
QUANT_PARAMS = dict(WAVE_PARAMS, tpu_quantized_grad="on",
                    tpu_wave_open_levels=5)
#: the constrained path: monotone +1 on feature 0, -1 on feature 1 and a
#: gain penalty of 0.5 on feature 2, the rest free
CON_PARAMS = dict(WAVE_PARAMS,
                  monotone_constraints=",".join(["1", "-1"]
                                                + ["0"] * (28 - 2)),
                  feature_contri=",".join(["1", "1", "0.5"]
                                          + ["1"] * (28 - 3)))
#: the masked learner's path: past 256 bins the default learner is masked
MASKED_BINS = 1023
MASKED_PARAMS = dict(WAVE_PARAMS, max_bin=MASKED_BINS)
SCAN_K = 128
MULTI_K = 16        # slots at the 5th opening level
FUSED_K = 64        # members of a full growth wave
POOL_H = 574        # the bench configuration's histogram pool slots
KERNEL_SOURCES = {
    "hist_packed": ("lightgbm_tpu_torch/csrc/hist_packed.cu",
                    "lightgbm_tpu/ops/hist_pallas.py:315"),
    "hist_segments": ("lightgbm_tpu_torch/csrc/hist_segments.cu",
                      "lightgbm_tpu/ops/hist_pallas.py:452"),
    "partition": ("lightgbm_tpu_torch/csrc/partition.cu",
                  "lightgbm_tpu/ops/partition_pallas.py:377"),
    # the compact learner's window split: the port of an XLA lax.sort (the
    # partition_pallas kernel computes the wave's permutation), not of a
    # pallas_call
    "partition_window": ("lightgbm_tpu_torch/csrc/partition.cu",
                         "lightgbm_tpu/learner_compact.py:265"),
    "split_scan": ("lightgbm_tpu_torch/csrc/split_scan.cu",
                   "lightgbm_tpu/ops/scan_pallas.py:185"),
    "hist_multislot": ("lightgbm_tpu_torch/csrc/hist_multislot.cu",
                       "lightgbm_tpu/ops/hist_pallas.py:584"),
    "fused_scan": ("lightgbm_tpu_torch/csrc/fused_scan.cu",
                   "lightgbm_tpu/ops/scan_pallas.py:298"),
    "hist_full": ("lightgbm_tpu_torch/csrc/hist_full.cu",
                  "lightgbm_tpu/ops/hist_pallas.py:90"),
    # the port of an XLA while_loop, not of a pallas_call
    "replay": ("lightgbm_tpu_torch/csrc/replay.cu",
               "lightgbm_tpu/learner_wave.py:1597"),
    # the port of an XLA lax.scan, not of a pallas_call
    "split_cat": ("lightgbm_tpu_torch/csrc/split_cat.cu",
                  "lightgbm_tpu/ops/split_cat.py:70"),
    # the port of a jitted XLA function, not of a pallas_call
    "bin_predict": ("lightgbm_tpu_torch/csrc/bin_predict.cu",
                    "lightgbm_tpu/serving/binner.py:184"),
}
#: the bench configuration's replay: node slots, splits, stall batch
REPLAY_M, REPLAY_BUDGET, REPLAY_KB = 1145, 254, 4
#: the large trees of the replay checks, one per placement of the kernel's
#: buffers past the bench configuration's (all in shared memory): the node
#: table in global memory (4,095 leaves), the list buffers (4,097), both
#: (8,191); ops/replay.py:replay_plan
REPLAY_LARGE = (4095, 4097, 8191)


def replay_dims(num_leaves: int) -> tuple:
    """The wave learner's node slots M and replay budget at ``num_leaves``
    with the other parameters at their defaults: 1 + 2 * (grow budget +
    correction reserve), learner_wave.py:_init_wave_dims."""
    budget = num_leaves - 1
    return 1 + 2 * (2 * budget + 64), budget


#: node gains of the replay checks: a small set, so exact ties are common
REPLAY_GAINS = np.array([-1.0, 0.0, 0.25, 0.5, 0.5, 1.0, 1.0, 1.5, 2.0,
                         3.0], dtype=np.float32)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def higgs_latent(rows: int, seed: int = 7):
    """bench.py's synthetic Higgs-shaped problem (28 dense features) and
    its latent score, whose sign is the binary label."""
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, FEATURES).astype(np.float64)
    logit = (X[:, 0] * 1.5 + X[:, 1] * X[:, 2] * 0.5 + np.sin(X[:, 3])
             + 0.5 * rng.randn(rows))
    return X, logit


def higgs_like(rows: int, seed: int = 7):
    """bench.py's synthetic Higgs-shaped binary problem (28 dense features)."""
    X, logit = higgs_latent(rows, seed)
    return X, (logit > 0).astype(np.float64)


def dyadic_weights(rng, n: int, n_real: int, dev):
    """(g*bag, h*bag, bag) with g, h multiples of 1/16, |g| <= 1, bag in
    {0, 1}: every sum is exact in float32 whatever its order."""
    bag = np.zeros(n, np.float32)
    bag[:n_real] = rng.rand(n_real) < 0.9
    g = (rng.randint(-16, 17, n) / 16.0).astype(np.float32)
    h = (rng.randint(1, 17, n) / 16.0).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (g, h, bag)]


def cuda_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` in ms from CUDA events, the 64 MB
    ``flush`` buffer rewritten before each launch so the L2 starts cold."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.add_(1)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def phase_device(ctx) -> None:
    from lightgbm_tpu_torch import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    ctx["smi"] = smi.stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    native.build_all(native.KERNELS)
    emit({"phase": "device", "nvidia_smi": ctx["smi"],
          "name": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": {k: v for k, v in native.BUILD_SECONDS.items()},
          "build_wall_s": time.perf_counter() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "smem" in ln
                        or "spill" in ln] for k, v in
                    native.PTXAS_REPORT.items()}})


def phase_kernel(ctx) -> None:
    from lightgbm_tpu_torch.ops.hist_packed import (
        build_histogram_packed, build_histogram_packed_plain, pack_bin_words)

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    codes = rng.randint(0, NUM_BINS, size=(4 * FW, N_FULL)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    g, h, bag = dyadic_weights(rng, N_FULL, N_FULL, dev)
    w_dy = torch.stack([g * bag, h * bag, bag])
    bag_r = torch.from_numpy((rng.rand(N_FULL) < 0.8).astype(np.float32)) \
        .to(dev)
    w_rand = torch.stack([
        torch.from_numpy(rng.randn(N_FULL).astype(np.float32)).to(dev) * bag_r,
        torch.from_numpy(rng.rand(N_FULL).astype(np.float32)).to(dev) * bag_r,
        bag_r])
    off, size = 12_345, 4096
    views = {"full": (words, slice(0, N_FULL)),
             "view4096@12345": (words[:, off:off + size],
                                slice(off, off + size))}
    out = {"phase": "kernel", "Fw": FW, "N": N_FULL, "num_bins": NUM_BINS}
    max_err = 0.0
    for tag, (wv, sl) in views.items():
        k = build_histogram_packed(wv, w_dy[:, sl], num_bins=NUM_BINS)
        p = build_histogram_packed_plain(wv, w_dy[:, sl], num_bins=NUM_BINS)
        check(torch.equal(k, p), f"dyadic {tag}: kernel != plain "
              f"(max diff {(k - p).abs().max().item()})")
        k = build_histogram_packed(wv, w_rand[:, sl], num_bins=NUM_BINS)
        k2 = build_histogram_packed(wv, w_rand[:, sl], num_bins=NUM_BINS)
        p = build_histogram_packed_plain(wv, w_rand[:, sl],
                                         num_bins=NUM_BINS)
        # float32 sums in another order than index_add_'s atomics: the error
        # bound scales with the channel's absolute mass
        atol = 1e-5 * w_rand[:, sl].abs().sum(dim=1)
        err = (k - p).abs()
        ok = bool((err <= 1e-5 * p.abs() + atol).all())
        check(ok, f"random {tag}: kernel vs plain beyond rtol=1e-5, "
              f"atol=1e-5*sum|w| (max diff {err.max().item()})")
        check(torch.equal(k, k2), f"{tag}: two launches differ")
        max_err = max(max_err, err.max().item())
        out[tag] = {"dyadic_bitwise": True, "random_max_abs_err":
                    err.max().item(), "relaunch_bitwise": True}
    torch.cuda.synchronize()
    ctx["max_abs_err"] = max_err
    emit(out)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN equal to NaN."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def wave_members(rng, n: int):
    """64 members tiling one wave over n rows: 56 disjoint windows with
    unaligned starts (sortable members' smaller children) and 4 frozen
    6,000-row spans, each shared by two members told apart by leaf id.
    Returns (lid (n,), start, cnt, leaf) as numpy arrays."""
    frozen, span = 4, 6000
    tail = n - frozen * span
    cuts = np.sort(rng.choice(np.arange(1, tail), 55, replace=False))
    bounds = np.concatenate([[0], cuts, [tail]])
    lid = np.full(n, 9999, np.int32)
    start, cnt, leaf = [], [], []
    for i in range(56):
        s, e = int(bounds[i]), int(bounds[i + 1])
        lid[s:e] = 100 + i
        start.append(s)
        cnt.append(e - s)
        leaf.append(100 + i)
    for j in range(frozen):
        s = tail + j * span
        a, b = 200 + 2 * j, 201 + 2 * j
        lid[s:s + span] = np.where(rng.rand(span) < 0.5, a, b)
        for lf in (a, b):
            start.append(s)
            cnt.append(span)
            leaf.append(lf)
    return lid, np.asarray(start), np.asarray(cnt), np.asarray(leaf)


def segments_inputs(seed: int, dyadic: bool):
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(seed)
    from lightgbm_tpu_torch.ops.hist_packed import pack_bin_words

    codes = rng.randint(0, NUM_BINS, size=(4 * FW, N_FULL)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    lid, start, cnt, leaf = wave_members(rng, N_FULL)
    if dyadic:
        g, h, bag = dyadic_weights(rng, N_FULL, N_FULL, dev)
    else:
        bag = torch.from_numpy((rng.rand(N_FULL) < 0.8).astype(np.float32)) \
            .to(dev)
        g = torch.from_numpy(rng.randn(N_FULL).astype(np.float32)).to(dev)
        h = torch.from_numpy(rng.rand(N_FULL).astype(np.float32)).to(dev)
    w = torch.stack([g * bag, h * bag, bag]).contiguous()
    t = [torch.from_numpy(a).to(dev) for a in (lid, start, cnt, leaf)]
    return words, w, t[0], t[1], t[2], t[3], int(cnt.sum())


def phase_segments(ctx) -> None:
    from lightgbm_tpu_torch.ops.hist_segments import (
        build_histogram_segments, build_histogram_segments_plain)

    out = {"phase": "segments", "Fw": FW, "N": N_FULL, "num_bins": NUM_BINS,
           "members": 64}
    for tag, dyadic in (("dyadic", True), ("random", False)):
        words, w, lid, start, cnt, leaf, bound = segments_inputs(3, dyadic)
        k = build_histogram_segments(words, w, lid, start, cnt, leaf,
                                     num_bins=NUM_BINS, rows_bound=bound)
        k2 = build_histogram_segments(words, w, lid, start, cnt, leaf,
                                      num_bins=NUM_BINS, rows_bound=bound)
        p = build_histogram_segments_plain(words, w, lid, start, cnt, leaf,
                                           num_bins=NUM_BINS)
        check(torch.equal(k, k2), f"segments {tag}: two launches differ")
        err = (k - p).abs()
        if dyadic:
            check(torch.equal(k, p), f"segments dyadic: kernel != plain (max "
                  f"diff {err.max().item()})")
        else:
            # float32 sums in two orders: each bin's rounding error is
            # bounded by the bin's own absolute mass, so the limit is set
            # per bin (a dropped or misrouted row moves its bin by far more)
            mass = build_histogram_segments_plain(
                words, w.abs(), lid, start, cnt, leaf, num_bins=NUM_BINS)
            lim = 1e-5 * p.abs() + 1e-5 * mass
            check(bool((err <= lim).all()),
                  f"segments random: kernel vs plain beyond rtol=1e-5, "
                  f"atol=1e-5*(the bin's sum of |w|) (max diff "
                  f"{err.max().item()})")
            nz = lim > 0
            out["random_worst_err_to_limit"] = (err[nz] / lim[nz]).max() \
                .item()
            ctx["err_segments"] = err.max().item()
        out[tag] = {"max_abs_err": err.max().item(), "relaunch_bitwise": True,
                    "rows_bound": bound}
    torch.cuda.synchronize()
    emit(out)


def partition_inputs(seed: int):
    """Random lanes (NaN and negative-zero weights included), 64 disjoint
    windows with random split flags, and dest computed as the wave learner
    computes it (window start + the row's rank among its side's rows)."""
    from lightgbm_tpu_torch.ops.partition import exclusive_cumsum

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(seed)
    n = N_FULL
    bins = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, size=(FW, n),
                                        dtype=np.int64).astype(np.int32))
    w = rng.randn(3, n).astype(np.float32)
    w[0, rng.rand(n) < 0.01] = np.nan
    w[1, rng.rand(n) < 0.01] = -0.0
    cuts = np.sort(rng.choice(np.arange(1, n), 128, replace=False))
    win_s, win_e = cuts[0::2], cuts[1::2]          # 64 windows, gaps between
    wid = np.full(n, -1, np.int64)
    for i, (s, e) in enumerate(zip(win_s, win_e)):
        wid[s:e] = i
    go = rng.rand(n) < rng.rand()
    sort_r = wid >= 0
    gl = torch.from_numpy(sort_r & go)
    gr = torch.from_numpy(sort_r & ~go)
    cl, cr = exclusive_cumsum(gl), exclusive_cumsum(gr)
    ps = torch.from_numpy(win_s)
    lc = torch.from_numpy(np.array([(go[s:e]).sum() for s, e in
                                    zip(win_s, win_e)]))
    base_l = torch.cat([ps - cl[ps], torch.zeros(1, dtype=torch.int64)])
    base_r = torch.cat([ps + lc - cr[ps], torch.zeros(1, dtype=torch.int64)])
    widt = torch.from_numpy(np.where(wid < 0, 64, wid))
    dest = torch.where(torch.from_numpy(sort_r),
                       torch.where(torch.from_numpy(go),
                                   base_l[widt] + cl, base_r[widt] + cr),
                       torch.arange(n)).to(torch.int32)
    lanes = (bins, torch.from_numpy(w), torch.arange(n, dtype=torch.int64),
             torch.from_numpy(rng.randint(0, 1145, n).astype(np.int32)),
             dest)
    return [t.to(dev).contiguous() for t in lanes]


def phase_partition(ctx) -> None:
    from lightgbm_tpu_torch.ops.partition import (apply_partition,
                                                  apply_partition_plain)

    bins, w, rid, lid, dest = partition_inputs(4)
    n = N_FULL
    check(torch.equal(torch.sort(dest.long()).values,
                      torch.arange(n, device=dest.device)),
          "partition input: dest is not a permutation")
    k = apply_partition(bins, w, rid, lid, dest)
    p = apply_partition_plain(bins, w, rid, lid, dest)
    names = ("bins", "w_bits", "rid", "lid")
    kv = (k[0], k[1].view(torch.int32), k[2], k[3])
    pv = (p[0], p[1].view(torch.int32), p[2], p[3])
    for name, a, b in zip(names, kv, pv):
        check(torch.equal(a, b), f"partition: lane {name} differs from the "
              f"plain version")
    moved = int((dest != torch.arange(n, device=dest.device,
                                      dtype=torch.int32)).sum())
    torch.cuda.synchronize()
    ctx["err_partition"] = 0.0
    emit({"phase": "partition", "Fw": FW, "N": n, "windows": 64,
          "rows_moved": moved, "lanes_bitwise": list(names),
          "nan_weights": int(torch.isnan(w).sum()),
          "negative_zero_weights": int((w.view(torch.int32)
                                        == -2 ** 31).sum()),
          "windowed": windowed_partition_checks()})
    ctx["err_partition_window"] = 0.0


#: the windowed partition's checks: (start, count) at the compact learner's
#: smallest window (1,024 rows), its sort cutoff (2,048: the default
#: tpu_sort_cutoff), all 1,000,000 rows and a window at a non-zero start
WINDOW_CASES = ((0, 1024), (4096, 2048), (0, ROWS), (333_333, 250_001))
#: decode-table rows of the windowed checks' splits (ops/partition.py FT_*):
#: a NaN-missing numerical feature in word 3 byte 2, a bundled (EFB) one in
#: word 5 byte 1, a categorical one in word 6 byte 3
WINDOW_FEATURES = ((3, 16, 2, 0, 200, 0, 0), (5, 8, 0, 7, 40, 30, 1),
                   (6, 24, 0, 0, 256, 0, 0))


def window_inputs(seed: int, start: int, count: int, leaf: int):
    """Full-width random lanes (NaN and negative-zero weights, a 0/1 bag
    lane) whose window rows are mostly leaf ``leaf`` (the rest of other
    leaves, as a frozen window holds), a categorical bitset and the
    decode table."""
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(seed)
    n = N_FULL
    bins = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1, size=(FW, n),
                                        dtype=np.int64).astype(np.int32))
    w = rng.randn(3, n).astype(np.float32)
    w[0, rng.rand(n) < 0.01] = np.nan
    w[1, rng.rand(n) < 0.01] = -0.0
    w[2] = (rng.rand(n) < 0.8).astype(np.float32)
    lid = rng.randint(0, 300, n).astype(np.int32)
    inside = rng.rand(count) < 0.9
    lid[start:start + count][inside] = leaf
    bits = rng.randint(-2 ** 31, 2 ** 31 - 1, size=8, dtype=np.int64) \
        .astype(np.int32)
    t = [torch.from_numpy(a) for a in (bins.numpy(), w, np.arange(
        n, dtype=np.int64), lid, np.asarray(WINDOW_FEATURES, np.int64),
        bits)]
    return [a.to(dev).contiguous() for a in t]


def windowed_partition_checks() -> dict:
    """The windowed partition kernel against its plain version at
    ``WINDOW_CASES``: in sort mode and in mask mode, for each decode-table
    feature, every lane and the result bitwise; a split with do = 0
    changes no lane."""
    from lightgbm_tpu_torch.ops.partition import (partition_window,
                                                  partition_window_plain)

    dev = torch.device("cuda", 0)
    out = {}
    for case, (start, count) in enumerate(WINDOW_CASES):
        leaf, new = 17, 254
        base = window_inputs(20 + case, start, count, leaf)
        ftab, bits = base[4], base[5]
        runs = []
        for feat, (thr, flags) in enumerate(((99, 1), (12, 0), (0, 2))):
            for mask_max, do in ((0, 1), (1 << 30, 1), (0, 0)):
                split = torch.tensor([leaf, new, feat, thr, flags, do,
                                      start, count], dtype=torch.int64,
                                     device=dev)
                k = [t.clone() for t in base[:4]]
                p = [t.clone() for t in base[:4]]
                ko = partition_window(*k, split, ftab, bits,
                                      mask_max=mask_max)
                po = partition_window_plain(*p, split, ftab, bits,
                                            mask_max=mask_max)
                tag = (f"window {start}+{count}, feature {feat}, "
                       f"mask_max {mask_max}, do {do}")
                check(torch.equal(ko, po), f"partition_window {tag}: result "
                      f"{ko.tolist()} != plain {po.tolist()}")
                for name, a, b in zip(("bins", "w_bits", "rid", "lid"),
                                      (k[0], k[1].view(torch.int32), k[2],
                                       k[3]),
                                      (p[0], p[1].view(torch.int32), p[2],
                                       p[3])):
                    check(torch.equal(a, b), f"partition_window {tag}: lane "
                          f"{name} differs from the plain version")
                if not do:
                    bits_of = (lambda t: t.view(torch.int32)
                               if t.dtype == torch.float32 else t)
                    check(all(torch.equal(bits_of(a), bits_of(b)) for a, b
                              in zip(k[:4], base[:4])),
                          f"partition_window {tag}: a do = 0 split moved "
                          f"rows")
                runs.append({"feature": feat, "mask_max": mask_max,
                             "do": do, "result": ko.tolist()})
        out[f"{start}+{count}"] = runs
    torch.cuda.synchronize()
    return {"cases": out, "bitwise": True}


def scan_inputs(seed: int, dyadic: bool, k: int = SCAN_K, f: int = FEATURES,
                b: int = NUM_BINS):
    """A (K, F, B, 3) histogram cube with mixed missing types.  Dyadic: the
    fixture of tests/test_partition.py at the bench width (leaf totals need
    not match the bins; every sum is exact).  Random: the histograms of
    4,096 random rows per leaf, so every feature's bins sum to the leaf
    totals, as in training."""
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(2, b + 1, size=f).astype(np.int32)
    missing = rng.randint(0, 3, size=f).astype(np.int32)
    default_bin = (rng.randint(0, 100, size=f) % num_bin).astype(np.int32)
    if dyadic:
        gen = (lambda s: (rng.randint(-(1 << 12), 1 << 12, size=s) / 64.0)
               .astype(np.float32))
        hg = gen((k, f, b))
        hh = np.abs(gen((k, f, b))) + 0.25
        hc = rng.randint(0, 50, size=(k, f, b)).astype(np.float32)
        hist = np.stack([hg, hh, hc], axis=-1)
        hist *= (np.arange(b)[None, :] < num_bin[:, None])[None, :, :, None]
        sum_g = hist[..., 0].sum(axis=(1, 2)) / f
        sum_h = hist[..., 1].sum(axis=(1, 2)) / f
        cnt = hist[..., 2].sum(axis=(1, 2)) / f
    else:
        rows = 4096
        w = np.stack([rng.randn(k, rows), rng.rand(k, rows),
                      np.ones((k, rows))]).astype(np.float32)
        codes = (rng.rand(k, f, rows) * num_bin[None, :, None]) \
            .astype(np.int64)
        flat = ((np.arange(k)[:, None, None] * f
                 + np.arange(f)[None, :, None]) * b + codes).reshape(-1)
        hist = np.stack([np.bincount(
            flat, weights=np.broadcast_to(w[c][:, None, :], codes.shape)
            .reshape(-1), minlength=k * f * b) for c in range(3)], -1) \
            .reshape(k, f, b, 3).astype(np.float32)
        sum_g, sum_h, cnt = w.astype(np.float64).sum(axis=2)
    fmask = rng.rand(f) < 0.9
    return [torch.from_numpy(np.asarray(a)) for a in
            (hist, sum_g.astype(np.float32), sum_h.astype(np.float32),
             cnt.astype(np.float32), num_bin, missing, default_bin, fmask)]


SCAN_KW = dict(lambda_l1=0.1, lambda_l2=0.5, max_delta_step=0.0,
               min_data_in_leaf=3, min_sum_hessian_in_leaf=1e-3,
               min_gain_to_split=0.0)


def scan_constraints(k: int, f: int, seed: int):
    """What a constrained scan takes, on the CPU: a monotone sign (F,) int8
    of -1, 0 or +1, per-leaf value bounds (K,) that bind (no bound, a band
    of +-0.05, a floor at 0, a ceiling at -0.01, in turn) and a gain
    penalty (F,) of 1, 0.5, 0.25 or 0."""
    rng = np.random.RandomState(seed)
    lo = np.array([-np.inf, -0.05, 0.0, -np.inf], np.float32)
    hi = np.array([np.inf, 0.05, np.inf, -0.01], np.float32)
    mono = rng.randint(-1, 2, f).astype(np.int8)
    pen = rng.choice([1.0, 0.5, 0.25, 0.0], f).astype(np.float32)
    return [torch.from_numpy(a) for a in
            (mono, np.resize(lo, k), np.resize(hi, k), pen)]


def threshold_gains(hist, sum_g, sum_h, cnt, num_bin, missing, default_bin,
                    *, lambda_l1, lambda_l2, max_delta_step, min_data_in_leaf,
                    min_sum_hessian_in_leaf, min_gain_to_split):
    """(K, F, 2B) gains at every threshold of both missing directions
    (missing-left, then missing-right) before the leaf's gain shift is taken
    off; -inf where a threshold is not evaluated, infeasible or not above
    the shift.  The split scan takes its maximum over these; the scan phase
    uses them to tell a clear best threshold from a near tie.  Written from
    the scan's rules in lightgbm_tpu_torch/ops/split.py, in its order of
    operations."""
    from lightgbm_tpu_torch.binning import (MISSING_NAN, MISSING_NONE,
                                            MISSING_ZERO)
    from lightgbm_tpu_torch.ops.split import K_EPSILON, leaf_split_gain

    dt = hist.dtype
    t = torch.arange(hist.shape[-2], device=hist.device)[None, :]   # (1, B)
    nb, d = num_bin[:, None], default_bin[:, None]                  # (F, 1)
    zero = (missing == MISSING_ZERO)[:, None]
    nan = (missing == MISSING_NAN)[:, None]
    two = ((num_bin > 2) & (missing != MISSING_NONE))[:, None]
    tg = sum_g.to(dt)[:, None, None]
    th = sum_h.to(dt)[:, None, None] + 2.0 * K_EPSILON
    tn = cnt.to(dt)[:, None, None]
    par = (lambda_l1, lambda_l2, max_delta_step)
    shift = leaf_split_gain(tg, th, *par) + min_gain_to_split

    def gains(lg, lh, lc, rg, rh, rc, ok):
        ok = ok & (lc >= min_data_in_leaf) & (rc >= min_data_in_leaf) \
            & (lh >= min_sum_hessian_in_leaf) & (rh >= min_sum_hessian_in_leaf)
        g = leaf_split_gain(lg, lh, *par) + leaf_split_gain(rg, rh, *par)
        return torch.where(ok & (g > shift), g, float("-inf"))

    def after(x):                                   # sum over bins > t
        c = torch.flip(torch.cumsum(torch.flip(x, [-1]), -1), [-1])
        return torch.cat([c[..., 1:], torch.zeros_like(c[..., :1])], -1)

    # missing-left: right sums by suffix, left = total - right
    keep = (~((two & zero & (t == d)) | (two & nan & (t >= nb - 1))
              | (t >= nb))).to(dt)
    rg, rh, rc = (after(hist[..., c] * keep) for c in range(3))
    rh = rh + K_EPSILON
    ok = (t <= torch.where(two & nan, nb - 3, nb - 2)) \
        & ~(two & zero & (t == d - 1))
    left = gains(tg - rg, th - rh, tn - rc, rg, rh, rc, ok)
    # missing-right (two-scan features only): left sums by prefix
    keep = (~((zero & (t == d)) | (nan & (t >= nb - 1)) | (t >= nb))).to(dt)
    lg, lh, lc = (torch.cumsum(hist[..., c] * keep, -1) for c in range(3))
    lh = lh + K_EPSILON
    ok = two & (t <= nb - 2) & ~(zero & (t == d))
    right = gains(lg, lh, lc, tg - lg, th - lh, tn - lc, ok)
    return torch.cat([left, right], -1)


def phase_scan(ctx) -> None:
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched
    from lightgbm_tpu_torch.ops.split import find_best_splits

    dev = torch.device("cuda", 0)
    out = {"phase": "scan", "K": SCAN_K, "F": FEATURES, "B": NUM_BINS}
    for tag, dyadic in (("dyadic", True), ("random", False)):
        kw = dict(SCAN_KW, lambda_l1=0.0) if dyadic else SCAN_KW
        cpu = scan_inputs(5 if dyadic else 6, dyadic)
        args = [t.to(dev) for t in cpu]
        k = find_best_splits_batched(*args, **kw)
        p = find_best_splits(*args, **kw)
        pc = find_best_splits(*cpu, **kw)
        fields = k._fields
        cpu_same = all(same(getattr(k, fl).cpu(), getattr(pc, fl))
                       for fl in fields)
        check(cpu_same, f"scan {tag}: kernel differs from the plain version "
              f"run on the CPU")
        if dyadic:
            for fl in fields:
                check(same(getattr(k, fl), getattr(p, fl)),
                      f"scan dyadic: field {fl} differs from the plain "
                      f"version")
            out[tag] = {"fields_exact": True, "cpu_plain_bitwise": True}
            continue
        # the card's plain version sums in another float32 order: hessian
        # prefix sums near 2,000 then carry ~1e-3 absolute error, and a
        # small child's hessian sum ~1e-4 relative (two orders measured on
        # the CPU differ by up to 1.2e-4 of the pre-shift gain on this
        # fixture).  Compare the gain to 1e-3 of the pre-shift gain, and the
        # choice wherever the best two candidates are further apart
        tg = threshold_gains(*args[:7], **kw)                 # (K, F, 2B)
        top2 = torch.topk(tg, 2, dim=-1).values
        scale = 1e-3 * top2[..., 0].abs()
        fin = torch.isfinite(p.gain)
        check(torch.equal(fin, torch.isfinite(k.gain)),
              "scan random: infeasible features differ")
        gerr = (k.gain - p.gain).abs()
        check(bool((gerr[fin] <= scale[fin]).all()),
              f"scan random: gain beyond 1e-3 of the pre-shift gain (max "
              f"diff {gerr[fin].max().item()})")
        clear = fin & (top2[..., 0] - top2[..., 1] > scale)
        for fl in ("threshold", "default_left"):
            check(torch.equal(getattr(k, fl)[clear], getattr(p, fl)[clear]),
                  f"scan random: {fl} differs at a clear best candidate")
        ctx["err_scan"] = gerr[fin].max().item()
        out[tag] = {"gain_max_abs_err": ctx["err_scan"],
                    "clear_candidates": int(clear.sum()),
                    "feasible": int(fin.sum()), "cpu_plain_bitwise": True}
        # the constrained scan on the same inputs: bounds, signs, penalty
        con = scan_constraints(SCAN_K, FEATURES, 8)
        con_d = [t.to(dev) for t in con]
        n0 = find_best_splits_batched.con_launches
        kc = find_best_splits_batched(*args, *con_d[:3], penalty=con_d[3],
                                      **kw)
        check(find_best_splits_batched.con_launches == n0 + 1,
              "scan constrained: not a constrained launch")
        pcc = find_best_splits(*cpu, *con[:3], penalty=con[3], **kw)
        check(all(same(getattr(kc, fl).cpu(), getattr(pcc, fl))
                  for fl in fields),
              "scan constrained: kernel differs from the plain version run "
              "on the CPU")
        moved = int((kc.threshold != k.threshold).sum())
        check(moved > 0, "scan constrained: the constraints moved no split")
        out["constrained"] = {"cpu_plain_bitwise": True,
                              "thresholds_moved": moved,
                              "finite_gains": int(torch.isfinite(
                                  kc.gain).sum())}
    torch.cuda.synchronize()
    emit(out)


def multislot_inputs(seed: int, kind: str, k: int, pad: bool = False):
    """Full-width packed rows, weights and a slot per row in root order, as
    an opening level sees them: slots 0..K-1, K and -1 (rows of leaves the
    level does not split) dropped.  ``kind``: dyadic, quant (the integer
    grids times powers of two) or random float32.  ``pad``: features
    28-31 hold code 0 in every row, as the dataset pads the 28 features."""
    from lightgbm_tpu_torch.ops.hist_packed import pack_bin_words

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, NUM_BINS, size=(4 * FW, N_FULL)).astype(np.uint8)
    if pad:
        codes[FEATURES:] = 0
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    if kind == "dyadic":
        g, h, bag = dyadic_weights(rng, N_FULL, N_FULL, dev)
    else:
        bag = torch.from_numpy((rng.rand(N_FULL) < 0.9).astype(np.float32)) \
            .to(dev)
        if kind == "quant":
            g = rng.randint(-7, 8, N_FULL) * 2.0 ** -6
            h = rng.randint(0, 16, N_FULL) * 2.0 ** -8
        else:
            g, h = rng.randn(N_FULL), rng.rand(N_FULL)
        g, h = (torch.from_numpy(a.astype(np.float32)).to(dev)
                for a in (g, h))
    w = torch.stack([g * bag, h * bag, bag]).contiguous()
    slot = rng.randint(-1, k + 1, N_FULL).astype(np.int32)
    return words, w, torch.from_numpy(slot).to(dev)


def phase_multislot(ctx) -> None:
    from lightgbm_tpu_torch.ops.hist_multislot import (
        build_histogram_multislot, build_histogram_multislot_plain)

    out = {"phase": "multislot", "Fw": FW, "N": N_FULL,
           "num_bins": NUM_BINS}
    for k in (1, 3, MULTI_K, 64):
        words, w, slot = multislot_inputs(20 + k, "dyadic", k)
        a = build_histogram_multislot(words, w, slot, num_bins=NUM_BINS,
                                      n_slots=k)
        p = build_histogram_multislot_plain(words, w, slot,
                                            num_bins=NUM_BINS, n_slots=k)
        check(torch.equal(a, p), f"multislot dyadic K={k}: kernel != plain "
              f"(max diff {(a - p).abs().max().item()})")
        out[f"dyadic_K{k}_bitwise"] = True
    # the dataset's padding features (one code in every row)
    for kind in ("dyadic", "quant"):
        words, w, slot = multislot_inputs(45, kind, MULTI_K, pad=True)
        a = build_histogram_multislot(words, w, slot, num_bins=NUM_BINS,
                                      n_slots=MULTI_K, quant=kind == "quant")
        p = build_histogram_multislot_plain(words, w, slot,
                                            num_bins=NUM_BINS,
                                            n_slots=MULTI_K,
                                            quant=kind == "quant")
        check(torch.equal(a, p), f"multislot {kind} with constant padding "
              f"features: kernel != plain")
        out[f"{kind}_K16_padding_features_bitwise"] = True
    k = MULTI_K
    words, w, slot = multislot_inputs(41, "random", k, pad=True)
    a = build_histogram_multislot(words, w, slot, num_bins=NUM_BINS,
                                  n_slots=k)
    a2 = build_histogram_multislot(words, w, slot, num_bins=NUM_BINS,
                                   n_slots=k)
    p = build_histogram_multislot_plain(words, w, slot, num_bins=NUM_BINS,
                                        n_slots=k)
    check(torch.equal(a, a2), "multislot random: two launches differ")
    mass = build_histogram_multislot_plain(words, w.abs(), slot,
                                           num_bins=NUM_BINS, n_slots=k)
    err = (a - p).abs()
    lim = 1e-5 * p.abs() + 1e-5 * mass
    check(bool((err <= lim).all()),
          f"multislot random: kernel vs plain beyond rtol=1e-5, atol=1e-5*"
          f"(the bin's sum of |w|) (max diff {err.max().item()})")
    nz = lim > 0
    out["random_K16"] = {"max_abs_err": err.max().item(),
                         "worst_err_to_limit": (err[nz] / lim[nz]).max()
                         .item(), "relaunch_bitwise": True}
    ctx["err_multislot"] = err.max().item()
    words, w, slot = multislot_inputs(42, "quant", k)
    a = build_histogram_multislot(words, w, slot, num_bins=NUM_BINS,
                                  n_slots=k, quant=True)
    p = build_histogram_multislot_plain(words, w, slot, num_bins=NUM_BINS,
                                        n_slots=k, quant=True)
    check(torch.equal(a, p), "multislot quant: kernel != plain")
    check(torch.equal(a[..., 2], a[..., 1]),
          "multislot quant: channel 2 is not the hessian lane's sum")
    out["quant_K16_bitwise"] = True
    torch.cuda.synchronize()
    emit(out)


#: the dataset's padded code rows at 28 features (features pad to 8)
CODE_ROWS = 32


def full_inputs(seed: int, dtype, num_bins: int, kind: str, n: int = N_FULL,
                f: int = FEATURES, code_max=None):
    """A (32, n) uint8 or uint16 code matrix whose first ``f`` rows are
    passed as the masked learner passes the used features (a view with the
    padded row stride), and (3, n) weights: dyadic or random float32."""
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, code_max or num_bins, size=(CODE_ROWS, n)) \
        .astype(dtype)
    bins = torch.from_numpy(codes).to(dev)[:f]
    if kind == "dyadic":
        g, h, bag = dyadic_weights(rng, n, n, dev)
    else:
        bag = torch.from_numpy((rng.rand(n) < 0.9).astype(np.float32)) \
            .to(dev)
        g, h = (torch.from_numpy(a.astype(np.float32)).to(dev)
                for a in (rng.randn(n), rng.rand(n)))
    return bins, torch.stack([g * bag, h * bag, bag]).contiguous()


def phase_hist_full(ctx) -> None:
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full
    from lightgbm_tpu_torch.ops.histogram import (build_histogram_onehot,
                                                  read_codes)

    out = {"phase": "hist_full", "F": FEATURES, "code_rows": CODE_ROWS,
           "N": N_FULL}
    worst = 0.0
    for dtype, b in ((np.uint16, MASKED_BINS), (np.uint8, NUM_BINS)):
        tag = f"{np.dtype(dtype).name}_B{b}"
        bins, w = full_inputs(50 + b, dtype, b, "dyadic")
        k = build_histogram_full(bins, w, num_bins=b)
        p = build_histogram_onehot(bins, w, num_bins=b)
        check(torch.equal(k, p), f"hist_full dyadic {tag}: kernel != plain "
              f"(max diff {(k - p).abs().max().item()})")
        bins, w = full_inputs(60 + b, dtype, b, "random")
        k = build_histogram_full(bins, w, num_bins=b)
        k2 = build_histogram_full(bins, w, num_bins=b)
        p = build_histogram_onehot(bins, w, num_bins=b)
        check(torch.equal(k, k2), f"hist_full {tag}: two launches differ")
        # float32 sums in two orders: each bin's rounding error is bounded
        # by the bin's own absolute mass
        mass = build_histogram_onehot(bins, w.abs(), num_bins=b)
        err = (k - p).abs()
        lim = 1e-5 * p.abs() + 1e-5 * mass
        check(bool((err <= lim).all()),
              f"hist_full random {tag}: kernel vs plain beyond rtol=1e-5, "
              f"atol=1e-5*(the bin's sum of |w|) (max diff "
              f"{err.max().item()})")
        nz = lim > 0
        out[tag] = {"dyadic_bitwise": True, "relaunch_bitwise": True,
                    "random_max_abs_err": err.max().item(),
                    "random_worst_err_to_limit":
                        (err[nz] / lim[nz]).max().item()}
        worst = max(worst, err.max().item())
    # codes at or past num_bins are dropped: uint16 codes up to 1,099
    b = MASKED_BINS
    bins, w = full_inputs(70, np.uint16, b, "dyadic", code_max=1100)
    k = build_histogram_full(bins, w, num_bins=b)
    check(torch.equal(k, build_histogram_onehot(bins, w, num_bins=b)),
          "hist_full: dropped codes differ from the plain version")
    kept = ((read_codes(bins) < b) * w[2]).sum(dim=1)
    check(torch.equal(k[..., 2].sum(dim=1), kept),
          "hist_full: codes at or past num_bins were counted")
    out["dropped_codes"] = int((read_codes(bins) >= b).sum())
    # past one shared-memory bin tile (1,024 bins), and the widest uint16
    for b, n, f in ((2047, 65_536, FEATURES), (65_536, 8_192, 5)):
        bins, w = full_inputs(80, np.uint16, b, "dyadic", n=n, f=f)
        k = build_histogram_full(bins, w, num_bins=b)
        p = build_histogram_onehot(bins, w, num_bins=b)
        check(torch.equal(k, p), f"hist_full dyadic at {b} bins, {n} rows: "
              f"kernel != plain")
        out[f"dyadic_B{b}_N{n}_bitwise"] = True
    torch.cuda.synchronize()
    ctx["err_hist_full"] = worst
    emit(out)


def fused_inputs(seed: int, exact: bool, k: int = FUSED_K,
                 f: int = FEATURES, b: int = NUM_BINS, h: int = POOL_H):
    """One growth wave's fused step at the bench width: smaller-child and
    sibling histograms (quant-grid values when ``exact``, else random
    float32; the count channel the hessian times 4.0), the pool with each
    member's parent in its own slot, fresh right-child slots, the child
    totals (feature 0's sums, interleaved [l0, r0, ...]) and the feature
    metadata.  Returns CPU tensors."""
    rng = np.random.RandomState(seed)
    num_bin = rng.randint(2, b + 1, size=f).astype(np.int32)
    missing = rng.randint(0, 3, size=f).astype(np.int32)
    default_bin = (rng.randint(0, 100, size=f) % num_bin).astype(np.int32)
    bm = (np.arange(b)[None, :] < num_bin[:, None])[None, :, :, None]

    def hist():
        if exact:
            g = rng.randint(-7 * 400, 7 * 400 + 1, (k, f, b)) * 2.0 ** -6
            hh = rng.randint(0, 15 * 400 + 1, (k, f, b)) * 2.0 ** -8
        else:
            g = rng.randn(k, f, b) * 20
            hh = rng.rand(k, f, b) * 20
        return (np.stack([g, hh, hh * 4.0], -1) * bm).astype(np.float32)

    h_small, h_other = hist(), hist()
    left_small = rng.rand(k) < 0.5
    lsm = left_small[:, None, None, None]
    hl = np.where(lsm, h_small, h_other)
    hr = np.where(lsm, h_other, h_small)
    tot = np.stack([hl[:, 0].astype(np.float64).sum(1),
                    hr[:, 0].astype(np.float64).sum(1)], 1) \
        .reshape(2 * k, 3).astype(np.float32)
    slots = rng.permutation(h)
    ph, rh = slots[:k].astype(np.int64), slots[k:2 * k].astype(np.int64)
    pool = rng.randn(h, f, b, 3).astype(np.float32)
    pool[ph] = h_small + h_other
    fmask = rng.rand(f) < 0.9
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (h_small, pool, ph, rh, left_small, tot[:, 0], tot[:, 1],
             tot[:, 2], num_bin, missing, default_bin, fmask)]


def unfused_step(h_small, pool, ph, rh, left_small, sg2, sh2, n2, num_bin,
                 missing, default_bin, fmask, **kw):
    """The wave learner's unfused step on the card: torch subtraction,
    selection and pool writes, ``fix_histogram``, the split-scan kernel."""
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched
    from lightgbm_tpu_torch.ops.split import fix_histogram

    k = h_small.shape[0]
    h_large = pool.index_select(0, ph) - h_small
    lsm = left_small.view(k, 1, 1, 1)
    hl = torch.where(lsm, h_small, h_large)
    hr = torch.where(lsm, h_large, h_small)
    pool.index_copy_(0, ph, hl)
    pool.index_copy_(0, rh, hr)
    h2 = torch.stack([hl, hr], 1).reshape((2 * k,) + hl.shape[1:])
    h2 = fix_histogram(h2, sg2, sh2, n2, default_bin)
    return find_best_splits_batched(h2, sg2, sh2, n2, num_bin, missing,
                                    default_bin, fmask, **kw)


def phase_fused_scan(ctx) -> None:
    from lightgbm_tpu_torch.ops.fused_scan import (fused_child_scans,
                                                   fused_child_scans_plain)

    dev = torch.device("cuda", 0)
    kw = dict(SCAN_KW, lambda_l1=0.0)
    out = {"phase": "fused_scan", "K": FUSED_K, "F": FEATURES,
           "B": NUM_BINS, "pool_slots": POOL_H}
    for tag, exact in (("quant_grid", True), ("random", False)):
        cpu = fused_inputs(30 + exact, exact)
        args = [t.to(dev) for t in cpu]
        pools = {n: args[1].clone() for n in ("kernel", "ref")}
        k = fused_child_scans(args[0], pools["kernel"], *args[2:], **kw)
        pool_cpu = cpu[1].clone()
        ref_cpu = fused_child_scans_plain(cpu[0], pool_cpu, *cpu[2:], **kw)
        check(all(same(getattr(k, fl).cpu(), getattr(ref_cpu, fl))
                  for fl in k._fields),
              f"fused {tag}: kernel differs from the plain version run on "
              f"the CPU")
        check(torch.equal(pools["kernel"].cpu(), pool_cpu),
              f"fused {tag}: pool differs from the CPU plain version")
        if exact:
            ref = fused_child_scans_plain(args[0], pools["ref"], *args[2:],
                                          **kw)
        else:
            ref = unfused_step(args[0], pools["ref"], *args[2:], **kw)
        for fl in k._fields:
            check(same(getattr(k, fl), getattr(ref, fl)),
                  f"fused {tag}: field {fl} differs from the "
                  f"{'plain version' if exact else 'unfused step'}")
        check(torch.equal(pools["kernel"], pools["ref"]),
              f"fused {tag}: pool rows differ")
        fin = torch.isfinite(k.gain)
        out[tag] = {"fields_bitwise": True, "pool_bitwise": True,
                    "feasible": int(fin.sum()),
                    "against": "plain version on the CPU, and the "
                    + ("plain version" if exact else "unfused step")
                    + " on the card"}
    ctx["err_fused"] = 0.0
    torch.cuda.synchronize()
    emit(out)


def replay_forest(rng, grown: int, positive: bool = False):
    """A random grown forest in REPLAY_M node slots as the wave learner
    holds it (float32 gain, split flag, left child, window width; CPU
    tensors) and its node count: ``grown`` splits of random unsplit
    positive-gain nodes, gains drawn from REPLAY_GAINS (only its positive
    values with ``positive``)."""
    m = REPLAY_M
    vals = REPLAY_GAINS[2:] if positive else REPLAY_GAINS
    gain = np.full(m, -np.inf, np.float32)
    split = np.zeros(m, bool)
    child0 = np.zeros(m, np.int64)
    width = np.zeros(m, np.int64)
    gain[0], width[0] = rng.choice(REPLAY_GAINS[2:]), N_FULL
    nn = 1
    for _ in range(grown):
        free = np.flatnonzero(~split[:nn] & (gain[:nn] > 0))
        if free.size == 0 or nn + 2 > m:
            break
        nn = split_node(rng, (gain, split, child0, width), int(rng.choice(
            free)), nn, vals)
    return [torch.from_numpy(a) for a in (gain, split, child0, width)], nn


def replay_ordered_forest(rng, m: int, grown: int, holes: float,
                          vals=REPLAY_GAINS[2:]):
    """A forest in ``m`` node slots grown in the replay's own order (gain
    desc, leaf index asc: the replay pops long runs), ``grown`` splits,
    each popped node left unsplit with probability ``holes`` (a stall);
    children's gains drawn from ``vals``, those of positive gain pushed.
    As ``replay_forest``."""
    import heapq

    gain = np.full(m, -np.inf, np.float32)
    split = np.zeros(m, bool)
    child0 = np.zeros(m, np.int64)
    width = np.full(m, N_FULL, np.int64)
    gain[0] = vals[-1]
    heap, nn, leaves = [(-float(gain[0]), 0, 0)], 1, 1
    while heap and nn < 1 + 2 * grown:
        _, ref, s = heapq.heappop(heap)
        if rng.rand() < holes:
            continue
        split[s], child0[s] = True, nn
        gain[nn:nn + 2] = rng.choice(vals, 2)
        for c, r in ((nn, ref), (nn + 1, leaves)):
            if gain[c] > 0:
                heapq.heappush(heap, (-float(gain[c]), r, c))
        nn, leaves = nn + 2, leaves + 1
    return [torch.from_numpy(a) for a in (gain, split, child0, width)], nn


def split_node(rng, tab, s: int, nn: int, vals) -> int:
    """Give node ``s`` children at slots nn, nn + 1 (random gains from
    ``vals``, a random cut of its width); returns the new node count."""
    gain, split, child0, width = tab
    split[s] = True
    child0[s] = nn
    gain[nn:nn + 2] = torch.from_numpy(rng.choice(vals, 2)
                                       .astype(np.float32))
    lw = int(rng.randint(0, int(width[s]) + 1))
    width[nn] = lw
    width[nn + 1] = int(width[s]) - lw
    return nn + 2


def replay_state(dev=None, m: int = REPLAY_M, b: int = REPLAY_BUDGET):
    """A replay's carried state before its first pass (ops/replay.py)."""
    from lightgbm_tpu_torch.ops.replay import NUM_CTL

    kb = REPLAY_KB
    avail = torch.zeros(m, dtype=torch.uint8)
    avail[0] = 1
    refidx = torch.full((m,), -1, dtype=torch.int32)
    refidx[0] = 0
    st = [avail, refidx, torch.zeros((b, 2), dtype=torch.int32),
          torch.zeros(NUM_CTL, dtype=torch.int32),
          torch.zeros(kb, dtype=torch.int64),
          torch.zeros(kb, dtype=torch.bool)]
    return [t.to(dev) for t in st] if dev is not None else st


REPLAY_KW = dict(budget=REPLAY_BUDGET, stall_batch=REPLAY_KB, extras_cap=64,
                 vec_cap=1 << 17, pad_slot=REPLAY_M)


def replay_to_end(rng, tab, nn: int, cpu, kw, card=None,
                  vals=REPLAY_GAINS) -> int:
    """Run replay passes of the plain version on the CPU state ``cpu``
    (and of the kernel on ``card``, checked bitwise after every pass) over
    the node table ``tab``, splitting each stall's members as a correction
    does (children's gains drawn from ``vals``), until the replay ends;
    returns the passes."""
    from lightgbm_tpu_torch.ops.replay import (CTL_FLAG, FLAG_DONE,
                                               replay_pass, replay_pass_plain)

    passes = 0
    while True:
        replay_pass_plain(*tab, *cpu, **kw)
        if card is not None:
            replay_pass(*[t.to(card[0].device) for t in tab], *card, **kw)
            check(all(torch.equal(a, b.cpu()) for a, b in zip(cpu, card)),
                  f"replay pass {passes + 1}: the kernel's state differs "
                  f"from the plain version's")
        passes += 1
        if int(cpu[3][CTL_FLAG]) == FLAG_DONE:
            return passes
        check(passes <= kw["budget"] + 1, "the replay did not end")
        for s in cpu[4][cpu[5]].tolist():
            nn = split_node(rng, tab, s, nn, vals)


def phase_replay(ctx) -> None:
    from lightgbm_tpu_torch.ops.replay import (CTL_POPS, CTL_STALL_EVENTS,
                                               replay_plan)

    dev = torch.device("cuda", 0)
    out = {"phase": "replay", "M": REPLAY_M, "budget": REPLAY_BUDGET,
           "stall_batch": REPLAY_KB, "cases": {}}
    # half grown: many stalls; grown to the growth budget: fewer
    for tag, seed, grown, vec_cap in (("half_grown", 1, 127, 1 << 17),
                                      ("half_grown_vec_cap", 2, 127, 5000),
                                      ("grown", 3, REPLAY_BUDGET, 1 << 17)):
        rng = np.random.RandomState(seed)
        tab, nn = replay_forest(rng, grown)
        cpu = replay_state()
        card = [t.to(dev) for t in cpu]
        passes = replay_to_end(rng, tab, nn, cpu, dict(REPLAY_KW,
                                                       vec_cap=vec_cap),
                               card)
        out["cases"][tag] = {"passes": passes,
                             "pops": int(cpu[3][CTL_POPS]),
                             "stalls": int(cpu[3][CTL_STALL_EVENTS]),
                             "state_bitwise_every_pass": True}
    # the large trees: every placement of the kernel's buffers
    for seed, leaves in enumerate(REPLAY_LARGE, 4):
        m, b = replay_dims(leaves)
        rng = np.random.RandomState(seed)
        tab, nn = replay_ordered_forest(rng, m, b, holes=0.002)
        cpu = replay_state(m=m, b=b)
        card = [t.to(dev) for t in cpu]
        kw = dict(REPLAY_KW, budget=b, pad_slot=m)
        passes = replay_to_end(rng, tab, nn, cpu, kw, card,
                               vals=REPLAY_GAINS[2:])
        pops = int(cpu[3][CTL_POPS])
        check(pops == b, f"the {leaves}-leaf replay made {pops} pops")
        plan = replay_plan(m, b)
        out["cases"][f"num_leaves_{leaves}"] = {
            "M": m, "budget": b, "passes": passes, "pops": pops,
            "stalls": int(cpu[3][CTL_STALL_EVENTS]),
            "list_in_shared_memory": plan.list_smem,
            "table_in_shared_memory": plan.tab_smem,
            "state_bitwise_every_pass": True}
    torch.cuda.synchronize()
    ctx["err_replay"] = 0.0
    emit(out)


CAT_K = 128         # children of a full growth wave
CAT_F = 8           # features of the fixture, six of them categorical
CAT_COLS = (0, 1, 2, 4, 5, 7)
#: the fixture's kwarg regimes (defaults; a tight category cap; no group
#: bookkeeping; a cat_smooth that leaves no bin eligible)
CAT_REGIMES = {"defaults": {},
               "max_cat_threshold_3": {"max_cat_threshold": 3},
               "min_data_per_group_1": {"min_data_per_group": 1},
               "none_eligible": {"cat_smooth": 1e9}}
#: the fixture's widths: the kernel's sort paths by eligible keys (a
#: register bitonic sort up to 2,048, through shared memory past it, cut
#: rounds past 8,192)
CAT_WIDTHS = (256, 1023, 2047, 4096, 10000)
CAT_KW = dict(lambda_l1=0.0, lambda_l2=0.5, max_delta_step=0.0,
              min_data_in_leaf=3, min_sum_hessian_in_leaf=1e-3,
              min_gain_to_split=0.0)


def split_cat_inputs(seed: int, dyadic: bool, k: int = CAT_K,
                     b: int = 256):
    """A (K, 8, B, 3) histogram cube whose six categorical columns cover the
    regimes: column 0 one-hot (4 bins), 1 many-vs-many over every bin, 2
    NaN-typed (its last bin outside the scan), 4 with two bins of equal CTR
    (bins 3 and 7: g / (h + 10) = 0.5 in every leaf), 5 Zero-missing, 7
    many-vs-many; columns 3 and 6 are numerical.  Dyadic: bins on a 1/64
    grid, totals from column 1 (every sum exact).  Random: the histograms
    of 16,384 random rows per leaf."""
    rng = np.random.RandomState(seed)
    f = CAT_F
    num_bin = np.array([4, b, 60, b, 40, 100, b, min(b, 300)], np.int32)
    missing = np.array([0, 0, 2, 0, 0, 1, 0, 0], np.int32)
    if dyadic:
        gen = (lambda s: (rng.randint(-(1 << 12), 1 << 12, size=s) / 64.0)
               .astype(np.float32))
        hg = gen((k, f, b))
        hh = np.abs(gen((k, f, b))) + 0.25
        hc = rng.randint(0, 400, size=(k, f, b)).astype(np.float32)
        hist = np.stack([hg, hh, hc], axis=-1)
    else:
        rows = 16384
        w = np.stack([rng.randn(k, rows), rng.rand(k, rows),
                      np.ones((k, rows))]).astype(np.float32)
        codes = (rng.rand(k, f, rows) * num_bin[None, :, None]) \
            .astype(np.int64)
        flat = ((np.arange(k)[:, None, None] * f
                 + np.arange(f)[None, :, None]) * b + codes).reshape(-1)
        hist = np.stack([np.bincount(
            flat, weights=np.broadcast_to(w[c][:, None, :], codes.shape)
            .reshape(-1), minlength=k * f * b) for c in range(3)], -1) \
            .reshape(k, f, b, 3).astype(np.float32)
    hist *= (np.arange(b)[None, :] < num_bin[:, None])[None, :, :, None]
    hist[:, 4, 3] = [15.0, 20.0, 300.0]
    hist[:, 4, 7] = [25.0, 40.0, 300.0]
    sums = hist[:, 1].astype(np.float64).sum(axis=1)            # (K, 3)
    fmask = np.ones(f, bool)
    return [torch.from_numpy(np.asarray(a)) for a in
            (hist, sums[:, 0].astype(np.float32),
             sums[:, 1].astype(np.float32), sums[:, 2].astype(np.float32),
             num_bin, missing, fmask)]


def _cat_start(args):
    """The fields split_cat writes into: the numerical scan's (the plain
    version, any width) of every column, and zero bitsets."""
    from lightgbm_tpu_torch.ops.split import find_best_splits
    from lightgbm_tpu_torch.ops.split_cat import cat_words

    hist, sg, sh, cnt, num_bin, missing, fmask = args
    num = find_best_splits(hist, sg, sh, cnt, num_bin, missing,
                           torch.zeros_like(num_bin), fmask, **CAT_KW)
    k, f, b, _ = hist.shape
    bits = torch.zeros((k, f, cat_words(b)), dtype=torch.int32,
                       device=hist.device)
    return num, bits


def _cat_run(fn, args, start, kw, con=()):
    """``fn`` on copies of ``start``'s fields; ``con`` the constrained
    call's (min_c, max_c, penalty)."""
    num, bits = start
    num = type(num)(*(t.clone() for t in num))
    bits = bits.clone()
    cols = torch.tensor(CAT_COLS, dtype=torch.int32, device=bits.device)
    fn(num, bits, *args, cols, *con, **dict(CAT_KW, **kw))
    return num, bits


def _cat_same(a, b) -> bool:
    return all(same(x.cpu(), y.cpu()) for x, y in zip(a[0], b[0])) \
        and torch.equal(a[1].cpu(), b[1].cpu())


def phase_split_cat(ctx) -> None:
    from lightgbm_tpu_torch.ops.split_cat import (
        categorical_candidates, categorical_candidates_plain)

    dev = torch.device("cuda", 0)
    n0 = categorical_candidates.launches
    out = {"phase": "split_cat", "K": CAT_K, "F": CAT_F,
           "categorical_columns": list(CAT_COLS), "cases": {}}
    # a (K, F) mask that drops column 5 in every other leaf
    kf_mask = torch.ones(CAT_K, CAT_F, dtype=torch.bool)
    kf_mask[1::2, 5] = False
    cols = list(CAT_COLS)
    for b in CAT_WIDTHS:
        for tag, dyadic in (("dyadic", True), ("random", False)):
            if b > 2047 and not dyadic:
                # 16,384 random rows a leaf leave few bins of so wide a
                # column at cnt >= cat_smooth: the dyadic counts fill it
                continue
            cpu = split_cat_inputs(7 if dyadic else 8, dyadic, b=b)
            eligible = int((cpu[0][:, 1, :, 2] >= 10.0).sum(-1).max())
            if dyadic:
                # column 1's eligible bins reach the sort path of the width
                check(eligible > {256: 128, 1023: 512, 2047: 1024,
                                  4096: 2048, 10000: 8192}[b],
                      f"split_cat B={b}: {eligible} eligible bins")
            for regime, kw in CAT_REGIMES.items():
                for mname, m in (("fmask_F", None), ("fmask_KF", kf_mask)):
                    if m is not None and regime != "defaults":
                        continue
                    ca = cpu[:6] + [cpu[6] if m is None else m]
                    card = [t.to(dev) for t in ca]
                    # the same start on both devices: the card's numerical
                    # scan, whose columns split_cat carries
                    sk = _cat_start(card)
                    sc = (type(sk[0])(*(t.cpu() for t in sk[0])),
                          sk[1].cpu())
                    k = _cat_run(categorical_candidates, card, sk, kw)
                    k2 = _cat_run(categorical_candidates, card, sk, kw)
                    pc = _cat_run(categorical_candidates_plain, ca, sc, kw)
                    where = f"split_cat B={b} {tag} {regime} {mname}"
                    check(_cat_same(k, pc), f"{where}: kernel differs from "
                          f"the plain version run on the CPU")
                    check(_cat_same(k, k2), f"{where}: two launches differ")
                    if dyadic:
                        pk = _cat_run(categorical_candidates_plain, card, sk,
                                      kw)
                        check(_cat_same(k, pk), f"{where}: kernel differs "
                              f"from the plain version on the card")
                    gain, bits = k[0].gain[:, cols], k[1][:, cols]
                    case = {"eligible_bins_max": eligible,
                            "valid_splits": int(torch.isfinite(gain).sum()),
                            "nonzero_bitsets": int((bits != 0).any(-1).sum()),
                            "cpu_plain_bitwise": True,
                            "card_plain_bitwise": True if dyadic else None}
                    if regime == "none_eligible":
                        # only the one-hot column (0) can split
                        check(not torch.isfinite(gain[:, 1:]).any(),
                              f"{where}: a many-vs-many split with no "
                              f"eligible bin")
                    if regime == "defaults" and m is None:
                        check(bool(torch.isfinite(gain).any(0).all()),
                              f"{where}: a column splits in no leaf")
                        nan_bin = 59                 # column 2's last bin
                        check(not ((bits[:, 2, nan_bin // 32]
                                    >> (nan_bin % 32)) & 1).any(),
                              f"{where}: the NaN bin is in a bitset")
                    out["cases"][f"B{b}/{tag}/{regime}/{mname}"] = case
            if b != 256:
                continue
            # the constrained launch: per-leaf bounds and the penalty
            card = [t.to(dev) for t in cpu]
            sk = _cat_start(card)
            sc = (type(sk[0])(*(t.cpu() for t in sk[0])), sk[1].cpu())
            _, mn, mx, pen = scan_constraints(CAT_K, CAT_F, 9)
            where = f"split_cat B={b} {tag} constrained"
            c0 = categorical_candidates.con_launches
            k = _cat_run(categorical_candidates, card, sk, {},
                         tuple(t.to(dev) for t in (mn, mx, pen)))
            check(categorical_candidates.con_launches == c0 + 1,
                  f"{where}: not a constrained launch")
            pc = _cat_run(categorical_candidates_plain, cpu, sc, {},
                          (mn, mx, pen))
            check(_cat_same(k, pc), f"{where}: kernel differs from the "
                  f"plain version run on the CPU")
            free = _cat_run(categorical_candidates, card, sk, {})
            out_c = k[0].left_output[:, cols]
            check(not _cat_same(k, free), f"{where}: the bounds bind nowhere")
            band = ((mn > -1.0) & (mx < 1.0)).to(dev)[:, None] \
                & torch.isfinite(
                k[0].gain[:, cols])
            check(bool((out_c[band].abs() <= 0.05).all()),
                  f"{where}: an output outside its leaf's band")
            out["cases"][f"B{b}/{tag}/constrained"] = {
                "cpu_plain_bitwise": True,
                "valid_splits": int(torch.isfinite(
                    k[0].gain[:, cols]).sum())}
    categorical_candidates.launches = n0
    torch.cuda.synchronize()
    ctx["err_split_cat"] = 0.0
    emit(out)


#: bin_predict's shapes: the bench's held-out matrix at 255 and 1,023 bins,
#: the Expo-shaped categorical rows, a bounds row too wide to stage (9,999
#: bounds: the search in global memory), the reference's whole Higgs set
#: scored at once, and MS LTR's width (more than one feature group)
BIN_SHAPES = (("higgs_255", 255), ("expo_categorical", 255),
              ("higgs_1023", 1023), ("global_bounds_10000", 10000),
              ("higgs_11m", 255), ("ms_ltr_137", 255))
#: training rows the mappers of a bin_predict case are fitted on
BIN_FIT_ROWS = 10_000
#: predict rows of a bin_predict case
BIN_ROWS = {"higgs_11m": 11_000_000}


def bin_predict_case(tag: str, max_bin: int, rows: int = None):
    """Mappers fitted on 10,000 training rows at ``max_bin`` (host FindBin
    costs about a second per 100,000 distinct values of a feature) and a
    raw predict matrix of ``rows`` rows (``BIN_ROWS``, else 100,000)
    holding the hard values: NaN (column 2 trains with NaN, so it has a NaN
    bin), +-inf, -0.0, 1e30, every bin bound and its neighbours one ulp
    away; for the Expo rows unseen (300 to 400), negative and fractional
    categories and NaN.  ``higgs_11m`` draws its 11,000,000 predict rows
    with numpy's faster ``default_rng``; ``ms_ltr_137`` takes the first rows of
    ``ms_ltr_like``'s matrix, and ``ms_ltr_137_cat`` makes every tenth of
    its columns categorical (integer codes 0 to 59)."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import _ConstructedDataset

    rows = rows or BIN_ROWS.get(tag, VALID_ROWS)
    n = BIN_FIT_ROWS + rows
    # no EFB: its exclusivity scan is set-up time, and predict binning
    # reads the mappers only
    params = {"max_bin": max_bin, "verbosity": -1, "enable_bundle": False}
    cat = []
    if tag == "expo_categorical":
        X, _ = expo_like(n, seed=12)
        cat = [int(c) for c in EXPO_CATEGORICAL.split(",")]
    elif tag == "global_bounds_10000":
        X = np.round(higgs_like(n, seed=13)[0][:, :4], 4)
        params["min_data_in_bin"] = 1
    elif tag == "higgs_11m":
        X = np.concatenate([
            higgs_like(BIN_FIT_ROWS, seed=13)[0],
            np.random.default_rng(13).standard_normal((rows, FEATURES))])
    elif tag.startswith("ms_ltr_137"):
        # ms_ltr_like's draws, row by row: its first n rows
        X = np.random.RandomState(13).randn(n, RANK_FEATURES).astype(
            np.float32).astype(np.float64)
        if tag == "ms_ltr_137_cat":
            cat = list(range(0, RANK_FEATURES, 10))
            X[:, cat] = np.floor((X[:, cat] + 3.0) * 10.0).clip(0, 59)
    else:
        X, _ = higgs_like(n, seed=13)
    train, Xp = X[:BIN_FIT_ROWS].copy(), X[BIN_FIT_ROWS:]
    del X
    train[::11, 2] = np.nan
    data = _ConstructedDataset.from_matrix(train, Config.from_params(params),
                                           categorical=cat)
    rng = np.random.RandomState(17)
    r = 0
    for k, j in enumerate(data.used_feature_map):
        m = data.bin_mappers[k]
        if j in cat:
            vals = np.array([np.nan, -1.0, -0.5, -0.0, 0.5, 2.7, 300.0,
                             350.25, 400.0, 1e30, np.inf, -np.inf, -7.0])
        else:
            b = np.asarray(m.bin_upper_bound, np.float64)
            b = b[np.isfinite(b)]
            vals = np.concatenate([[np.nan, np.inf, -np.inf, -0.0, 0.0,
                                    1e30, -1e30], b, np.nextafter(b, np.inf),
                                   np.nextafter(b, -np.inf)])
        # distinct rows (a permutation of 11M rows takes seconds a column)
        idx = np.unique(rng.randint(0, rows, 4 * len(vals)))[:len(vals)] \
            if rows > 1_000_000 else rng.choice(rows, len(vals),
                                                replace=False)
        Xp[idx, j] = vals
        r += len(vals)
    return data, Xp, r


def _bin_bytes(a, n: int) -> float:
    """What one binning call must move: each used column read once, the
    tables (metadata, the bounds rows at their own width, without the
    kernel's +inf padding, category tables) once, every code written
    once."""
    tables = a.meta.numel() * 4 + a.meta.shape[0] * a.num_bounds * 8 \
        + a.cat_lut.numel() * 4
    return n * a.fu * 8 + tables + a.f_pad * n * 4


def _time_bin_predict(x, a, flush, reps: int = 20,
                      device: bool = False) -> dict:
    """One bin_predict shape timed: the wrapper, the kernel alone (its
    staged replay), the plain version and torch.searchsorted on the
    numerical part, against the bound; with ``device`` the kernel's
    device time too (one profiler window, as before: the later phases'
    profiled trees have lost records in a long process;
    profiling/profile_bin_predict.py records every shape's device time in
    a process of its own)."""
    from lightgbm_tpu_torch.binner import M_COL, bin_plain, bin_predict

    n = x.shape[0]
    v = x.index_select(1, a.meta[:a.fu, M_COL].long()).T.contiguous()
    bounds = a.bounds[:a.fu].contiguous()
    call = (lambda: bin_predict(x, a))
    out = dict(
        ms=cuda_ms(call, reps, flush),
        kernel_ms=cuda_ms(staged(call), reps, flush),
        device_ms=_device_ms(call, "bin_predict_rows") if device else None,
        plain_ms=cuda_ms(lambda: bin_plain(x, a), min(reps, 5), flush),
        library_ms=cuda_ms(lambda: torch.searchsorted(bounds, v,
                                                      side="left"),
                           reps, flush),
        rows=n, **_bound(_bin_bytes(a, n), 0))
    del v
    return out


def _bin_host_chunks(arrs, X, chunk: int = 500_000):
    """``bin_host`` of ``X`` over row chunks in threads (numpy's searches
    let go of the interpreter lock): the same codes in a fraction of the
    time at 11,000,000 rows."""
    from concurrent.futures import ThreadPoolExecutor

    if len(X) <= chunk:
        return arrs.bin_host(X)
    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(arrs.bin_host, (X[r:r + chunk] for r in
                                              range(0, len(X), chunk))))
    return np.concatenate(parts, axis=1)


def phase_bin_predict(ctx) -> None:
    from lightgbm_tpu_torch.binner import (BinnerArrays, bin_plain,
                                           bin_predict, plan_for)
    from lightgbm_tpu_torch.dataset import upload

    dev = torch.device("cuda", 0)
    n0 = bin_predict.launches
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {"phase": "bin_predict", "cases": {},
           "nvidia_smi": ctx.get("smi")}
    for tag, max_bin in BIN_SHAPES:
        t0 = time.perf_counter()
        data, Xp, hard = bin_predict_case(tag, max_bin)
        arrs = BinnerArrays.for_data(data)
        a = arrs.device_arrays(dev)
        # a pageable copy: upload() would leave its pinned block (2.5 GB
        # at 11,000,000 rows) cached in the process for the later phases
        x = torch.from_numpy(Xp).to(dev)
        got = bin_predict(x, a)
        again = bin_predict(x, a)
        plain = bin_plain(x, a)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"{tag}: kernel != plain on the card")
        check(torch.equal(got, again), f"{tag}: two launches differ")
        del plain, again
        check(np.array_equal(got.cpu().numpy(), _bin_host_chunks(arrs, Xp)),
              f"{tag}: kernel != bin_host")
        del got
        plan = plan_for(x, a)
        case = {"rows": len(Xp), "fu": a.fu, "f_pad": a.f_pad,
                "B": arrs.bounds.shape[1], "W": a.bounds.shape[1],
                "C": a.cat_lut.shape[1], "hard_values": hard,
                "bitwise": True,
                "plan": {k: getattr(plan, k) for k in (
                    "rows", "staged", "group", "groups", "tile_rows",
                    "tiles", "stages", "stripes", "grid", "smem",
                    "moved_bytes", "bound_bytes")}}
        case["timing"] = _time_bin_predict(x, a, flush,
                                           device=tag == "higgs_255")
        if tag == "higgs_255":
            host_x = x.cpu().numpy()
            case["timing"]["upload_ms"] = cuda_ms(
                lambda: upload(host_x, dev), 5, flush)
            ctx["timing_bin_predict"] = dict(
                case["timing"],
                library="torch.searchsorted over the (fu, W) bounds and "
                        "the (fu, n) values, the numerical part alone",
                shapes={})
        case["phase_s"] = time.perf_counter() - t0
        out["cases"][tag] = case
        emit({"phase": "bin_predict", "case": tag, **case})
        del x, Xp, data, arrs, a
        torch.cuda.empty_cache()
    ctx["err_bin_predict"] = 0.0
    ctx["timing_bin_predict"]["shapes"] = {
        tag: {k: c["timing"][k] for k in ("ms", "kernel_ms", "device_ms",
                                          "plain_ms", "library_ms",
                                          "bound_ms")}
        for tag, c in out["cases"].items()}
    bin_predict.launches = n0 + len(BIN_SHAPES) * 2
    emit({"phase": "bin_predict", "shapes": list(out["cases"]),
          "nvidia_smi": ctx.get("smi")})


def _dataset(ctx):
    """The 1M-row training set and the 100,000-row held-out set, binned
    once and shared by the tree and train phases."""
    if "ds" not in ctx:
        import lightgbm_tpu_torch as lt

        X, logit = higgs_latent(ROWS + VALID_ROWS)
        y = (logit > 0).astype(np.float64)
        ctx["logit"] = logit
        t0 = time.perf_counter()
        ds = lt.Dataset(X[:ROWS], label=y[:ROWS], params=TRAIN_PARAMS)
        dv = ds.create_valid(X[ROWS:], label=y[ROWS:])
        ds.construct()
        dv.construct()
        ctx["ds"], ctx["dv"] = ds, dv
        ctx["Xv"], ctx["yv"] = X[ROWS:], y[ROWS:]
        ctx["bin_s"] = time.perf_counter() - t0
    return ctx["ds"], ctx["dv"]


def phase_tree(ctx) -> None:
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner_compact import (PLAIN_COMPACT,
                                                    CompactTreeLearner)

    dev = torch.device("cuda", 0)
    ds, _ = _dataset(ctx)
    data = ds.constructed
    cfg = Config.from_params(TRAIN_PARAMS)
    g, h, bag = dyadic_weights(np.random.RandomState(1),
                               data.num_data_padded, data.num_data, dev)
    res = {}
    kernel = CompactTreeLearner(cfg, data, dev)
    for tag, learner in (("kernel", kernel), ("graphed", kernel),
                         ("plain", CompactTreeLearner(
                             cfg, data, dev, kernels=PLAIN_COMPACT))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[tag] = learner.grow(g, h, bag)
        torch.cuda.synchronize()
        res[tag + "_s"] = time.perf_counter() - t0
    rk, ik, lk, ok = res["kernel"]
    splits = int((rk[:, 0] > 0.5).sum())
    check(splits > 0, "the dyadic tree did not split")
    for tag in ("graphed", "plain"):
        r, i, lf, o = res[tag]
        check(np.array_equal(rk, r) and np.array_equal(ik, i),
              f"tree records differ between the kernels and {tag}")
        check(torch.equal(lk, lf) and torch.equal(ok, o),
              f"leaf partitions or outputs differ ({tag})")
    stats = kernel.tree_stats
    check(stats[1]["graph_launches"] == cfg.num_leaves - 1
          and stats[0]["graph_launches"] == 0,
          f"the second tree did not replay its steps as graphs: {stats}")
    emit({"phase": "tree", "splits": splits, "records_bitwise": True,
          "graphed_tree_bitwise": True, "tree_stats": stats,
          "grow_s_kernel": res["kernel_s"],
          "grow_s_graphed": res["graphed_s"], "grow_s_plain": res["plain_s"],
          "bin_s": ctx["bin_s"]})


def phase_wave_tree(ctx) -> None:
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
    from lightgbm_tpu_torch.learner_wave import (PLAIN_KERNELS,
                                                 WaveTreeLearner)

    dev = torch.device("cuda", 0)
    ds, _ = _dataset(ctx)
    data = ds.constructed
    g, h, bag = dyadic_weights(np.random.RandomState(1),
                               data.num_data_padded, data.num_data, dev)
    growers = {
        "wave_kernels": lambda: WaveTreeLearner(
            Config.from_params(WAVE_PARAMS), data, dev),
        "wave_plain": lambda: WaveTreeLearner(
            Config.from_params(WAVE_PARAMS), data, dev, PLAIN_KERNELS),
        "compact": lambda: CompactTreeLearner(
            Config.from_params(TRAIN_PARAMS), data, dev)}
    res, info = {}, {}
    for tag, make in growers.items():
        learner = make()
        if tag == "wave_kernels":
            # a learner's first tree runs its passes eagerly (and warms up);
            # the second captures and replays them as CUDA graphs
            learner.grow(g, h, bag)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[tag] = learner.grow(g, h, bag)
        torch.cuda.synchronize()
        info[tag] = {"grow_s": time.perf_counter() - t0,
                     "host_syncs": learner.host_syncs}
        if tag.startswith("wave"):
            info[tag].update(learner.tree_stats[-1])
    rk, ik, lk, ok = res["wave_kernels"]
    splits = int((rk[:, 0] > 0.5).sum())
    check(splits == 254, f"the dyadic wave tree made {splits} splits, not 254")
    check(info["wave_kernels"]["graph_launches"]
          == info["wave_kernels"]["passes"] > 0,
          "the second wave tree did not replay its passes as CUDA graphs")
    check(info["wave_plain"]["graph_launches"] == 0,
          "the plain versions' tree replayed graphs")
    for tag in ("wave_plain", "compact"):
        r, i, lid, out = res[tag]
        check(np.array_equal(rk, r) and np.array_equal(ik, i),
              f"wave tree records differ from the {tag} tree")
        check(torch.equal(lk, lid), f"leaf ids differ from the {tag} tree")
        check(torch.equal(ok.to(torch.float32), out.to(torch.float32)),
              f"leaf outputs differ from the {tag} tree")
    emit({"phase": "wave_tree", "splits": splits, "records_bitwise": True,
          "graphed_tree_bitwise": True, "growers": info})


def _dataset_masked(ctx):
    """The same rows binned at max_bin=1023 (uint16 codes), built once and
    shared by the masked_tree and masked_train phases."""
    if "ds_masked" not in ctx:
        import lightgbm_tpu_torch as lt

        X, y = higgs_like(ROWS + VALID_ROWS)
        t0 = time.perf_counter()
        ds = lt.Dataset(X[:ROWS], label=y[:ROWS], params=MASKED_PARAMS)
        dv = ds.create_valid(X[ROWS:], label=y[ROWS:])
        ds.construct()
        dv.construct()
        ctx["ds_masked"], ctx["dv_masked"] = ds, dv
        ctx["bin_s_masked"] = time.perf_counter() - t0
        ctx.setdefault("Xv", X[ROWS:])  # held-out rows, when run alone
    return ctx["ds_masked"], ctx["dv_masked"]


def phase_masked_tree(ctx) -> None:
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner import MaskedTreeLearner
    from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
    from lightgbm_tpu_torch.ops.histogram import build_histogram_onehot

    dev = torch.device("cuda", 0)
    out = {"phase": "masked_tree"}
    for tag_b, ds, params in (("B255", _dataset(ctx)[0], TRAIN_PARAMS),
                              ("B1023", _dataset_masked(ctx)[0],
                               MASKED_PARAMS)):
        data = ds.constructed
        cfg = Config.from_params(dict(params, tpu_learner="masked"))
        g, h, bag = dyadic_weights(np.random.RandomState(1),
                                   data.num_data_padded, data.num_data, dev)
        growers = {
            "masked_kernel": lambda: MaskedTreeLearner(cfg, data, dev),
            "masked_plain": lambda: MaskedTreeLearner(
                cfg, data, dev, histogram=build_histogram_onehot)}
        if tag_b == "B255":
            growers["compact"] = lambda: CompactTreeLearner(
                Config.from_params(TRAIN_PARAMS), data, dev)
        res, info = {}, {}
        for tag, make in growers.items():
            learner = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[tag] = learner.grow(g, h, bag)
            torch.cuda.synchronize()
            info[tag] = {"grow_s": time.perf_counter() - t0,
                         "host_syncs": learner.host_syncs}
        rk, ik, lk, ok = res["masked_kernel"]
        splits = int((rk[:, 0] > 0.5).sum())
        check(splits == 254, f"the dyadic masked tree at {tag_b} made "
              f"{splits} splits, not 254")
        for tag in list(growers)[1:]:
            r, i, lid, o = res[tag]
            check(np.array_equal(rk, r) and np.array_equal(ik, i),
                  f"masked tree {tag_b}: records differ from the {tag} tree")
            check(torch.equal(lk, lid),
                  f"masked tree {tag_b}: leaf ids differ from the {tag} tree")
            check(torch.equal(ok.to(torch.float32), o.to(torch.float32)),
                  f"masked tree {tag_b}: leaf outputs differ from the {tag} "
                  f"tree")
        out[tag_b] = {"splits": splits, "num_bins": int(data.max_num_bin),
                      "codes": str(data.bins.dtype), "records_bitwise": True,
                      "growers": info}
    out["bin_s_masked"] = ctx["bin_s_masked"]
    emit(out)


def phase_opening_tree(ctx) -> None:
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops.hist_multislot import \
        build_histogram_multislot

    ds, _ = _dataset(ctx)
    # round 1 without boost_from_average: gradients +-0.5 and hessians 0.25,
    # so every float32 histogram sum is exact whatever its order
    p = dict(WAVE_PARAMS, boost_from_average=False, metric="none")
    text, info = {}, {}
    for tag, extra in (("off", {}), ("open5", {"tpu_wave_open_levels": 5})):
        n0 = build_histogram_multislot.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(dict(p, **extra), ds, 1, verbose_eval=False)
        torch.cuda.synchronize()
        learner = bst.gbdt.learner
        text[tag] = bst.model_to_string()
        info[tag] = dict(learner.tree_stats[0], train_s=time.perf_counter()
                         - t0, multislot_launches=
                         build_histogram_multislot.launches - n0,
                         leaves=bst.gbdt.models[0].num_leaves)
    check(info["open5"]["open_levels"] == 5,
          f"the opening ran {info['open5']['open_levels']} levels, not 5")
    check(info["open5"]["multislot_launches"] == 5,
          "the opening did not launch the multislot kernel once per level")
    check(info["open5"]["leaves"] == 255, "the opening tree is not full")
    check(text["off"] == text["open5"],
          "model text with the opening differs from the opening off")
    emit({"phase": "opening_tree", "model_text_equal": True, "runs": info})


CAT_PARAMS = dict(WAVE_PARAMS, categorical_feature=EXPO_CATEGORICAL)


def _dataset_expo(ctx):
    """The Expo-shaped 1M training and 100,000 held-out rows, binned once
    and shared by the categorical phases."""
    if "ds_expo" not in ctx:
        import lightgbm_tpu_torch as lt

        t0 = time.perf_counter()
        X, y = expo_like(ROWS + VALID_ROWS)
        ctx["gen_s_expo"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = lt.Dataset(X[:ROWS], label=y[:ROWS], params=CAT_PARAMS)
        dv = ds.create_valid(X[ROWS:], label=y[ROWS:])
        ds.construct()
        dv.construct()
        ctx["ds_expo"], ctx["dv_expo"] = ds, dv
        ctx["Xv_expo"], ctx["yv_expo"] = X[ROWS:], y[ROWS:]
        ctx["bin_s_expo"] = time.perf_counter() - t0
    return ctx["ds_expo"], ctx["dv_expo"]


def phase_categorical_tree(ctx) -> None:
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner import REC_IS_CAT, MaskedTreeLearner
    from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
    from lightgbm_tpu_torch.learner_wave import (PLAIN_KERNELS,
                                                 WaveTreeLearner)

    dev = torch.device("cuda", 0)
    ds, _ = _dataset_expo(ctx)
    data = ds.constructed
    g, h, bag = dyadic_weights(np.random.RandomState(1),
                               data.num_data_padded, data.num_data, dev)
    cfg = Config.from_params(CAT_PARAMS)
    growers = {
        "wave_kernels": lambda: WaveTreeLearner(cfg, data, dev),
        "wave_plain": lambda: WaveTreeLearner(cfg, data, dev, PLAIN_KERNELS),
        "compact": lambda: CompactTreeLearner(cfg, data, dev),
        "masked": lambda: MaskedTreeLearner(
            Config.from_params(dict(CAT_PARAMS, tpu_learner="masked")),
            data, dev)}
    res, info = {}, {}
    for tag, make in growers.items():
        learner = make()
        if tag == "wave_kernels":
            # the first tree runs eagerly; the second replays CUDA graphs
            learner.grow(g, h, bag)
        calls0 = dict(learner.kernel_calls)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res[tag] = learner.grow(g, h, bag)
        torch.cuda.synchronize()
        info[tag] = {"grow_s": time.perf_counter() - t0,
                     "split_cat_calls": learner.kernel_calls["split_cat"]
                     - calls0["split_cat"]}
        if tag.startswith("wave"):
            info[tag].update(learner.tree_stats[-1])
    rk, ik, lk, ok = res["wave_kernels"]
    splits = int((rk[:, 0] > 0.5).sum())
    cat_splits = int((rk[:splits, REC_IS_CAT] > 0.5).sum())
    check(splits == 254, f"the dyadic categorical tree made {splits} "
          f"splits, not 254")
    check(cat_splits > 0, "the dyadic tree has no categorical split")
    check(info["wave_kernels"]["graph_launches"]
          == info["wave_kernels"]["passes"] > 0,
          "the second wave tree did not replay its passes as CUDA graphs")
    for tag in ("wave_plain", "compact", "masked"):
        r, i, lid, o = res[tag]
        check(np.array_equal(rk, r),
              f"categorical tree records differ from the {tag} tree")
        check(np.array_equal(ik, i), f"categorical tree counts or bitsets "
              f"differ from the {tag} tree")
        check(torch.equal(lk, lid), f"leaf ids differ from the {tag} tree")
        check(torch.equal(ok.to(torch.float32), o.to(torch.float32)),
              f"leaf outputs differ from the {tag} tree")
    emit({"phase": "categorical_tree", "splits": splits,
          "categorical_splits": cat_splits,
          "bitset_words": int(ik.shape[1] - 2), "records_bitwise": True,
          "graphed_tree_bitwise": True, "growers": info,
          "gen_s": ctx["gen_s_expo"], "bin_s": ctx["bin_s_expo"]})


def _train_run(ctx, params, tag, counters, data=None, iters: int = 5,
               falling: bool = True):
    """Train ``iters`` iterations at the bench width with ``params`` on
    ``data`` (the 255-bin sets by default); ``counters`` maps kernel names
    to their wrappers, whose launch counts are set to 0 just before the run
    and read just after.  Checks (the training logloss falling every
    iteration where ``falling``) and returns the phase's result dict."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metrics import create_metric

    ds, dv = data or _dataset(ctx)
    evals, t_iter, train_ll = {}, [], []
    logloss = create_metric("binary_logloss", lt.Config.from_params(params))
    logloss.init(ds.constructed.metadata, ds.constructed.num_data)
    marks = {}

    def before(env):
        torch.cuda.synchronize()
        marks["t0"] = time.perf_counter()
    before.before_iteration = True

    def after(env):
        torch.cuda.synchronize()
        t_iter.append(time.perf_counter() - marks["t0"])
        score = env.model.gbdt.train_score.np_score()
        train_ll.append(logloss.eval(score, env.model.gbdt.objective)[0][1])
    after.order = 100

    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():                 # counts of the main path
        fn.launches = 0
    bst = lt.train(params, ds, iters, valid_sets=[dv],
                   valid_names=["heldout"], evals_result=evals,
                   verbose_eval=False, callbacks=[before, after])
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    trees = bst.gbdt.models
    check(len(trees) == iters, f"{len(trees)} trees, want {iters}")
    for name, n in launches.items():
        check(n > 0, f"{tag}: kernel {name} was not launched on the path")
    learner = bst.gbdt.learner
    bins = getattr(learner, "bins", None)
    if bins is None:
        bins = learner.bins_packed()
    check(bins.is_cuda and bst.gbdt.train_score.score.is_cuda,
          "bins or scores are not on the card")
    check(not falling or all(b < a for a, b in zip(train_ll, train_ll[1:])),
          f"training logloss did not fall every iteration: {train_ll}")
    auc = evals["heldout"]["auc"]
    check(all(np.isfinite(auc)) and auc[-1] > 0.7,
          f"held-out AUC too low: {auc}")
    n_dev = bst.gbdt.device_predictions
    pred = bst.predict(ctx["Xv"])
    # 100,000 rows x 5 trees: the DevicePredictor's batch size
    check(bst.gbdt.device_predictions == n_dev + 1,
          "Booster.predict did not go through the DevicePredictor")
    dev_score = bst.gbdt.valid_scores[0].np_score().astype(np.float64)
    check(pred.shape == (VALID_ROWS,) and bool(np.isfinite(pred).all()),
          "predictions are not finite of shape (100000,)")
    diff = float(np.abs(pred - 1.0 / (1.0 + np.exp(-dev_score))).max())
    check(diff < 1e-5, f"Booster.predict vs device held-out scores: {diff}")
    grads = bst.gbdt.objective.get_gradients(bst.gbdt.train_score.score[0])
    return bst, learner, grads, {
        "phase": tag, "iterations": iters,
        "trees_leaves": [t.num_leaves for t in trees],
        "kernel_launches": launches, "train_logloss": train_ll,
        "heldout_auc": auc,
        "heldout_logloss": evals["heldout"]["binary_logloss"],
        "s_per_iter": t_iter,
        "s_per_iter_after_first": float(np.mean(t_iter[1:])),
        "host_syncs_per_tree": learner.host_syncs / len(trees),
        "loop_score_reads": bst.gbdt.host_syncs,
        "peak_device_bytes": peak, "predict_vs_device_max_diff": diff,
        "predict_via_device_predictor": True,
        "device": str(learner.device)}


@contextmanager
def recording(module, name: str, record):
    """Replace ``module.name``, the histogram function a learner takes when
    it is built, by one that hands every call's arguments to ``record``
    (while the block runs) and then calls the original.  The launch counts
    stay on the original wrapper."""
    orig = getattr(module, name)
    live = [True]

    def hook(*args, **kw):
        if live[0]:
            record(*args, **kw)
        return orig(*args, **kw)

    setattr(module, name, hook)
    try:
        yield
    finally:
        live[0] = False
        setattr(module, name, orig)


def size_shapes(sizes, key: str, extra=None) -> dict:
    """The distribution of one number per launch (``key``: the weighted
    rows of a hist_full launch, the window of a hist_packed launch), and the
    median and largest launch."""
    order = sorted(range(len(sizes)), key=lambda i: sizes[i])
    pick = {"median": order[len(order) // 2], "largest": order[-1]}
    return {"distribution": {"launches": len(sizes),
                             key: _quantiles(sizes),
                             "launches_by_" + key: dict(Counter(
                                 str(v) for v in sorted(sizes)
                             ).most_common(8))},
            **{tag: dict({key: sizes[i]}, **(extra(i) if extra else {}))
               for tag, i in pick.items()}}


def compact_counters() -> dict:
    """The compact learner's kernel wrappers, by kernel name."""
    from lightgbm_tpu_torch.ops.hist_packed import build_histogram_packed
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.partition import partition_window

    return {"hist_packed": build_histogram_packed,
            "hist_segments": build_histogram_segments,
            "partition_window": partition_window}


def compact_step_checks(tag, learner, trees: int, steps: int,
                        launches) -> dict:
    """The compact learner's device step on a run of ``trees`` trees of
    ``steps`` steps each: one host read per tree, the first tree eager and
    every later tree's steps graph replays, and the launch identity (a
    root histogram per tree; a K = 1 segment histogram and a windowed
    partition per step)."""
    stats = learner.tree_stats[-trees:]
    check(learner.host_syncs == trees, f"{tag}: {learner.host_syncs} host "
          f"syncs for {trees} trees, want 1 per tree")
    check(all(s["steps"] == steps for s in stats),
          f"{tag}: steps per tree {[s['steps'] for s in stats]} != {steps}")
    check(stats[0]["graph_launches"] == 0
          and all(s["graph_launches"] == steps for s in stats[1:]),
          f"{tag}: not every step of trees 2.. a graph replay: {stats}")
    want = {"hist_packed": trees, "hist_segments": trees * steps,
            "partition_window": trees * steps}
    check(launches == want, f"{tag}: launches {launches} != {want}")
    return {"host_syncs_per_tree": learner.host_syncs / trees,
            "steps_per_tree": steps,
            "graph_launches_per_tree": [s["graph_launches"] for s in stats],
            "graph_captures": learner.graph_captures,
            "launches_expected": want}


def compact_shapes(learner, grads, bag) -> dict:
    """One more tree grown eagerly on ``grads`` by a learner of the same
    config whose kernels record every windowed partition's split and every
    K = 1 segment launch's count: the windows of the steps that split and
    their distribution (the parent's window: sort mode above the learner's
    mask limit) and the child histograms' counts."""
    from lightgbm_tpu_torch.learner_compact import (CompactKernels,
                                                    CompactTreeLearner)
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.partition import partition_window

    splits, cnts = [], []

    def seg(words, w, lid, start, cnt, leaf, **kw):
        cnts.append(cnt.clone())
        return build_histogram_segments(words, w, lid, start, cnt, leaf,
                                        **kw)

    def part(*args, **kw):
        splits.append(args[4].clone())
        return partition_window(*args, **kw)

    eager = CompactTreeLearner(learner.cfg, learner.data, learner.device,
                               kernels=CompactKernels(segments=seg,
                                                      partition=part))
    eager.grow(*grads, bag)
    sp = torch.stack(splits).tolist()
    windows = [r[7] for r in sp if r[5]]
    counts = [int(c) for c in torch.cat(cnts).tolist() if c > 0]
    mask_max = learner._mask_max
    return {"partition_window": size_shapes(
                windows, "rows",
                lambda i: {"sort_mode": windows[i] > mask_max}),
            "hist_segments": size_shapes(counts, "rows"),
            "mask_max": mask_max,
            "sort_mode_windows": sum(c > mask_max for c in windows)}


def phase_train(ctx) -> None:
    from lightgbm_tpu_torch.learner_compact import CompactTreeLearner

    bst, learner, grads, out = _train_run(ctx, TRAIN_PARAMS, "train",
                                          compact_counters())
    check(type(learner) is CompactTreeLearner, "compact was not selected")
    trees = len(bst.gbdt.models)
    out.update(compact_step_checks("train", learner, trees,
                                   learner.num_leaves - 1,
                                   out["kernel_launches"]))
    st = learner._init_root(*grads, bst.gbdt._bag_mask,
                            learner._all_features)
    check(st.w_p.is_cuda and st.hist_pool.is_cuda and st.bins_p.is_cuda,
          "weights or histogram pool are not on the card")
    ctx["shapes_train"] = out["shapes"] = compact_shapes(
        learner, grads, bst.gbdt._bag_mask)
    ctx["launches_train"] = out["kernel_launches"]
    ctx["launches_compact"] = out["kernel_launches"]["hist_packed"]
    ctx["auc_compact"] = out["heldout_auc"]
    emit(out)


def _quantiles(xs) -> dict:
    q = np.percentile(np.asarray(xs, dtype=np.float64), [0, 25, 50, 75, 100])
    return dict(zip(("min", "p25", "median", "p75", "max"), q.tolist()))


def launch_shapes(seg, scan) -> dict:
    """The distribution of the main path's hist_segments launches (member
    count K, sum and maximum of cnt, the row bound the wrapper was given)
    and split_scan launches (leaf count K), and for each kernel its median
    and largest launch (by rows for hist_segments, by K for split_scan)."""
    sizes = [c.numel() for c, _ in seg]
    flat = torch.cat([c.reshape(-1).to(torch.int64) for c, _ in seg]).cpu()
    cnts = [c.tolist() for c in torch.split(flat, sizes)]
    rows = [{"K": len(c), "sum_cnt": int(sum(c)), "max_cnt": int(max(c)),
             "rows_bound": int(b), "cnt": c}
            for c, (_, b) in zip(cnts, seg)]
    by_rows = sorted(rows, key=lambda r: (r["sum_cnt"], r["K"]))
    ks = sorted(scan)
    return {
        "hist_segments": {
            "distribution": {
                "launches": len(rows),
                "K": _quantiles([r["K"] for r in rows]),
                "sum_cnt": _quantiles([r["sum_cnt"] for r in rows]),
                "max_cnt": _quantiles([r["max_cnt"] for r in rows]),
                "launches_by_K": {str(k): n for k, n in sorted(
                    Counter(r["K"] for r in rows).items())}},
            "median": by_rows[len(by_rows) // 2], "largest": by_rows[-1]},
        "split_scan": {
            "distribution": {
                "launches": len(ks), "K": _quantiles(ks),
                "launches_by_K": {str(k): n for k, n in
                                  sorted(Counter(ks).items())}},
            "median": {"K": ks[len(ks) // 2]}, "largest": {"K": ks[-1]}}}


def eager_tree_shapes(learner, grads, bag, wrappers, replays=None):
    """Grow the first tree of a fresh learner with the learner's config and
    data (a learner's first tree runs its passes eagerly; a launch captured
    into a graph records no shape), with every launch of ``wrappers``
    recording its shape; returns the records and that tree's kernel
    calls.  With a list ``replays``, every replay pass appends its inputs
    and its carried state before and after (device copies, read after the
    tree)."""
    import dataclasses

    from lightgbm_tpu_torch.learner_wave import WaveKernels, WaveTreeLearner
    from lightgbm_tpu_torch.ops.replay import replay_pass

    kernels = WaveKernels()
    if replays is not None:
        def record(*args, **kw):
            before = [t.clone() for t in args]
            replay_pass(*args, **kw)
            replays.append((before, [t.clone() for t in args[4:]], kw))

        kernels = dataclasses.replace(kernels, replay=record)
    ln = WaveTreeLearner(learner.cfg, learner.data, learner.device, kernels)
    ln._use_fused = learner._use_fused
    for fn in wrappers:
        fn.shapes = []
    try:
        ln.grow(*grads, bag)
        rec = [fn.shapes for fn in wrappers]
    finally:
        for fn in wrappers:
            fn.shapes = None
    return rec, ln.kernel_calls


def replay_shapes(replays) -> dict:
    """The distribution of the pops per replay pass of an eager tree
    (``eager_tree_shapes``' records) and its median and largest pass by
    pops, each with its recorded inputs (``inputs``: the node table and the
    carried state before the pass, and the pass's kwargs)."""
    from lightgbm_tpu_torch.ops.replay import CTL_FLAG, CTL_POPS

    pops = [int(after[3][CTL_POPS]) - int(before[7][CTL_POPS])
            for before, after, _ in replays]
    flags = [int(after[3][CTL_FLAG]) for _, after, _ in replays]
    order = sorted(range(len(pops)), key=lambda i: pops[i])
    pick = {"median": order[len(order) // 2], "largest": order[-1]}
    return {"distribution": {"passes": len(pops), "pops": _quantiles(pops),
                             "pops_per_pass": pops, "flags": flags,
                             "M": int(replays[0][0][4].numel())},
            **{tag: {"pops": pops[i], "M": int(replays[i][0][4].numel()),
                     "inputs": (replays[i][0], replays[i][2])}
               for tag, i in pick.items()}}


#: spin kernels (a million cycles each) that open profiled_tree's window
OPEN_SPINS = 16
#: the windows profiled_tree may take, each opening with twice the spins
PROFILE_WINDOWS = 5


def profiled_tree(learner, grads, bag, names) -> dict:
    """Grow one more tree with ``learner`` (past its first, so its passes
    replay CUDA graphs) under torch.profiler, and check that the device ran
    each kernel of ``names`` as often as the learner's counts say it was
    launched in that tree: the launches a graph replay is credited with,
    read back from the device's own records.  On the H100 the profiler
    drops the kernels that start in a window's first 0.5 to 2.5 ms: an
    opening spin kernel in every window, however long it spins, and in
    some full runs also the tree's root histogram after a spin of a
    million cycles (PERF.md, section 6).  So the window opens with
    ``OPEN_SPINS`` spins of a million cycles (and closes with one) and
    reads the tree only where the last opening spins were kept, which
    shows that the drop ended before the tree began; else the window is
    taken again with twice the spins, up to ``PROFILE_WINDOWS`` windows
    (16 to 256 spins: full runs have dropped all of 32)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch import native

    windows, spins = [], OPEN_SPINS
    for _ in range(PROFILE_WINDOWS):
        calls0 = dict(learner.kernel_calls)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(1_000_000)
            learner.grow(*grads, bag)
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
        ran = [e.name for e in sorted(
            (e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        kept = next((i for i, k in enumerate(ran) if "spin" not in k),
                    len(ran))
        windows.append({"opening_spins": spins, "kept": kept,
                        "records": len(ran)})
        if kept:
            ran = ran[kept:]
            break
        spins *= 2
    sym = native.KERNEL_SYMBOLS
    device = {n: sum(1 for k in ran if re.search(
        rf"(^|::){sym[n]}(<[^>]*>)?\(", k)) for n in names}
    counted = {n: learner.kernel_calls[n] - calls0[n] for n in names}
    stats = learner.tree_stats[-1]
    check(stats["graph_launches"] == stats["passes"] > 0,
          f"the profiled tree did not replay its passes as graphs: {stats}")
    other = Counter(k[:80] for k in ran if not any(re.search(
        rf"(^|::){sym[n]}(<[^>]*>)?\(", k) for n in names))
    # where a record went: a kernel's name in a form the pattern misses,
    # or the window's head lost past its opening spins (the first records)
    near = [k[:120] for k in other if any(sym[n] in k for n in names)]
    check(device == counted and all(counted.values()),
          f"kernels the device ran in a graphed tree {device} != the "
          f"launches the learner counted {counted} ({len(ran)} records; "
          f"windows {windows}; the first {[k[:60] for k in ran[:4]]}; "
          f"named like a checked kernel {near}; the others "
          f"{other.most_common(6)})")
    return {"device_kernels": device, "counted_launches": counted,
            "graph_launches": stats["graph_launches"],
            "kernel_records": len(ran), "windows": windows}


def wave_counters() -> dict:
    """The wave learner's kernel wrappers, by kernel name."""
    from lightgbm_tpu_torch.ops.hist_packed import build_histogram_packed
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.partition import apply_partition
    from lightgbm_tpu_torch.ops.replay import replay_pass
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched

    return {"hist_packed": build_histogram_packed,
            "hist_segments": build_histogram_segments,
            "partition": apply_partition,
            "split_scan": find_best_splits_batched,
            "replay": replay_pass}


def tree_counters(out, learner, keys) -> None:
    """Per-tree counters of the learner's trees into ``out``."""
    stats = learner.tree_stats
    for key in keys:
        out[key + "_per_tree"] = [s[key] for s in stats]


WAVE_TREE_KEYS = ("waves", "stall_events", "stall_splits", "replay_passes",
                  "host_syncs", "flag_waits", "graph_launches", "passes",
                  "graph_captures")


def phase_wave_train(ctx) -> None:
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.replay import replay_pass_plain
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched

    counters = wave_counters()
    bst, learner, grads, out = _train_run(ctx, WAVE_PARAMS, "wave_train",
                                          counters)
    check(type(learner) is WaveTreeLearner and learner.use_graphs,
          "tpu_learner=auto did not select the wave learner with graphs")
    calls = learner.kernel_calls
    check(out["kernel_launches"] == {n: calls[n] for n in counters},
          f"kernel launches {out['kernel_launches']} != the calls the "
          f"learner recorded {calls}")
    tree_counters(out, learner, WAVE_TREE_KEYS)
    syncs = out["host_syncs_per_tree"]
    check(max(syncs) <= 2, f"host syncs per tree {syncs} (want <= 2)")
    check(all(n > 0 for n in out["graph_launches_per_tree"][1:]),
          "trees after the first did not replay CUDA graphs")
    out["graphed_tree_profiled"] = profiled_tree(
        learner, grads, bst.gbdt._bag_mask, counters)
    # each launch's shape, from one more tree grown eagerly on the run's
    # last gradients (a graph replay records none)
    replays = []
    (seg, scan), calls1 = eager_tree_shapes(
        learner, grads, bst.gbdt._bag_mask,
        (build_histogram_segments, find_best_splits_batched), replays)
    check(len(seg) == calls1["hist_segments"]
          and len(scan) == calls1["split_scan"]
          and len(replays) == calls1["replay"],
          "a launch shape was not recorded")
    # the main path's own replay passes against the plain version on the
    # CPU, from the recorded state before each
    for i, (before, after, kw) in enumerate(replays):
        st = [t.cpu() for t in before[4:]]
        replay_pass_plain(*[t.cpu() for t in before[:4]], *st, **kw)
        check(all(torch.equal(a, b.cpu()) for a, b in zip(st, after)),
              f"wave_train replay pass {i + 1}: the kernel's state differs "
              f"from the plain version's")
    out["replay_passes_bitwise_to_plain"] = len(replays)
    ctx["shapes_wave"] = launch_shapes(seg, scan)
    ctx["shapes_wave"]["replay"] = replay_shapes(replays)
    out["shapes"] = {k: v["distribution"]
                     for k, v in ctx["shapes_wave"].items()}
    st = learner._init_root_wave(*grads, bst.gbdt._bag_mask,
                                 learner._all_features)
    lanes = {"bins_p": st.bins_p, "w_p": st.w_p, "rid_p": st.rid_p,
             "lid_p": st.lid_p, "hist_pool": st.hist_pool,
             "node_i": st.node_i, "node_f": st.node_f, "cand_f": st.cand_f,
             "cand_i": st.cand_i, "split_m": st.split_m,
             "spare": st.spare[0], "replay_state": st.rctl}
    off = [k for k, v in lanes.items() if not v.is_cuda]
    check(not off, f"lanes not on the card: {off}")
    if "auc_compact" in ctx:
        gap = abs(out["heldout_auc"][-1] - ctx["auc_compact"][-1])
        check(gap < 1e-4, f"held-out AUC {out['heldout_auc'][-1]} is "
              f"{gap} from the compact learner's")
        out["auc_gap_to_compact"] = gap
    out["lanes_on_card"] = sorted(lanes)
    ctx["launches_wave"] = out["kernel_launches"]
    ctx["auc_wave"] = out["heldout_auc"]
    ctx["bst_wave"] = bst
    ctx["wave_s_per_iter"] = out["s_per_iter"]
    emit(out)


def phase_wave_pipelined(ctx) -> None:
    """wave_train's run without the held-out set: the pipelined loop, run
    8 iterations past its flush depth and timed over those, each of which
    also builds the host tree of the iteration `depth` back."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metrics import create_metric

    ds, dv = _dataset(ctx)
    counters = wave_counters()
    bst = lt.Booster(WAVE_PARAMS, ds)
    gbdt = bst.gbdt
    check(gbdt._can_pipeline(), "the run without a held-out set does not "
          "pipeline")
    learner = gbdt.learner
    # past the flush depth, so that every iteration of the last `steady`
    # also waits for and builds the host tree `depth` iterations old
    depth = int(gbdt.cfg.tpu_pipeline_flush_depth)
    steady = 8
    iters = depth + steady
    for fn in counters.values():                 # counts of the main path
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dispatch, starts = [], []
    for _ in range(iters):
        t1 = time.perf_counter()
        starts.append(t1)
        bst.update()
        dispatch.append(time.perf_counter() - t1)
    loop_s = time.perf_counter() - t0
    reads_in_loop = learner.host_syncs
    waits_in_loop = gbdt.pipeline_waits
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    wall = t_end - t0
    trees = gbdt.models                          # the flush
    launches = {name: fn.launches for name, fn in counters.items()}
    calls = learner.kernel_calls
    check(len(trees) == iters, f"{len(trees)} trees, want {iters}")
    check(reads_in_loop == 0, f"{reads_in_loop} blocking reads of records "
          f"in the loop")
    check(waits_in_loop == max(0, iters - depth) > 0,
          f"{waits_in_loop} record waits in the loop")
    check(launches == {n: calls[n] for n in counters}
          and all(launches.values()),
          f"kernel launches {launches} != the learner's calls {calls}")
    # the held-out AUC after wave_train's 5 iterations, and after all
    auc_m = create_metric("auc", lt.Config.from_params(WAVE_PARAMS))
    auc_m.init(dv.constructed.metadata, dv.constructed.num_data)
    aucs = []
    for n in (5, iters):
        raw = bst.predict(ctx["Xv"], num_iteration=n, raw_score=True)
        check(np.isfinite(raw).all() and raw.shape == (VALID_ROWS,),
              "held-out predictions are not finite of shape (100000,)")
        aucs.append(auc_m.eval(raw, gbdt.objective)[0][1])
    auc = aucs[0]
    out = {"phase": "wave_pipelined", "iterations": iters,
           "flush_depth": depth, "trees_leaves": [t.num_leaves
                                                  for t in trees],
           "kernel_launches": launches, "heldout_auc_5": auc,
           "heldout_auc": aucs[1],
           "loop_s": loop_s, "dispatch_s_per_iter": dispatch,
           "wall_s": wall, "s_per_iter": wall / iters,
           # the last `steady` iterations, each with its rolling flush:
           # from the host's start of the first to the card's end
           "steady_iterations": steady,
           "s_per_iter_steady": (t_end - starts[depth]) / steady,
           "record_reads_in_loop": reads_in_loop,
           "record_waits_in_loop": waits_in_loop,
           "record_waits_at_flush": gbdt.pipeline_waits - waits_in_loop}
    tree_counters(out, learner, WAVE_TREE_KEYS)
    if "bst_wave" in ctx:
        sync = ctx["bst_wave"].gbdt.models[0].to_string()
        check(trees[0].to_string() == sync,
              "the first pipelined tree's model text differs from the "
              "synchronous run's")
        gap = abs(auc - ctx["auc_wave"][-1])
        check(gap < 1e-4, f"pipelined held-out AUC {auc} is {gap} from "
              f"wave_train's")
        out["first_tree_text_equal"] = True
        out["auc_gap_to_wave_train"] = gap
    emit(out)


def quant_shapes(multi, n: int, fused_k) -> dict:
    """The distribution of the quant path's hist_multislot launches (slot
    count K and rows in a slot, of n rows) and fused_scan launches (member
    count K); for each kernel its median and largest launch (by rows in a
    slot, then K, for hist_multislot; by K for fused_scan), and the
    median K = 1 multislot launch (an opening's first level)."""
    rows = [{"K": k, "rows_in_slot": r, "share": r / n} for k, r in multi]
    by_rows = sorted(rows, key=lambda r: (r["rows_in_slot"], r["K"]))
    k1 = [r for r in by_rows if r["K"] == 1]
    ks = sorted(fused_k)
    return {
        "hist_multislot": {
            "distribution": {
                "launches": len(rows),
                "K": _quantiles([r["K"] for r in rows]),
                "rows_in_slot": _quantiles([r["rows_in_slot"]
                                            for r in rows]),
                "launches_by_K": {str(k): c for k, c in sorted(
                    Counter(r["K"] for r in rows).items())}},
            "median": by_rows[len(by_rows) // 2], "largest": by_rows[-1],
            **({"k1": k1[len(k1) // 2]} if k1 else {})},
        "fused_scan": {
            "distribution": {
                "launches": len(ks), "K": _quantiles(ks),
                "launches_by_K": {str(k): c for k, c in
                                  sorted(Counter(ks).items())}},
            "median": {"K": ks[len(ks) // 2]}, "largest": {"K": ks[-1]}}}


def phase_quant_train(ctx) -> None:
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner
    from lightgbm_tpu_torch.ops.fused_scan import fused_child_scans
    from lightgbm_tpu_torch.ops.hist_multislot import \
        build_histogram_multislot
    from lightgbm_tpu_torch.ops.hist_packed import build_histogram_packed
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.partition import apply_partition
    from lightgbm_tpu_torch.ops.quant import quantize_gradients
    from lightgbm_tpu_torch.ops.replay import replay_pass
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched

    counters = {"hist_packed": build_histogram_packed,
                "hist_segments": build_histogram_segments,
                "partition": apply_partition,
                "split_scan": find_best_splits_batched,
                "hist_multislot": build_histogram_multislot,
                "fused_scan": fused_child_scans,
                "replay": replay_pass}
    quant_modes = {"hist_packed_quant": build_histogram_packed,
                   "hist_segments_quant": build_histogram_segments,
                   "hist_multislot_quant": build_histogram_multislot}
    for fn in quant_modes.values():
        fn.quant_launches = 0
    bst, learner, grads, out = _train_run(ctx, QUANT_PARAMS, "quant_train",
                                          counters)
    quant = {name: fn.quant_launches for name, fn in quant_modes.items()}
    # each multislot launch's K and slot tensor and each fused launch's K,
    # from one more tree grown eagerly on the run's last gradients
    (multi, fused_k), calls1 = eager_tree_shapes(
        learner, grads, bst.gbdt._bag_mask,
        (build_histogram_multislot, fused_child_scans))
    check(len(multi) == calls1["hist_multislot"]
          and len(fused_k) == calls1["fused_scan"],
          "a multislot or fused launch shape was not recorded")
    ctx["shapes_quant"] = quant_shapes(
        [(k, int(((sl >= 0) & (sl < k)).sum())) for k, sl in multi],
        int(multi[0][1].numel()), fused_k)
    out["shapes"] = {k: v["distribution"]
                     for k, v in ctx["shapes_quant"].items()}
    check(type(learner) is WaveTreeLearner and learner._quant
          and learner._use_fused and learner.open_levels == 5,
          "quant_train did not run the quantized wave learner with the "
          "fused kernel and five opening levels")
    calls = learner.kernel_calls
    check(out["kernel_launches"] == {n: calls[n] for n in counters},
          f"kernel launches {out['kernel_launches']} != the calls the "
          f"learner recorded {calls}")
    check(quant == {n: calls[n] for n in quant_modes} and all(quant.values()),
          f"quant-mode launches {quant} != the learner's {calls}")
    tree_counters(out, learner, ("open_levels",) + WAVE_TREE_KEYS)
    check(max(out["host_syncs_per_tree"]) <= 2,
          f"host syncs per tree {out['host_syncs_per_tree']} (want <= 2)")
    out["graphed_tree_profiled"] = profiled_tree(
        learner, grads, bst.gbdt._bag_mask, counters)
    out["quant_mode_launches"] = quant
    if "auc_wave" in ctx:
        gap = abs(out["heldout_auc"][-1] - ctx["auc_wave"][-1])
        check(gap <= 1e-3, f"quantized held-out AUC {out['heldout_auc'][-1]}"
              f" is {gap} from the float32 wave learner's")
        out["auc_gap_to_wave_f32"] = gap
    # one more tree from the last gradients, fused against unfused
    data, bag = bst.gbdt.train_data, bst.gbdt._bag_mask
    cfg = Config.from_params(QUANT_PARAMS)
    res = {}
    for fused in (True, False):
        ln = WaveTreeLearner(cfg, data, learner.device)
        ln._use_fused = fused
        res[fused] = (ln.grow(*grads, bag), ln.kernel_calls["fused_scan"])
    (ra, ia, la, oa), na = res[True]
    (rb, ib, lb, ob), nb = res[False]
    check(na > 0 and nb == 0, "the fused comparison did not use one kernel")
    check(np.array_equal(ra, rb) and np.array_equal(ia, ib)
          and torch.equal(la, lb) and torch.equal(oa, ob),
          "one tree fused against unfused: records differ")
    out["fused_vs_unfused_tree_bitwise"] = True
    # the card's quantization equals the CPU's bit for bit
    gb = (grads[0] * bag).to(torch.float32)
    hb = (grads[1] * bag).to(torch.float32)
    qd = quantize_gradients(gb, hb, bag, 0, gb.abs().max(), hb.max())
    qc = quantize_gradients(gb.cpu(), hb.cpu(), bag.cpu(), 0,
                            gb.abs().max().cpu(), hb.max().cpu())
    check(all(torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
              for a, b in zip(qd, qc)),
          "quantize_gradients on the card differs from the CPU")
    out["quantize_card_vs_cpu_bitwise"] = True
    ctx["launches_quant"] = dict(out["kernel_launches"], **quant)
    emit(out)


def monotone_grid(bst, X, feature: int, sign: float, n_rows: int = 64,
                  n_grid: int = 256) -> float:
    """The largest step against the constraint's ``sign`` along
    ``feature``: ``n_rows`` rows of ``X``, each with ``feature`` set to
    ``n_grid`` values over its range, raw scores (host trees), differences
    along the grid times the sign; 0.0 when the model is monotone."""
    base = np.repeat(X[:n_rows], n_grid, axis=0)
    grid = np.linspace(X[:, feature].min(), X[:, feature].max(), n_grid)
    base[:, feature] = np.tile(grid, n_rows)
    raw = bst.predict(base, raw_score=True).reshape(n_rows, n_grid)
    return float(max(0.0, -(np.diff(raw, axis=1) * sign).min()))


def phase_constrained_train(ctx) -> None:
    """The main path with monotone constraints and a feature penalty
    (``CON_PARAMS``), then quantized with the opening."""
    import lightgbm_tpu_torch.learner as lm
    import lightgbm_tpu_torch.ops.scan as ops_scan
    from lightgbm_tpu_torch.ops.fused_scan import fused_child_scans
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched

    plain = []
    out = {"phase": "constrained_train"}
    for tag, params, iters in (("float32", CON_PARAMS, 5),
                               ("quant", dict(CON_PARAMS,
                                              tpu_quantized_grad="on",
                                              tpu_wave_open_levels=5), 3)):
        counters = wave_counters()
        fused_child_scans.launches = 0
        find_best_splits_batched.con_launches = 0
        build_histogram_segments.quant_launches = 0
        # the plain split search, counted: the card's wave path calls none
        with recording(lm, "find_best_splits",
                       lambda *a, **k: plain.append(tag)), \
                recording(ops_scan, "find_best_splits",
                          lambda *a, **k: plain.append(tag)):
            bst, learner, _, run = _train_run(
                ctx, params, f"constrained_train/{tag}", counters,
                iters=iters)
        launches = dict(run["kernel_launches"],
                        fused_scan=fused_child_scans.launches)
        run["kernel_launches"] = launches
        calls = learner.kernel_calls
        check(learner.has_monotone and learner.has_penalty
              and not learner._use_fused,
              f"{tag}: the constrained learner runs the fused kernel")
        check(launches == {n: calls[n] for n in launches},
              f"{tag}: kernel launches {launches} != the learner's calls "
              f"{calls}")
        check(launches["fused_scan"] == 0,
              f"{tag}: fused_scan launched {launches['fused_scan']} times")
        con = find_best_splits_batched.con_launches
        check(con == launches["split_scan"] > 0,
              f"{tag}: {con} constrained split_scan launches of "
              f"{launches['split_scan']}")
        check(not plain, f"{tag}: the plain split search ran {len(plain)} "
              f"times on the card's wave path")
        tree_counters(run, learner, WAVE_TREE_KEYS)
        check(all(n == 1 for n in run["host_syncs_per_tree"]),
              f"{tag}: host syncs per tree {run['host_syncs_per_tree']}")
        check(all(n > 0 for n in run["graph_launches_per_tree"][1:]),
              f"{tag}: trees after the first did not replay CUDA graphs")
        if tag == "quant":
            check(learner._quant and build_histogram_segments.quant_launches
                  == launches["hist_segments"] > 0,
                  f"{tag}: the quant segment histogram did not run")
        steps = {f"feature_{f}": monotone_grid(bst, ctx["Xv"], f, sign)
                 for f, sign in ((0, 1.0), (1, -1.0))}
        # the quantized recipe renews the leaf outputs from the float32
        # gradients after the tree is grown, without the bounds, as the JAX
        # package does (learner_wave.py:1926-1965): reported, not held
        if tag == "float32":
            check(all(v == 0.0 for v in steps.values()),
                  f"{tag}: the model is not monotone on the grid: {steps}")
        run["steps_against_the_sign"] = steps
        run["constrained_split_scan_launches"] = con
        run["plain_split_search_calls"] = len(plain)
        out[tag] = run
        ctx.setdefault("launches_con", {})[tag] = launches
    if "wave_s_per_iter" in ctx:
        out["wave_train_s_per_iter"] = ctx["wave_s_per_iter"]
    out["categorical"] = constrained_categorical(ctx)
    emit(out)


def constrained_categorical(ctx) -> dict:
    """The Expo-shaped cell with monotone constraints on its two numerical
    columns (DepTime +1, Distance -1) and a penalty of 0.5 on Origin, 5
    iterations: every split_scan and split_cat launch constrained, 1 host
    sync per tree, the model monotone along both columns."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched
    from lightgbm_tpu_torch.ops.split_cat import categorical_candidates

    ds, dv = _dataset_expo(ctx)
    params = dict(CAT_PARAMS, monotone_constraints="0,0,0,0,0,0,1,-1",
                  feature_contri="1,1,1,1,0.5,1,1,1")
    counters = dict(wave_counters(), split_cat=categorical_candidates)
    for fn in counters.values():
        fn.launches = 0
    find_best_splits_batched.con_launches = 0
    categorical_candidates.con_launches = 0
    evals, t_iter = {}, []
    bst = lt.train(params, ds, 5, valid_sets=[dv], valid_names=["heldout"],
                   evals_result=evals, verbose_eval=False,
                   callbacks=iteration_timer(t_iter))
    launches = {n: fn.launches for n, fn in counters.items()}
    out = wave_path_checks("constrained_train/categorical", bst, launches)
    con = {"split_scan": find_best_splits_batched.con_launches,
           "split_cat": categorical_candidates.con_launches}
    check(con == {n: launches[n] for n in con} and all(con.values()),
          f"categorical: constrained launches {con} of {launches}")
    check(out["host_syncs_per_tree"] == 1,
          f"categorical: host syncs per tree {out['host_syncs_per_tree']}")
    steps = {f"feature_{f}": monotone_grid(bst, ctx["Xv_expo"], f, sign)
             for f, sign in ((6, 1.0), (7, -1.0))}
    check(all(v == 0.0 for v in steps.values()),
          f"categorical: the model is not monotone on the grid: {steps}")
    ctx.setdefault("launches_con", {})["categorical"] = launches
    out.update(constrained_launches=con, steps_against_the_sign=steps,
               heldout_auc=evals["heldout"]["auc"], s_per_iter=t_iter,
               trees_with_categorical_splits=sum(
                   t.num_cat > 0 for t in bst.gbdt.models))
    return out


def forced_json(ctx, path) -> list:
    """A three-node forced-split tree on the bench data: feature 25 at its
    median, then feature 26 at its median on both sides; written to
    ``path``.  Returns [(feature, threshold)] in BFS order."""
    X = ctx["Xv"]
    t25, t26 = (float(np.median(X[:, f])) for f in (25, 26))
    node = {"feature": 25, "threshold": t25,
            "left": {"feature": 26, "threshold": t26},
            "right": {"feature": 26, "threshold": t26}}
    with open(path, "w") as fh:
        json.dump(node, fh)
    return [(25, t25), (26, t26), (26, t26)]


def phase_forced_train(ctx) -> None:
    """Forced splits through the compact learner (the default learner moved
    there, 255 bins) and the masked learner (max_bin=1023)."""
    import tempfile

    from lightgbm_tpu_torch.learner import MaskedTreeLearner
    from lightgbm_tpu_torch.learner_compact import CompactTreeLearner
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full

    _dataset(ctx)
    out = {"phase": "forced_train"}
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/forced.json"
        want = forced_json(ctx, path)
        for tag, params, cls, counters, data in (
                ("compact", WAVE_PARAMS, CompactTreeLearner,
                 compact_counters(), None),
                ("masked", MASKED_PARAMS, MaskedTreeLearner,
                 {"hist_full": build_histogram_full},
                 _dataset_masked(ctx))):
            # the forced splits take their children's sums from the
            # reference's GatherInfoForThreshold, which counts the
            # threshold bin on the right while the rows of that bin go
            # left (feature_histogram.hpp:284-322): the outputs of the
            # forced leaves miss, and the loss may rise in a later
            # iteration, in the JAX package as here (the same sums on a
            # 20,000-row cut: 0.5495 -> 0.6380 at the fourth)
            bst, learner, _, run = _train_run(
                ctx, dict(params, forcedsplits_filename=path),
                f"forced_train/{tag}", counters, data=data, iters=3,
                falling=False)
            ll = run["train_logloss"]
            check(bool(np.isfinite(ll).all()) and ll[-1] < ll[0] * 1.2,
                  f"{tag}: training logloss {ll}")
            check(type(learner) is cls, f"{tag}: {type(learner).__name__} "
                  f"trained, not {cls.__name__}")
            firsts = []
            for tree in bst.gbdt.models:
                got = [(int(tree.split_feature[i]), float(tree.threshold[i]))
                       for i in range(3)]
                firsts.append(got)
                check([f for f, _ in got] == [f for f, _ in want]
                      and tree.left_child[0] == 1
                      and tree.right_child[0] == 2,
                      f"{tag}: a tree's first splits {got} are not the "
                      f"forced {want}")
            run["first_splits_per_tree"] = firsts
            if tag == "compact":
                # the forced steps come before the num_leaves - 1 others
                ctx["launches_forced_compact"] = run["kernel_launches"]
                run.update(compact_step_checks(
                    "forced_train/compact", learner, 3,
                    len(want) + learner.num_leaves - 1,
                    run["kernel_launches"]))
            out[tag] = run
    out["forced"] = want
    emit(out)


OBSERVE_ITERS = 4


def phase_observe_train(ctx) -> None:
    """Training observability and crash-safe resume on the card: the wave
    cell (held-out set) for OBSERVE_ITERS iterations with telemetry,
    trace_out, telemetry_sync_every=2 and profile_trace_dir (the report
    schema-valid, the sampled legs covering the synced iteration within
    0.1, every kernel the run launched in the profile and attributed to a
    leg, the wave learner's counters); then, per learner (wave, compact),
    a bagged pipelined run killed by train.crash:nth=3 with
    snapshot_freq=2 and resumed: model text equal to the uninterrupted
    run's."""
    import os
    import tempfile

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.native import KERNEL_SYMBOLS
    from lightgbm_tpu_torch.observability import load_schema, validate_report
    from lightgbm_tpu_torch.reliability import faults
    from lightgbm_tpu_torch.reliability.resume import list_snapshots

    ds, dv = _dataset(ctx)
    out = {"phase": "observe_train"}
    with tempfile.TemporaryDirectory() as tmp:
        params = dict(WAVE_PARAMS, telemetry=True, telemetry_sync_every=2,
                      trace_out=f"{tmp}/trace.json",
                      telemetry_out=f"{tmp}/report.json",
                      profile_trace_dir=f"{tmp}/prof")
        counters = wave_counters()
        for fn in counters.values():             # counts of the main path
            fn.launches = 0
        t0 = time.perf_counter()
        bst = lt.train(params, ds, OBSERVE_ITERS, valid_sets=[dv],
                       valid_names=["heldout"], verbose_eval=False)
        train_s = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        with open(f"{tmp}/report.json") as fh:
            rep = json.load(fh)
        errs = validate_report(rep, load_schema())
        check(not errs, f"observe_train: the report breaks the schema: "
              f"{errs[:5]}")
        check(rep["iterations"]["count"] == OBSERVE_ITERS,
              f"observe_train: {rep['iterations']['count']} iterations")
        table = rep["distributed"]["attribution"]
        check(abs(1.0 - table["coverage"]) <= 0.1,
              f"observe_train: attribution coverage {table['coverage']}")
        prof = rep["distributed"]["profile"]
        check(prof is not None and prof["device_events"],
              "observe_train: the profile holds no device event")
        seen = prof["kernels"]
        for name, n in launches.items():
            legs = seen.get(name)
            check(n == 0 or (legs and "other" not in legs),
                  f"observe_train: kernel {name} ({KERNEL_SYMBOLS[name]}, "
                  f"{n} launches) is not attributed to a leg: {legs}")
        with open(f"{tmp}/trace.json") as fh:
            spans = {e["name"] for e in json.load(fh)["traceEvents"]
                     if e.get("ph") == "B"}
        check({"iteration", "gradients", "tree_train"} <= spans,
              f"observe_train: the trace lacks phase spans: {spans}")
        c = rep["counters"]
        check(c["trees_measured"] == OBSERVE_ITERS
              and c["total_splits"] >= c["pops"] > 0,
              f"observe_train: device counters {c}")
        out["telemetry"] = {
            "train_s": train_s, "kernel_launches": launches,
            "iterations": rep["iterations"], "counters": c,
            "attribution": table,
            "profile": {k: prof[k] for k in ("events", "total_ms",
                                              "legs_ms", "kernels")},
            "phases_ms": {k: v["total_ms"] for k, v in rep["phases"].items()},
            "trace_spans": sorted(spans)}
        # crash-safe resume: a bagged run killed after iteration 3 with a
        # snapshot every 2, resumed, against the uninterrupted run (the
        # pipelined loop: no held-out set)
        for learner in ("wave", "compact"):
            p = dict(WAVE_PARAMS, tpu_learner=learner, bagging_fraction=0.8,
                     bagging_freq=1, feature_fraction=0.9)
            model = f"{tmp}/{learner}.txt"
            t0 = time.perf_counter()
            full = lt.train(dict(p), ds, OBSERVE_ITERS,
                            verbose_eval=False).model_to_string()
            t1 = time.perf_counter()
            crashed = False
            try:
                lt.train(dict(p, output_model=model, snapshot_freq=2,
                              fault_spec="train.crash:nth=3"), ds,
                         OBSERVE_ITERS, verbose_eval=False)
            except faults.InjectedFault:
                crashed = True
            finally:
                faults.reset()
            check(crashed, f"observe_train/{learner}: train.crash did not "
                  f"fire")
            snaps = [it for it, _ in list_snapshots(model)]
            check(snaps == [2], f"observe_train/{learner}: snapshots {snaps}")
            t2 = time.perf_counter()
            res = lt.train(dict(p, output_model=model, snapshot_freq=2,
                                resume=True), ds, OBSERVE_ITERS,
                           verbose_eval=False)
            t3 = time.perf_counter()
            check(type(res.gbdt.learner).__name__.lower().startswith(learner)
                  and res.gbdt._can_pipeline(),
                  f"observe_train/{learner}: {type(res.gbdt.learner)}")
            check(res.model_to_string() == full,
                  f"observe_train/{learner}: the resumed model text differs "
                  f"from the uninterrupted run's")
            out[f"resume_{learner}"] = {
                "snapshots": snaps, "resumed_text_equal": True,
                "trees": res.num_trees(), "uninterrupted_s": t1 - t0,
                "resumed_s": t3 - t2,
                "state_bytes": os.path.getsize(f"{model}.snapshot_iter_2"
                                               ".state.pkl")}
    emit(out)


def weighted_rows(w: torch.Tensor) -> torch.Tensor:
    """Rows with any of their three weights not zero (NaN counts), as a
    device scalar."""
    return torch.count_nonzero(w.ne(0).any(dim=0))


def phase_masked_train(ctx) -> None:
    import lightgbm_tpu_torch.learner as lm
    from lightgbm_tpu_torch.learner import MaskedTreeLearner
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full

    counters = {"hist_full": build_histogram_full}
    data = _dataset_masked(ctx)
    # every hist_full launch's weighted rows, kept as device scalars and
    # read after the run (a few device ops per launch, no host read)
    active = []
    with recording(lm, "build_histogram",
                   lambda bins, w, dp=False, **kw: dp or active.append(
                       weighted_rows(w))):
        bst, learner, _, out = _train_run(ctx, MASKED_PARAMS,
                                          "masked_train", counters,
                                          data=data)
    active = torch.stack(
        active[:out["kernel_launches"]["hist_full"]]).cpu().tolist()
    check(type(learner) is MaskedTreeLearner,
          f"max_bin={MASKED_BINS} did not route to the masked learner")
    check(learner.bins.dtype == torch.uint16,
          f"the masked learner reads {learner.bins.dtype} codes, not uint16")
    calls = learner.kernel_calls["hist_full"]
    want = len(bst.gbdt.models) * learner.num_leaves
    check(out["kernel_launches"]["hist_full"] == calls == want,
          f"hist_full launches {out['kernel_launches']} != the learner's "
          f"calls {calls} != trees x num_leaves {want}")
    check(out["host_syncs_per_tree"] <= 2,
          f"{out['host_syncs_per_tree']} host syncs per tree")
    check(len(active) == calls, "a hist_full launch was not recorded")
    n = int(learner.bins.shape[1])
    ctx["shapes_masked_train"] = size_shapes(
        active, "weighted_rows",
        lambda i: {"rows": n, "share": active[i] / n})
    out["shapes"] = {"hist_full": ctx["shapes_masked_train"]}
    out["launches_expected"] = want
    out["num_bins"] = int(bst.gbdt.train_data.max_num_bin)
    out["bin_s"] = ctx["bin_s_masked"]
    if "auc_wave" in ctx:
        out["auc_gap_to_wave_B255"] = out["heldout_auc"][-1] \
            - ctx["auc_wave"][-1]
    out["pipelined"] = masked_pipelined(data[0], bst)
    ctx["launches_masked"] = out["kernel_launches"]
    emit(out)


def masked_pipelined(ds, sync_bst, iters: int = 3) -> dict:
    """The masked learner without a held-out set: the pipelined loop, at a
    flush depth of 1 so that the loop's rolling flush runs.  No record is
    read in the loop, each tree is built one iteration late, and the first
    tree's model text is the synchronous run's."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner import MaskedTreeLearner

    bst = lt.Booster(dict(MASKED_PARAMS, tpu_pipeline_flush_depth=1), ds)
    gbdt = bst.gbdt
    check(type(gbdt.learner) is MaskedTreeLearner and gbdt._can_pipeline(),
          "the masked learner without a held-out set does not pipeline")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        bst.update()
    reads, waits = gbdt.learner.host_syncs, gbdt.pipeline_waits
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trees = gbdt.models
    check(reads == 0 and waits == iters - 1,
          f"masked pipelined loop: {reads} blocking record reads, {waits} "
          f"record waits (want 0 and {iters - 1})")
    check(len(trees) == iters and all(t.num_leaves > 1 for t in trees),
          f"masked pipelined loop: {len(trees)} trees")
    check(trees[0].to_string() == sync_bst.gbdt.models[0].to_string(),
          "the masked learner's first pipelined tree differs from the "
          "synchronous run's")
    return {"iterations": iters, "flush_depth": 1,
            "record_reads_in_loop": reads, "record_waits_in_loop": waits,
            "trees_leaves": [t.num_leaves for t in trees],
            "s_per_iter": wall / iters, "first_tree_text_equal": True}


def _wave_booster(ctx):
    """The wave_train booster, or 5 iterations of the default learner when
    that phase did not run."""
    if "bst_wave" not in ctx:
        import lightgbm_tpu_torch as lt

        ds, _ = _dataset(ctx)
        ctx["bst_wave"] = lt.train(WAVE_PARAMS, ds, 5, verbose_eval=False)
    return ctx["bst_wave"]


def phase_predict(ctx) -> None:
    import copy

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.binner import BinnerArrays, bin_predict
    from lightgbm_tpu_torch.dataset import upload
    from lightgbm_tpu_torch.predictor import DevicePredictor

    bst = _wave_booster(ctx)
    gbdt, data, Xv = bst.gbdt, bst.gbdt.train_data, ctx["Xv"]
    dev = torch.device("cuda", 0)
    host = np.zeros(len(Xv))
    for t in gbdt.models:
        host += t.predict(Xv)
    dp = DevicePredictor(gbdt, data)
    # the main path: the raw rows uploaded, binned by the bin_predict
    # kernel, traversed; bin_host never called
    host_calls = BinnerArrays.host_calls
    bin_predict.launches = 0
    raw = dp.predict_raw(Xv)
    launches = {"bin_predict": bin_predict.launches}
    ctx["launches_predict"] = launches
    check(launches["bin_predict"] == 1,
          f"predict launched bin_predict {launches['bin_predict']} times")
    diff = float(np.abs(raw - host).max())
    check(diff <= 1e-9, f"DevicePredictor vs host trees: {diff}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp.predict_raw(Xv)                   # warm: upload, bin, walk, read
    predict_s = time.perf_counter() - t0
    check(BinnerArrays.host_calls == host_calls,
          "the device predict path called bin_host")
    arrs = BinnerArrays.for_data(data)
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32, device=dev)
    upload_ms = cuda_ms(lambda: upload(Xv, dev), 5, flush)
    x = upload(Xv, dev)
    bin_ms = cuda_ms(lambda: arrs.bin_device(x, dev), 5, flush)
    bins = arrs.bin_device(x, dev)
    check(torch.equal(bins.cpu(), torch.from_numpy(arrs.bin_host(Xv))),
          "device codes differ from bin_host's")
    t0 = time.perf_counter()
    arrs.bin_host(Xv)
    bin_host_s = time.perf_counter() - t0
    traverse_ms = cuda_ms(lambda: dp.predict_binned(bins), 5, flush)
    # prediction early stop, checked after every tree, with a margin that
    # freezes about half the rows after the first
    es = dict(pred_early_stop=True, pred_early_stop_freq=1,
              pred_early_stop_margin=float(np.median(
                  2.0 * np.abs(gbdt.models[0].predict(Xv)))))
    on_card = DevicePredictor(gbdt, data, **es).predict_raw(Xv)
    on_cpu_gbdt = copy.copy(gbdt)
    on_cpu_gbdt.device = torch.device("cpu")
    on_cpu = DevicePredictor(on_cpu_gbdt, data, **es).predict_raw(Xv)
    off_cpu = DevicePredictor(on_cpu_gbdt, data).predict_raw(Xv)
    frozen = on_card != raw
    check(0 < int(frozen.sum()) < len(Xv),
          f"pred_early_stop froze {int(frozen.sum())} rows")
    check(np.array_equal(frozen, on_cpu != off_cpu),
          "pred_early_stop froze other rows on the card than on the CPU")
    es_diff = float(np.abs(on_card - on_cpu).max())
    check(es_diff <= 1e-9, f"pred_early_stop card vs CPU: {es_diff}")
    # the model through its text: a bin schema rebuilt from the thresholds
    loaded = lt.Booster(model_str=bst.model_to_string())
    lraw = loaded.predict(Xv, raw_score=True)
    check(loaded.gbdt.device_predictions == 1
          and loaded.gbdt._pred_schema[0] is not None,
          "the text-loaded booster did not predict on the card")
    ldiff = float(np.abs(lraw - raw).max())
    check(ldiff <= 1e-9, f"text-loaded booster vs trained: {ldiff}")
    emit({"phase": "predict", "rows": len(Xv), "trees": dp.T,
          "depth": dp.depth, "vs_host_max_diff": diff,
          "kernel_launches": launches, "bin_host_calls": 0,
          "predict_raw_s": predict_s,
          "rows_per_s_with_device_binning": len(Xv) / predict_s,
          "upload_ms": upload_ms, "bin_kernel_ms": bin_ms,
          "bin_host_s": bin_host_s, "traverse_ms": traverse_ms,
          "rows_per_s_device_traversal": len(Xv) / traverse_ms * 1e3,
          "early_stop": {"margin": es["pred_early_stop_margin"],
                         "frozen_rows": int(frozen.sum()),
                         "card_vs_cpu_max_diff": es_diff,
                         "same_frozen_rows": True},
          "text_loaded_vs_trained_max_diff": ldiff,
          "nvidia_smi": ctx.get("smi")})


#: the serve phase's row ladder, clients and traffic seconds
SERVE_MIN, SERVE_MAX, SERVE_CLIENTS, SERVE_SECONDS = 32, 1024, 8, 10.0


def _serve_traffic(port: int, Xv, seconds: float, swap_text: str, seed: int):
    """``SERVE_CLIENTS`` client threads sending predicts of 1 to
    ``SERVE_MAX`` held-out rows (one request in ten with 20% of its values
    NaN and its first row all NaN) for ``seconds``; halfway through, one
    more client swaps ``swap_text`` in over the wire.  Returns every
    request's (sent, answered, rows, scores), the swap's (start, end) and
    the errors."""
    import threading

    from lightgbm_tpu_torch.serving import ServingClient

    records, errors, lock = [], [], threading.Lock()
    t_end = time.perf_counter() + seconds

    def client(i: int) -> None:
        rng = np.random.RandomState(seed + i)
        try:
            with ServingClient("127.0.0.1", port, timeout=60) as c:
                while time.perf_counter() < t_end:
                    X = Xv[rng.randint(0, len(Xv), rng.randint(1, SERVE_MAX
                                                               + 1))]
                    if rng.rand() < 0.1:
                        X = X.copy()
                        X[rng.rand(*X.shape) < 0.2] = np.nan
                        X[0] = np.nan
                    t0 = time.perf_counter()
                    got = c.predict(X, raw_score=True)
                    with lock:
                        records.append((t0, time.perf_counter(), X, got))
        except Exception as e:             # reported, then raised below
            with lock:
                errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    time.sleep(seconds / 2)
    with ServingClient("127.0.0.1", port, timeout=120) as c:
        s0 = time.perf_counter()
        version = c.swap(swap_text)
        swap = (s0, time.perf_counter(), version)
    for t in threads:
        t.join(seconds + 120)
        check(not t.is_alive(), "a serve client did not finish")
    return records, swap, errors


def phase_serve(ctx) -> None:
    """The prediction server on the card: warm one CUDA graph per bucket,
    serve client threads, swap a second model in mid-traffic, check every
    response against the host trees and every replay against the eager
    path."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.binner import bin_plain, bin_predict
    from lightgbm_tpu_torch.observability import validate_report
    from lightgbm_tpu_torch.serving import ServingClient
    from lightgbm_tpu_torch.serving.batcher import bucket_ladder

    bst = _wave_booster(ctx)
    ds, _ = _dataset(ctx)
    Xv = ctx["Xv"]
    dev = torch.device("cuda", 0)
    bst2 = lt.train(dict(WAVE_PARAMS, num_leaves=63), ds, 3,
                    verbose_eval=False)
    buckets = bucket_ladder(SERVE_MIN, SERVE_MAX)
    # the main path: counts zeroed, the server started (warmup: one eager
    # run and one capture per bucket), traffic, the swap's warmup
    bin_predict.launches = 0
    t0 = time.perf_counter()
    server = bst.serve(port=0, max_batch_rows=SERVE_MAX,
                       min_bucket=SERVE_MIN, deadline_ms=2.0, trace=True)
    start_s = time.perf_counter() - t0
    try:
        m1 = server.registry.get()
        check(m1.device == dev and m1.jit_entries() == len(buckets)
              and m1.replays == len(buckets) + 1 and m1.eager_batches == 0,
              f"warmup: {m1.jit_entries()} graphs, {m1.replays} replays")
        t0 = time.perf_counter()
        records, swap, errors = _serve_traffic(
            server.port, Xv, SERVE_SECONDS, bst2.model_to_string(), 16)
        traffic_s = time.perf_counter() - t0
        check(not errors, f"serve clients failed: {errors[:3]}")
        with ServingClient("127.0.0.1", server.port) as c:
            rep = c.stats()
            text = c.metrics()
            health = c.health()
        m2 = server.registry.get()
        entries = server.registry.jit_entries()
    finally:
        server.stop()
    launches = {"bin_predict": bin_predict.launches}
    ctx["launches_serve"] = launches
    srv = rep["serving"]
    check(swap[2] == 2 and m2 is not m1 and m2.version == 2,
          f"swap: version {swap[2]}")
    check(srv["fallback_batches"] == 0 and srv["errors"] == 0
          and srv["shed"] == 0, f"fallbacks {srv['fallback_batches']}, "
          f"errors {srv['errors']}, sheds {srv['shed']}")
    check(srv["compile_cache"]["misses"] == 2 * len(buckets),
          f"compile-cache misses {srv['compile_cache']} for 2 versions of "
          f"{len(buckets)} buckets")
    check(entries == m1.jit_entries() == m2.jit_entries() == len(buckets)
          and srv["compile_cache"]["jit_entries"] == len(buckets),
          f"graphs after the traffic: {entries}")
    replays = m1.replays + m2.replays - 2 * (len(buckets) + 1)
    check(replays == srv["batches"] and m1.eager_batches == 0
          and m2.eager_batches == 0,
          f"{replays} graph replays for {srv['batches']} batches")
    check(launches["bin_predict"] == 2 * len(buckets) + m1.replays
          + m2.replays, f"bin_predict launches {launches}")
    check(validate_report(rep) == [], f"report: {validate_report(rep)[:3]}")
    check("lgbt_serving_requests_total" in text
          and "lgbt_serving_request_latency_seconds_bucket" in text,
          "the metrics page did not render")
    check(health["ready"] and not health["shedding"], f"health {health}")
    check(srv["requests"] == len(records), f"{srv['requests']} requests "
          f"served, {len(records)} answered")
    # every response against the host trees and Booster.predict of the
    # model that served it (either one for a request during the swap)
    before = [r for r in records if r[1] < swap[0]]
    after = [r for r in records if r[0] > swap[1]]
    during = [r for r in records if r[1] >= swap[0] and r[0] <= swap[1]]
    worst = 0.0
    for group, models in ((before, [(m1, bst)]), (after, [(m2, bst2)]),
                          (during, [(m1, bst), (m2, bst2)])):
        if not group:
            continue
        X = np.concatenate([r[2] for r in group])
        got = np.concatenate([r[3] for r in group])
        refs = [(m.host_raw(X), b.predict(X, raw_score=True))
                for m, b in models]
        ofs = 0
        for r in group:
            n = len(r[2])
            g = got[ofs:ofs + n]
            fits = [np.allclose(g, h[ofs:ofs + n], rtol=1e-6, atol=1e-6)
                    and np.allclose(g, p[ofs:ofs + n], rtol=1e-6, atol=1e-6)
                    for h, p in refs]
            diff = min(float(np.abs(g - h[ofs:ofs + n]).max())
                       for h, _ in refs)
            check(any(fits), f"a response of {n} rows differs from the "
                  f"host trees of the model that served it by {diff}")
            worst = max(worst, diff)
            ofs += n
    check(before and after, f"{len(before)} requests before the swap, "
          f"{len(after)} after")
    # each bucket's replay of both models bitwise against the eager path on
    # the card and against bin_plain + the traversal; the bench model's
    # replay and eager ms
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32, device=dev)
    rng = np.random.RandomState(3)
    per_bucket = {}
    for b in buckets:
        Xpad = Xv[rng.randint(0, len(Xv), b)]
        Xpad[rng.rand(*Xpad.shape) < 0.05] = np.nan
        for m in (m1, m2):
            got = m.predict_padded(np.ascontiguousarray(Xpad), b)
            x = torch.from_numpy(Xpad).to(dev)
            eager = m.predictor.predict_binned(bin_predict(x, m.dev_arrays))
            plain = m.predictor.predict_binned(bin_plain(x, m.dev_arrays))
            check(np.array_equal(got, eager[0].cpu().numpy())
                  and np.array_equal(got, plain[0].cpu().numpy()),
                  f"bucket {b}, version {m.version}: the graph replay "
                  f"differs from the eager path")
        g = m1._graphs[b]
        per_bucket[str(b)] = {
            "replay_ms": cuda_ms(g.graph.replay, 20, flush),
            "eager_ms": cuda_ms(lambda: m1._run(g.x), 20, flush),
            "batches": srv["buckets"].get(str(b), 0)}
    # bin_predict at the serve path's small shapes over the bench model's
    # arrays (255 bins), the predict shape's 37-row cut among them
    a = m1.dev_arrays
    bins = {}
    for n in (SERVE_MIN, 37, SERVE_MAX):
        x = torch.from_numpy(np.ascontiguousarray(Xv[:n])).to(dev)
        bins[str(n)] = dict(_time_bin_predict(x, a, flush), device_ms=(
            _device_ms(lambda: bin_predict(x, a), "bin_predict_rows",
                       spins=OPEN_SPINS, reps=50)))
    ctx["timing_serve_bin"] = bins
    lat = np.array([r[1] - r[0] for r in records]) * 1e3
    rows = sum(len(r[2]) for r in records)
    stage = {k: v["total_ms"] / max(v["count"], 1)
             for k, v in srv["stage_ms"].items()}
    emit({"phase": "serve", "nvidia_smi": ctx.get("smi"),
          "buckets": buckets, "clients": SERVE_CLIENTS,
          "start_s": start_s, "traffic_s": traffic_s,
          "requests": len(records), "rows": rows,
          "qps": len(records) / traffic_s, "rows_per_s": rows / traffic_s,
          "client_latency_ms": {f"p{q}": float(np.percentile(lat, q))
                                for q in (50, 95, 99)},
          "server_latency_ms": srv["latency_ms"],
          "stage_mean_ms": stage, "batches": srv["batches"],
          "batch_occupancy": srv["batch_occupancy"],
          "bucket_batches": srv["buckets"],
          "swap": {"version": swap[2], "s": swap[1] - swap[0],
                   "requests_before": len(before),
                   "requests_during": len(during),
                   "requests_after": len(after)},
          "vs_host_max_diff": worst, "graphs": entries,
          "graph_replays": replays, "kernel_launches": launches,
          "fallback_batches": 0, "errors": 0, "shed": 0,
          "per_bucket": per_bucket,
          "bin_predict": bins,
          "provenance": rep["provenance"]})


#: the fleet phase: replicas on the one card, client threads (half binary,
#: half pickle), the replica fault's cooldown, the recorder window, the
#: autopilot refit's rounds and the refit's train rows
FLEET_REPLICAS, FLEET_CLIENTS, FLEET_RECOVERY_S = 2, 8, 2.0
FLEET_RECORD_ROWS, FLEET_REFIT_ROUNDS = 4096, 3
#: requests of the steady window (no fault, roll or refit), the one to set
#: beside phase serve's single server
FLEET_STEADY_REQUESTS = 3000


class _FleetTraffic:
    """``FLEET_CLIENTS`` client threads, half over the binary framing and
    half over the pickle framing, sending predicts of 1 to ``SERVE_MAX``
    held-out rows (rounded to float32, which the binary frames carry; one
    request in ten with 20% of its values NaN) until stopped; with
    ``shift`` set, feature 0 is moved by that much.  Every request's
    (sent, answered, rows, scores) is kept."""

    def __init__(self, port: int, Xv, seed: int):
        import threading

        self.port, self.Xv, self.seed = port, Xv, seed
        self.shift = 0.0
        self.records, self.errors = [], []
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.threads = [threading.Thread(target=self._client, args=(i,))
                        for i in range(FLEET_CLIENTS)]
        for t in self.threads:
            t.start()

    def _client(self, i: int) -> None:
        from lightgbm_tpu_torch.serving import ServingClient

        rng = np.random.RandomState(self.seed + i)
        proto = "binary" if i % 2 else "pickle"
        try:
            with ServingClient("127.0.0.1", self.port, timeout=120,
                               protocol=proto, retries=0) as c:
                while not self.stop.is_set():
                    X = self.Xv[rng.randint(0, len(self.Xv),
                                            rng.randint(1, SERVE_MAX + 1))]
                    X = X.astype(np.float32).astype(np.float64)
                    if rng.rand() < 0.1:
                        X[rng.rand(*X.shape) < 0.2] = np.nan
                    X[:, 0] += self.shift
                    t0 = time.perf_counter()
                    got = c.predict(X, raw_score=True)
                    with self.lock:
                        self.records.append((t0, time.perf_counter(), X,
                                             got))
        except Exception as e:             # reported, then raised
            with self.lock:
                self.errors.append(f"client {i} ({proto}): "
                                   f"{type(e).__name__}: {e}")

    def count(self) -> int:
        with self.lock:
            return len(self.records)

    def wait(self, n: int, timeout: float = 120.0) -> None:
        """Until ``n`` more requests have been answered."""
        want, t_end = self.count() + n, time.perf_counter() + timeout
        while self.count() < want and not self.errors:
            check(time.perf_counter() < t_end, "fleet traffic stalled")
            time.sleep(0.01)
        check(not self.errors, f"fleet clients failed: {self.errors[:3]}")

    def join(self) -> None:
        self.stop.set()
        for t in self.threads:
            t.join(180)
            check(not t.is_alive(), "a fleet client did not finish")
        check(not self.errors, f"fleet clients failed: {self.errors[:3]}")


def _scrape(port: int) -> str:
    """One plain-HTTP ``GET /metrics`` on the gateway's port."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(b"GET /metrics HTTP/1.0\r\nHost: chip\r\n\r\n")
        buf = b""
        while True:
            d = s.recv(1 << 16)
            if not d:
                break
            buf += d
    head, _, body = buf.partition(b"\r\n\r\n")
    check(head.startswith(b"HTTP/1.0 200"), f"scrape: {head[:60]!r}")
    return body.decode()


def _shadow_numbers(report) -> dict:
    """A shadow report's rows, verdict, mean divergence and p50 latency
    ratio (candidate over incumbent)."""
    gates = report.get("gates", {})
    return {"rows": report.get("rows"), "passed": report.get("passed"),
            "divergence_mean": gates.get("divergence", {}).get("mean"),
            "latency_ratio": gates.get("latency", {}).get("ratio")}


def phase_fleet(ctx) -> None:
    """The serving fleet on the card: a ``FleetServer`` of two replicas on
    cuda:0 (one CUDA graph of bin_predict + the traversal per bucket and
    replica), client threads over the binary and the pickle framing and an
    HTTP scrape; ``serving.replica_fault`` ejecting replica 1 and its
    recovery; a rolling promotion of a second model under traffic and the
    fleet's rollback; one autopilot cycle on traffic with feature 0 moved
    by 6 standard deviations: a refit of ``FLEET_REFIT_ROUNDS`` rounds on
    the card through the wave learner's kernels (its split passes captured
    while the replicas replay), shadowed and rolled out to both replicas.
    Every response against the host trees of the versions live while it
    was in flight; every kernel of the path launched; each replica's
    bucket replays bitwise against bin_predict eagerly and bin_plain."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.binner import bin_plain, bin_predict
    from lightgbm_tpu_torch.lifecycle import (Autopilot, LifecycleController,
                                              RefitBudget)
    from lightgbm_tpu_torch.observability import validate_report
    from lightgbm_tpu_torch.reliability import faults
    from lightgbm_tpu_torch.serving import FleetServer, ServingClient
    from lightgbm_tpu_torch.serving.batcher import bucket_ladder

    t_phase = time.perf_counter()
    bst = _wave_booster(ctx)
    ds, _ = _dataset(ctx)
    Xv = ctx["Xv"]
    dev = torch.device("cuda", 0)
    bst2 = lt.train(dict(WAVE_PARAMS, num_leaves=63), ds, 3,
                    verbose_eval=False)
    buckets = bucket_ladder(SERVE_MIN, SERVE_MAX)
    counters = dict(wave_counters(), bin_predict=bin_predict)
    # set-up: the 1M-row dataset and the served model (shared with phase
    # serve in a full run, built here when the phase runs alone) and the
    # second model
    out = {"phase": "fleet", "nvidia_smi": ctx.get("smi"),
           "replicas": FLEET_REPLICAS, "clients": FLEET_CLIENTS,
           "buckets": buckets, "setup_s": time.perf_counter() - t_phase}
    # the main path: counts zeroed, the fleet started (each replica's
    # warmup: one eager run and one capture per bucket), traffic, the
    # fault, the roll, the rollback, the autopilot's refit and roll
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    srv = FleetServer(booster=bst, replicas=FLEET_REPLICAS, port=0,
                      max_batch_rows=SERVE_MAX, min_bucket=SERVE_MIN,
                      deadline_ms=2.0, recovery_s=FLEET_RECOVERY_S,
                      record_rows=FLEET_RECORD_ROWS, drift_min_rows=256)
    srv.start()
    out["start_s"] = time.perf_counter() - t0
    reps = srv.replicas.replicas
    traffic = None
    timeline = []              # (t, the versions live from t on)
    try:
        m1 = [r.registry.get() for r in reps]
        check(all(r.device == dev for r in reps)
              and m1[0] is not m1[1], "replicas not on cuda:0")
        check(all(m.jit_entries() == len(buckets)
                  and m.replays == len(buckets) + 1 and m.eager_batches == 0
                  for m in m1),
              f"warmup: graphs {[m.jit_entries() for m in m1]}, replays "
              f"{[m.replays for m in m1]}, eager "
              f"{[m.eager_batches for m in m1]}")
        timeline.append((0.0, [m1[0]]))
        traffic = _FleetTraffic(srv.port, Xv, 40)
        t_traffic = time.perf_counter()
        traffic.wait(FLEET_STEADY_REQUESTS)
        page = _scrape(srv.port)
        check("lgbt_serving_replica_healthy:1 1" in page
              and "lgbt_serving_tenant_requests_total" in page,
              "the /metrics page lacks the replica or tenant series")
        snap = srv.replicas.section()
        check(all(s["dispatched"] > 0 for s in snap),
              f"dispatch {[s['dispatched'] for s in snap]}")
        # replica 1 faulted: its batches re-score on the host, it ejects,
        # replica 0 takes the traffic, and the cooldown re-admits it
        faults.arm("serving.replica_fault:rank=1:count=-1")
        t_fault = time.perf_counter()
        while srv.replicas.section()[1]["ejections"] < 1:
            check(time.perf_counter() - t_fault < 60, "replica 1 never "
                  "ejected")
            time.sleep(0.005)
        t_eject = time.perf_counter()
        d0 = [s["dispatched"] for s in srv.replicas.section()]
        traffic.wait(100)
        d1 = [s["dispatched"] for s in srv.replicas.section()]
        faults.disarm()
        out_fault = {"ejected_after_s": t_eject - t_fault,
                     "dispatched_while_ejected": [b - a for a, b in
                                                  zip(d0, d1)]}
        # a dispatch that raced the ejection may still land on replica 1
        check(d1[1] - d0[1] <= FLEET_CLIENTS and d1[0] - d0[0] >= 50,
              f"while replica 1 was out: {out_fault}")
        while not reps[1].healthy():
            check(time.perf_counter() - t_eject < FLEET_RECOVERY_S + 30,
                  "replica 1 never re-admitted")
            time.sleep(0.01)
        out_fault["recovered_after_s"] = time.perf_counter() - t_eject
        traffic.wait(200)
        d2 = [s["dispatched"] for s in srv.replicas.section()]
        check(d2[1] > d1[1], "replica 1 took no traffic after recovery")
        out_fault["ejections"] = [s["ejections"] for s in
                                  srv.replicas.section()]
        out["replica_fault"] = out_fault
        # a rolling promotion of a second model under traffic at the
        # gateway's gates, then the fleet's rollback
        traffic.wait(100)
        t0 = time.perf_counter()
        roll = srv.promote_rolling(model_str=bst2.model_to_string())
        t1 = time.perf_counter()
        check(roll["committed"], f"promotion: {roll}")
        m2 = [r.registry.get() for r in reps]
        timeline.append((t0, [m1[0], m2[0]]))
        timeline.append((t1, [m2[0]]))
        traffic.wait(200)
        t2 = time.perf_counter()
        back = srv.rollback_fleet()
        t3 = time.perf_counter()
        check(all(r.registry.get() is m for r, m in zip(reps, m1)),
              f"rollback: {back}")
        timeline.append((t2, [m1[0], m2[0]]))
        timeline.append((t3, [m1[0]]))
        out["promotion"] = {"s": t1 - t0, "rollback_s": t3 - t2,
                            "shadow": _shadow_numbers(roll["shadow"]),
                            "gates": roll["gates"],
                            "versions": roll["versions"]}
        # one autopilot cycle: a clean baseline, then feature 0 moved by
        # 6 standard deviations until the recorder holds only moved rows
        traffic.wait(200)
        check(srv.capture_drift_baseline(), "no drift baseline captured")
        traffic.shift = 6.0 * float(np.nanstd(Xv[:, 0]))
        rows0 = srv.recorder.total_rows
        while srv.recorder.total_rows < rows0 + 2 * FLEET_RECORD_ROWS:
            traffic.wait(20)
        ctl = LifecycleController(srv)
        spans = {"parse": 0.0, "bin": 0.0}
        refit = ctl.refit
        refit_s = []

        def timed_refit(*a, **kw):
            t = time.perf_counter()
            try:
                return refit(*a, **kw)
            finally:
                refit_s.append(time.perf_counter() - t)

        ctl.refit = timed_refit

        def train_source():
            X, logit = higgs_latent(ROWS + VALID_ROWS)
            return X[:ROWS], (logit[:ROWS] > 0).astype(np.float64)

        ap = Autopilot(srv, ctl, train_source, consecutive_checks=1,
                       num_boost_round=FLEET_REFIT_ROUNDS,
                       params=dict(WAVE_PARAMS,
                                   bin_construct_sample_cnt=FINDBIN_SAMPLE),
                       budget=RefitBudget(min_spacing_s=0.0))
        t4 = time.perf_counter()
        with timed_calls(spans):
            decision = ap.tick()
        t5 = time.perf_counter()
        check(decision is not None and decision["decision"] == "promoted",
              f"autopilot: {decision}, {ap.section()['decisions'][-3:]}")
        m3 = [r.registry.get() for r in reps]
        check(all(m.version == 2 and m.jit_entries() == len(buckets)
                  for m in m3), "the refit did not roll out to both "
              "replicas")
        # the refit's and the roll's captures ran on the card's capture
        # stream, which is no serving model's stream
        cap = native.capture_stream(dev).cuda_stream
        check(all(m._stream.cuda_stream != cap for m in m1 + m2 + m3),
              "a serving model's stream is the capture stream")
        timeline.append((t4, [m1[0], m3[0]]))
        timeline.append((t5, [m3[0]]))
        traffic.wait(200)
        traffic.join()
        t_end = time.perf_counter()
        with ServingClient("127.0.0.1", srv.port, timeout=120) as c:
            rep = c.stats()
            health = c.health()
            op_page = c.metrics()
        sec = ap.section()
        refit_train_s = refit_s[0] - spans["bin"]
        out["autopilot"] = {
            "decisions": [d["decision"] for d in sec["decisions"]],
            "drift_max_psi": next(d.get("max_psi") for d in
                                  sec["decisions"]
                                  if d["decision"] == "triggered"),
            "cycle_s": t5 - t4, "refit_s": refit_s[0],
            "refit_bin_s": spans["bin"],
            "refit_train_s": refit_train_s,
            "refit_s_per_iteration": refit_train_s / FLEET_REFIT_ROUNDS,
            "gates": {"divergence_max": ctl.divergence_max,
                      "latency_max_ratio": ctl.latency_max_ratio},
            "shadow": _shadow_numbers(ctl.section()["shadow"]),
            "trees": m3[0].booster.num_trees()}
    finally:
        faults.reset()
        if traffic is not None:
            traffic.stop.set()
            for t in traffic.threads:
                t.join(180)
        srv.stop()
    launches = {k: fn.launches for k, fn in counters.items()}
    ctx["launches_fleet"] = launches
    check(all(launches.values()), f"kernels not launched: {launches}")
    srv_sec = rep["serving"]
    check(validate_report(rep) == [], f"report: {validate_report(rep)[:3]}")
    check(health["ready"] and health["replicas_healthy"] == 2
          and health["device_errors"] == {}, f"health {health}")
    check(srv_sec["errors"] == 0 and srv_sec["shed"] == 0,
          f"errors {srv_sec['errors']}, sheds {srv_sec['shed']}")
    check("lgbt_serving_replica_dispatched_total:1" in op_page
          and "lgbt_serving_drift_drifted" in op_page,
          "the metrics op lacks the replica or drift series")
    check(rep["autopilot"]["promoted"] == 1, "autopilot section")
    # every response against the host trees of a version live while it
    # was in flight (replica fault batches were re-scored on the host)
    recs = traffic.records
    check(srv_sec["requests"] >= len(recs), f"{srv_sec['requests']} "
          f"requests served, {len(recs)} answered")
    groups = {}
    for r in recs:
        first = max(i for i, (t, _) in enumerate(timeline) if t <= r[0])
        models = {id(m): m for t, ms in timeline[first:] if t <= r[1]
                  for m in ms}
        groups.setdefault(tuple(sorted(models)), (list(models.values()),
                                                  []))[1].append(r)
    worst = 0.0
    for models, group in groups.values():
        X = np.concatenate([r[2] for r in group])
        got = np.concatenate([r[3] for r in group])
        refs = [m.host_raw(X) for m in models]
        ofs = 0
        for r in group:
            n = len(r[2])
            g = got[ofs:ofs + n]
            diffs = [float(np.abs(g - h[ofs:ofs + n]).max()) for h in refs]
            fits = [np.allclose(g, h[ofs:ofs + n], rtol=1e-6, atol=1e-6)
                    for h in refs]
            check(any(fits), f"a response of {n} rows differs from the "
                  f"host trees of every live version by {min(diffs)}")
            worst = max(worst, min(diffs))
            ofs += n
    # each replica's bucket replays of the refit model bitwise against
    # bin_predict run eagerly and bin_plain, with the traversal
    rng = np.random.RandomState(4)
    for b in buckets[::2] + [buckets[-1]]:
        Xpad = Xv[rng.randint(0, len(Xv), b)]
        Xpad[rng.rand(*Xpad.shape) < 0.05] = np.nan
        for m in m3:
            got = m.predict_padded(np.ascontiguousarray(Xpad), b)
            x = torch.from_numpy(Xpad).to(dev)
            eager = m.predictor.predict_binned(bin_predict(x, m.dev_arrays))
            plain = m.predictor.predict_binned(bin_plain(x, m.dev_arrays))
            check(np.array_equal(got, eager[0].cpu().numpy())
                  and np.array_equal(got, plain[0].cpu().numpy()),
                  f"bucket {b}: a replica's replay differs from the eager "
                  f"path")
    lat = np.array([r[1] - r[0] for r in recs]) * 1e3
    rows = sum(len(r[2]) for r in recs)
    traffic_s = t_end - t_traffic
    # each stage's window: requests answered in it, their rate and the
    # clients' latency percentiles
    windows = {}
    for name, a, b in (("steady", t_traffic, t_fault),
                       ("fault", t_fault, t0), ("roll", t0, t3),
                       ("refit", t4, t5), ("after", t5, t_end)):
        w = np.array([r[1] - r[0] for r in recs if a <= r[1] < b]) * 1e3
        windows[name] = {"s": b - a, "requests": int(len(w)),
                         "qps": len(w) / (b - a),
                         "client_p50_ms": float(np.percentile(w, 50))
                         if len(w) else None,
                         "client_p99_ms": float(np.percentile(w, 99))
                         if len(w) else None}
    replicas = rep["serving"]["replicas"]
    out.update({
        "traffic_s": traffic_s, "requests": len(recs), "rows": rows,
        "qps": len(recs) / traffic_s, "rows_per_s": rows / traffic_s,
        "windows": windows,
        "client_latency_ms": {f"p{q}": float(np.percentile(lat, q))
                              for q in (50, 95, 99)},
        "server_latency_ms": srv_sec["latency_ms"],
        "stage_mean_ms": {k: v["total_ms"] / max(v["count"], 1)
                          for k, v in srv_sec["stage_ms"].items()},
        "batches": srv_sec["batches"],
        "batch_occupancy": srv_sec["batch_occupancy"],
        "fallback_batches": srv_sec["fallback_batches"],
        "per_replica": [{k: r[k] for k in ("index", "dispatched",
                                          "completed", "ejections",
                                          "device_failures")}
                        | {"p99_ms": r["latency_ms"]["p99"]}
                        for r in replicas],
        "graph_replays": [m.replays for m in m1 + m2 + m3],
        "eager_batches": [m.eager_batches for m in m1 + m2 + m3],
        "vs_host_max_diff": worst, "kernel_launches": launches,
        "phase_s": time.perf_counter() - t_phase})
    emit(out)


def _csv_part(args) -> str:
    """Rows of a (label, features) block as CSV lines in ``path``, every
    float in its ``repr`` (the shortest string that parses back to the same
    double)."""
    path, block = args
    with open(path, "w") as fh:
        fh.write("\n".join(",".join(map(repr, r)) for r in block.tolist())
                 + "\n")
    return path


def write_csvs(files, workers: int = 8) -> float:
    """Each ``(path, X, y)`` of ``files`` as CSV, the label then the
    features of every row in ``repr`` floats, formatted by one pool of
    ``workers`` spawned processes (29M floats take about 30 s in one;
    forked ones would inherit this process's CUDA tensors, and freeing one
    there aborts them); returns the seconds."""
    import multiprocessing as mp
    import os

    t0 = time.perf_counter()
    parts = {path: [(f"{path}.part{i}", b) for i, b in enumerate(
        np.array_split(np.column_stack([y, X]), workers))]
        for path, X, y in files}
    with mp.get_context("spawn").Pool(workers) as pool:
        pool.map_async(_csv_part, [p for ps in parts.values() for p in ps]
                       ).get(timeout=600)
    for path, ps in parts.items():
        with open(path, "wb") as out:
            for name, _ in ps:
                with open(name, "rb") as fh:
                    out.write(fh.read())
                os.remove(name)
    return time.perf_counter() - t0


@contextmanager
def timed_calls(spans: dict):
    """Add the seconds of every text parse (``io.parser.load_data_file``)
    to ``spans["parse"]`` and of every dataset binning
    (``_ConstructedDataset.from_matrix`` / ``from_reference``) to
    ``spans["bin"]`` while the block runs."""
    from lightgbm_tpu_torch.dataset import _ConstructedDataset
    from lightgbm_tpu_torch.io import parser

    def timer(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spans[key] += time.perf_counter() - t0
        return run

    load = parser.load_data_file
    methods = {name: _ConstructedDataset.__dict__[name]
               for name in ("from_matrix", "from_reference")}
    parser.load_data_file = timer(load, "parse")
    for name, cm in methods.items():
        setattr(_ConstructedDataset, name,
                classmethod(timer(cm.__func__, "bin")))
    try:
        yield
    finally:
        parser.load_data_file = load
        for name, cm in methods.items():
            setattr(_ConstructedDataset, name, cm)


#: the cli phase's training rows (a tenth of the bench's, for the time
#: limit: its 1M rows made a 554 MB CSV)
CLI_ROWS = 100_000


def phase_cli(ctx) -> None:
    """The port's CLI and its inputs at the bench width: the first
    ``CLI_ROWS`` training and the 100,000 held-out rows written as CSV; 5
    iterations of the default config with a FindBin sample of
    ``FINDBIN_SAMPLE`` rows through ``cli.main`` (the wave learner's kernels);
    ``task=predict`` on the held-out file against ``Booster.predict``;
    ``task=convert_model``; a binary cache and ``two_round`` streaming of
    20,000 held-out rows against their in-memory dataset; ``pred_contrib``
    on 100 rows.  Prints the write, parse, bin and train seconds."""
    import os
    import tempfile

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import cli

    X, logit = higgs_latent(ROWS + VALID_ROWS)
    y = (logit > 0).astype(np.float64)
    Xv = X[ROWS:]
    out = {"phase": "cli"}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        out["write_s"] = write_csvs([
            (f"{tmp}/train.csv", X[:CLI_ROWS], y[:CLI_ROWS]),
            (f"{tmp}/valid.csv", Xv, y[ROWS:]),
            (f"{tmp}/small.csv", Xv[:20_000], y[ROWS:ROWS + 20_000])])
        out["train_csv_mb"] = os.path.getsize(f"{tmp}/train.csv") / 1e6
        conf = dict(WAVE_PARAMS, task="train", data="train.csv",
                    valid="valid.csv", num_iterations=5,
                    bin_construct_sample_cnt=FINDBIN_SAMPLE,
                    output_model="model.txt")
        with open(f"{tmp}/train.conf", "w") as fh:
            fh.write("".join(f"{k} = {v}\n" for k, v in conf.items()))
        spans = {"parse": 0.0, "bin": 0.0}
        counters = wave_counters()
        for fn in counters.values():
            fn.launches = 0
        os.chdir(tmp)
        try:
            with timed_calls(spans):
                t0 = time.perf_counter()
                check(cli.main(["config=train.conf"]) == 0, "cli train")
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        launches = {k: fn.launches for k, fn in counters.items()}
        check(all(launches.values()), f"kernels not launched: {launches}")
        out.update(cli_train_s=total, parse_s=spans["parse"],
                   bin_s=spans["bin"],
                   train_s=total - spans["parse"] - spans["bin"],
                   kernel_launches=launches)
        bst = lt.Booster(model_file=f"{tmp}/model.txt",
                         params=dict(WAVE_PARAMS))
        check(bst.num_trees() == 5, f"{bst.num_trees()} trees")
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            check(cli.main(["task=predict", "data=valid.csv",
                            "input_model=model.txt",
                            "output_result=pred.txt"]) == 0, "cli predict")
            out["cli_predict_s"] = time.perf_counter() - t0
            check(cli.main(["convert_model", "input_model=model.txt",
                            "convert_model=model.cpp"]) == 0,
                  "cli convert_model")
        finally:
            os.chdir(cwd)
        got = np.loadtxt(f"{tmp}/pred.txt")
        # the CLI writes each value with "%g", as the JAX package's does
        want = np.array([float(f"{v:g}") for v in bst.predict(Xv)])
        pdiff = float(np.abs(got - want).max())
        check(got.shape == (VALID_ROWS,) and pdiff <= 1e-9,
              f"task=predict vs Booster.predict: {pdiff}")
        with open(f"{tmp}/model.cpp") as fh:
            src = fh.read()
        check(src.count("double PredictTree") == 5, "convert_model source")
        out.update(predict_max_diff=pdiff, cpp_bytes=len(src))
        # the binary cache and two_round streaming, on the first 20,000
        # held-out rows (host FindBin takes about a second per 100,000
        # distinct values of a feature)
        p = dict(WAVE_PARAMS)
        mem = lt.Dataset(f"{tmp}/small.csv", params=p).construct()
        mem.save_binary(f"{tmp}/small.bin")
        cached = lt.Dataset(f"{tmp}/small.bin", params=p).construct()
        check(np.array_equal(cached.constructed.bins, mem.constructed.bins),
              "binary cache codes")
        trees = [lt.train(p, ds, 1, verbose_eval=False).model_to_string()
                 for ds in (mem, cached)]
        check(trees[0] == trees[1], "the cache trained another first tree")
        streamed = lt.Dataset(f"{tmp}/small.csv", params=dict(
            p, two_round=True, stream_chunk_rows=4096)).construct()
        check(np.array_equal(streamed.constructed.bins, mem.constructed.bins)
              and np.array_equal(streamed.get_label(), mem.get_label()),
              "two_round codes differ from the in-memory dataset's")
        out["binary_cache_mb"] = os.path.getsize(f"{tmp}/small.bin") / 1e6
    t0 = time.perf_counter()
    contrib = bst.predict(Xv[:100], pred_contrib=True)
    out["pred_contrib_s"] = time.perf_counter() - t0
    cdiff = float(np.abs(contrib.sum(axis=1) - bst.predict(
        Xv[:100], raw_score=True)).max())
    check(contrib.shape == (100, FEATURES + 1) and cdiff <= 1e-9,
          f"pred_contrib rows vs the raw score: {cdiff}")
    out.update(pred_contrib_sum_max_diff=cdiff, nvidia_smi=ctx.get("smi"))
    emit(out)


def phase_small(ctx) -> None:
    import lightgbm_tpu_torch as lt

    X, y = higgs_like(20_480, seed=11)
    out = {}
    for dev in ("cuda", "cpu"):
        p = dict(TRAIN_PARAMS, num_leaves=31, device_type=dev)
        ds = lt.Dataset(X[:16_384], label=y[:16_384], params=p)
        dv = ds.create_valid(X[16_384:], label=y[16_384:])
        ev = {}
        lt.train(p, ds, 3, valid_sets=[dv], valid_names=["v"],
                 evals_result=ev, verbose_eval=False)
        out[dev] = ev["v"]
    worst = max(abs(a - b) for m in ("auc", "binary_logloss")
                for a, b in zip(out["cuda"][m], out["cpu"][m]))
    # float32 histograms summed in other orders on the card and the CPU
    check(worst < 1e-4, f"card vs CPU held-out metrics differ by {worst}")
    emit({"phase": "small", "rows": 16_384, "cuda": out["cuda"],
          "cpu": out["cpu"], "max_metric_diff": worst})


#: the objective slice: five classes cut from the latent score, the class
#: count of the reference's examples/multiclass_classification/train.conf
NUM_CLASS = 5
MULTICLASS_PARAMS = dict(WAVE_PARAMS, objective="multiclass",
                         num_class=NUM_CLASS,
                         metric="multi_logloss,multi_error")
#: (objective, extra params) of objectives_train: the rest of the table
OBJECTIVE_CASES = (("regression", {"reg_sqrt": True}), ("regression_l1", {}),
                   ("huber", {}), ("fair", {}), ("poisson", {}),
                   ("quantile", {}), ("mape", {}), ("gamma", {}),
                   ("tweedie", {}), ("multiclassova", {"num_class": 3}),
                   ("cross_entropy", {}), ("cross_entropy_lambda", {}))
RENEWING = ("regression_l1", "quantile", "mape")
#: MS LTR's width (the reference's docs/Experiments.rst): features, queries
#: of 120 synthetic documents, 1,000 held out; its depth cut to a quarter
#: of its 2,270,296 training rows, and host FindBin to a 50,000-row sample
#: (the default 200,000 took about 108 s of the phase's binning, 126 s of
#: its 142 s, with every phase at 1,116 s of the 1,200 s limit on one card)
RANK_ROWS, RANK_FEATURES, RANK_QUERY, RANK_VALID_QUERIES = \
    2_270_296 // 4, 137, 120, 1_000
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "min_data_in_leaf": 20,
               "verbosity": -1, "metric": "ndcg", "eval_at": [1, 3, 5, 10],
               "bin_construct_sample_cnt": 50_000}


@contextmanager
def relabeled(ctx, label):
    """The shared 1M-row training and held-out sets with ``label`` (the
    user's ``Dataset.set_label``; the binned codes are shared), the binary
    labels restored after."""
    ds, dv = _dataset(ctx)
    old = (ds.get_label().copy(), dv.get_label().copy())
    ds.set_label(label[:ROWS])
    dv.set_label(label[ROWS:])
    try:
        yield ds, dv
    finally:
        ds.set_label(old[0])
        dv.set_label(old[1])


def iteration_timer(t_iter):
    """Callbacks that put each iteration's seconds (card synchronised at
    both ends) into ``t_iter``."""
    marks = {}

    def before(env):
        torch.cuda.synchronize()
        marks["t0"] = time.perf_counter()
    before.before_iteration = True

    def after(env):
        torch.cuda.synchronize()
        t_iter.append(time.perf_counter() - marks["t0"])
    after.order = 100
    return [before, after]


def wave_path_checks(tag, bst, launches) -> dict:
    """A run of the default learner: the wave learner with graphs, its
    kernels launched as often as it recorded calls; returns per-tree
    counts."""
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner

    learner = bst.gbdt.learner
    check(type(learner) is WaveTreeLearner and learner.use_graphs,
          f"{tag}: the default learner is not the wave learner with graphs")
    calls = learner.kernel_calls
    check(launches == {n: calls[n] for n in launches},
          f"{tag}: kernel launches {launches} != the learner's calls {calls}")
    for name in ("hist_packed", "hist_segments", "split_scan", "partition",
                 "replay"):
        check(launches[name] > 0, f"{tag}: kernel {name} was not launched")
    trees = len(bst.gbdt.models)
    return {"trees": trees,
            "trees_leaves": [t.num_leaves for t in bst.gbdt.models],
            "kernel_launches": launches,
            "kernel_calls_per_tree": {n: launches[n] / trees
                                      for n in launches},
            "learner_host_syncs_per_tree": learner.host_syncs / trees,
            "renew_reads_per_tree": bst.gbdt.renew_reads / trees,
            "host_syncs_per_tree": (learner.host_syncs
                                    + bst.gbdt.renew_reads) / trees}


def grads_close(card, cpu, tol: float) -> float:
    """Largest difference of the card's gradients from the CPU's, relative
    to the CPU's largest magnitude; checked against ``tol``."""
    worst = 0.0
    for a, b in zip(card, cpu):
        a = a.cpu().to(torch.float64)
        b = b.to(torch.float64)
        worst = max(worst, float((a - b).abs().max()
                                 / max(float(b.abs().max()), 1e-30)))
    check(worst <= tol, f"card vs CPU gradients differ by {worst} (rel)")
    return worst


def cpu_objective(params, metadata, num_data, num_data_padded):
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objectives import create_objective

    obj = create_objective(Config.from_params(params), torch.device("cpu"))
    obj.init(metadata, num_data, num_data_padded)
    return obj


def class_gradients(obj, score):
    """(grad, hess) of every class, as the boosting loop takes them."""
    if obj.name == "multiclass":
        return list(obj.get_gradients_all(score))
    out = []
    for k in range(score.shape[0]):
        out.extend(obj.get_gradients(score[k], k))
    return out


def phase_multiclass_train(ctx) -> None:
    """Five classes at the bench width: the synchronous loop with the
    held-out set, then the pipelined loop without it."""
    import lightgbm_tpu_torch as lt

    iters, k = 5, NUM_CLASS
    _dataset(ctx)
    logit = ctx["logit"]
    cuts = np.quantile(logit[:ROWS], np.linspace(0, 1, k + 1)[1:-1])
    label = np.digitize(logit, cuts).astype(np.float64)
    counters = wave_counters()
    out = {"phase": "multiclass_train", "num_class": k,
           "iterations": iters}
    with relabeled(ctx, label) as (ds, dv):
        evals, t_iter = {}, []
        for fn in counters.values():             # counts of the main path
            fn.launches = 0
        bst = lt.train(MULTICLASS_PARAMS, ds, iters, valid_sets=[dv],
                       valid_names=["heldout"], evals_result=evals,
                       verbose_eval=False, callbacks=iteration_timer(t_iter))
        launches = {n: fn.launches for n, fn in counters.items()}
        gbdt = bst.gbdt
        check(len(gbdt.models) == iters * k,
              f"{len(gbdt.models)} trees, want {iters * k}")
        out.update(wave_path_checks("multiclass_train", bst, launches))
        check(out["host_syncs_per_tree"] == 1,
              f"host syncs per tree {out['host_syncs_per_tree']} (want 1)")
        ll = evals["heldout"]["multi_logloss"]
        check(all(b < a for a, b in zip(ll, ll[1:])),
              f"held-out multi_logloss did not fall: {ll}")
        n_dev = gbdt.device_predictions
        prob = bst.predict(ctx["Xv"])
        check(gbdt.device_predictions == n_dev + 1,
              "Booster.predict did not go through the DevicePredictor")
        check(prob.shape == (VALID_ROWS, k) and np.isfinite(prob).all(),
              f"predictions of shape {prob.shape}, want ({VALID_ROWS}, {k})")
        row_sum = float(np.abs(prob.sum(axis=1) - 1.0).max())
        check(row_sum <= 1e-6, f"probabilities sum to 1 within {row_sum}")
        raw = bst.predict(ctx["Xv"], raw_score=True)
        host = np.zeros((VALID_ROWS, k))
        for i, t in enumerate(gbdt.models):
            host[:, i % k] += t.predict(ctx["Xv"])
        host_diff = float(np.abs(raw - host).max())
        check(host_diff <= 1e-9, f"predictions vs host trees: {host_diff}")
        cpu = cpu_objective(MULTICLASS_PARAMS, ds.constructed.metadata,
                            ds.constructed.num_data,
                            ds.constructed.num_data_padded)
        score = gbdt.train_score.score
        out["grads_card_vs_cpu_rel"] = grads_close(
            class_gradients(gbdt.objective, score),
            class_gradients(cpu, score.cpu()), 1e-6)
        out.update({"heldout_multi_logloss": ll,
                    "heldout_multi_error": evals["heldout"]["multi_error"],
                    "s_per_iter": t_iter,
                    "s_per_iter_after_first": float(np.mean(t_iter[1:])),
                    "predict_shape": list(prob.shape),
                    "prob_row_sum_max_err": row_sum,
                    "predict_vs_host_trees_max_diff": host_diff,
                    "tree_counters": {key: [s[key] for s in
                                            gbdt.learner.tree_stats]
                                      for key in ("flag_waits",
                                                  "graph_launches")}})
        ctx["launches_multiclass"] = launches

        # the same without the held-out set: the pipelined loop
        piped = lt.Booster(MULTICLASS_PARAMS, ds)
        pg = piped.gbdt
        check(pg._can_pipeline(), "multiclass without a held-out set does "
              "not pipeline")
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            piped.update()
        reads_in_loop = pg.learner.host_syncs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trees = pg.models                        # the flush
        plaunches = {n: fn.launches for n, fn in counters.items()}
        check(reads_in_loop == 0, f"{reads_in_loop} blocking record reads "
              f"in the pipelined loop")
        check(len(trees) == iters * k, f"{len(trees)} pipelined trees")
        pout = wave_path_checks("multiclass_pipelined", piped, plaunches)
        same = all(a.to_string() == b.to_string()
                   for a, b in zip(trees[:k], gbdt.models[:k]))
        check(same, "the first iteration's pipelined trees differ from "
              "the synchronous loop's")
        out["pipelined"] = dict(pout, s_per_iter=wall / iters,
                                record_reads_in_loop=reads_in_loop,
                                first_iteration_text_equal=True)
    emit(out)


def objective_label(name: str, logit: np.ndarray) -> np.ndarray:
    """A label valid for ``name`` from the latent score: positive for
    Poisson, Gamma, Tweedie and MAPE, in [0, 1] for the cross-entropies,
    three classes for one-vs-all, the score itself otherwise."""
    if name in ("poisson", "gamma", "tweedie", "mape"):
        return np.exp(0.5 * logit)
    if name.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-logit))
    if name == "multiclassova":
        cuts = np.quantile(logit[:ROWS], [1 / 3, 2 / 3])
        return np.digitize(logit, cuts).astype(np.float64)
    return logit


def phase_objectives_train(ctx) -> None:
    """The rest of the objective table at the bench width, 2 iterations
    each, the held-out set keeping the synchronous loop."""
    import lightgbm_tpu_torch as lt

    iters = 2
    _dataset(ctx)
    counters = wave_counters()
    results, t_phase = {}, time.perf_counter()
    for name, extra in OBJECTIVE_CASES:
        label = objective_label(name, ctx["logit"])
        params = dict(WAVE_PARAMS, objective=name, **extra)
        params.pop("metric")
        with relabeled(ctx, label) as (ds, dv):
            evals, t_iter = {}, []
            for fn in counters.values():
                fn.launches = 0
            bst = lt.train(params, ds, iters, valid_sets=[dv],
                           valid_names=["heldout"], evals_result=evals,
                           verbose_eval=False,
                           callbacks=iteration_timer(t_iter))
            launches = {n: fn.launches for n, fn in counters.items()}
            gbdt = bst.gbdt
            k = gbdt.num_tree_per_iteration
            check(len(gbdt.models) == iters * k,
                  f"{name}: {len(gbdt.models)} trees, want {iters * k}")
            res = wave_path_checks(name, bst, launches)
            want = 2 if name in RENEWING else 1
            check(res["host_syncs_per_tree"] == want,
                  f"{name}: host syncs per tree {res['host_syncs_per_tree']}"
                  f" (want {want})")
            (metric, values), = evals["heldout"].items()
            check(all(np.isfinite(values)), f"{name}: held-out {metric} "
                  f"{values}")
            cpu = cpu_objective(params, ds.constructed.metadata,
                                ds.constructed.num_data,
                                ds.constructed.num_data_padded)
            score = gbdt.train_score.score
            res["grads_card_vs_cpu_rel"] = grads_close(
                class_gradients(gbdt.objective, score),
                class_gradients(cpu, score.cpu()), 1e-6)
            res.update({"metric": metric, "heldout": values,
                        "s_per_iter": t_iter})
            results[name] = res
    emit({"phase": "objectives_train", "iterations": iters,
          "rows": ROWS, "phase_s": time.perf_counter() - t_phase,
          "objectives": results})


def ms_ltr_like(seed: int = 13):
    """Synthetic data at MS LTR's width: 137 dense features, queries of
    120 documents (the training set's last query holds the remainder),
    relevance 0-4 cut from a latent score at its 50/75/90/97th
    percentiles.  Returns (X, label, train groups, held-out groups)."""
    rng = np.random.RandomState(seed)
    n_valid = RANK_VALID_QUERIES * RANK_QUERY
    n = RANK_ROWS + n_valid
    X = rng.randn(n, RANK_FEATURES).astype(np.float32)
    w = rng.randn(8).astype(np.float32)
    latent = X[:, :8] @ w + 0.5 * X[:, 8] * X[:, 9] \
        + rng.randn(n).astype(np.float32)
    label = np.digitize(latent, np.percentile(latent, [50, 75, 90, 97]))
    full, rest = divmod(RANK_ROWS, RANK_QUERY)
    groups = [RANK_QUERY] * full + ([rest] if rest else [])
    return X, label.astype(np.float64), np.asarray(groups), \
        np.full(RANK_VALID_QUERIES, RANK_QUERY)


def phase_rank_train(ctx) -> None:
    """Lambdarank at MS LTR's width, 5 iterations, 1,000 held-out
    queries; CUDA events around every gradient call."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.dataset import Metadata
    from lightgbm_tpu_torch.rank_objective import LambdarankNDCG

    iters = 5
    t0 = time.perf_counter()
    X, label, groups, vgroups = ms_ltr_like()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(X[:RANK_ROWS], label=label[:RANK_ROWS], group=groups,
                    params=RANK_PARAMS)
    dv = ds.create_valid(X[RANK_ROWS:], label=label[RANK_ROWS:],
                         group=vgroups)
    ds.construct()
    dv.construct()
    bin_s = time.perf_counter() - t0
    del X
    counters = wave_counters()
    events = []
    orig = LambdarankNDCG.get_gradients

    def timed(self, score, class_id=0):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(self, score, class_id)
        e1.record()
        events.append((e0, e1))
        return out

    evals, t_iter = {}, []
    LambdarankNDCG.get_gradients = timed
    try:
        for fn in counters.values():
            fn.launches = 0
        bst = lt.train(RANK_PARAMS, ds, iters, valid_sets=[dv],
                       valid_names=["heldout"], evals_result=evals,
                       verbose_eval=False, callbacks=iteration_timer(t_iter))
        launches = {n: fn.launches for n, fn in counters.items()}
    finally:
        LambdarankNDCG.get_gradients = orig
    torch.cuda.synchronize()
    grad_ms = [a.elapsed_time(b) for a, b in events]
    gbdt = bst.gbdt
    check(len(gbdt.models) == iters, f"{len(gbdt.models)} trees")
    check(len(grad_ms) == iters, f"{len(grad_ms)} gradient calls")
    out = {"phase": "rank_train", "rows": RANK_ROWS,
           "features": RANK_FEATURES, "queries": len(groups),
           "query_docs": RANK_QUERY, "heldout_queries": len(vgroups),
           "iterations": iters, "generate_s": gen_s, "bin_s": bin_s}
    out.update(wave_path_checks("rank_train", bst, launches))
    check(out["host_syncs_per_tree"] == 1,
          f"host syncs per tree {out['host_syncs_per_tree']} (want 1)")
    ndcg = {m: v for m, v in evals["heldout"].items()}
    check(set(ndcg) == {"ndcg@1", "ndcg@3", "ndcg@5", "ndcg@10"},
          f"metrics {sorted(ndcg)}")
    check(ndcg["ndcg@10"][-1] > ndcg["ndcg@10"][0],
          f"held-out ndcg@10 did not rise: {ndcg['ndcg@10']}")
    # one query batch of the trained scores on the card and on the CPU
    obj = gbdt.objective
    nq = obj.q_batch
    hi = int(obj.query_boundaries[nq])
    meta = Metadata(hi)
    meta.set_label(label[:hi])
    meta.set_group(groups[:nq])
    pair = []
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        o = LambdarankNDCG(obj.cfg, dev)
        o.init(meta, hi, hi)
        pair.append(o.get_gradients(gbdt.train_score.score[0, :hi].to(dev)))
    batch_diff = max(float((a.cpu() - b).abs().max())
                     for a, b in zip(*pair))
    # near-tied scores give lambdas in the hundreds (delta / (0.01 +
    # |ds|)), where one float32 ulp is 3e-5: the card's and the CPU's exp
    # and reduction orders may differ by an ulp there, so 1e-5 is held
    # relative to the batch's largest magnitude
    scale = max(float(b.abs().max()) for b in pair[1])
    check(batch_diff <= 1e-5 * max(scale, 1.0),
          f"card vs CPU lambdarank gradients differ by {batch_diff} "
          f"(largest magnitude {scale})")
    share = [g / 1e3 / t for g, t in zip(grad_ms, t_iter)]
    out.update({"heldout_ndcg": ndcg, "s_per_iter": t_iter,
                "s_per_iter_after_first": float(np.mean(t_iter[1:])),
                "grad_ms": grad_ms, "grad_share_of_iter": share,
                "q_pad": obj.q_pad, "q_batch": obj.q_batch,
                "grads_batch_queries": nq,
                "grads_card_vs_cpu_max_abs": batch_diff,
                "grads_cpu_max_magnitude": scale,
                "peak_device_bytes": torch.cuda.max_memory_allocated()})
    ctx["launches_rank"] = launches
    emit(out)


def phase_categorical_train(ctx) -> None:
    """The Expo-shaped cell: 5 iterations of the default learner with the
    held-out AUC (the synchronous loop), then 5 without (pipelined)."""
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.metrics import create_metric
    from lightgbm_tpu_torch.ops.split_cat import categorical_candidates

    ds, dv = _dataset_expo(ctx)
    iters = 5
    counters = dict(wave_counters(), split_cat=categorical_candidates)
    evals, t_iter = {}, []
    for fn in counters.values():                 # counts of the main path
        fn.launches = 0
    bst = lt.train(CAT_PARAMS, ds, iters, valid_sets=[dv],
                   valid_names=["heldout"], evals_result=evals,
                   verbose_eval=False, callbacks=iteration_timer(t_iter))
    launches = {n: fn.launches for n, fn in counters.items()}
    gbdt, learner = bst.gbdt, bst.gbdt.learner
    out = {"phase": "categorical_train", "rows": ROWS,
           "heldout_rows": VALID_ROWS, "iterations": iters,
           "categorical_columns": [n for n, _ in EXPO_CATS],
           "num_bins": [m.num_bin for m in ds.constructed.bin_mappers]}
    out.update(wave_path_checks("categorical_train", bst, launches))
    check(launches["split_cat"] > 0,
          "categorical_train: kernel split_cat was not launched")
    trees = gbdt.models
    check(all(t.num_cat > 0 for t in trees),
          f"a tree without a categorical split: "
          f"{[t.num_cat for t in trees]}")
    check(out["host_syncs_per_tree"] == 1,
          f"host syncs per tree {out['host_syncs_per_tree']} (want 1)")
    tree_counters(out, learner, WAVE_TREE_KEYS)
    check(all(n > 0 for n in out["graph_launches_per_tree"][1:]),
          "trees after the first did not replay CUDA graphs")
    auc = evals["heldout"]["auc"]
    check(all(np.isfinite(auc)) and auc[-1] > auc[0] and auc[-1] > 0.6,
          f"held-out AUC {auc}")
    # the device traversal (DevicePredictor, 500,000 row-trees) against
    # the host trees, and the loop's float32 held-out scores against both
    Xv = ctx["Xv_expo"]
    n_dev = gbdt.device_predictions
    raw = bst.predict(Xv, raw_score=True)
    check(gbdt.device_predictions == n_dev + 1,
          "Booster.predict did not go through the DevicePredictor")
    host = np.sum([t.predict(Xv) for t in trees], axis=0)
    diff = float(np.abs(raw - host).max())
    check(raw.shape == (VALID_ROWS,) and np.isfinite(raw).all()
          and diff < 1e-9, f"device traversal vs host trees: {diff}")
    loop_diff = float(np.abs(gbdt.valid_scores[0].np_score() - host).max())
    check(loop_diff < 1e-5, f"held-out scores of the loop vs the host "
          f"trees: {loop_diff}")
    out["graphed_tree_profiled"] = profiled_tree(
        learner, gbdt.objective.get_gradients(gbdt.train_score.score[0]),
        gbdt._bag_mask, dict(counters))
    (shapes,), _ = eager_tree_shapes(
        learner, gbdt.objective.get_gradients(gbdt.train_score.score[0]),
        gbdt._bag_mask, (categorical_candidates,))
    ks = sorted(shapes)
    ctx["shapes_cat"] = {"median": {"K": ks[len(ks) // 2]},
                         "largest": {"K": ks[-1]}}
    out.update({"heldout_auc": auc, "s_per_iter": t_iter,
                "s_per_iter_after_first": float(np.mean(t_iter[1:])),
                "split_cat_launches_per_tree": launches["split_cat"]
                / len(trees),
                "num_cat_per_tree": [t.num_cat for t in trees],
                "predict_vs_host_max_diff": diff,
                "loop_scores_vs_host_max_diff": loop_diff,
                "split_cat_shapes": {"launches": len(ks), "K": _quantiles(ks),
                                     "launches_by_K": {str(k): n for k, n in
                                                       sorted(Counter(ks)
                                                              .items())}}})
    ctx["launches_cat"] = launches

    # the same without the held-out set: the pipelined loop
    bst2 = lt.Booster(CAT_PARAMS, ds)
    gbdt2 = bst2.gbdt
    check(gbdt2._can_pipeline(), "the run without a held-out set does not "
          "pipeline")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        bst2.update()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    reads = gbdt2.learner.host_syncs
    t0 = time.perf_counter()
    trees2 = gbdt2.models                        # the flush: host assembly
    flush_s = time.perf_counter() - t0
    check(reads == 0, f"{reads} blocking record reads in the loop")
    check(len(trees2) == iters and all(t.num_cat > 0 for t in trees2),
          "the pipelined loop's trees")
    check(trees2[0].to_string() == trees[0].to_string(),
          "the first pipelined tree's model text differs from the "
          "synchronous loop's")
    auc_m = create_metric("auc", lt.Config.from_params(CAT_PARAMS))
    auc_m.init(dv.constructed.metadata, dv.constructed.num_data)
    auc2 = auc_m.eval(bst2.predict(Xv, raw_score=True),
                      gbdt2.objective)[0][1]
    gap = abs(auc2 - auc[-1])
    check(gap < 1e-3, f"pipelined held-out AUC {auc2} is {gap} from the "
          f"synchronous loop's")
    texts_equal = [a.to_string() == b.to_string()
                   for a, b in zip(trees, trees2)]
    out["pipelined"] = {"s_per_iter": loop_s / iters,
                        "record_reads_in_loop": reads,
                        "flush_s": flush_s,
                        "flush_s_per_tree": flush_s / iters,
                        "heldout_auc": auc2, "auc_gap_to_sync": gap,
                        "tree_text_equal_to_sync": texts_equal}
    emit(out)


def _tree_diff(a: str, b: str) -> list:
    """The fields of two trees' model text that differ: every field but
    the gains and leaf values exactly (structure, thresholds, bitsets,
    counts), leaf and internal values within 1e-9 relative, gains (printed
    to six digits) within 1e-5 relative."""
    fa, fb = (dict(ln.split("=", 1) for ln in t.splitlines() if "=" in ln)
              for t in (a, b))
    rtol = {"split_gain": 1e-5, "leaf_value": 1e-9, "internal_value": 1e-9}
    out = []
    for key in sorted(set(fa) | set(fb)):
        va, vb = fa.get(key), fb.get(key)
        if key in rtol and va is not None and vb is not None:
            x, y = (np.array(v.split(), dtype=np.float64) for v in (va, vb))
            if x.shape == y.shape and np.allclose(x, y, rtol=rtol[key],
                                                  atol=1e-12):
                continue
        elif va == vb:
            continue
        out.append(key)
    return out


def _card_and_cpu(params, X, y, iters: int, counters) -> tuple:
    """``iters`` iterations of ``params`` on the card, in float32 through
    the kernels (launches of the ``counters`` wrappers counted, AUC on the
    last 20,000 rows rising); then one iteration with ``gpu_use_dp`` on the
    card and on the CPU, round 1 without boost_from_average (gradients
    +-0.5, hessians 0.25: every histogram sum exact), whose trees must be
    the same (``_tree_diff``).  Returns the float32 booster, the launches,
    the seconds per iteration and the AUC."""
    import lightgbm_tpu_torch as lt

    p = dict(params, boost_from_average=False, metric="auc",
             verbosity=-1)
    ds = lt.Dataset(X, label=y, params=p)
    for fn in counters.values():
        fn.launches = 0
    t_iter = []
    ev = {}
    dv = ds.create_valid(X[-20_000:], label=y[-20_000:])
    bst = lt.train(p, ds, iters, valid_sets=[dv], valid_names=["train"],
                   evals_result=ev, verbose_eval=False,
                   callbacks=iteration_timer(t_iter))
    launches = {n: fn.launches for n, fn in counters.items()}
    auc = ev["train"]["auc"]
    check(all(np.isfinite(auc)) and auc[-1] > auc[0],
          f"AUC on the last 20,000 training rows {auc} did not rise")
    trees = []
    for dev in ("cuda", "cpu"):
        pd_ = dict(p, gpu_use_dp=True, device_type=dev)
        b = lt.train(pd_, lt.Dataset(X, label=y, params=pd_), 1,
                     verbose_eval=False)
        trees.append(b.gbdt.models[0].to_string())
    diff = _tree_diff(*trees)
    check(not diff, f"the card's first tree (gpu_use_dp) differs from the "
          f"CPU's in {diff}")
    return bst, launches, t_iter, auc


def phase_categorical_2047(ctx) -> None:
    """Categorical data past 1,024 bins: the masked learner's split_cat at
    B > 1,024, on the card and against the CPU."""
    import lightgbm_tpu_torch.learner as lmod
    from lightgbm_tpu_torch.learner import MaskedTreeLearner
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full
    from lightgbm_tpu_torch.ops.split_cat import (
        categorical_candidates, categorical_candidates_plain)

    rows, cats = 100_000, 2500
    X, y = expo_like(rows, seed=12)
    rng = np.random.RandomState(12)
    # Origin with 2,500 categories, each shifting the positive rate
    X[:, 4] = rng.randint(0, cats, rows)
    flip = rng.rand(rows) < (0.3 * rng.rand(cats))[X[:, 4].astype(int)]
    y = np.where(flip, 1.0 - y, y)
    params = dict(CAT_PARAMS, max_bin=2047)
    counters = {"hist_full": build_histogram_full,
                "split_cat": categorical_candidates}
    # the float32 run's split_cat launches of its first tree, recorded
    # (inputs and the fields before and after) for the plain version
    calls = []

    def record(cands, bits, *args, **kw):
        keep = args[0].is_cuda and len(calls) < 256
        if keep:
            # (the bounds and the penalty, None without constraints)
            start = (type(cands), [t.clone() for t in cands], bits.clone(),
                     [None if t is None else t.clone() for t in args])
        categorical_candidates(cands, bits, *args, **kw)
        if keep:
            calls.append((start, [t.clone() for t in cands], bits.clone(),
                          kw))

    lmod.categorical_candidates = record
    try:
        bst, launches, t_iter, auc = _card_and_cpu(params, X, y, 3,
                                                   counters)
    finally:
        lmod.categorical_candidates = categorical_candidates
    check(len(calls) == min(256, launches["split_cat"]) > 0,
          f"{len(calls)} split_cat launches recorded of "
          f"{launches['split_cat']}")
    eligible = 0
    for i, ((kind, fields, bits0, args), after, bits, kw) in \
            enumerate(calls):
        cpu = [None if t is None else t.cpu() for t in args]
        cands, b0 = kind(*(t.cpu() for t in fields)), bits0.cpu()
        categorical_candidates_plain(cands, b0, *cpu, **kw)
        check(_cat_same((after, bits), (cands, b0)),
              f"categorical_2047 split_cat launch {i + 1}: the kernel "
              f"differs from the plain version run on the CPU")
        cnt = cpu[0][:, cpu[7].long(), :, 2]           # the cat_cols
        eligible = max(eligible,
                       int((cnt >= kw["cat_smooth"]).sum(-1).max()))
    # the root's Origin column reaches the kernel's shared-memory sort
    check(eligible > 2048, f"at most {eligible} eligible bins")
    learner = bst.gbdt.learner
    nb = [m.num_bin for m in bst.gbdt.train_data.bin_mappers]
    width = learner.num_bins_padded
    check(type(learner) is MaskedTreeLearner,
          f"max_bin=2047 trained through {type(learner).__name__}")
    check(width > 1024, f"the masked learner's width {width}")
    check(launches["split_cat"] > 0 and launches["hist_full"] > 0,
          f"kernels not launched: {launches}")
    trees = bst.gbdt.models
    check(all(t.num_cat > 0 for t in trees), "a tree without a "
          "categorical split")
    emit({"phase": "categorical_2047", "rows": rows,
          "origin_categories": cats, "width_B": width,
          "num_bins": nb, "learner": type(learner).__name__,
          "launches": launches, "s_per_iter": t_iter, "train_auc": auc,
          "num_cat_per_tree": [t.num_cat for t in trees],
          "split_cat_launches_bitwise_to_plain": len(calls),
          "eligible_bins_max": eligible,
          "first_tree_dp_equal_to_cpu": True})


def phase_wave_4095(ctx) -> None:
    """A wave tree of 4,095 leaves under the default tpu_wave_max_bytes:
    the replay's node table past shared memory (M = 16,505), on the card
    and against the CPU; then at the bench width (1,000,000 rows) the
    learner's byte estimate against the card's peak over one tree."""
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner

    rows = 100_000
    X, y = higgs_like(rows, seed=8)
    params = dict(WAVE_PARAMS, num_leaves=4095, min_data_in_leaf=5)
    counters = wave_counters()
    bst, launches, t_iter, auc = _card_and_cpu(params, X, y, 3, counters)
    learner = bst.gbdt.learner
    check(type(learner) is WaveTreeLearner,
          f"num_leaves=4095 trained through {type(learner).__name__}")
    check(learner.M == replay_dims(4095)[0], f"M = {learner.M}")
    check(all(launches.values()), f"kernels not launched: {launches}")
    leaves = [t.num_leaves for t in bst.gbdt.models]
    check(leaves[0] == 4095, f"leaves per tree {leaves}")
    stats = learner.tree_stats
    emit({"phase": "wave_4095", "rows": rows, "M": learner.M,
          "launches": launches, "s_per_iter": t_iter, "train_auc": auc,
          "leaves_per_tree": leaves,
          "replay_passes_per_tree": [s["replay_passes"] for s in stats],
          "graph_launches_per_tree": [s["graph_launches"] for s in stats],
          "first_tree_dp_equal_to_cpu": True,
          "tpu_wave_max_bytes": int(bst.gbdt.cfg.tpu_wave_max_bytes),
          "memory": wave_4095_memory(ctx)})


#: the full UCI Higgs set's rows, the bench workload's source
HIGGS_ROWS = 11_000_000


def tree_memory(bst, trees: int = 3) -> dict:
    """The wave learner's device memory over ``trees`` trees grown from
    ``bst``'s first gradients: per tree the peak of
    ``torch.cuda.max_memory_allocated()`` above the bytes allocated before
    the first (the eager first tree, the second that captures the CUDA
    graphs, the third that replays them); the bytes the segments of the
    graphs' private pool hold after the trees (``memory_snapshot``), and
    what the allocator keeps reserved beside them once its cache is
    emptied; the learner's footprint: its input codes (uploaded with the
    booster) plus the widest of the first two trees' peaks and of the
    third's beside the graph pool; and the learner's byte estimate
    (``learner_wave.wave_transient_bytes``) for its shapes."""
    from lightgbm_tpu_torch.learner_wave import wave_transient_bytes

    gbdt, learner = bst.gbdt, bst.gbdt.learner
    est = wave_transient_bytes(gbdt.cfg, learner.n_pad, 4 * learner.fw,
                               learner._hist_nbins, learner.has_categorical,
                               learner._hist_cols)
    grad, hess = gbdt._gradients()[0]
    inputs = learner.data.device_bins(learner.device).nbytes
    if learner._bins_packed is not None:
        inputs += learner._bins_packed.nbytes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    peaks, leaves, captures, seconds = [], [], [], []
    for _ in range(trees):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = learner.train_async(grad, hess, gbdt._bag_mask,
                                   learner._all_features)
        rec_f, _ = learner.host_records(tree.records.cpu().numpy(),
                                        tree.host_stats)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() - base)
        leaves.append(int(rec_f[:, 0].sum()) + 1)
        captures.append(tree.host_stats["graph_captures"])
        del tree
    torch.cuda.empty_cache()
    pid = learner._graph_pool
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if pid is not None
               and tuple(seg.get("segment_pool_id", ())) == tuple(pid))
    other = torch.cuda.memory_reserved() - torch.cuda.memory_allocated() \
        - pool
    footprint = inputs + max(peaks[:2] + [peaks[2] + pool])
    return {"padded_rows": learner.n_pad, "padded_columns": 4 * learner.fw,
            "hist_columns": learner._hist_cols,
            "num_leaves": learner.num_leaves,
            "learner": type(learner).__name__, "leaves_per_tree": leaves,
            "graph_captures_per_tree": captures, "s_per_tree": seconds,
            "estimate_bytes": est, "peak_bytes_per_tree": peaks,
            "input_bytes": inputs, "graph_pool_bytes": pool,
            "reserved_unallocated_bytes": other,
            "footprint_bytes": footprint,
            "estimate_over_peak": est["total_bytes"] / max(peaks),
            "estimate_over_footprint": est["total_bytes"] / footprint}


def wave_4095_memory(ctx) -> list:
    """Under the default learner and budget the wave learner trains 4,095
    leaves at the bench width (1,000,000 x 28, 32 padded columns, 255
    bins) and 31 and 255 leaves at Higgs's 11,000,000 rows (the bench rows
    repeated through ``Dataset.subset``); at each, its byte estimate is at
    or above the card's peak allocation over a tree (``tree_memory``)."""
    import gc

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.learner_wave import WaveTreeLearner

    ds, _ = _dataset(ctx)
    out = []
    for rows, leaves in ((ROWS, 4095), (HIGGS_ROWS, 31), (HIGGS_ROWS, 255)):
        d = ds if rows == ROWS else ds.subset(np.arange(rows) % ROWS)
        bst = lt.Booster(dict(WAVE_PARAMS, num_leaves=leaves), d)
        learner = bst.gbdt.learner
        check(type(learner) is WaveTreeLearner,
              f"{leaves} leaves at {rows} rows: {type(learner).__name__} "
              f"under the default budget")
        m = tree_memory(bst)
        check(rows != ROWS or m["leaves_per_tree"][0] == leaves,
              f"leaves per tree {m['leaves_per_tree']}")
        check(m["estimate_bytes"]["total_bytes"]
              >= max(m["peak_bytes_per_tree"]),
              f"{rows} rows, {leaves} leaves: byte estimate "
              f"{m['estimate_bytes']['total_bytes']} below the measured "
              f"peak {max(m['peak_bytes_per_tree'])}")
        out.append(m)
        del bst, learner, d
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _variant_run(ctx, params, tag, iters: int, valid: bool = True,
                 callbacks=()):
    """``iters`` iterations of a boosting variant at the bench width
    through ``lt.train`` (with the held-out set when ``valid``, and
    ``callbacks`` besides the timer's), the wave learner's kernel counts
    set to 0 just before and read just after; returns the booster and the
    phase's common fields."""
    import lightgbm_tpu_torch as lt

    ds, dv = _dataset(ctx)
    counters = wave_counters()
    for fn in counters.values():                 # counts of the path
        fn.launches = 0
    t_iter, evals = [], {}
    bst = lt.train(params, ds, iters, valid_sets=[dv] if valid else None,
                   valid_names=["heldout"], evals_result=evals,
                   verbose_eval=False,
                   callbacks=iteration_timer(t_iter) + list(callbacks))
    launches = {name: fn.launches for name, fn in counters.items()}
    out = wave_path_checks(tag, bst, launches)
    out.update({"phase": tag, "iterations": iters, "s_per_iter": t_iter,
                "loop_score_reads": bst.gbdt.host_syncs})
    if valid:
        auc = evals["heldout"]["auc"]
        check(all(np.isfinite(auc)) and auc[-1] > 0.7,
              f"{tag}: held-out AUC {auc}")
        out["heldout_auc"] = auc
    tree_counters(out, bst.gbdt.learner, ("graph_captures",
                                          "graph_launches"))
    check(not any(out["graph_captures_per_tree"][2:]),
          f"{tag}: graph captures after the second tree "
          f"{out['graph_captures_per_tree']}")
    return bst, out


def device_vs_host(bst, X) -> float:
    """A large batch's ``Booster.predict`` (the DevicePredictor) against
    the host trees' sum (averaged for an average_output model)."""
    gbdt = bst.gbdt
    n_dev = gbdt.device_predictions
    dev = bst.predict(X, raw_score=True)
    check(gbdt.device_predictions == n_dev + 1,
          "the large batch did not go through the DevicePredictor")
    host = np.zeros(len(X))
    for t in gbdt.models:
        host += t.predict(X)
    if gbdt.average_output:
        host /= gbdt.num_iterations_trained
    diff = float(np.abs(dev - host).max())
    check(diff <= 1e-6, f"device predictions vs host trees: {diff}")
    return diff


def phase_goss_train(ctx) -> None:
    """GOSS at the bench width without a held-out set: the pipelined loop,
    15 iterations at learning rate 0.1, so iterations 10-14 sample on the
    card; then the selection alone at full width."""
    from lightgbm_tpu_torch.boosting.goss import GOSS, goss_select

    iters = 15
    params = dict(WAVE_PARAMS, boosting="goss")
    draws = []

    def record(env):            # each sampled iteration's draw, unread
        d = env.model.gbdt.last_draw
        if d is not None and (not draws or draws[-1][0] != d[0]):
            draws.append(d)

    bst, out = _variant_run(ctx, params, "goss_train", iters, valid=False,
                            callbacks=[record])
    gbdt = bst.gbdt
    check(type(gbdt) is GOSS and gbdt._can_pipeline(),
          "GOSS did not take the pipelined loop")
    trees = gbdt.models
    reads = gbdt.pipeline_waits + gbdt.learner.host_syncs + gbdt.host_syncs
    check(gbdt.pipeline_waits == iters and gbdt.learner.host_syncs == 0
          and gbdt.host_syncs == 0,
          f"reads: {gbdt.pipeline_waits} record waits, "
          f"{gbdt.learner.host_syncs} learner reads, {gbdt.host_syncs} "
          f"score reads for {iters} trees")
    n = gbdt.num_data
    sampled = []
    for it, top_k, rows in draws:
        rows = int(rows)
        drawn = rows - top_k
        other_k = max(1, int(n * gbdt.cfg.other_rate))
        check(trees[it].internal_count[0] == rows,
              f"iteration {it}: the tree's root holds "
              f"{trees[it].internal_count[0]} rows, the bag {rows}")
        check(abs(drawn - other_k) < 6 * np.sqrt(other_k),
              f"iteration {it}: {drawn} rows drawn for {other_k}")
        sampled.append({"iteration": it, "bagged_rows": rows,
                        "top_k": top_k, "drawn": drawn})
    check([d["iteration"] for d in sampled] == list(range(10, iters)),
          f"sampled iterations {[d['iteration'] for d in sampled]}")
    # the selection alone, on the last sampled iteration's inputs
    g, h = gbdt._gradients()[0]
    u = gbdt._goss_uniform(iters)
    top_k = max(1, int(n * gbdt.cfg.top_rate))
    other_k = max(1, int(n * gbdt.cfg.other_rate))
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32,
                        device=g.device)
    sel_ms = cuda_ms(lambda: goss_select(g[None], h[None], gbdt._valid_rows,
                                         u, top_k, other_k), 10, flush)
    t_sampled = float(np.mean(out["s_per_iter"][10:]))
    out.update({"host_reads_per_tree": reads / iters,
                "sampled": sampled, "selection_ms": sel_ms,
                "s_per_sampled_iter": t_sampled,
                "selection_share_of_sampled_iter":
                    sel_ms / 1e3 / t_sampled})
    emit(out)


def phase_dart_train(ctx) -> None:
    """DART at the bench width with the held-out set, drops on every
    iteration after the first; a large batch predicts through a fresh
    DevicePredictor after every iteration's in-place edits."""
    params = dict(WAVE_PARAMS, boosting="dart", skip_drop=0.0,
                  drop_rate=0.5)
    bst, out = _variant_run(ctx, params, "dart_train", 5)
    gbdt = bst.gbdt
    check(not gbdt._can_pipeline(), "DART pipelined")
    drops = gbdt.tree_weight
    check(len(drops) == 5, f"tree weights {drops}")
    out["tree_weight"] = drops
    out["last_drop_index"] = gbdt.drop_index
    out["device_vs_host_max_diff"] = device_vs_host(bst, ctx["Xv"])
    bst.update()
    out["after_one_more_iteration_max_diff"] = device_vs_host(bst,
                                                              ctx["Xv"])
    emit(out)


def phase_rf_train(ctx) -> None:
    """Random forest at the bench width: bagging 0.632 every iteration,
    feature fraction 0.8, averaged scores and predictions."""
    params = dict(WAVE_PARAMS, boosting="rf", bagging_fraction=0.632,
                  bagging_freq=1, feature_fraction=0.8)
    bst, out = _variant_run(ctx, params, "rf_train", 5)
    gbdt = bst.gbdt
    check(gbdt.average_output, "rf did not average")
    out["device_vs_host_max_diff"] = device_vs_host(bst, ctx["Xv"])
    # the held-out score the loop kept is the mean of the trees
    kept = gbdt.valid_scores[0].np_score().astype(np.float64)
    raw = bst.predict(ctx["Xv"], raw_score=True)
    diff = float(np.abs(kept - raw).max())
    check(diff <= 1e-5, f"averaged held-out scores vs predict: {diff}")
    out["heldout_score_vs_predict_max_diff"] = diff
    emit(out)


def phase_surface(ctx) -> None:
    """The training API at the bench width: 5 iterations, saved and
    continued 5 more; rollback_one_iter and a large-batch predict; refit
    on the held-out rows; 3-fold cv x 5 iterations on 100,000 rows; a
    pickle round trip."""
    import pickle
    import tempfile

    import lightgbm_tpu_torch as lt

    ds, _ = _dataset(ctx)
    Xv, yv = ctx["Xv"], ctx["yv"]
    counters = wave_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    bst = lt.train(WAVE_PARAMS, ds, 5, verbose_eval=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/model.txt"
        bst.save_model(path)
        cont = lt.train(WAVE_PARAMS, ds, 5, init_model=path,
                        verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    check(all(launches.values()), f"kernels not launched: {launches}")
    check(cont.num_trees() == 10 and cont.gbdt.train_score.has_init_score,
          f"continued model has {cont.num_trees()} trees")
    first = [t.to_string() for t in cont.gbdt.models[:5]]
    check(first == [t.to_string() for t in bst.gbdt.models],
          "the continued model's first trees are not the saved ones")
    from lightgbm_tpu_torch.metrics import create_metric

    auc_m = create_metric("auc", lt.Config.from_params(WAVE_PARAMS))
    auc_m.init(ctx["dv"].constructed.metadata, VALID_ROWS)
    aucs = [auc_m.eval(b.predict(Xv, raw_score=True), None)[0][1]
            for b in (bst, cont)]
    check(aucs[1] > aucs[0], f"held-out AUC {aucs} did not rise")
    before = cont.predict(Xv)
    cont.rollback_one_iter()
    check(cont.num_trees() == 9, f"rollback left {cont.num_trees()} trees")
    rollback_diff = device_vs_host(cont, Xv)
    t0 = time.perf_counter()
    refit = cont.refit(Xv, yv)
    refit_s = time.perf_counter() - t0
    rp = refit.predict(Xv)
    check(np.isfinite(rp).all() and not np.allclose(rp, before),
          "refit predictions")
    X100, y100 = Xv, yv              # 100,000 rows of the same problem
    t0 = time.perf_counter()
    res = lt.cv(WAVE_PARAMS, lt.Dataset(X100, label=y100), 5, nfold=3,
                seed=3, verbose_eval=False)
    cv_s = time.perf_counter() - t0
    ll = res["binary_logloss-mean"]
    check(len(ll) == 5 and ll[-1] < ll[0], f"cv logloss means {ll}")
    blob = pickle.dumps(cont)
    back = pickle.loads(blob)
    pdiff = float(np.abs(back.predict(Xv) - cont.predict(Xv)).max())
    check(pdiff <= 1e-9, f"pickle round trip: {pdiff}")
    emit({"phase": "surface", "kernel_launches": launches,
          "train_and_continue_s": train_s, "heldout_auc_5_and_10": aucs,
          "rollback_device_vs_host_max_diff": rollback_diff,
          "refit_s": refit_s, "cv_s": cv_s, "cv_binary_logloss_mean": ll,
          "cv_auc_mean": res["auc-mean"], "pickle_bytes": len(blob),
          "pickle_predict_max_diff": pdiff})


def _bound(nbytes: float, flops: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}


def staged(fn):
    """The one launch ``fn`` makes, recorded and returned as a replay: the
    C entry point called again on the same staged buffers, with none of
    the wrapper's torch work around it."""
    from lightgbm_tpu_torch import native

    with native.staging() as rec:
        fn()
    check(len(rec) == 1, f"{len(rec)} launches staged, want 1")
    return rec[0]


def shape_segments_inputs(cnt, seed: int):
    """Full-width words and random float32 weights, and K disjoint member
    windows with the given counts laid out in order over N_FULL rows with
    random gaps (every row of a window matches its member's leaf)."""
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(seed)
    from lightgbm_tpu_torch.ops.hist_packed import pack_bin_words

    codes = rng.randint(0, NUM_BINS, size=(4 * FW, N_FULL)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    bag = (rng.rand(N_FULL) < 0.8).astype(np.float32)
    w = np.stack([rng.randn(N_FULL) * bag, rng.rand(N_FULL) * bag, bag])
    k = len(cnt)
    gaps = rng.multinomial(N_FULL - int(sum(cnt)), [1.0 / (k + 1)] * (k + 1))
    start = np.cumsum(gaps[:k]) + np.concatenate([[0], np.cumsum(cnt)[:-1]])
    lid = np.full(N_FULL, 9999, np.int32)
    for m, (s0, c) in enumerate(zip(start, cnt)):
        lid[s0:s0 + c] = 100 + m
    t = [torch.from_numpy(np.asarray(a)).to(dev) for a in
         (w.astype(np.float32), lid, start.astype(np.int64),
          np.asarray(cnt, np.int64), 100 + np.arange(k))]
    return words, t[0].contiguous(), t[1], t[2], t[3], t[4]


def _segments_bytes(words, lid, start, cnt, leaf) -> tuple:
    """(bytes, matching rows) the function needs: lid once for each row of
    the union of the member ranges (frozen members share theirs), words and
    weights once for each row that matches its member's leaf, the output
    once."""
    dev = words.device
    edge = torch.zeros(words.shape[1] + 1, dtype=torch.int64, device=dev)
    one = torch.ones_like(start, dtype=torch.int64)
    edge.index_add_(0, start.long(), one)
    edge.index_add_(0, (start + cnt).long(), -one)
    union_rows = int((torch.cumsum(edge[:-1], 0) > 0).sum())
    matching = sum(int((lid[s:s + c] == lf).sum()) for s, c, lf in
                   zip(start.tolist(), cnt.tolist(), leaf.tolist()))
    k = start.numel()
    return (union_rows * 4 + matching * (FW * 4 + 3 * 4)
            + k * 4 * FW * NUM_BINS * 3 * 4), matching, union_rows


def _time_segments_call(flush, words, w, lid, start, cnt, leaf, bound,
                        reps: int = 20) -> dict:
    """The wrapper's and the kernel's own time at one launch shape."""
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments

    call = (lambda: build_histogram_segments(
        words, w, lid, start, cnt, leaf, num_bins=NUM_BINS,
        rows_bound=bound))
    ms = cuda_ms(call, reps, flush)
    kernel_ms = cuda_ms(staged(call), reps, flush)
    nbytes, matching, union_rows = _segments_bytes(words, lid, start, cnt,
                                                   leaf)
    return dict(ms=ms, kernel_ms=kernel_ms, members=start.numel(),
                member_rows=int(cnt.sum()), max_cnt=int(cnt.max()),
                union_rows=union_rows, matching_rows=matching,
                rows_bound=bound,
                **_bound(nbytes, matching * 4 * FW * 3))


def _time_segments(flush, shapes=None, compact=None) -> dict:
    from lightgbm_tpu_torch.ops.hist_packed import unpack_bin_words
    from lightgbm_tpu_torch.ops.hist_segments import (
        build_histogram_segments_plain)

    words, w, lid, start, cnt, leaf, bound = segments_inputs(7, False)
    dev = words.device
    reps = 20
    res = _time_segments_call(flush, words, w, lid, start, cnt, leaf,
                              bound)
    res["plain_ms"] = cuda_ms(lambda: build_histogram_segments_plain(
        words, w, lid, start, cnt, leaf, num_bins=NUM_BINS), 3, flush)
    # the library call: one index_add_ over the members' matching rows, with
    # the flat (member, feature, bin) indices formed beforehand
    rows, members = [], []
    for m, (s, c, lf) in enumerate(zip(start.tolist(), cnt.tolist(),
                                       leaf.tolist())):
        r = torch.arange(s, s + c, device=dev)
        r = r[lid[r] == lf]
        rows.append(r)
        members.append(torch.full_like(r, m))
    rows, members = torch.cat(rows), torch.cat(members)
    codes = unpack_bin_words(words.index_select(1, rows), 4 * FW) \
        .to(torch.int64)                                  # (4Fw, R)
    fo = torch.arange(4 * FW, device=dev)[:, None]
    flat = ((members[None, :] * 4 * FW + fo) * NUM_BINS + codes).reshape(-1)
    src = w.index_select(1, rows).t().unsqueeze(0) \
        .expand(4 * FW, rows.numel(), 3).reshape(-1, 3).contiguous()
    k = start.numel()
    res["library_ms"] = cuda_ms(lambda: torch.zeros(
        k * 4 * FW * NUM_BINS, 3, device=dev).index_add_(0, flat, src),
        reps, flush)
    # the main path's median and largest launch (wave_train's shapes)
    if shapes:
        res["shapes_wave_train"] = {}
        for tag in ("median", "largest"):
            rec = shapes[tag]
            args = shape_segments_inputs(rec["cnt"], 11)
            res["shapes_wave_train"][tag] = _time_segments_call(
                flush, *args, rec["rows_bound"])
    # the compact path's K = 1 launches (its smaller child), the grid sized
    # by the padded row count
    if compact:
        res["shapes_train"] = {
            tag: dict(_time_segments_call(
                flush, *shape_segments_inputs([compact[tag]["rows"]], 12),
                N_FULL), recorded=compact[tag])
            for tag in ("median", "largest")}
    return res


def _time_partition(flush) -> dict:
    from lightgbm_tpu_torch.ops.partition import (apply_partition,
                                                  apply_partition_plain)

    bins, w, rid, lid, dest = partition_inputs(8)
    out = tuple(torch.empty_like(t) for t in (bins, w, rid, lid))
    reps = 20
    call = (lambda: apply_partition(bins, w, rid, lid, dest, out=out))
    ms = cuda_ms(call, reps, flush)
    kernel_ms = cuda_ms(staged(call), reps, flush)
    plain_ms = cuda_ms(lambda: apply_partition_plain(bins, w, rid, lid, dest,
                                                     out=out), reps, flush)
    # the library call: one index_copy_ of every lane stacked as int32 rows
    # (Fw words, 3 weight bit patterns, rid as two halves, lid)
    stacked = torch.cat([bins, w.view(torch.int32),
                         rid.view(torch.int32).view(-1, 2).t(),
                         lid[None, :]]).contiguous()
    target = torch.empty_like(stacked)
    d64 = dest.to(torch.int64)
    lib_ms = cuda_ms(lambda: target.index_copy_(1, d64, stacked), reps,
                     flush)
    n = N_FULL
    nbytes = n * (FW + 3 + 2 + 1) * 4 * 2 + n * 4
    return dict(ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                library_ms=lib_ms, **_bound(nbytes, 0))


def _time_partition_window(flush, shapes=None) -> dict:
    """The windowed partition at the largest window (all 1,000,000 rows,
    sort mode) with its plain version, and at the compact path's median
    and largest recorded window in the mode it ran, each at start 777: the
    wrapper, the three kernels alone, the bound (sort mode: the window's
    lanes read and written once; mask mode: the feature word, the bag lane
    and the leaf ids read, the leaf ids written)."""
    from lightgbm_tpu_torch.ops.partition import (partition_window,
                                                  partition_window_plain)

    dev = torch.device("cuda", 0)
    reps = 20
    cases = {"full": {"rows": ROWS, "sort_mode": True}}
    for tag in ("median", "largest"):
        if shapes:
            cases[tag] = shapes[tag]
    out = {}
    for tag, rec in cases.items():
        c, sort = int(rec["rows"]), bool(rec["sort_mode"])
        start = 777 if c + 777 <= N_FULL else 0
        base = window_inputs(40, start, c, 17)
        lanes = [t.clone() for t in base[:4]]
        split = torch.tensor([17, 254, 0, 99, 1, 1, start, c],
                             dtype=torch.int64, device=dev)
        mask_max = 0 if sort else c
        scratch = tuple(torch.empty_like(t) for t in lanes)
        # every launch repartitions the window it partitioned before: the
        # same bytes move each time
        call = (lambda: partition_window(*lanes, split, base[4], None,
                                         mask_max=mask_max, scratch=scratch))
        nbytes = 2 * c * (4 * FW + 24) if sort else 16 * c
        row = dict(rows=c, start=start, sort_mode=sort,
                   ms=cuda_ms(call, reps, flush),
                   kernel_ms=cuda_ms(staged(call), reps, flush),
                   library_ms=None, **_bound(nbytes, 0))
        if tag == "full":
            row["plain_ms"] = cuda_ms(lambda: partition_window_plain(
                *lanes, split, base[4], None, mask_max=mask_max), 3, flush)
        else:
            row["recorded"] = rec
        out[tag] = row
    res = dict(out.pop("full"))
    res["shapes_train"] = out
    return res


def _time_scan_call(flush, k: int, reps: int = 20,
                    con: bool = False) -> dict:
    """The wrapper's and the kernel's own time at K leaves (F = 28,
    B = 255, random float32 histograms); ``con``: the constrained scan
    (per-leaf bounds, monotone signs, penalty), its inputs in ``args``."""
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched

    dev = torch.device("cuda", 0)
    args = [t.to(dev) for t in scan_inputs(9, False, k=k)]
    extra, kw = [], dict(SCAN_KW)
    if con:
        mono, mn, mx, pen = (t.to(dev) for t in
                             scan_constraints(k, FEATURES, 10))
        extra, kw = [mono, mn, mx], dict(SCAN_KW, penalty=pen)
    call = lambda: find_best_splits_batched(  # noqa: E731
        *args, *extra, **kw)
    ms = cuda_ms(call, reps, flush)
    rec = staged(call)
    kernel_ms = cuda_ms(rec, reps, flush)
    device_ms = _device_ms(lambda: [(flush.add_(1), rec())
                                    for _ in range(reps)], "split_scan")
    cells = k * FEATURES * NUM_BINS
    # read the cube and the leaf totals once, write the 11 (K, F) fields
    # (ten of 4 bytes, default_left of 1); constrained: also the (K,)
    # bounds and the (F,) signs and penalties
    nbytes = cells * 3 * 4 + k * 3 * 4 + k * FEATURES * (10 * 4 + 1)
    if con:
        nbytes += k * 2 * 4 + FEATURES * (1 + 4)
    # per bin and direction: 3 cumulative adds, 3 subtractions, two leaf
    # outputs and two leaf gains (about 34 float operations); constrained:
    # two clips and the sign test, about 6 more
    flops = cells * 2 * (46 if con else 40)
    return dict(ms=ms, kernel_ms=kernel_ms, device_ms=device_ms, K=k,
                constrained=con, args=args + extra, kw=kw,
                **_bound(nbytes, flops))


def _time_scan(flush, shapes=None) -> dict:
    from lightgbm_tpu_torch.ops.split import find_best_splits

    res = _time_scan_call(flush, SCAN_K)
    args, kw = res.pop("args"), res.pop("kw")
    res["plain_ms"] = cuda_ms(lambda: find_best_splits(*args, **kw),
                              20, flush)
    res.update(library_ms=None,
               library="no single PyTorch call computes this function")
    if shapes:
        res["shapes_wave_train"] = {}
        for tag in ("median", "largest"):
            r = _time_scan_call(flush, shapes[tag]["K"])
            r.pop("args")
            r.pop("kw")
            res["shapes_wave_train"][tag] = r
    # the constrained launch at the same K (constrained_train's)
    r = _time_scan_call(flush, SCAN_K, con=True)
    args, kw = r.pop("args"), r.pop("kw")
    r["plain_ms"] = cuda_ms(lambda: find_best_splits(*args, **kw), 20, flush)
    res["constrained"] = r
    return res


def _time_split_cat_call(flush, k: int, reps: int = 20,
                         b: int = 256, con: bool = False) -> dict:
    """The wrapper's and the kernel's own time at K leaves of the fixture
    (six categorical columns of eight, B bins, random float32), on a start
    the numerical scan wrote; ``con``: with per-leaf bounds and the
    penalty."""
    from lightgbm_tpu_torch.ops.split_cat import (cat_words,
                                                  categorical_candidates)

    dev = torch.device("cuda", 0)
    args = [t.to(dev) for t in split_cat_inputs(9, False, k=k, b=b)]
    num, bits = _cat_start(args)
    cols = torch.tensor(CAT_COLS, dtype=torch.int32, device=dev)
    extra = []
    if con:
        extra = [t.to(dev) for t in scan_constraints(k, CAT_F, 11)[1:]]
    call = lambda: categorical_candidates(  # noqa: E731
        num, bits, *args, cols, *extra, **CAT_KW)
    ms = cuda_ms(call, reps, flush)
    rec = staged(call)
    kernel_ms = cuda_ms(rec, reps, flush)
    device_ms = _device_ms(lambda: [(flush.add_(1), rec())
                                    for _ in range(reps)], "split_cat")
    c, b = len(CAT_COLS), args[0].shape[2]
    w = cat_words(b)
    # read the categorical columns' histograms and the leaf totals once,
    # write per (leaf, column) the eleven fields (ten of 4 bytes, one of
    # 1) and W words
    nbytes = k * c * b * 3 * 4 + k * 3 * 4 + k * c * (10 * 4 + 1 + w * 4)
    if con:
        nbytes += k * 2 * 4 + c * 4        # the bounds, the penalties
    # per bin a CTR (2 operations) or a one-hot gain (about 30); per scan
    # position and direction about 30, over min(32, (B + 1) // 2) positions
    flops = k * c * (b * 30 + 2 * 32 * 30)
    return dict(ms=ms, kernel_ms=kernel_ms, device_ms=device_ms, K=k, C=c,
                B=b, constrained=con, args=args, extra=extra,
                start=(num, bits), **_bound(nbytes, flops))


def _time_split_cat(flush, shapes=None) -> dict:
    from lightgbm_tpu_torch.ops.split_cat import categorical_candidates_plain

    res = _time_split_cat_call(flush, CAT_K)
    args, (num, bits) = res.pop("args"), res.pop("start")
    res.pop("extra")
    cols = torch.tensor(CAT_COLS, dtype=torch.int32, device=bits.device)
    res["plain_ms"] = cuda_ms(lambda: categorical_candidates_plain(
        num, bits, *args, cols, **CAT_KW), 5, flush)
    res.update(library_ms=None,
               library="no single PyTorch call computes this function")
    if shapes:
        res["shapes_categorical_train"] = {}
        for tag in ("median", "largest"):
            r = _time_split_cat_call(flush, shapes[tag]["K"])
            for key in ("args", "start", "extra"):
                r.pop(key)
            res["shapes_categorical_train"][tag] = r
    r = _time_split_cat_call(flush, CAT_K, b=2047)
    for key in ("args", "start", "extra"):
        r.pop(key)
    res["B2047"] = r
    r = _time_split_cat_call(flush, CAT_K, con=True)
    args, (num, bits), extra = r.pop("args"), r.pop("start"), r.pop("extra")
    r["plain_ms"] = cuda_ms(lambda: categorical_candidates_plain(
        num, bits, *args, cols, *extra, **CAT_KW), 5, flush)
    res["constrained"] = r
    return res


def share_slots(n: int, k: int, share: float, seed: int, dev):
    """Root-order slots with ``share`` of the rows in a slot (each a
    uniform slot of [0, K)) and the others in slot K (dropped)."""
    rng = np.random.RandomState(seed)
    slot = np.where(rng.rand(n) < share, rng.randint(0, k, n), k)
    return torch.from_numpy(slot.astype(np.int32)).to(dev)


def _time_multislot_call(flush, words, w, slot, k: int,
                         reps: int = 20) -> dict:
    """hist_multislot through the wrapper and alone at one input, with its
    bound: every row's slot, the words and weights of the rows in a slot,
    the output once."""
    from lightgbm_tpu_torch.ops.hist_multislot import \
        build_histogram_multislot

    call = (lambda: build_histogram_multislot(
        words, w, slot, num_bins=NUM_BINS, n_slots=k))
    matching = int(((slot >= 0) & (slot < k)).sum())
    n = words.shape[1]
    nbytes = (n * 4 + matching * (FW * 4 + 3 * 4)
              + k * 4 * FW * NUM_BINS * 3 * 4)
    return dict(ms=cuda_ms(call, reps, flush),
                kernel_ms=cuda_ms(staged(call), reps, flush), slots=k,
                matching_rows=matching, share=matching / n,
                **_bound(nbytes, matching * 4 * FW * 3))


def _time_multislot(flush, shapes=None) -> dict:
    from lightgbm_tpu_torch.ops.hist_multislot import \
        build_histogram_multislot_plain
    from lightgbm_tpu_torch.ops.hist_packed import unpack_bin_words

    k = MULTI_K
    words, w, slot = multislot_inputs(43, "random", k)
    dev = words.device
    reps = 20
    res = _time_multislot_call(flush, words, w, slot, k)
    res["plain_ms"] = cuda_ms(lambda: build_histogram_multislot_plain(
        words, w, slot, num_bins=NUM_BINS, n_slots=k), 3, flush)
    # the library call: one index_add_ over the rows in a slot, with the
    # flat (slot, column, bin) indices formed beforehand
    rows = torch.nonzero((slot >= 0) & (slot < k)).squeeze(1)
    codes = unpack_bin_words(words.index_select(1, rows), 4 * FW) \
        .to(torch.int64)                                  # (4Fw, R)
    fo = torch.arange(4 * FW, device=dev)[:, None]
    flat = ((slot.index_select(0, rows).to(torch.int64)[None, :] * 4 * FW
             + fo) * NUM_BINS + codes).reshape(-1)
    src = w.index_select(1, rows).t().unsqueeze(0) \
        .expand(4 * FW, rows.numel(), 3).reshape(-1, 3).contiguous()
    res["library_ms"] = cuda_ms(lambda: torch.zeros(
        k * 4 * FW * NUM_BINS, 3, device=dev).index_add_(0, flat, src),
        reps, flush)
    # the quant path's launches: the recorded K and share of rows in a slot
    # through seeded random slots, over rows whose four padding features
    # hold code 0, as the dataset's do
    if shapes:
        words, w, _ = multislot_inputs(43, "random", k, pad=True)
        res["shapes_quant_train"] = {
            tag: dict(_time_multislot_call(
                flush, words, w, share_slots(N_FULL, rec["K"], rec["share"],
                                             44, dev), rec["K"]),
                recorded=rec, padding_features_constant=True)
            for tag, rec in shapes.items() if tag != "distribution"}
    return res


def _time_fused_call(flush, k: int, reps: int = 20) -> dict:
    """fused_scan through the wrapper and alone at K members (F = 28,
    B = 255, random float32), with its bound."""
    from lightgbm_tpu_torch.ops.fused_scan import fused_child_scans

    dev = torch.device("cuda", 0)
    args = [t.to(dev) for t in fused_inputs(33, False, k=k)]
    kw = dict(SCAN_KW, lambda_l1=0.0)
    # each launch rewrites the members' pool rows in place; the values
    # drift between launches, the work does not
    call = (lambda: fused_child_scans(*args, **kw))
    f, b = FEATURES, NUM_BINS
    cells = k * f * b
    # read h_small and the parents, write both children; read the (2K,)
    # sums, write the 11 (2K, F) fields (ten of 4 bytes, default_left of 1)
    nbytes = 4 * cells * 3 * 4 + 2 * k * 3 * 4 + 2 * k * f * (10 * 4 + 1)
    # per cell: 3 subtractions, 6 pairwise adds for the two fixes, then two
    # children's scans at the split scan's 2 x 40 operations per bin
    return dict(ms=cuda_ms(call, reps, flush),
                kernel_ms=cuda_ms(staged(call), reps, flush), members=k,
                args=args, kw=kw, **_bound(nbytes, cells * (3 + 6 + 2 * 80)))


def _time_fused(flush, shapes=None) -> dict:
    from lightgbm_tpu_torch.ops.fused_scan import fused_child_scans_plain

    res = _time_fused_call(flush, FUSED_K)
    args, kw = res.pop("args"), res.pop("kw")
    res["plain_ms"] = cuda_ms(lambda: fused_child_scans_plain(*args, **kw),
                              20, flush)
    res.update(library_ms=None,
               library="no single PyTorch call computes this function")
    if shapes:
        res["shapes_quant_train"] = {}
        for tag in ("median", "largest"):
            r = _time_fused_call(flush, shapes[tag]["K"])
            r.pop("args"), r.pop("kw")
            res["shapes_quant_train"][tag] = dict(r, recorded=shapes[tag])
    return res


def _full_bound(bins: torch.Tensor, w: torch.Tensor, num_bins: int) -> dict:
    """hist_full's bound at these inputs: the three weight rows, the 32-byte
    code sectors that hold a weighted row (in every feature's row) and the
    output; with every row's codes read, the all-rows bound beside it."""
    f, n = bins.shape
    act = w.ne(0).any(dim=0)
    per = 32 // bins.element_size()               # rows per code sector
    pad = torch.zeros((-n) % per, dtype=torch.bool, device=act.device)
    sectors = int(torch.cat([act, pad]).view(-1, per).any(dim=1).sum())
    rows = int(act.sum())
    out_bytes = f * num_bins * 3 * 4
    res = _bound(3 * n * 4 + sectors * 32 * f + out_bytes, rows * f * 3)
    res.update(weighted_rows=rows, weighted_share=rows / n,
               code_sectors=sectors,
               bound_ms_all_rows=_bound(
                   f * n * bins.element_size() + 3 * n * 4 + out_bytes,
                   n * f * 3)["bound_ms"])
    return res


def _time_full_call(flush, bins, w, num_bins: int, reps: int = 20) -> dict:
    """hist_full through the wrapper and alone at one input, with its
    bounds."""
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full

    call = (lambda: build_histogram_full(bins, w, num_bins=num_bins))
    return dict(ms=cuda_ms(call, reps, flush),
                kernel_ms=cuda_ms(staged(call), reps, flush),
                **_full_bound(bins, w, num_bins))


def share_mask(n: int, rows: int, seed: int, dev) -> torch.Tensor:
    """A float32 0/1 mask with exactly ``rows`` ones at random rows."""
    keep = np.zeros(n, np.float32)
    keep[np.random.RandomState(seed).permutation(n)[:rows]] = 1.0
    return torch.from_numpy(keep).to(dev)


def _time_hist_full(flush, shapes=None) -> dict:
    from lightgbm_tpu_torch.ops.histogram import (build_histogram_onehot,
                                                  read_codes)

    b, f, n = MASKED_BINS, FEATURES, N_FULL
    bins, w = full_inputs(90, np.uint16, b, "random")
    dev = bins.device
    reps = 20
    res = _time_full_call(flush, bins, w, b)
    res["plain_ms"] = cuda_ms(lambda: build_histogram_onehot(
        bins, w, num_bins=b), 3, flush)
    # the library call: one index_add_ on pre-flattened (feature, bin)
    # indices, as for hist_packed
    flat = (read_codes(bins) + torch.arange(f, device=dev)[:, None] * b) \
        .reshape(-1)
    src = w.t().unsqueeze(0).expand(f, n, 3).reshape(-1, 3).contiguous()
    res["library_ms"] = cuda_ms(lambda: torch.zeros(
        f * b, 3, device=dev).index_add_(0, flat, src), reps, flush)
    res.update(num_bins=b, codes="uint16")
    # the masked learner's calls: only the smaller child's rows carry
    # weights, the others are zero and skipped; 5% of the rows, no row, and
    # the weighted share of masked_train's median and largest launch, each
    # a random mask over weights that are all non-zero
    wall = w.clone()
    wall[2] = 1.0
    wall[:2] = torch.where(wall[:2] == 0, torch.ones_like(wall[:2]),
                           wall[:2])
    res["rows_5pct_weighted"] = _time_full_call(
        flush, bins, wall * share_mask(n, n // 20, 91, dev), b)
    res["ms_5pct_rows_weighted"] = res["rows_5pct_weighted"]["ms"]
    res["zero_weights"] = _time_full_call(flush, bins, torch.zeros_like(w),
                                          b)
    if shapes:
        res["shapes_masked_train"] = {}
        for tag in ("median", "largest"):
            rows = int(round(shapes[tag]["share"] * n))
            res["shapes_masked_train"][tag] = dict(
                _time_full_call(flush, bins,
                                wall * share_mask(n, rows, 93, dev), b),
                recorded=shapes[tag])
    # uint8 codes at 255 bins
    bins8, w8 = full_inputs(92, np.uint8, NUM_BINS, "random")
    r8 = _time_full_call(flush, bins8, w8, NUM_BINS)
    res.update(ms_uint8_B255=r8["ms"], kernel_ms_uint8_B255=r8["kernel_ms"],
               bound_ms_uint8_B255=r8["bound_ms"])
    return res


def _time_packed_call(flush, words, w, reps: int = 20) -> dict:
    """hist_packed through the wrapper and alone at one window, with its
    bound (every word and weight read once, the output written once)."""
    from lightgbm_tpu_torch.ops.hist_packed import build_histogram_packed

    s = words.shape[1]
    call = (lambda: build_histogram_packed(words, w, num_bins=NUM_BINS))
    ms = cuda_ms(call, reps, flush)
    nbytes = FW * s * 4 + 3 * s * 4 + 4 * FW * NUM_BINS * 3 * 4
    return dict(rows=s, ms=ms, kernel_ms=cuda_ms(staged(call), reps, flush),
                achieved_GBps=nbytes / ms / 1e6,
                **_bound(nbytes, 4 * FW * s * 3))


def _time_packed(flush) -> dict:
    """hist_packed at the full window (the root's, the compact path's only
    launch) and at 65,536 rows (with the plain version and the library
    call), with zero weights at both."""
    from lightgbm_tpu_torch.ops.hist_packed import (
        build_histogram_packed_plain, pack_bin_words, unpack_bin_words)

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(2)
    codes = rng.randint(0, NUM_BINS, size=(4 * FW, N_FULL)).astype(np.uint8)
    words = pack_bin_words(torch.from_numpy(codes).to(dev))
    bag = torch.from_numpy((rng.rand(N_FULL) < 0.9).astype(np.float32)) \
        .to(dev)
    w = torch.stack([
        torch.from_numpy(rng.randn(N_FULL).astype(np.float32)).to(dev) * bag,
        torch.from_numpy(rng.rand(N_FULL).astype(np.float32)).to(dev) * bag,
        bag])
    reps = 20
    rows = {}
    for tag, s in (("full", N_FULL), ("65536", 65_536)):
        wv, ww = words[:, :s], w[:, :s]
        flat = (unpack_bin_words(wv, 4 * FW).to(torch.int64)
                + torch.arange(4 * FW, device=dev)[:, None] * NUM_BINS) \
            .reshape(-1)
        src = ww.t().unsqueeze(0).expand(4 * FW, s, 3).reshape(-1, 3) \
            .contiguous()
        r = _time_packed_call(flush, wv, ww)
        r["plain_ms"] = cuda_ms(lambda: build_histogram_packed_plain(
            wv, ww, num_bins=NUM_BINS), reps, flush)
        r["library_ms"] = cuda_ms(lambda: torch.zeros(
            4 * FW * NUM_BINS, 3, device=dev).index_add_(0, flat, src),
            reps, flush)
        r["zero_weights"] = _time_packed_call(flush, wv,
                                              torch.zeros_like(ww))
        rows[tag] = r
    return rows


def _events_ms(fn) -> float:
    """Device time in ms of what ``fn`` queues, from CUDA events."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def _device_ms(fn, symbol: str, spins: int = 1, reps: int = 1) -> float:
    """Mean device time in ms of the kernels named ``symbol`` that ``fn``
    launches (called ``reps`` times), from torch.profiler's kernel
    records: no host launch time in it, which a kernel of a few
    microseconds timed by events carries.  ``spins`` spin kernels of a
    million cycles open the window (the profiler drops the kernels of a
    window's first milliseconds on the H100); a window with no record is
    taken again, twice, then None.  ``fn`` must be safe to call again."""
    import re

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):          # a window the profiler kept no record of
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(spins):
                torch.cuda._sleep(1_000_000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and re.search(rf"(^|::){symbol}(<[^>]*>)?\(", e.name)]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def _replay_bytes(tab, before, after, pops: int) -> float:
    """What one replay pass must move.  Read: per slot the gain, split flag,
    left child, avail flag and leaf index, and the counters (the window
    widths are read only for a stall's batch extras, which the bound leaves
    out).  Written: per pop the pop record (8) and the two children's leaf
    indices (8), the avail flags whose value the pass changed, the counters
    and the correction's members and valid mask."""
    from lightgbm_tpu_torch.ops.replay import NUM_CTL

    m = before[0].numel()
    changed = int((before[0].cpu() != after[0].cpu()).sum())
    kb = before[4].numel()
    return m * (tab[0].element_size() + 1 + 8 + 1 + 4) + NUM_CTL * 4 \
        + pops * (8 + 8) + changed + NUM_CTL * 4 + kb * (8 + 1)


def _time_replay_pass(tab, fresh, kw, reps: int = 20,
                      plain: bool = False) -> dict:
    """One replay pass from the state ``fresh`` over the node table ``tab``
    (CUDA tensors): the wrapper and the kernel alone (its C entry point
    replayed), each launch on its own copy of the state, then the kernel
    alone again on the states it left (``noop_kernel_ms`` where the pass
    ended the replay), and the plain version on the card; the pops, the
    flag and the bound."""
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.ops.replay import (CTL_FLAG, CTL_POPS,
                                               replay_pass,
                                               replay_pass_plain)

    states = [[t.clone() for t in fresh] for _ in range(reps)]

    def reset():
        for st in states:
            for a, b in zip(st, fresh):
                a.copy_(b)

    n0 = replay_pass.launches
    replay_pass(*tab, *states[0], **kw)                 # build and warm
    reset()
    ms = _events_ms(lambda: [replay_pass(*tab, *st, **kw)
                             for st in states]) / reps
    pops = int(states[0][3][CTL_POPS]) - int(fresh[3][CTL_POPS])
    flag = int(states[0][3][CTL_FLAG])
    bound = _bound(_replay_bytes(tab, fresh, states[0], pops), 0)
    reset()
    with native.staging() as rec:
        for st in states:
            replay_pass(*tab, *st, **kw)
    reset()
    kernel_ms = _events_ms(lambda: [r() for r in rec]) / reps
    again_ms = _events_ms(lambda: [r() for r in rec]) / reps
    again_dev = _device_ms(lambda: [r() for r in rec], "replay_pass")
    device_ms = _device_ms(lambda: (reset(), [r() for r in rec]),
                           "replay_pass")
    out = dict(ms=ms, kernel_ms=kernel_ms, device_ms=device_ms, pops=pops,
               flag=flag, M=int(fresh[0].numel()), **bound)
    if flag == 2:
        out["noop_kernel_ms"] = again_ms
        out["noop_device_ms"] = again_dev
    if plain:
        reset()
        out["plain_ms"] = _events_ms(lambda: [replay_pass_plain(
            *tab, *st, **kw) for st in states[:3]]) / 3
    replay_pass.launches = n0
    out["_rec"] = rec
    out["_reset"] = (reset, states)
    return out


def _time_replay(shapes=None, reps: int = 20) -> dict:
    """One replay pass of the bench configuration (M = 1,145 node slots,
    254 splits, stall batch 4) over a forest grown past the budget, so the
    pass makes all 254 pops (the first pass of a tree makes most): the
    wrapper, the kernel alone (its C entry point replayed) and the plain
    version on the card, each pass on its own fresh state; the kernel on a
    state whose replay has ended (the pass queued after the last, which
    returns at once) and on one whose budget is spent (the fixed cost).
    Then the main path's median and largest pass (wave_train's eager tree,
    its recorded inputs) and a pass of 4,094 pops at num_leaves=4095's
    sizing (M = 16,505).  The bound: the node table read once (not the
    window widths, which only a stall's batch extras read) and what the
    pass writes."""
    from lightgbm_tpu_torch.ops.replay import CTL_POPS, FLAG_DONE

    dev = torch.device("cuda", 0)
    # a forest the replay needed no correction in: the final tables of a
    # replay run to its end from a half-grown forest of positive gains
    rng = np.random.RandomState(3)
    tab, nn = replay_forest(rng, REPLAY_BUDGET // 2, positive=True)
    replay_to_end(rng, tab, nn, replay_state(), REPLAY_KW,
                  vals=REPLAY_GAINS[2:])
    tab = [t.to(dev) for t in tab]
    res = _time_replay_pass(tab, replay_state(dev), REPLAY_KW, reps,
                            plain=True)
    rec, (reset, states) = res.pop("_rec"), res.pop("_reset")
    check(res["pops"] == REPLAY_BUDGET and res["flag"] == FLAG_DONE,
          f"the timed replay pass made {res['pops']} pops")
    # the fixed cost: the table's load and the list, no pop (the budget
    # already spent)
    reset()
    for st in states:
        st[3][CTL_POPS] = REPLAY_BUDGET
    res["fixed_kernel_ms"] = _events_ms(lambda: [r() for r in rec]) / reps

    def spent():
        reset()
        for st in states:
            st[3][CTL_POPS] = REPLAY_BUDGET
        for r in rec:
            r()

    res["fixed_device_ms"] = _device_ms(spent, "replay_pass")
    res["us_per_pop"] = (res["kernel_ms"] - res["fixed_kernel_ms"]) * 1e3 \
        / res["pops"]
    if res["device_ms"] is not None and res["fixed_device_ms"] is not None:
        res["us_per_pop_device"] = (res["device_ms"]
                                    - res["fixed_device_ms"]) * 1e3 \
            / res["pops"]
    res.update(library_ms=None,
               library="no single PyTorch call computes this function")
    if shapes:
        res["shapes_wave_train"] = {}
        for tag in ("median", "largest"):
            (before, kw) = shapes[tag]["inputs"]
            r = _time_replay_pass(before[:4], before[4:], kw, reps)
            r.pop("_rec"), r.pop("_reset")
            check(r["pops"] == shapes[tag]["pops"],
                  f"the {tag} pass replayed {r['pops']} pops, not "
                  f"{shapes[tag]['pops']}")
            res["shapes_wave_train"][tag] = r
    # num_leaves=4095: a forest grown in the replay's order, one pass of
    # every pop
    m, b = replay_dims(4095)
    tab, _ = replay_ordered_forest(np.random.RandomState(5), m, b, 0.0)
    kw = dict(REPLAY_KW, budget=b, pad_slot=m)
    r = _time_replay_pass([t.to(dev) for t in tab],
                          replay_state(dev, m=m, b=b), kw, reps)
    r.pop("_rec"), r.pop("_reset")
    check(r["pops"] == b, f"the M = {m} pass made {r['pops']} pops")
    res["num_leaves_4095"] = r
    return res


#: the sharded_train phase: (tag, world, tree_learner, extra params, the
#: params of ``_shard_params``, the serial run its model is held against).
#: Every mode trains SHARD_ITERS iterations of the bench rows on ranks that
#: share the one card over gloo: the wave-based modes with quantized
#: gradients and the opening (their histograms are exact integer sums, so
#: a model is independent of how the ranks split the sums and can equal
#: the serial one's exactly; float32 sums are held bitwise on dyadic
#: gradients); data, voting with every feature elected and feature also
#: at the default float32 params, the path ``tree_learner=data`` gives a
#: user; the masked fall-back in float32 at 1,023 bins
SHARD_ITERS = 3
SHARD_RUNS = (
    ("data", 2, "data", {}, "wave", "serial"),
    ("voting_all", 2, "voting", {"top_k": FEATURES}, "wave", "serial"),
    ("voting", 2, "voting", {}, "wave", None),
    ("feature", 2, "feature", {}, "wave", "serial"),
    ("data_f32", 2, "data", {}, "wave_f32", "serial_f32"),
    ("voting_all_f32", 2, "voting", {"top_k": FEATURES}, "wave_f32",
     "serial_f32"),
    ("feature_f32", 2, "feature", {}, "wave_f32", "serial_f32"),
    ("masked", 2, "data", {}, "masked", "serial_masked"),
    ("data_feature", 4, "data_feature", {"parallel_mesh": "2x2"}, "wave",
     "serial"),
)
#: the serial references: (name, params); each trains on its params' rows
SHARD_REFS = (("serial", "wave"), ("serial_f32", "wave_f32"),
              ("serial_masked", "masked"))
SHARD_PRED_ROWS = 10_000
#: the kernels each wave-based mode's learner launches on every rank
SHARD_KERNELS = ("hist_packed", "hist_segments", "partition", "split_scan",
                 "replay", "hist_multislot", "fused_scan")


def _shard_structure(text: str) -> list:
    keep = ("split_feature=", "threshold=", "left_child=", "right_child=",
            "num_leaves=", "decision_type=")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def _shard_params() -> dict:
    """The phase's params: the quant+opening cell's, the wave cell's
    (float32) and the masked cell's (float32); telemetry on for the
    collective ledger."""
    quant = {k: v for k, v in QUANT_PARAMS.items() if k != "metric"}
    f32 = {k: v for k, v in WAVE_PARAMS.items() if k != "metric"}
    return {"wave": dict(quant, telemetry=True),
            "wave_f32": dict(f32, telemetry=True),
            "masked": dict(WAVE_PARAMS, max_bin=MASKED_BINS, telemetry=True,
                           metric="binary_logloss")}


def _shard_rows(params_key: str) -> str:
    """The binned rows a params key trains on."""
    return "masked" if params_key == "masked" else "wave"


def _shard_counters() -> dict:
    from lightgbm_tpu_torch.ops.fused_scan import fused_child_scans
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full
    from lightgbm_tpu_torch.ops.hist_multislot import \
        build_histogram_multislot
    out = dict(wave_counters())
    out.update(hist_multislot=build_histogram_multislot,
               fused_scan=fused_child_scans, hist_full=build_histogram_full)
    return out


_SHARD_CACHE: dict = {}


def _shard_train(params: dict, ds, iters: int) -> tuple:
    """``iters`` iterations of ``params`` on ``ds`` on this process's card,
    as a user calls them; the booster, the seconds of each iteration and
    the launches of each kernel (their counts set to 0 just before)."""
    import lightgbm_tpu_torch as lt
    t_iter, marks = [], {}

    def before(env):
        torch.cuda.synchronize()
        marks["t0"] = time.perf_counter()
    before.before_iteration = True

    def after(env):
        torch.cuda.synchronize()
        t_iter.append(time.perf_counter() - marks["t0"])

    counters = _shard_counters()
    for fn in counters.values():
        fn.launches = 0
    bst = lt.train(params, ds, iters, verbose_eval=False,
                   callbacks=[before, after])
    launches = {k: fn.launches for k, fn in counters.items()}
    return bst, t_iter, launches


def _shard_dyadic(learner, data, cfg, dev, rows=None) -> tuple:
    """One float32 tree of a learner of ``learner``'s class (the trained
    one's mesh and data, quantization off) from the dyadic gradients of
    seed 1, placed as ``rows`` places them: (records, exact counts)."""
    g, h, b = dyadic_weights(np.random.RandomState(1), data.num_data_padded,
                             data.num_data, dev)
    if rows is not None:
        g, h, b = (rows.place("rows", a) for a in (g, h, b))
    from lightgbm_tpu_torch.parallel.learners import ShardedMaskedLearner
    cfg = copy.copy(cfg)
    cfg.tpu_quantized_grad = "off"
    if isinstance(learner, ShardedMaskedLearner):
        args = (cfg, data, learner.mesh, dev, learner.mode)
    elif hasattr(learner, "mesh"):
        args = (cfg, data, learner.mesh, dev)
    else:
        args = (cfg, data, dev)
    rec_f, rec_i, _, _ = type(learner)(*args).grow(g, h, b)
    return rec_f, rec_i


def _shard_rank(runs: list, paths: dict, Xp) -> list:
    """One rank of the sharded_train phase: each run's dataset loaded from
    the binary cache every rank reads, the run trained on the card, then
    one float32 tree of its learner's class from dyadic gradients."""
    import lightgbm_tpu_torch as lt
    import torch.distributed as dist

    from lightgbm_tpu_torch.parallel.sharding import rules_for_mode
    out = []
    for tag, params, key, iters in runs:
        t0 = time.perf_counter()
        if key not in _SHARD_CACHE:
            ds = lt.Dataset(paths[key], params=params)
            ds.construct()
            _SHARD_CACHE[key] = ds
        ds = _SHARD_CACHE[key]
        load_s = time.perf_counter() - t0
        bst, t_iter, launches = _shard_train(params, ds, iters)
        gbdt = bst.gbdt
        learner, mesh = gbdt.learner, gbdt._mesh
        trees = len(gbdt.models)
        rep = bst.get_telemetry()
        stats = getattr(learner, "tree_stats", [])
        res = {
            "tag": tag, "rank": dist.get_rank(),
            "learner": type(learner).__name__,
            "device": str(learner.device),
            "backend": mesh.backend,
            "transport": mesh.transport(learner.device),
            "load_s": load_s,
            "s_per_iter": t_iter,
            "host_syncs_per_tree": learner.host_syncs / trees,
            "graph_launches_per_tree": [s.get("graph_launches", 0)
                                        for s in stats],
            "kernel_launches": launches,
            "collective_calls_per_tree": mesh.calls / trees,
            "collective_bytes_per_tree": mesh.bytes / trees,
            "collective_s_per_tree": mesh.seconds / trees,
            "ledger_per_tree": rep["collectives"]["per_tree_estimate"],
            "ledger_sites": len(rep["collectives"]["sites"]),
            "text": bst.model_to_string(),
            "pred": bst.predict(Xp),
            "raw": bst.predict(Xp, raw_score=True)}
        res["dyadic_records"] = _shard_dyadic(
            learner, learner.data, learner.cfg, learner.device,
            rules_for_mode(gbdt._parallel_mode, mesh))
        out.append(res)
    return out


def phase_sharded_train(ctx) -> None:
    import tempfile

    from lightgbm_tpu_torch.parallel.launch import RankPool

    dev = torch.device("cuda", 0)
    params = _shard_params()
    data = {"wave": _dataset(ctx)[0], "masked": _dataset_masked(ctx)[0]}
    Xp = ctx["Xv"][:SHARD_PRED_ROWS]
    # the serial references on this card: the models, and one float32 tree
    # of the serial learner from the dyadic gradients every rank grows too
    refs = {}
    for name, key in SHARD_REFS:
        t0 = time.perf_counter()
        ds = data[_shard_rows(key)]
        bst, t_iter, _ = _shard_train(params[key], ds, SHARD_ITERS)
        refs[name] = {"text": bst.model_to_string(),
                      "pred": bst.predict(Xp),
                      "raw": bst.predict(Xp, raw_score=True),
                      "records": _shard_dyadic(bst.gbdt.learner,
                                               ds.constructed,
                                               bst.gbdt.learner.cfg, dev),
                      "learner": type(bst.gbdt.learner).__name__,
                      "s_per_iter": t_iter, "s": time.perf_counter() - t0}
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        # every rank reads the same input: the binned rows, cached once
        t0 = time.perf_counter()
        paths = {}
        for key, ds in data.items():
            paths[key] = f"{tmp}/{key}.bin"
            ds.save_binary(paths[key])
        save_s = time.perf_counter() - t0
        for world in (2, 4):
            runs = [(tag, dict(params[key], tree_learner=mode, **extra),
                     _shard_rows(key), SHARD_ITERS)
                    for tag, w, mode, extra, key, _ in SHARD_RUNS
                    if w == world]
            t0 = time.perf_counter()
            # gloo: the ranks share this one card, which NCCL refuses
            with RankPool(world, "gloo", timeout_s=300) as pool:
                start_s = time.perf_counter() - t0
                per_rank = pool.run(_shard_rank, runs, paths, Xp,
                                    timeout_s=900)
            for i, (tag, *_rest) in enumerate(runs):
                results[tag] = [r[i] for r in per_rank]
                results[tag][0]["pool_start_s"] = start_s
                results[tag][0]["pool_wall_s"] = time.perf_counter() - t0
    out = {"phase": "sharded_train", "iterations": SHARD_ITERS,
           "serial": {k: {f: v[f] for f in ("learner", "s_per_iter", "s")}
                      for k, v in refs.items()},
           "binary_cache_save_s": save_s, "modes": {}}
    try:
        _shard_checks(results, refs, out)
    finally:
        emit(out)


def _shard_checks(results: dict, refs: dict, out: dict) -> None:
    """Hold every mode's ranks against each other and the serial runs;
    each mode's line goes into ``out`` before it is checked."""
    for tag, world, mode, extra, pkey, ref in SHARD_RUNS:
        ranks = results[tag]
        text = ranks[0]["text"]
        mode_out = out["modes"][tag] = {
            "world": world, "tree_learner": mode, "params": pkey,
            "extra": extra, "learner": ranks[0]["learner"],
            "ranks": [{k: v for k, v in r.items()
                       if k not in ("text", "pred", "raw", "dyadic_records")}
                      for r in ranks]}
        check(len(ranks) == world, f"{tag}: {len(ranks)} ranks")
        check(all(r["text"] == text for r in ranks),
              f"sharded_train {tag}: the ranks' models differ")
        mode_out["ranks_agree"] = True
        # voting scans its elected features outside the fused kernel (as
        # the JAX voting learners do); float32 runs no opening and no
        # quantized scan
        kernels = ("hist_full",) if pkey == "masked" else tuple(
            k for k in SHARD_KERNELS
            if not (mode == "voting" and k == "fused_scan")
            and not (pkey == "wave_f32"
                     and k in ("hist_multislot", "fused_scan")))
        for r in ranks:
            check(r["device"].startswith("cuda"),
                  f"{tag}: rank {r['rank']} trained on {r['device']}")
            for k in kernels:
                check(r["kernel_launches"][k] > 0,
                      f"{tag}: rank {r['rank']} never launched {k}")
            check(r["collective_calls_per_tree"] > 0,
                  f"{tag}: rank {r['rank']} issued no collective")
        if ref is not None:
            want = refs[ref]
            # Booster.predict's probabilities; the raw scores' difference
            # reported beside them
            diff = float(np.abs(ranks[0]["pred"] - want["pred"]).max())
            mode_out["pred_max_diff_vs_serial"] = diff
            mode_out["raw_max_diff_vs_serial"] = float(
                np.abs(ranks[0]["raw"] - want["raw"]).max())
            check(_shard_structure(text) == _shard_structure(want["text"]),
                  f"sharded_train {tag}: the model's structure differs from "
                  f"the serial model's")
            check(diff < 1e-5, f"sharded_train {tag}: predictions differ "
                  f"from the serial model's by {diff}")
            rf, ri = want["records"]
            for r in ranks:
                check(np.array_equal(r["dyadic_records"][0], rf)
                      and np.array_equal(r["dyadic_records"][1], ri),
                      f"sharded_train {tag}: rank {r['rank']}'s dyadic tree "
                      f"records differ from the serial learner's")
            mode_out.update(structure_equal_serial=True,
                            dyadic_records_bitwise=True)
        if tag.startswith("voting_all"):
            data_tag = tag.replace("voting_all", "data")
            check(_shard_structure(text)
                  == _shard_structure(results[data_tag][0]["text"]),
                  f"{tag}: voting with every feature elected differs from "
                  f"{data_tag}")
            mode_out["equals_data"] = True


# -- multihost_train: pods of emulated hosts on the one card -----------------

#: the pod leg's iterations and the elastic leg's (the JAX drills' six)
POD_ITERS, ELASTIC_ITERS = 3, 6
#: the loader and elastic legs' CSV: the first rows of the bench data
#: (200,000 before the 3 x 2 elastic leg; cut for the time limit)
POD_CSV_ROWS = 100_000
#: the CSV legs' FindBin sample (the default 200,000 would be every row;
#: host FindBin over it takes 20 s a load, over 50,000 about 5 s, and each
#: elastic worker loads once an epoch)
POD_CSV_SAMPLE = 25_000
#: the chaos leg's collective deadline (seconds)
POD_DEADLINE_S = 5.0
#: the elastic legs' deadline: the two legs run together, nine workers
#: sharing the card and the host's cores, so a rank may start later
ELASTIC_DEADLINE_S = 10.0


def _rank_auc(y, s) -> float:
    """Tie-averaged rank AUC of scores ``s`` for 0/1 labels ``y``."""
    y, s = np.asarray(y) > 0, np.asarray(s, dtype=np.float64)
    order = np.argsort(s, kind="mergesort")
    _, inv, counts = np.unique(s[order], return_inverse=True,
                               return_counts=True)
    ends = np.cumsum(counts)
    ranks = np.empty(len(s))
    ranks[order] = ((ends - counts + 1 + ends) / 2.0)[inv]
    n1 = int(y.sum())
    n0 = len(y) - n1
    return float((ranks[y].sum() - n1 * (n1 + 1) / 2.0) / (n1 * n0))


def _pod_params() -> dict:
    """The pod leg's params: ``sharded_train``'s ``data`` mode (the
    quant+opening cell, whose integer sums leave the model the serial
    one's exactly) with telemetry sampling every other iteration (the
    exchange probe)."""
    return dict(_shard_params()["wave"], tree_learner="data",
                telemetry_sync_every=2)


def _pod_train_rank(spec: dict) -> dict:
    """A pod or pool rank: the cached bench rows trained ``POD_ITERS``
    iterations with the kernel counts set to 0 just before (``_shard_train``);
    the model, predictions, launches and the report's pod figures."""
    import lightgbm_tpu_torch as lt
    import torch.distributed as dist
    params = dict(_pod_params(), **spec.get("extra", {}))
    ds = lt.Dataset(spec["cache"], params=params)
    ds.construct()
    bst, t_iter, launches = _shard_train(params, ds, POD_ITERS)
    rep = bst.get_telemetry()
    hb = rep["phases"].get("heartbeat", {"total_ms": 0.0, "count": 0})
    Xp = np.load(spec["xp"])
    return {"rank": dist.get_rank(), "backend": dist.get_backend(),
            "device": str(bst.gbdt.learner.device),
            "learner": type(bst.gbdt.learner).__name__,
            "launches": launches, "s_per_iter": t_iter,
            "heartbeat_ms_per_iter": (hb["total_ms"] / hb["count"]
                                      if hb["count"] else None),
            "heartbeats": hb["count"],
            "exchange_probe_ms": rep["gauges"].get("exchange_probe_ms"),
            "text": bst.model_to_string(),
            "pred": bst.predict(Xp).tolist()}


def _rank_job(spec: dict) -> dict:
    """One process of the multihost_train phase (``--rank-job``)."""
    from lightgbm_tpu_torch.parallel import multihost
    job = spec["job"]
    if job == "pod":
        return _pod_train_rank(spec)
    if job == "loader":
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.dataset import _ConstructedDataset
        cfg = Config.from_params(spec["params"])
        assert multihost.initialize_from_config(cfg)
        net = multihost.DistributedNet(cfg, namespace="loader")
        t0 = time.perf_counter()
        ds = _ConstructedDataset.from_stream(spec["csv"], spec["params"],
                                             cfg, net=net)
        secs = time.perf_counter() - t0
        ref = np.load(spec["ref_codes"], mmap_mode="r")
        nu = len(ds.bin_mappers)
        codes_equal = bool(np.array_equal(
            ds.bins[:nu, :ds.num_data], ref[:nu][:, ds.global_rows]))
        net.close()
        return {"rank": net.rank, "rows": int(ds.num_data),
                "rows_global": int(ds.num_data_global), "load_s": secs,
                "mappers": json.dumps([m.to_dict() for m in ds.bin_mappers]),
                "used": ds.used_feature_map.tolist(),
                "codes_equal": codes_equal}
    if job == "chaos":
        from lightgbm_tpu_torch.config import Config
        from lightgbm_tpu_torch.reliability.metrics import rel_counters
        cfg = Config.from_params(spec["params"])
        assert multihost.initialize_from_config(cfg)
        net = multihost.DistributedNet(cfg, namespace="chaos")
        out = {"rank": net.rank, "error": None}
        t0 = time.perf_counter()
        try:
            for i in range(6):
                t0 = time.perf_counter()
                net.heartbeat(i)
        except ConnectionError as e:
            out.update(error=str(e), elapsed_s=time.perf_counter() - t0,
                       dead_ranks=list(getattr(e, "dead_ranks", ())))
        out["counters"] = rel_counters()
        return out
    if job == "elastic":
        return _elastic_agent(spec)
    raise ValueError(f"unknown rank job {job!r}")


def _host_workers(hostdir: str) -> list:
    """Pids of the live elastic workers whose spec lies under ``hostdir``
    (one host's workers of every epoch), from each process's command
    line."""
    import os
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read().decode(errors="replace").split("\0")
        except OSError:
            continue
        if "lightgbm_tpu_torch.elastic.worker" in cmd and any(
                a.startswith(hostdir + os.sep) for a in cmd):
            out.append(int(pid))
    return out


def _elastic_agent(spec: dict) -> dict:
    """One host's elastic agent (``elastic.run_host``) of the
    multihost_train phase: its model and history, or the host's death;
    the host's workers still running after it, and each worker's global
    rank and backend in the last epoch."""
    import glob
    import os
    import re

    from lightgbm_tpu_torch.elastic import ElasticHostDead, run_host
    out = {"host": spec["host"]}
    hostdir = os.path.join(os.path.abspath(spec["workdir"]),
                           f"h{spec['host']}")
    t0 = time.perf_counter()
    try:
        res = run_host(spec["params"], spec["csv"], ELASTIC_ITERS,
                       host_id=spec["host"], num_hosts=spec["hosts"],
                       workdir=spec["workdir"],
                       worker_env=spec.get("env") or {},
                       worker_timeout_s=300)
        with open(res.model_path) as fh:
            out["model"] = fh.read()
        out.update(history=res.history, recoveries=res.recoveries,
                   recovery_wall_s=res.recovery_wall_s,
                   iterations=res.result.get("iterations"))
        last = os.path.join(hostdir, f"e{res.history[-1]['epoch']}")
        ranks = []
        for path in sorted(glob.glob(os.path.join(last, "result*.json"))):
            with open(path) as fh:
                r = json.load(fh)
            ranks.append({k: r.get(k) for k in ("global_rank", "local_rank",
                                                "backend")})
        out["ranks"] = ranks
        verdict = os.path.join(hostdir, "e0", "verdict.json")
        if os.path.exists(verdict):
            with open(verdict) as fh:
                v = json.load(fh)
            out["dead_ranks"] = v.get("dead_ranks")
            # the RankDeathError names the rank that raised it
            m = re.search(r"on rank (\d+)", v.get("error", ""))
            out["named_by_rank"] = int(m.group(1)) if m else None
    except ElasticHostDead as e:
        out.update(error_kind="host_dead", rc=e.rc, error=str(e)[-2000:])
    out["wall_s"] = time.perf_counter() - t0
    out["left_running"] = _host_workers(hostdir)
    out["cuda_initialized"] = torch.cuda.is_initialized()
    return out


def _run_ranks(specs, envs, timeout_s: float) -> dict:
    """``chip_smoke.py --rank-job`` once per spec, all started together
    with the extra environment ``envs[i]``; {index: (exit code, result or
    None, output tail)}.  Each runs in a session of its own, killed whole
    at the end (an elastic agent's workers with it)."""
    import os
    import signal
    procs = []
    try:
        for spec, extra in zip(specs, envs):
            env = dict(os.environ)
            for k in ("LGBT_COORDINATOR", "LGBT_NUM_HOSTS",
                      "LGBT_PROCESS_ID", "LOCAL_WORLD_SIZE", "LOCAL_RANK",
                      "WORLD_SIZE", "RANK", "LGBT_FAULTS"):
                env.pop(k, None)
            env.update(extra)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--rank-job", json.dumps(spec)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, start_new_session=True))
        deadline = time.monotonic() + timeout_s
        tails = [p.communicate(timeout=max(deadline - time.monotonic(),
                                           1.0))[0] for p in procs]
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
    out = {}
    for i, (spec, p, tail) in enumerate(zip(specs, procs, tails)):
        res = None
        if os.path.exists(spec["out"]):
            with open(spec["out"]) as fh:
                res = json.load(fh)
        out[i] = (p.returncode, res, tail[-3000:])
    return out


def _pod_env(port: int, host: int, hosts: int, local: int = 0,
             locals_: int = 1) -> dict:
    return {"LGBT_COORDINATOR": f"127.0.0.1:{port}",
            "LGBT_NUM_HOSTS": str(hosts), "LGBT_PROCESS_ID": str(host),
            "LOCAL_WORLD_SIZE": str(locals_), "LOCAL_RANK": str(local)}


def phase_multihost_train(ctx) -> None:
    """Pods of emulated hosts on the one card (``parallel/multihost.py``,
    ``io/distributed.py``, ``elastic/``), every rank a process:

      (i)   2 hosts x 2 ranks (LGBT_*, LOCAL_WORLD_SIZE=2) train
            tree_learner=data (sharded_train's quant+opening data mode) 3
            iterations on the 1M bench rows from one binary cache: the
            ranks' texts equal, held against the serial model, each
            rank's launches of every wave kernel equal to a 4-rank
            RankPool run's; the backend (gloo: one card),
            heartbeat ms, exchange_probe_ms, s per iteration and the
            merged pod trace's events;
      (ii)  a two_round load of a 100,000-row bench CSV by 2 hosts over
            DistributedNet (FindBin split by feature range): the mappers
            and the owned rows' codes equal single-host's;
      (iii) 3 hosts heartbeat with net.crash:rank=1:nth=3: rank 1 exits 17,
            every survivor names it within the deadline;
      (iv)  elastic.run_host on 3 emulated hosts over the CSV, 6 iterations,
            host 1's worker killed at its 5th collective: the survivors
            finish every round with equal models, AUC within 2e-3 of a
            serial model on the same rows; the recovery's wall seconds;
      (v)   the same on 3 hosts x 2 ranks (the agents under
            LOCAL_WORLD_SIZE=2, a worker a rank), net.crash:rank=3:nth=5
            armed in host 1's agent: its local rank 1 dies, host 1 goes
            down whole with no worker left, hosts 0 and 2 go on as 2 x 2
            with the same checks; every final rank's backend (gloo: one
            card), the rank that named the death, the dead ranks.  (iv)
            and (v) run together, with a 10 s collective deadline.
    """
    import tempfile

    out = {"phase": "multihost_train", "pod_iterations": POD_ITERS,
           "elastic_iterations": ELASTIC_ITERS}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            _multihost_legs(ctx, tmp, out)
    finally:
        emit(out)


def _multihost_legs(ctx, tmp: str, out: dict) -> None:
    import os

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.dataset import _ConstructedDataset
    from lightgbm_tpu_torch.observability import podtrace
    from lightgbm_tpu_torch.parallel.launch import RankPool, free_port
    t_phase = time.perf_counter()
    ds, _ = _dataset(ctx)
    params = _pod_params()
    Xp = ctx["Xv"][:SHARD_PRED_ROWS]
    xp = os.path.join(tmp, "xp.npy")
    np.save(xp, Xp)
    cache = os.path.join(tmp, "bench.bin")
    ds.save_binary(cache)
    # the serial reference on this card
    bst, t_ser, _ = _shard_train(dict(params, tree_learner="serial"), ds,
                                 POD_ITERS)
    serial = {"text": bst.model_to_string(), "pred": bst.predict(Xp)}
    out["serial_s_per_iter"] = t_ser

    # -- (ii) and (iii) inputs: the bench CSV and the single-host codes
    X, logit = higgs_latent(ROWS + VALID_ROWS)
    y = (logit > 0).astype(np.float64)
    csv = os.path.join(tmp, "bench.csv")
    t0 = time.perf_counter()
    np.savetxt(csv, np.column_stack([y[:POD_CSV_ROWS], X[:POD_CSV_ROWS]]),
               delimiter=",", fmt="%.17g")
    out["csv_write_s"] = time.perf_counter() - t0
    lparams = {"max_bin": 255, "verbosity": -1,
               "bin_construct_sample_cnt": POD_CSV_SAMPLE}
    t0 = time.perf_counter()
    single = _ConstructedDataset.from_stream(csv, lparams,
                                             Config.from_params(lparams))
    out["loader_single_host_s"] = time.perf_counter() - t0
    ref_codes = os.path.join(tmp, "codes.npy")
    np.save(ref_codes, single.bins[:, :single.num_data])

    # -- (i) the 2 x 2 pod, with (ii) and (iii) beside it on other ports
    port = free_port()
    pod_specs, pod_envs = [], []
    for h in range(2):
        for l in range(2):
            r = 2 * h + l
            pod_specs.append({
                "job": "pod", "cache": cache, "xp": xp,
                "out": os.path.join(tmp, f"pod{r}.json"),
                "extra": {"trace_out": os.path.join(tmp, "pod_trace.json")}})
            pod_envs.append(_pod_env(port, h, 2, l, 2))
    lport, cport = free_port(), free_port()
    side_specs, side_envs = [], []
    for h in range(2):
        side_specs.append({
            "job": "loader", "csv": csv, "ref_codes": ref_codes,
            "params": dict(lparams, coordinator_address=f"127.0.0.1:{lport}",
                           num_hosts=2, process_id=h, device_type="cpu"),
            "out": os.path.join(tmp, f"loader{h}.json")})
        side_envs.append({})
    chaos_outs = [os.path.join(tmp, f"chaos{h}.json") for h in range(3)]
    for h in range(3):
        side_specs.append({
            "job": "chaos",
            "params": {"coordinator_address": f"127.0.0.1:{cport}",
                       "num_hosts": 3, "process_id": h,
                       "net_collective_deadline_s": POD_DEADLINE_S,
                       "device_type": "cpu"},
            "out": chaos_outs[h],
            "peer_outs": chaos_outs if h == 0 else []})
        side_envs.append({"LGBT_FAULTS": "net.crash:rank=1:nth=3"})
    t0 = time.perf_counter()
    pod = _run_ranks(pod_specs + side_specs, pod_envs + side_envs, 400)
    out["pod_wall_s"] = time.perf_counter() - t0
    ranks = [pod[i] for i in range(4)]
    for r, (rc, res, tail) in enumerate(ranks):
        check(rc == 0 and res is not None,
              f"multihost_train pod rank {r} failed (rc={rc}):\n{tail}")
    ranks = [res for _, res, _ in ranks]
    with RankPool(4, "gloo", timeout_s=300) as pool:
        t0 = time.perf_counter()
        pool_out = pool.run(_pod_train_rank, {"cache": cache, "xp": xp},
                            timeout_s=600)
        out["pool_wall_s"] = time.perf_counter() - t0
    pod_out = out["pod"] = {
        "ranks": [{k: v for k, v in r.items() if k not in ("text", "pred")}
                  for r in ranks],
        "pool_launches": [r["launches"] for r in pool_out],
        "pool_s_per_iter": [r["s_per_iter"] for r in pool_out]}
    text = ranks[0]["text"]
    check(all(r["text"] == text for r in ranks),
          "multihost_train pod: the ranks' models differ")
    check(all(r["text"] == text for r in pool_out),
          "multihost_train pod: the model differs from the 4-rank pool's")
    check(all(r["backend"] == "gloo" and r["device"].startswith("cuda")
              for r in ranks),
          f"multihost_train pod: backends/devices "
          f"{[(r['backend'], r['device']) for r in ranks]}")
    check(all(r["heartbeats"] == POD_ITERS for r in ranks),
          "multihost_train pod: heartbeats != iterations")
    for r, p in zip(ranks, pool_out):
        for k in SHARD_KERNELS:
            check(r["launches"][k] > 0,
                  f"multihost_train pod rank {r['rank']} never launched {k}")
            check(r["launches"][k] == p["launches"][k],
                  f"multihost_train pod rank {r['rank']}: {k} launches "
                  f"{r['launches'][k]} != the pool's {p['launches'][k]}")
    diff = float(np.abs(np.asarray(ranks[0]["pred"]) - serial["pred"]).max())
    pod_out["pred_max_diff_vs_serial"] = diff
    check(_shard_structure(text) == _shard_structure(serial["text"]),
          "multihost_train pod: the model's structure differs from the "
          "serial model's")
    check(diff < 1e-5, f"multihost_train pod: predictions differ from the "
          f"serial model's by {diff}")
    paths = [os.path.join(tmp, f"pod_trace.json.rank{r}") for r in range(4)]
    merged = podtrace.merge_pod_trace(paths)
    pod_out["merged_trace_events"] = len(merged["traceEvents"])
    check(pod_out["merged_trace_events"] > 0 and all(
        any(ev.get("pid") == r and ev.get("name") == "heartbeat"
            for ev in merged["traceEvents"]) for r in range(4)),
          "multihost_train pod: the merged trace lacks a rank's heartbeats")

    # -- (ii) the loader
    loader = [pod[4 + h] for h in range(2)]
    for h, (rc, res, tail) in enumerate(loader):
        check(rc == 0 and res is not None,
              f"multihost_train loader host {h} failed (rc={rc}):\n{tail}")
    want = json.dumps([m.to_dict() for m in single.bin_mappers])
    out["loader"] = {"rows": [res["rows"] for _, res, _ in loader],
                     "load_s": [res["load_s"] for _, res, _ in loader]}
    for _, res, _ in loader:
        check(res["mappers"] == want
              and res["used"] == single.used_feature_map.tolist(),
              "multihost_train loader: mappers differ from single-host")
        check(res["codes_equal"] and res["rows_global"] == POD_CSV_ROWS,
              "multihost_train loader: owned rows' codes differ")
    check(sum(out["loader"]["rows"]) == POD_CSV_ROWS,
          "multihost_train loader: rows lost or doubled")

    # -- (iii) chaos
    chaos = [pod[6 + h] for h in range(3)]
    check(chaos[1][0] == 17, f"multihost_train chaos: rank 1 exited "
          f"{chaos[1][0]}, not 17:\n{chaos[1][2]}")
    out["chaos"] = {"deadline_s": POD_DEADLINE_S}
    for h in (0, 2):
        rc, res, tail = chaos[h]
        check(rc == 0 and res is not None and res["error"],
              f"multihost_train chaos survivor {h} (rc={rc}):\n{tail}")
        check("rank(s) 1" in res["error"] and "never posted" in res["error"]
              and res["dead_ranks"] == [1],
              f"multihost_train chaos: {res['error']}")
        check(res["elapsed_s"] < POD_DEADLINE_S + 5,
              f"multihost_train chaos: named after {res['elapsed_s']} s")
        out["chaos"][f"survivor{h}_s"] = res["elapsed_s"]

    # -- (iv) elastic, one rank a host, and (v) 3 hosts x 2 ranks, whose
    # host 1 loses its local rank 1 (global rank 3); run together
    eport, vport = free_port(), free_port()
    eparams = dict(WAVE_PARAMS, tree_learner="data", metric="none",
                   bin_construct_sample_cnt=POD_CSV_SAMPLE,
                   coordinator_address=f"127.0.0.1:{eport}",
                   net_collective_deadline_s=ELASTIC_DEADLINE_S)
    especs = [{"job": "elastic", "csv": csv, "host": h, "hosts": 3,
               "params": eparams, "workdir": os.path.join(tmp, "elastic"),
               "env": ({"LGBT_FAULTS": "net.crash:rank=1:nth=5"}
                       if h == 1 else {}),
               "out": os.path.join(tmp, f"elastic{h}.json")}
              for h in range(3)]
    vspecs = [{"job": "elastic", "csv": csv, "host": h, "hosts": 3,
               "params": dict(eparams,
                              coordinator_address=f"127.0.0.1:{vport}"),
               "workdir": os.path.join(tmp, "elastic_l2"),
               "env": ({"LGBT_FAULTS": "net.crash:rank=3:nth=5"}
                       if h == 1 else {}),
               "out": os.path.join(tmp, f"elastic_l2_{h}.json")}
              for h in range(3)]
    t0 = time.perf_counter()
    both = _run_ranks(especs + vspecs,
                      [{}] * 3 + [{"LOCAL_WORLD_SIZE": "2"}] * 3, 400)
    out["elastic_legs_wall_s"] = time.perf_counter() - t0
    el = {h: both[h] for h in range(3)}
    ev = {h: both[3 + h] for h in range(3)}

    def leg(runs, **kw):
        return dict(kw, rows=POD_CSV_ROWS, deadline_s=ELASTIC_DEADLINE_S,
                    wall_s=max((res or {}).get("wall_s", 0.0)
                               for _, res, _ in runs.values()))

    out["elastic"] = leg(el)
    sec = out["elastic_2_ranks_a_host"] = leg(ev, ranks_per_host=2)
    # the serial model on the same rows: the single-host load above has
    # the workers' bin config
    sparams = dict(WAVE_PARAMS, metric="none",
                   bin_construct_sample_cnt=POD_CSV_SAMPLE)
    sbst = lt.train(sparams, lt.Dataset._from_constructed(single, sparams),
                    ELASTIC_ITERS, verbose_eval=False)
    auc_s = _rank_auc(ctx["yv"], sbst.predict(ctx["Xv"]))
    _elastic_checks("elastic", el, out["elastic"], auc_s, ctx)
    _elastic_checks("elastic 3 x 2", ev, sec, auc_s, ctx)
    for h in (0, 2):
        res = ev[h][1]
        sec[f"host{h}_ranks"] = res["ranks"]
        sec[f"host{h}_named_by_rank"] = res.get("named_by_rank")
        check(sorted(r["global_rank"] for r in res["ranks"])
              == ([0, 1] if h == 0 else [2, 3])
              and all(r["backend"] == "gloo" for r in res["ranks"]),
              f"multihost_train elastic 3 x 2 host {h}: ranks {res['ranks']}")
        check(res.get("dead_ranks") is not None
              and 3 in res["dead_ranks"],
              f"multihost_train elastic 3 x 2 host {h}: dead ranks "
              f"{res.get('dead_ranks')}")
    out["phase_s"] = time.perf_counter() - t_phase


def _elastic_checks(tag: str, runs: dict, sec: dict, auc_s: float,
                    ctx) -> None:
    """An elastic leg of 3 hosts that loses host 1: host 1's agent reports
    its host dead by its worker's exit 17, with no worker left; hosts 0
    and 2 finish every round with the history [[0, 1, 2], [0, 2]], one
    recovery, no worker left, CUDA never initialized in an agent, equal
    models, held-out AUC within 2e-3 of the serial model's ``auc_s``."""
    import lightgbm_tpu_torch as lt

    rc1, res1, tail1 = runs[1]
    check(rc1 == 0 and res1 is not None
          and res1.get("error_kind") == "host_dead" and res1["rc"] == 17,
          f"multihost_train {tag}: host 1's agent (rc={rc1}): {res1}\n"
          f"{tail1}")
    check(res1["left_running"] == [] and res1["cuda_initialized"] is False,
          f"multihost_train {tag}: host 1 left {res1['left_running']}")
    models = []
    for h in (0, 2):
        rc, res, tail = runs[h]
        check(rc == 0 and res is not None and "model" in res,
              f"multihost_train {tag} host {h} failed (rc={rc}): {res}\n"
              f"{tail}")
        check(res["iterations"] == ELASTIC_ITERS
              and [e["members"] for e in res["history"]]
              == [[0, 1, 2], [0, 2]] and res["recoveries"] == 1,
              f"multihost_train {tag} host {h}: {res['history']}, "
              f"{res['iterations']} iterations")
        check(res["cuda_initialized"] is False and res["left_running"] == [],
              f"multihost_train {tag} host {h}: CUDA initialized in the "
              f"agent or workers left {res['left_running']}")
        sec[f"host{h}_recovery_wall_s"] = res["recovery_wall_s"]
        models.append(res["model"])
    check(models[0] == models[1], f"multihost_train {tag}: the survivors' "
          "models differ")
    ebst = lt.Booster(model_str=models[0])
    auc_e = _rank_auc(ctx["yv"], ebst.predict(ctx["Xv"]))
    sec.update(heldout_auc=auc_e, serial_heldout_auc=auc_s,
               trees=ebst.num_trees())
    check(ebst.num_trees() == ELASTIC_ITERS and abs(auc_e - auc_s) < 2e-3,
          f"multihost_train {tag}: AUC {auc_e} vs serial {auc_s}")


def phase_analysis(ctx) -> None:
    """The recompile sentinel of the analysis gate on the card (see the
    module docstring): zero CUDA graph captures after warm-up."""
    from lightgbm_tpu_torch.analysis import recompile

    t0 = time.perf_counter()
    findings, detail, skip = recompile.run("cuda")
    secs = time.perf_counter() - t0
    armed = detail.get("armed", {})
    emit({"phase": "analysis", "seconds": secs, "skip": skip,
          "counters": {k: v for k, v in detail.items() if k != "armed"},
          "findings": [str(f) for f in findings]})
    check(skip is None, f"the recompile sentinel skipped on the card: {skip}")
    need = ("train_step_wave", "quant_train_step_wave", "train_step_compact",
            "serving_graphs")
    check(all(armed.get(k, 0) > 0 for k in need),
          f"counters {need} registered and captured during warm-up: "
          f"{armed}")
    check(armed["serving_graphs"] == 2, f"two bucket graphs: {armed}")
    check(not findings, "captures after arm(): "
          + "; ".join(str(f) for f in findings))
    check(all(v["before"] == v["after"] for k, v in detail.items()
              if k != "armed"), f"counters moved: {detail}")


def phase_timing(ctx) -> None:
    from lightgbm_tpu_torch.ops.fused_scan import fused_child_scans
    from lightgbm_tpu_torch.ops.hist_full import build_histogram_full
    from lightgbm_tpu_torch.ops.hist_multislot import \
        build_histogram_multislot
    from lightgbm_tpu_torch.ops.hist_packed import build_histogram_packed
    from lightgbm_tpu_torch.ops.hist_segments import build_histogram_segments
    from lightgbm_tpu_torch.ops.partition import (apply_partition,
                                                  partition_window)
    from lightgbm_tpu_torch.ops.scan import find_best_splits_batched
    from lightgbm_tpu_torch.ops.split_cat import categorical_candidates

    dev = torch.device("cuda", 0)
    flush = torch.zeros(16 * 1024 * 1024, dtype=torch.float32, device=dev)
    wrappers = (build_histogram_packed, build_histogram_segments,
                apply_partition, partition_window, find_best_splits_batched,
                build_histogram_multislot, fused_child_scans,
                build_histogram_full, categorical_candidates)
    launches_before = [fn.launches for fn in wrappers]
    rows = _time_packed(flush)
    shapes = ctx.get("shapes_wave", {})
    quant = ctx.get("shapes_quant", {})
    compact = ctx.get("shapes_train", {})
    others = {"hist_segments": _time_segments(
                  flush, shapes.get("hist_segments"),
                  compact.get("hist_segments")),
              "partition": _time_partition(flush),
              "partition_window": _time_partition_window(
                  flush, compact.get("partition_window")),
              "split_scan": _time_scan(flush, shapes.get("split_scan")),
              "hist_multislot": _time_multislot(
                  flush, quant.get("hist_multislot")),
              "fused_scan": _time_fused(flush, quant.get("fused_scan")),
              "hist_full": _time_hist_full(flush,
                                           ctx.get("shapes_masked_train")),
              "replay": _time_replay(shapes.get("replay")),
              "split_cat": _time_split_cat(flush, ctx.get("shapes_cat"))}
    for fn, n in zip(wrappers, launches_before):
        fn.launches = n
    ctx["timing"] = rows
    ctx["timing_others"] = others
    emit({"phase": "timing", "kernel": "hist_packed", "Fw": FW,
          "num_bins": NUM_BINS, "windows": rows,
          "nvidia_smi": ctx.get("smi")})
    emit({"phase": "timing", "kernels": others, "nvidia_smi": ctx.get("smi")})


def kernels_line(ctx) -> dict:
    """The per-kernel summary: launches from the run of the path that
    launches each kernel (wave_train, quant_train, masked_train), times and
    bounds from the timing phase."""
    t = dict(ctx["timing_others"])
    t["hist_packed"] = ctx["timing"]["full"]
    t["bin_predict"] = ctx["timing_bin_predict"]
    compare = {
        "hist_packed": "dyadic inputs bitwise; two launches bitwise; random "
                       "float32 within rtol=1e-5, atol=1e-5*sum|w|",
        "hist_segments": "dyadic inputs bitwise; two launches bitwise; "
                         "random float32 within rtol=1e-5, atol=1e-5 "
                         "times each bin's sum of |w|",
        "partition": "every lane bitwise (NaN, -0.0 weight bits included)",
        "partition_window": "every lane and the result bitwise equal to "
                            "the plain version on the card at windows of "
                            "1,024 and 2,048 rows, all 1,000,000 rows and "
                            "a non-zero start; sort and mask mode; a NaN "
                            "numerical, a bundled and a categorical "
                            "feature; a do = 0 split a no-op",
        "split_scan": "dyadic: every field exact; random float32: bitwise "
                      "equal to the CPU plain version; vs the card plain "
                      "version gain within 1e-3 of the pre-shift gain, "
                      "choice equal at clear candidates; constrained "
                      "(bounds, signs, penalty): bitwise equal to the CPU "
                      "plain version",
        "hist_multislot": "dyadic inputs bitwise at K=1, 3, 16, 64; two "
                          "launches bitwise; quant mode bitwise; random "
                          "float32 within rtol=1e-5, atol=1e-5 times each "
                          "bin's sum of |w|",
        "fused_scan": "quant-grid and random float32 inputs: every field "
                      "and both pool rows bitwise equal to the plain "
                      "version on the CPU; quant-grid: bitwise equal to "
                      "the plain version on the card; random float32: "
                      "bitwise equal to the unfused step on the card",
        "hist_full": "uint16 codes at 1,023 bins and uint8 at 255: dyadic "
                     "inputs bitwise; two launches bitwise; random float32 "
                     "within rtol=1e-5, atol=1e-5 times each bin's sum of "
                     "|w|; dropped codes, 2,047 and 65,536 bins bitwise",
        "replay": "every pass's carried state, members and counters "
                  "bitwise equal to the plain version on the CPU over "
                  "random forests with exact gain ties (M = 1,145 and "
                  "16,505)",
        "split_cat": "every field and bitset bitwise equal to the plain "
                     "version on the CPU (random float32 and dyadic, B = "
                     "256, 1,023 and 2,047, seven regimes), to the plain "
                     "version on the card on dyadic inputs; two launches "
                     "bitwise; with bounds and penalty at B = 256 bitwise "
                     "to the CPU plain version",
        "bin_predict": "codes bitwise equal to the plain version on the "
                       "card and to bin_host at 100,000 rows: 28 features "
                       "at 255 and 1,023 bins, the Expo-shaped categorical "
                       "rows, a 9,999-bound row searched in global memory, "
                       "137 features in two groups; and at 11,000,000 "
                       "rows x 28 features "
                       "(NaN, +-inf, -0.0, every bound and its ulp "
                       "neighbours, unseen, negative and fractional "
                       "categories); two launches bitwise"}
    err = {"hist_packed": ctx.get("max_abs_err"),
           "hist_segments": ctx.get("err_segments"),
           "partition": ctx.get("err_partition"),
           "partition_window": ctx.get("err_partition_window"),
           "split_scan": ctx.get("err_scan"),
           "hist_multislot": ctx.get("err_multislot"),
           "fused_scan": ctx.get("err_fused"),
           "hist_full": ctx.get("err_hist_full"),
           "replay": ctx.get("err_replay"),
           "split_cat": ctx.get("err_split_cat"),
           "bin_predict": ctx.get("err_bin_predict")}
    quant = ctx.get("launches_quant", {})
    out = []
    for name in KERNEL_SOURCES:
        src, replaces = KERNEL_SOURCES[name]
        row = t[name]
        # each kernel's launches on the path that runs it: the default
        # (float32) wave learner for the first four, the quantized wave
        # learner with the opening for the next two, the masked learner
        # (max_bin=1023) for hist_full, the categorical cell for split_cat,
        # Booster.predict's device path for bin_predict
        path, launches = next(
            (p, c[name]) for p, c in (("wave_train", ctx["launches_wave"]),
                                      ("masked_train",
                                       ctx["launches_masked"]),
                                      ("quant_train", quant),
                                      ("categorical_train",
                                       ctx["launches_cat"]),
                                      ("predict", ctx["launches_predict"]),
                                      ("train", ctx["launches_train"]))
            if name in c)
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches,
                    "launches_path": path,
                    "launches_quant_train": quant.get(name),
                    "launches_multiclass_train": ctx.get(
                        "launches_multiclass", {}).get(name),
                    "launches_rank_train": ctx.get(
                        "launches_rank", {}).get(name),
                    "launches_categorical_train": ctx.get(
                        "launches_cat", {}).get(name),
                    "launches_serve": ctx.get("launches_serve",
                                              {}).get(name),
                    "launches_fleet": ctx.get("launches_fleet",
                                              {}).get(name),
                    "launches_constrained_train": {
                        run: c.get(name) for run, c in
                        ctx.get("launches_con", {}).items()},
                    "quant_mode_launches_quant_train":
                        quant.get(name + "_quant"),
                    "max_abs_err": err[name], "ms": row["ms"],
                    "kernel_ms": row["kernel_ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"],
                    "compare": compare[name]})
        if name == "replay":
            out[-1]["noop_kernel_ms"] = row["noop_kernel_ms"]
            out[-1]["fixed_kernel_ms"] = row["fixed_kernel_ms"]
            out[-1]["num_leaves_4095"] = row["num_leaves_4095"]
            out[-1]["ported_from"] = "an XLA while_loop, not a pallas_call"
        if name == "split_cat":
            out[-1]["B2047"] = row["B2047"]
            out[-1]["ported_from"] = "an XLA lax.scan, not a pallas_call"
        if name == "bin_predict":
            out[-1]["shapes_serve"] = ctx.get("timing_serve_bin")
            out[-1]["device_ms"] = row["device_ms"]
            out[-1]["upload_ms"] = row["upload_ms"]
            out[-1]["ported_from"] = "a jitted XLA function, not a " \
                "pallas_call"
        if name in ("split_scan", "split_cat"):
            # the constrained launch (bounds, signs, penalty) at K = 128
            out[-1]["constrained"] = row["constrained"]
        if name == "partition_window":
            out[-1]["ported_from"] = "an XLA lax.sort of the compact " \
                "learner's window, not a pallas_call"
            out[-1]["launches_forced_train"] = ctx.get(
                "launches_forced_compact", {}).get(name)
        for key in ("shapes_wave_train", "shapes_masked_train",
                    "shapes_train", "shapes_quant_train",
                    "shapes_categorical_train"):
            if key in row:
                out[-1][key] = row[key]
    out[0]["launches_compact_train"] = ctx.get("launches_compact")
    out[1]["launches_compact_train"] = ctx["launches_train"].get(
        "hist_segments")
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--rank-job", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch  # noqa: F401  (fails outside a checkout)

    if args.rank_job:
        # one process of the multihost_train phase: its result to a file,
        # then out without a teardown that waits on a peer
        spec = json.loads(args.rank_job)
        torch.set_num_threads(1)
        res = _rank_job(spec)
        with open(spec["out"], "w") as fh:
            json.dump(res, fh)
        import os
        # the store lives in this process on rank 0: it leaves last, once
        # the other survivors' results are on disk (bounded)
        waits = [p for i, p in enumerate(spec.get("peer_outs", ()))
                 if i not in (res.get("dead_ranks") or ())]
        t0 = time.monotonic()
        while time.monotonic() - t0 < 15 and not all(
                os.path.exists(p) for p in waits):
            time.sleep(0.05)
        sys.stdout.flush()
        os._exit(0)

    phases = [p for p in args.phases.split(",") if p]
    bad = [p for p in phases if p not in PHASES]
    if bad:
        raise SystemExit(f"unknown phases {bad}; known: {PHASES}")
    ctx = {}
    if "device" not in phases:
        phases.insert(0, "device")
    seconds = {}
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            globals()[f"phase_{name}"](ctx)
            seconds[name] = time.perf_counter() - t0
    emit({"phase_seconds": seconds})
    if all(p in phases for p in ("train", "wave_train", "quant_train",
                                 "masked_train", "categorical_train",
                                 "bin_predict", "predict", "serve",
                                 "fleet", "timing")):
        emit(kernels_line(ctx))
    print(ctx["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
