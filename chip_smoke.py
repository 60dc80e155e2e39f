#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA card (sm_90a, an H100).

    python3 chip_smoke.py

Builds the CUDA kernels from ``lightgbm_tpu_torch/ops/csrc`` with
``nvcc`` (one process per source, all at once), then:

- ``kernel``/``serve``: holds the traversal kernel (B1) against its plain
  PyTorch version in both modes with the node records staged in shared
  memory and read from global memory (the planner's pick and the other)
  and times both modes, then serves a HIGGS-width model (28 features,
  500 trees, 255 leaves, binary; random trees from a seed) through
  ``Booster.serve()`` and ``Booster.predict()`` on the card;
- ``swap_serve``: at the same width, ``swap_model`` to a second forest
  while ``serving.loadgen`` fires the serve phase's 320 requests from 8
  threads (every answer bit-equal to the host float64 path of the model
  its request was admitted against), a NaN-leaf swap quarantined, a swap
  to a 5-class forest (100 iterations x 5 trees), ``apredict``, bf16 and
  int8 servers (answers equal to the quantised forest's host path, B1's
  leaves mode on their planes against its plain version at every bucket
  shape, a budget under the measured delta quarantined), and the native
  host library (``backend="host"`` serving, 100,000 rows of
  ``StackedForest.predict_raw`` against the NumPy route's bits);
- ``fleet_serve`` (queue A6): a ``Fleet`` of the serve model,
  swap_serve's second forest and its 5-class forest (weights 3/1/1,
  classes interactive/standard/batch) under 240 requests of 1-512 rows
  from 8 threads, every answer bit-equal to its model's host float64
  path; a replan under a budget that fits only the hot model, the card's
  allocated memory falling by at least 0.9x the evicted forests' bytes
  and coming back on restore, the evicted models answering on the host
  with no B1 launch; each precision's ``DeviceForest`` against the byte
  model (``predict_forest_bytes``: the bytes its tensors requested of
  the allocator equal it, and ``memory_allocated`` is no less); the AOT
  store exported and restored by a fresh fleet (no program built, one
  forest a model built from the stored records, the bytes the fleet
  requested equal to the byte model's three forests, first requests
  timed cold and restored), a
  corrupt blob and a foreign torch version each a miss; two
  ``PodFleet(devices=2)`` drills on the one card (``kill_device``, then
  a chaos vanish) under load with availability 1.0 and no request
  answered on the host, a redispatch, a replan and a flight bundle
  each; chunks binned by B3 over two logical devices and
  ``BulkScorer(devices=plan_devices(2), aot_store=)`` twice, the first
  participant storing the program and every later one restoring it,
  scores bit-equal to ``Booster.predict``;
- ``train``: trains a HIGGS-width binary model (1,000,000 x 28 f32 rows
  from a seed, 255 leaves, 255 bins, 10 rounds, a 100,000-row valid set)
  through ``Dataset`` and ``train`` on the card — binning (B3), root and
  frontier histograms (B4), the frontier histogram -> split pair (B2)
  and the scans (B5) — and checks that the model text is byte-identical
  to a second run with every kernel replaced by its plain version, that
  the valid logloss falls every round and that the card's predictions
  match the host's;
- ``ingest``/``hist``: holds B3, B4, B2 and B5 against their plain
  versions at the training run's shapes, bit for bit, and times them;
  B5 also in its monotone + bounds mode (parent mode) and its
  random-threshold mode (leaf mode), and, in ``quant_hist``, its int8
  monotone + bounds mode;
- ``wide_bins``: a short run at ``max_bin=1023`` (int32 binned matrix,
  1023-bin scans) against its plain-version twin;
- ``efb_train``: the airline table one-hot encoded (1,000,000 x 674 f32,
  EFB bundles; ``testing.airline_like``) trained on the staged arm: B3's
  EFB fold, the whole-dataset histogram (B6) for each root, B4 segment
  histograms and B5 in leaf mode on the group histograms (nothing
  expanded), its first 2 trees against the plain-version run's (as
  ``rand_train``'s, ``rank_train``'s and ``multiclass_train``'s:
  ``PLAIN_SHORT_ROUNDS``); then ``Booster.predict`` through B1 against
  B1's plain version;
- ``hist6``: B6 against its plain version on that group matrix and on
  the ``train`` run's 28 uint8 features (``rand_train``'s root shape),
  timed; the build line shows that its shared atomics are native 32-bit
  adds;
- ``onehot_scan``: B5 in leaf mode at that table's widest shape (256
  children's [3, G, Bg] group histograms), against its plain version
  (the int64 expansion to [3, F, 255], then the scan), timed, and the
  old path's expansion timed;
- ``cat_train``: the same table with six native categorical features on
  the fused arm with the categorical merge, and B3's categorical branch;
  then B5 at that run's shape (its median round's candidates, 8
  features of their own bin counts) against its plain version, timed;
- ``quant_hist``: B4, B5 and B2 in their int8/int32 mode (quantized
  gradients) against their plain versions at the training run's shapes,
  exact, and timed, with ``quantize_gradients`` (threefry included);
- ``quant_train``: ``higgs_quant_1m``, the training run's dataset again
  with ``use_quantized_grad`` (LightGBM's defaults: 4 bins, stochastic
  rounding, no leaf renewal): the card's quantized gradients of the
  first tree and of the scores after the last bit-equal to the CPU
  port's, the first 2 trees byte-identical to the
  plain-version run's, only the int8 kernels launched; then 3 rounds at
  16 bins without stochastic rounding and with leaf renewal, and 3
  rounds of the one-hot table on the staged arm, each against its
  plain-version run's first 2 rounds (``SHORT_PLAIN_ROUNDS``, as every
  3-round run below but GOSS's);
- ``rand_train``: ``higgs_rand_1m``, the training run's datasets with
  ``extra_trees`` and ``feature_fraction_bynode=0.5`` (the staged arm:
  B6 roots, B4 segments, B5 with random thresholds in leaf mode), the
  first 2 trees byte-identical to the plain-version run's, valid AUC
  rising; then
  3 quantized rounds with bynode only (B4 and B5 int8 in leaf mode);
- ``mono_train``: ``mono_train_1m``, upstream LightGBM's monotone data
  at HIGGS width (1,000,000 x 28, constraints +1, -1, 0), regression,
  255 leaves, 10 rounds, on the fused arm (B2 with B5 in the monotone +
  bounds mode), the first 2 trees byte-identical to the plain-version
  run's, valid l2 falling, and predictions through B1 monotone on a sweep of
  x0 and x1; then 3 constrained rounds of the one-hot table (the staged
  arm, B5 in leaf mode with bounds);
- ``goss_train``: ``higgs_goss_1m``, the training run's datasets with
  ``boosting=goss`` for 15 rounds (11-15 sample): the first 11 trees
  byte-identical to the plain-version run's, sampled rounds counted and
  the kept rows' share printed; then 3 GOSS rounds of the one-hot table
  at lr 0.5 (staged arm, B6 roots, sampling from round 3);
- ``serial_train`` (queue A4): the serial grower, one best-first split
  at a time, on the training run's datasets: ``higgs_cegb_1m`` (10
  rounds of CEGB: the split, coupled and lazy penalties; ``auto``
  growth grows serially, every iteration splits, the valid logloss
  falls, fewer distinct features and no more leaves than ``train``'s
  model), ``higgs_forced_1m`` (10 rounds on a Dataset built with forced
  bin bounds, a 7-split forced plan heading every tree; then 3 rounds
  with ``tpu_forced_split_parity`` and 3 with a plan abandoned at its
  second split), ``higgs_serial_1m`` (3 rounds each of the staged f32
  arm, the quantized one and the fused one, each equal to the rounds
  grower's trees; the staged arm's tree profiled, timed by section and
  its synchronising calls counted) and 3 rounds of coupled CEGB on the
  one-hot table (EFB, the staged arm on group histograms); each against
  its plain-version run's first tree, the launches exact (B6 or B4 and B5
  once a tree and once a split step) and the host reads a tree counted;
- ``sharded_train`` (queue A9): two ranks as two spawned processes on
  the one card, in an explicit gloo group over a FileStore (NCCL refuses
  two ranks on one GPU): each bins its half of the training run's rows
  through B3 with bin mappers both agree on, then trains the 1,000,000
  x 28 data for 3 rounds data-parallel (the serial text, byte for
  byte), quantized data-parallel (its plain-version run's first 2
  trees),
  feature-parallel and voting at full top-k (the serial grower's text),
  and voting at top_k 4 (its plain-version run's first 2 trees; whether
  the vote
  left the serial tree is printed as ``equals_serial``), each rank's
  launches and collectives held to ``shard_expected``; a
  rank that fails fails the script;
- ``hybrid_train`` (queue A9, rest): four ranks as four spawned
  processes on the one card, gloo over a FileStore, on a 2 x 2 two-tier
  mesh (``LGBM_TPU_NUM_SLICES=2``): 400,000 x 28, 255 leaves, f32 and
  quantized data-parallel with hierarchical and with flat sums (the
  serial rounds twin's text; one quantized text), voting at top_k 4
  per slice (its plain-version run's first tree; whether its first tree
  is
  flat voting's is printed), one 2-D tree on a (data, feature) mesh (the
  serial grower's tree) and the elastic shrink (a bundle every 2 of 4
  rounds, a membership probe with slice 1 stalled that fails on every
  rank, the survivors' 2-rank group resuming to 6 rounds, equal to 2
  ranks from scratch, its ``predict`` through B1 equal to the plain
  version); each rank's launches and per-tier collectives exact in
  every run, the elastic first, resumed and from-scratch runs included
  (``hybrid_expected``, ``twod_expected``);
- ``stream_train`` (queue A10): the training run's 1,000,000 x 28 f32
  rows through ``Dataset.from_sample`` (bins from 200,000 rows) and
  ``push_rows`` in 100,000-row chunks (B3 once a chunk), spilled to a
  store of eight 131,072-row blocks whose bytes equal the resident
  twin's matrix; 10 rounds streamed (the root B6 a block, each round B4
  a block and one B5) and resident, f32 and quantized, model texts
  byte-identical; 1 round with the plain versions and 3 at 250,000-row
  blocks equal to the first trees; launches exact; the
  card's peaks held to 0.75-1.05 x the planner's predictions, the
  host's (VmRSS sampled over a spilled construct and 3 streamed trees
  in a fresh process) beside its prediction, and the planner's
  verdict at half the resident peak; then ``BulkScorer`` over the rows
  in 65,536-row blocks (B1 once a block), every banked block bit-equal
  to ``Booster.predict(raw_score=True)`` on the serving epilogue's path,
  and a run stopped after 3 blocks and resumed byte-identical to an
  uninterrupted one;
- ``obs_trace`` (queue A11, first part; after ``stream_train``, on
  ``train``'s constructed datasets): 5 rounds with tracing, the flight
  recorder and the watchdog's sentry on, through the round graph: the
  model text equal to ``train``'s first five trees, the host syncs and
  stop-flag waits of tree 12 and B2's launches equal to those of twins
  trained untraced and with the recorder off, one
  ``trace.grow_tree_rounds`` span a tree, ``engine.train`` covered above
  0.9, the dumped trace a Chrome trace; seconds a tree traced, untraced
  and with the recorder off (A B C C B A); 200 requests through ``serve`` (B1, every answer bit-equal to
  the host path) with the batcher's heartbeat under 1 s old and the
  server's series in the process registry; a NaN forest's swap
  quarantined into a temporary flight directory, the bundle's
  fingerprint naming the card; at most 60 s;
- ``boost_variants``: ``dart`` (a tree must be dropped), ``rf``
  (averaged output), ``regression_l1`` and ``quantile`` (the percentile
  renewal on the card), 5 rounds each on ``mono_train``'s dataset, each
  against its plain-version run;
- ``multiclass_train``: ``airline_multiclass_1m``, the airline table
  with its six categorical columns native and a 5-class delay band,
  ``multiclass`` (the default ``max_cat_threshold``), 10 rounds of 5
  trees: the first 2 iterations' trees byte-identical to the
  plain-version run's, valid
  multi_logloss falling every round, B1's scores mode at K = 5 equal to
  the host's and to its plain version; then 3 rounds of
  ``multiclassova`` and 3 of quantized multiclass (per-class scales,
  int8 kernels only), each against its plain-version run;
- ``rank_train``: ``mslr_lambdarank_1m``, lambdarank at MSLR-WEB30K
  width (1,000,000 x 136 f32, ~8,100 queries of 1 to 1,250 documents,
  grades 0-4; ``testing.mslr_like``), 255 leaves, ``eval_at`` 1, 3, 5,
  10, 10 rounds with a 100,000-row valid set: the first 2 trees
  byte-identical to the plain-version run's, valid NDCG@10 rising,
  predictions through B1
  equal to the host's; each tree's time by section (``objective`` is the
  lambdarank gradients, also timed alone); then B5 at the run's shape
  (row ``fused_sibling_scan[rank shape]``) and 3 rounds of
  ``rank_xendcg`` against their plain-version run;
- ``sparse_cv`` (after ``efb_train``): the same one-hot table given to
  ``Dataset`` as a scipy CSR matrix (f32, 8 stored entries a row): its
  bin mappers, EFB groups and [G, n] bytes equal to the dense table's
  (the CSR rows binned in densified chunks through B3); a binary cache
  reloads the same bytes and trains the same 3-round model; ``cv`` (5
  folds, 10 rounds, ``Dataset.subset``) raises every fold's valid AUC,
  its fold 0 equals a ``train`` on that subset and its first 3 rounds
  the plain-version run's; continued training from a 5-round model (5
  more rounds, a 100,000-row valid set; init scores from B1's scores
  mode on CSR chunks, equal to the host's) and ``refit`` on 200,000
  fresh rows (B1's leaves mode) equal their plain-version runs;
  ``pred_contrib`` on 10,000 CSR rows sums to the raw scores (host
  f64); the phase's launches of B1, B3, B4, B5 and B6 are counted from
  0 and must each be above 0;
- ``wide_ingest``: B3 at 200,000 x 2,000 f32 features (chunks that
  stage their own columns) and on one EFB group whose tables exceed 96
  KiB (member parts over successive launches), each byte-identical to
  ``Dataset._bin_block`` and equal to its plain version;
- ``devprof`` (queue A11, rest; after ``quant_hist``): ``obs.devprof``'s
  histogram table at ``higgs_train_1m``'s 1 M x 28 x 255, K = 128 (B6,
  B2 and B4 then B5, f32 and quantized), its predict table on
  ``higgs_500x255`` at 65,536 rows (B1 both modes) and its ingest table
  binning the 1 M x 28 rows (B3 and the host): each row's bytes and
  operations equal to the kernel table's at that shape, utilizations at
  most 1.05, launches counted, then ``obs.diagnose.run_doctor``;
- ``coresident`` (``coresident/``): a ``Fleet`` serves
  ``higgs_500x255`` to 8 client threads under a ``ResidencyLedger`` of
  the card's memory while ``Scheduler.refresh`` trains 200,000 rows of
  the training data for 5 rounds beside it; an injected
  ``serving.delay`` throttles and then pauses the refresh, which
  resumes to a text byte-identical to a solo ``train``; every answer
  bit-equal to its model's host path (after the swap, the refreshed
  model's), none failed; the contention verdict; the refresh's peak
  allocation against its lease and the bytes a pause frees;
- ``multi_train`` (queue A12, ``multi/``): 8 lane configs (their own
  learning rate, bagging seed and feature fraction) over 200,000 rows of
  the training data at its full width (28 features, 255 bins, 255
  leaves) for 10 rounds, each alone on the card, then all as one
  ``train_many`` group: every lane's text equal to its solo text, each
  all-lane round one replay of the group's graph, every training
  kernel's launches equal to the solo runs' sum; ``cv(fused=True)`` of 5
  stacked folds for 5 rounds equal to serial ``cv``; two lanes under
  learning-rate schedules over 3 chunks equal to solo, their group graph
  captured once; seconds a lane tree both ways and the predicted peak of
  the plan ``train_many`` elected beside the allocator's;
- ``lifecycle`` (queue A12, ``lifecycle/``): ``higgs_500x255`` behind a
  ``Fleet``; a refresh of 5 warm-started trees over 100,000 fresh rows
  promoted through the probe, the shadow mirror, a two-step canary ramp
  and the cutover under threaded traffic, then served bit-identically; a
  second refresh under an impossible drift budget rolled back,
  byte-identical, with a flight bundle naming ``drift``; a NaN
  candidate stopped at the probe and never registered; no device-wide
  synchronize while the traffic threads ran; ``refresh_many`` of 2
  segments equal to the serial candidates.

Every training phase also profiles one more tree (``tree_kernel_ms``):
the device time summed per kernel (B4 with its sort, B5 by mode, B2, B6,
B3) from ``torch.profiler``, or from CUDA events around the wrappers
where the profiler records no device time.

Each phase prints one JSON line.  Any failed check raises, and the
script exits non-zero; it exits non-zero without a result where CUDA is
absent or the package is missing (the work counts of every bound are
``lightgbm_tpu_torch.obs.devprof``'s, imported at start).  The last lines are the kernel table,
the card's name and power limit as ``nvidia-smi`` reports them, and
``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# the work counts and the card's peaks behind every bound below (the
# larger of bytes over 3.35 TB/s and f32 operations over 67 TFLOP/s, the
# H100 SXM's published rates; the card's power limit is printed beside
# them): lightgbm_tpu_torch/obs/devprof.py, from this checkout
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from lightgbm_tpu_torch.obs.devprof import (  # noqa: E402
    grouped_scan_cells, ingest_steps_per_row, kernel_cost, roofline,
    traverse_cost)

KERNEL = "fused_traverse"
# rows checked against the plain version (ragged tiles included) and the
# timed shapes: the serving buckets, the monotone sweep's batch (101) and
# one predict chunk
CHECK_ROWS = (8, 64, 1000, 1024, 65536 + 37)
TIMED_ROWS = (8, 64, 101, 1024, 65536)
SERVE_REQUESTS, SERVE_THREADS, MAX_REQUEST_ROWS = 320, 8, 1500
PREDICT_ROWS = 100_000
# swap_serve: the 5-class forest it swaps to (100 iterations of 5 trees),
# the requests of each of its later steps, and the rows the NumPy host
# route is timed on (the native route takes all PREDICT_ROWS)
SWAP_MULTI_ITERS, SWAP_CLASSES = 100, 5
SWAP_K_REQUESTS, LOWPREC_REQUESTS, HOST_REQUESTS = 32, 64, 32
APREDICT_REQUESTS, NUMPY_ROWS = 16, 5_000
# the training run (BASELINE's HIGGS width) and the histogram check's
# frontier width: one level of KCAP = 128 candidates
TRAIN_ROWS, VALID_ROWS, TRAIN_ROUNDS = 1_000_000, 100_000, 10
TRAIN_PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
                "learning_rate": 0.1, "metric": ["auc", "binary_logloss"],
                "verbose": -1}
HIST_SLOTS = 128
# devprof: timed calls a table row (after a warm one)
DEVPROF_REPS = 5
# coresident: the refresh's rows of higgs_train_1m's data and rounds; the
# serving load (client threads, rows a request from a pool of HIGGS-width
# rows); the guard's p99 ceiling and the injected serving delays
CORES_ROWS, CORES_ROUNDS = 200_000, 5
CORES_THREADS, CORES_MAX_ROWS, CORES_POOL_ROWS = 8, 64, 20_000
CORES_CEILING_MS, CORES_DELAYS, CORES_DELAY_S = 100.0, 40, 0.3
# multi_train (the model axis): MANY_LANES configs over the first
# MANY_ROWS rows of higgs_train_1m's data at its full width (28
# features, 255 bins, 255 leaves) for MANY_ROUNDS rounds, shared mode;
# then MANY_CV_FOLDS stacked folds of the same rows, MANY_CV_ROUNDS
# rounds, cv(fused=True) against serial cv
MANY_ROWS, MANY_ROUNDS, MANY_LANES = 200_000, 10, 8
MANY_CV_FOLDS, MANY_CV_ROUNDS = 5, 5
# two of those lanes under learning-rate schedules, as one group over
# chunks of 4, 2 and 1 rounds
MANY_LR_ROUNDS = 7
# lifecycle: higgs_500x255 behind a Fleet; a refresh of LC_TREES
# warm-started trees over LC_ROWS fresh rows (the deployed grid: the
# first LC_ROWS rows of the training data); the promotion's threaded
# traffic (LC_THREADS threads, LC_REQUESTS a phase window, at most
# LC_MAX_ROWS rows a request); refresh_many of 2 segments of
# LC_SEGMENT_ROWS rows
LC_ROWS, LC_TREES, LC_SEGMENT_ROWS = 100_000, 5, 50_000
LC_THREADS, LC_REQUESTS, LC_MAX_ROWS = 4, 64, 256
# update_chunk's chunk against as many update() calls (train phase)
CHUNK = 8
# the categorical phases: the airline table at a tenth of the Flight Delay
# set's rows, the training run's parameters; B3 is checked against the
# host oracle on the first EFB_ORACLE_ROWS rows of the one-hot matrix
EFB_ROWS, EFB_VALID_ROWS, EFB_ORACLE_ROWS = 1_000_000, 100_000, 250_000
# a short run with groups of more than 256 bins: the int32 binned layout
# and a 1024-thread scan
WIDE_ROWS, WIDE_ROUNDS = 200_000, 3
WIDE_PARAMS = {"objective": "binary", "num_leaves": 63, "max_bin": 1023,
               "verbose": -1}
# quantized training (higgs_quant_1m): the training run's data and
# parameters with LightGBM's quantized-training defaults; the two short
# runs take the other rounding/renewal branches and the staged arm
QUANT_PARAMS = dict(TRAIN_PARAMS, use_quantized_grad=True)
QUANT_BRANCH_PARAMS = dict(QUANT_PARAMS, num_grad_quant_bins=16,
                           stochastic_rounding=False,
                           quant_train_renew_leaf=True)
QUANT_SHORT_ROUNDS = 3
# the short runs' plain-version twins train this many of those rounds
# (their trees held byte for byte to the short run's first ones)
SHORT_PLAIN_ROUNDS = 2
# monotone constraints (mono_train): upstream LightGBM's monotone data at
# HIGGS width, regression, the training run's size and tree parameters;
# then the one-hot airline table with DepTime (column 50) increasing
MONO_PARAMS = {"objective": "regression", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "metric": ["l2"], "verbose": -1}
ONEHOT_DEPTIME = 50
SWEEP_POINTS, SWEEP_ROWS = 101, 10
# per-node randomness (rand_train): the training run with extra trees and
# half the features a node; then quantized rounds with bynode only
RAND_PARAMS = dict(TRAIN_PARAMS, extra_trees=True,
                   feature_fraction_bynode=0.5)
RAND_QUANT_PARAMS = dict(TRAIN_PARAMS, feature_fraction_bynode=0.5,
                         use_quantized_grad=True)
# the slice of multiclass, ranking and the boosting variants.
# rank_train (mslr_lambdarank_1m): MSLR-WEB30K width (136 features,
# grades 0-4; testing.mslr_like), a million of its 2,270,296 training rows
# with the parameters of LightGBM's docs/Experiments.rst; then
# rank_xendcg.  multiclass_train (airline_multiclass_1m): the airline table
# with a 5-class delay band; then multiclassova and quantized multiclass.
# goss_train (higgs_goss_1m): the training run's data under GOSS past its
# 1 / lr warm-up; then the one-hot table at lr 0.5.  boost_variants: dart,
# rf, regression_l1 and quantile on the monotone data.
RANK_ROWS, RANK_VALID_ROWS, RANK_ROUNDS = 1_000_000, 100_000, 10
RANK_ORACLE_ROWS = 100_000
RANK_PARAMS = {"objective": "lambdarank", "num_leaves": 255, "max_bin": 255,
               "learning_rate": 0.1, "metric": ["ndcg"],
               "eval_at": [1, 3, 5, 10], "verbose": -1}
XENDCG_PARAMS = dict(RANK_PARAMS, objective="rank_xendcg")
MULTI_ROWS, MULTI_VALID_ROWS, MULTI_ROUNDS, MULTI_CLASSES = (
    1_000_000, 100_000, 10, 5)
MULTI_PARAMS = {"objective": "multiclass", "num_class": MULTI_CLASSES,
                "num_leaves": 255, "max_bin": 255, "learning_rate": 0.1,
                "metric": ["multi_logloss", "multi_error"], "verbose": -1}
OVA_PARAMS = dict(MULTI_PARAMS, objective="multiclassova")
MULTI_QUANT_PARAMS = dict(MULTI_PARAMS, use_quantized_grad=True)
GOSS_ROUNDS = 15
# the GOSS plain twin: the 10 warm-up rounds (1 / lr) and the first
# sampled one
GOSS_PLAIN_ROUNDS = 11
GOSS_PARAMS = dict(TRAIN_PARAMS, boosting="goss")
GOSS_ONEHOT_PARAMS = dict(TRAIN_PARAMS, boosting="goss", learning_rate=0.5)
# serial_train (queue A4): the serial grower on the training run's data.
# higgs_cegb_1m takes LightGBM's cegb_* parameters (docs/Parameters.rst;
# Peter et al., "Cost Efficient Gradient Boosting", NIPS 2017): a penalty
# a row of each split, a coupled one a feature (paid once for the model)
# and a lazy one a feature and row (paid once a row).  The train run's
# model splits on the 8 features that carry signal and no other, so a
# coupled penalty must price some of those out: the odd features cost
# 1e5 (a weak feature's root gain at 1 M rows is a few thousand), the
# even ones 1e2.  higgs_forced_1m a
# 3-level forced plan (the features below, at training-sample medians)
# and forced bin bounds (quartiles) on two of its features; each config
# against its plain-version twin over SERIAL_PLAIN_ROUNDS; the forced
# plan's variants, the arms and the EFB run train SERIAL_SHORT_ROUNDS
# (1: a plain-version serial tree takes 4-7 s on the card's host, and
# the script has a time limit; the CEGB state across trees is held by
# the main runs' launches, features and paid rows)
SERIAL_ROUNDS, SERIAL_SHORT_ROUNDS, SERIAL_PLAIN_ROUNDS = 10, 3, 1
# the plain-version twins of efb_train, rand_train, rank_train,
# multiclass_train, quant_train, mono_train and cat_train train this
# many rounds (their first trees held byte for byte to the main run's),
# to keep the script inside its time limit
PLAIN_SHORT_ROUNDS = 2
CEGB_PARAMS = dict(
    TRAIN_PARAMS, cegb_tradeoff=1.0, cegb_penalty_split=1e-4,
    cegb_penalty_feature_coupled=[1e5 if f % 2 else 1e2
                                  for f in range(28)],
    cegb_penalty_feature_lazy=[1e-3] * 28)
FORCED_FEATURES = (0, 4, 5, 1, 2, 6, 7)        # the plan's BFS order
FORCED_BIN_FEATURES = (0, 4)
SERIAL_PARAMS = dict(TRAIN_PARAMS, tpu_tree_growth="serial")
VARIANT_ROUNDS = 5
VARIANT_PARAMS = {
    "dart": dict(MONO_PARAMS, boosting="dart", drop_rate=0.5,
                 skip_drop=0.0),
    "rf": dict(MONO_PARAMS, boosting="rf", bagging_freq=1,
               bagging_fraction=0.632),
    "regression_l1": dict(MONO_PARAMS, objective="regression_l1",
                          metric=["l1"]),
    "quantile": dict(MONO_PARAMS, objective="quantile", alpha=0.9,
                     metric=["quantile"]),
}
# sparse_cv (queue A7): the airline_onehot_1m table as a scipy CSR matrix
# (f32, 8 stored entries a row): CSR binning against the dense table's
# Dataset, a binary cache, 5-fold cv for 10 rounds, continued training
# (5 + 5 rounds, a 100,000-row valid set), refit on 200,000 fresh rows
# and pred_contrib on 10,000 rows; only 3-round runs against plain
# versions
SPARSE_CV_ROUNDS, SPARSE_CV_FOLDS, SPARSE_BASE_ROUNDS = 10, 5, 5
SPARSE_PLAIN_ROUNDS = 3
SPARSE_REFIT_ROWS, SPARSE_SHAP_ROWS = 200_000, 10_000
SPARSE_HOST_ROWS = 100_000
# C-1: B3 at 2,000 features (200,000 rows, a tenth NaN); mappers from a
# 10,000-row sample; _bin_block checks the first WIDE_ORACLE_ROWS rows
# and the edge rows (B3's plain version all of them); an EFB group of the
# first OVERSIZE_MEMBERS of those features, whose tables exceed 96 KiB
WIDE_INGEST_ROWS, WIDE_INGEST_FEATURES = 200_000, 2_000
WIDE_SAMPLE_ROWS, WIDE_ORACLE_ROWS, OVERSIZE_MEMBERS = 10_000, 20_000, 120
# stream_train (queue A10): the training run's rows through
# Dataset.from_sample (bins from the first STREAM_SAMPLE_ROWS rows) and
# push_rows in STREAM_PUSH_ROWS-row f32 chunks, spilled in
# STREAM_BLOCK_ROWS-row blocks (8 at 1 M rows) and trained streamed for
# STREAM_ROUNDS rounds, f32 and quantized, against the resident twin;
# STREAM_PLAIN_ROUNDS with the kernels' plain versions (its first tree;
# the resident twin holds every tree), STREAM_SHORT_ROUNDS at
# STREAM_BIG_BLOCK_ROWS-row blocks (4); bulk
# scoring of the f32 rows stored in BULK_BLOCK_ROWS-row blocks (16),
# stopped after BULK_STOP_BLOCKS blocks and resumed
STREAM_SAMPLE_ROWS, STREAM_PUSH_ROWS = 200_000, 100_000
STREAM_BLOCK_ROWS, STREAM_BIG_BLOCK_ROWS = 131_072, 250_000
STREAM_ROUNDS, STREAM_SHORT_ROUNDS, STREAM_PLAIN_ROUNDS = 10, 3, 1
BULK_BLOCK_ROWS, BULK_STOP_BLOCKS = 65_536, 3
# a training run's card peak (torch.cuda.max_memory_allocated) over the
# planner's prediction: at most 5% above it (the election must not call
# a run that does not fit feasible), and not below three quarters of it
PEAK_RATIO = (0.75, 1.05)


_T_START = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase's row also carries ``t_s``, the
    script's seconds when it was printed (where a whole run's time
    went)."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - _T_START, 1))
    print(json.dumps(obj), flush=True)


# template arguments of the kernels as the mangled name spells them
_MANGLED = {"h": "uint8_t", "i": "int", "f": "float", "a": "int8_t"}


def _template_args(kernel: str, symbol: str) -> str:
    """``kernel<...>`` from a mangled symbol's template arguments (types,
    and bool / int literals), or the symbol itself."""
    import re
    m = re.search(kernel + r"I(.*?)EE", symbol)
    if m is None:
        return symbol
    args = []
    for lit, val, code in re.findall(r"L([bi])(\d+)E|([a-z])",
                                     m.group(1) + "E"):
        if code:
            args.append(_MANGLED.get(code, code))
        else:
            args.append(("false", "true")[int(val)] if lit == "b" else val)
    return f"{kernel}<{', '.join(args)}>"


def sass_atomics(_build, lib, kernel: str) -> dict:
    """The atomic opcodes (``ATOMS``/``ATOM``/``RED``) in the SASS of each
    instance of ``kernel`` in a built library, by ``cuobjdump -sass``
    from the toolkit that built it: a 64-bit shared add that compiles to
    a compare-and-swap loop shows as ``ATOMS.CAST.SPIN.64``."""
    import re
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    found, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = None
            if kernel in m.group(1):
                func = _template_args(kernel, m.group(1))
                found[func] = set()
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9._]+)",
                      line)
        if m and func is not None:
            found[func].add(m.group(1))
    if not found:
        raise AssertionError(f"no {kernel} in the SASS of {lib}")
    return {k: sorted(v) for k, v in sorted(found.items())}


def native_shared_atomics(atomics: dict, kernel: str) -> None:
    """Raise unless every shared atomic of ``kernel`` is a native 32-bit
    ``ATOMS.ADD`` (no compare-and-swap loop, no 64-bit shared atomic)."""
    for func, ops in atomics.items():
        bad = [op for op in ops if "CAS" in op or "SPIN" in op
               or (op.startswith("ATOMS") and ".64" in op)]
        if bad or "ATOMS.ADD" not in ops:
            raise AssertionError(f"{func}: shared atomics {ops}, not native "
                                 f"32-bit adds ({kernel})")


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls from Python,
    by CUDA events after a warm-up: the device time plus whatever the
    host's launch rate leaves the card idle between calls."""
    for _ in range(warmup):
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


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn``: ``reps`` calls captured into one CUDA
    graph, replayed and timed by CUDA events, so no Python runs between
    launches.  The forest planes stay hot in L2, as they do for a server
    answering batch after batch."""
    fn()                                   # builds and loads the kernel
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
    ms = start.elapsed_time(end) / reps
    del graph
    torch.cuda.empty_cache()
    return ms


# the training kernels by the symbols of their CUDA functions, the
# first match naming an event (B4's sort kernels before B5's scan)
TREE_KERNELS = (("B4 sort", ("slot_count_kernel", "slot_scan_kernel",
                             "slot_scatter_kernel")),
                ("B4", ("accumulate_kernel",)),
                ("B5", ("scan_kernel",)),
                ("B6", ("histogram_kernel",)),
                ("B3", ("ingest_kernel",)),
                ("B1", ("descend_kernel", "ordered_sum_kernel")))


def _tree_kernel(name: str) -> str:
    for label, symbols in TREE_KERNELS:
        if any(sym in name for sym in symbols):
            return label
    return "other device work"


def cuda_event_kernel_ms(step) -> dict:
    """Device time per training kernel over one call of ``step``, from
    CUDA events around each wrapper's launches (B4 with its sort, B5, B6,
    B3), installed here and removed after."""
    from lightgbm_tpu_torch.ops import fused, histogram, ingest
    spans = {}
    saved = (fused._accumulate_cuda, fused._scan_cuda,
             histogram._histogram_cuda, ingest._bin_cuda)

    def timed(label, fn):
        def run(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            spans.setdefault(label, []).append((a, b))
            return out
        return run
    fused._accumulate_cuda = timed("B4", saved[0])
    fused._scan_cuda = timed("B5", saved[1])
    histogram._histogram_cuda = timed("B6", saved[2])
    ingest._bin_cuda = timed("B3", saved[3])
    try:
        step()
        torch.cuda.synchronize()
    finally:
        (fused._accumulate_cuda, fused._scan_cuda,
         histogram._histogram_cuda, ingest._bin_cuda) = saved
    return {k: sum(a.elapsed_time(b) for a, b in v)
            for k, v in spans.items()}


def tree_kernel_ms(step, fused_arm: bool) -> dict:
    """Device time summed per training kernel over one call of ``step``
    (one tree, its round graph already captured): ``torch.profiler``'s
    CUDA events by kernel symbol, or, where the profiler does not start
    or records no device time, ``cuda_event_kernel_ms`` over a further
    call with the round body run eagerly (a graph replay calls no
    wrapper).  ``busy_share`` is the device time over the call's wall
    time.  B5 is split by the modes its launches took (from
    ``fused.scan_modes``); on the fused arm B2 is the sum of its B4 and
    B5 launches.  ``device_events``: the device events the profiler
    recorded (kernels and copies).  An error of ``step`` itself
    propagates."""
    from lightgbm_tpu_torch import grower_rounds
    from lightgbm_tpu_torch.ops import fused
    before = dict(fused.scan_modes)
    # what reached B5 on group histograms, and what was expanded (counted
    # by the module, graph replays included)
    paths = dict(fused.path_counts)
    ms, source, wall_ms, kernels = {}, "torch.profiler", 0.0, None
    try:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.__enter__()
    except Exception as exc:              # a profiler without CUPTI
        prof = None
        source = (f"cuda events (the profiler did not start: "
                  f"{type(exc).__name__})")
    if prof is not None:
        try:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            prof.__exit__(None, None, None)
        kernels = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                kernels += 1
                label = _tree_kernel(e.name)
                ms[label] = (ms.get(label, 0.0)
                             + e.time_range.elapsed_us() / 1e3)
    if not any(v > 0 for k, v in ms.items() if k != "other device work"):
        if source == "torch.profiler":
            source = "cuda events (the profiler recorded no kernel time)"
        # a further tree, every count below taken over it alone
        source += "; eager round body"
        before = dict(fused.scan_modes)
        paths = dict(fused.path_counts)
        grower_rounds.USE_GRAPHS = False
        try:
            t0 = time.perf_counter()
            ms = cuda_event_kernel_ms(step)
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            grower_rounds.USE_GRAPHS = True
    modes = {k: v - before.get(k, 0) for k, v in fused.scan_modes.items()
             if v - before.get(k, 0)}
    seen = {k: v - paths.get(k, 0) for k, v in fused.path_counts.items()}
    busy = sum(ms.values())
    out = {"source": source, "b5_launches_by_mode": modes, **seen,
           **{k: ms.get(k, 0.0) for k, _ in TREE_KERNELS},
           "other device work": ms.get("other device work", 0.0),
           "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_events": kernels if source == "torch.profiler" else None,
           "busy_share": busy / wall_ms if wall_ms > 0 else None}
    out["B5 by mode"] = {"+".join(sorted(modes)): out["B5"]}
    if fused_arm:
        out["B2 (B4 + its sort + B5)"] = out["B4"] + out["B4 sort"] \
            + out["B5"]
    return out


def bound(pk, dev, X, num_class, emit_scores):
    """Least time the card could take for B1 on ``X``: its work
    (``devprof.traverse_cost``: the plane entries, bitset words and leaf
    values this input needs, X and the output, each once; the f32
    operations of every visit) against the card's rates."""
    c = traverse_cost(dev, X, num_class, emit_scores)
    return {"bytes": c["bytes"], "plane_entries": c["plane_entries"],
            "bitset_words": c["bitset_words"],
            **{k: v for k, v in roofline(c["bytes"], c["ops"]).items()
               if k != "bytes"}}


def plan_variants(dev, X, K, scores: bool) -> list:
    """The planner's launch for these rows and mode, and the launch with
    the node records staged in shared memory and read from global
    memory (the one the planner did not pick, where the trees fit); each
    (label, plan)."""
    from lightgbm_tpu_torch.ops import planner
    n, F = X.shape
    T, I = dev.split_feature.shape
    args = (F, I, T, n, bool(dev.forest.has_cat), K, scores)
    out = [("planned", planner.traverse_plan(*args))]
    for stage in (False, True):
        try:
            plan = planner.traverse_plan(*args, stage=stage)
        except ValueError:
            continue               # the trees do not fit: no staged path
        out.append(("staged" if stage else "global", plan))
    return out


def check_kernel(pk, dev, X, K, host_forest=None):
    """Kernel vs plain version on the card, both modes, at every launch
    shape of ``plan_variants``; exact.  Returns the shapes checked and
    the largest |kernel - plain| each mode showed ({"leaves": e,
    "scores": e})."""
    plain = pk.traverse_plain(dev, X)
    plain_s = pk.traverse_plain(dev, X, K, emit_scores=True)
    torch.cuda.synchronize()
    checked, errs = {}, {"leaves": 0.0, "scores": 0.0}
    for scores, want in ((False, plain), (True, plain_s)):
        mode = "scores" if scores else "leaves"
        for label, plan in plan_variants(dev, X, K, scores):
            got = pk.fused_traverse(dev, X, K, emit_scores=scores, plan=plan)
            torch.cuda.synchronize()
            errs[mode] = max(errs[mode], max_abs_err(got, want))
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                bad = int((got != want).sum())
                raise AssertionError(
                    f"{'scores' if scores else 'leaf ids'} differ from the "
                    f"plain version at {bad} of {got.numel()} entries "
                    f"({label}: {plan})")
            checked[f"{mode}:{label}"] = f"{plan.rows}x{plan.trees}"
            if label == "planned" and not scores and host_forest is not None:
                host = host_forest.predict_leaf(X.double().cpu().numpy())
                if not np.array_equal(got.cpu().numpy(), host.T):
                    raise AssertionError("leaf ids differ from the host "
                                         "float64 path")
    return checked, errs


def phase_kernel(pk, models):
    """Correctness at ragged and bucket shapes; times at the serving
    buckets and a predict chunk."""
    from lightgbm_tpu_torch.testing import salt_rows, synthetic_rows
    rows = {}
    max_err = {"leaves": 0.0, "scores": 0.0}
    for name, (bst, F, cats, seed) in models.items():
        K = bst.num_tree_per_iteration
        forest = bst._forest(0, len(bst.models) // K)
        dev = bst._device_forest(forest)
        shapes, errs = {}, {"leaves": 0.0, "scores": 0.0}
        for n in CHECK_ROWS:
            X = salt_rows(synthetic_rows(F, n, cats, seed=seed, row_seed=n))
            Xt = torch.from_numpy(X.astype(np.float32)).cuda()
            shapes[n], e = check_kernel(
                pk, dev, Xt, K,
                forest if n == CHECK_ROWS[2] and F < 100 else None)
            for mode in errs:
                errs[mode] = max(errs[mode], e[mode])
                max_err[mode] = max(max_err[mode], e[mode])
        emit({"phase": "kernel", "forest": name, "rows": list(CHECK_ROWS),
              "checked": "bit-identical to the plain version at the "
                         "planned, staged and global launch shapes",
              "launch_shapes": shapes, "max_abs_err": errs})
        if F >= 100:
            continue          # the wide forest is checked, not timed
        for n_t in TIMED_ROWS:
            X = salt_rows(synthetic_rows(F, n_t, cats, seed=seed,
                                         row_seed=n_t + 1))
            Xt = torch.from_numpy(X.astype(np.float32)).cuda()
            for scores in (False, True):
                def kernel():
                    return pk.fused_traverse(dev, Xt, K, emit_scores=scores)

                def plain():
                    return pk.traverse_plain(dev, Xt, K, emit_scores=scores)

                reps_k = 50 if n_t <= 1024 else 10
                reps_p = 5 if n_t <= 1024 else 2
                b = bound(pk, dev, Xt, K, scores)
                plan = plan_variants(dev, Xt, K, scores)[0][1]
                row = {"phase": "kernel", "forest": name, "rows": n_t,
                       "mode": "scores" if scores else "leaves",
                       "trees": dev.num_trees, "features": F,
                       "plan": plan._asdict(),
                       "kernel_ms": graph_ms(kernel, reps_k),
                       "kernel_event_ms": event_ms(kernel, reps_k),
                       "plain_ms": graph_ms(plain, reps_p),
                       "plain_event_ms": event_ms(plain, reps_p, warmup=1),
                       "library_ms": None, **b}
                rows[(name, n_t, scores)] = row
                emit(row)
    return rows, max_err


def phase_serve(pk, bst, F, seed):
    """The main path: Booster.serve() answering mixed-size requests from
    several threads, then Booster.predict() in scores mode."""
    from lightgbm_tpu_torch.testing import synthetic_rows
    forest = bst._forest(0, len(bst.models))
    rng = np.random.RandomState(seed)
    n_req, n_threads = SERVE_REQUESTS, SERVE_THREADS
    sizes = np.minimum(np.exp(rng.uniform(0, np.log(MAX_REQUEST_ROWS),
                                          n_req)).astype(int),
                       MAX_REQUEST_ROWS)
    sizes[:2] = [1, MAX_REQUEST_ROWS]
    X = synthetic_rows(F, int(sizes.sum()), seed=seed, row_seed=77)
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    Xbig = synthetic_rows(F, PREDICT_ROWS, seed=seed, row_seed=78)
    torch.cuda.synchronize()

    pk.reset_launch_counts()
    results, lat = {}, {}
    errors = []
    t0 = time.perf_counter()
    with bst.serve() as srv:
        def client(ids):
            try:
                for i in ids:
                    s = time.perf_counter()
                    results[i] = srv.predict(X[bounds[i]:bounds[i + 1]],
                                             timeout=600)
                    lat[i] = (time.perf_counter() - s) * 1e3
            except Exception as e:  # noqa: BLE001 — re-raised below
                errors.append(e)

        threads = [threading.Thread(target=client,
                                    args=(range(k, n_req, n_threads),))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        metrics = srv.metrics_dict()
    served_scores = pk.launch_counts[f"{KERNEL}[scores]"]
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or len(results) != n_req:
        raise AssertionError("not every request was answered")
    t1 = time.perf_counter()
    raw = bst.predict(Xbig, raw_score=True)
    predict_s = time.perf_counter() - t1
    launches = {mode: pk.launch_counts[f"{KERNEL}[{mode}]"]
                for mode in ("leaves", "scores")}

    host = forest.predict_raw(X)[0]
    for i in range(n_req):
        want = host[bounds[i]:bounds[i + 1]]
        if not np.array_equal(results[i].view(np.uint64),
                              want.view(np.uint64)):
            raise AssertionError(f"served request {i} differs from the "
                                 "host float64 path")
    dev = bst._device_forest(forest)
    plain = pk.traverse_plain(dev, torch.from_numpy(
        Xbig.astype(np.float32)).cuda(), 1, emit_scores=True)
    plain = plain.cpu().numpy().astype(np.float64)[0]
    if not np.array_equal(raw.view(np.uint64), plain.view(np.uint64)):
        raise AssertionError("Booster.predict differs from the plain version")
    if not np.isfinite(raw).all() or raw.shape != (Xbig.shape[0],):
        raise AssertionError("Booster.predict gave a bad result")
    if launches["leaves"] + served_scores <= 0:
        raise AssertionError("serving never launched the kernel")
    if launches["scores"] <= served_scores:
        raise AssertionError("Booster.predict never launched the kernel")
    lat_ms = np.array([lat[i] for i in range(n_req)])
    hist = metrics["histograms"]
    row = {"phase": "serve", "requests": n_req, "threads": n_threads,
          "rows": int(sizes.sum()), "wall_s": wall,
          "rows_per_s": int(sizes.sum()) / wall,
          "p50_ms": float(np.percentile(lat_ms, 50)),
          "p99_ms": float(np.percentile(lat_ms, 99)),
          "batches": metrics["counters"]["batches_total"],
          "batch_rows_mean": hist["batch_rows"]["mean"],
          "batch_ms_mean": hist["batch_latency_ms"]["mean"],
          "queue_wait_ms_mean": hist["queue_wait_ms"]["mean"],
          **batch_breakdown(dev, forest, F, seed),
          "predict_rows": Xbig.shape[0],
          "predict_rows_per_s": Xbig.shape[0] / predict_s,
          "launches": launches, "checked": "bit-exact"}
    emit(row)
    return launches, row


def batch_breakdown(dev, forest, F, seed, reps: int = 21) -> dict:
    """Host-clock split of one top-bucket (1024-row) serving batch, as
    ``DeviceForest.predict_raw_padded`` runs it when the f32 epilogue is
    not verified: rows to the card + kernel + leaf ids back, then the
    host float64 leaf gather.  Medians over ``reps`` runs."""
    from lightgbm_tpu_torch.predict import gather_leaf_sum
    from lightgbm_tpu_torch.testing import synthetic_rows
    Xpad = synthetic_rows(F, 1024, seed=seed, row_seed=79)
    route, gather = [], []
    for _ in range(reps):
        t = time.perf_counter()
        leaves = dev._leaves(dev._to_device(Xpad)).cpu().numpy()
        route.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        gather_leaf_sum(forest, leaves, 1)
        gather.append((time.perf_counter() - t) * 1e3)
    return {"bucket1024_route_ms": float(np.median(route)),
            "bucket1024_gather_ms": float(np.median(gather))}


def timed_calls(obj, name: str, store: dict) -> None:
    """Wrap ``obj.<name>`` so that each call adds its wall seconds to
    ``store[name]``."""
    fn = getattr(obj, name)

    def run(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            store[name] = store.get(name, 0.0) + time.perf_counter() - t

    setattr(obj, name, run)


def check_load(res: dict, n: int, models, what: str) -> None:
    """A load generator's run: every request answered, none failed, each
    bit-equal to the host path of the model it was admitted against."""
    if res["errors"] or res["mismatches"]:
        raise AssertionError(f"{what}: errors {res['errors'][:3]}, "
                             f"mismatches {res['mismatches'][:3]}")
    if res["requests"] != n or res["shed"] or res["expired"]:
        raise AssertionError(f"{what}: {res['requests']} of {n} answered")
    if not set(res["model_digests"]) <= {m.digest for m in models}:
        raise AssertionError(f"{what}: answers from an unknown model")


def phase_swap_serve(pk, lt, bst, F, seed, serve_row):
    """Hot-swap and low-precision serving at the serve phase's width (28
    features, 500 trees, 255 leaves): a swap to a second forest under the
    serve phase's traffic, a quarantined NaN swap, a swap to a 5-class
    forest, bf16 and int8 servers (B1 in leaves mode on their planes),
    ``apredict``, and the native host route."""
    import asyncio

    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.serving import (LowPrecisionQuarantined,
                                            SwapQuarantined, loadgen)
    from lightgbm_tpu_torch.serving.registry import CompiledModel
    from lightgbm_tpu_torch.testing import (salt_rows, synthetic_model_text,
                                            synthetic_rows)
    t_phase = time.perf_counter()
    text_b = synthetic_model_text(F, 500, 255, seed=seed + 1)
    bst_b = lt.Booster(model_str=text_b)
    bst_k = lt.Booster(model_str=synthetic_model_text(
        F, SWAP_MULTI_ITERS, 255, num_class=SWAP_CLASSES, seed=seed + 2))
    ma, mb, mk = (CompiledModel(b, backend="host")
                  for b in (bst, bst_b, bst_k))
    setup_s = time.perf_counter() - t_phase

    # 1. a swap from A to B under the serve phase's traffic
    pk.reset_launch_counts()
    with bst.serve() as srv:
        timing: dict = {}
        timed_calls(srv.models, "_probe", timing)
        timed_calls(srv.programs, "warm", timing)
        res: dict = {}
        traffic = threading.Thread(target=lambda: res.update(
            loadgen.fire_requests(srv, SERVE_REQUESTS, SERVE_THREADS,
                                  MAX_REQUEST_ROWS, F,
                                  verify_models=[ma, mb], timeout=600,
                                  seed=seed)))
        traffic.start()
        done = srv.metrics.counter("requests_completed")
        limit = time.monotonic() + 600
        while (done.value < SERVE_REQUESTS // 4 and traffic.is_alive()
               and time.monotonic() < limit):
            time.sleep(0.002)
        answered_before = done.value
        t0 = time.perf_counter()
        handle = srv.swap_model(bst_b, warm=True, block=False)
        handle.join(600)
        swap_s = time.perf_counter() - t0
        traffic.join(900)
        if handle.is_alive() or traffic.is_alive():
            raise AssertionError("the swap or the traffic hung")
        if handle.exception is not None:
            raise handle.exception
        swap_launches = {m: pk.launch_counts[f"{KERNEL}[{m}]"]
                         for m in ("leaves", "scores")}
        check_load(res, SERVE_REQUESTS, (ma, mb), "swap under load")
        if res["model_digests"].get(mb.digest, 0) <= 0 or \
                res["model_digests"].get(ma.digest, 0) <= 0:
            raise AssertionError(f"the swap did not land mid-traffic: "
                                 f"{res['model_digests']}")
        Xq = synthetic_rows(F, 1000, seed=seed, row_seed=81)
        if not np.array_equal(srv.predict(Xq, timeout=600),
                              loadgen.expected_answer(mb, Xq)):
            raise AssertionError("post-swap answers are not model B's")
        md = srv.metrics_dict()
        if md["counters"]["hot_swaps"] != 1 or \
                md["gauges"]["model_generation"] != 1 or \
                md["gauges"]["active_model_digest"] != mb.digest:
            raise AssertionError(f"swap counters: {md['counters']}")
        warmed = len({b for b, _k in srv.programs.seen_buckets})

        # 2. a NaN leaf is quarantined; B keeps serving
        bad = lt.Booster(model_str=text_b)
        bad.models[0].leaf_value[0] = np.nan
        try:
            srv.swap_model(bad)
        except SwapQuarantined:
            pass
        else:
            raise AssertionError("a forest with a NaN leaf was promoted")
        if srv.models.active.digest != mb.digest or \
                srv.metrics.counter("swap_quarantines").value != 1:
            raise AssertionError("the quarantined swap moved the model")

        # 3. across num_class: warm rebuilds every seen bucket for K = 5
        t0 = time.perf_counter()
        srv.swap_model(bst_k, warm=True)
        swap_k_s = time.perf_counter() - t0
        misses_warm = srv.metrics.counter("bucket_misses").value
        res_k = loadgen.fire_requests(srv, SWAP_K_REQUESTS, SERVE_THREADS,
                                      MAX_REQUEST_ROWS, F,
                                      verify_models=[mk], timeout=600,
                                      seed=seed + 50)
        check_load(res_k, SWAP_K_REQUESTS, (mk,), "5-class swap")
        if srv.metrics.gauge("model_generation").value != 2:
            raise AssertionError("the 5-class swap did not land")

        # 5. apredict: requests awaited from one event loop
        Xa = [synthetic_rows(F, int(n), seed=seed, row_seed=90 + i)
              for i, n in enumerate(np.linspace(1, MAX_REQUEST_ROWS,
                                                APREDICT_REQUESTS))]

        async def gather():
            return await asyncio.wait_for(
                asyncio.gather(*[srv.apredict(x) for x in Xa]), 600)

        outs = asyncio.run(gather())
        for x, out in zip(Xa, outs):
            if out.shape != (len(x), SWAP_CLASSES) or not np.array_equal(
                    out, srv.predict(x, timeout=600)):
                raise AssertionError("apredict differs from predict")
        # buckets the 5-class traffic met that no earlier request had
        cold_misses_k = (srv.metrics.counter("bucket_misses").value
                         - misses_warm)

    # 4. bf16 and int8 servers of A: answers are the quantised forest's
    # host path; B1 in leaves mode on their planes
    X1024 = torch.from_numpy(synthetic_rows(
        F, 1024, seed=seed, row_seed=83).astype(np.float32)).cuda()
    devs = {"f32": bst._device_forest(ma.forest)}
    lowprec = {}
    for prec in ("bf16", "int8"):
        pk.reset_launch_counts()
        with bst.serve(precision=prec) as lp:
            m = lp.models.active
            delta = lp.metrics.gauge("lowprec_accuracy_delta").value
            r = loadgen.fire_requests(lp, LOWPREC_REQUESTS, SERVE_THREADS,
                                      MAX_REQUEST_ROWS, F,
                                      verify_models=[m], timeout=600,
                                      seed=seed + 60)
            launched = pk.launch_counts[f"{KERNEL}[leaves]"]
            scores_launched = pk.launch_counts[f"{KERNEL}[scores]"]
            buckets = list(lp.ladder.buckets)
        check_load(r, LOWPREC_REQUESTS, (m,), f"{prec} serving")
        if launched <= 0 or scores_launched:
            raise AssertionError(f"{prec} serving launched B1 leaves "
                                 f"{launched}, scores {scores_launched}")
        dev = devs[prec] = m.device_forest
        err, shapes = 0.0, {}
        for b in buckets:
            Xt = torch.from_numpy(salt_rows(synthetic_rows(
                F, b, seed=seed, row_seed=b)).astype(np.float32)).cuda()
            want = pk.traverse_plain(dev, Xt)
            for label, plan in plan_variants(dev, Xt, 1, False):
                got = pk.fused_traverse(dev, Xt, plan=plan)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(f"B1 on the {prec} plane differs "
                                         f"from its plain version ({b} "
                                         f"rows, {label})")
                shapes[f"{b}:{label}"] = f"{plan.rows}x{plan.trees}"
        try:
            bst.serve(precision=prec, accuracy_budget=delta / 2).close()
        except LowPrecisionQuarantined:
            pass
        else:
            raise AssertionError(f"{prec} under half its delta served")
        lowprec[prec] = {"accuracy_delta": delta, "launches": launched,
                         "max_abs_err": err, "shapes_checked": len(shapes),
                         "rows_per_s": r["rows"] / r["wall_seconds"],
                         "p50_ms": r["latency_ms"]["p50"],
                         "p99_ms": r["latency_ms"]["p99"]}
    # B1's leaves mode at 1024 rows on each plane, in one stretch
    times = {p: [] for p in devs}
    for p in ("f32", "bf16", "int8", "int8", "bf16", "f32"):
        times[p].append(graph_ms(
            lambda d=devs[p]: pk.fused_traverse(d, X1024), 50))
    b1 = {p: {"ms": float(np.mean(v)), "ms_runs": v,
              "plain_ms": graph_ms(
                  lambda d=devs[p]: pk.traverse_plain(d, X1024), 5),
              **{k: v2 for k, v2 in bound(pk, devs[p], X1024, 1,
                                          False).items()
                 if k in ("bound_ms", "bound_by")}}
          for p, v in times.items()}

    # 6. the native host route: backend="host" serving, then 100,000 rows
    if native.load_native_lib() is None:
        raise AssertionError("the native host library did not build")
    native.reset_route_counts()
    with bst.serve(backend="host") as hs:
        r_host = loadgen.fire_requests(hs, HOST_REQUESTS, SERVE_THREADS,
                                       MAX_REQUEST_ROWS, F,
                                       verify_models=[ma], timeout=600,
                                       seed=seed + 70)
    check_load(r_host, HOST_REQUESTS, (ma,), "host serving")
    Xn = synthetic_rows(F, PREDICT_ROWS, seed=seed, row_seed=82)
    forest = ma.forest
    t0 = time.perf_counter()
    raw_native = forest.predict_raw(Xn)
    native_s = time.perf_counter() - t0
    routes = dict(native.route_counts)
    if routes["predict[native]"] <= 0 or routes["predict[numpy]"]:
        raise AssertionError(f"the host path missed the native route: "
                             f"{routes}")
    forest._native_lib = None
    try:
        t0 = time.perf_counter()
        raw_numpy = forest.predict_raw(Xn[:NUMPY_ROWS])
        numpy_s = time.perf_counter() - t0
    finally:
        del forest._native_lib
    if not np.array_equal(raw_native[:, :NUMPY_ROWS].view(np.uint64),
                          raw_numpy.view(np.uint64)):
        raise AssertionError("the native and NumPy routes differ")

    row = {"phase": "swap_serve", "setup_s": setup_s,
           "requests": SERVE_REQUESTS, "threads": SERVE_THREADS,
           "rows": res["rows"], "wall_s": res["wall_seconds"],
           "rows_per_s": res["rows"] / res["wall_seconds"],
           "p50_ms": res["latency_ms"]["p50"],
           "p99_ms": res["latency_ms"]["p99"],
           "serve_rows_per_s": serve_row["rows_per_s"],
           "serve_p50_ms": serve_row["p50_ms"],
           "serve_p99_ms": serve_row["p99_ms"],
           "answered_before_swap": answered_before,
           "answers_by_model": {"A": res["model_digests"].get(ma.digest, 0),
                                "B": res["model_digests"].get(mb.digest,
                                                              0)},
           "swap_s": swap_s, "probe_s": timing.get("_probe"),
           "warm_s": timing.get("warm"), "warmed_buckets": warmed,
           "swap_launches": swap_launches,
           "quarantined": "SwapQuarantined (NaN leaf)",
           "swap_k5_s": swap_k_s, "k5_requests": res_k["requests"],
           "k5_cold_bucket_misses": cold_misses_k,
           "apredict_requests": APREDICT_REQUESTS,
           "lowprec": lowprec, "b1_leaves_1024": b1,
           "host_serving_rows_per_s": (r_host["rows"]
                                       / r_host["wall_seconds"]),
           "native_rows": PREDICT_ROWS,
           "native_rows_per_s": PREDICT_ROWS / native_s,
           "numpy_rows": NUMPY_ROWS, "numpy_rows_per_s": NUMPY_ROWS / numpy_s,
           "native_routes": routes, "phase_s": time.perf_counter() - t_phase,
           "checked": "bit-exact to each request's admitted model"}
    emit(row)
    return row


# fleet_serve: the fleet's load (requests, threads, rows a request), the
# rows of a first request, the pod drills' load and the bulk scorer's
# rows and blocks
FLEET_REQUESTS, FLEET_THREADS, FLEET_MAX_ROWS = 240, 8, 512
FLEET_FIRST_ROWS = 64
POD_REQUESTS, POD_MAX_ROWS = 160, 256
FLEET_BULK_ROWS, FLEET_BULK_BLOCK_ROWS = 200_000, 65_536
FLEET_PHASE_LIMIT_S = 90.0


def _allocated() -> int:
    import gc
    gc.collect()
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated()


def _requested() -> int:
    """The bytes the live tensors asked the caching allocator for, before
    its rounding: ``memory_allocated`` also counts a reused cached block
    whole, up to 1 MiB over the request (seen on the card: a forest
    +650,240 bytes when the phase ran twice in one process)."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    return int(torch.cuda.memory_stats()["requested_bytes.all.current"])


def _tensor_count(obj) -> int:
    return sum(isinstance(t, torch.Tensor) for t in vars(obj).values())


def _fleet_load(fleet, mix, verify, n, threads, max_rows, seed, what):
    """``loadgen.fire_fleet_requests`` with every answer held bit-equal to
    its model's host float64 path; no failure, no mismatch."""
    from lightgbm_tpu_torch.serving.loadgen import fire_fleet_requests
    res = fire_fleet_requests(fleet, mix, n, threads, max_rows,
                              verify=verify, timeout=600, seed=seed)
    if res["errors"] or res["failures"] or res["mismatches"]:
        raise AssertionError(f"{what}: errors {res['errors'][:3]}, "
                             f"failures {res['failures'][:3]}, "
                             f"mismatches {res['mismatches']}")
    if res["requests"] + res["shed"] + res["expired"] != \
            res["requests_planned"] or res["requests"] <= 0:
        raise AssertionError(f"{what}: outcomes {res['outcomes']}")
    return res


def _pod_drill(pk, lt, path, host_forest, victim_down, router, chaos, seed,
               what):
    """A ``PodFleet(devices=2)`` of the hot model under load: replicas
    bit-identical, then ``victim_down(pod, device)`` while the victim has
    requests in flight; availability 1.0 through it with no request
    answered on the host, positive redispatch and replan counts, a
    ``flight_fleet_device_lost_*`` bundle."""
    import glob

    from lightgbm_tpu_torch.fleet import PodFleet
    from lightgbm_tpu_torch.obs.flight import global_flight
    from lightgbm_tpu_torch.testing import synthetic_rows
    pod = PodFleet(devices=2, router=router, chaos=chaos,
                   max_batch_rows=1024,
                   deadline_classes={"interactive": 60_000.0,
                                     "standard": 60_000.0, "batch": None})
    try:
        pod.add_model("hot", path, weight=3.0,
                      deadline_class="interactive")
        pod.warm()
        X = synthetic_rows(28, 300, seed=7, row_seed=seed)
        want = host_forest.predict_raw(X)[0]
        replicas = list(pod._replicas["hot"])
        if len(replicas) != 2:
            raise AssertionError(f"{what}: {len(replicas)} replicas")
        for r in replicas:
            if not np.array_equal(r.fleet.predict(r.inner_name, X,
                                                  timeout=600), want):
                raise AssertionError(f"{what}: replica on device "
                                     f"{r.device_id} differs")
        if not np.array_equal(pod.predict("hot", X, timeout=600), want):
            raise AssertionError(f"{what}: routed answer differs")
        victim = pod.topology.replicas["hot"][0]
        replans = pod.metrics.counter("fleet_replans_total")
        replans0 = replans.value
        before = set(glob.glob(os.path.join(global_flight.out_dir(),
                                            "flight_fleet_device_lost_*")))
        res: dict = {}

        def load():
            try:
                res.update(_fleet_load(
                    pod, {"hot": 1.0}, {"hot": host_forest}, POD_REQUESTS,
                    FLEET_THREADS, POD_MAX_ROWS, seed, what))
            except Exception as e:  # noqa: BLE001 — raised below
                res["error"] = e

        traffic = threading.Thread(target=load)
        pk.reset_launch_counts()
        traffic.start()
        limit = time.monotonic() + 120
        victim_rep = next(r for r in replicas if r.device_id == victim)
        while not victim_rep.inflight and time.monotonic() < limit:
            time.sleep(0.0005)
        if not victim_rep.inflight:
            raise AssertionError(f"{what}: no request in flight on the "
                                 "victim")
        t_kill = time.perf_counter()
        victim_down(pod, victim)
        limit = time.monotonic() + 60
        while replans.value == replans0 and time.monotonic() < limit:
            time.sleep(0.0005)
        kill_to_replan_ms = (time.perf_counter() - t_kill) * 1e3
        traffic.join(900)
        if "error" in res:
            raise res["error"]
        if traffic.is_alive() or not res:
            raise AssertionError(f"{what}: the load hung")
        launches = pk.launch_counts[KERNEL]
        m = pod.metrics
        redispatch = m.counter("fleet_failover_redispatch_total",
                               labels={"model": "hot"}).value
        limit = time.monotonic() + 30
        bundles: set = set()
        while not bundles and time.monotonic() < limit:
            bundles = set(glob.glob(os.path.join(
                global_flight.out_dir(),
                "flight_fleet_device_lost_*"))) - before
            time.sleep(0.01)
        row = {"victim": victim, "live_devices": pod.live_devices(),
               "availability": pod.availability("hot"),
               "loadgen_availability": res["availability"],
               "requests": res["requests"], "expired": res["expired"],
               "shed": res["shed"], "redispatched": redispatch,
               "replans": replans.value - replans0,
               "kill_to_replan_ms": kill_to_replan_ms,
               "devices_lost": m.counter("fleet_devices_lost_total").value,
               "hedges": m.counter("fleet_hedges_total",
                                   labels={"model": "hot"}).value,
               "host_fallbacks": m.counter("fleet_host_fallback_total",
                                           labels={"model": "hot"}).value,
               "b1_launches": launches,
               "flight_bundles": len(bundles)}
        if row["availability"] != 1.0 or res["availability"] != 1.0 or \
                redispatch <= 0 or row["replans"] <= 0 or not bundles or \
                victim in row["live_devices"] or launches <= 0 or \
                row["host_fallbacks"] != 0:
            raise AssertionError(f"{what}: {row}")
        if not np.array_equal(pod.predict("hot", X, timeout=600), want):
            raise AssertionError(f"{what}: the answer after the loss "
                                 "differs")
        return row
    finally:
        pod.close(drain=False, timeout=5.0)


def phase_fleet_serve(pk, lt, text_a, F, seed, smi):
    """Queue A6 at the serve phase's width: a ``Fleet`` of the serve
    model, swap_serve's second forest and its 5-class forest (load,
    eviction with the card's memory, the byte model against the
    allocator, stored programs), two ``PodFleet(devices=2)`` failover
    drills, and bulk scoring and chunk binning on two logical devices."""
    import glob
    import shutil
    import tempfile

    from lightgbm_tpu_torch.data import BlockStore, BulkScorer, IngestPump
    from lightgbm_tpu_torch.fleet import (AOTStore, Fleet, RouterConfig,
                                          plan_devices, quantize_forest)
    from lightgbm_tpu_torch.obs.flight import global_flight
    from lightgbm_tpu_torch.ops import ingest
    from lightgbm_tpu_torch.ops.planner import HEADROOM, predict_forest_bytes
    from lightgbm_tpu_torch.predict import DeviceForest
    from lightgbm_tpu_torch.resilience import ChaosRegistry
    from lightgbm_tpu_torch.testing import (synthetic_model_text,
                                            synthetic_rows)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="lgbt_fleet_")
    saved_dir = os.environ.get("LIGHTGBM_TPU_FLIGHT_DIR")
    saved_dumps = global_flight.dumps
    os.environ["LIGHTGBM_TPU_FLIGHT_DIR"] = os.path.join(tmp, "flight")
    os.makedirs(os.environ["LIGHTGBM_TPU_FLIGHT_DIR"])
    global_flight.dumps = 0
    fleet = None
    try:
        texts = {"hot": text_a,
                 "second": synthetic_model_text(F, 500, 255, seed=seed + 1),
                 "multi5": synthetic_model_text(
                     F, SWAP_MULTI_ITERS, 255, num_class=SWAP_CLASSES,
                     seed=seed + 2)}
        paths = {}
        for name, text in texts.items():
            paths[name] = os.path.join(tmp, f"{name}.txt")
            with open(paths[name], "w") as fh:
                fh.write(text)
        classes = {"hot": (3.0, "interactive"), "second": (1.0, "standard"),
                   "multi5": (1.0, "batch")}

        def make_fleet(**kw):
            f = Fleet(max_batch_rows=1024, **kw)
            for name, (w, cls) in classes.items():
                f.add_model(name, paths[name], weight=w, deadline_class=cls)
            return f

        def first_requests(f) -> dict:
            out = {}
            for name in classes:
                X = synthetic_rows(F, FLEET_FIRST_ROWS, seed=seed,
                                   row_seed=300)
                t = time.perf_counter()
                got = f.predict(name, X, timeout=600)
                out[name] = (time.perf_counter() - t) * 1e3
                want = expected(name, X)
                if not np.array_equal(got, want):
                    raise AssertionError(f"{name}'s first answer differs")
            return out

        def expected(name, X):
            forest = host[name]
            K = SWAP_CLASSES if name == "multi5" else 1
            raw = forest.predict_raw(X, num_class=K)
            return raw[0] if K == 1 else raw.T

        t0 = time.perf_counter()
        fleet = make_fleet()
        setup_s = time.perf_counter() - t0
        host = {n: fleet.entry(n).model.forest for n in classes}
        # 1. the fleet under load: every answer its model's host f64 path
        cold_ms = first_requests(fleet)
        pk.reset_launch_counts()
        load = _fleet_load(fleet, {"hot": 3.0, "second": 1.0,
                                   "multi5": 1.0}, host, FLEET_REQUESTS,
                           FLEET_THREADS, FLEET_MAX_ROWS, seed,
                           "fleet load")
        load_launches = {m: pk.launch_counts[f"{KERNEL}[{m}]"]
                         for m in ("leaves", "scores")}
        if sum(load_launches.values()) <= 0:
            raise AssertionError("the fleet never launched B1")
        wall = load["wall_seconds"]
        per_model = {n: {"requests": s["requests"], "rows": s["rows"],
                         "rows_per_s": s["rows"] / wall,
                         "p50_ms": s["latency_ms"].get("p50"),
                         "p99_ms": s["latency_ms"].get("p99"),
                         "shed": s["shed"], "expired": s["expired"]}
                     for n, s in load["models"].items()}

        # 2. eviction under a budget that fits only the hot model
        plan = fleet.replan()
        mp = next(m for m in plan.models if m.name == "hot")
        budget = int((mp.forest_bytes + mp.program_bytes + 1024) / HEADROOM)
        mem0 = _allocated()
        fleet.config.hbm_budget_bytes = budget
        plan = fleet.replan()
        mem1 = _allocated()
        evicted = set(plan.evicted)
        if evicted != {"second", "multi5"}:
            raise AssertionError(f"evicted {plan.evicted}")
        evicted_bytes = sum(m.forest_bytes for m in plan.models
                            if m.name in evicted)
        if mem0 - mem1 < 0.9 * evicted_bytes:
            raise AssertionError(f"eviction freed {mem0 - mem1} bytes of "
                                 f"{evicted_bytes}")
        pk.reset_launch_counts()
        for name in sorted(evicted):
            X = synthetic_rows(F, 700, seed=seed, row_seed=301)
            if not np.array_equal(fleet.predict(name, X, timeout=600),
                                  expected(name, X)):
                raise AssertionError(f"evicted {name} answers differ")
        evicted_launches = pk.launch_counts[KERNEL]
        if evicted_launches:
            raise AssertionError(f"evicted models launched B1 "
                                 f"{evicted_launches} times")
        fleet.config.hbm_budget_bytes = None
        plan = fleet.replan()
        mem2 = _allocated()
        if plan.evicted or mem2 - mem1 < 0.9 * evicted_bytes:
            raise AssertionError(f"restore: evicted {plan.evicted}, "
                                 f"{mem2 - mem1} bytes back")
        pk.reset_launch_counts()
        for name in sorted(evicted):
            X = synthetic_rows(F, 700, seed=seed, row_seed=302)
            if not np.array_equal(fleet.predict(name, X, timeout=600),
                                  expected(name, X)):
                raise AssertionError(f"restored {name} answers differ")
        restored_launches = pk.launch_counts[KERNEL]
        if restored_launches <= 0:
            raise AssertionError("restored models never launched B1")

        # 3. the byte model against the allocator (ROADMAP C-24)
        forest = host["hot"]
        T, I = forest.split_feature.shape
        byte_model = {}
        for prec in ("f32", "bf16", "int8"):
            src = forest if prec == "f32" else quantize_forest(forest, prec)
            m0, r0 = _allocated(), _requested()
            dev = (DeviceForest(src, "cuda") if prec == "f32" else
                   DeviceForest(src, "cuda", precision=prec,
                                routing_only=True))
            delta, requested = _allocated() - m0, _requested() - r0
            want = predict_forest_bytes(T, I, forest.leaf_value.shape[1],
                                        prec, routing_only=prec != "f32")
            byte_model[prec] = {"allocator_bytes": delta,
                                "requested_bytes": requested,
                                "predicted_bytes": want,
                                "tensors": _tensor_count(dev)}
            if requested != want or delta < want:
                raise AssertionError(f"{prec} forest: allocator {delta} "
                                     f"(requested {requested}), byte "
                                     f"model {want}")
            del dev

        # 4. stored programs: export, then a fresh fleet restores them
        store_dir = os.path.join(tmp, "aot")
        exported = fleet.export_aot(store_dir)
        fleet.close()
        fleet = None
        mem_pre, req_pre = _allocated(), _requested()
        t0 = time.perf_counter()
        fleet = make_fleet(aot_dir=store_dir)
        aot_setup_s = time.perf_counter() - t0
        restored_ms = first_requests(fleet)
        fleet.warm()
        aot_counts = {}
        for name in classes:
            c = fleet.entry(name).server.metrics_dict()["counters"]
            aot_counts[name] = {k: c.get(k, 0) for k in (
                "compile_events", "aot_program_loads", "bucket_misses")}
            if aot_counts[name]["compile_events"] != 0 or \
                    aot_counts[name]["aot_program_loads"] < 1:
                raise AssertionError(f"{name}: {aot_counts[name]}")
        # one forest a restored model on the card, as the byte model
        # counts it: the stored records build it, nothing is uploaded twice
        restored_mem = _allocated() - mem_pre
        restored_req = _requested() - req_pre
        restored_want = 0
        for name in classes:
            m = fleet.entry(name).model
            if m.device_forest.aot_records_sha is None:
                raise AssertionError(f"{name} was not built from the store")
            Tm, Im = m.forest.split_feature.shape
            restored_want += predict_forest_bytes(
                Tm, Im, m.forest.leaf_value.shape[1])
        if restored_req != restored_want or restored_mem < restored_want:
            raise AssertionError(f"restored fleet holds {restored_mem} "
                                 f"bytes (requested {restored_req}), byte "
                                 f"model {restored_want}")
        pk.reset_launch_counts()
        _fleet_load(fleet, {"hot": 3.0, "second": 1.0, "multi5": 1.0},
                    host, FLEET_REQUESTS // 4, FLEET_THREADS,
                    FLEET_MAX_ROWS, seed + 1, "restored fleet load")
        aot_launches = pk.launch_counts[KERNEL]
        if aot_launches <= 0:
            raise AssertionError("restored programs never launched B1")
        fleet.close()
        fleet = None
        # a corrupt blob and a foreign torch version are each a miss
        store = AOTStore(store_dir)
        srv = lt.serve(paths["hot"], aot_dir=store_dir, max_batch_rows=1024)
        try:
            digest = srv.models.active.digest
            if len(store.buckets_for(digest)) != len(srv.ladder.buckets):
                raise AssertionError("the store lacks buckets")
            with open(os.path.join(store_dir, f"{digest}-b64.bin"),
                      "wb") as fh:
                fh.write(b"not a stored program")
            meta_path = os.path.join(store_dir, f"{digest}-b128.json")
            with open(meta_path) as fh:
                meta = json.load(fh)
            meta["torch"] = "0.0.0"
            with open(meta_path, "w") as fh:
                json.dump(meta, fh)
            misses = []
            for rows in (40, 100, 8):
                X = synthetic_rows(F, rows, seed=seed, row_seed=303)
                if not np.array_equal(srv.predict(X, timeout=600),
                                      expected("hot", X)):
                    raise AssertionError(f"answer at {rows} rows differs")
                misses.append(srv.metrics.counter("compile_events").value)
            if misses != [1, 2, 2] or \
                    srv.metrics.counter("aot_program_loads").value != 1:
                raise AssertionError(f"corrupt entries: compile events "
                                     f"{misses}")
        finally:
            srv.close()

        # 5. PodFleet(devices=2) on the one card: kill_device, then a
        # chaos vanish, each under load
        fast = RouterConfig(health_interval_s=0.1)
        slow = ",".join(f"device.delay@{i}:sec=0.003" for i in range(4000))
        pod_kill = _pod_drill(
            pk, lt, paths["hot"], host["hot"],
            lambda pod, d: pod.kill_device(d), fast,
            ChaosRegistry(slow), seed + 10, "kill_device")
        chaos = ChaosRegistry(slow)
        pod_vanish = _pod_drill(
            pk, lt, paths["hot"], host["hot"],
            lambda pod, d: chaos.down_device(d, "vanish"), fast, chaos,
            seed + 20, "chaos vanish")

        # 6. two logical devices: chunks binned by B3, bulk scoring twice
        Xb = synthetic_rows(F, FLEET_BULK_ROWS, seed=seed, row_seed=304) \
            .astype(np.float32)
        ingest.reset_launch_counts()
        ds = lt.Dataset(Xb, label=np.zeros(len(Xb))).construct()
        binned = ds.binned_t.cpu().numpy()
        pump = IngestPump(Xb, FLEET_BULK_BLOCK_ROWS,
                          devices=["cuda:0", "cuda:0"])
        parts = {s: ds._bin_rows(chunk).cpu().numpy()
                 for _i, s, _r, chunk in pump}
        if not np.array_equal(np.concatenate(
                [parts[s] for s in sorted(parts)], axis=1), binned):
            raise AssertionError("two-device chunks bin differently")
        b3_launches = ingest.launch_counts["ingest"]
        del ds
        bst_a = lt.Booster(model_file=paths["hot"])
        dev_a = bst_a._device_forest(host["hot"])
        fstore = BlockStore.from_array(os.path.join(tmp, "features"), Xb,
                                       FLEET_BULK_BLOCK_ROWS)
        bulk_aot = AOTStore(os.path.join(tmp, "bulk_aot"))
        bulk = []
        pk.reset_launch_counts()
        for run in range(2):
            sink = os.path.join(tmp, f"sink{run}")
            before = bulk_aot.entries()
            stats = [BulkScorer(dev_a, fstore, sink, devices=plan_devices(2),
                                local_device_id=d, aot_store=bulk_aot).run()
                     for d in (0, 1)]
            sources = [st["program_source"] for st in stats]
            if not stats[1]["complete"] or sources != (
                    ["live", "aot"] if run == 0 else ["aot", "aot"]):
                raise AssertionError(f"bulk run {run}: {stats}")
            scorer = BulkScorer(dev_a, fstore, sink)
            from lightgbm_tpu_torch.data import ScoreSink
            sk = ScoreSink.open_or_create(
                sink, FLEET_BULK_ROWS, 1, FLEET_BULK_BLOCK_ROWS,
                fstore.num_blocks, scorer.digest)
            got = np.concatenate([sk.read_block(i) for i in
                                  range(fstore.num_blocks)], axis=1)[0]
            epilogue = stats[0]["epilogue"]
            want = bst_a.predict(Xb, raw_score=True,
                                 device=epilogue != "host")
            if not np.array_equal(got, want):
                raise AssertionError(f"bulk run {run} differs from "
                                     "Booster.predict")
            bulk.append({"entry_before": bool(before), "sources": sources,
                         "rows_per_s": [st["rows_per_sec"] for st in stats],
                         "blocks": [st["blocks_scored"] for st in stats],
                         "epilogue": epilogue})
        if bulk[0]["entry_before"] or not bulk[1]["entry_before"]:
            raise AssertionError(f"bulk restores: {bulk}")
        bulk_launches = pk.launch_counts[f"{KERNEL}[leaves]"]
        if bulk_launches != 2 * fstore.num_blocks:
            raise AssertionError(f"bulk B1 launches {bulk_launches}")
        phase_s = time.perf_counter() - t_phase
        row = {"phase": "fleet_serve", "card": smi, "setup_s": setup_s,
               "requests": FLEET_REQUESTS, "threads": FLEET_THREADS,
               "rows": load["rows"], "wall_s": wall,
               "rows_per_s": load["rows"] / wall,
               "p50_ms": load["latency_ms"]["p50"],
               "p99_ms": load["latency_ms"]["p99"],
               "shed": load["shed"], "expired": load["expired"],
               "models": per_model, "b1_launches": load_launches,
               "evicted": sorted(evicted), "budget_bytes": budget,
               "memory_allocated": [mem0, mem1, mem2],
               "evicted_forest_bytes": evicted_bytes,
               "evicted_b1_launches": evicted_launches,
               "restored_b1_launches": restored_launches,
               "byte_model": byte_model,
               "aot_entries": exported, "aot_setup_s": aot_setup_s,
               "restored_memory_allocated": restored_mem,
               "restored_requested_bytes": restored_req,
               "restored_forest_bytes": restored_want,
               "first_request_ms": {"cold": cold_ms,
                                    "restored": restored_ms},
               "aot_counters": aot_counts, "aot_b1_launches": aot_launches,
               "corrupt_compile_events": misses,
               "pod_kill": pod_kill, "pod_vanish": pod_vanish,
               "b3_launches": b3_launches, "bulk": bulk,
               "bulk_b1_launches": bulk_launches, "phase_s": phase_s,
               "checked": "bit-exact to each model's host f64 path"}
        emit(row)
        if phase_s > FLEET_PHASE_LIMIT_S:
            print(f"fleet_serve took {phase_s:.1f} s, over its "
                  f"{FLEET_PHASE_LIMIT_S} s share", file=sys.stderr)
        return {"leaves": load_launches["leaves"] + bulk_launches
                + pod_kill["b1_launches"] + pod_vanish["b1_launches"]
                + restored_launches + aot_launches,
                "scores": load_launches["scores"],
                "ingest": b3_launches, "row": row}
    finally:
        if fleet is not None:
            fleet.close(drain=False)
        global_flight.dumps = saved_dumps
        if saved_dir is None:
            os.environ.pop("LIGHTGBM_TPU_FLIGHT_DIR", None)
        else:
            os.environ["LIGHTGBM_TPU_FLIGHT_DIR"] = saved_dir
        shutil.rmtree(tmp, ignore_errors=True)


def cost_bound(kernel: str, **shape) -> dict:
    """``devprof.kernel_cost`` of ``kernel`` at ``shape`` with its least
    time on the card (``devprof.roofline``)."""
    c = kernel_cost(kernel, **shape)
    return roofline(c["bytes"], c["ops"])


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two tensors (equal infinities count 0), or
    over the fields of two ``NumericFeatureBest`` tuples."""
    if hasattr(a, "_fields"):
        return max(max_abs_err(getattr(a, f), getattr(b, f))
                   for f in a._fields)
    a, b = a.double(), b.double()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def kernel_launches():
    """Current launch counts of the training kernels (B3, B4, B5, B2,
    B6)."""
    from lightgbm_tpu_torch.ops import fused, histogram, ingest
    return {"ingest": ingest.launch_counts["ingest"],
            **fused.launch_counts, **histogram.launch_counts}


def reset_training_counts() -> None:
    from lightgbm_tpu_torch.ops import fused, histogram, ingest
    fused.reset_launch_counts()
    ingest.reset_launch_counts()
    histogram.reset_launch_counts()


def train_once(lt, X, y, Xv, yv, params, rounds, categorical,
               datasets=None, groups=(None, None)):
    """Dataset + valid set + ``train`` on the card (``datasets``: a
    constructed (train, valid) pair to reuse instead; ``groups``: the
    query sizes of the train and valid rows); returns (datasets, booster,
    evals, construct seconds, train seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if datasets is None:
        ds = lt.Dataset(X, label=y, group=groups[0],
                        categorical_feature=categorical)
        vs = ds.create_valid(Xv, label=yv, group=groups[1])
    else:
        ds, vs = datasets
    ds.construct()
    vs.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    evals = {}
    t1 = time.perf_counter()
    bst = lt.train(params, ds, rounds, valid_sets=[vs],
                   valid_names=["valid"], evals_result=evals,
                   verbose_eval=False)
    torch.cuda.synchronize()
    return ds, vs, bst, evals, construct_s, time.perf_counter() - t1


def plain_kernels():
    """Replace every training kernel's launcher by its plain version
    (returns the originals for ``restore_kernels``); the plain versions
    run the round body eagerly (they read the host)."""
    from lightgbm_tpu_torch import grower_rounds
    from lightgbm_tpu_torch.ops import fused, histogram, ingest
    saved = (ingest._bin_cuda, fused._accumulate_cuda, fused._scan_cuda,
             histogram._histogram_cuda)
    grower_rounds.USE_GRAPHS = False
    ingest._bin_cuda = lambda X, binner: binner.plain(X)
    fused._accumulate_cuda = fused.accumulate_plain
    fused._scan_cuda = (lambda *args, pair=False, plan=None, **kw:
                        fused.scan_plain(*args, **kw))
    histogram._histogram_cuda = histogram.histogram_plain
    return saved


def restore_kernels(saved) -> None:
    from lightgbm_tpu_torch import grower_rounds
    from lightgbm_tpu_torch.ops import fused, histogram, ingest
    (ingest._bin_cuda, fused._accumulate_cuda, fused._scan_cuda,
     histogram._histogram_cuda) = saved
    grower_rounds.USE_GRAPHS = True


def used_graph(bst) -> dict:
    """Fails unless ``bst``'s trees grew through the captured round graph
    (every rounds-grower run on the card does); returns the capture's
    milliseconds and each tree's dead rounds (rounds run past its end).
    A serial grower has no graph: returns each tree's host reads (the
    tree's scales and its per-split stop test) and split steps."""
    grower = bst.boosting.grower
    if type(grower).__name__ == "SerialGrower":
        return {"host_syncs_per_tree": list(grower.host_reads),
                "split_steps_per_tree": list(grower.steps)}
    if grower.graph is None:
        raise AssertionError("the run did not grow its trees through the "
                             "captured round graph")
    return {"graph_capture_ms": grower.capture_ms,
            "dead_rounds_per_tree": [ran - int(live) for ran, live
                                     in grower.round_counts]}


def host_reads(bst) -> dict:
    """One more ``update()`` of ``bst`` (its round graph captured) under
    ``torch.cuda.set_sync_debug_mode("warn")``: the synchronising calls
    it made (host reads, D2H copies), and the round loop's waits on its
    lagged stop flag (an event wait each, which that mode does not
    see); for a serial grower, its stop-test reads instead."""
    import warnings
    grower = bst.boosting.grower
    serial = type(grower).__name__ == "SerialGrower"
    waits = len(grower.host_reads) if serial else grower.flag_waits
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            bst.update()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message).lower()]
    out = {"host_syncs_per_iteration": len(syncs),
           "trees_per_iteration": bst.num_tree_per_iteration}
    if serial:
        out["grower_host_reads_per_iteration"] = sum(
            grower.host_reads[waits:])
    else:
        out["stop_flag_waits_per_iteration"] = grower.flag_waits - waits
    return out


def training_runs(lt, X, y, Xv, yv, params, rounds, categorical="auto",
                  datasets=None, falling="binary_logloss", rising="auc",
                  groups=(None, None), extras=False, plain_rounds=None):
    """The training path on the card three times: the main run (counts
    set to 0 just before it and read just after; its trees grow through
    the captured round graph), the same run with every kernel replaced by
    its plain version (the eager round body; its model text must be the
    same bytes, since every sum is an exact integer, and no count may
    rise), and a run through ``Booster.update()`` with a section timer
    (the eager fixed-shape body: where a tree's time goes; the timer
    synchronises the card at each section) that logs each tree's
    (candidates, committed) per frontier round; its trees must be the
    main run's.  ``plain_rounds``: the plain-version run trains that many
    rounds, and its trees must be the main run's first ones.  ``extras``
    (the ``train`` phase) adds an untimed eager
    run (seconds a tree without the graph), one tree's host reads, and
    ``update_chunk(8)`` against eight ``update()`` calls.
    Checks the trees, the valid metric ``falling`` (if any) falling every
    round, ``rising`` (if any) higher after the last round than after the
    first, and the card's predictions against the host's; returns what
    the phases report.  ``datasets``: a constructed (train, valid) pair
    that every run reuses (else each run bins its own, the plain-version
    run through B3's plain version); ``groups``: the query sizes of the
    train and valid rows."""
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.utils.timer import SectionTimer
    reset_training_counts()
    ds, vs, bst, evals, construct_s, train_s = train_once(
        lt, X, y, Xv, yv, params, rounds, categorical, datasets, groups)
    launches = kernel_launches()
    modes = dict(fused.scan_modes)
    graph = used_graph(bst)
    text = bst.model_to_string()
    K = bst.num_tree_per_iteration
    if bst.num_trees() != rounds * K:
        raise AssertionError(f"trained {bst.num_trees()} trees, not "
                             f"{rounds * K}")
    ll = evals["valid"][falling] if falling else None
    if falling and not all(b < a for a, b in zip(ll, ll[1:])):
        raise AssertionError(f"valid {falling} does not fall: {ll}")
    auc = evals["valid"][rising] if rising else None
    if rising and not auc[-1] > auc[0]:
        raise AssertionError(f"valid {rising} does not rise: {auc}")
    raw_dev = bst.predict(Xv, raw_score=True)
    raw_host = bst.predict(Xv, raw_score=True, device=False)
    leaf_dev = bst.predict(Xv[:20000], pred_leaf=True)
    leaf_host = bst.predict(Xv[:20000], pred_leaf=True, device=False)
    shape = (Xv.shape[0],) if K == 1 else (Xv.shape[0], K)
    if raw_dev.shape != shape or not np.isfinite(raw_dev).all():
        raise AssertionError("Booster.predict gave a bad result")
    if not np.array_equal(leaf_dev, leaf_host):
        raise AssertionError("leaf ids on the card differ from the host's")
    # f32 sums of the leaf values on the card vs f64 on the host
    pred_err = float(np.abs(raw_dev - raw_host).max())
    if not np.allclose(raw_dev, raw_host, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"predictions differ from the host: {pred_err}")

    saved = plain_kernels()
    reset_training_counts()
    plain_rounds = plain_rounds or rounds
    try:
        _, _, bst_p, _, _, plain_train_s = train_once(
            lt, X, y, Xv, yv, params, plain_rounds, categorical, datasets,
            groups)
    finally:
        restore_kernels(saved)
    plain_launches = kernel_launches()
    if any(plain_launches.values()):
        raise AssertionError(f"launch counts rose with no kernel launched: "
                             f"{plain_launches}")
    if (bst_p.model_to_string() != text if plain_rounds == rounds else
            head_trees(bst_p.model_to_string(), plain_rounds * K)
            != head_trees(text, plain_rounds * K)):
        raise AssertionError("the model text differs from the plain-version "
                             "run")
    del bst_p

    rounds_log = []
    bst_t = lt.Booster(params, train_set=ds)
    bst_t.add_valid(vs, "valid")
    timer = SectionTimer(cuda=True)
    bst_t.boosting.timer = timer
    bst_t.boosting.round_log = rounds_log
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        bst_t.update()
    timed_s = time.perf_counter() - t0
    bst_t.boosting.round_log = None
    if (bst_t.model_to_string().partition("end of trees")[0]
            != text.partition("end of trees")[0]):
        raise AssertionError("the timed run's trees differ")
    # seconds an iteration (num_class trees) by section
    per_tree = {k: v / rounds for k, v in timer.seconds.items()}
    per_tree["other"] = timed_s / rounds - sum(per_tree.values())
    # one more tree through the graph (its capture), then, untimed by
    # sections, a tree for its device time by kernel
    bst_t.boosting.timer = None
    bst_t.update()
    used_graph(bst_t)
    extra = host_reads(bst_t) if extras else {}
    gb = bst_t.boosting
    in_tree = tree_kernel_ms(bst_t.update, fused_arm=gb.grower.fused_arm)
    del bst_t
    if extras:
        extra.update(eager_and_chunk(lt, ds, vs, params, rounds, text,
                                     train_s))
    return {"ds": ds, "vs": vs, "bst": bst, "launches": launches,
            "text": text, "rounds_log": rounds_log, "row": {
        "rows": X.shape[0], "valid_rows": Xv.shape[0],
        "features": X.shape[1], "rounds": rounds,
        "num_leaves": params["num_leaves"],
        "leaves_per_tree": [m.num_leaves for m in bst.models],
        "construct_s": construct_s, "train_s": train_s,
        "s_per_tree": train_s / rounds,
        "plain_s_per_tree": plain_train_s / plain_rounds,
        "plain_rounds": plain_rounds,
        "timed_s_per_tree": timed_s / rounds,
        "breakdown_s_per_tree": per_tree,
        "tree_device_ms": in_tree,
        "trees_per_iteration": K,
        **({"valid_auc": auc, "valid_logloss": ll}
           if falling == "binary_logloss" else
           {"valid_" + m: evals["valid"][m] for m in (falling, rising)
            if m}),
        "launches": launches,
        "launches_per_tree": {k: v / rounds for k, v in launches.items()},
        **graph, **extra,
        "b5_launches_by_mode": modes,
        "rounds_per_tree": [len(r) for r in rounds_log],
        "rollbacks_per_tree": [sum(m < k for k, m in r) for r in rounds_log],
        "predict_max_abs_err_vs_host_f64": pred_err,
        "checked": ("model text byte-identical to the plain run"
                    if plain_rounds == rounds else
                    f"first {plain_rounds} iterations' trees byte-identical "
                    "to the plain run")}}


def eager_and_chunk(lt, ds, vs, params, rounds, text, graph_s) -> dict:
    """Seconds a tree of the eager fixed-shape body (no graph, no
    section timer) beside the graph run's, trees byte-identical; then
    ``update_chunk(8)`` against eight ``update()`` calls of fresh
    boosters, model text equal."""
    from lightgbm_tpu_torch import grower_rounds
    bst_e = lt.Booster(params, train_set=ds)
    bst_e.add_valid(vs, "valid")
    grower_rounds.USE_GRAPHS = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for _ in range(rounds):
            bst_e.update()
        torch.cuda.synchronize()
    finally:
        grower_rounds.USE_GRAPHS = True
    eager_s = time.perf_counter() - t0
    if (bst_e.model_to_string().partition("end of trees")[0]
            != text.partition("end of trees")[0]):
        raise AssertionError("the eager run's trees differ from the graph "
                             "run's")
    del bst_e
    # fresh boosters (each captures its graph in its first tree), in the
    # order A B B A: host clocks spread between calls
    out = {"updates": [], "update_chunk": []}
    texts = set()
    for name in ("updates", "update_chunk", "update_chunk", "updates"):
        b = lt.Booster(params, train_set=ds)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "updates":
            for _ in range(CHUNK):
                b.update()
        else:
            b.update_chunk(CHUNK)
        torch.cuda.synchronize()
        out[name].append(time.perf_counter() - t0)
        used_graph(b)
        texts.add(b.model_to_string())
        del b
    if len(texts) != 1:
        raise AssertionError(f"update_chunk({CHUNK}) differs from "
                             f"{CHUNK} update() calls")
    return {"eager_s_per_tree": eager_s / rounds,
            "graph_s_per_tree": graph_s / rounds,
            f"update_x{CHUNK}_s": out["updates"],
            f"update_chunk_{CHUNK}_s": out["update_chunk"]}


F32_ENTRIES = ("fused_frontier_splits", "fused_frontier_accumulate",
               "fused_sibling_scan", "fused_slot_order")
INT8_ENTRIES = tuple(name + "_int8" for name in F32_ENTRIES)


def expect_launches(launches: dict, positive=(), zero=(), exact=None):
    # B4 sorts the rows before every accumulate, and the training path
    # runs the sort nowhere else
    for mode in ("", "_int8"):
        if (launches["fused_slot_order" + mode]
                != launches["fused_frontier_accumulate" + mode]):
            raise AssertionError(f"B4{mode}: {launches} sorts for "
                                 "accumulates")
    for name in positive:
        if launches[name] <= 0:
            raise AssertionError(f"the training path never launched {name}")
    for name in zero:
        if launches[name] != 0:
            raise AssertionError(f"{name} launched {launches[name]} times; "
                                 "this path must not launch it")
    for name, n in (exact or {}).items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times, "
                                 f"not {n}")


def phase_train(lt):
    """The training path on the card; returns (launches, datasets, raw
    train matrix, booster)."""
    from lightgbm_tpu_torch.testing import higgs_like
    X, y = higgs_like(TRAIN_ROWS, seed=11)
    Xv, yv = higgs_like(VALID_ROWS, seed=12)
    r = training_runs(lt, X, y, Xv, yv, TRAIN_PARAMS, TRAIN_ROUNDS,
                      extras=True)
    # the fused arm: B4 roots, B2 (B4 + B5) rounds, no B6
    expect_launches(r["launches"], positive=("ingest",) + F32_ENTRIES,
                    zero=("histogram_pallas",) + INT8_ENTRIES)
    emit({"phase": "train", **r["row"]})
    return r, (X, y, Xv, yv)


def edge_rows(ds, F: int, X) -> np.ndarray:
    """Rows at every bin bound of every feature (the f32 nearest the
    bound and its two neighbours), plus NaN, +-inf, +-1e30, denormals
    and the salted rows of ``ops.ingest.salt_rows``."""
    from lightgbm_tpu_torch.ops.ingest import salt_rows
    cols = []
    for f in range(F):
        ub = np.asarray(ds.bin_mappers[f].bin_upper_bound, np.float64)
        ub = ub[np.isfinite(ub)].astype(np.float32)
        cols.append(np.concatenate([
            ub, np.nextafter(ub, np.float32(np.inf)),
            np.nextafter(ub, np.float32(-np.inf))]))
    width = max(len(c) for c in cols)
    grid = np.zeros((width, F), np.float32)
    for f, c in enumerate(cols):
        grid[:len(c), f] = c
    special = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 1e-40, -1e-40,
                        1e-45, 0.0, -0.0], np.float32)
    spec = np.repeat(special[:, None], F, axis=1)
    return np.concatenate([salt_rows(F, X), spec, grid]).astype(np.float32)


def phase_ingest(ds, X):
    """B3 against the host oracle ``Dataset._bin_block`` at the training
    shape plus edge rows, byte for byte; its times."""
    from lightgbm_tpu_torch.ops import ingest as ING
    n, F = X.shape
    tables = ING.build_ingest_tables(ds)
    binner = ING.DeviceBinner(tables, "cuda")
    Xc = np.concatenate([X, edge_rows(ds, F, X)])
    got = binner(torch.from_numpy(Xc).cuda()).cpu().numpy()
    ref = np.zeros((Xc.shape[0], tables.num_groups), tables.out_dtype)
    with np.errstate(invalid="ignore", over="ignore"):
        ds._bin_block(Xc.astype(np.float64), ref)
    if not np.array_equal(got.T, ref):
        bad = int((got.T != ref).sum())
        raise AssertionError(f"binned bytes differ from _bin_block at {bad} "
                             "entries")
    Xt = torch.from_numpy(X).cuda()
    plain_out = binner.plain(Xt)
    max_err = max_abs_err(binner(Xt), plain_out)
    if max_err != 0.0:
        raise AssertionError(f"B3 differs from its plain version by {max_err} "
                             "bins")
    del plain_out
    layouts = ingest_layouts(ING, tables, Xc[-100_003:], ref[-100_003:])
    cols = [s.column for s in tables.specs if not s.is_cat]
    XT = Xt[:, cols].T.contiguous()
    bw = tables.bounds.shape[1]
    row = {"phase": "ingest", "rows": n, "features": F,
           "groups": tables.num_groups, "checked_rows": int(Xc.shape[0]),
           "checked": "byte-identical to _bin_block", "max_abs_err": max_err,
           "plan": {"tile_rows": binner.kernel_state().plan.tile_rows,
                    "chunks": binner.kernel_state().plan.num_chunks,
                    "smem_bytes": binner.kernel_state().plan.smem_bytes,
                    "blocks": ING.planner.ingest_grid(
                        binner.kernel_state().plan, n)},
           "layouts": layouts,
           "kernel_ms": graph_ms(lambda: binner(Xt), 20),
           "plain_ms": event_ms(lambda: binner.plain(Xt), 3, warmup=1),
           "library_ms": event_ms(
               lambda: torch.searchsorted(binner.bounds, XT), 20),
           **cost_bound("B3", rows=n, columns=F, groups=tables.num_groups,
                        steps_per_row=ingest_steps_per_row(
                            tables.num_groups, bw))}
    emit(row)
    return row


def ingest_layouts(ING, tables, Xc, ref) -> list:
    """B3 byte for byte against ``_bin_block``'s ``ref`` where the kernel
    takes its other paths: X at an address that is not 16-byte aligned
    (scalar loads, and a row count that leaves ragged output words), and
    tables cut into several group chunks (a small table budget)."""
    from lightgbm_tpu_torch.ops import planner
    n, F = Xc.shape
    buf = torch.empty(n * F + 1, dtype=torch.float32, device="cuda")
    buf[1:] = torch.from_numpy(Xc).cuda().flatten()
    saved = planner.INGEST_TABLE_BYTES
    done = []
    try:
        for name, X, budget in (
                ("misaligned", buf[1:].view(n, F), saved),
                ("group_chunks", torch.from_numpy(Xc).cuda(), 4096)):
            planner.INGEST_TABLE_BYTES = budget
            binner = ING.DeviceBinner(tables, "cuda")
            got = binner(X).cpu().numpy()
            if not np.array_equal(got.T, ref):
                raise AssertionError(f"B3 ({name}) differs from _bin_block")
            done.append({"layout": name, "rows": n, "chunks":
                         binner.kernel_state().plan.num_chunks})
    finally:
        planner.INGEST_TABLE_BYTES = saved
    return done


def phase_hist(ds, bst):
    """B4, B2 and B5 against their plain versions at one frontier level
    of the training run (K = 128 slots, about half the rows slotted, the
    run's gradients after its last round); their times.  B4 and its sort
    also at a root and a deep round (``b4_shapes``) and on the edge cases
    of ``b4_edge_cases``.  Kernels are
    timed from CUDA graphs; the plain versions and the library call sync
    with the host (``nonzero``, ``bincount``) and cannot be captured, so
    they are timed by CUDA events over back-to-back calls."""
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (_vals_t, accumulate_plain,
                                                  fixed_point_scales)
    from lightgbm_tpu_torch.ops.split import fixed_to_f32
    gb = bst.boosting
    binned_t = ds.binned_t
    F, n = binned_t.shape
    K, B = HIST_SLOTS, gb.num_bins
    hp = gb.grower_cfg.hp
    mt = gb.meta_t
    nb, mty, db = mt["num_bin"], mt["missing_type"], mt["default_bin"]
    plan = fused.scan_tasks(gb.meta.num_bin, B, "cuda")
    grad, hess = gb.objective.get_gradients(gb.train_score[0])
    vals = _vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = fixed_point_scales(vals)
    g = torch.Generator(device="cuda").manual_seed(5)
    r = torch.rand(n, device="cuda", generator=g)
    pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    other = torch.randint(0, K, (n,), device="cuda", generator=g,
                          dtype=torch.int32)
    slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    parent = accumulate_plain(binned_t, vals, torch.where(r < 0.5, pick,
                                                          other), K, B,
                              scales)
    small_left = torch.rand(K, device="cuda", generator=g) < 0.5

    small = fused.accumulate(binned_t, vals, slot, K, B, scales)
    small_p = accumulate_plain(binned_t, vals, slot, K, B, scales)
    if not torch.equal(small, small_p):
        raise AssertionError("B4 differs from its plain version")
    # in value units: each channel's fixed-point difference times 2**-s
    err_b4 = max(max_abs_err(small[:, c], small_p[:, c]) * 2.0 ** -scales[c]
                 for c in range(3))
    del small_p
    children = fused.derive_children(small, small_left, parent)
    sums = torch.stack([fixed_to_f32(children[:, c, 0].sum(-1),
                                     [scales[c]], 0) for c in range(3)])

    def same(a, b):
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if x.dtype == torch.float32:
                x, y = x.view(torch.int32), y.view(torch.int32)
            if not torch.equal(x, y):
                return False
        return True

    def b5():
        return fused.sibling_scan(small, scales, sums, nb, mty, db, hp,
                                  small_left=small_left, parent=parent,
                                  plan=plan)

    def b5_plain():
        return fused.scan_plain(small, scales, sums, nb, mty, db, hp,
                                small_left=small_left, parent=parent)

    def b2():
        return fused.frontier_splits(binned_t, vals, slot, K, B, scales,
                                     sums, small_left, parent, nb, mty, db,
                                     hp, plan=plan)

    def b2_plain():
        seg = accumulate_plain(binned_t, vals, slot, K, B, scales)
        return seg, fused.scan_plain(seg, scales, sums, nb, mty, db, hp,
                                     small_left=small_left, parent=parent)

    best_k5, best_p5 = b5(), b5_plain()
    if not same(best_k5, best_p5):
        raise AssertionError("B5 differs from its plain version in bits")
    err_b5 = max_abs_err(best_k5, best_p5)
    seg_k, best_k = b2()
    seg_p, best_p = b2_plain()
    if not (torch.equal(seg_k, seg_p) and same(best_k, best_p)):
        raise AssertionError("B2 differs from its plain version in bits")
    err_b2 = max(max_abs_err(best_k, best_p),
                 *(max_abs_err(seg_k[:, c], seg_p[:, c]) * 2.0 ** -scales[c]
                   for c in range(3)))
    del seg_k, seg_p
    torch.cuda.synchronize()

    m = int((slot < K).sum())
    scan = cost_bound("B5", children=2 * K, features=F, bins=B)
    shapes = b4_shapes(fused, accumulate_plain, binned_t, vals, scales, B,
                       slot, seed=7)
    acc = shapes["frontier"]
    pair = cost_bound("B2", rows=n, features=F, bins=B, slots=K,
                      slotted_rows=m)
    edges = b4_edge_cases(fused, accumulate_plain, binned_t, vals, scales, B)
    modes = b5_mode_rows(fused, small, scales, sums, nb, mty, db, hp,
                         small_left, parent, plan, quant=False)
    rows_out = {
        "fused_frontier_accumulate": dict(acc, max_abs_err=err_b4),
        "fused_slot_order": slot_order_row(fused, slot, K, vals, scales),
        "fused_sibling_scan": {
            "kernel_ms": graph_ms(b5, 10),
            "plain_ms": event_ms(b5_plain, 2, warmup=1),
            "library_ms": None, "max_abs_err": err_b5, **scan},
        "fused_frontier_splits": {
            "kernel_ms": graph_ms(b2, 10),
            "plain_ms": event_ms(b2_plain, 2, warmup=1),
            "library_ms": None, "max_abs_err": err_b2, **pair},
    }
    emit({"phase": "hist", "rows": n, "features": F, "bins": B, "slots": K,
          "slotted_rows": m, "scales": list(scales),
          "checked": "bit-identical to the plain versions",
          "b4_shapes": shapes, "b4_edge_cases": edges,
          "b5_modes": modes, **{k: v for k, v in rows_out.items()}})
    return dict(rows_out, b5_modes=modes, frontier_slot=slot)


# B4's frontier shapes besides the training run's level (K = 128 with
# about half the rows slotted): a root (one slot holding every row) and a
# deep round (K = 128, about 5% of the rows slotted)
B4_SHAPES = (("root", 1, 1.0), ("deep", HIST_SLOTS, 0.05))


def b4_shapes(fused, accumulate_plain, binned_t, vals, scales, B, slot,
              seed):
    """B4 (sort + accumulate) at the frontier shape (``slot``, K =
    ``HIST_SLOTS``) and at ``B4_SHAPES``: each equal to
    ``accumulate_plain`` and its sort to ``slot_order_plain`` and
    ``sorted_values_plain`` (``torch.equal``), then the kernel's time
    from a CUDA graph, the plain version's and ``torch.bincount`` x C
    (one call per channel over the flattened (slot, feature, bin) index
    of the slotted rows, the levels as f32 weights in int8 mode: exact,
    sums below 2**24)."""
    F, n = binned_t.shape
    quant = vals.dtype == torch.int8
    C = 2 if quant else 3
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, K, frac in (("frontier", HIST_SLOTS, None),) + B4_SHAPES:
        if frac is not None:
            r = torch.rand(n, device="cuda", generator=g)
            pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                                 dtype=torch.int32)
            slot = torch.where(r < frac, pick, torch.full_like(pick, K))
        got = fused.accumulate(binned_t, vals, slot, K, B, scales)
        want = accumulate_plain(binned_t, vals, slot, K, B, scales)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B4 differs from its plain version at the "
                                 f"{name} shape")
        del got, want
        sort_vs_plain(fused, slot, K, vals, scales, f"the {name} shape")
        rows = torch.nonzero(slot < K).flatten()
        m = int(rows.numel())
        idx = ((slot[rows].to(torch.int64)[None, :] * F
                + torch.arange(F, device="cuda")[:, None]) * B
               + binned_t[:, rows].to(torch.int64)).flatten()
        wts = [vals[c, rows].float()[None, :].expand(F, -1).flatten()
               .contiguous() for c in range(C)]

        def library():
            for w in wts:
                torch.bincount(idx, weights=w, minlength=K * F * B)

        out[name] = {
            "slots": K, "slotted_rows": m,
            "kernel_ms": graph_ms(lambda: fused.accumulate(
                binned_t, vals, slot, K, B, scales), 10),
            "plain_ms": event_ms(lambda: accumulate_plain(
                binned_t, vals, slot, K, B, scales), 2, warmup=1),
            "library_ms": event_ms(library, 5),
            "sort_ms": graph_ms(lambda: fused._slot_order_cuda(
                slot, K, vals, scales), 10),
            **cost_bound("B4", rows=n, features=F, bins=B, slots=K,
                         slotted_rows=m, quant=quant,
                         bin_bytes=binned_t.element_size())}
        del idx, wts
    return out


def sort_vs_plain(fused, slot, K, vals, scales, where) -> float:
    """B4's sort as the path runs it (``_slot_order_cuda``: order,
    offsets and the slotted rows' values in sorted order) against
    ``slot_order_plain`` and ``sorted_values_plain``: raises unless all
    three are equal; returns the largest |difference| over them."""
    order, meta, sv = fused._slot_order_cuda(slot, K, vals, scales)
    p_order, p_offsets = fused.slot_order_plain(slot, K)
    p_sv = fused.sorted_values_plain(vals, p_order, p_offsets, scales)
    pairs = ((order, p_order), (meta[:K + 1], p_offsets),
             (sv[:p_sv.shape[0]], p_sv))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"B4's sort differs from its plain version at "
                             f"{where}")
    return max(float((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0.0 for a, b in pairs)


def slot_order_row(fused, slot, K, vals, scales):
    """B4's sort at the frontier shape, the variant the path runs (it
    lays out the slotted rows' values too): held to its plain version,
    its time from a CUDA graph and the plain version's.  No one PyTorch
    call computes it; ``torch.argsort(stable=True)`` gives the order
    alone (``argsort_order_only_ms``)."""
    n = slot.shape[0]
    err = sort_vs_plain(fused, slot, K, vals, scales, "the frontier shape")
    m = int((slot < K).sum())

    def plain():
        order, offsets = fused.slot_order_plain(slot, K)
        return fused.sorted_values_plain(vals, order, offsets, scales)

    return {"kernel_ms": graph_ms(lambda: fused._slot_order_cuda(
                slot, K, vals, scales), 10),
            "plain_ms": event_ms(plain, 5),
            "library_ms": None,
            "argsort_order_only_ms": event_ms(
                lambda: torch.argsort(slot, stable=True), 5),
            "max_abs_err": err, "slotted_rows": m,
            **cost_bound("B4_sort", rows=n, slots=K, slotted_rows=m,
                         quant=vals.dtype == torch.int8)}


def b4_edge_cases(fused, accumulate_plain, binned_t, vals, scales, B):
    """B4 against its plain version on the card where the sort has
    nothing or little to do: every row dropped, and slots left empty."""
    n = binned_t.shape[1]
    K = HIST_SLOTS
    g = torch.Generator(device="cuda").manual_seed(9)
    pick = torch.randint(0, K // 8, (n,), device="cuda", generator=g,
                         dtype=torch.int32) * 8      # 7 of 8 slots empty
    cases = {"all_dropped": torch.full((n,), K, dtype=torch.int32,
                                       device="cuda"),
             "empty_slots": pick}
    for name, slot in cases.items():
        got = fused.accumulate(binned_t, vals, slot, K, B, scales)
        want = accumulate_plain(binned_t, vals, slot, K, B, scales)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B4 differs from its plain version: {name}")
        sort_vs_plain(fused, slot, K, vals, scales, name)
        if name == "all_dropped" and bool(got.any()):
            raise AssertionError("B4 summed dropped rows")
    return {"cases": sorted(cases), "checked": "equal to the plain version"}


def phase_wide_bins(lt):
    """Groups of more than 256 bins (``max_bin=1023``): B3 writes int32,
    B4 reads it, B5 scans 1023 bins.  B3 against ``_bin_block`` byte for
    byte, and a short training run against its plain-version twin, model
    text byte for byte."""
    from lightgbm_tpu_torch.testing import higgs_like
    X, y = higgs_like(WIDE_ROWS, seed=13)
    X[::97, 3] = np.nan

    def run():
        ds = lt.Dataset(X, label=y,
                        params={"max_bin": WIDE_PARAMS["max_bin"]})
        bst = lt.train(WIDE_PARAMS, ds, WIDE_ROUNDS, verbose_eval=False)
        return ds, bst

    ds, bst = run()
    used_graph(bst)
    text = bst.model_to_string()
    del bst
    if ds.binned_t.dtype != torch.int32:
        raise AssertionError(f"wide groups binned as {ds.binned_t.dtype}")
    ref = np.zeros((WIDE_ROWS, ds.num_groups), ds.binned_dtype())
    ds._bin_block(X.astype(np.float64), ref)
    if not np.array_equal(ds.binned_t.cpu().numpy().T, ref):
        raise AssertionError("wide-bin binned matrix differs from "
                             "_bin_block")
    saved = plain_kernels()
    try:
        text_p = run()[1].model_to_string()
    finally:
        restore_kernels(saved)
    if text != text_p:
        raise AssertionError("wide-bin model text differs from the "
                             "plain-version run")
    B = int(ds.feature_meta().max_num_bin)
    emit({"phase": "wide_bins", "rows": WIDE_ROWS, "max_num_bin": B,
          "binned": str(ds.binned_t.dtype), "rounds": WIDE_ROUNDS,
          "b4_int32_bins": b4_wide_bins(ds.binned_t, B),
          "checked": "binned bytes equal _bin_block; model text "
                     "byte-identical to the plain run; B4 on int32 bins "
                     "equal to its plain version"})


def b4_wide_bins(binned_t, B) -> dict:
    """B4 on the int32 binned matrix of ``max_bin=1023`` in both modes
    (f32 values at their fixed-point scales, int8 levels), K = 64 with
    about half the rows slotted, against its plain version."""
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (accumulate_plain,
                                                  fixed_point_scales)
    n = binned_t.shape[1]
    K = 64
    g = torch.Generator(device="cuda").manual_seed(10)
    r = torch.rand(n, device="cuda", generator=g)
    pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    vals = torch.randn((3, n), device="cuda", generator=g)
    vals[2] = 1.0
    levels = torch.randint(-31, 32, (2, n), device="cuda", generator=g,
                           dtype=torch.int32).to(torch.int8)
    out = {}
    for mode, v, sc in (("f32", vals, fixed_point_scales(vals)),
                        ("int8", levels, None)):
        got = fused.accumulate(binned_t, v, slot, K, B, sc)
        want = accumulate_plain(binned_t, v, slot, K, B, sc)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B4 ({mode}) differs from its plain "
                                 f"version on int32 bins")
        out[mode] = {"kernel_ms": graph_ms(
            lambda: fused.accumulate(binned_t, v, slot, K, B, sc), 5)}
    return {"slots": K, "bins": B, **out}


def predict_vs_plain(pk, bst, Xv) -> int:
    """``Booster.predict`` of the valid rows through B1 (scores mode),
    bit for bit against B1's plain version; returns the B1 launches of
    that call."""
    K = bst.num_tree_per_iteration
    pk.reset_launch_counts()
    raw = bst.predict(Xv, raw_score=True)
    launches = pk.launch_counts[KERNEL]
    forest = bst._forest(0, len(bst.models) // K)
    dev = bst._device_forest(forest)
    plain = pk.traverse_plain(dev, torch.from_numpy(
        np.ascontiguousarray(Xv, np.float32)).cuda(), K, emit_scores=True)
    plain = plain.cpu().numpy().astype(np.float64)
    plain = plain[0] if K == 1 else np.ascontiguousarray(plain.T)
    if not np.array_equal(raw.view(np.uint64), plain.view(np.uint64)):
        raise AssertionError("Booster.predict differs from B1's plain version")
    if launches <= 0:
        raise AssertionError("Booster.predict never launched B1")
    return launches


def oracle_check(ds, X) -> int:
    """B3 against the host oracle ``Dataset._bin_block`` on the dataset's
    own layout (EFB groups, categorical codes): ``X`` plus the edge rows
    (bin bounds, salted rows, every category code and its neighbours),
    byte for byte; returns the rows checked."""
    from lightgbm_tpu_torch.ops import ingest as ING
    F = X.shape[1]
    edge = [edge_rows(ds, F, X)]
    for f in ds.used_features:
        codes = np.asarray(ds.bin_mappers[f].bin_2_categorical, np.float64)
        if codes.size:
            vals = np.concatenate([codes, codes + 0.4, codes - 0.4,
                                   [codes.max() + 1.0, -1.0, -2.0]])
            block = np.repeat(X[:1], vals.size, axis=0)
            block[:, f] = vals.astype(np.float32)
            edge.append(block)
    tables = ING.build_ingest_tables(ds)
    binner = ING.DeviceBinner(tables, "cuda")
    Xc = np.concatenate([X] + edge).astype(np.float32)
    got = binner(torch.from_numpy(Xc).cuda()).cpu().numpy()
    ref = np.zeros((Xc.shape[0], tables.num_groups), tables.out_dtype)
    with np.errstate(invalid="ignore", over="ignore"):
        ds._bin_block(Xc.astype(np.float64), ref)
    if not np.array_equal(got.T, ref):
        bad = int((got.T != ref).sum())
        raise AssertionError(f"binned bytes differ from _bin_block at {bad} "
                             "entries")
    return int(Xc.shape[0])


def b3_at(ds, X) -> dict:
    """B3 at a training phase's own shape, the whole train matrix: equal
    to its plain version, its launches a binning, its time from a CUDA
    graph, the plain version's, one ``torch.searchsorted`` over the
    numerical columns, and the bound (the columns B3 reads once, the bins
    once; a descent of h + 4 steps per (row, member)); beside them the
    host's parts of a Dataset's binning: the ragged tables and plan
    (``kernel_state``) and the copy of X to the card."""
    from lightgbm_tpu_torch.ops import ingest as ING
    n, F = X.shape
    tables = ING.build_ingest_tables(ds)
    binner = ING.DeviceBinner(tables, "cuda")
    t0 = time.perf_counter()
    state = binner.kernel_state()
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Xt = torch.from_numpy(X).cuda()
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    ING.reset_launch_counts()
    got = binner(Xt)
    per_binning = ING.launch_counts["ingest"]
    err = max_abs_err(got, binner.plain(Xt))
    if err != 0.0:
        raise AssertionError(f"B3 differs from its plain version by {err} "
                             "bins")
    del got
    cols = [s.column for s in tables.specs if not s.is_cat]
    XT = Xt[:, cols].T.contiguous()
    depth = int(state.members[:, 5].sum()) + 4 * len(tables.specs)
    read = len({s.column for s in tables.specs})     # columns B3 reads
    plan = state.plan
    row = {"rows": n, "features": F, "used_features": len(tables.specs),
           "groups": tables.num_groups,
           "plan": {"tile_rows": plan.tile_rows,
                    "whole_rows": plan.whole_rows,
                    "launches": len(plan.launches),
                    "chunks": plan.num_chunks,
                    "largest_chunk_columns": max(
                        c[7] - c[6] for launch in plan.launches
                        for c in launch),
                    "smem_bytes": plan.smem_bytes, "threads": plan.threads,
                    "blocks": [ING.planner.ingest_grid(plan, n, j)
                               for j in range(len(plan.launches))]},
           "launches_per_binning": per_binning,
           "kernel_ms": graph_ms(lambda: binner(Xt), 5),
           "plain_ms": event_ms(lambda: binner.plain(Xt), 1, warmup=1),
           "library_ms": event_ms(
               lambda: torch.searchsorted(binner.bounds, XT), 5),
           "max_abs_err": err, "host_tables_s": tables_s,
           "host_copy_x_s": copy_s,
           **cost_bound("B3", rows=n, columns=read,
                        groups=tables.num_groups, steps_per_row=depth,
                        out_bytes=(1 if ING.device_dtype(tables)
                                   == torch.uint8 else 4))}
    del Xt, XT
    return row


def phase_efb_train(lt, pk):
    """``airline_onehot_1m``: the airline table one-hot encoded (674 f32
    features, EFB bundles) trained on the staged arm: B3's EFB fold, B6
    for each root, B4 segment histograms, the int64 expansion and B5 in
    leaf mode.  Returns (launches, dataset, booster)."""
    from lightgbm_tpu_torch.testing import airline_like, one_hot
    X8, y = airline_like(EFB_ROWS, seed=11)
    Xv8, yv = airline_like(EFB_VALID_ROWS, seed=12)
    X, Xv = one_hot(X8), one_hot(Xv8)
    del X8, Xv8
    r = training_runs(lt, X, y, Xv, yv, TRAIN_PARAMS, TRAIN_ROUNDS,
                      plain_rounds=PLAIN_SHORT_ROUNDS)
    ds = r["ds"]
    if not ds.feature_meta().has_bundles:
        raise AssertionError("the one-hot table did not bundle")
    # B5 reads the group histograms; nothing is expanded (no categorical
    # column)
    seen = r["row"]["tree_device_ms"]
    if (seen["expand_groups_calls"] != 0
            or seen["b5_on_group_histograms"]
            != sum(seen["b5_launches_by_mode"].values())):
        raise AssertionError(f"the staged search expanded histograms or "
                             f"scanned expanded ones: {seen}")
    expect_launches(r["launches"], positive=(
        "fused_frontier_accumulate", "fused_sibling_scan",
        "fused_slot_order"), zero=("fused_frontier_splits",) + INT8_ENTRIES,
        exact={"histogram_pallas": TRAIN_ROUNDS, "ingest": 2})
    checked = oracle_check(ds, X[:EFB_ORACLE_ROWS])
    b3 = b3_at(ds, X)
    b1 = predict_vs_plain(pk, r["bst"], Xv)
    emit({"phase": "efb_train", "config": "airline_onehot_1m", **r["row"],
          "b3": b3,
          "used_features": len(ds.used_features), "groups": ds.num_groups,
          "max_group_bin": int(ds.max_group_bin),
          "max_num_bin": int(ds.feature_meta().max_num_bin),
          "b3_oracle_rows": checked, "predict_b1_launches": b1,
          "predict": "bit-identical to B1's plain version"})
    return (dict(r["launches"], b5_modes=r["row"]["b5_launches_by_mode"]),
            ds, r["bst"])


def phase_cat_train(lt, pk):
    """``airline_cat_1m``: the same table with its six categorical
    columns as native ``categorical_feature`` (8 features, no bundles) on
    the fused arm with the categorical merge, and B3's categorical
    branch; then B5 at the run's own shape (``b5_run_row``).  Returns
    (launches, B5's launches by mode, the B5 row)."""
    from lightgbm_tpu_torch.testing import AIRLINE_CATEGORICAL, airline_like
    X, y = airline_like(EFB_ROWS, seed=11)
    Xv, yv = airline_like(EFB_VALID_ROWS, seed=12)
    r = training_runs(lt, X, y, Xv, yv, TRAIN_PARAMS, TRAIN_ROUNDS,
                      categorical=list(AIRLINE_CATEGORICAL),
                      plain_rounds=PLAIN_SHORT_ROUNDS)
    ds = r["ds"]
    meta = ds.feature_meta()
    if meta.has_bundles or int(meta.is_categorical.sum()) != 6:
        raise AssertionError("the categorical table is not 6 categorical "
                             "features without bundles")
    expect_launches(r["launches"], positive=F32_ENTRIES,
                    zero=("histogram_pallas",) + INT8_ENTRIES,
                    exact={"ingest": 2})
    checked = oracle_check(ds, X)
    b1 = predict_vs_plain(pk, r["bst"], Xv)
    cat_splits = sum(int((m.decision_type[:m.num_leaves - 1] & 1).sum())
                     for m in r["bst"].models)
    if cat_splits == 0:
        raise AssertionError("no categorical split was made")
    ks = sorted(k for tree in r["rounds_log"] for k, _ in tree)
    b5 = b5_run_row(ds, r["bst"], ks[len(ks) // 2])
    emit({"phase": "cat_train", "config": "airline_cat_1m", **r["row"],
          "num_bin": meta.num_bin.tolist(), "categorical_splits": cat_splits,
          "b3_oracle_rows": checked, "predict_b1_launches": b1,
          "predict": "bit-identical to B1's plain version",
          "b5_at_this_shape": b5})
    return r["launches"], r["row"]["b5_launches_by_mode"], b5


def b5_run_row(ds, bst, K: int) -> dict:
    """B5 in parent mode (B2's scan half) at a fused-arm training run's
    shape (``cat_train``, ``rank_train``): K candidates (the run's median
    round), the run's features at their own bin counts, the run's last
    gradients and random slots (about half the rows slotted); bit for bit
    against its plain version, its time
    (CUDA graph), the plain version's (CUDA events) and its bound: each
    feature's walked bins of the smaller children and of the parents,
    once."""
    from lightgbm_tpu_torch.ops import fused, planner
    from lightgbm_tpu_torch.ops.histogram import (_vals_t, accumulate_plain,
                                                  fixed_point_scales)
    from lightgbm_tpu_torch.ops.split import fixed_to_f32
    gb = bst.boosting
    binned_t = ds.binned_t
    F, n = binned_t.shape
    B = gb.num_bins
    hp = gb.grower_cfg.hp
    mt = gb.meta_t
    nb, mty, db = mt["num_bin"], mt["missing_type"], mt["default_bin"]
    plan = fused.scan_tasks(gb.meta.num_bin, B, "cuda")
    grad, hess = gb.objective.get_gradients(gb.train_score[0])
    vals = _vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = fixed_point_scales(vals)
    g = torch.Generator(device="cuda").manual_seed(12)
    r = torch.rand(n, device="cuda", generator=g)
    pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    other = torch.randint(0, K, (n,), device="cuda", generator=g,
                          dtype=torch.int32)
    slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    parent = accumulate_plain(binned_t, vals, torch.where(r < 0.5, pick,
                                                          other), K, B,
                              scales)
    small = accumulate_plain(binned_t, vals, slot, K, B, scales)
    small_left = torch.rand(K, device="cuda", generator=g) < 0.5
    children = fused.derive_children(small, small_left, parent)
    sums = torch.stack([fixed_to_f32(children[:, c, 0].sum(-1),
                                     [scales[c]], 0) for c in range(3)])
    del children

    def k():
        return fused.sibling_scan(small, scales, sums, nb, mty, db, hp,
                                  small_left=small_left, parent=parent,
                                  plan=plan)

    def p():
        return fused.scan_plain(small, scales, sums, nb, mty, db, hp,
                                small_left=small_left, parent=parent)
    best_k, best_p = k(), p()
    if not same_bits(best_k, best_p):
        raise AssertionError("B5 (a run's shape) differs from its plain "
                             "version in bits")
    if not bool(torch.isfinite(best_k.gain).any()):
        raise AssertionError("B5 (a run's shape) found no split")
    NC = 2 * K
    walked = sum(planner.scan_walked_bins(x, B) for x in gb.meta.num_bin)
    return {"candidates": K, "children": NC, "features": F, "bins": B,
            "walked_bins": walked, "tasks": plan.numel() // 32,
            "checked": "bit-identical to the plain version",
            "max_abs_err": max_abs_err(best_k, best_p),
            "kernel_ms": graph_ms(k, 50),
            "plain_ms": event_ms(p, 5, warmup=1), "library_ms": None,
            **cost_bound("B5", children=NC, features=F, cells=walked,
                         plan_entries=plan.numel())}


def phase_hist6(ds, bst, config: str):
    """B6 against its plain version, bit for bit on int64, on a training
    run's binned matrix (``efb_train``'s 9 EFB group columns; the
    ``higgs_rand_1m`` root's 28 uint8 features, no bundles) with the
    first tree's gradients; its time from a CUDA graph, its bound and
    ``torch.bincount`` x 3."""
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops import planner
    gb = bst.boosting
    binned_t = ds.binned_t
    G, n = binned_t.shape
    Bg = int(ds.max_group_bin)
    init = float(np.float32(gb.init_scores[0]))
    grad, hess = gb.objective.get_gradients(
        torch.full((n,), init, dtype=torch.float32, device="cuda"))
    vals = H._vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = H.fixed_point_scales(vals)
    got = H.histogram_fixed(binned_t, vals, Bg, scales)
    want = H.histogram_plain(binned_t, vals, Bg, scales)
    if not torch.equal(got, want):
        raise AssertionError("B6 differs from its plain version")
    err = max(max_abs_err(got[c], want[c]) * 2.0 ** -scales[c]
              for c in range(3))
    del got, want
    # the kernel's other loads, bit for bit: a row count that is not a
    # multiple of 4 (scalar loads) and int32 bins (int4 loads), each
    # both ways
    also = []
    m = n - 1 if (n - 1) % 4 else n - 2
    ragged = (binned_t[:, :m].contiguous(), vals[:, :m].contiguous())
    for label, b, v in ((f"{binned_t.dtype}, {m} rows", *ragged),
                        (f"int32, {n} rows", binned_t.int(), vals),
                        (f"int32, {m} rows", ragged[0].int(), ragged[1])):
        got = H.histogram_fixed(b, v, Bg, scales)
        want = H.histogram_plain(b, v, Bg, scales)
        if not torch.equal(got, want):
            raise AssertionError(f"B6 differs from its plain version "
                                 f"({label})")
        err = max(err, *(max_abs_err(got[c], want[c]) * 2.0 ** -scales[c]
                         for c in range(3)))
        also.append(label)
        del got, want, b, v
    del ragged
    idx = (torch.arange(G, device="cuda")[:, None] * Bg
           + binned_t.to(torch.int64)).flatten()
    wts = [vals[c][None, :].expand(G, -1).flatten().contiguous()
           for c in range(3)]

    def library():
        for w in wts:
            torch.bincount(idx, weights=w, minlength=G * Bg)

    row = {"phase": "hist6", "config": config, "rows": n, "groups": G,
           "group_bins": Bg, "feat_tile": planner.hist_feat_tile(G, Bg),
           "scales": list(scales), "max_abs_err": err,
           "checked": "bit-identical to the plain version (int64)",
           "also_checked": also,
           "kernel_ms": graph_ms(
               lambda: H.histogram_fixed(binned_t, vals, Bg, scales), 20),
           "plain_ms": event_ms(
               lambda: H.histogram_plain(binned_t, vals, Bg, scales), 3,
               warmup=1),
           "library_ms": event_ms(library, 5),
           **cost_bound("B6", rows=n, features=G, bins=Bg,
                        bin_bytes=binned_t.element_size())}
    emit(row)
    return row


def same_bits(a, b) -> bool:
    """Two ``NumericFeatureBest`` tuples equal bit for bit."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def quant_check(gb, score, it) -> dict:
    """Quantization on the card against the CPU port, for the gradients
    at ``score`` with the booster's key of iteration ``it``: levels and
    scales must be the same bits (PyTorch's CUDA division by a CPU
    scalar multiplies by the reciprocal, so the scales stay device
    tensors; ``rows_differing_under_cpu_scalar_division`` counts the
    rows whose ``g / scale`` that would have changed)."""
    from lightgbm_tpu_torch.ops.histogram import quantize_gradients
    from lightgbm_tpu_torch.utils import threefry
    n = gb.num_data
    grad, hess = gb.objective.get_gradients(score)
    ones = torch.ones_like(grad)
    key = threefry.fold_in(threefry.fold_in(
        threefry.fold_in(gb._node_key_base, it), 0x51475442), 0)
    bins = gb.config.num_grad_quant_bins
    card = quantize_gradients(grad, hess, ones, bins, key)
    host = quantize_gradients(grad.cpu(), hess.cpu(), ones.cpu(), bins, key)
    same = [torch.equal(a.cpu(), b) for a, b in zip(card[:2], host[:2])]
    same += [np.float32(a.item()).tobytes() == np.float32(b.item()).tobytes()
             for a, b in zip(card[2:], host[2:])]
    if not all(same):
        raise AssertionError(f"the card's quantized gradients differ from "
                             f"the CPU port's (gq, hq, g_scale, h_scale: "
                             f"{same})")
    # what a division by a Python float (a CPU scalar) would have given
    x = grad * ones
    recip_rows = int((x / card[2] != x / float(card[2])).sum())
    return {"rows": n, "iteration": it,
            "distinct_gradients": int(torch.unique(grad).numel()),
            "gq_hq_scales_bit_equal_to_cpu": True,
            "g_scale": float(card[2]), "h_scale": float(card[3]),
            "rows_differing_under_cpu_scalar_division": recip_rows}


def phase_quant_hist(ds, bst):
    """B4, B5 and B2 in the int8/int32 mode against their plain versions
    at one frontier level of the training run (K = 128 slots, about half
    the rows slotted), with int8 levels that ``quantize_gradients`` made
    on the card from the run's last gradients; exact (integer sums), so
    ``max_abs_err`` must be 0.  B4 also at ``b4_shapes`` and
    ``b4_edge_cases``, as in ``phase_hist``.  Kernels timed from CUDA
    graphs; plain versions, ``torch.bincount`` x 2 and
    ``quantize_gradients`` by CUDA events."""
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops.histogram import (_vals_t_int,
                                                  accumulate_plain,
                                                  quantize_gradients)
    from lightgbm_tpu_torch.ops.split import QuantScales
    from lightgbm_tpu_torch.utils import threefry
    gb = bst.boosting
    binned_t = ds.binned_t
    F, n = binned_t.shape
    K, B = HIST_SLOTS, gb.num_bins
    hp = gb.grower_cfg.hp
    mt = gb.meta_t
    nb, mty, db = mt["num_bin"], mt["missing_type"], mt["default_bin"]
    plan = fused.scan_tasks(gb.meta.num_bin, B, "cuda")
    grad, hess = gb.objective.get_gradients(gb.train_score[0])
    ones = torch.ones_like(grad)
    key = threefry.fold_in(threefry.fold_in(threefry.prng_key(0),
                                            0x51475442), 0)

    def quantize():
        return quantize_gradients(grad, hess, ones, 4, key)

    gq, hq, gs, hs = quantize()
    qs = QuantScales(float(gs), float(hs))
    vals = _vals_t_int(gq, hq, ones > 0).contiguous()
    g = torch.Generator(device="cuda").manual_seed(6)
    r = torch.rand(n, device="cuda", generator=g)
    pick = torch.randint(0, K, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    other = torch.randint(0, K, (n,), device="cuda", generator=g,
                          dtype=torch.int32)
    slot = torch.where(r < 0.5, pick, torch.full_like(pick, K))
    pslot = torch.where(r < 0.5, pick, other)
    parent = accumulate_plain(binned_t, vals, pslot, K, B)
    small_left = torch.rand(K, device="cuda", generator=g) < 0.5

    small = fused.accumulate(binned_t, vals, slot, K, B)
    small_p = accumulate_plain(binned_t, vals, slot, K, B)
    if small.dtype != torch.int32 or not torch.equal(small, small_p):
        raise AssertionError("B4 int8 differs from its plain version")
    err_b4 = max_abs_err(small, small_p)
    del small_p
    children = fused.derive_children(small, small_left, parent)
    n_par = torch.bincount(pslot, minlength=K)
    n_small = torch.bincount(slot[slot < K], minlength=K)
    n_left = torch.where(small_left, n_small, n_par - n_small)
    tot = children[:, :, 0].to(torch.int64).sum(-1).to(torch.float32)
    sums = torch.stack([tot[:, 0] * gs, tot[:, 1] * hs,
                        torch.cat([n_left, n_par - n_left]).float()])

    def b5():
        return fused.sibling_scan(small, qs, sums, nb, mty, db, hp,
                                  small_left=small_left, parent=parent,
                                  plan=plan)

    def b5_plain():
        return fused.scan_plain(small, qs, sums, nb, mty, db, hp,
                                small_left=small_left, parent=parent)

    def b2():
        return fused.frontier_splits(binned_t, vals, slot, K, B, qs, sums,
                                     small_left, parent, nb, mty, db, hp,
                                     plan=plan)

    def b2_plain():
        seg = accumulate_plain(binned_t, vals, slot, K, B)
        return seg, fused.scan_plain(seg, qs, sums, nb, mty, db, hp,
                                     small_left=small_left, parent=parent)

    best_k5, best_p5 = b5(), b5_plain()
    if not same_bits(best_k5, best_p5):
        raise AssertionError("B5 (quantized) differs from its plain version "
                             "in bits")
    if not bool(torch.isfinite(best_k5.gain).any()):
        raise AssertionError("B5 (quantized) found no split")
    err_b5 = max_abs_err(best_k5, best_p5)
    seg_k, best_k = b2()
    seg_p, best_p = b2_plain()
    if not (torch.equal(seg_k, seg_p) and same_bits(best_k, best_p)):
        raise AssertionError("B2 (int8) differs from its plain version")
    err_b2 = max(max_abs_err(best_k, best_p), max_abs_err(seg_k, seg_p))
    del seg_k, seg_p
    for err in (err_b4, err_b5, err_b2):
        if err != 0.0:
            raise AssertionError(f"an int8 kernel is off by {err}")
    torch.cuda.synchronize()

    m = int((slot < K).sum())
    scan = cost_bound("B5", children=2 * K, features=F, bins=B, quant=True)
    shapes = b4_shapes(fused, accumulate_plain, binned_t, vals, None, B,
                       slot, seed=8)
    acc = shapes["frontier"]
    pair = cost_bound("B2", rows=n, features=F, bins=B, slots=K,
                      slotted_rows=m, quant=True)
    edges = b4_edge_cases(fused, accumulate_plain, binned_t, vals, None, B)
    modes = b5_mode_rows(fused, small, qs, sums, nb, mty, db, hp,
                         small_left, parent, plan, quant=True)
    rows_out = {
        "fused_frontier_accumulate": dict(acc, max_abs_err=err_b4),
        "fused_slot_order": slot_order_row(fused, slot, K, vals, None),
        "fused_sibling_scan": {
            "kernel_ms": graph_ms(b5, 10),
            "plain_ms": event_ms(b5_plain, 2, warmup=1),
            "library_ms": None, "max_abs_err": err_b5, **scan},
        "fused_frontier_splits": {
            "kernel_ms": graph_ms(b2, 10),
            "plain_ms": event_ms(b2_plain, 2, warmup=1),
            "library_ms": None, "max_abs_err": err_b2, **pair},
    }
    quant_ms = event_ms(quantize, 10)
    emit({"phase": "quant_hist", "rows": n, "features": F, "bins": B,
          "slots": K, "slotted_rows": m, "quant_bins": 4,
          "g_scale": qs.g, "h_scale": qs.h,
          "checked": "exact: equal to the plain versions (int32 sums, "
                     "tuples bit for bit)",
          "b4_shapes": shapes, "b4_edge_cases": edges,
          "quantize_gradients_ms": quant_ms,
          "quantize_gradients_bytes": 8 * n + 2 * n,
          "b5_modes": modes, **rows_out})
    return dict(rows_out, b5_modes=modes, b4_shapes=shapes)


def short_run(lt, ds, params, positive, zero, quant=True,
              rounds=QUANT_SHORT_ROUNDS, plain_rounds=SHORT_PLAIN_ROUNDS):
    """``rounds`` rounds of ``params`` on a reused dataset, on the kernels
    and then ``plain_rounds`` of them on their plain versions: the model
    text (at fewer rounds, its first trees) must be the same bytes.  Returns the kernel run's launch counts, with B5's launches by
    mode under ``b5_modes``, and its booster.
    ``quant``: the run must train quantized (or, False, f32) trees."""
    from lightgbm_tpu_torch.ops import fused
    reset_training_counts()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, rounds, verbose_eval=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_launches()
    modes = dict(fused.scan_modes)
    used_graph(bst)
    expect_launches(launches, positive=positive, zero=zero)
    if (bst.boosting._quant_on != quant or bst.num_trees()
            != rounds * bst.num_tree_per_iteration):
        raise AssertionError("the short run did not train the trees asked")
    saved = plain_kernels()
    plain_rounds = min(rounds, plain_rounds)
    try:
        bst_p = lt.train(params, ds, plain_rounds, verbose_eval=False)
    finally:
        restore_kernels(saved)
    if (bst_p.model_to_string() != bst.model_to_string()
            if plain_rounds == rounds else
            trees_of(bst_p.model_to_string()) != trees_of(
                bst.model_to_string(num_iteration=plain_rounds))):
        raise AssertionError("the short run's model text differs from its "
                             "plain-version run")
    return dict(launches, b5_modes=modes, seconds=seconds), bst


def phase_quant_train(lt, f32_run, data, efb_ds):
    """``higgs_quant_1m``: the training run's datasets with
    ``use_quantized_grad`` and LightGBM's defaults, through
    ``training_runs``; then the other branches (16 bins, no stochastic
    rounding, leaf renewal) and the staged arm (the one-hot table), 3
    rounds each.  Returns the main run's launch counts."""
    ds, f32_row = f32_run["ds"], f32_run["row"]
    r = training_runs(lt, *data, QUANT_PARAMS, TRAIN_ROUNDS,
                      datasets=(ds, f32_run["vs"]),
                      plain_rounds=PLAIN_SHORT_ROUNDS)
    expect_launches(r["launches"], positive=INT8_ENTRIES,
                    zero=F32_ENTRIES + ("histogram_pallas", "ingest"))
    if not r["bst"].boosting._quant_on:
        raise AssertionError("the quantized run trained f32 histograms")
    gb = r["bst"].boosting
    init = float(np.float32(gb.init_scores[0]))
    checks = [quant_check(gb, torch.full((gb.num_data,), init,
                                         device="cuda"), 0),
              quant_check(gb, gb.train_score[0], TRAIN_ROUNDS)]
    branch, _ = short_run(
        lt, ds, QUANT_BRANCH_PARAMS,
        positive=INT8_ENTRIES + ("fused_frontier_accumulate",
                                 "fused_slot_order"),
        zero=("fused_frontier_splits", "fused_sibling_scan",
              "histogram_pallas"))
    staged, _ = short_run(
        lt, efb_ds, QUANT_PARAMS,
        positive=("fused_frontier_accumulate_int8",
                  "fused_sibling_scan_int8", "fused_slot_order_int8"),
        zero=F32_ENTRIES + ("fused_frontier_splits_int8",
                            "histogram_pallas"))
    row = r["row"]
    cfg = r["bst"].boosting.config
    emit({"phase": "quant_train", "config": "higgs_quant_1m", **row,
          "datasets": "reused from phase train",
          "quant": {k: getattr(cfg, k) for k in (
              "use_quantized_grad", "num_grad_quant_bins",
              "stochastic_rounding", "quant_train_renew_leaf")},
          "round10_vs_f32": {
              "auc": [row["valid_auc"][-1], f32_row["valid_auc"][-1]],
              "logloss": [row["valid_logloss"][-1],
                          f32_row["valid_logloss"][-1]]},
          "quantize_check_first_and_after_last_tree": checks,
          "branch_run": {"rounds": QUANT_SHORT_ROUNDS,
                         "params": {k: QUANT_BRANCH_PARAMS[k] for k in (
                             "num_grad_quant_bins", "stochastic_rounding",
                             "quant_train_renew_leaf")},
                         "launches": branch,
                         "checked": "model text byte-identical to the "
                                    "plain run"},
          "staged_run": {"config": "airline_onehot_1m",
                         "rounds": QUANT_SHORT_ROUNDS, "launches": staged,
                         "checked": "model text byte-identical to the "
                                    "plain run"}})
    return dict(r["launches"], b5_modes=r["row"]["b5_launches_by_mode"])


def b5_mode_rows(fused, small, scales, sums, nb, mty, db, hp, small_left,
                 parent, plan, quant):
    """B5's other modes at a frontier level's shape (K candidates, NC = 2K
    children), each bit for bit against its plain version, with its time
    (CUDA graph), the plain version's (CUDA events) and its bound: the
    monotone + bounds mode in parent mode (constraints +1, -1, 0 by
    feature; a quarter of the children unbounded, the rest bounded near
    0, so the clamp bites), and (f32) the random-threshold mode in leaf
    mode on the derived children (one threshold per (child, feature),
    ``ops.split.random_thresholds`` of uniforms)."""
    from lightgbm_tpu_torch.ops.split import random_thresholds
    K, C, F, B = small.shape
    NC = 2 * K
    dev = small.device
    g = torch.Generator(device="cuda").manual_seed(9)
    mono = torch.zeros(F, dtype=torch.int32, device=dev)
    mono[0::3], mono[1::3] = 1, -1
    free = torch.rand(NC, device=dev, generator=g) < 0.25
    lo = -0.02 - 0.1 * torch.rand(NC, device=dev, generator=g)
    hi = 0.02 + 0.1 * torch.rand(NC, device=dev, generator=g)
    bounds = (torch.where(free, torch.full_like(lo, -np.inf), lo),
              torch.where(free, torch.full_like(hi, np.inf), hi))
    rows = {}

    def check(name, k, p, free_k):
        if not same_bits(k, p):
            raise AssertionError(f"B5 ({name}) differs from its plain "
                                 "version in bits")
        if not bool(torch.isfinite(k.gain).any()):
            raise AssertionError(f"B5 ({name}) found no split")
        if same_bits(k, free_k):
            raise AssertionError(f"B5 ({name}) elects what the plain mode "
                                 "elects: the mode did not bite")
        return max_abs_err(k, p)

    def mono_k():
        return fused.sibling_scan(small, scales, sums, nb, mty, db, hp,
                                  small_left=small_left, parent=parent,
                                  monotone_constraints=mono,
                                  child_bounds=bounds, plan=plan)

    def mono_p():
        return fused.scan_plain(small, scales, sums, nb, mty, db, hp,
                                small_left=small_left, parent=parent,
                                monotone_constraints=mono,
                                child_bounds=bounds)
    free_k = fused.sibling_scan(small, scales, sums, nb, mty, db, hp,
                                small_left=small_left, parent=parent,
                                plan=plan)
    err = check("monotone+bounds", mono_k(), mono_p(), free_k)
    rows["monotone+bounds"] = {
        "children": NC, "features": F, "bins": B, "max_abs_err": err,
        "kernel_ms": graph_ms(mono_k, 10),
        "plain_ms": event_ms(mono_p, 2, warmup=1), "library_ms": None,
        **cost_bound("B5", children=NC, features=F, bins=B, quant=quant,
                     monotone=True, bounds=True)}
    if quant:
        return rows
    leaf = fused.derive_children(small, small_left, parent).contiguous()
    thr = random_thresholds(torch.rand((NC, F), device=dev, generator=g), nb)

    def rand_k():
        return fused.sibling_scan(leaf, scales, sums, nb, mty, db, hp,
                                  rand_thr=thr, plan=plan)

    def rand_p():
        return fused.scan_plain(leaf, scales, sums, nb, mty, db, hp,
                                rand_thr=thr)
    err = check("rand_thr", rand_k(), rand_p(),
                fused.sibling_scan(leaf, scales, sums, nb, mty, db, hp,
                                   plan=plan))
    rows["rand_thr"] = {
        "children": NC, "features": F, "bins": B, "max_abs_err": err,
        "kernel_ms": graph_ms(rand_k, 10),
        "plain_ms": event_ms(rand_p, 2, warmup=1), "library_ms": None,
        **cost_bound("B5", children=NC, features=F, bins=B, leaf_mode=True,
                     rand_thr=True)}
    return rows


def phase_onehot_scan(ds, bst):
    """B5 in leaf mode at the staged arm's widest shape: 2 x 128 children
    of the one-hot airline table, their [256, 3, G, Bg] group histograms
    (B4 of random slots, with the last tree's gradients) read by B5 as the
    grower passes them; bit for bit against the plain version, the int64
    expansion to [256, 3, F, B] then the scan, and timed, with the old
    path's expansion timed as a row of its own."""
    from lightgbm_tpu_torch.grower_rounds import group_layout
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.ops.split import fixed_to_f32
    gb = bst.boosting
    binned_t = ds.binned_t
    G, n = binned_t.shape
    Bg, B = int(ds.max_group_bin), gb.num_bins
    NC = 2 * HIST_SLOTS
    hp = gb.grower_cfg.hp
    mt = gb.meta_t
    nb, mty, db = mt["num_bin"], mt["missing_type"], mt["default_bin"]
    F = nb.shape[0]
    plan = fused.scan_tasks(gb.meta.num_bin, B, "cuda")
    grad, hess = gb.objective.get_gradients(gb.train_score[0])
    vals = H._vals_t(grad, hess, torch.ones_like(grad)).contiguous()
    scales = H.fixed_point_scales(vals)
    g = torch.Generator(device="cuda").manual_seed(10)
    slot = torch.randint(0, NC, (n,), device="cuda", generator=g,
                         dtype=torch.int32)
    ghist = fused.accumulate(binned_t, vals, slot, NC, Bg, scales)
    sums = torch.stack([fixed_to_f32(ghist[:, c, 0].sum(-1), [scales[c]], 0)
                        for c in range(3)])
    groups = group_layout(mt, B)

    def expand(h):
        return fused.expand_groups(h, groups, nb)

    def k():
        return fused.sibling_scan(ghist, scales, sums, nb, mty, db, hp,
                                  groups=groups, plan=plan)

    def p():
        return fused.scan_plain(expand(ghist), scales, sums, nb, mty, db, hp)
    best_k, best_p = k(), p()
    if not same_bits(best_k, best_p):
        raise AssertionError("B5 (onehot leaf mode, group histograms) "
                             "differs from its plain version in bits")
    if not bool(torch.isfinite(best_k.gain).any()):
        raise AssertionError("B5 (onehot leaf mode) found no split")
    cells = grouped_scan_cells(mt["feat_group"], mt["feat_start"],
                               mt["num_bin"], B, Bg)
    walked = int(torch.clamp(nb, max=B).sum())
    row = {"phase": "onehot_scan", "children": NC, "features": F,
           "groups": G, "group_bins": Bg, "bins": B,
           "input": "group histograms [NC, 3, G, Bg] int64",
           "group_cells_read": cells,
           "checked": "bit-identical to the plain version (the int64 "
                      "expansion, then the scan)",
           "max_abs_err": max_abs_err(best_k, best_p),
           "kernel_ms": graph_ms(k, 20),
           "plain_ms": event_ms(p, 1, warmup=1), "library_ms": None,
           # the group cells the scan needs (group 0's row for the
           # totals, each feature's own bins), once; the meta; the
           # tuples; the gain arithmetic of every bin a feature has
           **cost_bound("B5", children=NC, features=F, cells=cells,
                        walked=walked, leaf_mode=True, feature_meta=5,
                        plan_entries=plan.numel())}
    # the old path: the expansion the grower ran before every search, and
    # the byte bound of a scan over its [NC, 3, F, B] output
    row["expansion_old_path"] = {
        "ms": graph_ms(lambda: expand(ghist), 5),
        **roofline(NC * 3 * G * Bg * 8 + NC * 3 * F * B * 8, 0)}
    row["expanded_input_bound"] = cost_bound("B5", children=NC, features=F,
                                             bins=B, leaf_mode=True)
    del ghist, best_p
    emit(row)
    return row


def phase_rand_train(lt, f32_run, data):
    """``higgs_rand_1m``: the training run's datasets with extra trees and
    ``feature_fraction_bynode=0.5``, through ``training_runs``: the staged
    arm, B6 for each root, B4 segments and B5 in leaf mode with random
    thresholds (the bynode masks apply outside the kernel); then 3
    quantized rounds with bynode only (B4 and B5 int8 in leaf mode).
    Returns (the main run's launches, B5's launches by mode)."""
    r = training_runs(lt, *data, RAND_PARAMS, TRAIN_ROUNDS,
                      datasets=(f32_run["ds"], f32_run["vs"]),
                      plain_rounds=PLAIN_SHORT_ROUNDS)
    expect_launches(r["launches"], positive=(
        "fused_frontier_accumulate", "fused_sibling_scan",
        "fused_slot_order"), zero=("fused_frontier_splits", "ingest")
        + INT8_ENTRIES, exact={"histogram_pallas": TRAIN_ROUNDS})
    modes = r["row"]["b5_launches_by_mode"]
    if modes != {"rand_thr": r["launches"]["fused_sibling_scan"]}:
        raise AssertionError(f"B5 ran other modes than rand_thr: {modes}")
    quant, _ = short_run(
        lt, f32_run["ds"], RAND_QUANT_PARAMS,
        positive=("fused_frontier_accumulate_int8",
                  "fused_sibling_scan_int8", "fused_slot_order_int8"),
        zero=F32_ENTRIES + ("fused_frontier_splits_int8",
                            "histogram_pallas"))
    emit({"phase": "rand_train", "config": "higgs_rand_1m", **r["row"],
          "datasets": "reused from phase train",
          "params": {k: RAND_PARAMS[k] for k in (
              "extra_trees", "feature_fraction_bynode")},
          "bynode_feature_cnt":
              r["bst"].boosting.grower_cfg.bynode_feature_cnt,
          "quant_bynode_run": {"rounds": QUANT_SHORT_ROUNDS,
                               "launches": quant,
                               "checked": "model text byte-identical to "
                                          "the plain run"}})
    return r["launches"], modes


def monotone_sweep(pk, bst, Xv) -> dict:
    """``Booster.predict`` through B1 on a 101-point sweep of x0 and of x1
    at 10 base rows (tests/test_engine.py's check): non-decreasing in x0,
    non-increasing in x1, exactly (every row sums the same trees in the
    same order, and f32 rounding is monotone)."""
    pk.reset_launch_counts()
    grid = np.linspace(0.0, 1.0, SWEEP_POINTS, dtype=np.float32)
    worst = {0: 0.0, 1: 0.0}
    for row in Xv[:SWEEP_ROWS]:
        for col, sign in ((0, 1.0), (1, -1.0)):
            sweep = np.repeat(row[None, :], SWEEP_POINTS, axis=0)
            sweep[:, col] = grid
            d = sign * np.diff(bst.predict(sweep))
            worst[col] = min(worst[col], float(d.min()))
    launches = pk.launch_counts[KERNEL]
    if worst[0] < 0 or worst[1] < 0:
        raise AssertionError(f"predictions break the constraints: {worst}")
    if launches <= 0:
        raise AssertionError("the sweep never launched B1")
    return {"base_rows": SWEEP_ROWS, "points": SWEEP_POINTS,
            "b1_launches": launches,
            "min_step_x0_increasing": worst[0],
            "min_step_x1_decreasing": worst[1]}


def phase_mono_train(lt, pk, efb_ds):
    """``mono_train_1m``: upstream LightGBM's monotone data at HIGGS width
    (1,000,000 x 28, constraints +1, -1, 0 on x0..x2), regression, 255
    leaves, through ``training_runs`` on the fused arm: B3, B4 roots and
    B2 (B4 + B5) in the monotone + bounds mode; the valid l2 falls every
    round, the first trees equal the plain-version run's, and B1's
    predictions keep the constraints on a sweep.  Then 3 rounds of the
    one-hot airline table (staged arm) with DepTime constrained: B5 in
    leaf mode with constraints and bounds.  Returns (the main run's
    launches, B5's launches by mode)."""
    from lightgbm_tpu_torch.testing import MONOTONE_CONSTRAINTS, monotone_like
    X, y = monotone_like(TRAIN_ROWS, seed=21)
    Xv, yv = monotone_like(VALID_ROWS, seed=22)
    params = dict(MONO_PARAMS,
                  monotone_constraints=list(MONOTONE_CONSTRAINTS))
    r = training_runs(lt, X, y, Xv, yv, params, TRAIN_ROUNDS, falling="l2",
                      rising=None, plain_rounds=PLAIN_SHORT_ROUNDS)
    expect_launches(r["launches"], positive=("ingest",) + F32_ENTRIES,
                    zero=("histogram_pallas",) + INT8_ENTRIES)
    modes = r["row"]["b5_launches_by_mode"]
    if modes != {"monotone+bounds": r["launches"]["fused_sibling_scan"]}:
        raise AssertionError(f"B5 ran other modes than monotone+bounds: "
                             f"{modes}")
    sweep = monotone_sweep(pk, r["bst"], Xv)
    mc = [0] * efb_ds.num_total_features
    mc[ONEHOT_DEPTIME] = 1
    onehot, _ = short_run(
        lt, efb_ds, dict(TRAIN_PARAMS, monotone_constraints=mc),
        positive=("fused_frontier_accumulate", "fused_sibling_scan",
                  "fused_slot_order", "histogram_pallas"),
        zero=("fused_frontier_splits",) + INT8_ENTRIES, quant=False)
    if set(onehot["b5_modes"]) != {"monotone+bounds"}:
        raise AssertionError(f"the one-hot run's B5 modes: "
                             f"{onehot['b5_modes']}")
    emit({"phase": "mono_train", "config": "mono_train_1m", **r["row"],
          "monotone_constraints": list(MONOTONE_CONSTRAINTS),
          "sweep": sweep,
          "onehot_run": {"config": "airline_onehot_1m", "rounds":
                         QUANT_SHORT_ROUNDS, "monotone_column":
                         ONEHOT_DEPTIME, "launches": onehot,
                         "checked": "model text byte-identical to the "
                                    "plain run"}})
    return r["launches"], modes, r["ds"]


def bin_oracle(ds, X, out_dtype, groups) -> np.ndarray:
    """``Dataset._bin_block`` of the rows of ``X`` on the host, in eight
    threads over row blocks (each block column-major in f64)."""
    from concurrent.futures import ThreadPoolExecutor
    ref = np.zeros((X.shape[0], groups), out_dtype)
    step = -(-X.shape[0] // 8)

    def one(i):
        block = np.asfortranarray(X[i:i + step], dtype=np.float64)
        with np.errstate(invalid="ignore", over="ignore"):
            ds._bin_block(block, ref[i:i + step])
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(one, range(0, X.shape[0], step)))
    return ref


def b3_check(ds, X, oracle_rows) -> dict:
    """``b3_at`` for ``ds``'s layout, and B3 byte for byte against
    ``_bin_block`` on the first ``oracle_rows`` rows plus the edge rows."""
    from lightgbm_tpu_torch.ops import ingest as ING
    row = b3_at(ds, X)
    tables = ING.build_ingest_tables(ds)
    Xc = np.concatenate([X[:oracle_rows], edge_rows(ds, X.shape[1], X)])
    out = ING.DeviceBinner(tables, "cuda")(
        torch.from_numpy(Xc).cuda()).cpu().numpy()
    ref = bin_oracle(ds, Xc, tables.out_dtype, tables.num_groups)
    if not np.array_equal(out.T, ref):
        bad = int((out.T != ref).sum())
        raise AssertionError(f"B3 differs from _bin_block at {bad} entries")
    return dict(row, checked_rows=int(Xc.shape[0]),
                checked="byte-identical to _bin_block; equal to the plain "
                        "version on every row")


def phase_wide_ingest(lt):
    """C-1: B3 binning what the host bins at any width.  200,000 x 2,000
    f32 numeric features, a tenth NaN, through ``Dataset`` on the card
    (the chunks stage their own columns); then the first
    ``OVERSIZE_MEMBERS`` of those features as one EFB group (the
    Dataset's mappers, the group's starts as EFB lays them out), whose
    tables exceed 96 KiB and are binned in member parts over successive
    launches, on rows where every member is non-zero (conflicts).  Each
    byte-identical to ``_bin_block``.  Returns both rows."""
    import copy
    from lightgbm_tpu_torch.ops import ingest as ING
    rng = np.random.default_rng(31)
    n, F = WIDE_INGEST_ROWS, WIDE_INGEST_FEATURES
    X = rng.standard_normal((n, F), dtype=np.float32)
    X[rng.random((n, F), dtype=np.float32) < 0.1] = np.nan
    y = rng.random(n, dtype=np.float32)
    ING.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(X, label=y,
                    params={"bin_construct_sample_cnt": WIDE_SAMPLE_ROWS})
    ds.construct()
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    construct_launches = ING.launch_counts["ingest"]
    if construct_launches <= 0:
        raise AssertionError("the Dataset never launched B3")
    Xt = torch.from_numpy(X).cuda()
    if not torch.equal(ds.binned_t.to(torch.int32),
                       ING.DeviceBinner(ING.build_ingest_tables(ds),
                                        "cuda").plain(Xt).to(torch.int32)):
        raise AssertionError("the Dataset's binned matrix differs from B3's "
                             "plain version")
    del Xt
    wide = b3_check(ds, X, WIDE_ORACLE_ROWS)
    if wide["plan"]["chunks"] < 2 or wide["plan"]["largest_chunk_columns"] \
            >= F:
        raise AssertionError(f"the 2,000-feature plan stages whole rows: "
                             f"{wide['plan']}")
    wide.update(construct_s=construct_s,
                construct_launches=construct_launches)
    # one EFB group of the first OVERSIZE_MEMBERS features
    M = OVERSIZE_MEMBERS
    grp = copy.copy(ds)
    grp.used_features = list(ds.used_features[:M])
    nbs = np.array([ds.bin_mappers[f].num_bin for f in grp.used_features])
    grp.feat_group = np.zeros(M, np.int32)
    grp.feat_start = (1 + np.concatenate([[0], np.cumsum(nbs - 1)[:-1]])
                      ).astype(np.int32)
    grp._group_size = [M]
    grp.num_groups = 1
    grp.max_group_bin = int(1 + (nbs - 1).sum())
    kt = ING.kernel_tables(ING.build_ingest_tables(grp))
    table_bytes = 4 * (6 * M + 2 + int(kt.group_words[-1]))
    if table_bytes <= 96 * 1024:
        raise AssertionError(f"the group's tables are {table_bytes} bytes")
    over = b3_check(grp, X, WIDE_ORACLE_ROWS)
    if over["plan"]["launches"] < 2:
        raise AssertionError(f"the oversize group was not split: "
                             f"{over['plan']}")
    over.update(members=M, table_bytes=table_bytes)
    emit({"phase": "wide_ingest", "features_2000": wide,
          "oversize_group": over})
    return wide, over


def phase_rank_train(lt, pk):
    """``mslr_lambdarank_1m``: lambdarank at MSLR-WEB30K width (1,000,000
    x 136 f32, about 8,200 queries of 1 to 1,250 documents, grades 0-4;
    ``testing.mslr_like``) with a 100,000-row valid set, through
    ``training_runs`` on the fused arm (B3, B4 roots, B2), each run
    binning its own train and valid rows (the plain-version run through
    B3's plain version): the first trees equal the plain-version run's,
    valid NDCG@10 rises, and the card's predictions equal the host's and
    B1's plain version; the section ``objective`` of each tree is the
    lambdarank gradients (plain PyTorch), also timed alone.  B3 at 136
    features: byte for byte against ``_bin_block`` on the first
    ``RANK_ORACLE_ROWS`` rows and the edge rows, and against its plain
    version on all rows (``b3_at``).  Then B5 at the run's shape, and 3 rounds
    of ``rank_xendcg`` against their plain-version run.  Returns (the
    main run's launches, B5's launches by mode, the B5 row)."""
    from lightgbm_tpu_torch.testing import mslr_like
    X, y, group = mslr_like(RANK_ROWS, seed=31)
    Xv, yv, vgroup = mslr_like(RANK_VALID_ROWS, seed=32)
    r = training_runs(lt, X, y, Xv, yv, RANK_PARAMS, RANK_ROUNDS,
                      falling=None, rising="ndcg@10", groups=(group, vgroup),
                      plain_rounds=PLAIN_SHORT_ROUNDS)
    ds = r["ds"]
    if ds.feature_meta().has_bundles:
        raise AssertionError("the MSLR-width table bundled")
    expect_launches(r["launches"], positive=("ingest",) + F32_ENTRIES,
                    zero=("histogram_pallas",) + INT8_ENTRIES,
                    exact={"ingest": 2})
    checked = oracle_check(ds, X[:RANK_ORACLE_ROWS])
    b3 = b3_at(ds, X)
    b1 = predict_vs_plain(pk, r["bst"], Xv)
    gb = r["bst"].boosting
    grad_ms = event_ms(lambda: gb.objective.get_gradients(gb.train_score[0]),
                       3, warmup=1)
    ks = sorted(k for tree in r["rounds_log"] for k, _ in tree)
    b5 = b5_run_row(ds, r["bst"], ks[len(ks) // 2])
    xendcg, _ = short_run(lt, ds, XENDCG_PARAMS, positive=F32_ENTRIES,
                       zero=("histogram_pallas",) + INT8_ENTRIES,
                       quant=False)
    row = r["row"]
    objective_s = row["breakdown_s_per_tree"].get("objective", 0.0)
    emit({"phase": "rank_train", "config": "mslr_lambdarank_1m", **row,
          "queries": len(group), "valid_queries": len(vgroup),
          "max_query_rows": int(group.max()),
          "buckets": {int(Q): len(q) for Q, q in
                      gb.objective.buckets.items()},
          "objective_s_per_tree": objective_s,
          "objective_share_of_timed_tree":
              objective_s / row["timed_s_per_tree"],
          "lambdarank_gradients_ms": grad_ms, "b3": b3,
          "b3_oracle_rows": checked, "predict_b1_launches": b1,
          "predict": "bit-identical to B1's plain version",
          "b5_at_this_shape": b5,
          "xendcg_run": {"rounds": QUANT_SHORT_ROUNDS, "launches": xendcg,
                         "checked": "model text byte-identical to the "
                                    "plain run"}})
    return r["launches"], row["b5_launches_by_mode"], b5


def phase_multiclass_train(lt, pk):
    """``airline_multiclass_1m``: ``multiclass`` (5 classes, 255 leaves,
    the default ``max_cat_threshold``) on the airline table with its six
    categorical columns native and a 5-class delay band
    (``testing.airline_multiclass_like``), 10 rounds of 5 trees, through
    ``training_runs`` on the fused arm with the categorical merge: the
    first trees equal the plain-version run's, valid multi_logloss falls
    every round, and B1's scores mode at K = 5 equals the host's and its
    plain version.  Then 3 rounds of ``multiclassova`` and 3 of quantized
    multiclass (per-class scales; int8 B4/B5/B2 only), each against its
    plain-version run.  Returns the main run's launches."""
    from lightgbm_tpu_torch.testing import (AIRLINE_CATEGORICAL,
                                            airline_multiclass_like)
    X, y = airline_multiclass_like(MULTI_ROWS, seed=41)
    Xv, yv = airline_multiclass_like(MULTI_VALID_ROWS, seed=42)
    r = training_runs(lt, X, y, Xv, yv, MULTI_PARAMS, MULTI_ROUNDS,
                      categorical=list(AIRLINE_CATEGORICAL),
                      falling="multi_logloss", rising=None,
                      plain_rounds=PLAIN_SHORT_ROUNDS)
    ds = r["ds"]
    expect_launches(r["launches"], positive=F32_ENTRIES,
                    zero=("histogram_pallas",) + INT8_ENTRIES,
                    exact={"ingest": 2})
    b1 = predict_vs_plain(pk, r["bst"], Xv)
    cat_splits = sum(int((m.decision_type[:m.num_leaves - 1] & 1).sum())
                     for m in r["bst"].models)
    if cat_splits == 0:
        raise AssertionError("no categorical split was made")
    ova, _ = short_run(lt, ds, OVA_PARAMS, positive=F32_ENTRIES,
                    zero=("histogram_pallas",) + INT8_ENTRIES, quant=False)
    quant, qbst = short_run(lt, ds, MULTI_QUANT_PARAMS,
                            positive=INT8_ENTRIES,
                            zero=F32_ENTRIES + ("histogram_pallas",))
    scales = [[float(g), float(h)] for g, h in qbst.boosting._quant_scales]
    if len(scales) != MULTI_CLASSES or len({tuple(s) for s in scales}) < 2:
        raise AssertionError(f"quantized multiclass scales: {scales}")
    emit({"phase": "multiclass_train", "config": "airline_multiclass_1m",
          **r["row"], "num_class": MULTI_CLASSES,
          "class_shares": (np.bincount(y.astype(np.int64))
                           / len(y)).tolist(),
          "categorical_splits": cat_splits, "predict_b1_launches": b1,
          "predict": "bit-identical to B1's plain version (K = 5)",
          "ova_run": {"rounds": QUANT_SHORT_ROUNDS, "launches": ova},
          "quant_run": {"rounds": QUANT_SHORT_ROUNDS, "launches": quant,
                        "last_scales_per_class": scales},
          "checked": "model texts byte-identical to the plain runs"})
    return r["launches"]


def phase_goss_train(lt, f32_run, data, efb_ds):
    """``higgs_goss_1m``: the training run's datasets with ``boosting=goss``
    at lr 0.1 for 15 rounds (rounds 11-15 sample, past the 1 / lr
    warm-up), through ``training_runs`` on the fused arm: the model text
    equals the plain-version run's and sampled rounds happened (the kept
    rows' share printed).  Then 3 GOSS rounds of the one-hot table
    (staged arm, B6 roots) at lr 0.5, sampling from round 3.  Returns the
    main run's launches."""
    r = training_runs(lt, *data, GOSS_PARAMS, GOSS_ROUNDS,
                      datasets=(f32_run["ds"], f32_run["vs"]),
                      falling=None, rising="auc",
                      plain_rounds=GOSS_PLAIN_ROUNDS)
    expect_launches(r["launches"], positive=F32_ENTRIES,
                    zero=("histogram_pallas", "ingest") + INT8_ENTRIES)
    gb = r["bst"].boosting
    warmup = int(np.ceil(1.0 / GOSS_PARAMS["learning_rate"]))
    if gb.sampled_iters != GOSS_ROUNDS - warmup:
        raise AssertionError(f"{gb.sampled_iters} sampled rounds, not "
                             f"{GOSS_ROUNDS - warmup}")
    kept = [float(k) for k in gb.kept_share]
    onehot, obst = short_run(
        lt, efb_ds, GOSS_ONEHOT_PARAMS,
        positive=("fused_frontier_accumulate", "fused_sibling_scan",
                  "fused_slot_order", "histogram_pallas"),
        zero=("fused_frontier_splits",) + INT8_ENTRIES, quant=False,
        plain_rounds=QUANT_SHORT_ROUNDS)    # round 3 is the sampled one
    if obst.boosting.sampled_iters != 1:
        raise AssertionError("the one-hot GOSS run did not sample round 3")
    emit({"phase": "goss_train", "config": "higgs_goss_1m", **r["row"],
          "datasets": "reused from phase train",
          "sampled_rounds": gb.sampled_iters, "kept_row_share": kept,
          "onehot_run": {"config": "airline_onehot_1m", "rounds":
                         QUANT_SHORT_ROUNDS, "learning_rate": 0.5,
                         "launches": onehot, "kept_row_share":
                         [float(k) for k in obst.boosting.kept_share],
                         "checked": "model text byte-identical to the "
                                    "plain run"}})
    return r["launches"]


def head_trees(text: str, k: int) -> list:
    """The first ``k`` tree blocks of a model text (a tree's block does
    not depend on how many rounds followed it)."""
    return [t.strip() for t in trees_of(text).split("\nTree=")[1:k + 1]]


def serial_expected(grower, arm: str) -> dict:
    """Each kernel's exact launches over a serial grower's trees: T
    trees of S split steps in all.  Every tree's root is one histogram
    and one search; every step one smaller-child histogram and one
    search of both children: the staged arm's B6 and B5 (f32) or B4 int8
    (with its sort) and B5 int8 (quantized), the fused arm's B4 root and
    a B2 (B4, its sort and B5) a step."""
    T, S = len(grower.steps), sum(grower.steps)
    if arm == "staged":
        return {"histogram_pallas": T + S, "fused_sibling_scan": T + S,
                **{k: 0 for k in F32_ENTRIES + INT8_ENTRIES
                   if k != "fused_sibling_scan"}}
    if arm == "quant":
        return {"fused_frontier_accumulate_int8": T + S,
                "fused_slot_order_int8": T + S,
                "fused_sibling_scan_int8": T + S, "histogram_pallas": 0,
                "fused_frontier_splits_int8": 0,
                **{k: 0 for k in F32_ENTRIES}}
    return {"fused_frontier_accumulate": T + S, "fused_slot_order": T + S,
            "fused_sibling_scan": T + S, "fused_frontier_splits": S,
            "histogram_pallas": 0, **{k: 0 for k in INT8_ENTRIES}}


def serial_run(lt, ds, vs, params, rounds, arm="staged",
               falling="binary_logloss") -> tuple:
    """``rounds`` rounds of ``params`` on constructed datasets through the
    serial grower, timed (seconds a tree, the valid set ``vs``, if any,
    evaluated every round), its launches held to ``serial_expected``;
    then
    ``SERIAL_PLAIN_ROUNDS`` rounds on the plain versions, whose trees
    must be the same bytes and whose launch counts must read 0.  Returns
    (booster, the run's row)."""
    reset_training_counts()
    evals = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, rounds,
                   valid_sets=[vs] if vs is not None else [],
                   valid_names=["valid"] if vs is not None else [],
                   evals_result=evals, verbose_eval=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = kernel_launches()
    grower = bst.boosting.grower
    if type(grower).__name__ != "SerialGrower":
        raise AssertionError(f"{params} did not grow serially")
    if bst.num_trees() != rounds:
        raise AssertionError(f"trained {bst.num_trees()} trees, not {rounds}")
    expect_launches(launches, exact=serial_expected(grower, arm))
    ll = evals["valid"].get(falling) if falling else None
    if falling and not all(b < a for a, b in zip(ll, ll[1:])):
        raise AssertionError(f"valid {falling} does not fall: {ll}")
    text = bst.model_to_string()
    syncs = used_graph(bst)
    saved = plain_kernels()
    reset_training_counts()
    try:
        t0 = time.perf_counter()
        bst_p = lt.train(params, ds, SERIAL_PLAIN_ROUNDS, verbose_eval=False)
        plain_s = time.perf_counter() - t0
    finally:
        restore_kernels(saved)
    if any(kernel_launches().values()):
        raise AssertionError(f"launch counts rose with no kernel launched: "
                             f"{kernel_launches()}")
    if (head_trees(bst_p.model_to_string(), SERIAL_PLAIN_ROUNDS)
            != head_trees(text, SERIAL_PLAIN_ROUNDS)):
        raise AssertionError("the trees differ from the plain-version run")
    del bst_p
    leaves = [m.num_leaves for m in bst.models]
    return bst, {
        "rounds": rounds, "leaves_per_tree": leaves,
        "s_per_tree": train_s / rounds,
        "plain_s_per_tree": plain_s / SERIAL_PLAIN_ROUNDS,
        **syncs, "launches": launches,
        "expected_launches": serial_expected(grower, arm),
        **({"valid_" + falling: ll} if falling else {}),
        "checked": f"first {SERIAL_PLAIN_ROUNDS} trees byte-identical to "
                   "the plain run, launches exact"}


def first_divergence(a: str, b: str) -> dict:
    """Where two model texts' trees first differ: the tree and its
    field line."""
    for i, (ta, tb) in enumerate(zip(trees_of(a).split("\nTree="),
                                     trees_of(b).split("\nTree="))):
        if ta != tb:
            for la, lb in zip(ta.splitlines(), tb.splitlines()):
                if la != lb:
                    return {"tree": i - 1, "field": la.split("=")[0],
                            "serial": la[:200], "rounds": lb[:200]}
    return {}


def serial_tree_profile(lt, ds, params) -> dict:
    """Where a serial tree's time goes, on a fresh booster after one
    warm-up tree: one tree's device time by kernel and busy share
    (``tree_kernel_ms``), one tree's sections (a ``SectionTimer``
    synchronising the card at each), and one iteration's synchronising
    calls (``host_reads``)."""
    from lightgbm_tpu_torch.utils.timer import SectionTimer
    bst = lt.Booster(params, train_set=ds)
    bst.update()
    out = {"tree_device_ms": tree_kernel_ms(bst.update, fused_arm=False)}
    timer = SectionTimer(cuda=True)
    bst.boosting.timer = timer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst.update()
    wall = time.perf_counter() - t0
    bst.boosting.timer = None
    sections = dict(timer.seconds)
    sections["other"] = wall - sum(sections.values())
    out["breakdown_s_per_tree"] = sections
    out.update(host_reads(bst))
    return out


def used_features(bst) -> set:
    return {int(f) for m in bst.models
            for f in m.split_feature[:m.num_leaves - 1]}


def phase_serial_train(lt, f32_run, data, efb_ds, train_stats) -> dict:
    """The serial grower (queue A4) on the card; returns the phase's
    launches summed over its kernel runs."""
    import json as _json
    t_phase = time.perf_counter()
    X, y, Xv, yv = data
    ds, vs = f32_run["ds"], f32_run["vs"]
    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            if isinstance(v, int):
                total[k] = total.get(k, 0) + v

    # higgs_cegb_1m: tpu_tree_growth stays "auto"
    # the checks' failures, raised after the phase's line is printed
    failed = []
    bst, cegb = serial_run(lt, ds, vs, CEGB_PARAMS, SERIAL_ROUNDS)
    add(cegb["launches"])
    if min(cegb["leaves_per_tree"]) < 2:
        failed.append("a CEGB iteration did not split")
    feats = used_features(bst)
    if not len(feats) < train_stats["features"]:
        failed.append(f"CEGB used {len(feats)} features, train "
                      f"{train_stats['features']}")
    if sum(cegb["leaves_per_tree"]) > train_stats["leaves"]:
        failed.append("CEGB grew more leaves than train")
    used, rows = bst.boosting.grower.cegb_state
    cegb.update({"features_used": sorted(feats),
                 "train_features_used": train_stats["features"],
                 "total_leaves": sum(cegb["leaves_per_tree"]),
                 "train_total_leaves": train_stats["leaves"],
                 "paid_rows_per_feature": rows.sum(1).tolist(),
                 "features_flagged_used": int(used.sum()),
                 "params": {k: CEGB_PARAMS[k] for k in (
                     "cegb_tradeoff", "cegb_penalty_split",
                     "cegb_penalty_feature_coupled",
                     "cegb_penalty_feature_lazy")}})
    del bst

    # higgs_forced_1m: forced bins (quartiles of two features) and a
    # 3-level forced plan at the training sample's medians
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "serial_train")
    os.makedirs(out_dir, exist_ok=True)
    sample = X[:100_000]
    med = {f: float(np.median(sample[:, f])) for f in FORCED_FEATURES}

    def node(i):
        n = {"feature": FORCED_FEATURES[i], "threshold":
             med[FORCED_FEATURES[i]]}
        if 2 * i + 1 < len(FORCED_FEATURES):
            n["left"], n["right"] = node(2 * i + 1), node(2 * i + 2)
        return n
    # BFS numbering: node i's children are 2i + 1 and 2i + 2 of the BFS
    # list when every level is full
    plan = {"feature": FORCED_FEATURES[0], "threshold": med[0],
            "left": node(1), "right": node(2)}
    bins = [{"feature": f, "bin_upper_bound": [
        float(np.quantile(sample[:, f], q)) for q in (0.25, 0.5, 0.75)]}
        for f in FORCED_BIN_FEATURES]
    fs_path = os.path.join(out_dir, "forced_splits.json")
    fb_path = os.path.join(out_dir, "forced_bins.json")
    with open(fs_path, "w") as fh:
        _json.dump(plan, fh)
    with open(fb_path, "w") as fh:
        _json.dump(bins, fh)
    fparams = dict(TRAIN_PARAMS, forcedsplits_filename=fs_path,
                   forcedbins_filename=fb_path)
    fds = lt.Dataset(X, label=y, params={"forcedbins_filename": fb_path})
    fvs = fds.create_valid(Xv, label=yv)
    fds.construct()
    fvs.construct()
    for spec in bins:
        ub = fds.bin_mappers[spec["feature"]].bin_upper_bound
        if not all(np.any(np.isclose(ub, b, rtol=0, atol=1e-12))
                   for b in spec["bin_upper_bound"]):
            failed.append(f"feature {spec['feature']}'s bin bounds miss "
                          "the forced bounds")
    plan_bins = []
    for f in FORCED_FEATURES:
        m = fds.bin_mappers[f]
        plan_bins.append(min(max(int(m.value_to_bin(
            np.array([med[f]]))[0]), 0), m.num_bin - 2))
    bst, forced = serial_run(lt, fds, fvs, fparams, SERIAL_ROUNDS)
    add(forced["launches"])
    kids = [(1, 2), (3, 4), (5, 6)]
    for t in bst.models:
        if (t.split_feature[:7].tolist() != list(FORCED_FEATURES)
                or t.threshold_in_bin[:7].tolist() != plan_bins
                or [(int(t.left_child[i]), int(t.right_child[i]))
                    for i in range(3)] != kids):
            failed.append("a tree does not start with the forced plan")
    forced.update({"plan_features": list(FORCED_FEATURES),
                   "plan_threshold_bins": plan_bins,
                   "forced_bins": bins})
    del bst
    # the reference's stats convention, and a plan abandoned at its
    # second split (its left child splits the root's feature again above
    # the root's threshold: an empty right side, gain 0)
    # (its sums follow another rule than its partition, so the valid
    # logloss need not fall)
    _, parity = serial_run(lt, fds, fvs,
                           dict(fparams, tpu_forced_split_parity=True),
                           SERIAL_SHORT_ROUNDS, falling=None)
    add(parity["launches"])
    bad = {"feature": 0, "threshold": med[0],
           "left": {"feature": 0,
                    "threshold": float(np.quantile(sample[:, 0], 0.75))}}
    bad_path = os.path.join(out_dir, "forced_abandoned.json")
    with open(bad_path, "w") as fh:
        _json.dump(bad, fh)
    bst, abandoned = serial_run(
        lt, fds, fvs, dict(fparams, forcedsplits_filename=bad_path),
        SERIAL_SHORT_ROUNDS)
    add(abandoned["launches"])
    for t in bst.models:
        if (int(t.split_feature[0]) != 0
                or int(t.threshold_in_bin[0]) != plan_bins[0]
                or (int(t.split_feature[1]) == 0
                    and int(t.left_child[0]) == 1
                    and t.threshold_in_bin[1] > plan_bins[0])
                or t.num_leaves != TRAIN_PARAMS["num_leaves"]):
            failed.append("the abandoned plan was not abandoned at its "
                          "second split")
    del bst, fds, fvs

    # higgs_serial_1m: each arm against its plain twin and the rounds
    # grower's trees
    arms = {}
    for arm, params in (
            ("staged", SERIAL_PARAMS),
            ("quant", dict(QUANT_PARAMS, tpu_tree_growth="serial")),
            ("fused", dict(SERIAL_PARAMS, tpu_hist_method="fused"))):
        bst, row = serial_run(lt, ds, vs, params, SERIAL_SHORT_ROUNDS, arm)
        add(row["launches"])
        if bst.boosting.grower.fused_arm != (arm == "fused"):
            failed.append(f"{arm}: the serial grower took the wrong arm")
        rparams = dict(params, tpu_tree_growth="rounds")
        rb = lt.train(rparams, ds, SERIAL_SHORT_ROUNDS, verbose_eval=False)
        a, b = bst.model_to_string(), rb.model_to_string()
        row["equals_rounds_grower"] = trees_of(a) == trees_of(b)
        if not row["equals_rounds_grower"]:
            row["first_divergence"] = first_divergence(a, b)
            ja, jb = (load_structures(t) for t in (a, b))
            if ja != jb:
                failed.append(f"{arm}: the serial and rounds structures "
                              f"differ: {row['first_divergence']}")
        if arm == "staged":
            row.update(serial_tree_profile(lt, ds, params))
        arms[arm] = row
        del bst, rb

    # airline_onehot_1m with coupled CEGB: EFB, the staged arm on group
    # histograms
    F1 = efb_ds.num_total_features
    oparams = dict(TRAIN_PARAMS, cegb_penalty_feature_coupled=[
        round(float(c), 3) for c in np.geomspace(1e2, 1e3, F1)])
    _, onehot = serial_run(lt, efb_ds, None, oparams, SERIAL_SHORT_ROUNDS,
                           falling=None)
    add(onehot["launches"])
    row = {"phase": "serial_train", "higgs_cegb_1m": cegb,
           "higgs_forced_1m": forced, "forced_parity": parity,
           "forced_abandoned": abandoned, "higgs_serial_1m": arms,
           "airline_onehot_1m_coupled_cegb": onehot,
           "launches": total, "phase_s": time.perf_counter() - t_phase,
           "failed": failed}
    emit(row)
    if failed:
        raise AssertionError(f"serial_train: {failed}")
    return total


# sharded_train (queue A9): two ranks, two processes on the one card,
# over an explicit gloo group (NCCL refuses two ranks on one GPU), each
# training higgs_train_1m's data (1,000,000 x 28, 255 leaves) for
# SHARD_ROUNDS rounds in five modes, each held to its twin:
# data-parallel on the rounds grower (the serial text), quantized
# data-parallel (its plain-version run's text: the rank folds into the
# rounding key), feature-parallel and voting at full top-k on the serial
# grower (the serial grower's text), and voting at top_k 4 of 28 (its
# plain-version run's text: the vote, not the serial search, picks); the
# plain-version runs train SHARD_PLAIN_ROUNDS, held to the first trees
SHARD_WORLD, SHARD_ROUNDS, SHARD_TIMEOUT_S = 2, 3, 600
SHARD_PLAIN_ROUNDS = 1
SHARD_MODES = (
    ("data", dict(TRAIN_PARAMS, tree_learner="data"), "rounds"),
    ("data_quant", dict(QUANT_PARAMS, tree_learner="data"), "plain"),
    ("feature", dict(SERIAL_PARAMS, tree_learner="feature"), "serial"),
    ("voting", dict(SERIAL_PARAMS, tree_learner="voting", top_k=28),
     "serial"),
    ("voting_top4", dict(SERIAL_PARAMS, tree_learner="voting", top_k=4),
     "plain"),
)


def shard_expected(mode: str, grower) -> dict:
    """A rank's exact launches and collectives over T trees: R frontier
    rounds run (data modes, the rounds grower) or S split steps (the
    serial grower).  data: B4 and B5 once a tree's root and once a round
    (the seam: no B2 pair), an all-reduce for the fixed-point peaks, one
    for the root and one a round; quantized: int8 kernels only, and the
    scale peaks and root totals summed instead of the fixed-point peaks;
    feature: B6 and B5 at the root and each step, one all-reduce a step
    (the owner's row sides) and one all-gather a search (the per-feature
    candidates); voting: B6 at the root and each step, B5 twice at the
    root (the local search, the elected one) and three times a step (one
    local search, one elected search a child), the peaks, root totals
    and each child's elected histograms summed, two all-gathers a vote;
    every data and voting tree all-gathers its rows' leaf ids once, and
    every booster all-gathers once as it is built (the ranks' training
    sets agree, ``GBDT._check_same_data``)."""
    if mode in ("data", "data_quant"):
        T = len(grower.round_counts)
        R = sum(r for r, _ in grower.round_counts)
        q = "_int8" if mode == "data_quant" else ""
        other = "" if q else "_int8"
        return {"fused_frontier_accumulate" + q: T + R,
                "fused_slot_order" + q: T + R,
                "fused_sibling_scan" + q: T + R,
                "fused_frontier_splits" + q: 0, "histogram_pallas": 0,
                **{k + other: 0 for k in F32_ENTRIES},
                "all_reduce": (3 if q else 2) * T + R,
                "all_gather": T + 1}
    T, S = len(grower.steps), sum(grower.steps)
    out = {"histogram_pallas": T + S, "fused_frontier_accumulate": 0,
           "fused_frontier_splits": 0,
           **{k: 0 for k in INT8_ENTRIES}}
    if mode == "feature":
        out.update(fused_sibling_scan=T + S, all_reduce=S,
                   all_gather=T + S + 1)
    else:
        out.update(fused_sibling_scan=2 * T + 3 * S,
                   all_reduce=3 * T + 2 * S, all_gather=3 * T + 2 * S + 1)
    return out


def sharded_worker(rank, tmp, device, rows, rounds, leaves, counted):
    """One rank of ``phase_sharded_train`` (a spawned process): the gloo
    group over a FileStore in ``tmp``, this rank's rows binned through
    B3 with mappers every rank agrees on (``construct_distributed``,
    checked against B3's plain version), then the five modes on the
    whole dataset, each run's model text, seconds, launches and
    collectives written to ``tmp``.  ``counted``: hold the launches to
    ``shard_expected`` (False where the kernels' plain versions run)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import datetime
    import hashlib

    import torch.distributed as dist

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.parallel import collectives
    from lightgbm_tpu_torch.parallel.dist_data import construct_distributed
    from lightgbm_tpu_torch.parallel.learners import contiguous_layout
    from lightgbm_tpu_torch.parallel.network import use_group
    from lightgbm_tpu_torch.testing import higgs_like
    if device == "cuda":
        torch.cuda.set_device(0)
    group = dist.ProcessGroupGloo(
        dist.FileStore(os.path.join(tmp, "store"), SHARD_WORLD), rank,
        SHARD_WORLD, datetime.timedelta(seconds=SHARD_TIMEOUT_S))

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()
        collectives.psum_tiered(torch.zeros(1, dtype=torch.int64), group)

    X, y = higgs_like(rows, seed=11)
    mine = contiguous_layout(rows, SHARD_WORLD).rows(rank)
    reset_training_counts()
    local = construct_distributed(X[mine], label=y[mine], group=group,
                                  device=device)
    b3 = kernel_launches()["ingest"]
    plain = local._binner_for().plain(
        torch.from_numpy(np.ascontiguousarray(X[mine])).to(device))
    digest = hashlib.sha256(json.dumps(
        [m.to_dict() for m in local.bin_mappers],
        sort_keys=True).encode()).hexdigest().encode()
    out = {"rank": rank, "backend": group.name(), "rows": len(mine),
           "b3_launches": b3,
           "b3_max_abs_err": max_abs_err(local.binned_t.int(), plain.int()),
           "mappers_agree": len(set(collectives.all_gather_bytes(
               digest, group))) == 1, "modes": {}}
    del local, plain
    with use_group(group):
        ds = lt.Dataset(X, label=y, device=device).construct()
        for name, params, twin in SHARD_MODES:
            params = dict(params, num_leaves=leaves)
            sync()
            reset_training_counts()
            collectives.reset_op_counts()
            t0 = time.perf_counter()
            bst = lt.train(params, ds, rounds, verbose_eval=False)
            if device == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            grower = bst.boosting.grower
            rec = {"s_per_tree": seconds / rounds,
                   "launches": kernel_launches(),
                   "collectives": dict(collectives.op_counts),
                   "leaves_per_tree": [m.num_leaves for m in bst.models],
                   "expected": shard_expected(name, grower),
                   "hist_sums_per_tree": hist_sums_per_tree(name, grower),
                   "num_bins": grower.B,
                   "b5_modes": dict(fused.scan_modes)}
            if counted:
                got = dict(rec["launches"], **rec["collectives"])
                bad = {k: (got[k], v) for k, v in rec["expected"].items()
                       if got[k] != v}
                if bad:
                    raise AssertionError(f"rank {rank} {name}: (counted, "
                                         f"expected) {bad}")
            with open(os.path.join(tmp, f"{name}_{rank}.txt"), "w") as f:
                f.write(bst.model_to_string())
            if twin == "plain":
                sync()
                saved = plain_kernels()
                reset_training_counts()
                try:
                    bst_p = lt.train(params, ds,
                                     min(rounds, SHARD_PLAIN_ROUNDS),
                                     verbose_eval=False)
                finally:
                    restore_kernels(saved)
                if any(kernel_launches().values()):
                    raise AssertionError("launch counts rose with no "
                                         f"kernel launched: "
                                         f"{kernel_launches()}")
                with open(os.path.join(tmp, f"{name}_plain_{rank}.txt"),
                          "w") as f:
                    f.write(bst_p.model_to_string())
            out["modes"][name] = rec
    with open(os.path.join(tmp, f"rank_{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_sharded_train(lt, f32_run, smi, device="cuda", rows=None,
                        leaves=255, counted=True) -> dict:
    """Sharded training (queue A9) on the card: the serial twins in this
    process, then ``SHARD_WORLD`` spawned ranks (``sharded_worker``);
    fails if a rank fails or any text differs from its twin.  Returns
    rank 0's launches summed over the five modes."""
    import shutil
    import tempfile

    import torch.multiprocessing as torch_mp
    t_phase = time.perf_counter()
    rows = rows or TRAIN_ROWS
    ds = f32_run["ds"]
    refs, serial_s = {}, {}
    for ref, params in (("rounds", TRAIN_PARAMS), ("serial", SERIAL_PARAMS)):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(dict(params, num_leaves=leaves), ds, SHARD_ROUNDS,
                       verbose_eval=False)
        if device == "cuda":
            torch.cuda.synchronize()
        serial_s[ref] = (time.perf_counter() - t0) / SHARD_ROUNDS
        refs[ref] = trees_of(bst.model_to_string())
        del bst
    emit({"phase": "sharded_train", "backend": "gloo",
          "why": "NCCL refuses two ranks on one GPU; the one card's two "
                 "ranks meet in an explicit gloo group (FileStore), which "
                 "stages the card's tensors through the host"})
    tmp = tempfile.mkdtemp(prefix="lgbt-shard-")
    try:
        ctx = torch_mp.start_processes(
            sharded_worker, args=(tmp, device, rows, SHARD_ROUNDS, leaves,
                                  counted),
            nprocs=SHARD_WORLD, join=False, start_method="spawn")
        deadline = time.perf_counter() + SHARD_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError(f"the ranks ran past {SHARD_TIMEOUT_S} s")
        ranks = []
        for r in range(SHARD_WORLD):
            with open(os.path.join(tmp, f"rank_{r}.json")) as f:
                ranks.append(json.load(f))
        texts = {}
        for name, _, ref in SHARD_MODES:
            for r in range(SHARD_WORLD):
                with open(os.path.join(tmp, f"{name}_{r}.txt")) as f:
                    texts[(name, r)] = trees_of(f.read())
                if ref == "plain":
                    with open(os.path.join(tmp,
                                           f"{name}_plain_{r}.txt")) as f:
                        texts[(name + "_plain", r)] = trees_of(f.read())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for rk in ranks:
        if rk["backend"] != "gloo" or not rk["mappers_agree"] \
                or rk["b3_max_abs_err"] != 0.0:
            raise AssertionError(f"rank {rk['rank']}: {rk['backend']}, "
                                 f"mappers agree {rk['mappers_agree']}, B3 "
                                 f"vs plain {rk['b3_max_abs_err']}")
        if counted and rk["b3_launches"] <= 0:
            raise AssertionError(f"rank {rk['rank']} never launched B3")
    modes = {}
    for name, params, ref in SHARD_MODES:
        want = (texts[(name + "_plain", 0)] if ref == "plain"
                else refs[ref])
        # the plain run's trees are the first trees
        head = ((lambda t: head_trees(t, SHARD_PLAIN_ROUNDS))
                if ref == "plain" else (lambda t: t))
        for r in range(SHARD_WORLD):
            if head(texts[(name, r)]) != head(want):
                raise AssertionError(f"{name} on rank {r}: the trees differ "
                                     f"from the {ref} twin")
        recs = [rk["modes"][name] for rk in ranks]
        hist_bytes = histogram_payload(params, recs[0]["num_bins"])
        modes[name] = {
            "s_per_tree": [rec["s_per_tree"] for rec in recs],
            "serial_s_per_tree": serial_s[
                "serial" if params.get("tpu_tree_growth") == "serial"
                else "rounds"],
            "leaves_per_tree": recs[0]["leaves_per_tree"],
            "launches_rank0": {k: v for k, v in recs[0]["launches"].items()
                               if v},
            "expected_rank0": recs[0]["expected"],
            "collectives_rank0": recs[0]["collectives"],
            "all_reduces_per_tree":
                recs[0]["collectives"]["all_reduce"] / SHARD_ROUNDS,
            "all_reduce_bytes_per_tree":
                recs[0]["collectives"]["all_reduce_bytes"] / SHARD_ROUNDS,
            "hist_payload_bytes": hist_bytes,
            "hist_payload_bytes_per_tree":
                hist_bytes * recs[0]["hist_sums_per_tree"],
            "twin": ref,
            "equals_serial": texts[(name, 0)] == refs["serial"]}
    summed = {}
    for name in modes:
        for k, v in ranks[0]["modes"][name]["launches"].items():
            summed[k] = summed.get(k, 0) + v
    summed["ingest"] = summed.get("ingest", 0) + ranks[0]["b3_launches"]
    emit({"phase": "sharded_train", "world": SHARD_WORLD,
          "rows": rows, "rounds": SHARD_ROUNDS, "num_leaves": leaves,
          "rank_rows": [rk["rows"] for rk in ranks],
          "b3_max_abs_err": [rk["b3_max_abs_err"] for rk in ranks],
          "modes": modes, "nvidia_smi": smi,
          "phase_s": time.perf_counter() - t_phase,
          "checked": "data text = serial (rounds) text; data_quant text = "
                     "its plain-version run's; feature and voting (top_k = "
                     "28) text = the serial grower's; voting_top4 text = "
                     "its plain-version run's; both ranks equal; "
                     "launches and collectives exact per rank"})
    return summed


# hybrid_train (queue A9, rest): four ranks, four spawned processes on
# the one card in a gloo group over a FileStore, LGBM_TPU_NUM_SLICES=2
# (a 2 x 2 two-tier mesh), HYBRID_ROWS rows of the training run's
# HIGGS-width data, 255 leaves, 255 bins: HYBRID_ROUNDS rounds of f32
# data hierarchical (the serial rounds twin's text) and flat (the same
# text), quantized hierarchical and flat (one text); VOTING_ROUNDS of
# voting at top_k 4 per slice (its plain-version run's text) and one
# round flat (whether its tree is the per-slice vote's first is printed);
# one 2-D tree on a (data, feature) mesh (the serial grower's tree); and
# the elastic shrink, quantized with deterministic rounding (a world-
# free model, and a third of f32's bytes a sum): 4 ranks train
# ELASTIC_FIRST rounds with a bundle every 2, a membership probe with
# slice 1's transport stalled fails on ranks 0 and 1, ranks 2 and 3
# exit, and the survivors resume to ELASTIC_ROUNDS in a fresh 2-rank
# group, equal to 2 ranks from scratch.  Cuts, so the phase stays under
# 150 s: 1,000,000 rows to 400,000, voting's 3 rounds to 2 per slice and
# 1 flat (gloo's host round-trips, ~60-150 ms a 22 MB data round and
# ~7-10 ms a voting sum, not the rows, set the time), and per-slice
# voting's plain-version twin to HYBRID_PLAIN_ROUNDS (its first tree)
HYBRID_WORLD, HYBRID_SLICES, HYBRID_ROUNDS, VOTING_ROUNDS = 4, 2, 3, 2
HYBRID_PLAIN_ROUNDS = 1
HYBRID_ROWS, HYBRID_VALID_ROWS, HYBRID_TIMEOUT_S = 400_000, 50_000, 600
ELASTIC_FIRST, ELASTIC_ROUNDS = 4, 6
ELASTIC_PARAMS = dict(QUANT_PARAMS, tree_learner="data",
                      stochastic_rounding=False)
HYBRID_TOPK = 4
HYBRID_MODES = (
    # name, params, LGBM_TPU_HIER_REDUCE, rounds, twin
    ("data_hier", dict(TRAIN_PARAMS, tree_learner="data"), "1",
     HYBRID_ROUNDS, "serial"),
    ("data_flat", dict(TRAIN_PARAMS, tree_learner="data"), "0",
     HYBRID_ROUNDS, "data_hier"),
    ("quant_hier", dict(QUANT_PARAMS, tree_learner="data"), "1",
     HYBRID_ROUNDS, None),
    ("quant_flat", dict(QUANT_PARAMS, tree_learner="data"), "0",
     HYBRID_ROUNDS, "quant_hier"),
    ("voting_slice", dict(SERIAL_PARAMS, tree_learner="voting",
                          top_k=HYBRID_TOPK), "1", VOTING_ROUNDS, "plain"),
    ("voting_flat", dict(SERIAL_PARAMS, tree_learner="voting",
                         top_k=HYBRID_TOPK), "0", 1, None),
)


def hybrid_expected(mode: str, grower, hier: bool, B: int) -> dict:
    """A rank's exact launches and per-tier collectives over T trees (R
    rounds run, or S split steps) on the 2 x 2 mesh: the data modes'
    kernels as ``shard_expected``; each tree's peaks one flat all-reduce
    (``dcn+ici``); every histogram sum (the root, ``KCAP`` slots a
    round) one all-reduce a tier hierarchical (``ici`` then ``dcn``,
    each moving ``hist_payload_bytes``), one over ``dcn+ici`` flat, as
    are the quantized root totals; voting per slice sums each search's
    whole histograms over ``ici``, gathers the votes and sums the
    elected ones over ``dcn``; every tree gathers its leaf ids over the
    mesh, every booster its data check over the group."""
    from lightgbm_tpu_torch.ops.histogram import hist_payload_bytes
    quant = mode.startswith("quant")
    out = {"all_gather@flat": 1}
    if mode.startswith("voting"):
        T, S = len(grower.steps), sum(grower.steps)
        out.update({
            "histogram_pallas": T + S, "fused_sibling_scan": 2 * T + 3 * S,
            "fused_frontier_accumulate": 0, "fused_frontier_splits": 0})
        full = hist_payload_bytes(28, B)
        vote = hist_payload_bytes(HYBRID_TOPK, B)
        if hier:
            out.update({
                "all_reduce@dcn+ici": T, "all_reduce@ici": 2 * T + S,
                "all_reduce@ici_bytes": 24 * T + full * (T + 2 * S),
                "all_reduce@dcn": 2 * T + 2 * S,
                "all_reduce@dcn_bytes": 24 * T + vote * (T + 2 * S),
                "all_gather@dcn": 2 * T + 2 * S, "all_gather@dcn+ici": T})
        else:
            out.update({"all_reduce@dcn+ici": 3 * T + 2 * S,
                        "all_gather@dcn+ici": 3 * T + 2 * S})
        return out
    T = len(grower.round_counts)
    R = sum(r for r, _ in grower.round_counts)
    q = "_int8" if quant else ""
    other = "" if q else "_int8"
    out.update({"fused_frontier_accumulate" + q: T + R,
                "fused_slot_order" + q: T + R,
                "fused_sibling_scan" + q: T + R,
                "fused_frontier_splits" + q: 0, "histogram_pallas": 0,
                **{k + other: 0 for k in F32_ENTRIES},
                "all_gather@dcn+ici": T})
    hist = hist_payload_bytes(28, B, quant=quant) * (T + R * grower.KCAP)
    sums = (2 if quant else 1) * T + R       # histograms (+ root totals)
    if hier:
        tier_bytes = hist + (24 * T if quant else 0)
        out.update({"all_reduce@dcn+ici": T, "all_reduce@ici": sums,
                    "all_reduce@dcn": sums, "all_reduce@ici_bytes":
                    tier_bytes, "all_reduce@dcn_bytes": tier_bytes})
    else:
        out["all_reduce@dcn+ici"] = T + sums
    return out


def twod_expected(grower) -> dict:
    """The 2-D tree's launches and collectives on the (data, feature)
    mesh: B6 and B5 at the root and each split step; over the data axis
    the peaks, the root and each smaller child's histogram of this
    rank's features; over the feature axis each step's row sides and
    each search's gathered candidates."""
    from lightgbm_tpu_torch.ops.histogram import hist_payload_bytes
    S = sum(grower.steps)
    local = hist_payload_bytes(grower.F, grower.B)
    return {"histogram_pallas": 1 + S, "fused_sibling_scan": 1 + S,
            "fused_frontier_accumulate": 0, "all_reduce@data": 2 + S,
            "all_reduce@data_bytes": 24 + local * (1 + S),
            "all_reduce@feature": S,
            "all_reduce@feature_bytes": S * grower.n,
            "all_gather@feature": 1 + S}


def _sync_group(device, group):
    from lightgbm_tpu_torch.parallel import collectives
    if device == "cuda":
        torch.cuda.synchronize()
    collectives.psum_tiered(torch.zeros(1, dtype=torch.int64), group)


def on_flat_group(expected: dict) -> dict:
    """``hybrid_expected`` of a flat-route mode on a bare group (the
    elastic survivors' 1 x 2 world): every collective's tier is
    ``flat``."""
    out = {}
    for k, v in expected.items():
        k = k.replace("@dcn+ici", "@flat")
        out[k] = out.get(k, 0) + v
    return out


def _counted_ok(rank, name, got, expected, counted) -> None:
    """Fails unless each expected collective (a key with a tier, ``@``)
    and, where ``counted``, each expected launch count is ``got``'s."""
    bad = {k: (got.get(k, 0), v) for k, v in expected.items()
           if (counted or "@" in k) and got.get(k, 0) != v}
    if bad:
        raise AssertionError(f"rank {rank} {name}: (counted, expected) "
                             f"{bad}")


def hybrid_worker(rank, tmp, device, rows, rounds, leaves, counted):
    """One rank of ``phase_hybrid_train`` (a spawned process): the gloo
    group over a FileStore in ``tmp`` (``parallel.network.new_group``),
    the Dataset of every row through B3, the modes of ``HYBRID_MODES``,
    the 2-D tree and the elastic shrink; each run's model text,
    seconds, launches, collectives and plan written to ``tmp``.
    ``counted``: hold the launches to ``hybrid_expected`` (False where
    the kernels' plain versions run).  Ends with ``os._exit``: a rank
    whose slice was lost keeps a transport thread blocked in the old
    group, which must not hold the process at exit."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    out = {"rank": rank, "modes": {}}
    try:
        _hybrid_rank(rank, tmp, device, rows, rounds, leaves, counted, out)
    except BaseException as e:      # noqa: BLE001 - reported to the parent
        import traceback
        out["error"] = "".join(traceback.format_exception(e))
    with open(os.path.join(tmp, f"hybrid_rank_{rank}.json"), "w") as f:
        json.dump(out, f)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def _hybrid_rank(rank, tmp, device, rows, rounds, leaves, counted, out):
    import torch.distributed as dist

    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.grower import GrowerConfig, SerialGrower
    from lightgbm_tpu_torch.ops import fused
    from lightgbm_tpu_torch.ops import predict_kernels as pk
    from lightgbm_tpu_torch.parallel import collectives, learners
    from lightgbm_tpu_torch.parallel.network import new_group, use_group
    from lightgbm_tpu_torch.resilience import (ChaosRegistry,
                                               ResilienceConfig,
                                               SliceLostError,
                                               membership_probe,
                                               shrink_and_resume)
    from lightgbm_tpu_torch.testing import higgs_like
    if device == "cuda":
        torch.cuda.set_device(0)
    os.environ["LGBM_TPU_NUM_SLICES"] = str(HYBRID_SLICES)
    os.environ.pop("LGBM_TPU_SLICE_DEVICES", None)
    group = new_group(dist.FileStore(os.path.join(tmp, "store"),
                                     HYBRID_WORLD), rank, HYBRID_WORLD,
                      HYBRID_TIMEOUT_S, prefix="hybrid")
    X, y = higgs_like(rows, seed=11)
    Xv, _ = higgs_like(HYBRID_VALID_ROWS, seed=12)

    def text_to(name, text):
        with open(os.path.join(tmp, f"{name}_{rank}.txt"), "w") as f:
            f.write(text)

    def counts():
        return dict(kernel_launches(), **collectives.op_counts)

    reset_training_counts()
    with use_group(group):
        ds = lt.Dataset(X, label=y, device=device).construct()
        out["b3_launches"] = kernel_launches()["ingest"]
        for name, params, hier, mode_rounds, twin in HYBRID_MODES:
            params = dict(params, num_leaves=leaves)
            mode_rounds = min(rounds, mode_rounds)
            os.environ["LGBM_TPU_HIER_REDUCE"] = hier
            _sync_group(device, group)
            reset_training_counts()
            collectives.reset_op_counts()
            t0 = time.perf_counter()
            bst = lt.train(params, ds, mode_rounds, verbose_eval=False)
            if device == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            b = bst.boosting
            got = counts()
            rec = {"s_per_tree": seconds / mode_rounds,
                   "launches": kernel_launches(),
                   "collectives": dict(collectives.op_counts),
                   "plan": b.collective_plan.summary(),
                   "mesh": dict(b.group.shape),
                   "leaves_per_tree": [m.num_leaves for m in bst.models],
                   "expected": hybrid_expected(name, b.grower, hier == "1",
                                               b.grower.B),
                   "b5_modes": dict(fused.scan_modes)}
            rec["num_bins"] = b.grower.B
            _counted_ok(rank, name, got, rec["expected"], counted)
            text_to(name, bst.model_to_string())
            if twin == "plain":
                _sync_group(device, group)
                saved = plain_kernels()
                reset_training_counts()
                try:
                    bst_p = lt.train(params, ds,
                                     min(mode_rounds, HYBRID_PLAIN_ROUNDS),
                                     verbose_eval=False)
                finally:
                    restore_kernels(saved)
                if any(kernel_launches().values()):
                    raise AssertionError("launch counts rose with no "
                                         f"kernel launched: "
                                         f"{kernel_launches()}")
                text_to(name + "_plain", bst_p.model_to_string())
            out["modes"][name] = rec
            del bst, b

        # (e) one 2-D tree on a (data, feature) mesh, the staged arm
        os.environ.pop("LGBM_TPU_HIER_REDUCE")
        meta = ds.feature_meta()
        cfg = GrowerConfig(num_leaves=leaves, num_bins=int(meta.max_num_bin),
                           hp=Config.from_params(
                               dict(TRAIN_PARAMS)).split_hyperparams())
        yt = torch.as_tensor(y, device=device)
        grad, hess = 0.5 - yt, torch.full_like(yt, 0.25)
        mesh2 = learners.make_mesh(group, (learners.DATA_AXIS,
                                           learners.FEATURE_AXIS), (2, 2))
        i = mesh2.coords[learners.DATA_AXIS]
        mine = torch.as_tensor(learners.contiguous_layout(rows, 2).rows(i),
                               device=device)
        serial = SerialGrower(ds.binned_t, meta, cfg)
        ref, ref_leaf = serial.grow(grad, hess, torch.ones_like(grad))
        _sync_group(device, group)
        reset_training_counts()
        collectives.reset_op_counts()
        t0 = time.perf_counter()
        g2 = learners.create_parallel_grower("data_feature", mesh2,
                                             ds.binned_t, meta, cfg)
        tree, leaf = g2.grow(grad[mine], hess[mine],
                             torch.ones(len(mine), device=device))
        if device == "cuda":
            torch.cuda.synchronize()
        rec = {"seconds": time.perf_counter() - t0,
               "launches": kernel_launches(),
               "collectives": dict(collectives.op_counts),
               "expected": twod_expected(g2), "steps": sum(g2.steps),
               "equal_to_serial": all(
                   torch.equal(getattr(tree, f).cpu(),
                               getattr(ref, f).cpu())
                   for f in tree._fields if f != "num_leaves")
               and int(tree.num_leaves) == int(ref.num_leaves)
               and torch.equal(leaf, ref_leaf[mine])}
        _counted_ok(rank, "2d", counts(), rec["expected"], counted)
        if not rec["equal_to_serial"]:
            raise AssertionError(f"rank {rank}: the 2-D tree differs from "
                                 "the serial grower's")
        out["modes"]["2d"] = rec
        del serial, g2

        # (f) elastic: 4 ranks, a bundle every 2 rounds, then slice 1's
        # transport stalls and the probe fails on the survivors
        params = dict(ELASTIC_PARAMS, num_leaves=leaves)
        ck = os.path.join(tmp, f"elastic_{rank}", "m.txt")
        _sync_group(device, group)
        reset_training_counts()
        collectives.reset_op_counts()
        t0 = time.perf_counter()
        first = lt.train(params, ds, ELASTIC_FIRST, verbose_eval=False,
                         snapshot_freq=2, snapshot_out=ck)
        b = first.boosting
        rec = {"first_s": time.perf_counter() - t0,
               "first_plan": b.collective_plan.summary(),
               "first_launches": kernel_launches(),
               "first_expected": hybrid_expected(
                   "quant_elastic", b.grower, b.collective_plan.hierarchical,
                   b.grower.B)}
        _counted_ok(rank, "elastic first", counts(), rec["first_expected"],
                    counted)
        del first, b
        stalled = (2, 3)
        chaos = ChaosRegistry(",".join(
            f"allgather.stall@{i}:rank={r}:sec=3600"
            for r in stalled for i in range(4)), seed=11)
        t0 = time.perf_counter()
        try:
            membership_probe(
                chaos.wrap_allgather(lambda p: collectives.all_gather_bytes(
                    p, group), rank), world=HYBRID_WORLD, rank=rank,
                config=ResilienceConfig(deadline_s=3.0, max_retries=2,
                                        base_backoff_s=0.01))
            rec["probe"] = "committed"
        except SliceLostError:
            rec["probe"] = "SliceLostError"
        rec["probe_s"] = time.perf_counter() - t0
        out["modes"]["elastic"] = rec
        if rank in stalled:
            rec["exited"] = True
            return
    # the survivors' fresh group: ranks 0 and 1 of a new FileStore
    survivors = new_group(dist.FileStore(os.path.join(tmp, "store2"), 2),
                          rank, 2, HYBRID_TIMEOUT_S, prefix="survivors")
    with use_group(survivors):
        _sync_group(device, survivors)
        reset_training_counts()
        collectives.reset_op_counts()
        pk.reset_launch_counts()
        t0 = time.perf_counter()
        res = shrink_and_resume(params, ds, os.path.dirname(ck) + "/m.txt"
                                ".ckpt", num_slices=HYBRID_SLICES,
                                devices_per_slice=HYBRID_WORLD
                                // HYBRID_SLICES, lost_slices=1,
                                num_boost_round=ELASTIC_ROUNDS,
                                verbose_eval=False)
        rec["resume_s"] = time.perf_counter() - t0
        rec["resume_launches"] = kernel_launches()
        rec["resume_expected"] = on_flat_group(hybrid_expected(
            "quant_elastic", res.boosting.grower, False,
            res.boosting.grower.B))
        _counted_ok(rank, "elastic resume", counts(),
                    rec["resume_expected"], counted)
        rec["resume_world"] = res.boosting.world
        rec["resume_mesh_shape"] = res.boosting._row_layout()["mesh_shape"]
        text_to("elastic_resumed", res.model_to_string())
        rec["predict_b1_launches"] = predict_vs_plain_on(pk, res, Xv,
                                                         device, counted)
        _sync_group(device, survivors)
        reset_training_counts()
        collectives.reset_op_counts()
        fresh = lt.train(params, ds, ELASTIC_ROUNDS, verbose_eval=False)
        rec["fresh_launches"] = kernel_launches()
        rec["fresh_expected"] = on_flat_group(hybrid_expected(
            "quant_elastic", fresh.boosting.grower, False,
            fresh.boosting.grower.B))
        _counted_ok(rank, "elastic fresh", counts(), rec["fresh_expected"],
                    counted)
        text_to("elastic_fresh", fresh.model_to_string())


def predict_vs_plain_on(pk, bst, Xv, device, counted=True) -> int:
    """``predict_vs_plain`` on ``device``: ``Booster.predict`` of ``Xv``
    through B1's scores mode, bit for bit against its plain version;
    returns the launches, held (where ``counted``) to one a
    ``PREDICT_CHUNK_ROWS`` chunk."""
    from lightgbm_tpu_torch.ops import planner
    pk.reset_launch_counts()
    raw = bst.predict(Xv, raw_score=True)
    launches = pk.launch_counts[KERNEL + "[scores]"]
    dev = bst._device_forest(bst._forest(0, len(bst.models)))
    plain = pk.traverse_plain(dev, torch.from_numpy(
        np.ascontiguousarray(Xv, np.float32)).to(device), 1,
        emit_scores=True)[0].cpu().numpy().astype(np.float64)
    if not np.array_equal(raw.view(np.uint64), plain.view(np.uint64)):
        raise AssertionError("the resumed Booster.predict differs from "
                             "B1's plain version")
    want = -(-len(Xv) // planner.PREDICT_CHUNK_ROWS)
    if counted and launches != want:
        raise AssertionError(f"the resumed Booster.predict launched B1 "
                             f"{launches} times, not {want}")
    return launches


def phase_hybrid_train(lt, smi, device="cuda", rows=None, leaves=255,
                       counted=True) -> dict:
    """Two tiers, the 2-D layout and the elastic shrink (queue A9, rest)
    on the card: the serial twins in this process, then ``HYBRID_WORLD``
    spawned ranks (``hybrid_worker``); fails if a rank fails or hangs,
    or a text, a launch count or a tier's collectives differ from what
    they are held to.  Returns rank 0's launches summed over its runs."""
    import shutil
    import tempfile

    import torch.multiprocessing as torch_mp

    from lightgbm_tpu_torch.ops.histogram import hist_payload_bytes
    t_phase = time.perf_counter()
    from lightgbm_tpu_torch.testing import higgs_like
    rows = rows or HYBRID_ROWS
    X, y = higgs_like(rows, seed=11)
    reset_training_counts()
    ds = lt.Dataset(X, label=y, device=device).construct()
    b3_lone = kernel_launches()["ingest"]
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = lt.train(dict(TRAIN_PARAMS, num_leaves=leaves), ds,
                    HYBRID_ROUNDS, verbose_eval=False)
    if device == "cuda":
        torch.cuda.synchronize()
    serial_s = (time.perf_counter() - t0) / HYBRID_ROUNDS
    serial_text = trees_of(twin.model_to_string())
    del twin, ds
    tmp = tempfile.mkdtemp(prefix="lgbt-hybrid-")
    try:
        ctx = torch_mp.start_processes(
            hybrid_worker, args=(tmp, device, rows, HYBRID_ROUNDS, leaves,
                                 counted),
            nprocs=HYBRID_WORLD, join=False, start_method="spawn")
        deadline = time.perf_counter() + HYBRID_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError(f"the ranks ran past {HYBRID_TIMEOUT_S}"
                                   " s")
        ranks = []
        for r in range(HYBRID_WORLD):
            with open(os.path.join(tmp, f"hybrid_rank_{r}.json")) as f:
                ranks.append(json.load(f))
        for rk in ranks:
            if "error" in rk:
                raise AssertionError(f"hybrid_train rank {rk['rank']}:\n"
                                     f"{rk['error']}")
        texts = {}
        names = [n for n, *_ in HYBRID_MODES] + ["voting_slice_plain"]
        for r in range(HYBRID_WORLD):
            for name in names:
                with open(os.path.join(tmp, f"{name}_{r}.txt")) as f:
                    texts[(name, r)] = trees_of(f.read())
        for r in range(2):
            for name in ("elastic_resumed", "elastic_fresh"):
                with open(os.path.join(tmp, f"{name}_{r}.txt")) as f:
                    texts[(name, r)] = trees_of(f.read())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failed = []
    for rk in ranks:
        if rk["b3_launches"] != b3_lone:
            failed.append(f"rank {rk['rank']}: B3 {rk['b3_launches']} "
                          f"launches, a lone construct {b3_lone}")
    want = {"data_hier": serial_text,
            "data_flat": texts[("data_hier", 0)],
            "quant_hier": texts[("quant_hier", 0)],
            "quant_flat": texts[("quant_hier", 0)],
            "voting_slice": texts[("voting_slice_plain", 0)],
            "voting_flat": texts[("voting_flat", 0)]}
    for name, text in want.items():
        # the plain run's trees are the first trees
        head = ((lambda t: head_trees(t, HYBRID_PLAIN_ROUNDS))
                if name == "voting_slice" else (lambda t: t))
        for r in range(HYBRID_WORLD):
            if head(texts[(name, r)]) != head(text):
                failed.append(f"{name} on rank {r}: the trees differ from "
                              "its twin")
    for r in range(2):
        if texts[("elastic_resumed", r)] != texts[("elastic_fresh", 0)]:
            failed.append(f"elastic on rank {r}: the resumed trees differ "
                          "from 2 ranks' from scratch")
    modes = {}
    r0 = ranks[0]["modes"]
    for name, params, hier, mode_rounds, _ in HYBRID_MODES:
        mode_rounds = min(HYBRID_ROUNDS, mode_rounds)
        rec = r0[name]
        if rec["plan"]["mesh_shape"] != [HYBRID_SLICES, HYBRID_WORLD
                                         // HYBRID_SLICES]:
            failed.append(f"{name}: mesh {rec['plan']['mesh_shape']}")
        if rec["plan"]["hierarchy_elected"] != (hier == "1"):
            failed.append(f"{name}: hierarchy_elected "
                          f"{rec['plan']['hierarchy_elected']}")
        c = rec["collectives"]
        modes[name] = {
            "s_per_tree": [rk["modes"][name]["s_per_tree"] for rk in ranks],
            "serial_s_per_tree": serial_s,
            "leaves_per_tree": rec["leaves_per_tree"],
            "elected": rec["plan"]["elected"],
            "plan": rec["plan"],
            "tiers": {k: v for k, v in c.items() if "@" in k},
            "rounds": mode_rounds,
            "all_reduces_per_tree": c["all_reduce"] / mode_rounds,
            "hist_payload_bytes": hist_payload_bytes(
                28, rec["num_bins"],
                quant=bool(params.get("use_quantized_grad"))),
            "launches_rank0": {k: v for k, v in rec["launches"].items()
                               if v},
            "expected_rank0": rec["expected"]}
    modes["voting_slice"]["first_tree_equals_flat_voting"] = (
        head_trees(texts[("voting_slice", 0)], 1)
        == head_trees(texts[("voting_flat", 0)], 1))
    el = ranks[0]["modes"]["elastic"]
    for rk in ranks:
        e = rk["modes"]["elastic"]
        if e["probe"] != "SliceLostError":
            failed.append(f"rank {rk['rank']}: the probe {e['probe']}")
        if rk["rank"] >= 2 and not e.get("exited"):
            failed.append(f"rank {rk['rank']} did not exit")
    if el.get("resume_world") != 2 or el.get("resume_mesh_shape") != [1, 2]:
        failed.append(f"elastic: resumed world {el.get('resume_world')}, "
                      f"mesh {el.get('resume_mesh_shape')}")
    summed = {}
    for name in list(r0):
        for key in ("launches", "first_launches", "resume_launches",
                    "fresh_launches"):
            for k, v in r0[name].get(key, {}).items():
                summed[k] = summed.get(k, 0) + v
    summed["ingest"] = summed.get("ingest", 0) + ranks[0]["b3_launches"]
    summed[KERNEL + "[scores]"] = el.get("predict_b1_launches", 0)
    emit({"phase": "hybrid_train", "world": HYBRID_WORLD,
          "mesh": [HYBRID_SLICES, HYBRID_WORLD // HYBRID_SLICES],
          "rows": rows, "rounds": HYBRID_ROUNDS, "num_leaves": leaves,
          "backend": "gloo", "modes": modes,
          "twod": {k: r0["2d"][k] for k in ("seconds", "steps",
                                            "equal_to_serial",
                                            "collectives", "expected")},
          "elastic": {k: el.get(k) for k in (
              "first_s", "first_plan", "probe", "probe_s", "resume_s",
              "resume_world", "resume_mesh_shape",
              "predict_b1_launches")},
          "nvidia_smi": smi, "phase_s": time.perf_counter() - t_phase,
          "failed": failed,
          "checked": "data hier text = serial rounds twin's = data flat; "
                     "quant hier = quant flat; voting per slice = its "
                     "plain-version run's; 2-D tree = serial grower's; "
                     "elastic resumed = 2 ranks from scratch, B1 predict "
                     "= plain; per-rank launches and per-tier collectives "
                     "exact in every mode, the 2-D tree and the elastic "
                     "first, resumed and from-scratch runs"})
    if failed:
        raise AssertionError(f"hybrid_train: {failed}")
    return summed



def stream_dataset(lt, X, y, spill, block_rows, push_rows=None):
    """``Dataset.from_sample`` of the first ``STREAM_SAMPLE_ROWS`` rows on
    the card and ``push_rows`` of every row in ``STREAM_PUSH_ROWS``-row
    f32 chunks (``spill``: the store's directory, or None for the
    resident matrix); returns (dataset, seconds)."""
    push_rows = push_rows or STREAM_PUSH_ROWS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset.from_sample(X[:STREAM_SAMPLE_ROWS], len(X), spill=spill,
                                spill_block_rows=block_rows, device="cuda")
    for s in range(0, len(X), push_rows):
        ds.push_rows(X[s:s + push_rows])
    ds.set_label(y)
    torch.cuda.synchronize()
    return ds, time.perf_counter() - t0


def stream_run(lt, ds, params, rounds) -> dict:
    """``rounds`` ``update()`` calls of a fresh booster on ``ds``: the
    booster, seconds a tree, and the card's peak bytes above what was
    allocated before (``torch.cuda.max_memory_allocated``)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bst = lt.Booster(dict(params), train_set=ds)
    for _ in range(rounds):
        bst.update()
    torch.cuda.synchronize()
    return {"bst": bst, "s_per_tree": (time.perf_counter() - t0) / rounds,
            "device_peak_bytes": torch.cuda.max_memory_allocated() - base}


def stream_host_worker(_rank, tmp):
    """``phase_stream_train``'s host reading in a fresh process (spawned):
    a small streamed run first (CUDA, the kernels and the allocator
    warm), then the phase's spilled construct and ``STREAM_SHORT_ROUNDS``
    streamed trees of the training rows, while a thread samples VmRSS
    every millisecond.  Writes the growth of VmRSS over that run (its
    peak less its value at the start, the rows already made) beside
    ``predict_host_peak_bytes`` to ``tmp``/host.json."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.data import host_rss_bytes, host_rss_peak_bytes
    from lightgbm_tpu_torch.ops import planner
    from lightgbm_tpu_torch.testing import higgs_like
    X, y = higgs_like(TRAIN_ROWS, seed=11)
    n, F = X.shape
    warm, _ = stream_dataset(lt, X[:STREAM_SAMPLE_ROWS], y[:STREAM_SAMPLE_ROWS],
                             os.path.join(tmp, "warm"), STREAM_BLOCK_ROWS // 4)
    stream_run(lt, warm, TRAIN_PARAMS, 1)
    del warm
    start = host_rss_bytes()
    peak = [start]
    done = threading.Event()

    def sample():
        while not done.wait(0.001):
            peak[0] = max(peak[0], host_rss_bytes())
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        ds, _ = stream_dataset(lt, X, y, os.path.join(tmp, "st"),
                               STREAM_BLOCK_ROWS)
        stream_run(lt, ds, TRAIN_PARAMS, STREAM_SHORT_ROUNDS)
    finally:
        done.set()
        t.join(10)
    peak[0] = max(peak[0], host_rss_bytes())
    with open(os.path.join(tmp, "host.json"), "w") as f:
        json.dump({"rss_at_start_bytes": start,
                   "rss_growth_peak_bytes": peak[0] - start,
                   "vmhwm_bytes": host_rss_peak_bytes(),
                   "predicted_stream_host_peak_bytes":
                       planner.predict_host_peak_bytes(
                           n, F, 1, STREAM_BLOCK_ROWS)[0],
                   "predicted_resident_host_peak_bytes":
                       planner.predict_host_peak_bytes(n, F, 1)[0]}, f)


def stream_host_peak() -> dict:
    """``stream_host_worker``'s reading, in a fresh spawned process (the
    phase's own host memory, not that of the phases before it)."""
    import shutil
    import tempfile

    import torch.multiprocessing as torch_mp
    tmp = tempfile.mkdtemp(prefix="lgbt-stream-host-")
    try:
        ctx = torch_mp.start_processes(stream_host_worker, args=(tmp,),
                                       nprocs=1, join=False,
                                       start_method="spawn")
        deadline = time.perf_counter() + SHARD_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError("the host-peak process ran past "
                                   f"{SHARD_TIMEOUT_S} s")
        with open(os.path.join(tmp, "host.json")) as f:
            return json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def stream_expected(grower, quant: bool) -> dict:
    """Each kernel's exact launches over a streamed grower's trees: T
    trees, R rounds run (no dead rounds: the stop test is read every
    round), nb blocks.  A tree's root is one B6 a block (f32) or one B4
    int8 a block with its sort (quantized), and one B5 search; a round is
    one B4 a block with its sort and one B5 scan of the summed arena; B2
    never runs."""
    T = len(grower.round_counts)
    R = sum(int(live) for _, live in grower.round_counts)
    nb = grower.store.num_blocks
    if quant:
        return {"fused_frontier_accumulate_int8": nb * (T + R),
                "fused_slot_order_int8": nb * (T + R),
                "fused_sibling_scan_int8": R + T, "histogram_pallas": 0,
                "fused_frontier_splits_int8": 0,
                **{k: 0 for k in F32_ENTRIES}}
    return {"histogram_pallas": nb * T, "fused_frontier_accumulate": nb * R,
            "fused_slot_order": nb * R, "fused_sibling_scan": R + T,
            "fused_frontier_splits": 0, **{k: 0 for k in INT8_ENTRIES}}


def phase_stream_train(lt, pk, train_data, smi) -> dict:
    """The out-of-core data plane (queue A10) at the training run's
    width: a spilled ``from_sample`` + ``push_rows`` construct (B3 once a
    chunk) whose blocks hold the resident twin's bytes; streamed training
    (f32 and quantized) byte-identical to resident training, launches
    exact; 3 rounds with the plain versions and 3 at 4 blocks equal to
    the first 3 trees; the planner's verdict under a card budget
    below the resident peak; bulk scoring through ``BulkScorer`` (B1 once
    a block) bit-equal to ``Booster.predict``, stopped and resumed
    byte-identically.  Returns the phase's launches (B3: the spilled
    construct; B4/B5/B6: the f32 and quantized streamed runs; B1: the
    uninterrupted bulk run)."""
    import shutil
    import tempfile

    from lightgbm_tpu_torch.data import (BlockStore, BulkScorer, ScoreSink,
                                         host_rss_bytes)
    from lightgbm_tpu_torch.ops import planner
    from lightgbm_tpu_torch.predict import DeviceForest
    t_phase = time.perf_counter()
    rss_start = host_rss_bytes()
    X, y = train_data[0], train_data[1]
    n, F = X.shape
    tmp = tempfile.mkdtemp(prefix="lgbt-stream-")
    try:
        reset_training_counts()
        sds, construct_s = stream_dataset(lt, X, y, os.path.join(tmp, "st"),
                                          STREAM_BLOCK_ROWS)
        chunks = -(-n // STREAM_PUSH_ROWS)
        store = sds._block_store
        b3 = kernel_launches()["ingest"]
        if b3 != chunks:
            raise AssertionError(f"B3 launched {b3} times for {chunks} "
                                 "pushed chunks")
        if sds.binned_t is not None or store.num_blocks != -(
                -n // STREAM_BLOCK_ROWS):
            raise AssertionError("the spilled Dataset holds a matrix on the "
                                 f"card or {store.num_blocks} blocks")
        rds, resident_construct_s = stream_dataset(lt, X, y, None, None)
        for i in range(store.num_blocks):
            s, r = store.block_bounds(i)
            if not np.array_equal(np.asarray(store.read_block(i)),
                                  rds.binned_t[:, s:s + r].cpu().numpy()):
                raise AssertionError(f"spilled block {i} differs from the "
                                     "resident matrix")
        runs, launches, texts = {}, {}, {}
        for name, params in (("f32", TRAIN_PARAMS), ("quant", QUANT_PARAMS)):
            reset_training_counts()
            st = stream_run(lt, sds, params, STREAM_ROUNDS)
            got = kernel_launches()
            g = st["bst"].boosting.grower
            if type(g).__name__ != "StreamGrower":
                raise AssertionError(f"{name}: the booster did not stream")
            want = stream_expected(g, name == "quant")
            for k, v in want.items():
                if got[k] != v:
                    raise AssertionError(f"{name}: {k} launched {got[k]} "
                                         f"times, not {v}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            res = stream_run(lt, rds, params, STREAM_ROUNDS)
            if res["bst"].boosting._stream is not None:
                raise AssertionError("the resident twin streamed")
            texts[name] = st["bst"].model_to_string()
            if texts[name] != res["bst"].model_to_string():
                raise AssertionError(f"{name}: the streamed model text "
                                     "differs from the resident run's")
            T = len(g.round_counts)
            plan = st["bst"].boosting.stream_plan
            runs[name] = {
                "s_per_tree": st["s_per_tree"],
                "resident_s_per_tree": res["s_per_tree"],
                "rounds_per_tree": [int(live) for _, live in g.round_counts],
                "block_passes_per_tree": g.pump.passes / T,
                "h2d_bytes_per_tree": g.pump.h2d_bytes / T,
                "host_reads_per_tree": g.host_reads / T,
                "launches": {k: v for k, v in got.items() if v},
                "device_peak_bytes": st["device_peak_bytes"],
                "predicted_stream_device_peak_bytes":
                    plan.predicted_device_peak_bytes,
                "resident_device_peak_bytes": res["device_peak_bytes"],
                "predicted_resident_device_peak_bytes":
                    planner.predict_peak_bytes(
                        n, F, 255, params["num_leaves"], 1,
                        name == "quant")[0]}
            for mode in ("", "resident_"):
                ratio = (runs[name][mode + "device_peak_bytes"]
                         / runs[name]["predicted_" + (mode or "stream_")
                                      + "device_peak_bytes"])
                runs[name][mode + "peak_over_predicted"] = ratio
                if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
                    raise AssertionError(
                        f"{name} {mode or 'streamed '}card peak "
                        f"{ratio:.3f} x the planner's prediction, outside "
                        f"{PEAK_RATIO}")
            if name == "f32":
                bst = st["bst"]
            del st, res
        saved = plain_kernels()
        reset_training_counts()
        try:
            plain = stream_run(lt, sds, TRAIN_PARAMS, STREAM_PLAIN_ROUNDS)
        finally:
            restore_kernels(saved)
        if any(kernel_launches().values()):
            raise AssertionError("launch counts rose in the plain-version "
                                 "run")
        if head_trees(plain["bst"].model_to_string(),
                      STREAM_PLAIN_ROUNDS) != head_trees(
                          texts["f32"], STREAM_PLAIN_ROUNDS):
            raise AssertionError("the plain versions' streamed trees "
                                 "differ")
        plain_s = plain["s_per_tree"]
        del plain
        big, _ = stream_dataset(lt, X, y, os.path.join(tmp, "st4"),
                                STREAM_BIG_BLOCK_ROWS)
        if big._block_store.num_blocks != -(-n // STREAM_BIG_BLOCK_ROWS):
            raise AssertionError("the 250,000-row store is not 4 blocks")
        short = stream_run(lt, big, TRAIN_PARAMS, STREAM_SHORT_ROUNDS)
        if head_trees(short["bst"].model_to_string(),
                      STREAM_SHORT_ROUNDS) != head_trees(
                          texts["f32"], STREAM_SHORT_ROUNDS):
            raise AssertionError("the 4-block run's trees differ from the "
                                 "8-block run's first trees")
        del short, big
        resident_peak = runs["f32"]["predicted_resident_device_peak_bytes"]
        verdict = planner.plan_stream(
            rows=n, features=F, num_bins=255,
            num_leaves=TRAIN_PARAMS["num_leaves"],
            device_budget_bytes=int(resident_peak / 2 / planner.HEADROOM))

        # bulk scoring: the f32 rows, BULK_BLOCK_ROWS a block
        fstore = BlockStore.from_array(os.path.join(tmp, "features"), X,
                                       BULK_BLOCK_ROWS)
        dev = DeviceForest(bst._forest(0, STREAM_ROUNDS), "cuda")
        full = os.path.join(tmp, "sink_full")
        pk.reset_launch_counts()
        torch.cuda.synchronize()
        bulk_base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stats = BulkScorer(dev, fstore, full).run()
        bulk_peak = torch.cuda.max_memory_allocated() - bulk_base
        b1 = pk.launch_counts["fused_traverse[leaves]"]
        if b1 != fstore.num_blocks or pk.launch_counts[
                "fused_traverse[scores]"] != 0 or not stats["complete"]:
            raise AssertionError(f"bulk scoring launched B1 {b1} times for "
                                 f"{fstore.num_blocks} blocks")
        on_device = stats["epilogue"] == "device"
        ref = bst.predict(X, raw_score=True, device=on_device)
        banked = ScoreSink.open_or_create(
            full, n, 1, BULK_BLOCK_ROWS, fstore.num_blocks,
            BulkScorer(dev, fstore, full).digest)
        for i in range(fstore.num_blocks):
            s, r = fstore.block_bounds(i)
            if not np.array_equal(banked.read_block(i)[0], ref[s:s + r]):
                raise AssertionError(f"banked block {i} differs from "
                                     "Booster.predict(raw_score=True)")
        last_s, last_r = fstore.block_bounds(fstore.num_blocks - 1)
        pad = np.zeros((BULK_BLOCK_ROWS, F), np.float32)
        pad[:last_r] = X[last_s:last_s + last_r]
        if not np.array_equal(banked.read_block(fstore.num_blocks - 1),
                              dev.predict_raw_padded(pad)[:, :last_r]):
            raise AssertionError("the ragged block differs from "
                                 "predict_raw_padded")
        device_err = float(np.abs(
            ref - bst.predict(X, raw_score=True)).max())
        resumed = os.path.join(tmp, "sink_resumed")
        part = BulkScorer(dev, fstore, resumed).run(
            max_blocks=BULK_STOP_BLOCKS)
        rest = BulkScorer(dev, fstore, resumed).run()
        if (part["blocks_scored"] != BULK_STOP_BLOCKS
                or rest["skipped_blocks"] != BULK_STOP_BLOCKS
                or not rest["complete"]):
            raise AssertionError(f"resume: {part} then {rest}")
        for f in sorted(os.listdir(full)):
            with open(os.path.join(full, f), "rb") as a, \
                    open(os.path.join(resumed, f), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"resumed sink file {f} differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    host = stream_host_peak()
    launches["ingest"] = b3
    launches["fused_traverse[leaves]"] = b1
    emit({"phase": "stream_train", "rows": n, "features": F,
          "rounds": STREAM_ROUNDS, "num_leaves": TRAIN_PARAMS["num_leaves"],
          "construct_s": construct_s,
          "resident_construct_s": resident_construct_s,
          "b3_launches": b3, "pushed_chunks": chunks,
          "store_blocks": store.num_blocks, "store_bytes": store.nbytes(),
          "block_rows": store.block_rows, "runs": runs,
          "plain_s_per_tree": plain_s,
          "host_rss_bytes_at_start": rss_start,
          "host_rss_bytes": host_rss_bytes(),
          "host_peak_in_a_fresh_process": host,
          "plan_at_half_the_resident_peak": verdict.summary(),
          "bulk": {"blocks": fstore.num_blocks, "block_rows": BULK_BLOCK_ROWS,
                   "store_bytes": fstore.nbytes(),
                   "rows_per_s": stats["rows_per_sec"],
                   "seconds": stats["seconds"], "b1_launches": b1,
                   "epilogue": stats["epilogue"],
                   "max_abs_err_vs_device_predict": device_err,
                   "device_peak_bytes": bulk_peak,
                   "predicted_device_peak_bytes":
                       stats["predicted_device_peak_bytes"],
                   "resumed_after": BULK_STOP_BLOCKS},
          "nvidia_smi": smi, "phase_s": time.perf_counter() - t_phase,
          "checked": "spilled blocks = resident bytes; B3 once a chunk; "
                     "streamed text = resident text (f32, quantized); "
                     "plain-version streamed trees and 4-block trees = "
                     "the first 8-block trees; launches exact; card "
                     f"peaks {PEAK_RATIO[0]}-{PEAK_RATIO[1]} x the "
                     "planner's predictions; banked "
                     "blocks = "
                     "Booster.predict(raw_score=True) on the epilogue's "
                     "path and predict_raw_padded; resumed sink = "
                     "uninterrupted sink, byte for byte"})
    return launches


def hist_sums_per_tree(mode: str, grower) -> float:
    """[F, B] histograms a tree sums over the group: data, the root and
    ``KCAP`` slots a round run; voting, the root and both children of
    each step (of the top_k elected features); feature, none."""
    if mode in ("data", "data_quant"):
        T = len(grower.round_counts)
        R = sum(r for r, _ in grower.round_counts)
        return (T + R * grower.KCAP) / T
    if mode.startswith("voting"):
        return (len(grower.steps) + 2 * sum(grower.steps)) / len(
            grower.steps)
    return 0.0


def histogram_payload(params, B: int) -> int:
    """The bytes one [F, B] histogram sum moves in ``params``' mode
    (``ops.histogram.hist_payload_bytes``; F = 28, or the ``top_k``
    elected features of a vote; B the dataset's bin axis)."""
    from lightgbm_tpu_torch.ops.histogram import hist_payload_bytes
    F = (min(params["top_k"], 28) if params.get("tree_learner") == "voting"
         else 28)
    return hist_payload_bytes(F, B,
                              quant=bool(params.get("use_quantized_grad")))


def load_structures(text: str) -> list:
    """Each tree's split features, bin thresholds and children from a
    model text (the structure without floats)."""
    from lightgbm_tpu_torch.model_text import load_model_from_string
    return [(m.split_feature.tolist(), m.threshold_in_bin.tolist()
             if hasattr(m, "threshold_in_bin") else None,
             m.left_child.tolist(), m.right_child.tolist())
            for m in load_model_from_string(text)["models"]]


OBS_ROUNDS = 5
OBS_EXTRA_UPDATES = 6        # the checked run's host reads: tree 12
OBS_REQUESTS, OBS_THREADS, OBS_REQUEST_ROWS = 200, 4, 1500
# the phase's timed runs: traced (tracing + recorder), untraced (the
# recorder, on by default) and the recorder off, in A B C C B A order
OBS_MODES = ("untraced", "traced", "recorder_off", "recorder_off",
             "traced", "untraced")
OBS_PHASE_LIMIT_S = 60.0


def _obs_mode(mode: str) -> None:
    from lightgbm_tpu_torch.obs import global_flight, global_tracer
    global_tracer.reset()
    global_tracer.enabled = mode == "traced"
    global_flight.enabled = mode != "recorder_off"


def obs_run(lt, ds, vs, mode: str, updates: int = 0):
    """``train`` of ``OBS_ROUNDS`` rounds on the constructed pair in
    ``mode`` (the launch counts set to 0 just before it), then
    ``updates`` more trees and one under ``host_reads``; returns
    (booster, seconds a tree of the ``train`` call, its launches, host
    reads, trace events of the ``train`` call)."""
    from lightgbm_tpu_torch.obs import global_tracer
    _obs_mode(mode)
    try:
        reset_training_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(TRAIN_PARAMS, ds, OBS_ROUNDS, valid_sets=[vs],
                       valid_names=["valid"], verbose_eval=False)
        torch.cuda.synchronize()
        s_tree = (time.perf_counter() - t0) / OBS_ROUNDS
        launches = kernel_launches()
        events = global_tracer.events()
        for _ in range(updates):
            bst.update()
        reads = host_reads(bst)
    finally:
        _obs_mode("untraced")
    return bst, s_tree, launches, reads, events


def phase_obs_trace(lt, pk, train_run, smi) -> dict:
    """The observability core on the card (queue A11, first part):
    ``higgs_train_1m``'s constructed datasets trained 5 rounds with
    tracing, the flight recorder and the watchdog on, through the round
    graph: the main run's first five trees byte for byte, the host syncs
    and stop-flag waits of tree 12 (``host_reads``) and B2's launches
    those of its untraced and recorder-off twins (each trained the same
    way), one ``trace.grow_tree_rounds`` span a tree, the root span
    covered, the trace a Chrome trace; s a tree traced, untraced and
    with the recorder off (A B C C B A); then ~200 requests through
    ``serve`` (B1) with the batcher's heartbeat and the server's series
    in the process registry; then a quarantined swap dumped to a
    temporary flight directory, its fingerprint naming the card."""
    import tempfile

    from lightgbm_tpu_torch.obs import (SLOConfig, global_flight,
                                        global_registry, global_tracer,
                                        global_watchdog, span_coverage)
    from lightgbm_tpu_torch.serving import loadgen
    from lightgbm_tpu_torch.serving.errors import SwapQuarantined
    t_phase = time.perf_counter()
    ds, vs = train_run["ds"], train_run["vs"]
    want = head_trees(train_run["text"], OBS_ROUNDS)
    main_reads = {k: train_run["row"][k] for k in
                  ("host_syncs_per_iteration",
                   "stop_flag_waits_per_iteration")}
    # the sentry thread watches the engine's heartbeat while it trains
    wd_config = global_watchdog.config
    global_watchdog.config = SLOConfig(heartbeat_stale_s=60.0,
                                       check_interval_s=0.5)
    global_watchdog.start()
    breaches0 = {k: v for k, v in global_registry.to_dict()["counters"]
                 .items() if k.startswith("slo_breach_total")}
    flight_was = global_flight.enabled
    try:
        bst, traced_s, traced_launches, reads, events = obs_run(
            lt, ds, vs, "traced", OBS_EXTRA_UPDATES)
    finally:
        global_watchdog.stop()
        global_watchdog.config = wd_config
    if global_watchdog.running:
        raise AssertionError("the watchdog's sentry thread did not stop")
    breaches = {k: v for k, v in global_registry.to_dict()["counters"]
                .items() if k.startswith("slo_breach_total")}
    if breaches != breaches0:
        raise AssertionError(f"SLO breaches during the traced run: "
                             f"{breaches}")
    used_graph(bst)
    text = bst.model_to_string()
    if head_trees(text, OBS_ROUNDS) != want:
        raise AssertionError("the traced run's trees differ from the main "
                             "run's first five")
    reads_cmp = {k: reads[k] for k in main_reads}
    names = [e["name"] for e in events]
    counts = {n: names.count(n) for n in set(names)}
    for name in ("engine.train", "engine.step", "planner.plan",
                 "engine.eval"):
        if not counts.get(name):
            raise AssertionError(f"no {name} event in the traced run")
    if counts.get("trace.grow_tree_rounds") != OBS_ROUNDS:
        raise AssertionError(f"{counts.get('trace.grow_tree_rounds')} "
                             f"trace.grow_tree_rounds spans for "
                             f"{OBS_ROUNDS} trees")
    if not (counts.get("gbdt.finish_iter") or counts.get("macro.host_fetch")):
        raise AssertionError("no host tree fetch span")
    coverage = span_coverage(events, "engine.train")
    if coverage is None or not coverage > 0.9:
        raise AssertionError(f"engine.train's coverage {coverage}")
    flight_dir = tempfile.mkdtemp(prefix="lgbt_obs_")
    try:
        trace_path = os.path.join(flight_dir, "trace.json")
        global_tracer.dump(trace_path, events)
        trace_bytes = os.path.getsize(trace_path)
        with open(trace_path) as fh:
            doc = json.load(fh)
        evs = doc["traceEvents"]
        if evs[0]["ph"] != "M" or len(evs) != len(events) + 1 or any(
                e["ph"] not in ("X", "i") or "ts" not in e
                for e in evs[1:]):
            raise AssertionError("the dumped trace is not a Chrome trace")
        ring = [e["name"] for e in global_flight.ring_events()]
        if "engine.step" not in ring:
            raise AssertionError("the flight ring holds no engine.step")

        # s a tree in each mode (A B C C B A; the host clock spreads);
        # every mode's tree 6 makes the same host reads
        times = {m: [] for m in OBS_MODES}
        mode_reads = {}
        b2 = "fused_frontier_splits"
        for mode in OBS_MODES:
            # each twin's tree 12 under host_reads, as the checked run's
            b, s_tree, launches, r, _ev = obs_run(lt, ds, vs, mode,
                                                  OBS_EXTRA_UPDATES)
            times[mode].append(s_tree)
            r = {k: r[k] for k in main_reads}
            mode_reads.setdefault(mode, r)
            if head_trees(b.model_to_string(), OBS_ROUNDS) != want:
                raise AssertionError(f"the {mode} run's trees differ")
            if r != reads_cmp:
                raise AssertionError(f"host reads at tree 12: traced "
                                     f"{reads_cmp}, {mode} {r}")
            # every mode's five trees launch B2 as often as the traced
            # run's: nothing is recorded inside the round graph
            if launches[b2] != traced_launches[b2] or launches[b2] <= 0:
                raise AssertionError(f"B2 launches {mode} {launches[b2]}, "
                                     f"traced {traced_launches[b2]}")
            del b

        # serving through the round's model (B1), traced
        _obs_mode("traced")
        pk.reset_launch_counts()
        with bst.serve(heartbeat_name="serving.batcher") as srv:
            # the served model (the booster's best iteration)
            res = loadgen.fire_requests(srv, OBS_REQUESTS, OBS_THREADS,
                                        OBS_REQUEST_ROWS, 28,
                                        verify_forest=srv.models.active
                                        .forest, timeout=300, seed=17)
            beat_age = global_watchdog.beat_age("serving.batcher")
            prom = global_registry.to_prometheus()
        serve_events = [e["name"] for e in global_tracer.events()]
        _obs_mode("untraced")
        b1 = pk.launch_counts[KERNEL]
        if res["errors"] or res["mismatches"] or \
                res["requests"] != res["requests_planned"]:
            raise AssertionError(f"serving: {res['errors'][:3]} "
                                 f"{res['mismatches'][:3]}")
        if beat_age is None or not beat_age < 1.0:
            raise AssertionError(f"the batcher's heartbeat is {beat_age} s "
                                 "old")
        if "lgbt_serving_requests_total" not in prom:
            raise AssertionError("the process registry lacks the server's "
                                 "series")
        for name in ("serving.batch", "serving.dispatch", "serving.admit",
                     "serving.complete"):
            if name not in serve_events:
                raise AssertionError(f"no {name} event while serving")
        if b1 <= 0:
            raise AssertionError("serving never launched B1")

        # a quarantined swap, dumped into a temporary flight directory
        saved_dir, saved_dumps = os.environ.get("LIGHTGBM_TPU_FLIGHT_DIR"), \
            global_flight.dumps
        os.environ["LIGHTGBM_TPU_FLIGHT_DIR"] = flight_dir
        global_flight.dumps = 0
        bad = lt.Booster(model_str=text)
        bad.models[0].leaf_value[:] = np.nan     # every row reads a NaN
        try:
            with bst.serve() as srv:
                try:
                    srv.swap_model(bad)
                except SwapQuarantined:
                    pass
                else:
                    raise AssertionError("a NaN forest was promoted")
        finally:
            if saved_dir is None:
                os.environ.pop("LIGHTGBM_TPU_FLIGHT_DIR", None)
            else:
                os.environ["LIGHTGBM_TPU_FLIGHT_DIR"] = saved_dir
            global_flight.dumps = saved_dumps
        files = sorted(os.listdir(flight_dir))
        bundles = [f for f in files if f.startswith("flight_serving.swap")]
        if len(bundles) != 1 or any(".tmp" in f for f in files):
            raise AssertionError(f"flight directory: {files}")
        with open(os.path.join(flight_dir, bundles[0])) as fh:
            bundle = json.load(fh)
        fp = bundle["fingerprint"]
        if fp.get("device_kind") != torch.cuda.get_device_name(0) or \
                fp.get("torch_version") != torch.__version__ or \
                bundle["exception"]["type"] != "SwapQuarantined":
            raise AssertionError(f"the bundle's fingerprint: {fp}")
    finally:
        import shutil
        shutil.rmtree(flight_dir, ignore_errors=True)
        global_tracer.reset()
        global_flight.enabled = flight_was
    phase_s = time.perf_counter() - t_phase
    row = {"phase": "obs_trace", "rows": ds.num_data, "rounds": OBS_ROUNDS,
           "trees_equal_main_run": True,
           "host_reads_traced": reads_cmp, "host_reads_by_mode": mode_reads,
           "host_reads_train_phase_timer_booster": main_reads,
           "s_per_tree": times, "s_per_tree_traced_checked_run": traced_s,
           "trace_events_per_tree": len(events) / OBS_ROUNDS,
           "trace_bytes_per_tree": trace_bytes / OBS_ROUNDS,
           "trace_event_counts": counts,
           "span_coverage_engine_train": coverage,
           "b2_launches_per_tree": traced_launches[b2] / OBS_ROUNDS,
           "serve_requests": res["requests"], "serve_rows": res["rows"],
           "serve_p99_ms": res["latency_ms"].get("p99"),
           "batcher_beat_age_s": beat_age, "b1_launches": b1,
           "quarantine_bundle_keys": sorted(bundle),
           "fingerprint_device": fp.get("device_kind"),
           "phase_s": phase_s, "device": smi}
    emit(row)
    if phase_s > OBS_PHASE_LIMIT_S:
        raise AssertionError(f"obs_trace took {phase_s:.1f} s, over its "
                             f"{OBS_PHASE_LIMIT_S} s")
    return row


CKPT_FREQ, CKPT_PAUSE_AT = 5, 3
CKPT_QUANT_ROUNDS, CKPT_QUANT_FREQ = 6, 3
CKPT_QUANT_PARAMS = dict(QUANT_PARAMS, bagging_fraction=0.7, bagging_freq=1)
CKPT_STREAM_ROUNDS, CKPT_STREAM_FREQ = 4, 2
CKPT_CAPI_ROWS = 65_536
CKPT_PHASE_LIMIT_S = 90.0


class _ResumeProbe:
    """A ``pause_control`` that never pauses: the engine consults it at
    every chunk boundary, the first one right after the restore, so its
    first call time is when the first resumed tree starts."""

    def __init__(self, pause_at=None):
        self.pause_at = pause_at
        self.first = None

    def consult(self, i):
        if self.first is None:
            self.first = time.perf_counter()
        return "pause" if i == self.pause_at else "run"

    def chunk_cap(self):
        return 1 << 30


def _conf_value(v) -> str:
    return ",".join(map(str, v)) if isinstance(v, (list, tuple)) else str(v)


def _cli(args, cwd, log):
    """``python -m lightgbm_tpu_torch`` in a subprocess that inherits the
    card; returns (seconds, stdout); a non-zero exit fails the phase."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch"] + args,
                       cwd=cwd, env=env, capture_output=True, text=True,
                       timeout=300)
    secs = time.perf_counter() - t0
    with open(log, "a") as fh:
        fh.write(f"$ {' '.join(args)}\n{r.stdout}{r.stderr}\n")
    if r.returncode != 0:
        raise AssertionError(f"the CLI ({' '.join(args)}) exited "
                             f"{r.returncode}: {r.stderr[-3000:]}")
    return secs, r.stdout


def phase_ckpt_cli(lt, pk, train_run, train_data, smi) -> dict:
    """Checkpoints, pause control, the CLI and the C API on the card
    (queue A8) at ``higgs_train_1m`` width, on the ``train`` phase's
    constructed datasets and parameters, against its uninterrupted model
    text: (1) the same training with a bundle every 5 iterations (text
    unchanged), resumed from the bundle of iteration 5 to the same text
    and evaluation history; (2) quantized with bagging, 6 rounds, resumed
    from 3; (3) paused at iteration 3 (``TrainingPaused``) and resumed;
    (4) a streamed run in the ``stream_train`` phase's spill geometry, 4
    rounds, resumed from 2 streamed and resident; (5) the CLI in
    subprocesses on the card: ``task=train`` on a binary Dataset file and
    a TSV valid set, then ``task=predict``; (6) the C API in process:
    ``LGBM_DatasetCreateFromMat`` (B3), 10 ``LGBM_BoosterUpdateOneIter``
    (B2), ``LGBM_BoosterPredictForMat`` (B1) bit-equal to the Booster.
    Counts are set to 0 at the start; B1, B2, B3 (and B4, B5 in the
    streamed step) must each launch."""
    import shutil
    import tempfile

    from lightgbm_tpu_torch import capi
    from lightgbm_tpu_torch.engine import TrainingPaused
    from lightgbm_tpu_torch.resilience import (load_checkpoint,
                                               save_checkpoint)
    t_phase = time.perf_counter()
    ds, vs, want = train_run["ds"], train_run["vs"], train_run["text"]
    X, y, Xv, yv = train_data
    want_evals = {"auc": train_run["row"]["valid_auc"],
                  "binary_logloss": train_run["row"]["valid_logloss"]}
    tmp = tempfile.mkdtemp(prefix="lgbt-ckpt-")
    log = os.path.join(tmp, "cli.log")
    row = {"phase": "ckpt_cli", "config": "higgs_train_1m"}

    def train(params, data, rounds, valid=True, **kw):
        ev = {}
        extra = ({"valid_sets": [vs], "valid_names": ["valid"],
                  "evals_result": ev} if valid else {})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = lt.train(params, data, rounds, verbose_eval=False, **extra,
                       **kw)
        torch.cuda.synchronize()
        return bst, ev, time.perf_counter() - t0

    def bundle(snap, it):
        return os.path.join(snap + ".ckpt", f"ckpt_iter_{it:08d}.lgbckpt")

    try:
        reset_training_counts()
        pk.reset_launch_counts()
        # (1) snapshots every 5, then the resume from iteration 5
        snap = os.path.join(tmp, "m.txt")
        bst1, ev1, s1 = train(TRAIN_PARAMS, ds, TRAIN_ROUNDS,
                              snapshot_freq=CKPT_FREQ, snapshot_out=snap)
        text1 = bst1.model_to_string()
        if text1 != want:
            raise AssertionError("snapshots changed the train phase's model "
                                 "text")
        if ev1["valid"] != want_evals:
            raise AssertionError("snapshots changed the evaluation history")
        one = os.path.join(tmp, "one.lgbckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(bst1, one, iteration=TRAIN_ROUNDS)
        write_s = time.perf_counter() - t0
        man = load_checkpoint(bundle(snap, CKPT_FREQ)).manifest
        probe = _ResumeProbe()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, ev_res, _ = train(TRAIN_PARAMS, ds, TRAIN_ROUNDS,
                               resume_from=bundle(snap, CKPT_FREQ),
                               pause_control=probe)
        t1 = time.perf_counter()
        if res.model_to_string() != want:
            raise AssertionError("the run resumed from iteration 5 ends with "
                                 "another model text")
        if ev_res["valid"] != want_evals:
            raise AssertionError("the resumed evaluation history (6-10) "
                                 "differs")
        row.update({
            "bundle_bytes": os.path.getsize(bundle(snap, CKPT_FREQ)),
            "bundle_bytes_10": os.path.getsize(one),
            "bundle_write_s": write_s, "snapshot_run_s": s1,
            "resume_to_first_tree_s": probe.first - t0,
            "resumed_s_per_tree": (t1 - probe.first)
            / (TRAIN_ROUNDS - CKPT_FREQ),
            "hist_plan": man["hist_plan"], "chunk_cap": man["chunk_cap"]})
        del res

        # (2) quantized with bagging
        qsnap = os.path.join(tmp, "q.txt")
        qfull, _, _ = train(CKPT_QUANT_PARAMS, ds, CKPT_QUANT_ROUNDS,
                            snapshot_freq=CKPT_QUANT_FREQ,
                            snapshot_out=qsnap)
        qres, _, _ = train(CKPT_QUANT_PARAMS, ds, CKPT_QUANT_ROUNDS,
                           resume_from=bundle(qsnap, CKPT_QUANT_FREQ))
        if qres.model_to_string() != qfull.model_to_string():
            raise AssertionError("the quantized resume differs")
        row["quant_resume_equal"] = True
        del qfull, qres

        # (3) pause at iteration 3, then resume
        psnap = os.path.join(tmp, "p.txt")
        try:
            train(TRAIN_PARAMS, ds, TRAIN_ROUNDS, snapshot_out=psnap,
                  pause_control=_ResumeProbe(pause_at=CKPT_PAUSE_AT))
            raise AssertionError("the pause control did not pause")
        except TrainingPaused as e:
            paused = e
        pres, pev, _ = train(TRAIN_PARAMS, ds, TRAIN_ROUNDS,
                             resume_from=paused.bundle_path)
        if paused.iteration != CKPT_PAUSE_AT or \
                pres.model_to_string() != want or pev["valid"] != want_evals:
            raise AssertionError("the run resumed after the pause differs")
        row["paused_at"] = paused.iteration
        del pres

        # (4) mid-stream: the stream_train phase's spill geometry
        before = kernel_launches()
        sds, _ = stream_dataset(lt, X, y, os.path.join(tmp, "st"),
                                STREAM_BLOCK_ROWS)
        ssnap = os.path.join(tmp, "s.txt")
        sfull, _, _ = train(TRAIN_PARAMS, sds, CKPT_STREAM_ROUNDS, False,
                            snapshot_freq=CKPT_STREAM_FREQ,
                            snapshot_out=ssnap)
        if sfull.boosting._stream is None:
            raise AssertionError("the spilled Dataset did not stream")
        stext = sfull.model_to_string()
        sman = load_checkpoint(bundle(ssnap, CKPT_STREAM_FREQ)).manifest
        sp = sman["stream_plan"] or {}
        if (sp.get("store_block_rows") != STREAM_BLOCK_ROWS
                or sp.get("store_num_blocks") != -(-len(X)
                                                  // STREAM_BLOCK_ROWS)):
            raise AssertionError(f"the manifest's stream plan {sp} does not "
                                 "name the store's geometry")
        sres, _, _ = train(TRAIN_PARAMS, sds, CKPT_STREAM_ROUNDS, False,
                           resume_from=bundle(ssnap, CKPT_STREAM_FREQ))
        rds, _ = stream_dataset(lt, X, y, None, None)
        rres, _, _ = train(TRAIN_PARAMS, rds, CKPT_STREAM_ROUNDS, False,
                           resume_from=bundle(ssnap, CKPT_STREAM_FREQ))
        if rres.boosting._stream is not None:
            raise AssertionError("the resident twin streamed")
        if sres.model_to_string() != stext or rres.model_to_string() != stext:
            raise AssertionError("a mid-stream resume (streamed or resident) "
                                 "differs")
        got = kernel_launches()
        stream_launches = {k: got[k] - before[k] for k in got}
        for k in ("fused_frontier_accumulate", "fused_sibling_scan"):
            if stream_launches[k] <= 0:
                raise AssertionError(f"the streamed step never launched {k}")
        row["stream_manifest"] = {k: sp.get(k) for k in (
            "stream", "block_rows", "store_block_rows", "store_num_blocks")}
        del sfull, sres, rres, sds, rds

        # (5) the CLI on the card
        cli = os.path.join(tmp, "cli")
        os.makedirs(cli)
        ds.save_binary(os.path.join(cli, "train.bin"))
        np.savetxt(os.path.join(cli, "valid.tsv"),
                   np.column_stack([yv, Xv]), delimiter="\t", fmt="%.9g")
        conf = dict(TRAIN_PARAMS, task="train", data="train.bin",
                    valid_data="valid.tsv", num_iterations=TRAIN_ROUNDS,
                    snapshot_freq=CKPT_FREQ, output_model="cli_model.txt")
        with open(os.path.join(cli, "train.conf"), "w") as fh:
            fh.writelines(f"{k} = {_conf_value(v)}\n" for k, v in conf.items())
        train_s, out = _cli(["config=train.conf"], cli, log)
        with open(os.path.join(cli, "cli_model.txt")) as fh:
            cli_text = fh.read()
        if trees_of(cli_text) != trees_of(want):
            raise AssertionError("the CLI's model differs from the train "
                                 "phase's")
        if "runs on device cuda" not in out:
            raise AssertionError("the CLI's log names no cuda device")
        predict_s, out = _cli(["task=predict", "data=valid.tsv",
                               "input_model=cli_model.txt",
                               "output_result=preds.txt"], cli, log)
        if "runs on device cuda" not in out:
            raise AssertionError("the CLI's predict log names no cuda device")
        cli_pred = np.loadtxt(os.path.join(cli, "preds.txt"))
        in_proc = bst1.predict(Xv)
        if not np.allclose(cli_pred, in_proc, rtol=1e-9, atol=0.0):
            raise AssertionError("the CLI's predictions differ from "
                                 "Booster.predict: max |d| "
                                 f"{np.abs(cli_pred - in_proc).max()}")
        row.update({"cli_train_s": train_s, "cli_predict_s": predict_s,
                    "cli_bundles": sorted(os.listdir(os.path.join(
                        cli, "cli_model.txt.ckpt")))})

        # (6) the C API in process
        pstr = " ".join(f"{k}={_conf_value(v)}"
                        for k, v in TRAIN_PARAMS.items())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dh, vh, bh, fin = [0], [0], [0], [0]
        rcs = [capi.LGBM_DatasetCreateFromMat(X, pstr, y, dh),
               capi.LGBM_DatasetCreateFromMat(Xv, pstr, yv, vh),
               capi.LGBM_BoosterCreate(dh[0], pstr, bh),
               capi.LGBM_BoosterAddValidData(bh[0], vh[0])]
        for _ in range(TRAIN_ROUNDS):
            rcs.append(capi.LGBM_BoosterUpdateOneIter(bh[0], fin))
        ev, pred, ctext = [], [None], [None]
        rcs += [capi.LGBM_BoosterGetEval(bh[0], 1, ev),
                capi.LGBM_BoosterPredictForMat(bh[0], Xv[:CKPT_CAPI_ROWS], 1,
                                               -1, pred),
                capi.LGBM_BoosterSaveModelToString(bh[0], ctext)]
        torch.cuda.synchronize()
        capi_s = time.perf_counter() - t0
        if set(rcs) != {0}:
            raise AssertionError(f"the C API failed: {rcs} "
                                 f"{capi.LGBM_GetLastError()}")
        if capi._get(dh[0]).device.type != "cuda":
            raise AssertionError("the C API's Dataset is not on the card")
        if trees_of(ctext[0]) != trees_of(want):
            raise AssertionError("the C API's model differs from the train "
                                 "phase's")
        ref = bst1.predict(Xv[:CKPT_CAPI_ROWS], raw_score=True)
        if not np.array_equal(pred[0], ref):
            raise AssertionError("LGBM_BoosterPredictForMat differs from "
                                 "Booster.predict(raw_score=True)")
        if not np.allclose(ev, [want_evals["auc"][-1],
                                want_evals["binary_logloss"][-1]],
                           rtol=1e-6):
            raise AssertionError(f"LGBM_BoosterGetEval gave {ev}")
        for h in (dh[0], vh[0]):
            capi.LGBM_DatasetFree(h)
        capi.LGBM_BoosterFree(bh[0])
        row.update({"capi_s": capi_s, "capi_eval": ev})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = kernel_launches()
    launches = {"fused_traverse": pk.launch_counts[KERNEL],
                "fused_frontier_splits": got["fused_frontier_splits"],
                "ingest": got["ingest"],
                "fused_frontier_accumulate": got["fused_frontier_accumulate"],
                "fused_sibling_scan": got["fused_sibling_scan"],
                "streamed_step": {k: v for k, v in stream_launches.items()
                                  if v}}
    for k in ("fused_traverse", "fused_frontier_splits", "ingest"):
        if launches[k] <= 0:
            raise AssertionError(f"the phase never launched {k}")
    phase_s = time.perf_counter() - t_phase
    row.update({"launches": launches, "phase_s": phase_s, "device": smi})
    emit(row)
    if phase_s > CKPT_PHASE_LIMIT_S:
        raise AssertionError(f"ckpt_cli took {phase_s:.1f} s, over its "
                             f"{CKPT_PHASE_LIMIT_S:.0f} s budget")
    return launches


def phase_boost_variants(lt, mono_ds):
    """``dart``, ``rf``, ``regression_l1`` and ``quantile`` (the last two
    renew their leaves on the card), 5 rounds each on the monotone run's
    1,000,000 x 28 dataset, each against its plain-version run; DART must
    drop a tree."""
    runs = {}
    for name, params in VARIANT_PARAMS.items():
        launches, bst = short_run(
            lt, mono_ds, params, positive=F32_ENTRIES,
            zero=("histogram_pallas", "ingest") + INT8_ENTRIES,
            quant=False, rounds=VARIANT_ROUNDS,
            # DART rescales earlier trees and RF averages them: all rounds
            plain_rounds=VARIANT_ROUNDS)
        extra = {}
        if name == "dart":
            extra["drops"] = bst.boosting.drops
            if not any(bst.boosting.drops):
                raise AssertionError("DART dropped no tree")
        if (name == "rf"
                and "\naverage_output\n" not in bst.model_to_string()):
            raise AssertionError("the RF model text is not averaged")
        runs[name] = {"rounds": VARIANT_ROUNDS, "s_per_iteration":
                      launches.pop("seconds") / VARIANT_ROUNDS,
                      "launches": launches,
                      "leaves_per_tree": [m.num_leaves for m in bst.models],
                      **extra}
    emit({"phase": "boost_variants", "config": "mono_train_1m",
          "runs": runs, "checked": "model texts byte-identical to the "
                                   "plain runs"})


def plain_traverse():
    """B1's launcher replaced by its plain version (returns the original
    for ``restore_traverse``)."""
    from lightgbm_tpu_torch.ops import predict_kernels as pk
    saved = pk.fused_traverse
    pk.fused_traverse = (lambda dev, X, num_class=1, emit_scores=False,
                         plan=None: pk.traverse_plain(dev, X, num_class,
                                                      emit_scores))
    return saved


def restore_traverse(saved) -> None:
    from lightgbm_tpu_torch.ops import predict_kernels as pk
    pk.fused_traverse = saved


def trees_of(text: str) -> str:
    return text.partition("end of trees")[0]


def phase_sparse_cv(lt, pk, dense_ds, smi: str) -> dict:
    """``sparse_cv``: the ``airline_onehot_1m`` table given to ``Dataset``
    as a scipy CSR matrix.  Checks: the CSR Dataset's bin mappers, EFB
    groups and [G, n] bytes equal the dense table's (``dense_ds``, binned
    from the same rows as a dense f32 matrix); a binary cache reloads the
    same bytes and trains the same 3-round model; ``cv`` (5 folds, 10
    rounds, through ``Dataset.subset``) raises every fold's valid AUC,
    its fold 0 equals a ``train`` on that subset and its first 3 rounds
    the plain-version run's; continued training (5 + 5 rounds, a
    100,000-row valid set) starts from the old model's raw scores (B1's
    scores mode on CSR chunks, equal to the host's) and its first 3 new
    rounds equal the plain-version run's; ``refit`` on 200,000 fresh rows
    (leaves from B1's leaves mode) equals the plain-version run's;
    ``pred_contrib`` on 10,000 CSR rows sums to the raw scores within
    1e-9 relative.  The kernels' launches over the phase (every count set
    to 0 at its start; the plain-version runs launch nothing) must show
    B1, B3, B4, B5 and B6."""
    from lightgbm_tpu_torch.engine import _make_n_folds, _raw_scores
    from lightgbm_tpu_torch.testing import airline_like, one_hot_csr
    params = TRAIN_PARAMS
    t_phase = time.perf_counter()
    X8, y = airline_like(EFB_ROWS, seed=11)
    csr = one_hot_csr(X8)
    Xv8, yv = airline_like(EFB_VALID_ROWS, seed=12)
    csr_v = one_hot_csr(Xv8)
    del X8, Xv8
    reset_training_counts()
    pk.reset_launch_counts()
    row = {"phase": "sparse_cv", "config": "airline_onehot_1m (CSR)",
           "card": smi, "rows": csr.shape[0], "features": csr.shape[1],
           "nnz_per_row": csr.nnz / csr.shape[0],
           "csr_mb": (csr.data.nbytes + csr.indices.nbytes
                      + csr.indptr.nbytes) / 1e6}

    # 1. CSR binning, against the dense table's Dataset
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = lt.Dataset(csr, label=y, free_raw_data=False).construct()
    torch.cuda.synchronize()
    row["construct_csr_s"] = time.perf_counter() - t0
    row["construct_dense_s"] = dense_ds.construct_seconds
    row["bin_route"] = ds.bin_route
    row["construct_b3_launches"] = kernel_launches()["ingest"]
    if ds.bin_route != "kernel" or row["construct_b3_launches"] <= 0:
        raise AssertionError("the CSR rows did not bin through B3")
    same = (json.dumps([m.to_dict() for m in ds.bin_mappers])
            == json.dumps([m.to_dict() for m in dense_ds.bin_mappers])
            and np.array_equal(ds.feat_group, dense_ds.feat_group)
            and np.array_equal(ds.feat_start, dense_ds.feat_start)
            and torch.equal(ds.binned_t, dense_ds.binned_t))
    if not same:
        raise AssertionError("the CSR Dataset's bins differ from the dense "
                             "table's")
    row["groups"] = ds.num_groups

    # 2. the binary cache
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, "build", "sparse_cv.bin")
    t0 = time.perf_counter()
    ds.save_binary(path)
    row["save_binary_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cached = lt.Dataset(path).construct()
    torch.cuda.synchronize()
    row["load_binary_s"] = time.perf_counter() - t0
    row["cache_mb"] = os.path.getsize(path) / 1e6
    os.remove(path)
    if not torch.equal(cached.binned_t, ds.binned_t) or not np.array_equal(
            cached.get_label(), ds.get_label()):
        raise AssertionError("the binary cache did not reload the same "
                             "bytes")
    a = lt.train(params, ds, SPARSE_PLAIN_ROUNDS, verbose_eval=False)
    b = lt.train(params, cached, SPARSE_PLAIN_ROUNDS, verbose_eval=False)
    if trees_of(a.model_to_string()) != trees_of(b.model_to_string()):
        raise AssertionError("training from the cache differs from the CSR")
    del cached, a, b

    # 3. cv through Dataset.subset
    fold_auc = {}

    def record(env):
        if env.iteration in (0, env.end_iteration - 1):
            fold_auc[env.iteration] = [
                dict((m, v) for _, m, v, _ in bst.eval_valid())["auc"]
                for bst in env.model.boosters]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = lt.cv(params, ds, SPARSE_CV_ROUNDS, nfold=SPARSE_CV_FOLDS,
                stratified=False, shuffle=True, seed=0,
                return_cvbooster=True, callbacks=[record])
    torch.cuda.synchronize()
    cv_s = time.perf_counter() - t0
    first, last = fold_auc[0], fold_auc[SPARSE_CV_ROUNDS - 1]
    if not all(b > a for a, b in zip(first, last)):
        raise AssertionError(f"a fold's valid AUC did not rise: {first} -> "
                             f"{last}")
    cvb = res.pop("cvbooster")
    row.update(cv_s=cv_s, cv_s_per_fold=cv_s / SPARSE_CV_FOLDS,
               cv_fold_auc_first=first, cv_fold_auc_last=last,
               cv_auc_mean=res["auc-mean"], cv_auc_stdv=res["auc-stdv"])
    folds = _make_n_folds(ds, None, SPARSE_CV_FOLDS, params, 0, False, True)
    tr = ds.subset(folds[0][0], params)
    te = ds.subset(folds[0][1], params)
    ev = {}
    one = lt.train(params, tr, SPARSE_CV_ROUNDS, valid_sets=[te],
                   valid_names=["valid"], evals_result=ev,
                   verbose_eval=False)
    fold0 = cvb.boosters[0].model_to_string()
    if trees_of(one.model_to_string()) != trees_of(fold0) \
            or ev["valid"]["auc"][-1] != last[0]:
        raise AssertionError("cv's fold 0 differs from a train on its "
                             "subset")
    saved, saved_b1 = plain_kernels(), plain_traverse()
    try:
        plain = lt.train(params, ds.subset(folds[0][0], params),
                         SPARSE_PLAIN_ROUNDS, verbose_eval=False)
    finally:
        restore_kernels(saved)
        restore_traverse(saved_b1)
    if trees_of(plain.model_to_string()) != trees_of(
            cvb.boosters[0].model_to_string(
                num_iteration=SPARSE_PLAIN_ROUNDS)):
        raise AssertionError("cv's fold 0 differs from its plain-version "
                             "run")
    del cvb, tr, te, one, plain

    # 4. continued training
    base = lt.train(params, ds, SPARSE_BASE_ROUNDS, verbose_eval=False)
    vs = ds.create_valid(csr_v, label=yv)
    ev = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cont = lt.train(params, ds, SPARSE_BASE_ROUNDS, init_model=base,
                    valid_sets=[vs], valid_names=["valid"],
                    evals_result=ev, verbose_eval=False)
    torch.cuda.synchronize()
    cont_s = time.perf_counter() - t0
    init = _raw_scores(base, csr, cont).cpu().numpy()[0]
    raw_card = base.predict(csr, raw_score=True)
    raw_host = base.predict(csr[:SPARSE_HOST_ROWS], raw_score=True,
                            device=False)
    if not np.array_equal(init, raw_card.astype(np.float32)):
        raise AssertionError("the init scores differ from predict on the "
                             "card")
    host_err = float(np.abs(raw_card[:SPARSE_HOST_ROWS] - raw_host).max())
    if not np.allclose(raw_card[:SPARSE_HOST_ROWS], raw_host, rtol=1e-5,
                       atol=1e-6):
        raise AssertionError(f"the init scores differ from the host's: "
                             f"{host_err}")
    auc = ev["valid"]["auc"]
    if not auc[-1] > auc[0]:
        raise AssertionError(f"the continued run's valid AUC fell: {auc}")
    saved, saved_b1 = plain_kernels(), plain_traverse()
    try:
        cont_p = lt.train(params, ds, SPARSE_PLAIN_ROUNDS, init_model=base,
                          valid_sets=[ds.create_valid(csr_v, label=yv)],
                          verbose_eval=False)
    finally:
        restore_kernels(saved)
        restore_traverse(saved_b1)
    n_it = SPARSE_BASE_ROUNDS + SPARSE_PLAIN_ROUNDS
    if trees_of(cont_p.model_to_string()) != trees_of(
            cont.model_to_string(num_iteration=n_it)):
        raise AssertionError("the continued run differs from its "
                             "plain-version run")
    row.update(continued_s_per_tree=cont_s / SPARSE_BASE_ROUNDS,
               continued_valid_auc=auc,
               init_score_max_abs_err_vs_host_f64=host_err)
    del cont, cont_p, vs

    # 5. refit on fresh rows
    Xr8, yr = airline_like(SPARSE_REFIT_ROWS, seed=13)
    csr_r = one_hot_csr(Xr8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    refit = base.refit(csr_r, yr)
    torch.cuda.synchronize()
    row["refit_s"] = time.perf_counter() - t0
    saved, saved_b1 = plain_kernels(), plain_traverse()
    try:
        refit_p = base.refit(csr_r, yr)
    finally:
        restore_kernels(saved)
        restore_traverse(saved_b1)
    if refit.model_to_string() != refit_p.model_to_string():
        raise AssertionError("refit differs from its plain-version run")

    # 6. SHAP contributions (host f64)
    rows = csr[:SPARSE_SHAP_ROWS]
    t0 = time.perf_counter()
    contrib = base.predict(rows, pred_contrib=True)
    shap_s = time.perf_counter() - t0
    raw = base.predict(rows.toarray().astype(np.float64), raw_score=True,
                       device=False)
    if contrib.shape != (SPARSE_SHAP_ROWS, csr.shape[1] + 1) or not \
            np.allclose(contrib.sum(axis=1), raw, rtol=1e-9, atol=0.0):
        raise AssertionError("pred_contrib does not sum to the raw scores")
    row.update(pred_contrib_s=shap_s,
               pred_contrib_rows_per_s=SPARSE_SHAP_ROWS / shap_s,
               pred_contrib_trees=base.num_trees())

    launches = {**kernel_launches(), **pk.launch_counts}
    named = {"B1": launches[KERNEL], "B1_leaves": launches[KERNEL
                                                             + "[leaves]"],
             "B1_scores": launches[KERNEL + "[scores]"],
             "B3": launches["ingest"],
             "B4": launches["fused_frontier_accumulate"],
             "B4_sort": launches["fused_slot_order"],
             "B5": launches["fused_sibling_scan"],
             "B6": launches["histogram_pallas"],
             "B2": launches["fused_frontier_splits"]}
    for k in ("B1_leaves", "B1_scores", "B3", "B4", "B5", "B6"):
        if named[k] <= 0:
            raise AssertionError(f"the sparse_cv path never launched {k}")
    expect_launches(launches, zero=INT8_ENTRIES)
    row["launches"] = named
    row["phase_s"] = time.perf_counter() - t_phase
    emit(row)
    return launches


def all_launches(pk) -> dict:
    """Every kernel's launch count now: B1 by mode, then the training
    kernels (``kernel_launches``)."""
    return {**{k: v for k, v in pk.launch_counts.items()},
            **kernel_launches()}


def reset_all_counts(pk) -> None:
    pk.reset_launch_counts()
    reset_training_counts()


def phase_devprof(lt, pk, higgs_text, ds, X, kernel_rows, ing, hist,
                  hist6_rand, qhist, smi):
    """``obs.devprof``'s three tables on the card, each at one shape:
    the histogram family at ``higgs_train_1m``'s 1 M x 28 x 255 on the
    hist phase's K = 128 frontier, the predict family on
    ``higgs_500x255`` at the kernel phase's 65,536 rows, the ingest
    family binning the 1 M x 28 training rows.  Each row's bytes and
    operations are held to the kernel table's at that shape, to the
    byte: B1, B3, B6, B4's quantized root and the f32 B2 and B4 + B5
    rows to the rows the other phases printed; the int8 B2 and B4 + B5
    rows to ``kernel_cost`` at the slotted rows the hist phase counted.
    No utilization above 1.05, each kernel's launches counted; then
    ``run_doctor``'s verdicts."""
    from lightgbm_tpu_torch.obs import devprof as D
    from lightgbm_tpu_torch.obs.diagnose import run_doctor
    from lightgbm_tpu_torch.testing import salt_rows, synthetic_rows
    t_phase = time.perf_counter()
    bst = lt.Booster(model_str=higgs_text)
    dev = bst._device_forest(bst._forest(0, len(bst.models)))
    X65 = salt_rows(synthetic_rows(28, 65536, (), seed=7,
                                   row_seed=65536 + 1)).astype(np.float32)
    reset_all_counts(pk)
    htab = D.histogram_utilization_table(
        rows=TRAIN_ROWS, features=28, num_bins=255, slots=HIST_SLOTS,
        reps=DEVPROF_REPS, slot=hist["frontier_slot"])
    pred = D.predict_utilization_table(dev, reps=DEVPROF_REPS, X=X65)
    ingest = D.ingest_utilization_table(ds, X, reps=1)
    torch.cuda.synchronize()
    launches = all_launches(pk)
    m = htab["slotted_rows"]
    acc, scan = hist["fused_frontier_accumulate"], hist["fused_sibling_scan"]
    if m != acc["slotted_rows"]:
        raise AssertionError(f"devprof's frontier slots {m} rows; the hist "
                             f"phase's {acc['slotted_rows']}")
    shape4 = dict(rows=TRAIN_ROWS, features=28, bins=255, slots=HIST_SLOTS,
                  slotted_rows=acc["slotted_rows"])
    b5q = D.kernel_cost("B5", children=2 * HIST_SLOTS, features=28,
                        bins=255, quant=True)
    pair = hist["fused_frontier_splits"]
    kt = {
        ("hist", "f32/pallas"): (hist6_rand["bytes"], hist6_rand["ops"]),
        # the model axis: 8 lanes' B6 over the one matrix, 8 launches
        ("hist", "f32/scatter_batched8"): (8 * hist6_rand["bytes"],
                                           8 * hist6_rand["ops"]),
        ("hist", "quant/pallas"): (qhist["b4_shapes"]["root"]["bytes"],
                                   qhist["b4_shapes"]["root"]["ops"]),
        ("hist", "f32/fused"): (pair["bytes"], pair["ops"]),
        ("hist", "quant/fused"): tuple(D.kernel_cost(
            "B2", quant=True, **shape4).values()),
        ("hist", "f32/fused_sharded_flat"): (acc["bytes"] + scan["bytes"],
                                             acc["ops"] + scan["ops"]),
        ("hist", "quant/fused_sharded_flat"): tuple(
            a + b for a, b in zip(D.kernel_cost(
                "B4", quant=True, **shape4).values(), b5q.values())),
        ("pred", "fused"): (
            kernel_rows[("higgs_500x255", 65536, False)]["bytes"],
            kernel_rows[("higgs_500x255", 65536, False)]["ops"]),
        ("pred", "fused_scores"): (
            kernel_rows[("higgs_500x255", 65536, True)]["bytes"],
            kernel_rows[("higgs_500x255", 65536, True)]["ops"]),
    }
    kkey = next(k for k in ingest if k.startswith("kernel/"))
    kt[("ingest", kkey)] = (ing["bytes"], ing["ops"])
    tables = {"hist": htab, "pred": pred, "ingest": ingest}
    rows_out = {}
    for (table, name), (nbytes, ops) in kt.items():
        r = tables[table][name]
        if r["route"] != "cuda":
            raise AssertionError(f"devprof {table} {name} ran {r['route']}")
        if (r["bytes_accessed"], r["flops"]) != (nbytes, ops):
            raise AssertionError(
                f"devprof {table} {name}: {r['bytes_accessed']} bytes, "
                f"{r['flops']} ops; the kernel table's: {nbytes}, {ops}")
        for k in ("mfu", "hbm_util"):
            if k not in r or not 0 < r[k] <= 1.05:
                raise AssertionError(f"devprof {table} {name}: {k} "
                                     f"{r.get(k)}")
        rows_out[f"{table}:{name}"] = {
            k: r[k] for k in ("kernel", "seconds_per_call", "bytes_accessed",
                              "flops", "hbm_gbps", "hbm_util", "mfu")}
    for key in ("histogram_pallas", "fused_frontier_splits",
                "fused_frontier_splits_int8", "fused_frontier_accumulate",
                "fused_frontier_accumulate_int8", "fused_sibling_scan",
                "fused_sibling_scan_int8", "fused_slot_order",
                "fused_traverse[leaves]", "fused_traverse[scores]",
                "ingest"):
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"devprof launched no {key}")
    report = run_doctor()
    emit({"phase": "devprof", "device": smi,
          "shapes": {"hist": [TRAIN_ROWS, 28, 255, HIST_SLOTS, m],
                     "pred": [65536, 28, dev.num_trees],
                     "ingest": [ingest["rows"], ingest["features"]]},
          "rows": rows_out, "host_bin_s": ingest["host"]["seconds_per_call"],
          "kernel_speedup_vs_host": ingest["kernel_speedup_vs_host"],
          "launches": {k: v for k, v in launches.items() if v},
          "doctor": {"top_verdict": report["top_verdict"],
                     "verdicts": [(v["name"], v["score"])
                                  for v in report["verdicts"]]},
          "phase_s": time.perf_counter() - t_phase})
    return launches


def phase_coresident(lt, pk, higgs_text, train_data, smi):
    """A ``Fleet`` serves ``higgs_500x255`` on the card under a
    ``ResidencyLedger`` of the card's whole memory (its resident bytes
    leased on the serving plane) to ``CORES_THREADS`` client threads
    while ``coresident.Scheduler.refresh`` trains ``CORES_ROWS`` rows of
    ``higgs_train_1m``'s data for ``CORES_ROUNDS`` rounds beside it,
    and a host reader reads a value back from the card every
    millisecond (the refresh's round-graph captures must survive other
    threads' calls: ROADMAP C-29).  The first consult arms ``resilience.faults``' ``serving.delay`` on
    the clients' calls (``CORES_DELAYS`` calls of ``CORES_DELAY_S``); the
    guard's windowed p99 breaches its ceiling, which throttles the
    refresh, and the breach persists, which pauses it (state to a bundle,
    the non-data lease released); quiet resumes it.  Held: the refreshed
    text byte-identical to a solo ``train`` of the same rows and rounds;
    every answer bit-equal to its model's host float64 path and every
    answer after the swap to the refreshed model's; no failed request;
    the contention verdict.  Printed: the card's peak allocation over the
    refresh against its lease, and the bytes a pause frees against the
    bytes it releases (``empty_cache`` first)."""
    import gc

    from lightgbm_tpu_torch.coresident import (CoresidentConfig,
                                               PauseControl, Scheduler)
    from lightgbm_tpu_torch.obs.diagnose import run_doctor
    from lightgbm_tpu_torch.obs.flight import global_flight
    from lightgbm_tpu_torch.obs.metrics import MetricsRegistry
    from lightgbm_tpu_torch.obs.watchdog import Watchdog, histogram_p99_ms
    from lightgbm_tpu_torch.ops.planner import ResidencyLedger
    from lightgbm_tpu_torch.resilience.faults import ChaosRegistry, FaultSpec
    from lightgbm_tpu_torch.testing import synthetic_rows
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    X, y = train_data[0][:CORES_ROWS], train_data[1][:CORES_ROWS]
    params = dict(TRAIN_PARAMS)
    # the solo run's construct and training, as refresh_s times the
    # refresh's (which also waits out its throttle and pause)
    t0 = time.perf_counter()
    solo = lt.train(dict(params), lt.Dataset(X, label=y), CORES_ROUNDS,
                    verbose_eval=False).model_to_string()
    solo_s = time.perf_counter() - t0
    old = lt.Booster(model_str=higgs_text)
    pool = synthetic_rows(28, CORES_POOL_ROWS, (), seed=7, row_seed=3)
    want_old = old.predict(pool, raw_score=True, device=False)
    tmp = tempfile.mkdtemp(prefix="lgbt_coresident_")
    # the brownout's breach bundles must not spend the dump budget of the
    # phases after this one
    saved_dumps = global_flight.dumps
    fleet = lt.Fleet(max_batch_rows=1024)
    sched = None
    stop = threading.Event()
    armed = threading.Event()
    try:
        fleet.add_model("higgs", old)
        fleet.warm()
        ledger = ResidencyLedger()
        ledger.lease("fleet:resident", fleet.plan.total_resident_bytes,
                     plane="serving")
        wd = Watchdog()
        cfg = CoresidentConfig(brownout_p99_ms=CORES_CEILING_MS,
                               throttle_delay_s=0.05, escalate_s=0.2,
                               recovery_s=0.3, chunk_cap=1,
                               poll_interval_s=0.01, max_pause_s=120.0)
        sched = Scheduler(fleet=fleet, ledger=ledger, config=cfg,
                          watchdog=wd, workdir=tmp)
        lat = MetricsRegistry().histogram("coresident_client_latency_ms")
        sched.guard_latency("higgs", lat)
        chaos = ChaosRegistry([FaultSpec(site="serving", kind="delay", at=i,
                                         arg=CORES_DELAY_S)
                               for i in range(CORES_DELAYS)])

        def plain(Xr):
            return fleet.predict("higgs", Xr, timeout=120)
        delayed = chaos.wrap_predict(plain)
        answers, failures = [], []

        def client(k):
            rng = np.random.RandomState(100 + k)
            while not stop.is_set():
                n = int(rng.randint(1, CORES_MAX_ROWS + 1))
                s = int(rng.randint(0, CORES_POOL_ROWS - n))
                t0 = time.perf_counter()
                try:
                    out = (delayed if armed.is_set() else plain)(
                        pool[s:s + n])
                except Exception as e:  # noqa: BLE001 - counted below
                    failures.append(repr(e))
                    continue
                t1 = time.perf_counter()
                lat.observe((t1 - t0) * 1e3)
                answers.append((t0, s, n, out))

        def sweeper():
            while not stop.is_set():
                wd.check_once()
                time.sleep(0.01)

        # a host reader beside the clients: a read back from the card
        # every millisecond (a launch, a copy and a wait on this thread's
        # stream, as serving's reads), so that the refresh's round-graph
        # captures (one a booster: the first and the resumed) overlap
        # another thread's synchronising calls every time; a device-wide
        # synchronize is not among them (it waits on the capture too)
        syncs = [0]

        def syncer():
            probe = torch.zeros(1, device="cuda")
            while not stop.is_set():
                probe.add_(1.0).item()
                syncs[0] += 1
                time.sleep(0.001)

        threads = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(CORES_THREADS)]
        threads.append(threading.Thread(target=sweeper, daemon=True))
        threads.append(threading.Thread(target=syncer, daemon=True))
        for t in threads:
            t.start()
        time.sleep(0.5)                      # serving alone first
        mem = {}
        state = {"paused": False}
        orig_consult = sched.control.consult

        def wait_for(pred, what):
            t_end = time.monotonic() + 60
            while not pred():
                if time.monotonic() > t_end:
                    raise AssertionError(f"coresident: no {what} within "
                                         "60 s of the injected delay")
                time.sleep(0.005)

        def consult(i):
            if i == 0:
                armed.set()
            elif i == 1 and not state["paused"]:
                wait_for(lambda: sched.control.state != PauseControl.RUN,
                         "throttle")
            elif i == 2 and not state["paused"]:
                wait_for(lambda: sched.control.state == PauseControl.PAUSE,
                         "pause")
                torch.cuda.synchronize()
                mem["before_pause"] = torch.cuda.memory_allocated()
                state["paused"] = True
            return orig_consult(i)
        sched.control.consult = consult
        orig_await = sched._await_resume

        def await_resume(name, want):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem["during_pause"] = torch.cuda.memory_allocated()
            mem["released_bytes"] = int(want)
            mem["held_leases"] = ledger.table()
            return orig_await(name, want)
        sched._await_resume = await_resume

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts(pk)
        t0 = time.perf_counter()
        refreshed, stats = sched.refresh(
            "higgs", lt.Dataset(X, label=y), dict(params), CORES_ROUNDS)
        t_swap = time.perf_counter()
        refresh_s = t_swap - t0
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        time.sleep(0.5)                      # serve the refreshed model
        stop.set()
        for t in threads:
            t.join(120)
        launches = all_launches(pk)
        report = run_doctor()
    finally:
        stop.set()
        if sched is not None:
            sched.close()
        fleet.close(drain=False)
        global_flight.dumps = saved_dumps
        shutil.rmtree(tmp, ignore_errors=True)
    text = refreshed.model_to_string()
    if text != solo:
        raise AssertionError("coresident: the refreshed text differs from "
                             "a solo train of the same rows and rounds")
    want_new = refreshed.predict(pool, raw_score=True, device=False)
    after = mismatched = 0
    for t_start, s, n, out in answers:
        new = np.array_equal(out, want_new[s:s + n])
        if t_start > t_swap:
            after += 1
            mismatched += not new
        elif not (new or np.array_equal(out, want_old[s:s + n])):
            mismatched += 1
    if failures or mismatched or after == 0:
        raise AssertionError(f"coresident: {len(failures)} failed "
                             f"({failures[:3]}), {mismatched} mismatched, "
                             f"{after} answers after the swap")
    if stats["pauses"] < 1 or stats["throttles"] < 1:
        raise AssertionError(f"coresident: the delay drove {stats}")
    names = [v["name"] for v in report["verdicts"]]
    if "contention" not in names:
        raise AssertionError(f"coresident: no contention verdict: {names}")
    for key in ("fused_traverse[leaves]", "ingest", "fused_frontier_splits",
                "fused_frontier_accumulate", "fused_sibling_scan"):
        if launches.get(key, 0) <= 0:
            raise AssertionError(f"coresident launched no {key}")
    freed = mem["before_pause"] - mem["during_pause"]
    emit({"phase": "coresident", "device": smi, "rows": CORES_ROWS,
          "rounds": CORES_ROUNDS, "clients": CORES_THREADS,
          "requests": len(answers), "answers_after_swap": after,
          "syncer_reads": syncs[0],
          "text": "byte-identical to a solo train", "stats": stats,
          "refresh_s": refresh_s, "solo_s": solo_s,
          "lease_bytes": stats["predicted_peak_bytes"],
          "held_bytes": stats["held_bytes"],
          "allocated_before_refresh": base,
          "peak_allocated_over_refresh": peak,
          "peak_over_lease": peak / max(stats["predicted_peak_bytes"], 1),
          "allocated_before_pause": mem["before_pause"],
          "allocated_during_pause": mem["during_pause"],
          "freed_by_pause": freed,
          "released_by_pause": mem["released_bytes"],
          "kept_by_pause": mem["during_pause"] - base,
          "leases_during_pause": mem["held_leases"],
          "client_p99_ms": histogram_p99_ms(lat),
          "doctor": [(v["name"], v["score"]) for v in report["verdicts"]],
          "launches": {k: v for k, v in launches.items() if v},
          "phase_s": time.perf_counter() - t_phase})
    return launches


def sweep_lanes() -> list:
    """The sweep's lane configs: the training run's params, each lane
    its own learning rate, bagging seed and feature fraction."""
    return [dict(TRAIN_PARAMS, learning_rate=0.05 + 0.02 * i,
                 bagging_fraction=0.8, bagging_freq=1, bagging_seed=3 + i,
                 feature_fraction=(1.0, 0.9, 0.8, 0.7)[i % 4])
            for i in range(MANY_LANES)]


def group_programs():
    """Collect every ``multi.batch.BatchedChunkProgram`` built while the
    returned lists live, each counting its dispatches (``chunks``), and
    every plan ``multi.driver._group_plan`` elected for a group (restore
    with ``stop()``)."""
    from lightgbm_tpu_torch.multi import batch as mb
    from lightgbm_tpu_torch.multi import driver as md
    made, plans = [], []
    orig_init, orig_plan = mb.BatchedChunkProgram.__init__, md._group_plan

    def spy(self, group):
        orig_init(self, group)
        self.chunks = 0
        run = self.dispatch

        def counted(*a, **k):
            self.chunks += 1
            return run(*a, **k)
        self.dispatch = counted
        made.append(self)

    def plan_spy(g):
        plan = orig_plan(g)
        plans.append(plan)
        return plan
    mb.BatchedChunkProgram.__init__ = spy
    md._group_plan = plan_spy

    def stop():
        mb.BatchedChunkProgram.__init__ = orig_init
        md._group_plan = orig_plan
    return made, plans, stop


def group_rounds_row(prog) -> dict:
    """A group's round counts; fails unless every round that ran all of
    its lanes together was one group-graph replay (or the one eager round
    before a capture)."""
    rg = prog.rounds
    row = {"lanes": len(prog.group.boosters), "group_rounds": rg.group_rounds,
           "group_graph_replays": rg.replays, "captures": rg.captures,
           "capture_ms": rg.capture_ms, "lane_rounds": rg.lane_rounds}
    if rg.replays + rg.captures != rg.group_rounds or rg.replays <= 0:
        raise AssertionError(f"the group's rounds were not one graph "
                             f"replay each: {row}")
    row["group_graph_replays_per_round"] = (
        rg.replays / (rg.group_rounds - rg.captures))
    return row


TRAIN_KERNELS = ("fused_frontier_splits", "fused_frontier_accumulate",
                 "fused_slot_order", "fused_sibling_scan", "histogram_pallas",
                 "ingest")


def lr_schedule_group(lt, ds) -> dict:
    """Two lanes under learning-rate schedules (``reset_parameter``
    callbacks) as one ``train_many`` group over ``MANY_LR_ROUNDS``
    rounds: the chunks 4, 2, 1, each followed by the lanes' learning
    rate reset.  Held: each lane's text equal to its solo card run, at
    least 3 dispatches, and the group graph captured once (the resets
    keep every lane's grower, so the graph replays across chunks)."""
    params = sweep_lanes()[:2]

    def sched(i):
        base = params[i]["learning_rate"]
        return lt.reset_parameter(learning_rate=lambda j: base * 0.9 ** j)
    solo = [lt.train(dict(p), ds, MANY_LR_ROUNDS, verbose_eval=False,
                     callbacks=[sched(i)]).model_to_string()
            for i, p in enumerate(params)]
    programs, _, stop = group_programs()
    try:
        many = lt.train_many([dict(p) for p in params], ds, MANY_LR_ROUNDS,
                             callbacks=[[sched(i)] for i in range(2)])
    finally:
        stop()
    if [b.model_to_string() for b in many] != solo:
        raise AssertionError("multi_train: an lr_schedule lane differs "
                             "from its solo card run")
    if len(programs) != 1:
        raise AssertionError(f"multi_train: the lr_schedule lanes formed "
                             f"{len(programs)} group programs")
    row = group_rounds_row(programs[0])
    row["chunks"] = programs[0].chunks
    if row["chunks"] < 3 or row["captures"] != 1:
        raise AssertionError(f"multi_train: the lr_schedule group ran "
                             f"{row['chunks']} chunks with "
                             f"{row['captures']} captures")
    return dict(row, rounds=MANY_LR_ROUNDS,
                texts="every lane byte-identical to its solo card run")


def phase_multi_train(lt, pk, train_data, smi) -> dict:
    """The model axis on the card (``multi/``).  ``MANY_LANES`` configs
    (``sweep_lanes``) over ``MANY_ROWS`` rows of the training data, at
    its full width, each trained alone on the card, then all of them as
    one ``train_many`` group (the main path: counts from 0).  Held: each
    lane's text equal to its solo text; one group program whose every
    all-lane round was one graph replay; every training kernel's
    launches equal to the solo runs' sum (B4, its sort and B5 through
    B2; each lane runs its solo rounds).  Then ``lr_schedule_group``
    (two lanes under learning-rate schedules over several chunks), and
    ``cv(fused=True)`` of ``MANY_CV_FOLDS`` stacked folds for
    ``MANY_CV_ROUNDS`` rounds equal to serial ``cv`` on the card.
    Printed: seconds a lane tree batched and solo (a record, not a
    claim), and the predicted peak of the plan that ``train_many``
    elected for the group (``multi.driver._group_plan``) beside the
    allocator's peak over it (above the allocation before it, plus the
    shared binned matrix the prediction counts)."""
    import gc

    t_phase = time.perf_counter()
    X, y = train_data[0][:MANY_ROWS], train_data[1][:MANY_ROWS]
    ds = lt.Dataset(X, label=y)
    ds.construct()
    lanes = sweep_lanes()
    # each lane alone on the card
    reset_all_counts(pk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo = [lt.train(dict(p), ds, MANY_ROUNDS, verbose_eval=False)
            for p in lanes]
    torch.cuda.synchronize()
    solo_s = time.perf_counter() - t0
    solo_launches = all_launches(pk)
    solo_texts = [b.model_to_string() for b in solo]
    del solo
    gc.collect()
    torch.cuda.empty_cache()
    # the main path: the lanes as one group
    programs, plans, stop = group_programs()
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_all_counts(pk)
        t0 = time.perf_counter()
        many = lt.train_many([dict(p) for p in lanes], ds, MANY_ROUNDS)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t0
        launches = all_launches(pk)
        peak = torch.cuda.max_memory_allocated() - base
    finally:
        stop()
    texts = [b.model_to_string() for b in many]
    bad = [i for i, (a, b) in enumerate(zip(texts, solo_texts)) if a != b]
    if bad:
        raise AssertionError(f"multi_train: lanes {bad} differ from their "
                             "solo card runs")
    if len(programs) != 1 or len(programs[0].group.boosters) != MANY_LANES:
        raise AssertionError(f"multi_train: {len(programs)} group programs")
    group = group_rounds_row(programs[0])
    if group["captures"] != 1:
        raise AssertionError(f"multi_train: the group was captured "
                             f"{group['captures']} times")
    diff = {k: (launches.get(k, 0), solo_launches.get(k, 0))
            for k in TRAIN_KERNELS
            if launches.get(k, 0) != solo_launches.get(k, 0)}
    if diff:
        raise AssertionError(f"multi_train: launches (group, solo sum) "
                             f"differ: {diff}")
    for k in ("fused_frontier_splits", "fused_frontier_accumulate",
              "fused_slot_order"):
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"multi_train launched no {k}")
    # the plan the main path elected for the group (_dispatch_groups)
    if len(plans) != 1:
        raise AssertionError(f"multi_train: {len(plans)} group plans")
    plan = plans[0]
    if plan.b_chunk != MANY_LANES:
        raise AssertionError(f"multi_train: the plan elected "
                             f"{plan.b_chunk} lanes")
    b0 = many[0].boosting
    binned = b0.binned_t.numel() * b0.binned_t.element_size()
    del many
    gc.collect()
    lr_group = lr_schedule_group(lt, ds)
    # cv: the folds as stacked lanes, against serial cv on the card
    cv_params = dict(TRAIN_PARAMS, metric="binary_logloss")
    kw = dict(nfold=MANY_CV_FOLDS, stratified=False, shuffle=False,
              verbose_eval=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = lt.cv(dict(cv_params), ds, MANY_CV_ROUNDS, **kw)
    torch.cuda.synchronize()
    cv_serial_s = time.perf_counter() - t0
    programs, _, stop = group_programs()
    try:
        t0 = time.perf_counter()
        fused_cv = lt.cv(dict(cv_params), ds, MANY_CV_ROUNDS, fused=True,
                         **kw)
        torch.cuda.synchronize()
        cv_fused_s = time.perf_counter() - t0
    finally:
        stop()
    if fused_cv != serial:
        raise AssertionError("multi_train: cv(fused=True) differs from "
                             "serial cv")
    if len(programs) != 1 or len(programs[0].group.boosters) != \
            MANY_CV_FOLDS:
        raise AssertionError(f"multi_train: cv formed {len(programs)} "
                             "group programs")
    cv_group = group_rounds_row(programs[0])
    trees = MANY_LANES * MANY_ROUNDS
    emit({"phase": "multi_train", "device": smi, "rows": MANY_ROWS,
          "features": 28, "leaves": TRAIN_PARAMS["num_leaves"],
          "bins": TRAIN_PARAMS["max_bin"], "lanes": MANY_LANES,
          "rounds": MANY_ROUNDS,
          "texts": "every lane byte-identical to its solo card run",
          "group": group,
          "launches_equal_solo_sum": {k: launches.get(k, 0)
                                      for k in TRAIN_KERNELS},
          "batched_s": batched_s, "solo_s": solo_s,
          "s_per_lane_tree_batched": batched_s / trees,
          "s_per_lane_tree_solo": solo_s / trees,
          "plan": plan.summary(),
          "predicted_peak_bytes": plan.predicted_peak_bytes,
          "measured_peak_bytes": peak + binned,
          "measured_over_predicted": (peak + binned)
          / max(plan.predicted_peak_bytes, 1),
          "lr_schedule_group": lr_group,
          "cv": {"folds": MANY_CV_FOLDS, "rounds": MANY_CV_ROUNDS,
                 "equal_to_serial": True, "group": cv_group,
                 "fused_s": cv_fused_s, "serial_s": cv_serial_s},
          "launches": {k: v for k, v in launches.items() if v},
          "phase_s": time.perf_counter() - t_phase})
    return launches


class CountSyncs:
    """Count the calls of ``torch.cuda.synchronize`` (device-wide) made
    while the block runs, from any thread."""

    def __enter__(self):
        self.calls = 0
        self._orig = torch.cuda.synchronize

        def counted(*a, **k):
            self.calls += 1
            return self._orig(*a, **k)
        torch.cuda.synchronize = counted
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize = self._orig
        return False


def phase_lifecycle(lt, pk, higgs_text, train_data, smi) -> dict:
    """The guarded lifecycle on the card (``lifecycle/``): a ``Fleet``
    serves ``higgs_500x255``; ``LifecycleController.refresh`` warm-starts
    ``LC_TREES`` trees over ``LC_ROWS`` fresh rows binned on the deployed
    grid (the first ``LC_ROWS`` rows of the training data), and
    ``promote`` drives the candidate through the probe, the shadow
    mirror, a two-step canary ramp and the cutover under threaded
    traffic; the fleet then serves it bit-identically (the serving
    contract's host float64 sums).  A second refresh promoted under an
    impossible drift budget rolls back: the fleet serves the promoted
    model byte-identically and a flight bundle names ``drift``.  A
    candidate poisoned to NaN is stopped at the probe and never
    registered.  No device-wide ``torch.cuda.synchronize()`` while the
    traffic threads run (``CountSyncs``).  The launches of that main
    path are counted from 0.  Then ``refresh_many`` of 2 segments of
    ``LC_SEGMENT_ROWS`` rows equals the serial candidates."""
    import shutil
    import tempfile

    from lightgbm_tpu_torch.lifecycle import (LifecycleConfig,
                                              LifecycleController,
                                              booster_digest)
    from lightgbm_tpu_torch.lifecycle.refresh import (fresh_dataset,
                                                      refresh_many,
                                                      train_candidate)
    from lightgbm_tpu_torch.obs.flight import global_flight
    from lightgbm_tpu_torch.resilience.checkpoint import build_bundle_bytes
    from lightgbm_tpu_torch.tools.torch_lifecycle_smoke import (
        _loadgen_traffic)
    from lightgbm_tpu_torch.utils.file_io import write_atomic
    t_phase = time.perf_counter()
    X, y = train_data[0], train_data[1]
    rows = [slice(i * LC_ROWS, (i + 1) * LC_ROWS) for i in range(3)]
    base = lt.Dataset(X[rows[0]], label=y[rows[0]], free_raw_data=False)
    base.construct()
    params = dict(TRAIN_PARAMS, metric="binary_logloss")
    deployed = lt.Booster(model_str=higgs_text)
    probe = X[:1024].astype(np.float64)
    traffic = _loadgen_traffic(LC_REQUESTS, LC_THREADS, LC_MAX_ROWS)
    tmp = tempfile.mkdtemp(prefix="lgbt_lifecycle_")
    saved_dumps = global_flight.dumps
    global_flight.dumps = 0
    fleet = lt.Fleet(max_batch_rows=1024)
    try:
        # the gates judge latency; no queue deadline of the fleet's
        # classes may expire a request of the check
        fleet.add_model("live", deployed, deadline_class="batch")
        fleet.warm()
        reset_all_counts(pk)
        ctl = LifecycleController(
            fleet, "live", directory=f"{tmp}/ok",
            config=LifecycleConfig(drift_budget=1e3, mirror_fraction=0.5,
                                   ramp=(0.25, 0.5)))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle, cand = ctl.refresh(X[rows[1]], y[rows[1]], params=params,
                                   num_boost_round=LC_TREES, base=base)
        torch.cuda.synchronize()
        refresh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with CountSyncs() as syncs_ok:
            res = ctl.promote(bundle, probe_X=probe, traffic=traffic)
        promote_s = time.perf_counter() - t0
        served = fleet.predict("live", probe, timeout=120)
        want = cand.predict(probe, raw_score=True, device=False)
        if res["status"] != "promoted" or not np.array_equal(served, want):
            raise AssertionError(f"lifecycle: promotion {res['status']} "
                                 f"{res.get('gate')}, served bit-equal "
                                 f"{np.array_equal(served, want)}")
        if fleet.entry("live").model.digest != booster_digest(cand):
            raise AssertionError("lifecycle: the live digest is not the "
                                 "candidate's")
        # a refresh under an impossible drift budget: rolled back
        pre = fleet.predict("live", probe, timeout=120)
        ctl2 = LifecycleController(
            fleet, "live", directory=f"{tmp}/bad",
            config=LifecycleConfig(drift_budget=1e-12, mirror_fraction=1.0,
                                   ramp=(0.5,)))
        bundle2, cand2 = ctl2.refresh(X[rows[2]], y[rows[2]], params=params,
                                      num_boost_round=LC_TREES, base=base)
        with CountSyncs() as syncs_bad:
            res2 = ctl2.promote(bundle2, probe_X=probe, traffic=traffic)
        post = fleet.predict("live", probe, timeout=120)
        dumps = sorted(d for d in os.listdir(global_flight.out_dir())
                       if d.startswith("flight_lifecycle") and "drift" in d)
        if (res2["status"], res2.get("gate")) != ("rolled_back", "drift") \
                or not np.array_equal(pre, post) or not dumps:
            raise AssertionError(
                f"lifecycle: drift run {res2['status']} {res2.get('gate')},"
                f" byte-identical {np.array_equal(pre, post)}, bundles "
                f"{dumps}")
        # a NaN candidate: stopped at the probe, never registered
        cand2.boosting.models[-1].leaf_value[:] = np.nan
        write_atomic(bundle2, build_bundle_bytes(
            cand2, cand2.current_iteration()))
        added = []
        orig_add = fleet.add_model
        fleet.add_model = lambda name, *a, **k: (added.append(name),
                                                 orig_add(name, *a, **k))[1]
        ctl3 = LifecycleController(
            fleet, "live", directory=f"{tmp}/bad",
            config=LifecycleConfig(drift_budget=1e3, ramp=(0.5,)))
        res3 = ctl3.promote(bundle2, probe_X=probe, traffic=traffic)
        fleet.add_model = orig_add
        if (res3["status"], res3.get("gate")) != ("rolled_back", "probe") \
                or added or fleet.models() != ["live"] \
                or not np.array_equal(
                    pre, fleet.predict("live", probe, timeout=120)):
            raise AssertionError(f"lifecycle: NaN candidate {res3['status']}"
                                 f" {res3.get('gate')}, registered {added}")
        torch.cuda.synchronize()
        launches = all_launches(pk)
        if syncs_ok.calls or syncs_bad.calls:
            raise AssertionError(
                f"lifecycle: {syncs_ok.calls + syncs_bad.calls} device-wide "
                "synchronize calls while the traffic threads ran")
        for key in ("fused_traverse[leaves]", "fused_traverse[scores]",
                    "ingest", "fused_frontier_splits",
                    "fused_frontier_accumulate", "fused_slot_order"):
            if launches.get(key, 0) <= 0:
                raise AssertionError(f"lifecycle launched no {key}")
    finally:
        fleet.close(drain=False)
        global_flight.dumps = saved_dumps
        shutil.rmtree(tmp, ignore_errors=True)
    # a family of two segments in one run against the serial candidates
    seg = [slice(3 * LC_ROWS + i * LC_SEGMENT_ROWS,
                 3 * LC_ROWS + (i + 1) * LC_SEGMENT_ROWS) for i in range(2)]
    seg_params = [dict(params), dict(params, learning_rate=0.2)]

    def fresh_sets():
        return [fresh_dataset(base, X[s], y[s]) for s in seg]
    t0 = time.perf_counter()
    family = refresh_many([deployed, deployed], fresh_sets(), seg_params,
                          LC_TREES)
    torch.cuda.synchronize()
    family_s = time.perf_counter() - t0
    serial = [train_candidate(deployed, d, p, LC_TREES)
              for d, p in zip(fresh_sets(), seg_params)]
    if [c.model_to_string() for c in family] != \
            [c.model_to_string() for c in serial]:
        raise AssertionError("lifecycle: refresh_many differs from the "
                             "serial candidates")
    emit({"phase": "lifecycle", "device": smi, "fresh_rows": LC_ROWS,
          "refresh_trees": LC_TREES,
          "candidate_iterations": cand.current_iteration(),
          "promotion": {"status": res["status"],
                        "served": "bit-identical to the candidate",
                        "shadow": res["phases"].get("shadow"),
                        "ramp": res["phases"].get("ramp")},
          "drift_rollback": {"status": res2["status"],
                             "gate": res2["gate"],
                             "served": "byte-identical to the promoted "
                                       "model", "flight_bundles": dumps},
          "nan_candidate": {"gate": res3["gate"], "registered": added},
          "device_wide_syncs_under_traffic": 0,
          "refresh_s": refresh_s, "promote_s": promote_s,
          "refresh_many": {"segments": 2, "rows": LC_SEGMENT_ROWS,
                           "equal_to_serial": True, "seconds": family_s},
          "launches": {k: v for k, v in launches.items() if v},
          "phase_s": time.perf_counter() - t_phase})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import _build
    from lightgbm_tpu_torch.ops import predict_kernels as pk
    from lightgbm_tpu_torch.testing import synthetic_model_text

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi})

    # the flight recorder's bundles (a quarantined swap dumps one) go to
    # a temporary directory, not the checkout
    import shutil
    import tempfile
    flight_tmp = tempfile.mkdtemp(prefix="lgbt_flight_")
    os.environ.setdefault("LIGHTGBM_TPU_FLIGHT_DIR", flight_tmp)
    try:
        return run_phases(lt, _build, pk, synthetic_model_text, smi)
    finally:
        shutil.rmtree(flight_tmp, ignore_errors=True)


def run_phases(lt, _build, pk, synthetic_model_text, smi) -> int:
    t0 = time.perf_counter()
    # the native host library (g++) builds beside the four nvcc processes
    from lightgbm_tpu_torch.native import build as native_build
    host_lib: dict = {}

    def build_host_lib():
        t = time.perf_counter()
        try:
            host_lib["path"] = native_build.build()
        except Exception as e:  # noqa: BLE001 - raised below
            host_lib["error"] = e
        host_lib["seconds"] = time.perf_counter() - t

    host_thread = threading.Thread(target=build_host_lib)
    host_thread.start()
    libs = _build.build(["traverse", "ingest", "fused", "histogram"])
    host_thread.join(300)
    if "error" in host_lib or "path" not in host_lib:
        raise RuntimeError(f"the native host library did not build: "
                           f"{host_lib.get('error')!r}")
    root = os.path.dirname(os.path.abspath(__file__))
    # the shared atomics of the two histogram kernels (B4, B6)
    atomics = {"fused": ("accumulate_atomics", "accumulate_kernel"),
               "histogram": ("histogram_atomics", "histogram_kernel")}
    atomics = {name: (key, sass_atomics(_build, libs[name], kernel), kernel)
               for name, (key, kernel) in atomics.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {
              name: {"path": os.path.relpath(lib, root),
                     "fresh": _build.build_info[name]["seconds"] > 0,
                     "ptxas": [ln.strip() for ln in
                               _build.build_info[name]["ptxas"].splitlines()
                               if "registers" in ln or "spill" in ln],
                     **({atomics[name][0]: atomics[name][1]}
                        if name in atomics else {})}
              for name, lib in libs.items()},
          "native_host_library": {
              "path": os.path.relpath(host_lib["path"], root),
              "seconds": host_lib["seconds"]}})
    for _key, found, kernel in atomics.values():
        native_shared_atomics(found, kernel)

    t0 = time.perf_counter()
    higgs = synthetic_model_text(28, 500, 255, seed=7)
    multi_cats = (0, 7, 13)
    multi = synthetic_model_text(20, 100, 31, num_class=5,
                                 cat_features=multi_cats, seed=101)
    wide = synthetic_model_text(400, 10, 15, cat_features=(3,), seed=5)
    models = {
        "higgs_500x255": (lt.Booster(model_str=higgs), 28, (), 7),
        "multiclass5_cat": (lt.Booster(model_str=multi), 20, multi_cats, 101),
        "wide_400": (lt.Booster(model_str=wide), 400, (3,), 5),
    }
    emit({"phase": "models", "seconds": time.perf_counter() - t0,
          "higgs_text_bytes": len(higgs)})

    rows, max_err = phase_kernel(pk, models)
    launches, serve_row = phase_serve(pk, models["higgs_500x255"][0], 28, 7)
    swap_row = phase_swap_serve(pk, lt, models["higgs_500x255"][0], 28, 7,
                                serve_row)
    del models
    fleet_launches = phase_fleet_serve(pk, lt, higgs, 28, 7, smi)
    train_run, train_data = phase_train(lt)
    train_launches, ds, bst = (train_run["launches"], train_run["ds"],
                               train_run["bst"])
    train_modes = train_run["row"]["b5_launches_by_mode"]
    # what the serial grower's CEGB run is held to
    train_stats = {"features": len(used_features(bst)),
                   "leaves": sum(m.num_leaves for m in bst.models)}
    ing = phase_ingest(ds, train_data[0])
    hist = phase_hist(ds, bst)
    hist6_rand = phase_hist6(ds, bst, "higgs_rand_1m")
    qhist = phase_quant_hist(ds, bst)
    devprof_launches = phase_devprof(lt, pk, higgs, ds, train_data[0], rows,
                                     ing, hist, hist6_rand, qhist, smi)
    coresident_launches = phase_coresident(lt, pk, higgs, train_data, smi)
    multi_launches = phase_multi_train(lt, pk, train_data, smi)
    lifecycle_launches = phase_lifecycle(lt, pk, higgs, train_data, smi)
    del ds, bst
    train_run.pop("bst")
    phase_wide_bins(lt)
    efb_launches, efb_ds, efb_bst = phase_efb_train(lt, pk)
    sparse_launches = phase_sparse_cv(lt, pk, efb_ds, smi)
    hist6 = phase_hist6(efb_ds, efb_bst, "airline_onehot_1m")
    onehot = phase_onehot_scan(efb_ds, efb_bst)
    del efb_bst
    quant_launches = phase_quant_train(lt, train_run, train_data, efb_ds)
    rand_launches, rand_modes = phase_rand_train(lt, train_run, train_data)
    phase_goss_train(lt, train_run, train_data, efb_ds)
    serial_launches = phase_serial_train(lt, train_run, train_data, efb_ds,
                                         train_stats)
    sharded_launches = phase_sharded_train(lt, train_run, smi)
    hybrid_launches = phase_hybrid_train(lt, smi)
    stream_launches = phase_stream_train(lt, pk, train_data, smi)
    phase_obs_trace(lt, pk, train_run, smi)
    ckpt_launches = phase_ckpt_cli(lt, pk, train_run, train_data, smi)
    del train_run, train_data
    mono_launches, mono_modes, mono_ds = phase_mono_train(lt, pk, efb_ds)
    del efb_ds
    phase_boost_variants(lt, mono_ds)
    del mono_ds
    cat_launches, cat_modes, cat_b5 = phase_cat_train(lt, pk)
    phase_multiclass_train(lt, pk)
    rank_launches, rank_modes, rank_b5 = phase_rank_train(lt, pk)
    wide, over = phase_wide_ingest(lt)

    # B1: leaves mode at the 1024-row bucket (serving's routing), scores
    # mode at the 1024-row bucket and the 65,536-row predict chunk
    # (Booster.predict); each row with its mode's launches in the serving
    # run (leaves: the serving batches; scores: the predict chunks) and
    # the largest error its mode showed in the kernel phase
    table = []
    for label, n_t, scores in ((KERNEL, 1024, False),
                               (f"{KERNEL}[scores]", 1024, True),
                               (f"{KERNEL}[scores, 65536 rows]", 65536,
                                True)):
        mode = "scores" if scores else "leaves"
        if launches[mode] <= 0:
            raise AssertionError(f"the main path never launched B1's "
                                 f"{mode} mode")
        head = rows[("higgs_500x255", n_t, scores)]
        table.append({
            "name": label, "route": "cuda",
            "source": "lightgbm_tpu_torch/ops/csrc/traverse.cu",
            "replaces": "lightgbm_tpu/ops/predict_kernels.py:238",
            "launches": launches[mode], "max_abs_err": max_err[mode],
            "ms": head["kernel_ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": None,
            "swap_serve_launches": swap_row["swap_launches"][mode],
            "fleet_serve_launches": fleet_launches[mode]})
    # leaves mode on the bf16 and int8 planes (swap_serve's servers)
    for prec in ("bf16", "int8"):
        lp, b1 = swap_row["lowprec"][prec], swap_row["b1_leaves_1024"][prec]
        if lp["launches"] <= 0:
            raise AssertionError(f"{prec} serving never launched B1")
        table.append({
            "name": f"{KERNEL}[{prec} planes]", "route": "cuda",
            "source": "lightgbm_tpu_torch/ops/csrc/traverse.cu",
            "replaces": "lightgbm_tpu/ops/predict_kernels.py:238",
            "launches": lp["launches"], "max_abs_err": lp["max_abs_err"],
            "ms": b1["ms"], "plain_ms": b1["plain_ms"],
            "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
            "library_ms": None,
            "f32_planes_ms": swap_row["b1_leaves_1024"]["f32"]["ms"]})
    fused_src = "lightgbm_tpu_torch/ops/csrc/fused.cu"
    for name, src, replaces, r in (
            ("ingest", "lightgbm_tpu_torch/ops/csrc/ingest.cu",
             "lightgbm_tpu/ops/ingest.py:233", ing),
            ("fused_frontier_splits", fused_src,
             "lightgbm_tpu/ops/fused.py:151",
             hist["fused_frontier_splits"]),
            ("fused_frontier_accumulate", fused_src,
             "lightgbm_tpu/ops/fused.py:375",
             hist["fused_frontier_accumulate"]),
            ("fused_slot_order", fused_src,
             "lightgbm_tpu/ops/fused.py:375", hist["fused_slot_order"]),
            ("fused_sibling_scan", fused_src,
             "lightgbm_tpu/ops/fused.py:403", hist["fused_sibling_scan"])):
        table.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name, replaces in (
            ("fused_frontier_splits", "lightgbm_tpu/ops/fused.py:151"),
            ("fused_frontier_accumulate", "lightgbm_tpu/ops/fused.py:375"),
            ("fused_slot_order", "lightgbm_tpu/ops/fused.py:375"),
            ("fused_sibling_scan", "lightgbm_tpu/ops/fused.py:403")):
        r = qhist[name]
        table.append({
            "name": f"{name}[int8]", "route": "cuda", "source": fused_src,
            "replaces": replaces, "launches": quant_launches[name + "_int8"],
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for row in table:
        if row["name"] == "fused_sibling_scan":
            row["modes"] = train_modes
        elif row["name"] == "fused_sibling_scan[int8]":
            row["modes"] = quant_launches["b5_modes"]
    scan_src = "lightgbm_tpu/ops/fused.py:403"
    for name, r, launches, modes in (
            # B5's modes: launches of the mode in the main-path run that
            # drives it; the int8 monotone mode is on no training path
            # (train falls back to f32 under monotone constraints, as the
            # JAX package does, and reaches it only through the
            # JAX-signature wrappers): its row counts B5 int8's launches
            # in quant_train, whose modes it lists
            ("fused_sibling_scan[monotone+bounds]",
             hist["b5_modes"]["monotone+bounds"],
             mono_modes.get("monotone+bounds", 0), mono_modes),
            ("fused_sibling_scan[int8,monotone+bounds]",
             qhist["b5_modes"]["monotone+bounds"],
             quant_launches["fused_sibling_scan_int8"],
             quant_launches["b5_modes"]),
            ("fused_sibling_scan[rand_thr]", hist["b5_modes"]["rand_thr"],
             rand_modes.get("rand_thr", 0), rand_modes),
            ("fused_sibling_scan[onehot leaf]", onehot,
             efb_launches["fused_sibling_scan"],
             efb_launches["b5_modes"]),
            ("fused_sibling_scan[cat shape]", cat_b5,
             cat_launches["fused_sibling_scan"], cat_modes),
            ("fused_sibling_scan[rank shape]", rank_b5,
             rank_launches["fused_sibling_scan"], rank_modes)):
        table.append({
            "name": name, "route": "cuda", "source": fused_src,
            "replaces": scan_src, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "modes": modes})
    for name, r in (("ingest[2000 features]", wide),
                    ("ingest[oversize EFB group]", over)):
        table.append({
            "name": name, "route": "cuda",
            "source": "lightgbm_tpu_torch/ops/csrc/ingest.cu",
            "replaces": "lightgbm_tpu/ops/ingest.py:233",
            "launches": (r.get("construct_launches")
                         or r["launches_per_binning"]),
            "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name, r, n_launch in (
            ("histogram_pallas", hist6, efb_launches["histogram_pallas"]),
            ("histogram_pallas[rand shape]", hist6_rand,
             rand_launches["histogram_pallas"])):
        table.append({
            "name": name, "route": "cuda",
            "source": "lightgbm_tpu_torch/ops/csrc/histogram.cu",
            "replaces": "lightgbm_tpu/ops/histogram.py:199",
            "launches": n_launch, "max_abs_err": r["max_abs_err"],
            "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # each row's launches on the sparse_cv path as well (B2 and the int8
    # entries launch nothing there)
    sparse_of = {KERNEL: KERNEL + "[leaves]",
                 f"{KERNEL}[scores]": KERNEL + "[scores]",
                 "ingest": "ingest", "fused_slot_order": "fused_slot_order",
                 "fused_frontier_accumulate": "fused_frontier_accumulate",
                 "fused_sibling_scan": "fused_sibling_scan",
                 "histogram_pallas": "histogram_pallas",
                 "fused_frontier_splits": "fused_frontier_splits"}
    for row in table:
        if row["name"] in sparse_of:
            row["sparse_cv_launches"] = sparse_launches[sparse_of[row["name"]]]
        if row["name"] == "ingest":
            row["fleet_serve_launches"] = fleet_launches["ingest"]
    # the ckpt_cli phase: its own process's launches (B1 in scores mode,
    # the f32 B2/B3/B4/B5); the CLI's subprocesses are not counted here
    ckpt_of = {f"{KERNEL}[scores]": "fused_traverse",
               "ingest": "ingest",
               "fused_frontier_splits": "fused_frontier_splits",
               "fused_frontier_accumulate": "fused_frontier_accumulate",
               "fused_sibling_scan": "fused_sibling_scan"}
    for row in table:
        if row["name"] in ckpt_of:
            row["ckpt_cli_launches"] = ckpt_launches[ckpt_of[row["name"]]]
    # and on the serial_train, sharded_train, hybrid_train and
    # stream_train paths (every training entry, f32 and int8;
    # sharded_train's and hybrid_train's: rank 0's, hybrid_train's B1
    # the resumed booster's predict; stream_train's B1: the bulk
    # scorer's leaves mode)
    for row in table:
        key = row["name"].replace("[int8]", "_int8")
        if key in serial_launches:
            row["serial_train_launches"] = serial_launches[key]
        if key in sharded_launches:
            row["sharded_train_launches"] = sharded_launches[key]
        if key in hybrid_launches:
            row["hybrid_train_launches"] = hybrid_launches[key]
        key = KERNEL + "[leaves]" if row["name"] == KERNEL else key
        if key in stream_launches:
            row["stream_train_launches"] = stream_launches[key]
    # and on the devprof and coresident paths (their tables' and the
    # refresh beside serving's launches)
    of_row = {KERNEL: KERNEL + "[leaves]",
              f"{KERNEL}[scores]": KERNEL + "[scores]"}
    for row in table:
        key = of_row.get(row["name"],
                         row["name"].replace("[int8]", "_int8"))
        if key in devprof_launches:
            row["devprof_launches"] = devprof_launches[key]
        if key in coresident_launches:
            row["coresident_launches"] = coresident_launches[key]
        # the model axis' group run and the lifecycle's main path
        if key in multi_launches:
            row["multi_train_launches"] = multi_launches[key]
        if key in lifecycle_launches:
            row["lifecycle_launches"] = lifecycle_launches[key]
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
