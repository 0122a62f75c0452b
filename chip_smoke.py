"""Chip smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(``--kernels``: build and check the kernels only, on the Higgs data and,
for the ordered histograms, on synthetic Expo-shaped bins made on the card,
then stop without the result lines.)

Phases (any failed check raises, and the script exits non-zero):
  device   the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  build    every kernel of lightgbm_tpu_torch/csrc compiled by nvcc
  xla_exp  the binary objective's exp (objectives.xla_exp) on the card
           against the CPU on 4,000,001 points of [-89, 89]: bit-equal
  kernels  each kernel against its plain PyTorch version on the card, at the
           main path's shapes (1,048,576 rows, 28 features, 256 bins,
           255-leaf trees), with its median time, the plain version's time,
           the least time the card could take (bound) and, where one
           PyTorch call computes the same function, that call's time: the
           f32 and int8 segment histograms (the root and K=2 windows, then
           the cases and edge cases of lightgbm_tpu_torch/bench_seg_hist.py
           on synthetic rows: counts exact, int8 bit-equal, f32 within
           _bench.f32_tol and the same bits on two calls), the partition, the
           fused grow step (int8 and f32; the root window, K=2 adjacent
           unaligned windows and K=4 disjoint unaligned windows, one of them
           empty, then the edge cases of
           lightgbm_tpu_torch/bench_grow_step.py on synthetic rows; f32 the
           same bits on two calls; its
           library yardstick the composite of sort, gathers, copies back and
           index_add_ of the child, the pair of the partition and seg_hist
           beside it), the split scan and its candidate call (one launch
           and one copy to the host; the packed candidates bit-equal to
           candidates_plain of the kernel's own rows under both tie rules,
           lightgbm_tpu_torch/bench_split_scan.py's checks), the batched
           partition on the same K=4 windows and the batched split scan on
           their 8 children (and their candidates in one call); the
           partition (its library yardstick: a stable sort of the go-left
           keys, the gathers of every column and the copies back, the sort
           alone beside it) also on the cases and edge cases of
           lightgbm_tpu_torch/bench_partition.py, through the wrappers;
           the u16 modes (bins past a byte, two byte planes a feature, a
           padded width of 1,024: the run_u16 cases of bench_seg_hist,
           bench_partition and bench_grow_step on synthetic rows, each
           timed beside the u8 mode on the same windows, the index_add_ /
           composite yardsticks and the bound; the segment histogram also
           at F = 121 (242 byte planes) and at 8,192 bins; the edge cases:
           thresholds at bins 255 and 256, a NaN bin past 255 sent left, an
           empty window among K, windows under 32 rows, table members on a
           u16 layout, rows of at most 700 bins at 1,024; order and nl
           bit-equal, int8 exact, f32 the same bits on two calls); the u16
           mode of the ordered histograms (f32 and int8: the run_u16 cases
           of lightgbm_tpu_torch/bench_ordered.py on synthetic u16 bins,
           1,048,576 x 700 at 1,024 bins on the root, K=2, 14,000 rows,
           K=4 x 14,000 and 4,000 rows, each beside the u8 mode on the same
           windows, the index_add_ yardstick and the bound, the roots of
           1,048,576 x 28 at 8,192 and 16,384 bins, then the edge cases: a
           feature narrower than the widest, bins 255 / 256, a NaN bin past
           255, an empty window among K, windows under 32 rows, rows of at
           most 700 bins; int8 bit-equal, f32 within ordered_tol and the
           same bits on two calls)
  main     train() of the Higgs-shaped binary model (1,048,576 x 28,
           255 leaves, max_bin 255, learning rate 0.1) with the default
           path parameters (fused grow step, int8 accumulation with the
           near-tie f32 refine) for 10 rounds on the card, then predict()
           on the same rows; launch counts of its kernels (each must be
           > 0), near-tie refines per tree, and the training log-loss per
           round (it must fall); one warm predict's last_predict_stats
           (host wall time a phase: bin_ms, transfer_ms, walk_ms, host_ms)
           beside its device time by operation (the walk kernel, then all);
           the rest of prediction on the same model and rows, timed:
           pred_leaf in 4,096-row chunks against the plain walker's leaves
           of every row, the walk path in 262,144-row chunks at
           pred_num_buffers 1 and 2 against one chunk, the streaming value
           path at 4,096 against 1<<20 rows a chunk (bit for bit) and early
           stopping (freq 2, margin 1.0) against the host's sum of the same
           per-tree block on the first 262,144 rows, pred_contrib of 32 rows against the block's sum
           (the SHAP identity, 1e-6), rows/s of each and their
           last_predict_stats; the walk kernel's scores bit-equal to the
           plain walker's, every row in the same leaf of every tree, then
           the same at 500 trees (the 10 trees' records repeated 50 times,
           the Higgs run's forest size), timed; one more iteration under
           torch.profiler
           (with the tree's fused steps, and its segment histograms of the
           near-tie refine, against their bounds and the rows of their
           windows)
  multiclass  softmax and one-vs-all at 5 classes (the class count of
           the reference's examples/multiclass_classification) on the main
           phase's rows and bins (nothing binned again) with a label made
           from MULTI_SEED: 5 rounds of multiclass (25 trees), 3 of
           multiclassova; multi_logloss per round (it must fall), the
           fused step, int8 histogram, split scan and the walk's class mode
           (forest_walk_multi) launched, predict [N, 5] raw and converted
           against the training score (1e-5 relative); the class mode on
           the 25 trees bit-equal to the plain walker at k = 5 and at
           k = 10 (two class blocks of the grid), every row in the same
           leaf, timed beside the same trees at k = 1; multiclass-parity:
           65,536 rows, 3 rounds, card vs CPU with int8 on both (>= 0.95
           of splits identical, multi_logloss within 1e-4 relative)
  objectives  3 rounds each of regression_l1 (leaf renewal on the host),
           quantile (alpha 0.7) and tweedie (1.3, count labels) on the same
           rows and bins with labels made from MULTI_SEED: the training loss
           (each one's metric) must fall, the host ms of each leaf renewal;
           then each XLA form of objectives.py (log, log1p, sigmoid,
           softmax, the subnormal flush) on the card against the CPU on
           xla_exp's sweep, and every objective's gradients and hessians,
           weighted and not, on OBJ_CHECK_ROWS scores: bit-equal
  batch    bench.py's headline parameters (min_data_in_leaf 100,
           leaf_batch 4: frontier-batched growth, up to 4 splits per grow
           step) for 5 rounds on the same rows: log-loss per round (it
           must fall), grow steps, commit rate and effective K per tree,
           kernel launches; the same rows and parameters at leaf_batch 1
           for the same rounds, whose splits must be >= 0.95 identical and
           whose log-loss must agree within 1e-4 relative; one more
           iteration under torch.profiler
  off      the two-launch path (grow_fused='off', hist_acc='bf16') for 3
           rounds on the same rows: partition and f32 histogram launches,
           its log-loss against the default path's after 3 rounds, and
           one more iteration under torch.profiler (with the rows of its
           partition windows, median, mean, largest, and its segment
           histograms against their bound)
  batch-off  the batch phase's parameters on the two-launch path for 3
           rounds: the batched partition, K-window f32 histograms and the
           batched split scan must launch
  parity   the default parameters for 2 rounds at 65,536 rows on the card
           and on the CPU with the int8 accumulation on there
           (grower.INT8_ON_CPU): share of identical splits, log-loss
  io       the train API, evaluation and model text on the card: the
           Higgs-shaped rows with seeded weights (uniform in [0.5, 1.5)) and
           a 262,144-row validation set binned with reference= the training
           set, 10 rounds of train() with metric binary_logloss and auc,
           record_evaluation and early_stopping(5), the training set
           evaluated too; the training log-loss must fall every round, the
           forest walk must run once a tree on the validation set (its
           score = predict_raw_bins of its bins within 1e-6 relative, the
           bias folded into the first tree adding in another order there),
           the recorded validation log-loss must equal the f64 host
           log-loss of predict() within 1e-5 relative; save_model, then the
           file loaded into Booster(model_file=) on the card: its
           real-space predict of the 1,048,576 rows within rtol 1e-6, atol
           1e-6 of the trained booster's bin-space predict, every row in
           the same leaf of every tree, its model_to_string byte-equal to
           the file; the reference LightGBM's tests/golden/
           scen_weighted.model.txt predicts scen_weighted.train.csv within
           rtol 1e-4, atol 1e-5 of its preds.txt.  Printed: the eval time a
           round against the round's wall time, save, load and predict
           times, real-space and bin-space rows/s
  efb      Exclusive Feature Bundling at the Expo / Flight Delay shape
           (binary, 700 one-hot columns; rows cut from 11,000,000 to
           1,048,576): 8 categorical variables of EFB_LEVELS levels, Zipf
           s = 1.1, made as f64 (the block structure is this script's: the
           dataset's own variables are not in the repo); the planes, the
           bundle search and construct seconds; the partition and the fused
           step (int8, f32) in table mode against their plain versions at
           the root (the root's own bundle-plane split) and on K=4 windows,
           timed beside the threshold mode at the same bins and that
           threshold's own table (the same rows left), then
           bench_partition's table-mode edge cases (order and nl bit-equal,
           int8 exact, f32 the same bits on two calls); 3 rounds with no
           path parameters and 3 at bench.py's parameters (K=4):
           iterations/s, log-loss falling, launches (the fused step must
           launch in table mode, the split-scan kernel never: best_split
           decides every leaf), one iteration each under the profiler
           (launches per split, best_split calls); predict of the rows
           against the training score (1e-5 relative, and its log-loss
           against training's); the model text read back: its real-space predict may differ from the bundled predict
           only on rows with two nonzero members in one plane (counted);
           2 rounds each of the two-launch path at K=1 and K=4 (the
           partition in table mode); card vs CPU at 65,536 rows, int8 on
           both; the first 262,144 of the rows with enable_bundle=False
           (the ordered layout) for its rate
  cat      categorical features end to end: the efb phase's draws kept as
           8 integer-coded columns named by categorical_feature (the same
           information, categorical instead of one-hot): 3 rounds with no
           path parameters and 3 at bench.py's parameters (K=4):
           iterations/s beside efb's, log-loss per round beside efb's (must
           fall), categorical splits in every tree, launches (the fused step
           in table mode, the split-scan kernel never, the walk kernel's
           categorical mode at predict); predict against the training score
           on the rows whose categories were all kept (1e-5 relative; a
           category past the 99% cut is bin 0 in training and right at
           predict), the model text read back on the card (within 1e-6);
           the walk kernel on this forest bit-equal to the plain walker,
           timed beside the same trees with every node numeric; one
           iteration under the profiler
  cat-wide the same rows at max_bin 1023 (the 300-level columns keep more
           than 255 categories): the partition and the fused step (int8,
           f32) with tables past 256 bins against their plain versions at
           the root and on K=4 windows (one empty), timed beside the same
           windows by 256-bin tables; 2 rounds at K=1, 2 at K=4, 2 each of
           the two-launch path at K=1 and K=4 (the *_wtable launches must
           be > 0), predict (the plain walker) against the training score,
           the model text read back; cat-parity: 65,536 rows, 2 rounds,
           card vs CPU with int8 on both (>= 0.95 of splits identical,
           log-loss within 1e-4)
  widebin  the Higgs shape at max_bin 1023 (padded 1,024: the u16 modes;
           rows cut from 11,000,000 to 1,048,576, rounds to 3): 3 rounds
           with no path parameters (iterations/s, log-loss falling, the
           u16 fused step, int8 root and f32 refine histograms launched,
           no split-scan kernel: best_split decides every leaf), one
           iteration under the profiler (CUDA launches a split, best_split
           calls a tree, beside the main phase's), predict through the plain
           walker against the training score (1e-5 relative), the model
           text read back (its real-space predict within rtol 1e-6);
           widebin-batch: bench.py's _PARAMS at max_bin 1023 for 3 rounds;
           widebin-off: the two-launch path (grow_fused='off',
           hist_acc='bf16') 2 rounds each at K=1 and K=4 (the u16
           partition, batched partition and f32 histogram launched);
           widebin-parity: 65,536 rows, 2 rounds, card vs CPU (int8 on
           both): >= 0.95 of splits identical, log-loss within 1e-4
  wide data  an Expo-shaped table (binary, 1,048,576 x 700 numeric
           features, 2% NaN, values on a grid of 1/32), binned (and the
           seconds of the bundle search); the ordered histograms (f32 and
           int8) against their plain versions on the cases of
           lightgbm_tpu_torch/bench_ordered.py (the root with no index, K=2
           windows of a shuffled index, windows of 14,000 and 4,000 rows,
           the root with 64 skewed features; f32 the same bits on two
           calls), with their times; the split scan and its candidate call
           (case-major) at F = 700
  wide     train() with no path parameters: the layout rule must pick
           hist_mode='ordered'; 5 rounds (log-loss must fall), launches
           (ordered_hist and split_scan, no seg kernel), predict through
           the plain walker (700 features > the walk kernel's 512) against
           the training score (1e-5 relative), one warm predict's
           last_predict_stats, the walker alone on the rows' bins; one
           iteration under the
           profiler, with the tree's ordered_hist time against its bound
           (each launch's rows * (F + 16) + K * F * B * 12 bytes)
  wide-batch  bench.py's batch parameters (leaf_batch 4) for 3 rounds:
           K-window ordered_hist launches, the batched split scan
  wide-quant  quantized training on the int8 kernel (use_quantized_grad,
           stochastic_rounding=False, hist_method='pallas_int8') for 3
           rounds: ordered_hist_int8 only
  wide-parity  32,768 of the wide rows for 1 round, card vs CPU, f32 and
           quantized: share of identical splits, log-loss
  wide-u16 the Expo shape at max_bin 1023 (262,144 x 700 normals on a
           grid of 1/1024, 2% NaN, padded to 1,024 bins): with no path parameters
           the rule must pick hist_mode='ordered' (its warning printed);
           3 rounds in f32 (ordered_hist_u16 launched, no seg kernel),
           predict of the rows through the plain walker against the
           training score (1e-5 relative); wide-u16-quant: 3 quantized
           rounds on the same rows (ordered_hist_int8_u16, not
           ordered_hist_u16); wide-u16-parity: the first 8,192 rows, card
           vs CPU for 1 round, quantized (>= 0.95 of splits identical,
           log-loss within 1e-4) and f32 (the trees may part only at a
           near tie: the first differing split's two gains within 1e-5
           relative; log-loss within 2e-4; its share printed)
The phases run in the order main, batch, off, batch-off, sampling, parity,
multiclass, objectives, sampling-wide, io, efb, cat, widebin, wide,
wide-u16; each prints its seconds ("phase ...: s").
The last lines: the kernels JSON (launches summed over the main, batch,
off, batch-off, multiclass, multiclassova, regression_l1, quantile,
tweedie, io, efb, efb-batch, efb-off, efb-batch-off, efb-flat, cat,
cat-batch, cat-wide, cat-wide-batch, cat-wide-off, cat-wide-batch-off,
widebin, widebin-batch, widebin-off, widebin-batch-off, wide, wide-batch,
wide-quant, wide-u16 and wide-u16-quant runs; the table, wide-table and
u16 modes of the partition, the fused step, the segment histogram and the
ordered histograms, and the walk's categorical and class modes, are
entries of their own), the card, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROWS = 1 << 20
FEATURES = 28
ROUNDS = 10
OFF_ROUNDS = 3
PARITY_ROWS = 1 << 16
# card vs CPU rounds of the parity, efb-, cat- and widebin-parity checks (3
# until the multiclass and objectives phases joined the script; the
# sampling-parity check keeps 3: its GOSS runs sample from the third round)
PARITY_ROUNDS = 2
SAMPLING_PARITY_ROUNDS = 3
PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255, "learning_rate": 0.1}
IO_VALID_ROWS = 1 << 18
IO_ROUNDS = 10
IO_PARAMS = {**PARAMS, "metric": ["binary_logloss", "auc"], "verbosity": -1}
GOLDEN = pathlib.Path(__file__).resolve().parent / "tests" / "golden"
# the two-launch path: a partition and a histogram launch per split, f32 sums
OFF_PARAMS = {**PARAMS, "grow_fused": "off", "hist_acc": "bf16", "fused_split_scan": True}
# bench.py's _PARAMS (less its logging keys): frontier batching, K = 4
BATCH_PARAMS = {**PARAMS, "min_data_in_leaf": 100, "leaf_batch": 4}
BATCH_ROUNDS = 5  # 10 until the multiclass and objectives phases joined the script
BATCH_OFF_PARAMS = {**BATCH_PARAMS, "grow_fused": "off", "hist_acc": "bf16",
                    "fused_split_scan": True}
BATCH_OFF_ROUNDS = 3
# the Expo shape of the reference's experiment table (docs/Experiments.rst):
# binary, 700 features; rows cut from 11,000,000 for the run's time limit
WIDE_ROWS = 1 << 20
WIDE_FEATURES = 700
WIDE_ROUNDS = 5
WIDE_BATCH_ROUNDS = 3
WIDE_QUANT_ROUNDS = 3
# card vs CPU on the first rows of the wide table: its CPU side (f32 and
# quantized, 700 features) takes ~1.6 s a thousand rows, so it is cut to
# these rows for the time limit
WIDE_PARITY_ROWS = 1 << 15
# rows of the streaming value path's and early stopping's card checks (the
# engine bins every row on the host, ~0.3 M rows/s)
STREAM_CHECK_ROWS = 1 << 18
# the two 700-column card-vs-CPU checks (wide-parity, wide-u16-parity): 1
# round (3 until the prediction checks joined the script, 2 until the
# multiclass and objectives phases did; their CPU side took 40-45 s a mode
# at 3)
WIDE_PARITY_ROUNDS = 1
QUANT_PARAMS = {**PARAMS, "use_quantized_grad": True, "stochastic_rounding": False,
                "num_grad_quant_bins": 4, "hist_method": "pallas_int8"}
# the efb phase: the Expo / Flight Delay shape of the reference's experiment
# table (binary, 11,000,000 x 700, one-hot coded), rows cut for the time
# limit, widths not; that dataset's own variables are not in the repo, so
# the block structure is this script's: 8 categorical variables of these
# levels (700 columns), level frequencies Zipf-like (s = 1.1)
EFB_ROWS = 1 << 20
EFB_LEVELS = (12, 31, 7, 24, 20, 300, 300, 6)
EFB_ZIPF = 1.1
EFB_ROUNDS = 3  # 10 until the cat phases joined the script, 5 until PR 20's phases
EFB_OFF_ROUNDS = 2
EFB_FLAT_ROUNDS = 3
# the unbundled run's rows when the phase has taken more than its budget
EFB_FLAT_CUT_ROWS = 1 << 18
EFB_BUDGET_S = 240.0
# the cat phases (categorical features end to end): the efb phase's rows
# and variables, the codes kept as 8 integer columns named by
# categorical_feature (one-hot coded in efb: the comparison of the
# reference's docs/Features.rst, "Optimal Split for Categorical Features");
# cat-wide at max_bin 1023, where the two 300-level columns keep more than
# 255 categories (tables past 256 bins)
CAT_ROUNDS = 3  # 10 until the prediction checks joined the script, 5 until PR 20's
CAT_BATCH_ROUNDS = 3  # 5 until the multiclass and objectives phases joined the script
CAT_WIDE_PARAMS = {**PARAMS, "max_bin": 1023}
CAT_WIDE_ROUNDS = 2  # 3 until the multiclass and objectives phases joined the script
CAT_WIDE_BATCH_ROUNDS = 2
CAT_WIDE_OFF_ROUNDS = 2
# the efb phase's rates and losses, for the cat phases' lines
EFB_RESULTS = {}
# the widebin phase: the Higgs shape at max_bin 1023 (LightGBM's tuning
# guide, docs/Parameters-Tuning.rst, "For Better Accuracy": "use large
# max_bin"), padded to 1,024 bins: the u16 modes of rows 1, 2, 5, 6; rows cut
# from 11,000,000 and rounds for the time limit, widths not
WIDEBIN_PARAMS = {**PARAMS, "max_bin": 1023}
WIDEBIN_BINS = 1024
WIDEBIN_ROUNDS = 3  # 10 until the cat phases joined the script, 5 until PR 20's
WIDEBIN_BATCH_ROUNDS = 3  # 5 until the multiclass and objectives phases joined the script
WIDEBIN_OFF_ROUNDS = 2

# the wide-u16 phase: the Expo shape (binary, 700 columns) at max_bin 1023,
# the ordered layout's u16 mode (the rule takes 'ordered' past 121 columns
# at 1,024 bins); normals on a grid of 1/1024 with 2% NaN, so that every
# column fills its ~1,023 bins (the wide table's 1/32 grid gives ~300 bins a
# column; continuous values, 200,000 distinct a column in the binning
# sample, took 78-97 s of bin search); rows cut from 11,000,000 to 262,144
# for the time limit (the phase takes ~150-200 s), widths not
WIDE_U16_ROWS = 1 << 18
WIDE_U16_GRID = 1024
WIDE_U16_PARAMS = {**PARAMS, "max_bin": 1023}
WIDE_U16_ROUNDS = 3
WIDE_U16_PARITY_ROWS = 8192
# f32 card vs CPU: the card adds a window's rows in chunks, so its sums
# differ from the CPU's row order in the last bits, and at 700 x 1,023
# thresholds on 8,192 rows the trees part at a near tie in the first tree
# (0.836-0.850 of splits identical); the log-loss after 3 rounds was then
# 5.8e-5 and 1.06e-4 apart (relative, two runs), hence this limit; the
# quantized runs (exact sums) keep 0.95 of splits and 1e-4
WIDE_U16_F32_LOSS_TOL = 2e-4

# the multiclass phase: the main phase's Higgs rows and bins with a 5-class
# label (the class count of the reference's examples/multiclass_classification),
# 5 rounds of softmax (25 trees), 3 of one-vs-all; the walk's class mode also
# at 10 classes on the same records
MULTI_SEED = 5
MULTI_CLASSES = 5
MULTI_ROUNDS = 5
MULTI_OVA_ROUNDS = 3
MULTI_WALK_WIDE_K = 10
MULTI_PARITY_ROUNDS = 3
# the objectives phase: 3 rounds each of regression_l1, quantile, tweedie on
# the same rows and bins; its card-vs-CPU gradient check covers every
# ported objective with these parameters (the scen_obj_* goldens' own)
OBJ_ROUNDS = 3
# scores of the card-vs-CPU gradient check of every objective (its CPU
# side, the fused multiply-adds emulated in f64, bounds the count)
OBJ_CHECK_ROWS = 1 << 18
OBJECTIVE_CASES = {
    "regression": {}, "regression_l1": {}, "huber": {"alpha": 0.9}, "fair": {"fair_c": 1.5},
    "poisson": {}, "quantile": {"alpha": 0.7}, "mape": {}, "gamma": {},
    "tweedie": {"tweedie_variance_power": 1.3}, "binary": {}, "cross_entropy": {},
    "cross_entropy_lambda": {}, "multiclass": {"num_class": 5},
    "multiclassova": {"num_class": 5},
}

# H100 SXM published peaks: HBM bytes/s and
# f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# idle time (s) at the end of a kernel entry's retaken device trace
RETAKE_IDLE_S = 3.0

SOURCES = {
    "seg_hist": ("lightgbm_tpu_torch/csrc/seg_hist.cu", "lightgbm_tpu/ops/pallas/seg.py:587"),
    "seg_hist_int8": ("lightgbm_tpu_torch/csrc/seg_hist.cu", "lightgbm_tpu/ops/pallas/seg.py:587"),
    "fused_grow_step": ("lightgbm_tpu_torch/csrc/grow_step.cu",
                        "lightgbm_tpu/ops/pallas/grow_step.py:260"),
    "partition": ("lightgbm_tpu_torch/csrc/partition.cu", "lightgbm_tpu/ops/pallas/partition.py:446"),
    "partition_batch": ("lightgbm_tpu_torch/csrc/partition.cu",
                        "lightgbm_tpu/ops/pallas/partition.py:525"),
    "split_scan": ("lightgbm_tpu_torch/csrc/split_scan.cu", "lightgbm_tpu/ops/pallas/split_scan.py:218"),
    "split_scan_batch": ("lightgbm_tpu_torch/csrc/split_scan.cu",
                         "lightgbm_tpu/ops/pallas/split_scan.py:218"),
    "split_candidates": ("lightgbm_tpu_torch/csrc/split_scan.cu",
                         "lightgbm_tpu/ops/pallas/split_scan.py:218"),
    "forest_walk": ("lightgbm_tpu_torch/csrc/forest_walk.cu", "lightgbm_tpu/ops/pallas/forest_walk.py:418"),
    "ordered_hist": ("lightgbm_tpu_torch/csrc/ordered_hist.cu",
                     "lightgbm_tpu/ops/pallas/histogram.py:140"),
    "ordered_hist_int8": ("lightgbm_tpu_torch/csrc/ordered_hist.cu",
                          "lightgbm_tpu/ops/pallas/histogram_int8.py:43"),
    # the table mode (cat_ref) of rows 2, 5 and 6: EFB bundle-plane splits
    "partition_table": ("lightgbm_tpu_torch/csrc/partition.cu",
                        "lightgbm_tpu/ops/pallas/partition.py:446"),
    "partition_batch_table": ("lightgbm_tpu_torch/csrc/partition.cu",
                              "lightgbm_tpu/ops/pallas/partition.py:525"),
    "fused_grow_step_table": ("lightgbm_tpu_torch/csrc/grow_step.cu",
                              "lightgbm_tpu/ops/pallas/grow_step.py:260"),
    # the u16 mode (wide, max_bin > 256) of rows 1, 2, 5 and 6
    "seg_hist_u16": ("lightgbm_tpu_torch/csrc/seg_hist.cu", "lightgbm_tpu/ops/pallas/seg.py:587"),
    "seg_hist_int8_u16": ("lightgbm_tpu_torch/csrc/seg_hist.cu",
                          "lightgbm_tpu/ops/pallas/seg.py:587"),
    "partition_u16": ("lightgbm_tpu_torch/csrc/partition.cu",
                      "lightgbm_tpu/ops/pallas/partition.py:446"),
    "partition_batch_u16": ("lightgbm_tpu_torch/csrc/partition.cu",
                            "lightgbm_tpu/ops/pallas/partition.py:525"),
    "fused_grow_step_u16": ("lightgbm_tpu_torch/csrc/grow_step.cu",
                            "lightgbm_tpu/ops/pallas/grow_step.py:260"),
    # the u16 mode (max_bin > 256) of rows 7 and 8: the ordered layout
    "ordered_hist_u16": ("lightgbm_tpu_torch/csrc/ordered_hist.cu",
                         "lightgbm_tpu/ops/pallas/histogram.py:140"),
    "ordered_hist_int8_u16": ("lightgbm_tpu_torch/csrc/ordered_hist.cu",
                              "lightgbm_tpu/ops/pallas/histogram_int8.py:43"),
    # the live mode (dead features skipped) of rows 1 and 6: feature_fraction
    "seg_hist_live": ("lightgbm_tpu_torch/csrc/seg_hist.cu", "lightgbm_tpu/ops/pallas/seg.py:587"),
    "seg_hist_int8_live": ("lightgbm_tpu_torch/csrc/seg_hist.cu",
                           "lightgbm_tpu/ops/pallas/seg.py:587"),
    "fused_grow_step_live": ("lightgbm_tpu_torch/csrc/grow_step.cu",
                             "lightgbm_tpu/ops/pallas/grow_step.py:260"),
    # the walk's categorical nodes (cat_gl) of row 4
    "forest_walk_cat": ("lightgbm_tpu_torch/csrc/forest_walk.cu",
                        "lightgbm_tpu/ops/pallas/forest_walk.py:418"),
    # the walk's class mode (k > 1 trees an iteration, kpad) of row 4
    "forest_walk_multi": ("lightgbm_tpu_torch/csrc/forest_walk.cu",
                          "lightgbm_tpu/ops/pallas/forest_walk.py:418"),
    # goes-left tables past 256 bins (cat_ref [K, bmt]) of rows 2, 5 and 6
    "partition_wtable": ("lightgbm_tpu_torch/csrc/partition.cu",
                         "lightgbm_tpu/ops/pallas/partition.py:446"),
    "partition_batch_wtable": ("lightgbm_tpu_torch/csrc/partition.cu",
                               "lightgbm_tpu/ops/pallas/partition.py:525"),
    "fused_grow_step_wtable": ("lightgbm_tpu_torch/csrc/grow_step.cu",
                               "lightgbm_tpu/ops/pallas/grow_step.py:260"),
}
# CUDA launches per split of the profiled iterations with the rows-only scan
# and its candidates in PyTorch operators on the host side (PERF.md section 5)
EARLIER_LAUNCHES_PER_SPLIT = {"profile": 100.6, "batch profile": 20.7, "off profile": 43.2,
                              "wide profile": 68.1}
# kernels that only the seg layout launches
SEG_KERNELS = ("seg_hist", "seg_hist_int8", "fused_grow_step", "partition", "partition_batch")
TABLE_KERNELS = ("fused_grow_step_table", "partition_table", "partition_batch_table")
U16_KERNELS = ("seg_hist_u16", "seg_hist_int8_u16", "partition_u16", "partition_batch_u16",
               "fused_grow_step_u16")


def make_data(n_rows: int, n_features: int, seed: int = 42):
    """The repo's Higgs-shaped synthetic task (the formula of bench.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    w = rng.normal(size=n_features)
    logits = x @ w * 0.5 + rng.normal(scale=1.0, size=n_rows)
    return x, (logits > 0).astype(np.float64)


def make_wide_data(n_rows: int, n_features: int, seed: int = 42, grid: int = 32):
    """The Expo-shaped table: standard normal values on a grid of 1/grid
    (at 32, ~300 distinct values a column, so each fills ~255 bins; at 1024,
    ~8,000, so each fills ~1,023), 2% NaN; the label a fixed
    linear-plus-quadratic function of the first 32 columns plus noise."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, n_features), dtype=np.float32)
    x *= float(grid)
    np.round(x, out=x)
    x /= float(grid)
    for lo in range(0, n_rows, 1 << 16):  # the NaN draw in row blocks
        blk = x[lo:lo + (1 << 16)]
        blk[rng.random(blk.shape, dtype=np.float32) < 0.02] = np.nan
    k = np.nan_to_num(x[:, :32]).astype(np.float64)
    w = rng.normal(size=32)
    z = k @ w * 0.5 + 0.25 * (k[:, :8] ** 2 - 1.0).sum(axis=1) + rng.normal(size=n_rows)
    return x, (z > 0).astype(np.float64)


def time_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float = 0.0):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_entry(name, max_abs_err, ms, plain_ms, bound, library_ms):
    src, replaces = SOURCES[name]
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": None, "max_abs_err": float(max_abs_err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": library_ms,
    }


def with_device(entry, fn):
    """The kernel entry with the device time of one call of ``fn`` alone
    (``_bench.device_profile``: the card's kernel times under
    torch.profiler, no host time between them) and its device operations;
    the event time ``ms`` is the host's and the card's together.  A trace
    that lost device operations is taken again with RETAKE_IDLE_S of idle
    time at the end of its window; if that one lost some too, both read
    NaN (null in the kernels line: not measured)."""
    from lightgbm_tpu_torch._bench import device_profile

    entry["device_ms"], entry["launches_per_call"] = device_profile(fn, idle=RETAKE_IDLE_S)
    print(f"kernel {entry['name']}: {entry['ms']:.4f} ms event time, {entry['device_ms']:.4f} ms "
          f"device time in {entry['launches_per_call']:.0f} device operations a call")
    return entry


def nan_to_null(v):
    """``v`` (a kernel entry, a list or a number) with every NaN (a device
    time that was not measured) as None, so the line is strict JSON."""
    if isinstance(v, float) and math.isnan(v):
        return None
    if isinstance(v, dict):
        return {k: nan_to_null(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [nan_to_null(x) for x in v]
    return v


def check_seg_kernels(ds, dev):
    """Histograms, partition, split scan and the fused grow step at the root
    of the first tree."""
    from lightgbm_tpu_torch import bench_seg_hist as bs
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.ops import seg, split, split_scan
    from lightgbm_tpu_torch.quantize import hist_acc_scales

    n, f = ds.bins.shape
    b = ds.max_bin_padded
    obj = create_objective("binary", ds.label, dev)
    score = torch.full((n,), obj.boost_from_score(), dtype=torch.float32, device=dev)
    grad, hess = obj.get_gradients(score)
    bins_fn = torch.as_tensor(np.ascontiguousarray(ds.bins.T), device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    rows = seg.pack_rows(bins_fn, grad, hess, ones)
    scales = hist_acc_scales(grad, hess, ones)
    out = []

    # -- kernel 1: the histograms of the root and of K=2 adjacent windows
    # that start off any tile boundary, f32 and int8, through the wrapper
    # (bench_seg_hist.run_case: counts exact, int8 bit-equal to the plain
    # version, f32 g/h within f32_tol and the same on two calls; the time,
    # the device time alone, the plain version's, index_add_ beside it)
    wrapper = {"wrapper": bs.this_launcher()}
    k2 = [(37, n // 3 + 1), (37 + n // 3 + 1, n // 2)]
    seg_res = {}
    for mode, qs in (("f32", None), ("int8", scales)):
        for where, wins in (("root", [(0, n)]), ("K=2", k2)):
            r = bs.run_case(f"Higgs {where} {mode}", rows, wins, b, qs, wrapper, reps=20,
                            plain_reps=5)
            seg_res[mode, where] = r
            print(f"kernel seg_hist {mode} {where} {wins} x {f} features: {r['wrapper']:.4f} ms "
                  f"(device {r['wrapper device']:.4f} ms, {r['wrapper ops']:.0f} device "
                  f"operations), bound {r['bound']:.5f} ms, plain {r['plain']:.4f} ms, library "
                  f"index_add_ {r['library']:.4f} ms (device {r['library device']:.4f}); counts "
                  + ("exact, bit-equal to the plain version" if qs is not None else
                     "exact, g/h within f32_tol, the same bits on two calls"))
    hk = seg.seg_hist(rows, 0, n, b)
    hp = seg.seg_hist_plain(rows, 0, n, b)
    err = (hk[..., :2] - hp[..., :2]).abs()
    r64 = seg.SegRows(rows.bins, rows.g.double(), rows.h.double(), rows.m.double(), rows.ridx)
    h64 = _hist_f64(r64, n, b)
    h8k = seg.seg_hist(rows, 0, n, b, scales)
    print(f"kernel seg_hist: max |err| vs f64 sums: kernel "
          f"{float((hk[..., :2] - h64).abs().max()):.3g}, plain "
          f"{float((hp[..., :2] - h64).abs().max()):.3g}; the int8 grid is "
          f"{float((h8k[..., :2] - h64).abs().max()):.3g} from them at most "
          f"(scales {scales.tolist()})")
    del hk, h8k, h64, r64
    for name, mode, max_err, lib in (
            ("seg_hist", "f32", float(err.max()), "index_add_ of the rows' (g*m, h*m, m) into a "
             "[K, F, B] table"),
            ("seg_hist_int8", "int8", 0.0, "index_add_ of the rows' i32 digits and count into "
             "a [K, F, B] table")):
        r, r2 = seg_res[mode, "root"], seg_res[mode, "K=2"]
        entry = kernel_entry(name, max_err, r["wrapper"], r["plain"],
                             bound_ms(n * (f + 12) + f * b * 12), r["library"])
        entry.update(device_ms=r["wrapper device"], launches_per_call=r["wrapper ops"],
                     library_call=lib, k2_ms=r2["wrapper"], k2_device_ms=r2["wrapper device"],
                     k2_library_ms=r2["library"])
        out.append(entry)
    check_seg_hist_cases(dev)

    # -- kernel 3: split scan of the root histogram
    kw = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
    nb_t = torch.as_tensor(ds.num_bins(), device=dev)
    nan_t = torch.as_tensor(ds.nan_bins(), device=dev)
    mask = torch.ones(f, dtype=torch.bool, device=dev)
    tot = hp[0].sum(0)
    rk = split_scan.split_scan(hp, tot, nb_t, nan_t, mask, **kw)
    rp = split_scan.split_scan_plain(hp, tot, nb_t, nan_t, mask, **kw)
    if not torch.equal(rk[:, 1:3], rp[:, 1:3]):
        raise AssertionError("split_scan: bin or direction differs from the plain version")
    gerr = (rk[:, [0, 3, 4, 5]] - rp[:, [0, 3, 4, 5]]).abs()
    if bool((gerr > 1e-6 * rp[:, [0, 3, 4, 5]].abs() + 1e-6).any()):
        raise AssertionError(f"split_scan: rows off by {float(gerr.max())}")
    tg, th, tc = tot.tolist()
    ck = split_scan.fused_best_split(hp, tg, th, tc, nb_t, nan_t, mask, min_gain_to_split=0.0, **kw)
    cp = split.best_split(hp, tg, th, tc, nb_t, nan_t, mask, min_gain_to_split=0.0, **kw)
    if (ck.feature, ck.bin) != (cp.feature, cp.bin):
        raise AssertionError(f"split_scan: best split {ck} vs best_split {cp}")
    out.append(with_device(kernel_entry(
        "split_scan", gerr.max(),
        time_ms(lambda: split_scan.split_scan(hp, tot, nb_t, nan_t, mask, **kw)),
        time_ms(lambda: split_scan.split_scan_plain(hp, tot, nb_t, nan_t, mask, **kw), reps=5),
        # ~20 f32 operations per (bin, direction): 3 prefix adds, 3
        # subtractions, 4 compares, two leaf gains and their sum
        bound_ms(f * b * 12 + f * 8 * 4 + f * 12, ops=f * b * 2 * 20), None,
    ), lambda: split_scan.split_scan(hp, tot, nb_t, nan_t, mask, **kw)))
    print(f"kernel split_scan: bins/directions equal, rows max |err| {float(gerr.max()):.3g}; "
          f"best split feature {ck.feature} bin {ck.bin} as best_split")
    out.append(check_candidates("Higgs root", hp[None], tot[None].cpu().numpy(), nb_t, nan_t))

    # -- kernel 2: stable partition of the root window by the root's split
    nanb = int(ds.nan_bins()[ck.feature])
    mem = seg.split_members([0], [n], [ck.feature], [ck.bin], [int(ck.default_left)], [nanb])
    out.append(partition_entry("partition", seg.pack_rows(bins_fn, grad, hess, ones), mem,
                               "root of the Higgs table", plain_reps=5))

    out.append(check_fused_step(ds, bins_fn, grad, hess, ones, ck, scales))
    out.extend(check_batch_kernels(ds, bins_fn, grad, hess, ones, ck, dev))
    check_partition_cases(dev)
    return out


def check_candidates(where, hist, parents, num_bins, nan_bins, case_major=False):
    """The split scan's candidate call (``fused_best_split_batch``: one
    launch, one copy to the host) on these leaves: the checks of
    ``bench_split_scan.check_case`` (packed candidates bit-equal to
    ``candidates_plain`` of the kernel's own rows under both tie rules,
    feature/bin/direction as the plain version's, members as single calls,
    one launch and one device-to-host copy), then its time from the
    histograms to the candidates on the host, the plain version's, and
    its device time and operations.  Returns its kernel entry."""
    from lightgbm_tpu_torch import bench_split_scan as bss
    from lightgbm_tpu_torch.ops import split_scan

    dev = hist.device
    m, f, b = hist.shape[0], hist.shape[1], hist.shape[2]
    inputs = split_scan.scan_inputs(num_bins, nan_bins, torch.ones(f, device=dev), dev)
    bss.check_case(where, hist, parents, inputs)
    par_t = torch.as_tensor(parents, dtype=torch.float32, device=dev)

    def plain():
        rows = split_scan.split_scan_batch_plain(hist, par_t, *inputs, **bss.KW)
        return split_scan.candidates_plain(rows, par_t, lambda_l1=bss.KW["lambda_l1"],
                                           lambda_l2=bss.KW["lambda_l2"],
                                           min_gain_to_split=bss.MIN_GAIN,
                                           case_major=case_major).tolist()

    def call():
        return bss.this_call(hist, parents, inputs, case_major)

    got = torch.tensor(bss.packed_call(hist, parents, inputs, case_major))
    err = float((got - torch.tensor(plain())).abs().nan_to_num(0.0).max())
    kinds = bss.transfers(call)
    entry = with_device(kernel_entry(
        "split_candidates", err, time_ms(call), time_ms(plain, reps=5),
        bss.bound_ms(m, f, b), None), call)
    entry.update(host_ms=bss.host_ms(call, 20), host_transfers_per_call=kinds["HtoD"] +
                 kinds["DtoH"], shape=[m, f, b])
    print(f"kernel split_candidates {where} ({m} x {f} x {b}, case_major={case_major}): one "
          f"call {entry['ms']:.4f} ms event time, {entry['host_ms']:.4f} ms host time, device "
          f"{entry['device_ms']:.4f} ms in {entry['launches_per_call']:.0f} device operations "
          f"({kinds['kernels']:.0f} kernel, {kinds['HtoD']:.0f} host-to-device and "
          f"{kinds['DtoH']:.0f} device-to-host copies), plain {entry['plain_ms']:.4f} ms, bound "
          f"{entry['bound_ms']:.6f} ms; packed candidates bit-equal to candidates_plain of the "
          f"kernel's rows under both tie rules, max |diff| vs the plain version {err:.3g}")
    return entry


def check_seg_hist_cases(dev):
    """The segment histogram through its wrapper on the cases of
    ``bench_seg_hist`` (synthetic seg rows made on the card: the root, K=2,
    the serial and batched near-tie refines, windows of 16,384 and 4,096
    rows, K=16 x 4,096, the root at F = 242) in both modes with their times,
    and on its edge cases (windows empty but one, under 32 rows, ending at
    row n, a 64-bin table, an int8 window of MAX_INT8_ROWS rows): counts
    exact, int8 bit-equal to the plain version, f32 within f32_tol and the
    same on two calls."""
    from lightgbm_tpu_torch import bench_partition as bp
    from lightgbm_tpu_torch import bench_seg_hist as bs

    wrapper = {"wrapper": bs.this_launcher()}
    for f in (bp.ROOT_FEATURES, bp.WIDE_FEATURES):
        rows, _ = bp.synthetic_rows(ROWS, f, dev)
        scales = bs.int8_scales(rows)
        todo = bs.cases(rows.n) if f == bp.ROOT_FEATURES else {"root": bs.cases(rows.n)["root"]}
        for cname, wins in todo.items():
            for mode, qs in (("f32", None), ("int8", scales)):
                r = bs.run_case(cname, rows, wins, 256, qs, wrapper, reps=20)
                print(f"kernel seg_hist case {cname} {mode} x {f} features "
                      f"({sum(c for _, c in wins)} rows in {len(wins)} window(s)): exact; "
                      f"{r['wrapper']:.4f} ms (device "
                      f"{r['wrapper device']:.4f} ms, {r['wrapper ops']:.0f} device operations), "
                      f"bound {r['bound']:.5f} ms, library index_add_ {r['library']:.4f} ms "
                      f"(device {r['library device']:.4f})")
        if f == bp.ROOT_FEATURES:
            small = bs.few_bins(rows)
            for q in (None, scales):
                for cname, wins in bs.edge_cases(rows.n).items():
                    bs.run_case(cname, rows, wins, 256, q, wrapper, reps=0, timed=False)
                bs.run_case("root at 64 bins", small, [(0, rows.n)], 64, q, wrapper, reps=0,
                            timed=False)
            print(f"kernel seg_hist edge cases {list(bs.edge_cases(rows.n))} and the root at 64 "
                  "bins: exact in both modes")
            del small
        del rows
        torch.cuda.empty_cache()
    wins = bs.check_largest_int8(wrapper, dev)
    print(f"kernel seg_hist edge case int8 window {wins}, every row in one bin at digit 127: "
          "bit-equal to the plain version")


def partition_entry(name, rows, mem, where, plain_reps):
    """The partition kernel through its wrapper on one case
    (``bench_partition.run_case``): nl and every column of the rows equal
    to the plain version's, then its times with the rows restored before
    each call; the library yardstick is the composite (stable sort of the
    go-left keys, gathers of every column, copies back), the sort alone
    beside it."""
    from lightgbm_tpu_torch import bench_partition as bp

    res = bp.run_case(where, rows, mem, {"wrapper": bp.wrapper_launch}, reps=20,
                      plain_reps=plain_reps)
    f, rows_k = rows.f, int(mem[:, 1].sum())
    entry = kernel_entry(name, 0.0, res["wrapper"], res["plain"], bound_ms(2 * rows_k * (f + 16)),
                         res["composite"])
    entry.update(device_ms=res["wrapper device"], launches_per_call=res["wrapper ops"],
                 sort_ms=res["sort"], library_call="stable torch.sort of the go-left keys, "
                 "index_select of the bins and the four columns, copy_ back")
    print(f"kernel {name} ({where}, windows {mem[:, :2].tolist()}): nl and every column equal "
          f"to the plain version; {res['wrapper']:.4f} ms (device {res['wrapper device']:.4f} ms, "
          f"{res['wrapper ops']:.0f} launches), bound {entry['bound_ms']:.5f} ms, sort "
          f"{res['sort']:.4f} ms, composite {res['composite']:.4f} ms (device "
          f"{res['composite device']:.4f}), plain {res['plain']:.4f} ms")
    return entry


def check_partition_cases(dev):
    """The partition wrappers on the cases of ``bench_partition`` (synthetic
    seg rows made on the card: the root, chip_smoke's K=4 layout, windows of
    16,384 and 4,096 rows at unaligned starts, K=16 windows of 4,096 rows,
    the root at F = 242) with their times, and on its edge cases: nl and
    every column of the rows exactly as the plain versions leave them."""
    from lightgbm_tpu_torch import bench_partition as bp

    for f in (bp.ROOT_FEATURES, bp.WIDE_FEATURES):
        rows, nb = bp.synthetic_rows(ROWS, f, dev)
        todo = bp.cases(rows.n, nb)
        if f != bp.ROOT_FEATURES:
            todo = {"root": todo["root"]}
        for cname, mem in todo.items():
            res = bp.run_case(cname, rows, mem, {"wrapper": bp.wrapper_launch}, reps=20)
            print(f"kernel partition case {cname} x {f} features ({int(mem[:, 1].sum())} rows in "
                  f"{len(mem)} window(s)): exact; {res['wrapper']:.4f} ms (device "
                  f"{res['wrapper device']:.4f} ms, {res['wrapper ops']:.0f} launches), bound "
                  f"{res['bound']:.5f} ms, sort {res['sort']:.4f} ms, composite "
                  f"{res['composite']:.4f} ms (device {res['composite device']:.4f})")
        if f == bp.ROOT_FEATURES:
            for cname, mem in bp.edge_cases(rows.n, nb).items():
                bp.run_case(cname, rows, mem, {"wrapper": bp.wrapper_launch}, reps=0,
                            timed=False)
                print(f"kernel partition edge case {cname}: windows {mem[:, :2].tolist()}: exact")
        del rows
        torch.cuda.empty_cache()


def k4_members(ds, ck):
    """K=4 disjoint windows of the root's rows, none starting on a tile
    boundary, the second one empty, split on three features: (starts,
    cnts, feats, tbins, dls, nanbs)."""
    n, f = ds.bins.shape
    nan = ds.nan_bins()
    f2, f3 = (ck.feature + 1) % f, (ck.feature + 2) % f
    feats = [ck.feature, f2, f2, f3]
    return ([37, n // 4 + 5, n // 4 + 5, n // 2 + 1001],
            [n // 4 - 100, 0, n // 4 - 900, n // 2 - 2000],
            feats, [ck.bin, 100, 100, 60], [int(ck.default_left), 0, 1, 0],
            [int(nan[j]) for j in feats])


def check_batch_kernels(ds, bins_fn, grad, hess, ones, ck, dev):
    """The batched partition on the K=4 windows against its plain version
    (K sequential partitions): nl and the row order exactly.  The batched
    split scan on the 8 children of those windows (their f32 histograms)
    against its plain version and against 8 single launches: bit-equal."""
    from lightgbm_tpu_torch.ops import seg, split_scan

    n, f = ds.bins.shape
    b = ds.max_bin_padded
    mem = k4_members(ds, ck)
    marr = seg.split_members(*mem)
    rk = seg.pack_rows(bins_fn, grad, hess, ones)
    out = [partition_entry("partition_batch", rk, marr, "K=4 windows of the Higgs table",
                           plain_reps=3)]
    nlk = seg.sort_partition_batch(rk, *mem)

    nl = nlk.tolist()
    wins = ([(int(s0), l) for s0, l in zip(marr[:, 0], nl)]
            + [(int(s0) + l, int(c) - l) for s0, c, l in zip(marr[:, 0], marr[:, 1], nl)])
    hist8 = seg.seg_hist_batch(rk, wins, b)
    parents = hist8[:, 0].sum(1)  # every row of a child: one bin of feature 0
    del rk
    kw = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=BATCH_PARAMS["min_data_in_leaf"],
              min_sum_hessian_in_leaf=1e-3)
    args = (torch.as_tensor(ds.num_bins(), device=dev), torch.as_tensor(ds.nan_bins(), device=dev),
            torch.ones(f, dtype=torch.bool, device=dev))
    bk = split_scan.split_scan_batch(hist8, parents, *args, **kw)
    bp = split_scan.split_scan_batch_plain(hist8, parents, *args, **kw)
    single = torch.stack([split_scan.split_scan(hist8[i], parents[i], *args, **kw)
                          for i in range(len(wins))])
    torch.cuda.synchronize()
    if not torch.equal(bk, single):
        raise AssertionError("split_scan_batch: a member differs from its single launch")
    if not torch.equal(bk, bp):
        diff = (bk - bp).abs().nan_to_num(0.0).max()
        raise AssertionError(f"split_scan_batch: rows differ from the plain version ({float(diff)})")
    m = len(wins)
    out.append(with_device(kernel_entry(
        "split_scan_batch", 0.0,
        time_ms(lambda: split_scan.split_scan_batch(hist8, parents, *args, **kw)),
        time_ms(lambda: split_scan.split_scan_batch_plain(hist8, parents, *args, **kw), reps=3),
        # histograms and parents in, rows out, the shared per-feature
        # num_bins / nan_bins / mask in once; ~20 f32 operations per (bin,
        # direction) as the single scan
        bound_ms(m * (f * b * 12 + 12 + f * 8 * 4) + f * 12, ops=m * f * b * 2 * 20), None,
    ), lambda: split_scan.split_scan_batch(hist8, parents, *args, **kw)))
    print(f"kernel split_scan_batch: {m} children of the K=4 windows, rows bit-equal to the "
          f"plain version and to {m} single launches")
    from lightgbm_tpu_torch import bench_split_scan

    bench_split_scan.check_case("K=4 children", hist8, parents.cpu().numpy(),
                                split_scan.scan_inputs(args[0], args[1], args[2], dev))
    print(f"kernel split_candidates: the {m} children of the K=4 windows in one call: packed "
          "candidates bit-equal to candidates_plain of the kernel's rows under both tie rules, "
          "each member bit-equal to a call of it alone, one launch and one device-to-host copy")
    return out


def check_fused_step(ds, bins_fn, grad, hess, ones, ck, scales):
    """The fused grow step through its wrapper against its plain version
    (the oracle composition) in both modes, with the rows restored before
    each call (``bench_grow_step.run_case``): at the root window, on K=2
    adjacent windows that start off any tile boundary and on the K=4
    windows of ``k4_members`` (one empty), then on the edge cases of
    ``bench_grow_step`` on synthetic rows made on the card (and the root of
    a 64-bin table, ``few_bins``): dec and every
    column of the rows exactly, the int8 histogram bit-equal, the f32
    one's counts exactly and g/h within ``_bench.f32_tol``.  At the root:
    its time, the plain version's, the pair (partition, then the histogram
    of the elected child) and the composite (sort, gathers, copies back,
    index_add_ of the child), the library yardstick."""
    from lightgbm_tpu_torch import bench_grow_step as bg
    from lightgbm_tpu_torch import bench_partition as bp
    from lightgbm_tpu_torch.ops import grow_step, seg

    n, f = ds.bins.shape
    b = ds.max_bin_padded
    nan = ds.nan_bins()
    f2 = (ck.feature + 1) % f
    members = {
        "root": ([0], [n], [ck.feature], [ck.bin], [int(ck.default_left)],
                 [int(nan[ck.feature])]),
        "K=2": ([1234, 1234 + n // 3], [n // 3, n // 2], [ck.feature, f2],
                [ck.bin, 100], [int(ck.default_left), 1],
                [int(nan[ck.feature]), int(nan[f2])]),
        "K=4": k4_members(ds, ck),
    }
    wrapper = {"wrapper": bg.this_launcher()}
    root = {}
    for mode, qs in (("int8", scales), ("f32", None)):
        for where, mem in members.items():
            rows = seg.pack_rows(bins_fn, grad, hess, ones)
            marr = seg.split_members(*mem)
            res = bg.run_case(f"{where} {mode}", rows, marr, b, qs, wrapper, reps=20,
                              timed=where == "root", plain_reps=5)
            got = "bit-equal" if qs is not None else "within f32_tol"
            if qs is None:
                got += ", the same bits on two calls"
            print(f"kernel fused_grow_step {mode} {where} (windows {marr[:, :2].tolist()}): dec "
                  f"and every column of the rows equal to the plain version, histogram {got}")
            if where == "root":
                root[mode] = res
                print(f"kernel fused_grow_step {mode} root: {res['wrapper']:.4f} ms (device "
                      f"{res['wrapper device']:.4f} ms, {res['wrapper ops']:.0f} device "
                      f"operations), bound {res['bound']:.5f} ms, pair {res['pair']:.4f} ms "
                      f"(device {res['pair device']:.4f}), composite {res['composite']:.4f} ms "
                      f"(device {res['composite device']:.4f}), plain {res['plain']:.4f} ms")
            del rows
    rows, nb = bp.synthetic_rows(ROWS, f, torch.device("cuda"))
    qs = bg.int8_scales(rows)
    for cname, mem in bg.edge_cases(rows, nb).items():
        for q in (qs, None):
            bg.run_case(cname, rows, mem, 256, q, wrapper, reps=0, timed=False)
        print(f"kernel fused_grow_step edge case {cname}: windows {mem[:, :2].tolist()}: exact "
              "in both modes")
    small, mem = bg.few_bins(rows)
    for q in (qs, None):
        bg.run_case("root at 64 bins", small, mem, 64, q, wrapper, reps=0, timed=False)
    print("kernel fused_grow_step edge case root at 64 bins: exact in both modes")
    del rows, small
    torch.cuda.empty_cache()
    res = root["int8"]
    entry = kernel_entry("fused_grow_step", 0.0, res["wrapper"], res["plain"],
                         bound_ms(2 * n * (f + 16) + f * b * 12), res["composite"])
    entry.update(device_ms=res["wrapper device"], launches_per_call=res["wrapper ops"],
                 pair_ms=res["pair"], pair_device_ms=res["pair device"],
                 f32_ms=root["f32"]["wrapper"], f32_device_ms=root["f32"]["wrapper device"],
                 library_call="composite: stable torch.sort of the go-left keys, index_select "
                 "of every column, copy_ back, index_add_ of the child's i32 digit rows")
    return entry


def library_index_add(rows, order, windows, b, scales=None):
    """Time of one index_add_ of the windows' rows into a [K, F, B] table
    (``bench_ordered.library_ms``): (ms, rows it covered).  The ids alone
    take 8 bytes a (row, feature): where the windows do not fit the card's
    memory, the first window is halved until they do."""
    from lightgbm_tpu_torch import bench_ordered

    wins = list(windows)
    while True:
        try:
            return (bench_ordered.library_ms(rows, order, wins, b, scales),
                    sum(c for _, c in wins))
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            s0, c = wins[0]
            if c < 2:
                raise
            wins[0] = (s0, c // 2)


def check_ordered_kernels(rows, qrows, scales, num_bins, nan_bins, b):
    """The ordered histograms (f32 and int8) against their plain versions on
    the cases of ``bench_ordered.cases``: the root (no index), K=2 unaligned
    windows of a shuffled index, windows of 14,000 rows at K=1 and K=4, and
    the root with 64 skewed features; the split scan of the root histogram
    at F=700."""
    from lightgbm_tpu_torch import bench_ordered
    from lightgbm_tpu_torch._bench import device_profile
    from lightgbm_tpu_torch.ops import histogram as oh
    from lightgbm_tpu_torch.ops import split_scan

    f = rows.f
    out, err32 = [], 0.0
    for where, (crows, idx, wins) in bench_ordered.cases(rows).items():
        cq = oh.OrderedRows(crows.bins, f, qrows.g, qrows.h, qrows.m)
        hk = oh.ordered_hist(crows, idx, wins, b)
        hp = oh.ordered_hist_plain(crows, idx, wins, b)
        h8k = oh.ordered_hist_int8(cq, idx, wins, b, scales)
        h8p = oh.ordered_hist_int8_plain(cq, idx, wins, b, scales)
        again = oh.ordered_hist(crows, idx, wins, b)
        torch.cuda.synchronize()
        err = bench_ordered.check(where, hk, hp, h8k, h8p, crows, idx, wins, b, again)
        del again
        err32 = max(err32, err)
        t = {
            "f32": time_ms(lambda: oh.ordered_hist(crows, idx, wins, b)),
            "int8": time_ms(lambda: oh.ordered_hist_int8(cq, idx, wins, b, scales)),
            "f32 plain": time_ms(lambda: oh.ordered_hist_plain(crows, idx, wins, b), reps=3),
            "int8 plain": time_ms(lambda: oh.ordered_hist_int8_plain(cq, idx, wins, b, scales),
                                  reps=3),
        }
        lib32, lib32_rows = library_index_add(crows, idx, wins, b)
        lib8, lib8_rows = library_index_add(cq, idx, wins, b, scales)
        bound = (bench_ordered.bound_ms(crows, idx, wins, b), "bytes")
        print(f"kernel ordered_hist {where} {[tuple(w) for w in wins]} x {f} features: f32 "
              f"{t['f32']:.4f} ms (plain {t['f32 plain']:.4f}), int8 {t['int8']:.4f} ms (plain "
              f"{t['int8 plain']:.4f}), bound {bound[0]:.5f} ms by {bound[1]}; library index_add_ "
              f"f32 {lib32:.4f} ms over {lib32_rows} rows, i32 digits {lib8:.4f} ms over "
              f"{lib8_rows} rows; counts exact, f32 g/h within {err:.3g} and the same bits on "
              "two calls, int8 bit-equal")
        if where == "root":
            out.append(kernel_entry("ordered_hist", err, t["f32"], t["f32 plain"], bound, lib32))
            out.append(kernel_entry("ordered_hist_int8", 0.0, t["int8"], t["int8 plain"], bound, lib8))
            root = hp[0]
        del hk, hp, h8k, h8p, cq, crows
        torch.cuda.empty_cache()
    print(f"kernel ordered_hist: f32 max |err| vs plain {err32:.3g} (bound: count * 2^-24 * "
          "sum|x| per bin, each)")

    # the split scan at the wide shape: F = 700 blocks of 256 bins
    kw = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
    dev = rows.device
    nb_t = torch.as_tensor(num_bins, device=dev)
    nan_t = torch.as_tensor(nan_bins, device=dev)
    mask = torch.ones(f, dtype=torch.bool, device=dev)
    tot = root[0].sum(0)
    rk = split_scan.split_scan(root, tot, nb_t, nan_t, mask, **kw)
    rp = split_scan.split_scan_plain(root, tot, nb_t, nan_t, mask, **kw)
    if not torch.equal(rk[:, 1:3], rp[:, 1:3]):
        raise AssertionError("split_scan F=700: bin or direction differs from the plain version")
    gerr = (rk[:, [0, 3, 4, 5]] - rp[:, [0, 3, 4, 5]]).abs()
    if bool((gerr > 1e-6 * rp[:, [0, 3, 4, 5]].abs() + 1e-6).any()):
        raise AssertionError(f"split_scan F=700: rows off by {float(gerr.max())}")
    ts = time_ms(lambda: split_scan.split_scan(root, tot, nb_t, nan_t, mask, **kw))
    tp = time_ms(lambda: split_scan.split_scan_plain(root, tot, nb_t, nan_t, mask, **kw), reps=5)
    td, _ = device_profile(lambda: split_scan.split_scan(root, tot, nb_t, nan_t, mask, **kw))
    sb = bound_ms(f * b * 12 + f * 8 * 4 + f * 12, ops=f * b * 2 * 20)
    print(f"kernel split_scan F={f}: {ts:.4f} ms (device {td:.4f}; plain {tp:.4f}), bound "
          f"{sb[0]:.5f} ms by {sb[1]}; bins/directions equal, rows max |err| "
          f"{float(gerr.max()):.3g}")
    check_candidates(f"F={f} root", root[None], tot[None].cpu().numpy(), nb_t, nan_t,
                     case_major=True)
    return out


def wide_kernel_inputs(ds, dev):
    """The ordered histograms' inputs on the binned wide table: (f32 rows,
    quantized rows as the quantized phase gives them, their scales, bins a
    feature, NaN bins, B)."""
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.ops import histogram as oh
    from lightgbm_tpu_torch.quantize import quantize_gradients

    n, f = ds.bins.shape
    obj = create_objective("binary", ds.label, dev)
    score = torch.full((n,), obj.boost_from_score(), dtype=torch.float32, device=dev)
    grad, hess = obj.get_gradients(score)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    bins_nf = oh.row_major_bins(ds.bins, dev)
    qg, qh, gs, hs = quantize_gradients(grad, hess, QUANT_PARAMS["num_grad_quant_bins"])
    return (oh.OrderedRows(bins_nf, f, grad, hess, ones), oh.OrderedRows(bins_nf, f, qg, qh, ones),
            torch.stack([gs, hs]), ds.num_bins(), ds.nan_bins(), ds.max_bin_padded)


def _hist_f64(rows, n, b):
    """[F, B, 2] g/h sums in f64 (reference for the error report)."""
    f = rows.bins.shape[0]
    ids = (rows.bins.long() + torch.arange(f, device=rows.g.device)[:, None] * b).reshape(-1)
    out = torch.zeros((f * b, 2), dtype=torch.float64, device=rows.g.device)
    out.index_add_(0, ids, torch.stack([rows.g, rows.h], 1).repeat(f, 1))
    return out.reshape(f, b, 2).float()


def check_forest_walk(booster, x, dev):
    """The walk of the trained model over all rows, kernel vs plain (the
    same bits), the same leaves in every tree; then the Higgs run's forest
    size, the 10 trees' records repeated 50 times (500 trees)."""
    from lightgbm_tpu_torch._bench import device_profile
    from lightgbm_tpu_torch.bench_forest_walk import plain as plain_in_blocks
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.predict import predict_bins_leaves, stack_bin_trees

    tables = booster._walk_tables()
    # the bins as Booster.predict gives them to the walk: its f32 rows are
    # C-contiguous, so bin_numeric's bins and their u8 cast are row-major
    # and the wrapper walks them with no copy
    xs = torch.as_tensor(np.ascontiguousarray(x[:, booster.used_features], dtype=np.float32),
                         device=dev)
    dbt = fw.build_devbin_tables(booster.bin_mappers, booster.used_features, dev)
    bins = fw.bin_numeric(xs, *dbt)[0].to(torch.uint8)
    if not bins.is_contiguous():
        raise AssertionError("forest_walk: predict's bins reach the walk feature-major")
    sk = fw.forest_walk(bins, tables, 1)
    sp = fw.forest_walk_plain(bins, tables, 1)
    err = float((sk - sp).abs().max())
    if not torch.equal(sk, sp):
        raise AssertionError(f"forest_walk: scores differ from the plain walker's bits "
                             f"(max |err| {err})")
    # same leaves: walk each tree alone with leaf values set to the leaf index
    batch = stack_bin_trees([t.record() for t in booster.trees], booster.nan_bins, dev)
    leaves = predict_bins_leaves(batch, bins)
    for i, tree in enumerate(booster.trees):
        rec = dict(tree.record(), leaf_value=np.arange(tree.num_leaves, dtype=np.float32))
        got = fw.forest_walk(bins, fw.build_tables([rec], booster.nan_bins, dev), 1)[:, 0]
        if not torch.equal(got.long(), leaves[:, i]):
            raise AssertionError(f"forest_walk: tree {i} routes rows to other leaves")
    # nodes visited = sum over rows and trees of the leaf depth (ops bound)
    depth = torch.as_tensor(
        np.stack([_leaf_depths(t, batch.leaf_value.shape[1]) for t in booster.trees]),
        device=dev,
    )
    visits = float(depth[torch.arange(len(booster.trees), device=dev)[None, :], leaves].sum())
    n, f = bins.shape
    table_bytes = tables.tables.numel() * 4
    print(f"kernel forest_walk: same leaves in every tree, scores bit-equal to the plain walker "
          f"(max |err| {err:.3g}), {visits:.0f} node visits "
          f"({visits / (n * len(booster.trees)):.3f} a row-tree)")
    entry = with_device(kernel_entry(
        "forest_walk", err,
        time_ms(lambda: fw.forest_walk(bins, tables, 1)),
        time_ms(lambda: fw.forest_walk_plain(bins, tables, 1), reps=3),
        bound_ms(n * f + table_bytes + n * 4, ops=visits), None,
    ), lambda: fw.forest_walk(bins, tables, 1))
    # the call on the feature-major bins that a column gather of a row-major
    # array gives (what this check timed before it made the bins as predict
    # does): the wrapper copies them into rows before the kernel
    bins_fm = bins.T.contiguous().T
    if not torch.equal(fw.forest_walk(bins_fm, tables, 1), sk):
        raise AssertionError("forest_walk: feature-major bins give other scores")
    entry["feature_major_ms"] = time_ms(lambda: fw.forest_walk(bins_fm, tables, 1))
    entry["feature_major_device_ms"], entry["feature_major_ops"] = device_profile(
        lambda: fw.forest_walk(bins_fm, tables, 1))
    print(f"kernel forest_walk on feature-major bins (the wrapper's copy into rows included): "
          f"{entry['feature_major_ms']:.4f} ms event time, {entry['feature_major_device_ms']:.4f} "
          f"ms device time in {entry['feature_major_ops']:.0f} device operations a call")
    del bins_fm

    # the Higgs run's 500 trees (docs/Experiments.rst): the trained records
    # repeated 50 times, each row's leaf values added in tree order
    recs = [t.record() for t in booster.trees] * 50
    big = fw.build_tables(recs, booster.nan_bins, dev)
    sk = fw.forest_walk(bins, big, 1)
    sp = plain_in_blocks(bins, big, 1)
    if not torch.equal(sk, sp):
        raise AssertionError(f"forest_walk at {len(recs)} trees: scores differ from the plain "
                             f"walker's bits (max |err| {float((sk - sp).abs().max())})")
    big_ms = time_ms(lambda: fw.forest_walk(bins, big, 1), reps=10)
    big_dev, big_ops = device_profile(lambda: fw.forest_walk(bins, big, 1))
    t0 = time.perf_counter()
    plain_in_blocks(bins, big, 1)
    torch.cuda.synchronize()
    big_plain = (time.perf_counter() - t0) * 1e3
    bound = bound_ms(n * f + big.tables.numel() * 4 + n * 4, ops=visits * 50)
    print(f"kernel forest_walk at {len(recs)} trees ({n} rows): scores bit-equal to the plain "
          f"walker; {big_ms:.4f} ms event time, {big_dev:.4f} ms device time in {big_ops:.0f} "
          f"device operations a call, bound {bound[0]:.5f} ms by {bound[1]}; plain "
          f"{big_plain:.1f} ms")
    return entry


def predict_stats(booster, x, label: str) -> dict:
    """One warm predict of rows x: ``Booster.last_predict_stats`` (host wall
    time a phase, taken without extra synchronisation), its rows/s, and the
    device time of the same predict by operation (one trace of one call:
    the walk kernel alone, and every device operation)."""
    from lightgbm_tpu_torch._bench import device_by_name

    booster.predict(x)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster.predict(x)
    total = time.perf_counter() - t0
    stats = dict(booster.last_predict_stats)
    by_name = device_by_name(lambda: booster.predict(x), reps=1)
    walk = sum(ms for name, ms in by_name.items() if "forest_walk" in name)
    busy = sum(by_name.values())
    dev = (f"device time of the same call (one trace): the walk kernel {walk:.4f} ms, "
           f"{len(by_name)} kinds of device operation {busy:.3f} ms in all"
           if by_name else "device time: the trace lost operations (not measured)")
    print(f"{label}: one warm predict of {len(x)} rows {total * 1e3:.1f} ms "
          f"({len(x) / total:.0f} rows/s); last_predict_stats {json.dumps(stats)}; {dev}")
    return {"total_ms": total * 1e3, "stats": stats,
            "walk_device_ms": walk if by_name else float("nan"),
            "device_ms": busy if by_name else float("nan")}


def early_stop_reference(per_tree: np.ndarray, freq: int, margin: float):
    """(each row's sum up to the first checkpoint, every ``freq`` trees,
    where 2 |sum| > margin, else its full sum; the rows stopped), adding
    the trees in order row by row (reference gbdt_prediction.cpp:18-36)."""
    acc = np.zeros(len(per_tree))
    out = np.zeros(len(per_tree))
    done = np.zeros(len(per_tree), bool)
    for t in range(per_tree.shape[1]):
        acc = acc + per_tree[:, t]
        if (t + 1) % freq == 0:
            stop = ~done & (2 * np.abs(acc) > margin)
            out[stop] = acc[stop]
            done |= stop
    return np.where(done, out, acc), int(done.sum())


def predict_checks(booster, x, dev) -> dict:
    """The rest of prediction on the card, on the main phase's model and
    rows, each timed: ``pred_leaf`` (chunks of 4,096 rows) against the
    plain walker's leaves of every row; the walk path in chunks of 262,144
    rows at ``pred_num_buffers`` 1 and 2 against one chunk; the streaming
    value path at 4,096 against 1<<20 rows a chunk and prediction early
    stopping against the same per-tree block summed on the host, both on
    the first STREAM_CHECK_ROWS rows; and
    ``pred_contrib`` of 32 rows against the per-tree block's sum (the SHAP
    identity).  Every comparison is bit for bit but the last (1e-6)."""
    from lightgbm_tpu_torch.boosting import gbdt
    from lightgbm_tpu_torch.predict import predict_bins_leaves, stack_bin_trees

    n, n_trees = len(x), len(booster.trees)
    rates = {}

    def timed(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        rates[what] = len(out) / (time.perf_counter() - t0)
        return out

    t_all = time.perf_counter()
    leaves = timed("pred_leaf", lambda: booster.predict(x, pred_leaf=True, pred_chunk_rows=4096))
    leaf_stats = dict(booster.last_predict_stats)
    batch = stack_bin_trees([t.record() for t in booster.trees], booster.nan_bins, dev)
    plain = predict_bins_leaves(batch, torch.as_tensor(booster._bin_matrix(x), device=dev))
    if leaves.shape != (n, n_trees) or not np.array_equal(leaves, plain.cpu().numpy()):
        raise AssertionError("pred_leaf: leaves differ from the plain walker's")
    del plain
    want = booster.predict(x)
    chunk = gbdt.PREDICT_CHUNK
    gbdt.PREDICT_CHUNK = 1 << 18
    try:
        for nb in (1, 2):
            got = timed(f"walk path, 262,144-row chunks, {nb} buffers",
                        lambda: booster.predict(x, pred_num_buffers=nb))
            if not np.array_equal(got, want):
                raise AssertionError(f"walk path: {nb} buffers differ from one chunk")
        chunk_stats = dict(booster.last_predict_stats)
    finally:
        gbdt.PREDICT_CHUNK = chunk
    eng = booster._stream_engine()
    xq = x[:STREAM_CHECK_ROWS]
    small = timed("stream value, 4,096-row chunks",
                  lambda: eng.run(xq, 0, n_trees, space="bin", kind="value", chunk=4096))
    stream_stats = dict(eng.last_stats)
    big = timed("stream value, 1<<20-row chunks",
                lambda: eng.run(xq, 0, n_trees, space="bin", kind="value", chunk=1 << 20))
    if not np.array_equal(small, big):
        raise AssertionError("streaming value path: 4,096 and 1<<20 rows a chunk differ")
    margin = 1.0
    es = timed("early stopping, freq 2, margin 1.0", lambda: booster.predict(
        xq, raw_score=True, pred_early_stop=True, pred_early_stop_freq=2,
        pred_early_stop_margin=margin))
    ref, stopped = early_stop_reference(small, 2, margin)
    if not np.array_equal(es, ref) or not 0 < stopped < len(xq):
        raise AssertionError(f"early stopping: card and host differ ({stopped} rows stopped)")
    contrib = timed("pred_contrib, 32 rows", lambda: booster.predict(x[:32], pred_contrib=True))
    err = float(np.abs(contrib.sum(axis=1) - small[:32].sum(axis=1)).max())
    if contrib.shape != (32, x.shape[1] + 1) or err > 1e-6:
        raise AssertionError(f"pred_contrib: the SHAP identity is off by {err:.3g}")
    took = time.perf_counter() - t_all
    print(f"main: pred_leaf of {n} rows (4,096-row chunks) equals the plain walker's leaves; "
          f"the walk path in 262,144-row chunks at 1 and 2 buffers bit-equal to one chunk; on "
          f"the first {len(xq)} rows the streaming value path at 4,096 and 1<<20 rows a chunk "
          f"bit-equal; early stopping "
          f"(freq 2, margin {margin}) equals the host's sum of the same per-tree block, "
          f"{stopped} rows stopped early; pred_contrib of 32 rows sums to the raw score within "
          f"{err:.3g}; the checks took {took:.1f} s")
    print("main: predict rows/s " + ", ".join(f"{k} {v:.0f}" for k, v in rates.items()))
    print(f"main: last_predict_stats of pred_leaf {json.dumps(leaf_stats)}; of the walk path "
          f"in 262,144-row chunks {json.dumps(chunk_stats)}; of the streaming value path at "
          f"4,096 {json.dumps(stream_stats)}")
    return {"rows_per_s": rates, "seconds": took, "stopped": stopped}


def profile_iteration(booster, label: str = "profile") -> dict:
    """Where one training iteration's time goes: torch.profiler over one
    update(), device time by kernel against the host's wall time, and the
    host's own time by operator (self time: the rest of the wall is Python
    outside PyTorch's operators, and the profiler's overhead).  Returns
    {"launches a split", "best_split calls", "hist device ms" (the lane
    histogram's kernels: the segment histograms and the fused steps'
    histograms), "wall ms"} of the iteration."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch import _build

    from lightgbm_tpu_torch.ops import grow_step, grower, seg
    from lightgbm_tpu_torch.ops import histogram as oh

    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    scans = []  # (leaves, host ms) of each split-scan call of the grower
    scan_call = grower.fused_best_split_batch

    def scan_timed(hists, *a, **k):
        t0 = time.perf_counter()
        got = scan_call(hists, *a, **k)
        scans.append((len(hists), (time.perf_counter() - t0) * 1e3))
        return got

    best = []  # (leaves, host ms) of each best_split call of the grower (EFB trees)
    best_call = grower.best_split_batch

    def best_timed(*a, **k):
        t0 = time.perf_counter()
        got = best_call(*a, **k)
        best.append((len(got), (time.perf_counter() - t0) * 1e3))
        return got

    ordered = []  # (rows, windows) of each ordered histogram call
    launch = oh._launch

    def recorded(rows, order, wins, num_bins, scales):
        ordered.append((sum(c for _, c in wins), len(wins)))
        return launch(rows, order, wins, num_bins, scales)

    parts = []  # rows of each window of each partition call
    part_launch = seg._partition_launch

    def part_recorded(rows, mem, counted_as, fn=None):
        parts.extend(int(c) for c in mem[:, 1])
        return part_launch(rows, mem, counted_as, fn)

    steps = []  # rows of each window of each fused grow step
    step_launch = grow_step._launch

    def step_recorded(rows, mem, num_bins, quant_scales, fn=None, live=None):
        steps.append([int(c) for c in mem[:, 1]])
        return step_launch(rows, mem, num_bins, quant_scales, fn, live=live)

    hists = {"f32": [], "int8": []}  # rows of each window of each segment histogram call
    hist_launch = seg._seg_hist_launch

    def hist_recorded(rows, wins, num_bins, scales, fn=None, live=None):
        hists["f32" if scales is None else "int8"].append([int(c) for _, c in wins])
        return hist_launch(rows, wins, num_bins, scales, fn, live=live)

    oh._launch = recorded
    grower.fused_best_split_batch = scan_timed
    grower.best_split_batch = best_timed
    seg._partition_launch = part_recorded
    grow_step._launch = step_recorded
    seg._seg_hist_launch = hist_recorded
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            booster.update()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        oh._launch = launch
        grower.fused_best_split_batch = scan_call
        grower.best_split_batch = best_call
        seg._partition_launch = part_launch
        grow_step._launch = step_launch
        seg._seg_hist_launch = hist_launch
    launched = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
                if v - before.get(k, 0)}
    # device-side events only (kernels and copies on the card); the host
    # ops that launched them carry the same time and are left out
    from torch.autograd import DeviceType

    dev_us = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, cnt = dev_us.get(e.name, (0.0, 0))
            dev_us[e.name] = (us + e.time_range.elapsed_us(), cnt + 1)
    # the lane histogram's kernels serve the segment histogram and the fused
    # step: an accumulate names its user (its second template argument is
    # true in csrc/seg_hist.cu), and the reduce after it on the stream is
    # the same call's
    lane_us = {"seg f32": 0.0, "seg int8": 0.0, "step": 0.0}
    user = "step"
    for e in sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and "lane_hist_" in e.name), key=lambda e: e.time_range.start):
        acc = re.search(r"lane_hist_accumulate<(\w+), (\w+)(?:, \w+)?>", e.name)
        if acc:
            user = "step" if acc.group(2) == "false" else (
                "seg int8" if acc.group(1) == "true" else "seg f32")
        lane_us[user] += e.time_range.elapsed_us()
    busy_ms = sum(us for us, _ in dev_us.values()) / 1e3
    print(f"{label}: one iteration (tree {len(booster.trees)}) {wall_ms:.1f} ms wall under the "
          f"profiler, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.3f} of wall)")
    # bytes a row of the bins (planes: two a feature in the u16 mode) and
    # the histograms' features
    b = booster._grower_params.max_bin
    planes = int(booster._bins_fn.shape[0])
    feats = planes // 2 if b > 256 and booster.hist_mode == "seg" else planes
    for key, (us, cnt) in sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"{label}:   {us / 1e3:8.2f} ms  {cnt:6d} calls  {key[:90]}")
    if ordered:
        # the tree's ordered histograms against their bound: each launch
        # reads rows * (F + 16) bytes and writes K * F * B * 12
        f = planes
        nbytes = sum(r * (f + 16) + k * f * b * 12 for r, k in ordered)
        hist_us = sum(us for key, (us, _) in dev_us.items() if "ordered_hist_" in key)
        rows = sorted(r for r, _ in ordered)
        print(f"{label}: ordered_hist {hist_us / 1e3:.3f} ms over {len(ordered)} launches "
              f"against a bound of {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms "
              f"({hist_us / 1e3 / (nbytes / HBM_BYTES_PER_S * 1e3):.1f}x); rows a launch: "
              f"median {rows[len(rows) // 2]}, mean {sum(rows) / len(rows):.0f}, "
              f"non-root mean {sum(rows[:-1]) / max(1, len(rows) - 1):.0f}")
    if parts:
        # the tree's partitions against their bound: each window's rows
        # read and written once, F + 16 bytes a row
        part_us = sum(us for key, (us, _) in dev_us.items() if "partition_" in key)
        wins = sorted(parts)
        pbound = 2 * sum(wins) * (planes + 16) / HBM_BYTES_PER_S * 1e3
        print(f"{label}: partition {part_us / 1e3:.3f} ms over {len(wins)} windows against a bound "
              f"of {pbound:.3f} ms; rows a window median {wins[len(wins) // 2]}, mean "
              f"{sum(wins) / len(wins):.0f}, largest {wins[-1]}")
    if steps:
        # the tree's fused grow steps against their bound: each window's
        # rows read and written once, planes + 16 bytes a row, and each
        # call's K * F * B * 12 output bytes
        step_us = lane_us["step"] + sum(us for key, (us, _) in dev_us.items()
                                        if "partition_" in key)
        wins = sorted(c for call in steps for c in call)
        sbound = (2 * sum(wins) * (planes + 16) + sum(len(call) for call in steps) * feats * b
                  * 12) / HBM_BYTES_PER_S * 1e3
        print(f"{label}: fused_grow_step {step_us / 1e3:.3f} ms over {len(steps)} calls "
              f"({len(wins)} windows) against a bound of {sbound:.3f} ms "
              f"({step_us / 1e3 / sbound:.1f}x); rows a window median {wins[len(wins) // 2]}, "
              f"mean {sum(wins) / len(wins):.0f}, largest {wins[-1]}")
    for mode, calls in hists.items():
        if not calls:
            continue
        # the tree's segment histograms against their bound: each window's
        # rows read once, planes + 12 bytes a row, and each call's
        # K * F * B * 12 output bytes (f32: the near-tie refine on the fused
        # path)
        wins = sorted(c for call in calls for c in call)
        live = [c for c in wins if c > 0]
        hbound = (sum(wins) * (planes + 12) + len(wins) * feats * b * 12) / HBM_BYTES_PER_S * 1e3
        hms = lane_us["seg " + mode] / 1e3
        print(f"{label}: seg_hist {mode} {hms:.3f} ms over {len(calls)} calls ({len(wins)} "
              f"windows, {len(wins) - len(live)} of them empty) against a bound of {hbound:.3f} "
              f"ms ({hms / max(hbound, 1e-9):.1f}x); rows a non-empty window median "
              f"{live[len(live) // 2] if live else 0}, mean {sum(live) / max(1, len(live)):.0f}, "
              f"largest {wins[-1]}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    splits = max(1, booster.trees[-1].num_leaves - 1)
    cuda_launches = sum(e.count for e in host if e.key.startswith("cudaLaunch"))
    print(f"{label}: {splits} splits in {booster.grow_steps[-1]} grow steps at K="
          f"{booster.leaf_batch_effective[-1]}: {cuda_launches / splits:.1f} CUDA launches per "
          f"split ({cuda_launches} in all; {EARLIER_LAUNCHES_PER_SPLIT.get(label, 'n/a')} with "
          f"the rows-only scan, PERF.md section 5); kernel wrappers {json.dumps(launched)}")
    scan_ms = sum(ms for _, ms in scans)
    scan_us = sum(us for key, (us, _) in dev_us.items() if "split_scan_" in key)
    print(f"{label}: split scan {len(scans)} calls ({sum(k for k, _ in scans)} leaves, "
          f"{len(scans) / splits:.2f} a split), wrapper {scan_ms:.2f} ms in all under the "
          f"profiler, {scan_ms / max(1, len(scans)):.4f} ms a call; device {scan_us / 1e3:.3f} ms")
    if best:
        ms = sum(t for _, t in best)
        print(f"{label}: best_split (every leaf of an EFB, u16 or categorical tree, plain "
              f"PyTorch on the card) {len(best)} calls ({sum(k for k, _ in best)} leaves, {len(best) / splits:.2f} a "
              f"split), {ms:.2f} ms in all under the profiler, {ms / len(best):.4f} ms a call")
    print(f"{label}: host operators {host_ms:.1f} ms self time ({host_ms / wall_ms:.3f} of wall), "
          f"{sum(e.count for e in host)} calls; top by self time:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"{label}:   host {e.self_cpu_time_total / 1e3:8.2f} ms  {e.count:6d} calls  {e.key[:60]}")
    return {"launches a split": cuda_launches / splits, "best_split calls": len(best),
            "hist device ms": sum(lane_us.values()) / 1e3, "wall ms": wall_ms}


def _leaf_depths(tree, width: int) -> np.ndarray:
    depth = np.zeros(width, np.int64)
    stack = [(0, 1)] if tree.num_leaves > 1 else []
    while stack:
        node, d = stack.pop()
        for c in (tree.left_child[node], tree.right_child[node]):
            if c >= 0:
                stack.append((int(c), d + 1))
            else:
                depth[~int(c)] = d
    return depth


def first_difference(a, b):
    """The first split, in tree and node order, where boosters ``a`` (the
    card's) and ``b`` (the CPU's) part: {tree, node, each one's (feature,
    bin, default_left) and gain}, or None when every split is the same; a
    tree with more splits than the other's parts after the last shared one
    (its gains then never agree)."""
    def split(tree, i):
        return int(tree.split_feature[i]), int(tree.split_bin[i]), bool(tree.default_left[i])

    for t, (ta, tb) in enumerate(zip(a.trees, b.trees)):
        k = min(len(ta.split_feature), len(tb.split_feature))
        diff = np.nonzero((ta.split_feature[:k] != tb.split_feature[:k])
                          | (ta.split_bin[:k] != tb.split_bin[:k])
                          | (ta.default_left[:k] != tb.default_left[:k]))[0]
        if len(diff):
            i = int(diff[0])
            return {"tree": t, "node": i, "cuda": split(ta, i), "cpu": split(tb, i),
                    "gain cuda": float(ta.split_gain[i]), "gain cpu": float(tb.split_gain[i])}
        if len(ta.split_feature) != len(tb.split_feature):
            return {"tree": t, "node": k, "gain cuda": 0.0, "gain cpu": float("inf")}
    return None


def split_share(a, b) -> float:
    """Share of nodes, over all trees, with the same (feature, bin,
    default_left) at the same position."""
    same = total = 0
    for ta, tb in zip(a.trees, b.trees):
        m = max(len(ta.split_feature), len(tb.split_feature))
        k = min(len(ta.split_feature), len(tb.split_feature))
        eq = (
            (ta.split_feature[:k] == tb.split_feature[:k])
            & (ta.split_bin[:k] == tb.split_bin[:k])
            & (ta.default_left[:k] == tb.default_left[:k])
        )
        same += int(eq.sum())
        total += m
    return same / max(total, 1)


def train_rounds(lt, params, ds, rounds):
    """Booster on the card, ``rounds`` updates; (booster, log-loss per
    round, seconds of the updates, seconds of the Booster's set-up: the
    bins' copies to the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    booster = lt.Booster(params, ds, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = []
    for _ in range(rounds):
        if booster.update():
            break
        losses.append(booster.train_loss())
    torch.cuda.synchronize()
    return booster, losses, time.perf_counter() - t1, t1 - t0


def require_launches(launches, names, what):
    missing = [k for k in names if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels never launched: {missing} ({launches})")


def batch_phase(lt, _build, ds):
    """bench.py's headline parameters (frontier batching at K = 4) on the
    card, against the same parameters at K = 1.  Returns the batched run's
    kernel launches."""
    _build.LAUNCHES.clear()
    bb, losses, train_s, _ = train_rounds(lt, BATCH_PARAMS, ds, BATCH_ROUNDS)
    launches = dict(_build.LAUNCHES)
    splits = sum(t.num_leaves - 1 for t in bb.trees)
    print(f"batch: leaf_batch 4, min_data_in_leaf 100: {len(bb.trees)} trees of "
          f"{[t.num_leaves for t in bb.trees]} leaves, {len(losses) / train_s:.3f} iterations/s")
    print("batch: training log-loss per round " + " ".join(f"{v:.6f}" for v in losses))
    print(f"batch: grow steps per tree {bb.grow_steps}, effective K {bb.leaf_batch_effective}, "
          "commit rate " + " ".join(f"{r:.3f}" for r in bb.commit_rates)
          + f"; {splits} splits in {sum(bb.grow_steps)} steps")
    print(f"batch: near-tie f32 refines per tree {bb.refine_counts}")
    print(f"batch: kernel launches {json.dumps(launches)}")
    if len(losses) != BATCH_ROUNDS or not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError("batch: training log-loss did not fall every round")
    require_launches(launches, ("fused_grow_step", "seg_hist_int8", "split_scan_batch"),
                     "batched path")

    # the same rows and parameters, one split per step
    sb, s_losses, s_s, _ = train_rounds(lt, {**BATCH_PARAMS, "leaf_batch": 1}, ds, BATCH_ROUNDS)
    share = split_share(bb, sb)
    rel = abs(losses[-1] - s_losses[-1]) / s_losses[-1]
    print(f"batch: serial (leaf_batch 1) {len(s_losses) / s_s:.3f} iterations/s in the same "
          f"process; {share:.4f} of splits identical, log-loss after {BATCH_ROUNDS} rounds "
          f"batched {losses[-1]:.7f} vs serial {s_losses[-1]:.7f} (relative {rel:.3g})")
    if share < 0.95 or rel > 1e-4:
        raise AssertionError("batched and serial growth disagree")
    del sb
    profile_iteration(bb, "batch profile")
    return launches


def io_phase(lt, _build, rows, dev):
    """Weighted training with a validation set through train(), its
    evaluation records, the model text written and read on the card, and
    the reference's own model.  Returns the training run's kernel
    launches."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.predict import (predict_bins_leaves, predict_real_leaves,
                                            stack_bin_trees, stack_real_trees)

    # one draw of the task: the training rows, then the validation rows
    x, y = make_data(rows + IO_VALID_ROWS, FEATURES, seed=17)
    x, xv, y, yv = x[:rows], x[rows:], y[:rows], y[rows:]
    weight = np.random.default_rng(5).uniform(0.5, 1.5, rows)
    ds = lt.Dataset(x, y, weight=weight, params=IO_PARAMS)
    vs = lt.Dataset(xv, yv, reference=ds)
    rec, stamps = {}, []

    def start(env):
        torch.cuda.synchronize()
        stamps.append([time.perf_counter()])

    def end(env):
        torch.cuda.synchronize()
        stamps[-1].append(time.perf_counter())

    # end runs after record_evaluation (order 20), before early_stopping (30),
    # which raises at the last round
    start.before_iteration, start.order, end.order = True, 0, 25
    _build.LAUNCHES.clear()
    booster = lt.train(IO_PARAMS, ds, IO_ROUNDS, valid_sets=[ds, vs],
                       valid_names=["training", "valid"], device=dev,
                       callbacks=[lt.record_evaluation(rec), lt.early_stopping(5, verbose=False),
                                  start, end])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    n_trees = booster.num_trees()
    round_ms = [(b - a) * 1e3 for a, b in stamps]
    losses = rec["training"]["binary_logloss"]
    print(f"io: {n_trees} trees, best iteration {booster.best_iteration}, best score "
          f"{json.dumps(booster.best_score)}")
    print("io: weighted training log-loss per round " + " ".join(f"{v:.6f}" for v in losses))
    print("io: validation log-loss per round "
          + " ".join(f"{v:.6f}" for v in rec["valid"]["binary_logloss"])
          + "; auc " + " ".join(f"{v:.6f}" for v in rec["valid"]["auc"]))
    print(f"io: kernel launches {json.dumps(launches)}")
    if not falls(losses, IO_ROUNDS):
        raise AssertionError("io: weighted training log-loss did not fall every round")
    require_launches(launches, ("fused_grow_step", "seg_hist_int8", "split_scan",
                                "forest_walk"), "io training")
    if launches["forest_walk"] != n_trees:
        raise AssertionError(f"io: {launches['forest_walk']} forest walks for {n_trees} trees "
                             "on one validation set")

    entry = booster._valid[0]
    want = booster.predict_raw_bins(entry.bins)
    if not torch.allclose(entry.score, want, rtol=1e-6, atol=1e-6):
        raise AssertionError(f"io: validation score differs from predict_raw_bins "
                             f"(max |diff| {float((entry.score - want).abs().max())})")
    p = np.clip(booster.predict(xv, num_iteration=n_trees), 1e-15, 1 - 1e-15)
    host = float(-np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p)))
    got = rec["valid"]["binary_logloss"][-1]
    print(f"io: recorded validation log-loss {got:.8f}, host f64 from predict {host:.8f} "
          f"(relative {abs(got - host) / host:.3g}); validation score = predict_raw_bins "
          f"(max |diff| {float((entry.score - want).abs().max()):.3g})")
    if abs(got - host) > 1e-5 * host:
        raise AssertionError("io: recorded log-loss differs from the host's")

    # the validation walk of one tree: the kernel alone, and the whole step
    # (the tree's table built on the host, copied, walked, added)
    tables = fw.build_tables([booster.trees[-1].record()], booster.nan_bins, dev)
    nv, nf = entry.bins.shape
    walk_ms = time_ms(lambda: fw.forest_walk(entry.bins, tables, 1))
    walk_bound = bound_ms(nv * nf + tables.tables.numel() * 4 + nv * 4)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        entry.score + booster._walk_one(booster.trees[-1].record(), entry.bins)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"io: validation walk of one tree over {nv} rows: kernel {walk_ms:.4f} ms event time "
          f"(bound {walk_bound[0]:.5f} ms by {walk_bound[1]}), the whole step {step_ms:.3f} ms "
          "host wall (table, copy, walk, add)")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        booster.eval_train()
        booster.eval_valid()
    eval_ms = (time.perf_counter() - t0) * 1e3 / reps
    print(f"io: eval of the training and validation sets {eval_ms:.2f} ms a round; round wall "
          f"time median {statistics.median(round_ms):.1f} ms (eval share "
          f"{eval_ms / statistics.median(round_ms):.4f}); rounds "
          + " ".join(f"{v:.1f}" for v in round_ms) + " ms")

    # model text: save, load on the card, predict in real space
    path = pathlib.Path(lt.__file__).resolve().parent / "build" / "io_model.txt"
    path.parent.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    booster.save_model(str(path))
    save_ms = (time.perf_counter() - t0) * 1e3
    text = path.read_text()
    t0 = time.perf_counter()
    loaded = lt.Booster(model_file=str(path), device=dev)
    load_ms = (time.perf_counter() - t0) * 1e3
    if loaded.model_to_string() != text:
        raise AssertionError("io: the loaded model's text differs from the file")
    real = loaded.predict(x)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    real = loaded.predict(x)
    real_s = time.perf_counter() - t0
    bins_pred = booster.predict(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bins_pred = booster.predict(x)
    bin_s = time.perf_counter() - t0
    diff = float(np.abs(real - bins_pred).max())
    if not np.allclose(real, bins_pred, rtol=1e-6, atol=1e-6):
        raise AssertionError(f"io: real-space predict differs from bin-space (max |diff| {diff})")
    t_end = booster._tree_range(0, None)[1]
    records = [t.record() for t in booster.trees[:t_end]]
    bin_leaves = predict_bins_leaves(
        stack_bin_trees(records, booster.nan_bins, dev),
        torch.as_tensor(ds.bins, device=dev))
    real_leaves = predict_real_leaves(stack_real_trees(loaded.trees, dev),
                                      torch.as_tensor(x, dtype=torch.float64, device=dev))
    if not torch.equal(bin_leaves, real_leaves):
        raise AssertionError("io: the loaded model routes rows to other leaves")
    print(f"io: save_model {save_ms:.1f} ms ({len(text)} bytes, {len(loaded.trees)} trees), "
          f"load {load_ms:.1f} ms; real-space predict {len(x) / real_s:.0f} rows/s "
          f"({real_s * 1e3:.1f} ms), bin-space {len(x) / bin_s:.0f} rows/s "
          f"({bin_s * 1e3:.1f} ms); max |diff| {diff:.3g}, every row in the same leaf of every "
          "tree; the loaded model's text byte-equal to the file")

    # the reference LightGBM's own model
    arr = np.loadtxt(GOLDEN / "scen_weighted.train.csv", delimiter=",")
    ref = lt.Booster(model_file=str(GOLDEN / "scen_weighted.model.txt"), device=dev)
    gp = ref.predict(arr[:, 1:])
    gw = np.loadtxt(GOLDEN / "scen_weighted.preds.txt", ndmin=1)
    if not np.allclose(gp, gw, rtol=1e-4, atol=1e-5):
        raise AssertionError("io: scen_weighted.model.txt does not predict its preds.txt")
    print(f"io: the reference's scen_weighted.model.txt on the card: {len(gp)} rows, max |diff| "
          f"from its preds.txt {float(np.abs(gp - gw).max()):.3g}")
    path.unlink()
    return launches


def make_efb_data(n_rows: int, seed: int = 42):
    """The efb phase's table, f64 (what ``Dataset.construct`` reads, so
    that it makes no copy): the ``EFB_LEVELS`` categorical variables, each
    level drawn with probability proportional to 1 / k ** EFB_ZIPF and
    one-hot coded; the label drawn from a logistic of the summed per-level
    effects (normal, from the seed) plus standard normal noise."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_rows, sum(EFB_LEVELS)))
    z = rng.normal(size=n_rows)
    rows, col = np.arange(n_rows), 0
    for levels in EFB_LEVELS:
        p = 1.0 / np.arange(1, levels + 1) ** EFB_ZIPF
        codes = rng.choice(levels, size=n_rows, p=p / p.sum())
        x[rows, col + codes] = 1.0
        z += rng.normal(size=levels)[codes]
        col += levels
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return x, y


def efb_members(ds, ck):
    """Members of the efb table's table-mode checks: the root split by the
    root's bundle-plane candidate ``ck``, and K=4 windows (the second one
    empty, none on a tile boundary) each split by the table of one member
    of a bundle plane; beside them the same windows split by a threshold at
    the same plane bins, and by that threshold's own table (the same rows
    left: the table mode's cost alone).  {name: (table members, threshold
    members, threshold-table members)}."""
    from lightgbm_tpu_torch.ops import seg
    from lightgbm_tpu_torch.ops.split import bundle_table

    n, b, lay = ds.num_data, ds.max_bin_padded, ds.bundle_layout
    root = ([0], [n], [ck.feature], [ck.bin], [0], [-1])
    bundles = [p for p in range(lay.num_planes) if lay.is_bundle(p)]
    planes = [ck.feature] + [bundles[i % len(bundles)] for i in (1, 2, 3)]
    # each window's member: the plane's first, then one of its widest
    pick = [0, 0, int(np.argmax(lay.widths[planes[2]])), len(lay.planes[planes[3]]) - 1]
    tb = [lay.starts[p][k] for p, k in zip(planes, pick)]
    ends = [lay.starts[p][k] + lay.widths[p][k] - 1 for p, k in zip(planes, pick)]
    k4 = ([37, n // 4 + 5, n // 4 + 5, n // 2 + 1001],
          [n // 4 - 100, 0, n // 4 - 900, n // 2 - 2000], planes, tb, [0] * 4, [-1] * 4)
    out = {}
    for name, cols, tables in (("root", root, [ck.table]),
                               ("K=4", k4, [bundle_table(t, e, b) for t, e in zip(tb, ends)])):
        twins = [np.arange(b) <= t for t in cols[3]]  # dl 0, no NaN bin on a bundle plane
        out[name] = (seg.split_members(*cols, [1] * len(tables), tables),
                     seg.split_members(*cols),
                     seg.split_members(*cols, [1] * len(twins), twins))
    return out


def check_efb_kernels(ds, dev):
    """The partition and the fused step (int8 and f32) in table mode on the
    efb table's rows, through the wrappers, against their plain versions
    (``bench_partition.run_case`` / ``bench_grow_step.run_case``: nl, dec
    and every column of the rows exactly, int8 histograms bit-equal, f32
    ones within f32_tol and the same bits on two calls): at the root (the
    root's own bundle-plane split) and on K=4 windows, timed beside the
    threshold mode on the same windows; then the table-mode edge cases of
    ``bench_partition``.  Returns the three table-mode kernel entries."""
    from lightgbm_tpu_torch import bench_grow_step as bg
    from lightgbm_tpu_torch import bench_partition as bp
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.ops import seg
    from lightgbm_tpu_torch.ops.split import best_split
    from lightgbm_tpu_torch.quantize import hist_acc_scales

    n, f = ds.bins.shape
    b = ds.max_bin_padded
    obj = create_objective("binary", ds.label, dev)
    score = torch.full((n,), obj.boost_from_score(), dtype=torch.float32, device=dev)
    grad, hess = obj.get_gradients(score)
    bins_fn = torch.as_tensor(np.ascontiguousarray(ds.bins.T), device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    rows = seg.pack_rows(bins_fn, grad, hess, ones)
    hist = seg.seg_hist(rows, 0, n, b)
    tot = hist[0].sum(0).tolist()
    ck = best_split(hist, *tot, torch.as_tensor(ds.num_bins(), device=dev),
                    torch.as_tensor(ds.nan_bins(), device=dev),
                    torch.ones(f, dtype=torch.bool, device=dev), lambda_l1=0.0,
                    lambda_l2=0.0, min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3,
                    min_gain_to_split=0.0,
                    bundle_end=torch.as_tensor(ds.bundle_layout.bundle_end_array(b), device=dev))
    if ck.table is None:
        raise AssertionError("efb: the root's best split is not on a bundle plane")
    print(f"efb kernels: the root's split is plane {ck.feature} (members "
          f"{len(ds.bundle_layout.planes[ck.feature])}) at plane bin {ck.bin}, "
          f"{int((~ck.table).sum())} of {b} bins right")
    members = efb_members(ds, ck)
    out = {}
    for where, name in (("root", "partition_table"), ("K=4", "partition_batch_table")):
        table, thresh, twin = members[where]
        entry = partition_entry(name, rows, table, f"{where} of the efb table, table mode",
                                plain_reps=3)
        res = bp.run_case(f"{where} threshold", rows, thresh, {"wrapper": bp.wrapper_launch},
                          reps=20)
        tw = bp.run_case(f"{where} threshold's table", rows, twin, {"wrapper": bp.wrapper_launch},
                         reps=20)
        entry.update(threshold_ms=res["wrapper"], threshold_device_ms=res["wrapper device"],
                     threshold_table_ms=tw["wrapper"], threshold_table_device_ms=tw["wrapper device"])
        print(f"kernel {name}: threshold mode on the same windows {res['wrapper']:.4f} ms "
              f"(device {res['wrapper device']:.4f} ms), the same split by its table "
              f"{tw['wrapper']:.4f} ms (device {tw['wrapper device']:.4f} ms)")
        out[name] = entry
    scales = hist_acc_scales(grad, hess, ones)
    wrapper = {"wrapper": bg.this_launcher()}
    step = {}
    for mode, qs in (("int8", scales), ("f32", None)):
        for where in ("root", "K=4"):
            table, thresh, twin = members[where]
            for kind, mem in (("table", table), ("threshold", thresh),
                              ("threshold's table", twin)):
                res = bg.run_case(f"efb {where} {mode} {kind}", rows, mem, b, qs, wrapper, reps=20,
                                  plain_reps=3 if kind == "table" and where == "root" else 0)
                repeatable(res, qs, f"efb {where} {mode} {kind}")
                step[mode, where, kind] = res
                print(f"kernel fused_grow_step {mode} {kind} mode, {where} of the efb table "
                      f"(windows {mem[:, :2].tolist()}): dec and every column equal to the plain "
                      f"version, histogram {'bit-equal' if qs is not None else 'within f32_tol, the same bits on two calls'}; "
                      f"{res['wrapper']:.4f} ms (device {res['wrapper device']:.4f} ms), bound "
                      f"{res['bound']:.5f} ms, pair {res['pair']:.4f} ms, composite "
                      f"{res['composite']:.4f} ms")
    r = step["int8", "root", "table"]
    entry = kernel_entry("fused_grow_step_table", 0.0, r["wrapper"], r["plain"],
                         bound_ms(2 * n * (f + 16) + f * b * 12), r["composite"])
    entry.update(device_ms=r["wrapper device"], launches_per_call=r["wrapper ops"],
                 pair_ms=r["pair"], f32_ms=step["f32", "root", "table"]["wrapper"],
                 f32_device_ms=step["f32", "root", "table"]["wrapper device"],
                 threshold_ms=step["int8", "root", "threshold"]["wrapper"],
                 threshold_device_ms=step["int8", "root", "threshold"]["wrapper device"],
                 threshold_table_device_ms=step["int8", "root", "threshold's table"][
                     "wrapper device"],
                 k4_ms=step["int8", "K=4", "table"]["wrapper"],
                 k4_device_ms=step["int8", "K=4", "table"]["wrapper device"],
                 k4_threshold_ms=step["int8", "K=4", "threshold"]["wrapper"],
                 library_call="composite: stable torch.sort of the go-left keys, index_select "
                 "of every column, copy_ back, index_add_ of the child's i32 digit rows")
    out["fused_grow_step_table"] = entry
    nb = ds.num_bins()
    for cname, mem in bp.table_edge_cases(n, nb).items():
        bp.run_case(cname, rows, mem, {"wrapper": bp.wrapper_launch}, reps=0, timed=False)
        for q in (scales, None):
            repeatable(bg.run_case(cname, rows, mem, b, q, wrapper, reps=0, timed=False), q, cname)
        print(f"kernel table-mode edge case {cname}: windows {mem[:, :2].tolist()}: partition and "
              "fused step (int8, f32) exact")
    del rows
    torch.cuda.empty_cache()
    return out


def repeatable(res, qs, where) -> None:
    """An f32 fused step must give the same bits on two calls
    (``bench_grow_step.run_case`` records it for each build)."""
    if qs is None and res.get("wrapper repeatable") != 1.0:
        raise AssertionError(f"fused_grow_step {where}: f32 sums differ between two calls")


def conflict_rows(x, layout) -> np.ndarray:
    """[N] bool: rows with two nonzero members in one bundle plane."""
    out = np.zeros(x.shape[0], bool)
    for lo in range(0, x.shape[0], 1 << 16):
        blk = x[lo:lo + (1 << 16)]
        for feats in layout.planes:
            if len(feats) > 1:
                out[lo:lo + len(blk)] |= (blk[:, feats] != 0).sum(1) >= 2
    return out


def efb_phase(lt, _build, dev):
    """Exclusive Feature Bundling on the card at the efb table's shape.
    Returns (the table-mode kernel entries, {phase: kernel launches})."""
    from lightgbm_tpu_torch.ops import grower

    t_phase = time.perf_counter()
    x, y = make_efb_data(EFB_ROWS)
    t1 = time.perf_counter()
    ds = lt.Dataset(x, y, params=PARAMS).construct()
    lay = ds.bundle_layout
    if lay is None:
        raise AssertionError("efb: nothing bundled")
    print(f"efb data: {EFB_ROWS} x {x.shape[1]} one-hot columns of {len(EFB_LEVELS)} variables "
          f"{list(EFB_LEVELS)} (Zipf s = {EFB_ZIPF}) made in {t1 - t_phase:.1f} s; constructed "
          f"in {time.perf_counter() - t1:.1f} s, the bundle search {ds.bundle_check_s:.2f} s of it; "
          f"{len(ds.used_features)} used columns in {ds.num_planes} planes of "
          f"{lay.plane_bins} bins (members {[len(p) for p in lay.planes]})")
    kernels = check_efb_kernels(ds, dev)
    phases = {}
    runs = {}
    for name, params in (("efb", PARAMS), ("efb-batch", BATCH_PARAMS)):
        _build.LAUNCHES.clear()
        booster, losses, train_s, setup_s = train_rounds(lt, params, ds, EFB_ROUNDS)
        phases[name] = launches = dict(_build.LAUNCHES)
        runs[name] = len(losses) / train_s
        EFB_RESULTS[name] = (runs[name], losses)
        print(f"{name}: leaf_batch {params.get('leaf_batch', 1)}: hist_mode {booster.hist_mode!r}, "
              f"{len(booster.trees)} trees of {[t.num_leaves for t in booster.trees]} leaves, "
              f"{runs[name]:.3f} iterations/s (set-up {setup_s:.1f} s)")
        print(f"{name}: training log-loss per round " + " ".join(f"{v:.6f}" for v in losses))
        print(f"{name}: near-tie f32 refines per tree {booster.refine_counts}; bundle-plane "
              f"splits per tree {[int(t.split_is_cat.sum()) for t in booster.trees]}")
        print(f"{name}: kernel launches {json.dumps(launches)}")
        if booster.hist_mode != "seg" or not falls(losses, EFB_ROUNDS):
            raise AssertionError(f"{name}: layout {booster.hist_mode!r}, or the log-loss did not "
                                 "fall every round")
        require_launches(launches, ("fused_grow_step", "fused_grow_step_table", "seg_hist_int8"),
                         f"{name} path")
        if launches.get("split_scan", 0) or launches.get("split_scan_batch", 0):
            raise AssertionError(f"{name}: the split-scan kernel decided a bundled leaf")
        if name == "efb":
            efb_predict_and_text(lt, booster, x, y, losses[-1], lay)
        profile_iteration(booster, f"{name} profile")
        del booster

    # the two-launch path: the partition kernel's table mode at K = 1 and 4
    for name, params in (("efb-off", OFF_PARAMS), ("efb-batch-off", BATCH_OFF_PARAMS)):
        _build.LAUNCHES.clear()
        ob, losses, train_s, _ = train_rounds(lt, params, ds, EFB_OFF_ROUNDS)
        phases[name] = launches = dict(_build.LAUNCHES)
        print(f"{name}: {len(losses) / train_s:.3f} iterations/s, log-loss per round "
              + " ".join(f"{v:.6f}" for v in losses) + f"; kernel launches {json.dumps(launches)}")
        want = "partition_table" if name == "efb-off" else "partition_batch_table"
        require_launches(launches, (want, "seg_hist"), f"{name} path")
        if not falls(losses, EFB_OFF_ROUNDS):
            raise AssertionError(f"{name}: log-loss did not fall every round")
        del ob

    # card vs CPU on the first rows, int8 accumulation on both
    xs, ys = x[:PARITY_ROWS].copy(), y[:PARITY_ROWS].copy()
    pr = {}
    grower.INT8_ON_CPU = True
    try:
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            pr[d] = lt.train(PARAMS, lt.Dataset(xs, ys, params=PARAMS), PARITY_ROUNDS, device=d)
            print(f"efb-parity: {d} trained {PARITY_ROUNDS} rounds in "
                  f"{time.perf_counter() - t0:.1f} s ({pr[d].hist_mode}, "
                  f"{pr[d].train_set.num_planes} planes), refines per tree {pr[d].refine_counts}")
    finally:
        grower.INT8_ON_CPU = False
    share = split_share(pr["cuda"], pr["cpu"])
    lc, lp = pr["cuda"].train_loss(), pr["cpu"].train_loss()
    print(f"efb-parity: {share:.4f} of splits identical, log-loss cuda {lc:.7f} cpu {lp:.7f}")
    if share < 0.95 or abs(lc - lp) > 1e-4 * abs(lp):
        raise AssertionError("efb-parity: card and CPU training disagree")
    del pr, xs, ys, ds

    # the same rows unbundled: 700 columns take the ordered layout
    spent = time.perf_counter() - t_phase
    flat_rows = EFB_ROWS if spent <= EFB_BUDGET_S else EFB_FLAT_CUT_ROWS
    if flat_rows != EFB_ROWS:
        print(f"efb-flat: the phase has taken {spent:.0f} s > {EFB_BUDGET_S:.0f} s: the unbundled "
              f"run is cut to its first {flat_rows} rows")
    flat = {**PARAMS, "enable_bundle": False}
    t0 = time.perf_counter()
    fds = lt.Dataset(x[:flat_rows], y[:flat_rows], params=flat).construct()
    print(f"efb-flat: enable_bundle=False, {flat_rows} rows constructed in "
          f"{time.perf_counter() - t0:.1f} s, {fds.num_planes} columns")
    del x
    _build.LAUNCHES.clear()
    fb, losses, train_s, setup_s = train_rounds(lt, flat, fds, EFB_FLAT_ROUNDS)
    phases["efb-flat"] = launches = dict(_build.LAUNCHES)
    print(f"efb-flat: hist_mode {fb.hist_mode!r}, {len(losses) / train_s:.3f} iterations/s (set-up "
          f"{setup_s:.1f} s) against the bundled {runs['efb']:.3f} at {EFB_ROWS} rows; log-loss "
          "per round " + " ".join(f"{v:.6f}" for v in losses)
          + f"; kernel launches {json.dumps(launches)}")
    if fb.hist_mode != "ordered" or not falls(losses, EFB_FLAT_ROUNDS):
        raise AssertionError("efb-flat: not the ordered layout, or the log-loss did not fall")
    del fb, fds
    torch.cuda.empty_cache()
    print(f"efb: phase {time.perf_counter() - t_phase:.1f} s")
    return kernels, phases


def efb_predict_and_text(lt, booster, x, y, train_loss, lay):
    """Predict of the efb rows against the training score, then the model
    saved and read back: its real-space predict may differ from the bundled
    predict only on rows with two nonzero members in one plane."""
    t0 = time.perf_counter()
    raw = booster.predict(x, raw_score=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    score = booster.score.double().cpu().numpy()
    err = float(np.max(np.abs(raw - score) / np.maximum(np.abs(score), 1.0)))
    p = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1 - 1e-15)
    loss = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    print(f"efb: predict {len(x) / pred_s:.0f} rows/s through the plain walker with tables; raw "
          f"scores vs the training score max relative |diff| {err:.3g}, log-loss {loss:.7f} vs "
          f"training {train_loss:.7f}")
    if err > 1e-5 or abs(loss - train_loss) > 1e-5 * train_loss:
        raise AssertionError("efb: predict disagrees with the training score")
    text = booster.model_to_string()
    loaded = lt.Booster(model_str=text, device="cuda")
    real = loaded.predict(x, raw_score=True)
    differ = np.abs(real - raw) > 1e-5 * np.maximum(np.abs(raw), 1.0)
    conflict = conflict_rows(x, lay)
    print(f"efb: the model read back from its text ({len(text)} bytes) walks real values: "
          f"{int(differ.sum())} rows differ from the bundled predict, {int(conflict.sum())} rows "
          f"have two nonzero members in one plane, {int((differ & ~conflict).sum())} rows "
          "differ without one")
    if (differ & ~conflict).any():
        raise AssertionError("efb: the real-space predict differs on a row without a conflict")


def make_cat_data(n_rows: int, seed: int = 42):
    """The cat phases' table: ``make_efb_data``'s draws in its order (the
    same codes and labels), each variable's codes kept as one f64 column."""
    rng = np.random.default_rng(seed)
    x = np.zeros((n_rows, len(EFB_LEVELS)))
    z = rng.normal(size=n_rows)
    for i, levels in enumerate(EFB_LEVELS):
        p = 1.0 / np.arange(1, levels + 1) ** EFB_ZIPF
        codes = rng.choice(levels, size=n_rows, p=p / p.sum())
        x[:, i] = codes
        z += rng.normal(size=levels)[codes]
    y = (rng.random(n_rows) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return x, y


def kept_rows(ds, x) -> np.ndarray:
    """[N] bool: rows whose every categorical value is a kept category.
    Training bins a cut category (the 99% cut) at bin 0, predict sends it
    right (lightgbm_tpu/binning.py:420-433 against boosting/gbdt.py:
    3118-3129), so only these rows' predictions equal the training score."""
    keep = np.ones(len(x), bool)
    for j in ds.used_features:
        m = ds.bin_mappers[j]
        if m.is_categorical:
            keep &= np.isin(x[:, j].astype(np.int64), m.bin_to_cat)
    return keep


def cat_predict_and_text(lt, booster, ds, x, y, what, card):
    """Predict against the training score on the rows of kept categories,
    then the model text read back on the card (real-space walk) against
    the Booster's predict on every row."""
    t0 = time.perf_counter()
    pred = booster.predict(x)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    keep = kept_rows(ds, x)
    score = booster.score.double().cpu().numpy()
    p = np.clip(pred[keep], 1e-15, 1 - 1e-15)
    yk = y[keep]
    loss = float(-np.mean(yk * np.log(p) + (1 - yk) * np.log(1 - p)))
    ps = np.clip(1.0 / (1.0 + np.exp(-score[keep])), 1e-15, 1 - 1e-15)
    train = float(-np.mean(yk * np.log(ps) + (1 - yk) * np.log(1 - ps)))
    print(f"{what}: predict {len(x) / pred_s:.0f} rows/s; on the {int(keep.sum())} rows of kept "
          f"categories ({int((~keep).sum())} rows hold a category past the 99% cut, which "
          f"training bins at bin 0 and predict sends right) log-loss {loss:.7f} vs the training "
          f"score's {train:.7f} [{card}]")
    if abs(loss - train) > 1e-5 * train:
        raise AssertionError(f"{what}: predict disagrees with the training score")
    text = booster.model_to_string()
    loaded = lt.Booster(model_str=text, device="cuda")
    real = loaded.predict(x)
    diff = float(np.abs(real - pred).max())
    print(f"{what}: the model read back from its text ({len(text)} bytes, "
          f"{text.count('cat_threshold=')} trees with categorical nodes) walks real values on "
          f"the card: max |diff| {diff:.3g} from the Booster's predict")
    if diff > 1e-6:
        raise AssertionError(f"{what}: the model text predicts other values")


def check_cat_walk(booster, x, dev):
    """The walk kernel on the cat forest (categorical nodes) against the
    plain walker, bit for bit, with the bins predict gives it; timed beside
    the same trees with every categorical node made numeric (the numeric
    mode on the same shape)."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.predict import predict_bins_leaves

    tables = booster._walk_tables()
    if not isinstance(tables, fw.ForestTables) or not tables.m_cat:
        raise AssertionError("cat: the forest does not take the walk kernel's categorical mode")
    bins = booster._bin_type(booster._bin_host(x))
    sk = fw.forest_walk(bins, tables, 1)
    sp = fw.forest_walk_plain(bins, tables, 1)
    err = float((sk - sp).abs().max())
    if not torch.equal(sk, sp):
        raise AssertionError(f"forest_walk_cat: scores differ from the plain walker's (max "
                             f"|err| {err})")
    leaves = predict_bins_leaves(fw.decode_tables(tables), bins)
    depth = torch.as_tensor(np.stack([_leaf_depths(t, int(tables.m_leaves))
                                      for t in booster.trees]), device=dev)
    visits = float(depth[torch.arange(len(booster.trees), device=dev)[None, :], leaves].sum())
    n, f = bins.shape
    entry = with_device(kernel_entry(
        "forest_walk_cat", err, time_ms(lambda: fw.forest_walk(bins, tables, 1)),
        time_ms(lambda: fw.forest_walk_plain(bins, tables, 1), reps=3),
        bound_ms(n * f + tables.tables.numel() * 4 + n * 4, ops=visits), None,
    ), lambda: fw.forest_walk(bins, tables, 1))
    recs = []
    for t in booster.trees:
        r = dict(t.record())
        r["split_is_cat"] = np.zeros(len(r["split_feature"]), bool)
        r["split_bin"] = np.full(len(r["split_feature"]), 3, np.int32)
        recs.append(r)
    numeric = fw.build_tables(recs, booster.nan_bins, dev)
    entry["numeric_twin_ms"] = time_ms(lambda: fw.forest_walk(bins, numeric, 1))
    entry["cat_nodes"] = int(sum(t.num_cat for t in booster.trees))
    print(f"kernel forest_walk_cat: {len(booster.trees)} trees, {entry['cat_nodes']} categorical "
          f"nodes ({tables.m_cat} bitsets a tree at most), scores bit-equal to the plain walker, "
          f"{visits / (n * len(booster.trees)):.3f} node visits a row-tree; {entry['ms']:.4f} ms "
          f"against {entry['numeric_twin_ms']:.4f} ms for the same trees with every node numeric "
          f"(threshold bin 3), plain {entry['plain_ms']:.4f} ms")
    return entry


def wide_table_members(n, nb, b):
    """Members of the wide-table checks on the cat-wide rows: the root and
    K=4 windows (the second one empty, none on a tile boundary), each split
    by a table on a 300-level column with bits set past bin 256; beside
    them the same windows by the tables cut to their first 256 bins (the
    parameter path).  {name: (wide members, 256-bin members)}."""
    from lightgbm_tpu_torch.ops import seg

    wide_f = [j for j in range(len(nb)) if nb[j] > seg.TABLE_BINS]
    bins = np.arange(b)
    tabs = [((bins * (3 + i)) % 7 < 3) & (bins < nb[wide_f[i % len(wide_f)]]) for i in range(4)]
    root = ([0], [n], [wide_f[0]], [0], [0], [-1])
    k4 = ([37, n // 4 + 5, n // 4 + 5, n // 2 + 1001], [n // 4 - 100, 0, n // 4 - 900,
                                                         n // 2 - 2000],
          [wide_f[i % len(wide_f)] for i in range(4)], [0] * 4, [0] * 4, [-1] * 4)
    out = {}
    for name, cols, tables in (("root", root, tabs[:1]), ("K=4", k4, tabs)):
        out[name] = (seg.split_members(*cols, [1] * len(tables), tables),
                     seg.split_members(*cols, [1] * len(tables),
                                       [t[:seg.TABLE_BINS] for t in tables]))
        if out[name][0].shape[1] <= seg.MEMBER_COLS:
            raise AssertionError("cat-wide: the checks' tables do not pass 256 bins")
    return out


def check_wide_table_kernels(ds, dev):
    """The partition and the fused step (int8 and f32) with tables past 256
    bins on the cat-wide rows (u16), through the wrappers, against their
    plain versions (``bench_partition.run_case`` / ``bench_grow_step.
    run_case``: nl, dec and every column of the rows exactly, int8
    histograms bit-equal, f32 ones within f32_tol and the same bits on two
    calls), at the root and on K=4 windows, each timed beside the 256-bin
    table mode on the same windows.  Returns the three wide-table entries."""
    from lightgbm_tpu_torch import bench_grow_step as bg
    from lightgbm_tpu_torch import bench_partition as bp
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.ops import seg
    from lightgbm_tpu_torch.quantize import hist_acc_scales

    n, f = ds.bins.shape
    b = ds.max_bin_padded
    nb = ds.num_bins()
    obj = create_objective("binary", ds.label, dev)
    score = torch.full((n,), obj.boost_from_score(), dtype=torch.float32, device=dev)
    grad, hess = obj.get_gradients(score)
    wide = torch.as_tensor(ds.bins.astype(np.int32), device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    rows = seg.pack_rows(seg.byte_planes(wide.T), grad, hess, ones, wide=True,
                         used_bins=int(nb.max()))
    del wide
    members = wide_table_members(n, nb, b)
    out = {}
    for where, name in (("root", "partition_wtable"), ("K=4", "partition_batch_wtable")):
        wmem, nmem = members[where]
        entry = partition_entry(name, rows, wmem, f"{where} of the cat-wide rows, tables past "
                                "256 bins", plain_reps=3)
        res = bp.run_case(f"{where} 256-bin tables", rows, nmem, {"wrapper": bp.wrapper_launch},
                          reps=20)
        entry.update(table256_ms=res["wrapper"], table256_device_ms=res["wrapper device"])
        print(f"kernel {name}: the same windows by 256-bin tables {res['wrapper']:.4f} ms "
              f"(device {res['wrapper device']:.4f} ms)")
        out[name] = entry
    scales = hist_acc_scales(grad, hess, ones)
    wrapper = {"wrapper": bg.this_launcher()}
    step = {}
    for mode, qs in (("int8", scales), ("f32", None)):
        for where in ("root", "K=4"):
            for kind, mem in zip(("wide", "256-bin"), members[where]):
                res = bg.run_case(f"cat-wide {where} {mode} {kind}", rows, mem, b, qs, wrapper,
                                  reps=10, plain_reps=3 if kind == "wide" and where == "root"
                                  else 0)
                repeatable(res, qs, f"cat-wide {where} {mode} {kind}")
                step[mode, where, kind] = res
                print(f"kernel fused_grow_step {mode} {kind} tables, {where} of the cat-wide rows "
                      f"(windows {mem[:, :2].tolist()}): dec and every column equal to the plain "
                      f"version, histogram {'bit-equal' if qs is not None else 'within f32_tol, the same bits on two calls'}; "
                      f"{res['wrapper']:.4f} ms (device {res['wrapper device']:.4f} ms), bound "
                      f"{res['bound']:.5f} ms, composite {res['composite']:.4f} ms")
    r = step["int8", "root", "wide"]
    entry = kernel_entry("fused_grow_step_wtable", 0.0, r["wrapper"], r["plain"],
                         bound_ms(2 * n * (2 * f + 16) + f * b * 12), r["composite"])
    entry.update(device_ms=r["wrapper device"], launches_per_call=r["wrapper ops"],
                 f32_ms=step["f32", "root", "wide"]["wrapper"],
                 table256_ms=step["int8", "root", "256-bin"]["wrapper"],
                 table256_device_ms=step["int8", "root", "256-bin"]["wrapper device"],
                 k4_ms=step["int8", "K=4", "wide"]["wrapper"],
                 k4_table256_ms=step["int8", "K=4", "256-bin"]["wrapper"],
                 library_call="composite: stable torch.sort of the go-left keys, index_select "
                 "of every column, copy_ back, index_add_ of the child's i32 digit rows")
    out["fused_grow_step_wtable"] = entry
    del rows
    torch.cuda.empty_cache()
    return out


def cat_phases(lt, _build, dev, card):
    """Categorical features on the card: cat (the efb table's variables as
    8 categorical columns, max_bin 255: the fused step's table mode, the
    walk's categorical nodes), cat-wide (max_bin 1023: tables past 256
    bins, the two-launch path too) and cat-parity (card against CPU).
    Returns (kernel entries, {phase: kernel launches})."""
    from lightgbm_tpu_torch.ops import grower

    t_phase = time.perf_counter()
    x, y = make_cat_data(EFB_ROWS)
    cats = list(range(len(EFB_LEVELS)))
    kernels, phases = {}, {}
    for wide in (False, True):
        base = CAT_WIDE_PARAMS if wide else PARAMS
        t0 = time.perf_counter()
        ds = lt.Dataset(x, y, params=base, categorical_feature=cats).construct()
        tag = "cat-wide" if wide else "cat"
        print(f"{tag} data: {EFB_ROWS} x {x.shape[1]} categorical columns ({list(EFB_LEVELS)} "
              f"levels, Zipf s = {EFB_ZIPF}, the efb table's draws) at max_bin "
              f"{base['max_bin']}, constructed in {time.perf_counter() - t0:.1f} s: bins per "
              f"column {ds.num_bins().tolist()}, {ds.max_bin_padded} padded [{card}]")
        if wide:
            if int(ds.num_bins().max()) <= 256:
                raise AssertionError("cat-wide: no column keeps more than 255 categories")
            kernels.update(check_wide_table_kernels(ds, dev))
            runs = (("cat-wide", CAT_WIDE_PARAMS, CAT_WIDE_ROUNDS),
                    ("cat-wide-batch", {**BATCH_PARAMS, "max_bin": 1023}, CAT_WIDE_BATCH_ROUNDS),
                    ("cat-wide-off", {**OFF_PARAMS, "max_bin": 1023}, CAT_WIDE_OFF_ROUNDS),
                    ("cat-wide-batch-off", {**BATCH_OFF_PARAMS, "max_bin": 1023},
                     CAT_WIDE_OFF_ROUNDS))
        else:
            runs = (("cat", PARAMS, CAT_ROUNDS), ("cat-batch", BATCH_PARAMS, CAT_BATCH_ROUNDS))
        for name, params, rounds in runs:
            _build.LAUNCHES.clear()
            booster, losses, train_s, setup_s = train_rounds(lt, params, ds, rounds)
            if name in ("cat", "cat-wide"):
                cat_predict_and_text(lt, booster, ds, x, y, name, card)
            phases[name] = launches = dict(_build.LAUNCHES)
            rate = len(losses) / train_s
            efb = EFB_RESULTS.get(name.replace("cat", "efb"))
            print(f"{name}: leaf_batch {params.get('leaf_batch', 1)}, grow_fused "
                  f"{params.get('grow_fused', 'auto')!r}: hist_mode {booster.hist_mode!r}, "
                  f"{len(booster.trees)} trees of {[t.num_leaves for t in booster.trees]} "
                  f"leaves, {rate:.3f} iterations/s (set-up {setup_s:.1f} s)"
                  + (f" against efb's {efb[0]:.3f} one-hot coded" if efb else "")
                  + f" [{card}]")
            print(f"{name}: training log-loss per round " + " ".join(f"{v:.6f}" for v in losses)
                  + ("; efb's " + " ".join(f"{v:.6f}" for v in efb[1][:len(losses)])
                     if efb else "") + f" [{card}]")
            print(f"{name}: categorical splits per tree {[t.num_cat for t in booster.trees]}, "
                  f"refines per tree {booster.refine_counts}")
            print(f"{name}: kernel launches {json.dumps(launches)}")
            if booster.hist_mode != "seg" or not falls(losses, rounds):
                raise AssertionError(f"{name}: layout {booster.hist_mode!r}, or the log-loss did "
                                     "not fall every round")
            if not all(t.num_cat > 0 for t in booster.trees):
                raise AssertionError(f"{name}: a tree has no categorical split")
            if launches.get("split_scan", 0) or launches.get("split_scan_batch", 0):
                raise AssertionError(f"{name}: the split-scan kernel decided a categorical leaf")
            fused = params.get("grow_fused", "auto") != "off"
            batch = params.get("leaf_batch", 1) > 1
            want = (["fused_grow_step", "fused_grow_step_table", "seg_hist_int8"] if fused
                    else ["partition_batch_table" if batch else "partition_table", "seg_hist"])
            if name == "cat":
                want.append("forest_walk_cat")
            require_launches(launches, want, f"{name} path")
            if name == "cat":
                kernels["forest_walk_cat"] = check_cat_walk(booster, x, dev)
                profile_iteration(booster, "cat profile")
            del booster
        if wide:
            wt = {k: sum(ph.get(k, 0) for n_, ph in phases.items() if n_.startswith("cat-wide"))
                  for k in ("fused_grow_step_wtable", "partition_wtable",
                            "partition_batch_wtable")}
            print(f"cat-wide: launches with tables past 256 bins {json.dumps(wt)}")
            require_launches(wt, list(wt), "cat-wide paths")
        del ds

    # card vs CPU on the first rows, int8 accumulation on both
    xs, ys = x[:PARITY_ROWS].copy(), y[:PARITY_ROWS].copy()
    pr = {}
    grower.INT8_ON_CPU = True
    try:
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            pr[d] = lt.train(PARAMS, lt.Dataset(xs, ys, params=PARAMS, categorical_feature=cats),
                             PARITY_ROUNDS, device=d)
            print(f"cat-parity: {d} trained {PARITY_ROUNDS} rounds in "
                  f"{time.perf_counter() - t0:.1f} s, refines per tree {pr[d].refine_counts}")
    finally:
        grower.INT8_ON_CPU = False
    share = split_share(pr["cuda"], pr["cpu"])
    lc, lp = pr["cuda"].train_loss(), pr["cpu"].train_loss()
    print(f"cat-parity: {share:.4f} of splits identical, log-loss cuda {lc:.7f} cpu {lp:.7f} "
          f"[{card}]")
    if share < 0.95 or abs(lc - lp) > 1e-4 * abs(lp):
        raise AssertionError("cat-parity: card and CPU training disagree")
    torch.cuda.empty_cache()
    print(f"cat: phases {time.perf_counter() - t_phase:.1f} s [{card}]")
    return kernels, phases


def check_xla_exp(dev):
    """The binary objective's exp on the card against the CPU, bit for bit,
    on a dense sweep of f32 (its clamp ends and flush to 0 included)."""
    from lightgbm_tpu_torch.objectives import xla_exp

    x = torch.linspace(-89.0, 89.0, 4_000_001, dtype=torch.float32)
    cpu = xla_exp(x).view(torch.int32)
    card = xla_exp(x.to(dev)).view(torch.int32).cpu()
    differ = int((cpu != card).sum())
    print(f"xla_exp: card vs CPU on {len(x)} points of [-89, 89]: {differ} differ")
    if differ:
        raise AssertionError("xla_exp: the card's exp differs from the CPU's")


def falls(losses, rounds) -> bool:
    return len(losses) == rounds and all(b < a for a, b in zip(losses, losses[1:]))


def check_u16_kernels(dev):
    """The u16 modes of rows 1, 2, 5 and 6 on synthetic rows made on the
    card (1,048,576 x 28 at a padded width of 1,024): the run_u16 cases and
    edge cases of the three benches through the public wrappers, each
    case's times beside the u8 mode on the same windows; the kernel entries
    of the root (K=4 for the batched partition).  Raises on a difference."""
    from lightgbm_tpu_torch import bench_grow_step as bg
    from lightgbm_tpu_torch import bench_partition as bp
    from lightgbm_tpu_torch import bench_seg_hist as bs
    from lightgbm_tpu_torch.ops import seg

    t0 = time.perf_counter()
    hist = bs.run_u16({"this": bs.this_launcher()}, ROWS, 20, dev, kernels=False, plain_reps=3)
    part = bp.run_u16({"this": bp.this_launcher()}, ROWS, 20, dev, kernels=False, plain_reps=3)
    step = bg.run_u16({"this": bg.this_launcher()}, ROWS, 20, dev, kernels=False, plain_reps=3)
    # the f32 histogram's largest |error| against the plain version at the root
    rows, _ = bp.synthetic_rows_u16(ROWS, FEATURES, dev)
    err = float((seg.seg_hist(rows, 0, ROWS, WIDEBIN_BINS)
                 - seg.seg_hist_plain(rows, 0, ROWS, WIDEBIN_BINS)).abs().max())
    del rows
    torch.cuda.empty_cache()
    kernels = {}
    for name, res, err_k, lib in (
            ("seg_hist_u16", hist["u16 root f32"], err, "library"),
            ("seg_hist_int8_u16", hist["u16 root int8"], 0.0, "library"),
            ("partition_u16", part["u16 root"], 0.0, "composite"),
            ("partition_batch_u16", part["u16 K=4"], 0.0, "composite"),
            ("fused_grow_step_u16", step["u16 root int8"], 0.0, "composite")):
        entry = kernel_entry(name, err_k, res["this"], res["plain"], (res["bound"], "bytes"),
                             res[lib])
        entry.update({"device_ms": res["this device"], "launches_per_call": res["this ops"],
                      "u8_ms": res["u8"], "u8_device_ms": res["u8 device"],
                      "shape": f"{ROWS} x {FEATURES} at {WIDEBIN_BINS} bins (u16)"})
        kernels[name] = entry
        print(f"kernel {name}: root{' K=4' if 'batch' in name else ''} {res['this']:.4f} ms "
              f"[device {res['this device']:.4f}] against the u8 mode's {res['u8']:.4f} "
              f"[{res['u8 device']:.4f}] on the same windows, bound {res['bound']:.5f} ms, plain "
              f"{res['plain']:.4f} ms, {lib} {res[lib]:.4f} ms, max |err| {err_k:.3g}")
    print(f"kernels u16: checked and timed in {time.perf_counter() - t0:.1f} s")
    return kernels


def check_ordered_u16_kernels(dev):
    """The u16 mode of rows 7 and 8 on synthetic bins made on the card
    (``bench_ordered.run_u16``: 1,048,576 x 700 at 1,024 bins on the root,
    K=2, 14,000 rows, K=4 x 14,000 and 4,000 rows beside the u8 mode on the
    same windows, the roots of 1,048,576 x 28 at 8,192 and 16,384 bins,
    then the edge cases) through the public wrappers: f32 within
    ``ordered_tol`` and the same bits on two calls, int8 bit-equal.  The
    kernel entries of the 1,024-bin root.  Raises on a difference."""
    from lightgbm_tpu_torch import bench_ordered

    t0 = time.perf_counter()
    res = bench_ordered.run_u16(WIDE_ROWS, dev, reps=20, plain_reps=3, features=WIDE_FEATURES)
    root = res["root"]
    kernels = {}
    for name, mode in (("ordered_hist_u16", "f32"), ("ordered_hist_int8_u16", "int8")):
        entry = kernel_entry(name, root["f32 max err"] if mode == "f32" else 0.0, root[mode],
                             root[f"{mode} plain"], (root["bound"], "bytes"),
                             root[f"index_add_ {mode}"])
        entry.update({
            "device_ms": root[f"{mode} device"], "u8_device_ms": root[f"u8 {mode} device"],
            "shape": f"{WIDE_ROWS} x {WIDE_FEATURES} at {bench_ordered.U16_BINS} bins (u16), root",
            "cases_device_ms": {case: r[f"{mode} device"] for case, r in res.items()},
            "cases_u8_device_ms": {case: r[f"u8 {mode} device"] for case, r in res.items()
                                   if f"u8 {mode} device" in r},
            "cases_index_add_ms": {case: r[f"index_add_ {mode}"] for case, r in res.items()},
            "cases_bound_ms": {case: r["bound"] for case, r in res.items()},
        })
        kernels[name] = entry
        print(f"kernel {name}: root {root[mode]:.4f} ms [device {root[f'{mode} device']:.4f}] "
              f"against the u8 mode's [{root[f'u8 {mode} device']:.4f}] on the same windows, "
              f"bound {root['bound']:.5f} ms, plain {root[f'{mode} plain']:.4f} ms, index_add_ "
              f"{root[f'index_add_ {mode}']:.4f} ms")
    print(f"kernels ordered u16: checked and timed in {time.perf_counter() - t0:.1f} s")
    return kernels


def widebin_phase(lt, _build, main_profile):
    """The Higgs shape at max_bin 1023 on the card (the u16 modes on the main
    path).  Returns {phase: kernel launches}."""
    from lightgbm_tpu_torch.ops import grower

    t_phase = time.perf_counter()
    x, y = make_data(ROWS, FEATURES)
    t0 = time.perf_counter()
    ds = lt.Dataset(x, y, params=WIDEBIN_PARAMS).construct()
    nb = ds.num_bins()
    print(f"widebin data: {ROWS} x {FEATURES} (Higgs shape, rows cut from 11,000,000, "
          f"{WIDEBIN_ROUNDS} rounds) binned at max_bin 1023 in {time.perf_counter() - t0:.1f} s: {ds.bins.dtype} bins, "
          f"{int(nb.min())}-{int(nb.max())} bins a feature, {ds.max_bin_padded} histogram bins")
    if ds.max_bin_padded != WIDEBIN_BINS or ds.bins.dtype != np.uint16:
        raise AssertionError("widebin: the bins are not the u16 mode's")
    phases = {}

    # -- no path parameters, K = 1
    _build.LAUNCHES.clear()
    booster, losses, train_s, setup_s = train_rounds(lt, WIDEBIN_PARAMS, ds, WIDEBIN_ROUNDS)
    phases["widebin"] = launches = dict(_build.LAUNCHES)
    rate = len(losses) / train_s
    print(f"widebin: hist_mode {booster.hist_mode!r}, {len(booster.trees)} trees of "
          f"{[t.num_leaves for t in booster.trees]} leaves, {rate:.3f} iterations/s (set-up "
          f"{setup_s:.1f} s)")
    print("widebin: training log-loss per round " + " ".join(f"{v:.6f}" for v in losses))
    print(f"widebin: near-tie f32 refines per tree {booster.refine_counts}")
    print(f"widebin: kernel launches {json.dumps(launches)}")
    if booster.hist_mode != "seg" or not falls(losses, WIDEBIN_ROUNDS):
        raise AssertionError(f"widebin: layout {booster.hist_mode!r}, or the log-loss did not "
                             "fall every round")
    require_launches(launches, ("fused_grow_step_u16", "seg_hist_int8_u16", "seg_hist_u16"),
                     "widebin path")
    if launches.get("split_scan", 0) or launches.get("split_scan_batch", 0):
        raise AssertionError("widebin: the split-scan kernel decided a leaf past 256 bins")
    t0 = time.perf_counter()
    raw = booster.predict(x, raw_score=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    score = booster.score.double().cpu().numpy()
    err = float(np.max(np.abs(raw - score) / np.maximum(np.abs(score), 1.0)))
    print(f"widebin: predict {ROWS / pred_s:.0f} rows/s through the plain walker; raw scores vs "
          f"the training score max relative |diff| {err:.3g}")
    if err > 1e-5:
        raise AssertionError("widebin: predict disagrees with the training score")
    t0 = time.perf_counter()
    text = booster.model_to_string()
    loaded = lt.Booster(model_str=text, device="cuda")
    real = loaded.predict(x, raw_score=True)
    diff = float(np.max(np.abs(real - raw) / np.maximum(np.abs(raw), 1e-6)))
    print(f"widebin: the model text ({len(text)} bytes) read back and predicted in real space in "
          f"{time.perf_counter() - t0:.1f} s: max relative |diff| {diff:.3g} from the booster's")
    if not np.allclose(real, raw, rtol=1e-6, atol=1e-6):
        raise AssertionError("widebin: the model read back predicts otherwise")
    del loaded, real, raw, score
    prof = profile_iteration(booster, "widebin profile")
    print(f"widebin: {prof['launches a split']:.1f} CUDA launches a split and "
          f"{prof['best_split calls']} best_split calls a tree against the main phase's "
          f"{main_profile['launches a split']:.1f} and {main_profile['best_split calls']} at "
          "max_bin 255")
    del booster

    # -- bench.py's _PARAMS at max_bin 1023 (K = 4)
    _build.LAUNCHES.clear()
    params = {**BATCH_PARAMS, "max_bin": 1023}
    bb, losses, train_s, _ = train_rounds(lt, params, ds, WIDEBIN_BATCH_ROUNDS)
    phases["widebin-batch"] = launches = dict(_build.LAUNCHES)
    print(f"widebin-batch: leaf_batch 4, min_data_in_leaf 100: {len(losses) / train_s:.3f} "
          f"iterations/s, log-loss per round " + " ".join(f"{v:.6f}" for v in losses)
          + f"; grow steps per tree {bb.grow_steps}, effective K {bb.leaf_batch_effective}")
    print(f"widebin-batch: kernel launches {json.dumps(launches)}")
    if not falls(losses, WIDEBIN_BATCH_ROUNDS):
        raise AssertionError("widebin-batch: log-loss did not fall every round")
    require_launches(launches, ("fused_grow_step_u16", "seg_hist_int8_u16"), "widebin batched path")
    del bb

    # -- the two-launch path at K = 1 and K = 4
    for name, base, want in (("widebin-off", OFF_PARAMS, "partition_u16"),
                             ("widebin-batch-off", BATCH_OFF_PARAMS, "partition_batch_u16")):
        _build.LAUNCHES.clear()
        ob, losses, train_s, _ = train_rounds(lt, {**base, "max_bin": 1023}, ds,
                                              WIDEBIN_OFF_ROUNDS)
        phases[name] = launches = dict(_build.LAUNCHES)
        print(f"{name}: {len(losses) / train_s:.3f} iterations/s, log-loss per round "
              + " ".join(f"{v:.6f}" for v in losses) + f"; kernel launches {json.dumps(launches)}")
        require_launches(launches, (want, "seg_hist_u16"), f"{name} path")
        if not falls(losses, WIDEBIN_OFF_ROUNDS):
            raise AssertionError(f"{name}: log-loss did not fall every round")
        if launches.get("fused_grow_step", 0) or launches.get("seg_hist_int8", 0):
            raise AssertionError(f"{name}: the two-launch path went through the fused step or int8")
        del ob
    del ds, x, y

    # -- card vs CPU on 65,536 rows, int8 accumulation on both
    xs, ys = make_data(PARITY_ROWS, FEATURES, seed=7)
    pr = {}
    grower.INT8_ON_CPU = True
    try:
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            pr[d] = lt.train(WIDEBIN_PARAMS, lt.Dataset(xs, ys, params=WIDEBIN_PARAMS),
                             PARITY_ROUNDS, device=d)
            print(f"widebin-parity: {d} trained {PARITY_ROUNDS} rounds in "
                  f"{time.perf_counter() - t0:.1f} s ({pr[d].hist_mode}, {pr[d]._max_bin} bins), "
                  f"refines per tree {pr[d].refine_counts}")
    finally:
        grower.INT8_ON_CPU = False
    share = split_share(pr["cuda"], pr["cpu"])
    lc, lp = pr["cuda"].train_loss(), pr["cpu"].train_loss()
    print(f"widebin-parity: {share:.4f} of splits identical, log-loss cuda {lc:.7f} cpu {lp:.7f}")
    if share < 0.95 or abs(lc - lp) > 1e-4 * abs(lp):
        raise AssertionError("widebin-parity: card and CPU training disagree")
    del pr
    torch.cuda.empty_cache()
    print(f"widebin: phase {time.perf_counter() - t_phase:.1f} s")
    return phases


def wide_data(lt):
    """(x, y, the binned Dataset) of the Expo-shaped table."""
    t0 = time.perf_counter()
    x, y = make_wide_data(WIDE_ROWS, WIDE_FEATURES)
    t1 = time.perf_counter()
    ds = lt.Dataset(x, y, params=PARAMS).construct()
    print(f"wide data: {WIDE_ROWS} x {WIDE_FEATURES} made in {t1 - t0:.1f} s, binned in "
          f"{time.perf_counter() - t1:.1f} s; {len(ds.used_features)} used features, "
          f"{int(ds.num_bins().min())}-{int(ds.num_bins().max())} bins a feature, "
          f"{ds.max_bin_padded} histogram bins; the bundle search took "
          f"{ds.bundle_check_s:.2f} s (no bundle: every column has NaNs)")
    return x, y, ds


def wide_phases(lt, _build, dev):
    """The ordered layout at the Expo shape.  Returns (kernel entries of the
    two ordered histograms, {phase: kernel launches})."""
    from lightgbm_tpu_torch.ops.forest_walk import ForestTables

    x, y, ds = wide_data(lt)
    kernels = check_ordered_kernels(*wide_kernel_inputs(ds, dev))
    phases = {}

    # -- no path parameters: the layout rule must pick the ordered layout
    _build.LAUNCHES.clear()
    wb, losses, train_s, setup_s = train_rounds(lt, PARAMS, ds, WIDE_ROUNDS)
    t0 = time.perf_counter()
    raw = wb.predict(x, raw_score=True)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    phases["wide"] = launches = dict(_build.LAUNCHES)
    print(f"wide: hist_mode resolved to {wb.hist_mode!r}; {len(wb.trees)} trees of "
          f"{[t.num_leaves for t in wb.trees]} leaves, {len(losses) / train_s:.4f} iterations/s "
          f"(set-up {setup_s:.1f} s), predict {len(x) / pred_s:.0f} rows/s")
    print("wide: training log-loss per round " + " ".join(f"{v:.6f}" for v in losses))
    print(f"wide: kernel launches {json.dumps(launches)}")
    if wb.hist_mode != "ordered":
        raise AssertionError(f"wide: the layout rule picked {wb.hist_mode!r}, not 'ordered'")
    if not falls(losses, WIDE_ROUNDS):
        raise AssertionError("wide: training log-loss did not fall every round")
    require_launches(launches, ("ordered_hist", "split_scan"), "wide path")
    seg = {k: launches[k] for k in SEG_KERNELS + ("ordered_hist_int8", "forest_walk")
           if launches.get(k)}
    if seg:
        raise AssertionError(f"wide path launched kernels of another path: {seg}")
    if isinstance(wb._walk_tables(), ForestTables):
        raise AssertionError(f"wide: predict went through the walk kernel at {WIDE_FEATURES} features")
    score = wb.score.double().cpu().numpy()
    err = float(np.max(np.abs(raw - score) / np.maximum(np.abs(score), 1.0)))
    if raw.shape != (WIDE_ROWS,) or not np.all(np.isfinite(raw)) or err > 1e-5:
        raise AssertionError(f"wide: predict is off the training score by {err:.3g} (relative)")
    predict_stats(wb, x, "wide")
    bins = wb._bins_nf[:, :WIDE_FEATURES]
    walk_ms = time_ms(lambda: wb.predict_raw_bins(bins), reps=3, warmup=1)
    print(f"wide: predict through the plain walker matches the training score (max relative "
          f"|diff| {err:.3g}); the walker alone on the binned rows {walk_ms:.1f} ms "
          f"({WIDE_ROWS / walk_ms * 1e3:.0f} rows/s): the rest of predict is the host's "
          "conversion of the values and the device binning")
    del bins
    profile_iteration(wb, "wide profile")
    del wb, raw, score

    # -- frontier batching, K = 4
    _build.LAUNCHES.clear()
    bb, losses, train_s, setup_s = train_rounds(lt, BATCH_PARAMS, ds, WIDE_BATCH_ROUNDS)
    phases["wide-batch"] = launches = dict(_build.LAUNCHES)
    splits = sum(t.num_leaves - 1 for t in bb.trees)
    print(f"wide-batch: leaf_batch 4, min_data_in_leaf 100: {len(losses) / train_s:.4f} "
          f"iterations/s (set-up {setup_s:.1f} s), log-loss per round "
          + " ".join(f"{v:.6f}" for v in losses))
    print(f"wide-batch: grow steps per tree {bb.grow_steps}, effective K {bb.leaf_batch_effective}, "
          "commit rate " + " ".join(f"{r:.3f}" for r in bb.commit_rates)
          + f"; {splits} splits in {sum(bb.grow_steps)} steps")
    print(f"wide-batch: kernel launches {json.dumps(launches)}")
    if not falls(losses, WIDE_BATCH_ROUNDS):
        raise AssertionError("wide-batch: training log-loss did not fall every round")
    require_launches(launches, ("ordered_hist", "ordered_hist:K>1", "split_scan_batch"),
                     "wide batched path")
    del bb

    # -- quantized training on the int8 kernel
    _build.LAUNCHES.clear()
    qb, losses, train_s, setup_s = train_rounds(lt, QUANT_PARAMS, ds, WIDE_QUANT_ROUNDS)
    phases["wide-quant"] = launches = dict(_build.LAUNCHES)
    print(f"wide-quant: use_quantized_grad, 4 bins, hist_method 'pallas_int8': "
          f"{len(losses) / train_s:.4f} iterations/s (set-up {setup_s:.1f} s), log-loss per "
          "round " + " ".join(f"{v:.6f}" for v in losses))
    print(f"wide-quant: kernel launches {json.dumps(launches)}")
    if not falls(losses, WIDE_QUANT_ROUNDS):
        raise AssertionError("wide-quant: training log-loss did not fall every round")
    require_launches(launches, ("ordered_hist_int8", "split_scan"), "wide quantized path")
    if launches.get("ordered_hist", 0):
        raise AssertionError("wide-quant: the f32 ordered histogram launched")
    del qb, ds

    # -- card vs CPU on the first rows, f32 and quantized
    xs, ys = x[:WIDE_PARITY_ROWS].copy(), y[:WIDE_PARITY_ROWS].copy()
    del x
    for name, params in (("f32", PARAMS), ("quantized", QUANT_PARAMS)):
        runs = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[d] = lt.train(params, lt.Dataset(xs, ys, params=params), WIDE_PARITY_ROUNDS,
                               device=d)
            print(f"wide-parity {name}: {d} trained {WIDE_PARITY_ROUNDS} rounds in "
                  f"{time.perf_counter() - t0:.1f} s ({runs[d].hist_mode})")
        share = split_share(runs["cuda"], runs["cpu"])
        lc, lp = runs["cuda"].train_loss(), runs["cpu"].train_loss()
        print(f"wide-parity {name}: {share:.4f} of splits identical, log-loss cuda {lc:.7f} "
              f"cpu {lp:.7f}")
        if share < 0.95 or abs(lc - lp) > 1e-4 * abs(lp):
            raise AssertionError(f"wide-parity {name}: card and CPU training disagree")
    return kernels, phases


def wide_u16_phase(lt, _build):
    """The Expo shape at max_bin 1023 on the ordered layout's u16 mode.
    Returns {phase: kernel launches}."""
    import warnings

    t_phase = time.perf_counter()
    x, y = make_wide_data(WIDE_U16_ROWS, WIDE_FEATURES, seed=43, grid=WIDE_U16_GRID)
    t0 = time.perf_counter()
    ds = lt.Dataset(x, y, params=WIDE_U16_PARAMS).construct()
    nb = ds.num_bins()
    print(f"wide-u16 data: {WIDE_U16_ROWS} x {WIDE_FEATURES} normals on a grid of "
          f"1/{WIDE_U16_GRID}, 2% NaN (Expo shape, rows cut from 11,000,000) binned at max_bin "
          f"1023 in {time.perf_counter() - t0:.1f} s: {ds.bins.dtype} bins, "
          f"{int(nb.min())}-{int(nb.max())} bins a feature, {ds.max_bin_padded} histogram bins")
    if ds.max_bin_padded != WIDEBIN_BINS or ds.bins.dtype != np.uint16:
        raise AssertionError("wide-u16: the bins are not the u16 mode's")
    phases = {}

    # -- no path parameters: the rule must pick the ordered layout, f32
    _build.LAUNCHES.clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wb, losses, train_s, setup_s = train_rounds(lt, WIDE_U16_PARAMS, ds, WIDE_U16_ROUNDS)
    phases["wide-u16"] = launches = dict(_build.LAUNCHES)
    rule = [str(w.message) for w in caught if "segment-resident" in str(w.message)]
    print(f"wide-u16: the layout rule's warning: {rule[0] if rule else None}")
    print(f"wide-u16: hist_mode {wb.hist_mode!r}, {len(wb.trees)} trees of "
          f"{[t.num_leaves for t in wb.trees]} leaves, {len(losses) / train_s:.4f} iterations/s "
          f"(set-up {setup_s:.1f} s)")
    print("wide-u16: training log-loss per round " + " ".join(f"{v:.6f}" for v in losses))
    print(f"wide-u16: kernel launches {json.dumps(launches)}")
    if wb.hist_mode != "ordered" or not rule or not falls(losses, WIDE_U16_ROUNDS):
        raise AssertionError(f"wide-u16: layout {wb.hist_mode!r} (warning {bool(rule)}), or the "
                             "log-loss did not fall every round")
    require_launches(launches, ("ordered_hist_u16",), "wide-u16 path")
    other = {k: launches[k] for k in SEG_KERNELS + U16_KERNELS + ("ordered_hist_int8",)
             if launches.get(k)}
    if other:
        raise AssertionError(f"wide-u16 launched kernels of another path: {other}")
    t0 = time.perf_counter()
    raw = wb.predict(x, raw_score=True)
    pred_s = time.perf_counter() - t0
    score = wb.score.double().cpu().numpy()
    err = float(np.max(np.abs(raw - score) / np.maximum(np.abs(score), 1.0)))
    print(f"wide-u16: predict {len(x) / pred_s:.0f} rows/s through the plain walker; raw scores "
          f"vs the training score max relative |diff| {err:.3g}")
    if raw.shape != (WIDE_U16_ROWS,) or not np.all(np.isfinite(raw)) or err > 1e-5:
        raise AssertionError("wide-u16: predict disagrees with the training score")
    del wb, raw, score

    # -- quantized training on the int8 kernel's u16 mode, the same rows
    _build.LAUNCHES.clear()
    qparams = {**QUANT_PARAMS, "max_bin": 1023}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the rule's warning, printed above
        qb, losses, train_s, setup_s = train_rounds(lt, qparams, ds, WIDE_U16_ROUNDS)
    phases["wide-u16-quant"] = launches = dict(_build.LAUNCHES)
    print(f"wide-u16-quant: use_quantized_grad, 4 bins, hist_method 'pallas_int8', {WIDE_U16_ROWS} rows: "
          f"{len(losses) / train_s:.4f} iterations/s (set-up {setup_s:.1f} s), log-loss per round "
          + " ".join(f"{v:.6f}" for v in losses) + f"; kernel launches {json.dumps(launches)}")
    if qb.hist_mode != "ordered" or not falls(losses, WIDE_U16_ROUNDS):
        raise AssertionError("wide-u16-quant: not the ordered layout, or the log-loss did not fall")
    require_launches(launches, ("ordered_hist_int8_u16",), "wide-u16 quantized path")
    if launches.get("ordered_hist_u16", 0) or launches.get("ordered_hist", 0):
        raise AssertionError("wide-u16-quant: the f32 ordered histogram launched")
    del qb, ds

    # -- card vs CPU on the first rows for WIDE_PARITY_ROUNDS: quantized (exact
    # int8 sums: the same trees), then f32, whose sums the card adds in
    # another order
    xs, ys = x[:WIDE_U16_PARITY_ROWS].copy(), y[:WIDE_U16_PARITY_ROWS].copy()
    del x, y
    for name, params, loss_tol in (("quantized", qparams, 1e-4),
                                   ("f32", WIDE_U16_PARAMS, WIDE_U16_F32_LOSS_TOL)):
        runs = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for d in ("cuda", "cpu"):
                t0 = time.perf_counter()
                runs[d] = lt.train(params, lt.Dataset(xs, ys, params=params),
                                   WIDE_PARITY_ROUNDS, device=d)
                print(f"wide-u16-parity {name}: {d} trained {WIDE_PARITY_ROUNDS} rounds in "
                      f"{time.perf_counter() - t0:.1f} s ({runs[d].hist_mode}, "
                      f"{runs[d]._max_bin} bins)")
        share = split_share(runs["cuda"], runs["cpu"])
        lc, lp = runs["cuda"].train_loss(), runs["cpu"].train_loss()
        first = first_difference(runs["cuda"], runs["cpu"])
        print(f"wide-u16-parity {name}: {share:.4f} of splits identical, log-loss cuda {lc:.7f} "
              f"cpu {lp:.7f}; first differing split: {first}")
        if abs(lc - lp) > loss_tol * abs(lp):
            raise AssertionError(f"wide-u16-parity {name}: card and CPU log-loss disagree")
        if name == "quantized" and share < 0.95:
            raise AssertionError("wide-u16-parity quantized: card and CPU trees disagree")
        # f32: the card adds a window's rows in chunks, so its sums differ from
        # the CPU's row order in the last bits; the trees may part only at a
        # near tie, where the two chosen splits' gains agree within 1e-5
        if first is not None and abs(first["gain cuda"] - first["gain cpu"]) > 1e-5 * max(
                abs(first["gain cpu"]), 1e-12):
            raise AssertionError(f"wide-u16-parity {name}: the trees part at a split that is not "
                                 "a near tie")
        del runs
    torch.cuda.empty_cache()
    print(f"wide-u16: phase {time.perf_counter() - t_phase:.1f} s")
    return phases



# ---------------------------------------------------------------- sampling
# the sampling phases (the Higgs rows of the main phase): scen_bagging's
# sampling parameters, scen_goss's, and feature_fraction_bynode at bench.py's
# batch parameters (tests/golden/scen_*.params.json)
BAG_PARAMS = {**PARAMS, "bagging_fraction": 0.7, "bagging_freq": 1, "feature_fraction": 0.8}
GOSS_PARAMS = {**PARAMS, "boosting": "goss", "top_rate": 0.2, "other_rate": 0.1,
               "learning_rate": 0.15}
BYNODE_PARAMS = {**BATCH_PARAMS, "feature_fraction_bynode": 0.5}
SAMPLING_ROUNDS = 10
BYNODE_ROUNDS = 3
# in-bag share at a refresh: bagging within 0.002 of its fraction (4 sigma
# at 1,048,576 rows), GOSS at least 0.95 of top_rate + other_rate
BAG_SHARE_TOL = 0.002
# card vs CPU: GOSS at learning rate 0.5 (a warm-up of 2 iterations, so 3
# rounds sample once); every run quantized with stochastic rounding on the
# int8 histogram (hist_method='pallas_int8') as well
PARITY_GOSS_PARAMS = {**GOSS_PARAMS, "learning_rate": 0.5}
# the sampling-wide phase: MSLR-WEB30K's 136 features (binary labels on
# normals on a grid of 1/32: the port has no ranking objective), rows cut
# to 262,144
SAMPLING_WIDE_ROWS = 1 << 18
SAMPLING_WIDE_FEATURES = 136
SAMPLING_WIDE_ROUNDS = 3
# the live kernel check: F = 242 (the seg layout's widest table), half the
# features dead, feature 0 live
LIVE_SEED = 5


def live_features(f: int, seed: int = LIVE_SEED) -> np.ndarray:
    """Feature 0 and f / 2 - 1 others drawn from a seed: half the features
    live, spread over every group of 32."""
    rng = np.random.default_rng(seed)
    rest = rng.choice(np.arange(1, f), f // 2 - 1, replace=False)
    return np.sort(np.concatenate([[0], rest])).astype(np.int32)


def check_live_kernels(dev):
    """The live mode of the segment histogram (f32 and int8) and of the
    fused grow step at F = 242 on synthetic rows (``bench_partition
    .synthetic_rows``), half the features dead: at the root and on the K=4
    windows of ``bench_partition.cases``, the live features' cells bit-equal
    to the all-live call's, the dead ones' 0, and the same bits on a second
    call; against the plain version with the same live list (counts exact,
    int8 bit-equal, f32 within ``_bench.f32_tol``); the fused step's dec
    and rows equal to the all-live call's.  Times (event and device) of the
    live and the all-live call, the plain version's, ``index_add_`` of the
    live features' rows, and the bound of the live planes' bytes.  Returns
    the three kernel entries."""
    from lightgbm_tpu_torch import _bench
    from lightgbm_tpu_torch import bench_partition as bp
    from lightgbm_tpu_torch import bench_seg_hist as bs
    from lightgbm_tpu_torch.ops import grow_step, seg

    n, f, b = ROWS, bp.WIDE_FEATURES, 256
    rows, nb = bp.synthetic_rows(n, f, dev)
    live = live_features(f)
    live_t = torch.as_tensor(live, device=dev).long()
    dead_t = torch.as_tensor(np.setdiff1d(np.arange(f), live), device=dev).long()
    nl = len(live)
    qs = bs.int8_scales(rows)
    members = {"root": bp.cases(n, nb)["root"], "K=4": bp.cases(n, nb)["K=4"]}
    out = {}
    print(f"live: F = {f}, {nl} live features (feature 0 and {nl - 1} drawn from seed "
          f"{LIVE_SEED}), {(nl + 31) // 32} of {(f + 31) // 32} groups of 32 run")

    def held(what, got, full, again, plain, tol):
        if not torch.equal(got[:, live_t], full[:, live_t]):
            raise AssertionError(f"{what}: live cells differ from the all-live call")
        if bool(got[:, dead_t].any()):
            raise AssertionError(f"{what}: a dead feature's cell is not 0")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two live calls differ")
        if not torch.equal(got[..., 2], plain[..., 2]):
            raise AssertionError(f"{what}: counts differ from the plain version")
        err = (got[..., :2] - plain[..., :2]).abs()
        if tol is None and not torch.equal(got, plain):
            raise AssertionError(f"{what}: int8 histogram differs from the plain version")
        if tol is not None and bool((err > tol).any()):
            raise AssertionError(f"{what}: f32 off the plain version by {float(err.max())}")
        return float(err.max())

    for name, q in (("seg_hist_live", None), ("seg_hist_int8_live", qs)):
        res = {}
        for where, mem in members.items():
            wins = [(int(s), int(c)) for s, c in mem[:, :2]]
            full = seg.seg_hist_batch(rows, wins, b, q)
            got = seg.seg_hist_batch(rows, wins, b, q, live=live)
            again = seg.seg_hist_batch(rows, wins, b, q, live=live)
            plain = seg.seg_hist_batch_plain(rows, wins, b, q, live)
            tol = None if q is not None else _bench.f32_tol(rows, wins, b, plain[..., 2:3])
            err = held(f"{name} {where}", got, full, again, plain, tol)
            del full, again, plain, tol
            torch.cuda.empty_cache()
            call = lambda: seg.seg_hist_batch(rows, wins, b, q, live=live)  # noqa: E731
            call_all = lambda: seg.seg_hist_batch(rows, wins, b, q)  # noqa: E731
            sub = seg.SegRows(rows.bins[live_t], rows.g, rows.h, rows.m, rows.ridx)
            lib = bs.library_call(sub, wins, b, q)
            r = {"ms": time_ms(call), "all ms": time_ms(call_all),
                 "device": _bench.device_ms(call), "all device": _bench.device_ms(call_all),
                 "plain": time_ms(lambda: seg.seg_hist_batch_plain(rows, wins, b, q, live),
                                  reps=1, warmup=0),
                 "library": time_ms(lib, reps=5), "err": err,
                 "bound": bound_ms(sum(c for _, c in wins) * (nl + 12) + len(wins) * f * b * 12)}
            del sub, lib
            torch.cuda.empty_cache()
            res[where] = r
            print(f"kernel {name} {where} {wins}: live {r['ms']:.4f} ms (device "
                  f"{r['device']:.4f}) against all live {r['all ms']:.4f} ms (device "
                  f"{r['all device']:.4f}), bound {r['bound'][0]:.5f} ms (the live planes), plain "
                  f"{r['plain']:.4f} ms, index_add_ of the live features {r['library']:.4f} ms; "
                  "live cells bit-equal to the all-live call, dead cells 0, the same bits on "
                  "two calls, " + ("bit-equal to the plain version" if q is not None else
                                   f"within f32_tol of the plain version (max |err| {err:.3g})"))
        r, r4 = res["root"], res["K=4"]
        entry = kernel_entry(name, r["err"], r["ms"], r["plain"], r["bound"], r["library"])
        entry.update(device_ms=r["device"], all_live_ms=r["all ms"],
                     all_live_device_ms=r["all device"], k4_ms=r4["ms"],
                     k4_device_ms=r4["device"], k4_all_live_device_ms=r4["all device"],
                     live_features=nl, features=f,
                     library_call="index_add_ of the live features' rows into a [K, F, B] table")
        out[name] = entry

    res = {}
    for mode, q in (("int8", qs), ("f32", None)):
        for where, mem in members.items():
            work = bp._clone_rows(rows)
            restore = lambda: bp._copy_rows(work, rows)  # noqa: E731
            full = grow_step.fused_grow_step(work, *seg.member_args(mem)[0], b, quant_scales=q)
            full_rows = bp._clone_rows(work)
            restore()
            got = grow_step.fused_grow_step(work, *seg.member_args(mem)[0], b, quant_scales=q,
                                            live=live)
            if not bp.same_rows(work, full_rows) or not all(
                    torch.equal(a, c) for a, c in zip(got[:4], full[:4])):
                raise AssertionError(f"fused_grow_step live {mode} {where}: dec or rows differ "
                                     "from the all-live call")
            restore()
            again = grow_step.fused_grow_step(work, *seg.member_args(mem)[0], b, quant_scales=q,
                                              live=live)
            restore()
            dec_p, plain = grow_step.fused_grow_step_plain(work, mem, b, q, live)
            if not bp.same_rows(work, full_rows) or not torch.equal(
                    dec_p, torch.stack(got[:4], 1)):
                raise AssertionError(f"fused_grow_step live {mode} {where}: dec or rows differ "
                                     "from the plain version")
            wins = [(int(s), int(c)) for s, c in dec_p[:, 2:4].tolist()]
            tol = None if q is not None else _bench.f32_tol(work, wins, b, plain[..., 2:3])
            err = held(f"fused_grow_step live {mode} {where}", got[4], full[4], again[4], plain,
                       tol)
            del full, full_rows, again, plain, tol
            call = lambda: grow_step.fused_grow_step(  # noqa: E731
                work, *seg.member_args(mem)[0], b, quant_scales=q, live=live)
            call_all = lambda: grow_step.fused_grow_step(  # noqa: E731
                work, *seg.member_args(mem)[0], b, quant_scales=q)
            r = {"ms": _bench.time_ms(call, setup=restore),
                 "all ms": _bench.time_ms(call_all, setup=restore),
                 "device": _bench.device_ms(call, setup=restore),
                 "all device": _bench.device_ms(call_all, setup=restore),
                 "plain": _bench.time_ms(lambda: grow_step.fused_grow_step_plain(
                     work, mem, b, q, live), reps=1, warmup=0, setup=restore),
                 "err": err,
                 "bound": bound_ms(2 * int(mem[:, 1].sum()) * (f + 16)
                                   + sum(c for _, c in wins) * (nl + 12) + len(wins) * f * b * 12)}
            res[mode, where] = r
            print(f"kernel fused_grow_step_live {mode} {where} (windows {mem[:, :2].tolist()}): "
                  f"live {r['ms']:.4f} ms (device {r['device']:.4f}) against all live "
                  f"{r['all ms']:.4f} ms (device {r['all device']:.4f}), bound "
                  f"{r['bound'][0]:.5f} ms, plain {r['plain']:.4f} ms; dec and rows equal to the "
                  "all-live call and the plain version, live cells bit-equal to the all-live "
                  "call, dead cells 0, the same bits on two calls")
            del work
            torch.cuda.empty_cache()
    r = res["int8", "root"]
    entry = kernel_entry("fused_grow_step_live", r["err"], r["ms"], r["plain"], r["bound"], None)
    entry.update(device_ms=r["device"], all_live_ms=r["all ms"], all_live_device_ms=r["all device"],
                 f32_device_ms=res["f32", "root"]["device"],
                 f32_all_live_device_ms=res["f32", "root"]["all device"],
                 k4_device_ms=res["int8", "K=4"]["device"],
                 k4_all_live_device_ms=res["int8", "K=4"]["all device"],
                 live_features=nl, features=f)
    out["fused_grow_step_live"] = entry
    del rows
    torch.cuda.empty_cache()
    return out


def sampling_phases(lt, _build, ds, main_rate, card):
    """Bagging, GOSS and feature_fraction_bynode on the main phase's rows
    (see the top).  Returns the kernel launches of each run."""
    phases = {}
    # yardsticks in this phase (host-bound rates drift between phases): the
    # main and batch parameters, unsampled
    near = {}
    for label, params, rounds in (("main", PARAMS, SAMPLING_ROUNDS),
                                  ("batch", BATCH_PARAMS, BYNODE_ROUNDS)):
        bst, losses, secs, _ = train_rounds(lt, params, ds, rounds)
        near[label] = len(losses) / secs
        steps = bst.grow_steps
        del bst
    print(f"sampling: unsampled yardsticks in this phase: main parameters {near['main']:.3f}, "
          f"batch parameters {near['batch']:.3f} iterations/s (grow steps per tree {steps}; "
          f"the main phase's {main_rate:.3f}) [{card}]")
    for label, params, rounds in (("bag", BAG_PARAMS, SAMPLING_ROUNDS),
                                  ("goss", GOSS_PARAMS, SAMPLING_ROUNDS),
                                  ("bynode", BYNODE_PARAMS, BYNODE_ROUNDS)):
        _build.LAUNCHES.clear()
        bst, losses, secs, _ = train_rounds(lt, params, ds, rounds)
        launches = dict(_build.LAUNCHES)
        phases["sampling-" + label] = launches
        rate = len(losses) / secs
        yard = near["batch" if label == "bynode" else "main"]
        print(f"sampling {label}: {len(bst.trees)} trees, {rate:.3f} iterations/s against "
              f"{yard:.3f} unsampled in this phase ({rate / yard:.3f}x) [{card}]")
        print(f"sampling {label}: training log-loss per round "
              + " ".join(f"{v:.6f}" for v in losses) + f" [{card}]")
        print(f"sampling {label}: in-bag share at each fresh mask (iteration, share) "
              f"{[(i, round(s, 6)) for i, s in bst.bag_shares]}; refines per tree "
              f"{bst.refine_counts}; grow steps per tree {bst.grow_steps}, effective K "
              f"{bst.leaf_batch_effective}, commit rate "
              + " ".join(f"{r:.3f}" for r in bst.commit_rates))
        print(f"sampling {label}: kernel launches {json.dumps(launches)}")
        if len(losses) != rounds or not falls(losses, rounds):
            raise AssertionError(f"sampling {label}: log-loss did not fall every round")
        if label == "bag":
            if len(bst.bag_shares) != rounds or any(
                    abs(s - params["bagging_fraction"]) > BAG_SHARE_TOL for _, s in bst.bag_shares):
                raise AssertionError("sampling bag: an in-bag share is off 0.7 by more than "
                                     f"{BAG_SHARE_TOL}")
            require_launches(launches, ("fused_grow_step_live", "seg_hist_int8_live"),
                             "sampling bag")
        if label == "goss":
            warm = int(1.0 / params["learning_rate"])
            least = (params["top_rate"] + params["other_rate"]) * 0.95
            if len(bst.bag_shares) != rounds - warm or any(s < least for _, s in bst.bag_shares):
                raise AssertionError(f"sampling goss: {rounds - warm} sampled iterations, each "
                                     f"with an in-bag share of at least {least}")
        if label == "bynode":
            require_launches(launches, ("split_scan_batch", "fused_grow_step"), "sampling bynode")
        del bst
    return phases


def sampling_parity(lt, ds, card):
    """Card against CPU: the samplers' masks and gradients from the same
    keys (bit-equal), stochastic quantize_gradients on the main phase's
    1,048,576 gradients (bit-equal), then 3 rounds of bag and of goss at
    65,536 x 28, int8 on both (>= 0.95 of splits identical, log-loss within
    1e-4 relative)."""
    from lightgbm_tpu_torch import random as rnd
    from lightgbm_tpu_torch.boosting.sampling import create_sample_strategy
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.ops import grower
    from lightgbm_tpu_torch.quantize import quantize_gradients

    dev = torch.device("cuda")
    n = ds.num_data
    obj = create_objective("binary", ds.label, dev)
    score = torch.full((n,), obj.boost_from_score(), dtype=torch.float32, device=dev)
    score += torch.randn(n, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    grad, hess = obj.get_gradients(score)
    key = rnd.prng_key(0)
    for label, params in (("bag", BAG_PARAMS), ("goss", PARITY_GOSS_PARAMS)):
        cfg = Config.from_params(params)
        on = {d: create_sample_strategy(cfg, n, d, ds.label) for d in ("cuda", "cpu")}
        for it in range(6):
            key, sub = rnd.split(key)
            got = {d: s.sample(it, grad.to(d), hess.to(d), sub) for d, s in on.items()}
            for a, c in zip(got["cuda"], got["cpu"]):
                if not torch.equal(a.cpu(), c):
                    raise AssertionError(f"sampling-parity {label}: iteration {it}'s mask or "
                                         "gradients differ between the card and the CPU")
        print(f"sampling-parity {label}: masks and reweighted gradients of 6 iterations "
              f"({n} rows) bit-equal on the card and the CPU")
    qk = quantize_gradients(grad, hess, 4, key=key)
    qc = quantize_gradients(grad.cpu(), hess.cpu(), 4, key=key)
    if not all(torch.equal(a.cpu(), c) for a, c in zip(qk, qc)):
        raise AssertionError("sampling-parity: stochastic quantize_gradients differs between "
                             "the card and the CPU")
    print(f"sampling-parity: stochastic quantize_gradients of the {n} main-phase gradients "
          "bit-equal on the card and the CPU")
    del grad, hess, score, qk, qc

    xs, ys = make_data(PARITY_ROWS, FEATURES, seed=7)
    quant = {"use_quantized_grad": True, "hist_method": "pallas_int8"}
    grower.INT8_ON_CPU = True
    try:
        for label, params in (("bag", BAG_PARAMS), ("goss", PARITY_GOSS_PARAMS),
                              ("bag quantized", {**BAG_PARAMS, **quant}),
                              ("goss quantized", {**PARITY_GOSS_PARAMS, **quant})):
            runs = {}
            for d in ("cuda", "cpu"):
                t0 = time.perf_counter()
                runs[d] = lt.train(params, lt.Dataset(xs, ys, params=params),
                                   SAMPLING_PARITY_ROUNDS, device=d)
                secs = time.perf_counter() - t0
            share = split_share(runs["cuda"], runs["cpu"])
            lc, lp = runs["cuda"].train_loss(), runs["cpu"].train_loss()
            # bagging's masks do not depend on the scores, so the two runs
            # draw the same ones; GOSS's follow |g * h|, whose last bits
            # follow the card's f32 sums
            shares = [runs[d].bag_shares for d in ("cuda", "cpu")]
            print(f"sampling-parity {label}: {share:.4f} of splits identical, log-loss cuda "
                  f"{lc:.7f} cpu {lp:.7f} [{card}]; in-bag shares cuda {shares[0]}, cpu "
                  f"{shares[1]} (CPU run {secs:.1f} s)")
            if share < 0.95 or abs(lc - lp) > 1e-4 * abs(lp) or (
                    label.startswith("bag") and shares[0] != shares[1]):
                raise AssertionError(f"sampling-parity {label}: card and CPU disagree")
    finally:
        grower.INT8_ON_CPU = False


def sampling_wide_phase(lt, _build, card):
    """The sampling-wide phase (see the top): 3 rounds at feature_fraction
    0.5 and 3 at 1.0 on 262,144 x 136, their rates and one profiled
    iteration each (the trees' lane-histogram device time).  Returns the
    launches of the feature_fraction run."""
    x, y = make_wide_data(SAMPLING_WIDE_ROWS, SAMPLING_WIDE_FEATURES)
    t0 = time.perf_counter()
    ds = lt.Dataset(x, y, params=PARAMS).construct()
    print(f"sampling-wide: {SAMPLING_WIDE_ROWS} x {SAMPLING_WIDE_FEATURES} binned in "
          f"{time.perf_counter() - t0:.1f} s, {ds.num_planes} planes")
    out = {}
    for ff in (0.5, 1.0):
        _build.LAUNCHES.clear()
        bst, losses, secs, _ = train_rounds(lt, {**PARAMS, "feature_fraction": ff}, ds,
                                            SAMPLING_WIDE_ROUNDS)
        launches = dict(_build.LAUNCHES)
        if bst.hist_mode != "seg":
            raise AssertionError(f"sampling-wide: layout {bst.hist_mode}, not seg")
        prof = profile_iteration(bst, f"sampling-wide ff {ff} profile")
        print(f"sampling-wide feature_fraction {ff}: {len(losses) / secs:.3f} iterations/s, "
              f"log-loss per round " + " ".join(f"{v:.6f}" for v in losses)
              + f"; profiled tree: lane histograms {prof['hist device ms']:.3f} ms device, "
              f"{prof['wall ms']:.1f} ms wall [{card}]")
        print(f"sampling-wide feature_fraction {ff}: kernel launches {json.dumps(launches)}")
        if not falls(losses, SAMPLING_WIDE_ROUNDS):
            raise AssertionError(f"sampling-wide {ff}: log-loss did not fall every round")
        if ff < 1.0:
            require_launches(launches, ("fused_grow_step_live", "seg_hist_int8_live"),
                             "sampling-wide")
            out["sampling-wide"] = launches
        elif any(k.endswith("_live") for k in launches):
            raise AssertionError("sampling-wide: a live-mode launch with every feature live")
        del bst
    return out


def multiclass_labels(x, classes: int, seed: int = MULTI_SEED) -> np.ndarray:
    """A ``classes``-class label of rows x made from ``seed``: the class of
    the largest of ``classes`` seeded projections of the first 8 columns
    plus unit normal noise (learnable, every class present)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(8, classes))
    z = np.nan_to_num(x[:, :8]) @ w + rng.normal(size=(len(x), classes))
    return np.argmax(z, axis=1).astype(np.float64)


def with_label(ds, label):
    """The constructed Dataset ``ds`` with another label: its bins, mappers
    and layout shared, so nothing is binned again."""
    import copy

    out = copy.copy(ds)
    out.label = np.asarray(label, np.float64)
    return out


def multi_logloss(score: np.ndarray, y: np.ndarray) -> float:
    """The f64 multi-class log-loss of [k, N] raw scores."""
    s = score - score.max(axis=0, keepdims=True)
    logp = s - np.log(np.exp(s).sum(axis=0, keepdims=True))
    p = np.maximum(logp[y.astype(np.int64), np.arange(len(y))], math.log(1e-15))
    return float(-p.mean())


def check_multi_walk(booster, x, dev, classes):
    """The walk kernel's class mode on the trained k-class forest over all
    rows, kernel vs plain (the same bits) at k = classes and at k = 10 on
    the same records, every row in the same leaf of every tree; timed
    beside the same trees walked at k = 1.  Returns the kernels line's
    entry (bound: the bytes of the bins, tables and scores, or the levels
    walked at the f32 rate)."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.predict import predict_bins_leaves, stack_bin_trees

    tables = booster._walk_tables()
    xs = torch.as_tensor(np.ascontiguousarray(x[:, booster.used_features], dtype=np.float32),
                         device=dev)
    dbt = fw.build_devbin_tables(booster.bin_mappers, booster.used_features, dev)
    bins = fw.bin_numeric(xs, *dbt)[0].to(torch.uint8)
    n, f = bins.shape
    out = {}
    for k in (classes, MULTI_WALK_WIDE_K):
        sk = fw.forest_walk(bins, tables, k)
        sp = fw.forest_walk_plain(bins, tables, k)
        if sk.shape != (n, k) or not torch.equal(sk, sp):
            raise AssertionError(f"forest_walk_multi at k = {k}: scores differ from the plain "
                                 f"walker's bits (max |err| {float((sk - sp).abs().max())})")
        out[k] = sk
    batch = stack_bin_trees([t.record() for t in booster.trees], booster.nan_bins, dev)
    leaves = predict_bins_leaves(batch, bins)
    for i, tree in enumerate(booster.trees):
        rec = dict(tree.record(), leaf_value=np.arange(tree.num_leaves, dtype=np.float32))
        got = fw.forest_walk(bins, fw.build_tables([rec] * classes, booster.nan_bins, dev),
                             classes)[:, i % classes]
        if not torch.equal(got.long(), leaves[:, i]):
            raise AssertionError(f"forest_walk_multi: tree {i} routes rows to other leaves")
    depth = torch.as_tensor(
        np.stack([_leaf_depths(t, batch.leaf_value.shape[1]) for t in booster.trees]),
        device=dev)
    visits = float(depth[torch.arange(len(booster.trees), device=dev)[None, :], leaves].sum())
    times = {k: time_ms(lambda k=k: fw.forest_walk(bins, tables, k), reps=10)
             for k in (1, classes, MULTI_WALK_WIDE_K)}
    table_bytes = tables.tables.numel() * 4
    print(f"kernel forest_walk_multi: {len(booster.trees)} trees, scores bit-equal to the plain "
          f"walker at k = {classes} and k = {MULTI_WALK_WIDE_K}, every row in the same leaf; "
          f"{visits:.0f} node visits; " + ", ".join(f"k = {k} {t:.4f} ms" for k, t in times.items())
          + " (the same trees)")
    entry = with_device(kernel_entry(
        "forest_walk_multi", 0.0, times[classes],
        time_ms(lambda: fw.forest_walk_plain(bins, tables, classes), reps=3),
        bound_ms(n * f + table_bytes + n * classes * 4, ops=visits), None,
    ), lambda: fw.forest_walk(bins, tables, classes))
    entry["k1_ms"] = times[1]
    entry[f"k{MULTI_WALK_WIDE_K}_ms"] = times[MULTI_WALK_WIDE_K]
    return entry


def multiclass_phase(lt, _build, ds, x, dev, card):
    """Softmax and one-vs-all multiclass on the main phase's Higgs rows and
    bins with a 5-class label (``multiclass_labels``): 5 rounds of
    multiclass (25 trees), then 3 of multiclassova; multi_logloss falling
    every round, predict [N, 5] against the training score, the kernels of
    the path launched (the walk's class mode at predict), the class mode
    against the plain walker (``check_multi_walk``), and card vs CPU at
    65,536 rows (int8 on both, 3 rounds of multiclass)."""
    from lightgbm_tpu_torch.ops import grower

    classes = MULTI_CLASSES
    y = multiclass_labels(x, classes)
    dsm = with_label(ds, y)
    phases = {}
    out = {}
    for obj, rounds in (("multiclass", MULTI_ROUNDS), ("multiclassova", MULTI_OVA_ROUNDS)):
        params = {**PARAMS, "objective": obj, "num_class": classes}
        _build.LAUNCHES.clear()
        booster, losses, secs, _ = train_rounds(lt, params, dsm, rounds)
        t0 = time.perf_counter()
        pred = booster.predict(x)
        raw = booster.predict(x, raw_score=True)
        torch.cuda.synchronize()
        pred_s = time.perf_counter() - t0
        phases[obj] = launches = dict(_build.LAUNCHES)
        print(f"{obj}: {len(booster.trees)} trees in {len(losses)} rounds, "
              f"{len(losses) / secs:.3f} iterations/s ({len(booster.trees) / secs:.3f} trees/s), "
              f"multi_logloss per round " + " ".join(f"{v:.6f}" for v in losses)
              + f"; predict and raw predict {2 * len(x) / pred_s:.0f} rows/s [{card}]")
        print(f"{obj}: kernel launches {json.dumps(launches)}")
        if not falls(losses, rounds):
            raise AssertionError(f"{obj}: multi_logloss did not fall every round")
        require_launches(launches, ("fused_grow_step", "seg_hist_int8", "split_scan",
                                    "forest_walk", "forest_walk_multi"), obj)
        score = booster.scores.double().cpu().numpy()  # [k, N]
        if raw.shape != (len(x), classes) or pred.shape != (len(x), classes):
            raise AssertionError(f"{obj}: predict shapes {raw.shape}, {pred.shape}")
        rel = float(np.max(np.abs(raw - score.T) / np.maximum(np.abs(score.T), 1e-3)))
        want = (torch.softmax(torch.as_tensor(score.T), dim=1) if obj == "multiclass"
                else torch.sigmoid(torch.as_tensor(score.T))).numpy()
        rel_p = float(np.max(np.abs(pred - want) / np.maximum(want, 1e-3)))
        print(f"{obj}: predict against the training score: raw {rel:.3g}, output {rel_p:.3g} "
              f"(relative)")
        if rel > 1e-5 or rel_p > 1e-5 or not np.all(np.isfinite(pred)):
            raise AssertionError(f"{obj}: predict differs from the training score")
        if obj == "multiclass":
            if abs(multi_logloss(score, y) - losses[-1]) > 1e-6 * losses[-1]:
                raise AssertionError("multiclass: the f64 log-loss of the score disagrees")
            out["forest_walk_multi"] = check_multi_walk(booster, x, dev, classes)
        del booster
    # card vs CPU, int8 accumulation on both
    xs, _ = make_data(PARITY_ROWS, FEATURES, seed=7)
    ys = multiclass_labels(xs, classes)
    params = {**PARAMS, "objective": "multiclass", "num_class": classes}
    runs = {}
    grower.INT8_ON_CPU = True
    try:
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[d] = lt.train(params, lt.Dataset(xs, ys, params=params), MULTI_PARITY_ROUNDS,
                               device=d)
            print(f"multiclass-parity: {d} trained {MULTI_PARITY_ROUNDS} rounds "
                  f"({len(runs[d].trees)} trees) in {time.perf_counter() - t0:.1f} s")
    finally:
        grower.INT8_ON_CPU = False
    share = split_share(runs["cuda"], runs["cpu"])
    lc, lp = runs["cuda"].train_loss(), runs["cpu"].train_loss()
    print(f"multiclass-parity: {share:.4f} of splits identical, multi_logloss cuda {lc:.7f} "
          f"cpu {lp:.7f}")
    if share < 0.95 or abs(lc - lp) > 1e-4 * abs(lp):
        raise AssertionError("multiclass: card and CPU training disagree")
    return out, phases


def check_xla_forms(dev):
    """Each XLA-form function of the objectives (log, log1p, sigmoid,
    softmax over 5 classes, the subnormal flush) on the card against the
    CPU on xla_exp's sweep of 4,000,001 points of [-89, 89] (log of their
    magnitudes), bit for bit (a NaN against a NaN); then every objective's
    gradients and hessians, weighted and not, on the card against the CPU
    on OBJ_CHECK_ROWS of the points."""
    from lightgbm_tpu_torch import objectives as ob
    from lightgbm_tpu_torch.config import Config

    x = torch.linspace(-89.0, 89.0, 4_000_001, dtype=torch.float32)

    def same(a, b):
        a, b = a.cpu(), b.cpu()
        return int(((a.view(torch.int32) != b.view(torch.int32))
                    & ~(torch.isnan(a) & torch.isnan(b))).sum())

    # each form's input made on the CPU (on the card a tensor divided by a
    # Python number is a product with its reciprocal) and copied to the card
    forms = {
        "xla_log": (ob.xla_log, x.abs()),
        "xla_log1p": (ob.xla_log1p, x / torch.full_like(x, 89.0)),
        "xla_sigmoid": (ob.xla_sigmoid, x),
        "xla_softmax": (ob.xla_softmax, x[:4_000_000].reshape(5, -1)),
        "ftz": (ob.ftz, x * 1e-38),
    }
    for name, (fn, v) in forms.items():
        differ = same(fn(v), fn(v.to(dev)))
        print(f"{name}: card vs CPU on {len(x)} points: {differ} differ")
        if differ:
            raise AssertionError(f"{name}: the card's differs from the CPU's")
    rng = np.random.default_rng(MULTI_SEED)
    n = OBJ_CHECK_ROWS
    s = (x[::15][:n] * 0.125).reshape(1, -1)  # [-11.1, 11.1]
    for name, extra in OBJECTIVE_CASES.items():
        if name.startswith("multiclass"):
            label = rng.integers(0, 5, n).astype(np.float64)
            sc = s.repeat(5, 1) + torch.arange(5, dtype=torch.float32)[:, None]
        elif name.startswith("cross_entropy"):
            label, sc = rng.random(n), s
        elif name in ("poisson", "gamma", "tweedie"):
            label, sc = rng.poisson(2.0, n) + 1.0, s
        elif name == "binary":
            label, sc = (rng.random(n) < 0.4).astype(np.float64), s
        else:
            label, sc = rng.normal(size=n) * 3.0, s
        cfg = Config.from_params({"objective": name, **extra})
        for weight in (None, rng.uniform(0.5, 1.5, n)):
            g0, h0 = ob.create_objective(cfg, label, "cpu", weight).get_gradients(sc)
            g1, h1 = ob.create_objective(cfg, label, dev, weight).get_gradients(sc.to(dev))
            differ = same(g0, g1) + same(h0, h1)
            if differ:
                raise AssertionError(f"{name}: gradients on the card differ from the CPU's "
                                     f"({differ} values)")
    print(f"objectives: gradients and hessians of {', '.join(OBJECTIVE_CASES)} (weighted and "
          f"not) on the card bit-equal to the CPU on {n} scores")


def objectives_phase(lt, _build, ds, x, dev, card):
    """The pointwise objectives on the main phase's Higgs rows and bins
    with regression labels made from MULTI_SEED: 3 rounds each of
    regression_l1 (leaf renewal), quantile (alpha 0.7, as scen_obj_quantile)
    and tweedie (1.3, as scen_obj_tweedie, on count labels); the training
    loss (the objective's metric) must fall, the host ms of each leaf
    renewal printed; then ``check_xla_forms``."""
    rng = np.random.default_rng(MULTI_SEED)
    z = np.nan_to_num(x[:, :8]) @ rng.normal(size=8) * 0.3
    reg = z + rng.normal(size=len(x))
    counts = rng.poisson(np.exp(np.clip(z, -3, 3))).astype(np.float64)
    phases = {}
    for name, extra, label in (("regression_l1", {}, reg), ("quantile", {"alpha": 0.7}, reg),
                               ("tweedie", {"tweedie_variance_power": 1.3}, counts)):
        params = {**PARAMS, "objective": name, **extra}
        _build.LAUNCHES.clear()
        booster, losses, secs, _ = train_rounds(lt, params, with_label(ds, label),
                                                OBJ_ROUNDS)
        phases[name] = launches = dict(_build.LAUNCHES)
        renew = booster.renew_ms
        print(f"{name}: {len(losses) / secs:.3f} iterations/s, {booster.config.default_metric()[0]}"
              f" per round " + " ".join(f"{v:.6f}" for v in losses)
              + (f", leaf renewal host ms per tree " + " ".join(f"{v:.1f}" for v in renew)
                 if renew else "") + f" [{card}]")
        if not falls(losses, OBJ_ROUNDS):
            raise AssertionError(f"{name}: the training loss did not fall every round")
        if booster.objective.is_renew_tree_output and len(renew) != len(booster.trees):
            raise AssertionError(f"{name}: not every tree renewed its leaves")
        require_launches(launches, ("fused_grow_step", "seg_hist_int8", "split_scan"), name)
        del booster
    check_xla_forms(dev)
    return phases


class Stamps:
    """Seconds of each phase of the script, printed as each one ends."""

    def __init__(self):
        self.t = time.perf_counter()
        self.took = {}

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.took[name] = now - self.t
        print(f"phase {name}: {self.took[name]:.1f} s")
        self.t = now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import _build
    from lightgbm_tpu_torch.ops import grower

    t_script = time.perf_counter()
    stamp = Stamps()
    dev = torch.device("cuda")
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(took)} sources")
    for name, (secs, report) in sorted(took.items()):
        print(f"build: {name} {secs:.1f} s; ptxas: {report}")
    check_xla_exp(dev)

    x, y = make_data(ROWS, FEATURES)
    t0 = time.perf_counter()
    ds = lt.Dataset(x, y, params=PARAMS).construct()
    print(f"dataset: {ROWS} x {FEATURES} binned in {time.perf_counter() - t0:.1f} s, "
          f"{ds.max_bin_padded} histogram bins")

    stamp("build and data")
    kernels = {k["name"]: k for k in check_seg_kernels(ds, dev)}
    kernels.update(check_u16_kernels(dev))
    kernels.update(check_ordered_u16_kernels(dev))
    kernels.update(check_live_kernels(dev))
    if "--kernels" in sys.argv[1:]:
        del ds, x, y
        # synthetic Expo-shaped bins made on the card (the binned table takes
        # ~100 s on the host): the same shapes and cases
        from lightgbm_tpu_torch import bench_ordered

        rows, qrows, scales, nb = bench_ordered.synthetic_inputs(WIDE_ROWS, WIDE_FEATURES, dev)
        check_ordered_kernels(rows, qrows, scales, nb, -torch.ones_like(nb), 256)
        return 0

    stamp("kernels")
    # -- main path (default parameters): counts from 0 just before, read
    # just after training and predict
    _build.LAUNCHES.clear()
    booster, losses, train_s, _ = train_rounds(lt, PARAMS, ds, ROUNDS)
    t0 = time.perf_counter()
    pred = booster.predict(x)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    main_launches = dict(_build.LAUNCHES)
    main_rate = len(losses) / train_s
    print(f"main: {len(booster.trees)} trees of {[t.num_leaves for t in booster.trees]} leaves, "
          f"{main_rate:.3f} iterations/s, predict {ROWS / pred_s:.0f} rows/s")
    print("main: training log-loss per round " + " ".join(f"{v:.6f}" for v in losses))
    print(f"main: near-tie f32 refines per tree {booster.refine_counts}, refine rate per tree "
          + " ".join(f"{booster.refine_rate(i):.3f}" for i in range(len(booster.trees))))
    print(f"main: kernel launches {json.dumps(main_launches)}")
    if len(losses) != ROUNDS or not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError("training log-loss did not fall every round")
    require_launches(main_launches, ("fused_grow_step", "seg_hist_int8", "split_scan",
                                     "forest_walk"), "main path")
    if pred.shape != (ROWS,) or not np.all(np.isfinite(pred)) or not np.all((pred > 0) & (pred < 1)):
        raise AssertionError("predictions are not finite probabilities")
    # predicted log-loss must equal the train score's (same rows, same trees)
    p = np.clip(pred, 1e-15, 1 - 1e-15)
    pred_loss = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    if abs(pred_loss - losses[-1]) > 1e-5 * losses[-1]:
        raise AssertionError(f"predict log-loss {pred_loss} vs train {losses[-1]}")
    print(f"main: predict log-loss {pred_loss:.6f} matches the training score")

    predict_stats(booster, x, "main")
    predict_checks(booster, x, dev)
    kernels["forest_walk"] = check_forest_walk(booster, x, dev)
    main_profile = profile_iteration(booster)
    del booster
    stamp("main")

    batch_launches = batch_phase(lt, _build, ds)
    stamp("batch")

    # -- the two-launch path with f32 sums, on the same rows
    _build.LAUNCHES.clear()
    off, off_losses, off_s, _ = train_rounds(lt, OFF_PARAMS, ds, OFF_ROUNDS)
    off_launches = dict(_build.LAUNCHES)
    print(f"off: grow_fused='off', hist_acc='bf16': {len(off_losses) / off_s:.3f} iterations/s, "
          f"log-loss per round " + " ".join(f"{v:.6f}" for v in off_losses))
    print(f"off: kernel launches {json.dumps(off_launches)}")
    profile_iteration(off, "off profile")
    require_launches(off_launches, ("partition", "seg_hist", "split_scan"), "two-launch path")
    if off_launches.get("fused_grow_step", 0) or off_launches.get("seg_hist_int8", 0):
        raise AssertionError("two-launch path went through the fused step or int8")
    k = OFF_ROUNDS - 1
    rel = abs(losses[k] - off_losses[k]) / off_losses[k]
    print(f"off: log-loss after {OFF_ROUNDS} rounds int8 {losses[k]:.7f} vs bf16 "
          f"{off_losses[k]:.7f} (relative {rel:.3g})")
    if rel > 1e-4:
        raise AssertionError("int8 and f32 accumulation disagree on the log-loss")
    del off

    # -- frontier batching on the two-launch path
    _build.LAUNCHES.clear()
    boff, boff_losses, boff_s, _ = train_rounds(lt, BATCH_OFF_PARAMS, ds, BATCH_OFF_ROUNDS)
    boff_launches = dict(_build.LAUNCHES)
    print(f"batch-off: leaf_batch 4, grow_fused='off', hist_acc='bf16': "
          f"{len(boff_losses) / boff_s:.3f} iterations/s, log-loss per round "
          + " ".join(f"{v:.6f}" for v in boff_losses))
    print(f"batch-off: grow steps per tree {boff.grow_steps}, effective K {boff.leaf_batch_effective}")
    print(f"batch-off: kernel launches {json.dumps(boff_launches)}")
    require_launches(boff_launches, ("partition_batch", "seg_hist", "split_scan_batch"),
                     "batched two-launch path")
    if boff_launches.get("fused_grow_step", 0) or boff_launches.get("seg_hist_int8", 0):
        raise AssertionError("batched two-launch path went through the fused step or int8")
    if len(boff_losses) != BATCH_OFF_ROUNDS or not all(
            b < a for a, b in zip(boff_losses, boff_losses[1:])):
        raise AssertionError("batched two-launch path: log-loss did not fall every round")
    del boff

    phases = {"main": main_launches, "batch": batch_launches, "off": off_launches,
              "batch-off": boff_launches}
    stamp("off and batch-off")

    t0 = time.perf_counter()
    phases.update(sampling_phases(lt, _build, ds, main_rate, card))
    sampling_parity(lt, ds, card)
    print(f"sampling: the sampling and sampling-parity phases took {time.perf_counter() - t0:.1f} s")
    stamp("sampling")

    # -- card vs CPU on the default path, int8 accumulation on both
    xs, ys = make_data(PARITY_ROWS, FEATURES, seed=7)
    runs = {}
    grower.INT8_ON_CPU = True
    try:
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[d] = lt.train(PARAMS, lt.Dataset(xs, ys, params=PARAMS), PARITY_ROUNDS, device=d)
            print(f"parity: {d} trained {PARITY_ROUNDS} rounds in {time.perf_counter() - t0:.1f} s, "
                  f"refines per tree {runs[d].refine_counts}")
    finally:
        grower.INT8_ON_CPU = False
    share = split_share(runs["cuda"], runs["cpu"])
    pdiff = float(np.abs(runs["cuda"].predict(xs) - runs["cpu"].predict(xs)).max())
    lc, lp = runs["cuda"].train_loss(), runs["cpu"].train_loss()
    print(f"parity: {share:.4f} of splits identical, prediction max |diff| {pdiff:.3g}, "
          f"log-loss cuda {lc:.7f} cpu {lp:.7f}")
    if share < 0.95 or abs(lc - lp) > 1e-4 * abs(lp):
        raise AssertionError("card and CPU training disagree")
    del runs, xs, ys
    stamp("parity")

    multi_kernels, multi_launches = multiclass_phase(lt, _build, ds, x, dev, card)
    kernels.update(multi_kernels)
    phases.update(multi_launches)
    stamp("multiclass")
    phases.update(objectives_phase(lt, _build, ds, x, dev, card))
    stamp("objectives")
    del x, ds

    t0 = time.perf_counter()
    phases.update(sampling_wide_phase(lt, _build, card))
    print(f"sampling-wide: the phase took {time.perf_counter() - t0:.1f} s")
    stamp("sampling-wide")

    phases["io"] = io_phase(lt, _build, ROWS, dev)
    stamp("io")

    efb_kernels, efb_launches = efb_phase(lt, _build, dev)
    kernels.update(efb_kernels)
    phases.update(efb_launches)
    stamp("efb")

    cat_kernels, cat_launches = cat_phases(lt, _build, dev, card)
    kernels.update(cat_kernels)
    phases.update(cat_launches)
    stamp("cat")

    phases.update(widebin_phase(lt, _build, main_profile))
    stamp("widebin")

    wide_kernels, wide_launches = wide_phases(lt, _build, dev)
    kernels.update({k["name"]: k for k in wide_kernels})
    phases.update(wide_launches)
    stamp("wide")

    phases.update(wide_u16_phase(lt, _build))
    stamp("wide-u16")
    for name, kern in kernels.items():
        kern["launches"] = sum(ph.get(name, 0) for ph in phases.values())
    for kern in kernels.values():
        lib = "none" if kern["library_ms"] is None else f"{kern['library_ms']:.4f} ms"
        print(f"kernel {kern['name']}: {kern['ms']:.4f} ms (bound {kern['bound_ms']:.5f} ms by "
              f"{kern['bound_by']}), plain {kern['plain_ms']:.4f} ms, library {lib}, "
              f"{kern['launches']} launches on the {', '.join(phases)} paths "
              f"({' + '.join(str(ph.get(kern['name'], 0)) for ph in phases.values())})")
    missing = [name for name, kern in kernels.items() if kern["launches"] <= 0]
    if len(kernels) != len(SOURCES) or missing:
        raise AssertionError(f"kernels not checked or never launched on a path: {missing}")
    from lightgbm_tpu_torch._bench import TRACES

    print(f"device traces: {TRACES['lost']} of {TRACES['taken']} lost (their device times not "
          f"measured: NaN here, null in the kernels line); {TRACES['session']} of them lost device "
          f"operations in one session, and of those taken again with CUPTI's forced flush "
          f"{TRACES['flush']} lost them again")
    print(f"chip_smoke: the script took {time.perf_counter() - t_script:.1f} s [{card}]")
    print(json.dumps({"kernels": nan_to_null(list(kernels.values()))}, allow_nan=False))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
