"""Chip smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py
(``--kernels``: build and check the kernels only, on the Higgs data and,
for the ordered histograms, on synthetic Expo-shaped bins made on the card,
then stop without the result lines.)

Phases (any failed check raises, and the script exits non-zero):
  device   the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  build    every kernel of lightgbm_tpu_torch/csrc compiled by nvcc
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
           lightgbm_tpu_torch/bench_partition.py, through the wrappers
  main     train() of the Higgs-shaped binary model (1,048,576 x 28,
           255 leaves, max_bin 255, learning rate 0.1) with the default
           path parameters (fused grow step, int8 accumulation with the
           near-tie f32 refine) for 10 rounds on the card, then predict()
           on the same rows; launch counts of its kernels (each must be
           > 0), near-tie refines per tree, and the training log-loss per
           round (it must fall); one more iteration under torch.profiler
           (with the tree's fused steps, and its segment histograms of the
           near-tie refine, against their bounds and the rows of their
           windows)
  batch    bench.py's headline parameters (min_data_in_leaf 100,
           leaf_batch 4: frontier-batched growth, up to 4 splits per grow
           step) for 10 rounds on the same rows: log-loss per round (it
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
  parity   the default parameters for 3 rounds at 65,536 rows on the card
           and on the CPU with the int8 accumulation on there
           (grower.INT8_ON_CPU): share of identical splits, log-loss
  wide data  an Expo-shaped table (binary, 1,048,576 x 700 numeric
           features, 2% NaN, values on a grid of 1/32), binned (and the
           seconds of the bundling check); the ordered histograms (f32 and
           int8) against their plain versions on the cases of
           lightgbm_tpu_torch/bench_ordered.py (the root with no index, K=2
           windows of a shuffled index, windows of 14,000 and 4,000 rows,
           the root with 64 skewed features; f32 the same bits on two
           calls), with their times; the split scan and its candidate call
           (case-major) at F = 700
  wide     train() with no path parameters: the layout rule must pick
           hist_mode='ordered'; 5 rounds (log-loss must fall), launches
           (ordered_hist and split_scan, no seg kernel), predict through
           the plain walker (700 features > the walk kernel's 512): its
           log-loss must equal training's; one iteration under the
           profiler, with the tree's ordered_hist time against its bound
           (each launch's rows * (F + 16) + K * F * B * 12 bytes)
  wide-batch  bench.py's batch parameters (leaf_batch 4) for 3 rounds:
           K-window ordered_hist launches, the batched split scan
  wide-quant  quantized training on the int8 kernel (use_quantized_grad,
           stochastic_rounding=False, hist_method='pallas_int8') for 3
           rounds: ordered_hist_int8 only
  wide-parity  65,536 of the wide rows for 3 rounds, card vs CPU, f32 and
           quantized: share of identical splits, log-loss
The last lines: the kernels JSON (launches summed over the main, batch,
off, batch-off, wide, wide-batch and wide-quant runs), the card, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
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
PARITY_ROUNDS = 3
PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255, "learning_rate": 0.1}
# the two-launch path: a partition and a histogram launch per split, f32 sums
OFF_PARAMS = {**PARAMS, "grow_fused": "off", "hist_acc": "bf16", "fused_split_scan": True}
# bench.py's _PARAMS (less its logging keys): frontier batching, K = 4
BATCH_PARAMS = {**PARAMS, "min_data_in_leaf": 100, "leaf_batch": 4}
BATCH_ROUNDS = 10
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
QUANT_PARAMS = {**PARAMS, "use_quantized_grad": True, "stochastic_rounding": False,
                "num_grad_quant_bins": 4, "hist_method": "pallas_int8"}

# H100 SXM published peaks: HBM bytes/s and
# f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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
}
# CUDA launches per split of the profiled iterations with the rows-only scan
# and its candidates in PyTorch operators on the host side (PERF.md section 5)
EARLIER_LAUNCHES_PER_SPLIT = {"profile": 100.6, "batch profile": 20.7, "off profile": 43.2,
                              "wide profile": 68.1}
# kernels that only the seg layout launches
SEG_KERNELS = ("seg_hist", "seg_hist_int8", "fused_grow_step", "partition", "partition_batch")


def make_data(n_rows: int, n_features: int, seed: int = 42):
    """The repo's Higgs-shaped synthetic task (the formula of bench.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    w = rng.normal(size=n_features)
    logits = x @ w * 0.5 + rng.normal(scale=1.0, size=n_rows)
    return x, (logits > 0).astype(np.float64)


def make_wide_data(n_rows: int, n_features: int, seed: int = 42):
    """The Expo-shaped table: standard normal values on a grid of 1/32
    (~300 distinct values a column, so each fills ~255 bins), 2% NaN; the
    label a fixed linear-plus-quadratic function of the first 32 columns
    plus noise."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, n_features), dtype=np.float32)
    x *= 32.0
    np.round(x, out=x)
    x /= 32.0
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
    the event time ``ms`` is the host's and the card's together."""
    from lightgbm_tpu_torch._bench import device_profile

    entry["device_ms"], entry["launches_per_call"] = device_profile(fn)
    print(f"kernel {entry['name']}: {entry['ms']:.4f} ms event time, {entry['device_ms']:.4f} ms "
          f"device time in {entry['launches_per_call']:.0f} device operations a call")
    return entry


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
            marr = grow_step._members(*mem, None)
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
    """The walk of the trained model over all rows, kernel vs plain."""
    from lightgbm_tpu_torch.ops import forest_walk as fw
    from lightgbm_tpu_torch.predict import predict_bins_leaves, stack_bin_trees

    tables = booster._walk_tables()
    xs = torch.as_tensor(x[:, booster.used_features], device=dev)
    dbt = fw.build_devbin_tables(booster.bin_mappers, booster.used_features, dev)
    bins = fw.bin_numeric(xs, *dbt)[0].to(torch.uint8)
    sk = fw.forest_walk(bins, tables, 1)
    sp = fw.forest_walk_plain(bins, tables, 1)
    err = float((sk - sp).abs().max())
    if err > 1e-5:
        raise AssertionError(f"forest_walk: scores off by {err}")
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
    table_bytes = sum(t.numel() * t.element_size() for t in (tables.node, tables.child, tables.leaf))
    print(f"kernel forest_walk: same leaves in every tree, scores max |err| {err:.3g} "
          f"vs the plain walker (tolerance 1e-5), {visits:.0f} node visits")
    return with_device(kernel_entry(
        "forest_walk", err,
        time_ms(lambda: fw.forest_walk(bins, tables, 1)),
        time_ms(lambda: fw.forest_walk_plain(bins, tables, 1), reps=3),
        bound_ms(n * f + table_bytes + n * 4, ops=visits), None,
    ), lambda: fw.forest_walk(bins, tables, 1))


def profile_iteration(booster, label: str = "profile") -> None:
    """Where one training iteration's time goes: torch.profiler over one
    update(), device time by kernel against the host's wall time, and the
    host's own time by operator (self time: the rest of the wall is Python
    outside PyTorch's operators, and the profiler's overhead)."""
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

    def step_recorded(rows, mem, num_bins, quant_scales, fn=None):
        steps.append([int(c) for c in mem[:, 1]])
        return step_launch(rows, mem, num_bins, quant_scales, fn)

    hists = {"f32": [], "int8": []}  # rows of each window of each segment histogram call
    hist_launch = seg._seg_hist_launch

    def hist_recorded(rows, wins, num_bins, scales, fn=None):
        hists["f32" if scales is None else "int8"].append([int(c) for _, c in wins])
        return hist_launch(rows, wins, num_bins, scales, fn)

    oh._launch = recorded
    grower.fused_best_split_batch = scan_timed
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
        acc = re.search(r"lane_hist_accumulate<(\w+), (\w+)>", e.name)
        if acc:
            user = "step" if acc.group(2) == "false" else (
                "seg int8" if acc.group(1) == "true" else "seg f32")
        lane_us[user] += e.time_range.elapsed_us()
    busy_ms = sum(us for us, _ in dev_us.values()) / 1e3
    print(f"{label}: one iteration (tree {len(booster.trees)}) {wall_ms:.1f} ms wall under the "
          f"profiler, device busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.3f} of wall)")
    for key, (us, cnt) in sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"{label}:   {us / 1e3:8.2f} ms  {cnt:6d} calls  {key[:90]}")
    if ordered:
        # the tree's ordered histograms against their bound: each launch
        # reads rows * (F + 16) bytes and writes K * F * B * 12
        f, b = len(booster.used_features), booster._grower_params.max_bin
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
        pbound = 2 * sum(wins) * (len(booster.used_features) + 16) / HBM_BYTES_PER_S * 1e3
        print(f"{label}: partition {part_us / 1e3:.3f} ms over {len(wins)} windows against a bound "
              f"of {pbound:.3f} ms; rows a window median {wins[len(wins) // 2]}, mean "
              f"{sum(wins) / len(wins):.0f}, largest {wins[-1]}")
    if steps:
        # the tree's fused grow steps against their bound: each window's
        # rows read and written once, F + 16 bytes a row, and each call's
        # K * F * B * 12 output bytes
        f, b = len(booster.used_features), booster._grower_params.max_bin
        step_us = lane_us["step"] + sum(us for key, (us, _) in dev_us.items()
                                        if "partition_" in key)
        wins = sorted(c for call in steps for c in call)
        sbound = (2 * sum(wins) * (f + 16) + sum(len(call) for call in steps) * f * b * 12
                  ) / HBM_BYTES_PER_S * 1e3
        print(f"{label}: fused_grow_step {step_us / 1e3:.3f} ms over {len(steps)} calls "
              f"({len(wins)} windows) against a bound of {sbound:.3f} ms "
              f"({step_us / 1e3 / sbound:.1f}x); rows a window median {wins[len(wins) // 2]}, "
              f"mean {sum(wins) / len(wins):.0f}, largest {wins[-1]}")
    for mode, calls in hists.items():
        if not calls:
            continue
        # the tree's segment histograms against their bound: each window's
        # rows read once, F + 12 bytes a row, and each call's K * F * B * 12
        # output bytes (f32: the near-tie refine on the fused path)
        f, b = len(booster.used_features), booster._grower_params.max_bin
        wins = sorted(c for call in calls for c in call)
        live = [c for c in wins if c > 0]
        hbound = (sum(wins) * (f + 12) + len(wins) * f * b * 12) / HBM_BYTES_PER_S * 1e3
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
    print(f"{label}: host operators {host_ms:.1f} ms self time ({host_ms / wall_ms:.3f} of wall), "
          f"{sum(e.count for e in host)} calls; top by self time:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"{label}:   host {e.self_cpu_time_total / 1e3:8.2f} ms  {e.count:6d} calls  {e.key[:60]}")


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


def falls(losses, rounds) -> bool:
    return len(losses) == rounds and all(b < a for a, b in zip(losses, losses[1:]))


def wide_data(lt):
    """(x, y, the binned Dataset) of the Expo-shaped table."""
    t0 = time.perf_counter()
    x, y = make_wide_data(WIDE_ROWS, WIDE_FEATURES)
    t1 = time.perf_counter()
    ds = lt.Dataset(x, y, params=PARAMS).construct()
    print(f"wide data: {WIDE_ROWS} x {WIDE_FEATURES} made in {t1 - t0:.1f} s, binned in "
          f"{time.perf_counter() - t1:.1f} s; {len(ds.used_features)} used features, "
          f"{int(ds.num_bins().min())}-{int(ds.num_bins().max())} bins a feature, "
          f"{ds.max_bin_padded} histogram bins; the bundling check took "
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
    pred = wb.predict(x)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    phases["wide"] = launches = dict(_build.LAUNCHES)
    print(f"wide: hist_mode resolved to {wb.hist_mode!r}; {len(wb.trees)} trees of "
          f"{[t.num_leaves for t in wb.trees]} leaves, {len(losses) / train_s:.4f} iterations/s "
          f"(set-up {setup_s:.1f} s), predict {WIDE_ROWS / pred_s:.0f} rows/s")
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
    if pred.shape != (WIDE_ROWS,) or not np.all(np.isfinite(pred)):
        raise AssertionError("wide: predictions are not finite")
    p = np.clip(pred, 1e-15, 1 - 1e-15)
    pred_loss = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    if abs(pred_loss - losses[-1]) > 1e-5 * losses[-1]:
        raise AssertionError(f"wide: predict log-loss {pred_loss} vs train {losses[-1]}")
    bins = wb._bins_nf[:, :WIDE_FEATURES]
    walk_ms = time_ms(lambda: wb.predict_raw_bins(bins), reps=3, warmup=1)
    print(f"wide: predict through the plain walker, log-loss {pred_loss:.6f} matches the "
          f"training score; the walker alone on the binned rows {walk_ms:.1f} ms "
          f"({WIDE_ROWS / walk_ms * 1e3:.0f} rows/s): the rest of predict is the host's "
          "conversion of the values and the device binning")
    del bins
    profile_iteration(wb, "wide profile")
    del wb, pred

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
    xs, ys = x[:PARITY_ROWS].copy(), y[:PARITY_ROWS].copy()
    del x
    for name, params in (("f32", PARAMS), ("quantized", QUANT_PARAMS)):
        runs = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[d] = lt.train(params, lt.Dataset(xs, ys, params=params), PARITY_ROUNDS, device=d)
            print(f"wide-parity {name}: {d} trained {PARITY_ROUNDS} rounds in "
                  f"{time.perf_counter() - t0:.1f} s ({runs[d].hist_mode})")
        share = split_share(runs["cuda"], runs["cpu"])
        lc, lp = runs["cuda"].train_loss(), runs["cpu"].train_loss()
        print(f"wide-parity {name}: {share:.4f} of splits identical, log-loss cuda {lc:.7f} "
              f"cpu {lp:.7f}")
        if share < 0.95 or abs(lc - lp) > 1e-4 * abs(lp):
            raise AssertionError(f"wide-parity {name}: card and CPU training disagree")
    return kernels, phases


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch import _build
    from lightgbm_tpu_torch.ops import grower

    dev = torch.device("cuda")
    card = card_line()
    print(f"device: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(took)} sources")
    for name, (secs, report) in sorted(took.items()):
        print(f"build: {name} {secs:.1f} s; ptxas: {report}")

    x, y = make_data(ROWS, FEATURES)
    t0 = time.perf_counter()
    ds = lt.Dataset(x, y, params=PARAMS).construct()
    print(f"dataset: {ROWS} x {FEATURES} binned in {time.perf_counter() - t0:.1f} s, "
          f"{ds.max_bin_padded} histogram bins")

    kernels = {k["name"]: k for k in check_seg_kernels(ds, dev)}
    if "--kernels" in sys.argv[1:]:
        del ds, x, y
        # synthetic Expo-shaped bins made on the card (the binned table takes
        # ~100 s on the host): the same shapes and cases
        from lightgbm_tpu_torch import bench_ordered

        rows, qrows, scales, nb = bench_ordered.synthetic_inputs(WIDE_ROWS, WIDE_FEATURES, dev)
        check_ordered_kernels(rows, qrows, scales, nb, -torch.ones_like(nb), 256)
        return 0

    # -- main path (default parameters): counts from 0 just before, read
    # just after training and predict
    _build.LAUNCHES.clear()
    booster, losses, train_s, _ = train_rounds(lt, PARAMS, ds, ROUNDS)
    t0 = time.perf_counter()
    pred = booster.predict(x)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    main_launches = dict(_build.LAUNCHES)
    print(f"main: {len(booster.trees)} trees of {[t.num_leaves for t in booster.trees]} leaves, "
          f"{len(losses) / train_s:.3f} iterations/s, predict {ROWS / pred_s:.0f} rows/s")
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

    kernels["forest_walk"] = check_forest_walk(booster, x, dev)
    profile_iteration(booster)
    del booster

    batch_launches = batch_phase(lt, _build, ds)

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
    del runs, xs, ys, x, ds

    wide_kernels, wide_launches = wide_phases(lt, _build, dev)
    kernels.update({k["name"]: k for k in wide_kernels})
    phases.update(wide_launches)
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
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
