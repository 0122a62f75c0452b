"""The fused grow step's kernels (csrc/grow_step.cu: the partition of
csrc/partition.cu, then the lane histogram of csrc/lane_hist.cuh on each
elected child) as a plain model on the CPU.

The kernels run only on the card.  ``model_grow_step`` repeats, in plain
PyTorch, what their four launches compute: the partition's tiles and copy
pass (``model_partition`` of test_torch_partition.py, in random orders the
partition's waits allow), which leave each window's left count nl; then the
histogram blocks, one per (row chunk, 32-feature group), each window's
chunks planned as the kernel plans them, in a random order (blocks of one
launch wait on nothing but the launch before): each reads nl, elects the
window's smaller child (the left one when nl <= nr), takes its chunk of
the child's rows as the kernel cuts them and writes its table to its own
slot; then the reduce sums each window's slots in the
kernel's fixed order, recombines the int8 digit sums as the kernel does,
and writes dec (the histogram's launches: ``lane_hist_model.model_lane_hist``,
shared with test_torch_seg_hist_model.py).

Held against ``fused_grow_step_plain`` and the JAX package's
``fused_grow_step`` (the XLA oracle in f32, the Pallas kernel in interpret
mode for int8): dec and every column of the rows exactly, the int8
histogram bit for bit, the f32 one's counts exactly and g/h within the f32
tolerance of chip_smoke.py (``_bench.f32_tol``).
"""

import os
import re

import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.pallas import grow_step as jax_grow_step

from lightgbm_tpu_torch import _build, bench_grow_step, bench_partition
from lightgbm_tpu_torch._bench import f32_tol
from lightgbm_tpu_torch.ops import grow_step, seg

from .lane_hist_model import (LANES, MIN_ROWS, PLANES, SLICES, atomic_types, model_lane_hist,
                              plan_chunks, recombine, source_in_order, window_chunks)
from .test_torch_grow_step import MEMBERS, _jax_members, _jax_seg, _problem, _scales, _torch_rows
from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import jax_interpret
from .test_torch_partition import _assert_same, _clone, _members, _rows, model_partition


def model_grow_step(rows, mem, num_bins, scales, fill, rng, tile=None):
    """The four launches on the CPU (see the module docstring): partitions
    the rows in place; returns (dec [K, 4] i32, hist [K, F, B, 3] f32)."""
    k, f = len(mem), rows.f
    tile = tile or seg.partition_tile_rows(rows.planes, int(mem[:, 1].sum()))
    nl = model_partition(rows, mem, tile, rng).numpy().astype(np.int64)
    groups = -(-f // LANES)
    ranges = seg.hist_ranges(rows, num_bins)
    chunk0 = plan_chunks([int(c) for c in mem[:, 1]], True, groups * ranges, fill)

    def child(w):  # hist_window: the elected child of window w
        s, c, l = int(mem[w, 0]), int(mem[w, 1]), int(nl[w])
        return (s, l) if l <= c - l else (s + l, c - l)

    children = [child(w) for w in range(k)]
    hist = model_lane_hist(rows, children, chunk0, num_bins, scales, rng,
                           in_order=source_in_order(scales is not None, False), ranges=ranges)
    dec = np.zeros((k, 4), np.int64)
    for w, (s, c) in enumerate(children):
        dec[w] = (nl[w], int(mem[w, 1]) - nl[w], s, c)
    return torch.as_tensor(dec.astype(np.int32)), hist


def _check(rows, want, dec, hist, dec_p, hist_p, scales, num_bins):
    assert torch.equal(dec, dec_p)
    _assert_same(rows, want)
    if scales is not None:
        assert torch.equal(hist, hist_p)
        return
    assert torch.equal(hist[..., 2], hist_p[..., 2])
    tol = f32_tol(want, dec_p[:, 2:4].tolist(), num_bins, hist_p[..., 2:3])
    assert bool(((hist[..., :2] - hist_p[..., :2]).abs() <= tol).all())


def _run(rows, mem, num_bins, scales, fill, seed, tile=None):
    want = _clone(rows)
    dec_p, hist_p = grow_step.fused_grow_step_plain(want, mem, num_bins, scales)
    dec, hist = model_grow_step(rows, mem, num_bins, scales, fill, np.random.default_rng(seed),
                                tile)
    _check(rows, want, dec, hist, dec_p, hist_p, scales, num_bins)
    return dec


def _int8_scales(rows):
    return bench_grow_step.int8_scales(rows)


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("k,seed,fill", [(1, 0, 132), (2, 1, 7), (4, 2, 264), (16, 3, 132)])
def test_model_equals_plain_on_random_windows(k, seed, fill, mode):
    """Random disjoint windows at unaligned starts (one empty among four or
    more), 37 features (two groups of lanes), many chunks a child."""
    rng = np.random.default_rng(seed)
    rows, nb = _rows(24_000, 37, seed)
    mem = _members(rows.n, nb, rng, k)
    scales = _int8_scales(rows) if mode == "int8" else None
    _run(rows, mem, 40, scales, fill, seed)


@pytest.mark.parametrize("k,seed,fill", [(1, 6, 132), (4, 7, 264), (16, 8, 132)])
def test_model_f32_the_same_bits_whatever_the_block_order(k, seed, fill):
    """The step's f32 histogram, its blocks adding as lane_hist.cuh's Acc
    has the step's f32 blocks add, is the same bits with the blocks (and
    the partition's tiles) in two other orders: every block sums its chunk
    in row order and the reduce in a fixed order."""
    rows, nb = _rows(24_000, 37, seed)
    mem = _members(rows.n, nb, np.random.default_rng(seed), k)
    got = []
    for order_seed in (seed + 100, seed + 200):
        r = _clone(rows)
        got.append(model_grow_step(r, mem, 40, None, fill, np.random.default_rng(order_seed))[1])
    assert torch.equal(got[0], got[1])


def test_kernel_source_sums_the_step_f32_in_row_order():
    """The step's f32 launch (``lhist::launch<false>``, Acc<false, false>)
    takes the header's in-order path, one warp a block, its scratch sized
    for that path, and no atomicAdd in the header adds a float; the int8
    launch keeps sixteen warps."""
    with open(os.path.join(_build.CSRC, "lane_hist.cuh")) as fh:
        lane = fh.read()
    with open(os.path.join(_build.CSRC, "grow_step.cu")) as fh:
        step = fh.read()
    assert source_in_order(False, False) and source_in_order(False, True)
    assert not source_in_order(True, False)
    assert "kWarps = kInt8 ? (kSeg ? 32 : 16) : 1;" in lane
    assert "lhist::launch<false>(" in step and "lhist::scratch_bytes<false>(f, nbins)" in step
    assert atomic_types(lane) == {"int"}


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("case", ["all left", "all right", "cnt 0 among K", "cnt < 32",
                                  "NaN bin left", "nl == nr"])
def test_model_equals_plain_on_the_bench_edge_cases(case, mode):
    rows, nb = bench_partition.synthetic_rows(24_000, 6, torch.device("cpu"), seed=4)
    mem = bench_grow_step.edge_cases(rows, nb)[case]
    scales = _int8_scales(rows) if mode == "int8" else None
    dec = _run(rows, mem, 256, scales, 132, 5, tile=128)
    if case == "nl == nr":
        assert int(dec[0, 0]) == int(dec[0, 1]) and int(dec[0, 2]) == int(mem[0, 0])
    if case == "all left":  # the right child, empty, is elected
        assert int(dec[0, 0]) == int(mem[0, 1]) and int(dec[0, 3]) == 0


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_model_equals_jax_fused_grow_step(mode):
    """K=2 adjacent unaligned windows (test_torch_grow_step.MEMBERS) against
    the JAX package: the XLA oracle in f32, the Pallas kernel in interpret
    mode for int8."""
    bins, grad, hess, mask = _problem()
    rows = _torch_rows(bins, grad, hess, mask)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    qs = None
    kw = {}
    if mode == "int8":
        qs, sj = _scales(grad, hess, mask)
        kw = dict(quant_scales=(sj[0], sj[1]))
    with jax_interpret(seg=False, grow_step=mode == "int8"):
        want = jax_grow_step.fused_grow_step(seg_j, *_jax_members(), f=11, num_bins=256,
                                             n_pad=n_pad, **kw)
    mem = seg.split_members(*np.asarray(MEMBERS).T)
    dec, hist = model_grow_step(rows, mem, 256, qs, 5, np.random.default_rng(0), tile=128)
    for i in range(4):
        np.testing.assert_array_equal(dec[:, i].numpy(), np.asarray(want[i + 1]))
    hist_j = torch.as_tensor(np.array(want[5]))
    if mode == "int8":
        assert torch.equal(hist, hist_j)
    else:
        assert torch.equal(hist[..., 2], hist_j[..., 2])
        tol = f32_tol(rows, dec[:, 2:4].tolist(), 256, hist_j[..., 2:3])
        assert bool(((hist[..., :2] - hist_j[..., :2]).abs() <= tol).all())


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("case", ["random K=4", "tbin 256", "NaN bin past 255 left",
                                  "table members", "K=4, 1024-bin tables"])
def test_model_equals_plain_on_u16_windows(case, mode):
    """The u16 mode at a padded width of 1,024 (37 features as two byte
    planes each): the partition's key lo | hi << 8, the elected children's
    histograms in bin ranges of 256, on random windows, the bench's u16
    edge cases and its wide tables (wide member rows)."""
    rows, nb = bench_partition.synthetic_rows_u16(4_000, 37, torch.device("cpu"), seed=5)
    rng = np.random.default_rng(6)
    if case == "random K=4":
        mem = _members(rows.n, nb, rng, 4)
    elif "1024-bin" in case:
        mem = bench_partition.wide_table_cases(rows.n, nb, 1024)[case]
    else:
        mem = bench_partition.u16_edge_cases(rows.n, nb)[case]
    scales = _int8_scales(rows) if mode == "int8" else None
    _run(rows, mem, 1024, scales, 24, 7)


def test_recombine_model_is_bit_equal_to_combine_int8():
    """The reduce's f32 recombine against the plain version's, on digit sums
    up to 2^28 (past f32's exact integers) and scales of every size."""
    rng = np.random.default_rng(0)
    raw = rng.integers(-(1 << 28), 1 << 28, size=(4, 7, 64, 5)).astype(np.int32)
    raw[0] = rng.integers(-300, 300, size=raw[0].shape)
    raw[..., 4] = np.abs(raw[..., 4])
    for scales in ([1e-30, 1e-30], [3.1e-5, 7.7e-3], [0.37, 12.5]):
        sc = np.asarray(scales, np.float32)
        want = seg.combine_int8(torch.as_tensor(raw), torch.as_tensor(sc)).numpy()
        np.testing.assert_array_equal(recombine(raw, sc).view(np.int32), want.view(np.int32))


def test_chunks_cover_every_child_row_once():
    """The kernel's chunks of a child (window_chunks, then ceil(c / chunks)
    rows a chunk) cut [0, c) into adjacent runs, at most the window's cap of
    them, none empty (an empty child gets one empty chunk, which writes its
    zero table)."""
    for c in (0, 1, 31, 255, 256, 257, 70_001, 524_288):
        for cap in (1, 3, 132):
            wc = window_chunks(c, cap)
            per = -(-c // wc)
            runs = [(x * per, min(x * per + per, c)) for x in range(wc)]
            assert wc <= cap and runs[0][0] == 0 and runs[-1][1] == c
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))
            assert c == 0 or all(hi > lo for lo, hi in runs)


@pytest.mark.parametrize("groups,fill", [(1, 132), (1, 264), (8, 132), (2, 7)])
def test_chunk_plan_shares_the_card_by_rows(groups, fill):
    """plan_chunks: each window at least one chunk, no more than its rows
    need, a larger window never fewer than a smaller one; the launch within
    the scratch that lgbt_grow_step_scratch sizes (fill / groups + 16
    chunks a group)."""
    rng = np.random.default_rng(groups * fill)
    for k in (1, 2, 4, 16):
        for _ in range(20):
            cnts = [int(c) for c in rng.integers(0, 1 << 20, size=k)]
            cnts[0] = 0 if k > 2 else cnts[0]
            chunk0 = plan_chunks(cnts, True, groups, fill)
            caps = np.diff(chunk0)
            assert chunk0[-1] <= fill // groups + seg.MAX_WINDOWS
            assert all(1 <= cap <= max(1, -(-(c // 2) // MIN_ROWS)) for c, cap in zip(cnts, caps))
            order = np.argsort(cnts, kind="stable")
            assert all(np.diff(caps[order]) >= 0)


@pytest.mark.parametrize("k", [0, 17])
def test_launch_refuses_k_outside_1_to_16(k):
    rows, _ = _rows(500, 3, 0)
    mem = seg.split_members(list(range(0, 10 * k, 10)), [5] * k, [0] * k, [1] * k, [0] * k,
                            [-1] * k)
    with pytest.raises(ValueError, match="1 to 16 windows"):
        grow_step._launch(rows, mem, 16, None)


def test_launch_refuses_rows_off_the_card():
    rows, _ = _rows(500, 3, 0)
    mem = seg.split_members([0], [500], [0], [1], [0], [-1])
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        grow_step._launch(rows, mem, 16, None)


def test_kernel_source_agrees_with_the_model():
    """The constants and expressions of lane_hist.cuh and grow_step.cu that
    the model above and the wrapper rely on (the kernels build only on the
    card)."""
    with open(os.path.join(_build.CSRC, "lane_hist.cuh")) as fh:
        src = fh.read()
    assert int(re.search(r"kLanes = (\d+);", src).group(1)) == LANES
    assert int(re.search(r"kMinRowsPerBlock = (\d+);", src).group(1)) == MIN_ROWS
    assert int(re.search(r"kMaxWindows = (\d+);", src).group(1)) == seg.MAX_WINDOWS
    assert re.search(r"kWords = kInt8 \? (\d) : (\d);", src).groups() == (
        str(PLANES[True]), str(PLANES[False]))
    assert int(re.search(r"kReduceThreads = (\d+);", src).group(1)) // int(
        re.search(r"kReduceCells = (\d+);", src).group(1)) == SLICES
    assert "constexpr int kSlices = kReduceThreads / kReduceCells;" in src
    # the election, the chunks and their rows, as the model computes them
    assert "const bool left = l <= c - l;" in src and "s += left ? 0 : l;" in src
    assert "long long n = (c + kMinRowsPerBlock - 1) / kMinRowsPerBlock;" in src
    for line in ("const long long share = fill / groups;",
                 "long long cap = window_chunks(children ? w.cnt[i] / 2 : w.cnt[i], share);",
                 "const long long fair = total > 0 ? share * w.cnt[i] / total : 0;",
                 "if (cap > fair) cap = fair > 0 ? fair : 1;",
                 "const long long blocks = fill + groups * kMaxWindows;",
                 "const long long per = (c + chunks - 1) / chunks;",
                 "const long long i1 = min(i0 + per, c);",
                 "for (long long q = slice; q < chunks; q += kSlices)",
                 "for (int t = 1; t < kSlices; ++t)",
                 "row[0] = ((float)o[0] * 128.0f + (float)o[1]) * sg;"):
        assert line in src, line
    with open(os.path.join(_build.CSRC, "grow_step.cu")) as fh:
        step = fh.read()
    assert '#include "partition.cu"' in step and "lhist::launch<true>(" in step
    decl = re.search(r'extern "C" int lgbt_grow_step\(([^)]*)\)', step).group(1)
    assert len(decl.split(",")) == len(_build.SIGNATURES["grow_step"])
    decl = re.search(r'extern "C" long long lgbt_grow_step_scratch\(([^)]*)\)', step).group(1)
    assert len(decl.split(",")) == len(_build.EXTRA_ENTRIES["grow_step_scratch"][1])
    assert "-fmad=false" in _build.NVCC_FLAGS  # the recombine's rounding
    assert set(_build._includes(_build._paths("grow_step")[0])) == {
        os.path.join(_build.CSRC, name) for name in
        ("partition.cu", "partition_tile.cuh", "lane_hist.cuh", "hist_block.cuh")}
