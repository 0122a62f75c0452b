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
and writes dec.

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

from .test_torch_grow_step import MEMBERS, _jax_members, _jax_seg, _problem, _scales, _torch_rows
from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import jax_interpret
from .test_torch_partition import _assert_same, _clone, _members, _rows, model_partition

# csrc/lane_hist.cuh (test_kernel_source_agrees_with_the_model checks them)
LANES = 32  # features a block's lanes take (kLanes)
MIN_ROWS = 256  # rows a chunk takes at least, where a window has them (kMinRowsPerBlock)
PLANES = {False: 3, True: 5}  # 32-bit planes of a table cell (Table<kInt8>::kWords)
SLICES = 8  # threads of the reduce a cell (kSlices)


def window_chunks(c, cap):
    """lane_hist.cuh window_chunks: the chunks of a window of c rows that
    may take `cap`, at least one."""
    return max(1, min(-(-c // MIN_ROWS), cap))


def plan_chunks(cnts, children, groups, fill):
    """lane_hist.cuh plan_chunks: each window's first chunk, and the
    launch's chunks last."""
    total, share = sum(cnts), fill // groups
    chunk0 = [0]
    for c in cnts:
        cap = window_chunks(c // 2 if children else c, share)
        fair = share * c // total if total > 0 else 0
        if cap > fair:
            cap = fair if fair > 0 else 1
        chunk0.append(chunk0[-1] + cap)
    return chunk0


def recombine(raw: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """The reduce's recombine, one f32 operation at a time (numpy float32
    rounds each as the card does with -fmad=false): [..., 5] i32 digit sums
    -> [..., 3] f32 (g, h, count)."""
    a = raw.astype(np.float32)
    s = scales.astype(np.float32)
    g = (a[..., 0] * np.float32(128.0) + a[..., 1]) * s[0]
    h = (a[..., 2] * np.float32(128.0) + a[..., 3]) * s[1]
    return np.stack([g, h, a[..., 4]], axis=-1)


def _block_table(rows, s, i0, i1, f0, nf, num_bins, scales, rng):
    """One accumulate block's table: [planes, B, 32] over rows [s + i0,
    s + i1) and features [f0, f0 + nf) (lane j: feature f0 + j); int8
    digit sums as i64 (exact), f32 sums in a random order (the atomics')."""
    int8 = scales is not None
    table = torch.zeros((PLANES[int8], num_bins * LANES), dtype=torch.int64 if int8
                        else torch.float32)
    r = s + i0 + torch.as_tensor(rng.permutation(i1 - i0), dtype=torch.int64)
    m = rows.m[r]
    if int8:
        g_hi, g_lo = seg.int8_digits(rows.g[r] * m, scales[0])
        h_hi, h_lo = seg.int8_digits(rows.h[r] * m, scales[1])
        vals = torch.stack([g_hi, g_lo, h_hi, h_lo, (m != 0).to(torch.int32)]).to(torch.int64)
    else:
        vals = torch.stack([rows.g[r] * m, rows.h[r] * m, (m != 0).to(torch.float32)])
    for j in range(nf):
        b = rows.bins[f0 + j, r].to(torch.int64)
        cell, keep = b * LANES + j, b < num_bins
        for p in range(PLANES[int8]):
            table[p].index_add_(0, cell[keep], vals[p][keep])
    return table.reshape(PLANES[int8], num_bins, LANES)


def model_grow_step(rows, mem, num_bins, scales, fill, rng, tile=None):
    """The four launches on the CPU (see the module docstring): partitions
    the rows in place; returns (dec [K, 4] i32, hist [K, F, B, 3] f32)."""
    k, f = len(mem), rows.f
    tile = tile or seg.partition_tile_rows(f, int(mem[:, 1].sum()))
    nl = model_partition(rows, mem, tile, rng).numpy().astype(np.int64)
    groups = -(-f // LANES)
    chunk0 = plan_chunks([int(c) for c in mem[:, 1]], True, groups, fill)

    def child(w):  # hist_window: the elected child of window w
        s, c, l = int(mem[w, 0]), int(mem[w, 1]), int(nl[w])
        return (s, l) if l <= c - l else (s + l, c - l)

    slots = {}
    blocks = [(y, x) for y in range(groups) for x in range(chunk0[-1])]
    for i in rng.permutation(len(blocks)):
        y, x = blocks[i]
        w = max(v for v in range(k) if chunk0[v] <= x)
        s, c = child(w)
        wc = window_chunks(c, chunk0[w + 1] - chunk0[w])
        xi = x - chunk0[w]
        if xi >= wc:  # the block exits at once
            continue
        per = -(-c // wc)
        i0, i1 = xi * per, min(xi * per + per, c)
        assert 0 <= i0 <= i1 <= c  # a chunk never reads past its child
        f0 = y * LANES
        slots[(y, x)] = _block_table(rows, s, i0, i1, f0, min(LANES, f - f0), num_bins, scales,
                                     rng)

    hist = torch.zeros((k, f, num_bins, 3), dtype=torch.float32)
    dec = np.zeros((k, 4), np.int64)
    for w in range(k):
        s, c = child(w)
        dec[w] = (nl[w], int(mem[w, 1]) - nl[w], s, c)
        wc = window_chunks(c, chunk0[w + 1] - chunk0[w])
        for y in range(groups):
            parts = [slots[(y, chunk0[w] + q)] for q in range(wc)]
            assert all((y, x) not in slots for x in range(chunk0[w] + wc, chunk0[w + 1]))
            # thread slice t sums chunks t, t + SLICES, ... in order, then the
            # slices are summed in order
            sliced = []
            for t in range(SLICES):
                acc = torch.zeros_like(parts[0])
                for p in parts[t::SLICES]:
                    acc += p
                sliced.append(acc)
            total = sliced[0]
            for p in sliced[1:]:
                total = total + p
            nf = min(LANES, f - y * LANES)
            cells = total[:, :, :nf].permute(2, 1, 0)  # [nf, B, planes]
            if scales is None:
                hist[w, y * LANES:y * LANES + nf] = cells
            else:
                hist[w, y * LANES:y * LANES + nf] = torch.as_tensor(
                    recombine(cells.numpy(), scales.numpy()))
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
                 "const long long blocks = groups * (fill / groups + kMaxWindows);",
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
