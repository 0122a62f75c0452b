"""The ordered-layout histogram's kernels (csrc/ordered_hist.cu) as a plain
model on the CPU.

The kernels run only on the card.  ``model_ordered_hist`` repeats, in plain
PyTorch, what their two launches compute: the launch's row chunks as
``grid_chunks`` plans them (enough blocks to fill the card once, each of at
least ``kMinRows`` rows, the bin ranges counted in the cap), the accumulate
blocks, one per (row chunk, 32-feature group x bin range, window), in a
random order (blocks of one launch wait on nothing but the launch before),
each taking its chunk of its window's index as the kernel cuts it, adding
the rows whose bin lies in its range of 256 (the others to its trash bin)
and writing its table to its own slot; then the reduce, which sums each
window's slots of a bin's range in chunk order (a bin past the launch's
ranges sums nothing).  u16 rows (bins past a byte) take as many ranges as
the widest feature needs (``ordered_ranges``); u8 rows one.  A block's f32 table
adds its rows in row order where the source's f32 launch is the one-warp
in-order kernel, else in a random order (shared f32 atomics from many
warps); int8 digit sums are integers, the same in any order.

Held against ``ordered_hist_plain`` / ``ordered_hist_int8_raw_plain`` (the
int8 sums exactly, the f32 counts exactly and g/h within
``bench_ordered.ordered_tol``), f32 the same bits whatever order the blocks
run in, and the JAX package's ``leaf_histogram_segment``; then the source's
constants and its f32 accumulate.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.histogram import leaf_histogram_segment

from lightgbm_tpu_torch import _build
from lightgbm_tpu_torch.bench_ordered import ordered_tol
from lightgbm_tpu_torch.ops import histogram as oh

from .lane_hist_model import atomic_types
from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)


def _source() -> str:
    with open(os.path.join(_build.CSRC, "ordered_hist.cu")) as fh:
        return fh.read()


SRC = _source()
LANES = 32  # features of a block's group
# rows a chunk takes at least, where a window has them (Acc<kInt8>::kMinRows)
_MIN = re.search(r"kMinRows = kInt8 \? (\d+) : (\d+);", SRC)
MIN_ROWS = {True: int(_MIN.group(1)), False: int(_MIN.group(2))} if _MIN else {True: 1024,
                                                                                False: 1024}
# the f32 launch is the one-warp kernel that adds a chunk's rows in row order
F32_IN_ORDER = re.search(r"ordered_hist_in_order(<\w+>)?<<<", SRC) is not None


RANGE = 256  # bins of a block's table (kRangeBins)
WORDS = {True: 5, False: 3}  # 32-bit words of a cell (Acc<kInt8>::kWords)


def grid_chunks(int8, k, max_cnt, groups, fill):
    """ordered_hist.cu grid_chunks: the launch's chunks, ``fill`` the
    blocks the card holds at once, ``groups`` the feature groups times the
    bin ranges."""
    chunks = -(-max_cnt // MIN_ROWS[int8])
    return max(1, min(chunks, max(1, fill // (groups * k))))


def scratch_bytes(int8, k, max_cnt, f, num_bins, ranges, fill):
    """ordered_hist.cu scratch_bytes: an image of range_width(num_bins)
    bins for every (window, group, range, chunk) block."""
    groups = -(-f // LANES)
    chunks = grid_chunks(int8, k, max_cnt, groups * ranges, fill)
    return k * groups * ranges * chunks * WORDS[int8] * min(num_bins, RANGE) * LANES * 4


def window_chunks(int8, cnt, grid):
    """ordered_hist.cu window_chunks: a window's chunks, at least one."""
    return max(1, min(-(-cnt // MIN_ROWS[int8]), grid))


def _stats(rows, idx, scales):
    m = rows.m[idx]
    if scales is None:
        return torch.stack([rows.g[idx] * m, rows.h[idx] * m, (m != 0).to(torch.float32)])
    return oh.int8_digit_rows(rows.g[idx], rows.h[idx], m, scales).T.to(torch.int64)


def block_table(rows, idx, f0, nf, lo, width, scales, rng):
    """One accumulate block's table [planes, width, 32] of its bin range
    [lo, lo + width) over the rows ``idx`` (i64, the chunk's window
    positions mapped through the index) and features [f0, f0 + nf): a row
    whose bin lies outside the range adds to the trash bin (dropped here);
    int8 sums exactly; f32 in row order, or with ``rng`` in a random
    order."""
    int8 = scales is not None
    planes = WORDS[int8]
    table = torch.zeros((planes, (width + 1) * LANES),
                        dtype=torch.int64 if int8 else torch.float32)
    if rng is not None:
        idx = idx[torch.as_tensor(rng.permutation(len(idx)), dtype=torch.int64)]
    vals = _stats(rows, idx, scales)
    for j in range(nf):
        b = oh.gather_bins(rows.bins, idx, f0 + j, f0 + j + 1)[:, 0] - lo
        inside = (b >= 0) & (b < width)
        cell = torch.where(inside, b, torch.full_like(b, width)) * LANES + j
        for p in range(planes):
            if int8:
                table[p].index_add_(0, cell, vals[p])
            else:  # one f32 add after another (np.add.at is unbuffered)
                t = table[p].numpy()
                np.add.at(t, cell.numpy(), vals[p].numpy())
    return table.reshape(planes, width + 1, LANES)[:, :width]  # the image: no trash bin


def model_ordered_hist(rows, order, windows, num_bins, scales, fill, rng, in_order=None,
                       slots_out=None):
    """The two launches over K windows of ``order`` (None: of the rows):
    [K, F, B, 3] f32 g/h/count sums, or int8's raw [K, F, B, 5] i64 digit
    sums.  ``in_order``: the f32 blocks' order, by default the source's.
    ``slots_out``: a dict that receives each block's scratch slot index."""
    int8 = scales is not None
    in_order = F32_IN_ORDER if in_order is None else in_order
    k, f = len(windows), rows.f
    groups = -(-f // LANES)
    ranges = oh.ordered_ranges(rows, num_bins)
    width = min(num_bins, RANGE)
    grid = grid_chunks(int8, k, max(c for _, c in windows), groups * ranges, fill)
    slots = {}
    blocks = [(w, y, r, x) for w in range(k) for y in range(groups) for r in range(ranges)
              for x in range(grid)]
    for i in rng.permutation(len(blocks)):
        w, y, r, x = blocks[i]
        s, c = windows[w]
        chunks = window_chunks(int8, c, grid)
        if x >= chunks:  # the block exits at once
            continue
        per = -(-c // chunks)
        i0, i1 = x * per, min(x * per + per, c)
        pos = torch.arange(s + i0, s + max(i0, i1), dtype=torch.int64)
        idx = pos if order is None else order[pos].to(torch.int64)
        f0 = y * LANES
        lo = r * RANGE
        slots[(w, y, r, x)] = block_table(rows, idx, f0, min(LANES, f - f0), lo,
                                          min(width, num_bins - lo), scales,
                                          None if int8 or in_order else rng)
        if slots_out is not None:  # blockIdx.y = group * ranges + range
            slots_out[(w, y, r, x)] = ((w * groups * ranges + y * ranges + r) * grid + x)
    planes = WORDS[int8]
    out = torch.zeros((k, f, num_bins, planes), dtype=torch.int64 if int8 else torch.float32)
    for w in range(k):
        chunks = window_chunks(int8, windows[w][1], grid)
        for y in range(groups):
            nf = min(LANES, f - y * LANES)
            for r in range(ranges):
                total = torch.zeros_like(slots[(w, y, r, 0)])
                for x in range(chunks):  # chunk order
                    total = total + slots[(w, y, r, x)]
                lo = r * RANGE
                out[w, y * LANES:y * LANES + nf, lo:lo + total.shape[1]] = (
                    total[:, :, :nf].permute(2, 1, 0))
    return out


def _rows(n, f, seed, nb=64, used=0):
    """Rows of nb bins (u16 past 256), feature 1 at most 300 wide: a
    feature narrower than the widest."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, size=(n, f)).astype(np.uint16 if nb > 256 else np.uint8)
    if nb > 256:
        bins[:, 1] %= 300
        if used:  # the widest feature's bins
            bins %= used
    grad = rng.normal(size=n).astype(np.float32)
    hess = (rng.random(n) + 0.5).astype(np.float32)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    rows = oh.OrderedRows(bins=oh.row_major_bins(bins, "cpu"), f=f, g=torch.as_tensor(grad),
                          h=torch.as_tensor(hess), m=torch.as_tensor(mask), used_bins=used)
    order = torch.as_tensor(rng.permutation(n).astype(np.int32))
    return rows, order


SCALES = torch.tensor([0.02, 0.01], dtype=torch.float32)
CASES = {
    "root": (None, [(0, 20_000)]),
    "K=2": ("order", [(37, 6_667), (6_704, 10_000)]),
    "K=4 with an empty window": ("order", [(5, 3_000), (3_005, 0), (3_100, 700), (9_000, 31)]),
}


def _check(got, rows, order, wins, num_bins, scales):
    if scales is not None:
        want = oh.ordered_hist_int8_raw_plain(rows, order, wins, num_bins, scales)
        assert torch.equal(got, want.to(torch.int64))
        return
    want = oh.ordered_hist_plain(rows, order, wins, num_bins)
    assert torch.equal(got[..., 2], want[..., 2])  # counts exact
    tol = ordered_tol(rows, order, wins, num_bins, want[..., 2:3])
    assert bool(((got[..., :2] - want[..., :2]).abs() <= tol).all())


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fill", [264, 7])
def test_model_equals_plain(case, mode, fill):
    """20,000 rows x 37 features (two groups of lanes, the second short),
    the root with no index and windows of a shuffled index; many chunks a
    window (fill 264) or one (fill 7)."""
    rows, order = _rows(20_000, 37, seed=len(case) + fill)
    idx, wins = CASES[case]
    idx = order if idx else None
    scales = SCALES if mode == "int8" else None
    got = model_ordered_hist(rows, idx, wins, 64, scales, fill, np.random.default_rng(fill))
    _check(got, rows, idx, wins, 64, scales)


@pytest.mark.parametrize("case", list(CASES))
def test_model_f32_the_same_bits_whatever_the_block_order(case):
    """f32 as the source's f32 launch adds: the same bits with the blocks
    in two other orders (each block in row order, the reduce in chunk
    order)."""
    rows, order = _rows(20_000, 37, seed=3)
    idx, wins = CASES[case]
    idx = order if idx else None
    got = [model_ordered_hist(rows, idx, wins, 64, None, 264, np.random.default_rng(s))
           for s in (11, 12)]
    assert torch.equal(got[0], got[1])


def test_model_equals_jax_leaf_histogram_segment():
    """The K=2 windows against the JAX package's ordered-mode histogram of
    the gathered rows: counts exact, g/h within the f32 tolerance."""
    rows, order = _rows(20_000, 37, seed=5)
    wins = CASES["K=2"][1]
    got = model_ordered_hist(rows, order, wins, 64, None, 264, np.random.default_rng(0))
    for k, (s, c) in enumerate(wins):
        idx = order[s:s + c].numpy().astype(np.int64)
        want = torch.as_tensor(np.array(leaf_histogram_segment(
            jnp.asarray(rows.bins[idx, :rows.f].numpy().astype(np.int32)),
            jnp.asarray(rows.g[idx].numpy()), jnp.asarray(rows.h[idx].numpy()),
            jnp.asarray(rows.m[idx].numpy()), 64)))
        assert torch.equal(got[k, ..., 2], want[..., 2])
        tol = ordered_tol(rows, order, [(s, c)], 64, want[None, ..., 2:3])[0]
        assert bool(((got[k, ..., :2] - want[..., :2]).abs() <= tol).all())


U16_CASES = {
    "root, 4 ranges": (None, [(0, 12_000)], 0),
    "K=3 with an empty window, 3 ranges": ("order", [(5, 3_000), (3_005, 0), (3_100, 6_000)], 700),
    "K=2 under 32 rows, 4 ranges": ("order", [(11, 31), (500, 9_000)], 0),
}


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("case", list(U16_CASES))
@pytest.mark.parametrize("fill", [264, 7])
def test_model_u16_equals_plain(case, mode, fill):
    """u16 rows at 1,024 bins, 37 features (feature 1 at most 300 wide):
    bin ranges of 256 as the widest feature needs (all four, or three when
    no bin reaches 768, the fourth written 0), each block's rows outside its
    range sent to the trash bin."""
    used = U16_CASES[case][2]
    rows, order = _rows(12_000, 37, seed=len(case) + fill, nb=1024, used=used)
    assert rows.wide and oh.ordered_ranges(rows, 1024) == (3 if used else 4)
    idx, wins, _ = U16_CASES[case]
    idx = order if idx else None
    scales = SCALES if mode == "int8" else None
    got = model_ordered_hist(rows, idx, wins, 1024, scales, fill, np.random.default_rng(fill))
    _check(got, rows, idx, wins, 1024, scales)
    if used:
        assert not got[..., 768:, :].any()


def test_model_u16_f32_the_same_bits_whatever_the_block_order():
    rows, order = _rows(12_000, 37, seed=4, nb=1024)
    wins = U16_CASES["K=3 with an empty window, 3 ranges"][1]
    got = [model_ordered_hist(rows, order, wins, 1024, None, 264, np.random.default_rng(s))
           for s in (21, 22)]
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("num_bins,f,k", [(1024, 37, 3), (16384, 28, 1), (256, 700, 4)])
def test_scratch_counts_every_slot_and_the_ranges_in_the_cap(mode, num_bins, f, k):
    """The scratch holds one image a (window, group, range, chunk) block at
    the slot the blocks write (blockIdx.y = group * ranges + range), and the
    launch's blocks stay capped by the fill with the ranges counted: at
    16,384 bins (64 ranges) the scratch is no larger than one range's
    launch, where without the ranges in the cap it would be 64 times it."""
    int8 = mode == "int8"
    fill = 264 * (1 if int8 else 2)  # resident blocks x multiprocessors
    ranges = max(1, num_bins // RANGE)
    need = scratch_bytes(int8, k, 1 << 20, f, num_bins, ranges, fill)
    image = WORDS[int8] * min(num_bins, RANGE) * LANES * 4
    groups = -(-f // LANES)
    chunks = grid_chunks(int8, k, 1 << 20, groups * ranges, fill)
    assert need == k * groups * ranges * chunks * image
    assert k * groups * ranges * chunks <= max(fill, k * groups * ranges)
    one_range = scratch_bytes(int8, k, 1 << 20, f, num_bins, 1, fill)
    assert need <= max(one_range, k * groups * ranges * image)
    # the slots a launch's blocks write, on a small u16 problem
    if num_bins == 1024:
        rows, order = _rows(3_000, f, seed=1, nb=1024)
        wins = [(0, 1_000), (1_000, 0), (1_500, 1_500)]
        slots = {}
        model_ordered_hist(rows, order, wins, 1024, SCALES if int8 else None, fill,
                           np.random.default_rng(0), slots_out=slots)
        grid = grid_chunks(int8, k, 1_500, groups * 4, fill)
        bound = scratch_bytes(int8, k, 1_500, f, 1024, 4, fill) // image
        assert max(slots.values()) < bound == k * groups * 4 * grid


def test_kernel_source_sums_f32_in_row_order():
    """The f32 launch is the one-warp in-order kernel, its accumulate has
    no shared f32 atomics (no atomicAdd in the source adds a float), the
    reduce sums a window's chunks in chunk order (a few chunks' loads
    first, then their adds in order), and the constants the model reads
    are there."""
    assert F32_IN_ORDER and _MIN is not None
    assert "kThreads = kInt8 ? 1024 : 32;" in SRC
    assert atomic_types(SRC) == {"int"}
    assert "for (long long c0 = 0; c0 < chunks; c0 += kLoads) {" in SRC
    assert "long long cap = (long long)resident * sm_count() / ((long long)groups * k);" in SRC
    # the bin ranges count in the cap and in the scratch, and blockIdx.y
    # is group * ranges + range
    assert "grid_chunks<kInt8>(k, max_cnt, groups * ranges, resident)" in SRC
    assert ("return (long long)k * groups * ranges * chunks * "
            "(long long)Acc<kInt8>::image_bytes") in SRC
    assert "dim3 grid((unsigned)chunks, (unsigned)(groups * ranges), (unsigned)k);" in SRC
    assert "group = y / ranges;" in SRC and "constexpr int kRangeBins = 256;" in SRC
    assert "const long long rows_per_block = (cnt + chunks - 1) / chunks;" in SRC
    decl = re.search(r'extern "C" int lgbt_ordered_hist\(([^)]*)\)', SRC).group(1)
    assert len(decl.split(",")) == len(_build.SIGNATURES["ordered_hist"])
