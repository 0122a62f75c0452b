"""The segment histogram's kernels (csrc/seg_hist.cu: the lane histogram of
csrc/lane_hist.cuh on the host's windows) as a plain model on the CPU.

The kernels run only on the card.  ``model_seg_hist`` repeats, in plain
PyTorch, what their two launches compute (``lane_hist_model``, shared with
test_torch_grow_step_model.py): the chunks of the host's windows planned as
the C entry plans them (``plan_chunks(children=False)``), the accumulate
blocks in a random order, each adding its chunk's rows (f32: in row order,
as the kernel's one warp a block does) into its own slot, then the reduce's
fixed order and the int8 recombine.

Held against ``seg_hist_batch_plain`` (the int8 histogram bit for bit, the
f32 one's counts exactly and g/h within chip_smoke.py's f32 tolerance,
``_bench.f32_tol``; f32 the same bits whatever order the blocks run in) and
the JAX package's ``seg_hist_pallas_batch`` in interpret mode; then the
plan's cover of every window row, the C entry's source and the wrapper's
split of more than 16 windows and its refusals.
"""

import inspect
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.pallas.seg import seg_hist_pallas_batch

from lightgbm_tpu_torch import _build, bench_partition, bench_seg_hist
from lightgbm_tpu_torch._bench import f32_tol
from lightgbm_tpu_torch.ops import seg

from .lane_hist_model import LANES, chunk_rows, model_lane_hist, plan_chunks, source_in_order
from .test_torch_grow_step import _jax_seg, _problem, _scales, _torch_rows
from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_interpret import jax_interpret


def model_seg_hist(rows, windows, num_bins, scales, fill, rng):
    """The two launches of lgbt_seg_hist on the CPU: [K, F, B, 3] f32."""
    wins = [(int(s), max(int(c), 0)) for s, c in windows]
    groups = -(-rows.f // LANES)
    chunk0 = plan_chunks([c for _, c in wins], False, groups, fill)
    return model_lane_hist(rows, wins, chunk0, num_bins, scales, rng,
                           in_order=source_in_order(scales is not None, True))


def _check(got, want, rows, windows, num_bins, scales):
    assert torch.equal(got[..., 2], want[..., 2])  # counts exact
    if scales is not None:
        assert torch.equal(got, want)
        return
    tol = f32_tol(rows, windows, num_bins, want[..., 2:3])
    assert bool(((got[..., :2] - want[..., :2]).abs() <= tol).all())


def _windows(n, rng, k):
    """k disjoint windows at unaligned starts: empty ones among them, some
    under 32 rows, the last one ending at row n."""
    cuts = np.sort(rng.choice(np.arange(1, n), size=2 * k - 1, replace=False))
    starts = cuts[0::2]
    ends = np.append(cuts[1::2], n)
    cnts = ends - starts
    if k > 2:
        cnts[rng.integers(k - 1)] = 0
        j = int(rng.integers(k - 1))
        cnts[j] = min(int(cnts[j]), int(rng.integers(1, 32)))
    return [(int(s), int(c)) for s, c in zip(starts, cnts)]


def _scales_of(rows, mode):
    return bench_seg_hist.int8_scales(rows) if mode == "int8" else None


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("k,seed,fill", [(1, 0, 132), (2, 1, 7), (8, 2, 264), (16, 3, 132)])
def test_model_equals_plain_on_random_windows(k, seed, fill, mode):
    """Random windows (empty ones, ones under 32 rows, unaligned starts, one
    ending at row n), 37 features (two groups of lanes), many chunks a
    window; f32 the same bits with the blocks in another order."""
    rng = np.random.default_rng(seed)
    rows, _ = bench_partition.synthetic_rows(24_000, 37, torch.device("cpu"), seed=seed)
    wins = _windows(rows.n, rng, k)
    scales = _scales_of(rows, mode)
    got = model_seg_hist(rows, wins, 256, scales, fill, rng)
    _check(got, seg.seg_hist_batch_plain(rows, wins, 256, scales), rows, wins, 256, scales)
    if scales is None:
        again = model_seg_hist(rows, wins, 256, None, fill, np.random.default_rng(seed + 99))
        assert torch.equal(got, again)


@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("case", list(bench_seg_hist.cases(200_000))
                         + list(bench_seg_hist.edge_cases(200_000)))
def test_model_equals_plain_on_the_bench_cases(case, mode):
    """The bench's timed cases and edge cases at 200,000 rows x 5 features."""
    rows, _ = bench_partition.synthetic_rows(200_000, 5, torch.device("cpu"), seed=4)
    wins = {**bench_seg_hist.cases(rows.n), **bench_seg_hist.edge_cases(rows.n)}[case]
    scales = _scales_of(rows, mode)
    got = model_seg_hist(rows, wins, 256, scales, 132, np.random.default_rng(5))
    _check(got, seg.seg_hist_batch_plain(rows, wins, 256, scales), rows, wins, 256, scales)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_model_equals_plain_at_64_bins(mode):
    """The bench's 64-bin table (``few_bins``): the root and K=3 windows."""
    rows, _ = bench_partition.synthetic_rows(30_000, 6, torch.device("cpu"), seed=6)
    small = bench_seg_hist.few_bins(rows)
    scales = _scales_of(small, mode)
    for wins in ([(0, small.n)], [(17, 9_000), (9_100, 0), (20_003, 9_997)]):
        got = model_seg_hist(small, wins, 64, scales, 264, np.random.default_rng(7))
        _check(got, seg.seg_hist_batch_plain(small, wins, 64, scales), small, wins, 64, scales)


@pytest.mark.parametrize("mode", ["f32", "int8"])
def test_model_equals_jax_seg_hist_pallas_batch(mode):
    """K=4 windows (one of one row, one empty) against the JAX package's
    kernel in interpret mode: int8 bit for bit; f32 counts exactly and g/h
    within 5e-6 relative (the TPU kernel splits each addend into three bf16
    digits, test_torch_seg.py)."""
    bins, grad, hess, mask = _problem(n=2000, f=5, nb=64, seed=2)
    rows = _torch_rows(bins, grad, hess, mask)
    seg_j, n_pad = _jax_seg(bins, grad, hess, mask)
    windows = [(0, 2000), (130, 333), (1999, 1), (500, 0)]
    st, sj = _scales(grad, hess, mask)
    kw = dict(f=5, num_bins=64, n_pad=n_pad, interpret=True)
    with jax_interpret(grow_step=False):
        if mode == "int8":
            want = seg_hist_pallas_batch(seg_j, jnp.asarray(windows, jnp.int32), sj,
                                         quantized=True, **kw)
        else:
            want = seg_hist_pallas_batch(seg_j, jnp.asarray(windows, jnp.int32), **kw)
    want = torch.as_tensor(np.array(want))
    got = model_seg_hist(rows, windows, 64, st if mode == "int8" else None, 5,
                         np.random.default_rng(0))
    if mode == "int8":
        assert torch.equal(got, want)
    else:
        assert torch.equal(got[..., 2], want[..., 2])
        assert float((got - want).abs().max() / want.abs().max()) < 5e-6
    assert not got[3].any()  # cnt = 0: a zero histogram


def test_chunks_cover_every_window_row_once():
    """plan_chunks(children=False) then window_chunks: every row of every
    window in exactly one chunk, no chunk empty but an empty window's one
    (which writes its zero table), a window's chunks within its share."""
    rng = np.random.default_rng(8)
    for groups, fill in ((1, 132), (1, 264), (8, 264), (2, 7)):
        for k in (1, 2, 8, 16):
            for _ in range(10):
                wins = _windows(1 << 20, rng, k)
                chunk0 = plan_chunks([c for _, c in wins], False, groups, fill)
                for w, (_, c) in enumerate(wins):
                    cap = chunk0[w + 1] - chunk0[w]
                    runs = chunk_rows(c, cap)
                    assert 1 <= len(runs) <= cap
                    covered = np.zeros(c, np.int64)
                    for lo, hi in runs:
                        assert hi > lo or c == 0
                        covered[lo:hi] += 1
                    assert bool((covered == 1).all())
                assert chunk0[-1] <= fill // groups + seg.MAX_WINDOWS


def test_kernel_source_runs_the_lane_histogram_on_host_windows():
    """The C entry of csrc/seg_hist.cu: the header's two launches with no
    left counts and no dec, f32 in row order, no global atomics, no zeroed
    output; its arities as _build gives them; the old block histogram gone
    from hist_block.cuh."""
    with open(os.path.join(_build.CSRC, "seg_hist.cu")) as fh:
        src = fh.read()
    assert '#include "lane_hist.cuh"' in src
    for mode in ("true", "false"):
        call = re.search(r"lhist::launch<%s, true>\(([^;]*)\);" % mode, src).group(1)
        args = [a.strip() for a in call.split(",")]
        assert args[6] == "nullptr" and args[12] == "nullptr"  # nl, dec
    assert "atomicAdd" not in src and "cudaMemset" not in src.split("#ifdef HIST_TRACE")[0]
    decl = re.search(r'extern "C" int lgbt_seg_hist\(([^)]*)\)', src).group(1)
    assert len(decl.split(",")) == len(_build.SIGNATURES["seg_hist"])
    decl = re.search(r'extern "C" long long lgbt_seg_hist_scratch\(([^)]*)\)', src).group(1)
    assert len(decl.split(",")) == len(_build.EXTRA_ENTRIES["seg_hist_scratch"][1])
    assert "lhist::scratch_bytes<true, true>" in src
    assert set(_build._includes(_build._paths("seg_hist")[0])) == {
        os.path.join(_build.CSRC, name) for name in ("lane_hist.cuh", "hist_block.cuh")}
    with open(os.path.join(_build.CSRC, "hist_block.cuh")) as fh:
        assert "BlockHist" not in fh.read()
    with open(os.path.join(_build.CSRC, "lane_hist.cuh")) as fh:
        lane = fh.read()
    assert "static constexpr bool kInOrder = !kInt8;" in lane
    assert "kWarps = kInt8 ? (kSeg ? 32 : 16) : 1;" in lane
    launch = inspect.getsource(seg._seg_hist_launch)
    assert "torch.empty((k, f, num_bins, 3)" in launch
    assert "zeros" not in launch and "combine_int8" not in launch


class _OffTheCPU(seg.SegRows):
    """CPU rows that report another device (PyTorch's ``meta``, which
    allocates no memory), to reach the wrapper's launch path without a
    card."""

    @property
    def device(self):
        return torch.device("meta")


def test_wrapper_splits_more_than_16_windows(monkeypatch):
    """seg_hist_batch on 37 windows: three launches of 16, 16 and 5 windows
    in order, concatenated; every window empty: no launch."""
    rows, _ = bench_partition.synthetic_rows(6_000, 4, torch.device("cpu"), seed=9)
    card = _OffTheCPU(rows.bins, rows.g, rows.h, rows.m, rows.ridx)
    calls = []

    def launch(r, wins, num_bins, scales, fn=None):
        calls.append(len(wins))
        return seg.seg_hist_batch_plain(rows, wins, num_bins, scales)

    monkeypatch.setattr(seg, "_require_cuda", lambda r: None)
    monkeypatch.setattr(seg, "_seg_hist_launch", launch)
    wins = [(i * 150 + 7, (i * 37) % 140) for i in range(37)]
    for scales in (None, bench_seg_hist.int8_scales(rows)):
        calls.clear()
        got = seg.seg_hist_batch(card, wins, 256, scales)
        assert calls == [16, 16, 5]
        assert torch.equal(got, seg.seg_hist_batch_plain(rows, wins, 256, scales))
    calls.clear()
    empty = seg.seg_hist_batch(card, [(5, 0), (900, 0)], 256)
    assert calls == [] and empty.shape == (2, 4, 256, 3) and empty.device.type == "meta"


def test_wrapper_refuses_int8_windows_past_max_int8_rows():
    rows, _ = bench_partition.synthetic_rows(100, 2, torch.device("cpu"), seed=10)
    with pytest.raises(ValueError, match="int8 histogram windows hold at most"):
        seg.seg_hist_batch(rows, [(0, seg.MAX_INT8_ROWS + 1)], 16, torch.ones(2))


@pytest.mark.parametrize("k", [0, 17])
def test_launch_refuses_k_outside_1_to_16(k):
    rows, _ = bench_partition.synthetic_rows(500, 3, torch.device("cpu"), seed=11)
    with pytest.raises(ValueError, match="1 to 16 windows"):
        seg._seg_hist_launch(rows, [(i, 1) for i in range(k)], 16, None)


def test_launch_refuses_rows_off_the_card():
    rows, _ = bench_partition.synthetic_rows(500, 3, torch.device("cpu"), seed=11)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        seg._seg_hist_launch(rows, [(0, 500)], 16, None)
