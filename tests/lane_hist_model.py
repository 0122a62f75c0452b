"""A plain model on the CPU of the lane histogram's two launches
(csrc/lane_hist.cuh), shared by the models of the segment histogram
(test_torch_seg_hist_model.py: the host's windows) and of the fused grow
step (test_torch_grow_step_model.py: the elected children).

The kernels run only on the card.  ``model_lane_hist`` repeats, in plain
PyTorch, what their two launches compute: the accumulate blocks, one per
(row chunk, 32-feature group), each window's chunks as ``plan_chunks`` plans
them, in a random order (blocks of one launch wait on nothing but the launch
before), each taking its chunk of its window's rows as the kernel cuts them
and writing its table to its own slot; then the reduce, which sums each
window's slots in the kernel's fixed order and recombines the int8 digit
sums as the kernel does.  A block's f32 table adds its rows in row order
(one warp, the block's only thread of each cell) or, where the header's
``Acc`` gives the caller's f32 blocks shared atomics, in a random order
(``source_in_order`` reads which from the source).
"""

import os
import re

import numpy as np
import torch

from lightgbm_tpu_torch import _build
from lightgbm_tpu_torch.ops import seg

# csrc/lane_hist.cuh (the models' tests check them against the source)
LANES = 32  # features a block's lanes take (kLanes)
MIN_ROWS = 256  # rows a chunk takes at least, where a window has them (kMinRowsPerBlock)
PLANES = {False: 3, True: 5}  # 32-bit planes of a table cell (Table<kInt8>::kWords)
SLICES = 8  # threads of the reduce a cell (kSlices)


def source_in_order(int8: bool, seg_caller: bool) -> bool:
    """Whether lane_hist.cuh's ``Acc<kInt8, kSeg>`` adds a block's rows in
    row order (its ``kInOrder`` expression, evaluated for the caller: the
    segment histogram, ``seg_caller``, or the fused grow step)."""
    with open(os.path.join(_build.CSRC, "lane_hist.cuh")) as fh:
        expr = re.search(r"static constexpr bool kInOrder = ([^;]+);", fh.read()).group(1)
    expr = expr.replace("&&", " and ").replace("||", " or ").replace("!", " not ")
    return bool(eval(expr, {}, {"kInt8": int8, "kSeg": seg_caller, "true": True,
                                "false": False}))


def atomic_types(src: str) -> set:
    """The element types of the operands of every ``atomicAdd`` in a
    source, from the declarations of the names they index (``int* s``,
    ``float* sf``, ``int smem[]``)."""
    words = {"int", "unsigned", "float", "double", "half", "uint32_t", "int32_t", "long"}
    types = set()
    for name in set(re.findall(r"atomicAdd\(\s*&\s*(\w+)\s*\[", src)):
        decl = re.findall(r"(\w+)\s*\*\s*(?:const\s+)?(?:__restrict__\s+)?%s\b" % name, src)
        decl += re.findall(r"(\w+)\s+%s\s*\[" % name, src)
        types.update([t for t in decl if t in words] or ["?"])
    return types


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


def chunk_rows(c, cap):
    """The [i0, i1) runs of a window of c rows that window_chunks cuts
    for `cap` chunks: ceil(c / chunks) rows a chunk."""
    wc = window_chunks(c, cap)
    per = -(-c // wc)
    return [(x * per, min(x * per + per, c)) for x in range(wc)]


def recombine(raw: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """The reduce's recombine, one f32 operation at a time (numpy float32
    rounds each as the card does with -fmad=false): [..., 5] i32 digit sums
    -> [..., 3] f32 (g, h, count)."""
    a = raw.astype(np.float32)
    s = scales.astype(np.float32)
    g = (a[..., 0] * np.float32(128.0) + a[..., 1]) * s[0]
    h = (a[..., 2] * np.float32(128.0) + a[..., 3]) * s[1]
    return np.stack([g, h, a[..., 4]], axis=-1)


def block_table(rows, s, i0, i1, f0, nf, num_bins, scales, rng=None):
    """One accumulate block's table: [planes, B, 32] over rows [s + i0,
    s + i1) and features [f0, f0 + nf) (lane j: feature f0 + j); int8
    digit sums as i64 (exact), f32 sums in a random order (``rng``: the
    shared atomics') or, with no ``rng``, in row order (the in-order warp:
    one add after another from +0.0)."""
    int8 = scales is not None
    table = torch.zeros((PLANES[int8], num_bins * LANES), dtype=torch.int64 if int8
                        else torch.float32)
    order = np.arange(i1 - i0) if rng is None else rng.permutation(i1 - i0)
    r = s + i0 + torch.as_tensor(order, dtype=torch.int64)
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
            if int8 or rng is not None:
                table[p].index_add_(0, cell[keep], vals[p][keep])
            else:  # one f32 add after another, in row order (np.add.at is unbuffered)
                t = table[p].numpy()
                np.add.at(t, cell[keep].numpy(), vals[p][keep].numpy())
    return table.reshape(PLANES[int8], num_bins, LANES)


def model_lane_hist(rows, windows, chunk0, num_bins, scales, rng, in_order=False):
    """The two launches over K windows [(start, cnt)], window w taking
    chunks [chunk0[w], chunk0[w + 1]) of the launch: the accumulate blocks
    in a random order (``rng``), each table to its own slot (f32 in row
    order with ``in_order``), then the reduce's fixed order and recombine.
    Returns [K, F, B, 3] f32."""
    k, f = len(windows), rows.f
    groups = -(-f // LANES)
    slots = {}
    blocks = [(y, x) for y in range(groups) for x in range(chunk0[-1])]
    for i in rng.permutation(len(blocks)):
        y, x = blocks[i]
        w = max(v for v in range(k) if chunk0[v] <= x)
        s, c = windows[w]
        runs = chunk_rows(c, chunk0[w + 1] - chunk0[w])
        xi = x - chunk0[w]
        if xi >= len(runs):  # the block exits at once
            continue
        i0, i1 = runs[xi]
        assert 0 <= i0 <= i1 <= c  # a chunk never reads past its window
        f0 = y * LANES
        slots[(y, x)] = block_table(rows, s, i0, i1, f0, min(LANES, f - f0), num_bins, scales,
                                    None if in_order else rng)

    hist = torch.zeros((k, f, num_bins, 3), dtype=torch.float32)
    for w in range(k):
        wc = window_chunks(windows[w][1], chunk0[w + 1] - chunk0[w])
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
    return hist
