"""Fused grow step: partition, smaller-child election and the smaller
child's histogram of K disjoint leaf windows in one call.

Counterpart of ``lightgbm_tpu/ops/pallas/grow_step.py`` (``fused_grow_step``
:318, kernel ``fused_grow_step_pallas`` :218).  ``fused_grow_step``
dispatches on the device of the rows: on the CPU it runs the plain version,
the XLA oracle of grow_step.py:388-411 (a stable partition of each window,
the election ``nl <= nr`` picks the left child, the histogram of the
smaller child), on a CUDA device it calls ``csrc/grow_step.cu``: the
partition kernels of ``csrc/partition.cu`` then the histogram of
``csrc/lane_hist.cuh`` on each elected child, four launches with no host
read between them, counted once a call in
``_build.LAUNCHES['fused_grow_step']`` (and ``'fused_grow_step_table'`` when
a live member partitions by its goes-left table, ``'fused_grow_step_wtable'``
too when a table passes 256 bins, ``'fused_grow_step_u16'``
on u16 rows, ``'fused_grow_step_live'`` with a dead feature: the
histogram's live mode, ``seg.feature_order``).  A member splits by its
threshold or, as the TPU kernel's ``cat_ref`` operand (grow_step.py:95,
:224-226), by a [B] bool goes-left table: an EFB bundle-plane split or a
categorical one, of any width up to the padded bins (``seg.split_members``'
wide rows).  Past
256 bins (the TPU kernel's ``wide`` mode, grow_step.py:231) the rows are
the u16 mode's byte planes (``SegRows.wide``) and the histogram runs
``seg.hist_ranges`` bin ranges.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from .seg import (
    MAX_INT8_ROWS,
    MAX_WINDOWS,
    SegRows,
    _device_scales,
    count_table_modes,
    feature_order,
    kernel_members,
    hist_ranges,
    partition_scratch,
    partition_tile_rows,
    seg_hist_batch_plain,
    sort_partition_batch_plain,
    split_members,
)


def _decision(mem: np.ndarray, nl: np.ndarray) -> np.ndarray:
    """[K, 4] (nl, nr, child_start, child_cnt) from the left counts."""
    nr = mem[:, 1] - nl
    left_smaller = nl <= nr
    return np.stack(
        [nl, nr, mem[:, 0] + np.where(left_smaller, 0, nl),
         np.where(left_smaller, nl, nr)], axis=1,
    ).astype(np.int32)


def fused_grow_step_plain(
    rows: SegRows, mem: np.ndarray, num_bins: int, quant_scales=None, live=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The oracle composition: K stable partitions (disjoint windows, so
    their order does not matter), the local election, the K smaller
    children's histograms (the features outside ``live`` 0).  Returns (dec
    [K, 4] i32, hist [K, F, B, 3])."""
    nl = sort_partition_batch_plain(rows, mem).cpu().numpy().astype(np.int64)
    dec = _decision(mem, nl)
    hist = seg_hist_batch_plain(rows, dec[:, 2:4], num_bins, quant_scales, live)
    return torch.as_tensor(dec, device=rows.device), hist


def fused_grow_step(
    rows: SegRows,
    sbegins: Sequence[int],  # [K] window begins (disjoint windows)
    cnts: Sequence[int],  # [K] window rows (0: a no-op member)
    feats: Sequence[int],  # [K] split feature
    tbins: Sequence[int],  # [K] threshold bin: bin <= tbin goes left
    dls: Sequence[int],  # [K] missing values (the NaN bin) go left
    nanbs: Sequence[int],  # [K] NaN bin of the feature, -1 if none
    num_bins: int,
    quant_scales: Optional[torch.Tensor] = None,  # [2] f32: int8 grid
    iscats: Optional[Sequence[int]] = None,  # [K] partition by the table
    tables: Optional[Sequence] = None,  # [K] [B] bool goes-left tables (or None)
    live: Optional[Sequence[int]] = None,  # the histogram's live features (None: all)
):
    """K fused partition + election + histogram steps.  Partitions the rows
    in place and returns (nl, nr, child_start, child_cnt) as [K] i32 and the
    smaller children's histograms [K, F, B, 3] f32 (int8 2-digit grid when
    ``quant_scales`` is given; the features outside ``live`` 0), all on the
    rows' device."""
    mem = split_members(sbegins, cnts, feats, tbins, dls, nanbs, iscats, tables)
    # the smaller child of a window holds at most cnt // 2 rows
    if quant_scales is not None and int(mem[:, 1].max(initial=0)) // 2 > MAX_INT8_ROWS:
        raise ValueError(
            f"int8 histogram windows hold at most {MAX_INT8_ROWS} rows "
            "(exact i32 digit sums)"
        )
    if rows.device.type == "cpu":
        dec, hist = fused_grow_step_plain(rows, mem, num_bins, quant_scales, live)
    else:
        dec, hist = _launch(rows, mem, num_bins, quant_scales, live=live)
    return dec[:, 0], dec[:, 1], dec[:, 2], dec[:, 3], hist


@functools.lru_cache(maxsize=None)
def scratch_bytes(f: int, num_bins: int, int8: bool) -> int:
    """Bytes of the histogram scratch a step over any K <= 16 windows needs
    (``lgbt_grow_step_scratch``: the head, then one image of a block's table
    for each block the card holds at once)."""
    nbytes = int(_build.entry("grow_step_scratch")(f, num_bins, int(int8)))
    if nbytes < 0:
        _build.check(-nbytes, "fused grow step scratch")
    return nbytes


def _launch(rows: SegRows, mem: np.ndarray, num_bins: int, quant_scales, fn=None, live=None):
    """One call of the ``csrc/grow_step.cu`` entry (``fn``: another build of
    it) on K members ([K, MEMBER_COLS] i64, or wide rows whose table words
    go to the card): (dec [K, 4] i32, hist [K, F, B, 3] f32) on
    the card, the histogram of the features of ``live`` (None: all).  The
    partition's buffers and the histogram scratch live on the rows; only
    the two outputs are allocated."""
    k, f = mem.shape[0], rows.f
    if not 1 <= k <= MAX_WINDOWS:
        raise ValueError(f"fused_grow_step takes 1 to {MAX_WINDOWS} windows, got {k}")
    ranges = hist_ranges(rows, int(num_bins))
    ps = partition_scratch(rows)
    dev = rows.device
    need = scratch_bytes(f, int(num_bins), quant_scales is not None)
    if rows.step is None or rows.step.numel() < need:
        rows.step = torch.empty(need, dtype=torch.uint8, device=dev)
    dec = torch.empty((k, 4), dtype=torch.int32, device=dev)
    out = torch.empty((k, f, num_bins, 3), dtype=torch.float32, device=dev)
    scales = None if quant_scales is None else _device_scales(quant_scales, dev)
    order, nlive = feature_order(rows, live)
    cmem, wt, ww = kernel_members(mem, dev)
    rc = (fn or _build.entry("grow_step"))(
        rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(), rows.m.data_ptr(),
        rows.ridx.data_ptr(), rows.n, rows.planes, cmem.ctypes.data, k,
        partition_tile_rows(rows.planes, int(mem[:, 1].sum()), ww), ps.planes.data_ptr(),
        ps.cols.data_ptr(), ps.stride, ps.status.data_ptr(), ps.staged.data_ptr(),
        ps.counter.data_ptr(), ps.next_epoch(), int(num_bins), ranges, order.data_ptr(), nlive,
        None if scales is None else scales.data_ptr(),
        rows.step.data_ptr(), rows.step.numel(), dec.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
        # the wide tables close the call, as in seg._partition_launch
        None if wt is None else wt.data_ptr(), ww,
    )
    _build.check(rc, "fused grow step kernels")
    _build.LAUNCHES["fused_grow_step"] += 1
    count_table_modes("fused_grow_step", mem)
    if rows.wide:
        _build.LAUNCHES["fused_grow_step_u16"] += 1
    if nlive < f:
        _build.LAUNCHES["fused_grow_step_live"] += 1
    return dec, out
