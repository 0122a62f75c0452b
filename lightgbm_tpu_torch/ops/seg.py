"""Segment-resident training rows: leaf-ordered windows, their histogram
and their stable partition.

Counterpart of ``lightgbm_tpu/ops/pallas/seg.py`` and
``lightgbm_tpu/ops/segpart.py``.  The training rows are kept PHYSICALLY in
leaf order: every leaf of the growing tree owns one contiguous window
``[start, start + cnt)``.  A split partitions its leaf's window stably in
place (left rows first, each side in its old order), and a histogram is one
pass over a contiguous window, with no gathers.

Layout (the port's; the TPU packed everything into i16 planes): separate
contiguous columns, bins u8 feature-major ``[F, n]`` (one feature of
consecutive rows is one run of bytes), g/h/mask f32 ``[n]`` and the original
row index ``ridx`` i32 ``[n]``.  The two contracts of the TPU layout hold:
stable leaf-ordered windows, and the ``[F, B, 3]`` (g, h, count) histogram
that ``combine_hist_raw`` returns.

The u16 mode (``SegRows.wide``): past 256 padded bins the TPU packs one u16
plane a feature (lightgbm_tpu/ops/pallas/seg.py:96, :111-115); here a
feature is two byte planes, lo at plane 2j and hi at 2j + 1 (``[2F, n]``
u8, ``byte_planes``), so the partition moves planes of bytes whatever they
mean and only its decision and the histogram read a feature's bin as
``lo | hi << 8``.  The histogram kernel then takes the bins in ranges of
``RANGE_BINS`` (``hist_ranges``: enough for the widest feature's bins,
``SegRows.used_bins``).

``seg_hist_batch`` (kernel ``csrc/seg_hist.cu``: K windows per call, f32
sums or the int8 2-digit grid, the lane histogram of ``csrc/lane_hist.cuh``
in two launches), ``sort_partition`` and
``sort_partition_batch`` (kernel ``csrc/partition.cu``: one window, or K
disjoint windows per call) dispatch on the device of the tensors they are given:
on the CPU they run their plain PyTorch versions, on a CUDA device they
launch the kernel.  Each counts its kernel launches in ``_build.LAUNCHES``
(and, on u16 rows, under its name with ``_u16`` too; a partition by
goes-left tables with ``_table``, and with ``_wtable`` where a table passes
256 bins: a categorical split past 256 bins, ``split_members``' wide rows).

The live mode (the TPU kernels' ``live`` plane-group mask, seg.py:62-65):
the histograms take the tree's live features (``live``: the feature mask's,
feature 0 always among them; None, every feature), read only those, and
write every other feature's cells 0.  The kernel takes them as a feature
order, the live ones first (``feature_order``); a call with a dead feature
counts under its name with ``_live`` too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import _build


@dataclasses.dataclass
class SegRows:
    """The leaf-ordered training rows of one tree (updated in place)."""

    bins: torch.Tensor  # [P, n] u8: P = F, or 2F byte planes when wide
    g: torch.Tensor  # [n] f32
    h: torch.Tensor  # [n] f32
    m: torch.Tensor  # [n] f32 (1 in bag, 0 out)
    ridx: torch.Tensor  # [n] i32 original row index
    # the u16 mode: feature j's bin is bins[2j] | bins[2j + 1] << 8
    wide: bool = False
    # every bin lies below this (the widest feature's bins; 0: unknown, the
    # histogram's padded width): sizes the u16 mode's histogram ranges
    used_bins: int = 0
    # the partition kernel's buffers, made at its first call on these rows
    part: Optional["PartitionScratch"] = dataclasses.field(default=None, repr=False,
                                                           compare=False)
    # the lane histogram's scratch (csrc/lane_hist.cuh), likewise, shared by
    # the fused grow step (ops/grow_step.py) and seg_hist_batch: both use it
    # in stream order on one stream, and it grows to the larger need
    step: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False, compare=False)
    # the histogram kernels' feature order of the last live set (its key,
    # the order on the rows' device, its live count)
    order: Optional[tuple] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return int(self.g.shape[0])

    @property
    def planes(self) -> int:
        return int(self.bins.shape[0])

    @property
    def f(self) -> int:
        """Features (a plane each, or two in the u16 mode)."""
        return self.planes // 2 if self.wide else self.planes

    @property
    def device(self) -> torch.device:
        return self.g.device


def pack_rows(
    bins_fn: torch.Tensor,  # [F, N] u8 feature-major, or [2F, N] byte planes (wide)
    grad: torch.Tensor,  # [N] f32
    hess: torch.Tensor,  # [N] f32
    mask: torch.Tensor,  # [N] f32
    wide: bool = False,
    used_bins: int = 0,
) -> SegRows:
    """Rows in their original order (ridx = iota), ready for the root
    histogram.  The bins are copied: the tree partitions them in place."""
    n = int(grad.shape[0])
    if wide and int(bins_fn.shape[0]) % 2:
        raise ValueError("u16 seg rows hold two byte planes a feature")
    return SegRows(
        bins=bins_fn.clone(),
        g=grad.to(torch.float32).contiguous().clone(),
        h=hess.to(torch.float32).contiguous().clone(),
        m=(mask > 0).to(torch.float32),
        ridx=torch.arange(n, dtype=torch.int32, device=grad.device),
        wide=wide,
        used_bins=int(used_bins),
    )


def byte_planes(bins: torch.Tensor) -> torch.Tensor:
    """[F, N] integer bins below 65,536 -> the u16 mode's [2F, N] u8 byte
    planes (lo at 2j, hi at 2j + 1)."""
    b = bins.to(torch.int32)
    f, n = int(b.shape[0]), int(b.shape[1])
    return torch.stack([b & 0xFF, b >> 8], dim=1).reshape(2 * f, n).to(torch.uint8)


def feature_bins(rows: SegRows, win, feat: Optional[int] = None) -> torch.Tensor:
    """The bins of rows ``win`` (a slice, or an index tensor) as i64: [F,
    cnt], or [cnt] of feature ``feat`` (the u16 mode's lo | hi << 8)."""
    if not rows.wide:
        planes = rows.bins[:, win] if feat is None else rows.bins[feat, win]
        return planes.to(torch.int64)
    lo = slice(0, None, 2) if feat is None else 2 * feat
    hi = slice(1, None, 2) if feat is None else 2 * feat + 1
    return rows.bins[lo, win].to(torch.int64) | (rows.bins[hi, win].to(torch.int64) << 8)


def go_left(col: torch.Tensor, tbin: int, dl: bool, nanb: int, table=None) -> torch.Tensor:
    """Split predicate in bin space (ops/segpart.py:52): bin <= the
    threshold bin, or the NaN bin when missing values go left; or, given a
    goes-left ``table`` ([B] bool of any width: an EFB bundle-plane split or
    a categorical one, the branch of lightgbm_tpu/ops/pallas/partition.py:
    271-285), the table's entry of the bin (a bin past its end goes right,
    as there and in ops/segpart.py:57).
    ``col``: a u8 column, or the u16 mode's bins as integers."""
    if table is not None:
        t = torch.as_tensor(np.asarray(table, bool), device=col.device)
        c = col.long()
        return t[torch.clamp(c, max=len(t) - 1)] & (c < len(t))
    gl = col <= tbin
    if dl and nanb >= 0:
        gl = gl | (col == nanb)
    return gl


# a member row of the partition kernels (csrc/partition.cu kMemberCols):
# start, cnt, feat, tbin, dl, nanb, iscat, then the goes-left table as
# TABLE_WORDS u32 words (bit v & 31 of word v >> 5 for bin v), which travel
# in the launch's parameters.  Where a table sends a bin at or past
# TABLE_BINS left (a categorical split past 256 bins), the rows are wider,
# 7 + W columns with W = ceil(widest table / 32) words a table, and the
# wrappers give the kernel the words as a [K, W] u32 array on the card
# (``wide_words``).
TABLE_BINS = 256
TABLE_WORDS = TABLE_BINS // 32
MEMBER_COLS = 7 + TABLE_WORDS


def _words(t: np.ndarray, words: int) -> np.ndarray:
    """[words] i64 words of the bool bits ``t`` (at most 32 * words)."""
    full = np.zeros(32 * words, bool)
    full[: len(t)] = t
    bits = full.reshape(words, 32).astype(np.int64)
    return (bits << np.arange(32, dtype=np.int64)).sum(axis=1)


def table_words(table, words: int = TABLE_WORDS) -> np.ndarray:
    """[words] i64 words of a goes-left table ([B] bool, 1 <= B; bins past
    its end go right, as ``go_left`` reads them); raises when it sends a
    bin at or past 32 * words left."""
    t = np.asarray(table, bool)
    if len(t) < 1 or t[32 * words:].any():
        raise ValueError(f"a goes-left table holds 1 to {32 * words} bins, got {len(t)}")
    return _words(t[: 32 * words], words)


def table_width_words(tables) -> int:
    """Words a member row gives each table: TABLE_WORDS, or, where a table
    sends a bin at or past TABLE_BINS left, ceil(widest table / 32)."""
    ts = [np.asarray(t, bool) for t in (tables or []) if t is not None]
    if not any(t[TABLE_BINS:].any() for t in ts):
        return TABLE_WORDS
    return -(-max(len(t) for t in ts) // 32)


def wide_words(mem: np.ndarray) -> Optional[np.ndarray]:
    """[K, W] u32 table words of wide member rows (``split_members`` past
    TABLE_BINS), None for rows of MEMBER_COLS (the parameter path)."""
    if mem.shape[1] <= MEMBER_COLS:
        return None
    return np.ascontiguousarray(mem[:, 7:].astype(np.uint32))


def member_table(row) -> Optional[np.ndarray]:
    """The [32 W] bool goes-left table of a member row (W = 8, or a wide
    row's words), None for a threshold member."""
    if not int(row[6]):
        return None
    words = np.asarray(row[7:], np.int64)
    return ((words[:, None] >> np.arange(32)) & 1).astype(bool).reshape(-1)


def member_args(mem: np.ndarray):
    """The public wrappers' arguments of member rows: ((starts, cnts,
    feats, tbins, dls, nanbs), iscats, tables)."""
    return (tuple(mem[:, i] for i in range(6)), mem[:, 6],
            [member_table(r) for r in mem])


def member_go_left(col: torch.Tensor, row) -> torch.Tensor:
    """``go_left`` of bins ``col`` by a member row's rule."""
    return go_left(col, int(row[3]), bool(row[4]), int(row[5]), member_table(row))


# ---------------------------------------------------------------------------
# kernel 1: histograms of K windows, f32 or on the int8 2-digit grid
# ---------------------------------------------------------------------------

QMAX = 127 * 128  # 2-digit int8 grid ceiling (lightgbm_tpu/ops/pallas/seg.py:100)
RANGE_BINS = 256  # bins of a histogram block's table (kRangeBins of lane_hist.cuh)
# the i32 digit sums are exact up to this many rows per window (|hi| <= 127)
MAX_INT8_ROWS = (2**31 - 1) // 127
MAX_WINDOWS = 16  # windows per launch (kMaxWindows of seg_hist.cu, partition.cu, lane_hist.cuh)


def _zero_dead(out: torch.Tensor, live) -> torch.Tensor:
    """``out`` [F, ...] with the cells of the features outside ``live``
    (None: none) 0."""
    if live is not None:
        dead = np.ones(int(out.shape[0]), bool)
        dead[np.asarray(live, np.int64)] = False
        out[torch.as_tensor(dead, device=out.device)] = 0
    return out


def seg_hist_plain(rows: SegRows, start: int, cnt: int, num_bins: int,
                   live=None) -> torch.Tensor:
    """[F, B, 3] (sum g*m, sum h*m, sum m) over rows [start, start+cnt);
    the features outside ``live`` (None: none) 0.

    One scatter-add in row order per cell, the order of the JAX package's
    ``segment_sum`` (ops/histogram.py:55), so on the CPU both give the same
    f32 sums."""
    f = rows.f
    dev = rows.device
    out = torch.zeros((f * num_bins, 3), dtype=torch.float32, device=dev)
    if cnt <= 0 or f == 0:
        return out.reshape(f, num_bins, 3)
    win = slice(start, start + cnt)
    m = rows.m[win]
    stats = torch.stack([rows.g[win] * m, rows.h[win] * m, m], dim=1)  # [cnt, 3]
    ids = feature_bins(rows, win) + (
        torch.arange(f, device=dev, dtype=torch.int64)[:, None] * num_bins
    )  # [F, cnt]
    data = stats.unsqueeze(0).expand(f, cnt, 3).reshape(-1, 3)
    out.scatter_add_(0, ids.reshape(-1, 1).expand(-1, 3), data)
    return _zero_dead(out.reshape(f, num_bins, 3), live)


def int8_digits(x: torch.Tensor, scale: torch.Tensor):
    """(hi, lo) i32 digits of q = clip(round_half_even(x / scale), +-QMAX),
    q = hi*128 + lo (the TPU kernel's _hist_window, seg.py:348-353): the
    reciprocal is taken once in f32, then multiplied."""
    inv = 1.0 / scale
    q = torch.clamp(torch.round(x * inv), -QMAX, QMAX).to(torch.int32)
    hi = (q + 64) >> 7
    return hi, q - hi * 128


def seg_hist_int8_raw_plain(
    rows: SegRows, start: int, cnt: int, num_bins: int, scales: torch.Tensor, live=None
) -> torch.Tensor:
    """Raw i32 planes [F, B, 5] (S_g_hi, S_g_lo, S_h_hi, S_h_lo, count) of
    window [start, start+cnt) on the int8 2-digit grid with ``scales`` [2]
    (g_scale, h_scale); the features outside ``live`` 0.  Integer sums:
    exact in any order."""
    f = rows.f
    dev = rows.device
    out = torch.zeros((f * num_bins, 5), dtype=torch.int64, device=dev)
    if cnt > 0 and f > 0:
        win = slice(start, start + cnt)
        m = rows.m[win]
        g_hi, g_lo = int8_digits(rows.g[win] * m, scales[0])
        h_hi, h_lo = int8_digits(rows.h[win] * m, scales[1])
        stats = torch.stack([g_hi, g_lo, h_hi, h_lo, (m != 0).to(torch.int32)], 1)
        ids = feature_bins(rows, win) + (
            torch.arange(f, device=dev, dtype=torch.int64)[:, None] * num_bins
        )
        data = stats.to(torch.int64).unsqueeze(0).expand(f, cnt, 5).reshape(-1, 5)
        out.scatter_add_(0, ids.reshape(-1, 1).expand(-1, 5), data)
    return _zero_dead(out.to(torch.int32).reshape(f, num_bins, 5), live)


def combine_int8(raw: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[..., B, 5] raw i32 planes -> [..., B, 3] (g, h, count) f32, as
    ``combine_hist_raw`` does (seg.py:457-461): g = (f32(S_hi)*128 +
    f32(S_lo)) * g_scale; the *128 is exact, the digit sums are exact below
    2^24.  The plain versions' recombine, and the ordered histogram's after
    its launch; the lane histogram's reduce (``csrc/lane_hist.cuh``: the
    segment histogram, the fused grow step) computes the same, bit for bit
    (``-fmad=false``)."""
    a = raw.to(torch.float32)
    g = (a[..., 0] * 128.0 + a[..., 1]) * scales[0]
    h = (a[..., 2] * 128.0 + a[..., 3]) * scales[1]
    return torch.stack([g, h, a[..., 4]], dim=-1)


def _windows_list(windows):
    """[(start, cnt), ...] host ints from a [K, 2] array-like."""
    return [(int(s), max(int(c), 0)) for s, c in windows]


def seg_hist_batch_plain(
    rows: SegRows, windows, num_bins: int, scales=None, live=None
) -> torch.Tensor:
    """[K, F, B, 3] histograms of K windows (start, cnt): f32 sums, or with
    ``scales`` [2] f32 the int8 2-digit grid recombined to f32; the
    features outside ``live`` 0."""
    out = []
    for start, cnt in _windows_list(windows):
        if scales is None:
            out.append(seg_hist_plain(rows, start, cnt, num_bins, live))
        else:
            raw = seg_hist_int8_raw_plain(rows, start, cnt, num_bins, scales, live)
            out.append(combine_int8(raw, scales))
    return torch.stack(out)


def seg_hist_batch(
    rows: SegRows, windows, num_bins: int, scales=None, live=None
) -> torch.Tensor:
    """K-window histogram ([K, 2] (start, cnt) host ints -> [K, F, B, 3];
    ``seg_hist_batch`` of seg.py:754): f32 sums, or with ``scales`` [2] f32
    (``quantize.hist_acc_scales``) the int8 2-digit grid; only the features
    of ``live`` (None: all) read, the others' cells 0.  A window with
    cnt = 0 gives a zero histogram.  Plain version on the CPU, the
    ``csrc/seg_hist.cu`` kernels on a CUDA device (one call of
    ``_seg_hist_launch`` per ``MAX_WINDOWS`` windows; none when every
    window is empty)."""
    wins = _windows_list(windows)
    if scales is not None and max((c for _, c in wins), default=0) > MAX_INT8_ROWS:
        raise ValueError(
            f"int8 histogram windows hold at most {MAX_INT8_ROWS} rows "
            "(exact i32 digit sums)"
        )
    if rows.device.type == "cpu":
        return seg_hist_batch_plain(rows, wins, num_bins, scales, live)
    _require_cuda(rows)
    k = len(wins)
    if k > MAX_WINDOWS:  # one call per MAX_WINDOWS windows
        return torch.cat([seg_hist_batch(rows, wins[i : i + MAX_WINDOWS], num_bins, scales,
                                         live)
                          for i in range(0, k, MAX_WINDOWS)])
    if k < 1:
        raise ValueError("seg_hist takes at least one window")
    if not any(c for _, c in wins):  # nothing to read: no launch
        return torch.zeros((k, rows.f, num_bins, 3), dtype=torch.float32, device=rows.device)
    return _seg_hist_launch(rows, wins, num_bins, scales, live=live)


def feature_order(rows: SegRows, live=None):
    """(order [F] i32 on the rows' device, live count) of the histogram
    kernels: the features of ``live`` first (each once, in their order),
    then the others; the identity and F when ``live`` is None.  Kept on the
    rows, so a tree's calls copy it to the card once."""
    f = rows.f
    key = None if live is None else tuple(int(v) for v in live)
    if rows.order is not None and rows.order[0] == key:
        return rows.order[1], rows.order[2]
    if key is None:
        order = np.arange(f, dtype=np.int32)
    else:
        if len(set(key)) != len(key) or not all(0 <= v < f for v in key) or not key:
            raise ValueError(f"live features: distinct indices below {f}, at least one")
        dead = np.setdiff1d(np.arange(f), np.asarray(key))
        order = np.concatenate([np.asarray(key, np.int64), dead]).astype(np.int32)
    rows.order = (key, torch.as_tensor(order, device=rows.device), len(key or order))
    return rows.order[1], rows.order[2]


def hist_ranges(rows: SegRows, num_bins: int) -> int:
    """Bin ranges of ``RANGE_BINS`` the histogram kernels run at
    ``num_bins``: one in the u8 mode, else enough for the rows' widest
    feature (``used_bins``; 1,025 bins: 5, not 8).  Raises when the rows'
    mode is not the one ``num_bins`` implies (u16 past 256 bins)."""
    if rows.wide != (num_bins > RANGE_BINS):
        raise ValueError(
            f"{'u16' if rows.wide else 'u8'} seg rows with a {num_bins}-bin histogram "
            f"(bins take two byte planes exactly past {RANGE_BINS} bins)")
    if not rows.wide:
        return 1
    used = min(rows.used_bins or num_bins, num_bins)
    return max(1, -(-used // RANGE_BINS))


@functools.lru_cache(maxsize=None)
def seg_hist_scratch_bytes(f: int, num_bins: int, int8: bool) -> int:
    """Bytes of the scratch a ``csrc/seg_hist.cu`` call over any K <= 16
    windows needs (``lgbt_seg_hist_scratch``: one image of a block's table
    for each block the card holds at once, after the head that the fused
    grow step's scratch has)."""
    nbytes = int(_build.entry("seg_hist_scratch")(f, num_bins, int(int8)))
    if nbytes < 0:
        _build.check(-nbytes, "seg_hist scratch")
    return nbytes


def _seg_hist_launch(rows: SegRows, wins, num_bins: int, scales, fn=None,
                     live=None) -> torch.Tensor:
    """One call of the ``csrc/seg_hist.cu`` entry (``fn``: another build of
    it) on 1 to ``MAX_WINDOWS`` windows [(start, cnt)] of CUDA rows: [K, F,
    B, 3] f32 on the card, every cell written by the kernels (the features
    outside ``live`` 0).  The scratch lives on the rows (``SegRows.step``);
    only the output is allocated."""
    k, f = len(wins), rows.f
    if not 1 <= k <= MAX_WINDOWS:
        raise ValueError(f"the seg_hist kernel takes 1 to {MAX_WINDOWS} windows, got {k}")
    _require_cuda(rows)
    ranges = hist_ranges(rows, int(num_bins))
    dev = rows.device
    need = seg_hist_scratch_bytes(f, int(num_bins), scales is not None)
    if rows.step is None or rows.step.numel() < need:
        rows.step = torch.empty(need, dtype=torch.uint8, device=dev)
    out = torch.empty((k, f, num_bins, 3), dtype=torch.float32, device=dev)
    sp = None if scales is None else _device_scales(scales, dev)
    win_host = np.asarray(wins, dtype=np.int64).reshape(k, 2)
    order, nlive = feature_order(rows, live)
    rc = (fn or _build.entry("seg_hist"))(
        rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(), rows.m.data_ptr(),
        rows.n, win_host.ctypes.data, k, f, int(num_bins), ranges, order.data_ptr(), nlive,
        None if sp is None else sp.data_ptr(), rows.step.data_ptr(), rows.step.numel(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "seg_hist kernels")
    name = "seg_hist" if scales is None else "seg_hist_int8"
    _build.LAUNCHES[name] += 1
    if rows.wide:
        _build.LAUNCHES[name + "_u16"] += 1
    if nlive < f:
        _build.LAUNCHES[name + "_live"] += 1
    if k > 1:
        _build.LAUNCHES["seg_hist:K>1"] += 1
    return out


def seg_hist(
    rows: SegRows, start: int, cnt: int, num_bins: int, scales=None, live=None
) -> torch.Tensor:
    """Histogram [F, B, 3] of window [start, start+cnt): ``seg_hist_batch``
    with one window."""
    return seg_hist_batch(rows, [(start, cnt)], num_bins, scales, live)[0]


def _device_scales(scales, dev) -> torch.Tensor:
    t = torch.as_tensor(scales, dtype=torch.float32, device=dev).reshape(2)
    return t.contiguous()


# ---------------------------------------------------------------------------
# kernel 2: stable partition of one window, or of K disjoint windows
# ---------------------------------------------------------------------------


def sort_partition_plain(
    rows: SegRows, start: int, cnt: int, feat: int, tbin: int, dl: bool,
    nanb: int, table=None,
) -> torch.Tensor:
    """Stable in-place partition of [start, start+cnt) by the split (its
    threshold, or its goes-left ``table``); returns nl as a 0-d i32 tensor
    (the order of ops/segpart.py sort_partition_xla: left rows in order,
    then right rows in order)."""
    if cnt <= 0:
        return torch.zeros((), dtype=torch.int32, device=rows.device)
    win = slice(start, start + cnt)
    gl = go_left(feature_bins(rows, win, feat), tbin, dl, nanb, table)
    perm = torch.cat([torch.nonzero(gl)[:, 0], torch.nonzero(~gl)[:, 0]])
    rows.bins[:, win] = rows.bins[:, win][:, perm]
    for col in (rows.g, rows.h, rows.m, rows.ridx):
        col[win] = col[win][perm]
    return gl.sum().to(torch.int32)


def split_members(sbegins, cnts, feats, tbins, dls, nanbs, iscats=None,
                  tables=None) -> np.ndarray:
    """[K, MEMBER_COLS] i64 host rows (start, cnt, feat, tbin, dl, nanb,
    iscat, the goes-left table's words) of K splits over disjoint windows;
    a negative cnt counts as 0 (a no-op member).  ``iscats`` [K] marks the
    members that partition by their entry of ``tables`` ([K] of [B] bool
    or None); where a table sends a bin at or past TABLE_BINS left, the
    rows are [K, 7 + W], W words a table (``table_width_words``).  Raises
    when two non-empty windows overlap, or a table member has no table."""
    cols = [np.asarray(a, dtype=np.int64).reshape(-1)
            for a in (sbegins, cnts, feats, tbins, dls, nanbs)]
    k = len(cols[0])
    cols.append(np.zeros(k, np.int64) if iscats is None
                else (np.asarray(iscats).reshape(-1) != 0).astype(np.int64))
    if any(len(c) != k for c in cols):
        raise ValueError("split members: arrays differ in length")
    words = table_width_words(tables) if iscats is not None else TABLE_WORDS
    mem = np.zeros((k, 7 + words), np.int64)
    if k:
        mem[:, :7] = np.stack(cols, axis=1)
    for i in np.flatnonzero(mem[:, 6]):
        if tables is None or tables[i] is None:
            raise ValueError("split members: a categorical (table) member needs its "
                             "goes-left table")
        mem[i, 7:] = table_words(tables[i], words)
    mem[:, 1] = np.maximum(mem[:, 1], 0)
    live = mem[mem[:, 1] > 0]
    live = live[np.argsort(live[:, 0], kind="stable")]
    if np.any(live[:-1, 0] + live[:-1, 1] > live[1:, 0]):
        raise ValueError("split members: windows overlap")
    return np.ascontiguousarray(mem)


def sort_partition_batch_plain(rows: SegRows, mem: np.ndarray) -> torch.Tensor:
    """K sequential stable partitions (the oracle of ops/segpart.py:228):
    the windows are disjoint, so the order of the calls does not matter and
    the result is that of K serial calls.  Returns nl [K] i32."""
    nl = [sort_partition_plain(rows, *(int(v) for v in r[:6]), member_table(r)) for r in mem]
    if not nl:
        return torch.zeros(0, dtype=torch.int32, device=rows.device)
    return torch.stack(nl)


def sort_partition_batch(
    rows: SegRows, sbegins, cnts, feats, tbins, dls, nanbs, iscats=None, tables=None
) -> torch.Tensor:
    """K stable in-place partitions over K disjoint windows (``[K]`` host
    sequences as ``split_members`` takes them; cnt = 0 is a no-op member).
    Returns nl [K] i32 on the rows' device.  Plain version on the CPU, ONE
    call of the ``csrc/partition.cu`` kernels (two launches) on a CUDA
    device (counted as ``partition_batch``, as ``partition_batch_table``
    when a live member partitions by its table, and as
    ``partition_batch_wtable`` when the tables pass TABLE_BINS)."""
    mem = split_members(sbegins, cnts, feats, tbins, dls, nanbs, iscats, tables)
    if rows.device.type == "cpu":
        return sort_partition_batch_plain(rows, mem)
    return _partition_launch(rows, mem, "partition_batch")


# the tile sizes csrc/partition.cu instantiates, largest first
PART_TILES = (2048, 1024, 512, 256, 128)
# shared memory one tile block may take, so that three share a
# multiprocessor (227 KB of the H100's 228 KB, 1 KB reserved per block)
PART_BLOCK_SMEM = 75_776
PART_COPY_ROWS = 1024  # right rows a block of the copy pass moves (kCopyRows)
PART_FILL_TILES = 264  # tiles a call aims for: two a multiprocessor
PART_MIN_TILE = 256


def partition_stage_bytes(f: int, tile: int, table_words: int = 0) -> int:
    """Shared memory of one tile block: f planes of tile + 32 bytes and four
    4-byte columns of 4 * tile + 32 (the 16-byte chunks that cover an
    unaligned run), the ranks (2 bytes a row), the ballot masks and their
    scan (8 bytes per 32 rows), the planes' stage offsets (512 bytes) and
    a few words; with wide tables, a window's ``table_words`` words."""
    return (f * (tile + 32) + 4 * (4 * tile + 32) + 2 * tile + tile // 4 + 512 + 64
            + 4 * table_words)


def partition_tile_rows(f: int, rows: int = 0, table_words: int = 0) -> int:
    """Rows a tile of the partition kernel stages: the largest of
    ``PART_TILES`` whose stage fits ``PART_BLOCK_SMEM``; for a call on
    ``rows`` rows, no larger than gives ``PART_FILL_TILES`` tiles, and no
    smaller than ``PART_MIN_TILE`` (small windows finish sooner in more,
    smaller tiles; large ones lose less to each tile's fixed cost in fewer,
    larger ones)."""
    for tile in PART_TILES:
        if partition_stage_bytes(f, tile, table_words) <= PART_BLOCK_SMEM:
            break
    else:
        widest = ((PART_BLOCK_SMEM - partition_stage_bytes(0, PART_TILES[-1], table_words))
                  // (PART_TILES[-1] + 32))
        raise ValueError(f"the partition kernel's tiles hold at most {widest} features, got {f}")
    while rows and tile > PART_MIN_TILE and rows < tile * PART_FILL_TILES:
        tile //= 2
    return tile


def partition_scratch_rows(n: int) -> int:
    """Row stride of the partition kernel's scratch: every window's right
    run (at most its cnt rows; the windows hold at most n rows together)
    at a 16-row aligned offset, with 16 rows of margin before the first
    and after the last (the copy pass reads up to 7 bytes past a run)."""
    return -(-(n + 16 * (MAX_WINDOWS + 2)) // 16) * 16


class PartitionScratch:
    """The partition kernel's buffers for one set of seg rows, made once
    and kept across calls: the right runs' scratch (planes u8 [F, stride],
    the four 4-byte columns [4, stride]), the look-back's status words and
    the staged words (one each per tile, tagged with the call's epoch, so
    never cleared) and the tile counter (the kernel leaves it 0)."""

    def __init__(self, rows: SegRows):
        dev = rows.device
        self.shape = (rows.planes, rows.n)
        self.stride = partition_scratch_rows(rows.n)
        self.planes = torch.empty((rows.planes, self.stride), dtype=torch.uint8, device=dev)
        self.cols = torch.empty((4, self.stride), dtype=torch.int32, device=dev)
        tiles = -(-rows.n // PART_TILES[-1]) + MAX_WINDOWS  # at the smallest tile
        self.status = torch.zeros(tiles, dtype=torch.int64, device=dev)
        self.staged = torch.zeros(tiles, dtype=torch.int32, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int32, device=dev)
        self.epoch = 0

    def next_epoch(self) -> int:
        """The epoch of the next call, in [1, 2^30) (the status words keep
        it in 30 bits; after 2^30 - 1 calls they are cleared once)."""
        self.epoch += 1
        if self.epoch >= 1 << 30:
            self.status.zero_()
            self.staged.zero_()
            self.epoch = 1
        return self.epoch


def partition_scratch(rows: SegRows) -> PartitionScratch:
    """The partition kernel's buffers on the rows (made at the first call),
    once the rows are checked: CUDA columns of the seg layout at 16-byte
    aligned starts."""
    _require_cuda(rows)
    if any(t.data_ptr() % 16 for t in (rows.bins, rows.g, rows.h, rows.m, rows.ridx)):
        raise ValueError("the partition kernel needs seg rows columns at 16-byte aligned starts")
    if rows.part is None or rows.part.shape != (rows.planes, rows.n):
        rows.part = PartitionScratch(rows)
    return rows.part


def kernel_members(mem: np.ndarray, dev):
    """The C entries' view of member rows: ([K, MEMBER_COLS] i64 rows,
    C-contiguous; the wide rows' table words on the card or None; their
    words a table, 0 on the parameter path)."""
    wide = wide_words(mem)
    if wide is None:
        return np.ascontiguousarray(mem), None, 0
    rows = np.ascontiguousarray(mem[:, :MEMBER_COLS])
    return rows, torch.as_tensor(wide.view(np.int32), device=dev), int(wide.shape[1])


def count_table_modes(name: str, mem: np.ndarray) -> None:
    """Count a partition or fused-step call in its goes-left-table modes:
    ``<name>_table`` when a live member partitions by its table,
    ``<name>_wtable`` too when the tables pass TABLE_BINS (wide rows)."""
    if table_mode(mem):
        _build.LAUNCHES[name + "_table"] += 1
        if mem.shape[1] > MEMBER_COLS:
            _build.LAUNCHES[name + "_wtable"] += 1


def _partition_launch(rows: SegRows, mem: np.ndarray, counted_as: str, fn=None) -> torch.Tensor:
    """One call of the ``csrc/partition.cu`` entry (``fn``: another build
    of it) on K members ([K, MEMBER_COLS] i64 rows, or wide rows whose
    table words go to the card); nl [K] i32 on the card."""
    k = mem.shape[0]
    if not 1 <= k <= MAX_WINDOWS:
        raise ValueError(f"the partition kernel takes 1 to {MAX_WINDOWS} windows, got {k}")
    ps = partition_scratch(rows)
    dev = rows.device
    nl = torch.empty((k,), dtype=torch.int32, device=dev)
    cmem, wt, ww = kernel_members(mem, dev)
    args = [
        rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(), rows.m.data_ptr(),
        rows.ridx.data_ptr(), rows.n, rows.planes, int(rows.wide), cmem.ctypes.data, k,
        partition_tile_rows(rows.planes, int(mem[:, 1].sum()), ww), ps.planes.data_ptr(),
        ps.cols.data_ptr(), ps.stride, ps.status.data_ptr(), ps.staged.data_ptr(),
        ps.counter.data_ptr(), ps.next_epoch(), nl.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    ]
    # the wide tables' pointer and words close the call (a build of the
    # earlier entry, which ends at the stream, ignores them)
    rc = (fn or _build.entry("partition"))(*args, None if wt is None else wt.data_ptr(), ww)
    _build.check(rc, "partition kernel")
    _build.LAUNCHES[counted_as] += 1
    count_table_modes(counted_as, mem)
    if rows.wide:
        _build.LAUNCHES[counted_as + "_u16"] += 1
    return nl


def table_mode(mem: np.ndarray) -> bool:
    """Whether a live member of a call partitions by its goes-left table."""
    return bool(np.any((mem[:, 6] != 0) & (mem[:, 1] > 0)))


def sort_partition(
    rows: SegRows, start: int, cnt: int, feat: int, tbin: int, dl: bool,
    nanb: int, table=None,
) -> torch.Tensor:
    """Stable in-place partition of one window by its threshold or its
    goes-left ``table``; returns nl (0-d i32 tensor on the rows' device).
    Plain version on the CPU, the ``csrc/partition.cu`` kernels on a CUDA
    device."""
    if rows.device.type == "cpu":
        return sort_partition_plain(rows, start, cnt, feat, tbin, dl, nanb, table)
    mem = split_members([start], [cnt], [feat], [tbin], [int(bool(dl))], [nanb],
                        [table is not None], [table])
    return _partition_launch(rows, mem, "partition")[0]


def _require_cuda(rows: SegRows) -> None:
    """The kernels take contiguous CUDA tensors of the layout above."""
    if rows.device.type != "cuda":
        raise ValueError(f"no kernel for device {rows.device}")
    for name, t, dt in (
        ("bins", rows.bins, torch.uint8), ("g", rows.g, torch.float32),
        ("h", rows.h, torch.float32), ("m", rows.m, torch.float32),
        ("ridx", rows.ridx, torch.int32),
    ):
        if t.dtype != dt or not t.is_contiguous() or t.device != rows.device:
            raise ValueError(f"seg rows column {name}: need contiguous {dt}")
