"""Histograms of the ordered layout: K windows of an index array over the
row-major bins.

Counterpart of the ordered-mode histogram of ``lightgbm_tpu/ops``:
``leaf_histogram`` (ops/histogram.py:140-222) on the gathered rows
``bins_pad[cidx]`` of a leaf window (ops/grower.py:1274-1325), through the
TPU kernels ``histogram_pallas`` (f32; ``tile_pallas_histogram``,
ops/pallas/histogram.py:140) and ``histogram_pallas_int8`` (the int8
2-digit grid of quantized gradients, ops/pallas/histogram_int8.py:109).

Layout: the bins are ``[N, stride]`` u8, row-major (one row's features are
one run of bytes), with the row stride padded to a multiple of 16 bytes so
the kernel loads 16 features at once; the padding is never read as a
feature.  Past a byte (a histogram of more than 256 bins) they are u16, the
stride padded to 8 features (16 bytes), and the kernel runs its u16 mode:
bin ranges of 256, as many as the widest feature needs
(``OrderedRows.used_bins``), a grid dimension, each block the u8 mode's
table over its range.  g, h and the 0/1 mask are f32 columns ``[N]``.  A
window ``(start, cnt)`` covers the rows ``order[start : start + cnt]`` of an i32
index array, or, with no index, the rows ``start .. start + cnt`` (the
root).  The JAX package gathers the rows in XLA before its kernel; the
port's kernel folds that gather into its loads: the same function, the
histogram of the gathered rows.

``ordered_hist`` (f32 sums) and ``ordered_hist_int8`` (exact i32 digit
sums of q = clip(round(x / scale), +-QMAX), recombined as the quantized
branch of ``combine_hist_raw``, seg.py:457-461) dispatch on the device of
the rows: the plain PyTorch version on the CPU, one call of the
``csrc/ordered_hist.cu`` kernel on a CUDA device (two launches: the
per-block histograms into a scratch buffer, then their sum into the
output; counted once, in ``_build.LAUNCHES['ordered_hist']`` and
``['ordered_hist_int8']``, and on u16 bins also as ``..._u16``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _build
from .seg import (
    MAX_INT8_ROWS,
    MAX_WINDOWS,
    QMAX,
    RANGE_BINS,
    _device_scales,
    _windows_list,
    combine_int8,
)

ROW_ALIGN = 16  # bytes: the kernel's vector load of 16 features
# rows x features gathered per step of the plain versions (bounds their
# temporaries; every cell still adds its rows in row order)
_PLAIN_CELLS = 1 << 25


@dataclasses.dataclass
class OrderedRows:
    """The training rows of the ordered layout (never reordered: the leaf
    windows live in a separate index array)."""

    bins: torch.Tensor  # [N, stride] u8 (u16 past a byte) row-major, stride >= f
    f: int  # features (the first f bins of a row)
    g: torch.Tensor  # [N] f32
    h: torch.Tensor  # [N] f32
    m: torch.Tensor  # [N] f32 (1 in bag, 0 out)
    # the widest feature's bins (0: the histogram's): the u16 mode's ranges
    used_bins: int = 0

    @property
    def n(self) -> int:
        return int(self.g.shape[0])

    @property
    def device(self) -> torch.device:
        return self.g.device

    @property
    def wide(self) -> bool:
        """Whether the bins are u16 (the kernel's u16 mode)."""
        return self.bins.dtype == torch.uint16


def row_major_bins(bins: np.ndarray, device) -> torch.Tensor:
    """[N, F] u8 or u16 host bins -> [N, stride] of the same type on
    ``device``, the row stride F padded to a multiple of ROW_ALIGN bytes
    with zeros."""
    n, f = bins.shape
    dt = np.uint16 if bins.dtype == np.uint16 else np.uint8
    per = ROW_ALIGN // np.dtype(dt).itemsize  # bins of a ROW_ALIGN-byte vector
    out = np.zeros((n, -(-max(f, 1) // per) * per), dt)
    out[:, :f] = bins
    return torch.as_tensor(out, device=device)


def gather_bins(bins: torch.Tensor, idx: torch.Tensor, f0: int, f1: int) -> torch.Tensor:
    """[cnt, f1 - f0] i64 bins of features [f0, f1) of the rows ``idx``
    (u16 bins read through an i16 view: PyTorch's uint16 tensors take few
    operators)."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16)[idx, f0:f1].to(torch.int64) & 0xFFFF
    return bins[idx, f0:f1].to(torch.int64)


def ordered_ranges(rows: OrderedRows, num_bins: int) -> int:
    """Bin ranges of ``RANGE_BINS`` the kernel runs at ``num_bins``: one in
    the u8 mode, else enough for the rows' widest feature (``used_bins``;
    1,025 bins: 5, not 8).  Raises on u8 rows past 256 bins."""
    if not rows.wide:
        if num_bins > RANGE_BINS:
            raise ValueError(f"u8 ordered rows with a {num_bins}-bin histogram (u16 bins "
                             f"past {RANGE_BINS})")
        return 1
    used = min(rows.used_bins or num_bins, num_bins)
    return max(1, -(-used // RANGE_BINS))


def window_rows(order: Optional[torch.Tensor], start: int, cnt: int, dev) -> torch.Tensor:
    """i64 row indices of window (start, cnt) of ``order`` (None: the rows)."""
    if order is None:
        return torch.arange(start, start + cnt, dtype=torch.int64, device=dev)
    return order[start : start + cnt].to(torch.int64)


def _scatter_rows(rows: OrderedRows, idx: torch.Tensor, stats: torch.Tensor,
                  num_bins: int) -> torch.Tensor:
    """[F * B, P] sums of stats [cnt, P] into the (feature, bin) cells of the
    rows idx, one scatter-add per block of features, each cell in row order
    (the order of ``segment_sum`` over the row-major ids,
    ops/histogram.py:55)."""
    f, dev = rows.f, rows.device
    cnt, planes = stats.shape
    out = torch.zeros((f * num_bins, planes), dtype=stats.dtype, device=dev)
    if cnt == 0 or f == 0:
        return out
    fb = max(1, min(f, _PLAIN_CELLS // cnt))
    for f0 in range(0, f, fb):
        f1 = min(f, f0 + fb)
        ids = gather_bins(rows.bins, idx, f0, f1) + (
            torch.arange(f0, f1, device=dev, dtype=torch.int64)[None, :] * num_bins
        )  # [cnt, fb] row-major
        data = stats.unsqueeze(1).expand(cnt, f1 - f0, planes).reshape(-1, planes)
        out.scatter_add_(0, ids.reshape(-1, 1).expand(-1, planes), data)
    return out


def ordered_hist_plain(
    rows: OrderedRows, order: Optional[torch.Tensor], windows, num_bins: int
) -> torch.Tensor:
    """[K, F, B, 3] (sum g*m, sum h*m, sum m) of each window's rows, in row
    order per cell: ``leaf_histogram_segment`` of the gathered rows."""
    out = []
    for start, cnt in _windows_list(windows):
        idx = window_rows(order, start, cnt, rows.device)
        m = rows.m[idx]
        stats = torch.stack([rows.g[idx] * m, rows.h[idx] * m, m], dim=1)
        out.append(_scatter_rows(rows, idx, stats, num_bins).reshape(rows.f, num_bins, 3))
    return torch.stack(out)


def int8_digit_rows(g, h, m, scales: torch.Tensor) -> torch.Tensor:
    """[cnt, 5] i32 (g_hi, g_lo, h_hi, h_lo, m) of ``int8_digit_rows``
    (ops/pallas/histogram_int8.py:86-103): q = clip(round_half_even(x /
    scale), +-QMAX) * (m > 0), q = hi*128 + lo with hi = (q + 64) >> 7."""
    mi = (m > 0).to(torch.int32)

    def digits(x, scale):
        q = torch.clamp(torch.round(x / scale), -QMAX, QMAX).to(torch.int32) * mi
        hi = (q + 64) >> 7
        return hi, q - (hi << 7)

    g_hi, g_lo = digits(g, scales[0])
    h_hi, h_lo = digits(h, scales[1])
    return torch.stack([g_hi, g_lo, h_hi, h_lo, mi], dim=1)


def ordered_hist_int8_raw_plain(
    rows: OrderedRows, order: Optional[torch.Tensor], windows, num_bins: int,
    scales: torch.Tensor,
) -> torch.Tensor:
    """[K, F, B, 5] i32 raw digit sums (S_g_hi, S_g_lo, S_h_hi, S_h_lo,
    count) of each window: integer sums, exact in any order."""
    out = []
    for start, cnt in _windows_list(windows):
        idx = window_rows(order, start, cnt, rows.device)
        stats = int8_digit_rows(rows.g[idx], rows.h[idx], rows.m[idx], scales)
        out.append(_scatter_rows(rows, idx, stats, num_bins).reshape(rows.f, num_bins, 5))
    return torch.stack(out)


def ordered_hist_int8_plain(rows, order, windows, num_bins: int, scales) -> torch.Tensor:
    """[K, F, B, 3] f32: the raw digit sums recombined (``combine_int8``)."""
    scales = torch.as_tensor(scales, dtype=torch.float32, device=rows.device).reshape(2)
    return combine_int8(ordered_hist_int8_raw_plain(rows, order, windows, num_bins, scales), scales)


def ordered_hist(
    rows: OrderedRows, order: Optional[torch.Tensor], windows, num_bins: int
) -> torch.Tensor:
    """f32 histograms [K, F, B, 3] of K windows ``[(start, cnt), ...]`` of
    ``order`` (None: of the rows themselves); a window with cnt = 0 gives a
    zero histogram.  Plain version on the CPU, ONE call of the
    ``csrc/ordered_hist.cu`` f32 kernel on a CUDA device."""
    wins = _windows_list(windows)
    if rows.device.type == "cpu":
        return ordered_hist_plain(rows, order, wins, num_bins)
    return _launch(rows, order, wins, num_bins, None)


def ordered_hist_int8(
    rows: OrderedRows, order: Optional[torch.Tensor], windows, num_bins: int,
    scales,
) -> torch.Tensor:
    """``ordered_hist`` on the int8 2-digit grid with ``scales`` [2] f32
    (g_scale, h_scale): exact i32 digit sums recombined to f32.  Plain
    version on the CPU, ONE call of the int8 kernel on a CUDA device."""
    wins = _windows_list(windows)
    if max((c for _, c in wins), default=0) > MAX_INT8_ROWS:
        raise ValueError(
            f"int8 histogram windows hold at most {MAX_INT8_ROWS} rows "
            "(exact i32 digit sums)"
        )
    if rows.device.type == "cpu":
        return ordered_hist_int8_plain(rows, order, wins, num_bins, scales)
    return _launch(rows, order, wins, num_bins, scales)


def _launch(rows: OrderedRows, order, wins, num_bins: int, scales) -> torch.Tensor:
    _require_cuda(rows, order)
    k, f, dev = len(wins), rows.f, rows.device
    if k > MAX_WINDOWS:  # one launch per MAX_WINDOWS windows
        return torch.cat([_launch(rows, order, wins[i : i + MAX_WINDOWS], num_bins, scales)
                          for i in range(0, k, MAX_WINDOWS)])
    if k < 1:
        raise ValueError("ordered_hist takes at least one window")
    ranges = ordered_ranges(rows, num_bins)
    if f == 0 or not any(c for _, c in wins):  # nothing to read: no launch
        return torch.zeros((k, f, num_bins, 3), dtype=torch.float32, device=dev)
    end = max(s + c for s, c in wins if c)
    if min(s for s, c in wins if c) < 0 or end > (rows.n if order is None else order.shape[0]):
        raise ValueError("ordered_hist: a window runs past the rows")
    win_host = np.asarray(wins, dtype=np.int64).reshape(k, 2)
    if scales is None:
        sp = None
    else:
        scales = _device_scales(scales, dev)
        sp = scales.data_ptr()
    width = rows.bins.element_size()
    out, scratch = kernel_buffers(_build.entry("ordered_hist_scratch"), k, f, int(num_bins),
                                  scales is not None, dev, width, ranges)
    rc = _build.entry("ordered_hist")(
        rows.bins.data_ptr(), int(rows.bins.shape[1]),
        None if order is None else order.data_ptr(),
        rows.g.data_ptr(), rows.h.data_ptr(), rows.m.data_ptr(),
        win_host.ctypes.data, k, f, int(num_bins), width, ranges, sp, scratch.data_ptr(),
        scratch.numel(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "ordered_hist kernel")
    name = "ordered_hist" if scales is None else "ordered_hist_int8"
    _build.LAUNCHES[name] += 1
    if rows.wide:
        _build.LAUNCHES[name + "_u16"] += 1
    if k > 1:
        _build.LAUNCHES["ordered_hist:K>1"] += 1
    return out if scales is None else combine_int8(out, scales)


# scratch bytes by (entry, K, F, B, int8, bin bytes, ranges): the most any
# windows need
_SCRATCH_BYTES: dict = {}


def kernel_buffers(scratch_entry, k: int, f: int, num_bins: int, int8: bool, dev,
                   bin_bytes: int = 1, ranges: int = 1) -> tuple:
    """(out, scratch) of a launch over k windows: the kernel writes every
    cell of out, f32 [K, F, B, 3] or i32 [K, F, B, 5], and keeps one
    histogram per block in the scratch.  Its size is
    ``lgbt_ordered_hist_scratch`` of k windows of the most rows (the blocks
    of a launch are capped, the bin ranges counted in the cap), asked once
    per shape."""
    key = (id(scratch_entry), k, f, num_bins, bool(int8), bin_bytes, ranges)
    need = _SCRATCH_BYTES.get(key)
    if need is None:
        most = np.tile(np.array([[0, 1 << 40]], dtype=np.int64), (k, 1))
        need = scratch_entry(most.ctypes.data, k, f, num_bins, int(int8), bin_bytes, ranges)
        if need < 0:
            _build.check(-need, "ordered_hist scratch size")
        _SCRATCH_BYTES[key] = need
    shape, dt = (k, f, num_bins, 5 if int8 else 3), torch.int32 if int8 else torch.float32
    return (torch.empty(shape, dtype=dt, device=dev),
            torch.empty(need, dtype=torch.uint8, device=dev))


def _require_cuda(rows: OrderedRows, order) -> None:
    """The kernel takes contiguous CUDA tensors of the layout above."""
    if rows.device.type != "cuda":
        raise ValueError(f"no kernel for device {rows.device}")
    b = rows.bins
    per = ROW_ALIGN // b.element_size()  # bins of a 16-byte vector
    if (b.dtype not in (torch.uint8, torch.uint16) or b.dim() != 2 or not b.is_contiguous()
            or b.shape[1] % per or b.shape[1] < rows.f or b.data_ptr() % ROW_ALIGN
            or b.shape[0] != rows.n):
        raise ValueError(
            f"ordered rows: need contiguous [N, stride] u8 or u16 bins with a stride of a "
            f"multiple of {ROW_ALIGN} bytes and >= {rows.f} bins, got {tuple(b.shape)} {b.dtype}"
        )
    cols = [("g", rows.g, torch.float32), ("h", rows.h, torch.float32),
            ("m", rows.m, torch.float32)]
    if order is not None:
        cols.append(("order", order, torch.int32))
    for name, t, dt in cols:
        if t.dtype != dt or not t.is_contiguous() or t.device != rows.device:
            raise ValueError(f"ordered rows column {name}: need contiguous {dt} on {rows.device}")
