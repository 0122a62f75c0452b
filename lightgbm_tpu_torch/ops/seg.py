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

``seg_hist_batch`` (kernel ``csrc/seg_hist.cu``: K windows per call, f32
sums or the int8 2-digit grid, the lane histogram of ``csrc/lane_hist.cuh``
in two launches), ``sort_partition`` and
``sort_partition_batch`` (kernel ``csrc/partition.cu``: one window, or K
disjoint windows per call) dispatch on the device of the tensors they are given:
on the CPU they run their plain PyTorch versions, on a CUDA device they
launch the kernel.  Each counts its kernel launches in ``_build.LAUNCHES``.
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

    bins: torch.Tensor  # [F, n] u8
    g: torch.Tensor  # [n] f32
    h: torch.Tensor  # [n] f32
    m: torch.Tensor  # [n] f32 (1 in bag, 0 out)
    ridx: torch.Tensor  # [n] i32 original row index
    # the partition kernel's buffers, made at its first call on these rows
    part: Optional["PartitionScratch"] = dataclasses.field(default=None, repr=False,
                                                           compare=False)
    # the lane histogram's scratch (csrc/lane_hist.cuh), likewise, shared by
    # the fused grow step (ops/grow_step.py) and seg_hist_batch: both use it
    # in stream order on one stream, and it grows to the larger need
    step: Optional[torch.Tensor] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n(self) -> int:
        return int(self.g.shape[0])

    @property
    def f(self) -> int:
        return int(self.bins.shape[0])

    @property
    def device(self) -> torch.device:
        return self.g.device


def pack_rows(
    bins_fn: torch.Tensor,  # [F, N] u8, feature-major
    grad: torch.Tensor,  # [N] f32
    hess: torch.Tensor,  # [N] f32
    mask: torch.Tensor,  # [N] f32
) -> SegRows:
    """Rows in their original order (ridx = iota), ready for the root
    histogram.  The bins are copied: the tree partitions them in place."""
    n = int(grad.shape[0])
    return SegRows(
        bins=bins_fn.clone(),
        g=grad.to(torch.float32).contiguous().clone(),
        h=hess.to(torch.float32).contiguous().clone(),
        m=(mask > 0).to(torch.float32),
        ridx=torch.arange(n, dtype=torch.int32, device=grad.device),
    )


def go_left(col: torch.Tensor, tbin: int, dl: bool, nanb: int) -> torch.Tensor:
    """Numeric split predicate in bin space (ops/segpart.py:52): bin <= the
    threshold bin, or the NaN bin when missing values go left."""
    gl = col <= tbin
    if dl and nanb >= 0:
        gl = gl | (col == nanb)
    return gl


# ---------------------------------------------------------------------------
# kernel 1: histograms of K windows, f32 or on the int8 2-digit grid
# ---------------------------------------------------------------------------

QMAX = 127 * 128  # 2-digit int8 grid ceiling (lightgbm_tpu/ops/pallas/seg.py:100)
# the i32 digit sums are exact up to this many rows per window (|hi| <= 127)
MAX_INT8_ROWS = (2**31 - 1) // 127
MAX_WINDOWS = 16  # windows per launch (kMaxWindows of seg_hist.cu, partition.cu, lane_hist.cuh)


def seg_hist_plain(rows: SegRows, start: int, cnt: int, num_bins: int) -> torch.Tensor:
    """[F, B, 3] (sum g*m, sum h*m, sum m) over rows [start, start+cnt).

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
    ids = rows.bins[:, win].to(torch.int64) + (
        torch.arange(f, device=dev, dtype=torch.int64)[:, None] * num_bins
    )  # [F, cnt]
    data = stats.unsqueeze(0).expand(f, cnt, 3).reshape(-1, 3)
    out.scatter_add_(0, ids.reshape(-1, 1).expand(-1, 3), data)
    return out.reshape(f, num_bins, 3)


def int8_digits(x: torch.Tensor, scale: torch.Tensor):
    """(hi, lo) i32 digits of q = clip(round_half_even(x / scale), +-QMAX),
    q = hi*128 + lo (the TPU kernel's _hist_window, seg.py:348-353): the
    reciprocal is taken once in f32, then multiplied."""
    inv = 1.0 / scale
    q = torch.clamp(torch.round(x * inv), -QMAX, QMAX).to(torch.int32)
    hi = (q + 64) >> 7
    return hi, q - hi * 128


def seg_hist_int8_raw_plain(
    rows: SegRows, start: int, cnt: int, num_bins: int, scales: torch.Tensor
) -> torch.Tensor:
    """Raw i32 planes [F, B, 5] (S_g_hi, S_g_lo, S_h_hi, S_h_lo, count) of
    window [start, start+cnt) on the int8 2-digit grid with ``scales`` [2]
    (g_scale, h_scale).  Integer sums: exact in any order."""
    f = rows.f
    dev = rows.device
    out = torch.zeros((f * num_bins, 5), dtype=torch.int64, device=dev)
    if cnt > 0 and f > 0:
        win = slice(start, start + cnt)
        m = rows.m[win]
        g_hi, g_lo = int8_digits(rows.g[win] * m, scales[0])
        h_hi, h_lo = int8_digits(rows.h[win] * m, scales[1])
        stats = torch.stack([g_hi, g_lo, h_hi, h_lo, (m != 0).to(torch.int32)], 1)
        ids = rows.bins[:, win].to(torch.int64) + (
            torch.arange(f, device=dev, dtype=torch.int64)[:, None] * num_bins
        )
        data = stats.to(torch.int64).unsqueeze(0).expand(f, cnt, 5).reshape(-1, 5)
        out.scatter_add_(0, ids.reshape(-1, 1).expand(-1, 5), data)
    return out.to(torch.int32).reshape(f, num_bins, 5)


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
    rows: SegRows, windows, num_bins: int, scales=None
) -> torch.Tensor:
    """[K, F, B, 3] histograms of K windows (start, cnt): f32 sums, or with
    ``scales`` [2] f32 the int8 2-digit grid recombined to f32."""
    out = []
    for start, cnt in _windows_list(windows):
        if scales is None:
            out.append(seg_hist_plain(rows, start, cnt, num_bins))
        else:
            raw = seg_hist_int8_raw_plain(rows, start, cnt, num_bins, scales)
            out.append(combine_int8(raw, scales))
    return torch.stack(out)


def seg_hist_batch(
    rows: SegRows, windows, num_bins: int, scales=None
) -> torch.Tensor:
    """K-window histogram ([K, 2] (start, cnt) host ints -> [K, F, B, 3];
    ``seg_hist_batch`` of seg.py:754): f32 sums, or with ``scales`` [2] f32
    (``quantize.hist_acc_scales``) the int8 2-digit grid.  A window with
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
        return seg_hist_batch_plain(rows, wins, num_bins, scales)
    _require_cuda(rows)
    k = len(wins)
    if k > MAX_WINDOWS:  # one call per MAX_WINDOWS windows
        return torch.cat([seg_hist_batch(rows, wins[i : i + MAX_WINDOWS], num_bins, scales)
                          for i in range(0, k, MAX_WINDOWS)])
    if k < 1:
        raise ValueError("seg_hist takes at least one window")
    if not any(c for _, c in wins):  # nothing to read: no launch
        return torch.zeros((k, rows.f, num_bins, 3), dtype=torch.float32, device=rows.device)
    return _seg_hist_launch(rows, wins, num_bins, scales)


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


def _seg_hist_launch(rows: SegRows, wins, num_bins: int, scales, fn=None) -> torch.Tensor:
    """One call of the ``csrc/seg_hist.cu`` entry (``fn``: another build of
    it) on 1 to ``MAX_WINDOWS`` windows [(start, cnt)] of CUDA rows: [K, F,
    B, 3] f32 on the card, every cell written by the kernels.  The scratch
    lives on the rows (``SegRows.step``); only the output is allocated."""
    k, f = len(wins), rows.f
    if not 1 <= k <= MAX_WINDOWS:
        raise ValueError(f"the seg_hist kernel takes 1 to {MAX_WINDOWS} windows, got {k}")
    _require_cuda(rows)
    dev = rows.device
    need = seg_hist_scratch_bytes(f, int(num_bins), scales is not None)
    if rows.step is None or rows.step.numel() < need:
        rows.step = torch.empty(need, dtype=torch.uint8, device=dev)
    out = torch.empty((k, f, num_bins, 3), dtype=torch.float32, device=dev)
    sp = None if scales is None else _device_scales(scales, dev)
    win_host = np.asarray(wins, dtype=np.int64).reshape(k, 2)
    rc = (fn or _build.entry("seg_hist"))(
        rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(), rows.m.data_ptr(),
        rows.n, win_host.ctypes.data, k, f, int(num_bins),
        None if sp is None else sp.data_ptr(), rows.step.data_ptr(), rows.step.numel(),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "seg_hist kernels")
    _build.LAUNCHES["seg_hist" if scales is None else "seg_hist_int8"] += 1
    if k > 1:
        _build.LAUNCHES["seg_hist:K>1"] += 1
    return out


def seg_hist(
    rows: SegRows, start: int, cnt: int, num_bins: int, scales=None
) -> torch.Tensor:
    """Histogram [F, B, 3] of window [start, start+cnt): ``seg_hist_batch``
    with one window."""
    return seg_hist_batch(rows, [(start, cnt)], num_bins, scales)[0]


def _device_scales(scales, dev) -> torch.Tensor:
    t = torch.as_tensor(scales, dtype=torch.float32, device=dev).reshape(2)
    return t.contiguous()


# ---------------------------------------------------------------------------
# kernel 2: stable partition of one window, or of K disjoint windows
# ---------------------------------------------------------------------------


def sort_partition_plain(
    rows: SegRows, start: int, cnt: int, feat: int, tbin: int, dl: bool,
    nanb: int,
) -> torch.Tensor:
    """Stable in-place partition of [start, start+cnt) by the split; returns
    nl as a 0-d i32 tensor (the order of ops/segpart.py sort_partition_xla:
    left rows in order, then right rows in order)."""
    if cnt <= 0:
        return torch.zeros((), dtype=torch.int32, device=rows.device)
    win = slice(start, start + cnt)
    gl = go_left(rows.bins[feat, win], tbin, dl, nanb)
    perm = torch.cat([torch.nonzero(gl)[:, 0], torch.nonzero(~gl)[:, 0]])
    rows.bins[:, win] = rows.bins[:, win][:, perm]
    for col in (rows.g, rows.h, rows.m, rows.ridx):
        col[win] = col[win][perm]
    return gl.sum().to(torch.int32)


def split_members(sbegins, cnts, feats, tbins, dls, nanbs) -> np.ndarray:
    """[K, 6] i64 host rows (start, cnt, feat, tbin, dl, nanb) of K splits
    over disjoint windows; a negative cnt counts as 0 (a no-op member).
    Raises when two non-empty windows overlap."""
    cols = [np.asarray(a, dtype=np.int64).reshape(-1)
            for a in (sbegins, cnts, feats, tbins, dls, nanbs)]
    k = len(cols[0])
    if any(len(c) != k for c in cols):
        raise ValueError("split members: arrays differ in length")
    mem = np.stack(cols, axis=1) if k else np.zeros((0, 6), np.int64)
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
    nl = [sort_partition_plain(rows, int(s), int(c), int(ft), int(tb), bool(dl), int(nb))
          for s, c, ft, tb, dl, nb in mem]
    if not nl:
        return torch.zeros(0, dtype=torch.int32, device=rows.device)
    return torch.stack(nl)


def sort_partition_batch(
    rows: SegRows, sbegins, cnts, feats, tbins, dls, nanbs
) -> torch.Tensor:
    """K stable in-place partitions over K disjoint windows (``[K]`` host
    sequences as ``split_members`` takes them; cnt = 0 is a no-op member).
    Returns nl [K] i32 on the rows' device.  Plain version on the CPU, ONE
    call of the ``csrc/partition.cu`` kernels (two launches) on a CUDA
    device (counted as ``partition_batch``)."""
    mem = split_members(sbegins, cnts, feats, tbins, dls, nanbs)
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


def partition_stage_bytes(f: int, tile: int) -> int:
    """Shared memory of one tile block: f planes of tile + 32 bytes and four
    4-byte columns of 4 * tile + 32 (the 16-byte chunks that cover an
    unaligned run), the ranks (2 bytes a row), the ballot masks and their
    scan (8 bytes per 32 rows), the planes' stage offsets (512 bytes) and
    a few words."""
    return f * (tile + 32) + 4 * (4 * tile + 32) + 2 * tile + tile // 4 + 512 + 64


def partition_tile_rows(f: int, rows: int = 0) -> int:
    """Rows a tile of the partition kernel stages: the largest of
    ``PART_TILES`` whose stage fits ``PART_BLOCK_SMEM``; for a call on
    ``rows`` rows, no larger than gives ``PART_FILL_TILES`` tiles, and no
    smaller than ``PART_MIN_TILE`` (small windows finish sooner in more,
    smaller tiles; large ones lose less to each tile's fixed cost in fewer,
    larger ones)."""
    for tile in PART_TILES:
        if partition_stage_bytes(f, tile) <= PART_BLOCK_SMEM:
            break
    else:
        widest = ((PART_BLOCK_SMEM - partition_stage_bytes(0, PART_TILES[-1]))
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
        self.shape = (rows.f, rows.n)
        self.stride = partition_scratch_rows(rows.n)
        self.planes = torch.empty((rows.f, self.stride), dtype=torch.uint8, device=dev)
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
    if rows.part is None or rows.part.shape != (rows.f, rows.n):
        rows.part = PartitionScratch(rows)
    return rows.part


def _partition_launch(rows: SegRows, mem: np.ndarray, counted_as: str, fn=None) -> torch.Tensor:
    """One call of the ``csrc/partition.cu`` entry (``fn``: another build
    of it) on K members ([K, 6] i64, C-contiguous); nl [K] i32 on the
    card."""
    k = mem.shape[0]
    if not 1 <= k <= MAX_WINDOWS:
        raise ValueError(f"the partition kernel takes 1 to {MAX_WINDOWS} windows, got {k}")
    ps = partition_scratch(rows)
    dev = rows.device
    nl = torch.empty((k,), dtype=torch.int32, device=dev)
    rc = (fn or _build.entry("partition"))(
        rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(), rows.m.data_ptr(),
        rows.ridx.data_ptr(), rows.n, rows.f, mem.ctypes.data, k,
        partition_tile_rows(rows.f, int(mem[:, 1].sum())), ps.planes.data_ptr(),
        ps.cols.data_ptr(), ps.stride, ps.status.data_ptr(), ps.staged.data_ptr(),
        ps.counter.data_ptr(), ps.next_epoch(), nl.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, "partition kernel")
    _build.LAUNCHES[counted_as] += 1
    return nl


def sort_partition(
    rows: SegRows, start: int, cnt: int, feat: int, tbin: int, dl: bool,
    nanb: int,
) -> torch.Tensor:
    """Stable in-place partition of one window; returns nl (0-d i32 tensor
    on the rows' device).  Plain version on the CPU, the
    ``csrc/partition.cu`` kernels on a CUDA device."""
    if rows.device.type == "cpu":
        return sort_partition_plain(rows, start, cnt, feat, tbin, dl, nanb)
    mem = np.array([[start, max(cnt, 0), feat, tbin, int(bool(dl)), nanb]], dtype=np.int64)
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
