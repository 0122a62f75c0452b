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

``seg_hist`` (kernel ``csrc/seg_hist.cu``) and ``sort_partition`` (kernel
``csrc/partition.cu``) dispatch on the device of the tensors they are given:
on the CPU they run their plain PyTorch versions, on a CUDA device they
launch the kernel.  Each counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import dataclasses

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
# kernel 1: histogram of one window
# ---------------------------------------------------------------------------


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


def seg_hist(rows: SegRows, start: int, cnt: int, num_bins: int) -> torch.Tensor:
    """Histogram [F, B, 3] of window [start, start+cnt): plain version on
    the CPU, the ``csrc/seg_hist.cu`` kernel on a CUDA device."""
    if rows.device.type == "cpu":
        return seg_hist_plain(rows, start, cnt, num_bins)
    _require_cuda(rows)
    out = torch.zeros((rows.f, num_bins, 3), dtype=torch.float32, device=rows.device)
    fn = _build.entry("seg_hist")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    rc = fn(
        rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(),
        rows.m.data_ptr(), rows.n, int(start), int(cnt), rows.f,
        int(num_bins), out.data_ptr(), stream,
    )
    _build.check(rc, "seg_hist kernel")
    seg_hist.launches += 1
    return out


seg_hist.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: stable partition of one window
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


_PART_TILE = 1024  # rows per block of csrc/partition.cu


def sort_partition(
    rows: SegRows, start: int, cnt: int, feat: int, tbin: int, dl: bool,
    nanb: int,
) -> torch.Tensor:
    """Stable in-place partition of one window; returns nl (0-d i32 tensor
    on the rows' device).  Plain version on the CPU, the
    ``csrc/partition.cu`` kernel on a CUDA device."""
    if rows.device.type == "cpu":
        return sort_partition_plain(rows, start, cnt, feat, tbin, dl, nanb)
    _require_cuda(rows)
    dev = rows.device
    c = max(int(cnt), 0)
    s_bins = torch.empty((rows.f, c), dtype=torch.uint8, device=dev)
    s_g = torch.empty((c,), dtype=torch.float32, device=dev)
    s_h = torch.empty_like(s_g)
    s_m = torch.empty_like(s_g)
    s_ridx = torch.empty((c,), dtype=torch.int32, device=dev)
    blocks = torch.empty(
        (max(1, -(-c // _PART_TILE)),), dtype=torch.int32, device=dev
    )
    nl = torch.empty((), dtype=torch.int32, device=dev)
    fn = _build.entry("partition")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(
        rows.bins.data_ptr(), rows.g.data_ptr(), rows.h.data_ptr(),
        rows.m.data_ptr(), rows.ridx.data_ptr(), rows.n, int(start), c,
        rows.f, int(feat), int(tbin), int(bool(dl)), int(nanb),
        s_bins.data_ptr(), s_g.data_ptr(), s_h.data_ptr(), s_m.data_ptr(),
        s_ridx.data_ptr(), blocks.data_ptr(), nl.data_ptr(), stream,
    )
    _build.check(rc, "partition kernel")
    sort_partition.launches += 1
    return nl


sort_partition.launches = 0


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
