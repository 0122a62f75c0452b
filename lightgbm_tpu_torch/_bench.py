"""Helpers shared by the kernel benches (``bench_ordered``,
``bench_partition``, ``bench_grow_step``) and chip_smoke.py: the card's
line, timing by CUDA events and by device time under torch.profiler, the
tolerance of an f32 histogram, and building another version of a kernel
source into a directory of its own.  Nothing here runs at import time."""

from __future__ import annotations

import os
import statistics
import subprocess
from typing import Callable, Dict, Optional, Tuple

import torch

from . import _build

HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM rate


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def time_ms(fn: Callable, reps: int = 20, warmup: int = 2,
            setup: Optional[Callable] = None) -> float:
    """Median device time of one call, by CUDA events around each call;
    ``setup`` (for example restoring rows that ``fn`` rewrites in place)
    runs before each call, outside the events."""
    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        z.record()
        z.synchronize()
        times.append(a.elapsed_time(z))
    return statistics.median(times)


def _device_events(fn: Callable, reps: int, setup: Optional[Callable]):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(fn: Callable, reps: int = 10, setup: Optional[Callable] = None) -> float:
    """Device time of one call: the sum of the card's kernel times over
    ``reps`` calls under torch.profiler, divided by ``reps`` (no host time
    between launches, unlike ``time_ms``)."""
    return device_profile(fn, reps, setup)[0]


def device_profile(fn: Callable, reps: int = 10,
                   setup: Optional[Callable] = None) -> Tuple[float, float]:
    """(device ms, device operations) of one call, as ``device_ms``; with
    ``setup`` (run before each call), the device time and operations of
    ``setup`` alone over as many calls (profiled on their own) are taken
    out of both."""
    fn()
    events = _device_events(fn, reps, setup)
    us = sum(e.time_range.elapsed_us() for e in events)
    ops = len(events)
    if setup is not None:
        alone = _device_events(setup, reps, None)
        us -= sum(e.time_range.elapsed_us() for e in alone)
        ops -= len(alone)
    return us / reps / 1e3, ops / reps


def device_by_name(fn: Callable, reps: int = 10,
                   setup: Optional[Callable] = None) -> Dict[str, float]:
    """{device operation: ms a call} of ``fn``, leaving out the operations
    whose names ``setup`` alone runs."""
    fn()
    skip = set() if setup is None else {e.name for e in _device_events(setup, 1, None)}
    out: Dict[str, float] = {}
    for e in _device_events(fn, reps, setup):
        if e.name not in skip:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    return out


def f32_tol(rows, windows, b: int, counts: torch.Tensor) -> torch.Tensor:
    """Worst-case |error| of an f32 sum of c terms per bin, c * 2^-24 *
    sum|x|, for two sums of the windows' (g*m, h*m) taken in different
    orders; ``counts`` [K, F, B, 1] the bins' counts."""
    from .ops import seg

    absr = seg.SegRows(rows.bins, rows.g.abs(), rows.h.abs(), rows.m, rows.ridx,
                       wide=rows.wide, used_bins=rows.used_bins)
    scale = seg.seg_hist_batch_plain(absr, windows, b)[..., :2]
    return 2.0 * counts * 2.0**-24 * scale + 1e-6


def build_library(src: str, flags, out_dir: str) -> Tuple[str, str]:
    """Compile ``src`` (with extra nvcc ``flags``, the headers of csrc/ on
    the include path) into a shared library in ``out_dir``: (its path,
    ptxas's registers and spills a kernel)."""
    lib = os.path.join(out_dir, f"lib{abs(hash((src, tuple(flags))))}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-I", _build.CSRC, "-o", lib, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} {flags}:\n{out}")
    return lib, _build.ptxas_report(out)
