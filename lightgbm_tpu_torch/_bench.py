"""Helpers shared by the kernel benches (``bench_ordered``,
``bench_partition``, ``bench_grow_step``) and chip_smoke.py: the card's
line, timing by CUDA events and by device time under torch.profiler, the
tolerance of an f32 histogram, and building another version of a kernel
source into a directory of its own.  Nothing here runs at import time."""

from __future__ import annotations

import os
import statistics
import subprocess
import time
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


# the profiler can lose device operations of a short trace (none, or not a
# whole number a call); such a trace reads NaN, "not measured", unless a
# retake with idle host time at the end of its window is whole.  TRACES
# counts the traces taken and lost in this process.
TRACES = {"taken": 0, "lost": 0}


def _device_events(fn: Callable, reps: int, setup: Optional[Callable], idle: float = 0.0):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if setup is not None:
                setup()
            fn()
        torch.cuda.synchronize()
        time.sleep(idle)
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _whole_trace(fn: Callable, reps: int, setup: Optional[Callable], idle: float = 0.0,
                 empty_ok: bool = False):
    """The device events of ``reps`` calls of ``fn``, or None when the
    trace lost some (no device operation, unless ``empty_ok``, or a count
    that is not a whole number a call) and, with ``idle`` > 0, so did a
    retake with ``idle`` s of idle time at the end of its window."""
    TRACES["taken"] += 1
    for pad in (0.0, idle) if idle > 0 else (0.0,):
        events = _device_events(fn, reps, setup, pad)
        if (events or empty_ok) and len(events) % reps == 0:
            if pad:
                print(f"device trace: whole with {pad} s of idle time at the end of its window")
            return events
        print(f"device trace: {len(events)} device operations over {reps} calls with {pad} s of "
              "idle time at the end of the window: the profiler lost some")
    TRACES["lost"] += 1
    print("device trace: lost; this device time is not measured (NaN)")
    return None


def device_ms(fn: Callable, reps: int = 10, setup: Optional[Callable] = None) -> float:
    """Device time of one call: the sum of the card's kernel times over
    ``reps`` calls under torch.profiler, divided by ``reps`` (no host time
    between launches, unlike ``time_ms``); NaN when the trace lost device
    operations."""
    return device_profile(fn, reps, setup)[0]


def device_profile(fn: Callable, reps: int = 10, setup: Optional[Callable] = None,
                   idle: float = 0.0) -> Tuple[float, float]:
    """(device ms, device operations) of one call, as ``device_ms``; with
    ``setup`` (run before each call), the device time and operations of
    ``setup`` alone over as many calls (profiled on their own) are taken
    out of both.  (NaN, NaN) when a trace lost device operations
    (``_whole_trace``, retaken with ``idle`` s at the end of its window)."""
    fn()
    events = _whole_trace(fn, reps, setup, idle)
    alone = [] if setup is None else _whole_trace(setup, reps, None, idle, empty_ok=True)
    if events is None or alone is None:
        return float("nan"), float("nan")
    us = sum(e.time_range.elapsed_us() for e in events) - sum(
        e.time_range.elapsed_us() for e in alone)
    return us / reps / 1e3, (len(events) - len(alone)) / reps


def device_by_name(fn: Callable, reps: int = 10,
                   setup: Optional[Callable] = None) -> Dict[str, float]:
    """{device operation: ms a call} of ``fn``, leaving out the operations
    whose names ``setup`` alone runs; empty when a trace lost device
    operations."""
    fn()
    alone = [] if setup is None else _whole_trace(setup, 1, None, empty_ok=True)
    events = _whole_trace(fn, reps, setup)
    if events is None or alone is None:
        return {}
    skip = {e.name for e in alone}
    out: Dict[str, float] = {}
    for e in events:
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
