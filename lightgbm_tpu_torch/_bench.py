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


# The profiler can lose device operations of a trace (none, or not a whole
# number a call).  A trace is one profiler session over every part of a
# measurement (``setup`` alone, then ``setup`` and ``fn``), the parts told
# apart by a marker kernel between them, read once after a synchronize; a
# take that lost operations is taken again with a forced flush of CUPTI's
# activity buffers before the profiler stops (``_flush_activity``), and
# then, where asked, with idle host time at the end of its window.  A
# trace whose takes all lost operations reads NaN, "not measured".  TRACES
# counts the traces taken, those lost in the end, and the takes that lost
# operations in one session ("session") and with the flush ("flush").
TRACES = {"taken": 0, "lost": 0, "session": 0, "flush": 0}
# torch.cuda._sleep's kernel, at::cuda::(anonymous namespace)::spin_kernel(long)
_MARKER = "spin_kernel"
_CUPTI = {}


def _flush_activity() -> bool:
    """cuptiActivityFlushAll with CUPTI_ACTIVITY_FLAG_FLUSH_FORCED on the
    CUPTI library this process loaded (found in /proc/self/maps), so that
    buffers holding incomplete records are delivered before the profiler
    stops; False when no such library is loaded."""
    if "fn" not in _CUPTI:
        _CUPTI["fn"] = None
        try:
            with open("/proc/self/maps") as fh:
                paths = sorted({ln.split()[-1] for ln in fh if "libcupti" in ln})
        except OSError:
            paths = []
        if paths:
            import ctypes

            fn = ctypes.CDLL(paths[0]).cuptiActivityFlushAll
            fn.argtypes, fn.restype = [ctypes.c_uint32], ctypes.c_int
            _CUPTI["fn"] = fn
    if _CUPTI["fn"] is None:
        return False
    return _CUPTI["fn"](1) == 0


def _session(parts, flush: bool, idle: float):
    """The device events of each part [(fn, reps, setup)] of one profiler
    session, or None when the markers between the parts were lost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, (fn, reps, setup) in enumerate(parts):
            if i:
                torch.cuda._sleep(1000)
            for _ in range(reps):
                if setup is not None:
                    setup()
                fn()
        torch.cuda.synchronize()
        if flush:
            _flush_activity()
        time.sleep(idle)
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if _MARKER in e.name]
    if len(marks) != len(parts) - 1:
        return None
    bounds = [-1] + marks + [len(events)]
    return [events[a + 1:b] for a, b in zip(bounds, bounds[1:])]


def _device_events(fn: Callable, reps: int, setup: Optional[Callable], idle: float = 0.0):
    """The device events of one session of ``reps`` calls of ``fn``
    (``setup`` before each), read after the forced flush; [] when the
    session lost its parts."""
    got = _session([(fn, reps, setup)], True, idle)
    return [] if got is None else got[0]


def _whole_trace(parts, idle: float = 0.0):
    """The device events of each part [(fn, reps, setup, empty_ok)] of one
    trace (``_session``), or None when every take lost some: no device
    operation in a part (unless ``empty_ok``), or a count that is not a
    whole number of its reps.  Taken in one session, again with the forced
    flush, and with ``idle`` > 0 once more with ``idle`` s at the end of
    the window."""
    TRACES["taken"] += 1
    calls = [(fn, reps, setup) for fn, reps, setup, _ in parts]
    takes = [("session", False, 0.0), ("flush", True, 0.0)]
    if idle > 0:
        takes.append(("idle", True, idle))
    for name, flush, pad in takes:
        got = _session(calls, flush, pad)
        if got is not None and all((ev or empty_ok) and len(ev) % reps == 0
                                   for ev, (_, reps, _, empty_ok) in zip(got, parts)):
            if name != "session":
                print(f"device trace: whole when taken again ({name})")
            return got
        TRACES[name] = TRACES.get(name, 0) + 1
        got_n = "markers lost" if got is None else [len(ev) for ev in got]
        print(f"device trace: a take ({name}) lost device operations (device operations a "
              f"part {got_n}, calls a part {[reps for _, reps, _ in calls]})")
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
    ``setup`` alone over as many calls (the first part of the same
    session) are taken out of both.  (NaN, NaN) when the trace lost device
    operations (``_whole_trace``, retaken with ``idle`` s at the end of its
    window)."""
    fn()
    parts = [(fn, reps, setup, False)]
    if setup is not None:
        parts.insert(0, (setup, reps, None, True))
    got = _whole_trace(parts, idle)
    if got is None:
        return float("nan"), float("nan")
    events, alone = got[-1], (got[0] if setup is not None else [])
    us = sum(e.time_range.elapsed_us() for e in events) - sum(
        e.time_range.elapsed_us() for e in alone)
    return us / reps / 1e3, (len(events) - len(alone)) / reps


def device_by_name(fn: Callable, reps: int = 10,
                   setup: Optional[Callable] = None) -> Dict[str, float]:
    """{device operation: ms a call} of ``fn``, leaving out the operations
    whose names ``setup`` alone runs; empty when the trace lost device
    operations."""
    fn()
    parts = [(fn, reps, setup, False)]
    if setup is not None:
        parts.insert(0, (setup, 1, None, True))
    got = _whole_trace(parts)
    if got is None:
        return {}
    skip = {e.name for e in got[0]} if setup is not None else set()
    out: Dict[str, float] = {}
    for e in got[-1]:
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
