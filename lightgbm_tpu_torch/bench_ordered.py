"""The ordered-layout histogram kernel (``csrc/ordered_hist.cu``) on the
card: its cases, its check against the plain versions, and its time against
other builds of it.

Run from the root of a checkout, on a machine with the card::

    python3 -m lightgbm_tpu_torch.bench_ordered [--baseline OTHER.cu]
        [--variant NAME=-DMACRO=VALUE ...] [--sass] [--rows N]

It makes Expo-shaped bins on the card from a seed (1,048,576 x 700 by
default, 208-256 bins a feature, B = 256), the f32 statistics of a binary
objective and their quantized form, then for each case below checks every
build against the plain versions (int8 bit-equal, counts exact, f32 g and h
within ``ordered_tol``; this source's f32 the same bits on two calls, the
others' reported as ``<build> repeatable``) and times them by CUDA events,
the builds in turns
(baseline, this source, variants, ..., then the reverse order), with the
bound and one ``index_add_`` of the same sums beside them, and each build's
device time alone (``device_ms``: the kernels' own times under
torch.profiler, without the host's time between launches):

* root: every row, no index;
* K=2: two unaligned windows of a shuffled index, 87% of the rows;
* small K=1 / small K=4: windows of 14,000 rows of the shuffled index (a
  tree's smaller children average about that at 1,048,576 rows);
* median K=1: one window of 4,000 rows (the median launch of a profiled
  255-leaf tree at 1,048,576 rows);
* skewed: the root with 64 of the 700 features putting 90% of rows in one
  bin.

``--baseline`` builds another version of the source (same C entry) into a
temporary directory; ``--variant`` builds this source with extra compiler
flags; ``--sass`` prints the atomic instructions of each build's SASS
(``cuobjdump -sass``).  chip_smoke.py runs the same cases and checks on
this build alone.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _build
from ._bench import HBM_BYTES_PER_S, build_library, card_line, device_ms, time_ms
from .ops import histogram as oh

SMALL_ROWS = 14_000
MEDIAN_ROWS = 4_000  # the median window of a profiled 255-leaf wide tree
SKEWED_FEATURES = 64
SKEW_SHARE = 0.9


def synthetic_inputs(n: int, f: int, dev, seed: int = 0):
    """(f32 rows, quantized rows, scales, [F] i32 bins a feature):
    Expo-shaped bins made on the card from ``seed`` (feature j has 208-256
    bins, uniform, no NaN bin), the gradients and hessians of a binary
    objective at a random score, all rows in bag."""
    from .quantize import quantize_gradients

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    stride = -(-f // oh.ROW_ALIGN) * oh.ROW_ALIGN
    nb = torch.randint(208, 257, (f,), generator=gen, device=dev).to(torch.float32)
    bins = torch.zeros((n, stride), dtype=torch.uint8, device=dev)
    for lo in range(0, n, 1 << 16):  # bound the f32 temporary
        hi = min(n, lo + (1 << 16))
        u = torch.rand((hi - lo, f), generator=gen, device=dev)
        bins[lo:hi, :f] = (u * nb).to(torch.uint8)
    y = (torch.rand(n, generator=gen, device=dev) < 0.5).to(torch.float32)
    p = torch.sigmoid(torch.randn(n, generator=gen, device=dev))
    grad, hess = p - y, p * (1.0 - p)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    qg, qh, gs, hs = quantize_gradients(grad, hess, 4)
    return (oh.OrderedRows(bins, f, grad, hess, ones), oh.OrderedRows(bins, f, qg, qh, ones),
            torch.stack([gs, hs]), nb.to(torch.int32))


def skewed_bins(bins: torch.Tensor, f: int, seed: int = 1) -> torch.Tensor:
    """A copy of ``bins`` where 64 features spread over the row (every
    ~11th) put 90% of the rows in their bin 0."""
    gen = torch.Generator(device=bins.device)
    gen.manual_seed(seed)
    out = bins.clone()
    feats = torch.linspace(0, f - 1, SKEWED_FEATURES, device=bins.device).round().long()
    for j in feats.tolist():
        hot = torch.rand(bins.shape[0], generator=gen, device=bins.device) < SKEW_SHARE
        out[hot, j] = 0
    return out


def cases(rows: oh.OrderedRows, seed: int = 5):
    """{name: (rows of the case, index or None, windows)}."""
    n, dev = rows.n, rows.device
    order = torch.as_tensor(np.random.default_rng(seed).permutation(n).astype(np.int32),
                            device=dev)
    small = min(SMALL_ROWS, n // 8)
    skew = oh.OrderedRows(skewed_bins(rows.bins, rows.f), rows.f, rows.g, rows.h, rows.m)
    return {
        "root": (rows, None, [(0, n)]),
        "K=2": (rows, order, [(37, n // 3 + 1), (37 + n // 3 + 1, n // 2)]),
        "small K=1": (rows, order, [(101, small)]),
        "median K=1": (rows, order, [(77, min(MEDIAN_ROWS, n // 8))]),
        "small K=4": (rows, order, [(101 + i * (small + 3), small) for i in range(4)]),
        "skewed": (skew, None, [(0, n)]),
    }


def ordered_tol(rows, order, windows, b, counts):
    """Worst-case |error| of an f32 sum of c terms per bin, c * 2^-24 *
    sum|x|, for two sums taken in different orders (g and h each), from the
    plain version on |g| and |h|."""
    absr = oh.OrderedRows(rows.bins, rows.f, rows.g.abs(), rows.h.abs(), rows.m)
    scale = oh.ordered_hist_plain(absr, order, windows, b)[..., :2]
    return 2.0 * counts * 2.0**-24 * scale + 1e-6


def check(name: str, hk, hp, h8k, h8p, rows, order, wins, b, again=None) -> float:
    """Raise unless the kernel's f32 histogram ``hk`` has the plain ``hp``'s
    counts exactly and g, h within ``ordered_tol``, and the int8 one
    ``h8k`` equals ``h8p``; with ``again`` (the f32 histogram of a second
    call), unless the two are the same bits.  Returns the f32 max |error|."""
    if again is not None and not torch.equal(hk, again):
        raise AssertionError(f"ordered_hist {name}: f32 sums differ between two calls")
    err = (hk[..., :2] - hp[..., :2]).abs()
    if not torch.equal(hk[..., 2], hp[..., 2]) or bool(
            (err > ordered_tol(rows, order, wins, b, hp[..., 2:3])).any()):
        raise AssertionError(f"ordered_hist {name}: off the plain version by {float(err.max())}")
    if not torch.equal(h8k, h8p):
        raise AssertionError(f"ordered_hist_int8 {name}: differs from the plain version")
    return float(err.max())


def bound_ms(rows: oh.OrderedRows, order, wins, b: int) -> float:
    """Each row read once (its F bin bytes, three f32 statistics and, with
    an index, its i32 row index), the K histograms written once."""
    rows_k = sum(c for _, c in wins)
    nbytes = rows_k * (rows.f + 12 + (4 if order is not None else 0)) + len(wins) * rows.f * b * 12
    return nbytes / HBM_BYTES_PER_S * 1e3


def library_ms(rows, order, wins, b, scales=None) -> float:
    """One ``index_add_`` of the windows' (g*m, h*m, m) rows, or with
    ``scales`` their i32 digit rows, into a [K * F * B] table."""
    dev, f = rows.device, rows.f
    ids, stats = [], []
    for k, (s0, c) in enumerate(wins):
        idx = oh.window_rows(order, s0, c, dev)
        ids.append((rows.bins[idx, :f].long() + (k * f + torch.arange(f, device=dev)) * b)
                   .reshape(-1))
        m = rows.m[idx]
        st = (torch.stack([rows.g[idx] * m, rows.h[idx] * m, m], 1) if scales is None
              else oh.int8_digit_rows(rows.g[idx], rows.h[idx], m, scales))
        stats.append(st.repeat_interleave(f, dim=0))
    ids, stats = torch.cat(ids), torch.cat(stats)
    ms = time_ms(lambda: torch.zeros(len(wins) * f * b, stats.shape[1], dtype=stats.dtype,
                                     device=dev).index_add_(0, ids, stats), reps=5)
    del ids, stats
    torch.cuda.empty_cache()
    return ms


# ----------------------------------------------------------------- builds
def build_other(src: str, flags: List[str], out_dir: str):
    """Build ``src`` (with ``flags``) into ``out_dir``: ((its lgbt_ordered_hist
    entry, its lgbt_ordered_hist_scratch entry or None for a source of the
    older interface: no scratch, output zeroed by the caller), the library
    path)."""
    lib, _ = build_library(src, flags, out_dir)
    so = ctypes.CDLL(lib)
    fn = so.lgbt_ordered_hist
    if hasattr(so, "lgbt_ordered_hist_scratch"):
        fn.argtypes = list(_build.SIGNATURES["ordered_hist"])
        _, argtypes, restype = _build.EXTRA_ENTRIES["ordered_hist_scratch"]
        scratch = so.lgbt_ordered_hist_scratch
        scratch.argtypes, scratch.restype = list(argtypes), restype
    else:
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ctypes.c_longlong] + [vp] * 5 + [i32] * 3 + [vp] * 3
        scratch = None
    fn.restype = ctypes.c_int
    return (fn, scratch), lib


def sass_atomics(lib: str) -> Dict[str, Dict[str, int]]:
    """{kernel: {atomic SASS opcode: count}} of a built library."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    found: Dict[str, Counter] = {}
    fn = "?"
    for ln in out.splitlines():
        s = ln.strip()
        if s.startswith("Function :"):
            fn = s.split(":", 1)[1].strip()
            continue
        for word in s.replace(";", " ").split():
            if word.startswith(("ATOMS", "ATOMG", "ATOM.", "RED.", "REDG", "REDUX")):
                found.setdefault(fn, Counter())[word] += 1
    return {k: dict(v) for k, v in found.items()}


def launch_with(entry, rows, order, wins, b: int, scales=None) -> torch.Tensor:
    """One call of a build's C entry, as the wrapper (ops/histogram.py)
    calls it: the raw f32 [K, F, B, 3] or i32 [K, F, B, 5] output."""
    fn, scratch_fn = entry
    k, f, dev = len(wins), rows.f, rows.device
    win_host = np.asarray(wins, dtype=np.int64).reshape(k, 2)
    args = (rows.bins.data_ptr(), int(rows.bins.shape[1]),
            None if order is None else order.data_ptr(), rows.g.data_ptr(),
            rows.h.data_ptr(), rows.m.data_ptr(), win_host.ctypes.data, k, f, b,
            None if scales is None else scales.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    if scratch_fn is None:  # the older interface: output zeroed here
        planes, dt = (3, torch.float32) if scales is None else (5, torch.int32)
        out = torch.zeros((k, f, b, planes), dtype=dt, device=dev)
        rc = fn(*args, out.data_ptr(), stream)
    else:
        out, scratch = oh.kernel_buffers(scratch_fn, k, f, b, scales is not None, dev)
        rc = fn(*args, scratch.data_ptr(), scratch.numel(), out.data_ptr(), stream)
    _build.check(rc, "ordered_hist (a build of the bench)")
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", help="another ordered_hist.cu to time beside this one")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: this source built with extra nvcc flags")
    ap.add_argument("--sass", action="store_true", help="print each build's atomic opcodes")
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--features", type=int, default=700)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_ordered: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    _build.build_all(["ordered_hist"])
    builds = {"this": ((_build.entry("ordered_hist"), _build.entry("ordered_hist_scratch")),
                       os.path.join(_build.BUILD, "libordered_hist.so"))}
    tmp = tempfile.mkdtemp(prefix="ordered_bench_")
    src = os.path.join(_build.CSRC, "ordered_hist.cu")
    if args.baseline:
        builds["baseline"] = build_other(args.baseline, [], tmp)
    for v in args.variant:
        name, _, flags = v.partition("=")
        builds[name] = build_other(src, flags.split(), tmp)
    if args.sass:
        for name, (_, lib) in builds.items():
            print(f"sass {name}: {json.dumps(sass_atomics(lib))}")

    rows, qrows, scales, _ = synthetic_inputs(args.rows, args.features, dev)
    b = 256
    order_names = list(builds) + list(builds)[::-1]
    results = {}
    for cname, (crows, order, wins) in cases(rows).items():
        cq = oh.OrderedRows(crows.bins, crows.f, qrows.g, qrows.h, qrows.m)
        hp = oh.ordered_hist_plain(crows, order, wins, b)
        h8p = oh.ordered_hist_int8_raw_plain(cq, order, wins, b, scales)
        errs = {}
        for name, (entry, _) in builds.items():
            hk = launch_with(entry, crows, order, wins, b)
            h8k = launch_with(entry, cq, order, wins, b, scales)
            again = launch_with(entry, crows, order, wins, b)
            torch.cuda.synchronize()
            errs[f"{name} repeatable"] = float(torch.equal(hk, again))
            errs[name] = check(f"{cname} ({name})", hk, hp, h8k, h8p, crows, order, wins, b,
                               again if name == "this" else None)
            del hk, h8k, again
        del hp, h8p
        times: Dict[str, List[float]] = {}
        for name in order_names:
            entry = builds[name][0]
            for mode, sc, rr in (("f32", None, crows), ("int8", scales, cq)):
                times.setdefault(f"{name} {mode}", []).append(
                    time_ms(lambda: launch_with(entry, rr, order, wins, b, sc), reps=args.reps))
        res = {key: statistics.median(v) for key, v in times.items()}
        for name in builds:  # device time alone (kernels, the zeroing included)
            entry = builds[name][0]
            for mode, sc, rr in (("f32", None, crows), ("int8", scales, cq)):
                res[f"{name} {mode} device"] = device_ms(
                    lambda: launch_with(entry, rr, order, wins, b, sc))
        res["bound"] = bound_ms(crows, order, wins, b)
        res["index_add_ f32"] = library_ms(crows, order, wins, b)
        res["index_add_ int8"] = library_ms(cq, order, wins, b, scales)
        results[cname] = res
        rows_k = sum(c for _, c in wins)
        print(f"case {cname}: {len(wins)} window(s), {rows_k} rows x {crows.f} features; "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in res.items())
              + "; f32 max |err| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
        del cq
        if cname == "skewed":
            del crows
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "cases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
