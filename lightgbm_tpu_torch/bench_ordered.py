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

``--baseline`` builds another version of the source (this C entry, or the
earlier ones without the u16 mode) into a temporary directory;
``--variant`` builds this source with extra compiler flags; ``--sass``
prints the atomic instructions of each build's SASS (``cuobjdump -sass``).
chip_smoke.py runs the same cases and checks on this build alone.

Then the u16 mode (``run_u16``), on u16 bins
made on the card: 1,048,576 x 700 at 1,024 bins (700-1,024 bins a
feature; four bin ranges) on the cases above but the skewed one, and
1,048,576 x 28 roots at 8,192 and 16,384 bins (5,000-8,192 and
9,000-16,384 bins a feature), each checked as above (f32 within
``ordered_tol`` and the same bits on two calls, int8 bit-equal), timed
(event and device time, the plain version's time at the roots) beside the
u8 mode on the same windows of the u8 table (device time), one
``index_add_`` of the same sums and the bound; then the edge cases,
checked, not timed, at 1,024 bins: a feature narrower than the widest,
bins at 255 and 256, a NaN bin past 255, an empty window among K, windows
under 32 rows, and rows of at most 700 bins (three ranges, the fourth
written 0).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
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


def synthetic_inputs(n: int, f: int, dev, seed: int = 0, span=(208, 257)):
    """(f32 rows, quantized rows, scales, [F] i32 bins a feature):
    Expo-shaped bins made on the card from ``seed`` (feature j has a
    uniform number of bins in ``span``, 208-256 by default, each bin
    equally likely, no NaN bin; u16 bins past 256, u8 ones else), the
    gradients and hessians of a binary objective at a random score, all
    rows in bag."""
    from .quantize import quantize_gradients

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    wide = span[1] > 257
    per = oh.ROW_ALIGN // (2 if wide else 1)  # bins of a 16-byte vector
    stride = -(-f // per) * per
    nb = torch.randint(span[0], span[1], (f,), generator=gen, device=dev).to(torch.float32)
    # u16 bins written through an i16 view (PyTorch's uint16 takes few operators)
    bins = torch.zeros((n, stride), dtype=torch.int16 if wide else torch.uint8, device=dev)
    for lo in range(0, n, 1 << 16):  # bound the f32 temporary
        hi = min(n, lo + (1 << 16))
        u = torch.rand((hi - lo, f), generator=gen, device=dev)
        bins[lo:hi, :f] = (u * nb).to(torch.int32).to(bins.dtype)
    if wide:
        bins = bins.view(torch.uint16)
    used = int(nb.max()) if wide else 0
    y = (torch.rand(n, generator=gen, device=dev) < 0.5).to(torch.float32)
    p = torch.sigmoid(torch.randn(n, generator=gen, device=dev))
    grad, hess = p - y, p * (1.0 - p)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    qg, qh, gs, hs = quantize_gradients(grad, hess, 4)
    return (oh.OrderedRows(bins, f, grad, hess, ones, used),
            oh.OrderedRows(bins, f, qg, qh, ones, used),
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


def cases(rows: oh.OrderedRows, seed: int = 5, skewed: bool = True):
    """{name: (rows of the case, index or None, windows)}; the skewed root
    on u8 rows only, and with ``skewed``."""
    n, dev = rows.n, rows.device
    order = torch.as_tensor(np.random.default_rng(seed).permutation(n).astype(np.int32),
                            device=dev)
    small = min(SMALL_ROWS, n // 8)
    out = {
        "root": (rows, None, [(0, n)]),
        "K=2": (rows, order, [(37, n // 3 + 1), (37 + n // 3 + 1, n // 2)]),
        "small K=1": (rows, order, [(101, small)]),
        "median K=1": (rows, order, [(77, min(MEDIAN_ROWS, n // 8))]),
        "small K=4": (rows, order, [(101 + i * (small + 3), small) for i in range(4)]),
    }
    if skewed and not rows.wide:
        out["skewed"] = (oh.OrderedRows(skewed_bins(rows.bins, rows.f), rows.f, rows.g, rows.h,
                                        rows.m), None, [(0, n)])
    return out


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
    """Each row read once (its F bins, a byte or two each, three f32
    statistics and, with an index, its i32 row index), the K histograms
    written once."""
    rows_k = sum(c for _, c in wins)
    row_bytes = rows.f * rows.bins.element_size() + 12 + (4 if order is not None else 0)
    nbytes = rows_k * row_bytes + len(wins) * rows.f * b * 12
    return nbytes / HBM_BYTES_PER_S * 1e3


def library_ms(rows, order, wins, b, scales=None) -> float:
    """One ``index_add_`` of the windows' (g*m, h*m, m) rows, or with
    ``scales`` their i32 digit rows, into a [K * F * B] table."""
    dev, f = rows.device, rows.f
    ids, stats = [], []
    for k, (s0, c) in enumerate(wins):
        idx = oh.window_rows(order, s0, c, dev)
        ids.append((oh.gather_bins(rows.bins, idx, 0, f)
                    + (k * f + torch.arange(f, device=dev)) * b).reshape(-1))
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
# a build's C interface, by the parameters of its lgbt_ordered_hist: this
# one (u16 mode, bin bytes and ranges), PR 7-15's (a scratch, u8 only), or
# PR 5's (no scratch, the output zeroed by the caller)
U16, SCRATCH, ZEROED = "u16", "scratch", "zeroed"


def interface(src: str) -> str:
    """The C interface of a source of ``ordered_hist.cu``."""
    with open(src) as fh:
        text = fh.read()
    decl = re.search(r'extern "C" int lgbt_ordered_hist\(([^)]*)\)', text).group(1)
    if len(decl.split(",")) == len(_build.SIGNATURES["ordered_hist"]):
        return U16
    return SCRATCH if "lgbt_ordered_hist_scratch" in text else ZEROED


def build_other(src: str, flags: List[str], out_dir: str):
    """Build ``src`` (with ``flags``) into ``out_dir``: ((its lgbt_ordered_hist
    entry, its lgbt_ordered_hist_scratch entry or None, its interface), the
    library path)."""
    lib, _ = build_library(src, flags, out_dir)
    so = ctypes.CDLL(lib)
    fn, kind = so.lgbt_ordered_hist, interface(src)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    scratch = None
    if kind == U16:
        fn.argtypes = list(_build.SIGNATURES["ordered_hist"])
        _, argtypes, restype = _build.EXTRA_ENTRIES["ordered_hist_scratch"]
        scratch = so.lgbt_ordered_hist_scratch
        scratch.argtypes, scratch.restype = list(argtypes), restype
    elif kind == SCRATCH:
        fn.argtypes = [vp, i64] + [vp] * 5 + [i32] * 3 + [vp, vp, i64, vp, vp]
        scratch = so.lgbt_ordered_hist_scratch
        scratch.argtypes, scratch.restype = [vp] + [i32] * 4, i64
    else:
        fn.argtypes = [vp, i64] + [vp] * 5 + [i32] * 3 + [vp] * 3
    fn.restype = ctypes.c_int
    return (fn, scratch, kind), lib


def this_build():
    """This source's build, as ``build_other`` returns a build's entry."""
    return (_build.entry("ordered_hist"), _build.entry("ordered_hist_scratch"), U16)


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
    fn, scratch_fn, kind = entry
    k, f, dev = len(wins), rows.f, rows.device
    if rows.wide and kind != U16:
        raise ValueError("this build predates the u16 mode")
    win_host = np.asarray(wins, dtype=np.int64).reshape(k, 2)
    width, ranges = rows.bins.element_size(), oh.ordered_ranges(rows, b)
    args = (rows.bins.data_ptr(), int(rows.bins.shape[1]),
            None if order is None else order.data_ptr(), rows.g.data_ptr(),
            rows.h.data_ptr(), rows.m.data_ptr(), win_host.ctypes.data, k, f, b)
    args += (width, ranges) if kind == U16 else ()
    args += (None if scales is None else scales.data_ptr(),)
    stream = torch.cuda.current_stream(dev).cuda_stream
    int8 = scales is not None
    if kind == ZEROED:  # the output zeroed here
        planes, dt = (3, torch.float32) if scales is None else (5, torch.int32)
        out = torch.zeros((k, f, b, planes), dtype=dt, device=dev)
        rc = fn(*args, out.data_ptr(), stream)
    else:
        if kind == U16:
            out, scratch = oh.kernel_buffers(scratch_fn, k, f, b, int8, dev, width, ranges)
        else:
            most = np.tile(np.array([[0, 1 << 40]], dtype=np.int64), (k, 1))
            need = scratch_fn(most.ctypes.data, k, f, b, int(int8))
            if need < 0:
                _build.check(-need, "ordered_hist scratch size")
            out = torch.empty((k, f, b, 5 if int8 else 3),
                              dtype=torch.int32 if int8 else torch.float32, device=dev)
            scratch = torch.empty(need, dtype=torch.uint8, device=dev)
        rc = fn(*args, scratch.data_ptr(), scratch.numel(), out.data_ptr(), stream)
    _build.check(rc, "ordered_hist (a build of the bench)")
    return out


# ---------------------------------------------------------------- u16 mode
U16_BINS = 1024
U16_SPAN = (700, 1025)  # bins a feature at 1,024 bins
WIDE_SPANS = {8192: (5000, 8193), 16384: (9000, 16385)}  # ... at 8,192 / 16,384 bins
WIDE_FEATURES = 28
EDGE_ROWS = 1 << 16
EDGE_FEATURES = 40


def edge_inputs_u16(n: int, f: int, dev, seed: int = 7, used: int = U16_BINS):
    """(f32 rows, quantized rows, scales) of u16 bins below ``used`` made
    on the card: feature 1 of at most 300 bins (narrower than the widest),
    feature 2 at bins 0, 255, 256 and 700 only, 5% of every feature in the
    last bin (a NaN bin past 255)."""
    rows, qrows, scales, _ = synthetic_inputs(n, f, dev, seed, span=(used, used + 1))
    b = rows.bins.view(torch.int16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b[:, 1] = torch.remainder(b[:, 1].to(torch.int32), 300).to(torch.int16)
    pick = torch.tensor([0, 255, 256, min(700, used - 1)], dtype=torch.int16, device=dev)
    b[:, 2] = pick[torch.randint(0, 4, (n,), generator=gen, device=dev)]
    nan = torch.rand((n, f), generator=gen, device=dev) < 0.05
    b[:, :f][nan] = used - 1
    return rows, qrows, scales


def edge_cases_u16(n: int) -> Dict[str, list]:
    """Window sets of the u16 edge cases over a shuffled index of n rows."""
    return {"K=4, one window empty, one under 32 rows": [(3, 5_000), (5_003, 0), (6_000, 31),
                                                         (9_000, 20_000)],
            "one row": [(77, 1)], "under 32 rows": [(100, 17)]}


def _time_case(rows, qrows, scales, order, wins, b, reps, plain_reps):
    """Event and device times of the wrappers in both modes, with
    ``plain_reps`` the plain versions' times."""
    res = {
        "f32": time_ms(lambda: oh.ordered_hist(rows, order, wins, b), reps=reps),
        "int8": time_ms(lambda: oh.ordered_hist_int8(qrows, order, wins, b, scales), reps=reps),
        "f32 device": device_ms(lambda: oh.ordered_hist(rows, order, wins, b)),
        "int8 device": device_ms(lambda: oh.ordered_hist_int8(qrows, order, wins, b, scales)),
    }
    if plain_reps:
        res["f32 plain"] = time_ms(lambda: oh.ordered_hist_plain(rows, order, wins, b),
                                   reps=plain_reps, warmup=1)
        res["int8 plain"] = time_ms(
            lambda: oh.ordered_hist_int8_plain(qrows, order, wins, b, scales),
            reps=plain_reps, warmup=1)
    return res


def _check_case(name, rows, qrows, scales, order, wins, b) -> float:
    """The wrappers against the plain versions (``check``: f32 twice, the
    int8 digit planes of this build's C entry bit-equal), and the int8
    wrapper's recombined sums equal to the plain version's; the f32 max
    |error|."""
    hk = oh.ordered_hist(rows, order, wins, b)
    again = oh.ordered_hist(rows, order, wins, b)
    raw = launch_with(this_build(), qrows, order, wins, b, scales)
    hp = oh.ordered_hist_plain(rows, order, wins, b)
    h8p = oh.ordered_hist_int8_raw_plain(qrows, order, wins, b, scales)
    torch.cuda.synchronize()
    err = check(name, hk, hp, raw, h8p, rows, order, wins, b, again)
    del hk, again, raw, hp, h8p
    if not torch.equal(oh.ordered_hist_int8(qrows, order, wins, b, scales),
                       oh.ordered_hist_int8_plain(qrows, order, wins, b, scales)):
        raise AssertionError(f"ordered_hist_int8 {name}: the recombined sums differ")
    return err


def run_u16(n: int, dev, reps: int = 20, plain_reps: int = 3, features: int = 700,
            verbose: bool = True) -> Dict[str, Dict[str, float]]:
    """The u16 mode on this build through the public wrappers: the 1,024-bin
    cases of ``cases`` (but the skewed one) at n x ``features``, each
    beside the u8 mode on the same windows of the u8 table (device time,
    ``u8 f32 device`` / ``u8 int8 device``), the roots at 8,192 and 16,384
    bins on n x 28, then the edge cases (checked, not timed).  {case:
    results}."""
    results: Dict[str, Dict[str, float]] = {}

    def report(key, rows, wins, res, err):
        res["f32 max err"] = err
        results[key] = res
        if verbose:
            print(f"case u16 {key}: {len(wins)} window(s), {sum(c for _, c in wins)} rows x "
                  f"{rows.f} features (u16, {oh.ordered_ranges(rows, res['bins'])} ranges); "
                  + ", ".join(f"{k} {v:.4f}" + ("" if k == "bins" else " ms")
                              for k, v in res.items())
                  + f"; counts exact, f32 max |err| {err:.3g} and the same bits on two calls, "
                  "int8 bit-equal")

    rows8, qrows8, scales8, _ = synthetic_inputs(n, features, dev, seed=0)
    u8 = {name: _time_case(r, oh.OrderedRows(r.bins, r.f, qrows8.g, qrows8.h, qrows8.m),
                           scales8, o, w, 256, reps, 0)
          for name, (r, o, w) in cases(rows8, skewed=False).items()}
    del rows8, qrows8
    torch.cuda.empty_cache()
    rows, qrows, scales, _ = synthetic_inputs(n, features, dev, seed=1, span=U16_SPAN)
    for cname, (crows, order, wins) in cases(rows).items():
        err = _check_case(f"u16 {cname}", crows, qrows, scales, order, wins, U16_BINS)
        res = {"bins": U16_BINS, **_time_case(crows, qrows, scales, order, wins, U16_BINS, reps,
                                              plain_reps if cname == "root" else 0)}
        res["u8 f32 device"], res["u8 int8 device"] = (u8[cname]["f32 device"],
                                                       u8[cname]["int8 device"])
        res["bound"] = bound_ms(crows, order, wins, U16_BINS)
        res["index_add_ f32"] = library_ms(crows, order, wins, U16_BINS)
        res["index_add_ int8"] = library_ms(qrows, order, wins, U16_BINS, scales)
        report(cname, crows, wins, res, err)
    del rows, qrows
    torch.cuda.empty_cache()
    for b, span in WIDE_SPANS.items():
        rows, qrows, scales, _ = synthetic_inputs(n, WIDE_FEATURES, dev, seed=2, span=span)
        wins = [(0, n)]
        err = _check_case(f"u16 root at {b} bins", rows, qrows, scales, None, wins, b)
        res = {"bins": b, **_time_case(rows, qrows, scales, None, wins, b, reps, plain_reps)}
        res["bound"] = bound_ms(rows, None, wins, b)
        res["index_add_ f32"] = library_ms(rows, None, wins, b)
        res["index_add_ int8"] = library_ms(qrows, None, wins, b, scales)
        report(f"root F={WIDE_FEATURES} B={b}", rows, wins, res, err)
        del rows, qrows
        torch.cuda.empty_cache()
    order = torch.as_tensor(np.random.default_rng(3).permutation(EDGE_ROWS).astype(np.int32),
                            device=dev)
    for used in (U16_BINS, 700):
        rows, qrows, scales = edge_inputs_u16(EDGE_ROWS, EDGE_FEATURES, dev, used=used)
        for cname, wins in {"root": [(0, EDGE_ROWS)], **edge_cases_u16(EDGE_ROWS)}.items():
            for o in ((None,) if cname == "root" else (order,)):
                _check_case(f"u16 edge {cname}, widest {used}", rows, qrows, scales, o, wins,
                            U16_BINS)
        if verbose:
            print(f"edge cases u16 (widest feature {used} of {U16_BINS} bins: "
                  f"{oh.ordered_ranges(rows, U16_BINS)} ranges; feature 1 of 300 bins, bins 255 / "
                  "256, a NaN bin past 255): root, " + ", ".join(edge_cases_u16(EDGE_ROWS))
                  + ": equal to the plain versions in both modes")
        del rows, qrows
    torch.cuda.empty_cache()
    return results


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
    builds = {"this": (this_build(), os.path.join(_build.BUILD, "libordered_hist.so"))}
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
    del rows, qrows
    torch.cuda.empty_cache()
    u16 = run_u16(args.rows, dev, args.reps, features=args.features)
    print(json.dumps({"card": card, "cases": results, "u16": u16}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
