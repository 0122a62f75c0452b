"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (with the ``csrc/`` files it includes) is compiled
on first use, by ``nvcc`` for ``sm_90a``, into its own shared library
``build/lib<name>.so`` with a plain C interface, and loaded with
``ctypes``.  Nothing here runs at import time: the CPU tests import every
module of the package on machines without ``nvcc``.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them, so a cold build costs the slowest file, not the sum.  A library is
rebuilt when its source, a file it includes or the flags change (a hash
stamp sits beside it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD = os.path.join(_HERE, "build")

# -fmad=false: no contraction of a*b+c into one fused multiply-add, so the
# kernels round every f32 operation as the plain PyTorch versions do
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
    "-Xptxas", "-v",
)

# argtypes of each source's one C entry ``lgbt_<name>``, which returns the
# cudaError_t of its launches as an int
_VP = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
SIGNATURES: Dict[str, Sequence] = {
    "seg_hist": (_VP,) * 4 + (_I64, _VP) + (_I32,) * 4 + (_VP, _I32, _VP, _VP, _I64, _VP, _VP),
    "grow_step": (_VP,) * 5 + (_I64, _I32, _VP, _I32, _I32, _VP, _VP, _I64, _VP, _VP, _VP,
                                ctypes.c_uint, _I32, _I32, _VP, _I32, _VP, _VP, _I64, _VP, _VP,
                                _VP, _VP, _I32),
    "partition": (_VP,) * 5 + (_I64, _I32, _I32, _VP, _I32, _I32, _VP, _VP, _I64, _VP, _VP,
                                _VP, ctypes.c_uint, _VP, _VP, _VP, _I32),
    "split_scan": (_VP,) * 5 + (_I32,) * 4 + (_F32,) * 4 + (_VP, _F32, _I32) + (_VP,) * 4,
    "forest_walk": (_VP,) * 3 + (_I64,) + (_I32,) * 9 + (_VP,) * 2 + (_I32,),
    "ordered_hist": (_VP, _I64) + (_VP,) * 5 + (_I32,) * 5 + (_VP, _VP, _I64, _VP, _VP),
}
# further C entries of a source: name -> (source, argtypes, restype)
EXTRA_ENTRIES: Dict[str, Tuple[str, Sequence, object]] = {
    "ordered_hist_scratch": ("ordered_hist", (_VP,) + (_I32,) * 6, _I64),
    "grow_step_scratch": ("grow_step", (_I32,) * 3, _I64),
    "seg_hist_scratch": ("seg_hist", (_I32,) * 3, _I64),
}

_ENTRIES: Dict[str, object] = {}
_LOCK = threading.Lock()

# kernel launches by kernel name ("seg_hist_int8" and "ordered_hist_int8"
# are the int8 modes of seg_hist.cu and ordered_hist.cu, "partition_batch"
# and "split_scan_batch" the K-window and M-leaf calls of partition.cu and
# split_scan.cu, "split_candidates" the split_scan.cu launches, of one leaf
# or of M, that also reduce each leaf to its candidate; "<name>_table" and
# "<name>_u16" count the calls of the partition, fused step, segment
# histogram and ordered histogram in their goes-left-table and u16 modes
# beside their plain names, "<name>_wtable" the table calls of the partition
# and the fused step whose tables pass 256 bins, "<name>_live" the calls of the segment histogram
# and the fused step with a dead feature); a wrapper adds one
# where it launches its kernel, nowhere else, so a run shows which kernels
# it went through
LAUNCHES: Counter = Counter()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc`` (PyTorch's own lookup of
    the toolkit), else ``nvcc`` on ``PATH``."""
    try:
        from torch.utils.cpp_extension import CUDA_HOME
    except Exception:  # pragma: no cover - torch without the extension helpers
        CUDA_HOME = None
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found: the port's kernels are built from "
            "lightgbm_tpu_torch/csrc with the CUDA toolkit"
        )
    return found


def _paths(name: str) -> Tuple[str, str, str]:
    src = os.path.join(CSRC, name + ".cu")
    lib = os.path.join(BUILD, f"lib{name}.so")
    return src, lib, lib + ".stamp"


def _includes(path: str) -> List[str]:
    """The csrc/ files that a source includes (``#include "..."``), and the
    ones they include, each once."""
    found: List[str] = []
    todo = [path]
    while todo:
        with open(todo.pop()) as fh:
            names = re.findall(r'^#include "([^"]+)"', fh.read(), flags=re.M)
        for name in names:
            dep = os.path.join(CSRC, name)
            if dep not in found and os.path.exists(dep):
                found.append(dep)
                todo.append(dep)
    return sorted(found)


def _stamp(src: str) -> str:
    """Hash of the source, the csrc/ files it includes and the flags."""
    h = hashlib.sha256()
    for path in [src] + _includes(src):
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _fresh(name: str) -> bool:
    src, lib, stamp = _paths(name)
    if not (os.path.exists(lib) and os.path.exists(stamp)):
        return False
    with open(stamp) as fh:
        return fh.read().strip() == _stamp(src)


def build_all(names: Sequence[str] = tuple(SIGNATURES)) -> Dict[str, Tuple[float, str]]:
    """Compile every stale kernel library, one ``nvcc`` per source, all
    started together.  Returns {name: (seconds, ptxas register/shared
    memory report)} for the ones built; raises with the compiler's output
    if any build fails."""
    import time

    os.makedirs(BUILD, exist_ok=True)
    nvcc = nvcc_path()
    procs: List[Tuple[str, subprocess.Popen, str, float]] = []
    for name in names:
        if _fresh(name):
            continue
        src, lib, _ = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        p = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, p, tmp, time.perf_counter()))
    took: Dict[str, Tuple[float, str]] = {}
    errors = []
    for name, p, tmp, t0 in procs:
        out, _ = p.communicate()
        src, lib, stamp = _paths(name)
        took[name] = (time.perf_counter() - t0, ptxas_report(out))
        if p.returncode != 0:
            errors.append(f"nvcc failed for {src}:\n{out}")
            continue
        os.replace(tmp, lib)
        with open(stamp, "w") as fh:
            fh.write(_stamp(src))
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def _kernel_name(mangled: str) -> str:
    """A mangled entry function's own name, with its template arguments
    when they are bools or ints (``lane_hist_accumulate<true>``)."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        if mangled.startswith("I", i):
            args = re.findall(r"L([bi])(\d+)E", mangled[i:mangled.find("EE", i) + 2])
            return name + "<" + ", ".join(("true" if v == "1" else "false") if t == "b" else v
                                          for t, v in args) + ">"
    return name


def ptxas_report(out: str) -> str:
    """nvcc's ``-Xptxas -v`` output as one entry a kernel: its registers
    and its spill stores / loads in bytes."""
    rows, name, spill = [], None, ""
    for ln in out.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = _kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            rows.append(f"{name} {m.group(1)} registers, {spill}")
            name = None
    return "; ".join(rows)


def entry(name: str):
    """The C entry ``lgbt_<name>`` of ``csrc/<name>.cu`` (or of the source
    ``EXTRA_ENTRIES`` names), built and loaded on first use."""
    with _LOCK:
        fn = _ENTRIES.get(name)
        if fn is None:
            src, argtypes, restype = EXTRA_ENTRIES.get(
                name, (name, SIGNATURES.get(name), ctypes.c_int))
            build_all([src])
            fn = getattr(ctypes.CDLL(_paths(src)[1]), f"lgbt_{name}")
            fn.argtypes = list(argtypes)
            fn.restype = restype
            _ENTRIES[name] = fn
        return fn


def loaded(name: str) -> bool:
    """Whether the C entry ``lgbt_<name>`` is loaded in this process."""
    return name in _ENTRIES


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
