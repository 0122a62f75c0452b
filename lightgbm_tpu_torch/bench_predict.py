"""Warm predicts of the walk path and of a model read from text on the
card, for this package and other copies of it, timed in turns in one
process.

Run from the root of a checkout, on a machine with the card::

    python3 -m lightgbm_tpu_torch.bench_predict [--other NAME=ROOT ...]
        [--reps N] [--out FILE]

``--other NAME=ROOT`` loads the package under ``ROOT/lightgbm_tpu_torch``
(for example the parent commit's, unpacked by ``git archive``) beside this
one, under its own module name, with its own kernel builds.  Each package
trains its own models from the same seeds; their model texts must be equal,
and so must their predictions, bit for bit (a model read from text: within
a relative 1e-12, as a package may sum its f64 leaf values on the host).

Cases:

* ``higgs``: 1,048,576 rows x 28 f32 (``chip_smoke.py``'s Higgs-shaped
  task, seed 42), 10 trees of 255 leaves trained on them: one chunk of the
  walk path;
* ``higgs x4``: 4,194,304 rows of the same task (seed 43) through that
  model: four chunks, at ``pred_num_buffers`` 1 and 2 where the package
  takes the keyword (the lookahead against none);
* ``wide``: 1,048,576 rows x 700 f32 (``chip_smoke.py``'s Expo-shaped
  table), 5 trees of 255 leaves trained on its first 131,072 rows (past
  512 features: the plain walker);
* ``text``: the ``higgs`` model's text read back, its 1,048,576 rows
  predicted in real space.

Each case is one warm predict (host wall time, ``torch.cuda.synchronize``
before it; the call returns host arrays, so it ends synchronised), taken
``--reps`` times in turns over the packages, then in the reverse order;
the median is printed with ``last_predict_stats`` of the last call where
the package has it.  The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from ._bench import card_line

PARAMS = {"objective": "binary", "num_leaves": 255, "max_bin": 255, "learning_rate": 0.1,
          "verbosity": -1}
HIGGS_ROWS = 1 << 20
WIDE_ROWS = 1 << 20
WIDE_TRAIN_ROWS = 1 << 17


def higgs_data(n_rows: int, seed: int, n_features: int = 28):
    """chip_smoke.py's ``make_data``: bench.py's Higgs-shaped formula."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    w = rng.normal(size=n_features)
    logits = x @ w * 0.5 + rng.normal(scale=1.0, size=n_rows)
    return x, (logits > 0).astype(np.float64)


def wide_data(n_rows: int, n_features: int = 700, seed: int = 42, grid: int = 32):
    """chip_smoke.py's ``make_wide_data``: normal values on a grid of
    1/grid, 2% NaN, the label a function of the first 32 columns."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, n_features), dtype=np.float32)
    x *= float(grid)
    np.round(x, out=x)
    x /= float(grid)
    for lo in range(0, n_rows, 1 << 16):
        blk = x[lo:lo + (1 << 16)]
        blk[rng.random(blk.shape, dtype=np.float32) < 0.02] = np.nan
    k = np.nan_to_num(x[:, :32]).astype(np.float64)
    w = rng.normal(size=32)
    z = k @ w * 0.5 + 0.25 * (k[:, :8] ** 2 - 1.0).sum(axis=1) + rng.normal(size=n_rows)
    return x, (z > 0).astype(np.float64)


def load_package(name: str, root: str):
    """The package under ``root/lightgbm_tpu_torch`` as module ``name`` (its
    relative imports resolve inside it; its kernels build in its own
    ``build/``)."""
    if name == "this":
        import lightgbm_tpu_torch as mod
        return mod
    path = os.path.join(os.path.abspath(root), "lightgbm_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=ROOT")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the results as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_predict: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    names = ["this"] + [o.split("=", 1)[0] for o in args.other]
    roots = {"this": "."} | dict(o.split("=", 1) for o in args.other)
    dev = torch.device("cuda")

    t = time.perf_counter()
    x, y = higgs_data(HIGGS_ROWS, 42)
    x4, _ = higgs_data(4 * HIGGS_ROWS, 43)
    xw, yw = wide_data(WIDE_ROWS)
    print(f"data made in {time.perf_counter() - t:.1f} s")

    models = {}
    for name in names:
        t = time.perf_counter()
        lt = load_package(name, roots[name])
        build = importlib.import_module(lt.__name__ + "._build")
        build.build_all()
        higgs = lt.train(PARAMS, lt.Dataset(x, y, params=PARAMS), 10, device=dev)
        wide = lt.train(PARAMS, lt.Dataset(xw[:WIDE_TRAIN_ROWS], yw[:WIDE_TRAIN_ROWS],
                                           params=PARAMS), 5, device=dev)
        text = lt.Booster(model_str=higgs.model_to_string(), device=dev)
        models[name] = {"higgs": higgs, "wide": wide, "text": text}
        print(f"{name}: built and trained in {time.perf_counter() - t:.1f} s")
    for name in names[1:]:
        for m in ("higgs", "wide"):
            if models[name][m].model_to_string() != models["this"][m].model_to_string():
                raise AssertionError(f"{name}: its {m} model differs from this package's")

    def takes_buffers(booster) -> bool:
        try:
            booster.predict(x[:8], pred_num_buffers=1)
            return True
        except TypeError:
            return False

    cases = [("higgs", "higgs", x, {}), ("higgs x4", "higgs", x4, {}),
             ("wide", "wide", xw, {}), ("text", "text", x, {})]
    cases += [("higgs x4, 1 buffer", "higgs", x4, {"pred_num_buffers": 1}),
              ("higgs x4, 2 buffers", "higgs", x4, {"pred_num_buffers": 2})]
    runs = [(case, name) for case in cases for name in names
            if not case[3] or takes_buffers(models[name][case[1]])]
    times = {(case[0], name): [] for case, name in runs}
    outs, stats, differ = {}, {}, []
    for case, name in runs:  # warm
        label, model, rows, kw = case
        outs[(label, name)] = models[name][model].predict(rows, **kw)
    for label, model, rows, kw in cases:
        got = [outs[(label, name)] for name in names if (label, name) in outs]
        for other in got[1:]:
            # a model read from text sums f64 leaf values, on the card or
            # on the host by package: equal to f64 rounding
            same = (np.allclose(other, got[0], rtol=1e-12, atol=0) if model == "text"
                    else np.array_equal(other, got[0]))
            if not same:
                differ.append(label)
                print(f"{label}: the packages' predictions DIFFER")
    order = runs * args.reps + runs[::-1] * args.reps
    for (label, model, rows, kw), name in order:
        booster = models[name][model]
        torch.cuda.synchronize()
        t = time.perf_counter()
        booster.predict(rows, **kw)
        times[(label, name)].append((time.perf_counter() - t) * 1e3)
        stats[(label, name)] = dict(getattr(booster, "last_predict_stats", {}))
    results = []
    for (label, name), ms in times.items():
        med = statistics.median(ms)
        rows = len(outs[(label, name)])
        results.append({"case": label, "package": name, "rows": rows, "ms": ms,
                        "median_ms": med, "rows_per_s": rows / med * 1e3,
                        "last_predict_stats": stats[(label, name)]})
        print(f"{label:22s} {name:8s} median {med:9.1f} ms ({rows / med * 1e3:12.0f} rows/s) "
              f"of {' '.join(f'{v:.1f}' for v in ms)}; stats {json.dumps(stats[(label, name)])}")
    if not differ:
        print("every package's predictions bit-equal in every case (text: within 1e-12)")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card_line(), "results": results, "differ": differ}, f, indent=1)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
