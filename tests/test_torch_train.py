"""The whole slice: lightgbm_tpu_torch training on the CPU against the JAX
package's seg-path training, plus the port's import and device rules.

The JAX package trains with ``hist_mode='seg', hist_acc='bf16',
grow_fused='off', fused_split_scan=True``; the port with ``train(...,
device='cpu')`` on the same data.  Every tree must have the same split
features, bins, default directions and children; leaf values and
predictions must agree within 1e-5 (the two packages' f32 ``exp`` may
differ in the last ulp, which moves binary gradients by an ulp).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb

import lightgbm_tpu_torch as lt

SLICE = {"hist_mode": "seg", "hist_acc": "bf16", "grow_fused": "off",
         "fused_split_scan": True}


def _data(objective, n=3000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
    z = (np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, 1])
         - 0.3 * np.nan_to_num(x[:, 2]) ** 2 + rng.normal(size=n))
    return x, (z > 0).astype(float) if objective == "binary" else z


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_training_matches_jax_seg_path(objective):
    x, y = _data(objective)
    params = {"objective": objective, "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.1}
    jp = {**params, **SLICE, "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 5)
    assert jb._grower_params.hist_mode == "seg"
    assert not jb._grower_params.grow_fused and jb._grower_params.fused_split_scan
    tb = lt.train({**params, **SLICE}, lt.Dataset(x, y, params=params), 5, device="cpu")

    assert len(tb.trees) == len(jb._bin_records) == 5
    for jr, tree in zip(jb._bin_records, tb.trees):
        tr = tree.record()
        for k in ("split_feature", "split_bin", "default_left", "left_child", "right_child"):
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=k)
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
    for jt, tt in zip(jb.models_, tb.trees):
        np.testing.assert_array_equal(tt.threshold, jt.threshold)
        np.testing.assert_array_equal(tt.split_feature_real, jt.split_feature)
    for raw in (True, False):
        np.testing.assert_allclose(tb.predict(x, raw_score=raw), jb.predict(x, raw_score=raw),
                                   rtol=0, atol=1e-5)


def test_training_loss_falls_and_score_matches_predict():
    x, y = _data("binary", n=2000, seed=5)
    params = {"objective": "binary", "num_leaves": 7, "max_bin": 31}
    b = lt.Booster(params, lt.Dataset(x, y, params=params), device="cpu")
    losses = []
    for _ in range(4):
        assert not b.update()
        losses.append(b.train_loss())
    assert all(b2 < b1 for b1, b2 in zip(losses, losses[1:]))
    np.testing.assert_allclose(b.predict(x, raw_score=True), b.score.numpy(), rtol=0, atol=1e-5)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = (
        "import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.convert, chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(__import__("pathlib").Path(__file__).parents[1]))
    assert out.stdout.strip() == ""


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _data("regression", n=200)
    params = {"objective": "regression", "num_leaves": 4}
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.train(params, lt.Dataset(x, y, params=params), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Booster(params, lt.Dataset(x, y, params=params))
    with pytest.raises(RuntimeError, match="CUDA"):
        lt.Booster(params, lt.Dataset(x, y, params=params), device="cuda")
