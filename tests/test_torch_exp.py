"""The binary objective's f32 ``exp`` (ROADMAP Queue 3, F5) against XLA's.

``lightgbm_tpu_torch.objectives.xla_exp`` must equal ``jax.jit(jnp.exp)`` on
the CPU bit for bit: over a dense sweep of f32 in [-89, 89], every f32 around
the ends where the input clamp, the exponent clamp, the flush of results
below the least normal f32 and the overflow act, and at +-0, +-inf, NaN and
subnormal inputs.  Then the binary gradients and hessians against the JAX
objective's on 200,000 rows, and binary trees against the JAX package's at
``max_bin`` 255 and 1023 on the data where ``torch.exp`` made them part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.objectives import create_objective as jax_create_objective

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.objectives import create_objective, xla_exp

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_widebin import _train_data

TREE_KEYS = ("split_feature", "split_bin", "default_left", "left_child", "right_child")


def _around(x, each=100_000):
    """Every f32 within ``each`` steps of ``x``."""
    base = np.array([x], np.float32).view(np.int32)[0]
    return (base + np.arange(-each, each, dtype=np.int32)).view(np.float32)


SWEEPS = {
    "dense [-89, 89]": lambda: np.linspace(-89.0, 89.0, 4_000_001, dtype=np.float32),
    # the input clamp's low end, the least normal result (ln 2^-126), the
    # exponent clamp at -127
    "underflow end": lambda: np.concatenate(
        [_around(v) for v in (-87.8, -87.33654, -87.68)]),
    # the exponent clamp at 127 (127.5 ln 2), the largest finite result
    # (ln of the largest f32), the input clamp's high end
    "overflow end": lambda: np.concatenate(
        [_around(v) for v in (88.37626, 88.72284, 88.8)]),
    "near zero": lambda: np.concatenate([_around(0.0), _around(-0.5), _around(1.0)]),
    "special values": lambda: np.array(
        [0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-45, -1e-45, 1e-39, -1e-39,
         1e-20, -1e-20, -87.8, 88.8, -89.0, 89.0, -100.0, 100.0, -1e30, 1e30,
         np.finfo(np.float32).max, -np.finfo(np.float32).max], np.float32),
}


@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_xla_exp_equals_jax_exp_bit_for_bit(sweep):
    x = SWEEPS[sweep]()
    got = xla_exp(torch.as_tensor(x)).numpy()
    want = np.asarray(jax.jit(jnp.exp)(x))
    same = (got.view(np.int32) == want.view(np.int32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:5], got[~same][:5], want[~same][:5])
    # torch.exp is not XLA's: on the dense sweep it differs in the last ulp
    if sweep == "dense [-89, 89]":
        torch_exp = torch.exp(torch.as_tensor(x)).numpy()
        assert (torch_exp.view(np.int32) != want.view(np.int32)).mean() > 0.01


def test_binary_gradients_equal_jax_bit_for_bit():
    rng = np.random.default_rng(16)
    n = 200_000
    label = (rng.random(n) < 0.4).astype(float)
    score = (rng.normal(size=n) * 3.0).astype(np.float32)
    jobj = jax_create_objective(JaxConfig.from_params({"objective": "binary"}))
    jobj.init(label, None)
    jg, jh = (np.asarray(a)[0] for a in jobj.get_gradients(jnp.asarray(score)[None]))
    tobj = create_objective("binary", label, torch.device("cpu"))
    tg, th = (a.numpy() for a in tobj.get_gradients(torch.as_tensor(score)))
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(th, jh)


F5_PARAMS = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1, "leaf_batch": 1,
             "hist_mode": "seg", "hist_acc": "bf16", "grow_fused": "off",
             "fused_split_scan": True}


@pytest.mark.parametrize("max_bin,seed", [(255, 0), (1023, 0), (1023, 2), (1023, 4)])
def test_binary_trees_equal_jax_at_near_ties(max_bin, seed):
    """The smallest data on which ``torch.exp`` parted the packages' binary
    trees (tree 2 at max_bin 255; trees 7, 6 and 1 at 1023): 8 rounds give
    the same trees, leaves within 1e-5."""
    x, z = _train_data(n=600, seed=seed)
    y = (z > 0).astype(float)
    params = {**F5_PARAMS, "max_bin": max_bin}
    jp = {**params, "verbosity": -1, "metric": "none"}
    jb = lgb.train(jp, lgb.Dataset(x, y, params=jp), 8)
    tb = lt.train(params, lt.Dataset(x, y, params=params), 8, device="cpu")
    assert len(tb.trees) == len(jb._bin_records) == 8
    for i, (jr, tree) in enumerate(zip(jb._bin_records, tb.trees)):
        tr = tree.record()
        for k in TREE_KEYS:
            np.testing.assert_array_equal(tr[k], jr[k], err_msg=f"tree {i} {k}")
        np.testing.assert_allclose(tr["leaf_value"], jr["leaf_value"], rtol=0, atol=1e-5)
