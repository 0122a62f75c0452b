"""Quantized training on the ordered layout past 255 bins: the int8 kernel's
u16 mode in lightgbm_tpu_torch against the JAX package's int8 kernel in
interpret mode (``hist_method='pallas_int8_interpret'``).

The cases of ``tests/test_torch_ordered_widebin.py`` at ``max_bin`` 1023 on
130 columns, binary and regression, at K=1 and K=4, on deterministic
quantized gradients (``use_quantized_grad``, ``stochastic_rounding=False``,
4 bins): the trees identical, leaves within 1e-5, predictions, the model
text and ``booster_from_arrays`` of the JAX package's records equal.  A
file of their own: the JAX kernel in interpret mode compiles for tens of
seconds a case.
"""

import pytest

from .test_torch_interpret import clear_jax_caches_after_module  # noqa: F401 (autouse)
from .test_torch_ordered_widebin import check_model_text_and_arrays, check_training, train_pair

CASES = [(obj, "int8", k) for obj in ("binary", "regression") for k in (1, 4)]


@pytest.fixture(scope="module", params=CASES, ids=[f"{o}-{m}-K{k}" for o, m, k in CASES])
def trained_pair(request):
    return train_pair(*request.param)


def test_ordered_training_past_255_bins_equals_jax(trained_pair):
    check_training(trained_pair)


def test_model_text_and_arrays_carry_across(trained_pair):
    check_model_text_and_arrays(trained_pair)
