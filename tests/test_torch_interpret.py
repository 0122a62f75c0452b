"""Switches that the port's tests flip to reach the int8 paths on the CPU.

The JAX package engages its Pallas kernels off the TPU only in interpret
mode, and reads the flags ``lightgbm_tpu.ops.pallas.seg._INTERPRET`` and
``grow_step._INTERPRET`` when it TRACES (ops/grower.py:323, :485).  A jitted
grower traced with the flags on is cached under its static parameters,
which do not name the flags: a later call with the same parameters and the
flags off would run the interpret-mode trace, and a trace cached before
the flags went on would run the plain XLA one.  ``jax_interpret`` clears
JAX's caches on entry and on exit, so every trace inside it sees the flags
on and every trace after it sees them off, whichever test ran before or
after it in the same process (pytest-xdist puts many test files in one
worker).  ``int8_on_cpu`` is the port's own switch
(``lightgbm_tpu_torch.ops.grower.INT8_ON_CPU``), read at call time.

Both restore what they found, in ``finally``.

``clear_jax_caches_after_module`` is a module-scoped autouse fixture that
every port test file imports: JAX's compiled executables keep their memory
mappings until its caches are cleared, and an xdist worker that runs many
files could otherwise reach the kernel's limit on mappings
(``vm.max_map_count``) and crash inside XLA:CPU.

Importing this module also gives PyTorch one intra-op thread in the
process: the suite runs as several pytest workers on the machine's cores,
and a pool of a thread a core in each worker oversubscribes them, so that
the port's plain CPU versions (many small operators) spend most of their
time waiting on each other's threads (3 rounds of a 5-class model on 3,000
rows: 16.7 s at 8 threads beside 6 busy workers, 1.0 s at 1).
"""

import contextlib
import gc

import jax
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.ops.pallas import grow_step as jax_grow_step
from lightgbm_tpu.ops.pallas import seg as jax_seg

from lightgbm_tpu_torch.ops import grower

torch.set_num_threads(1)


def clear_jax_caches() -> None:
    """Drop JAX's compiled executables and collect them, which unmaps their
    memory."""
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def clear_jax_caches_after_module():
    """``clear_jax_caches`` at the end of the module."""
    yield
    clear_jax_caches()


@contextlib.contextmanager
def jax_interpret(seg: bool = True, grow_step: bool = True):
    """Run the JAX package's seg and grow-step kernels in interpret mode
    inside the block, with JAX's caches cleared on entry and on exit."""
    saved = (jax_seg._INTERPRET, jax_grow_step._INTERPRET)
    jax.clear_caches()
    jax_seg._INTERPRET, jax_grow_step._INTERPRET = seg, grow_step
    try:
        yield
    finally:
        jax_seg._INTERPRET, jax_grow_step._INTERPRET = saved
        jax.clear_caches()


@contextlib.contextmanager
def int8_on_cpu():
    """The port's int8 accumulation on the CPU inside the block."""
    saved = grower.INT8_ON_CPU
    grower.INT8_ON_CPU = True
    try:
        yield
    finally:
        grower.INT8_ON_CPU = saved


@jax.jit
def _traced_flag(x):
    # the flag as seen at trace time, as the JAX grower reads it
    return x + (1 if jax_seg._INTERPRET else 0)


def test_traces_inside_see_the_flags_and_traces_after_do_not():
    zero = jnp.zeros((), jnp.int32)
    assert int(_traced_flag(zero)) == 0  # traced and cached with the flags off
    with jax_interpret():
        assert int(_traced_flag(zero)) == 1
    assert int(_traced_flag(zero)) == 0


def test_flags_are_restored_when_the_block_raises(monkeypatch):
    cleared = []
    monkeypatch.setattr(jax, "clear_caches", lambda: cleared.append(1))
    before = (jax_seg._INTERPRET, jax_grow_step._INTERPRET, grower.INT8_ON_CPU)
    with pytest.raises(RuntimeError):
        with jax_interpret(), int8_on_cpu():
            assert jax_seg._INTERPRET and jax_grow_step._INTERPRET
            assert grower.INT8_ON_CPU
            raise RuntimeError("inside")
    assert (jax_seg._INTERPRET, jax_grow_step._INTERPRET, grower.INT8_ON_CPU) == before
    assert len(cleared) == 2  # on entry and on exit


def _mappings() -> int:
    with open("/proc/self/maps") as fh:
        return sum(1 for _ in fh)


def test_clearing_jax_caches_unmaps_compiled_executables():
    before = _mappings()
    for n in range(3, 9):  # six executables
        jax.jit(lambda x: jnp.cumsum(x * 2.0) - x.sum())(jnp.ones(n * 17)).block_until_ready()
    grown = _mappings()
    clear_jax_caches()
    assert grown > before
    assert _mappings() < grown


def test_every_port_test_file_clears_jax_caches_after_it():
    import importlib
    import pathlib

    files = sorted(pathlib.Path(__file__).parent.glob("test_torch_*.py"))
    assert len(files) >= 9
    for path in files:
        mod = importlib.import_module(f"{__package__}.{path.stem}")
        fixture = getattr(mod, "clear_jax_caches_after_module", None)
        assert fixture is clear_jax_caches_after_module, path.name
