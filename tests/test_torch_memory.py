"""Bounded host memory for the port's CPU tests.

The port's test files run the JAX package beside the port, and every new
shape they give a jitted JAX function compiles and caches another
executable. Under pytest-xdist a worker runs many files in one process, so
those caches and the freed heap add up. `release_memory_around_each_test`
is an autouse fixture: a test file that imports it drops JAX's compiled
executables, collects garbage and hands the freed heap back to the OS
before and after each of its tests, so a worker's peak RSS while it runs
that file is its base plus the heaviest test, not the sum of the files it
ran.
"""

import ctypes
import gc

import jax
import jax.numpy as jnp
import pytest


def release_memory() -> None:
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):  # not glibc: nothing to hand back
        pass


@pytest.fixture(autouse=True)
def release_memory_around_each_test():
    release_memory()
    yield
    release_memory()


def test_release_memory_drops_compiled_executables():
    f = jax.jit(lambda x: x + 1)
    assert int(f(jnp.int32(1))) == 2
    assert f._cache_size() == 1
    release_memory()
    assert f._cache_size() == 0
    assert int(f(jnp.int32(2))) == 3  # recompiles on the next call
