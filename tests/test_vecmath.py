"""Unit tests for the vecmath backend.

Mirrors the reference math unit test values (``src/math.rs:84-122``).
"""

import jax.numpy as jnp
import numpy as np

from lbfgs_jax.ops import vecmath as vm


def test_axpy():
    y = jnp.array([1.0, 2.0, 3.0])
    x = jnp.array([1.0, 1.0, 1.0])
    out = vm.axpy(y, x, 2.0)
    np.testing.assert_array_equal(np.asarray(out), [3.0, 4.0, 5.0])


def test_dot():
    y = jnp.array([3.0, 4.0, 5.0])
    x = jnp.array([1.0, 1.0, 1.0])
    assert float(vm.dot(y, x)) == 12.0


def test_scale():
    y = jnp.array([3.0, 4.0, 5.0])
    np.testing.assert_array_equal(np.asarray(vm.scale(y, 2.0)), [6.0, 8.0, 10.0])


def test_diff():
    x = jnp.array([1.0, 1.0, 1.0])
    y = jnp.array([6.0, 8.0, 10.0])
    np.testing.assert_array_equal(np.asarray(vm.diff(x, y)), [-5.0, -7.0, -9.0])


def test_ncopy():
    x = jnp.array([1.0, 1.0, 1.0])
    np.testing.assert_array_equal(np.asarray(vm.ncopy(x)), [-1.0, -1.0, -1.0])


def test_norms():
    x = jnp.array([3.0, 4.0])
    assert float(vm.norm2(x)) == 5.0
    assert float(vm.norm2inv(x)) == 0.2
