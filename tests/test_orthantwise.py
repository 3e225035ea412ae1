"""Unit tests for OWL-QN operators against hand-computed values
(semantics of ``src/orthantwise.rs``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.orthantwise import (
    Orthantwise,
    choose_orthant,
    constrain_direction,
    project,
    project_line_point,
    pseudo_gradient,
    signum,
    x1norm,
)


def test_signum_convention():
    x = jnp.array([-2.0, -0.0, 0.0, 3.0, jnp.nan])
    out = np.asarray(signum(x))
    np.testing.assert_array_equal(out[:4], [-1.0, 0.0, 0.0, 1.0])
    assert out[4] == 0.0  # NaN -> 0 (src/orthantwise.rs:174-180)


def test_project_zeroes_disagreeing_signs():
    x = jnp.array([1.0, -1.0, 2.0, 0.0, -3.0])
    y = jnp.array([1.0, 1.0, -1.0, 1.0, -1.0])
    out = np.asarray(project(x, y))
    np.testing.assert_array_equal(out, [1.0, 0.0, 0.0, 0.0, -3.0])


def test_x1norm_window():
    ow = Orthantwise(c=2.0, start=1, end=3)
    x = jnp.array([10.0, -1.0, 2.0, 100.0])
    assert float(x1norm(ow, x)) == 2.0 * (1.0 + 2.0)


def test_x1norm_end_clamped():
    # end beyond n is clamped, not an error (src/orthantwise.rs:59-67)
    ow = Orthantwise(c=1.0, start=0, end=99)
    x = jnp.array([1.0, -2.0])
    assert float(x1norm(ow, x)) == 3.0


def test_invalid_window_raises():
    ow = Orthantwise(c=1.0, start=3, end=2)
    with pytest.raises(ValueError):
        x1norm(ow, jnp.zeros(5))


def test_pseudo_gradient_cases():
    ow = Orthantwise(c=1.0, start=0, end=None)
    # x != 0: pg = g + sign(x)*c
    x = jnp.array([2.0, -2.0, 0.0, 0.0, 0.0])
    g = jnp.array([0.5, 0.5, -2.0, 2.0, 0.3])
    pg = np.asarray(pseudo_gradient(ow, x, g))
    assert pg[0] == 1.5         # g + c
    assert pg[1] == -0.5        # g - c
    assert pg[2] == -1.0        # right partial g + c < 0
    assert pg[3] == 1.0         # left partial g - c > 0
    assert pg[4] == 0.0         # subgradient interval contains 0


def test_pseudo_gradient_outside_window():
    ow = Orthantwise(c=1.0, start=1, end=2)
    x = jnp.array([0.0, 2.0, 0.0])
    g = jnp.array([3.0, 0.5, -4.0])
    pg = np.asarray(pseudo_gradient(ow, x, g))
    assert pg[0] == 3.0 and pg[2] == -4.0  # untouched outside window
    assert pg[1] == 1.5


def test_choose_orthant():
    ow = Orthantwise()
    xp = jnp.array([1.5, -2.0, 0.0, 0.0])
    pg = jnp.array([9.0, 9.0, -3.0, 4.0])
    wp = np.asarray(choose_orthant(ow, xp, pg))
    np.testing.assert_array_equal(wp, [1.0, -1.0, 1.0, -1.0])


def test_constrain_direction_window_only():
    ow = Orthantwise(c=1.0, start=1, end=3)
    d = jnp.array([5.0, 1.0, -1.0, 7.0])
    pg = jnp.array([1.0, 1.0, 1.0, 1.0])  # -pg = -1 => positive d zeroed
    out = np.asarray(constrain_direction(ow, d, pg))
    np.testing.assert_array_equal(out, [5.0, 0.0, -1.0, 7.0])


def test_project_line_point_window_only():
    ow = Orthantwise(c=1.0, start=0, end=2)
    x = jnp.array([1.0, -1.0, -5.0])
    wp = jnp.array([1.0, 1.0, 1.0])
    out = np.asarray(project_line_point(ow, x, wp))
    np.testing.assert_array_equal(out, [1.0, 0.0, -5.0])
