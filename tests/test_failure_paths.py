"""Failure-path semantics: line-search internal errors revert to the
previous point and surface as the reference's "x not changed" fatal error
in the same propagate (``src/line.rs:213-220`` + ``src/lbfgs.rs:646``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax import LbfgsError, lbfgs
from lbfgs_jax.native import minimize_native
from lbfgs_jax.params import LbfgsParams


def linear_vag(x):
    """f(x) = sum(x): unbounded below; More-Thuente extrapolates to
    max_step and must fail with the max-step error, triggering the
    revert-then-fatal recovery chain."""
    return jnp.sum(x), jnp.ones_like(x)


linear_vag.__lbfgs_value_and_grad__ = True


def test_jax_linear_objective_fails_like_reference():
    with pytest.raises(LbfgsError, match="x not changed"):
        lbfgs().minimize(jnp.zeros(8), linear_vag)


def test_native_linear_objective_fails_like_reference():
    def linear(x, g):
        g[...] = 1.0
        return float(np.sum(x))

    with pytest.raises(LbfgsError, match="x not changed"):
        minimize_native(LbfgsParams(), np.zeros(8), linear)


def test_jit_driver_reports_fatal_status():
    with pytest.raises(LbfgsError, match="x not changed"):
        lbfgs().minimize_jit(jnp.zeros(8), linear_vag)


def test_g_not_changed_error():
    """Quadratic-with-constant-gradient pathology: y = g - gp = 0 after a
    successful step -> reference 'gx not changed' (src/lbfgs.rs:655)."""

    def const_grad(x):
        # gradient constant (and nonzero): fx decreases along -g forever,
        # but curvature information is degenerate
        return jnp.dot(x, jnp.ones_like(x)), jnp.full_like(x, 0.5)

    const_grad.__lbfgs_value_and_grad__ = True
    with pytest.raises(LbfgsError):
        lbfgs().with_max_iterations(50).minimize(jnp.ones(4), const_grad)


def test_objective_with_optional_kwarg_not_misrouted():
    """Regression: a 1-arg objective with optional kwargs must not be
    mistaken for the mutating closure f(x, gx) (which silently produced a
    zero gradient and a bogus CONVERGED)."""

    def quad(x, verbose=False):
        return jnp.sum((x - 3.0) ** 2)

    rep = lbfgs().minimize(jnp.zeros(4), quad)
    assert rep.fx < 1e-8
    assert abs(float(rep.x[0]) - 3.0) < 1e-4


def test_odd_n_rosenbrock_rejected():
    from lbfgs_jax.models import rosenbrock

    with pytest.raises(ValueError, match="even n"):
        rosenbrock.value_and_grad(jnp.zeros(5))


def test_native_cancel_status_matches_jax():
    from lbfgs_jax import Status

    def rosen(x, g):
        n = len(x)
        fx = 0.0
        for i in range(0, n, 2):
            t1 = 1.0 - x[i]
            t2 = 10.0 * (x[i + 1] - x[i] * x[i])
            g[i + 1] = 20.0 * t2
            g[i] = -2.0 * (x[i] * g[i + 1] + t1)
            fx += t1 * t1 + t2 * t2
        return fx

    x0 = np.zeros(10)
    x0[0::2] = -1.2
    x0[1::2] = 1.0
    rep = minimize_native(
        LbfgsParams(), x0, rosen, progress=lambda p: p.niter >= 2
    )
    assert rep.status == Status.CANCELLED


def test_native_gradient_only_mt_config_error():
    import dataclasses

    p = LbfgsParams()
    p = p.replace_ls(gradient_only=True)  # algorithm stays MoreThuente
    with pytest.raises(ValueError, match="incompatible"):
        minimize_native(p, np.zeros(4), lambda x, g: 0.0)
