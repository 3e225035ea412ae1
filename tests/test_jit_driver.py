"""Fully-jitted while_loop driver: must match the host-loop driver's
result on the same problem (same statuses, same goldens)."""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax import Status, lbfgs
from lbfgs_jax.models import booth, rosenbrock


def test_jit_matches_host_loop():
    x0 = rosenbrock.initial_point(40)
    rep_host = lbfgs().minimize(x0, rosenbrock.value_and_grad)
    rep_jit = lbfgs().minimize_jit(x0, rosenbrock.value_and_grad)
    # identical trajectories: same executable math, same stop conditions
    assert rep_jit.niter == rep_host.niter
    assert rep_jit.neval == rep_host.neval
    assert rep_jit.fx == pytest.approx(rep_host.fx, rel=1e-12, abs=1e-15)
    np.testing.assert_allclose(
        np.asarray(rep_jit.x), np.asarray(rep_host.x), rtol=1e-12
    )
    assert rep_jit.status == Status.CONVERGED


def test_jit_owlqn():
    x0 = rosenbrock.initial_point(100)
    pre = lbfgs().minimize_jit(x0, rosenbrock.value_and_grad)
    rep = lbfgs().with_orthantwise(1.0, 0, 99).minimize_jit(
        pre.x, rosenbrock.value_and_grad
    )
    assert rep.fx == pytest.approx(43.5025, rel=1e-4)


def test_jit_max_iterations():
    x0 = rosenbrock.initial_point(10)
    rep = lbfgs().with_max_iterations(5).minimize_jit(x0, rosenbrock.value_and_grad)
    assert rep.niter == 5
    assert rep.status == Status.MAX_ITERATIONS


def test_jit_booth():
    rep = lbfgs().minimize_jit(jnp.array([-1.2, 1.0]), booth.value_and_grad)
    assert float(rep.x[0]) == pytest.approx(1.0, abs=1e-6)
    assert float(rep.x[1]) == pytest.approx(3.0, abs=1e-6)


def test_jit_return_state_no_sync():
    from lbfgs_jax.core import SolverState
    from lbfgs_jax.params import LbfgsParams

    x0 = rosenbrock.initial_point(10)
    from lbfgs_jax.minimize import minimize_jit

    st = minimize_jit(LbfgsParams(), x0, rosenbrock.value_and_grad, return_state=True)
    assert isinstance(st, SolverState)
    assert int(st.status) == Status.CONVERGED
