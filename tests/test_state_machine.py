"""Resumable state machine, callbacks, caps, cancellation, checkpointing —
the reference's build/propagate/report surface (``src/lbfgs.rs:443-499``)
and driver-loop semantics (``src/lbfgs.rs:399-421``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax import Status, lbfgs
from lbfgs_jax.minimize import LbfgsState
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.params import LbfgsParams


def test_first_propagate_reports_initial_point():
    """k == 1 reports the initial point without searching
    (src/lbfgs.rs:507-510); the first callback sees niter == 1."""
    x0 = rosenbrock.initial_point(10)
    st = LbfgsState.build(LbfgsParams(), x0, rosenbrock.value_and_grad)
    fx0 = float(st.state.prob.fx)
    p = st.propagate()
    assert p.niter == 1
    assert p.fx == fx0
    assert p.neval == 1  # only the build evaluation
    assert p.ncall == 0


def test_max_iterations_cap():
    x0 = rosenbrock.initial_point(10)
    seen = []
    rep = (
        lbfgs()
        .with_max_iterations(5)
        .minimize(x0, rosenbrock.value_and_grad, lambda p: seen.append(p.niter) or False)
    )
    assert rep.niter == 5
    assert seen == [1, 2, 3, 4, 5]
    assert rep.status == Status.MAX_ITERATIONS


def test_max_evaluations_cap():
    x0 = rosenbrock.initial_point(10)
    rep = (
        lbfgs()
        .with_max_evaluations(7)
        .minimize(x0, rosenbrock.value_and_grad)
    )
    assert rep.neval >= 7
    assert rep.status == Status.MAX_EVALUATIONS


def test_cancellation():
    """Progress callback returning True cancels (src/lbfgs.rs:412-416)."""
    x0 = rosenbrock.initial_point(10)
    rep = lbfgs().minimize(x0, rosenbrock.value_and_grad, lambda p: p.niter >= 3)
    assert rep.niter == 3
    assert rep.status == Status.CANCELLED


def test_already_converged_at_start():
    """Converged x0: loop breaks before any propagate (k stays 0)."""
    x0 = jnp.ones(10)  # the Rosenbrock minimum
    rep = lbfgs().minimize(x0, rosenbrock.value_and_grad)
    assert rep.niter == 0
    assert rep.neval == 1
    assert rep.status == Status.CONVERGED


def test_checkpoint_resume_exact():
    """SolverState is a pytree: save at iteration 10, restore into a fresh
    driver, and the continued trajectory matches the uninterrupted one."""
    x0 = rosenbrock.initial_point(30)
    params = LbfgsParams()

    a = LbfgsState.build(params, x0, rosenbrock.value_and_grad)
    for _ in range(10):
        a.propagate()
    # checkpoint via flatten to host numpy
    leaves, treedef = jax.tree.flatten(a.state)
    saved = [np.asarray(l) for l in leaves]

    # uninterrupted run for 5 more
    for _ in range(5):
        a.propagate()

    # resume from checkpoint in a fresh state machine
    b = LbfgsState.build(params, x0, rosenbrock.value_and_grad)
    b.restore(jax.tree.unflatten(treedef, [jnp.asarray(s) for s in saved]))
    for _ in range(5):
        b.propagate()

    np.testing.assert_array_equal(np.asarray(a.state.prob.x), np.asarray(b.state.prob.x))
    assert float(a.state.prob.fx) == float(b.state.prob.fx)


def test_host_closure_objective():
    """Reference-style mutating closure fn(x, gx) -> fx via io_callback."""
    calls = []

    def evaluate(x, gx):
        calls.append(1)
        n = len(x)
        fx = 0.0
        for i in range(0, n, 2):
            t1 = 1.0 - x[i]
            t2 = 10.0 * (x[i + 1] - x[i] * x[i])
            gx[i + 1] = 20.0 * t2
            gx[i] = -2.0 * (x[i] * gx[i + 1] + t1)
            fx += t1 * t1 + t2 * t2
        return fx

    x0 = rosenbrock.initial_point(6)
    rep = lbfgs().minimize(x0, evaluate)
    assert rep.fx == pytest.approx(0.0, abs=1e-4)
    assert len(calls) == rep.neval


def test_fx_delta_stop_enabled():
    """The flag-gated past/delta plateau test (dead code in the reference,
    src/lbfgs.rs:767-787) stops a flat objective early when enabled."""
    x0 = rosenbrock.initial_point(10)
    rep = (
        lbfgs()
        .with_fx_delta(1e-2, 3)
        .with_fx_delta_enabled()
        .with_epsilon(1e-12)  # make gnorm stop unreachable first
        .with_max_iterations(200)
        .minimize(x0, rosenbrock.value_and_grad)
    )
    assert rep.status == Status.CONVERGED
    assert rep.niter < 200


def test_gradient_only_mode_runs():
    """with_gradient_only implies damping + strong-Wolfe backtracking
    (src/lbfgs.rs:283-289) and still relaxes Rosenbrock."""
    x0 = rosenbrock.initial_point(10)
    rep = (
        lbfgs()
        .with_gradient_only()
        .with_max_iterations(100)
        .minimize(x0, rosenbrock.value_and_grad)
    )
    assert rep.fx < 1.0  # made strong progress from fx0 = 121


def test_damping_converges():
    x0 = rosenbrock.initial_point(10)
    rep = lbfgs().with_damping(True).minimize(x0, rosenbrock.value_and_grad)
    assert rep.fx == pytest.approx(0.0, abs=1e-4)


def test_damping_fixed_variant_converges():
    x0 = rosenbrock.initial_point(10)
    rep = (
        lbfgs()
        .with_damping(True)
        .with_damping_fixed()
        .minimize(x0, rosenbrock.value_and_grad)
    )
    assert rep.fx == pytest.approx(0.0, abs=1e-4)
