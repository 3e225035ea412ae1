"""Speculative K-way backtracking (an extension, no reference
counterpart): the Armijo-only ladder's candidate steps stp·0.5^j are known
upfront, so K candidates are evaluated per vmapped pass.  The contract is
exact ladder equivalence with the sequential search — accepted step, ncall,
neval, status, and whole-minimization trajectories must match the
sequential `backtracking` trial-for-trial."""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax import lbfgs
from lbfgs_jax.core import ProblemDef
from lbfgs_jax.linesearch import backtracking, backtracking_speculative, find
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.params import LineSearchAlgorithm, LineSearchParams
from lbfgs_jax.status import Status


def _quad_pdef():
    def vag(x):
        return 0.5 * jnp.sum(x**2), x

    vag.__lbfgs_value_and_grad__ = True
    return ProblemDef(value_and_grad=vag)


def _run_both(pdef, ls, xp, d, stp0, K):
    fx, g = pdef.value_and_grad(xp)
    dginit = jnp.dot(g, d)
    seq = backtracking(
        pdef, ls, xp, fx, g, d, jnp.float64(stp0), dginit, jnp.int32(1), xp
    )
    spec = backtracking_speculative(
        pdef,
        LineSearchParams(
            algorithm=ls.algorithm,
            max_linesearch=ls.max_linesearch,
            min_step=ls.min_step,
            max_step=ls.max_step,
            speculative=K,
        ),
        xp, fx, g, d, jnp.float64(stp0), dginit, jnp.int32(1), xp,
    )
    return seq, spec


def _assert_equal_results(seq, spec):
    assert int(spec.status) == int(seq.status)
    assert int(spec.ncall) == int(seq.ncall)
    assert int(spec.neval) == int(seq.neval)
    assert float(spec.step) == float(seq.step)
    assert float(spec.step_eval) == float(seq.step_eval)
    np.testing.assert_array_equal(np.asarray(spec.x), np.asarray(seq.x))
    assert float(spec.fx) == float(seq.fx)
    np.testing.assert_array_equal(np.asarray(spec.gx), np.asarray(seq.gx))


@pytest.mark.parametrize("K", [2, 3, 4, 8])
@pytest.mark.parametrize("stp0", [1.0, 8.0, 64.0])
def test_matches_sequential_on_quadratic(K, stp0):
    """Deep-ladder accepts crossing round boundaries: stp0 = 64 needs ~7
    halvings on f = ||x||^2/2 from x = 1, d = -x before Armijo passes."""
    pdef = _quad_pdef()
    xp = jnp.ones(5)
    d = -xp
    ls = LineSearchParams(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
    seq, spec = _run_both(pdef, ls, xp, d, stp0, K)
    assert int(seq.status) == 0 and int(seq.ncall) >= 1
    _assert_equal_results(seq, spec)


@pytest.mark.parametrize("K", [2, 5])
def test_matches_sequential_on_exhaustion(K):
    """Ascent direction: Armijo never passes; the sequential loop exhausts
    with ncall = max_linesearch and stp left at the never-evaluated next
    proposal (src/line.rs:777, :781-783)."""
    pdef = _quad_pdef()
    xp = jnp.ones(3)
    d = +xp  # ascent
    ls = LineSearchParams(
        algorithm=LineSearchAlgorithm.BacktrackingArmijo, max_linesearch=6
    )
    seq, spec = _run_both(pdef, ls, xp, d, 1.0, K)
    assert int(seq.ncall) == 6
    _assert_equal_results(seq, spec)


def test_matches_sequential_on_min_step_error():
    pdef = _quad_pdef()
    xp = jnp.ones(3)
    d = +xp  # ascent: every trial fails, first failure checks the bound
    ls = LineSearchParams(
        algorithm=LineSearchAlgorithm.BacktrackingArmijo, min_step=1.0
    )
    seq, spec = _run_both(pdef, ls, xp, d, 0.5, 3)
    assert int(seq.status) == Status.LS_MIN_STEP
    _assert_equal_results(seq, spec)


def test_matches_sequential_on_max_step_error():
    pdef = _quad_pdef()
    xp = jnp.ones(3)
    d = +xp
    ls = LineSearchParams(
        algorithm=LineSearchAlgorithm.BacktrackingArmijo, max_step=4.0
    )
    seq, spec = _run_both(pdef, ls, xp, d, 8.0, 4)
    assert int(seq.status) == Status.LS_MAX_STEP
    _assert_equal_results(seq, spec)


def test_zero_trial_parity():
    """max_linesearch = 1: the sequential loop never runs and returns the
    entry point with result = max_linesearch."""
    pdef = _quad_pdef()
    xp = jnp.ones(3)
    d = -xp
    ls = LineSearchParams(
        algorithm=LineSearchAlgorithm.BacktrackingArmijo, max_linesearch=1
    )
    seq, spec = _run_both(pdef, ls, xp, d, 1.0, 4)
    _assert_equal_results(seq, spec)


def test_minimize_armijo_trajectory_identical():
    """Whole-minimization equivalence on the eval-hungry Armijo ladder
    (~10 evals/iteration on Rosenbrock, PERF.md sweep)."""
    x0 = rosenbrock.initial_point(20)
    base = lbfgs().with_linesearch_algorithm("BacktrackingArmijo").with_max_iterations(60)
    r_seq = base.minimize(x0, rosenbrock.value_and_grad)
    r_spec = base.with_speculative_linesearch(4).minimize(
        x0, rosenbrock.value_and_grad
    )
    assert r_spec.niter == r_seq.niter
    assert r_spec.neval == r_seq.neval
    # the TRAJECTORY (every x, every g, every accept decision) is
    # bit-identical — asserted below — but the reported fx of the two
    # separately-jitted programs can differ in the last ulp: XLA fuses the
    # objective's sum reduction into different surrounding graphs, and CPU
    # vectorized reductions reassociate per fusion context.
    assert float(r_spec.fx) == pytest.approx(float(r_seq.fx), rel=1e-14)
    np.testing.assert_array_equal(np.asarray(r_spec.x), np.asarray(r_seq.x))


def test_minimize_owlqn_trajectory_identical():
    """OWL-QN always routes to the Armijo-only ladder; the speculative
    search must reproduce the sequential OWL-QN trajectory exactly."""
    x0 = rosenbrock.initial_point(40)
    base = lbfgs().with_orthantwise(1.0, 0, 39).with_max_iterations(80)
    r_seq = base.minimize(x0, rosenbrock.value_and_grad)
    r_spec = base.with_speculative_linesearch(3).minimize(
        x0, rosenbrock.value_and_grad
    )
    assert r_spec.niter == r_seq.niter
    assert r_spec.neval == r_seq.neval
    assert float(r_spec.fx) == float(r_seq.fx)
    np.testing.assert_array_equal(np.asarray(r_spec.x), np.asarray(r_seq.x))


def test_owlqn_golden_with_speculation():
    """Reference golden (tests/simple.rs:42-54) still holds under
    speculation: fx = 43.5025, x0 = 0.25, x1 = 0.0575."""
    x0 = rosenbrock.initial_point(100)
    rep1 = lbfgs().minimize(x0, rosenbrock.value_and_grad)
    rep = (
        lbfgs()
        .with_orthantwise(1.0, 0, 99)
        .with_speculative_linesearch(4)
        .minimize(rep1.x, rosenbrock.value_and_grad)
    )
    assert rep.fx == pytest.approx(43.5025, abs=1e-4 * 43.5025)
    assert float(rep.x[0]) == pytest.approx(0.25, abs=1e-4)
    assert float(rep.x[1]) == pytest.approx(0.0575, abs=1e-4)


@pytest.mark.parametrize(
    "builder",
    [
        lambda b: b,  # default MoreThuente
        lambda b: b.with_linesearch_algorithm("BacktrackingWolfe"),
        lambda b: b.with_linesearch_algorithm("BacktrackingStrongWolfe"),
        lambda b: b.with_gradient_only(),
    ],
)
def test_speculative_rejects_non_armijo_ladders(builder):
    x0 = rosenbrock.initial_point(10)
    b = builder(lbfgs()).with_speculative_linesearch(4)
    with pytest.raises(ValueError):
        b.minimize(x0, rosenbrock.value_and_grad)


def test_speculative_batched_matches_sequential_batched():
    """Scenario-batch composition: the speculative ladder under the
    batched driver's vmap must reproduce the sequential batched run."""
    rng = np.random.default_rng(0)
    x0b = jnp.asarray(rng.uniform(-2.0, 2.0, size=(8, 16)))
    base = (
        lbfgs()
        .with_linesearch_algorithm("BacktrackingArmijo")
        .with_max_iterations(30)
    )
    out_seq = base.minimize_batched(x0b, rosenbrock.value_and_grad)
    out_spec = base.with_speculative_linesearch(4).minimize_batched(
        x0b, rosenbrock.value_and_grad
    )
    # inside the batched driver the speculative pass is doubly vmapped
    # (K candidates x B instances), which reassociates the objective's
    # reductions — candidate fx values can differ from the sequential
    # search's by an ULP, so equivalence here is tolerance-level (the same
    # contract as XLA-vs-sequential-Rust parity, SURVEY.md §7), not bitwise
    np.testing.assert_allclose(
        np.asarray(out_spec["fx"]), np.asarray(out_seq["fx"]), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(out_spec["x"]), np.asarray(out_seq["x"]), atol=1e-8
    )


def test_speculative_jit_driver_matches_host_driver():
    x0 = rosenbrock.initial_point(20)
    b = (
        lbfgs()
        .with_linesearch_algorithm("BacktrackingArmijo")
        .with_speculative_linesearch(4)
        .with_max_iterations(40)
    )
    r_host = b.minimize(x0, rosenbrock.value_and_grad)
    r_jit = b.minimize_jit(x0, rosenbrock.value_and_grad)
    assert r_jit.niter == r_host.niter
    assert float(r_jit.fx) == float(r_host.fx)
