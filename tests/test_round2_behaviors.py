"""Round-2 reference-parity behaviors: line-search entry validation
(``src/line.rs:197-201``), the ascent-direction warning
(``src/core.rs:78-92``), reference-parity log lines, and the past/delta
fx-plateau test working identically in all three drivers."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax import LbfgsError, Status, lbfgs
from lbfgs_jax.core import ProblemDef
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.params import LbfgsParams, LineSearchParams


# ---------------------------------------------------------------------------
# entry validation: negative line-search step is a hard error
# ---------------------------------------------------------------------------


def test_negative_step_propagate_fatal():
    """A restored/mangled state with a negative step fails find's entry
    validation with the reference's logic error (src/line.rs:197-201)."""
    st = lbfgs().build(rosenbrock.initial_point(10), rosenbrock.value_and_grad)
    st.propagate()  # k=1 bookkeeping
    st.state = st.state._replace(step=jnp.asarray(-1.0, st.state.step.dtype))
    with pytest.raises(LbfgsError, match="negative line-search step"):
        st.propagate()
    assert int(st.state.status) == Status.ERR_NEGATIVE_STEP


def test_zero_step_is_sign_positive():
    """Parity quirk: the reference's is_sign_positive() accepts +0.0, so a
    zero step passes entry validation (and fails later, differently)."""
    st = lbfgs().build(rosenbrock.initial_point(10), rosenbrock.value_and_grad)
    st.propagate()
    st.state = st.state._replace(step=jnp.asarray(0.0, st.state.step.dtype))
    try:
        st.propagate()
        code = int(st.state.status)
    except LbfgsError as e:
        code = int(e.status)
    assert code != Status.ERR_NEGATIVE_STEP


def test_negative_step_jit_driver():
    """The whole-run driver surfaces the same status via _run_while."""
    import jax

    from lbfgs_jax.minimize import _run_while
    from lbfgs_jax.solver import init_state, start_state

    params = LbfgsParams()
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
    st = init_state(pdef, params, rosenbrock.initial_point(10))
    st = start_state(st, params)
    st = st._replace(step=jnp.asarray(-0.5, st.step.dtype))
    out = jax.jit(lambda s: _run_while(pdef, params, s))(st)
    assert int(out.status) == Status.ERR_NEGATIVE_STEP


# ---------------------------------------------------------------------------
# ascent-direction warning
# ---------------------------------------------------------------------------


def test_ascent_direction_warning(caplog):
    from lbfgs_jax import linesearch

    x0 = rosenbrock.initial_point(10)
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
    fx, gx = rosenbrock.value_and_grad(x0)
    d = gx  # ascent: g . d = ||g||^2 > 0
    with caplog.at_level(logging.WARNING, logger="lbfgs_jax"):
        linesearch.find(
            pdef,
            LineSearchParams(),
            x0,
            fx,
            gx,
            gx,
            d,
            jnp.asarray(1e-3, x0.dtype),
            jnp.asarray(1, jnp.int32),
        )
    assert any(
        "increases the objective function value" in r.message for r in caplog.records
    )


def test_no_ascent_warning_on_descent(caplog):
    from lbfgs_jax import linesearch

    x0 = rosenbrock.initial_point(10)
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
    fx, gx = rosenbrock.value_and_grad(x0)
    with caplog.at_level(logging.WARNING, logger="lbfgs_jax"):
        linesearch.find(
            pdef,
            LineSearchParams(),
            x0,
            fx,
            gx,
            gx,
            -gx,
            jnp.asarray(1e-3, x0.dtype),
            jnp.asarray(1, jnp.int32),
        )
    assert not any(
        "increases the objective" in r.message for r in caplog.records
    )


# ---------------------------------------------------------------------------
# reference-parity log lines
# ---------------------------------------------------------------------------


def test_log_max_iterations(caplog):
    with caplog.at_level(logging.WARNING, logger="lbfgs_jax"):
        lbfgs().with_max_iterations(3).minimize(
            rosenbrock.initial_point(10), rosenbrock.value_and_grad
        )
    assert any("max iterations reached!" in r.message for r in caplog.records)


def test_log_convergence_info(caplog):
    with caplog.at_level(logging.INFO, logger="lbfgs_jax"):
        lbfgs().minimize(rosenbrock.initial_point(10), rosenbrock.value_and_grad)
    assert any("reaches convergence" in r.message for r in caplog.records)


def test_log_linesearch_failure(caplog):
    def linear_vag(x):
        return jnp.sum(x), jnp.ones_like(x)

    linear_vag.__lbfgs_value_and_grad__ = True
    # max_linesearch high enough for More-Thuente's extrapolation to
    # actually reach max_step (0.35 * 5^26 > 1e20) and error out, instead
    # of exhausting the trial budget (which counts as success)
    with caplog.at_level(logging.ERROR, logger="lbfgs_jax"):
        with pytest.raises(LbfgsError):
            lbfgs().with_max_linesearch(60).minimize(jnp.zeros(8), linear_vag)
    assert any(
        "line search failed, revert to the previous point!" in r.message
        for r in caplog.records
    )
    assert any("max_step" in r.message for r in caplog.records)


def test_log_owlqn_restriction(caplog):
    with caplog.at_level(logging.WARNING, logger="lbfgs_jax"):
        lbfgs().with_orthantwise(1.0, 0, 99)
    assert any("Only the backtracking" in r.message for r in caplog.records)


# ---------------------------------------------------------------------------
# past/delta plateau test: identical in all three drivers
# ---------------------------------------------------------------------------


def _plateau_vag(x):
    # fx -> 100 with gnorm -> 0 but never exactly 0: without the plateau
    # test (epsilon tiny) the solver would keep polishing forever
    fx = jnp.sum((x - 1.0) ** 2) + 100.0
    return fx, 2.0 * (x - 1.0)


_plateau_vag.__lbfgs_value_and_grad__ = True


@pytest.mark.parametrize("past,delta", [(3, 1e-10), (1, 1e-12)])
def test_fx_delta_three_drivers_agree(past, delta):
    opt = (
        lbfgs()
        .with_epsilon(1e-300)
        .with_fx_delta(delta, past)
        .with_fx_delta_enabled()
        .with_max_iterations(200)
    )
    x0 = jnp.full((8,), 5.0)

    rep_host = opt.minimize(x0, _plateau_vag)
    rep_jit = opt.minimize_jit(x0, _plateau_vag)
    out_b = opt.minimize_batched(jnp.stack([x0, x0]), _plateau_vag)

    assert rep_host.status == Status.CONVERGED
    assert rep_jit.status == Status.CONVERGED
    assert int(out_b["status"][0]) == Status.CONVERGED
    assert rep_host.niter == rep_jit.niter == int(out_b["niter"][0])
    assert rep_host.niter < 200  # actually stopped by the plateau test


def test_fx_delta_disabled_ring_absent():
    st = lbfgs().build(rosenbrock.initial_point(10), rosenbrock.value_and_grad)
    assert st.state.pf is None


# ---------------------------------------------------------------------------
# builder cross-validation + speculative host-objective rejection
# ---------------------------------------------------------------------------


def test_ftol_after_gtol_cross_validated():
    b = lbfgs().with_linesearch_gtol(0.5)
    with pytest.raises(AssertionError):
        b.with_linesearch_ftol(0.6)


def test_speculative_rejects_host_closure():
    def mut_closure(x, g):
        g[...] = 2.0 * x
        return float(np.dot(x, x))

    with pytest.raises(ValueError, match="traceable objective"):
        (
            lbfgs()
            .with_linesearch_algorithm("BacktrackingArmijo")
            .with_speculative_linesearch(4)
            .minimize(np.ones(4), mut_closure)
        )
