"""Line-search unit tests: mcstep safeguards and the three search families
on analytic 1-D objectives embedded in R^n."""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.core import ProblemDef
from lbfgs_jax.linesearch import backtracking, find, morethuente, update_trial_interval
from lbfgs_jax.params import LineSearchAlgorithm, LineSearchParams
from lbfgs_jax.status import Status


def f64(v):
    return jnp.float64(v)


# ---------------------------------------------------------------------------
# mcstep
# ---------------------------------------------------------------------------


def test_mcstep_case1_brackets():
    # trial has higher f than best -> case 1, minimum bracketed
    out = update_trial_interval(
        f64(0.0), f64(0.0), f64(-1.0),   # x, fx, dx (best; descent)
        f64(0.0), f64(0.0), f64(-1.0),   # y, fy, dy
        f64(1.0), f64(2.0), f64(3.0),    # t, ft, dt: higher value
        f64(0.0), f64(10.0), jnp.asarray(False),
    )
    assert bool(out.brackt)
    assert int(out.status) == 0
    assert float(out.y) == 1.0 and float(out.fy) == 2.0  # y <- t
    assert 0.0 <= float(out.t) <= 1.0  # new trial inside interval


def test_mcstep_case2_opposite_derivative_signs():
    # lower f, derivative sign flipped -> case 2, bracketed, x <- t, y <- old x
    out = update_trial_interval(
        f64(0.0), f64(0.0), f64(-1.0),
        f64(0.0), f64(0.0), f64(-1.0),
        f64(1.0), f64(-0.5), f64(0.8),
        f64(0.0), f64(10.0), jnp.asarray(False),
    )
    assert bool(out.brackt)
    assert float(out.x) == 1.0 and float(out.fx) == -0.5
    assert float(out.y) == 0.0


def test_mcstep_case3_extrapolates():
    # lower f, same sign, smaller |derivative| -> not bracketed, step grows
    out = update_trial_interval(
        f64(0.0), f64(0.0), f64(-1.0),
        f64(0.0), f64(0.0), f64(-1.0),
        f64(1.0), f64(-0.9), f64(-0.5),
        f64(0.0), f64(10.0), jnp.asarray(False),
    )
    assert not bool(out.brackt)
    assert float(out.t) > 1.0


def test_mcstep_case4_unbracketed_goes_to_tmax():
    # lower f, same sign, derivative magnitude grows, not bracketed
    out = update_trial_interval(
        f64(0.0), f64(0.0), f64(-1.0),
        f64(0.0), f64(0.0), f64(-1.0),
        f64(1.0), f64(-0.5), f64(-2.0),
        f64(0.0), f64(10.0), jnp.asarray(False),
    )
    assert float(out.t) == 10.0  # x < t -> tmax (src/line.rs:544-550)


def test_mcstep_error_out_of_interval():
    out = update_trial_interval(
        f64(0.0), f64(0.0), f64(-1.0),
        f64(1.0), f64(0.5), f64(1.0),
        f64(5.0), f64(0.1), f64(0.1),   # t outside [0, 1]
        f64(0.0), f64(10.0), jnp.asarray(True),
    )
    assert int(out.status) == Status.LS_OUT_OF_INTERVAL


def test_mcstep_error_nondescent():
    out = update_trial_interval(
        f64(0.0), f64(0.0), f64(1.0),    # dx > 0 and t > x -> dx*(t-x) >= 0
        f64(1.0), f64(0.5), f64(-1.0),
        f64(0.5), f64(0.1), f64(0.1),
        f64(0.0), f64(10.0), jnp.asarray(True),
    )
    assert int(out.status) == Status.LS_INCREASE_GRADIENT


# ---------------------------------------------------------------------------
# search drivers on a 1-D quadratic f(x) = (x - 2)^2 embedded via x = t*d
# ---------------------------------------------------------------------------


def _quad_pdef():
    def vag(x):
        fx = jnp.sum((x - 2.0) ** 2)
        return fx, 2.0 * (x - 2.0)

    vag.__lbfgs_value_and_grad__ = True
    return ProblemDef(value_and_grad=vag)


def _setup(pdef, x0=0.0):
    xp = jnp.array([jnp.float64(x0)])
    fx, g = pdef.value_and_grad(xp)
    d = -g
    return xp, fx, g, d


def test_morethuente_quadratic():
    pdef = _quad_pdef()
    xp, fx, g, d = _setup(pdef)
    # tight gtol forces the search to localize the 1-D minimizer
    ls = LineSearchParams(gtol=1e-3)
    res = morethuente(
        pdef, ls, xp, fx, g, d, jnp.float64(0.1), jnp.dot(g, d), jnp.int32(1)
    )
    assert int(res.status) == 0
    assert int(res.ncall) >= 1
    # strong curvature condition satisfied at the accepted point
    dg = float(jnp.dot(res.gx, d))
    dginit = float(jnp.dot(g, d))
    assert abs(dg) <= 1e-3 * (-dginit)
    # on a quadratic the curvature condition pins x near the minimizer 2.0
    assert float(res.x[0]) == pytest.approx(2.0, abs=5e-3)


@pytest.mark.parametrize(
    "algo",
    [
        LineSearchAlgorithm.BacktrackingArmijo,
        LineSearchAlgorithm.BacktrackingWolfe,
        LineSearchAlgorithm.BacktrackingStrongWolfe,
    ],
)
def test_backtracking_conditions(algo):
    pdef = _quad_pdef()
    xp, fx, g, d = _setup(pdef)
    ls = LineSearchParams(algorithm=algo)
    dginit = jnp.dot(g, d)
    res = backtracking(
        pdef, ls, xp, fx, g, d, jnp.float64(0.05), dginit, jnp.int32(1), xp
    )
    assert int(res.status) == 0
    f_new = float(res.fx)
    stp = float(res.step)
    # Armijo holds at the accepted point for every flavor
    assert f_new <= float(fx) + 1e-4 * stp * float(dginit) + 1e-12
    if algo != LineSearchAlgorithm.BacktrackingArmijo:
        dg = float(jnp.dot(res.gx, d))
        assert dg >= 0.9 * float(dginit)  # regular Wolfe
    if algo == LineSearchAlgorithm.BacktrackingStrongWolfe:
        dg = float(jnp.dot(res.gx, d))
        assert abs(dg) <= 0.9 * abs(float(dginit))


def test_exhaustion_returns_max_linesearch():
    # objective so ill-scaled the Armijo test keeps failing: f rises along d
    def vag(x):
        return jnp.sum(x**2), 2.0 * x

    vag.__lbfgs_value_and_grad__ = True
    pdef = ProblemDef(value_and_grad=vag)
    xp = jnp.array([1.0])
    fx, g = vag(xp)
    d = jnp.array([1.0])  # ascent direction
    ls = LineSearchParams(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
    res = backtracking(
        pdef, ls, xp, fx, g, d, jnp.float64(1.0), jnp.dot(g, d), jnp.int32(1), xp
    )
    # loop runs max_linesearch - 1 trials then *succeeds* with
    # ncall = max_linesearch (quirk parity, src/line.rs:739, :781-783)
    assert int(res.status) == 0
    assert int(res.ncall) == ls.max_linesearch
    assert int(res.neval) == 1 + ls.max_linesearch - 1


def test_find_routes_owlqn_to_backtracking():
    from lbfgs_jax.orthantwise import Orthantwise

    def vag(x):
        return jnp.sum((x - 1.0) ** 2), 2.0 * (x - 1.0)

    vag.__lbfgs_value_and_grad__ = True
    pdef = ProblemDef(value_and_grad=vag, owlqn=Orthantwise(c=0.1, start=0, end=None))
    xp = jnp.array([0.5, -0.5])
    fx0, g = vag(xp)
    from lbfgs_jax.orthantwise import pseudo_gradient, x1norm

    fx = fx0 + x1norm(pdef.owlqn, xp)
    pg = pseudo_gradient(pdef.owlqn, xp, g)
    d = -pg
    ls = LineSearchParams()  # MoreThuente algorithm, but OWL-QN forces backtracking
    res = find(pdef, ls, xp, fx, g, pg, d, jnp.float64(0.2), jnp.int32(1))
    assert int(res.status) == 0
    assert float(res.fx) < float(fx)


def test_gradient_only_with_morethuente_raises():
    pdef = _quad_pdef()
    ls = LineSearchParams(gradient_only=True)
    xp = jnp.array([0.0])
    with pytest.raises(ValueError):
        find(pdef, ls, xp, f64(0.0), xp, xp, xp, jnp.float64(0.1), jnp.int32(0))
