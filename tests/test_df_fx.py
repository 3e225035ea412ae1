"""x64-free wide objective carry: the double-float (two-f32) fx
(an extension).

``params.fx_wide`` without ``jax_enable_x64`` now carries the objective
scalar as a ``(2,)``-f32 double-float pair (``ops/df.py``, ~48-bit
resolution) instead of hard-erroring — removing the process-global x64
flag's blast radius (int64 iotas, kernel-body promotion, user-code dtype
semantics).  Pinned here:

- error-free-transformation arithmetic (exact two-sum, tree reduction
  matching the f64 sum, ordering on (hi, lo));
- trajectory equivalence with the f64 mode on OWL-QN Rosenbrock shifted
  to the 4e7 fx magnitude (the 1e8 resolution-floor regime): identical
  iteration/evaluation counts and final fx, while the plain f32 carry
  deviates — the de-fang contract (the f64-mode capability itself is
  pinned by test_owlqn_logistic/test_wide_fx);
- More-Thuente under df32 tracking the f64 mode (sub-ULP fx resolution
  with f32-collapsed difference geometry); speculative search rejects
  the carry with a clear error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.models import separable
from lbfgs_jax.ops import df, fused
from lbfgs_jax.orthantwise import Orthantwise
from lbfgs_jax.params import LbfgsParams, LineSearchAlgorithm


def test_two_sum_exact():
    rng = np.random.RandomState(0)
    a = jnp.asarray(rng.randn(64).astype(np.float32) * 1e6)
    b = jnp.asarray(rng.randn(64).astype(np.float32))
    s, e = df._two_sum(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


def test_tree_sum_matches_f64():
    """The cross-block reduction property wide-fx needs: the df tree sum
    of ~1500 partials at the 1e8-problem magnitude tracks the f64 sum
    essentially exactly where the plain f32 chain drifts."""
    rng = np.random.RandomState(1)
    parts = jnp.asarray(rng.randn(1500).astype(np.float32) * 4e4)
    exact = float(np.sum(np.asarray(parts, np.float64)))
    got = df.value_f64(df.sum_f32(parts))
    assert abs(got - exact) <= 4.0 * abs(exact) * 2.0 ** -48
    f32_err = abs(float(jnp.sum(parts)) - exact)
    assert abs(got - exact) < f32_err / 100.0


def test_scale_and_add_track_f64():
    rng = np.random.RandomState(2)
    vals = rng.randn(32) * 1e7
    x = df.sum_f32(jnp.asarray(rng.randn(4096).astype(np.float32) * 1e3))
    x64 = df.value_f64(x)
    y = df.scale(df.add_f(x, 123.456), 0.371)
    assert df.value_f64(y) == pytest.approx((x64 + np.float32(123.456))
                                            * np.float32(0.371), rel=1e-12)
    z = df.add(y, x)
    assert df.value_f64(z) == pytest.approx(df.value_f64(y) + x64, rel=1e-12)
    del vals


def test_compare_orders_below_f32_ulp():
    base = df.from_f(4.4e7)
    bumped = df.add_f(base, 0.25)  # far below ULP(4.4e7) = 4
    assert bool(df.gt(bumped, base))
    assert not bool(df.gt(base, bumped))
    assert bool(df.lt(base, bumped))


def _offset_rosenbrock(n, off=4.0e7):
    """Extended Rosenbrock shifted to the n=1e8 OWL-QN fx magnitude
    (~4e7, where f32's ULP is 4): the controlled small-scale stand-in
    for the objective-resolution floor (PERF.md round 4)."""
    from lbfgs_jax.models import rosenbrock

    OFF = jnp.float32(off)

    def vag(x):
        fx, g = rosenbrock._plain_value_and_grad(x)
        return fused.obj_add(fx, OFF), g

    vag.__lbfgs_value_and_grad__ = True
    return vag


def test_df32_reproduces_f64_mode_trajectory():
    """The equivalence that de-fangs the x64 flag: on OWL-QN Rosenbrock
    shifted to the 4e7 fx magnitude, the x64-free double-float carry
    takes the SAME trajectory as the f64 wide mode (identical iteration
    count, evaluation count, and final fx to the f32 bit), while the
    plain f32 carry deviates (its Armijo comparisons cannot see the
    sub-ULP decreases; measured here: 66 iters / fx 40007148.0 vs the
    wide modes' 88 / 40007147.543...)."""
    from lbfgs_jax.minimize import LbfgsState
    from lbfgs_jax.models import rosenbrock

    n = 1 << 14
    base = dict(
        epsilon=3e-2, max_iterations=150, constrain_step_size=False,
        orthantwise=Orthantwise(c=1.0, start=0, end=None),
    )

    def run(wide):
        params = LbfgsParams(fx_wide=wide, **base)
        st = LbfgsState.build(
            params, rosenbrock.initial_point(n, dtype=jnp.float32),
            _offset_rosenbrock(n),
        )
        while not st.is_converged():
            st.propagate()
        return st

    # f64 wide mode (x64 is on in the test harness)
    st_f64 = run(True)
    assert st_f64.state.prob.fx.dtype == jnp.float64
    # df32 wide mode: same config with x64 off
    with jax.enable_x64(False):
        st_df = run(True)
        assert df.is_df(st_df.state.prob.fx)
        st_f32 = run(False)

    assert int(st_df.state.k) == int(st_f64.state.k)
    assert int(st_df.state.prob.neval) == int(st_f64.state.prob.neval)
    fx_df = df.value_f64(st_df.state.prob.fx)
    fx_f64 = float(st_f64.state.prob.fx)
    assert fx_df == pytest.approx(fx_f64, rel=1e-9)
    # the f32 carry walks a DIFFERENT (resolution-blind) trajectory
    assert int(st_f32.state.prob.neval) != int(st_f64.state.prob.neval)
    # host report path collapses the pair correctly
    assert st_df.report().fx == pytest.approx(fx_df, rel=1e-9)


def test_df32_morethuente_tracks_f64_mode():
    """More-Thuente under the df32 carry: decisions go through df
    compares and the interval geometry consumes the sub-ULP-resolved
    f-value DIFFERENCES — on the 4e7-offset Rosenbrock the df32 run
    matches the f64 mode's iteration/evaluation counts and resolves fx
    below the f32 ULP (4 at this magnitude), where the plain f32 carry
    reads a flat 40000000.0."""
    from lbfgs_jax.minimize import LbfgsState
    from lbfgs_jax.models import rosenbrock

    n = 1 << 14

    def run(wide, x64off):
        ctx = jax.enable_x64(False) if x64off else jax.enable_x64(True)
        with ctx:
            params = LbfgsParams(fx_wide=wide, epsilon=3e-2,
                                 max_iterations=150,
                                 constrain_step_size=False)  # MoreThuente
            st = LbfgsState.build(
                params, rosenbrock.initial_point(n, dtype=jnp.float32),
                _offset_rosenbrock(n),
            )
            while not st.is_converged():
                st.propagate()
            fx = st.state.prob.fx
            fxv = df.value_f64(fx) if df.is_df(fx) else float(fx)
            return int(st.state.k), int(st.state.prob.neval), fxv

    k64, e64, fx64 = run(True, False)
    kdf, edf, fxdf = run(True, True)
    k32, e32, fx32 = run(False, True)
    assert (kdf, edf) == (k64, e64)
    # both wide modes resolve below the 4e7 f32 ULP; plain f32 cannot
    assert 0.0 < fxdf - 4.0e7 < 4.0
    assert fx32 == 4.0e7
    assert fxdf == pytest.approx(fx64, abs=4.0)  # same sub-ULP regime


def test_df32_rejects_speculative():
    from lbfgs_jax.minimize import LbfgsState

    with jax.enable_x64(False):
        n = 256
        w = jnp.ones((n,), jnp.float32)
        t = jnp.asarray(np.random.RandomState(3).randn(n), jnp.float32)
        obj = separable.quadratic(w, t)
        x0 = jnp.zeros((n,), jnp.float32)
        with pytest.raises(ValueError, match="speculative"):
            LbfgsState.build(
                LbfgsParams(fx_wide=True).replace_ls(
                    algorithm=LineSearchAlgorithm.BacktrackingArmijo,
                    speculative=4,
                ),
                x0, obj,
            )


def test_df32_backtracking_plain_converges():
    """Non-OWL-QN df32 path (plain Armijo): sane end-to-end behavior and
    a df-carried fx through the whole run."""
    from lbfgs_jax.minimize import minimize_jit

    with jax.enable_x64(False):
        n = 4096
        rng = np.random.RandomState(4)
        w = jnp.asarray(0.5 + np.abs(rng.randn(n)), jnp.float32)
        t = jnp.asarray(rng.randn(n), jnp.float32)
        obj = separable.quadratic(w, t)
        params = LbfgsParams(
            epsilon=1e-4, max_iterations=100, constrain_step_size=False,
            fx_wide=True,
        ).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
        rep = minimize_jit(params, jnp.zeros((n,), jnp.float32), obj)
        np.testing.assert_allclose(np.asarray(rep.x), np.asarray(t),
                                   rtol=1e-3, atol=1e-3)
