"""Wide (f64) objective-scalar carry (``params.fx_wide``).

The reference is f64 throughout (``src/math.rs:4-82``); this build
streams f32 vectors, which caps the objective scalar at ~7 digits — at
the n = 1e8 OWL-QN scale the L1 term pins fx at ~4e7 where f32 cannot
represent the Armijo sufficient-decrease differences (PERF.md).  The
wide mode keeps every vector stream f32 but reduces PER-BLOCK f32
partials of the objective in f64 and carries fx/finit/ft as f64
scalars.

These tests pin:
  * the mechanism — at many-block scale the wide reduction tracks the
    exact f64 sum an order of magnitude closer than one f32 total;
  * dtype flow — fx is f64 end-to-end through the line searches, solver
    state, and drivers while x/g/d stay f32;
  * no semantic drift — wide and default trajectories agree at f32
    tolerance on well-conditioned problems (wide is a resolution
    upgrade, not a different algorithm);
  * the x64 guard.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.core import ProblemDef
from lbfgs_jax.minimize import minimize_jit
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.orthantwise import Orthantwise
from lbfgs_jax.ops import fused
from lbfgs_jax.params import LbfgsParams, LineSearchAlgorithm

def _exact_rosen(xt: np.ndarray) -> float:
    xt = np.asarray(xt, np.float64)
    t1 = 1.0 - xt
    t2 = 10.0 * (np.roll(xt, -1) - xt * xt)
    even = (np.arange(xt.shape[0]) % 2) == 0
    return float(np.sum(np.where(even, t1 * t1 + t2 * t2, 0.0)))


def _serial_f32_sum(v) -> float:
    """One f32 accumulator run left to right over the blocks' partial
    order — the drift the wide mode removes."""
    acc = np.float32(0.0)
    for p in np.asarray(v, np.float32).reshape(-1, 2048).sum(axis=1, dtype=np.float32):
        acc = np.float32(acc + p)
    return float(acc)


def test_wide_reduction_tracks_exact_f64():
    """At n = 2^22 (2048 blocks) and |fx| ~ 1e12 an f32 cross-block chain
    drifts from the exact sum; the wide per-block-partial reduction stays
    within ~1e-8 (its residual is the within-block f32 accumulation, by
    design)."""
    n = 1 << 22
    xp = np.asarray(rosenbrock.initial_point(n, dtype=jnp.float64)) + 10.0
    d = 0.001 * np.random.RandomState(0).randn(n)
    xpf = jnp.asarray(xp, jnp.float32)
    df = jnp.asarray(d, jnp.float32)
    exact = _exact_rosen(
        np.asarray(xpf, np.float64) + np.asarray(df, np.float64)
    )

    k = rosenbrock.value_and_grad.kernels
    xt = np.asarray(xpf + df)
    even = (np.arange(n) % 2) == 0
    e = xt.astype(np.float32)
    t1 = np.float32(1.0) - e
    t2 = np.float32(10.0) * (np.roll(e, -1) - e * e)
    ft32 = _serial_f32_sum(np.where(even, t1 * t1 + t2 * t2, np.float32(0.0)))
    with fused.wide_fx():
        ft64, _ = k.probe(xpf, df, jnp.float32(1.0))
    assert ft64.dtype == jnp.float64
    rel32 = abs(float(ft32) - exact) / exact
    rel64 = abs(float(ft64) - exact) / exact
    assert rel64 < 1e-8, (rel64, rel32)
    assert rel64 < rel32 / 5.0, (rel64, rel32)


def test_wide_trial_matches_probe_bitwise():
    """The remat contract must hold in wide mode too: the probed ft
    equals the materializing trial's fx bit-for-bit (same evaluation,
    same f64 reduce)."""
    n = 1 << 18
    xp = rosenbrock.initial_point(n, dtype=jnp.float32)
    d = jnp.asarray(0.01 * np.random.RandomState(1).randn(n), jnp.float32)
    k = rosenbrock.value_and_grad.kernels
    with fused.wide_fx():
        ft, dgp = k.probe(xp, d, jnp.float32(0.7))
        _, fx, _, dg, *_ = k.trial(xp, d, jnp.float32(0.7))
    assert float(ft) == float(fx)
    assert float(dgp) == float(dg)
    assert ft.dtype == fx.dtype == jnp.float64


def test_wide_owlqn_trial_kernel():
    """OWL-QN trial under wide: raw-fx AND L1 partials reduce in f64 (the
    L1 term is the dominant magnitude at scale); matches the f64 oracle."""
    k = rosenbrock.value_and_grad.kernels
    n = 1 << 18
    rng = np.random.RandomState(2)
    xp = jnp.asarray(rng.randn(n) * 3.0, jnp.float32)
    d = jnp.asarray(rng.randn(n) * 0.01, jnp.float32)
    wp = jnp.sign(xp)
    c, lo, hi = 1.0, 0, n - 1
    with fused.wide_fx():
        xt, ft, g, dg, xx, changed = k.owlqn_trial(
            xp, d, wp, jnp.float32(1.0), c, lo, hi
        )
        ftp, dgp = k.owlqn_probe(xp, d, wp, jnp.float32(1.0), c, lo, hi)
    assert ft.dtype == jnp.float64
    assert float(ftp) == float(ft)  # remat contract
    # f64 oracle on the f32 trial point
    xt64 = np.asarray(xt, np.float64)
    idx = np.arange(n)
    l1 = float(np.sum(np.where((idx >= lo) & (idx < hi), np.abs(xt64), 0.0)))
    exact = _exact_rosen(xt64) + c * l1
    assert abs(float(ft) - exact) / abs(exact) < 1e-7


def _run(n, wide, ow=None, iters=12, algo=None):
    params = LbfgsParams(
        max_iterations=iters + 1, epsilon=0.0, fx_wide=wide, orthantwise=ow,
        constrain_step_size=False,
    )
    if algo:
        params = params.replace_ls(algorithm=algo)
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    return minimize_jit(params, x0, rosenbrock.value_and_grad, return_state=True)


def test_wide_end_to_end_morethuente(epilogue_interpret):
    """Whole-run jitted driver on the fused-epilogue hot path (interpret
    mode): wide fx is f64, vectors stay f32, and the trajectory agrees
    with the default run at f32 tolerance."""
    n = 1 << 14
    st_w = _run(n, True)
    assert epilogue_interpret, "the epilogue did not engage"
    st_d = _run(n, False)
    assert st_w.prob.fx.dtype == jnp.float64
    assert st_w.prob.x.dtype == jnp.float32
    assert st_w.prob.gx.dtype == jnp.float32
    assert st_d.prob.fx.dtype == jnp.float32
    assert int(st_w.k) == int(st_d.k)
    assert float(st_w.prob.fx) == pytest.approx(float(st_d.prob.fx), rel=1e-3)


def test_wide_end_to_end_owlqn():
    """OWL-QN (Armijo ladder) under wide: f64 fx end-to-end, trajectory
    at f32 tolerance vs the default run."""
    n = 1 << 14
    ow = Orthantwise(c=1.0, start=0, end=n - 1)
    st_w = _run(n, True, ow=ow)
    st_d = _run(n, False, ow=ow)
    assert st_w.prob.fx.dtype == jnp.float64
    assert st_w.prob.pg.dtype == jnp.float32
    assert int(st_w.k) == int(st_d.k)
    assert float(st_w.prob.fx) == pytest.approx(float(st_d.prob.fx), rel=1e-3)
    assert np.isfinite(float(st_w.prob.fx))


def test_wide_host_driver_and_generic_objective():
    """Step-at-a-time driver + generic (non-kernel) jnp objective: the
    evaluate boundary (core.evaluate + obj_sum two-stage) carries f64."""
    from lbfgs_jax.minimize import LbfgsState

    params = LbfgsParams(fx_wide=True, max_iterations=10)
    x0 = rosenbrock.initial_point(100, dtype=jnp.float32)
    st = LbfgsState.build(params, x0, rosenbrock.value_and_grad)
    assert st.state.prob.fx.dtype == jnp.float64
    while not st.is_converged():
        p = st.propagate()
    assert st.state.prob.fx.dtype == jnp.float64
    rep = st.report()
    assert np.isfinite(rep.fx)


def test_wide_without_x64_uses_df_carry():
    """fx_wide without jax_enable_x64 is NOT an error since round 5: the
    objective scalar carries as a double-float (two-f32) pair instead of
    silently downgrading to f32 (see tests/test_df_fx.py for the full
    equivalence pins)."""
    from lbfgs_jax.ops import df
    from lbfgs_jax.solver import init_state

    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
    params = LbfgsParams(fx_wide=True)
    x0 = rosenbrock.initial_point(64, dtype=jnp.float32)
    orig = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_enable_x64", False)
        st = init_state(pdef, params, x0)
        assert df.is_df(st.prob.fx)
    finally:
        jax.config.update("jax_enable_x64", orig)
