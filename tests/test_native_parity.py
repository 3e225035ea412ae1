"""Iteration-for-iteration parity against the reference's recorded
trajectories, via the native sequential-f64 oracle (see PARITY.md).

Key finding: the reference's golden comments (``tests/simple.rs:33-35,
48-50``) were recorded in 2018, BEFORE ``constrain_step_size`` /
``max_step_size`` were added (both default-on today).  With
``constrain_step_size=False`` this framework reproduces those recorded
values to every printed digit; with today's defaults it follows today's
(different) trajectory, which still passes every reference assert.
The recorded iteration numbers use the pre-v0.0.13 progress convention
(first search = iteration 1); the current convention reports the initial
point as iteration 1, shifting counts by exactly +1.
"""

import numpy as np
import pytest

from lbfgs_jax import lbfgs
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.native import minimize_native
from lbfgs_jax.orthantwise import Orthantwise
from lbfgs_jax.params import LbfgsParams

OLD = dict(constrain_step_size=False)  # pre-2019 reference behavior


def rosen_seq(x, g):
    """Sequential-accumulation Rosenbrock identical to the reference
    closure (src/lib.rs:79-94): left-fold fx sum, pairwise gradient."""
    n = len(x)
    fx = 0.0
    for i in range(0, n, 2):
        t1 = 1.0 - x[i]
        t2 = 10.0 * (x[i + 1] - x[i] * x[i])
        g[i + 1] = 20.0 * t2
        g[i] = -2.0 * (x[i] * g[i + 1] + t1)
        fx += t1 * t1 + t2 * t2
    return fx


def x0_np(n=100):
    x = np.zeros(n)
    x[0::2] = -1.2
    x[1::2] = 1.0
    return x


def test_native_reproduces_recorded_lbfgs_trajectory():
    """Recorded: fx = 0.0000000000000012832127771605377,
    gnorm = 0.0000009486547293218877 (tests/simple.rs:33-35)."""
    rep = minimize_native(LbfgsParams(**OLD), x0_np(), rosen_seq)
    assert rep.fx == pytest.approx(1.2832127771605377e-15, rel=1e-9)
    assert rep.gnorm == pytest.approx(9.486547293218877e-07, rel=1e-9)
    assert rep.niter == 38  # recorded "Iteration 37" + counting offset


def test_native_reproduces_recorded_owlqn_trajectory():
    """Recorded: fx = 43.50249999999999, x[0] = 0.2500000069348678,
    x[1] = 0.057500004213084016 (tests/simple.rs:48-50)."""
    r1 = minimize_native(LbfgsParams(**OLD), x0_np(), rosen_seq)
    p2 = LbfgsParams(orthantwise=Orthantwise(1.0, 0, 99), **OLD)
    r2 = minimize_native(p2, r1.x.copy(), rosen_seq)
    assert r2.fx == pytest.approx(43.50249999999999, rel=1e-12)
    assert r2.x[0] == pytest.approx(0.2500000069348678, rel=1e-8)
    assert r2.x[1] == pytest.approx(0.057500004213084016, rel=1e-8)
    assert r2.niter == 172  # recorded "Iteration 171" + counting offset


def test_jax_scan_reproduces_recorded_trajectory():
    """The JAX solver (literal scan two-loop) lands on the same recorded
    trajectory: XLA's elementwise ops round identically and the n=100
    reductions happen to agree here."""
    x0 = rosenbrock.initial_point(100)
    params = LbfgsParams(compact_two_loop=False, **OLD)
    from lbfgs_jax.minimize import minimize as _min

    rep = _min(params, x0, rosenbrock.value_and_grad)
    assert rep.fx == pytest.approx(1.2832127771605377e-15, rel=1e-3)
    assert rep.gnorm == pytest.approx(9.486547293218877e-07, rel=1e-6)
    assert rep.niter == 38


def test_jax_matches_native_current_defaults():
    """With today's defaults both stacks follow the same trajectory."""
    rep_n = minimize_native(LbfgsParams(), x0_np(), rosen_seq)
    x0 = rosenbrock.initial_point(100)
    from lbfgs_jax.minimize import minimize as _min

    rep_j = _min(LbfgsParams(compact_two_loop=False), x0, rosenbrock.value_and_grad)
    assert rep_j.niter == rep_n.niter == 35
    assert rep_j.fx == pytest.approx(rep_n.fx, rel=1e-6)
    assert rep_j.gnorm == pytest.approx(rep_n.gnorm, rel=1e-6)
    np.testing.assert_allclose(np.asarray(rep_j.x), rep_n.x, rtol=1e-6)


def test_native_booth():
    def booth(x, g):
        fx = (x[0] + 2 * x[1] - 7) ** 2 + (2 * x[0] + x[1] - 5) ** 2
        g[0] = 10 * x[0] + 8 * x[1] - 34
        g[1] = 8 * x[0] + 10 * x[1] - 38
        return fx

    rep = minimize_native(LbfgsParams(), np.array([-1.2, 1.0]), booth)
    assert rep.x[0] == pytest.approx(1.0, abs=1e-6)
    assert rep.x[1] == pytest.approx(3.0, abs=1e-6)


def test_native_cancellation_and_caps():
    seen = []
    rep = minimize_native(
        LbfgsParams(), x0_np(10), rosen_seq, progress=lambda p: p.niter >= 3
    )
    assert rep.niter == 3
    rep = minimize_native(LbfgsParams(max_iterations=5), x0_np(10), rosen_seq)
    assert rep.niter == 5
    assert rep.status == 2


def test_builder_native_backend_routing():
    """lbfgs().minimize(..., backend='native') runs the C++ core with any
    objective shape, including traceable JAX objectives."""
    import jax.numpy as jnp

    x0 = rosenbrock.initial_point(100)
    rep = (
        lbfgs()
        .with_constrain_step_size(False)
        .minimize(x0, rosenbrock.value_and_grad, backend="native")
    )
    # exact recorded-trajectory parity through the builder API
    assert rep.fx == pytest.approx(1.2832127771605377e-15, rel=1e-6)
    assert rep.niter == 38


# ---------------------------------------------------------------------------
# Default-path pinning: the SHIPPING config — compact two-loop, and the
# fused epilogue via interpret mode — is held to the same trajectories as
# the oracle / jnp path, so a regression in the compact or fused path
# fails CI (not just the loose golden bands).
# ---------------------------------------------------------------------------


def test_jax_compact_reproduces_recorded_trajectory():
    """The DEFAULT compact (Byrd-Nocedal-Schnabel) two-loop follows the
    recorded 2018 trajectory digit-for-digit, like the scan path."""
    x0 = rosenbrock.initial_point(100)
    params = LbfgsParams(compact_two_loop=True, **OLD)
    from lbfgs_jax.minimize import minimize as _min

    rep = _min(params, x0, rosenbrock.value_and_grad)
    assert rep.fx == pytest.approx(1.2832127771605377e-15, rel=1e-3)
    assert rep.gnorm == pytest.approx(9.486547293218877e-07, rel=1e-6)
    assert rep.niter == 38


def test_jax_compact_matches_native_current_defaults():
    rep_n = minimize_native(LbfgsParams(), x0_np(), rosen_seq)
    x0 = rosenbrock.initial_point(100)
    from lbfgs_jax.minimize import minimize as _min

    rep_j = _min(LbfgsParams(compact_two_loop=True), x0, rosenbrock.value_and_grad)
    assert rep_j.niter == rep_n.niter == 35
    assert rep_j.fx == pytest.approx(rep_n.fx, rel=1e-6)
    np.testing.assert_allclose(np.asarray(rep_j.x), rep_n.x, rtol=1e-6)


def test_jax_compact_owlqn_matches_native():
    """OWL-QN through the compact path lands on the native trajectory."""
    r1 = minimize_native(LbfgsParams(**OLD), x0_np(), rosen_seq)
    p2 = LbfgsParams(orthantwise=Orthantwise(1.0, 0, 99), **OLD)
    from lbfgs_jax.minimize import minimize as _min
    import jax.numpy as jnp

    rep_j = _min(p2, jnp.asarray(r1.x.copy()), rosenbrock.value_and_grad)
    assert rep_j.fx == pytest.approx(43.50249999999999, rel=1e-9)
    assert rep_j.niter == 172


def _run_f32(n, obj, damping=False, max_iter=25):
    """Fixed-prefix f32 trajectory through the host driver (fresh jits)."""
    import jax.numpy as jnp

    from lbfgs_jax.minimize import LbfgsState

    params = LbfgsParams(max_iterations=max_iter, epsilon=0.0,
                         damping=damping)
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    st = LbfgsState.build(params, x0, obj)
    while not st.is_converged():
        st.propagate()
    rep = st.report()
    return rep


@pytest.mark.parametrize("damping", [False, True], ids=["lbfgs", "damped"])
def test_kernel_path_pinned_to_jnp_path(epilogue_interpret, damping):
    """The f32 fused-epilogue path (interpret mode on CPU: the same kernel
    math, no Triton compile) follows the jnp path's trajectory: identical
    iteration count over a fixed prefix and matching fx."""
    from lbfgs_jax.ops.factory import without_epilogue

    n = 1 << 14
    vag = rosenbrock.value_and_grad
    # short prefix: tight agreement (f32 reassociation has not amplified
    # through the chaotic Rosenbrock valley yet) — a ring-slot or Gram
    # wiring regression diverges by orders of magnitude immediately
    rep_k8 = _run_f32(n, vag, damping, max_iter=8)
    rep_k = _run_f32(n, vag, damping)
    assert epilogue_interpret, "the epilogue did not engage"
    plain = without_epilogue(vag)
    rep_j8 = _run_f32(n, plain, damping, max_iter=8)
    rep_j = _run_f32(n, plain, damping)

    assert rep_k8.niter == rep_j8.niter
    assert rep_k8.fx == pytest.approx(rep_j8.fx, rel=1e-4)
    assert rep_k8.gnorm == pytest.approx(rep_j8.gnorm, rel=1e-2)
    # longer prefix: tolerance-level rounding divergence compounds, but
    # the trajectories must stay in lock-step
    assert rep_k.niter == rep_j.niter
    assert rep_k.fx == pytest.approx(rep_j.fx, rel=5e-2)


def test_native_backend_does_not_mutate_caller_x0():
    """Regression: the C++ core iterates x in place, and np.asarray of a
    CPU jax array is a zero-copy VIEW of the device buffer — without a
    defensive copy, backend="native" silently corrupted the caller's
    immutable jax x0 (a jax re-run after a native run started from the
    already-minimized point and reported niter=0)."""
    import jax.numpy as jnp

    from lbfgs_jax.minimize import minimize

    x0 = rosenbrock.initial_point(100)
    before = np.array(x0)
    minimize(LbfgsParams(), x0, rosenbrock.value_and_grad, backend="native")
    np.testing.assert_array_equal(np.array(x0), before)

    # and the raw wrapper path too
    from lbfgs_jax.native import minimize_native

    x1 = jnp.asarray(x0_np())
    before1 = np.array(x1)
    minimize_native(LbfgsParams(), x1, rosen_seq)
    np.testing.assert_array_equal(np.array(x1), before1)
