"""The objective-agnostic factory (``ops/factory.make_fused_objective``).

Any separable objective gets the complete ``__lbfgs_*__`` protocol from a
per-block body — the answer to the reference's objective-agnostic eval
boundary (``src/core.rs:119-132``).  Pinned here with the separable
family (``models/separable``):

- the plain-jnp trial/probe protocol against direct jnp expressions,
  including the OWL-QN projected trial and its L1 term;
- the fused epilogue (interpret mode) streaming bound extras, and the
  solver engaging it for a factory objective;
- OWL-QN on the diagonal quadratic against its ANALYTIC soft-threshold
  solution;
- extras and global-index bodies on an 8-device mesh (GSPMD partitions
  the jnp protocol; results equal the single-device ones).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.models import separable
from lbfgs_jax.ops import epilogue, factory, fused
from lbfgs_jax.params import LbfgsParams
from lbfgs_jax.parallel import make_mesh, shard_vector

M = 6


def _rand(shape, seed, scale=1.0):
    return jnp.asarray(
        np.random.RandomState(seed).randn(*np.atleast_1d(shape)) * scale,
        jnp.float32,
    )


def _quad(n, seed=0):
    w = 0.5 + jnp.abs(_rand(n, seed + 1))
    t = _rand(n, seed + 2)
    return separable.quadratic(w, t), w, t


def _ring(H):
    m, n = H.shape
    return H.reshape(m, n // fused.LANES, fused.LANES)


def test_sphere_synthesized_vag():
    """No value_and_grad given: the factory synthesizes one from the
    block body (incl. the lane-padding tail path, n % 128 != 0)."""
    obj = separable.sphere()
    for n in (256, 300):
        x = _rand(n, 3)
        fx, g = obj(x)
        assert float(fx) == pytest.approx(float(0.5 * jnp.sum(x * x)),
                                          rel=1e-6)
        np.testing.assert_allclose(np.asarray(g), np.asarray(x), rtol=1e-6)


def test_protocol_attached():
    obj, _, _ = _quad(256)
    for name in ("value_and_grad", "trial", "trial_probe", "owlqn_trial",
                 "owlqn_probe", "trial_pair_gram", "trial_pair_gram_ok"):
        assert getattr(obj, f"__lbfgs_{name}__", None) is not None, name
    plain = factory.without_epilogue(obj)
    assert getattr(plain, "__lbfgs_trial__") is obj.__lbfgs_trial__
    assert getattr(plain, "__lbfgs_trial_pair_gram__", None) is None


@pytest.mark.parametrize("n", [4096, 128 * 9 + 2])  # aligned + tail
def test_quadratic_trial_probe_kernels(n):
    obj, w, t = _quad(n, seed=10)
    k = obj.kernels
    xp, d = _rand(n, 11), _rand(n, 12)
    xt, fx, g, dg, gg, xx, changed = k.trial(xp, d, 0.37)
    x = xp + 0.37 * d
    r = x - t
    np.testing.assert_allclose(np.asarray(xt), np.asarray(x), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(g), np.asarray(w * r), rtol=1e-6)
    assert float(fx) == pytest.approx(float(0.5 * jnp.sum(w * r * r)), rel=1e-5)
    assert float(dg) == pytest.approx(float(jnp.dot(w * r, d)), rel=1e-4)
    assert float(gg) == pytest.approx(float(jnp.dot(w * r, w * r)), rel=1e-5)
    assert float(xx) == pytest.approx(float(jnp.dot(x, x)), rel=1e-5)
    assert bool(changed)
    ft, dgp = k.probe(xp, d, 0.37)
    assert float(ft) == float(fx) and float(dgp) == float(dg)  # remat


def test_quadratic_owlqn_trial_probe_kernels():
    n = 4096
    obj, w, t = _quad(n, seed=20)
    k = obj.kernels
    xp, d = _rand(n, 21), _rand(n, 22)
    wp = jnp.sign(_rand(n, 23))
    c, lo, hi = 0.5, 100, 3000
    xt, ft, g, dg, xx, changed = k.owlqn_trial(xp, d, wp, 0.2, c, lo, hi)
    x = xp + 0.2 * d
    idx = np.arange(n)
    win = (idx >= lo) & (idx < hi)
    x = jnp.where(win & (jnp.sign(x) != wp), 0.0, x)
    np.testing.assert_allclose(np.asarray(xt), np.asarray(x), rtol=1e-7)
    r = x - t
    l1 = float(jnp.sum(jnp.where(win, jnp.abs(x), 0.0)))
    assert float(ft) == pytest.approx(
        float(0.5 * jnp.sum(w * r * r)) + c * l1, rel=1e-5)
    assert float(dg) == pytest.approx(float(jnp.dot(w * r, d)), rel=1e-4)
    ftp, dgp = k.owlqn_probe(xp, d, wp, 0.2, c, lo, hi)
    assert float(ftp) == float(ft) and float(dgp) == float(dg)


def test_quadratic_epilogue_kernels(epilogue_interpret):
    """The factory's epilogue entry streams the bound extras (w, t)."""
    n = 128 * 21
    obj, w, t = _quad(n, seed=30)
    xp, d, gp = _rand(n, 31), _rand(n, 32, 0.1), _rand(n, 33)
    S, Y = _ring(_rand((M, n), 34, 0.1)), _ring(_rand((M, n), 35, 0.1))
    assert obj.kernels.trial_pair_gram_ok(xp, S)
    out = obj.kernels.trial_pair_gram(xp, d, gp, 0.3, S, Y, 4, with_gp=True)
    ref = epilogue.trial_pair_gram_ref(obj, xp, d, gp, 0.3, S, Y, 4,
                                       with_gp=True)
    assert epilogue_interpret
    np.testing.assert_allclose(np.asarray(out[2]), np.asarray(ref[2]),
                               rtol=1e-6, atol=1e-6)
    assert float(out[1]) == pytest.approx(float(ref[1]), rel=1e-5)
    np.testing.assert_allclose(np.asarray(out[9]), np.asarray(ref[9]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out[10]), np.asarray(ref[10]),
                               rtol=1e-4, atol=1e-4)


def test_quadratic_solver_engages_epilogue(epilogue_interpret):
    """End-to-end: a factory objective (with extras!) drives the fused
    epilogue hot path to the exact minimizer t, in step with the plain
    path."""
    from lbfgs_jax.minimize import minimize_jit

    n = 1 << 14
    obj, w, t = _quad(n, seed=50)
    params = LbfgsParams(epsilon=1e-5, max_iterations=60,
                         constrain_step_size=False)
    x0 = jnp.zeros((n,), jnp.float32)
    rep_k = minimize_jit(params, x0, obj)
    assert epilogue_interpret, "factory epilogue did not engage"
    np.testing.assert_allclose(np.asarray(rep_k.x), np.asarray(t),
                               rtol=1e-3, atol=1e-3)
    rep_j = minimize_jit(params, x0, factory.without_epilogue(obj))
    assert rep_k.niter == pytest.approx(rep_j.niter, abs=2)
    assert rep_k.fx == pytest.approx(rep_j.fx, rel=1e-2, abs=1e-4)


def test_quartic_nontrivial_convergence():
    """A non-quadratic separable family member: the history must learn
    real curvature; the solver lands on the minimizer (0)."""
    from lbfgs_jax.minimize import minimize_jit

    n = 1 << 14
    w = 0.5 + jnp.abs(_rand(n, 60))
    obj = separable.scaled_quartic(w)
    params = LbfgsParams(epsilon=1e-5, max_iterations=80,
                         constrain_step_size=False)
    x0 = _rand(n, 61)
    rep = minimize_jit(params, x0, obj)
    assert rep.fx < 1e-8
    assert float(jnp.max(jnp.abs(rep.x))) < 1e-3


def test_owlqn_quadratic_soft_threshold():
    """OWL-QN on the diagonal quadratic has the ANALYTIC solution
    x* = sign(t) * max(|t| - c/w, 0)."""
    from lbfgs_jax.minimize import minimize_jit
    from lbfgs_jax.orthantwise import Orthantwise

    n = 1 << 14
    obj, w, t = _quad(n, seed=70)
    c = 0.3
    # epsilon sized to the f32 objective-resolution floor: at this n the
    # fx magnitude is ~3e3 (ULP ~2.4e-4) and the Armijo ladder stalls
    # below gnorm ~4e-3 (the wall params.fx_wide exists for)
    params = LbfgsParams(
        epsilon=1e-4, max_iterations=200, constrain_step_size=False,
        orthantwise=Orthantwise(c=c, start=0, end=None),
    )
    x0 = jnp.zeros((n,), jnp.float32)
    rep = minimize_jit(params, x0, obj)
    x_star = jnp.sign(t) * jnp.maximum(jnp.abs(t) - c / w, 0.0)
    np.testing.assert_allclose(np.asarray(rep.x), np.asarray(x_star),
                               rtol=1e-2, atol=2e-3)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(jax.devices()[:8])


def test_quadratic_extras_on_mesh(mesh):
    """Extras sharded WITH the vector: the partitioned trial equals the
    single-device one."""
    n = 8 * 128 * 4
    w = 0.5 + jnp.abs(_rand(n, 80))
    t = _rand(n, 81)
    xp, d = _rand(n, 82), _rand(n, 83)

    def trial(w_, t_, xp_, d_):
        return separable.quadratic(w_, t_).kernels.trial(xp_, d_, 0.37)

    out0 = jax.jit(trial)(w, t, xp, d)
    sh = [shard_vector(a, mesh) for a in (w, t, xp, d)]
    out1 = jax.jit(trial)(*sh)
    np.testing.assert_allclose(np.asarray(out1[0]), np.asarray(out0[0]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out1[2]), np.asarray(out0[2]),
                               rtol=1e-6, atol=1e-6)
    assert float(out1[1]) == pytest.approx(float(out0[1]), rel=1e-5)
    assert float(out1[3]) == pytest.approx(float(out0[3]), rel=1e-5, abs=1e-3)


def test_gidx_dependent_body_on_mesh(mesh):
    """A block body that reads the GLOBAL element index sees the same
    indices on a sharded vector as on one device."""
    n = 8 * 128 * 2

    def block(x, gidx):
        w = 1.0 + 0.1 * (gidx % 7).astype(x.dtype)
        return 0.5 * (w * (x * x)), w * x

    obj = factory.make_fused_objective(block)
    xp, d = _rand(n, 90), _rand(n, 91)
    trial = jax.jit(lambda a, b: obj.kernels.trial(a, b, 0.4))
    ref = trial(xp, d)
    out = trial(shard_vector(xp, mesh), shard_vector(d, mesh))
    w = 1.0 + 0.1 * (jnp.arange(n) % 7)
    # pointwise math, but separate programs may contract a*b+c into FMAs
    # differently: tight tolerance instead of bitwise
    np.testing.assert_allclose(np.asarray(ref[2]),
                               np.asarray(w * (xp + 0.4 * d)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(out[2]), np.asarray(ref[2]),
                               rtol=1e-6, atol=1e-6)
    assert float(out[1]) == pytest.approx(float(ref[1]), rel=1e-5)


def test_quadratic_epilogue_on_mesh(mesh):
    """On a mesh the epilogue's gate keeps the partitioned jnp path: a
    sharded factory-objective solve matches the single-device one."""
    from lbfgs_jax.minimize import minimize_jit

    n = 8 * 128 * 2
    obj, w, t = _quad(n, seed=95)
    params = LbfgsParams(epsilon=1e-5, max_iterations=40,
                         constrain_step_size=False)
    x0 = jnp.zeros((n,), jnp.float32)
    rep0 = minimize_jit(params, x0, obj)
    rep1 = minimize_jit(params, shard_vector(x0, mesh), obj)
    assert int(rep1.niter) == int(rep0.niter)
    np.testing.assert_allclose(np.asarray(rep1.x), np.asarray(rep0.x),
                               rtol=1e-4, atol=1e-5)
