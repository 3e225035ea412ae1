"""Lennard-Jones cluster relaxation — the chemistry workload behind the
reference's gradient-only/damped modes (``examples/lj.rs``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax import lbfgs
from lbfgs_jax.models import lennard_jones


def test_lj_gradient_matches_autodiff():
    """Hand-derived gradient equals jax.grad of the energy."""
    lj = lennard_jones.LennardJones()
    x = lennard_jones.lj38_positions()

    def energy(x):
        return lj.value_and_grad(x)[0]

    g_auto = jax.grad(energy)(x)
    _, g_hand = lj.value_and_grad(x)
    np.testing.assert_allclose(np.asarray(g_hand), np.asarray(g_auto), rtol=1e-9)


def test_lj_dimer_minimum():
    """Two atoms relax to the pair-potential minimum r = 2^(1/6) sigma,
    E = -epsilon."""
    obj = lennard_jones.make_objective()
    x0 = jnp.asarray([0.0, 0.0, 0.0, 1.5, 0.0, 0.0])
    rep = lbfgs().minimize(x0, obj)
    p = np.asarray(rep.x).reshape(2, 3)
    r = np.linalg.norm(p[0] - p[1])
    assert r == pytest.approx(2 ** (1 / 6), abs=1e-5)
    assert rep.fx == pytest.approx(-1.0, abs=1e-8)


def test_lj38_relaxation_default():
    """Default L-BFGS relaxes the reference example's LJ38 start geometry
    (``examples/lj.rs:70-109``) into its basin: E = -164.27015, matching
    the trajectory-exact native oracle to the reference tolerance."""
    obj = lennard_jones.make_objective()
    x0 = lennard_jones.lj38_positions()
    e0 = float(obj(x0)[0])
    assert e0 == pytest.approx(-116.84147098, abs=1e-6)
    rep = lbfgs().with_max_iterations(400).minimize(x0, obj)
    assert rep.fx == pytest.approx(-164.2701507, abs=1e-4)
    # run-comparable with the sequential reference-parity core
    rep_native = lbfgs().with_max_iterations(400).minimize(x0, obj, backend="native")
    assert rep.fx == pytest.approx(rep_native.fx, abs=1e-5)


def test_lj38_grid_start_relaxation():
    """The harder synthetic perturbed-grid start also relaxes into the
    LJ38 funnel (stress configuration)."""
    obj = lennard_jones.make_objective()
    x0 = lennard_jones.lj38_grid_start()
    e0 = float(obj(x0)[0])
    rep = lbfgs().with_max_iterations(400).minimize(x0, obj)
    assert rep.fx < e0
    assert rep.fx < -140.0  # near the LJ38 funnel (global min -173.93)


def test_lj38_gradient_only_damped_pinned_to_native():
    """Gradient-only + damped mode (the chemistry configuration,
    src/lbfgs.rs:283-289): the jax trajectory is pinned ITERATION-BY-
    ITERATION against the native oracle over a 50-step prefix (fx to
    1e-8 rel, gnorm/step/neval in lock-step).

    An end-state golden is NOT meaningful for this mode on LJ38: the f64
    summation-order difference between the C++ and jax reductions
    (~1e-10 by iteration 59) amplifies through the glassy LJ38 landscape
    into different basins — measured: the implementations agree to 1e-9
    for ~59 iterations, then separate chaotically.  The prefix pin is
    the stronger parity statement (it catches any semantic divergence
    immediately); the default-mode end-state golden lives in
    test_lj38_relaxation_default."""
    obj = lennard_jones.make_objective()
    x0 = lennard_jones.lj38_positions()

    def run(backend):
        trace = []

        def cb(p):
            trace.append(
                (p.niter, float(p.fx), float(p.gnorm), float(p.step), p.neval)
            )
            return False

        b = lbfgs().with_gradient_only().with_max_iterations(50)
        if backend == "native":
            b.minimize(x0, obj, cb, backend="native")
        else:
            b.minimize(x0, obj, cb)
        return trace

    tn = run("native")
    tj = run("jax")
    assert len(tn) == len(tj) == 50
    for (kn, fn, gn, sn, en), (kj, fj, gj, sj, ej) in zip(tn, tj):
        assert kn == kj and en == ej
        assert fj == pytest.approx(fn, rel=1e-8)
        assert gj == pytest.approx(gn, rel=1e-6)
        assert sj == pytest.approx(sn, rel=1e-6)
    # the damped prefix descends well below the start energy
    assert tj[-1][1] < -150.0
