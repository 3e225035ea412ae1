"""Scenario-batch regime: vmapped whole-solver over problem instances."""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax import Status, lbfgs
from lbfgs_jax.models import rosenbrock


def test_batched_matches_single():
    """Each batched instance reaches the same result as a solo run."""
    n, B = 10, 8
    rng = np.random.RandomState(0)
    x0b = jnp.asarray(np.tile(np.asarray(rosenbrock.initial_point(n)), (B, 1)))
    # perturb instances so they have distinct trajectories
    x0b = x0b + jnp.asarray(0.1 * rng.randn(B, n))

    out = lbfgs().minimize_batched(x0b, rosenbrock.value_and_grad)
    assert out["fx"].shape == (B,)
    assert np.all(np.asarray(out["status"]) == Status.CONVERGED)
    np.testing.assert_allclose(np.asarray(out["fx"]), 0.0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(out["x"]), 1.0, atol=1e-4)

    # spot-check instance 3 against a solo run (vmapped lowering rounds
    # differently, so iteration counts may drift by a few on chaotic
    # trajectories; the converged solution must agree)
    solo = lbfgs().minimize_jit(x0b[3], rosenbrock.value_and_grad)
    assert abs(int(out["niter"][3]) - solo.niter) <= 10
    assert float(out["fx"][3]) == pytest.approx(solo.fx, abs=1e-8)
    np.testing.assert_allclose(
        np.asarray(out["x"][3]), np.asarray(solo.x), atol=1e-4
    )


def test_batched_early_finishers_freeze():
    """Instances that converge early keep their neval/niter frozen while
    stragglers continue."""
    n = 10
    x0_done = jnp.ones(n)                      # already at the minimum
    x0_far = rosenbrock.initial_point(n)
    x0b = jnp.stack([x0_done, x0_far])
    out = lbfgs().minimize_batched(x0b, rosenbrock.value_and_grad)
    assert int(out["niter"][0]) == 0
    assert int(out["neval"][0]) == 1
    assert int(out["niter"][1]) > 5
    assert np.all(np.asarray(out["status"]) == Status.CONVERGED)


def test_batched_owlqn():
    n, B = 10, 4
    x0b = jnp.tile(jnp.ones(n), (B, 1))
    out = (
        lbfgs()
        .with_orthantwise(1.0, 0, None)
        .minimize_batched(x0b, rosenbrock.value_and_grad)
    )
    assert np.all(np.asarray(out["status"]) == Status.CONVERGED)
    # all instances identical => identical results
    xs = np.asarray(out["x"])
    np.testing.assert_array_equal(xs, np.tile(xs[0], (xs.shape[0], 1)))
