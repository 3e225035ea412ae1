"""Parity matrix against the native sequential-f64 oracle
(``lbfgs_jax/native``, the C++ stand-in for the Rust reference).

Every solver variant the library ships runs through the public host
driver on extended Rosenbrock, for each line search and for a problem
size that is lane-aligned (256) and one that is not (100), and must land
where the oracle lands:

- both report convergence;
- final fx agrees to 1e-9 absolute (relative for |fx| > 1): the same
  minimum, reached with f64 vectors;
- the iteration count agrees to within 12% — the trajectories coincide
  until the last steps, where the Armijo ladder and damped OWL-QN round
  their final accepts differently (measured: at most +2 iterations for
  Armijo and +11.7% for damped OWL-QN at n = 256).

``damped_fixed`` (the intended case-2 write-back, which the reference
drops) has no oracle twin: it must reach the oracle's minimum, at any
iteration count.  ``wide_df32`` runs f32 vectors with the double-float fx
carry (x64 off), so it is held to the f32 resolution of the minimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.minimize import minimize
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.native import minimize_native
from lbfgs_jax.orthantwise import Orthantwise
from lbfgs_jax.params import LbfgsParams
from lbfgs_jax.status import Status


def rosen_seq(x, g):
    """Sequential-accumulation Rosenbrock identical to the reference
    closure (src/lib.rs:79-94)."""
    fx = 0.0
    for i in range(0, len(x), 2):
        t1 = 1.0 - x[i]
        t2 = 10.0 * (x[i + 1] - x[i] * x[i])
        g[i + 1] = 20.0 * t2
        g[i] = -2.0 * (x[i] * g[i + 1] + t1)
        fx += t1 * t1 + t2 * t2
    return fx


def x0_np(n):
    x = np.zeros(n)
    x[0::2] = -1.2
    x[1::2] = 1.0
    return x


VARIANTS = ["plain", "damped", "damped_fixed", "owlqn", "damped_owlqn",
            "wide_f64", "wide_df32"]
SEARCHES = ["MoreThuente", "BacktrackingArmijo", "BacktrackingWolfe",
            "BacktrackingStrongWolfe"]


def _params(variant, search, n):
    kw = dict(constrain_step_size=False, max_iterations=400)
    if "damped" in variant:
        kw["damping"] = True
    if variant == "damped_fixed":
        kw["damping_fixed"] = True
    if "owlqn" in variant:
        kw["orthantwise"] = Orthantwise(1.0, 0, n)
    if variant.startswith("wide"):
        kw["fx_wide"] = True
    return LbfgsParams(**kw).replace_ls(algorithm=search)


@pytest.mark.parametrize("n", [100, 256], ids=["tail", "aligned"])
@pytest.mark.parametrize("search", SEARCHES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_matches_native_oracle(variant, search, n):
    params = _params(variant, search, n)
    rep_n = minimize_native(
        params.replace(damping_fixed=False, fx_wide=False), x0_np(n), rosen_seq
    )
    if variant == "wide_df32":
        with jax.enable_x64(False):
            x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
            rep = minimize(params.replace(epsilon=1e-4), x0,
                           rosenbrock.value_and_grad)
    else:
        rep = minimize(params, rosenbrock.initial_point(n),
                       rosenbrock.value_and_grad)

    assert rep_n.status == Status.CONVERGED
    assert rep.status == Status.CONVERGED
    if variant == "wide_df32":
        # f32 vectors: the minimum to f32 resolution of the iterate
        assert abs(rep.fx - rep_n.fx) <= 1e-5 * max(1.0, abs(rep_n.fx))
        return
    assert abs(rep.fx - rep_n.fx) <= 1e-9 * max(1.0, abs(rep_n.fx))
    if variant != "damped_fixed":
        assert abs(rep.niter - rep_n.niter) <= 0.12 * rep_n.niter
