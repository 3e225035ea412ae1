"""L1-regularizable log-linear (Poisson) regression objective.

The OWL-QN realistic workload matching the reference integration test
(``tests/owlqn.rs:24-46``), which optimizes over a [nrow, ncol] design
matrix X and count vector y:

    fx(beta) = -( sum(y * X beta - exp(X beta)) ) + 0.5 * prec * sum(beta^2)
    g(beta)  = -( X^T (y - exp(X beta)) ) + prec * beta

This is the model family where the FLOPs live in the user objective
(two matrix-vector products per evaluation) rather than the solver.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array


def make_objective(X: Array, y: Array, prec: float = 0.0,
                   precision: str | None = "highest"):
    """Log-linear (Poisson) regression value-and-grad over design matrix X.

    ``precision=None`` uses the backend default matmul precision (on an
    NVIDIA GPU, f32 contractions may then run in TF32); "highest" matches
    the f64-parity test configuration.  The fx
    reduction routes through ``fused.obj_sum`` so ``params.fx_wide``
    carries the objective scalar as f64 at scale.
    """
    from ..ops import fused

    def vag(beta: Array) -> tuple[Array, Array]:
        xbeta = jnp.matmul(X, beta.astype(X.dtype), precision=precision,
                           preferred_element_type=beta.dtype)
        exp_xbeta = jnp.exp(xbeta)
        fx = fused.obj_add(
            fused.obj_scale(fused.obj_sum(y * xbeta - exp_xbeta), -1.0),
            0.5 * prec * jnp.sum(beta * beta),
        )
        r = (y - exp_xbeta).astype(X.dtype)
        g = -jnp.matmul(X.T, r, precision=precision,
                        preferred_element_type=beta.dtype) + prec * beta
        return fx, g

    vag.__lbfgs_value_and_grad__ = True
    return vag


def synthetic_device(nrow: int, ncol: int, seed: int = 0,
                     dtype=jnp.float32, x_dtype=None, nnz: int = 32):
    """On-device synthetic Poisson-regression dataset for the at-scale
    benchmarks (generated with jax.random inside jit: no multi-GB
    host->device transfer).

    Column 0 is the intercept; ``beta_true`` has ``nnz`` nonzero
    coefficients so the L1 path has real sparsity to recover.
    ``x_dtype`` (e.g. bfloat16) stores X narrow for HBM bandwidth while
    y and the solver vectors stay ``dtype``.  Returns (X, y).
    """
    x_dtype = x_dtype or dtype

    @jax.jit
    def gen():
        key = jax.random.PRNGKey(seed)
        kx, kb, ky = jax.random.split(key, 3)
        X = jax.random.normal(kx, (nrow, ncol), dtype)
        X = X.at[:, 0].set(1.0)
        # sparse ground truth over the first nnz slots after the intercept
        idx = jnp.arange(ncol, dtype=jnp.int32)
        sign = jnp.where(idx % 2 == 0, 1.0, -1.0)
        beta = jnp.where((idx >= 1) & (idx <= nnz), 0.3 * sign, 0.0).astype(dtype)
        lam = jnp.exp(jnp.clip(jnp.matmul(X, beta), -6.0, 6.0))
        y = jax.random.poisson(ky, lam).astype(dtype)
        return X.astype(x_dtype), y

    return gen()


def synthetic_dataset(nrow: int = 500, ncol: int = 21, seed: int = 7, dtype=jnp.float64):
    """Deterministic synthetic Poisson-regression dataset with an intercept
    column, shaped like the reference's tests/x.csv (500x21)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    X = rng.randn(nrow, ncol)
    X[:, 0] = 1.0  # intercept
    beta_true = np.zeros(ncol)
    beta_true[0] = 0.3
    beta_true[1:6] = np.array([0.4, -0.3, 0.2, 0.0, -0.2])
    lam = np.exp(np.clip(X @ beta_true, -10, 10))
    y = rng.poisson(lam).astype(float)
    return jnp.asarray(X, dtype), jnp.asarray(y, dtype)
