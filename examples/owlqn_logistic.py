"""OWL-QN L1-regularized log-linear regression (reference ``tests/owlqn.rs``
as a runnable example): intercept excluded from the L1 window.

    JAX_PLATFORMS=cpu python examples/owlqn_logistic.py
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from lbfgs_jax import lbfgs
from lbfgs_jax.models import logistic


def main():
    X, y = logistic.synthetic_dataset(nrow=500, ncol=21, seed=7)
    obj = logistic.make_objective(X, y)
    rep = (
        lbfgs()
        .with_orthantwise(1.0, 1, 21)
        .with_epsilon(1e-4)
        .minimize(jnp.zeros(21), obj)
    )
    beta = np.asarray(rep.x)
    print(f"fx = {rep.fx:.6f}  niter = {rep.niter}  neval = {rep.neval}")
    print(f"nonzero coefficients: {np.sum(beta != 0)}/21")
    print("beta:", np.array2string(beta, precision=4, suppress_small=True))


if __name__ == "__main__":
    main()
