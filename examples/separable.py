"""Custom objectives at full kernel speed via the factory (round 5).

The reference accepts any closure at full speed (its eval boundary is
objective-agnostic, ``src/core.rs:119-132``).  The JAX build's analog:
``make_fused_objective`` turns a per-block math body into a complete
fused-kernel objective — trial/probe, OWL-QN variants, the one-kernel
epilogues and the combine+probe fusions all generated.

Run: python examples/separable.py          (GPU or CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from lbfgs_jax import lbfgs
from lbfgs_jax.models import separable
from lbfgs_jax.ops.factory import make_fused_objective


def main():
    n = 1 << 16
    rng = np.random.RandomState(0)
    w = jnp.asarray(0.5 + np.abs(rng.randn(n)), jnp.float32)
    t = jnp.asarray(rng.randn(n), jnp.float32)

    # ready-made family member: weighted quadratic with bound extras
    rep = (
        lbfgs()
        .with_epsilon(1e-5)
        .with_constrain_step_size(False)
        .minimize(jnp.zeros(n, jnp.float32), separable.quadratic(w, t))
    )
    print(f"quadratic: fx={rep.fx:.3e} niter={rep.niter} "
          f"max|x-t|={float(jnp.max(jnp.abs(rep.x - t))):.2e}")

    # OWL-QN on the same family: diagonal LASSO with an analytic solution
    c = 0.3
    rep = (
        lbfgs()
        .with_orthantwise(c, 0, None)
        .with_constrain_step_size(False)
        .with_adaptive_entry_step(2.0)   # round-5 ladder policy
        .with_epsilon(1e-4)
        .minimize(jnp.zeros(n, jnp.float32), separable.quadratic(w, t))
    )
    x_star = jnp.sign(t) * jnp.maximum(jnp.abs(t) - c / w, 0.0)
    print(f"owlqn lasso: niter={rep.niter} neval={rep.neval} "
          f"max|x-x*|={float(jnp.max(jnp.abs(rep.x - x_star))):.2e} "
          f"zeros={int(jnp.sum(rep.x == 0.0))}/{n}")

    # a custom body, one screen of code: index-weighted Huber-like loss
    def block(x, gidx, tb):
        r = x - tb
        scale = 1.0 + 0.25 * (gidx % 4).astype(x.dtype)
        a = jnp.abs(r)
        quad = 0.5 * (r * r)
        lin = a - 0.5
        fx_elem = scale * jnp.where(a <= 1.0, quad, lin)
        g = scale * jnp.where(a <= 1.0, r, jnp.sign(r))
        return fx_elem, g

    obj = make_fused_objective(block, extras=(t,))
    rep = (
        lbfgs()
        .with_epsilon(1e-5)
        .with_constrain_step_size(False)
        .minimize(jnp.zeros(n, jnp.float32), obj)
    )
    print(f"huber: fx={rep.fx:.3e} niter={rep.niter} "
          f"max|x-t|={float(jnp.max(jnp.abs(rep.x - t))):.2e}")


if __name__ == "__main__":
    main()
