"""lbfgs_jax — a limited-memory quasi-Newton framework in JAX for GPUs.

A JAX/XLA re-design (one Pallas kernel on the hot path) with the
capabilities of the reference
Rust crate ybyygu/rust-lbfgs (``liblbfgs`` v0.2.0):

  * L-BFGS with circular (s, y) history — two-loop recursion as masked
    scans / compact batched matvecs over sharded vectors
  * OWL-QN (orthant-wise L1-regularized quasi-Newton)
  * More-Thuente + backtracking (Armijo / Wolfe / strong Wolfe) line
    searches as jit-compiled ``lax.while_loop``s
  * Powell/Al-Baali damped updates, gradient-only mode
  * builder-pattern config, progress callbacks + cancellation, and a
    resumable (checkpointable) step-at-a-time state machine
  * scaling regimes: giant sharded vectors over a device mesh
    (``parallel``), and vmapped scenario batches (``batched``)

Quick start (mirrors the reference crate doc-example, ``src/lib.rs:8-53``)::

    import jax.numpy as jnp
    from lbfgs_jax import lbfgs, default_evaluate, default_progress

    n = 100
    x0 = jnp.zeros(n).at[0::2].set(-1.2).at[1::2].set(1.0)
    report = (
        lbfgs()
        .with_max_iterations(5)
        # .with_orthantwise(1.0, 0, 99)  # enable OWL-QN
        .minimize(x0, default_evaluate(), default_progress())
    )
    print(report.fx)
"""

from __future__ import annotations

from .core import ProblemDef, Progress, Report
from .orthantwise import Orthantwise
from .params import Lbfgs, LbfgsParams, LineSearchAlgorithm, LineSearchParams, lbfgs
from .pytree_api import minimize_pytree
from .status import LbfgsError, Status

__version__ = "0.1.0"


def default_evaluate():
    """Extended-Rosenbrock objective (reference ``default_evaluate``,
    ``src/lib.rs:79-94``)."""
    from .models.rosenbrock import value_and_grad

    return value_and_grad


def default_progress():
    """Printing progress monitor (reference ``default_progress``,
    ``src/lib.rs:102-112``). Returning True cancels the optimization."""

    def progress(prgr: Progress) -> bool:
        print(f"Iteration {prgr.niter}, Evaluation {prgr.neval}:")
        print(
            f" fx = {prgr.fx:-12.6f} xnorm = {prgr.xnorm:-12.6f}, "
            f"gnorm = {prgr.gnorm:-12.6f}, ls = {prgr.ncall}, step = {prgr.step}"
        )
        return False

    return progress


__all__ = [
    "Lbfgs",
    "LbfgsError",
    "LbfgsParams",
    "LineSearchAlgorithm",
    "LineSearchParams",
    "Orthantwise",
    "ProblemDef",
    "Progress",
    "Report",
    "Status",
    "default_evaluate",
    "default_progress",
    "lbfgs",
    "minimize_pytree",
]
