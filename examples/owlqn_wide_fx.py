"""OWL-QN at scale with the wide (f64) objective-scalar carry.

At large n the L1 term pins |fx| at a magnitude where f32's ~7
significant digits cannot represent the Armijo sufficient-decrease
differences — the search ladders exhaust and the run stalls (PERF.md
round 4: at n = 1e8 plain f32 NEVER reaches the stopping tolerance).
``with_fx_wide()`` keeps every vector stream f32 but carries the
objective scalars as f64 (per-block f32 kernel partials, f64 cross-block
reduction): the same configuration then converges.

Run small on CPU:

    JAX_PLATFORMS=cpu python examples/owlqn_wide_fx.py

Run at scale on a GPU:

    BENCH_N=100000000 python examples/owlqn_wide_fx.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

# wide-fx needs 64-bit scalars enabled BEFORE array creation; vectors
# stay f32 below
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from lbfgs_jax import lbfgs
from lbfgs_jax.models import rosenbrock


def main():
    n = int(os.environ.get("BENCH_N", 1 << 16))
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)

    report = (
        lbfgs()
        .with_orthantwise(1.0, 0, n - 1)
        .with_fx_wide()                    # f64 objective-scalar carry
        .with_history_dtype(
            "bfloat16" if jax.default_backend() != "cpu" else None
        )
        .with_constrain_step_size(False)   # the 2018 step policy
        .with_epsilon(3e-2)
        .with_max_iterations(300)
        .minimize_jit(x0, rosenbrock.value_and_grad)
    )
    print(f"n = {n}")
    print(f"status = {report.status}, iterations = {report.niter}, "
          f"evaluations = {report.neval}")
    print(f"fx = {report.fx!r}  (carried as f64; x stays f32)")
    print(f"scaled ||pg|| = {report.gnorm / max(1.0, report.xnorm):.3e}")


if __name__ == "__main__":
    main()
