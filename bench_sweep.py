"""Benchmark sweep across line-search algorithms and history sizes m.

The counterpart of the reference's criterion configuration space
(``benches/rosenbrock.rs`` + BASELINE.json config "Rosenbrock bench sweep
across line searches + history sizes m"): one full Rosenbrock
minimization per configuration, reporting wall time, iterations, and
evaluations.  Prints a JSON line per config (machine-parseable) plus a
summary table.
"""

from __future__ import annotations

import json
import os

# keep the in-jit ascent-warning host callback out of the timed programs
# (benchmarks legitimately quiet runtime warnings)
os.environ.setdefault("LBFGS_NO_RUNTIME_WARN", "1")
import time

import jax

from lbfgs_jax.utils import compile_cache

compile_cache.enable()

import jax.numpy as jnp


def main():
    from lbfgs_jax.minimize import minimize_jit
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.params import LbfgsParams, LineSearchAlgorithm

    backend = jax.default_backend()
    n = int(os.environ.get("SWEEP_N", 100))
    dtype = jnp.float32 if backend != "cpu" else jnp.float64
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)
    x0 = rosenbrock.initial_point(n, dtype=dtype)
    eps = 1e-5 if dtype == jnp.float64 else 1e-3

    rows = []
    for algo in LineSearchAlgorithm.ALL:
        for m in (3, 6, 12):
            params = LbfgsParams(m=m, epsilon=eps, max_iterations=500)
            params = params.replace_ls(algorithm=algo)
            # compile
            minimize_jit(params, x0, rosenbrock.value_and_grad, return_state=True)
            t0 = time.perf_counter()
            st = minimize_jit(params, x0, rosenbrock.value_and_grad, return_state=True)
            fx = float(st.prob.fx)
            dt = time.perf_counter() - t0
            row = {
                "algo": algo,
                "m": m,
                "n": n,
                "niter": int(st.k),
                "neval": int(st.prob.neval),
                "fx": fx,
                "wall_s": round(dt, 4),
                "backend": backend,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    print(f"\n{'algo':<26} {'m':>3} {'niter':>6} {'neval':>6} {'wall_s':>8}")
    for r in rows:
        print(
            f"{r['algo']:<26} {r['m']:>3} {r['niter']:>6} {r['neval']:>6} "
            f"{r['wall_s']:>8.4f}"
        )


if __name__ == "__main__":
    main()
