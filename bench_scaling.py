"""Scaling-efficiency benchmark: iters/s vs device count on a 1-D mesh.

Measures the BASELINE.md north-star "iterations/s scaling efficiency" on
whatever devices are available: the GPUs of one host, or virtual CPU
devices (set XLA_FLAGS=--xla_force_host_platform_device_count=8) to
exercise the collective path without hardware.  Fixed global problem size
(strong scaling): per-device work shrinks as devices grow while the
two-loop's collective count stays O(1) per iteration.

Prints one JSON line per device count plus an efficiency summary.
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


def run(n: int, iters: int, ndev: int) -> float:
    from lbfgs_jax.minimize import minimize_jit
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.parallel import make_mesh, shard_vector
    from lbfgs_jax.params import LbfgsParams

    params = LbfgsParams(max_iterations=iters + 1, epsilon=0.0)
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    if ndev > 1:
        mesh = make_mesh(jax.devices()[:ndev])
        x0 = shard_vector(x0, mesh)
    # compile + warm
    st = minimize_jit(params, x0, rosenbrock.value_and_grad, return_state=True)
    float(st.prob.fx)
    t0 = time.perf_counter()
    st = minimize_jit(params, x0, rosenbrock.value_and_grad, return_state=True)
    float(st.prob.fx)
    dt = time.perf_counter() - t0
    return (int(st.k) - 1) / dt


def main():
    ndev_all = len(jax.devices())
    n = int(os.environ.get("SCALE_N", 1 << 22))
    iters = int(os.environ.get("SCALE_ITERS", 20))

    counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= ndev_all]
    results = {}
    for c in counts:
        ips = run(n, iters, c)
        results[c] = ips
        eff = ips / (results[1] * c) if 1 in results and c > 1 else 1.0
        print(
            json.dumps(
                {
                    "metric": "scaling_iters_per_s",
                    "devices": c,
                    "value": round(ips, 3),
                    "unit": "iters/s",
                    "efficiency_vs_1dev": round(eff, 3),
                    "n": n,
                    "backend": jax.default_backend(),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
