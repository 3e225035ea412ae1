"""Scenario-batch benchmark: vmapped independent L-BFGS instances per chip.

The BASELINE.md batch-regime config ("vmapped 10k-instance scenario batch
per chip"): B independent Rosenbrock minimizations advance together inside
one vmapped while_loop.  Metric: instance-iterations/second (sum over the
batch), the throughput number that matters when sweeping thousands of
scenarios.

Prints one JSON line.
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
import numpy as np


def main():
    from lbfgs_jax.batched import _batched_run
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.params import LbfgsParams

    backend = jax.default_backend()
    on_accel = backend not in ("cpu",)
    B = int(os.environ.get("BATCH_B", 10000 if on_accel else 256))
    n = int(os.environ.get("BATCH_N", 64))
    iters = int(os.environ.get("BATCH_ITERS", 30))

    params = LbfgsParams(max_iterations=iters + 1, epsilon=0.0)
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)

    rng = np.random.RandomState(0)
    base = np.asarray(rosenbrock.initial_point(n, jnp.float32))
    x0b = jnp.asarray(
        base[None, :] + 0.05 * rng.randn(B, n).astype(np.float32)
    )

    run = jax.jit(lambda xb: _batched_run(pdef, params, xb))
    st = run(x0b)
    float(st.prob.fx[0])  # sync

    t0 = time.perf_counter()
    st = run(x0b)
    float(st.prob.fx[0])
    dt = time.perf_counter() - t0

    total_iters = int(np.sum(np.asarray(st.k) - 1))
    assert np.all(np.isfinite(np.asarray(st.prob.fx)))
    out = {
        "metric": f"rosenbrock_batch{B}x{n}_instance_iters_per_s",
        "value": round(total_iters / dt, 1),
        "unit": "instance-iters/s",
        "vs_baseline": None,
        "backend": backend,
        "B": B,
        "n": n,
        "iters_per_instance": iters,
        "wall_s": round(dt, 3),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
