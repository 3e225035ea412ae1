"""Giant-vector regime demo: Rosenbrock sharded over all local devices.

The reference has no distributed mode; this is the accelerator-native scaling
regime (SURVEY.md §2.3). With 8 virtual CPU devices:

    JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/sharded_giant.py

On a multi-GPU host, run under the default environment; with multiple hosts,
call jax.distributed.initialize() first.
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import jax
import jax.numpy as jnp

from lbfgs_jax import lbfgs
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.parallel import make_mesh, shard_vector


def main():
    ndev = len(jax.devices())
    n = 1 << 22  # scale up freely on real hardware
    print(f"{ndev} devices, n = {n}")

    mesh = make_mesh()
    x0 = shard_vector(rosenbrock.initial_point(n, dtype=jnp.float32), mesh)

    t0 = time.time()
    rep = (
        lbfgs()
        .with_epsilon(1e-3)
        .with_max_iterations(60)
        .minimize_jit(x0, rosenbrock.value_and_grad)
    )
    print(
        f"niter {rep.niter}  fx {rep.fx:.3e}  gnorm {rep.gnorm:.3e}  "
        f"wall {time.time()-t0:.1f}s"
    )


if __name__ == "__main__":
    main()
