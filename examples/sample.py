"""Extended-Rosenbrock sample run (reference ``examples/sample.rs``).

N = 100, x0 alternating (-1.2, 1.0), default parameters, printing
per-iteration progress. Run on CPU:

    JAX_PLATFORMS=cpu python examples/sample.py
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

from lbfgs_jax import lbfgs
from lbfgs_jax.models import rosenbrock


def main():
    x0 = rosenbrock.initial_point(100)

    def progress(p):
        print(f"Iteration {p.niter}:")
        print(f"  fx = {p.fx}, x[0] = {float(p.x[0])}, x[1] = {float(p.x[1])}")
        print(f"  xnorm = {p.xnorm}, gnorm = {p.gnorm}, step = {p.step}")
        print()
        return False

    rep = lbfgs().minimize(x0, rosenbrock.value_and_grad, progress)
    print(f"  fx = {rep.fx}, x[0] = {float(rep.x[0])}, x[1] = {float(rep.x[1])}")


if __name__ == "__main__":
    main()
