"""Lennard-Jones cluster relaxation (reference ``examples/lj.rs``).

Relaxes a 38-atom LJ cluster (114 variables) with the default L-BFGS;
the chemistry workload that motivated the reference's gradient-only /
damped modes (reference CHANGELOG v0.0.13-14). Gradient = -forces.

    JAX_PLATFORMS=cpu python examples/lj.py
"""

import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

from lbfgs_jax import lbfgs
from lbfgs_jax.models import lennard_jones


def main():
    x0 = lennard_jones.lj38_positions()
    obj = lennard_jones.make_objective()

    def progress(p):
        print(f"Iteration {p.niter}, Evaluation: {p.neval}")
        print(f"  energy = {p.fx:.6f}, gnorm = {p.gnorm:.6f}, step = {p.step}")
        return False

    rep = lbfgs().with_max_iterations(500).minimize(x0, obj, progress)
    print(f"final energy: {rep.fx:.6f} (LJ38 global minimum is -173.928427)")


if __name__ == "__main__":
    main()
