"""BLAS-1 style vector primitives for the L-BFGS framework.

The counterpart of the reference math backend (``src/math.rs:4-82`` in
ybyygu/rust-lbfgs): the reference implements 8 sequential scalar ops over
``[f64]`` slices; here every op is a ``jnp`` expression that XLA fuses and —
under ``jax.sharding`` — lowers to shard-local compute plus a single
``psum``-style collective for the reductions (``dot``, ``norm2``).

These wrappers exist for three reasons:
  * a single place to pin reduction precision/semantics,
  * parity documentation against the reference op set,
  * a seam where hand-written kernels can be swapped in
    (see ``ops/epilogue.py``).

Functional style: every op returns a new array (XLA buffer donation makes
this in-place at runtime); the reference's in-place mutation has no other
analog here.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
from jax import Array

#: matmul/dot precision for the solver's reductions.  On an H100, XLA
#: runs the f32 Gram and two-loop contractions under "default" as TF32
#: tensor-core fusions (Gram entries ~2e-4 relative to f64) and under
#: "highest" as cuBLAS f32 GEMMs that first widen the bf16 history in a
#: separate pass; "highest" measured 1.7x slower per iteration and 1.8x
#: slower to epsilon at n = 2^24 for the same iteration count (PERF.md),
#: so "default" stays.  On the CPU both are exact f32.  Override with
#: LBFGS_PRECISION=highest for bitwise-stable parity work.
PRECISION = os.environ.get("LBFGS_PRECISION", "default")


def axpy(y: Array, x: Array, c) -> Array:
    """y + c*x  (reference ``vecadd``, src/math.rs:33-37)."""
    return y + c * x


def dot(x: Array, y: Array) -> Array:
    """x . y  (reference ``vecdot``, src/math.rs:40-42).

    Under a sharded layout this lowers to a shard-local partial reduce and
    one all-reduce over the vector axis.
    """
    return jnp.dot(x, y, precision=PRECISION)


def scale(y: Array, c) -> Array:
    """c*y  (reference ``vecscale``, src/math.rs:45-49)."""
    return y * c


def copy(x: Array) -> Array:
    """identity; functional stand-in for ``veccpy`` (src/math.rs:52-56)."""
    return x


def ncopy(x: Array) -> Array:
    """-x  (reference ``vecncpy``, src/math.rs:59-63)."""
    return -x


def diff(x: Array, y: Array) -> Array:
    """x - y  (reference ``vecdiff``, src/math.rs:66-70)."""
    return x - y


def norm2(x: Array) -> Array:
    """||x||_2  (reference ``vec2norm``, src/math.rs:73-76)."""
    return jnp.sqrt(dot(x, x))


def norm2inv(x: Array) -> Array:
    """1/||x||_2  (reference ``vec2norminv``, src/math.rs:79-81)."""
    return 1.0 / norm2(x)
