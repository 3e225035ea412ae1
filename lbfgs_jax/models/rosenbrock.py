"""Extended Rosenbrock objective (the reference's default/benchmark problem).

Per-pair form with a = 1, b = 10 (squared inside), exactly matching the
reference ``default_evaluate`` (``src/lib.rs:79-94``; also
``examples/sample.rs:26-41`` and ``benches/rosenbrock.rs:16-29``):

    for even i:  t1 = 1 - x_i;  t2 = 10*(x_{i+1} - x_i^2)
                 g_{i+1} = 20*t2;  g_i = -2*(x_i*g_{i+1} + t1)
                 fx += t1^2 + t2^2

The fused protocol (``ops/factory.make_fused_objective``) is generated
from the single per-block body ``_rosen_block`` below; the plain
``_plain_value_and_grad`` serves every jnp evaluation.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from ..ops import factory, fused


def _plain_value_and_grad(x: Array) -> tuple[Array, Array]:
    """Whole-vector evaluation with one left/right rotate and a parity
    mask — elementwise work plus one reduction that XLA fuses.  At every
    even position i the pair (x_i, x_{i+1}) is visible as
    (x, roll(x, -1)); gradient values for odd positions are produced at
    the even position and rotated into place."""
    n = x.shape[0]
    _check_even(n)
    # explicit i32: under jax_enable_x64 (the wide-fx config) a default
    # arange is int64, which doubles the mask's integer work
    even = (jnp.arange(n, dtype=jnp.int32) % 2) == 0
    x_next = jnp.roll(x, -1)  # x_{i+1} at position i (valid at even i)
    t1 = 1.0 - x
    t2 = 10.0 * (x_next - x * x)
    go = 20.0 * t2              # g_{i+1}, computed at even position i
    ge = -2.0 * (x * go + t1)   # g_i, at even position i
    # obj_sum: two-stage (f32 block partials, f64 total) under wide_fx,
    # plain jnp.sum otherwise — keeps this path's objective resolution
    # consistent with the fused epilogue's
    fx = fused.obj_sum(jnp.where(even, t1 * t1 + t2 * t2, 0.0))
    g = jnp.where(even, ge, jnp.roll(go, 1))
    return fx, g


def _check_even(n: int) -> None:
    if n % 2:
        # the pair form is defined for even n only; the reference panics on
        # odd n (index out of bounds in the pair loop) — fail loudly too
        raise ValueError(f"extended Rosenbrock requires even n, got {n}")


def _rosen_block(x: Array, gidx: Array) -> tuple[Array, Array]:
    """Per-(R, 128)-block Rosenbrock body for the factory.

    The pair structure (2i, 2i+1) never crosses a 128-lane row because
    128 is even and rows start at even indices, so a reshape to
    ``[R, 64, 2]`` and a split along the last axis expose each pair
    (a rotate would lower to a concatenate that the Triton route
    refuses).  Per element the arithmetic is the same as
    ``_plain_value_and_grad``'s."""
    del gidx
    R, L = x.shape
    xe, xo = jnp.split(x.reshape(R, L // 2, 2), 2, axis=-1)
    t1 = 1.0 - xe
    t2 = 10.0 * (xo - xe * xe)
    go = 20.0 * t2              # g_{i+1}
    ge = -2.0 * (xe * go + t1)  # g_i
    fe = t1 * t1 + t2 * t2
    join = lambda a, b: jnp.concatenate([a, b], axis=-1).reshape(R, L)
    return join(fe, jnp.zeros_like(fe)), join(ge, go)


value_and_grad = factory.make_fused_objective(
    _rosen_block, _plain_value_and_grad, validate=_check_even
)


def initial_point(n: int, dtype=jnp.float64) -> Array:
    """x0 alternating (-1.2, 1.0) (``examples/sample.rs:13-17``)."""
    x = jnp.zeros((n,), dtype)
    x = x.at[0::2].set(-1.2)
    x = x.at[1::2].set(1.0)
    return x
