"""Orthant-Wise Limited-memory Quasi-Newton (OWL-QN) operators.

Re-design of the reference OWL-QN module
(``src/orthantwise.rs:1-181`` in ybyygu/rust-lbfgs): the reference walks
``[f64]`` slices with scalar loops; here every operator is a fully
vectorized, branch-free elementwise expression over the parameter vector,
with the ``[start, end)`` regularization window realized as a static index
mask.  All ops are embarrassingly shard-local except ``x1norm`` whose sum
lowers to one collective under sharding.

Semantics parity notes (vs. reference):
  * ``signum`` follows the mathematical convention: 0 at 0 and NaN,
    else +/-1 (``src/orthantwise.rs:174-180``).
  * the pseudo-gradient implements Eq. 4 of Andrew & Gao (2007) including
    the subgradient selection at x_i == 0 (``src/orthantwise.rs:82-112``).
  * ``project`` zeroes entries whose sign disagrees with the orthant
    indicator (``src/orthantwise.rs:165-171``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
from jax import Array


@dataclasses.dataclass(frozen=True)
class Orthantwise:
    """OWL-QN configuration: minimize F(x) + c * sum_{i in [start,end)} |x_i|.

    Mirrors the reference parameter struct (``src/orthantwise.rs:19-55``):
    ``c`` defaults to 1.0, ``start`` to 0, ``end=None`` means "up to n".
    """

    c: float = 1.0
    start: int = 0
    end: Optional[int] = None

    def start_end(self, n: int) -> tuple[int, int]:
        """Clamp the window to the vector length (``src/orthantwise.rs:59-67``)."""
        end = n if self.end is None else min(self.end, n)
        if not self.start < end:
            raise ValueError(
                f"invalid start for orthantwise: {self.start} (end = {end})"
            )
        return self.start, end

    def window_mask(self, n: int, dtype=jnp.bool_) -> Array:
        """Boolean mask selecting the regularized index window (static under jit)."""
        start, end = self.start_end(n)
        # i32: an x64-mode default arange is int64 (emulated, ~4x cost)
        idx = jnp.arange(n, dtype=jnp.int32)
        return ((idx >= start) & (idx < end)).astype(dtype)


def signum(x: Array) -> Array:
    """Mathematical sign: 0 at 0 and NaN, else +/-1 (``src/orthantwise.rs:174-180``)."""
    return jnp.where(jnp.isnan(x), jnp.zeros_like(x), jnp.sign(x))


def project(x: Array, y: Array) -> Array:
    """Pi alignment operator: zero x_i where sign(x_i) != sign(y_i).

    Reference ``project`` (``src/orthantwise.rs:165-171``).
    """
    return jnp.where(signum(x) != signum(y), jnp.zeros_like(x), x)


def x1norm(ow: Orthantwise, x: Array) -> Array:
    """c * sum_{i in window} |x_i|  (``src/orthantwise.rs:70-79``).

    Under ``fused.wide_fx`` the reduction runs two-stage (f32 block
    partials, wide total — f64 or double-float per ``fused.wide_mode``)
    so the generic-evaluate L1 term carries the same resolution as the
    factory's OWL-QN trial."""
    from .ops import fused

    mask = ow.window_mask(x.shape[0], dtype=x.dtype)
    # obj_scale (not plain *): a df-carried sum must renormalize the
    # product error, or the L1 term's resolution collapses back to f32
    return fused.obj_scale(fused.obj_sum(jnp.abs(x) * mask), ow.c)


def pseudo_gradient(ow: Orthantwise, x: Array, g: Array) -> Array:
    """Pseudo-gradient of F(x) + c|x| per Andrew & Gao Eq. 4.

    Outside the window pg = g; inside, at differentiable points
    pg = g + sign(x)*c; at x_i == 0 pick the one-sided partial derivative
    that allows descent, else 0 (``src/orthantwise.rs:82-112``).
    """
    c = ow.c
    if c < 0:
        raise ValueError(f"invalid orthantwise param c: {c}")
    mask = ow.window_mask(x.shape[0])

    right = g + c
    left = g - c
    at_zero = jnp.where(right < 0.0, right, jnp.where(left > 0.0, left, 0.0))
    inside = jnp.where(x != 0.0, g + jnp.sign(x) * c, at_zero)
    return jnp.where(mask, inside, g)


def project_line_point(ow: Orthantwise, x: Array, wp: Array) -> Array:
    """Project a trial line-search point onto the chosen orthant ``wp``.

    Reference ``constraint_line_search`` (``src/orthantwise.rs:118-133``):
    projection applies only inside the regularization window.
    """
    mask = ow.window_mask(x.shape[0])
    return jnp.where(mask, project(x, wp), x)


def constrain_direction(ow: Orthantwise, d: Array, pg: Array) -> Array:
    """Constrain the search direction: d <- pi(d; -pg) inside the window.

    Reference ``constrain_search_direction`` (``src/orthantwise.rs:140-161``).
    The reference asserts the result is non-zero; in the jitted build that
    check is carried as a status code by the solver (no exceptions under jit).
    """
    mask = ow.window_mask(d.shape[0])
    return jnp.where(mask, project(d, -pg), d)


def choose_orthant(ow: Orthantwise, xp: Array, pg: Array) -> Array:
    """Choose the orthant indicator for a new point.

    wp_i = sign(xp_i), or sign(-pg_i) where xp_i == 0
    (reference ``Problem::update_orthant_new_point``, ``src/core.rs:167-180``;
    note the reference computes this over the FULL vector, not just the
    window — parity preserved here).
    """
    return jnp.where(xp == 0.0, signum(-pg), signum(xp))
