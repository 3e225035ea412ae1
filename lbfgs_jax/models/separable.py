"""Separable objective family — factory-generated protocol.

Demonstrates (and ships) the objective-agnostic factory
(``ops/factory.make_fused_objective``): each constructor below supplies
ONLY a per-block math body and gets the complete protocol — trial,
probe, OWL-QN trial/probe and the fused trial + pair + Gram epilogue
(incl. the damped ``with_gp`` column) — with zero bespoke kernel code.
This is the answer to the reference's objective-agnostic eval boundary
(``src/core.rs:119-132``): any separable f(x) = sum_i phi(x_i, ...)
runs the same path as the Rosenbrock flagship.

For extra per-element operand streams (weights, targets): bind inside
your own ``jit`` at large n so the arrays stay operands rather than HLO
constants (see the factory docstring).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from ..ops import factory, fused


def quadratic(w: Array, t: Array):
    """Weighted separable quadratic  fx = 1/2 * sum_i w_i (x_i - t_i)^2.

    ``w`` (per-element weights, the diagonal Hessian) and ``t`` (targets)
    stream into every evaluation as bound extras.  With OWL-QN this is the
    diagonal-LASSO problem  min 1/2 ||x - t||_W^2 + c |x|_1, whose exact
    solution is the W-scaled soft-threshold of t — used as an analytic
    oracle in tests.
    """
    w = jnp.asarray(w)
    t = jnp.asarray(t)

    def value_and_grad(x: Array):
        r = x - t
        return fused.obj_sum(0.5 * (w * (r * r))), w * r

    def block(x, gidx, wb, tb):
        r = x - tb
        return 0.5 * (wb * (r * r)), wb * r

    return factory.make_fused_objective(block, value_and_grad,
                                        extras=(w, t))


def sphere():
    """fx = 1/2 ||x||^2 — the minimal separable body (no extras, and the
    jnp fallback is SYNTHESIZED by the factory from the block itself)."""

    def block(x, gidx):
        return 0.5 * (x * x), x

    return factory.make_fused_objective(block)


def scaled_quartic(w: Array):
    """fx = sum_i w_i (x_i^2/2 + x_i^4/4): a non-quadratic separable body
    with one extra stream — exercises curvature the history actually has
    to learn (unlike ``sphere``, which converges in one step)."""
    w = jnp.asarray(w)

    def value_and_grad(x: Array):
        x2 = x * x
        return (
            fused.obj_sum(w * (0.5 * x2 + 0.25 * (x2 * x2))),
            w * (x + x2 * x),
        )

    def block(x, gidx, wb):
        x2 = x * x
        return wb * (0.5 * x2 + 0.25 * (x2 * x2)), wb * (x + x2 * x)

    return factory.make_fused_objective(block, value_and_grad, extras=(w,))
