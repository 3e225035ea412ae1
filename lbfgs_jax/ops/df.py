"""Double-float (two-f32) scalar arithmetic for the objective carry.

The ``fx_wide`` mode restores the reference's f64 objective resolution
(``src/math.rs:4-82``) on top of f32 vector streams.  Its original
implementation carries fx as a REAL f64 scalar — which requires the
process-global ``jax_enable_x64`` flag, changing dtype semantics for all
user code.  This module removes that
requirement: an objective scalar is carried as an UNEVALUATED SUM of two
f32s ``(hi, lo)`` with ``|lo| <= ulp(hi)/2`` — the classic double-float
("double-single") representation — giving ~48 significant bits, far past
what the Armijo sufficient-decrease comparisons need (the n = 1e8 OWL-QN
floor is ULP(4.4e7) = 4 in f32; in df48 it is ~3e-7).

All ops are branch-free error-free transformations (Knuth two-sum,
Dekker split/two-prod — no FMA dependency) and work elementwise on
arrays, so the cross-block partial reduction is a vectorized binary tree.
A df value travels as ONE pytree leaf of shape ``(..., 2)``.

Used by ``fused.obj_*`` when ``params.fx_wide`` is on without x64; the
f64 path is unchanged when x64 is enabled.  Consumed by BOTH search
families: the backtracking Armijo test compares df values directly, and
More-Thuente's mcstep geometry takes the f-value differences through
``sub_f32`` (a df value's sub-ULP information lives entirely in its
differences).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

#: Dekker split factor for f32 (24-bit mantissa -> 12+12 split).
#: A PYTHON float, not a jnp constant: a module-level jax Array captured
#: by a traced closure becomes a LIFTED CONST of the jaxpr, and this
#: environment's jax (0.9.0) drops lifted consts on repeated jit
#: dispatches ("Execution supplied 18 buffers but compiled program
#: expected 19" on the second host-driver propagate — reproduced).
#: Python literals inline into the jaxpr instead.  Weak promotion keeps
#: f32 math exact (4097 is exactly representable).
_SPLIT = 4097.0  # 2^12 + 1


def is_df(v) -> bool:
    """True if ``v`` is a df-carried objective scalar (trailing dim 2)."""
    return (
        getattr(v, "ndim", None) is not None
        and v.ndim >= 1
        and v.shape[-1] == 2
        and v.dtype == jnp.float32
    )


def _two_sum(a: Array, b: Array) -> tuple[Array, Array]:
    """(s, e) with s = fl(a+b) and a + b = s + e EXACTLY (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _two_prod(a: Array, b: Array) -> tuple[Array, Array]:
    """(p, e) with p = fl(a*b) and a*b = p + e exactly (Dekker split)."""
    p = a * b
    ta = a * _SPLIT
    ahi = ta - (ta - a)
    alo = a - ahi
    tb = b * _SPLIT
    bhi = tb - (tb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def _pack(hi: Array, lo: Array) -> Array:
    return jnp.stack([hi, lo], axis=-1)


def from_f(a) -> Array:
    """Lift a plain f32 scalar/array to df (exact)."""
    a = jnp.asarray(a, jnp.float32)
    return _pack(a, jnp.zeros_like(a))


def value(x: Array) -> Array:
    """Collapse to the nearest f32 (hi absorbs lo by construction)."""
    return x[..., 0] + x[..., 1]


def value_f64(x: Array):
    """Host-side exact value (for reports/asserts outside jit)."""
    import numpy as np

    xx = np.asarray(x, np.float64)
    return xx[..., 0] + xx[..., 1]


def add(x: Array, y: Array) -> Array:
    """df + df, renormalized."""
    s, e = _two_sum(x[..., 0], y[..., 0])
    e = e + (x[..., 1] + y[..., 1])
    hi, lo = _two_sum(s, e)
    return _pack(hi, lo)


def add_f(x: Array, b) -> Array:
    """df + plain f32 scalar, renormalized."""
    b = jnp.asarray(b, jnp.float32)
    s, e = _two_sum(x[..., 0], b)
    e = e + x[..., 1]
    hi, lo = _two_sum(s, e)
    return _pack(hi, lo)


def scale(x: Array, c) -> Array:
    """df * plain f32 scalar, renormalized (exact product of hi)."""
    c = jnp.asarray(c, jnp.float32)
    p, e = _two_prod(x[..., 0], c)
    e = e + x[..., 1] * c
    hi, lo = _two_sum(p, e)
    return _pack(hi, lo)


def neg(x: Array) -> Array:
    """-x (exact: both components negate)."""
    return -x


def sub_f32(x: Array, y: Array) -> Array:
    """(x - y) collapsed to f32 — the fine-difference extractor: the
    result keeps sub-ULP(x) resolution because the df subtraction is
    error-free before the single final rounding.  This is what interval
    geometry (mcstep minimizers) consumes: decisions need df compares,
    but step arithmetic only needs the DIFFERENCE at full resolution."""
    return value(add(x, -y))


def gt(x: Array, y: Array) -> Array:
    """x > y on normalized dfs (lexicographic on (hi, lo))."""
    return (x[..., 0] > y[..., 0]) | (
        (x[..., 0] == y[..., 0]) & (x[..., 1] > y[..., 1])
    )


def lt(x: Array, y: Array) -> Array:
    return gt(y, x)


def sum_f32(parts: Array) -> Array:
    """Exact-ish compensated sum of a 1-D f32 array -> df.

    Vectorized binary-tree reduction with a full df add per level
    (log2(n) elementwise passes over halving arrays): every partial sum
    is carried with its error term, so the result matches the f64 sum to
    ~2^-47 relative — the property the wide-fx mode needs from its
    cross-block reduction.  Zero-padding to a power of two is exact.
    """
    n = parts.shape[0]
    size = 1
    while size < n:
        size *= 2
    if size != n:
        parts = jnp.pad(parts, (0, size - n))
    hi = parts.astype(jnp.float32)
    lo = jnp.zeros_like(hi)
    while hi.shape[0] > 1:
        half = hi.shape[0] // 2
        s, e = _two_sum(hi[:half], hi[half:])
        e = e + (lo[:half] + lo[half:])
        hi, lo = _two_sum(s, e)
    return _pack(hi[0], lo[0])
