"""Objective-scalar representation and the solver's elementwise helpers.

The reference is f64 throughout (``src/math.rs:4-82``,
``src/orthantwise.rs:70-79``); this build streams f32 vectors for
bandwidth, which caps the OBJECTIVE SCALAR's resolution at ~7 digits.  At
the n = 1e8 OWL-QN scale the L1 term pins fx at ~4e7, where f32 cannot
represent the per-step Armijo sufficient-decrease differences and the
search stalls.  The fix (``params.fx_wide``): every vector stream stays
f32, objective reductions produce per-block f32 partial sums (each over a
few thousand elements, so each partial is full f32 precision at its own
scale) and the cross-block total runs wide — O(n / block) scalar work.

The mode is trace-time static: the solver enters ``wide_fx(params.fx_wide)``
around its traced bodies, and reductions read ``wide_fx_active()`` to pick
the representation (``wide_mode``).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax import Array

#: minor dimension of the history's lane-aligned storage and of the
#: per-block objective bodies (``ops/factory.py``)
LANES = 128


# ---------------------------------------------------------------------------
# Wide (f64) objective-scalar mode
# ---------------------------------------------------------------------------

_WIDE_FX: list = []


class wide_fx:
    """Context manager: objective scalars reduce/carry wide inside."""

    def __init__(self, enabled: bool = True):
        self._enabled = bool(enabled)

    def __enter__(self):
        _WIDE_FX.append(self._enabled)
        return self

    def __exit__(self, *exc):
        _WIDE_FX.pop()
        return False


def wide_fx_active() -> bool:
    if os.environ.get("LBFGS_WIDE_FX"):
        return True
    return bool(_WIDE_FX and _WIDE_FX[-1])


def wide_mode() -> str:
    """How the wide objective scalar is represented: ``'off'`` (vector
    dtype), ``'f64'`` (real f64 scalars — requires ``jax_enable_x64``),
    or ``'df32'`` (double-float two-f32 carry, ``ops/df.py`` — no global
    flag needed; ~48-bit resolution).  Chosen from the x64 config so
    ``params.fx_wide`` works in any process without changing dtype
    semantics for the caller's own code."""
    if not wide_fx_active():
        return "off"
    return "f64" if jax.config.jax_enable_x64 else "df32"


def obj_reduce(parts: Array, vdtype) -> Array:
    """Cross-block reduction of per-block objective partials in the
    objective representation."""
    mode = wide_mode()
    if mode == "df32":
        from . import df

        return df.sum_f32(parts)
    if mode == "f64":
        return jnp.sum(parts.astype(jnp.float64))
    return jnp.sum(parts.astype(jnp.dtype(vdtype)))


def obj_sum(v: Array) -> Array:
    """Full-vector objective reduction: f32 block partials with a wide
    cross-block total under wide_fx (the resolution the evaluate boundary,
    reference ``src/core.rs:119-132``, needs at scale); a plain
    single-stage sum otherwise."""
    if not wide_fx_active():
        return jnp.sum(v)
    B = 2048
    n = v.shape[0]
    pad = (-n) % B
    if pad:
        v = jnp.pad(v, (0, pad))
    parts = v.reshape(-1, B).sum(axis=1)
    return obj_reduce(parts, v.dtype)


# -- representation-generic scalar algebra on objective values -------------
# Every objective-scalar expression outside the reductions goes through
# these (plain arithmetic would broadcast ELEMENTWISE over a df's (hi, lo)
# pair, silently discarding the error term); under 'off'/'f64' they reduce
# to the ordinary expressions.


def _is_df_val(v) -> bool:
    from . import df

    return df.is_df(v)


def obj_lift(fx):
    """Lift a plain objective scalar into the active representation
    (identity when it already is one, e.g. out of ``obj_sum``)."""
    mode = wide_mode()
    if mode == "f64":
        return jnp.asarray(fx, jnp.float64)
    if mode == "df32":
        from . import df

        return fx if _is_df_val(fx) else df.from_f(fx)
    return fx


def obj_add(a, b):
    """a + b on objective values."""
    if _is_df_val(a) or _is_df_val(b):
        from . import df

        if not _is_df_val(a):
            return df.add_f(b, a)
        if not _is_df_val(b):
            return df.add_f(a, b)
        return df.add(a, b)
    return a + b


def obj_scale(a, c):
    """c * a on an objective value (c: plain scalar)."""
    if _is_df_val(a):
        from . import df

        return df.scale(a, c)
    return c * a


def obj_axpy(c, a, b):
    """b + c * a on objective values (the fx + c*L1 composition)."""
    if _is_df_val(a) or _is_df_val(b):
        return obj_add(b, obj_scale(a, c))
    if jnp.result_type(b) == jnp.float64:
        return b + jnp.float64(c) * a
    return b + jnp.asarray(c, jnp.result_type(b)) * a


def obj_float(fx):
    """Collapse an objective value to a plain scalar (pf ring, host
    reports); f64 passes through, df collapses to its nearest f32."""
    if _is_df_val(fx):
        from . import df

        return df.value(fx)
    return fx


# ---------------------------------------------------------------------------
# Elementwise helpers (XLA fuses each into its consumers)
# ---------------------------------------------------------------------------


def _msign(v):
    """signum with the math convention 0 at 0/NaN."""
    return jnp.where(jnp.isnan(v), jnp.zeros_like(v), jnp.sign(v))


def owlqn_trial_step(xp, d, wp, stp, start, end):
    """x = project(xp + stp*d, wp) inside the [start, end) window — the
    OWL-QN line-search trial point (reference ``take_line_step``,
    ``src/core.rs:155-164``, ``src/orthantwise.rs:82-171``)."""
    x = xp + stp * d
    idx = jnp.arange(x.shape[0], dtype=jnp.int32)
    mask = (idx >= start) & (idx < end)
    projected = jnp.where(_msign(x) != _msign(wp), jnp.zeros_like(x), x)
    return jnp.where(mask, projected, x)

