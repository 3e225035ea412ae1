"""Objective-agnostic fused-objective factory (``make_fused_objective``).

The reference accepts *any* closure at full speed — its eval boundary is
objective-agnostic (``src/core.rs:119-132``).  This module turns a
per-block objective body

    block_fn(x, gidx, *extra_blocks) -> (fx_elem, g)

into an objective carrying the solver's ``__lbfgs_*__`` protocol: ``x`` is
an ``(R, 128)`` f32 block of the iterate, ``gidx`` the matching ``(R, 128)``
i32 GLOBAL element indices, and ``extra_blocks`` the same-shaped blocks of
any bound per-element operand streams (weights, targets, ...).
``fx_elem`` holds the elementwise objective contributions (structure-masked
so that ``sum(fx_elem)`` over valid elements is the block's fx partial) and
``g`` the gradient block.

The protocol the solver consumes:
  * ``__lbfgs_trial__`` / ``__lbfgs_trial_probe__`` and the OWL-QN
    ``__lbfgs_owlqn_trial__`` / ``__lbfgs_owlqn_probe__``: one
    line-search trial with its byproducts (gg, xx, changed) — plain jnp,
    which XLA fuses into multi-output reduction passes;
  * ``__lbfgs_trial_pair_gram__`` (+ ``_ok__``): the fused
    trial + correction-pair + Gram epilogue, a Pallas kernel through
    Triton (``ops/epilogue.py``) that the solver engages where
    ``_ok__`` holds.

Contract for ``block_fn``:
  * block-local: it sees one ``(R, 128)`` tile at a time; any coupling
    between elements must stay inside a 128-lane row (e.g. Rosenbrock's
    (2i, 2i+1) pairs).
  * pure f32 elementwise math the Triton lowering accepts (no
    ``jnp.roll``: it lowers to a concatenate Triton refuses — reshape
    and split instead, see ``models/rosenbrock._rosen_block``).
  * padded/garbage lanes may flow through it (tail blocks); its outputs
    at invalid lanes are masked by the caller.

Extra operand streams (``extras``) are bound at factory time and flow into
every evaluation.  At large n bind them inside your own ``jit`` (pass the
arrays as arguments and call ``make_fused_objective`` in the traced
function) so they stay operands instead of becoming HLO constants.
"""

from __future__ import annotations

from types import SimpleNamespace

import jax.numpy as jnp
from jax import Array

from . import epilogue, fused


def make_fused_objective(block_fn, value_and_grad=None, *, extras=(),
                         validate=None):
    """Build an objective carrying the ``__lbfgs_*__`` protocol from a
    per-block body.

    Args:
      block_fn: ``(x, gidx, *extra_blocks) -> (fx_elem, g)`` — see module
        docstring.
      value_and_grad: optional plain jnp ``x -> (fx, gx)`` used for every
        non-kernel evaluation.  When None, one is synthesized from
        ``block_fn`` (lane-padded evaluation).
      extras: tuple of ``[n]`` arrays streamed alongside the iterate.
      validate: optional ``validate(n) -> None`` raising on unsupported
        problem sizes (e.g. Rosenbrock's even-n requirement).

    Returns the (possibly synthesized) ``value_and_grad`` callable with the
    protocol attached, plus ``.kernels``, a namespace of the protocol
    functions.
    """
    extras = tuple(extras)
    L = fused.LANES

    if value_and_grad is None:
        def value_and_grad(x):
            """Synthesized jnp evaluation: lane-pad, run the block body
            on the whole array as one tile stack, mask, reduce."""
            n = x.shape[0]
            pad = (-n) % L
            xr = (jnp.pad(x, (0, pad)) if pad else x).reshape(-1, L)
            gidx = jnp.arange(xr.size, dtype=jnp.int32).reshape(xr.shape)
            exb = [
                (jnp.pad(e, (0, pad)) if pad else e).reshape(-1, L)
                for e in extras
            ]
            fx_elem, g = block_fn(xr, gidx, *exb)
            if pad:
                valid = gidx < n
                fx = fused.obj_sum(jnp.where(valid, fx_elem, 0.0).reshape(-1))
                g = g.reshape(-1)[:n]
            else:
                fx = fused.obj_sum(fx_elem.reshape(-1))
                g = g.reshape(-1)
            return fx, g

    vag = value_and_grad

    def _check(n: int) -> None:
        if validate is not None:
            validate(n)

    def trial(xp, d, stp):
        """(xt, fx, g, dg, gg, xx, changed) of one trial xt = xp + stp*d."""
        from . import vecmath as vm

        _check(xp.shape[0])
        xt = xp + stp * d
        fx, g = vag(xt)
        return (xt, fx, g, vm.dot(g, d), vm.dot(g, g), vm.dot(xt, xt),
                jnp.any(xt != xp))

    def probe(xp, d, stp):
        """(ft, dg) of one trial; XLA drops the unused vector outputs."""
        from . import vecmath as vm

        _check(xp.shape[0])
        fx, g = vag(xp + stp * d)
        return fx, vm.dot(g, d)

    def owlqn_trial(xp, d, wp, stp, c, start, end):
        """(xt, fx_incl_L1, g, dg, xx, changed) of one projected trial."""
        from . import vecmath as vm

        _check(xp.shape[0])
        xt = fused.owlqn_trial_step(xp, d, wp, stp, start, end)
        fx, g = vag(xt)
        idx = jnp.arange(xt.shape[0], dtype=jnp.int32)
        l1 = fused.obj_sum(
            jnp.where((idx >= start) & (idx < end), jnp.abs(xt), 0.0)
        )
        return (xt, fused.obj_axpy(c, l1, fx), g, vm.dot(g, d),
                vm.dot(xt, xt), jnp.any(xt != xp))

    def owlqn_probe(xp, d, wp, stp, c, start, end):
        res = owlqn_trial(xp, d, wp, stp, c, start, end)
        return res[1], res[3]

    def trial_pair_gram_ok(xp: Array, S: Array) -> bool:
        try:
            _check(xp.shape[0])
        except ValueError:
            return False
        return epilogue.supported(xp, S, *extras)

    def trial_pair_gram(xp, d, gp, stp, S, Y, end, with_gp=False):
        """Fused trial + pair + Gram epilogue (``ops/epilogue.py``)."""
        return epilogue.trial_pair_gram(
            block_fn, extras, xp, d, gp, stp, S, Y, end, with_gp=with_gp
        )

    ns = SimpleNamespace(
        value_and_grad=vag,
        block_fn=block_fn,
        extras=extras,
        trial=trial,
        probe=probe,
        owlqn_trial=owlqn_trial,
        owlqn_probe=owlqn_probe,
        trial_pair_gram=trial_pair_gram,
        trial_pair_gram_ok=trial_pair_gram_ok,
    )
    vag.__lbfgs_value_and_grad__ = True
    vag.__lbfgs_trial__ = trial
    vag.__lbfgs_trial_probe__ = probe
    vag.__lbfgs_owlqn_trial__ = owlqn_trial
    vag.__lbfgs_owlqn_probe__ = owlqn_probe
    vag.__lbfgs_trial_pair_gram__ = trial_pair_gram
    vag.__lbfgs_trial_pair_gram_ok__ = trial_pair_gram_ok
    vag.kernels = ns
    return vag


def without_epilogue(vag):
    """A copy of a protocol-carrying objective without the fused epilogue,
    so the solver takes the plain XLA path (the comparison the epilogue
    must win to stay)."""
    def plain(x):
        return vag(x)

    for k, v in vars(vag).items():
        if k.startswith("__lbfgs_") and "pair_gram" not in k:
            setattr(plain, k, v)
    return plain
