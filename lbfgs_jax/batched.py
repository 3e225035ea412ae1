"""Scenario-batch regime: vmap the whole solver over problem instances.

The reference solves one problem per call (no parallelism of any kind,
SURVEY.md §2.3); this module is the accelerator-native scaling regime it lacks:
thousands of independent minimizations per chip, the entire
``while_loop``-driver vmapped over the ``SolverState`` pytree.  Instances
that finish early become no-ops inside the batched loop (their state is
frozen by a per-instance select) until all are done.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import Array, lax

from .core import ProblemDef, SolverState, gnorm_of, normalize_objective
from .ops import vecmath as vm
from .params import LbfgsParams
from .solver import init_state, propagate, stop_status
from .status import Status

# jitted batched runs keyed on (objective, params) — see minimize._RUN_CACHE
_BATCH_CACHE: dict = {}


def _batched_run(pdef: ProblemDef, params: LbfgsParams, x0b: Array) -> SolverState:
    def one_init(x0):
        return init_state(pdef, params, x0)

    st0 = jax.vmap(one_init)(x0b)

    def one_active(st: SolverState) -> Array:
        return (st.status == Status.RUNNING) & (
            stop_status(pdef, params, st) == Status.RUNNING
        )

    def cond(stb: SolverState):
        return jnp.any(jax.vmap(one_active)(stb))

    def one_step(st: SolverState) -> SolverState:
        active = one_active(st)
        new = propagate(pdef, params, st)
        # freeze finished instances
        return jax.tree.map(lambda a, b: jnp.where(active, b, a), st, new)

    def body(stb: SolverState):
        return jax.vmap(one_step)(stb)

    stb = lax.while_loop(cond, body, st0)

    def finalize(st: SolverState) -> SolverState:
        final = stop_status(pdef, params, st)
        st = st._replace(
            status=jnp.where(st.status == Status.RUNNING, final, st.status)
        )
        # per-instance vector revert for terminal line-search failures
        # (src/line.rs:213-220) — once at the end, not per iteration
        revert = st.ls_status != 0
        prob = st.prob._replace(
            x=jnp.where(revert, st.prob.xp, st.prob.x),
            gx=jnp.where(revert, st.prob.gp, st.prob.gx),
        )
        if pdef.orthantwise:
            from .core import pseudo_gradient

            prob = prob._replace(pg=pseudo_gradient(pdef, prob.x, prob.gx))
        return st._replace(prob=prob)

    return jax.vmap(finalize)(stb)


def minimize_batched(
    params: LbfgsParams,
    x0_batch,
    evaluate: Callable,
    return_state: bool = False,
):
    """Minimize a [B, n] batch of instances; returns per-instance results.

    ``evaluate`` is a single-instance objective (any supported traceable
    shape); it is vmapped internally.  Returns a dict of stacked results,
    or the raw batched ``SolverState`` when ``return_state``.
    """
    x0_batch = jnp.asarray(x0_batch)
    # in-jit runtime warnings use lax.cond + host callback; under vmap a
    # cond executes both branches, so they must stay out of the batched path
    if params.linesearch.warn_ascent:
        params = params.replace_ls(warn_ascent=False)
    key = (evaluate, params)
    entry = _BATCH_CACHE.get(key)
    if entry is None:
        pdef = ProblemDef(
            value_and_grad=normalize_objective(evaluate, x0_batch[0]),
            owlqn=params.orthantwise,
        )
        run = jax.jit(lambda xb: _batched_run(pdef, params, xb))
        if len(_BATCH_CACHE) > 64:
            _BATCH_CACHE.clear()
        entry = (pdef, run)
        _BATCH_CACHE[key] = entry
    pdef, run = entry
    st = run(x0_batch)
    if return_state:
        return st

    def summarize(s: SolverState):
        return dict(
            fx=s.prob.fx,
            xnorm=vm.norm2(s.prob.x),
            gnorm=gnorm_of(pdef, s.prob),
            neval=s.prob.neval,
            niter=s.k,
            status=s.status,
        )

    out = jax.vmap(summarize)(st)
    out["x"] = st.prob.x
    return out
