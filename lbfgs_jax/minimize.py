"""Optimization drivers.

Two execution modes (SURVEY.md §7 architecture point 7):

  * ``minimize`` / ``LbfgsState`` — a host Python loop calling ONE jitted
    ``propagate`` executable per iteration, with host-side Progress
    callbacks and cancellation.  Parity with the reference's
    ``Lbfgs::minimize`` / ``build``-``propagate``-``report`` state machine
    (``src/lbfgs.rs:399-421, 443-499``).  Works with black-box host
    objectives (bridged via io_callback) as well as traceable ones.

  * ``minimize_jit`` — the whole optimization as a single
    ``lax.while_loop`` compiled to one XLA executable: maximum throughput
    for cheap/traceable objectives and the building block for the vmapped
    scenario-batch regime (``batched.py``).

Fatal statuses raise ``LbfgsError`` from the host drivers, mirroring the
reference's ``anyhow`` error propagation out of ``propagate``.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array, lax

from .core import (
    ProblemDef,
    Progress,
    Report,
    SolverState,
    fx_host,
    gnorm_of,
    normalize_objective,
    xnorm_of,
)
from .ops import vecmath as vm
from .params import LbfgsParams
from .solver import init_state, propagate_hot, start_state, stop_status
from .status import LS_ERROR_MESSAGES, LbfgsError, Status, is_fatal, is_ls_error


def _log_stop_status(code: int) -> None:
    """Reference-parity log lines for the stop conditions
    (``src/lbfgs.rs:717, 730, 743, 778``)."""
    if code == Status.CONVERGED:
        logger.info("L-BFGS reaches convergence.")
    elif code == Status.MAX_ITERATIONS:
        logger.warning("max iterations reached!")
    elif code == Status.MAX_EVALUATIONS:
        logger.warning("Max allowed evaluations reached!")

logger = logging.getLogger("lbfgs_jax")


def _make_pdef(params: LbfgsParams, x0: Array, evaluate: Callable) -> ProblemDef:
    vag = normalize_objective(evaluate, x0)
    return ProblemDef(value_and_grad=vag, owlqn=params.orthantwise)


class LbfgsState:
    """Resumable step-at-a-time optimizer state (reference ``LbfgsState``,
    ``src/lbfgs.rs:424-499``).

    The full optimizer state is the ``SolverState`` pytree in ``.state`` —
    checkpoint it with orbax/np.save and rebuild with ``restore``.
    """

    def __init__(self, pdef: ProblemDef, params: LbfgsParams, state: SolverState):
        self.pdef = pdef
        self.params = params
        self.state = state
        self._propagate = jax.jit(
            lambda st: propagate_hot(pdef, params, st), donate_argnums=0
        )
        self._stop = jax.jit(lambda st: stop_status(pdef, params, st))

    @classmethod
    def build(cls, params: LbfgsParams, x0, evaluate: Callable) -> "LbfgsState":
        """Initial evaluation + direction (``Lbfgs::build``, src/lbfgs.rs:443-481)."""
        x0 = jnp.asarray(x0)
        pdef = _make_pdef(params, x0, evaluate)
        if params.damping:
            logger.info("Powell damping Enabled.")
        state = jax.jit(lambda x: init_state(pdef, params, x))(x0)
        return cls(pdef, params, state)

    def restore(self, state: SolverState) -> None:
        """Swap in a checkpointed ``SolverState`` pytree."""
        self.state = state

    # -- reference API ------------------------------------------------------

    def is_converged(self) -> bool:
        """Stop-conditions check on the current state (``src/lbfgs.rs:489-494``).

        The past/delta fx-plateau test (when enabled) is applied inside
        ``propagate`` itself via the carried fx ring (``solver.fx_delta_step``),
        so all three drivers share one implementation."""
        code = int(self._stop(self.state))
        if code != Status.RUNNING and int(self.state.status) == Status.RUNNING:
            self.state = self.state._replace(status=jnp.int32(code))
        if code != Status.RUNNING:
            _log_stop_status(code)
        return code != Status.RUNNING

    def propagate(self) -> Progress:
        """One L-BFGS step; returns per-iteration Progress
        (``src/lbfgs.rs:503-560``).  Raises ``LbfgsError`` on fatal status."""
        if int(self.state.k) == 0:
            # k == 1 reports the initial point without searching
            # (src/lbfgs.rs:507-510) — pure bookkeeping, done on host
            self.state = start_state(self.state, self.params)
        else:
            self.state = self._propagate(self.state)
            ls_code = int(self.state.ls_status)
            if is_ls_error(ls_code):
                # the reference logs at the failure site before reverting
                # (src/line.rs:213-220)
                logger.error("line search failed, revert to the previous point!")
                logger.error("%s", LS_ERROR_MESSAGES.get(Status(ls_code), ls_code))
            if ls_code != 0:
                # vector revert (reference Problem::revert,
                # src/core.rs:201-210).  Done here on the host — the
                # failure is terminal, so the jitted hot path never pays
                # the per-iteration revert selects; the carried scalars
                # (fx/norms/step) were already reverted inside propagate.
                st = self.state
                prob = st.prob._replace(x=st.prob.xp, gx=st.prob.gp)
                if self.pdef.orthantwise:
                    from .core import pseudo_gradient

                    prob = prob._replace(
                        pg=pseudo_gradient(self.pdef, prob.x, prob.gx)
                    )
                self.state = st._replace(prob=prob)
        code = int(self.state.status)
        if is_fatal(code):
            raise LbfgsError(Status(code))
        return self.get_progress()

    def get_progress(self) -> Progress:
        st = self.state
        return Progress(
            x=st.prob.x,
            gx=st.prob.gx,
            fx=fx_host(st.prob.fx),
            xnorm=float(xnorm_of(st.prob)),
            gnorm=float(gnorm_of(self.pdef, st.prob)),
            step=float(st.step_ls),
            niter=int(st.k),
            neval=int(st.prob.neval),
            ncall=int(st.ncall),
        )

    def report(self) -> Report:
        """Final outcome (``src/lbfgs.rs:497-499``, ``src/core.rs:288-298``)."""
        st = self.state
        return Report(
            fx=fx_host(st.prob.fx),
            xnorm=float(xnorm_of(st.prob)),
            gnorm=float(gnorm_of(self.pdef, st.prob)),
            neval=int(st.prob.neval),
            x=st.prob.x,
            niter=int(st.k),
            status=int(st.status),
        )


def minimize(
    params: LbfgsParams,
    x0,
    evaluate: Callable,
    progress: Optional[Callable[[Progress], bool]] = None,
    backend: str = "jax",
) -> Report:
    """Host-loop driver (reference ``Lbfgs::minimize``, ``src/lbfgs.rs:399-421``):

      loop { if converged break; propagate; if progress(prgr) -> cancel }

    The progress callback returning True cancels the optimization.

    ``backend="native"`` routes to the sequential C++ core — the right
    choice for small problems where accelerator dispatch latency dominates
    (and the bit-exact reference-parity path, see PARITY.md).
    """
    if backend == "native":
        return _minimize_native_backend(params, x0, evaluate, progress)
    if backend != "jax":
        raise ValueError(f"unknown backend: {backend!r} (use 'jax' or 'native')")
    state = LbfgsState.build(params, x0, evaluate)
    logger.info("start lbfgs loop...")
    while True:
        if state.is_converged():
            break
        prgr = state.propagate()
        if progress is not None and progress(prgr):
            logger.info("The minimization process has been canceled.")
            state.state = state.state._replace(status=jnp.int32(Status.CANCELLED))
            break
    return state.report()


def _minimize_native_backend(
    params: LbfgsParams,
    x0,
    evaluate: Callable,
    progress: Optional[Callable] = None,
) -> Report:
    """Route to the sequential C++ core, adapting any supported objective
    shape to the mutating-closure ABI."""
    import inspect

    from .native import minimize_native

    # np.array (NOT asarray): on CPU backends np.asarray(jax_array) can be
    # a zero-copy VIEW of the device buffer, and the native core iterates
    # x in place (reference semantics) — without the copy it would
    # silently corrupt the caller's immutable jax x0 (found: a jax re-run
    # after backend="native" started from the already-minimized point)
    x0_np = np.array(x0, dtype=np.float64)

    try:
        nreq = sum(
            1
            for p in inspect.signature(evaluate).parameters.values()
            if p.default is inspect.Parameter.empty
            and p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        )
    except (TypeError, ValueError):
        nreq = 1

    if nreq >= 2:
        closure = evaluate  # already reference-style f(x, gx) -> fx
    else:
        # traceable objective: evaluate via a jitted CPU value-and-grad
        x0j = jnp.asarray(x0_np)
        vag = jax.jit(normalize_objective(evaluate, x0j), backend="cpu")

        def closure(x, g):
            fx, gx = vag(jnp.asarray(x))
            g[...] = np.asarray(gx)
            return float(fx)

    return minimize_native(params, x0_np, closure, progress)


# ---------------------------------------------------------------------------
# Fully-jitted driver
# ---------------------------------------------------------------------------


def _run_while(pdef: ProblemDef, params: LbfgsParams, st0: SolverState) -> SolverState:
    """while !stop: propagate — as one lax.while_loop (traced once).

    The k == 1 bookkeeping step runs once before the loop (keeping it out
    of the loop body avoids per-iteration history copies from branch
    unification), guarded by the same stop check the reference applies
    before every propagate (``src/lbfgs.rs:407-410``)."""

    def cond(st: SolverState):
        running = st.status == Status.RUNNING
        return running & (stop_status(pdef, params, st) == Status.RUNNING)

    def body(st: SolverState):
        return propagate_hot(pdef, params, st)

    st0 = lax.cond(cond(st0), lambda s: start_state(s, params), lambda s: s, st0)
    st = lax.while_loop(cond, body, st0)
    # record why we stopped (fatal statuses already recorded by propagate)
    final = stop_status(pdef, params, st)
    st = st._replace(
        status=jnp.where(st.status == Status.RUNNING, final, st.status)
    )
    # epilogue vector revert for a terminal line-search failure
    # (src/line.rs:213-220): one select pass per RUN instead of two per
    # iteration.  Lean states (xp/gp not carried) skip it — their drivers
    # raise on the fatal status, so the vectors are never observed.
    if st.prob.xp is not None:
        revert = st.ls_status != 0
        prob = st.prob._replace(
            x=jnp.where(revert, st.prob.xp, st.prob.x),
            gx=jnp.where(revert, st.prob.gp, st.prob.gx),
        )
        st = st._replace(prob=prob)
    return st


# jitted whole-run executables keyed on (objective, params): repeated calls
# with identical config reuse the trace/compile instead of paying it again
_RUN_CACHE: dict = {}


def _get_run(params: LbfgsParams, x0: Array, evaluate: Callable):
    # key on the USER objective (normalize_objective may build a fresh
    # wrapper per call, which would always miss)
    key = (evaluate, params)
    entry = _RUN_CACHE.get(key)
    if entry is None:
        pdef = _make_pdef(params, x0, evaluate)
        # lean state: no xp/gp slots -> no per-iteration rotation copies.
        # A line-search failure raises LbfgsError below (reference: Err out
        # of minimize), so the previous point is never observable here.
        run = jax.jit(
            lambda x: _run_while(pdef, params, init_state(pdef, params, x, lean=True))
        )
        if len(_RUN_CACHE) > 64:
            _RUN_CACHE.clear()
        entry = (pdef, run)
        _RUN_CACHE[key] = entry
    return entry


def minimize_jit(
    params: LbfgsParams,
    x0,
    evaluate: Callable,
    return_state: bool = False,
):
    """Whole-minimization-in-one-executable driver.

    Requires a traceable objective.  Returns a ``Report`` (or the raw
    ``SolverState`` pytree when ``return_state``, for composition /
    benchmarking without host sync).
    """
    x0 = jnp.asarray(x0)
    pdef, run = _get_run(params, x0, evaluate)

    st = run(x0)
    if return_state:
        return st
    code = int(st.status)
    if is_fatal(code):
        raise LbfgsError(Status(code))
    _log_stop_status(code)
    return Report(
        fx=fx_host(st.prob.fx),
        xnorm=float(xnorm_of(st.prob)),
        gnorm=float(gnorm_of(pdef, st.prob)),
        neval=int(st.prob.neval),
        x=st.prob.x,
        niter=int(st.k),
        status=code,
    )
