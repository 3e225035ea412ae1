"""Line searches as jit-compiled ``lax.while_loop``s.

Re-design of the reference line-search layer (``src/line.rs``):
the reference drives a mutable ``Problem`` through Rust loops with
``bail!``-style exceptions; here each search is a single pure
``lax.while_loop`` whose carry holds the six interval scalars, the trial
point/gradient vectors, and an integer status (no exceptions under jit —
every ``bail!`` path of the reference maps to a ``Status`` code, see
``status.py``).  One loop trip == one objective evaluation, identical to the
reference's evaluation pattern.

Parity-preserved quirks (each cited):
  * the loop bound is ``for count in 1..max_linesearch`` — i.e. at most
    ``max_linesearch - 1`` trials, then the search *succeeds* returning
    ``max_linesearch`` (``src/line.rs:258,739,395-398``).
  * More-Thuente's first convergence test returns on the curvature
    condition alone; the combined branch after it is unreachable
    (``src/line.rs:315-321``).
  * the ``gradient_only`` early exit tests ``|dg| <= -gtol*|dginit|`` which
    is unsatisfiable unless dginit == 0 (``src/line.rs:768-774``).
  * ``uinfo`` can never become nonzero (mcstep either succeeds with 0 or
    errors out), but the reference's ``uinfo != 0`` guards are kept.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array, lax

from . import orthantwise as ow_ops
from .core import ProblemDef, evaluate
from .ops import vecmath as vm
from .params import LineSearchAlgorithm, LineSearchParams
from .status import Status

import logging
import os

logger = logging.getLogger("lbfgs_jax")


def _warnings_enabled() -> bool:
    """Trace-time gate for in-jit runtime warnings (ascent direction):
    disabled via LBFGS_NO_RUNTIME_WARN=1 (e.g. for benchmarks) or when
    the package logger would drop WARNING records anyway."""
    if os.environ.get("LBFGS_NO_RUNTIME_WARN"):
        return False
    return logger.isEnabledFor(logging.WARNING)


# ---------------------------------------------------------------------------
# mcstep: safeguarded trial value & interval-of-uncertainty update
# ---------------------------------------------------------------------------


def _cubic_minimizer(u, fu, du, v, fv, dv):
    """Minimizer of the cubic interpolating (u, fu, du), (v, fv, dv).

    Reference ``cubic_minimizer`` (``src/line.rs:620-637``).
    """
    return _cubic_minimizer_d(u, fu - fv, du, v, dv)


def _cubic_minimizer_d(u, dfuv, du, v, dv):
    """Difference-parameterized form: ``dfuv = fu - fv``.  The f-values
    enter the geometry ONLY through this difference, so the df32 wide
    carry can feed the sub-ULP-resolved ``df.sub_f32`` here while the
    plain/f64 paths pass the ordinary subtraction (bitwise-identical to
    the inline expression)."""
    d = v - u
    theta = dfuv * 3.0 / d + du + dv
    s = jnp.maximum(jnp.maximum(jnp.abs(theta), jnp.abs(du)), jnp.abs(dv))
    a = theta / s
    gamma = s * jnp.sqrt(a * a - (du / s) * (dv / s))
    gamma = jnp.where(v < u, -gamma, gamma)
    p = gamma - du + theta
    q = gamma - du + gamma + dv
    r = p / q
    return u + r * d


def _cubic_minimizer2(u, fu, du, v, fv, dv, xmin, xmax):
    """Clamped cubic minimizer (``src/line.rs:652-680``)."""
    return _cubic_minimizer2_d(u, fu - fv, du, v, dv, xmin, xmax)


def _cubic_minimizer2_d(u, dfuv, du, v, dv, xmin, xmax):
    d = v - u
    theta = dfuv * 3.0 / d + du + dv
    s = jnp.maximum(jnp.maximum(jnp.abs(theta), jnp.abs(du)), jnp.abs(dv))
    a = theta / s
    gamma = s * jnp.sqrt(jnp.maximum(0.0, a * a - (du / s) * (dv / s)))
    gamma = jnp.where(u < v, -gamma, gamma)
    p = gamma - dv + theta
    q = gamma - dv + gamma + du
    r = p / q
    cm = jnp.where(
        (r < 0.0) & (gamma != 0.0),
        v - r * d,
        jnp.where(v > u, xmax, xmin),
    )
    return cm


def _quad_minimizer(u, fu, du, v, fv):
    """Quadratic (function-value) minimizer (``src/line.rs:692-695``)."""
    return _quad_minimizer_d(u, fu - fv, du, v)


def _quad_minimizer_d(u, dfuv, du, v):
    a = v - u
    return u + du / (dfuv / a + du) / 2.0 * a


def _quad_minimizer2(u, du, v, dv):
    """Quadratic (secant) minimizer (``src/line.rs:706-709``)."""
    a = u - v
    return v + dv / (dv - du) * a


class McstepResult(NamedTuple):
    x: Array
    fx: Array
    dx: Array
    y: Array
    fy: Array
    dy: Array
    t: Array
    brackt: Array
    status: Array  # 0 on success; LS_* code on error


def update_trial_interval(x, fx, dx, y, fy, dy, t, ft, dt, tmin, tmax, brackt) -> McstepResult:
    """Branch-free port of MCSTEP (reference ``mcstep::update_trial_interval``,
    ``src/line.rs:446-606``): 4-case cubic/quadratic trial selection, interval
    endpoint update, [tmin, tmax] clipping and the 0.66 far-endpoint
    safeguard.  All four candidate trial values are computed unconditionally
    (scalar work; NaN/inf in unselected branches is discarded by the selects).

    Function values (fx/fy/ft) keep their own dtype — f64 under the
    solver's wide-fx mode while the step/derivative scalars stay in the
    vector dtype (the interval geometry needs no extra resolution; the
    f-value COMPARISONS do).
    """
    from .ops import df as _df

    wide_df = _df.is_df(fx)
    dtype = jnp.result_type(t)
    fdt = jnp.result_type(fx, fy, ft)
    zero = jnp.zeros((), dtype)

    dsign = dt * (dx / jnp.abs(dx)) < 0.0

    # input validation (only when already bracketed), src/line.rs:470-481
    err = jnp.where(
        brackt & ((t <= jnp.minimum(x, y)) | (jnp.maximum(x, y) <= t)),
        jnp.int32(Status.LS_OUT_OF_INTERVAL),
        jnp.int32(0),
    )
    err = jnp.where(
        brackt & (err == 0) & (0.0 <= dx * (t - x)),
        jnp.int32(Status.LS_INCREASE_GRADIENT),
        err,
    )
    err = jnp.where(
        brackt & (err == 0) & (tmax < tmin),
        jnp.int32(Status.LS_INVALID_INTERVAL),
        err,
    )

    if wide_df:
        # decisions via lexicographic df compares; geometry via the
        # sub-ULP-resolved collapsed DIFFERENCES (see _cubic_minimizer_d)
        case1 = _df.lt(fx, ft)
        d_fx_ft = _df.sub_f32(fx, ft)
        d_ft_fy = _df.sub_f32(ft, fy)
    else:
        case1 = fx < ft
        d_fx_ft = fx - ft
        d_ft_fy = ft - fy
    case2 = (~case1) & dsign
    case3 = (~case1) & (~dsign) & (jnp.abs(dt) < jnp.abs(dx))
    # case4 = the rest

    mc = _cubic_minimizer_d(x, d_fx_ft, dx, t, dt)
    mq1 = _quad_minimizer_d(x, d_fx_ft, dx, t)
    newt1 = jnp.where(
        jnp.abs(mc - x) < jnp.abs(mq1 - x), mc, mc + 0.5 * (mq1 - mc)
    )

    mq2 = _quad_minimizer2(x, dx, t, dt)
    newt2 = jnp.where(jnp.abs(mc - t) > jnp.abs(mq2 - t), mc, mq2)

    mc3 = _cubic_minimizer2_d(x, d_fx_ft, dx, t, dt, tmin, tmax)
    newt3 = jnp.where(
        brackt,
        jnp.where(jnp.abs(t - mc3) < jnp.abs(t - mq2), mc3, mq2),
        jnp.where(jnp.abs(t - mc3) > jnp.abs(t - mq2), mc3, mq2),
    )

    newt4 = jnp.where(
        brackt,
        _cubic_minimizer_d(t, d_ft_fy, dt, y, dy),
        jnp.where(x < t, tmax, tmin),
    )

    newt = jnp.where(case1, newt1, jnp.where(case2, newt2, jnp.where(case3, newt3, newt4)))
    bound = case1 | case3
    brackt_new = brackt | case1 | case2

    # interval-of-uncertainty update (src/line.rs:555-579)
    take_t_as_x = ~case1  # cases b & c: x <- t
    y_new = jnp.where(case1, t, jnp.where(dsign, x, y))
    fy_new = jnp.where(case1, ft, jnp.where(dsign, fx, fy))
    dy_new = jnp.where(case1, dt, jnp.where(dsign, dx, dy))
    x_new = jnp.where(take_t_as_x, t, x)
    fx_new = jnp.where(take_t_as_x, ft, fx)
    dx_new = jnp.where(take_t_as_x, dt, dx)

    newt = jnp.clip(newt, tmin, tmax)

    # far-endpoint 0.66 safeguard (src/line.rs:591-600)
    mq_s = x_new + 0.66 * (y_new - x_new)
    newt_safe = jnp.where(
        x_new < y_new, jnp.minimum(newt, mq_s), jnp.maximum(newt, mq_s)
    )
    newt = jnp.where(brackt_new & bound, newt_safe, newt)

    return McstepResult(
        x=x_new.astype(dtype),
        fx=fx_new if wide_df else fx_new.astype(fdt),
        dx=dx_new.astype(dtype),
        y=y_new.astype(dtype),
        fy=fy_new if wide_df else fy_new.astype(fdt),
        dy=dy_new.astype(dtype),
        t=newt.astype(dtype),
        brackt=brackt_new,
        status=err,
    )


# ---------------------------------------------------------------------------
# Shared line-search result container
# ---------------------------------------------------------------------------


class LineSearchResult(NamedTuple):
    x: Array       #: evaluated trial point of the accepted (or last) step [n]
    fx: Array      #: objective there (incl. OWL-QN L1)
    gx: Array      #: gradient there [n]
    step: Array    #: accepted step length
    ncall: Array   #: number of objective evaluations used (i32)
    neval: Array   #: updated global evaluation counter (i32)
    status: Array  #: 0 success; LS_* on internal error (i32)
    gg: Array = None       #: gx . gx at the returned point (None under
                           #: OWL-QN, where the caller needs ||pg|| instead)
    xx: Array = None       #: x . x at the returned point
    changed: Array = None  #: any(x != xp); None when the objective has no
                           #: fused trial (caller falls back to the snorm
                           #: check for x-not-changed)
    #: the step that actually PRODUCED x.  Differs from ``step`` exactly on
    #: loop-exhaustion exits, where the reference leaves the caller's stp
    #: at the next (never evaluated) proposal (src/line.rs:777,395-398) —
    #: ``step`` keeps that reporting parity; pair updates that reconstruct
    #: s = step*d must use THIS one.
    step_eval: Array = None


def _take_line_step(pdef: ProblemDef, xp: Array, d: Array, stp: Array, wp: Array) -> Array:
    """x = xp + stp * d, orthant-projected under OWL-QN
    (reference ``Problem::take_line_step``, ``src/core.rs:155-164``).

    XLA fuses the jnp ops into the evaluation that consumes x."""
    if pdef.orthantwise:
        from .ops import fused

        start, end = pdef.owlqn.start_end(xp.shape[0])
        return fused.owlqn_trial_step(xp, d, wp, stp, start, end)
    return xp + stp * d


def _has_fused_trial(pdef: ProblemDef) -> bool:
    return (
        getattr(pdef.value_and_grad, "__lbfgs_trial__", None) is not None
        and not pdef.orthantwise
    )


def _has_fused_owlqn_trial(pdef: ProblemDef) -> bool:
    """The OWL-QN analog of ``_has_fused_trial``: the objective provides a
    one-pass projected trial (``__lbfgs_owlqn_trial__``: projection +
    objective + windowed L1 + dg/xx/changed, reference take_line_step +
    evaluate, ``src/core.rs:119-132,155-164``)."""
    return (
        pdef.orthantwise
        and getattr(pdef.value_and_grad, "__lbfgs_owlqn_trial__", None) is not None
    )


def _owlqn_trial_args(pdef: ProblemDef, n: int):
    start, end = pdef.owlqn.start_end(n)
    return pdef.owlqn.c, start, end


def _owlqn_trial(pdef: ProblemDef, xp: Array, d: Array, stp: Array, wp: Array):
    """(xt, ft_incl_L1, gt, dg, xx, changed) via the fused OWL-QN trial."""
    c, start, end = _owlqn_trial_args(pdef, xp.shape[0])
    return pdef.value_and_grad.__lbfgs_owlqn_trial__(xp, d, wp, stp, c, start, end)


def _probe(pdef: ProblemDef, xp: Array, d: Array, stp: Array, wp: Array = None):
    """(ft, dg) of one trial WITHOUT materializing the trial point or
    gradient — the per-trip body of the rematerializing searches.  The
    Armijo/Wolfe/curvature decisions consume only these two scalars, so a
    probe reads xp and d and writes nothing (XLA drops the unused trial
    outputs of the objective's ``__lbfgs_trial_probe__``); otherwise it
    falls back to the full trial (same scalars, wasted writes).
    Under OWL-QN (wp given) the projected-trial probe protocol applies."""
    if pdef.orthantwise:
        c, start, end = _owlqn_trial_args(pdef, xp.shape[0])
        probe = getattr(pdef.value_and_grad, "__lbfgs_owlqn_probe__", None)
        if probe is not None:
            return probe(xp, d, wp, stp, c, start, end)
        res = pdef.value_and_grad.__lbfgs_owlqn_trial__(xp, d, wp, stp, c, start, end)
        return res[1], res[3]
    probe = getattr(pdef.value_and_grad, "__lbfgs_trial_probe__", None)
    if probe is not None:
        return probe(xp, d, stp)
    res = pdef.value_and_grad.__lbfgs_trial__(xp, d, stp)
    return res[1], res[3]


def _trial(pdef: ProblemDef, xp: Array, d: Array, stp: Array, wp: Array):
    """One line-search trial: xt = step(xp, d, stp), (ft, gt) = f(xt),
    dg = gt . d  — the per-eval inner body shared by both searches
    (reference ``take_line_step`` + ``evaluate`` + the dg dot,
    ``src/line.rs:285-290, 740-744``).

    Objectives may provide a fused single-pass implementation via the
    ``__lbfgs_trial__`` protocol (``ops/factory.py``), returning additionally (gg, xx, changed) =
    (gt.gt, xt.xt, any(xt != xp)) as free byproducts of the pass; the
    searches carry those so the solver's stop conditions and
    x-not-changed check never re-read the vectors.  The protocol is used
    whenever OWL-QN is off (under OWL-QN the trial point is
    orthant-projected and fx carries the L1 term, so the generic path
    applies).  Generic returns 4 values; extras are computed post-loop."""
    if _has_fused_trial(pdef):
        return pdef.value_and_grad.__lbfgs_trial__(xp, d, stp)
    xt = _take_line_step(pdef, xp, d, stp, wp)
    ft, gt = evaluate(pdef, xt)
    return xt, ft, gt, vm.dot(gt, d)


# ---------------------------------------------------------------------------
# More-Thuente
# ---------------------------------------------------------------------------


class _MTCarry(NamedTuple):
    stp: Array
    stx: Array
    sty: Array
    fx: Array       # f at best step
    fy: Array
    dgx: Array
    dgy: Array
    brackt: Array
    stage1: Array
    uinfo: Array
    width: Array
    prev_width: Array
    count: Array
    done: Array
    result: Array   # ncall on success
    status: Array
    # evaluated problem state at the current trial
    xt: Array
    ft: Array
    gt: Array
    neval: Array
    stp_eval: Array  #: the step xt/ft/gt were evaluated at
    extras: tuple  #: (gg, xx, changed) when the objective has a fused trial


def morethuente(
    pdef: ProblemDef,
    ls: LineSearchParams,
    xp: Array,
    finit: Array,
    gp: Array,
    d: Array,
    stp0: Array,
    dginit: Array,
    neval0: Array,
    extras0: tuple = (),
    materialize: bool = True,
) -> LineSearchResult:
    """More-Thuente bracketing search (reference ``line_search_morethuente``,
    ``src/line.rs:226-399``): guarantees sufficient decrease + curvature via
    the stage-1 modified-function trick and mcstep interval updates.

    One ``while_loop`` trip = one objective evaluation.  Never used with
    OWL-QN (routing parity, ``src/line.rs:204-211``), so no orthant logic.
    """
    from .ops import df as _df

    dtype = xp.dtype
    f = lambda v: jnp.asarray(v, dtype)
    # objective-scalar representation: f64 scalars under wide-fx/x64, or
    # (2,)-f32 double-float pairs under the x64-free wide carry (finit
    # arrives as prob.fx); the fx/fy/ft family must not be downcast to
    # the vector dtype or the comparisons lose exactly the resolution
    # the mode exists to provide.  The df helpers below reduce to the
    # ordinary expressions on plain scalars (a - b == a + (-b) in IEEE).
    wide_df = _df.is_df(finit)
    if wide_df:
        fadd = _df.add_f                      # F + plain-f32 scalar
        flt = _df.lt
        fle = lambda a, b: ~_df.gt(a, b)
    else:
        fadd = lambda F, v: F + v
        flt = lambda a, b: a < b
        fle = lambda a, b: a <= b
    fdt = jnp.result_type(finit)
    ff = lambda v: jnp.asarray(v, fdt)
    i32 = lambda v: jnp.asarray(v, jnp.int32)

    dgtest = ls.ftol * dginit
    width0 = f(ls.max_step - ls.min_step)

    max_ls = ls.max_linesearch
    has_fused = _has_fused_trial(pdef)
    # Rematerializing mode (fused-trial objectives): the loop carries ONLY
    # scalars — each trip probes (ft, dg) without writing the trial
    # point/gradient, and ONE full trial after the loop materializes the
    # accepted (x, g) directly into the caller's buffers.  This removes
    # the xt/gt carry (whose while-loop buffers cost a seed copy at entry
    # and an exit copy per outer iteration) and halves per-trip traffic
    # when the objective provides a probe.  Bitwise-identical to
    # the carrying mode: the trial is deterministic, so re-evaluating at
    # stp_eval reproduces the loop's (x, f, g) exactly (stp_eval = 0 on a
    # zero-trip exit reproduces the entry point).  Generic objectives
    # (host callbacks, OWL-QN) keep the carrying mode — re-evaluation
    # there would double the cost of an arbitrary user objective.
    remat = has_fused

    carry0 = _MTCarry(
        stp=f(stp0),
        stx=f(0.0),
        sty=f(0.0),
        fx=ff(finit),
        fy=ff(finit),
        dgx=f(dginit),
        dgy=f(dginit),
        brackt=jnp.asarray(False),
        stage1=jnp.asarray(True),
        uinfo=i32(0),
        width=width0,
        prev_width=2.0 * width0,
        count=i32(1),
        done=jnp.asarray(False),
        result=i32(ls.max_linesearch),
        status=i32(0),
        xt=None if remat else xp,
        ft=ff(finit),
        gt=None if remat else gp,
        neval=neval0,
        stp_eval=f(0.0),
        extras=() if remat else extras0,
    )

    if has_fused and not remat and not extras0:
        # direct callers: seed the carried extras with the entry point
        extras0 = (vm.dot(gp, gp), vm.dot(xp, xp), jnp.asarray(False))
        carry0 = carry0._replace(extras=extras0)

    def cond(c: _MTCarry):
        return (~c.done) & (c.count < max_ls)

    def body(c: _MTCarry) -> _MTCarry:
        # interval of uncertainty (src/line.rs:261-265)
        stmin = jnp.where(c.brackt, jnp.minimum(c.stx, c.sty), c.stx)
        stmax = jnp.where(
            c.brackt, jnp.maximum(c.stx, c.sty), c.stp + 4.0 * (c.stp - c.stx)
        )

        stp = jnp.clip(c.stp, ls.min_step, ls.max_step)

        # unusual termination -> lowest point so far (src/line.rs:277-281)
        unusual = c.brackt & (
            (stp <= stmin)
            | (stmax <= stp)
            | (max_ls <= c.count + 1)
            | (c.uinfo != 0)
        )
        unusual = unusual | (c.brackt & (stmax - stmin <= ls.xtol * stmax))
        stp = jnp.where(unusual, c.stx, stp)

        if remat:
            ft, dg = _probe(pdef, xp, d, stp)
            xt = gt = None
            extras = ()
        else:
            res = _trial(pdef, xp, d, stp, xp)  # wp unused (no OWL-QN here)
            xt, ft, gt, dg = res[:4]
            extras = tuple(res[4:]) if has_fused else ()
        neval = c.neval + 1
        ftest1 = fadd(finit, stp * dgtest)

        # error exits (src/line.rs:292-313)
        status = jnp.where(
            c.brackt & ((stp <= stmin) | (stmax <= stp) | (c.uinfo != 0)),
            i32(Status.LS_ROUNDING),
            i32(0),
        )
        status = jnp.where(
            (status == 0) & c.brackt & (stmax - stmin <= ls.xtol * stmax),
            i32(Status.LS_XTOL),
            status,
        )
        status = jnp.where(
            (status == 0) & (stp == ls.max_step) & fle(ft, ftest1) & (dg <= dgtest),
            i32(Status.LS_MAX_STEP),
            status,
        )
        status = jnp.where(
            (status == 0) & (stp == ls.min_step) & (flt(ftest1, ft) | (dgtest <= dg)),
            i32(Status.LS_MIN_STEP),
            status,
        )
        errored = status != 0

        # convergence: curvature condition alone (quirk parity,
        # src/line.rs:315-321 — the combined branch is unreachable)
        success = (~errored) & (jnp.abs(dg) <= ls.gtol * (-dginit))

        # stage-1 update (src/line.rs:324-326)
        stage1 = c.stage1 & ~(
            fle(ft, ftest1) & (min(ls.ftol, ls.gtol) * dginit <= dg)
        )

        use_mod = stage1 & flt(ftest1, ft) & fle(ft, c.fx)

        # modified function values (src/line.rs:333-340)
        fm = jnp.where(use_mod, fadd(ft, -(stp * dgtest)), ft)
        fxm = jnp.where(use_mod, fadd(c.fx, -(c.stx * dgtest)), c.fx)
        fym = jnp.where(use_mod, fadd(c.fy, -(c.sty * dgtest)), c.fy)
        dgm = jnp.where(use_mod, dg - dgtest, dg)
        dgxm = jnp.where(use_mod, c.dgx - dgtest, c.dgx)
        dgym = jnp.where(use_mod, c.dgy - dgtest, c.dgy)

        mcs = update_trial_interval(
            c.stx, fxm, dgxm, c.sty, fym, dgym, stp, fm, dgm, stmin, stmax, c.brackt
        )

        stx, sty = mcs.x, mcs.y
        fx_n = jnp.where(use_mod, fadd(mcs.fx, stx * dgtest), mcs.fx)
        fy_n = jnp.where(use_mod, fadd(mcs.fy, sty * dgtest), mcs.fy)
        dgx_n = jnp.where(use_mod, mcs.dx + dgtest, mcs.dx)
        dgy_n = jnp.where(use_mod, mcs.dy + dgtest, mcs.dy)
        stp_n = mcs.t
        brackt = mcs.brackt
        mc_err = mcs.status != 0
        status = jnp.where((status == 0) & mc_err, mcs.status, status)
        errored = status != 0

        # force sufficient interval shrinkage (src/line.rs:382-391)
        shrink = brackt & (0.66 * c.prev_width <= jnp.abs(sty - stx))
        stp_n = jnp.where(shrink, stx + 0.5 * (sty - stx), stp_n)
        prev_width = jnp.where(brackt, c.width, c.prev_width)
        width = jnp.where(brackt, jnp.abs(sty - stx), c.width)

        done = errored | success
        # on success or error: freeze interval state (values don't matter
        # once done); result/status recorded
        return _MTCarry(
            stp=jnp.where(success | errored, stp, stp_n),
            stx=stx,
            sty=sty,
            fx=fx_n,
            fy=fy_n,
            dgx=dgx_n,
            dgy=dgy_n,
            brackt=brackt,
            stage1=stage1,
            uinfo=c.uinfo,  # never becomes nonzero (mcstep errors abort)
            width=width,
            prev_width=prev_width,
            count=c.count + 1,
            done=done,
            result=jnp.where(success, c.count, c.result),
            status=status,
            xt=xt,
            ft=ft,
            gt=gt,
            neval=neval,
            stp_eval=stp,
            extras=extras,
        )

    out = lax.while_loop(cond, body, carry0)
    if remat and not materialize:
        # the caller (solver fused epilogue) materializes the accepted
        # trial itself — return only the carried scalars; the probed ft is
        # bitwise-identical to the materialized fx (remat contract)
        return LineSearchResult(
            x=None, fx=out.ft, gx=None, step=out.stp,
            ncall=jnp.where(out.status != 0, jnp.int32(0), out.result),
            neval=out.neval, status=out.status,
            gg=None, xx=None, changed=None, step_eval=out.stp_eval,
        )
    if remat:
        # materialize the accepted trial (one deterministic re-evaluation;
        # not counted in neval — it duplicates a loop evaluation)
        xt, ft, gt, _dg, gg, xx, changed = _trial(pdef, xp, d, out.stp_eval, xp)
    else:
        xt, ft, gt = out.xt, out.ft, out.gt
        if has_fused:
            gg, xx, changed = out.extras
        else:
            gg = None if pdef.orthantwise else vm.dot(out.gt, out.gt)
            xx = vm.dot(out.xt, out.xt)
            changed = None
    # loop exhausted without done => Ok(max_linesearch) (src/line.rs:395-398)
    return LineSearchResult(
        x=xt,
        fx=ft,
        gx=gt,
        step=out.stp,
        ncall=jnp.where(out.status != 0, jnp.int32(0), out.result),
        neval=out.neval,
        status=out.status,
        gg=gg,
        xx=xx,
        changed=changed,
        step_eval=out.stp_eval,
    )


# ---------------------------------------------------------------------------
# Backtracking (Armijo / Wolfe / strong Wolfe; OWL-QN path)
# ---------------------------------------------------------------------------


class _BTCarry(NamedTuple):
    stp: Array
    count: Array
    done: Array
    result: Array
    status: Array
    xt: Array
    ft: Array
    gt: Array
    neval: Array
    stp_eval: Array  #: the step xt/ft/gt were evaluated at
    extras: tuple  #: (gg, xx, changed) when the objective has a fused trial


def backtracking(
    pdef: ProblemDef,
    ls: LineSearchParams,
    xp: Array,
    finit: Array,
    gp: Array,
    d: Array,
    stp0: Array,
    dginit: Array,
    neval0: Array,
    wp: Array,
    extras0: tuple = (),
    materialize: bool = True,
) -> LineSearchResult:
    """Backtracking search with the Armijo / Wolfe / strong-Wolfe exit ladder
    (reference ``line_search_backtracking``, ``src/line.rs:716-784``).

    Under OWL-QN every trial point is projected onto the orthant ``wp``
    chosen before the loop (``src/line.rs:733-736``), and only the Armijo
    exit applies (``src/line.rs:747-751``).
    """
    from .ops import df as _df

    dtype = xp.dtype
    f = lambda v: jnp.asarray(v, dtype)
    # objective-scalar representation (see morethuente): ft carries like
    # finit — f64 scalars under wide-fx/x64, or (2,)-f32 double-float
    # pairs under the x64-free wide carry (fused.wide_mode 'df32'; the
    # Armijo comparison is then lexicographic on (hi, lo))
    wide_df = _df.is_df(finit)
    fdt = jnp.result_type(finit)
    ff = lambda v: jnp.asarray(v, fdt)
    i32 = lambda v: jnp.asarray(v, jnp.int32)

    dec, inc = 0.5, 2.1
    dgtest = ls.ftol * dginit
    armijo_only = ls.algorithm == LineSearchAlgorithm.BacktrackingArmijo
    wolfe = ls.algorithm == LineSearchAlgorithm.BacktrackingWolfe
    max_ls = ls.max_linesearch

    has_fused = _has_fused_trial(pdef)
    has_fused_ow = _has_fused_owlqn_trial(pdef)
    # scalar-only carry + one materializing re-trial (see morethuente's
    # remat note); the OWL-QN re-trial at stp_eval=0 reproduces xp exactly
    # because xp is already in its own orthant (wp = sign(xp) where
    # xp != 0; projection at xp == 0 is the identity)
    remat = has_fused or has_fused_ow
    if has_fused and not remat and not extras0:
        extras0 = (vm.dot(gp, gp), vm.dot(xp, xp), jnp.asarray(False))
    carry0 = _BTCarry(
        stp=f(stp0),
        count=i32(1),
        done=jnp.asarray(False),
        result=i32(max_ls),
        status=i32(0),
        xt=None if remat else xp,
        ft=ff(finit),
        gt=None if remat else gp,
        neval=neval0,
        stp_eval=f(0.0),
        extras=() if remat else extras0,
    )

    def cond(c: _BTCarry):
        return (~c.done) & (c.count < max_ls)

    def body(c: _BTCarry) -> _BTCarry:
        if remat:
            ft, dg = _probe(pdef, xp, d, c.stp, wp)
            xt = gt = None
            extras = ()
        else:
            res = _trial(pdef, xp, d, c.stp, wp)
            xt, ft, gt, dg = res[:4]
            extras = tuple(res[4:]) if has_fused else ()
        neval = c.neval + 1

        if wide_df:
            armijo_fail = _df.gt(ft, _df.add_f(finit, c.stp * dgtest))
        else:
            armijo_fail = ft > finit + c.stp * dgtest

        if armijo_only or pdef.orthantwise:
            # Armijo-only exit ladder (src/line.rs:745-751)
            success = ~armijo_fail
            width = f(dec)
        else:
            curv_low = dg < ls.gtol * dginit
            if wolfe:
                # regular Wolfe (src/line.rs:754-757)
                success = (~armijo_fail) & (~curv_low)
                width = jnp.where(armijo_fail, f(dec), f(inc))
            else:
                # strong Wolfe (src/line.rs:759-763)
                curv_high = dg > -ls.gtol * dginit
                success = (~armijo_fail) & (~curv_low) & (~curv_high)
                width = jnp.where(
                    armijo_fail, f(dec), jnp.where(curv_low, f(inc), f(dec))
                )

        if ls.gradient_only:
            # literal quirk parity: |dg| <= -gtol*|dginit| is unsatisfiable
            # unless dginit == 0 (src/line.rs:768-774)
            success = success | (jnp.abs(dg) <= -ls.gtol * jnp.abs(dginit))

        # validate_step after a failed trial (src/line.rs:776, :166-178)
        status = jnp.where(
            (~success) & (c.stp < ls.min_step), i32(Status.LS_MIN_STEP), i32(0)
        )
        status = jnp.where(
            (~success) & (status == 0) & (c.stp > ls.max_step),
            i32(Status.LS_MAX_STEP),
            status,
        )
        errored = status != 0

        return _BTCarry(
            stp=jnp.where(success | errored, c.stp, c.stp * width),
            count=c.count + 1,
            done=success | errored,
            result=jnp.where(success, c.count, c.result),
            status=status,
            xt=xt,
            ft=ft,
            gt=gt,
            neval=neval,
            stp_eval=c.stp,
            extras=extras,
        )

    out = lax.while_loop(cond, body, carry0)
    if remat and not materialize:
        # caller materializes via the fused epilogue (see morethuente)
        return LineSearchResult(
            x=None, fx=out.ft, gx=None, step=out.stp,
            ncall=jnp.where(out.status != 0, jnp.int32(0), out.result),
            neval=out.neval, status=out.status,
            gg=None, xx=None, changed=None, step_eval=out.stp_eval,
        )
    if remat and has_fused_ow:
        xt, ft, gt, _dg, xx, changed = _owlqn_trial(pdef, xp, d, out.stp_eval, wp)
        gg = None  # the solver needs ||pg||^2 under OWL-QN, not ||g||^2
    elif remat:
        xt, ft, gt, _dg, gg, xx, changed = _trial(pdef, xp, d, out.stp_eval, wp)
    else:
        xt, ft, gt = out.xt, out.ft, out.gt
        if has_fused:
            gg, xx, changed = out.extras
        else:
            gg = None if pdef.orthantwise else vm.dot(out.gt, out.gt)
            xx = vm.dot(out.xt, out.xt)
            changed = None
    return LineSearchResult(
        x=xt,
        fx=ft,
        gx=gt,
        step=out.stp,
        ncall=jnp.where(out.status != 0, jnp.int32(0), out.result),
        neval=out.neval,
        status=out.status,
        gg=gg,
        xx=xx,
        changed=changed,
        step_eval=out.stp_eval,
    )


# ---------------------------------------------------------------------------
# Speculative K-way backtracking (Armijo-only ladder; an extension)
# ---------------------------------------------------------------------------


class _SpecCarry(NamedTuple):
    r: Array          #: ladder round index
    stp_base: Array   #: step at ladder position r*K
    done: Array
    sel_count: Array  #: sequential `count` of the selected trial (i32)
    sel_step: Array   #: step of the selected trial
    status: Array


def backtracking_speculative(
    pdef: ProblemDef,
    ls: LineSearchParams,
    xp: Array,
    finit: Array,
    gp: Array,
    d: Array,
    stp0: Array,
    dginit: Array,
    neval0: Array,
    wp: Array,
) -> LineSearchResult:
    """Speculative K-way variant of the Armijo-only backtracking ladder.

    An extension with no reference counterpart: the sequential search
    (``src/line.rs:716-784``, Armijo path) evaluates stp, stp·0.5, stp·0.5²,…
    one ``while_loop`` trip at a time — a latency chain of full-vector
    evaluations.  Because the Armijo ladder's shrink factor is a constant
    (dec = 0.5, ``src/line.rs:725``; success exits, it never grows), ALL
    candidate steps are known upfront; this search evaluates K of them per
    pass with one ``jax.vmap`` over the step scalar, selects the first
    acceptable candidate branch-free, then re-evaluates once at the accepted
    step to materialize (x, g) with O(n) live memory.

    Ladder equivalence with the sequential search: the accepted step, the
    reported ``step``/``step_eval``/``ncall``/``status``, and ``neval``
    (counted in *logical* sequential trials, so max_evaluations semantics
    and trajectories are unchanged) all match the sequential search
    trial-for-trial; only the *physical* evaluation count differs
    (ceil(trials/K)·K + 1 vmapped lanes instead of `trials` sequential
    evaluations).  Halving is exact in binary floating point, so
    stp·0.5^j equals the sequentially-halved step bit-for-bit; the
    equivalence is therefore bitwise whenever the vmapped candidate
    evaluations round identically to the unbatched ones (always true for
    elementwise objectives; reduction-based objectives may reassociate
    under vmap, making the equivalence tolerance-level — the same contract
    as XLA-vs-sequential-reference parity, SURVEY.md §7).

    Wins when trials/iteration is large (the Armijo ladder burns ~10 evals
    per iteration on Rosenbrock, and OWL-QN always backtracks) and the
    objective is cheap, batched, or latency-dominated; costs up to K-1
    wasted lanes when the first candidate is accepted.  Opt-in via
    ``with_speculative_linesearch(K)``.
    """
    from .ops import df as _df

    if _df.is_df(finit):
        raise ValueError(
            "the speculative line search does not support the x64-free "
            "double-float fx carry; enable jax_enable_x64 for fx_wide "
            "with speculation, or use the sequential search."
        )
    dtype = xp.dtype
    f = lambda v: jnp.asarray(v, dtype)
    i32 = lambda v: jnp.asarray(v, jnp.int32)

    K = int(ls.speculative)
    max_ls = ls.max_linesearch
    trials = max_ls - 1  # `for count in 1..max_linesearch` (src/line.rs:739)
    dec = f(0.5)
    dgtest = ls.ftol * dginit
    has_fused = _has_fused_trial(pdef)

    def _finish(eval_step, report_step, ncall, neval, status):
        res = _trial(pdef, xp, d, eval_step, wp)
        xt, ft, gt = res[:3]
        if has_fused:
            gg, xx, changed = res[4:]
        else:
            gg = None if pdef.orthantwise else vm.dot(gt, gt)
            xx = vm.dot(xt, xt)
            changed = None
        return LineSearchResult(
            x=xt,
            fx=ft,
            gx=gt,
            step=report_step,
            ncall=jnp.where(status != 0, i32(0), ncall),
            neval=neval,
            status=status,
            gg=gg,
            xx=xx,
            changed=changed,
            step_eval=eval_step,
        )

    if trials <= 0:
        # zero-trial parity: the sequential loop never runs (max_ls <= 1) —
        # returns the entry point with result = max_linesearch
        gg0 = None if pdef.orthantwise else vm.dot(gp, gp)
        return LineSearchResult(
            x=xp, fx=jnp.asarray(finit), gx=gp, step=f(stp0), ncall=i32(max_ls),
            neval=neval0, status=i32(0), gg=gg0, xx=vm.dot(xp, xp),
            changed=None if not has_fused else jnp.asarray(False),
            step_eval=f(0.0),
        )

    ladder = dec ** jnp.arange(K, dtype=dtype)  # [K]: 1, 0.5, 0.25, ...
    rounds = -(-trials // K)

    # trial-point step for the vmapped scalar pass (elementwise math,
    # bitwise-identical to the sequential search's trial points).  The
    # candidate fx values come from the generic `evaluate` path below; for
    # objectives with a fused `__lbfgs_trial__` the accept DECISION can
    # round differently than the sequential search's, and `_finish`
    # re-materializes fx through that trial — so equivalence there is
    # tolerance-level (same contract as the vmap-reassociation caveat).
    if pdef.orthantwise:
        from .ops import fused

        _lo, _hi = pdef.owlqn.start_end(xp.shape[0])
        _step_fn = lambda s: fused.owlqn_trial_step(xp, d, wp, s, _lo, _hi)
    else:
        _step_fn = lambda s: xp + s * d

    def _fts(steps):
        # scalar pass: candidate objective values only (the accepted point
        # is re-materialized once afterwards).  Generic evaluation path on
        # purpose: identical math to `_trial`'s jnp route, and vmap of the
        # full-vector pass is left to XLA's batching.
        def one(s):
            ft, _ = evaluate(pdef, _step_fn(s))
            return ft

        return jax.vmap(one)(steps)

    def cond(c: _SpecCarry):
        return (~c.done) & (c.r < rounds)

    def body(c: _SpecCarry) -> _SpecCarry:
        j = jnp.arange(K)
        steps = c.stp_base * ladder
        valid = (c.r * K + j) < trials
        fts = _fts(steps)

        # Armijo test (src/line.rs:745-751); step validation only after a
        # failed trial (src/line.rs:776, :166-178)
        fail = fts > finit + steps * dgtest
        success = (~fail) & valid
        err_min = fail & (steps < ls.min_step) & valid
        err_max = fail & (~err_min) & (steps > ls.max_step) & valid
        event = success | err_min | err_max

        any_event = jnp.any(event)
        jsel = jnp.argmax(event).astype(jnp.int32)  # first event in ladder order
        status_sel = jnp.where(
            success[jsel],
            i32(0),
            jnp.where(err_min[jsel], i32(Status.LS_MIN_STEP), i32(Status.LS_MAX_STEP)),
        )
        return _SpecCarry(
            r=c.r + 1,
            stp_base=c.stp_base * (dec ** K),
            done=any_event,
            sel_count=jnp.where(any_event, i32(1) + c.r * K + jsel, c.sel_count),
            sel_step=jnp.where(any_event, steps[jsel], c.sel_step),
            status=jnp.where(any_event, status_sel, c.status),
        )

    out = lax.while_loop(
        cond,
        body,
        _SpecCarry(
            r=i32(0), stp_base=f(stp0), done=jnp.asarray(False),
            sel_count=i32(max_ls), sel_step=f(stp0), status=i32(0),
        ),
    )

    # exhaustion parity: the sequential loop leaves stp at the NEXT (never
    # evaluated) proposal while (x, f, g) sit at the last evaluated trial
    # (src/line.rs:777); ncall stays max_linesearch, neval counts all trials
    last_step = f(stp0) * (dec ** (trials - 1))
    eval_step = jnp.where(out.done, out.sel_step, last_step)
    report_step = jnp.where(out.done, out.sel_step, last_step * dec)
    ncall = jnp.where(out.done & (out.status == 0), out.sel_count, i32(max_ls))
    neval = neval0 + jnp.where(out.done, out.sel_count, i32(trials))
    return _finish(eval_step, report_step, ncall, neval, out.status)


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


def find(
    pdef: ProblemDef,
    ls: LineSearchParams,
    xp: Array,
    finit: Array,
    gp: Array,
    pgp: Array,
    d: Array,
    stp0: Array,
    neval0: Array,
    gg0: Array = None,
    xx0: Array = None,
    dginit: Array = None,
    materialize: bool = True,
) -> LineSearchResult:
    """Unified line-search entry (reference ``LineSearch::find``,
    ``src/line.rs:193-223``).

    Routing parity: More-Thuente only when the algorithm selects it AND
    OWL-QN is off AND gradient_only is off; otherwise backtracking.  The
    reference's gradient_only+MoreThuente combination is a hard error
    (``src/line.rs:208``) — checked at trace time here.

    On an internal line-search error the caller is responsible for the
    revert-to-previous-point recovery (``src/line.rs:213-220``); this
    function just reports the status.

    ``materialize=False`` (solver fused-epilogue mode): the search returns
    only the carried scalars (x/gx/gg/xx/changed are None) and the caller
    materializes the accepted trial — plus the correction pair and Gram
    products — in one fused pass (``__lbfgs_trial_pair_gram__``).
    Requires the rematerializing mode (fused-trial objective, no OWL-QN,
    no speculation).
    """
    if not materialize and not _has_fused_trial(pdef):
        raise ValueError(
            "materialize=False requires a fused-trial objective "
            "(__lbfgs_trial__) without OWL-QN"
        )
    use_mt = (
        ls.algorithm == LineSearchAlgorithm.MoreThuente and not pdef.orthantwise
    )
    if use_mt and ls.gradient_only:
        raise ValueError(
            "Gradient only optimization is incompatible with MoreThuente line search."
        )

    speculative = int(getattr(ls, "speculative", 1)) > 1
    if speculative:
        armijo_ladder = pdef.orthantwise or (
            ls.algorithm == LineSearchAlgorithm.BacktrackingArmijo
        )
        if use_mt or not armijo_ladder or ls.gradient_only:
            raise ValueError(
                "Speculative line search requires the Armijo-only ladder "
                "(BacktrackingArmijo, or any backtracking search under "
                "OWL-QN) without gradient_only; More-Thuente and the Wolfe "
                "ladders choose data-dependent trial steps."
            )
        if getattr(pdef.value_and_grad, "__lbfgs_host_callback__", False):
            raise ValueError(
                "Speculative line search requires a traceable objective: "
                "reference-style host closures (f(x, gx)) evaluate through "
                "an ordered io_callback, which cannot be vmapped over the "
                "candidate steps.  Use the sequential search, or provide a "
                "traceable f(x) -> fx or f(x) -> (fx, gx) objective."
            )

    # dginit: pg.d under OWL-QN else g.d (src/core.rs:78-92); the reference
    # only warns on ascent directions, it does not error.  The solver
    # carries it (SolverState.dg0, a free byproduct of the direction
    # combine) so the healthy path costs zero vector reads here.
    if dginit is None:
        dginit = vm.dot(pgp if pdef.orthantwise else gp, d)

    if (
        not pdef.orthantwise
        and getattr(ls, "warn_ascent", True)
        and _warnings_enabled()
    ):
        # ascent-direction warning (reference Problem::dginit,
        # src/core.rs:78-92).  The cond's branches carry no buffers, so it
        # adds only a scalar compare to the hot loop; the callback fires
        # only when the warning condition holds.
        def _warn(dg):
            # re-check on the host: under vmap/batching a lax.cond lowers
            # to a select that executes BOTH branches, so the callback can
            # fire with a non-ascent dginit (or a batch of them)
            import numpy as _np

            for v in _np.atleast_1d(_np.asarray(dg)):
                if v > 0.0:
                    logger.warning(
                        "The current search direction increases the objective "
                        "function value. dginit = %-0.4f",
                        float(v),
                    )

        lax.cond(
            dginit > 0.0,
            lambda dg: jax.debug.callback(_warn, dg),
            lambda dg: None,
            dginit,
        )

    # seed the carried extras with the entry point's values (gg0/xx0 are
    # the caller's carried gp.gp / xp.xp) so a zero-trial exit is correct
    if _has_fused_trial(pdef):
        if gg0 is None:
            gg0 = vm.dot(gp, gp)
        if xx0 is None:
            xx0 = vm.dot(xp, xp)
        extras0 = (gg0, xx0, jnp.asarray(False))
    else:
        extras0 = ()

    if use_mt:
        res = morethuente(
            pdef, ls, xp, finit, gp, d, stp0, dginit, neval0, extras0,
            materialize=materialize,
        )
    else:
        # choose the orthant before the loop (src/line.rs:733-736)
        if pdef.orthantwise:
            wp = ow_ops.choose_orthant(pdef.owlqn, xp, pgp)
        else:
            wp = xp  # unused
        if speculative:
            if not materialize:
                raise ValueError(
                    "materialize=False is incompatible with the speculative "
                    "search (its candidate pass already materializes)"
                )
            res = backtracking_speculative(
                pdef, ls, xp, finit, gp, d, stp0, dginit, neval0, wp
            )
        else:
            res = backtracking(
                pdef, ls, xp, finit, gp, d, stp0, dginit, neval0, wp, extras0,
                materialize=materialize,
            )

    # entry validation (reference find, src/line.rs:197-201): a negative
    # entry step is a logic error that bubbles OUT of find (unlike internal
    # search failures, which the caller reverts and swallows).  The
    # reference's is_sign_positive() accepts +0.0; only a set sign bit
    # fails.  Under jit the search traced anyway; only SCALAR outputs are
    # masked back to the entry values — the caller's status!=0 revert path
    # already restores x/gx/norms, and masking the vectors here would add
    # full HBM passes to every (valid) search.
    neg = jnp.signbit(stp0)
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    res = res._replace(
        fx=jnp.where(neg, finit, res.fx),
        step=jnp.where(neg, stp0, res.step),
        ncall=jnp.where(neg, i32(0), res.ncall),
        neval=jnp.where(neg, neval0, res.neval),
        status=jnp.where(neg, i32(Status.ERR_NEGATIVE_STEP), res.status),
        step_eval=jnp.where(neg, stp0, res.step_eval),
    )
    return res
