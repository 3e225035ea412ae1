"""L-BFGS driver step: history update, two-loop recursion, propagate.

Re-design of the reference optimizer driver
(``src/lbfgs.rs:424-693``).  Two interchangeable two-loop implementations:

  * ``two_loop_scan`` — a literal Nocedal Alg. 7.4 over the ring buffer as a
    masked ``lax.scan`` (reference ``lbfgs_two_loop_recursion``,
    ``src/lbfgs.rs:569-604``): 2*bound dot products per iteration, each one
    a cross-shard reduction when the vector axis is sharded.

  * ``two_loop_compact`` — the default: the Byrd–Nocedal–Schnabel
    compact representation.  All 2m+2 length-n dot products of one iteration
    collapse into TWO [2m, n] @ [n] matvecs (streaming passes, ONE collective
    round each under sharding), followed by O(m^2) replicated scalar
    recurrences for the alpha/beta coefficients, and a final [n, 2m] @ [2m]
    combine.  Exact same math as the two-loop in real arithmetic — verified
    against ``two_loop_scan`` in tests/test_two_loop.py.

The per-slot damped update replicates Powell/Al-Baali damping with the
reference's literal behavior (``src/lbfgs.rs:658-691``), including:
  * gamma = ys/yy computed from the PRE-damping y,
  * stored ``ys`` kept at its pre-damping value,
  * damping case 2 computes a blend but never stores it (a no-op) —
    the intended write-back is available behind ``params.damping_fixed``.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array, lax

logger = logging.getLogger("lbfgs_jax")

from . import orthantwise as ow_ops
from .core import (
    History,
    ProblemDef,
    ProblemState,
    SolverState,
    evaluate,
    hist_store_shape,
    pseudo_gradient,
    pseudo_gradient_and_norm,
)
from .linesearch import find as ls_find
from .ops import vecmath as vm
from .params import LbfgsParams
from .status import Status


# ---------------------------------------------------------------------------
# History-storage helpers (ring-major [m, n/128, 128] when aligned; see
# core.History docstring for why)
# ---------------------------------------------------------------------------


def _hist_row(H: Array, j) -> Array:
    """Ring row j as a flat [n] vector (reshape views are free)."""
    return jnp.take(H, j, axis=0).reshape(-1)


def _hist_set(H: Array, j, v: Array) -> Array:
    """Write flat [n] vector v into ring row j (casting to the storage
    dtype under mixed-precision history)."""
    return H.at[j].set(v.reshape(H.shape[1:]).astype(H.dtype))


def _hist_matvec(H: Array, v: Array) -> Array:
    """All-rows dot products H . v -> [m] (ring order), accumulated in the
    vector's dtype (XLA fuses the widening convert into the contraction,
    so a bf16 history is still read at half traffic)."""
    if H.ndim == 3:
        return jnp.einsum(
            "mrl,rl->m", H, v.reshape(H.shape[1:]), precision=vm.PRECISION,
            preferred_element_type=v.dtype,
        )
    return jnp.matmul(H, v, precision=vm.PRECISION, preferred_element_type=v.dtype)


def _hist_gram_pass(S_new: Array, Y_new: Array, y: Array, s: Array, g0: Array):
    """One streaming pass over each history stack against (y, s, g0):
    SP = S_new @ [y; s; g0], YP likewise ([m, 3] each, accumulated in the
    vectors' dtype).  ``g0`` is the POSITIVE gradient vector (gx, or pg
    under OWL-QN); callers needing products against the steepest direction
    d0 = -g0 negate the [m]-scalar column (bitwise-exact, and it avoids
    materializing a full negated vector)."""
    Z = jnp.stack([y, s, g0], axis=1)                                 # [n, 3]
    if S_new.ndim == 3:
        Z3 = Z.reshape(S_new.shape[1], S_new.shape[2], 3)
        SP = jnp.einsum("mrl,rlz->mz", S_new, Z3, precision=vm.PRECISION,
                        preferred_element_type=Z.dtype)
        YP = jnp.einsum("mrl,rlz->mz", Y_new, Z3, precision=vm.PRECISION,
                        preferred_element_type=Z.dtype)
    else:
        SP = jnp.matmul(S_new, Z, precision=vm.PRECISION,
                        preferred_element_type=Z.dtype)
        YP = jnp.matmul(Y_new, Z, precision=vm.PRECISION,
                        preferred_element_type=Z.dtype)
    return SP, YP


def _hist_combine(coef: Array, H: Array) -> Array:
    """Linear combination coef @ H -> flat [n] (ring order)."""
    if H.ndim == 3:
        return jnp.einsum(
            "m,mrl->rl", coef, H, precision=vm.PRECISION,
            preferred_element_type=coef.dtype,
        ).reshape(-1)
    return jnp.matmul(coef, H, precision=vm.PRECISION, preferred_element_type=coef.dtype)


# ---------------------------------------------------------------------------
# Two-loop recursion, literal scan form
# ---------------------------------------------------------------------------


def two_loop_scan(hist: History, d: Array, gamma: Array, bound: Array, end: Array):
    """Nocedal Alg. 7.4 over the circular history (``src/lbfgs.rs:569-604``).

    ``end`` is the ring slot of the NEWEST pair (already written); the
    reference advances its write cursor first and then walks newest→oldest.
    ``bound = min(m, k-1)`` pairs are active; inactive ring slots are masked.
    Returns the new search direction (caller handles the cursor advance).
    """
    m = hist.s.shape[0]
    idx = jnp.arange(m)

    def bwd(q, i):
        j = (end - i) % m
        active = i < bound
        sj = _hist_row(hist.s, j)
        yj = _hist_row(hist.y, j)
        ysj = jnp.take(hist.ys, j)
        alpha_j = jnp.where(active, vm.dot(sj, q) / ysj, 0.0)
        q = q - jnp.where(active, alpha_j, 0.0) * yj
        return q, alpha_j

    q, alphas = lax.scan(bwd, d, idx)
    q = q * gamma

    def fwd(q, i):
        bidx = bound - 1 - i  # backward-iteration index, oldest first
        active = i < bound
        j = (end - bidx) % m
        sj = _hist_row(hist.s, j)
        yj = _hist_row(hist.y, j)
        ysj = jnp.take(hist.ys, j)
        alpha_j = jnp.take(alphas, bidx, mode="clip")
        beta = vm.dot(yj, q) / ysj
        q = q + jnp.where(active, alpha_j - beta, 0.0) * sj
        return q, alpha_j

    q, alphas_fwd = lax.scan(fwd, q, idx)
    # persist alphas in ring order for parity with IterationData.alpha
    alpha_ring = jnp.zeros_like(hist.alpha)
    ring_j = (end - idx) % m
    alpha_ring = alpha_ring.at[ring_j].set(jnp.where(idx < bound, alphas, hist.alpha[ring_j]))
    return q, alpha_ring


# ---------------------------------------------------------------------------
# Two-loop recursion, compact (batched-matvec) form
# ---------------------------------------------------------------------------


def gram_for(hist: History, slot: Array):
    """Gather the cached Gram blocks into newest-first order."""
    return hist.sy[slot][:, slot], hist.yy[slot][:, slot]


def make_history(s: Array, y: Array, ys: Array, alpha: Array) -> History:
    """Build a History from [m, n] stacks with the Gram caches populated
    (test/standalone helper; the solver maintains the caches
    incrementally and stores ring-major, see ``core.hist_store_shape``)."""
    sy = jnp.matmul(s, y.T, precision=vm.PRECISION)
    yy = jnp.matmul(y, y.T, precision=vm.PRECISION)
    shape = hist_store_shape(*s.shape)
    return History(
        s=s.reshape(shape), y=y.reshape(shape), ys=ys, alpha=alpha, sy=sy, yy=yy
    )


def two_loop_compact(
    hist: History,
    d: Array,
    gamma: Array,
    bound: Array,
    end: Array,
    Sd_ring: Array | None = None,
    Yd_ring: Array | None = None,
    neg: bool = False,
):
    """Byrd–Nocedal–Schnabel compact two-loop.

    With pairs ordered newest-first p = 0..bound-1 (ring slot j = end - p):

      backward:  alpha_p = (s_p.q_p) / ys_p,  q_{p+1} = q_p - alpha_p y_p
        =>       alpha_p = (s_p.d - sum_{i<p} alpha_i (s_p.y_i)) / ys_p

      forward (oldest first):  beta = (y.r)/ys,  r += (alpha - beta) s
        =>       beta_p = (gamma*(y_p.d) - gamma*sum_i alpha_i (y_p.y_i)
                           + sum_{i older than p} (alpha_i - beta_i) (y_p.s_i)) / ys_p

      result:    r = gamma*d - gamma*Y^T alpha + S^T (alpha - beta)

    All length-n reductions batch into W @ d with W = [S; Y]  ([2m, n]) plus
    Gram blocks S Y^T, Y Y^T ([m, m]) gathered from the incrementally
    maintained cache in ``History`` (see ``propagate_core``), so one
    iteration touches the history exactly twice (W @ d and the final
    combine).  The scalar recurrences run on replicated [m] arrays.

    ``neg=True`` means the passed ``d`` is the POSITIVE gradient vector
    (gx or pg) and the effective two-loop input is ``-d`` — the sign is
    folded into the [m]-scalar coefficients and the combine's gamma
    (bitwise-identical to materializing the negated vector, per IEEE
    sign symmetry of multiply/add), saving one full HBM negate pass.
    """
    m = hist.s.shape[0]
    idx = jnp.arange(m)
    # ring slot for newest-first position p
    slot = (end - idx) % m                     # [m]
    active = idx < bound                       # [m]

    # The [m, n] history is ONLY ever touched by streaming matvecs in its
    # native ring order — row-permuting it (gather) or concatenating S
    # with Y would materialize multi-hundred-MB copies.  All ring->
    # newest-first reordering happens on [m]-sized scalars (free).
    # ``propagate_core`` passes S.d / Y.d precomputed (batched into the
    # Gram-update pass so the history is read once); standalone callers
    # compute them here.
    if Sd_ring is None:
        Sd_ring = _hist_matvec(hist.s, d)
        if neg:
            Sd_ring = -Sd_ring
    if Yd_ring is None:
        Yd_ring = _hist_matvec(hist.y, d)
        if neg:
            Yd_ring = -Yd_ring
    Sd = Sd_ring[slot]  # [m]
    Yd = Yd_ring[slot]  # [m]

    ys = jnp.take(hist.ys, slot)               # [m]
    ys_safe = jnp.where(active, ys, 1.0)

    # Gram blocks from the incrementally-maintained cache (newest-first)
    SY, YY = gram_for(hist, slot)              # [m, m] each

    mask = active.astype(d.dtype)

    # backward recurrence for alpha (newest-first order)
    def bwd(alphas, p):
        # alpha_p = (Sd[p] - sum_{i<p} alphas[i] * SY[p, i]) / ys[p]
        prior = jnp.where(jnp.arange(m) < p, alphas, 0.0)
        a = (Sd[p] - jnp.dot(SY[p], prior)) / ys_safe[p]
        a = jnp.where(p < bound, a, 0.0)
        return alphas.at[p].set(a), None

    alphas, _ = lax.scan(bwd, jnp.zeros_like(ys), idx)

    # y_p . q0  where q0 = d - Y^T alpha
    Yq0 = Yd - jnp.matmul(YY, alphas * mask, precision=vm.PRECISION)

    # forward recurrence for beta (oldest active first: p = bound-1 .. 0)
    # coef_p = alpha_p - beta_p
    def fwd(coefs, step):
        p = bound - 1 - step  # may be negative for inactive steps
        p_c = jnp.clip(p, 0, m - 1)
        older = (jnp.arange(m) > p_c) & active  # processed-before mask
        prior = jnp.where(older, coefs, 0.0)
        beta = (gamma * Yq0[p_c] + jnp.dot(SY.T[p_c], prior)) / ys_safe[p_c]
        coef = alphas[p_c] - beta
        ok = (step < bound)
        coefs = coefs.at[p_c].set(jnp.where(ok, coef, coefs[p_c]))
        return coefs, None

    coefs, _ = lax.scan(fwd, jnp.zeros_like(ys), idx)

    # scatter the combine coefficients back to ring order ([m] scalars),
    # then r = gamma*d + S^T coef_s + Y^T coef_y as streaming matvecs
    coef_s = jnp.zeros_like(ys).at[slot].set(coefs * mask)
    coef_y = jnp.zeros_like(ys).at[slot].set(-gamma * (alphas * mask))
    gamma_eff = -gamma if neg else gamma
    r = gamma_eff * d + _hist_combine(coef_s, hist.s) + _hist_combine(coef_y, hist.y)

    # persist alphas in ring order for parity with IterationData.alpha
    alpha_ring = hist.alpha.at[slot].set(jnp.where(active, alphas, hist.alpha[slot]))
    return r, alpha_ring


def two_loop(params: LbfgsParams, hist: History, d, gamma, bound, end):
    if params.compact_two_loop:
        return two_loop_compact(hist, d, gamma, bound, end)
    return two_loop_scan(hist, d, gamma, bound, end)


# ---------------------------------------------------------------------------
# Correction-pair update (+ Powell/Al-Baali damping)
# ---------------------------------------------------------------------------


class PairUpdate(NamedTuple):
    s: Array
    y: Array
    ys: Array
    gamma: Array
    status: Array


def update_pair(
    params: LbfgsParams,
    x: Array,
    xp: Array,
    gx: Array,
    gp: Array,
    step: Array,
) -> PairUpdate:
    """Compute the new correction pair (reference ``IterationData::update``,
    ``src/lbfgs.rs:640-692``) with literal damping semantics."""
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    s = x - xp
    y = gx - gp

    # all three pair reductions (s.s, s.y, y.y) in one [2,n]@[n,2] product:
    # one HBM pass, one collective round under sharding
    D = jnp.stack([s, y])
    G = jnp.matmul(D, D.T, precision=vm.PRECISION)
    snorm = jnp.sqrt(G[0, 0])
    ys = G[0, 1]
    yy = G[1, 1]

    status = jnp.where(snorm == 0.0, i32(Status.ERR_X_NOT_CHANGED), i32(0))
    status = jnp.where(
        (status == 0) & (yy == 0.0), i32(Status.ERR_G_NOT_CHANGED), status
    )

    # gamma from PRE-damping ys/yy (src/lbfgs.rs:653-656, 691)
    yy_safe = jnp.where(yy == 0.0, 1.0, yy)
    gamma = ys / yy_safe

    if params.damping:
        sigma2, sigma3 = 0.6, 3.0
        # B_k s_k ~= -step * g_prev  (src/lbfgs.rs:670-673)
        bs = -step * gp
        sbs = vm.dot(s, bs)

        # case 1: ys < (1 - sigma2) * sbs  ->  y <- (1-theta)Bs + theta*y
        theta1 = sigma2 * sbs / (sbs - ys)
        y_case1 = (1.0 - theta1) * bs + theta1 * y

        case1 = ys < (1.0 - sigma2) * sbs
        case2 = (~case1) & (ys > (1.0 + sigma3) * sbs)

        if logger.isEnabledFor(logging.DEBUG):
            # damping case traces (reference debug!/trace!,
            # src/lbfgs.rs:667, 676-687).  Trace-time gated on the Python
            # log level so the default configuration pays zero runtime cost.
            def _log_case(c):
                logger.debug(
                    "Applying Powell damping, sigma2 = %s, sigma3 = %s",
                    sigma2, sigma3,
                )
                logger.debug("damping case%d", int(c))

            case_idx = jnp.where(case1, 1, jnp.where(case2, 2, 3))
            jax.debug.callback(_log_case, case_idx)

        if params.damping_fixed:
            # intended case-2 write-back (the reference drops it,
            # src/lbfgs.rs:681-685)
            theta2 = sigma3 * sbs / (ys - sbs)
            y_case2 = (1.0 - theta2) * bs + theta2 * y
            y = jnp.where(case1, y_case1, jnp.where(case2, y_case2, y))
        else:
            # literal: case 2 computes but never stores (no-op)
            y = jnp.where(case1, y_case1, y)
        # NOTE: stored ys stays pre-damping in both variants (parity,
        # src/lbfgs.rs:656)

    return PairUpdate(s=s, y=y, ys=ys, gamma=gamma, status=status)


# ---------------------------------------------------------------------------
# One full L-BFGS iteration (the k >= 2 path of LbfgsState::propagate)
# ---------------------------------------------------------------------------


def propagate_core(pdef: ProblemDef, params: LbfgsParams, st: SolverState) -> SolverState:
    """One optimization iteration (see ``_propagate_core_impl``), traced
    under the wide-fx objective-scalar mode when ``params.fx_wide``."""
    from .ops import fused

    with fused.wide_fx(params.fx_wide):
        return _propagate_core_impl(pdef, params, st)


def _propagate_core_impl(
    pdef: ProblemDef, params: LbfgsParams, st: SolverState
) -> SolverState:
    """One optimization iteration: save state, line search, history update,
    two-loop, step-size constraint, OWL-QN direction constraint.

    Mirrors ``LbfgsState::propagate`` (``src/lbfgs.rs:503-560``) except the
    k == 1 initial-progress special case, which the drivers handle (it
    involves no compute).  Fatal conditions set ``status`` instead of
    raising.

    **Line-search failure handling** (``src/line.rs:213-220``): a failure
    is terminal in the same call (the reference reverts and errors with
    "x not changed" on the NEXT propagate; here ERR_X_NOT_CHANGED is set
    immediately — same observable outcome, one call earlier).  The carried
    scalars (fx stays at the last trial value, gnorm2/xnorm2/step revert)
    are reference-exact; the x/gx VECTOR revert is applied by the drivers
    (host: Python-side fix-up per iteration; whole-run: epilogue select
    after the loop) instead of a per-iteration ``jnp.where`` — two full
    HBM select passes on every healthy iteration just to serve the
    terminal one.
    """
    prob = st.prob
    m = params.m
    lean = prob.xp is None  # see ProblemState: no xp/gp slots carried

    # save state (src/core.rs:207-210) — same buffers, no copy
    xp, gp = prob.x, prob.gx

    # fused trial+pair+Gram epilogue (``__lbfgs_trial_pair_gram__``,
    # ops/epilogue.py): when the objective provides it and its gate holds,
    # the line search returns only scalars and ONE kernel materializes the
    # accepted (x, g), writes the correction pair into the ring, and
    # produces all 6m Gram products.  Trace-time static decision (shapes,
    # dtypes, backend).
    mega_fn = getattr(pdef.value_and_grad, "__lbfgs_trial_pair_gram__", None)
    mega_ok = getattr(pdef.value_and_grad, "__lbfgs_trial_pair_gram_ok__", None)
    use_mega = (
        params.compact_two_loop
        and not pdef.orthantwise
        and int(getattr(params.linesearch, "speculative", 1) or 1) <= 1
        and mega_fn is not None
        and mega_ok is not None
        and bool(mega_ok(prob.x, st.hist.s))
    )

    with jax.named_scope("lbfgs.line_search"):
        ls = ls_find(
            pdef,
            params.linesearch,
            xp,
            prob.fx,
            gp,
            prob.pg,
            prob.d,
            st.step,
            prob.neval,
            gg0=prob.gnorm2 if not pdef.orthantwise else None,
            xx0=prob.xnorm2,
            dginit=st.dg0,
            materialize=not use_mega,
        )

    ls_failed = ls.status != 0
    if use_mega:
        with jax.named_scope("lbfgs.trial_pair_gram"):
            (x, _fx_m, gx, _dg_m, ls_gg, ls_xx, ls_changed,
             S_new, Y_new, SP, YP) = mega_fn(
                xp, prob.d, gp, ls.step_eval, st.hist.s, st.hist.y, st.end,
                with_gp=params.damping,
            )
    else:
        x = ls.x
        gx = ls.gx
        ls_gg, ls_xx, ls_changed = ls.gg, ls.xx, ls.changed
    fx = ls.fx
    step_ls = jnp.where(ls_failed, st.step, ls.step)
    ncall = ls.ncall

    # carried stop-condition norms for the new point: free byproducts of
    # the fused trial (or one post-loop reduction on the generic path);
    # on revert they are the previous point's values (scalar selects)
    if pdef.orthantwise:
        pg, pgpg = pseudo_gradient_and_norm(pdef, x, gx)
        gnorm2 = jnp.where(ls_failed, prob.gnorm2, pgpg)
    else:
        pg = None
        gnorm2 = jnp.where(ls_failed, prob.gnorm2, ls_gg)
    xnorm2 = jnp.where(ls_failed, prob.xnorm2, ls_xx)

    # positive steepest-direction base of the two-loop input d0 = -g0
    # (src/lbfgs.rs:536-537); the sign is folded into [m]-scalar
    # coefficients downstream so -g0 is never materialized
    g0 = pg if pdef.orthantwise else gx

    # history update (src/lbfgs.rs:525-533)
    i32 = lambda v: jnp.asarray(v, jnp.int32)

    # Damped fused path (src/lbfgs.rs:658-691): the damped pair is
    # y_d = a*y + b*gp with scalars a, b derived from global reductions
    # (ys, sbs) only, so the epilogue's 4th (. gp) product column yields
    # the whole bilinear basis {S, Y} x {y, s, d0, gp}; every
    # post-damping Gram quantity is then [m]-scalar math plus the carried
    # gp . gp = prob.gnorm2, and the stored ring row is fixed with one
    # row blend.
    damped_fused = use_mega and params.damping
    if params.compact_two_loop and (not params.damping or damped_fused):
        # Fused pair + Gram update: without damping the stored pair is
        # exactly (s, y) = (x - xp, gx - gp), so the pair reductions
        # (s.s, s.y, y.y) that update_pair would compute in a separate
        # [2, n] @ [n, 2] pass are ALREADY row `end` of the incremental
        # Gram products below — SP[end] = (s.y, s.s, s.d0) and
        # YP[end] = (y.y, y.s, y.d0).  One streaming pass over S and one
        # over Y covers everything.
        with jax.named_scope("lbfgs.pair_gram_update"):
            if use_mega:
                # the epilogue already wrote the pair and produced the 6m
                # products in the pass that materialized (x, g)
                s = y = None
            else:
                s = x - xp
                y = gx - gp
                S_new = _hist_set(st.hist.s, st.end, s)
                Y_new = _hist_set(st.hist.y, st.end, y)
                SP, YP = _hist_gram_pass(S_new, Y_new, y, s, g0)
                # the gram pass dots against +g0; flip to d0 = -g0
                # products ([m]-scalar negation, bitwise-exact)
                SP = SP.at[:, 2].set(-SP[:, 2])
                YP = YP.at[:, 2].set(-YP[:, 2])
            if damped_fused:
                # Reconstruct the post-damping Gram quantities from the
                # 4-column bilinear basis (reference update_pair semantics,
                # src/lbfgs.rs:658-691, incl. the literal case-2 no-op
                # unless params.damping_fixed).  y_d = a*y + b*gp:
                ridx = jnp.arange(m)
                stp_d = ls.step_eval
                ys_raw = SP[st.end, 0]          # s . y (pre-damping)
                yy_raw = YP[st.end, 0]          # y . y (pre-damping)
                sgp = SP[st.end, 3]             # s . gp
                ygp = YP[st.end, 3]             # y . gp
                gpgp = prob.gnorm2              # carried ||gp||^2
                sbs = -stp_d * sgp              # s . (-step*gp)
                sigma2, sigma3 = 0.6, 3.0
                case1 = ys_raw < (1.0 - sigma2) * sbs
                den1 = sbs - ys_raw
                theta1 = sigma2 * sbs / jnp.where(den1 == 0.0, 1.0, den1)
                if params.damping_fixed:
                    case2 = (~case1) & (ys_raw > (1.0 + sigma3) * sbs)
                    den2 = ys_raw - sbs
                    theta2 = sigma3 * sbs / jnp.where(den2 == 0.0, 1.0, den2)
                    theta = jnp.where(case1, theta1, jnp.where(case2, theta2, 1.0))
                    apply_damp = case1 | case2
                else:
                    theta = jnp.where(case1, theta1, 1.0)
                    apply_damp = case1
                a_d = jnp.where(apply_damp, theta, 1.0)
                b_d = jnp.where(apply_damp, -(1.0 - theta) * stp_d, 0.0)
                # S . y_d (row end is s . y_d — same linear form)
                u = a_d * SP[:, 0] + b_d * SP[:, 3]
                # Y . s: old rows are post-damping already; row end is
                # y_d . s == s . y_d
                w = jnp.where(ridx == st.end, u[st.end], YP[:, 1])
                # Y . y_d: linear for old rows; row end is the quadratic
                # y_d . y_d = a^2 yy + 2ab (y.gp) + b^2 (gp.gp)
                ydyd = a_d * a_d * yy_raw + 2.0 * a_d * b_d * ygp \
                    + b_d * b_d * gpgp
                v = jnp.where(
                    ridx == st.end, ydyd, a_d * YP[:, 0] + b_d * YP[:, 3]
                )
                Sd_ring = SP[:, 2]
                # gp . d0 = -(gp . gx) = -((y . gp) + gp . gp)
                yd_d0_end = a_d * YP[st.end, 2] + b_d * (-(ygp + gpgp))
                Yd_ring = jnp.where(ridx == st.end, yd_d0_end, YP[:, 2])
                # persist the damped row via the NEW gradient:
                # a*y + b*gp == (a-b)*y + b*gx (gp = gx - y), and gx is
                # the epilogue's OUTPUT — reading gp here instead would
                # force XLA to copy-protect the gp buffer the kernel
                # aliased g into.  a_d = 1, b_d = 0 on no-damping
                # iterations rewrites the row exactly.
                y_row = _hist_row(Y_new, st.end).astype(x.dtype)
                Y_new = _hist_set(
                    Y_new, st.end, (a_d - b_d) * y_row + b_d * gx
                )
                # stored ys and gamma stay PRE-damping (src/lbfgs.rs:653-656)
                ss_new, ys_new, yy_d = SP[st.end, 1], ys_raw, yy_raw
            else:
                u = SP[:, 0]         # S . y_new
                v = YP[:, 0]         # Y . y_new
                w = YP[:, 1]         # Y . s_new
                Sd_ring = SP[:, 2]   # S . d0
                Yd_ring = YP[:, 2]   # Y . d0
                ss_new, ys_new, yy_d = SP[st.end, 1], SP[st.end, 0], YP[st.end, 0]
            sy_new = st.hist.sy.at[:, st.end].set(u).at[st.end, :].set(w)
            yy_new = st.hist.yy.at[:, st.end].set(v).at[st.end, :].set(v)
            if use_mega:
                # the reference's s == 0 "x not changed" test
                # (src/lbfgs.rs:646), decided by the epilogue's exact
                # `changed` count
                x_unchanged = ls_failed | ~ls_changed
            else:
                x_unchanged = ls_failed | (ss_new == 0.0)
            status = jnp.where(x_unchanged, i32(Status.ERR_X_NOT_CHANGED), i32(0))
            status = jnp.where(
                (status == 0) & (yy_d == 0.0), i32(Status.ERR_G_NOT_CHANGED), status
            )
            # gamma = ys/yy from the PRE-damping pair (src/lbfgs.rs:653-656)
            gamma = ys_new / jnp.where(yy_d == 0.0, 1.0, yy_d)
            pu = PairUpdate(s=s, y=y, ys=ys_new, gamma=gamma, status=status)
    else:
        with jax.named_scope("lbfgs.pair_update"):
            pu = update_pair(params, x, xp, gx, gp, step_ls)
        # a failed line search surfaces as the reference's "x not changed"
        # error (src/lbfgs.rs:646 via the revert, src/line.rs:213-220)
        status = jnp.where(
            ls_failed, jnp.asarray(Status.ERR_X_NOT_CHANGED, jnp.int32), pu.status
        )
        S_new = _hist_set(st.hist.s, st.end, pu.s)
        Y_new = _hist_set(st.hist.y, st.end, pu.y)
        if params.compact_two_loop:
            # damping may have modified y, so the Gram pass runs on the
            # stored (post-damping) pair
            SP, YP = _hist_gram_pass(S_new, Y_new, pu.y, pu.s, g0)
            SP = SP.at[:, 2].set(-SP[:, 2])
            YP = YP.at[:, 2].set(-YP[:, 2])
            u = SP[:, 0]         # S . y_new
            v = YP[:, 0]         # Y . y_new
            w = YP[:, 1]         # Y . s_new
            Sd_ring = SP[:, 2]   # S . d0
            Yd_ring = YP[:, 2]   # Y . d0
            sy_new = st.hist.sy.at[:, st.end].set(u).at[st.end, :].set(w)
            yy_new = st.hist.yy.at[:, st.end].set(v).at[st.end, :].set(v)
        else:
            sy_new, yy_new = st.hist.sy, st.hist.yy
            Sd_ring = Yd_ring = None

    hist = History(
        s=S_new,
        y=Y_new,
        ys=st.hist.ys.at[st.end].set(pu.ys),
        alpha=st.hist.alpha,
        sy=sy_new,
        yy=yy_new,
    )

    # two-loop recursion (src/lbfgs.rs:538-540)
    bound = jnp.minimum(m, st.k - 1)
    with jax.named_scope("lbfgs.two_loop"):
        if params.compact_two_loop:
            # the two-loop input is d0 = -g0, with the sign folded into
            # the scalar coefficients (neg=True) — no negated vector pass
            d, alpha_ring = two_loop_compact(
                hist, g0, pu.gamma, bound, st.end, Sd_ring, Yd_ring, neg=True,
            )
        else:
            d, alpha_ring = two_loop_scan(hist, -g0, pu.gamma, bound, st.end)
    hist = hist._replace(alpha=alpha_ring)
    end_new = (st.end + 1) % m

    dnorm = vm.norm2(d)
    # parity: the reference's check is `dnorm.is_sign_positive()`, which
    # ACCEPTS +0.0 (src/lbfgs.rs:544) — reaching the exact minimum gives
    # d = 0 and must not error (the convergence test fires before the
    # zero direction is ever used); only NaN/negative is fatal
    status = jnp.where(
        (status == 0) & ~(dnorm >= 0.0), jnp.int32(Status.ERR_INVALID_DNORM), status
    )

    # next-iteration step size (src/lbfgs.rs:547-551)
    if params.constrain_step_size:
        dnorm_safe = jnp.where(dnorm == 0.0, 1.0, dnorm)
        step_next = jnp.minimum(params.max_step_size, dnorm) / dnorm_safe
    elif params.adaptive_entry_step > 0.0:
        # adapt only from REAL ladder history: the first search's accepted
        # step reflects the tiny init entry (initial_inverse_hessian/||d||),
        # not ladder depth — adapting from it makes well-scaled problems
        # crawl back up to 1.0 (measured: 13 vs 3 evals on a uniform
        # quadratic); iteration 2 enters literal
        adapted = jnp.clip(
            jnp.asarray(params.adaptive_entry_step, step_ls.dtype) * step_ls,
            2.0 ** -16, 1.0,
        )
        step_next = jnp.where(st.k <= 2, jnp.ones_like(adapted), adapted)
    else:
        step_next = jnp.ones_like(st.step)

    # OWL-QN direction constraint (src/lbfgs.rs:554, core.rs:213-217)
    if pdef.orthantwise:
        d = ow_ops.constrain_direction(pdef.owlqn, d, pg)
        status = jnp.where(
            (status == 0) & (vm.norm2(d) == 0.0),
            jnp.int32(Status.ERR_OWLQN_ZERO_DIRECTION),
            status,
        )

    # entry validation parity: a non-positive entry step is a HARD error
    # bubbling out of find (src/line.rs:197-201), not a swallowed
    # line-search failure — it overrides the revert-path bookkeeping
    status = jnp.where(
        ls.status == Status.ERR_NEGATIVE_STEP,
        jnp.int32(Status.ERR_NEGATIVE_STEP),
        status,
    )

    # dginit for the NEXT search (src/core.rs:78-92): one dot on the final
    # direction (the read find() would otherwise pay).  Carried only if
    # the entry state carried one (structure stability across drivers).
    dg0 = None if st.dg0 is None else vm.dot(g0, d)

    prob_new = ProblemState(
        x=x,
        fx=fx,
        gx=gx,
        xp=None if lean else xp,
        gp=None if lean else gp,
        pg=pg,
        d=d,
        neval=ls.neval,
        gnorm2=gnorm2,
        xnorm2=xnorm2,
    )
    return SolverState(
        prob=prob_new,
        hist=hist,
        end=end_new,
        step=step_next,
        step_ls=step_ls,
        k=st.k,
        ncall=ncall,
        status=status,
        ls_status=ls.status,
        pf=st.pf,
        dg0=dg0,
    )


def fx_delta_step(params: LbfgsParams, st: SolverState) -> SolverState:
    """Compare-then-store for the (flag-gated) past/delta fx-plateau stop
    test, run once per iteration in every driver.

    Literal semantics of the reference's dead-code ``satisfying_delta``
    (``src/lbfgs.rs:767-787``): rate = |pf[k % past] - fx| / fx with the
    CURRENT fx as (signed!) denominator, firing only once ``past <= k``;
    fx == 0 yields inf/NaN and the test simply never fires.  The ring is
    compared BEFORE the current fx is stored into its slot.
    """
    if not (params.fx_delta_enabled and params.past > 0):
        return st
    from .ops import fused

    fx = fused.obj_float(st.prob.fx)  # collapse a df carry (f64: no-op)
    slot = st.k % params.past
    rate = jnp.abs(st.pf[slot] - fx) / fx
    hit = (st.k >= params.past) & (rate < params.delta)
    status = jnp.where(
        (st.status == Status.RUNNING) & hit, jnp.int32(Status.CONVERGED), st.status
    )
    return st._replace(pf=st.pf.at[slot].set(fx), status=status)


def propagate_hot(pdef: ProblemDef, params: LbfgsParams, st: SolverState) -> SolverState:
    """Propagate for states past the k == 1 bookkeeping step (the hot
    path).  Keeping the k == 1 ``lax.cond`` out of here matters: a cond
    whose identity branch passes the history through forces XLA to copy
    the [m, n] buffers on EVERY iteration to unify branch layouts."""
    return fx_delta_step(params, propagate_core(pdef, params, st._replace(k=st.k + 1)))


def start_state(st: SolverState, params: LbfgsParams | None = None) -> SolverState:
    """The k == 1 "report initial point" bookkeeping
    (``src/lbfgs.rs:504-510``): no compute; Progress.step is the initial
    step (``src/lbfgs.rs:564``)."""
    # jnp.copy, NOT st.step itself: this runs on the HOST in the
    # step-at-a-time driver, and passing the SAME Array object in two
    # leaves of a donated jit argument specializes the executable on the
    # deduplicated buffer — the next call (with distinct step/step_ls)
    # then fails with a buffer-count mismatch (reproduced under the df32
    # fx carry, whose stable signatures never mask it with a retrace)
    st = st._replace(k=jnp.ones_like(st.k), step_ls=jnp.copy(st.step))
    if params is not None:
        st = fx_delta_step(params, st)
    return st


def propagate(pdef: ProblemDef, params: LbfgsParams, st: SolverState) -> SolverState:
    """Full propagate, including the k == 1 special case as a ``lax.cond``
    so it is traceable with per-instance k (used by the vmapped batch
    driver; solo drivers use ``start_state`` + ``propagate_hot``)."""
    st = st._replace(k=st.k + 1)

    def first(s: SolverState) -> SolverState:
        return fx_delta_step(params, s._replace(step_ls=s.step))

    def rest(s: SolverState) -> SolverState:
        return fx_delta_step(params, propagate_core(pdef, params, s))

    return lax.cond(st.k == 1, first, rest, st)


# ---------------------------------------------------------------------------
# Initialization (the build path)
# ---------------------------------------------------------------------------


def init_state(
    pdef: ProblemDef, params: LbfgsParams, x0: Array, lean: bool = False
) -> SolverState:
    """Initial evaluation + steepest-descent direction + initial step.

    Mirrors ``Lbfgs::build`` (``src/lbfgs.rs:443-481``): evaluate at x0,
    d = -g (or -pg), step = initial_inverse_hessian / ||d||.

    ``lean=True`` omits the xp/gp previous-point slots from the carried
    state (see ``ProblemState``): used by the whole-run jitted drivers,
    where the slots would cost two full-vector copies per iteration and a
    line-search failure is terminal within the same call.
    """
    from .ops import fused

    if params.fx_wide and not jax.config.jax_enable_x64:
        # x64-free wide carry: fx travels as a double-float (two-f32)
        # pair (~48-bit resolution, ops/df.py) instead of a real f64 —
        # no process-global flag, no dtype-semantics blast radius.
        # Supported across More-Thuente AND the backtracking family
        # (decisions via df compares; interval geometry consumes the
        # sub-ULP-resolved f-value differences).
        if int(getattr(params.linesearch, "speculative", 1) or 1) > 1:
            raise ValueError(
                "fx_wide without jax_enable_x64 is incompatible with "
                "the speculative line search; enable x64 or disable "
                "speculation."
            )
    with fused.wide_fx(params.fx_wide):
        return _init_state_impl(pdef, params, x0, lean)


def _init_state_impl(
    pdef: ProblemDef, params: LbfgsParams, x0: Array, lean: bool = False
) -> SolverState:
    n = x0.shape[0]
    dtype = x0.dtype
    m = params.m
    from .ops import fused

    fx, gx = evaluate(pdef, x0)
    pg = pseudo_gradient(pdef, x0, gx) if pdef.orthantwise else None
    g0 = pg if pdef.orthantwise else gx
    d = -g0
    gnorm2 = vm.dot(g0, g0)
    gnorm2_safe = jnp.where(gnorm2 == 0.0, 1.0, gnorm2)
    # step = initial_inverse_hessian / ||d||, and ||d|| = ||g or pg||
    step = params.initial_inverse_hessian / jnp.sqrt(gnorm2_safe)

    prob = ProblemState(
        x=x0,
        fx=fx,
        gx=gx,
        xp=None if lean else jnp.zeros_like(x0),
        gp=None if lean else jnp.zeros_like(x0),
        pg=pg,
        d=d,
        neval=jnp.asarray(1, jnp.int32),
        gnorm2=gnorm2,
        xnorm2=vm.dot(x0, x0),
    )
    hdtype = jnp.dtype(params.history_dtype) if params.history_dtype else dtype
    hist = History(
        s=jnp.zeros(hist_store_shape(m, n), hdtype),
        y=jnp.zeros(hist_store_shape(m, n), hdtype),
        ys=jnp.zeros((m,), dtype),
        alpha=jnp.zeros((m,), dtype),
        sy=jnp.zeros((m, m), dtype),
        yy=jnp.zeros((m, m), dtype),
    )
    if params.fx_delta_enabled and params.past > 0:
        # fx ring for the past/delta plateau test: zero-initialized like
        # the reference's pf allocation, with the k == 0 store applied
        # (the compare never fires at k == 0 since past >= 1).  Carries
        # the collapsed objective value (f64 under wide-fx/x64; the df32
        # carry collapses to f32 — the plateau RATE needs no extra bits).
        fxv = fused.obj_float(fx)
        pf = jnp.zeros((params.past,), fxv.dtype).at[0].set(fxv)
    else:
        pf = None
    return SolverState(
        prob=prob,
        hist=hist,
        end=jnp.asarray(0, jnp.int32),
        step=step,
        step_ls=step,
        k=jnp.asarray(0, jnp.int32),
        ncall=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(0, jnp.int32),
        ls_status=jnp.asarray(0, jnp.int32),
        pf=pf,
        # d = -g0, so dginit = g0 . d = -||g0||^2 exactly (IEEE sign
        # symmetry) — the first search's dot for free
        dg0=-gnorm2,
    )


# ---------------------------------------------------------------------------
# Stop conditions (src/lbfgs.rs:695-748)
# ---------------------------------------------------------------------------


def stop_status(pdef: ProblemDef, params: LbfgsParams, st: SolverState) -> Array:
    """Return the stop Status for the CURRENT state (checked before each
    propagate, ``src/lbfgs.rs:407-410``), or RUNNING.

    Order parity with ``satisfying_stop_conditions`` (``src/lbfgs.rs:697-709``):
    max_iterations, then max_evaluations, then scaled gnorm.  The past/delta
    test is dead code in the reference (``src/lbfgs.rs:702``) and only runs
    here when ``params.fx_delta_enabled`` (see drivers).
    """
    i32 = lambda v: jnp.asarray(v, jnp.int32)
    from .core import gnorm_of, xnorm_of

    gnorm = gnorm_of(pdef, st.prob)
    xnorm = xnorm_of(st.prob)

    # short-circuit priority: max_iterations, max_evaluations, scaled gnorm
    out = i32(Status.RUNNING)
    # a state already carrying a terminal status (e.g. the fx-plateau test
    # applied inside propagate, or a recorded cancellation) reports it
    if st.status is not None:
        out = jnp.where(st.status != Status.RUNNING, st.status, out)
    if params.max_iterations != 0:
        out = jnp.where(st.k >= params.max_iterations, i32(Status.MAX_ITERATIONS), out)
    if params.max_evaluations != 0:
        out = jnp.where(
            (out == Status.RUNNING) & (st.prob.neval >= params.max_evaluations),
            i32(Status.MAX_EVALUATIONS),
            out,
        )
    out = jnp.where(
        (out == Status.RUNNING) & (gnorm / jnp.maximum(xnorm, 1.0) <= params.epsilon),
        i32(Status.CONVERGED),
        out,
    )
    return out
