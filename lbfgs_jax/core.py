"""Core solver state pytrees and the objective-evaluation boundary.

Re-design of the reference ``Problem`` (``src/core.rs:10-218``):
the reference owns seven mutable ``f64`` vectors and an eval closure; here
the same quantities live in an immutable ``ProblemState`` pytree that flows
through jit-compiled steps (XLA buffer donation recovers in-place updates).
``Progress`` and ``Report`` mirror ``src/core.rs:223-299``.

The user-objective boundary (``Problem::evaluate``, ``src/core.rs:119-132``)
supports three shapes:

  * ``fn(x) -> (fx, gx)``        traceable value-and-grad (canonical, fastest)
  * ``fn(x) -> fx``              traceable scalar; gradient via ``jax.grad``
  * ``fn(x, gx) -> fx``          reference-style black-box host closure
                                 (mutates ``gx`` in place); bridged into jit
                                 via ``jax.experimental.io_callback``

OWL-QN bookkeeping (L1 term added to fx, pseudo-gradient) is folded in here,
exactly as the reference does inside ``evaluate`` (``src/core.rs:123-126``).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from . import orthantwise as ow_ops
from .orthantwise import Orthantwise


class ProblemState(NamedTuple):
    """Optimization vectors (reference ``Problem``, ``src/core.rs:10-52``)."""

    x: Array      #: current point                      [n]
    fx: Array     #: objective at x (incl. OWL-QN L1)   scalar
    gx: Array     #: true gradient at x                 [n]
    #: previous point / gradient.  ``None`` in the LEAN state used by the
    #: whole-run jitted drivers: inside one iteration the "previous" values
    #: are simply the entry x/gx (same buffers), and carrying dedicated
    #: xp/gp slots costs two full-vector copies per ``while_loop``
    #: iteration (XLA while carries have fixed per-slot buffers, so the
    #: x->xp rotation is a real HBM copy).  The host step-at-a-time driver
    #: keeps them for reference-exact Progress/revert reporting
    #: (``src/core.rs:201-210``); on the lean path a line-search failure is
    #: terminal in the same jitted call (the driver raises, as the
    #: reference's minimize returns Err), so the previous point is never
    #: observable.
    xp: Array     #: previous point (or None: lean)     [n]
    gp: Array     #: previous gradient (or None: lean)  [n]
    #: OWL-QN pseudo-gradient.  ``None`` whenever OWL-QN is off: the
    #: reference keeps pg == gx in that regime (``src/core.rs:95-101``),
    #: and carrying the duplicate costs a full-vector copy per iteration.
    pg: Array     #: OWL-QN pseudo-gradient (None when OWL-QN off) [n]
    d: Array      #: search direction                   [n]
    neval: Array  #: total objective evaluations        i32 scalar
    #: carried squared norms of the CURRENT point/gradient (pg under
    #: OWL-QN), maintained by the solver so the per-iteration stop test
    #: (src/lbfgs.rs:714-722) costs zero vector reads — they come out of
    #: the line search's trial reductions
    gnorm2: Array = None  #: ||pg or gx||^2   scalar
    xnorm2: Array = None  #: ||x||^2          scalar

    # NOTE: the reference also persists the orthant indicator `wp`
    # (src/core.rs:36), but it is recomputed before every backtracking
    # search (src/line.rs:733-736) in both codebases, so carrying it in the
    # state would only waste an [n] buffer — it lives inside the line
    # search here.


class History(NamedTuple):
    """Fixed-shape circular (s, y) correction history.

    Replaces the reference's ``Vec<IterationData>`` ring
    (``src/lbfgs.rs:606-627``) with dense stacks so the two-loop
    recursion vectorizes/shards (the n axis carries the sharding).

    **Storage layout:** when n is lane-aligned (n % 128 == 0) the stacks
    are stored ring-major as ``[m, n/128, 128]`` — the blocked view the
    fused epilogue (``ops/epilogue.py``) reads; unaligned n uses
    ``[m, n]``.  Both hold the same elements in the same row-major order.
    Use ``hist_store_shape`` / the ``_hist_*`` helpers in ``solver.py``;
    rows are always [n] vectors at the API boundary.

    ``sy``/``yy`` cache the Gram blocks of the Byrd–Nocedal–Schnabel
    compact representation (sy[i, j] = s_i . y_j in ring-slot indexing),
    updated incrementally — one fused pass per iteration — so the compact
    two-loop never recomputes O(m^2 n) products.  The scan-mode two-loop
    ignores them.
    """

    s: Array      #: position differences   [m, n/128, 128] or [m, n]
    y: Array      #: gradient differences   [m, n/128, 128] or [m, n]
    ys: Array     #: y_j . s_j              [m]
    alpha: Array  #: two-loop alpha scratch [m]
    sy: Array     #: Gram cache s_i . y_j   [m, m]
    yy: Array     #: Gram cache y_i . y_j   [m, m]


#: the history's minor storage dim when aligned
HIST_LANES = 128


def hist_store_shape(m: int, n: int) -> tuple:
    """Storage shape for the (s, y) stacks (see ``History``).

    It depends on n alone, never on the devices present, so a state
    keeps its layout whichever host or mesh runs it; under a mesh the
    rows axis carries the vector sharding (``parallel.state_shardings``).
    """
    if n % HIST_LANES:
        return (m, n)
    return (m, n // HIST_LANES, HIST_LANES)


class SolverState(NamedTuple):
    """Full resumable solver state (reference ``LbfgsState``, ``src/lbfgs.rs:424-439``).

    A plain pytree: trivially checkpointable (np.save / orbax) and vmappable
    for the scenario-batch regime.
    """

    prob: ProblemState
    hist: History
    end: Array      #: ring index of newest correction pair   i32
    step: Array     #: line-search step for next iteration    scalar
    step_ls: Array  #: step accepted by the last line search  scalar
    k: Array        #: iteration counter                      i32
    ncall: Array    #: evals used by the last line search     i32
    status: Array   #: Status code                            i32
    #: internal status of the last line search (LS_* code, or 0) — the
    #: reference logs + swallows these at the failure site
    #: (``src/line.rs:213-220``); carrying the code out of the jitted step
    #: lets the host drivers emit the same ``error!`` lines
    ls_status: Array = None  # i32
    #: fx ring for the (flag-gated) past/delta plateau stop test
    #: (``src/lbfgs.rs:767-787``): [past], present only when
    #: ``params.fx_delta_enabled`` — see ``solver.fx_delta_step``
    pf: Array = None
    #: carried dginit = g . d for the next line search
    #: (``src/core.rs:78-92``) — one dot after the direction update, so
    #: ``linesearch.find`` never re-reads the vectors.  None on states
    #: restored from pre-dg0 checkpoints (find falls back to computing it).
    dg0: Array = None


# ---------------------------------------------------------------------------
# Objective normalization
# ---------------------------------------------------------------------------

EvalFn = Callable[[Array], tuple[Array, Array]]


@dataclasses.dataclass(frozen=True)
class ProblemDef:
    """Static problem definition closed over by the jitted step."""

    value_and_grad: EvalFn
    owlqn: Optional[Orthantwise] = None

    @property
    def orthantwise(self) -> bool:
        return self.owlqn is not None


def host_objective(fn: Callable, like: Array) -> EvalFn:
    """Bridge a reference-style mutating closure ``fn(x, gx) -> fx`` into jit.

    The callback runs on the host per evaluation via ``io_callback``
    (ordered: the closure may be stateful, as ``FnMut`` is in the reference).
    """
    from jax.experimental import io_callback

    shape = jax.ShapeDtypeStruct(like.shape, like.dtype)
    fshape = jax.ShapeDtypeStruct((), like.dtype)

    def _host(x):
        x = np.asarray(x)
        g = np.zeros_like(x)
        fx = fn(x, g)
        return np.asarray(fx, dtype=x.dtype), g

    def vag(x):
        return io_callback(_host, (fshape, shape), x, ordered=True)

    # marks objectives that cannot be vmapped/traced freely (ordered
    # io_callback); consumed by linesearch.find to reject incompatible
    # modes (e.g. speculative search) with a clear error
    vag.__lbfgs_host_callback__ = True
    return vag


def normalize_objective(fn: Callable, x0: Array) -> EvalFn:
    """Accept any of the three supported objective shapes; return (fx, gx) fn."""
    if getattr(fn, "__lbfgs_value_and_grad__", False):
        return fn
    try:
        # count REQUIRED positional parameters only: a 1-arg objective with
        # optional kwargs (def f(x, verbose=False)) must not be mistaken
        # for the reference-style mutating closure f(x, gx)
        nparams = sum(
            1
            for p in inspect.signature(fn).parameters.values()
            if p.default is inspect.Parameter.empty
            and p.kind
            in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        )
    except (TypeError, ValueError):
        nparams = 1
    if nparams >= 2:
        return host_objective(fn, x0)
    # 1-arg: decide scalar vs value-and-grad by abstract evaluation
    try:
        out = jax.eval_shape(fn, jax.ShapeDtypeStruct(x0.shape, x0.dtype))
    except Exception:
        # untraceable 1-arg host function returning (fx, gx)
        def _host2(x, g):
            fx, gx = fn(np.asarray(x))
            g[...] = gx
            return fx

        return host_objective(_host2, x0)
    if isinstance(out, (tuple, list)):
        return fn
    return jax.value_and_grad(fn)


def evaluate(pdef: ProblemDef, x: Array) -> tuple[Array, Array]:
    """One objective evaluation, with the OWL-QN L1 term folded into fx.

    Mirrors ``Problem::evaluate`` (``src/core.rs:119-132``) minus the
    pseudo-gradient, which callers recompute only where needed
    (``pseudo_gradient`` below) to keep line-search trials lean.

    Under ``fused.wide_fx`` (``params.fx_wide``) the returned fx carries
    as f64 — the reference's objective resolution (``src/math.rs:4-82``)
    restored on top of f32 vector streams.
    """
    from .ops import fused

    fx, gx = pdef.value_and_grad(x)
    if fused.wide_fx_active():
        # lift into the wide representation (f64, or the two-f32
        # double-float when x64 is off — fused.wide_mode); a no-op when
        # the objective's own obj_sum already produced one
        fx = fused.obj_lift(fx)
    if pdef.owlqn is not None:
        fx = fused.obj_add(fx, ow_ops.x1norm(pdef.owlqn, x))
    return fx, gx


def pseudo_gradient(pdef: ProblemDef, x: Array, gx: Array) -> Array:
    """pg for OWL-QN, or gx itself otherwise (``src/core.rs:123-126``)."""
    if pdef.owlqn is not None:
        return ow_ops.pseudo_gradient(pdef.owlqn, x, gx)
    return gx


def pseudo_gradient_and_norm(pdef: ProblemDef, x: Array, gx: Array) -> tuple[Array, Array]:
    """(pg, pg . pg) — the solver's post-line-search OWL-QN epilogue."""
    assert pdef.owlqn is not None
    from .ops import vecmath as vm

    pg = ow_ops.pseudo_gradient(pdef.owlqn, x, gx)
    return pg, vm.dot(pg, pg)


def fx_host(fx) -> float:
    """Host-side objective value for Progress/Report: collapses the
    x64-free wide carry (a (2,)-f32 double-float leaf, ops/df.py) in f64;
    plain/f64 scalars pass through."""
    a = np.asarray(fx)
    if a.ndim >= 1 and a.shape[-1] == 2:
        return float(np.float64(a[..., 0]) + np.float64(a[..., 1]))
    return float(a)


def gnorm_of(pdef: ProblemDef, prob: ProblemState) -> Array:
    """||pg|| under OWL-QN else ||gx|| (``src/core.rs:183-189``).

    Uses the carried squared norm when present (zero vector reads)."""
    if prob.gnorm2 is not None:
        import jax.numpy as jnp

        return jnp.sqrt(prob.gnorm2)
    from .ops import vecmath as vm

    pg = prob.pg if (pdef.orthantwise and prob.pg is not None) else prob.gx
    return vm.norm2(pg)


def xnorm_of(prob: ProblemState) -> Array:
    """||x||, from the carried squared norm when present."""
    if prob.xnorm2 is not None:
        import jax.numpy as jnp

        return jnp.sqrt(prob.xnorm2)
    from .ops import vecmath as vm

    return vm.norm2(prob.x)


# ---------------------------------------------------------------------------
# Progress / Report (host-facing)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Progress:
    """Per-iteration snapshot handed to the progress callback
    (reference ``Progress``, ``src/core.rs:223-269``)."""

    x: Array
    gx: Array
    fx: float
    xnorm: float
    gnorm: float
    step: float
    niter: int
    neval: int
    ncall: int


@dataclasses.dataclass
class Report:
    """Final optimization outcome (reference ``Report``, ``src/core.rs:273-299``).

    This build adds ``x`` (arrays are immutable here; the reference
    mutates the caller's buffer instead) and ``niter``/``status``.
    """

    fx: float
    xnorm: float
    gnorm: float
    neval: int
    x: Array = None
    niter: int = 0
    status: int = 0
