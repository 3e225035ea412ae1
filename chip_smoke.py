"""Bring-up check of the solver on one NVIDIA GPU.

Drives the library's public entry points at the sizes its users run and
checks every result against an independent reference:

  * ``gpu_checks``: the ``gpu``-marked tests (tests/test_gpu_smoke.py),
    among them the Triton-compiled fused epilogue against its jnp oracle;
  * ``rosenbrock``: extended Rosenbrock at n = 1e8 (f32, bf16 history,
    m = 6) through ``lbfgs().minimize_jit`` and the host loop
    ``lbfgs().minimize`` with a progress callback; the reported fx against
    an f64 evaluation at the returned x, and the step's
    ``compiled.memory_analysis()``;
  * ``native_parity``: plain, damped and OWL-QN Rosenbrock at n = 2^20 to
    epsilon against the native f64 C++ core (iterations and final fx);
  * ``owlqn`` at 2^24 and ``owlqn_wide`` at 1e8 (``with_fx_wide``),
    ``damped`` at 2^24: stepped, fx against an f64 evaluation;
  * ``logistic``: the L1 log-linear fit at 2^15 x 2^13 with f32 X, under
    the default and the "highest" matmul precision, fx against an f64
    evaluation; a 500 x 21 fit against the native f64 core;
  * ``batch``: ``minimize_batched`` with B = 10,000 x n = 64 against the
    unbatched solves of sampled instances;
  * ``precision``: Gram entries under "default"/"highest" against f64,
    and time to epsilon at 2^24 under each;
  * ``kernel_vs_xla``: iters/s of the fused epilogue against the plain
    XLA path at 2^24 and 1e8 (alternating, one process);
  * ``trace``: per-phase device time of both paths at 2^24.

``--four-cards`` runs only the sharded path: ``parallel.make_mesh`` +
``shard_vector`` + ``minimize_jit`` at n = 2^27 for plain and OWL-QN,
against the same problems on one card.

Every phase prints one JSON line; any failed check raises and the script
exits non-zero.  The last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Run it on a machine with an NVIDIA GPU:  ``python chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

GPU_SIZES = dict(
    big=100_000_000, mid=1 << 24, ref=1 << 20, logistic=(1 << 15, 1 << 13),
    batch=(10_000, 64), four=1 << 27, big_iters=30, mid_iters=100,
)


def card_info() -> str:
    """``nvidia-smi`` name and power limit, read by a child process that
    stays off JAX."""
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip() or out.stderr.strip()


def emit(phase: str, **kw) -> dict:
    print(json.dumps({"phase": phase, **kw}), flush=True)
    return kw


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _rosen_f64(x) -> float:
    import numpy as np

    x = np.asarray(x, np.float64)
    e, o = x[0::2], x[1::2]
    return float(np.sum((1.0 - e) ** 2 + (10.0 * (o - e * e)) ** 2))


def _l1(x, start, end) -> float:
    import numpy as np

    return float(np.sum(np.abs(np.asarray(x, np.float64)[start:end])))


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _aot(params, pdef, x0):
    """AOT-compile the whole-run solve; returns (compiled, compile_s)."""
    import jax

    from lbfgs_jax.minimize import _run_while
    from lbfgs_jax.solver import init_state

    fn = jax.jit(lambda x: _run_while(pdef, params,
                                      init_state(pdef, params, x, lean=True)))
    return _timed(lambda: fn.lower(x0).compile())


def _rate(compiled, x0, runs=3):
    """iters/s of each of ``runs`` calls (the last state is returned)."""
    rates = []
    st = None
    for _ in range(runs):
        t0 = time.perf_counter()
        st = compiled(x0)
        float(st.prob.fx)
        rates.append((int(st.k) - 1) / (time.perf_counter() - t0))
    return rates, st


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_gpu_checks() -> dict:
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "gpu_smoke", os.path.join(here, "tests", "test_gpu_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ran = []
    mod.test_propagate_runs_on_gpu(None)
    ran.append("propagate")
    for rows in (512, 1001):
        for with_gp in (False, True):
            mod.test_epilogue_compiled_matches_reference(None, rows, with_gp)
            ran.append(f"epilogue_rows{rows}_gp{int(with_gp)}")
    mod.test_epilogue_solver_matches_plain_path(None)
    ran.append("epilogue_solver")
    return emit("gpu_checks", passed=ran)


def phase_rosenbrock(n: int, iters: int) -> dict:
    """1e8 Rosenbrock through minimize_jit and the host loop."""
    import jax
    import jax.numpy as jnp

    from lbfgs_jax import lbfgs
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.solver import init_state, propagate_hot, start_state

    vag = rosenbrock.value_and_grad
    b = (lbfgs().with_history_dtype("bfloat16").with_epsilon(0.0)
         .with_max_iterations(iters + 1))
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    fx0 = _rosen_f64(x0)
    rep, first_s = _timed(lambda: b.minimize_jit(x0, vag))
    rep2, steady_s = _timed(lambda: b.minimize_jit(x0, vag))
    fx_ref = _rosen_f64(rep.x)
    check(rep.niter == iters + 1 and rep2.fx == rep.fx,
          "minimize_jit is not deterministic across calls")
    check(rep.fx < fx0, "minimize_jit did not decrease fx")
    check(abs(rep.fx - fx_ref) <= 1e-4 * fx_ref,
          f"reported fx {rep.fx} vs f64 evaluation {fx_ref}")

    # the host loop: one jitted propagate step per iteration
    params = b.param
    pdef = ProblemDef(value_and_grad=vag)
    st = start_state(jax.jit(lambda x: init_state(pdef, params, x))(x0),
                     params)
    # donated like the host driver's own step (LbfgsState)
    step = jax.jit(lambda s: propagate_hot(pdef, params, s), donate_argnums=0)
    mem = step.lower(st).compile().memory_analysis()
    del st
    seen = []
    host = (lbfgs().with_history_dtype("bfloat16").with_epsilon(0.0)
            .with_max_iterations(6))
    rep_h = host.minimize(x0, vag, lambda p: seen.append(p.fx) and False)
    check(len(seen) >= 5 and all(a >= b_ for a, b_ in zip(seen, seen[1:])),
          f"host loop fx not monotone: {seen}")
    check(abs(rep_h.fx - _rosen_f64(rep_h.x)) <= 1e-4 * abs(rep_h.fx),
          "host-loop fx disagrees with the f64 evaluation")
    return emit(
        "rosenbrock", n=n, iters=iters,
        first_call_s=first_s, steady_call_s=steady_s,
        compile_and_setup_s=first_s - steady_s,
        iters_per_s=iters / steady_s, fx=rep.fx, fx_f64=fx_ref, fx0=fx0,
        host_loop_fx=seen,
        step_memory={k: getattr(mem, k) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes")},
    )


def phase_native_parity(n: int) -> dict:
    """Plain and damped Rosenbrock to epsilon = 1e-4, and OWL-QN over a
    fixed 40 iterations, on the card (f32 vectors) against the native f64
    core.  Tolerances come from the dtype: near the plain minimum 0 the
    converged fx agrees to 1e-3 absolute and the iteration count to
    within 25%; OWL-QN's Armijo accepts round differently in f32, which
    measured 6e-5 relative after 40 iterations at n = 2^20 on the CPU, so
    5e-4 relative.  (epsilon = 1e-4 stays clear of the f32 floor: the
    gradient rounding of f32 Rosenbrock near x = 1 alone gives
    ||g|| / ||x|| of about 2e-5, so a run to 1e-5 converges only when the
    iterate lands exactly on the minimum.  To epsilon, OWL-QN Rosenbrock
    stalls at the f32 resolution of the iterate and the f64 oracle stops
    on a zero direction, so a fixed prefix is the comparable quantity.)"""
    import jax.numpy as jnp
    import numpy as np

    from lbfgs_jax import lbfgs
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.native import minimize_native_rosenbrock

    out = {}
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    for variant in ("plain", "damped", "owlqn"):
        if variant == "owlqn":
            b = (lbfgs().with_orthantwise(1.0, 0, None).with_epsilon(0.0)
                 .with_max_iterations(40))
        else:
            b = (lbfgs().with_epsilon(1e-4).with_max_iterations(2000)
                 .with_damping(variant == "damped"))
        rep, dt = _timed(lambda: b.minimize_jit(x0, rosenbrock.value_and_grad))
        ref, ref_dt = _timed(lambda: minimize_native_rosenbrock(
            b.param, np.asarray(x0, np.float64)))
        if variant == "owlqn":
            check(rep.niter == ref.niter == 40, "OWL-QN prefix lengths differ")
            check(abs(rep.fx - ref.fx) <= 5e-4 * abs(ref.fx),
                  f"{variant}: fx {rep.fx} vs native {ref.fx}")
        else:
            check(rep.status == 1 and ref.status == 1,
                  f"{variant}: status {rep.status} (native {ref.status})")
            check(abs(rep.fx - ref.fx) <= 1e-3,
                  f"{variant}: fx {rep.fx} vs native {ref.fx}")
            check(abs(rep.niter - ref.niter) <= 0.25 * ref.niter,
                  f"{variant}: {rep.niter} iterations vs native {ref.niter}")
        out[variant] = dict(niter=rep.niter, fx=rep.fx, seconds=dt,
                            native_niter=ref.niter, native_fx=ref.fx,
                            native_seconds=ref_dt)
    return emit("native_parity", n=n, **out)


def phase_owlqn(n: int, iters: int, wide: bool) -> dict:
    import jax.numpy as jnp

    from lbfgs_jax import lbfgs
    from lbfgs_jax.models import rosenbrock

    b = (lbfgs().with_orthantwise(1.0, 0, None).with_epsilon(0.0)
         .with_max_iterations(iters + 1).with_history_dtype("bfloat16"))
    if wide:
        b = b.with_fx_wide()
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    rep, first_s = _timed(lambda: b.minimize_jit(x0, rosenbrock.value_and_grad))
    _, steady_s = _timed(lambda: b.minimize_jit(x0, rosenbrock.value_and_grad))
    fx0 = _rosen_f64(x0) + _l1(x0, 0, n)
    fx_ref = _rosen_f64(rep.x) + _l1(rep.x, 0, n)
    check(rep.fx < fx0, "OWL-QN did not decrease fx")
    # the wide carry resolves fx to ~1e-7 relative at this magnitude
    check(abs(rep.fx - fx_ref) <= (1e-6 if wide else 1e-4) * fx_ref,
          f"OWL-QN fx {rep.fx} vs f64 evaluation {fx_ref}")
    _, host_s = _timed(lambda: (lbfgs().with_orthantwise(1.0, 0, None)
                                .with_max_iterations(4)
                                .minimize(x0, rosenbrock.value_and_grad)))
    return emit("owlqn_wide" if wide else "owlqn", n=n, iters=iters,
                compile_and_setup_s=first_s - steady_s,
                iters_per_s=iters / steady_s, fx=rep.fx, fx_f64=fx_ref,
                fx0=fx0, host_loop_4_iters_s=host_s)


def phase_damped(n: int, iters: int) -> dict:
    """Damped Rosenbrock through the fused epilogue, against the same
    iterations on the plain XLA path."""
    import jax.numpy as jnp

    from lbfgs_jax import lbfgs
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.ops.factory import without_epilogue

    vag = rosenbrock.value_and_grad
    b = (lbfgs().with_damping(True).with_epsilon(0.0)
         .with_max_iterations(iters + 1).with_history_dtype("bfloat16"))
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    rep, first_s = _timed(lambda: b.minimize_jit(x0, vag))
    _, steady_s = _timed(lambda: b.minimize_jit(x0, vag))
    rep_p = b.minimize_jit(x0, without_epilogue(vag))
    fx_ref = _rosen_f64(rep.x)
    check(rep.fx < _rosen_f64(x0), "damped run did not decrease fx")
    check(abs(rep.fx - fx_ref) <= 1e-4 * fx_ref,
          f"damped fx {rep.fx} vs f64 evaluation {fx_ref}")
    _, host_s = _timed(lambda: (lbfgs().with_damping(True)
                                .with_max_iterations(4).minimize(x0, vag)))
    return emit("damped", n=n, iters=iters,
                compile_and_setup_s=first_s - steady_s,
                iters_per_s=iters / steady_s, fx=rep.fx, fx_f64=fx_ref,
                plain_path_fx=rep_p.fx, host_loop_4_iters_s=host_s)


def _logistic_f64(X, y, beta, c) -> float:
    import numpy as np

    X = np.asarray(X, np.float64)
    y = np.asarray(y, np.float64)
    beta = np.asarray(beta, np.float64)
    xb = X @ beta
    return float(-np.sum(y * xb - np.exp(xb)) + c * np.sum(np.abs(beta[1:])))


def phase_logistic(nrow: int, ncol: int, iters: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lbfgs_jax import lbfgs
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.models import logistic
    from lbfgs_jax.native import minimize_native
    from lbfgs_jax.orthantwise import Orthantwise
    from lbfgs_jax.params import LbfgsParams, LineSearchAlgorithm

    X, y = logistic.synthetic_device(nrow, ncol, seed=0, dtype=jnp.float32)
    ow = Orthantwise(c=1.0, start=1, end=ncol)
    params = LbfgsParams(
        max_iterations=iters + 1, epsilon=0.0, orthantwise=ow,
        history_dtype="bfloat16",
    ).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)
    out = {}
    for prec in (None, "highest"):
        from lbfgs_jax.minimize import _run_while
        from lbfgs_jax.solver import init_state

        def solve(X_, y_, b0):
            pdef = ProblemDef(value_and_grad=logistic.make_objective(
                X_, y_, precision=prec), owlqn=ow)
            return _run_while(pdef, params,
                              init_state(pdef, params, b0, lean=True))

        b0 = jnp.zeros((ncol,), jnp.float32)
        comp, comp_s = _timed(lambda: jax.jit(solve).lower(X, y, b0).compile())
        st = comp(X, y, b0)
        float(st.prob.fx)
        st, dt = _timed(lambda: comp(X, y, b0))
        fx = float(st.prob.fx)
        fx_ref = _logistic_f64(X, y, st.prob.x, 1.0)
        check(abs(fx - fx_ref) <= 1e-4 * abs(fx_ref),
              f"logistic[{prec}] fx {fx} vs f64 evaluation {fx_ref}")
        out[str(prec or "default")] = dict(
            compile_s=comp_s, iters_per_s=(int(st.k) - 1) / dt, fx=fx,
            fx_f64=fx_ref, neval=int(st.prob.neval),
            nnz=int(np.sum(np.asarray(st.prob.x)[1:] != 0.0)))
    check(abs(out["default"]["fx"] - out["highest"]["fx"])
          <= 1e-3 * abs(out["highest"]["fx"]),
          "logistic fx differs between matmul precisions")

    # the reference's 500 x 21 workload in f64 (as the reference runs it:
    # in f32 the first line-search trials overflow exp) against the native
    # f64 core, at the reference's golden tolerance of 1e-6
    with jax.enable_x64(True):
        Xs, ys = logistic.synthetic_dataset(dtype=jnp.float64)
        rep = (lbfgs().with_orthantwise(1.0, 1, 21).with_epsilon(1e-4)
               .minimize_jit(jnp.zeros(21, jnp.float64),
                             logistic.make_objective(Xs, ys)))
    Xn, yn = np.asarray(Xs, np.float64), np.asarray(ys, np.float64)

    def f_np(b, g):
        xb = Xn @ b
        e = np.exp(xb)
        g[:] = -(Xn.T @ (yn - e))
        return float(-np.sum(yn * xb - e))

    ref = minimize_native(
        LbfgsParams(epsilon=1e-4, orthantwise=Orthantwise(1.0, 1, 21)),
        np.zeros(21), f_np)
    check(abs(rep.fx - ref.fx) <= 1e-6 * abs(ref.fx),
          f"500x21 fx {rep.fx} vs native {ref.fx}")
    return emit("logistic", nrow=nrow, ncol=ncol, iters=iters, **out,
                small_500x21=dict(fx=rep.fx, native_fx=ref.fx,
                                  niter=rep.niter, native_niter=ref.niter))


def phase_batch(B: int, n: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lbfgs_jax import lbfgs
    from lbfgs_jax.models import rosenbrock

    base = rosenbrock.initial_point(n, dtype=jnp.float32)
    x0b = base + 0.1 * jax.random.normal(jax.random.PRNGKey(0), (B, n),
                                         jnp.float32)
    b = lbfgs().with_epsilon(1e-4).with_max_iterations(500)
    out, first_s = _timed(lambda: jax.block_until_ready(
        b.minimize_batched(x0b, rosenbrock.value_and_grad)))
    out, steady_s = _timed(lambda: jax.block_until_ready(
        b.minimize_batched(x0b, rosenbrock.value_and_grad)))
    fx = np.asarray(out["fx"])
    niter = np.asarray(out["niter"])
    check(np.all(np.asarray(out["status"]) == 1), "a batch instance did not "
          "converge")
    # the vmapped program rounds its reductions differently (and on a GPU
    # its Gram contractions run in TF32), so f32 trajectories through the
    # Rosenbrock valley take different numbers of iterations; the
    # converged solutions must agree
    picks = sorted({0, B // 3, B // 2, B - 1})
    solo_niter = []
    for i in picks:
        rep = b.minimize_jit(x0b[i], rosenbrock.value_and_grad)
        solo_niter.append((int(niter[i]), rep.niter))
        check(rep.status == 1, f"unbatched instance {i} did not converge")
        check(abs(float(fx[i]) - rep.fx) <= 1e-4,
              f"instance {i}: fx {fx[i]} vs unbatched {rep.fx}")
        check(float(np.max(np.abs(np.asarray(out["x"][i]) - np.asarray(rep.x))))
              <= 2e-2, f"instance {i}: minimizers differ")
    return emit("batch", B=B, n=n, compile_and_setup_s=first_s - steady_s,
                seconds=steady_s, instances_per_s=B / steady_s,
                max_niter=int(niter.max()), checked=picks,
                batched_vs_unbatched_niter=solo_niter)


def phase_precision(n: int, eps: float = 1e-4) -> dict:
    """Gram entries and time to epsilon under "default" and "highest".
    epsilon = 1e-4 is reached on the f32 trajectory's superlinear tail;
    1e-5 lies below the floor that f32 gradient rounding sets (see
    ``phase_native_parity``) and is reached only by luck."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.ops import vecmath as vm
    from lbfgs_jax.params import LbfgsParams

    m = 6
    S = jax.random.normal(jax.random.PRNGKey(1), (m, n // 128, 128)
                          ).astype(jnp.bfloat16)
    Z = jax.random.normal(jax.random.PRNGKey(2), (n // 128, 128, 3),
                          jnp.float32)
    ref = np.einsum("mrl,rlz->mz", np.asarray(S, np.float64),
                    np.asarray(Z, np.float64))
    saved = vm.PRECISION
    out = {}
    try:
        for prec in ("default", "highest"):
            vm.PRECISION = prec
            gram = jax.jit(lambda a, z: jnp.einsum(
                "mrl,rlz->mz", a, z, precision=vm.PRECISION,
                preferred_element_type=jnp.float32))(S, Z)
            rel = float(np.max(np.abs(np.asarray(gram) - ref))
                        / np.max(np.abs(ref)))
            params = LbfgsParams(max_iterations=3000, epsilon=eps,
                                 history_dtype="bfloat16")
            pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
            x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
            comp, _ = _aot(params, pdef, x0)
            comp(x0).prob.fx.block_until_ready()
            st, dt = _timed(lambda: comp(x0))
            float(st.prob.fx)
            _, dt = _timed(lambda: float(comp(x0).prob.fx))
            check(int(st.status) == 1,
                  f"[{prec}] did not converge to {eps}: status "
                  f"{int(st.status)} after {int(st.k) - 1} iterations, "
                  f"fx {float(st.prob.fx)}")
            out[prec] = dict(gram_rel_err_vs_f64=rel, tte_s=dt,
                             tte_iters=int(st.k) - 1,
                             fx=float(st.prob.fx), status=int(st.status))
    finally:
        vm.PRECISION = saved
    return emit("precision", n=n, eps=eps, selected=saved, **out)


def phase_kernel_vs_xla(sizes, iters_of) -> dict:
    """iters/s of the fused epilogue against the plain XLA path, in turns
    (kernel, plain, plain, kernel) in one process."""
    import jax.numpy as jnp

    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.ops.factory import without_epilogue
    from lbfgs_jax.params import LbfgsParams

    vag = rosenbrock.value_and_grad
    objs = {"kernel": vag, "plain": without_epilogue(vag)}
    out = {}
    for n in sizes:
        iters = iters_of(n)
        params = LbfgsParams(max_iterations=iters + 1, epsilon=0.0,
                             history_dtype="bfloat16")
        x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
        comps = {k: _aot(params, ProblemDef(value_and_grad=o), x0)
                 for k, o in objs.items()}
        rates = {"kernel": [], "plain": []}
        fx = {}
        for k in ("kernel", "plain", "plain", "kernel"):
            r, st = _rate(comps[k][0], x0)
            rates[k].extend(r)
            fx[k] = float(st.prob.fx)
        out[str(n)] = dict(
            iters=iters, iters_per_s=rates, fx_after=fx,
            compile_s={k: v[1] for k, v in comps.items()},
            median_iters_per_s={k: sorted(v)[len(v) // 2]
                                for k, v in rates.items()})
    return emit("kernel_vs_xla", **out)


def phase_trace(n: int, iters: int, logdir: str) -> dict:
    import jax.numpy as jnp

    from bench_trace import trace_run
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.ops.factory import without_epilogue
    from lbfgs_jax.params import LbfgsParams

    vag = rosenbrock.value_and_grad
    params = LbfgsParams(max_iterations=iters + 1, epsilon=0.0,
                         history_dtype="bfloat16")
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    out = {}
    for k, obj in (("kernel", vag), ("plain", without_epilogue(vag))):
        comp, _ = _aot(params, ProblemDef(value_and_grad=obj), x0)
        out[k] = trace_run(comp, (x0,), os.path.join(logdir, k))
    return emit("trace", n=n, **out)


def phase_four_cards(n: int, iters: int) -> dict:
    """The sharded path on every card of the host against one card."""
    import jax
    import jax.numpy as jnp

    from lbfgs_jax import lbfgs
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.parallel import make_mesh, shard_vector

    mesh = make_mesh()
    vag = rosenbrock.value_and_grad
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    x0s = shard_vector(x0, mesh)
    out = {}
    for variant in ("plain", "owlqn"):
        b = (lbfgs().with_epsilon(0.0).with_max_iterations(iters + 1)
             .with_history_dtype("bfloat16"))
        if variant == "owlqn":
            b = b.with_orthantwise(1.0, 0, None).with_fx_wide()
        res = {}
        for tag, x in (("one_card", x0), ("sharded", x0s)):
            rep, first_s = _timed(lambda: b.minimize_jit(x, vag))
            rep, steady_s = _timed(lambda: b.minimize_jit(x, vag))
            res[tag] = dict(fx=rep.fx, niter=rep.niter,
                            iters_per_s=iters / steady_s,
                            compile_and_setup_s=first_s - steady_s,
                            devices=len(rep.x.sharding.device_set))
        check(res["sharded"]["devices"] == len(jax.devices()),
              "the sharded run did not span every card")
        check(res["sharded"]["niter"] == res["one_card"]["niter"],
              f"{variant}: iteration counts differ")
        check(abs(res["sharded"]["fx"] - res["one_card"]["fx"])
              <= 1e-3 * abs(res["one_card"]["fx"]),
              f"{variant}: sharded fx {res['sharded']['fx']} vs one card "
              f"{res['one_card']['fx']}")
        res["speedup"] = (res["sharded"]["iters_per_s"]
                          / res["one_card"]["iters_per_s"])
        out[variant] = res
    return emit("four_cards", n=n, iters=iters, **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path across the host's cards")
    ap.add_argument("--logdir", default="traces/chip_smoke")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {dev.platform}); refusing to run",
              file=sys.stderr)
        return 2
    from lbfgs_jax.utils import compile_cache

    compile_cache.enable()
    # keep the in-jit ascent-warning host callback out of the timed programs
    os.environ.setdefault("LBFGS_NO_RUNTIME_WARN", "1")
    t_start = time.perf_counter()
    emit("device", platform=dev.platform, kind=dev.device_kind,
         count=len(devs), jax=jax.__version__)
    z = GPU_SIZES
    if args.four_cards:
        if len(devs) < 2:
            print("chip_smoke: --four-cards needs several cards",
                  file=sys.stderr)
            return 2
        phase_four_cards(z["four"], 20)
    else:
        phase_gpu_checks()
        phase_rosenbrock(z["big"], z["big_iters"])
        phase_native_parity(z["ref"])
        phase_owlqn(z["mid"], z["mid_iters"], wide=False)
        phase_owlqn(z["big"], z["big_iters"], wide=True)
        phase_damped(z["mid"], z["mid_iters"])
        phase_logistic(*z["logistic"], iters=100)
        phase_batch(*z["batch"])
        phase_precision(z["mid"])
        phase_kernel_vs_xla(
            (z["mid"], z["big"]),
            lambda n: z["mid_iters"] if n == z["mid"] else z["big_iters"])
        phase_trace(z["mid"], 20, args.logdir)
    emit("done", seconds=time.perf_counter() - t_start)
    print(card_info(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
