"""Benchmark harness: L-BFGS iteration throughput on a large Rosenbrock.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Metric: solver iterations/second on extended Rosenbrock (full propagate
steps including the More-Thuente line search, f32, single chip).  The
whole timed run executes as ONE on-device ``lax.while_loop`` dispatch, so
the number reflects device throughput, not host dispatch latency.  It
needs a GPU and fails without one.

The reference publishes no timing numbers (BASELINE.md), so the baseline
is this repo's native C++ sequential core — a faithful performance
stand-in for the single-threaded Rust reference — running the same
problem on the host CPU.  `vs_baseline` = accelerator iters/s over
native-CPU iters/s at equal n (higher is better).

The persistent compilation cache (``lbfgs_jax.utils.compile_cache``)
keeps reruns cheap.

Env knobs: BENCH_N (problem size), BENCH_ITERS (iteration budget),
BENCH_EPS (nonzero -> time-to-epsilon run), BENCH_M (history size),
BENCH_DAMPING=1, BENCH_CONSTRAIN=1 (capped step policy),
BENCH_HISTORY_DTYPE (default bfloat16).
"""

from __future__ import annotations

import json
import os
import time

# keep the in-jit ascent-warning cond/callback out of the benchmarked hot
# loop (it is a scalar-only branch, but a host-callback effect in the body
# constrains scheduling); benchmarks legitimately quiet runtime warnings
os.environ.setdefault("LBFGS_NO_RUNTIME_WARN", "1")

import jax

from lbfgs_jax.utils import compile_cache

compile_cache.enable()

# BENCH_WIDE_FX=1: wide (f64) objective-scalar carry (fx_wide) — for
# measuring its throughput cost on the plain path (vectors stay f32)
WIDE_FX = bool(os.environ.get("BENCH_WIDE_FX"))
if WIDE_FX:
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


#: BENCH_OBJECTIVE selects the benchmarked objective family:
#: "rosenbrock" (default, the headline metric) or "quadratic" — the
#: round-5 factory-generated separable objective (weights/targets as
#: extra kernel operand streams), proving the objective-agnostic fused
#: path at benchmark scale with zero bespoke kernel code.
OBJECTIVE = os.environ.get("BENCH_OBJECTIVE", "rosenbrock")


def bench_jax(n: int, iters: int, dtype=jnp.float32) -> dict:
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.minimize import _run_while
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.params import LbfgsParams
    from lbfgs_jax.solver import init_state

    # epsilon=0 so the run always uses the full iteration budget
    # (BENCH_EPS overrides for time-to-epsilon measurements).
    # bfloat16 history halves the dominant history traffic
    hd = os.environ.get("BENCH_HISTORY_DTYPE", "bfloat16") or None
    params = LbfgsParams(
        max_iterations=iters + 1,
        epsilon=float(os.environ.get("BENCH_EPS", "0.0")),
        m=int(os.environ.get("BENCH_M", "6")),
        history_dtype=hd,
        damping=bool(os.environ.get("BENCH_DAMPING")),
        fx_wide=WIDE_FX,
        # default False: the reference's ORIGINAL (2018-golden-pinned)
        # step policy.  The later constrain_step_size=True cap
        # (max_step_size=1.0) clamps early steps on large-n Rosenbrock
        # and costs ~2x the evaluations AND ~2x the iterations to reach
        # epsilon (measured: 36 iters / 52 evals vs 83 / 227 at n=2^20);
        # both configs are reference semantics — BENCH_CONSTRAIN=1
        # selects the capped one (the pre-round-3 bench definition).
        constrain_step_size=bool(os.environ.get("BENCH_CONSTRAIN")),
    )
    if OBJECTIVE == "quadratic":
        # the factory objective binds (w, t) as extras: build it INSIDE
        # the traced function so the arrays stay jit OPERANDS (a closure
        # capture would embed 2x 4n bytes as HLO constants).  Operands
        # are generated on device.
        from lbfgs_jax.models import separable

        # a pure quadratic reaches the exact minimum and then errors with
        # x-not-changed if the budget continues: default to a
        # time-to-epsilon definition unless BENCH_EPS was given
        if not os.environ.get("BENCH_EPS"):
            params = params.replace(epsilon=1e-4)

        @jax.jit
        def make_ops(key):
            kw, kt = jax.random.split(key)
            w = 0.5 + jax.random.uniform(kw, (n,), dtype)
            t = jax.random.normal(kt, (n,), dtype)
            return w, t, jnp.zeros((n,), dtype)

        w, t, x0 = make_ops(jax.random.PRNGKey(7))

        @jax.jit
        def run_q(x, w_, t_):
            obj = separable.quadratic(w_, t_)
            pdef = ProblemDef(value_and_grad=obj)
            return _run_while(pdef, params, init_state(pdef, params, x, lean=True))

        run = lambda x: run_q(x, w, t)
    else:
        pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
        x0 = rosenbrock.initial_point(n, dtype=dtype)

        # ONE jitted executable for the whole minimization, reused for the
        # timed run (re-jitting would bill tracing/cache lookup to the timing)
        run = jax.jit(
            lambda x: _run_while(pdef, params, init_state(pdef, params, x, lean=True))
        )

    float(run(x0).prob.fx)  # compile + warm

    def timed():
        t0 = time.perf_counter()
        st = run(x0)
        fx = float(st.prob.fx)
        return st, fx, time.perf_counter() - t0

    # best-of-N with the spread recorded: the result carries its own
    # run-to-run variance
    nruns = max(1, int(os.environ.get("BENCH_RUNS", "3")))
    per_run = []
    st = fx = None
    for _ in range(nruns):
        st, fx, dt = timed()
        assert np.isfinite(fx), "bench diverged"
        per_run.append((int(st.k) - 1) / dt)  # k==1 is the initial-report step
    real_iters = int(st.k) - 1
    best = max(per_run)
    return {
        "iters_per_s": best,
        "seconds": real_iters / best,
        "final_fx": fx,
        "iters": real_iters,
        "runs": [round(r, 3) for r in per_run],
        "spread": round(max(per_run) - min(per_run), 3),
    }


def bench_native(n: int, iters: int) -> dict:
    from lbfgs_jax.native import minimize_native_rosenbrock
    from lbfgs_jax.params import LbfgsParams

    x0 = np.zeros(n)
    x0[0::2] = -1.2
    x0[1::2] = 1.0
    # identical solver configuration to bench_jax (fair vs_baseline)
    params = LbfgsParams(
        max_iterations=iters + 1,
        epsilon=0.0,
        constrain_step_size=bool(os.environ.get("BENCH_CONSTRAIN")),
    )
    t0 = time.perf_counter()
    rep = minimize_native_rosenbrock(params, x0)
    dt = time.perf_counter() - t0
    real_iters = max(1, rep.niter - 1)
    return {"iters_per_s": real_iters / dt, "seconds": dt, "niter": rep.niter}


def main() -> None:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")

    n = int(os.environ.get("BENCH_N", 1 << 24))
    iters = int(os.environ.get("BENCH_ITERS", 100))
    base_iters = 10

    jx = bench_jax(n, iters)

    # native baseline at a bounded size, scaled linearly (the sequential
    # core is strictly O(n) streaming per iteration); best of two runs to
    # damp shared-machine noise.  A baseline failure must not lose the
    # accelerator number — emit partial JSON with vs_baseline=null.
    # (non-rosenbrock objectives have no native twin: vs_baseline=null)
    native_scaled = None
    try:
        if OBJECTIVE != "rosenbrock":
            raise RuntimeError("no native baseline for this objective")
        nb = min(n, 1 << 22)
        nat = max(
            (bench_native(nb, base_iters) for _ in range(2)),
            key=lambda r: r["iters_per_s"],
        )
        native_scaled = nat["iters_per_s"] * (nb / n)
    except Exception as e:  # noqa: BLE001 - keep the headline number alive
        print(f"# bench: native baseline failed ({type(e).__name__}: {e})",
              flush=True)

    tag = "_damped" if os.environ.get("BENCH_DAMPING") else ""
    if os.environ.get("BENCH_M"):
        tag += f"_m{os.environ['BENCH_M']}"
    if os.environ.get("BENCH_EPS"):
        tag += f"_eps{os.environ['BENCH_EPS']}"
    if os.environ.get("BENCH_CONSTRAIN"):
        tag += "_constrained"
    if WIDE_FX:
        tag += "_widefx"
    out = {
        "metric": f"{OBJECTIVE}_n{n}_lbfgs{tag}_iters_per_s",
        "seconds": round(jx["seconds"], 4),
        "value": round(jx["iters_per_s"], 3),
        "runs": jx["runs"],
        "spread": jx["spread"],
        "unit": "iters/s",
        "vs_baseline": (round(jx["iters_per_s"] / native_scaled, 3)
                        if native_scaled else None),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "n": n,
        "timed_iters": jx["iters"],
        "native_baseline_iters_per_s_scaled": (
            round(native_scaled, 3) if native_scaled else None),
        "dtype": "float32",
        "history_dtype": os.environ.get("BENCH_HISTORY_DTYPE", "bfloat16"),
        "constrain_step_size": bool(os.environ.get("BENCH_CONSTRAIN")),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
