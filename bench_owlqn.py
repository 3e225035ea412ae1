"""OWL-QN throughput benchmark: sequential vs speculative backtracking.

The OWL-QN path (the reference's L1-regularized mode, src/orthantwise.rs)
always routes to the Armijo-only backtracking ladder, making it the
eval-hungriest configuration — and the one the speculative K-way search
(`with_speculative_linesearch`) is designed for.  This bench times the
whole minimization as ONE ``lax.while_loop`` executable, like bench.py,
and prints one JSON line per variant.

Run on a GPU:  python bench_owlqn.py
Run on CPU:    JAX_PLATFORMS=cpu python bench_owlqn.py --n 65536
"""

from __future__ import annotations

import argparse
import json
import os

# keep the in-jit ascent-warning host callback out of the timed programs
# (benchmarks legitimately quiet runtime warnings)
os.environ.setdefault("LBFGS_NO_RUNTIME_WARN", "1")
import time

import jax

from lbfgs_jax.utils import compile_cache

compile_cache.enable()

# BENCH_WIDE_FX=1: wide (f64) objective-scalar carry — the config that
# makes OWL-QN converge at n = 1e8 (the f32 resolution floor, PERF.md).
# x64 must be on before any array is created; vectors stay f32.
# BENCH_WIDE_FX=df32: the x64-FREE wide carry (double-float two-f32 fx,
# ops/df.py) — same capability without the process-global flag.
WIDE_KIND = os.environ.get("BENCH_WIDE_FX", "")
WIDE_FX = bool(WIDE_KIND)
if WIDE_FX and WIDE_KIND != "df32":
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def bench(
    n: int, iters: int, speculative: int, plain: bool, batch: int = 1,
    dtype=jnp.float32, eps: float = 0.0, m: int = 6,
) -> dict:
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.minimize import _run_while
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.orthantwise import Orthantwise
    from lbfgs_jax.params import LbfgsParams, LineSearchAlgorithm
    from lbfgs_jax.solver import init_state

    hd = "bfloat16" if jax.default_backend() not in ("cpu",) else None
    ow = None if plain else Orthantwise(c=1.0, start=0, end=n - 1)
    params = LbfgsParams(
        max_iterations=iters + 1, epsilon=eps, m=m, orthantwise=ow,
        history_dtype=hd, fx_wide=WIDE_FX,
        damping=bool(os.environ.get("BENCH_DAMPING")),
        # same policy as bench.py: the unconstrained (2018-golden) step
        # config unless BENCH_CONSTRAIN=1 (see bench.py for the numbers)
        constrain_step_size=bool(os.environ.get("BENCH_CONSTRAIN")),
        # BENCH_ADAPTIVE=<growth>: the round-5 adaptive entry-step
        # extension (enter each ladder at clip(growth*step_ls, ., 1.0))
        adaptive_entry_step=float(os.environ.get("BENCH_ADAPTIVE", "0") or 0),
    )
    params = params.replace_ls(
        speculative=speculative, algorithm=LineSearchAlgorithm.BacktrackingArmijo
    )
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad, owlqn=ow)
    x0 = rosenbrock.initial_point(n, dtype=dtype)

    if batch > 1:
        # the speculative search's claimed winning regime:
        # vmapped scenario batches, where one while_loop trip costs the
        # WHOLE batch an evaluation (stragglers' deep ladders dominate) and
        # the K candidate lanes are cheap elementwise work
        from lbfgs_jax.batched import minimize_batched

        key = jax.random.PRNGKey(0)
        x0b = x0[None, :] + 0.5 * jax.random.normal(key, (batch, n), dtype)
        st = minimize_batched(params, x0b, rosenbrock.value_and_grad,
                              return_state=True)
        float(st.prob.fx[0])  # sync through the transport
        t0 = time.perf_counter()
        st = minimize_batched(params, x0b, rosenbrock.value_and_grad,
                              return_state=True)
        fx = float(np.asarray(st.prob.fx).sum())
        dt = time.perf_counter() - t0
        assert np.isfinite(fx), "bench diverged"
        real_iters = int(np.asarray(st.k).sum()) - batch
        neval = int(np.asarray(st.prob.neval).sum())
        trials = neval - batch
        if speculative > 1:
            K = speculative
            neval_physical = real_iters + batch + -(-trials // K) * K
        else:
            neval_physical = neval
        return {
            "iters_per_s": real_iters / dt,
            "seconds": dt,
            "final_fx": fx,
            "iters": real_iters,
            "neval": neval,
            "neval_physical": neval_physical,
        }

    def _fxv(v):
        a = np.asarray(v)
        if a.ndim and a.shape[-1] == 2:  # df32 carry (ops/df.py)
            return float(np.float64(a[..., 0]) + np.float64(a[..., 1]))
        return float(a)

    run = jax.jit(lambda x: _run_while(pdef, params, init_state(pdef, params, x)))
    st = run(x0)
    _fxv(st.prob.fx)  # sync through the transport

    t0 = time.perf_counter()
    st = run(x0)
    fx = _fxv(st.prob.fx)
    dt = time.perf_counter() - t0
    assert np.isfinite(fx), "bench diverged"
    real_iters = int(st.k) - 1
    neval = int(st.prob.neval)
    # neval counts LOGICAL sequential trials (trajectory/max_evaluations
    # parity with the reference); under speculation the PHYSICAL objective
    # call count is ceil(trials/K)*K vmapped lanes + 1 materialization per
    # search — report both so perf analysis isn't skewed
    trials = neval - 1  # minus the init evaluation
    if speculative > 1:
        K = speculative
        neval_physical = real_iters + 1  # one _finish materialization/search
        # per-search ladder rounds are not individually recoverable from
        # the aggregate; bound them by the worst case of whole rounds
        neval_physical += -(-trials // K) * K
    else:
        neval_physical = neval
    return {
        "iters_per_s": real_iters / dt,
        "seconds": dt,
        "final_fx": fx,
        "iters": real_iters,
        "neval": neval,
        "neval_physical": neval_physical,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument(
        "--plain", action="store_true",
        help="plain L-BFGS with the Armijo ladder instead of OWL-QN",
    )
    ap.add_argument(
        "--batch", type=int, default=1,
        help="vmapped scenario-batch size (the speculative search's "
        "designed-for regime); metric becomes instance-iters/s",
    )
    ap.add_argument(
        "--eps", type=float, default=0.0,
        help="nonzero: time-to-epsilon run (stop on scaled ||pg|| <= eps) "
        "instead of a fixed-iteration throughput run",
    )
    ap.add_argument("--m", type=int, default=6, help="history size")
    ap.add_argument(
        "--no-spec", action="store_true",
        help="skip the speculative variant (one compile less)",
    )
    args = ap.parse_args()

    # one metric tag for BOTH output paths: --eps/--m must show up in the
    # metric name even when the speculative variant also runs, or those
    # runs silently collide with default-config rows in results logs
    tag = f"_b{args.batch}" if args.batch > 1 else ""
    if args.eps:
        tag += f"_eps{args.eps:g}"
    if args.m != 6:
        tag += f"_m{args.m}"
    if WIDE_FX:
        tag += "_widefx" if WIDE_KIND != "df32" else "_widefx_df32"
    if os.environ.get("BENCH_DAMPING"):
        tag += "_damped"
    if os.environ.get("BENCH_ADAPTIVE"):
        tag += f"_adaptive{os.environ['BENCH_ADAPTIVE']}"

    seq = bench(args.n, args.iters, speculative=1, plain=args.plain,
                batch=args.batch, eps=args.eps, m=args.m)
    if args.no_spec:
        print(json.dumps({
            "metric": f"{'armijo' if args.plain else 'owlqn'}_n{args.n}{tag}_sequential_iters_per_s",
            "value": round(seq["iters_per_s"], 3),
            "unit": "iters/s",
            "seconds": round(seq["seconds"], 4),
            "backend": jax.default_backend(),
            "n": args.n,
            "iters": seq["iters"],
            "neval": seq["neval"],
            "final_fx": seq["final_fx"],
        }))
        return
    spec = bench(args.n, args.iters, speculative=args.k, plain=args.plain,
                 batch=args.batch, eps=args.eps, m=args.m)
    # ladder-equivalence sanity: the two runs must land on the same
    # minimum.  Equivalence is bitwise only when vmapped candidate
    # evaluations round like unbatched ones; f32 reductions reassociate
    # under vmap, so iteration counts may differ slightly — compare fx.
    rel = abs(spec["final_fx"] - seq["final_fx"]) / max(1.0, abs(seq["final_fx"]))
    assert rel < 1e-3, (spec, seq)

    for name, r in (("sequential", seq), (f"speculative_k{args.k}", spec)):
        print(
            json.dumps(
                {
                    "metric": f"{'armijo' if args.plain else 'owlqn'}_n{args.n}{tag}_{name}_iters_per_s",
                    "value": round(r["iters_per_s"], 3),
                    "unit": "iters/s",
                    "vs_baseline": round(r["iters_per_s"] / seq["iters_per_s"], 3),
                    "backend": jax.default_backend(),
                    "n": args.n,
                    "iters": r["iters"],
                    "neval": r["neval"],
                    "neval_physical": r["neval_physical"],
                    "final_fx": r["final_fx"],
                }
            )
        )


if __name__ == "__main__":
    main()
