"""OWL-QN L1-logistic (log-linear/Poisson) regression benchmark at scale.

The reference's realistic OWL-QN workload is L1-regularized log-linear
regression over a design matrix (``/root/reference/tests/owlqn.rs:5-63``,
500x21).  This bench runs the SAME objective family at scale — the
regime where the user objective (two [nrow, ncol] matrix-vector products
+ exp per evaluation) dominates the iteration, unlike the
elementwise-cheap Rosenbrock the other benches use.  Design matrix and
counts are generated ON DEVICE and passed to the jitted run as ARGUMENTS
(a closure capture would embed them as HLO constants).

Default configs on a GPU (one JSON line each):
  dense:  nrow=2^15, ncol=2^13  (X f32: 1 GiB; the objective is the whole
          story)
  wide:   nrow=2^11, ncol=2^20  (X bf16: 4 GiB; n large enough for the
          solver's vector passes to matter)

Run on a GPU:  python bench_logistic.py
Small smoke:   JAX_PLATFORMS=cpu python bench_logistic.py --nrow 512 --ncol 64 --iters 10
Golden self-check vs the reference CSVs: --golden (CPU, f64, 500x21 —
asserts fx = -42724.136705 @1e-6, tests/owlqn.rs:60).
"""

from __future__ import annotations

import argparse
import json
import os

os.environ.setdefault("LBFGS_NO_RUNTIME_WARN", "1")
import time

import jax

from lbfgs_jax.utils import compile_cache

compile_cache.enable()

WIDE_FX = bool(os.environ.get("BENCH_WIDE_FX"))
if WIDE_FX:
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def golden_check():
    """The 500x21 reference golden (CPU, f64) through the same objective
    the scaled bench times — proves the bench measures the reference's
    workload, not a lookalike."""
    ref = "/root/reference/tests"
    if not os.path.exists(os.path.join(ref, "x.csv")):
        print("# golden: reference CSVs not available, skipped", flush=True)
        return
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        from lbfgs_jax import lbfgs
        from lbfgs_jax.models import logistic
        from lbfgs_jax.utils.csvio import read_r_csv

        X = jnp.asarray(read_r_csv(os.path.join(ref, "x.csv")))
        y = jnp.asarray(read_r_csv(os.path.join(ref, "y.csv")).ravel())
        rep = (
            lbfgs()
            .with_orthantwise(1.0, 1, 21)
            .with_epsilon(1e-4)
            .minimize(jnp.zeros(21, jnp.float64), logistic.make_objective(X, y))
        )
        golden = -42724.136705
        assert abs(rep.fx - golden) <= 1e-6 * abs(golden), rep.fx
        print(f"# golden OK: fx={rep.fx:.6f} niter={rep.niter}", flush=True)
    finally:
        jax.config.update("jax_enable_x64", prev)


def bench(nrow: int, ncol: int, iters: int, eps: float, c: float,
          x_dtype, m: int) -> dict:
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.minimize import _run_while
    from lbfgs_jax.models import logistic
    from lbfgs_jax.orthantwise import Orthantwise
    from lbfgs_jax.params import LbfgsParams, LineSearchAlgorithm
    from lbfgs_jax.solver import init_state

    hd = "bfloat16" if jax.default_backend() == "gpu" else None
    ow = Orthantwise(c=c, start=1, end=ncol)  # intercept excluded (owlqn.rs:47)
    params = LbfgsParams(
        max_iterations=iters + 1, epsilon=eps, m=m, orthantwise=ow,
        history_dtype=hd, fx_wide=WIDE_FX,
        constrain_step_size=bool(os.environ.get("BENCH_CONSTRAIN")),
        # BENCH_ADAPTIVE=<growth>: adaptive ladder entry (round 5) — on
        # this objective every saved evaluation is two matrix products
        adaptive_entry_step=float(os.environ.get("BENCH_ADAPTIVE", "0") or 0),
    ).replace_ls(algorithm=LineSearchAlgorithm.BacktrackingArmijo)

    X, y = logistic.synthetic_device(nrow, ncol, seed=0, dtype=jnp.float32,
                                     x_dtype=x_dtype)
    float(y[0])  # sync generation through the transport

    @jax.jit
    def run(X, y, x0):
        # the objective closes over the TRACED X/y (jit arguments), so
        # the multi-GB design matrix is never an HLO constant
        pdef = ProblemDef(
            value_and_grad=logistic.make_objective(X, y),
            owlqn=ow,
        )
        return _run_while(pdef, params, init_state(pdef, params, x0, lean=True))

    x0 = jnp.zeros((ncol,), jnp.float32)
    st = run(X, y, x0)
    float(st.prob.fx)  # warmup + sync

    t0 = time.perf_counter()
    st = run(X, y, x0)
    fx = float(st.prob.fx)
    dt = time.perf_counter() - t0
    assert np.isfinite(fx), "bench diverged"
    beta = np.asarray(st.prob.x)
    return {
        "iters_per_s": (int(st.k) - 1) / dt,
        "seconds": dt,
        "final_fx": fx,
        "iters": int(st.k) - 1,
        "neval": int(st.prob.neval),
        "evals_per_s": int(st.prob.neval) / dt,
        "nnz": int(np.sum(beta[1:] != 0.0)),
        "status": int(st.status),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nrow", type=int, default=None)
    ap.add_argument("--ncol", type=int, default=None)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--eps", type=float, default=0.0)
    ap.add_argument("--c", type=float, default=1.0)
    ap.add_argument("--m", type=int, default=6)
    ap.add_argument("--xdtype", default=None, choices=[None, "f32", "bf16"])
    ap.add_argument("--golden", action="store_true",
                    help="run the 500x21 reference-golden self-check first")
    args = ap.parse_args()

    if args.golden:
        golden_check()

    if args.nrow is not None:
        configs = [(args.nrow, args.ncol or 64,
                    jnp.bfloat16 if args.xdtype == "bf16" else jnp.float32)]
    elif jax.default_backend() == "gpu":
        configs = [(1 << 15, 1 << 13, jnp.float32),
                   (1 << 11, 1 << 20, jnp.bfloat16)]
    else:
        configs = [(1 << 10, 1 << 8, jnp.float32)]

    for nrow, ncol, xdt in configs:
        r = bench(nrow, ncol, args.iters, args.eps, args.c, xdt, args.m)
        tag = ""
        if args.eps:
            tag += f"_eps{args.eps:g}"
        if args.m != 6:
            tag += f"_m{args.m}"
        if WIDE_FX:
            tag += "_widefx"
        if os.environ.get("BENCH_ADAPTIVE"):
            tag += f"_adaptive{os.environ['BENCH_ADAPTIVE']}"
        print(json.dumps({
            "metric": f"logistic_owlqn_{nrow}x{ncol}{tag}_iters_per_s",
            "value": round(r["iters_per_s"], 3),
            "unit": "iters/s",
            "seconds": round(r["seconds"], 4),
            "backend": jax.default_backend(),
            "x_dtype": str(jnp.dtype(xdt).name),
            "iters": r["iters"],
            "neval": r["neval"],
            "evals_per_s": round(r["evals_per_s"], 3),
            "final_fx": r["final_fx"],
            "nnz_coeffs": r["nnz"],
            "status": r["status"],
        }), flush=True)


if __name__ == "__main__":
    main()
