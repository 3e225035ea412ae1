"""Per-phase device time of the solver on a GPU, from a profiler trace.

Runs one whole-run jitted solve (``minimize._run_while``) under
``jax.profiler``, then reads the GPU planes of the trace: every kernel
event is attributed to the ``lbfgs.*`` named scope (``solver.py``) of the
HLO instruction that launched it, found through the compiled program's
op metadata (inside the while loop XLA replays the body as a command
buffer, so the trace events carry kernel names, not scopes).  Prints one
JSON line per phase (ms per iteration) and a summary line with the
window, the device's busy time and its idle share.

Usage (GPU):
  python bench_trace.py                  # n = 2^24
  BENCH_N=100000000 python bench_trace.py --iters 30
The raw trace stays under --logdir for xprof/tensorboard.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re

import jax
import jax.numpy as jnp

_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name="([^"]*)"')
_SCOPE = re.compile(r"(lbfgs\.\w+)")


def scope_map(hlo_text: str) -> dict:
    """Kernel name -> ``lbfgs.*`` scope (or "other") from compiled HLO.
    Trace kernel names are the HLO instruction names with '.' and '-'
    written as '_'."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            sc = _SCOPE.search(m.group(2))
            key = m.group(1).replace(".", "_").replace("-", "_")
            out[key] = sc.group(1) if sc else "other"
    return out


def _phase_of(name: str, scopes: dict) -> str:
    if name in scopes:
        return scopes[name]
    base = re.sub(r"_\d+$", "", name)
    if name.startswith("lbfgs_trial_pair_gram"):  # the Pallas kernel's name
        return "lbfgs.trial_pair_gram"
    return scopes.get(base, "other")


def device_breakdown(xplane: str, scopes: dict, iters: int) -> dict:
    """Per-phase device ms/iteration, busy time and idle share of the
    traced window (union of kernel intervals on the GPU planes)."""
    pdata = jax.profiler.ProfileData.from_file(xplane)
    per = collections.Counter()
    ivals = []
    for plane in pdata.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                per[_phase_of(ev.name, scopes)] += ev.duration_ns
                ivals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not ivals:
        raise RuntimeError(f"no GPU device events in {xplane}")
    ivals.sort()
    busy, cur_s, cur_e = 0, ivals[0][0], ivals[0][1]
    for s, e in ivals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in ivals) - ivals[0][0]
    return {
        "phases_ms_per_iter": {k: v / 1e6 / iters for k, v in per.most_common()},
        "window_ms": window / 1e6,
        "busy_ms": busy / 1e6,
        "idle_share": 1.0 - busy / window,
        "iters": iters,
    }


def trace_run(compiled, args, logdir: str) -> dict:
    """Trace one call of an AOT-compiled solve and reduce it."""
    st = compiled(*args)
    float(st.prob.fx)  # warm
    with jax.profiler.trace(logdir):
        st = compiled(*args)
        float(st.prob.fx)
    paths = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                          "*.xplane.pb")))
    if not paths:
        raise RuntimeError(f"no trace written under {logdir}")
    return device_breakdown(paths[-1], scope_map(compiled.as_text()),
                            int(st.k) - 1)


def main():
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.minimize import _run_while
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.orthantwise import Orthantwise
    from lbfgs_jax.params import LbfgsParams, LineSearchAlgorithm
    from lbfgs_jax.solver import init_state
    from lbfgs_jax.utils import compile_cache

    os.environ.setdefault("LBFGS_NO_RUNTIME_WARN", "1")
    compile_cache.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("--logdir", default="traces/bench_trace")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--owlqn", action="store_true",
                    help="trace the OWL-QN config (Armijo ladder)")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_trace.py traces a GPU; JAX found {dev.platform}")
    n = int(os.environ.get("BENCH_N", 1 << 24))
    ow = Orthantwise(c=1.0, start=0, end=n - 1) if args.owlqn else None
    params = LbfgsParams(max_iterations=args.iters + 1, epsilon=0.0,
                         orthantwise=ow, history_dtype="bfloat16")
    if args.owlqn:
        params = params.replace_ls(
            algorithm=LineSearchAlgorithm.BacktrackingArmijo)
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad, owlqn=ow)
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    run = jax.jit(
        lambda x: _run_while(pdef, params, init_state(pdef, params, x, lean=True))
    )
    out = trace_run(run.lower(x0).compile(), (x0,), args.logdir)
    for phase, ms in out.pop("phases_ms_per_iter").items():
        print(json.dumps({"phase": phase, "ms_per_iter": ms}))
    print(json.dumps({"n": n, "device_kind": dev.device_kind, **out}))


if __name__ == "__main__":
    main()
