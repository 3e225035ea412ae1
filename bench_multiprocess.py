"""Cross-PROCESS scaling curve: iters/s vs OS-process count (gloo CPU).

Complements bench_scaling.py (in-process virtual-device mesh): here each
rank is a separate OS process owning one CPU device, jax.distributed
coordinates them, and every per-iteration reduction crosses process
boundaries as a gloo all-reduce — the closest this single-host
environment gets to the multi-host DCN regime (SURVEY.md §2.3,
BASELINE.md scaling north star).  This host has 2 physical cores, so the
curve measures COLLECTIVE/COORDINATION OVERHEAD versus the in-process
GSPMD path, not hardware scaling.

Prints one JSON line per process count:
  python bench_multiprocess.py [--n 1048576] [--iters 100] [--procs 1 2 4]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time

_WORKER = r"""
import sys, time
import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")
pid, port, nproc, n, iters = (
    int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
    int(sys.argv[5]),
)
sys.path.insert(0, REPO)
from lbfgs_jax.parallel import init_distributed, make_mesh, vector_sharding

if nproc > 1:
    init_distributed(
        coordinator_address=f"localhost:{port}", num_processes=nproc,
        process_id=pid,
    )
import numpy as np
from lbfgs_jax.minimize import minimize_jit
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.params import LbfgsParams

mesh = make_mesh()
sh = vector_sharding(mesh)
x0_np = np.zeros(n, dtype=np.float32)
x0_np[0::2] = -1.2
x0_np[1::2] = 1.0
x0 = jax.make_array_from_callback((n,), sh, lambda idx: x0_np[idx])

params = LbfgsParams(max_iterations=iters + 1, epsilon=0.0,
                     constrain_step_size=False)
st = minimize_jit(params, x0, rosenbrock.value_and_grad, return_state=True)
float(st.prob.fx)  # warmup sync
t0 = time.perf_counter()
st = minimize_jit(params, x0, rosenbrock.value_and_grad, return_state=True)
fx = float(st.prob.fx)
dt = time.perf_counter() - t0
k = int(st.k) - 1
print(f"RESULT pid={pid} iters_per_s={k / dt!r} fx={fx!r} k={k}", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_procs(nproc: int, n: int, iters: int) -> dict:
    repo = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join("/tmp", f"lbfgs_mp_worker_{os.getpid()}.py")
    with open(worker, "w") as f:
        f.write(f"REPO = {repo!r}\n" + _WORKER)
    port = _free_port()

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    # pinned to the CPU: several processes must not open one card
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port), str(nproc), str(n),
             str(iters)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for i in range(nproc)
    ]
    outs = [p.communicate(timeout=1200)[0] for p in procs]
    os.unlink(worker)
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {i} failed:\n{out[-3000:]}")
    m = re.search(r"RESULT pid=0 iters_per_s=(\S+) fx=(\S+) k=(\d+)", outs[0])
    assert m, outs[0][-2000:]
    return {"iters_per_s": float(m.group(1)), "fx": float(m.group(2)),
            "iters": int(m.group(3))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()

    base = None
    for nproc in args.procs:
        r = run_procs(nproc, args.n, args.iters)
        if base is None:
            base = r["iters_per_s"]
        print(json.dumps({
            "metric": f"rosenbrock_n{args.n}_procs{nproc}_iters_per_s",
            "value": round(r["iters_per_s"], 3),
            "unit": "iters/s",
            "vs_baseline": round(r["iters_per_s"] / base, 3),
            "processes": nproc,
            "iters": r["iters"],
            "final_fx": r["fx"],
            "backend": "cpu+gloo",
        }), flush=True)


if __name__ == "__main__":
    main()
