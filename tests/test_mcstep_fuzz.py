"""Cross-implementation fuzz of the mcstep trial-interval update.

The branchless JAX port (``linesearch.update_trial_interval``) must agree
with the sequential C++ implementation (``lbfgs_native_mcstep``) — two
independent realizations of ``src/line.rs:446-606`` — on thousands of
randomized inputs covering all four interpolation cases, both bracketing
states, and the error exits.
"""

import ctypes as ct

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.linesearch import update_trial_interval
from lbfgs_jax.native import load


def native_mcstep(x, fx, dx, y, fy, dy, t, ft, dt, tmin, tmax, brackt):
    lib = load()
    lib.lbfgs_native_mcstep.restype = ct.c_int32
    vals = [ct.c_double(v) for v in (x, fx, dx, y, fy, dy, t)]
    b = ct.c_int32(1 if brackt else 0)
    st = lib.lbfgs_native_mcstep(
        *(ct.byref(v) for v in vals),
        ct.c_double(ft),
        ct.c_double(dt),
        ct.c_double(tmin),
        ct.c_double(tmax),
        ct.byref(b),
    )
    out = [v.value for v in vals]
    return out, bool(b.value), int(st)


def _gen_case(rng):
    """Random but structurally valid mcstep input."""
    x = rng.uniform(-2, 2)
    dx = -abs(rng.uniform(0.1, 3))  # descent at best point
    fx = rng.uniform(-1, 1)
    brackt = rng.rand() < 0.5
    if brackt:
        y = x + rng.uniform(0.2, 3)
        t = rng.uniform(min(x, y) + 1e-6, max(x, y) - 1e-6)
    else:
        y = x
        t = x + abs(rng.uniform(0.05, 2))
    fy = fx + rng.uniform(-0.5, 1.5)
    dy = rng.uniform(-3, 3)
    ft = fx + rng.uniform(-0.5, 1.5)
    dt = rng.uniform(-3, 3)
    tmin = min(x, t) - rng.uniform(0, 1)
    tmax = max(x, t) + rng.uniform(0.5, 5)
    return x, fx, dx, y, fy, dy, t, ft, dt, tmin, tmax, brackt


@pytest.mark.parametrize("seed", range(4))
def test_mcstep_jax_matches_native_fuzz(seed):
    rng = np.random.RandomState(seed)
    agree = 0
    for trial in range(500):
        args = _gen_case(rng)
        (nx, nfx, ndx, ny, nfy, ndy, nt), nb, nst = native_mcstep(*args)

        j = update_trial_interval(
            *(jnp.float64(v) for v in args[:11]), jnp.asarray(args[11])
        )
        jst = int(j.status)

        assert jst == nst, (args, jst, nst)
        if nst != 0:
            continue  # on error the reference leaves outputs half-updated
        agree += 1
        for name, jv, nv in [
            ("x", float(j.x), nx),
            ("fx", float(j.fx), nfx),
            ("dx", float(j.dx), ndx),
            ("y", float(j.y), ny),
            ("fy", float(j.fy), nfy),
            ("dy", float(j.dy), ndy),
            ("t", float(j.t), nt),
        ]:
            if np.isnan(jv) and np.isnan(nv):
                continue
            assert jv == pytest.approx(nv, rel=1e-12, abs=1e-12), (
                name,
                args,
                jv,
                nv,
            )
        assert bool(j.brackt) == nb, args
    assert agree > 300  # the generator mostly produces valid updates
