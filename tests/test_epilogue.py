"""The fused trial + pair + Gram epilogue (``ops/epilogue.py``).

The Triton kernel runs here through the Pallas interpreter: every case
compares it with the composed jnp oracle (``epilogue.trial_pair_gram_ref``:
a plain trial, a ring-row update and "highest"-precision Gram products),
covering ring slots
0/3/5, whole-block and row-masked tail grids, both history dtypes, the
damped update's extra (. gp) column, in-place ring-row writes, the
partial-sum reduction (plain and wide fx) and bound extra operand streams.
Solver-level cases pin the engaged path to the plain XLA path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.models import rosenbrock, separable
from lbfgs_jax.ops import epilogue, fused
from lbfgs_jax.params import LbfgsParams

M = 6


def _rand(shape, seed, scale=1.0, dtype=jnp.float32):
    return jnp.asarray(
        np.random.RandomState(seed).randn(*np.atleast_1d(shape)) * scale, dtype
    )


def _hist(rows, seed, dtype):
    return (_rand((M, rows, 128), seed, 0.1, dtype),
            _rand((M, rows, 128), seed + 1, 0.1, dtype))


def _compare(out, ref, sums_rel=1e-5):
    for i in (0, 2, 7, 8):  # xt, g, S_new, Y_new (elementwise)
        # the interpreter and XLA may contract a*b+c into an FMA
        # differently: one rounding of the vector's own scale
        r = np.asarray(ref[i], np.float32)
        np.testing.assert_allclose(
            np.asarray(out[i], np.float32), r,
            rtol=1e-6, atol=1e-6 * float(np.max(np.abs(r))))
    for i in (1, 3, 4, 5):  # fx, dg, gg, xx (reassociated f32 sums)
        assert float(out[i]) == pytest.approx(float(ref[i]), rel=sums_rel)
    assert bool(out[6]) == bool(ref[6])
    for i in (9, 10):  # SP, YP
        np.testing.assert_allclose(np.asarray(out[i]), np.asarray(ref[i]),
                                   rtol=1e-4, atol=1e-4)


# rows = 32 fills two ROWS=16 blocks; rows = 37 leaves a masked tail block
@pytest.mark.parametrize("rows", [32, 37], ids=["aligned", "tail"])
@pytest.mark.parametrize("hdtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32hist", "bf16hist"])
@pytest.mark.parametrize("with_gp", [False, True], ids=["plain", "damped"])
@pytest.mark.parametrize("end", [0, 3, 5])
def test_epilogue_matches_composed_oracle(rows, hdtype, with_gp, end):
    n = 128 * rows
    xp, d, gp = _rand(n, 1), _rand(n, 2, 0.1), _rand(n, 3)
    S, Y = _hist(rows, 4, hdtype)
    vag = rosenbrock.value_and_grad
    out = epilogue.trial_pair_gram(vag.kernels.block_fn, (), xp, d, gp, 0.37,
                                   S, Y, end, with_gp=with_gp, interpret=True)
    ref = epilogue.trial_pair_gram_ref(vag, xp, d, gp, 0.37, S, Y, end,
                                       with_gp=with_gp)
    assert out[9].shape == (M, 4 if with_gp else 3)
    _compare(out, ref)


def test_epilogue_writes_only_ring_row_end():
    """The pair lands in row `end` of the donated stacks; every other row
    is left exactly as it was."""
    rows, end = 37, 3
    n = 128 * rows
    xp, d, gp = _rand(n, 10), _rand(n, 11, 0.1), _rand(n, 12)
    S, Y = _hist(rows, 13, jnp.float32)
    out = epilogue.trial_pair_gram(rosenbrock.value_and_grad.kernels.block_fn,
                                   (), xp, d, gp, 0.5, S, Y, end,
                                   interpret=True)
    S_new, Y_new, g = out[7], out[8], out[2]
    keep = [j for j in range(M) if j != end]
    np.testing.assert_array_equal(np.asarray(S_new)[keep], np.asarray(S)[keep])
    np.testing.assert_array_equal(np.asarray(Y_new)[keep], np.asarray(Y)[keep])
    np.testing.assert_allclose(np.asarray(S_new[end]).reshape(-1),
                               np.asarray(0.5 * d), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(Y_new[end]).reshape(-1),
                               np.asarray(g - gp), rtol=1e-6)


@pytest.mark.parametrize("x64", [True, False], ids=["f64", "df32"])
def test_epilogue_wide_fx_reduces_partials(x64):
    """Under fx_wide the per-block fx partials reduce in the wide
    representation (an f64 scalar, or a double-float pair without x64);
    each partial is an f32 sum over one block, so the total is good to
    f32 rounding of the partials."""
    rows = 37
    n = 128 * rows
    xp = _rand(n, 20, 30.0)  # large fx: f32 total loses digits
    d, gp = _rand(n, 21, 0.1), _rand(n, 22)
    S, Y = _hist(rows, 23, jnp.float32)
    block = rosenbrock.value_and_grad.kernels.block_fn
    x_np = np.asarray(xp, np.float64) + np.float32(0.25) * np.asarray(d, np.float64)
    x_np = np.asarray(np.float32(x_np), np.float64)
    e, o = x_np[0::2], x_np[1::2]
    exact = float(np.sum((1 - e) ** 2 + (10 * (o - e * e)) ** 2))
    with jax.enable_x64(x64), fused.wide_fx(True):
        out = epilogue.trial_pair_gram(block, (), xp, d, gp, 0.25, S, Y, 0,
                                       interpret=True)
        mode = fused.wide_mode()
    from lbfgs_jax.core import fx_host

    assert mode == ("f64" if x64 else "df32")
    if x64:
        assert out[1].dtype == jnp.float64
    else:
        assert out[1].shape == (2,) and out[1].dtype == jnp.float32
    assert fx_host(out[1]) == pytest.approx(exact, rel=2e-7)


@pytest.mark.parametrize("rows", [32, 37], ids=["aligned", "tail"])
def test_epilogue_streams_bound_extras(rows):
    """A factory objective with extra operand streams (the weighted
    quadratic binds w and t) feeds them block by block."""
    n = 128 * rows
    w = 0.5 + jnp.abs(_rand(n, 30))
    t = _rand(n, 31)
    obj = separable.quadratic(w, t)
    xp, d, gp = _rand(n, 32), _rand(n, 33, 0.1), _rand(n, 34)
    S, Y = _hist(rows, 35, jnp.bfloat16)
    out = epilogue.trial_pair_gram(obj.kernels.block_fn, obj.kernels.extras,
                                   xp, d, gp, 0.3, S, Y, 2, interpret=True)
    ref = epilogue.trial_pair_gram_ref(obj, xp, d, gp, 0.3, S, Y, 2)
    _compare(out, ref)


def test_epilogue_rejects_mismatched_history():
    n = 128 * 8
    x = _rand(n, 40)
    S, Y = _hist(4, 41, jnp.float32)  # 4 rows of 128, not 8
    with pytest.raises(ValueError, match="does not match"):
        epilogue.trial_pair_gram(rosenbrock.value_and_grad.kernels.block_fn,
                                 (), x, x, x, 0.1, S, Y, 0, interpret=True)


@pytest.mark.parametrize("case", ["cpu", "small", "unaligned", "f64",
                                  "flat_history"])
def test_gate_keeps_plain_path(case, monkeypatch):
    """The kernel engages only on a GPU, at n >= MIN_N, for lane-aligned
    f32 problems with a ring-major history; here (CPU) never."""
    n = epilogue.MIN_N
    x = jnp.zeros((n,), jnp.float32)
    S = jnp.zeros((M, n // 128, 128), jnp.bfloat16)
    if case != "cpu":
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(jax, "device_count", lambda *a: 1)
        assert epilogue.supported(x, S)
    if case == "small":
        x = jnp.zeros((n // 2,), jnp.float32)
        S = jnp.zeros((M, n // 256, 128), jnp.bfloat16)
    elif case == "unaligned":
        x = jnp.zeros((n + 2,), jnp.float32)
        S = jnp.zeros((M, n + 2), jnp.bfloat16)
    elif case == "f64":
        x = jnp.zeros((n,), jnp.float64)
    elif case == "flat_history":
        S = jnp.zeros((M, n), jnp.bfloat16)
    assert not epilogue.supported(x, S)
    assert not rosenbrock.value_and_grad.kernels.trial_pair_gram_ok(x, S)


def _solve(params, obj, n, driver="jit"):
    from lbfgs_jax.minimize import minimize, minimize_jit

    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    if driver == "jit":
        return minimize_jit(params, x0, obj)
    return minimize(params, x0, obj)


@pytest.mark.parametrize(
    "variant,algorithm",
    [("plain", "MoreThuente"), ("plain", "BacktrackingArmijo"),
     ("damped", "MoreThuente"), ("damped", "BacktrackingWolfe"),
     ("damped_fixed", "MoreThuente"), ("damped_fixed", "BacktrackingStrongWolfe")],
)
def test_solver_epilogue_path_pinned_to_plain_path(epilogue_interpret,
                                                   variant, algorithm):
    """With the epilogue engaged (interpret mode) the solver follows the
    plain XLA path's f32 trajectory over a fixed prefix: same iteration
    count, fx within f32 reassociation drift."""
    n = 128 * 20
    params = LbfgsParams(
        max_iterations=10, epsilon=0.0, history_dtype="bfloat16",
        damping=variant != "plain", damping_fixed=variant == "damped_fixed",
    ).replace_ls(algorithm=algorithm)
    from lbfgs_jax.ops.factory import without_epilogue

    rep_k = _solve(params, rosenbrock.value_and_grad, n)
    assert epilogue_interpret, "the epilogue did not engage"
    rep_p = _solve(params, without_epilogue(rosenbrock.value_and_grad), n)
    assert rep_k.niter == rep_p.niter
    assert rep_k.fx == pytest.approx(rep_p.fx, rel=1e-3)


def test_host_driver_engages_epilogue(epilogue_interpret):
    """The step-at-a-time host driver takes the same fused path."""
    n = 128 * 20
    params = LbfgsParams(max_iterations=6, epsilon=0.0)
    rep = _solve(params, rosenbrock.value_and_grad, n, driver="host")
    assert epilogue_interpret
    assert np.isfinite(rep.fx) and rep.niter == 6
