"""Checks that need an NVIDIA GPU.

Marked ``gpu``: under pytest (which the conftest pins to the CPU) they
skip through the ``gpu`` fixture.  ``python chip_smoke.py`` calls them on
the card, where the fused epilogue compiles through Triton (no interpret
mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _rand(shape, seed, scale=1.0, dtype=jnp.float32):
    return jnp.asarray(
        np.random.RandomState(seed).randn(*np.atleast_1d(shape)) * scale, dtype
    )


def test_propagate_runs_on_gpu(gpu):
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.params import LbfgsParams
    from lbfgs_jax.solver import init_state, propagate_hot, start_state

    n = 1 << 16
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
    params = LbfgsParams()
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    st = jax.jit(lambda x: start_state(init_state(pdef, params, x)))(x0)
    step = jax.jit(lambda s: propagate_hot(pdef, params, s))
    st = step(step(st))
    assert np.isfinite(float(st.prob.fx))
    assert int(st.k) == 3
    assert int(st.status) == 0


@pytest.mark.parametrize("rows", [512, 1001])  # whole blocks, masked tail
@pytest.mark.parametrize("with_gp", [False, True])
def test_epilogue_compiled_matches_reference(gpu, rows, with_gp):
    """The Triton-compiled epilogue equals the composed jnp oracle."""
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.ops import epilogue

    m, n = 6, 128 * rows
    xp, d, gp = _rand(n, 1), _rand(n, 2, 0.1), _rand(n, 3)
    S = _rand((m, rows, 128), 4, 0.1, jnp.bfloat16)
    Y = _rand((m, rows, 128), 5, 0.1, jnp.bfloat16)
    k = rosenbrock.value_and_grad.kernels
    assert epilogue.supported(xp, S)
    for end in (0, 5):
        ref = epilogue.trial_pair_gram_ref(
            rosenbrock.value_and_grad, xp, d, gp, 0.3, S, Y, end,
            with_gp=with_gp,
        )
        out = jax.jit(
            lambda *a: epilogue.trial_pair_gram(
                k.block_fn, (), *a, with_gp=with_gp),
            static_argnums=(6,),
        )(xp, d, gp, jnp.float32(0.3), S, Y, end)
        for i in (0, 2, 7, 8):  # xt, g, S_new, Y_new
            np.testing.assert_allclose(
                np.asarray(out[i], np.float32), np.asarray(ref[i], np.float32),
                rtol=1e-5, atol=1e-5)
        for i in (1, 3, 4, 5):  # fx, dg, gg, xx: f32 sums of n terms
            assert float(out[i]) == pytest.approx(float(ref[i]), rel=1e-4)
        assert bool(out[6]) == bool(ref[6])
        for i in (9, 10):  # SP, YP
            np.testing.assert_allclose(np.asarray(out[i]), np.asarray(ref[i]),
                                       rtol=1e-3, atol=1e-3)


def test_epilogue_solver_matches_plain_path(gpu):
    """minimize_jit with the compiled epilogue follows the plain XLA
    path's trajectory over a fixed prefix."""
    from lbfgs_jax.minimize import minimize_jit
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.ops.factory import without_epilogue
    from lbfgs_jax.params import LbfgsParams

    n = 1 << 16
    params = LbfgsParams(max_iterations=12, epsilon=0.0,
                         history_dtype="bfloat16")
    x0 = rosenbrock.initial_point(n, dtype=jnp.float32)
    rep_k = minimize_jit(params, x0, rosenbrock.value_and_grad)
    rep_p = minimize_jit(params, x0, without_epilogue(rosenbrock.value_and_grad))
    assert rep_k.niter == rep_p.niter
    assert rep_k.fx == pytest.approx(rep_p.fx, rel=1e-3)

