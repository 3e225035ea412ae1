"""Golden end-to-end convergence tests against the reference test suite
(``tests/simple.rs``, ``tests/owlqn.rs``): same problems, same tolerances.

Iteration counts are rounding-trajectory dependent (XLA reassociates the
f64 reductions the reference computes sequentially — SURVEY.md §7 "hard
parts"), so fx/x goldens use the reference epsilons while iteration counts
assert a sane band around the reference's recorded 37 / 171.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax import lbfgs
from lbfgs_jax.models import booth, rosenbrock


def test_lbfgs_rosenbrock_golden():
    """Reference: 37 iterations, fx = 1.28e-15, x = 1 (tests/simple.rs:16-40)."""
    x0 = rosenbrock.initial_point(100)
    rep = lbfgs().minimize(x0, rosenbrock.value_and_grad)
    assert rep.fx == pytest.approx(0.0, abs=1e-4)
    np.testing.assert_allclose(np.asarray(rep.x), 1.0, atol=1e-4)
    assert rep.niter <= 60  # reference records 37
    # converged via scaled gnorm
    assert rep.gnorm / max(1.0, rep.xnorm) <= 1e-5


def test_owlqn_rosenbrock_golden():
    """Reference: 171 iterations, fx = 43.5025, x0 = 0.25, x1 = 0.0575
    (tests/simple.rs:42-54) — started from the L-BFGS solution."""
    x0 = rosenbrock.initial_point(100)
    rep1 = lbfgs().minimize(x0, rosenbrock.value_and_grad)
    rep = lbfgs().with_orthantwise(1.0, 0, 99).minimize(
        rep1.x, rosenbrock.value_and_grad
    )
    assert rep.fx == pytest.approx(43.5025, abs=1e-4 * 43.5025)
    assert float(rep.x[0]) == pytest.approx(0.25, abs=1e-4)
    assert float(rep.x[1]) == pytest.approx(0.0575, abs=1e-4)
    assert rep.niter <= 260  # reference records 171


def test_lbfgs_booth_golden():
    """Reference: solution (1, 3) at 1e-6 (tests/simple.rs:57-83)."""
    rep = lbfgs().minimize(jnp.array([-1.2, 1.0]), booth.value_and_grad)
    assert float(rep.x[0]) == pytest.approx(1.0, abs=1e-6)
    assert float(rep.x[1]) == pytest.approx(3.0, abs=1e-6)


def test_scan_two_loop_same_goldens():
    """The literal scan two-loop path reaches the same solution."""
    x0 = rosenbrock.initial_point(100)
    rep = lbfgs().with_compact_two_loop(False).minimize(x0, rosenbrock.value_and_grad)
    assert rep.fx == pytest.approx(0.0, abs=1e-4)
    np.testing.assert_allclose(np.asarray(rep.x), 1.0, atol=1e-4)


def test_backtracking_algorithms_converge():
    x0 = rosenbrock.initial_point(20)
    for algo in ("BacktrackingArmijo", "BacktrackingWolfe", "BacktrackingStrongWolfe"):
        rep = (
            lbfgs()
            .with_linesearch_algorithm(algo)
            .minimize(x0, rosenbrock.value_and_grad)
        )
        assert rep.fx == pytest.approx(0.0, abs=1e-4), algo


def test_f32_converges_loosely():
    """The solver is dtype-generic; f32 reaches a loose tolerance."""
    x0 = rosenbrock.initial_point(16, dtype=jnp.float32)
    rep = lbfgs().with_epsilon(1e-3).minimize(x0, rosenbrock.value_and_grad)
    assert rep.fx == pytest.approx(0.0, abs=1e-2)


def test_bf16_history_still_converges():
    """Mixed-precision history (an extension): quantized (s, y)
    pairs degrade the direction slightly but the line search protects
    convergence; Rosenbrock must still reach the minimum."""
    import jax.numpy as jnp

    from lbfgs_jax import lbfgs
    from lbfgs_jax.models import rosenbrock

    x0 = rosenbrock.initial_point(256, dtype=jnp.float32)
    rep = (
        lbfgs()
        .with_history_dtype("bfloat16")
        .with_epsilon(1e-4)
        .with_max_iterations(300)
        .minimize_jit(x0, rosenbrock.value_and_grad)
    )
    assert rep.fx < 1e-4, rep.fx
    # and the history really is stored narrow
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.params import LbfgsParams
    from lbfgs_jax.solver import init_state

    st = init_state(
        ProblemDef(value_and_grad=rosenbrock.value_and_grad),
        LbfgsParams(history_dtype="bfloat16"),
        x0,
    )
    assert st.hist.s.dtype == jnp.bfloat16
