"""Doc-example and utility-subsystem tests (the reference pins its public
API shape with doc-tests, ``src/lib.rs:9-53``)."""

import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest


def test_package_docstring_example():
    """The package-docstring quick start runs as written."""
    from lbfgs_jax import lbfgs, default_evaluate, default_progress

    n = 100
    x0 = jnp.zeros(n).at[0::2].set(-1.2).at[1::2].set(1.0)
    report = (
        lbfgs()
        .with_max_iterations(5)
        .minimize(x0, default_evaluate(), default_progress())
    )
    assert report.niter == 5
    assert np.isfinite(report.fx)


def test_owlqn_docstring_variant():
    from lbfgs_jax import lbfgs, default_evaluate

    x0 = jnp.ones(100)
    report = (
        lbfgs()
        .with_orthantwise(1.0, 0, 99)
        .minimize(x0, default_evaluate())
    )
    assert report.fx == pytest.approx(43.5025, rel=1e-4)


def test_checkpoint_save_load_roundtrip():
    from lbfgs_jax.minimize import LbfgsState
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.params import LbfgsParams
    from lbfgs_jax.utils.checkpoint import load_state, save_state

    x0 = rosenbrock.initial_point(20)
    a = LbfgsState.build(LbfgsParams(), x0, rosenbrock.value_and_grad)
    for _ in range(6):
        a.propagate()

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "ckpt.npz")
        save_state(path, a.state)

        b = LbfgsState.build(LbfgsParams(), x0, rosenbrock.value_and_grad)
        b.restore(load_state(path, b.state))

        for _ in range(4):
            a.propagate()
            b.propagate()
        np.testing.assert_array_equal(
            np.asarray(a.state.prob.x), np.asarray(b.state.prob.x)
        )


def test_csv_loader_matches_reference_format():
    from lbfgs_jax.utils.csvio import read_r_csv

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "t.csv")
        with open(path, "w") as f:
            f.write('"","V1","V2"\n"1",1,-0.5\n"2",2,0.25\n')
        arr = read_r_csv(path)
        np.testing.assert_array_equal(arr, [[1.0, -0.5], [2.0, 0.25]])


def test_minimize_pytree():
    import jax.numpy as jnp
    from lbfgs_jax import lbfgs, minimize_pytree

    x0 = {"w": jnp.zeros((3, 3)), "b": jnp.ones(3)}

    def loss(p):
        return jnp.sum((p["w"] - 2.0) ** 2) + jnp.sum((p["b"] + 1.0) ** 2)

    rep, final = minimize_pytree(loss, x0, lbfgs())
    assert rep.fx == pytest.approx(0.0, abs=1e-8)
    np.testing.assert_allclose(np.asarray(final["w"]), 2.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(final["b"]), -1.0, atol=1e-5)


def test_minimize_pytree_jit_driver():
    import jax.numpy as jnp
    from lbfgs_jax import lbfgs, minimize_pytree

    x0 = [jnp.zeros(5), jnp.zeros(2)]

    def loss(p):
        return jnp.sum((p[0] - 1.0) ** 2) + jnp.sum(p[1] ** 2)

    rep, final = minimize_pytree(loss, x0, lbfgs(), jit_driver=True)
    assert rep.fx == pytest.approx(0.0, abs=1e-10)


def test_profiling_trace_and_timed(tmp_path):
    import jax.numpy as jnp

    from lbfgs_jax import lbfgs, default_evaluate
    from lbfgs_jax.utils.profiling import timed, trace

    x0 = jnp.zeros(16).at[0::2].set(-1.2).at[1::2].set(1.0)
    run = lambda: lbfgs().with_max_iterations(3).minimize_jit(x0, default_evaluate())

    logdir = str(tmp_path / "trace")
    with trace(logdir):
        run()
    import os

    assert any(os.scandir(logdir)), "profiler trace wrote nothing"

    dt = timed(run, warmup=1, repeats=2)
    assert dt > 0.0
