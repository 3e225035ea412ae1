"""Sharded-vector regime on a simulated 8-device CPU mesh (SURVEY.md §4):
sharded results must equal unsharded results within tolerance, and the
solver must accept sharded inputs transparently via GSPMD."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from lbfgs_jax import lbfgs
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.parallel import make_mesh, shard_vector, state_shardings, vector_sharding


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(jax.devices()[:8])


def test_shard_vector_layout(mesh):
    x = jnp.arange(64.0)
    xs = shard_vector(x, mesh)
    assert xs.sharding == vector_sharding(mesh)
    np.testing.assert_array_equal(np.asarray(xs), np.asarray(x))


def test_sharded_minimize_matches_unsharded(mesh):
    n = 64  # divisible by 8
    x0 = rosenbrock.initial_point(n)
    rep_plain = lbfgs().minimize_jit(x0, rosenbrock.value_and_grad)

    x0s = shard_vector(x0, mesh)
    rep_shard = lbfgs().minimize_jit(x0s, rosenbrock.value_and_grad)

    assert rep_shard.niter == rep_plain.niter
    assert rep_shard.fx == pytest.approx(rep_plain.fx, abs=1e-12)
    np.testing.assert_allclose(
        np.asarray(rep_shard.x), np.asarray(rep_plain.x), rtol=1e-9, atol=1e-12
    )


def test_sharded_dot_reduction(mesh):
    """The vecmath reductions produce one scalar regardless of sharding."""
    from lbfgs_jax.ops import vecmath as vm

    x = jnp.arange(128.0)
    xs = shard_vector(x, mesh)
    d_plain = float(jax.jit(vm.dot)(x, x))
    d_shard = float(jax.jit(vm.dot)(xs, xs))
    assert d_plain == pytest.approx(d_shard, rel=1e-12)


def test_state_shardings_specs(mesh):
    """state_shardings assigns P('shard') to [n] vectors, P(None,'shard')
    to [m, n] history, and replication to scalars/[m] stacks."""
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.params import LbfgsParams
    from lbfgs_jax.solver import init_state

    n = 64
    x0 = rosenbrock.initial_point(n)
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
    st = init_state(pdef, LbfgsParams(), x0)
    sh = state_shardings(mesh, st, n)
    assert sh.prob.x.spec == P("shard")
    assert sh.hist.s.spec == P(None, "shard")
    assert sh.hist.ys.spec == P()
    assert sh.step.spec == P()


def test_state_shardings_ring_major_history(mesh):
    """Lane-aligned n stores the history [m, rows, 128]; its rows axis
    carries the vector sharding, lanes stay local."""
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.params import LbfgsParams
    from lbfgs_jax.solver import init_state

    n = 1024  # rows = 8 -> one row per device
    x0 = rosenbrock.initial_point(n)
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
    st = init_state(pdef, LbfgsParams(), x0)
    assert st.hist.s.shape == (6, 8, 128)
    sh = state_shardings(mesh, st, n)
    assert sh.hist.s.spec == P(None, "shard", None)


def test_sharded_minimize_matches_unsharded_ring_major(mesh):
    """End-to-end sharded == unsharded on a lane-aligned n (3D history)."""
    n = 1024
    x0 = rosenbrock.initial_point(n)
    rep_plain = lbfgs().minimize_jit(x0, rosenbrock.value_and_grad)
    rep_shard = lbfgs().minimize_jit(shard_vector(x0, mesh), rosenbrock.value_and_grad)
    assert rep_shard.niter == rep_plain.niter
    assert rep_shard.fx == pytest.approx(rep_plain.fx, abs=1e-10)


def test_explicit_sharded_propagate(mesh):
    """propagate jitted with explicit in/out shardings runs and keeps the
    state sharded across all 8 devices."""
    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.params import LbfgsParams
    from lbfgs_jax.solver import init_state, propagate

    n = 64
    params = LbfgsParams()
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
    x0 = shard_vector(rosenbrock.initial_point(n), mesh)
    st = jax.jit(lambda x: init_state(pdef, params, x))(x0)
    sh = state_shardings(mesh, st, n)
    st = jax.device_put(st, sh)  # lay out the full state explicitly
    step = jax.jit(
        lambda s: propagate(pdef, params, s), in_shardings=(sh,), out_shardings=sh
    )
    st = step(st)  # k=1 no-op
    st = step(st)  # real iteration
    assert int(st.k) == 2
    assert int(st.status) == 0
    assert len(st.prob.x.sharding.device_set) == 8
    # trajectory value matches the unsharded propagate
    st_plain = jax.jit(lambda x: init_state(pdef, params, x))(
        rosenbrock.initial_point(n)
    )
    pstep = jax.jit(lambda s: propagate(pdef, params, s))
    st_plain = pstep(pstep(st_plain))
    np.testing.assert_allclose(
        np.asarray(st.prob.x), np.asarray(st_plain.prob.x), rtol=1e-12
    )


@pytest.mark.parametrize(
    "variant",
    ["plain", "damped", "damped_fixed", "owlqn", "damped_owlqn", "wide"],
)
def test_sharded_variant_matches_unsharded(mesh, variant):
    """Every solver variant on the partitioned jnp path: a sharded
    whole-run solve equals the unsharded one (f64, lane-aligned n with
    a ring-major history split one row block per device)."""
    from lbfgs_jax.minimize import minimize_jit
    from lbfgs_jax.orthantwise import Orthantwise
    from lbfgs_jax.params import LbfgsParams

    n = 2048
    kw = dict(max_iterations=30, constrain_step_size=False)
    if "damped" in variant:
        kw["damping"] = True
    if variant == "damped_fixed":
        kw["damping_fixed"] = True
    if "owlqn" in variant:
        kw["orthantwise"] = Orthantwise(1.0, 0, n)
    if variant == "wide":
        kw["fx_wide"] = True
    params = LbfgsParams(**kw)
    x0 = rosenbrock.initial_point(n)
    rep_plain = minimize_jit(params, x0, rosenbrock.value_and_grad)
    rep_shard = minimize_jit(params, shard_vector(x0, mesh),
                             rosenbrock.value_and_grad)
    # the shard split reassociates every f64 reduction; 30 iterations of
    # the Rosenbrock valley amplify that to ~1e-8 relative in fx
    assert rep_shard.niter == rep_plain.niter
    assert rep_shard.fx == pytest.approx(rep_plain.fx, rel=1e-6, abs=1e-10)
    np.testing.assert_allclose(np.asarray(rep_shard.x), np.asarray(rep_plain.x),
                               rtol=1e-5, atol=1e-7)
