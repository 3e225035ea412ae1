"""Collective-count proof for the sharded hot path.

``solver.two_loop_compact`` claims all 2m+2 dot products of one iteration
collapse into ONE collective round (solver.py module docstring).  This
test compiles ``propagate`` under the 8-virtual-device CPU mesh with the
real state shardings and inspects the optimized HLO:

- exactly ONE all-reduce inside the line-search while body (the fused
  (fx, dg) trial round),
- ONE batched all-reduce carrying the entire gram round as a tuple —
  including both [m, 3] gram blocks — not per-dot collectives,
- ONE all-reduce for the combine epilogue's (r.r, r.d),
- and nothing else: no all-gather / all-to-all / reduce-scatter of the
  vector state anywhere.

A regression that reintroduces per-dot collectives fails the <=3 budget.
"""

import re

import jax
import jax.numpy as jnp
import pytest

from lbfgs_jax.core import ProblemDef
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.params import LbfgsParams
from lbfgs_jax.parallel import make_mesh, shard_vector, state_shardings
from lbfgs_jax.solver import init_state, propagate


@pytest.fixture(scope="module")
def propagate_hlo():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(jax.devices()[:8])
    n = 1024  # ring-major history (rows=8, one per device)
    params = LbfgsParams()
    pdef = ProblemDef(value_and_grad=rosenbrock.value_and_grad)
    x0 = shard_vector(rosenbrock.initial_point(n, dtype=jnp.float32), mesh)
    st = jax.jit(lambda x: init_state(pdef, params, x))(x0)
    sh = state_shardings(mesh, st, n)
    st = jax.device_put(st, sh)
    step = jax.jit(
        lambda s: propagate(pdef, params, s), in_shardings=(sh,), out_shardings=sh
    )
    return step.lower(st).compile().as_text()


def _all_reduce_lines(txt):
    # result types may be tuples with spaces: `%x = (f32[], f32[]) all-reduce(`
    return [l for l in txt.splitlines() if re.search(r" all-reduce\(", l)]


def test_at_most_three_all_reduce_rounds(propagate_hlo):
    ars = _all_reduce_lines(propagate_hlo)
    assert len(ars) <= 3, (
        f"propagate compiled to {len(ars)} all-reduce rounds (expected <=3: "
        "trial, gram, combine) — per-dot collectives have crept back:\n"
        + "\n".join(a[:160] for a in ars)
    )


def test_line_search_body_has_one_all_reduce(propagate_hlo):
    body_ars = [
        l for l in _all_reduce_lines(propagate_hlo) if "while/body" in l
    ]
    assert len(body_ars) == 1, body_ars


def test_gram_round_is_one_batched_all_reduce(propagate_hlo):
    """Both [m, 3] gram blocks (S'[s y d], Y'[s y d]) must travel in a
    single tuple all-reduce, not separate rounds."""
    m = LbfgsParams().m
    gram = [
        l
        for l in _all_reduce_lines(propagate_hlo)
        if len(re.findall(rf"f32\[{m},3\]", l)) >= 2  # both blocks in the result tuple
    ]
    assert len(gram) == 1, (
        "expected exactly one batched gram all-reduce carrying both "
        f"[{m},3] blocks:\n" + "\n".join(_all_reduce_lines(propagate_hlo))
    )


def test_no_vector_regathering_collectives(propagate_hlo):
    """The [n] vector state must never be all-gathered: shard-local compute
    + scalar reductions only."""
    for kind in ("all-gather", "all-to-all", "reduce-scatter"):
        hits = re.findall(rf" {kind}\(", propagate_hlo)
        assert not hits, f"unexpected {kind} in propagate HLO: {hits[:3]}"
