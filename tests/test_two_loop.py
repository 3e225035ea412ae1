"""Two-loop recursion: scan vs compact equivalence, and both vs a dense
reference H_k @ g product built from the BFGS recursion directly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.solver import make_history, two_loop_compact, two_loop_scan


def _rand_hist(rng, m, n):
    S = rng.randn(m, n)
    Y = rng.randn(m, n)
    ys = np.einsum("ij,ij->i", S, Y)
    return make_history(
        jnp.asarray(S), jnp.asarray(Y), jnp.asarray(ys), jnp.zeros(m)
    )


def _dense_hg(S, Y, gamma, order, g):
    """Dense inverse-Hessian application: H = V^T H V + rho s s^T chained
    over pairs in `order` (oldest..newest), H_0 = gamma I."""
    n = S.shape[1]
    H = gamma * np.eye(n)
    for j in order:
        s, y = S[j], Y[j]
        rho = 1.0 / (y @ s)
        V = np.eye(n) - rho * np.outer(y, s)
        H = V.T @ H @ V + rho * np.outer(s, s)
    return H @ g


@pytest.mark.parametrize("bound,end", [(1, 0), (3, 2), (6, 5), (6, 1)])
def test_scan_matches_dense(bound, end):
    rng = np.random.RandomState(bound * 10 + end)
    m, n = 6, 12
    hist = _rand_hist(rng, m, n)
    d = jnp.asarray(rng.randn(n))
    gamma = 0.7
    r, _ = two_loop_scan(hist, d, jnp.float64(gamma), jnp.int32(bound), jnp.int32(end))
    # ring order: newest is slot `end`, so oldest..newest is
    # end-bound+1 .. end (mod m)
    order = [(end - i) % m for i in range(bound)][::-1]
    expected = _dense_hg(np.asarray(hist.s), np.asarray(hist.y), gamma, order, np.asarray(d))
    np.testing.assert_allclose(np.asarray(r), expected, rtol=1e-10)


@pytest.mark.parametrize("bound", [0, 1, 2, 4, 6])
@pytest.mark.parametrize("end", [0, 3, 5])
def test_compact_matches_scan(bound, end):
    rng = np.random.RandomState(bound * 7 + end)
    m, n = 6, 40
    hist = _rand_hist(rng, m, n)
    d = jnp.asarray(rng.randn(n))
    gamma = jnp.float64(abs(rng.randn()) + 0.1)
    r1, a1 = two_loop_scan(hist, d, gamma, jnp.int32(bound), jnp.int32(end))
    r2, a2 = two_loop_compact(hist, d, gamma, jnp.int32(bound), jnp.int32(end))
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2), rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("bound,end", [(1, 0), (4, 2), (6, 5)])
def test_ring_major_storage_matches_flat(bound, end):
    """Lane-aligned n stores the history ring-major [m, n/128, 128]
    (core.hist_store_shape); results must match the flat [m, n] math."""
    rng = np.random.RandomState(bound + end)
    m, n = 6, 1024
    hist = _rand_hist(rng, m, n)
    assert hist.s.ndim == 3 and hist.s.shape == (m, n // 128, 128)
    d = jnp.asarray(rng.randn(n))
    gamma = jnp.float64(0.9)
    r1, a1 = two_loop_scan(hist, d, gamma, jnp.int32(bound), jnp.int32(end))
    r2, a2 = two_loop_compact(hist, d, gamma, jnp.int32(bound), jnp.int32(end))
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), rtol=1e-12, atol=1e-12)
    order = [(end - i) % m for i in range(bound)][::-1]
    S2 = np.asarray(hist.s).reshape(m, n)
    Y2 = np.asarray(hist.y).reshape(m, n)
    expected = _dense_hg(S2, Y2, float(gamma), order, np.asarray(d))
    np.testing.assert_allclose(np.asarray(r1), expected, rtol=1e-10)


def test_bound_zero_scales_by_gamma():
    rng = np.random.RandomState(0)
    hist = _rand_hist(rng, 6, 10)
    d = jnp.asarray(rng.randn(10))
    for fn in (two_loop_scan, two_loop_compact):
        out = fn(hist, d, jnp.float64(2.5), jnp.int32(0), jnp.int32(0))
        r = out[0]
        np.testing.assert_allclose(np.asarray(r), 2.5 * np.asarray(d), rtol=1e-15)
