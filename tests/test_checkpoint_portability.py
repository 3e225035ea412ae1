"""Checkpoint portability across history layouts: the storage shape
depends on n alone (``core.hist_store_shape``: ring-major [m, n/128, 128]
when lane-aligned, else flat [m, n]), never on the devices present, but a
checkpoint written in the flat layout must still restore into a
ring-major template and back.  ``utils.checkpoint.load_state``
canonicalizes by reshape (the layouts are element-order-identical); these
tests pin the round trip in BOTH directions and the config-mismatch
detection.

Reference anchor: the resumable state machine being extended
(``src/lbfgs.rs:443-499``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lbfgs_jax.core import hist_store_shape
from lbfgs_jax.minimize import LbfgsState
from lbfgs_jax.models import rosenbrock
from lbfgs_jax.params import LbfgsParams
from lbfgs_jax.utils.checkpoint import load_state, save_state

N = 1024  # lane-aligned: ring-major history
M = 6


def _build(params=None):
    x0 = rosenbrock.initial_point(N, dtype=jnp.float64)
    return LbfgsState.build(params or LbfgsParams(), x0, rosenbrock.value_and_grad)


def _steps(solver, k):
    out = []
    for _ in range(k):
        out.append(float(solver.propagate().fx))
    return out


def _force_flat(monkeypatch):
    """Build states with the flat [m, n] history (the layout of a
    checkpoint written for an unaligned-layout configuration)."""
    import lbfgs_jax.solver as solver

    monkeypatch.setattr(solver, "hist_store_shape", lambda m, n: (m, n))


def test_layouts_differ_by_device_count(monkeypatch):
    """They no longer do: the layout is a function of n alone, so a
    one-device run on a many-device host keeps the one-device layout."""
    import jax

    ring = hist_store_shape(M, N)
    assert ring == (M, N // 128, 128)
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 3)
    assert hist_store_shape(M, N) == ring
    assert hist_store_shape(M, N + 2) == (M, N + 2)


@pytest.mark.parametrize("direction", ["ring_to_flat", "flat_to_ring"])
def test_checkpoint_round_trip_across_layouts(tmp_path, monkeypatch, direction):
    path = str(tmp_path / "ckpt.npz")

    # saver runs 5 real iterations (full history ring in play), then saves
    if direction == "flat_to_ring":
        with monkeypatch.context() as mp:
            _force_flat(mp)
            saver = _build()
            _steps(saver, 6)
            assert saver.state.hist.s.shape == (M, N)
            save_state(path, saver.state)
    else:
        saver = _build()
        _steps(saver, 6)
        assert saver.state.hist.s.shape == (M, N // 128, 128)
        save_state(path, saver.state)
    cont_ref = _steps(saver, 5)

    # loader builds its template under the OTHER layout and restores
    if direction == "flat_to_ring":
        loader = _build()
        expect_shape = (M, N // 128, 128)
    else:
        with monkeypatch.context() as mp:
            _force_flat(mp)
            loader = _build()
        expect_shape = (M, N)
    st = load_state(path, loader.state)
    assert st.hist.s.shape == expect_shape
    assert st.hist.y.shape == expect_shape
    loader.restore(st)

    # the restored run continues the saved trajectory (layout changes only
    # reassociate the history matvec reductions: f64 tolerance-level)
    cont = _steps(loader, 5)
    np.testing.assert_allclose(cont, cont_ref, rtol=1e-9)


def test_checkpoint_restores_bf16_history_into_f32_template(tmp_path):
    path = str(tmp_path / "ckpt_bf16.npz")
    saver = _build(LbfgsParams(history_dtype="bfloat16"))
    _steps(saver, 4)
    assert saver.state.hist.s.dtype == jnp.bfloat16
    save_state(path, saver.state)

    loader = _build(LbfgsParams())
    st = load_state(path, loader.state)
    assert st.hist.s.dtype == loader.state.hist.s.dtype  # cast to template
    loader.restore(st)
    fx = _steps(loader, 3)
    assert np.all(np.isfinite(fx))


def test_checkpoint_mismatch_detected(tmp_path):
    path = str(tmp_path / "ckpt_m.npz")
    saver = _build(LbfgsParams(m=6))
    _steps(saver, 2)
    save_state(path, saver.state)

    other_m = _build(LbfgsParams(m=4))
    with pytest.raises(ValueError, match="element count"):
        load_state(path, other_m.state)

    x_small = rosenbrock.initial_point(512, dtype=jnp.float64)
    other_n = LbfgsState.build(LbfgsParams(), x_small, rosenbrock.value_and_grad)
    with pytest.raises(ValueError, match="element count"):
        load_state(path, other_n.state)
