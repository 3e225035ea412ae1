"""Test harness configuration.

Tests run on CPU with 8 virtual devices (the standard JAX analog of
"multi-node without a real cluster", SURVEY.md §4) and 64-bit floats for
deterministic-f64 parity with the reference golden values.  Tests marked
``gpu`` need the card and skip here; ``python chip_smoke.py`` runs their
checks on it.
"""

import os

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; run on the card by chip_smoke.py"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import time, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("no GPU backend in this process")


@pytest.fixture
def epilogue_interpret(monkeypatch):
    """Engage the fused epilogue (``ops/epilogue.py``) on CPU: its gate
    admits any lane-aligned ring-major problem and the Triton kernel runs
    through the Pallas interpreter.  Yields a list that records each
    kernel invocation."""
    from lbfgs_jax.ops import epilogue

    calls = []
    kernel = epilogue.trial_pair_gram

    def interpret(*args, **kwargs):
        calls.append(True)
        return kernel(*args, interpret=True, **kwargs)

    monkeypatch.setattr(
        epilogue, "supported",
        lambda x, S, *extras: (x.shape[0] % 128 == 0 and S.ndim == 3
                               and x.dtype == jax.numpy.float32),
    )
    monkeypatch.setattr(epilogue, "trial_pair_gram", interpret)
    yield calls
