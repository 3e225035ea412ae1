"""``chip_smoke.py`` at tiny sizes on the CPU: every phase's control flow
and checks (the card runs them at full size), its refusal to run
without a GPU, and the trace reducer's scope attribution."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_refuses_without_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""  # prints no result
    assert "no GPU" in out.err


def test_refuses_outside_the_repo(tmp_path):
    """Alone in a directory it cannot import the library: non-zero exit,
    no contract line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_card_info_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(chip_smoke.shutil, "which", lambda name: None)
    assert chip_smoke.card_info() == "nvidia-smi not found"


def test_phase_rosenbrock_tiny():
    out = chip_smoke.phase_rosenbrock(1 << 12, 4)
    assert out["fx"] < out["fx0"]
    assert len(out["host_loop_fx"]) >= 5
    assert out["step_memory"]["argument_size_in_bytes"] > 0


def test_phase_native_parity_tiny():
    out = chip_smoke.phase_native_parity(1 << 8)
    assert set(out) >= {"plain", "damped", "owlqn", "n"}


@pytest.mark.parametrize("wide", [False, True], ids=["f32", "wide"])
def test_phase_owlqn_tiny(wide):
    out = chip_smoke.phase_owlqn(1 << 12, 4, wide=wide)
    assert out["fx"] < out["fx0"]


def test_phase_damped_tiny():
    out = chip_smoke.phase_damped(1 << 12, 4)
    assert out["fx"] == pytest.approx(out["fx_f64"], rel=1e-4)


def test_phase_logistic_tiny():
    out = chip_smoke.phase_logistic(256, 64, iters=10)
    assert set(out) >= {"default", "highest", "small_500x21"}


def test_phase_batch_tiny():
    out = chip_smoke.phase_batch(8, 64)
    assert out["B"] == 8 and out["max_niter"] > 1


def test_phase_precision_tiny():
    out = chip_smoke.phase_precision(1 << 12, eps=1e-3)
    for prec in ("default", "highest"):
        assert out[prec]["status"] == 1  # converged
        # the CPU has no reduced-precision matmul: both settings are f32
        assert out[prec]["gram_rel_err_vs_f64"] < 1e-5


def test_phase_kernel_vs_xla_tiny():
    out = chip_smoke.phase_kernel_vs_xla((1 << 12,), lambda n: 3)
    res = out[str(1 << 12)]
    assert len(res["iters_per_s"]["kernel"]) == 6
    # on the CPU both objectives take the plain path: same trajectory
    assert res["fx_after"]["kernel"] == res["fx_after"]["plain"]


def test_phase_four_cards_on_virtual_devices():
    out = chip_smoke.phase_four_cards(8 * 1024, 3)
    assert out["plain"]["sharded"]["devices"] == jax.device_count()


def test_trace_scope_map_finds_solver_phases():
    from bench_trace import scope_map

    from lbfgs_jax.core import ProblemDef
    from lbfgs_jax.models import rosenbrock
    from lbfgs_jax.params import LbfgsParams

    params = LbfgsParams(max_iterations=3)
    x0 = rosenbrock.initial_point(1 << 10, dtype=jnp.float32)
    comp, _ = chip_smoke._aot(params,
                              ProblemDef(value_and_grad=rosenbrock.value_and_grad),
                              x0)
    scopes = set(scope_map(comp.as_text()).values())
    assert {"lbfgs.line_search", "lbfgs.two_loop"} <= scopes
