"""chip_smoke.py at a tiny size on the CPU backend (PCR_FORCE_JAX=1 makes
the JAX CPU device act as the accelerator): every phase's control flow and
oracle comparison, and main()'s refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

import chip_smoke as cs
from conftest import selects_gpu_tests


@pytest.fixture(autouse=True)
def _force_jax(monkeypatch):
    monkeypatch.setenv("PCR_FORCE_JAX", "1")


def test_phase_device():
    assert cs.phase_device(platform="cpu")["count"] >= 1


def test_phase_point_dc(tmp_path):
    out = cs.phase_point_dc(n_points=20_000, n_resume=2_000, width=96,
                            tile=32, workdir=str(tmp_path), platform="cpu")
    assert out["cloud"].count() == 20_000
    assert os.path.exists(tmp_path / "dev.tif")
    assert os.path.isdir(tmp_path / "dev_state")


def test_phase_glyphs():
    out = cs.phase_glyphs(n_points=3_000, width=64, oracle_budget=2e5,
                          max_oracle=1_500, platform="cpu")
    assert set(out) == {name for name, _, _ in cs.glyph_cases()}


def test_phase_hybrid():
    out = cs.phase_hybrid(n_points=30_000, width=96, tile=32,
                          n_oracle=3_000, platform="cpu")
    assert out["max_rel"] <= 1e-4


def test_phase_out_of_core():
    out = cs.phase_out_of_core(n_points=20_000, width=96, tile=32,
                               budget=40_000, platform="cpu")
    assert out["max_abs"] >= 0.0


def test_phase_determinism():
    out = cs.phase_determinism(n_point=20_000, point_width=16,
                               n_gauss=2_000, gauss_width=48)
    # the CPU backend sums in a fixed order
    assert all(v["bit_identical"] for v in out.values())


def test_phase_multi_device():
    out = cs.phase_multi_device(n_cards=4, width=96, n_points=20_000,
                                n_gauss=1_000, n_line=2_000, tile_multi=32,
                                platform="cpu")
    assert "partitioned" in out and len(out) == 7


def test_main_refuses_without_nvidia_smi(monkeypatch, capsys):
    monkeypatch.setattr(cs, "card_info", lambda: None)
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert "no NVIDIA GPU" in out and '"ok"' not in out


def test_main_refuses_cpu_backend(monkeypatch, capsys):
    """With a card reported but JAX on the CPU, main() exits 1 and prints
    no result line."""
    monkeypatch.setattr(cs, "card_info", lambda: "Fake GPU, 700.00 W")
    monkeypatch.setattr(cs, "phase_gpu_tests", lambda: {"rc": 0})
    assert cs.main([]) == 1
    out = capsys.readouterr().out
    assert "JAX found no GPU" in out and '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """Run from a directory holding only chip_smoke.py (no package): a
    non-zero exit and no result line."""
    import shutil
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("argv,want", [
    (["-m", "gpu", "tests/"], True),
    (["-mgpu"], True),
    (["-m", "not slow", "-n", "6"], False),
    (["-m", "not gpu"], False),
    (["tests/", "-q"], False),
])
def test_selects_gpu_tests(argv, want):
    assert selects_gpu_tests(argv) is want
