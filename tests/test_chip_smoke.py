"""chip_smoke.py: its contract on the CPU (refuses a CPU-only backend, exact
last-line keys, fails alone) and its on-card phases as ``gpu``-marked tests.

The ``gpu`` tests decide in a fixture whether a card is present and skip
here; on a card run them in one process:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_chip_smoke.py
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_require_gpu_refuses_cpu_backend():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(RuntimeError):
        chip_smoke.require_gpu([])


def test_result_line_has_exactly_the_contract_keys():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1}}


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if not k.startswith("QD_")}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return proc.returncode != 0 and not (lines and '"ok"' in lines[-1])


def test_chip_smoke_fails_without_an_accelerator():
    assert _no_result(_run(ROOT))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    assert _no_result(_run(tmp_path))


# ------------------------------------------------------------------ on card
@pytest.fixture(scope="module")
def card():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu "
                    "tests/test_chip_smoke.py")
    return chip_smoke.phase_device()


@pytest.fixture(scope="module")
def day_one(card):
    return chip_smoke.day_one()


@pytest.mark.gpu
def test_median_parity_on_card(day_one):
    assert chip_smoke.check_median(chip_smoke.median_fields(*day_one)) <= 1.0


@pytest.mark.gpu
def test_windowed_advection_parity_on_card(day_one):
    assert chip_smoke.check_advection(*day_one) <= 1e-6


@pytest.mark.gpu
def test_hyperdiffusion_parity_on_card(day_one):
    assert chip_smoke.check_hyper4(*day_one) <= 1e-5


@pytest.mark.gpu
def test_phyto_contractions_on_card(day_one):
    assert chip_smoke.check_phyto(*day_one) <= 1e-6


@pytest.mark.gpu
def test_main_path_on_card(card):
    chip_smoke.phase_main_path(card)


@pytest.mark.gpu
def test_card_matches_cpu_f64(card):
    chip_smoke.phase_card_vs_cpu()
