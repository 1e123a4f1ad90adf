"""Test configuration: the CPU backend with a virtual 8-device mesh, so
sharding tests run without accelerator hardware; the reference's fast-test
philosophy (tiny grid, heavy subsystems off by default —
/root/reference/tests/conftest.py:21-42).

``JAX_PLATFORMS`` set to anything but ``cpu`` (e.g. ``cuda``) leaves the
backend alone instead: that is how the ``gpu``-marked tests run on a card,
in one process (README "Tests")."""

import os

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
# Must be set before jax import.
if ON_CPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("MPLBACKEND", "Agg")

import jax

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
# Math-parity tests compare against float64 NumPy/SciPy oracles.
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def small_grid():
    from qingdai_tpu.grid import make_grid
    return make_grid(19, 36)
