"""Persistent compile cache placement (qingdai_tpu/compile_cache.py): the
QD_COMPILE_CACHE opt-out, JAX_COMPILATION_CACHE_DIR honoured as the only
directory, and the fixed in-checkout default on the GPU."""

import importlib
import os

import jax
import pytest

import qingdai_tpu.compile_cache as cc


@pytest.fixture
def fresh(monkeypatch):
    """A reloaded module with the cache env cleared, and jax's cache config
    restored afterwards."""
    monkeypatch.delenv(cc.ENV_DIR, raising=False)
    monkeypatch.delenv("QD_COMPILE_CACHE", raising=False)
    prev = (jax.config.jax_compilation_cache_dir,
            jax.config.jax_enable_compilation_cache,
            jax.config.jax_persistent_cache_min_compile_time_secs)
    yield importlib.reload(cc)
    jax.config.update("jax_compilation_cache_dir", prev[0])
    jax.config.update("jax_enable_compilation_cache", prev[1])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", prev[2])


def test_cache_opt_out(fresh, monkeypatch, tmp_path):
    monkeypatch.setenv("QD_COMPILE_CACHE", "0")
    monkeypatch.setenv(cc.ENV_DIR, str(tmp_path / "ignored"))
    assert fresh.setup_from_env() is None
    assert not jax.config.jax_enable_compilation_cache
    assert not (tmp_path / "ignored").exists()


def test_cache_honours_env_dir_and_sets_nothing_else(fresh, monkeypatch,
                                                     tmp_path):
    target = str(tmp_path / "xla_cache")
    monkeypatch.setenv(cc.ENV_DIR, target)
    assert fresh.setup_from_env() == target
    assert os.path.isdir(target)
    assert jax.config.jax_compilation_cache_dir == target
    # idempotent second call
    assert fresh.setup_from_env() == target
    # the env directory wins on every backend, the GPU's included
    assert fresh.cache_dir("gpu") == target
    assert fresh.cache_dir("cpu") == target


def test_default_dir_is_fixed_in_checkout(fresh):
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(cc.__file__)))
    d = fresh.default_dir()
    assert d == os.path.join(checkout, ".jax_cache")
    assert fresh.default_dir() == d            # no pid/time/tmp component
    assert fresh.cache_dir("gpu") == d
    with open(os.path.join(checkout, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cpu_backend_cache_off_without_env(fresh):
    assert fresh.cache_dir("cpu") is None
    assert jax.default_backend() == "cpu"
    assert fresh.setup_from_env() is None
