"""The persistent compilation cache directory rule."""
import os

import jax
import pytest

from nrc_hpm.utils import compile_cache


@pytest.fixture
def cache_config():
    """Restore JAX's cache-dir setting after a test changes it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_dir_is_used_and_nothing_set(monkeypatch, tmp_path,
                                         cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    monkeypatch.delenv("NRC_NO_COMPILE_CACHE", raising=False)
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compilation_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "env").exists()


def test_default_dir_is_repo_output(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("NRC_NO_COMPILE_CACHE", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, "output", "xla_cache")
    assert compile_cache.enable_compilation_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert os.path.isdir(want)


def test_disable(monkeypatch):
    monkeypatch.setenv("NRC_NO_COMPILE_CACHE", "1")
    assert compile_cache.enable_compilation_cache() is None
