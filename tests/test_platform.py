"""Process setup: where the persistent compile cache lives."""

import os

import jax
import pytest

from guacamole import platform


def test_cache_dir_is_the_variable_exactly(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
    assert platform.compile_cache_dir() == str(tmp_path / "x")


def test_cache_dir_defaults_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert platform.compile_cache_dir() == os.path.join(repo, ".jax_cache")
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


@pytest.mark.parametrize("set_variable", [True, False])
def test_configure_platform_applies_the_cache_dir(
    monkeypatch, tmp_path, set_variable
):
    """configure_platform() hands JAX that directory and creates it."""
    target = str(tmp_path / "cache")
    if set_variable:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", target)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(platform, "DEFAULT_CACHE_DIR", target)
    before = jax.config.jax_compilation_cache_dir
    try:
        platform.configure_platform()
        assert jax.config.jax_compilation_cache_dir == target
        assert os.path.isdir(target)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
