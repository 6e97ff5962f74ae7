"""The shared persistent compile-cache helper (fora/utils/compile_cache.py)."""

from pathlib import Path

import jax

import fora
from fora.utils import compile_cache


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_set_means_no_cache_dir_from_code(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable_compile_cache() is None
    assert calls == []
    assert not (tmp_path / "env").exists()   # JAX itself owns that dir


def test_env_var_unset_uses_fixed_dir_beside_package(monkeypatch, tmp_path):
    # the default resolves from the package file, not the working dir
    assert compile_cache.DEFAULT_DIR == \
        Path(fora.__file__).resolve().parent.parent / ".jax_cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(compile_cache, "DEFAULT_DIR", tmp_path / "cache")
    monkeypatch.chdir(tmp_path)
    calls = _record_updates(monkeypatch)
    assert compile_cache.enable_compile_cache() == tmp_path / "cache"
    assert calls == [("jax_compilation_cache_dir", str(tmp_path / "cache"))]
    assert (tmp_path / "cache").is_dir()
