"""The persistent compilation cache sits at one fixed place."""

import jax

from isaac_aligner_tpu.utils import compile_cache


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets nothing."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_default_is_checkout_cache(monkeypatch):
    """Unset, the cache is `.jax_cache` at the checkout root, which
    .gitignore lists."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = compile_cache.CHECKOUT_CACHE_DIR.parent
    assert compile_cache.enable_compile_cache() == str(root / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", str(root / ".jax_cache"))]
    assert (root / "isaac_aligner_tpu").is_dir()
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()
