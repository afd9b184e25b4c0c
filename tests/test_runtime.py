"""Process set-up shared by the entry points (asm_tpu.runtime)."""

import jax
import pytest

from asm_tpu import runtime


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing is
    changed; otherwise the fixed <repo>/.jax_cache path is used."""
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert runtime.use_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert runtime.use_compile_cache() == runtime.CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == runtime.CACHE_DIR
        assert runtime.CACHE_DIR.endswith(".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_device_accepts_explicit_cpu_rehearsal(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    info = runtime.require_device()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}
    assert runtime.describe(info).startswith("device: platform=cpu")


def test_require_device_refuses_cpu_without_opt_in(monkeypatch):
    """A measurement that finds no GPU fails instead of falling back."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_device()


def test_gpu_name_power_reports_missing_tool(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    assert runtime.gpu_name_power().startswith("nvidia-smi unavailable")
