"""Option validation for the retired kernel knobs, and the process set-up
helpers shared by the entry points (streamoptima_tpu/runtime.py)."""
import jax
import pytest

from streamoptima_tpu import runtime
from streamoptima_tpu.config import CodecConfig

_BASE = dict(height=64, width=64, frames=2)


@pytest.mark.parametrize("field,value", [
    ("me_search", "pallas"),
    ("me_search", "bogus"),
    ("fast_me_fetch", "pallas"),
    ("fast_me_fetch", "dma"),
])
def test_removed_option_values_raise(field, value):
    with pytest.raises(ValueError, match=field):
        CodecConfig(**_BASE, **{field: value})


@pytest.mark.parametrize("field,value", [
    ("winner_fetch", "fetch"),
    ("winner_fetch", "auto"),
    ("fast_me_pass", "kernel"),
    ("fast_me_pass", "auto"),
])
def test_removed_option_fields_raise(field, value):
    with pytest.raises(TypeError, match=field):
        CodecConfig(**_BASE, **{field: value})


@pytest.mark.parametrize("field,value", [
    ("me_search", "auto"), ("me_search", "materialized"), ("me_search", "fused"),
    ("fast_me_fetch", "auto"), ("fast_me_fetch", "xla"), ("fast_me_fetch", "slice"),
])
def test_kept_option_values_accepted(field, value):
    assert getattr(CodecConfig(**_BASE, **{field: value}), field) == value


def test_compile_cache_dir_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv(runtime.ENV_CACHE, raising=False)
    key = runtime.host_cpu_key()
    assert runtime.compile_cache_dir() == runtime.CHECKOUT / ".jax_cache" / key
    assert (runtime.CHECKOUT / "streamoptima_tpu" / "runtime.py").exists()


def test_host_cpu_key_is_stable_and_names_the_cpu():
    key = runtime.host_cpu_key()
    assert key == runtime.host_cpu_key()
    assert key.startswith("cpu_") and "/" not in key


def test_compile_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv(runtime.ENV_CACHE, str(tmp_path))
    # the environment names THE directory: no CPU-key subdirectory
    assert runtime.compile_cache_dir() == tmp_path


def test_setup_compile_cache_sets_config_only_without_environment(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv(runtime.ENV_CACHE, str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", "/nonexistent-sentinel")
        assert runtime.setup_compile_cache() == tmp_path
        assert jax.config.jax_compilation_cache_dir == "/nonexistent-sentinel"
        monkeypatch.delenv(runtime.ENV_CACHE)
        d = runtime.setup_compile_cache()
        assert jax.config.jax_compilation_cache_dir == str(d)
        assert d == runtime.CHECKOUT / ".jax_cache" / runtime.host_cpu_key()
        assert jax.config.jax_persistent_cache_min_compile_time_secs == runtime.MIN_COMPILE_SECS
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_require_gpu_refuses_the_cpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        runtime.require_gpu()
