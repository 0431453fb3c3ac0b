"""Process set-up shared by the entry points (CLI, benchmarks, chip smoke,
test suite).

Two decisions live here so that every entry point makes them the same way:

- where JAX's persistent compilation cache goes: ``$JAX_COMPILATION_CACHE_DIR``
  when it is set (JAX reads it itself and no other directory is set in
  code), otherwise ``.jax_cache/<host CPU key>/`` inside the checkout
  (listed in ``.gitignore``).  The key separates hosts by CPU feature
  flags: XLA:CPU programs (the test suite, chip_smoke.py's CPU-backend
  phase) are compiled for the host's instruction set, and loading another
  host's entries warns and can fault;
- which device a measurement runs on: ``require_gpu`` refuses to continue on
  any other backend, so a missing card fails loudly instead of timing XLA's
  CPU backend.
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
ENV_CACHE = "JAX_COMPILATION_CACHE_DIR"
# programs that compiled faster than this are not worth a cache entry
MIN_COMPILE_SECS = 0.5


def host_cpu_key() -> str:
    """``cpu_<hash of the CPU feature flags>`` (``cpu_generic`` where the
    flags cannot be read)."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next(line for line in f if line.startswith("flags"))
    except (OSError, StopIteration):
        return "cpu_generic"
    return "cpu_" + hashlib.md5(flags.encode()).hexdigest()[:8]


def compile_cache_dir() -> Path:
    """The compile-cache directory: ``$JAX_COMPILATION_CACHE_DIR`` if set,
    else ``<checkout>/.jax_cache/<host_cpu_key()>``."""
    env = os.environ.get(ENV_CACHE)
    if env:
        return Path(env)
    return CHECKOUT / ".jax_cache" / host_cpu_key()


def setup_compile_cache() -> Path:
    """Point JAX's persistent compilation cache at compile_cache_dir() and
    cache every program that took at least MIN_COMPILE_SECS to compile.
    Returns the directory."""
    import jax

    d = compile_cache_dir()
    if not os.environ.get(ENV_CACHE):
        jax.config.update("jax_compilation_cache_dir", str(d))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", MIN_COMPILE_SECS)
    return d


def require_gpu() -> dict:
    """The default backend's devices as {"platform", "kind", "count"};
    raises RuntimeError unless the backend is a GPU."""
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {backend!r} "
            f"({[str(d) for d in jax.devices()]}); this measurement runs on the card only"
        )
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}
