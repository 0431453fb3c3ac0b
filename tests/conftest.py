"""Test env: force the CPU backend with 8 virtual devices so multi-device
sharding paths compile and run without a GPU (SURVEY.md section 4).

The platform is forced through jax.config before the first backend
initialization: an environment variable set here would come too late if
jax was already imported.  Tests that need the card carry the ``gpu``
marker and skip here (see the ``gpu_only`` fixture)."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("MPLBACKEND", "Agg")

try:
    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

import sys
from pathlib import Path

import numpy as np
import pytest

from streamoptima_tpu.runtime import setup_compile_cache

# persistent XLA compile cache (native-engine tests are compile-heavy),
# placed by the shared helper like every other entry point
setup_compile_cache()

REPO = Path(__file__).resolve().parent.parent
REFERENCE = Path("/root/reference")


def reference_available() -> bool:
    return (REFERENCE / "Encoder.py").exists()


@pytest.fixture(scope="session")
def ref_modules():
    """Import the upstream NumPy reference (oracle for golden generation)."""
    if not reference_available():
        pytest.skip("reference codebase not available")
    shim = str(Path(__file__).parent / "ref_shims")
    for p in (shim, str(REFERENCE)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import Encoder  # noqa: F401
    import decoder  # noqa: F401

    return Encoder, decoder


@pytest.fixture
def gpu_only():
    """Skip unless JAX's default backend is a GPU (decided at run time, never
    while the module is imported, so every xdist worker collects the same
    tests)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card via chip_smoke.py")


def synthetic_clip(h=64, w=64, frames=3, seed=42, motion=1):
    """Deterministic test clip: a translating random texture (has real motion
    structure so ME/intra paths are exercised nontrivially)."""
    rng = np.random.default_rng(seed)
    pad = motion * frames + 8
    base = rng.integers(0, 256, size=(h + pad, w + pad)).astype(np.uint8)
    return np.stack([base[i * motion : i * motion + h, i * motion : i * motion + w].copy() for i in range(frames)])


def smooth_clip(h=64, w=64, frames=3, seed=7, motion=2):
    """Smoother clip (low-pass filtered) - exercises zero runs in RLE."""
    rng = np.random.default_rng(seed)
    pad = motion * frames + 16
    base = rng.integers(0, 256, size=(h + pad, w + pad)).astype(np.float64)
    k = np.ones(9) / 9.0
    for ax in (0, 1):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), ax, base)
    base = base.astype(np.uint8)
    return np.stack([base[i * motion : i * motion + h, i * motion : i * motion + w].copy() for i in range(frames)])
