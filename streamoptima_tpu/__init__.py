"""StreamOptima: a block video codec framework in JAX, run on NVIDIA GPUs.

A ground-up JAX/XLA re-design of the capabilities of
Suyashagarw/StreamOptima (a simplified H.264-style Y-only codec): I/P frames,
full-search + fast motion estimation, half-pel fractional ME, multi-reference,
variable block size with RD mode decision, 2D DCT + power-of-two quantization,
diagonal-scan RLE entropy coding, differential MV coding, per-row rate
control, scene-change intra promotion, two-pass RC, ROI QP maps, and
block/frame-level parallelism via vmap / shard_map over device meshes.
"""

from streamoptima_tpu.config import CodecConfig, parse_bitrate


def __getattr__(name):  # lazy: keep `import streamoptima_tpu` jax-free
    if name == "VideoCodec":
        from streamoptima_tpu.codec import VideoCodec

        return VideoCodec
    raise AttributeError(name)


__all__ = ["CodecConfig", "VideoCodec", "parse_bitrate"]
__version__ = "0.1.0"
