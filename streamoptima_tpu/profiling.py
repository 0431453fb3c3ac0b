"""Timing + tracing instrumentation.

Device twin of the reference's manual timing harness (per-ParallelMode
intra/inter second lists, Encoder.py:62-69, :494-498, :1265-1267, :1777-1782,
printed at :1897) and its only observability surface.  Here:

- ``time_steps``: per-frame-kind device latencies, properly synchronized
  (the async dispatch model makes in-loop wall timestamps meaningless, so
  this re-runs jitted steps with block_until_ready instead of polluting the
  production encode loop with syncs).
- ``trace``: jax.profiler trace context (XProf/TensorBoard format) for
  per-kernel breakdowns.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np


def time_steps(cfg, y_frames, warmup: int = 1, iters: int = 8):
    """Measure per-frame encode-step latencies for each frame kind.

    Returns {"intra_s": [...], "inter_s": [...], "decode_inter_s": [...],
    "decode_intra_s": [...]} — each a list of ``iters`` seconds, the
    reference's self.intraN/interN analog (Encoder.py:62-69).
    """
    import jax
    import jax.numpy as jnp

    from streamoptima_tpu.jax_engine import JaxCodec

    codec = JaxCodec(cfg, y_frames)
    n = min(len(codec.y), 2)
    cur = codec._y_dev[n - 1]
    refs = codec._y_dev[:1]

    out = {}

    def run(name, fn):
        for _ in range(warmup):
            jax.block_until_ready(fn())
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            times.append(time.perf_counter() - t0)
        out[name] = times

    run("intra_s", lambda: codec._intra_step_j(cur, codec.row_qps, cur))
    run("inter_s", lambda: codec._inter_step_j(cur, refs, codec.row_qps, cur, nref=1, initial_refs=False))
    enc = codec._inter_step_j(cur, refs, codec.row_qps, cur, nref=1, initial_refs=False)
    run(
        "decode_inter_s",
        lambda: codec._dec_inter_j(
            refs, enc["mv"], enc["split"], enc["sub_mv"], enc["qtc_full"], enc["qtc_quads"],
            codec.row_qps, nref=1, initial_refs=False,
        ),
    )
    enc_i = codec._intra_step_j(cur, codec.row_qps, cur)
    mv_i = enc_i["mv"]
    smv_i = enc_i["sub_mv"][:, :, 0] if enc_i["sub_mv"].ndim == 3 else enc_i["sub_mv"]
    run(
        "decode_intra_s",
        lambda: codec._dec_intra_j(mv_i, enc_i["split"], smv_i, enc_i["qtc_full"], enc_i["qtc_quads"], codec.row_qps),
    )
    return out


def report(times: dict) -> str:
    """Human-readable table (the reference's end-of-encode print, Encoder.py:1897)."""
    lines = []
    for k, v in times.items():
        v = np.asarray(v)
        lines.append(f"{k:>16}: mean {v.mean()*1e3:8.2f} ms   min {v.min()*1e3:8.2f} ms   max {v.max()*1e3:8.2f} ms")
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context; view with XProf/TensorBoard."""
    import jax

    with jax.profiler.trace(str(log_dir)):
        yield
