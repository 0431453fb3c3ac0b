"""Headline benchmark: 720p YUV encode frames/sec on one GPU.

Config = BASELINE.json config #2 (IPPP, full-search ME sr=+-8, block 16) on a
synthetic 1280x720 clip.  ``vs_baseline`` is the speedup over the NumPy
reference encoder, whose throughput was measured on this host by
``benchmarks/measure_reference.py`` (recorded in
benchmarks/reference_baseline.json; the reference cannot intra-code beyond
CIF — see that file's docstring — so its 720p number is its P-frame rate,
which flatters it).

Prints ONE json line:
  {"metric": "720p_encode_fps", "value": N, "unit": "frames/s", "vs_baseline": N}

Runs on the GPU only: on any other backend it exits non-zero (a CPU timing
is not a device number).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

from streamoptima_tpu.config import CodecConfig  # noqa: E402
from streamoptima_tpu.jax_engine import JaxCodec  # noqa: E402
from streamoptima_tpu.utils import synthetic_clip  # noqa: E402

H, W, FRAMES = 720, 1280, 32
BS, SR, QP, INTRA_DUR = 16, 8, 4, 8


def main():
    import jax

    from streamoptima_tpu.parallel import ShardedCodec, make_mesh
    from streamoptima_tpu.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    device = require_gpu()

    clip = synthetic_clip(H, W, FRAMES)
    cfg = CodecConfig(height=H, width=W, frames=FRAMES, block_size=BS, search_range=SR,
                      qp=QP, intra_dur=INTRA_DUR, lam=0.015)
    # single-chip GOP-scan encoder: the whole GOP (intra + lax.scan over inter
    # frames) is ONE device program, so per-frame dispatch overhead vanishes
    mesh = make_mesh(cfg, devices=jax.devices()[:1])
    codec = ShardedCodec(cfg, mesh, clip)

    # warmup: compile the GOP program, then one full encode (uploads the clip
    # to HBM once — the reference's frames likewise sit in RAM before its
    # timed per-frame flows)
    warm = jax.numpy.asarray(clip[None, :INTRA_DUR])
    jax.block_until_ready(codec._encode_j(warm, codec._row_qps, codec._roi))
    codec.encode(fetch="metrics")

    # fetch="metrics": reconstructions/coefficients stay on the device,
    # exactly as the reference's stay in process RAM — only sizes/PSNR are
    # copied to the host.
    # (The reference's timed scope is likewise its per-frame flows, not
    # serialization or disk writes.)  Both best-of-N and mean-of-N are
    # reported.
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        pkg = codec.encode(fetch="metrics")
        times.append(time.perf_counter() - t0)
    elapsed = min(times)
    mean_elapsed = sum(times) / len(times)
    fps = FRAMES / elapsed

    base_path = REPO / "benchmarks" / "reference_baseline.json"
    vs = None
    if base_path.exists():
        base = json.loads(base_path.read_text())
        ref_fps = base["p720_inter"]["fps"]
        vs = fps / ref_fps
    psnr = float(np.mean(pkg["PSNR per frame"]))

    # decode rider: chained inter decode through the XLA decode step (the
    # production JaxCodec.decode dispatch), one sync at the end
    dcodec = JaxCodec(cfg, clip[:8])
    enc1 = dcodec._inter_step_j(dcodec._y_dev[1], dcodec._y_dev[:1], dcodec.row_qps,
                                dcodec._y_dev[1], nref=1, initial_refs=False)

    def dec(r):
        return dcodec._dec_inter_j(
            r, enc1["mv"], enc1["split"], enc1["sub_mv"], enc1["qtc_full"],
            enc1["qtc_quads"], dcodec.row_qps, nref=1, initial_refs=False)

    out = dcodec._y_dev[:1]
    jax.block_until_ready(dec(out))
    dts = []
    # best-of-3 makes the recorded number robust to one stall
    for _ in range(3):
        t0 = time.perf_counter()
        out = dcodec._y_dev[:1]
        for _ in range(FRAMES):
            out = dec(out)[None]
        jax.block_until_ready(out)
        dts.append((time.perf_counter() - t0) / FRAMES)
    decode_fps = 1.0 / min(dts)

    print(
        json.dumps(
            {
                "metric": "720p_encode_fps",
                "value": round(fps, 3),
                "unit": "frames/s",
                "vs_baseline": round(vs, 1) if vs is not None else None,
                "detail": {
                    "device": device["platform"],
                    "device_kind": device["kind"],
                    "device_count": device["count"],
                    "frames": FRAMES,
                    "elapsed_s": round(elapsed, 3),
                    "timing": "best of 3 passes",
                    "mean_fps": round(FRAMES / mean_elapsed, 3),
                    "pass_times_s": [round(t, 3) for t in times],
                    "mean_psnr_db": round(psnr, 2),
                    "decode_fps": round(decode_fps, 1),
                    "decode_path": "xla-gather",
                    "config": f"IPPP bs={BS} sr={SR} qp={QP} gop={INTRA_DUR}",
                },
            }
        )
    )


if __name__ == "__main__":
    main()
