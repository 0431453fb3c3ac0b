"""Benchmark sweep: encode/decode throughput across configurations.

Beyond bench.py's single headline number, this measures the feature matrix
on the attached GPU and writes ``benchmarks/sweep_results.json`` (not
committed; every row carries the device it ran on):

- 720p IPPP full search (the headline config), plus sr=16
- 720p with VBS + FME (flagship feature set, half-pel search range doubled)
- 1080p / 4K IPPP full search (scaling headroom)
- CIF at the reference's ACTUAL defaults (main.py:19-43: qp=5, gop=21, sr=16,
  fast-ME+VBS+FME) on the single-chip engine — directly comparable to the
  measured reference baseline (round-1 ADVICE item 1)
- 720p decode throughput, input-chained (no identical-args pipelining)
- multi-chip GOP/tile mesh scaling (if >1 device)

Each entry reports best-of-2 and mean-of-2 fps.

Run:  python benchmarks/sweep.py   (GPU only; exits non-zero elsewhere)
      python benchmarks/sweep.py only=fast_me   re-runs matching rows only,
      merging into the existing sweep_results.json (other rows untouched)
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from streamoptima_tpu.runtime import require_gpu, setup_compile_cache

    setup_compile_cache()
    device = require_gpu()

    from streamoptima_tpu.config import CodecConfig
    from streamoptima_tpu.jax_engine import JaxCodec
    from streamoptima_tpu.parallel import ShardedCodec, make_mesh
    from streamoptima_tpu.utils import synthetic_clip

    only = next((a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("only=")), None)
    out_path = REPO / "benchmarks" / "sweep_results.json"
    results = {}
    if only and out_path.exists():
        results = json.loads(out_path.read_text())  # merge partial re-runs
        stored = results.get("device")
        current = str(jax.devices()[0])
        if stored is not None and stored != current:
            # refusing beats silently mixing two devices' rows in one file
            raise SystemExit(
                f"only= merge refused: stored rows were measured on {stored!r} "
                f"but this run is on {current!r}; delete {out_path} or re-run "
                "the full sweep on the current backend"
            )
    results.update({"device": str(jax.devices()[0]), "device_kind": device["kind"],
                    "n_devices": device["count"]})

    def _skip(name):
        if only is not None and only not in name:
            print(f"[skip] {name}", flush=True)
            return True
        return False

    def timed(fn, frames_n):
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            pkg = fn()
            times.append(time.perf_counter() - t0)
        return pkg, frames_n / min(times), frames_n / (sum(times) / len(times))

    def gop_encode_fps(name, cfg, frames_n=32):
        if _skip(name):
            return
        clip = synthetic_clip(cfg.height, cfg.width, frames_n)
        import dataclasses

        cfg = dataclasses.replace(cfg, frames=frames_n)
        mesh = make_mesh(cfg, devices=jax.devices()[:1])
        codec = ShardedCodec(cfg, mesh, clip)
        warm = jnp.asarray(clip[None, : cfg.intra_dur])
        jax.block_until_ready(codec._encode_j(warm, codec._row_qps, codec._roi))
        codec.encode(fetch="metrics")  # one-time clip upload to the device
        pkg, fps, mean_fps = timed(lambda: codec.encode(fetch="metrics"), frames_n)
        results[name] = {
            "fps": round(fps, 2),
            "mean_fps": round(mean_fps, 2),
            "mean_psnr_db": round(float(np.mean(pkg["PSNR per frame"])), 2),
            "config": f"{cfg.width}x{cfg.height} sr={cfg.search_range} qp={cfg.qp} vbs={cfg.vbs_enable} fme={cfg.fme_enable} gop={cfg.intra_dur}",
        }
        print(name, results[name], flush=True)

    base = dict(frames=32, block_size=16, qp=4, intra_dur=8, lam=0.015)
    gop_encode_fps("720p_full_search", CodecConfig(height=720, width=1280, search_range=8, **base))
    gop_encode_fps("720p_full_search_sr16", CodecConfig(height=720, width=1280, search_range=16, **base))
    gop_encode_fps("720p_vbs_fme", CodecConfig(height=720, width=1280, search_range=8,
                                               vbs_enable=True, fme_enable=True, **base))
    gop_encode_fps("1080p_full_search", CodecConfig(height=1088, width=1920, search_range=8, **base))
    gop_encode_fps("1080p_vbs_fme", CodecConfig(height=1088, width=1920, search_range=8,
                                                vbs_enable=True, fme_enable=True, **base))
    gop_encode_fps("4k_full_search", CodecConfig(height=2160, width=3840, search_range=8, **base), frames_n=8)
    gop_encode_fps("4k_vbs_fme", CodecConfig(height=2160, width=3840, search_range=8,
                                             vbs_enable=True, fme_enable=True, **base), frames_n=8)

    # benchmark-matrix completeness rows (round-2 VERDICT item 7): fast-ME
    # at 720p (the CIF-only fast-ME story), multi-ref, and RC-active /
    # two-pass encode throughput (RC was tested but never measured)
    gop_encode_fps("720p_fast_me", CodecConfig(height=720, width=1280, search_range=16,
                                               fast_me=True, **base))
    gop_encode_fps("720p_fast_me_vbs_fme", CodecConfig(height=720, width=1280, search_range=16,
                                                       fast_me=True, vbs_enable=True,
                                                       fme_enable=True, **base))
    gop_encode_fps("720p_nref4", CodecConfig(height=720, width=1280, search_range=8,
                                             n_ref_frames=4, **base))
    # fast-ME at every supported size (round-3 VERDICT item: the reference's
    # fast-ME is its DEFAULT config, main.py:29 — it deserves the full matrix)
    gop_encode_fps("1080p_fast_me", CodecConfig(height=1088, width=1920, search_range=16,
                                                fast_me=True, **base))
    gop_encode_fps("1080p_fast_me_vbs_fme", CodecConfig(height=1088, width=1920, search_range=16,
                                                        fast_me=True, vbs_enable=True,
                                                        fme_enable=True, **base))
    gop_encode_fps("4k_fast_me", CodecConfig(height=2160, width=3840, search_range=16,
                                             fast_me=True, **base), frames_n=8)
    gop_encode_fps("4k_fast_me_vbs_fme", CodecConfig(height=2160, width=3840, search_range=16,
                                                     fast_me=True, vbs_enable=True,
                                                     fme_enable=True, **base), frames_n=8)
    # per-row budget at 8 mbps/30 fps/45 rows ~ 5.9k bits: mid-table pick
    rc_tables = [[2e5, 1.2e5, 8e4, 5e4, 3e4, 2e4, 1.2e4, 8e3, 5e3, 3e3, 2e3, 1.2e3]] * 2
    gop_encode_fps("720p_rc_row_qp", CodecConfig(height=720, width=1280, search_range=8,
                                                 rc_flag=1, target_br="8 mbps", frame_rate=30,
                                                 qp_rate_tables=rc_tables, **base))

    def two_pass_fps(name, cfg, frames_n=16):
        if _skip(name):
            return
        import dataclasses

        cfg = dataclasses.replace(cfg, frames=frames_n)
        clip = synthetic_clip(cfg.height, cfg.width, frames_n)
        codec = ShardedCodec(cfg, make_mesh(cfg, devices=jax.devices()[:1]), clip)
        codec.encode(fetch="metrics")  # warm
        pkg, fps, mean_fps = timed(lambda: codec.encode(fetch="metrics"), frames_n)
        results[name] = {"fps": round(fps, 2), "mean_fps": round(mean_fps, 2),
                         "mean_psnr_db": round(float(np.mean(pkg["PSNR per frame"])), 2),
                         "config": f"{cfg.width}x{cfg.height} two_pass rc_flag={cfg.rc_flag}"}
        print(name, results[name], flush=True)

    two_pass_fps("720p_two_pass", CodecConfig(height=720, width=1280, search_range=8,
                                              rc_flag=1, target_br="8 mbps", frame_rate=30,
                                              qp_rate_tables=rc_tables, two_pass=True, **base))

    # the reference's ACTUAL default config (main.py:19-43): qp=5, gop=21,
    # sr=16, fast-ME + VBS + FME, 21 CIF frames — the MVP chain runs as the
    # Jacobi fixpoint inside the GOP scan (bit-identical to the sequential
    # chain, test_parallel.py), so the whole clip is one device program
    if not _skip("cif_reference_defaults"):
        cfg_ref = CodecConfig(height=288, width=352, frames=21, block_size=16, search_range=16,
                              qp=5, intra_dur=21, lam=0.015, n_ref_frames=1,
                              vbs_enable=True, fme_enable=True, fast_me=True)
        clip_ref = synthetic_clip(288, 352, 21)
        codec_ref = ShardedCodec(cfg_ref, make_mesh(cfg_ref, devices=jax.devices()[:1]), clip_ref)
        codec_ref.encode(fetch="metrics")  # warm compile + clip upload
        pkg, fps, mean_fps = timed(lambda: codec_ref.encode(fetch="metrics"), 21)
        results["cif_reference_defaults"] = {
            "fps": round(fps, 2),
            "mean_fps": round(mean_fps, 2),
            "mean_psnr_db": round(float(np.mean(pkg["PSNR per frame"])), 2),
            "config": "352x288 sr=16 qp=5 fast_me+vbs+fme gop=21 (reference main.py defaults)",
        }
        print("cif_reference_defaults", results["cif_reference_defaults"], flush=True)

    # decode throughput: jitted decode steps over an encoded frame's real
    # MVs/residuals.  Each decode chains on the previous output so XLA
    # cannot pipeline identical dispatches.  One unrecorded warmup pass,
    # then >= 5 recorded passes; warmup_ms is recorded separately so the
    # excluded cost stays visible.
    def decode_bench(name, vbs, fme, h=720, w=1280, passes=5):
        if _skip(name):
            return
        cfg = CodecConfig(height=h, width=w, search_range=8,
                          vbs_enable=vbs, fme_enable=fme, **base)
        clip = synthetic_clip(h, w, 8)
        codec = JaxCodec(cfg, clip)
        cur = codec._y_dev[1]
        refs = codec._y_dev[:1]
        enc = codec._inter_step_j(cur, refs, codec.row_qps, cur, nref=1, initial_refs=False)

        def dec(r):
            return codec._dec_inter_j(
                r, enc["mv"], enc["split"], enc["sub_mv"], enc["qtc_full"],
                enc["qtc_quads"], codec.row_qps, nref=1, initial_refs=False,
            )

        jax.block_until_ready(dec(refs))

        def one_pass():
            t0 = time.perf_counter()
            out = refs
            for _ in range(32):
                out = dec(out[None] if out.ndim == 2 else out)[None]
            jax.block_until_ready(out)
            return (time.perf_counter() - t0) / 32

        warm = one_pass()  # excluded from the record (first-pass warmup)
        els = [one_pass() for _ in range(passes)]
        el, el_mean = min(els), sum(els) / len(els)
        results[name] = {"fps": round(1.0 / el, 1), "mean_fps": round(1.0 / el_mean, 1),
                         "ms_per_frame": round(el * 1e3, 2),
                         "warmup_ms": round(warm * 1e3, 2),
                         "pass_ms": [round(e * 1e3, 2) for e in els]}
        print(name, results[name], flush=True)

    decode_bench("720p_decode", False, False)
    decode_bench("720p_decode_vbs_fme", True, True)
    decode_bench("1080p_decode", False, False, h=1088, w=1920)
    decode_bench("1080p_decode_vbs_fme", True, True, h=1088, w=1920)
    decode_bench("4k_decode", False, False, h=2160, w=3840)
    decode_bench("4k_decode_vbs_fme", True, True, h=2160, w=3840)

    # ---- bytes-to-bytes pipeline (the reference's actual unit of work,
    # main.py:17-73): YUV in -> encode -> binary container write -> read ->
    # decode -> YUV out, wall-clock end to end, with the phases broken out.
    def pipeline_bench(name, h, w, frames_n=16):
        if _skip(name):
            return
        import dataclasses
        import tempfile

        from streamoptima_tpu.codec import VideoCodec

        cfg = dataclasses.replace(
            CodecConfig(height=h, width=w, search_range=8, vbs_enable=True,
                        fme_enable=True, **base), frames=frames_n)
        clip = synthetic_clip(h, w, frames_n)
        with tempfile.TemporaryDirectory() as td:
            yuv_in = Path(td) / "in.yuv"
            clip.tofile(yuv_in)
            bit_p = Path(td) / "clip.sob"
            yuv_out = Path(td) / "out.yuv"

            def run():
                t0 = time.perf_counter()
                y = np.fromfile(yuv_in, dtype=np.uint8).reshape(frames_n, h, w)
                enc = VideoCodec(cfg, y)
                enc.encode(package=False, compute_ssim=False)
                t1 = time.perf_counter()
                enc.transmit_bitstream_binary(bit_p)
                t2 = time.perf_counter()
                dec_codec = VideoCodec(dataclasses.replace(cfg))
                dec = dec_codec.decode_bitstream_binary(bit_p)
                t3 = time.perf_counter()
                np.stack([np.asarray(f, dtype=np.uint8) for f in dec]).tofile(yuv_out)
                t4 = time.perf_counter()
                return t1 - t0, t2 - t1, t3 - t2, t4 - t3

            run()  # warm compiles
            walls = [run() for _ in range(2)]
            totals = [sum(wl) for wl in walls]
            best = walls[int(np.argmin(totals))]
            results[name] = {
                "fps": round(frames_n / min(totals), 2),
                "mean_fps": round(frames_n / (sum(totals) / len(totals)), 2),
                "ms_per_frame": round(1e3 * min(totals) / frames_n, 1),
                "phases_ms_per_frame": {
                    "encode": round(1e3 * best[0] / frames_n, 1),
                    "container_write": round(1e3 * best[1] / frames_n, 1),
                    "read_decode": round(1e3 * best[2] / frames_n, 1),
                    "yuv_out": round(1e3 * best[3] / frames_n, 1),
                },
                "container_bytes_pf": int(bit_p.stat().st_size // frames_n),
                "config": f"{w}x{h} sr=8 vbs+fme gop=8, SOTPB1 container",
            }
            print(name, results[name], flush=True)

    pipeline_bench("720p_pipeline", 720, 1280)
    pipeline_bench("4k_pipeline", 2160, 3840, frames_n=8)

    if len(jax.devices()) > 1:
        import dataclasses

        cfg = dataclasses.replace(CodecConfig(height=720, width=1280, search_range=8, **base), frames=32)
        clipm = synthetic_clip(720, 1280, 32)
        mesh = make_mesh(cfg)
        codecm = ShardedCodec(cfg, mesh, clipm)
        t0 = time.perf_counter()
        codecm.encode(fetch="metrics")
        el = time.perf_counter() - t0
        results["720p_mesh_all_devices"] = {
            "fps": round(32 / el, 2),
            "mesh": f"data={mesh.devices.shape[0]} tile={mesh.devices.shape[1]}",
        }
        print("720p_mesh_all_devices", results["720p_mesh_all_devices"], flush=True)

    out_path = REPO / "benchmarks" / "sweep_results.json"
    out_path.write_text(json.dumps(results, indent=2) + "\n")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
