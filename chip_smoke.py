"""Smoke test of the codec's main path on one NVIDIA GPU, at real size.

    python chip_smoke.py                 # phases 0-6 on one card
    python chip_smoke.py --four          # phase 0 + the 4-card mesh phase only
    python chip_smoke.py --trace DIR     # also trace warm re-runs of phases 1-3
                                         # (DIR/trace_stages.json: the reduction)

One process drives the card.  Each phase prints one line with its result,
its wall time and its compile time; any failed check raises, so the script
exits non-zero and prints no result line.  The last line of standard output
is exactly {"ok": true, "device": {"platform", "kind", "count"}} as JAX
reports the devices.  Without a GPU it stops at phase 0 and does no work on
the CPU.

Phases (one card):
  0  device check: devices, nvidia-smi name and power limit, native library
  1  library path, 1280x720 x32: VideoCodec encode -> SOTPB1 container ->
     decode in a fresh VideoCodec -> save; decode == encoder reconstruction
  2  fast-ME path, 1920x1088 x16 (rowscan chain, auto fetch = slice): same
  3  GOP-scan engine on a 1x1 mesh (what bench.py times), 720p x32, at
     bench.py's IPPP sr=8 config and at phase 1's VBS+FME config: package
     == the per-frame engine's bitwise, sharded decode closes the loop
  4a the same program on the CPU backend in this process: phase 1's first
     3 frames bitwise equal to the GPU's
  4b the compat engine (host NumPy, bit-exact with the upstream reference)
     at CIF: the agreement rules of tests/test_jax_engine.py
  5  numerics probes vs NumPy, tolerance zero: the exact int32 transform at
     the +-255 residual extremes, the bf16 one-hot window gather on 1080p
     FME parity planes; how XLA lowers the int32 dot_general
  6  the CLI, in-process (a second process could not get card memory)

The sizes are the defaults above; the functions take smaller ones so the
tests can run every phase at 64x64 on the CPU (tests/test_chip_smoke.py).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from __graft_entry__ import _assert_packages_bitwise  # noqa: E402
from streamoptima_tpu import native  # noqa: E402
from streamoptima_tpu.codec import VideoCodec  # noqa: E402
from streamoptima_tpu.compat_engine import CompatCodec  # noqa: E402
from streamoptima_tpu.config import CodecConfig  # noqa: E402
from streamoptima_tpu.core import fastme as FM  # noqa: E402
from streamoptima_tpu.core import transform as T  # noqa: E402
from streamoptima_tpu.core.quant import quantize, rescale  # noqa: E402
from streamoptima_tpu.jax_engine import JaxCodec  # noqa: E402
from streamoptima_tpu.parallel import ShardedCodec, make_mesh  # noqa: E402
from streamoptima_tpu.runtime import require_gpu, setup_compile_cache  # noqa: E402
from streamoptima_tpu.utils import synthetic_clip  # noqa: E402

# scratch files (containers, YUV, CLI bitstreams) stay inside the checkout
OUT_DIR = REPO / "build" / "chip_smoke"


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its own
    monitoring events; phases read the difference across their run."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **_):
        if name in self.EVENTS:
            self.total += secs

    def run(self, name, fn, *args, **kw):
        """Run one phase, print its line (result, wall, compile) and return
        its result dict.  Exceptions propagate: a failed phase ends the
        script."""
        c0, t0 = self.total, time.perf_counter()
        res = fn(*args, **kw)
        wall = time.perf_counter() - t0
        shown = {k: v for k, v in res.items() if not k.startswith("_")}
        print(f"[{name}] ok wall_s={wall:.2f} compile_s={self.total - c0:.2f} "
              + json.dumps(shown, default=str), flush=True)
        return res


# ------------------------------------------------------------------ phase 0
def device_check() -> dict:
    """Devices as JAX reports them, the card's name and power limit, and the
    native entropy library.  Raises unless the default backend is a GPU."""
    dev = require_gpu()
    print("jax.devices():", jax.devices(), flush=True)
    print("device_kind:", [d.device_kind for d in jax.devices()], flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    if not native.available():
        raise RuntimeError("the native entropy library did not build (g++ missing or failed)")
    return dict(dev, nvidia_smi=smi, native=True)


# ------------------------------------------------------------- phases 1, 2
def library_cfg(h=720, w=1280, frames=32) -> CodecConfig:
    """Phase 1's configuration: full search sr=8, VBS+FME, GOP 8."""
    return CodecConfig(height=h, width=w, frames=frames, search_range=8, qp=4, intra_dur=8,
                       vbs_enable=True, fme_enable=True, lam=0.015)


def fast_me_cfg(h=1088, w=1920, frames=16) -> CodecConfig:
    """Phase 2's configuration: fast ME (rowscan chain) sr=16, VBS+FME, GOP 8."""
    return CodecConfig(height=h, width=w, frames=frames, search_range=16, qp=4, intra_dur=8,
                       vbs_enable=True, fme_enable=True, lam=0.015, fast_me=True)


def closed_loop(cfg: CodecConfig, clip, tag: str, out_dir: Path = OUT_DIR) -> dict:
    """encode -> binary container -> decode in a fresh VideoCodec -> save;
    the decode must equal the encoder's reconstructions bit for bit.  The
    fps are one cold pass each (compile included), not a benchmark."""
    out_dir.mkdir(parents=True, exist_ok=True)
    vc = VideoCodec(cfg, clip)
    t0 = time.perf_counter()
    pkg = vc.encode()
    t_enc = time.perf_counter() - t0
    container = out_dir / f"{tag}.sob"
    vc.transmit_bitstream_binary(container)
    t0 = time.perf_counter()
    dvc = VideoCodec(dataclasses.replace(cfg))
    dec = dvc.decode_bitstream_binary(container)
    t_dec = time.perf_counter() - t0
    dvc.save_decoded_frames(out_dir / f"{tag}_decoded.yuv")
    recon = pkg["reconstructed frames"]
    if dec.shape != recon.shape or not np.array_equal(dec, recon):
        raise AssertionError(f"{tag}: decode != encoder reconstruction")
    return {
        "size": f"{cfg.width}x{cfg.height}x{cfg.frames}",
        "decode_bitwise_equal": True,
        "encode_fps_cold_pass": cfg.frames / t_enc,
        "decode_fps_cold_pass": cfg.frames / t_dec,
        "mean_psnr_db": float(np.mean(pkg["PSNR per frame"])),
        "container_bytes": container.stat().st_size,
        "_pkg": pkg,
    }


# ------------------------------------------------------------------ phase 3
def bench_cfg(h=720, w=1280, frames=32) -> CodecConfig:
    """bench.py's configuration: IPPP full search sr=8, GOP 8."""
    return CodecConfig(height=h, width=w, frames=frames, block_size=16, search_range=8,
                       qp=4, intra_dur=8, lam=0.015)


def gop_scan(cfg: CodecConfig, clip, tag: str, single_pkg=None) -> dict:
    """ShardedCodec on a 1x1 mesh: package == JaxCodec's bitwise (MVs,
    coefficients, reconstructions), sharded decode == reconstructions, then
    one warm encode(fetch="metrics") as bench.py times it."""
    mesh = make_mesh(cfg, devices=jax.devices()[:1])
    if mesh.devices.shape != (1, 1):
        raise AssertionError(f"{tag}: mesh {mesh.devices.shape} is not 1x1")
    sc = ShardedCodec(cfg, mesh, clip)
    pkg = sc.encode()
    if single_pkg is None:
        single_pkg = JaxCodec(cfg, clip).encode()
    _assert_packages_bitwise(single_pkg, pkg, tag)
    dec = np.stack(sc.decode(pkg["frame_type_seq"], pkg["approx residual"],
                             pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"]))
    if not np.array_equal(dec, pkg["reconstructed frames"]):
        raise AssertionError(f"{tag}: sharded decode != reconstruction")
    t0 = time.perf_counter()
    m = sc.encode(fetch="metrics")
    t_warm = time.perf_counter() - t0
    return {
        "size": f"{cfg.width}x{cfg.height}x{cfg.frames}",
        "package_bitwise_equal_per_frame_engine": True,
        "decode_bitwise_equal": True,
        "warm_metrics_encode_fps": cfg.frames / t_warm,
        "mean_psnr_db": float(np.mean(m["PSNR per frame"])),
    }


# ----------------------------------------------------------------- phase 4
def cpu_backend(cfg: CodecConfig, clip, gpu_pkg, frames: int = 3) -> dict:
    """The same program on the CPU backend of this process: its first
    ``frames`` frames (one intra, then inter) must equal the GPU's bitwise
    — the exactness contract across backends (README "Exactness")."""
    cfg3 = dataclasses.replace(cfg, frames=frames)
    with jax.default_device(jax.devices("cpu")[0]):
        codec = JaxCodec(cfg3, clip[:frames])
        cpu_pkg = codec.encode()
    if codec._y_dev.devices() != {jax.devices("cpu")[0]}:
        raise AssertionError("the CPU reference did not run on the CPU backend")
    _assert_packages_bitwise(cpu_pkg, gpu_pkg, "gpu_vs_cpu", frames=frames)
    return {"frames": frames, "frame_types": cpu_pkg["frame_type_seq"],
            "bitwise_equal": True, "tolerance": 0}


def compat_cfg(fast_me: bool, h=288, w=352, frames=None, sr=None) -> CodecConfig:
    """The reference's own defaults (main.py:19-43: qp 5, GOP 21, sr 16,
    fast ME + VBS + FME, lam 0.015); the full-search variant runs 6 frames
    at sr 8 (the host engine is slow at full search)."""
    frames = (21 if fast_me else 6) if frames is None else frames
    sr = (16 if fast_me else 8) if sr is None else sr
    return CodecConfig(height=h, width=w, frames=frames, qp=5, intra_dur=21, search_range=sr,
                       vbs_enable=True, fme_enable=True, fast_me=fast_me, lam=0.015)


# agreement rules with the compat engine (tests/test_jax_engine.py): the
# native transform is exact fixed point where compat uses scipy floats
# (values within +-1), and the native engine fixes quirks K6 (fast-ME RD
# used zero SADs) and K18 (inconsistent FME bounds), COMPAT_NOTES.md — so
# bits and PSNR may differ, but never by a material loss
PSNR_TOL_DB = {"full_search": 0.35, "fast_me": 1.5}


def shared_ref_mvs(codec: JaxCodec, clip, frame_types, recons, i: int) -> list:
    """The native engine's inter step on frame ``i`` with ``recons`` (another
    encoder's reconstructions) as its references — the same references that
    encoder searched — as the list-form MVs of frame ``i``."""
    intra = max(j for j in range(i) if frame_types[j] == 0)
    refs = np.stack(recons[max(intra, i - codec.cfg.n_ref_frames):i])
    cur = jnp.asarray(clip[i])
    out = codec._inter_step_j(cur, jnp.asarray(refs), codec.row_qps_by_type[1], cur,
                              nref=len(refs), initial_refs=False)
    return codec._mvs_to_list(out, 1)


def compat_agreement(cfg: CodecConfig, clip) -> dict:
    """Native engine (on the default device) vs the compat engine (host
    NumPy): equal frame types; per-frame PSNR no more than the tolerance
    below compat; and, under full search, equal MVs for every block that
    neither side splits.  A search is transform-independent only given the
    same reference, and the +-1 transform differences reach every inter
    frame's reference through the reconstructions, so each inter frame's
    native MVs for that rule come from a native search against compat's own
    reconstructed references; the closed-loop agreement is reported too."""
    tag = "fast_me" if cfg.fast_me else "full_search"
    codec = JaxCodec(cfg, clip)
    pkg = codec.encode()
    pkg_c = CompatCodec(dataclasses.replace(cfg, engine="compat"), clip).encode()
    fts = list(pkg["frame_type_seq"])
    if fts != list(pkg_c["frame_type_seq"]):
        raise AssertionError(f"compat {tag}: frame types differ")
    rec, rec_c = pkg["reconstructed frames"], pkg_c["reconstructed frames"]
    mv_checked = loop_same = loop_compared = 0
    if not cfg.fast_me:
        for i, (fa, fb) in enumerate(zip(pkg["MVS per Frame"], pkg_c["MVS per Frame"])):
            shared = fa if fts[i] == 0 else shared_ref_mvs(codec, clip, fts, rec_c, i)
            for j, ((sa, ma), (sb, mb), (sl, ml)) in enumerate(zip(shared, fb, fa)):
                mb = tuple(np.atleast_1d(mb))
                if sl == 0 == sb:
                    loop_compared += 1
                    loop_same += tuple(np.atleast_1d(ml)) == mb
                if sa == 0 == sb:
                    if tuple(np.atleast_1d(ma)) != mb:
                        raise AssertionError(f"compat {tag}: MV differs on a shared reference, "
                                             f"frame {i} block {j}")
                    mv_checked += 1
    tol = PSNR_TOL_DB[tag]
    gap = np.asarray(pkg["PSNR per frame"]) - np.asarray(pkg_c["PSNR per frame"])
    if not (gap > -tol).all():
        raise AssertionError(f"compat {tag}: PSNR {gap.min():.3f} dB below compat (tol {tol})")
    return {
        "size": f"{cfg.width}x{cfg.height}x{cfg.frames}", "sr": cfg.search_range,
        "frame_types_equal": True,
        "frames_with_equal_recon": int(sum(np.array_equal(a, b) for a, b in zip(rec, rec_c))),
        "mvs_checked_equal_shared_ref": mv_checked,
        "mv_agreement_closed_loop": (loop_same / loop_compared) if loop_compared else None,
        "psnr_native_db": float(np.mean(pkg["PSNR per frame"])),
        "psnr_compat_db": float(np.mean(pkg_c["PSNR per frame"])),
        "min_psnr_gap_db": float(gap.min()), "tolerance_db": tol,
        "why_not_bitwise": "exact int DCT vs scipy float DCT; K6/K18 fixed",
    }


# ----------------------------------------------------------------- phase 5
def extreme_blocks(n_blocks: int, n: int = 16, seed: int = 0) -> np.ndarray:
    """(n_blocks, n, n) int32 residuals at the +-255 extremes: constant
    +-255, the sign pattern of every DCT basis function (each maximizes one
    coefficient), then random +-255 blocks."""
    d = T.dct_matrix_f64(n)
    pats = [np.full((n, n), 255), np.full((n, n), -255)]
    for k in range(n):
        for j in range(n):
            s = np.sign(np.outer(d[k], d[j]))
            pats += [np.where(s >= 0, 255, -255), np.where(s >= 0, -255, 255)]
    rng = np.random.default_rng(seed)
    rand = np.where(rng.integers(0, 2, (max(n_blocks - len(pats), 0), n, n)) == 1, 255, -255)
    return np.concatenate([np.stack(pats), rand])[:n_blocks].astype(np.int32)


def _lowering(compiled_text: str) -> dict:
    """How XLA lowered the program: library calls and fusion kinds."""
    import re

    calls = sorted(set(re.findall(r'custom_call_target="([^"]+)"', compiled_text)))
    kinds = sorted(set(re.findall(r"kind=(k\w+)", compiled_text)))
    dots = [ln.strip()[:160] for ln in compiled_text.splitlines()
            if " dot(" in ln or "__triton" in ln or "custom-call(" in ln]
    return {"custom_calls": calls, "fusion_kinds": kinds,
            "triton_fusions": compiled_text.count("__triton"), "dot_lines": dots[:8]}


def transform_probe(n_blocks: int = 8160, n: int = 16, timing_blocks: int = 3600) -> dict:
    """dct2_int / idct2_int on the device vs NumPy (int64), tolerance zero,
    for the extreme residuals and for their quantized-rescaled coefficients
    at every QP; plus the lowering and the per-frame time (``timing_blocks``
    = one 720p frame of 16x16 blocks)."""
    x = extreme_blocks(n_blocks, n)
    dct_j = jax.jit(T.dct2_int)
    idct_j = jax.jit(T.idct2_int)
    t_np = T.dct2_int(x, xp=np)
    if not np.array_equal(np.asarray(dct_j(jnp.asarray(x))), t_np):
        raise AssertionError("dct2_int: device != NumPy")
    for qp in range(13):
        rs = np.asarray(rescale(quantize(t_np.astype(np.int64), qp), qp)).astype(np.int32)
        if not np.array_equal(np.asarray(idct_j(jnp.asarray(rs))), T.idct2_int(rs, xp=np)):
            raise AssertionError(f"idct2_int: device != NumPy at qp {qp}")
    xt = jnp.asarray(x[:timing_blocks])
    low = _lowering(dct_j.lower(xt).compile().as_text())

    def frame(v):
        return T.idct2_int(T.dct2_int(v))

    fj = jax.jit(frame)
    jax.block_until_ready(fj(xt))
    reps = 20
    t0 = time.perf_counter()
    out = xt
    for _ in range(reps):
        out = fj(out)  # chained so no two calls share inputs
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / reps * 1e3
    return {"blocks": int(n_blocks), "qps": "0..12", "bitwise_equal": True,
            "dct_lowering": low, "dct_plus_idct_ms_per_frame": ms,
            "frame_blocks": int(timing_blocks)}


def window_gather_probe(h: int = 1088, w: int = 1920, nb: int = 4096, seed: int = 0) -> dict:
    """fastme.window_gather (bf16 one-hot operands, f32 accumulation) on
    FME parity planes of an (h, w) frame vs direct NumPy indexing, for the
    square confirm window and the k=4 lookahead wide window, at origins
    in-plane, on every edge and far outside.  Tolerance zero."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (1, h, w), dtype=np.uint8)
    planes = FM.plane_stack(jnp.asarray(ref), True, jnp)
    pn = np.asarray(planes.astype(jnp.int32))
    P = pn.shape[0]
    checked = []
    for nwin, nwin_c in ((18, 18), FM.wide_window_spec(16, 4, True)):
        by0 = np.concatenate([rng.integers(-nwin, h + 1, nb - 4), [-nwin, h - 1, -10**6, 10**6]])
        bx0 = np.concatenate([rng.integers(-nwin_c, w + 1, nb - 4), [w - 1, -nwin_c, 10**6, 0]])
        got = np.asarray(jax.jit(
            lambda p, y, x, a=nwin, b=nwin_c: FM.window_gather(p, y, x, a, jnp, nwin_c=b)
        )(planes, jnp.asarray(by0, jnp.int32), jnp.asarray(bx0, jnp.int32)))
        pad = np.zeros((P, h + 2 * nwin, w + 2 * nwin_c), np.int32)
        pad[:, nwin:nwin + h, nwin_c:nwin_c + w] = pn
        yy = np.clip(by0, -nwin, h) + nwin
        xx = np.clip(bx0, -nwin_c, w) + nwin_c
        want = np.stack([pad[:, y:y + nwin, x:x + nwin_c] for y, x in zip(yy, xx)])
        if not np.array_equal(got, want):
            raise AssertionError(f"window_gather {nwin}x{nwin_c}: device != NumPy")
        checked.append(f"{nwin}x{nwin_c}")
    return {"planes": f"{P}x{h}x{w}", "windows": checked, "origins": int(nb),
            "bitwise_equal": True}


# ----------------------------------------------------------------- phase 6
def cli(h=720, w=1280, frames=16, out_dir: Path = OUT_DIR) -> dict:
    """python -m streamoptima_tpu with the given arguments, called in-process."""
    from streamoptima_tpu.main import main

    d = out_dir / "cli"
    d.mkdir(parents=True, exist_ok=True)
    argv = ["--synthetic", "--height", str(h), "--width", str(w), "--frames", str(frames),
            "--no-fast-me", "--no-fme", "--no-vbs", "--search-range", "8", "--intra-dur", "8",
            "--mv-file", str(d / "mv.txt"), "--residual-file", str(d / "res.txt"),
            "--out", str(d / "decoded.yuv"), "--recon-out", str(d / "recon.yuv")]
    rc = main(argv)
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    return {"argv": " ".join(argv[:15]), "returncode": rc}


# ------------------------------------------------------------- four cards
def four_card(h=1088, w=1920, frames=16, devices=None) -> dict:
    """data=2 x tile=2 mesh (GOP axis and row-tile halo ppermute), full
    search VBS+FME and fast-ME VBS+FME: sharded encode and decode bitwise
    equal to the single-card JaxCodec on the same clip."""
    devices = jax.devices()[:4] if devices is None else devices
    clip = synthetic_clip(h, w, frames, seed=0)
    out = {}
    for tag, cfg in (("full_search_vbs_fme", library_cfg(h, w, frames)),
                     ("fast_me_vbs_fme", fast_me_cfg(h, w, frames))):
        mesh = make_mesh(cfg, devices=devices, tile=2)
        if mesh.devices.shape != (len(devices) // 2, 2):
            raise AssertionError(f"{tag}: mesh {mesh.devices.shape}")
        sc = ShardedCodec(cfg, mesh, clip)
        pkg = sc.encode()
        with jax.default_device(devices[0]):
            single = JaxCodec(cfg, clip).encode()
        _assert_packages_bitwise(single, pkg, f"four_card {tag}")
        dec = np.stack(sc.decode(pkg["frame_type_seq"], pkg["approx residual"],
                                 pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"]))
        if not np.array_equal(dec, pkg["reconstructed frames"]):
            raise AssertionError(f"four_card {tag}: sharded decode != reconstruction")
        out[tag] = {"mesh": f"data={mesh.devices.shape[0]} x tile={mesh.devices.shape[1]}",
                    "encode_bitwise_equal_single_card": True, "decode_bitwise_equal": True,
                    "mean_psnr_db": float(np.mean(pkg["PSNR per frame"]))}
    return out


# ------------------------------------------------------------------ trace
def traced_rerun(trace_dir: Path, dump_dir: Path, lib_cfg, lib_clip, fm_cfg, fm_clip) -> dict:
    """Warm re-runs of phases 1-3 (8 frames each) under jax.profiler,
    reduced to device time per named stage (benchmarks/trace_stages.py;
    ``dump_dir`` holds the optimized HLO of every compiled program)."""
    from benchmarks import trace_stages

    frames = 8
    lib_c = dataclasses.replace(lib_cfg, frames=frames)
    fm_c = dataclasses.replace(fm_cfg, frames=frames)
    lib, fm = JaxCodec(lib_c, lib_clip[:frames]), JaxCodec(fm_c, fm_clip[:frames])
    gop = ShardedCodec(lib_c, make_mesh(lib_c, devices=jax.devices()[:1]), lib_clip[:frames])
    pkg = lib.encode()
    fm.encode()
    gop.encode(fetch="metrics")
    dec_args = (pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"],
                pkg["MVS per Frame"])
    lib.decode(*dec_args)  # every program compiles outside the traced window
    shutil.rmtree(trace_dir, ignore_errors=True)
    wall = {}
    with jax.profiler.trace(str(trace_dir)):
        for name, fn in (("encode_720p_vbs_fme", lambda: lib.encode(package=False)),
                         ("decode_720p_vbs_fme", lambda: lib.decode(*dec_args)),
                         ("encode_1088p_fast_me", lambda: fm.encode(package=False)),
                         ("gop_scan_720p_vbs_fme", lambda: gop.encode(fetch="metrics"))):
            with jax.profiler.TraceAnnotation(f"window:{name}"):
                t0 = time.perf_counter()
                out = fn()
                jax.block_until_ready(out.get("per_frame", out) if isinstance(out, dict) else out)
                wall[name] = time.perf_counter() - t0
    red = trace_stages.reduce_trace(trace_dir, str(dump_dir), frames=frames)
    red["window_wall_s"] = wall
    (trace_dir / "trace_stages.json").write_text(json.dumps(red, indent=1))
    return {k: v for k, v in red.items() if k != "top_kernels_ms"}


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase (needs 4 GPUs)")
    ap.add_argument("--trace", metavar="DIR", default=None,
                    help="also trace warm re-runs of phases 1-3 into DIR")
    args = ap.parse_args(argv)
    dump_dir = OUT_DIR.parent / "xla_dump"
    if args.trace:
        # the optimized HLO that maps kernels to stages (it changes no
        # program); read by XLA at the first compile, so set before any JAX
        # work
        shutil.rmtree(dump_dir, ignore_errors=True)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_dump_to={dump_dir} --xla_dump_hlo_as_text").strip()

    clock = CompileClock()
    dev = clock.run("phase 0 device", device_check)
    setup_compile_cache()
    if args.four:
        if dev["count"] < 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {dev['count']}")
        clock.run("phase 4card mesh data=2 x tile=2, 1920x1088 x16", four_card)
    else:
        lib_cfg, fm_cfg = library_cfg(), fast_me_cfg()
        lib_clip = synthetic_clip(lib_cfg.height, lib_cfg.width, lib_cfg.frames, seed=0)
        fm_clip = synthetic_clip(fm_cfg.height, fm_cfg.width, fm_cfg.frames, seed=0)
        p1 = clock.run("phase 1 library 720p", closed_loop, lib_cfg, lib_clip, "lib720")
        clock.run("phase 2 fast-ME 1088p", closed_loop, fm_cfg, fm_clip, "fastme1088")
        clock.run("phase 3a GOP scan 720p IPPP sr8", gop_scan, bench_cfg(), lib_clip, "gop_ippp")
        clock.run("phase 3b GOP scan 720p VBS+FME", gop_scan, lib_cfg, lib_clip, "gop_vbs_fme",
                   single_pkg=p1["_pkg"])
        clock.run("phase 4a CPU backend == GPU", cpu_backend, lib_cfg, lib_clip, p1["_pkg"])
        for fast in (True, False):
            cfg = compat_cfg(fast)
            clock.run(f"phase 4b compat CIF {'fast-ME' if fast else 'full search'}",
                       compat_agreement, cfg, synthetic_clip(cfg.height, cfg.width, cfg.frames,
                                                             seed=0))
        clock.run("phase 5a int32 transform probe", transform_probe)
        clock.run("phase 5b window gather probe 1088p", window_gather_probe)
        clock.run("phase 6 CLI", cli)
        if args.trace:
            clock.run("trace phases 1-3 (warm)", traced_rerun, Path(args.trace), dump_dir,
                      lib_cfg, lib_clip, fm_cfg, fm_clip)
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {"platform": dev["platform"], "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
