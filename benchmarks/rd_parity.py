"""Native-engine RD parity vs the reference (via the bit-exact compat twin).

The native engine deliberately deviates from the reference in three recorded
places (COMPAT_NOTES.md N1-N3: int32 fixed-point DCT, true SADs where the
reference reports stale ones, per-frame-type RC tables) — each changes
nothing or almost nothing about the rate-distortion operating point, but
BASELINE.md's "matched PSNR/bitrate" claim deserves a recorded artifact, not
an assertion.  This sweep encodes the same clips with BOTH engines at
QP in {1, 4, 7, 10} and records mean PSNR (reference Encoder.py:934-935
metric) and mean bits/frame per engine, plus the deltas.

Runs on the CPU (the compat engine is host NumPy; the native engine's bits
and PSNR are backend-independent).  Writes benchmarks/rd_parity.json and
prints the table (mirrored into docs/DESIGN.md).

    PYTHONPATH=/root/repo JAX_PLATFORMS=cpu python benchmarks/rd_parity.py
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402


def package_bits_per_frame(pkg, cfg):
    """Serialized stream size in bits/frame through the SAME serializer for
    both engines (the reference's text grammar, bitstream.py — what the
    reference's own 'residual size' counts, Encoder.py:934-935 vicinity)."""
    from streamoptima_tpu import bitstream as BS

    total = 0
    for i in range(cfg.frames):
        ft = pkg["frame_type_seq"][i]
        total += len(BS.encode_mv_frame(ft, pkg["MVS per Frame"][i],
                                        pkg["Qp_per_row_per_frame"][i],
                                        cfg.rc_active, cfg.blocks_per_row))
        total += len(BS.encode_residual_frame(pkg["approx residual"][i],
                                              cfg.block_size, True))
    return 8.0 * total / cfg.frames


def run(h, w, frames, qps, extra, label, results):
    import dataclasses

    from streamoptima_tpu.compat_engine import CompatCodec
    from streamoptima_tpu.config import CodecConfig
    from streamoptima_tpu.jax_engine import JaxCodec
    from streamoptima_tpu.utils import synthetic_clip

    clip = synthetic_clip(h, w, frames)
    rows = []
    for qp in qps:
        cfg = CodecConfig(height=h, width=w, frames=frames, block_size=16,
                          qp=qp, **extra)
        t0 = time.perf_counter()
        nat = JaxCodec(cfg, clip).encode()
        t_nat = time.perf_counter() - t0
        ccfg = dataclasses.replace(cfg, engine="compat")
        t0 = time.perf_counter()
        cmp_ = CompatCodec(ccfg, clip).encode()
        t_cmp = time.perf_counter() - t0
        row = {
            "qp": qp,
            "native_psnr_db": round(float(np.mean(nat["PSNR per frame"])), 4),
            "compat_psnr_db": round(float(np.mean(cmp_["PSNR per frame"])), 4),
            "native_bits_pf": round(package_bits_per_frame(nat, cfg), 1),
            "compat_bits_pf": round(package_bits_per_frame(cmp_, ccfg), 1),
            "t_native_s": round(t_nat, 2),
            "t_compat_s": round(t_cmp, 2),
        }
        row["dpsnr_db"] = round(row["native_psnr_db"] - row["compat_psnr_db"], 4)
        row["dbits_pct"] = round(
            100.0 * (row["native_bits_pf"] - row["compat_bits_pf"]) / row["compat_bits_pf"], 3)
        rows.append(row)
        print(f"[{label}] qp={qp}: native {row['native_psnr_db']:.3f} dB / "
              f"{row['native_bits_pf']:.0f} b/f, compat {row['compat_psnr_db']:.3f} dB / "
              f"{row['compat_bits_pf']:.0f} b/f  ->  dPSNR {row['dpsnr_db']:+.3f} dB, "
              f"dbits {row['dbits_pct']:+.2f}%", flush=True)
    results[label] = {
        "config": f"{w}x{h} frames={frames} " + " ".join(f"{k}={v}" for k, v in extra.items()),
        "rows": rows,
    }


def equal_bits_rows(results):
    """Bits-matched operating points (round-5 VERDICT item 4): the K6-fix
    makes the native fast-ME engine spend MORE bits at equal QP, so
    BASELINE.md's "matched bitrate" claim needs the PSNR delta stated at
    EQUAL rate.  No knob reaches intermediate rates — lam was measured
    INSENSITIVE over 0.015..10 (recorded below): the bits surplus is
    inf-forced honest splits at quirk-K7-invalid edge blocks (rd.py: an
    all-invalid block splits, reference full-search semantics at
    Encoder.py:684 — which the reference's own fast-ME path never applies
    because K6 feeds its RD cost mae=0), and an inf beats any finite
    lam*bits term.  The standard tool is therefore RD-curve interpolation
    (the BD-PSNR construction): native PSNR at the compat point's rate,
    piecewise log-linear on the recorded native (bits, psnr) curve."""
    curves = results["cif_fastme_vbs_fme"]["rows"]
    nat = sorted(((r["native_bits_pf"], r["native_psnr_db"]) for r in curves))
    out_rows = []
    for r in curves:
        cb, cp = r["compat_bits_pf"], r["compat_psnr_db"]
        # bracket compat's rate on the native curve (log-rate domain)
        lo = max((p for p in nat if p[0] <= cb), default=None)
        hi = min((p for p in nat if p[0] >= cb), default=None)
        if lo is None or hi is None:
            continue
        if hi[0] == lo[0]:
            psnr = lo[1]
        else:
            t = (np.log(cb) - np.log(lo[0])) / (np.log(hi[0]) - np.log(lo[0]))
            psnr = lo[1] + t * (hi[1] - lo[1])
        out_rows.append({
            "qp": r["qp"],
            "compat_bits_pf": cb, "compat_psnr_db": cp,
            "native_psnr_at_equal_bits_db": round(float(psnr), 4),
            "dpsnr_at_equal_bits_db": round(float(psnr) - cp, 4),
            "native_bracket_bits": [lo[0], hi[0]],
        })
        print(f"[equal_bits] qp={r['qp']}: native {psnr:.3f} dB interpolated at "
              f"compat's {cb:.0f} b/f vs compat {cp:.3f} dB "
              f"(dPSNR {psnr - cp:+.3f} dB at equal bits)", flush=True)
    results["equal_bits_fastme"] = {
        "method": "piecewise log-rate interpolation of the recorded native "
                  "(bits, PSNR) curve at each compat point's rate (BD-PSNR "
                  "construction); lam tuning measured ineffective "
                  "(0.015..10 moved neither splits nor bits — the bits "
                  "surplus is inf-forced honest splits at K7-invalid edge "
                  "blocks, structural, not priced by lam)",
        "rows": out_rows,
    }


def main():
    import json as _json

    out = REPO / "benchmarks" / "rd_parity.json"
    if "equal_bits" in sys.argv:
        # derive the bits-matched rows from the recorded curves and merge
        results = _json.loads(out.read_text())
        equal_bits_rows(results)
        out.write_text(json.dumps(results, indent=1))
        print(f"wrote {out}")
        return
    results = {}
    qps = (1, 4, 7, 10)
    # CIF at the reference's shipped feature set (fast-ME + VBS + FME)
    run(288, 352, 6, qps,
        dict(search_range=16, intra_dur=6, fast_me=True, vbs_enable=True,
             fme_enable=True, lam=0.015), "cif_fastme_vbs_fme", results)
    # full-search flagship feature set (VBS + FME).  NOTE: a 720p comparison
    # is structurally impossible — the reference intra-codes on a hardcoded
    # 288x352 canvas (Encoder.py:1248, replicated by the compat engine as a
    # loud error) and every clip's frame 0 is intra, so the reference cannot
    # encode beyond CIF at all; CIF is the largest comparable size.
    run(288, 352, 6, qps,
        dict(search_range=8, intra_dur=6, vbs_enable=True, fme_enable=True,
             lam=0.015), "cif_full_vbs_fme", results)
    # plain full search (the N1 int32-DCT deviation in isolation)
    run(288, 352, 6, qps, dict(search_range=8, intra_dur=6), "cif_plain", results)
    out = REPO / "benchmarks" / "rd_parity.json"
    old = json.loads(out.read_text()) if out.exists() else {}
    if "equal_bits_fastme" in old:  # keep the bits-matched rows on re-runs
        results["equal_bits_fastme"] = old["equal_bits_fastme"]
    out.write_text(json.dumps(results, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
