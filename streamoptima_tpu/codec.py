"""User-facing codec facade: engine dispatch + bitstream + file I/O.

The working twin of the reference's driver surface (main.py + the public
methods of Y_Video_codec / decoder — the shipped main.py is unrunnable,
bug B5 in COMPAT_NOTES.md):

    codec = VideoCodec(cfg, y_frames)
    pkg = codec.encode()                         # Encoder.encode, Encoder.py:1790
    codec.transmit_bitstream("mv.txt", "res.txt")  # Encoder.py:1544
    frames = codec.decode_bitstream("mv.txt", "res.txt")  # decoder.py:692
    codec.save_decoded_frames("out.yuv")         # decoder.py:711

Engines: cfg.engine == "jax" (native device pipeline; optionally multi-device via
``mesh=``) or "compat" (host NumPy, bit-exact with the reference).
"""
from __future__ import annotations

import time

import numpy as np

from streamoptima_tpu import bitstream as BS
from streamoptima_tpu import metrics
from streamoptima_tpu.config import CodecConfig
from streamoptima_tpu.io.video import VideoManager


class VideoCodec:
    """Encode/decode driver over either engine, with file-level APIs."""

    def __init__(self, cfg: CodecConfig, y_frames=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self._pkg = None
        self._decoded = None
        if cfg.compat:
            from streamoptima_tpu.compat_engine import CompatCodec

            assert mesh is None, "multi-chip encoding requires engine='jax'"
            self._enc = CompatCodec(cfg, y_frames) if y_frames is not None else None
            self._dec = CompatCodec(cfg, np.zeros((cfg.frames, cfg.height, cfg.width), np.uint8))
        else:
            from streamoptima_tpu.jax_engine import JaxCodec

            self._dec_mesh = None
            if mesh is not None:
                from streamoptima_tpu.parallel import ShardedCodec

                self._enc = ShardedCodec(cfg, mesh, y_frames) if y_frames is not None else None
                # sharded decode for GOP-regular streams (the only kind the
                # mesh encoder produces); single-chip decoder kept as the
                # fallback for foreign/promoted bitstreams
                self._dec_mesh = self._enc if self._enc is not None else ShardedCodec(cfg, mesh)
            else:
                self._enc = JaxCodec(cfg, y_frames) if y_frames is not None else None
            self._dec = JaxCodec(cfg)

    # ----------------------------------------------------------- encoding
    def encode(self, compute_ssim: bool = True, **kw):
        """Encode the clip; returns the package dict (same keys as the
        reference's encoded_package, Encoder.py:1877-1892, plus SSIM).

        Wall-clock per frame type is recorded in pkg["timing"] (the
        reference's per-mode second lists, Encoder.py:62-69, :1897).
        """
        assert self._enc is not None, "construct with y_frames to encode"
        t0 = time.perf_counter()
        pkg = self._enc.encode(**kw)
        pkg.setdefault("timing", {})["total_s"] = time.perf_counter() - t0
        if compute_ssim and self._enc.y is not None and pkg.get("reconstructed frames") is not None:
            recon = pkg["reconstructed frames"]
            if self.cfg.compat:
                pkg["SSIM per frame"] = [
                    metrics.ssim(self._enc.y[i], recon[i]) for i in range(len(recon))
                ]
            else:
                # one batched device call; the per-frame host scipy loop
                # dominated fast 720p encodes (round-1 VERDICT item 10)
                pkg["SSIM per frame"] = metrics.ssim_frames(self._enc.y[: len(recon)], recon)
        self._pkg = pkg
        return pkg

    def transmit_bitstream(self, mv_file, residual_file, raw_mv_file=None):
        """Write the two text bitstream files (transmit_bitstream twin,
        Encoder.py:1544-1573; shipped-format bug B1 fixed)."""
        assert self._pkg is not None, "encode() first"
        p = self._pkg
        if "per_frame" in p:  # array package (encode(package=False))
            BS.write_bitstream_arrays(
                mv_file, residual_file, p["frame_type_seq"], p["per_frame"],
                p["Qp_per_row_per_frame"], self.cfg, raw_mv_path=raw_mv_file,
            )
        else:
            BS.write_bitstream(
                mv_file, residual_file, p["frame_type_seq"], p["MVS per Frame"],
                p["Qp_per_row_per_frame"], p["approx residual"], self.cfg, raw_mv_path=raw_mv_file,
            )

    def transmit_bitstream_binary(self, path):
        """Write the single-file binary container (binstream.py, format
        SOTPB1) — the production form behind the same serializer interface;
        the two text files remain the reference-parity format."""
        assert self._pkg is not None, "encode() first"
        from streamoptima_tpu import binstream as BIN

        p = self._pkg
        if "per_frame" in p:
            from streamoptima_tpu import jax_engine

            pairs = [
                jax_engine.frame_arrays_of(o, ft)
                for o, ft in zip(p["per_frame"], p["frame_type_seq"])
            ]
            BIN.write_binary(path, p["frame_type_seq"], [m for m, _ in pairs],
                             p["Qp_per_row_per_frame"], [r for _, r in pairs], self.cfg)
        else:
            BIN.write_binary(path, p["frame_type_seq"], p["MVS per Frame"],
                             p["Qp_per_row_per_frame"], p["approx residual"], self.cfg)

    # ----------------------------------------------------------- decoding
    def decode(self, frame_types=None, residuals=None, qp_rows=None, mvs=None):
        """In-memory decode (decoder.decode twin, decoder.py:487).  With no
        arguments, decodes the last encoded package (the encoder's embedded
        self-check, Encoder.py:1873)."""
        if frame_types is None:
            p = self._pkg
            assert p is not None and "approx residual" in p, "encode() with packaging first"
            frame_types, residuals, qp_rows, mvs = (
                p["frame_type_seq"], p["approx residual"], p["Qp_per_row_per_frame"], p["MVS per Frame"],
            )
        frames = self._run_decode(frame_types, residuals, qp_rows, mvs)
        self._decoded = np.stack([np.asarray(f) for f in frames])
        return self._decoded

    def decode_bitstream(self, mv_file, residual_file):
        """File-level decode (decode_bitstream twin, decoder.py:692-709).

        ROI streams are self-describing: read_bitstream adopts the stream's
        per-block QP-offset header into cfg (or raises on a map conflicting
        with a USER-set one; maps adopted from earlier streams are replaced
        or cleared per stream, so one codec decodes any sequence).  The
        decode engines cache the map at construction, so they are rebuilt
        whenever the effective map changed."""
        return self._decode_files(
            lambda: BS.read_bitstream(mv_file, residual_file, self.cfg))

    def decode_bitstream_binary(self, path):
        """File-level decode of the binary container (binstream.py); same
        ROI adoption/rebuild semantics as decode_bitstream.  Native-engine
        only (the compat oracle replicates the reference, which has no
        binary format)."""
        if self.cfg.compat:
            raise ValueError("the binary container requires engine='jax'")
        from streamoptima_tpu import binstream as BIN

        return self._decode_files(lambda: BIN.read_binary(path, self.cfg))

    def _decode_files(self, read):
        before = None if self.cfg.roi_qp_map is None else np.asarray(self.cfg.roi_qp_map)
        fts, mvs, qps, res = read()
        after = None if self.cfg.roi_qp_map is None else np.asarray(self.cfg.roi_qp_map)
        changed = (before is None) != (after is None) or (
            before is not None and not np.array_equal(before, after)
        )
        if changed:
            from streamoptima_tpu.jax_engine import JaxCodec

            self._dec = JaxCodec(self.cfg)
            if getattr(self, "_dec_mesh", None) is not None:
                from streamoptima_tpu.parallel import ShardedCodec

                self._dec_mesh = ShardedCodec(self.cfg, self.mesh)
        frames = self._run_decode(fts, res, qps, mvs)
        self._decoded = np.stack([np.asarray(f) for f in frames])
        return self._decoded

    def _run_decode(self, frame_types, residuals, qp_rows, mvs):
        if getattr(self, "_dec_mesh", None) is not None:
            try:
                return self._dec_mesh.decode(frame_types, residuals, qp_rows, mvs)
            except ValueError:
                pass  # non-GOP-regular stream: single-chip decode below
        return self._dec.decode(frame_types, residuals, qp_rows, mvs)

    def save_decoded_frames(self, path, overlay_path=None):
        """Write decoded Y frames as raw bytes (save_decoded_frames twin,
        decoder.py:711-725); optional VBS-partition overlay clip."""
        assert self._decoded is not None, "decode first"
        VideoManager.save_y_only(path, self._decoded)
        if overlay_path is not None:
            from streamoptima_tpu import viz

            assert self._pkg is not None and "MVS per Frame" in self._pkg
            ov = viz.vbs_overlay_frames(self._decoded, self._pkg["MVS per Frame"],
                                        self._pkg["frame_type_seq"], self.cfg)
            VideoManager.save_y_only(overlay_path, ov)

    def save_reconstructed(self, path):
        """Write the encoder-side reconstructions (Encoder.py:1894)."""
        assert self._pkg is not None
        VideoManager.save_y_only(path, self._pkg["reconstructed frames"])
