"""Bitstream serialization: differential MV coding + entropy text format.

Byte-exact with the reference's text formats:
- MV file line:  "<frame_type>|" + differential_encoder_frame output
  (Encoder.py:1419-1520, :1567)
- residual file line: entropy_encoder_frame output (Encoder.py:1522-1542).
  NOTE the shipped transmit_bitstream writes raw array reprs instead
  (Encoder.py:1569, bug B1 in COMPAT_NOTES.md); we write the format the
  decoder parses (decoder.py:651-670).

Parsing replaces the reference's ``eval`` (decoder.py:605-662) with a safe
literal parser that also accepts numpy scalar reprs (``np.int64(-3)``).

MV structures: per frame a list of ``(0, mv)`` or ``(1, [mv x4])`` where mv is
an int (intra) or an (dx, dy, ref) tuple (inter).  Residual structures: per
frame a list of ``(0, block)`` or ``(1, [blocks x4])`` of int arrays.
"""
from __future__ import annotations

import ast
import re
from typing import NamedTuple

import numpy as np

from streamoptima_tpu.core.zigzag import rle_decode_block, rle_encode_block


class FrameMVArrays(NamedTuple):
    """Array-form MV interchange for one frame (the native text parser's
    output): drop-in alternative to the list format wherever the JAX-engine
    helpers (jax_engine.list_to_mvs_np) consume a frame's MVs.  Intra frames
    use component 0 of ``mv``/``smv`` only (the other components are 0)."""

    ftype: int
    mv: np.ndarray  # (nb, 3) int32
    split: np.ndarray  # (nb,) bool
    smv: np.ndarray  # (nb, 4, 3) int32


class FrameResArrays(NamedTuple):
    """Array-form residual interchange for one frame (native parser output);
    accepted by jax_engine.list_to_res_np in place of the list format."""

    split: np.ndarray  # (nb,) bool
    qf: np.ndarray  # (nb, bs, bs) int16
    qq: np.ndarray  # (nb, 4, sbs, sbs) int16

def widen_mvs(ftype: int, mv, smv, dtype=np.int32):
    """Either MV layout -> the canonical (nb, 3) / (nb, 4, 3) arrays (intra
    scalars widen into component 0).  The single widening implementation —
    binstream, jax_engine.frame_arrays_of and the native wrapper all share
    it so the forms cannot drift."""
    mv = np.asarray(mv)
    smv = np.asarray(smv)
    nb = mv.shape[0]
    m3 = np.zeros((nb, 3), dtype)
    s3 = np.zeros((nb, 4, 3), dtype)
    if mv.ndim == 1:
        m3[:, 0] = mv
    else:
        m3[:] = mv
    if smv.ndim == 2:
        s3[:, :, 0] = smv
    else:
        s3[:] = smv
    if ftype == 0:  # intra carries component-0 scalars only
        m3[:, 1:] = 0
        s3[:, :, 1:] = 0
    return m3, s3


_NP_SCALAR = re.compile(r"np\.int(?:8|16|32|64)\((-?\d+)\)")

# ROI header line prefix in the MV file (native extension: the reference's
# README promises ROI but ships none; frame lines always start "0|"/"1|" so
# the prefix cannot collide).  Streams carrying a per-block QP-offset map
# must be self-describing — a decoder without the exact map would silently
# reconstruct garbage (round-2 VERDICT item 5).
_ROI_PREFIX = "roi|"


def _safe_eval(text: str):
    return ast.literal_eval(_NP_SCALAR.sub(r"\1", text))


def encode_roi_header(roi_qp_map, block_rows: int, blocks_per_row: int) -> str:
    """Per-block QP-offset map -> one MV-file header line
    ("roi|<rows>x<cols>|v,v,..." in block raster order)."""
    roi = np.asarray(roi_qp_map, dtype=np.int32).reshape(-1)
    assert roi.shape[0] == block_rows * blocks_per_row, "roi_qp_map must have one offset per block"
    return f"{_ROI_PREFIX}{block_rows}x{blocks_per_row}|" + ",".join(str(int(v)) for v in roi)


def decode_roi_header(line: str) -> np.ndarray:
    """ROI header line -> (block_rows, blocks_per_row) int32 offset map."""
    _, dims, body = line.rstrip("\n").split("|")
    nbr, nbc = (int(v) for v in dims.split("x"))
    roi = (
        np.fromiter((int(v) for v in body.split(",")), dtype=np.int32)
        if body else np.zeros(0, np.int32)
    )
    if roi.shape[0] != nbr * nbc:
        raise ValueError(f"ROI header declares {nbr}x{nbc} blocks but carries {roi.shape[0]} offsets")
    return roi.reshape(nbr, nbc)


def _reconcile_roi(stream_roi, cfg) -> None:
    """Make ``cfg`` agree with the stream's ROI header (or its absence).

    - stream has a map, cfg has none: adopt it (the stream is
      self-describing — a default cfg decodes ROI streams correctly);
    - both have maps: a difference against a USER-set map raises (decoding
      with the wrong offsets would silently reconstruct garbage); a map a
      previous stream ADOPTED is just provenance, so the new stream's map
      replaces it — one cfg can decode any sequence of streams;
    - stream has none: a USER-set map raises for the same reason; an
      adopted one is cleared.

    Adoption provenance rides a private ``_roi_adopted`` attribute so a
    stream-derived map is never mistaken for user configuration (the sticky
    form made the first ROI stream poison every later decode)."""
    adopted = bool(getattr(cfg, "_roi_adopted", False))
    cfg_roi = None if cfg.roi_qp_map is None else np.asarray(cfg.roi_qp_map, np.int32).reshape(-1)
    if stream_roi is None:
        if cfg_roi is not None:
            if not adopted:
                raise ValueError(
                    "cfg carries a roi_qp_map but the bitstream has no ROI header: "
                    "decoding would apply QP offsets the encoder never used"
                )
            cfg.roi_qp_map = None
            cfg._roi_adopted = False
        return
    if cfg_roi is not None and not adopted and not np.array_equal(cfg_roi, stream_roi.reshape(-1)):
        raise ValueError("cfg.roi_qp_map differs from the bitstream's ROI header")
    if cfg.compat:
        raise ValueError(
            "the bitstream carries an ROI header but the compat engine replicates "
            "the reference, which has no ROI — decode with engine='jax'"
        )
    cfg.roi_qp_map = stream_roi
    cfg._roi_adopted = cfg_roi is None or adopted


def encode_mv_frame(frame_type: int, mvs, qp_per_row, rc_active: bool, blocks_per_row: int) -> str:
    """Twin of differential_encoder_frame (Encoder.py:1419-1520), including
    quirk K11 (intra split serializes diff_mv in the QP field)."""
    out = []
    ref_qp = 0
    if frame_type == 0:
        ref_mv = 0
        for j, (split, mv) in enumerate(mvs):
            row_head = rc_active and j % blocks_per_row == 0
            if row_head:
                diff_qp = int(qp_per_row[j // blocks_per_row]) - ref_qp
            if split == 0:
                diff = int(mv) - ref_mv
                if j == 0:
                    out.append((f"{diff_qp}@" if row_head else "") + f"0'({diff})")
                else:
                    out.append(";" + (f"{diff_qp}@" if row_head else "") + f"0'({diff})")
                ref_mv = int(mv)
            else:
                parts = []
                first_diff = None
                for k, sb in enumerate(mv):
                    diff = int(sb) - ref_mv
                    if k == 0:
                        first_diff = diff
                    parts.append(str(diff))
                    ref_mv = int(sb)
                # quirk K11: the "qp" field is the first sub-mv diff
                head = ";" + (f"{first_diff}@" if row_head else "") + "1'("
                out.append(head + ",".join(parts) + ")")
            if row_head:
                ref_qp = int(qp_per_row[j // blocks_per_row])
    else:
        ref_mv = (0, 0, 0)
        for j, (split, mv) in enumerate(mvs):
            row_head = rc_active and j % blocks_per_row == 0
            if row_head:
                diff_qp = int(qp_per_row[j // blocks_per_row]) - ref_qp
            if split == 0:
                t = tuple(int(v) for v in mv)
                diff = (t[0] - ref_mv[0], t[1] - ref_mv[1], t[2] - ref_mv[2])
                if j == 0:
                    out.append((f"{diff_qp}@" if row_head else "") + f"0'{diff}")
                else:
                    out.append(";" + (f"{diff_qp}@" if row_head else "") + f"0'{diff}")
                ref_mv = t
            else:
                parts = []
                for k, sb in enumerate(mv):
                    t = tuple(int(v) for v in sb)
                    diff = (t[0] - ref_mv[0], t[1] - ref_mv[1], t[2] - ref_mv[2])
                    parts.append(str(diff))
                    ref_mv = t
                head = ";" + (f"{diff_qp}@" if row_head else "") + "1'("
                out.append(head + ",".join(parts) + ")")
            if row_head:
                ref_qp = int(qp_per_row[j // blocks_per_row])
    return "".join(out)


def decode_mv_frame(line: str, rc_active: bool, blocks_per_row: int):
    """Twin of differential_decoder_frame (decoder.py:590-649)."""
    raw = line.rstrip("\n").split("|")
    frame_type = int(raw[0])
    items = raw[1].split(";")
    mvs = []
    qps = []
    if frame_type == 0:
        ref_mv = 0
        ref_qp = 0
        for j, item in enumerate(items):
            if rc_active and j % blocks_per_row == 0:
                qp_s, item = item.split("@")
                ref_qp = ref_qp + int(_safe_eval(qp_s))
                qps.append(ref_qp)
            split, body = item.split("'")
            if split == "0":
                ref_mv = ref_mv + int(_safe_eval(body))
                mvs.append((0, ref_mv))
            else:
                subs = []
                for d in _safe_eval(body):
                    ref_mv = ref_mv + d
                    subs.append(ref_mv)
                mvs.append((1, subs))
    else:
        ref_mv = (0, 0, 0)
        ref_qp = 0
        for j, item in enumerate(items):
            if rc_active and j % blocks_per_row == 0:
                qp_s, item = item.split("@")
                ref_qp = ref_qp + int(_safe_eval(qp_s))
                qps.append(ref_qp)
            split, body = item.split("'")
            if split == "0":
                d = _safe_eval(body)
                ref_mv = (ref_mv[0] + d[0], ref_mv[1] + d[1], ref_mv[2] + d[2])
                mvs.append((0, ref_mv))
            else:
                subs = []
                for d in _safe_eval(body):
                    ref_mv = (ref_mv[0] + d[0], ref_mv[1] + d[1], ref_mv[2] + d[2])
                    subs.append(ref_mv)
                mvs.append((1, subs))
    return frame_type, mvs, qps


def encode_residual_frame(residuals, block_size: int, numpy_repr: bool) -> str:
    """Twin of entropy_encoder_frame (Encoder.py:1522-1542)."""
    out = []
    for i, (split, res) in enumerate(residuals):
        if split == 0:
            s = "0'(" + str(rle_encode_block(np.asarray(res), numpy_repr)) + ")"
            out.append(s if i == 0 else ";" + s)
        else:
            parts = [str(rle_encode_block(np.asarray(sb), numpy_repr)) for sb in res]
            out.append(";1'(" + ",".join(parts) + ")")
    return "".join(out)


def encode_residual_frame_arrays(qtc_full, qtc_quads, split, numpy_repr: bool) -> str:
    """Residual line straight from device-shaped arrays (qtc_full (nb,bs,bs),
    qtc_quads (nb,4,sbs,sbs), split (nb,)) — C++ fast path when available
    (streamoptima_tpu/native), byte-identical Python fallback otherwise."""
    from streamoptima_tpu import native

    line = native.encode_residual_line(qtc_full, qtc_quads, split, numpy_repr)
    if line is not None:
        return line
    qf = np.asarray(qtc_full)
    qq = np.asarray(qtc_quads)
    sp = np.asarray(split)
    residuals = [
        (1, [qq[i, q] for q in range(4)]) if sp[i] else (0, qf[i]) for i in range(qf.shape[0])
    ]
    return encode_residual_frame(residuals, qf.shape[-1], numpy_repr)


def write_bitstream_arrays(path_mv, path_res, frame_types, per_frame, qp_per_row_per_frame, cfg, raw_mv_path=None):
    """transmit_bitstream twin that consumes the native engine's device-array
    package (``encode(package=False)``) directly — no list interchange, C++
    serialization for the residual lines."""
    from streamoptima_tpu import jax_engine, native

    nb = cfg.n_blocks
    with open(path_mv, "w") as fm, open(path_res, "w") as fr:
        if cfg.roi_qp_map is not None:
            fm.write(encode_roi_header(cfg.roi_qp_map, cfg.block_rows, cfg.blocks_per_row) + "\n")
        for i, out in enumerate(per_frame):
            ft = int(frame_types[i])
            line = native.encode_mv_line(
                ft, out["mv"], out["split"], out["sub_mv"],
                qp_per_row_per_frame[i], cfg.rc_active, cfg.blocks_per_row,
            )
            if line is None:  # no native lib: byte-identical Python twin
                mvs = jax_engine.mvs_to_list(out, ft, nb)
                line = encode_mv_frame(ft, mvs, qp_per_row_per_frame[i], cfg.rc_active, cfg.blocks_per_row)
            fm.write(str(ft) + "|" + line + "\n")
            fr.write(
                encode_residual_frame_arrays(out["qtc_full"], out["qtc_quads"], out["split"], cfg.bitstream_numpy_repr)
                + "\n"
            )
    if raw_mv_path is not None:
        with open(raw_mv_path, "w") as f:
            for i, out in enumerate(per_frame):
                ft = int(frame_types[i])
                f.write(str(ft) + "|" + str(jax_engine.mvs_to_list(out, ft, nb)) + "\n")


def decode_residual_frame(line: str, block_size: int):
    """Twin of entropy_decoder_frame (decoder.py:651-670)."""
    out = []
    for item in line.rstrip("\n").split(";"):
        split, body = item.split("'")
        if split == "0":
            out.append((0, np.array(rle_decode_block(_safe_eval(body), block_size))))
        else:
            subs = [np.array(rle_decode_block(b, block_size // 2)) for b in _safe_eval(body)]
            out.append((1, subs))
    return out


def mv_arrays_to_list(m: FrameMVArrays):
    """Array-form MV interchange -> the list format (the exact inverse of
    jax_engine.list_to_mvs_np's pass-through)."""
    sp = m.split.tolist()
    nb = len(sp)
    if m.ftype == 0:
        mv = m.mv[:, 0].tolist()
        smv = m.smv[:, :, 0].tolist()
        return [(1, smv[i]) if sp[i] else (0, mv[i]) for i in range(nb)]
    mvl = list(map(tuple, m.mv.tolist()))
    smvl = [[tuple(q) for q in b] for b in m.smv.tolist()]
    return [(1, smvl[i]) if sp[i] else (0, mvl[i]) for i in range(nb)]


def _mv_line(ft, m, qp_rows, cfg) -> str:
    """One MV-line body from either interchange form (native fast path for
    arrays; the two forms serialize byte-identically — the differential
    chain reads only each block's CHOSEN variant, which both carry)."""
    from streamoptima_tpu import native

    if isinstance(m, FrameMVArrays):
        line = native.encode_mv_line(ft, m.mv, m.split, m.smv, qp_rows,
                                     cfg.rc_active, cfg.blocks_per_row)
        if line is not None:
            return line
        m = mv_arrays_to_list(m)
    return encode_mv_frame(ft, m, qp_rows, cfg.rc_active, cfg.blocks_per_row)


def _res_line(r, cfg) -> str:
    if isinstance(r, FrameResArrays):
        return encode_residual_frame_arrays(r.qf, r.qq, r.split, cfg.bitstream_numpy_repr)
    return encode_residual_frame(r, cfg.block_size, cfg.bitstream_numpy_repr)


def write_bitstream(path_mv, path_res, frame_types, mvs_per_frame, qp_per_row_per_frame, residuals_per_frame, cfg, raw_mv_path=None):
    """Twin of transmit_bitstream (Encoder.py:1544-1573) with bug B1 fixed.

    Accepts either interchange form per frame (lists, or the FrameMVArrays /
    FrameResArrays the readers produce — so read -> write round-trips)."""
    with open(path_mv, "w") as fm, open(path_res, "w") as fr:
        if cfg.roi_qp_map is not None:
            fm.write(encode_roi_header(cfg.roi_qp_map, cfg.block_rows, cfg.blocks_per_row) + "\n")
        for i in range(len(frame_types)):
            ft = int(frame_types[i])
            fm.write(str(ft) + "|" + _mv_line(ft, mvs_per_frame[i], qp_per_row_per_frame[i], cfg) + "\n")
            fr.write(_res_line(residuals_per_frame[i], cfg) + "\n")
    if raw_mv_path is not None:
        with open(raw_mv_path, "w") as f:
            for i in range(len(frame_types)):
                m = mvs_per_frame[i]
                if isinstance(m, FrameMVArrays):
                    m = mv_arrays_to_list(m)
                f.write(str(int(frame_types[i])) + "|" + str(m) + "\n")


def read_bitstream(path_mv, path_res, cfg):
    """Twin of decode_differential_entropy (decoder.py:673-690).

    An ROI header (native extension) is reconciled with ``cfg`` in place: a
    cfg without a map adopts the stream's, a conflicting map raises.  NOTE
    engines cache the map at construction — (re)build the decoder from
    ``cfg`` AFTER this call (VideoCodec.decode_bitstream does).

    Frames parse through the native C++ parser when available (into
    FrameMVArrays / FrameResArrays — the Python text parse costs hundreds
    of ms per 720p frame on the host), falling back
    per line to the Python parser on unavailability or any anomaly (corrupt
    streams keep their loud list-path errors).  The compat engine indexes
    the list format directly, so ``cfg.compat`` keeps it."""
    from streamoptima_tpu import native

    frame_types = []
    mvs = []
    qps = []
    residuals = []
    stream_roi = None
    arrays = not cfg.compat and native.available()
    nb, nbc, nrows = cfg.n_blocks, cfg.blocks_per_row, cfg.block_rows
    with open(path_mv) as f:
        for line in f:
            if line.startswith(_ROI_PREFIX):
                stream_roi = decode_roi_header(line)
                continue
            r = native.parse_mv_line(line, cfg.rc_active, nbc, nb, nrows) if arrays else None
            if r is not None:
                ft, mv, sp, smv, qp = r
                mvs.append(FrameMVArrays(ft, mv, sp, smv))
            else:
                ft, mv, qp = decode_mv_frame(line, cfg.rc_active, nbc)
                mvs.append(mv)
            frame_types.append(ft)
            qps.append(qp)
    _reconcile_roi(stream_roi, cfg)
    with open(path_res) as f:
        for line in f:
            r = native.parse_residual_line(line, nb, cfg.block_size) if arrays else None
            if r is not None:
                residuals.append(FrameResArrays(*r))
            else:
                residuals.append(decode_residual_frame(line, cfg.block_size))
    return frame_types, mvs, qps, residuals
