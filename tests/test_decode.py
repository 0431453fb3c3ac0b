"""Inter-frame decode: the prediction gather (core/pred.gather_predictions,
the decoder.py:97-211 semantics) against a per-block loop oracle, and the
encode/decode closed loop through JaxCodec.decode and the sharded decoder
for multi-ref, rate control, ROI and fast-ME streams whose MVs exceed the
search range."""
import numpy as np
import pytest

import jax.numpy as jnp

from streamoptima_tpu import CodecConfig
from streamoptima_tpu.core import me as M
from streamoptima_tpu.core import pred as P
from streamoptima_tpu.jax_engine import JaxCodec

from conftest import synthetic_clip


def _grids(h, w, bs, sbs):
    nbr, nbc = h // bs, w // bs
    by, bx = np.meshgrid(np.arange(nbr) * bs, np.arange(nbc) * bs, indexing="ij")
    bx, by = bx.reshape(-1), by.reshape(-1)
    qx = np.stack([bx + dx for dy in (0, sbs) for dx in (0, sbs)], 1)
    qy = np.stack([by + dy for dy in (0, sbs) for dx in (0, sbs)], 1)
    return bx, by, qx, qy


def _loop_oracle(mvs, stack, xs, ys, n, fme):
    """Per-block restatement of the reference's three prediction cases
    (Encoder.py:432-460 / decoder.py:97-211): A = window (stride 2 under
    FME), B = FME margin failure -> all 128, C = contiguous stride-1 window
    zero-filled outside the frame."""
    H, W = stack.shape[-2:]
    s = 2 if fme else 1
    out = np.zeros((len(xs), n, n), np.int64)
    for b in range(len(xs)):
        dx, dy, r = (int(v) for v in mvs[b])
        px, py = s * int(xs[b]) + dx, s * int(ys[b]) + dy
        if 0 <= px < W - n and 0 <= py < H - n:
            if not fme:
                out[b] = stack[r, py:py + n, px:px + n]
            elif 0 <= px + 2 * n < W - n and 0 <= py + 2 * n < H - n:
                out[b] = stack[r, py:py + 2 * n:2, px:px + 2 * n:2]
            else:
                out[b] = 128
            continue
        for i in range(n):
            for j in range(n):
                y, x = py + i, px + j
                if 0 <= y < H and 0 <= x < W:
                    out[b, i, j] = stack[r, y, x]
    return out


@pytest.mark.parametrize("fme", [False, True])
@pytest.mark.parametrize("bound", [4, 80], ids=["in_range", "wide"])
def test_gather_predictions_matches_loop_oracle(fme, bound):
    """Random MVs within the search range and far beyond it (fast-ME MVP
    chains are unbounded), full blocks and VBS quads, two references."""
    rng = np.random.default_rng(7 + bound)
    h, w, bs, sbs, nref = 48, 64, 16, 8, 2
    refs = rng.integers(0, 256, (nref, h, w), dtype=np.uint8)
    stack = np.stack([M.fme_upsample(r, np, wrap_row_pass=True) for r in refs]) if fme \
        else refs.astype(np.int32)
    bx, by, qx, qy = _grids(h, w, bs, sbs)
    b = 2 * bound if fme else bound

    def rand_mv(n):
        return np.stack([rng.integers(-b, b + 1, n), rng.integers(-b, b + 1, n),
                         rng.integers(0, nref, n)], 1).astype(np.int32)

    for xs, ys, n in ((bx, by, bs), (qx.reshape(-1), qy.reshape(-1), sbs)):
        mv = rand_mv(len(xs))
        got = P.gather_predictions(jnp.asarray(mv), jnp.asarray(stack), jnp.asarray(xs),
                                   jnp.asarray(ys), n, fme, jnp)
        np.testing.assert_array_equal(np.asarray(got), _loop_oracle(mv, stack, xs, ys, n, fme))


def _roundtrip(cfg, clip):
    codec = JaxCodec(cfg, clip)
    pkg = codec.encode()
    dec = codec.decode(pkg["frame_type_seq"], pkg["approx residual"],
                       pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"])
    for i, (d, r) in enumerate(zip(dec, pkg["reconstructed frames"])):
        np.testing.assert_array_equal(np.asarray(d), r, err_msg=f"frame {i}")
    return pkg


@pytest.mark.parametrize("fme,vbs", [(False, False), (True, True)])
def test_decode_roundtrip(fme, vbs):
    """JaxCodec.decode reproduces the encoder's reconstructions bit-exactly."""
    clip = synthetic_clip(h=64, w=64, frames=5, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=5, qp=4, intra_dur=4, search_range=4,
                      vbs_enable=vbs, fme_enable=fme, engine="jax")
    _roundtrip(cfg, clip)


@pytest.mark.parametrize("tile_comm,fme", [("halo", False), ("halo", True),
                                           ("all_gather", True)])
def test_sharded_decode_fetch_matches_single_chip(tile_comm, fme):
    """Mesh decode (halo/all_gather bands) == encoder reconstruction."""
    from streamoptima_tpu.parallel import ShardedCodec, make_mesh

    clip = synthetic_clip(h=64, w=64, frames=6, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=6, search_range=4, qp=4, intra_dur=3,
                      vbs_enable=fme, fme_enable=fme)
    sc = ShardedCodec(cfg, make_mesh(cfg), clip, tile_comm=tile_comm)
    pkg = sc.encode()
    args = (pkg["frame_type_seq"], pkg["approx residual"],
            pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"])
    sharded = np.stack([np.asarray(f) for f in sc.decode(*args)])
    assert list(sc._decode_js) == [tile_comm]
    np.testing.assert_array_equal(sharded, pkg["reconstructed frames"])


def test_decode_with_rate_control():
    """Decode under RC (per-row QPs from the bitstream) reproduces the
    encoder's reconstructions (decoder.py:112-114 semantics)."""
    tables = [[99000, 60000, 40000, 26000, 17000, 11000, 7200, 4800, 3200, 2100, 1400, 950],
              [60000, 36000, 24000, 16000, 10000, 6600, 4400, 2900, 1900, 1300, 850, 560]]
    clip = synthetic_clip(h=64, w=64, frames=5, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=5, qp=4, intra_dur=4, search_range=4,
                      vbs_enable=True, fme_enable=True, lam=0.015,
                      rc_flag=1, target_br="640 kbps", frame_rate=30, qp_rate_tables=tables)
    _roundtrip(cfg, clip)


def test_decode_multi_ref():
    """Decode with a deep reference FIFO (n_ref_frames=3): the transmitted
    reference index must select the right reconstruction."""
    clip = synthetic_clip(h=64, w=64, frames=7, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=7, qp=4, intra_dur=7, search_range=4,
                      vbs_enable=True, fme_enable=True, lam=0.015,
                      n_ref_frames=3, engine="jax")
    pkg = _roundtrip(cfg, clip)
    # the encoder must actually have used refs beyond index 0 for the test
    # to bite
    refs_used = set()
    for frame_mvs in pkg["MVS per Frame"][2:]:
        for split, mv in frame_mvs:
            refs_used.update(q[2] for q in (mv if split else [mv]))
    assert refs_used - {0}, refs_used


def test_corrupt_residual_overflow_raises():
    """Coefficients beyond the int16 interchange bound (impossible in
    well-formed streams: |qtc| <= 4080) raise instead of wrapping."""
    from streamoptima_tpu.jax_engine import list_to_res_np

    good = [(0, [[0] * 16] * 16) for _ in range(4)]
    qf, qq = list_to_res_np(good, 4, 16, 8)
    assert qf.dtype == np.int16
    bad = list(good)
    blk = [[0] * 16 for _ in range(16)]
    blk[0][0] = 70000  # far beyond any real quantized coefficient
    bad[1] = (0, blk)
    with pytest.raises((OverflowError, ValueError)):
        list_to_res_np(bad, 4, 16, 8)


def test_decode_with_roi():
    """Decode under a ROI QP map (per-block QP offsets applied in
    _block_qps on both encode and decode) round-trips bit-exactly."""
    clip = synthetic_clip(h=64, w=64, frames=4, motion=2)
    nb = (64 // 16) * (64 // 16)
    roi = np.zeros(nb, np.int32)
    roi[: nb // 2] = -2  # better quality top half
    cfg = CodecConfig(height=64, width=64, frames=4, qp=5, intra_dur=4, search_range=4,
                      vbs_enable=True, fme_enable=True, lam=0.015, roi_qp_map=roi.tolist())
    _roundtrip(cfg, clip)


@pytest.mark.parametrize("fme", [False, True])
def test_wide_fetch_decode_roundtrip_fast_me(fme):
    """Facade decode of a fast-ME stream whose MVP chain walks beyond the
    search range reproduces the encoder's reconstructions bit-exactly."""
    # smooth vertical sinusoid panning 8px/frame with sr=2: its SAD gradient
    # walks the MVP chain far past the search range (same construction as
    # test_parallel.test_halo_decode_fast_me_large_motion)
    h, w, frames, pan = 128, 64, 4, 8
    y = np.arange(h + pan * frames)
    base = np.clip(128 + 100 * np.sin(2 * np.pi * y / 32.0), 0, 255)[:, None]
    rng = np.random.default_rng(3)
    tex = rng.integers(-8, 9, size=(h + pan * frames, w))
    sheet = np.clip(base + tex, 0, 255).astype(np.uint8)
    clip = np.stack([sheet[i * pan : i * pan + h] for i in range(frames)])
    cfg = CodecConfig(height=h, width=w, frames=frames, qp=3, intra_dur=frames,
                      search_range=2, vbs_enable=fme, fme_enable=fme, fast_me=True,
                      engine="jax")
    pkg = _roundtrip(cfg, clip)
    # the stream must actually exceed the search-range bound somewhere
    big = max(
        abs(m[1][1])
        for ft, mvs in zip(pkg["frame_type_seq"], pkg["MVS per Frame"]) if ft == 1
        for m in mvs if m[0] == 0
    )
    assert big > (2 * cfg.search_range if fme else cfg.search_range), big
