"""Multi-chip sharded encoder: bit-parity with the single-chip native engine.

Runs on the 8-virtual-device CPU mesh configured in conftest.py.  The sharded
GOP/tile encoder (parallel/mesh.py) must produce bit-identical MVs, splits,
coefficients and reconstructions to JaxCodec for every supported feature
combination (full-search ME; the sharded path's exactness claim).
"""
import numpy as np
import pytest

import jax

from streamoptima_tpu.config import CodecConfig
from streamoptima_tpu.jax_engine import JaxCodec
from streamoptima_tpu.parallel import ShardedCodec, make_mesh

from conftest import synthetic_clip


def _compare_packages(a, b, check_psnr=True):
    assert a["frame_type_seq"] == b["frame_type_seq"]
    assert a["residual size per frame"] == b["residual size per frame"]
    np.testing.assert_array_equal(a["reconstructed frames"], b["reconstructed frames"])
    for fa, fb in zip(a["MVS per Frame"], b["MVS per Frame"]):
        assert fa == fb
    for fa, fb in zip(a["approx residual"], b["approx residual"]):
        for (sa, ra), (sb, rb) in zip(fa, fb):
            assert sa == sb
            if sa == 0:
                np.testing.assert_array_equal(np.asarray(ra), np.asarray(rb))
            else:
                for x, y in zip(ra, rb):
                    np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    if check_psnr:
        np.testing.assert_allclose(a["PSNR per frame"], b["PSNR per frame"], rtol=1e-4)


CASES = [
    dict(),  # plain: full search, no VBS/FME
    dict(vbs_enable=True, lam=0.015),
    dict(fme_enable=True),
    dict(vbs_enable=True, fme_enable=True, lam=0.015),
    dict(n_ref_frames=3),
    dict(
        rc_flag=1,
        target_br="640 kbps",
        frame_rate=30,
        qp_rate_tables=[[99000, 60000, 40000, 26000, 17000, 11000, 7200, 4800, 3200, 2100, 1400, 950], [60000, 36000, 24000, 16000, 10000, 6600, 4400, 2900, 1900, 1300, 850, 560]],
    ),
    # fast-ME: the raster-sequential MVP chain crosses tile boundaries; the
    # mesh solves it as a global Jacobi fixpoint (ppermute of each tile's
    # last MV per sweep) — must stay bit-identical to the single-chip chain
    dict(fast_me=True),
    dict(fast_me=True, vbs_enable=True, fme_enable=True, lam=0.015),
    dict(fast_me=True, n_ref_frames=3),
    # segmented rowscan (fast_me_seg_mult=2): sub-row chain segments on both
    # engines — the solve must not depend on the segmentation
    dict(fast_me=True, vbs_enable=True, fme_enable=True, lam=0.015,
         fast_me_seg_mult=2),
    # clamped-dynamic-slice window fetch + explicit lookahead (the large-
    # plane production path, forced at this small size) on both engines
    dict(fast_me=True, vbs_enable=True, fme_enable=True, lam=0.015,
         fast_me_fetch="slice", fast_me_lookahead=2),
    # the same with the one-hot gather fetch and a 4-column lookahead
    dict(fast_me=True, vbs_enable=True, fme_enable=True, lam=0.015,
         fast_me_fetch="xla", fast_me_lookahead=4),
]


@pytest.mark.parametrize("extra", CASES, ids=[",".join(sorted(c)) or "plain" for c in CASES])
def test_sharded_matches_single_chip(extra):
    clip = synthetic_clip(h=64, w=64, frames=6, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=6, block_size=16, search_range=4, qp=3, intra_dur=3, **extra)
    single = JaxCodec(cfg, clip).encode()
    mesh = make_mesh(cfg)  # 8 devices -> tile=4 (nbr=4), data=2
    assert mesh.devices.shape == (2, 4)
    sharded = ShardedCodec(cfg, mesh, clip).encode()
    _compare_packages(single, sharded)


def test_sharded_roi():
    clip = synthetic_clip(h=64, w=64, frames=4, motion=1)
    roi = np.zeros((4, 4), dtype=np.int32)
    roi[1:3, 1:3] = -2  # better quality in the middle
    cfg = CodecConfig(height=64, width=64, frames=4, search_range=4, qp=5, intra_dur=2, roi_qp_map=roi)
    single = JaxCodec(cfg, clip).encode()
    sharded = ShardedCodec(cfg, make_mesh(cfg), clip).encode()
    _compare_packages(single, sharded)


def test_sharded_decodes_with_single_chip_decoder():
    """Packages from the sharded encoder must round-trip through the
    single-chip decoder (the encode/decode closed-loop invariant)."""
    clip = synthetic_clip(h=64, w=64, frames=4, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=4, search_range=4, qp=4, intra_dur=2, vbs_enable=True, lam=0.02)
    pkg = ShardedCodec(cfg, make_mesh(cfg), clip).encode()
    dec = JaxCodec(cfg)
    frames = dec.decode(
        pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"]
    )
    np.testing.assert_array_equal(np.stack(frames), pkg["reconstructed frames"])


def test_uneven_tail_and_gop_padding():
    """frames not divisible by intra_dur or by the data axis still encode."""
    clip = synthetic_clip(h=64, w=64, frames=5, motion=1)
    cfg = CodecConfig(height=64, width=64, frames=5, search_range=4, qp=4, intra_dur=3)
    single = JaxCodec(cfg, clip).encode()
    sharded = ShardedCodec(cfg, make_mesh(cfg), clip).encode()
    _compare_packages(single, sharded)


def test_make_mesh_factorization():
    cfg = CodecConfig(height=96, width=64, frames=2, search_range=2)  # nbr=6
    mesh = make_mesh(cfg)  # 8 devices, nbr=6 -> tile=2, data=4
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("data", "tile")


@pytest.mark.parametrize("tile", [2, 4])
def test_halo_equals_all_gather(tile):
    """The ppermute halo exchange and the all_gather tile paths must be
    bit-identical (same search/prediction semantics via global-coordinate
    validity), including under FME + VBS + multi-ref."""
    clip = synthetic_clip(h=64, w=64, frames=5, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=5, search_range=4, qp=4, intra_dur=3,
                      vbs_enable=True, fme_enable=True, lam=0.015, n_ref_frames=2)
    mesh = make_mesh(cfg, tile=tile)
    a = ShardedCodec(cfg, mesh, clip, tile_comm="halo").encode()
    b = ShardedCodec(cfg, mesh, clip, tile_comm="all_gather").encode()
    _compare_packages(a, b)


def test_sharded_accepts_two_pass():
    """Two-pass RC became a sharded feature in round 2 (it was guarded off in
    round 1); construction must succeed."""
    cfg = CodecConfig(height=64, width=64, frames=2, search_range=2, two_pass=True,
                      rc_flag=1, target_br="100 kbps",
                      qp_rate_tables=[[9000, 4000, 2000, 1100, 800, 600, 450, 350, 280, 230, 200, 180]] * 2)
    ShardedCodec(cfg, make_mesh(cfg))


def test_dryrun_multichip_fresh_process():
    """__graft_entry__.dryrun_multichip runs in a fresh process where no
    CPU-forcing env vars are set (a GPU may own the default backend) — the
    entry point must force the 8-virtual-device CPU platform itself."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    r = subprocess.run(
        [sys.executable, "-c", "import __graft_entry__ as g; g.dryrun_multichip(8)"],
        cwd=str(Path(__file__).resolve().parent.parent),
        env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "dryrun ok" in r.stdout


def test_sharded_fast_me_warm_start_parity():
    """The GOP scan warm-starts each frame's Jacobi solve from the previous
    frame's converged guesses; the fixpoint is unique, so a long GOP with a
    discontinuous motion field must still match the single-chip chain
    bit-for-bit (this exercises many warm-started solves in one scan)."""
    rng = np.random.default_rng(5)
    clip = rng.integers(0, 256, size=(8, 128, 64), dtype=np.uint8)  # noise: worst case
    cfg = CodecConfig(height=128, width=64, frames=8, block_size=16, search_range=4,
                      qp=2, intra_dur=8, fast_me=True, n_ref_frames=2)
    single = JaxCodec(cfg, clip).encode()
    mesh = make_mesh(cfg)  # nbr=8, 8 devices -> tile=8
    assert mesh.devices.shape[1] > 1
    sharded = ShardedCodec(cfg, mesh, clip).encode()
    _compare_packages(single, sharded)


@pytest.mark.parametrize("h", [64, 128, 256])
@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("sr", [4, 16, 31])
def test_make_mesh_halo_always_fits(h, ndev, sr):
    """Property: every auto-selected mesh satisfies halo <= band height, so
    the encoder never trips the trace-time halo assert (round-1 VERDICT
    item 6: h=128, 8 devices, sr=16 used to pick tile=8 and crash)."""
    cfg = CodecConfig(height=h, width=64, frames=2, search_range=sr)
    mesh = make_mesh(cfg, devices=jax.devices()[:ndev])
    tile = mesh.devices.shape[1]
    assert tile == 1 or sr + 1 <= (cfg.block_rows // tile) * cfg.block_size
    clip = synthetic_clip(h=h, w=64, frames=2)
    pkg = ShardedCodec(cfg, mesh, clip).encode(fetch="metrics")
    assert len(pkg["PSNR per frame"]) == 2


@pytest.mark.parametrize("extra", [
    dict(),
    dict(vbs_enable=True, fme_enable=True, lam=0.015, n_ref_frames=2),
    dict(rc_flag=1, target_br="640 kbps", frame_rate=30,
         qp_rate_tables=[[99000, 60000, 40000, 26000, 17000, 11000, 7200, 4800, 3200, 2100, 1400, 950],
                         [60000, 36000, 24000, 16000, 10000, 6600, 4400, 2900, 1900, 1300, 850, 560]]),
], ids=["plain", "vbs_fme_nref2", "rc1"])
def test_sharded_decode_matches_single_chip(extra):
    """Sharded decode == single-chip decode == encoder reconstruction
    (round-1 VERDICT item 4).  Reference decode loop: decoder.py:487-545."""
    clip = synthetic_clip(h=64, w=64, frames=6, motion=2)
    cfg = CodecConfig(height=64, width=64, frames=6, search_range=4, qp=4, intra_dur=3, **extra)
    sc = ShardedCodec(cfg, make_mesh(cfg), clip)
    pkg = sc.encode()
    args = (pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"], pkg["MVS per Frame"])
    sharded = np.stack([np.asarray(f) for f in sc.decode(*args)])
    single = np.stack([np.asarray(f) for f in JaxCodec(cfg).decode(*args)])
    np.testing.assert_array_equal(sharded, single)
    np.testing.assert_array_equal(sharded, pkg["reconstructed frames"])


def test_sharded_decode_rejects_bad_gop_opener():
    """Mid-GOP intra (scene promotion) is accepted, but a GOP that does NOT
    open intra would carry reference state across the sharded "data" axis —
    still rejected loudly."""
    cfg = CodecConfig(height=64, width=64, frames=4, search_range=2, intra_dur=2)
    sc = ShardedCodec(cfg, make_mesh(cfg))
    with pytest.raises(ValueError):
        # frame 2 opens GOP 2 (2 % intra_dur == 0) but claims inter
        sc.decode([0, 1, 1, 1], [[]] * 4, [[]] * 4, [[]] * 4)


def _scene_cut_clip(h, w, frames, cut):
    """Static clip with a hard scene change at frame `cut` — residual-size
    strings carry ~13 chars of per-block floor, so static inter frames sit
    near that floor (~3330 @64x64) while the cut frame's real content pushes
    past it (~4160); intra_thresh between the two promotes exactly the cut."""
    a = synthetic_clip(h=h, w=w, frames=1, seed=42)[0]
    b = synthetic_clip(h=h, w=w, frames=1, seed=1234)[0]
    return np.stack([a] * cut + [b] * (frames - cut))


RC_TABLES = [[99000, 60000, 40000, 26000, 17000, 11000, 7200, 4800, 3200, 2100, 1400, 950],
             [60000, 36000, 24000, 16000, 10000, 6600, 4400, 2900, 1900, 1300, 850, 560]]


def test_sharded_promotion_matches_single_chip():
    """Scene-change promotion (RCFlag>1, Encoder.py:1851-1856) on the mesh:
    the cut sits mid-GOP in the second GOP only, so the data-parallel batch
    has one promoting GOP and one that doesn't — exercising the per-GOP
    select and the per-GOP reference-FIFO reset."""
    h, w, frames = 64, 64, 6
    clip = _scene_cut_clip(h, w, frames, cut=4)
    cfg = CodecConfig(height=h, width=w, frames=frames, search_range=4, qp=4,
                      intra_dur=3, rc_flag=2, target_br="100 mbps", frame_rate=30,
                      qp_rate_tables=RC_TABLES, intra_thresh=3800)
    single = JaxCodec(cfg, clip).encode()
    # the cut frame must actually promote, and not everything may promote
    assert single["frame_type_seq"][4] == 0
    assert single["frame_type_seq"][1] == 1
    sc = ShardedCodec(cfg, make_mesh(cfg), clip)
    sharded = sc.encode()
    _compare_packages(single, sharded)
    assert single["Qp_per_row_per_frame"] == sharded["Qp_per_row_per_frame"]
    # sharded decode of the promoted stream (frame-type-driven per-frame steps)
    args = (sharded["frame_type_seq"], sharded["approx residual"],
            sharded["Qp_per_row_per_frame"], sharded["MVS per Frame"])
    dec = np.stack([np.asarray(f) for f in sc.decode(*args)])
    np.testing.assert_array_equal(dec, np.stack(sharded["reconstructed frames"]))


def test_sharded_intra_mode1_matches_single_chip():
    """intra_mode=1 (native-only; reference bug B2) on the mesh: the vertical
    chain spans all row tiles, so make_mesh forces tile=1 and the 'data' (GOP)
    axis carries all the parallelism — bitwise vs single-chip (VERDICT r2
    item 8)."""
    from conftest import smooth_clip
    clip = smooth_clip(h=48, w=64, frames=4, motion=2)
    cfg = CodecConfig(height=48, width=64, frames=4, search_range=4, qp=4,
                      intra_dur=2, intra_mode=1)
    mesh = make_mesh(cfg)
    assert mesh.devices.shape == (8, 1)
    with pytest.raises(ValueError):
        make_mesh(cfg, tile=2)
    single = JaxCodec(cfg, clip).encode()
    sc = ShardedCodec(cfg, mesh, clip)
    sharded = sc.encode()
    _compare_packages(single, sharded)
    args = (sharded["frame_type_seq"], sharded["approx residual"],
            sharded["Qp_per_row_per_frame"], sharded["MVS per Frame"])
    dec = np.stack([np.asarray(f) for f in sc.decode(*args)])
    np.testing.assert_array_equal(dec, np.stack(sharded["reconstructed frames"]))


def test_sharded_promotion_two_pass():
    """Promotion composes with two-pass RC on the mesh (both ride the same
    per-frame-step path): bitwise vs single-chip."""
    h, w, frames = 64, 64, 6
    clip = _scene_cut_clip(h, w, frames, cut=4)
    cfg = CodecConfig(height=h, width=w, frames=frames, search_range=4, qp=4,
                      intra_dur=3, rc_flag=2, target_br="100 mbps", frame_rate=30,
                      qp_rate_tables=RC_TABLES, intra_thresh=3800, two_pass=True)
    single = JaxCodec(cfg, clip).encode()
    assert 0 in single["frame_type_seq"][1:]
    sharded = ShardedCodec(cfg, make_mesh(cfg), clip).encode()
    _compare_packages(single, sharded)
    assert single["Qp_per_row_per_frame"] == sharded["Qp_per_row_per_frame"]


def test_sharded_two_pass_matches_single_chip():
    """Mesh two-pass RC == single-chip two-pass, bitwise (round-1 VERDICT
    item 8; README.md:13's promised consumer of the first-pass row stats)."""
    clip = synthetic_clip(h=64, w=64, frames=6, motion=2)
    tables = [[99000, 60000, 40000, 26000, 17000, 11000, 7200, 4800, 3200, 2100, 1400, 950],
              [60000, 36000, 24000, 16000, 10000, 6600, 4400, 2900, 1900, 1300, 850, 560]]
    cfg = CodecConfig(height=64, width=64, frames=6, search_range=4, qp=4, intra_dur=3,
                      vbs_enable=True, lam=0.015, two_pass=True, rc_flag=1,
                      target_br="640 kbps", frame_rate=30, qp_rate_tables=tables)
    single = JaxCodec(cfg, clip).encode()
    sharded = ShardedCodec(cfg, make_mesh(cfg), clip).encode()
    _compare_packages(single, sharded)
    assert single["Qp_per_row_per_frame"] == sharded["Qp_per_row_per_frame"]


def test_halo_decode_fast_me_large_motion():
    """ADVICE r2 (high): a mesh-encoded fast-ME stream whose MVP chain walked
    beyond search_range must decode correctly in tile_comm='halo' mode — the
    sr+1 halo band cannot serve such MVs (gather_predictions would clamp the
    reads), so decode() must detect the stream's MV range and use the
    all_gather band instead.  Encode already forces all_gather for the same
    reason (mesh.py _inter_tile)."""
    h, w, frames, pan = 128, 64, 4, 8
    y = np.arange(h + pan * frames)
    base = np.clip(128 + 100 * np.sin(2 * np.pi * y / 32.0), 0, 255)[:, None]
    rng = np.random.default_rng(3)
    tex = rng.integers(-8, 9, size=(h + pan * frames, w))
    sheet = np.clip(base + tex, 0, 255).astype(np.uint8)
    clip = np.stack([sheet[i * pan : i * pan + h] for i in range(frames)])
    cfg = CodecConfig(height=h, width=w, frames=frames, search_range=2, qp=3,
                      intra_dur=frames, fast_me=True)
    mesh = make_mesh(cfg)
    assert mesh.devices.shape[1] > 1
    sc = ShardedCodec(cfg, mesh, clip, tile_comm="halo")
    pkg = sc.encode()
    # the stream must actually exceed the halo bound, else this test is vacuous
    max_dy = max(
        abs(m[1][1])
        for ft, mvs in zip(pkg["frame_type_seq"], pkg["MVS per Frame"]) if ft == 1
        for m in mvs if m[0] == 0
    )
    assert max_dy > cfg.search_range, "clip failed to drive the MVP chain past sr"
    args = (pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"],
            pkg["MVS per Frame"])
    halo_dec = np.stack([np.asarray(f) for f in sc.decode(*args)])
    np.testing.assert_array_equal(halo_dec, pkg["reconstructed frames"])


def test_mesh_wide_fetch_decode_fast_me():
    """Mesh decode of a fast-ME stream whose MVP chain walked beyond
    search_range (both axes): the decoder downgrades the halo band to the
    all_gather band and reproduces the encoder bit-exactly."""
    h, w, frames, pan = 128, 64, 4, 8
    y = np.arange(h + pan * frames)
    base = np.clip(128 + 100 * np.sin(2 * np.pi * y / 32.0), 0, 255)[:, None]
    rng = np.random.default_rng(3)
    tex = rng.integers(-8, 9, size=(h + pan * frames, w))
    sheet = np.clip(base + tex, 0, 255).astype(np.uint8)
    clip = np.stack([sheet[i * pan : i * pan + h] for i in range(frames)])
    cfg = CodecConfig(height=h, width=w, frames=frames, search_range=2, qp=3,
                      intra_dur=frames, fast_me=True)
    mesh = make_mesh(cfg)
    sc = ShardedCodec(cfg, mesh, clip, tile_comm="halo")
    pkg = sc.encode()
    mvs = np.concatenate([
        np.array([m[1] for m in f_mvs if m[0] == 0], np.int32).reshape(-1, 3)
        for ft, f_mvs in zip(pkg["frame_type_seq"], pkg["MVS per Frame"]) if ft == 1])
    assert np.abs(mvs[:, :2]).max() > cfg.search_range, "stream must exceed the search range"
    args = (pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"],
            pkg["MVS per Frame"])
    dec = np.stack([np.asarray(f) for f in sc.decode(*args)])
    np.testing.assert_array_equal(dec, pkg["reconstructed frames"])
    # |dy| beyond the halo: the all_gather decode program was the one built
    assert list(sc._decode_js) == ["all_gather"], sc._decode_js.keys()


def test_mesh_wide_fetch_decode_fast_me_horizontal():
    """dx-wide fast-ME stream (horizontal pan; |dy| within the halo) on a
    multi-tile HALO mesh: row bands are full width, so the halo decode serves
    any dx — the decoder must stay on the halo band and stay bit-exact."""
    h, w, frames, pan = 128, 96, 4, 8
    x = np.arange(w + pan * frames)
    rng = np.random.default_rng(4)
    # horizontally textured, vertically ANCHORED content (a static vertical
    # ramp + per-column noise constant along y): the pan is pure dx, so the
    # MVP chain walks wide horizontally while dy stays within the halo —
    # exactly the case the dy-only downgrade scan used to miss
    tex = rng.integers(-10, 11, size=w + pan * frames)
    base = (60 * np.sin(2 * np.pi * x / 32.0) + tex)[None, :]
    anchor = 50 * np.sin(2 * np.pi * np.arange(h) / 16.0)[:, None]
    sheet = np.clip(128 + base + anchor, 0, 255).astype(np.uint8)
    clip = np.stack([sheet[:, i * pan : i * pan + w] for i in range(frames)])
    cfg = CodecConfig(height=h, width=w, frames=frames, search_range=2, qp=3,
                      intra_dur=frames, fast_me=True)
    mesh = make_mesh(cfg)
    sc = ShardedCodec(cfg, mesh, clip, tile_comm="halo")
    assert sc.ntile > 1, "needs a real multi-tile halo mesh"
    pkg = sc.encode()
    mvs = [np.array([m[1] for m in f_mvs if m[0] == 0], np.int32).reshape(-1, 3)
           for ft, f_mvs in zip(pkg["frame_type_seq"], pkg["MVS per Frame"]) if ft == 1]
    allmv = np.concatenate(mvs)
    assert np.abs(allmv[:, 0]).max() > cfg.search_range, "stream must be dx-wide"
    assert np.abs(allmv[:, 1]).max() <= cfg.search_range, "dy must stay halo-narrow"
    args = (pkg["frame_type_seq"], pkg["approx residual"], pkg["Qp_per_row_per_frame"],
            pkg["MVS per Frame"])
    dec = np.stack([np.asarray(f) for f in sc.decode(*args)])
    np.testing.assert_array_equal(dec, pkg["reconstructed frames"])
    assert list(sc._decode_js) == ["halo"], sc._decode_js.keys()
