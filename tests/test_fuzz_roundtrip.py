"""Randomized-config closed-loop fuzz: encode -> bitstream text -> parse ->
decode must reproduce the encoder's reconstructions bit-exactly for every
feature combination (the decoder.py:487-545 contract), and the package's
scalar metadata must survive the text round trip.

Seeded, so failures reproduce; dims stay small.
"""
import dataclasses
import os

import numpy as np
import pytest

from streamoptima_tpu import CodecConfig
from streamoptima_tpu import bitstream as BS
from streamoptima_tpu.jax_engine import JaxCodec

from conftest import synthetic_clip

TABLES = [[99000, 60000, 40000, 26000, 17000, 11000, 7200, 4800, 3200, 2100, 1400, 950],
          [60000, 36000, 24000, 16000, 10000, 6600, 4400, 2900, 1900, 1300, 850, 560]]


def _random_cfg(rng):
    h = int(rng.choice([32, 48, 64, 80]))
    w = int(rng.choice([32, 64, 96]))
    frames = int(rng.integers(3, 7))
    vbs = bool(rng.integers(0, 2))
    fme = bool(rng.integers(0, 2))
    rc = bool(rng.integers(0, 3) == 0)
    kw = dict(
        height=h, width=w, frames=frames,
        qp=int(rng.integers(0, 7)),
        intra_dur=int(rng.choice([2, 3, frames])),
        search_range=int(rng.choice([2, 4, 8])),
        vbs_enable=vbs, fme_enable=fme,
        fast_me=bool(rng.integers(0, 2)),
        n_ref_frames=int(rng.integers(1, 4)),
        me_search=str(rng.choice(["auto", "auto", "fused", "materialized"])),
        engine="jax",
    )
    if vbs:
        kw["lam"] = float(rng.choice([0.0, 0.015, 0.3]))
    if rc:
        kw.update(rc_flag=1, target_br="480 kbps", frame_rate=30, qp_rate_tables=TABLES)
    if rng.integers(0, 3) == 0:  # ROI: random per-block QP offsets in the stream
        kw["roi_qp_map"] = rng.integers(-3, 4, size=(h // 16, w // 16)).astype(np.int32)
    return CodecConfig(**kw)


@pytest.mark.parametrize("seed", range(10))
def test_random_config_roundtrip(seed, tmp_path):
    rng = np.random.default_rng(1000 + seed)
    cfg = _random_cfg(rng)
    clip = synthetic_clip(cfg.height, cfg.width, cfg.frames,
                          motion=int(rng.integers(1, 4)), seed=seed)
    codec = JaxCodec(cfg, clip)
    pkg = codec.encode()

    mv_p, res_p = str(tmp_path / "mv.txt"), str(tmp_path / "res.txt")
    BS.write_bitstream(mv_p, res_p, pkg["frame_type_seq"], pkg["MVS per Frame"],
                       pkg["Qp_per_row_per_frame"], pkg["approx residual"], cfg)
    # read with a BARE cfg (no roi_qp_map): ROI streams must be
    # self-describing via the MV-file header (round-2 VERDICT item 5)
    import dataclasses

    bare = dataclasses.replace(cfg, roi_qp_map=None)
    fts, mvs, qps, res = BS.read_bitstream(mv_p, res_p, bare)
    assert fts == pkg["frame_type_seq"], cfg
    dec = JaxCodec(bare).decode(fts, res, qps, mvs)
    for i, (d, r) in enumerate(zip(dec, pkg["reconstructed frames"])):
        np.testing.assert_array_equal(np.asarray(d), r, err_msg=f"seed {seed} frame {i} cfg {cfg}")

    # the binary container must carry the identical stream: write from the
    # text-parsed interchange, read with another bare cfg, decode bit-exact
    from streamoptima_tpu import binstream as BIN

    bin_p = str(tmp_path / "clip.sob")
    BIN.write_binary(bin_p, fts, mvs, qps, res, bare)
    bare2 = dataclasses.replace(cfg, roi_qp_map=None)
    fts2, mvs2, qps2, res2 = BIN.read_binary(bin_p, bare2)
    assert fts2 == fts and qps2 == [list(q) for q in qps]
    dec2 = JaxCodec(bare2).decode(fts2, res2, qps2, mvs2)
    for i, (d, r) in enumerate(zip(dec2, pkg["reconstructed frames"])):
        np.testing.assert_array_equal(np.asarray(d), r,
                                      err_msg=f"binary seed {seed} frame {i} cfg {cfg}")


@pytest.mark.parametrize("seed", range(6))
def test_random_config_mesh_matches_single_chip(seed):
    """Random GOP-regular configs on the 8-virtual-device mesh: sharded
    encode must match the single-chip engine package bitwise, and sharded
    decode must reproduce the reconstructions."""
    from streamoptima_tpu.parallel import ShardedCodec, make_mesh

    rng = np.random.default_rng(2000 + seed)
    h = int(rng.choice([48, 64, 96]))
    w = int(rng.choice([32, 64]))
    frames = int(rng.integers(4, 8))
    gop = int(rng.choice([2, 4]))
    vbs = bool(rng.integers(0, 2))
    kw = dict(
        height=h, width=w, frames=frames, qp=int(rng.integers(1, 6)),
        intra_dur=gop, search_range=int(rng.choice([2, 4])),
        vbs_enable=vbs, fme_enable=bool(rng.integers(0, 2)),
        fast_me=bool(rng.integers(0, 2)),
        n_ref_frames=int(rng.integers(1, 3)),
        me_search=str(rng.choice(["fused", "materialized", "fused"])),
    )
    if vbs:
        kw["lam"] = 0.015
    cfg = CodecConfig(**kw)
    clip = synthetic_clip(h, w, frames, motion=int(rng.integers(1, 3)), seed=seed)
    tile_comm = str(rng.choice(["halo", "all_gather"]))
    sc = ShardedCodec(cfg, make_mesh(cfg), clip, tile_comm=tile_comm)
    sharded = sc.encode()
    single = JaxCodec(dataclasses.replace(cfg, me_search="fused"), clip).encode()
    np.testing.assert_array_equal(
        sharded["reconstructed frames"], single["reconstructed frames"],
        err_msg=f"seed {seed} cfg {cfg} tile_comm {tile_comm}",
    )
    assert sharded["MVS per Frame"] == single["MVS per Frame"]
    args = (sharded["frame_type_seq"], sharded["approx residual"],
            sharded["Qp_per_row_per_frame"], sharded["MVS per Frame"])
    dec = np.stack([np.asarray(f) for f in sc.decode(*args)])
    np.testing.assert_array_equal(dec, sharded["reconstructed frames"],
                                  err_msg=f"seed {seed} decode")
