"""core/fastme.py vs the established oracles: the one-hot window gather +
batched eval9/confirm must reproduce me.fast_candidates (per-block 3x3
search), me.fast_quads_sweep (VBS quads at the block MVP) and
pred.gather_predictions (winner predictions incl. the FME g1/g2/128 branch
semantics) bit-exactly, including wild/out-of-frame MVPs (K8 fallbacks)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from streamoptima_tpu.core import fastme as FM
from streamoptima_tpu.core import me as M
from streamoptima_tpu.core import pred as P


def _setup(fme, nref=2, h=64, w=96, bs=16, seed=0):
    rng = np.random.default_rng(seed)
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    refs = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    ys, xs = np.meshgrid(np.arange(nbr) * bs, np.arange(nbc) * bs, indexing="ij")
    bx, by = xs.reshape(-1), ys.reshape(-1)
    scale = 2 if fme else 1
    # guesses: mostly small, some huge/wild (K8 fallback territory), some
    # exactly at frame edges, random parities
    g = rng.integers(-6, 7, (nb, 3))
    g[:, 2] = rng.integers(0, nref, nb)
    g[3] = [5000, -4000, 0]
    g[7] = [-2 * w, 2 * h, nref - 1]
    g[11] = [scale * (w - bs) - scale * bx[11], 0, 0]  # right edge
    g[15] = [0, -scale * by[15], 0]                     # top edge exactly
    return cur, refs, jnp.asarray(bx), jnp.asarray(by), jnp.asarray(g.astype(np.int32)), (nbr, nbc)


@pytest.mark.parametrize("fme", [False, True])
def test_eval9_matches_fast_candidates(fme):
    cur, refs, bx, by, g, (nbr, nbc) = _setup(fme)
    h, w = cur.shape
    bs = 16
    scale = 2 if fme else 1
    n = bs
    pad = scale * (n - 1) + 3
    if fme:
        sref = jax.vmap(lambda r: M.fme_upsample(r.astype(jnp.int32), jnp, wrap_row_pass=True))(
            jnp.asarray(refs)
        )
    else:
        sref = jnp.asarray(refs).astype(jnp.int32)
    dims = sref.shape[-2:]
    refs_pad = jnp.pad(sref, ((0, 0), (pad, pad), (pad, pad)))
    cur_b = jnp.asarray(cur).reshape(nbr, bs, nbc, bs).swapaxes(1, 2).reshape(-1, bs, bs)
    X, Y = (bx * scale).astype(jnp.int32), (by * scale).astype(jnp.int32)
    mv_ref, sad_ref = M.fast_sweep(cur_b, X, Y, refs_pad, pad, dims, n, fme, g)

    planes = FM.plane_stack(jnp.asarray(refs), fme, jnp)
    by0, bx0 = FM._region_base(g, by, bx, n, fme, jnp)
    win = FM.window_gather(planes, by0, bx0, n + 2, jnp)
    mv, sad = FM.eval9(win, cur_b, g, X, Y, n, tuple(int(d) for d in dims), fme, None, jnp)
    np.testing.assert_array_equal(np.asarray(mv), np.asarray(mv_ref))
    np.testing.assert_array_equal(np.asarray(sad), np.asarray(sad_ref))


@pytest.mark.parametrize("fme", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_eval_chain_matches_sequential_eval9(fme, k):
    """The speculative lookahead step (one wide window per segment, candidate
    SAD grids from static slices, traced-select resolve) must reproduce the
    sequential per-column eval9 chain bit-exactly for every k — including K8
    fallbacks mid-chain (wild seeds), edge seeds, multi-ref, and padding
    columns (colmask False -> the MVP propagates unchanged)."""
    cur, refs, bx, by, g, (nbr, nbc) = _setup(fme, seed=3)
    bs = 16
    scale = 2 if fme else 1
    n = bs
    planes = FM.plane_stack(jnp.asarray(refs), fme, jnp)
    dims = (2 * cur.shape[0] - 1, 2 * cur.shape[1] - 1) if fme else cur.shape
    cur_b = jnp.asarray(cur).reshape(nbr, bs, nbc, bs).swapaxes(1, 2).reshape(-1, bs, bs)
    # chain segments = block rows; seeds = column-0 guesses from _setup
    S = nbr
    seeds = g.reshape(nbr, nbc, 3)[:, 0]
    curT = cur_b.reshape(nbr, nbc, n, n).swapaxes(0, 1)  # (L, S, n, n)
    xsT = jnp.asarray(bx).reshape(nbr, nbc).swapaxes(0, 1).astype(jnp.int32)
    ys = jnp.asarray(by).reshape(nbr, nbc)[:, 0].astype(jnp.int32)

    # oracle: per-column eval9 forward substitution
    gg = seeds
    mv_seq = []
    for j in range(nbc):
        by0, bx0 = FM._region_base(gg, ys, xsT[j], n, fme, jnp)
        win = FM.window_gather(planes, by0, bx0, n + 2, jnp)
        mv, _ = FM.eval9(win, curT[j], gg, xsT[j] * scale, ys * scale, n,
                         dims, fme, None, jnp)
        mv_seq.append(np.asarray(mv))
        gg = mv

    # lookahead: chunks of k columns with a padded tail
    Lp = -(-nbc // k)
    padc = Lp * k - nbc
    curK = jnp.concatenate([curT, jnp.zeros((padc, S, n, n), curT.dtype)])
    xsK = jnp.concatenate([xsT, jnp.broadcast_to(xsT[-1:], (padc, S))])
    wr, wc = FM.wide_window_spec(n, k, fme)
    gg = seeds
    mv_la = []
    for c in range(Lp):
        cm = jnp.asarray((np.arange(c * k, (c + 1) * k) < nbc))
        by0, bx0 = FM._wide_base(gg, ys, xsK[c * k], k, fme, jnp)
        wide = FM.window_gather(planes, by0, bx0, wr, jnp, nwin_c=wc)
        mvs = FM.eval_chain(wide, curK[c * k : (c + 1) * k], gg,
                            xsK[c * k : (c + 1) * k], ys, n, k, dims, fme,
                            None, cm, jnp)
        for i in range(min(k, nbc - c * k)):
            mv_la.append(np.asarray(mvs[i]))
        gg = mvs[-1]

    for j in range(nbc):
        np.testing.assert_array_equal(mv_la[j], mv_seq[j], err_msg=f"column {j}")


@pytest.mark.parametrize("fme", [False, True])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_confirm_windows_from_stack_matches_gather(fme, k):
    """confirm_windows_from_stack must equal window_gather at
    _region_base(g_fin) bit-for-bit: simulate the final sweep pass (chunk
    seeds = g_fin at each chunk's first column, per-block drift <= its
    column index) and compare the sliced confirm regions against a direct
    gather — including out-of-plane zero-fill and the padded tail chunk."""
    rng = np.random.default_rng(11)
    h, w, bs, nref = 64, 96, 16, 2
    nbr, nbc = h // bs, w // bs
    S, L = nbr, nbc
    refs = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    planes = FM.plane_stack(jnp.asarray(refs), fme, jnp)
    ys = jnp.arange(nbr, dtype=jnp.int32) * bs
    xs = jnp.arange(nbc, dtype=jnp.int32) * bs
    # build a g_fin whose chunk-relative drift respects the lookahead cone
    # (|pos(g[c*k+i]) - pos(g[c*k])| <= i on each axis), drifting randomly,
    # with some seeds at wild positions (zero-fill territory)
    Lp = -(-L // k)
    g = np.zeros((S, L, 3), np.int64)
    for s in range(S):
        pos = rng.integers(-4, 5, 2)
        if s == 1:
            pos = np.array([250, -300])  # out-of-plane chunk
        for j in range(L):
            g[s, j, :2] = pos
            g[s, j, 2] = rng.integers(0, nref)
            pos = pos + rng.integers(-1, 2, 2)  # winner = MVP + delta
    g_fin = jnp.asarray(g.reshape(S * L, 3).astype(np.int32))
    n = bs
    wr, wc = FM.wide_window_spec(n, k, fme)
    # simulate the final pass's wide-window stack at the chunk seeds
    gk = np.concatenate([g, np.repeat(g[:, -1:], Lp * k - L, axis=1)], axis=1) \
        if Lp * k != L else g
    wides = []
    for c in range(Lp):
        seeds = jnp.asarray(gk[:, c * k].astype(np.int32))
        by0, bx0 = FM._wide_base(seeds, ys, xs[min(c * k, L - 1)], k, fme, jnp)
        wides.append(FM.window_gather(planes, by0, bx0, wr, jnp, nwin_c=wc))
    wideT = jnp.stack(wides, axis=0)
    got = FM.confirm_windows_from_stack(wideT, g_fin, n, k, L, S, fme, jnp)
    byc = jnp.repeat(ys, L)
    bxc = jnp.tile(xs, S)
    by0, bx0 = FM._region_base(g_fin, byc, bxc, n, fme, jnp)
    want = FM.window_gather(planes, by0, bx0, n + 2, jnp)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("fme", [False, True])
def test_confirm_matches_quads_and_gather_predictions(fme):
    cur, refs, bx, by, g, (nbr, nbc) = _setup(fme, seed=1)
    h, w = cur.shape
    bs, sbs = 16, 8
    scale = 2 if fme else 1
    pad = scale * (bs - 1) + 3
    if fme:
        sref = jax.vmap(lambda r: M.fme_upsample(r.astype(jnp.int32), jnp, wrap_row_pass=True))(
            jnp.asarray(refs)
        )
    else:
        sref = jnp.asarray(refs).astype(jnp.int32)
    dims = sref.shape[-2:]
    refs_pad = jnp.pad(sref, ((0, 0), (pad, pad), (pad, pad))).astype(jnp.uint8)
    cur_b = jnp.asarray(cur).reshape(nbr, bs, nbc, bs).swapaxes(1, 2).reshape(-1, bs, bs)
    cur_q = cur_b.reshape(-1, 2, sbs, 2, sbs).swapaxes(2, 3).reshape(-1, 4, sbs, sbs)
    X, Y = (bx * scale).astype(jnp.int32), (by * scale).astype(jnp.int32)
    offs = np.array([[0, 0], [0, 1], [1, 0], [1, 1]]) * sbs
    qx = (np.asarray(bx)[:, None] + offs[None, :, 1])
    qy = (np.asarray(by)[:, None] + offs[None, :, 0])

    mv_ref, sad_ref = M.fast_sweep(cur_b, X, Y, refs_pad, pad, dims, bs, fme, g)
    smv_ref, ssad_ref = M.fast_quads_sweep(
        cur_q, jnp.asarray(qx * scale), jnp.asarray(qy * scale), refs_pad, pad, dims, sbs, fme, g
    )
    predf_ref = P.gather_predictions(mv_ref, sref, bx, by, bs, fme, jnp)
    predq_ref = P.gather_predictions(
        smv_ref.reshape(-1, 3), sref, jnp.asarray(qx.reshape(-1)), jnp.asarray(qy.reshape(-1)),
        sbs, fme, jnp,
    ).reshape(-1, 4, sbs, sbs)

    planes = FM.plane_stack(jnp.asarray(refs), fme, jnp)
    by0, bx0 = FM._region_base(g, by, bx, bs, fme, jnp)
    win = FM.window_gather(planes, by0, bx0, bs + 2, jnp)
    out = FM.confirm(
        win, cur_b, cur_q, g, X, Y, bs, sbs, tuple(int(d) for d in dims), fme, True, None,
        by0, bx0, jnp,
    )
    np.testing.assert_array_equal(np.asarray(out["mv"]), np.asarray(mv_ref))
    np.testing.assert_array_equal(np.asarray(out["sad"]), np.asarray(sad_ref))
    np.testing.assert_array_equal(np.asarray(out["sub_mv"]), np.asarray(smv_ref))
    np.testing.assert_array_equal(np.asarray(out["sub_sad"]), np.asarray(ssad_ref))
    np.testing.assert_array_equal(np.asarray(out["pred_full"]), np.asarray(predf_ref))
    np.testing.assert_array_equal(np.asarray(out["pred_quads"]), np.asarray(predq_ref))


def test_window_gather_zero_fill_and_chunking():
    rng = np.random.default_rng(2)
    planes = jnp.asarray(rng.integers(0, 256, (3, 40, 56)).astype(np.float32)).astype(jnp.bfloat16)
    by0 = jnp.asarray([-5, 0, 30, 39, 1000, -1000, 12])
    bx0 = jnp.asarray([10, -3, 50, 55, 0, 0, -100000])
    ref = np.zeros((7, 3, 9, 9), np.int32)
    pn = np.asarray(planes.astype(jnp.int32))
    for b in range(7):
        for i in range(9):
            for j in range(9):
                y, x = int(by0[b]) + i, int(bx0[b]) + j
                if 0 <= y < 40 and 0 <= x < 56:
                    ref[b, :, i, j] = pn[:, y, x]
    win = FM.window_gather(planes, by0, bx0, 9, jnp)
    np.testing.assert_array_equal(np.asarray(win), ref)
    # tiny chunk budget forces the lax.map path; results identical
    win_c = FM.window_gather(planes, by0, bx0, 9, jnp, chunk_bytes=3 * 40 * 9 * 4 * 2)
    np.testing.assert_array_equal(np.asarray(win_c), ref)


def test_rowscan_fetch_modes_bitwise():
    """Engine-level: fast-ME VBS+FME encodes under every window-fetch mode
    — 'slice' (clamped dynamic_slice on zero-padded planes, incl. lookahead
    wide windows) and 'xla' with explicit lookahead — are bitwise-identical
    to 'xla' (the one-hot gather): MVs, bitstream, and reconstruction."""
    import dataclasses

    from streamoptima_tpu.config import CodecConfig
    from streamoptima_tpu.jax_engine import JaxCodec
    from streamoptima_tpu.utils import synthetic_clip

    h, w, frames = 48, 64, 3
    clip = synthetic_clip(h, w, frames)
    base = CodecConfig(height=h, width=w, frames=frames, block_size=16, qp=4,
                       intra_dur=frames, search_range=4, vbs_enable=True,
                       fme_enable=True, fast_me=True, fast_me_fetch="xla")
    ref = JaxCodec(base, clip).encode(package=True)
    for extra in (dict(fast_me_fetch="slice"),
                  dict(fast_me_fetch="slice", fast_me_lookahead=3),
                  dict(fast_me_fetch="slice", fast_me_lookahead=4),
                  dict(fast_me_fetch="slice", fast_me_lookahead=1),
                  dict(fast_me_fetch="xla", fast_me_lookahead=2),
                  dict(fast_me_fetch="xla", fast_me_lookahead=4)):
        b = JaxCodec(dataclasses.replace(base, **extra), clip).encode(package=True)
        np.testing.assert_array_equal(ref["reconstructed frames"], b["reconstructed frames"],
                                      err_msg=str(extra))
        np.testing.assert_equal(ref["MVS per Frame"], b["MVS per Frame"])
        np.testing.assert_equal(ref["approx residual"], b["approx residual"])


@pytest.mark.parametrize("P,h,w,wr,wc,nb", [
    (4, 64, 96, 18, 18, 41),     # FME square confirm window (n+2)
    (1, 48, 56, 10, 10, 200),    # whole-pel small block, many origins
    (8, 40, 48, 18, 18, 9),      # multi-ref FME stack
    (4, 64, 96, 21, 69, 23),     # FME k=4 lookahead wide window
    (1, 80, 120, 24, 72, 37),    # whole-pel k=4 lookahead wide window
    (2, 40, 160, 16, 128, 9),    # wide window spanning most of the plane
])
def test_window_read_slice_matches_window_gather(P, h, w, wr, wc, nb):
    """The clamped-dynamic_slice fetch ("slice" mode) is bit-identical to the
    one-hot gather for any origin — in-plane, clipped at every edge, and
    absurdly far out (clamping is exact zero-fill: origins outside
    (-nwin, H/W) have no plane overlap and read all zeros), for square and
    rectangular (lookahead) windows, including square reads served by a
    WIDE prep's padding."""
    rng = np.random.default_rng(P * 1000 + h + wc)
    planes = jnp.asarray(rng.integers(0, 256, (P, h, w)), jnp.bfloat16)
    by0 = jnp.asarray(np.concatenate(
        [rng.integers(-60, h + 30, nb - 4), [-(10**6), 10**6, -wr, h]]), jnp.int32)
    bx0 = jnp.asarray(np.concatenate(
        [rng.integers(-80, w + 30, nb - 4), [10**6, -(10**6), w, -wc]]), jnp.int32)
    ref = np.asarray(FM.window_gather(planes, by0, bx0, wr, jnp, nwin_c=wc))
    prep = FM.window_prep(planes, min(wr, wc), "slice", wide=(wr, wc))
    got = np.asarray(FM.window_read(prep, by0, bx0, wr, jnp, nwin_c=wc))
    np.testing.assert_array_equal(ref, got)
    nsq = min(wr, wc) - 3
    ref_sq = np.asarray(FM.window_gather(planes, by0, bx0, nsq, jnp))
    got_sq = np.asarray(FM.window_read(prep, by0, bx0, nsq, jnp))
    np.testing.assert_array_equal(ref_sq, got_sq)


@pytest.mark.parametrize("req,plane_px,want", [
    ("auto", 4 * 288 * 352, "xla"),       # CIF FME stack: one-hot
    ("auto", 4 * 720 * 1280, "slice"),    # 720p FME stack: slice
    ("auto", 1 * 1088 * 1920, "xla"),     # 1080p whole-pel single ref
    ("xla", 4 * 2160 * 3840, "xla"),      # explicit requests are honored
    ("slice", 1 * 64 * 64, "slice"),
])
def test_resolve_fetch_mode(req, plane_px, want):
    assert FM.resolve_fetch_mode(req, plane_px, 1, 1) == want


@pytest.mark.parametrize("req,seg_len,n_segments,want", [
    ("auto", 80, 45, 4),     # 720p: 45 block rows -> lookahead 4
    ("auto", 22, 18, 1),     # CIF: fewer than 32 segments -> 1
    ("auto", 3, 64, 3),      # clamped to the segment length
    (2, 80, 4, 2),           # explicit request honored
])
def test_resolve_lookahead(req, seg_len, n_segments, want):
    assert FM.resolve_lookahead(req, seg_len, n_segments) == want


def test_resolve_lookahead_warns_on_clamped_request():
    with pytest.warns(UserWarning, match="fast_me_lookahead=9"):
        assert FM.resolve_lookahead(9, 5, 40) == 5
