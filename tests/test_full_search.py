"""Full search: the two XLA forms (core/me.py full_search_materialized and
full_search_fused) against a brute-force per-block NumPy oracle, over search
ranges, reference counts, a partly filled reference FIFO, frame heights whose
block rows do not divide evenly, VBS quads and half-pel (FME) grids; plus
the halo-band contract the row-sharded mesh relies on."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from numpy.lib.stride_tricks import sliding_window_view

from streamoptima_tpu.core import me as M

_INF = np.int32(2**31 - 1)


def _brute_search(cur, refs, sr, n, stride, fme, xs, ys, nvalid=None):
    """Per-block oracle: every valid candidate of the (2sr+1)^2 grid in every
    populated reference, winner = lexicographic min of (SAD, |dx|+|dy|, ref,
    dx index, dy index); validity is the reference's strict off-by-one bound
    0 <= p < W - n (plus the +2n bound under FME)."""
    nref, H, W = refs.shape
    span = stride * (n - 1) + 1
    views = [sliding_window_view(r.astype(np.int64), (span, span)) for r in refs]
    mvs, sads = [], []
    for x, y in zip(xs, ys):
        blk = cur[y:y + n, x:x + n].astype(np.int64)
        best = None
        for r in range(nref if nvalid is None else nvalid):
            for dyi in range(2 * sr + 1):
                py = stride * y + dyi - sr
                if not (0 <= py < H - n and (not fme or 0 <= py + 2 * n < H - n)):
                    continue
                for dxi in range(2 * sr + 1):
                    px = stride * x + dxi - sr
                    if not (0 <= px < W - n and (not fme or 0 <= px + 2 * n < W - n)):
                        continue
                    win = views[r][py, px][::stride, ::stride]
                    key = (int(np.abs(win - blk).sum()), abs(dxi - sr) + abs(dyi - sr), r, dxi, dyi)
                    best = key if best is None or key < best else best
        if best is None:
            mvs.append((0, 0, 0))
            sads.append(_INF)
        else:
            mvs.append((best[3] - sr, best[4] - sr, best[2]))
            sads.append(best[0])
    return np.asarray(mvs, np.int32), np.asarray(sads, np.int32)


def _oracle(cur, refs, sr, bs, stride, fme, vbs, nvalid):
    h, w = cur.shape
    ys, xs = np.meshgrid(np.arange(h // bs) * bs, np.arange(w // bs) * bs, indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    mv, sad = _brute_search(cur, refs, sr, bs, stride, fme, xs, ys, nvalid)
    out = {"mv": mv, "sad": sad, "ok": sad != _INF}
    if vbs:
        s = bs // 2
        qx = np.stack([xs + dx for dy in (0, s) for dx in (0, s)], 1).reshape(-1)
        qy = np.stack([ys + dy for dy in (0, s) for dx in (0, s)], 1).reshape(-1)
        smv, ssad = _brute_search(cur, refs, sr, s, stride, fme, qx, qy, nvalid)
        out.update(sub_mv=smv.reshape(-1, 4, 3), sub_sad=ssad.reshape(-1, 4),
                   sub_ok=(ssad != _INF).reshape(-1, 4))
    return out


CASES = [
    # (h, w, sr, nref, nvalid, fme, vbs)
    (64, 128, 4, 1, None, False, True),
    (96, 128, 8, 2, None, False, True),
    (64, 128, 4, 3, 2, False, True),     # partly filled reference FIFO
    (80, 128, 4, 2, None, False, True),  # 5 block rows
    (128, 256, 16, 1, None, False, True),
    (64, 128, 4, 1, None, False, False),
    (64, 128, 4, 1, None, True, True),
    (64, 128, 8, 2, 1, True, True),
    (80, 128, 4, 2, None, True, True),
    (64, 128, 4, 2, None, True, False),
]


@pytest.mark.parametrize("h,w,sr,nref,nvalid,fme,vbs", CASES,
                         ids=["x".join(map(str, c[:3])) + f"-r{c[3]}-v{c[4]}-fme{int(c[5])}-vbs{int(c[6])}"
                              for c in CASES])
def test_full_search_forms_match_brute_oracle(h, w, sr, nref, nvalid, fme, vbs):
    rng = np.random.default_rng(h + w + sr + nref)
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    raw = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    stride = 2 if fme else 1
    grid_sr = 2 * sr if fme else sr
    # under FME the search grid is the upsampled reference (uint8 input:
    # the reference's row-pass wrap, quirk K17, is live)
    refs = np.stack([M.fme_upsample(r, np) for r in raw]) if fme else raw.astype(np.int32)
    want = _oracle(cur, refs, grid_sr, 16, stride, fme, vbs, nvalid)
    nv = None if nvalid is None else jnp.int32(nvalid)
    for search in (M.full_search_materialized, M.full_search_fused):
        got = search(jnp.asarray(cur), jnp.asarray(refs), grid_sr, 16, 8, stride, fme, vbs,
                     jnp, nvalid=nv)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=f"{search.__name__}: {k}")


def test_full_search_translating_texture():
    """Real motion: the winner MVs recover the global translation exactly."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (80, 144)).astype(np.int32)
    ref = base[2 : 2 + 64, 3 : 3 + 128]
    cur = base[0:64, 0:128]  # cur(x) == ref(x + (-3, -2)) in ref coords
    for search in (M.full_search_materialized, M.full_search_fused):
        out = search(jnp.asarray(cur), jnp.asarray(ref)[None], 4, 16, 8, 1, False, False, jnp)
        mv = np.asarray(out["mv"]).reshape(4, 8, 3)
        # interior blocks: exact match at displacement (-3, -2)
        assert (mv[1:3, 2:6, 0] == -3).all() and (mv[1:3, 2:6, 1] == -2).all()
        assert (np.asarray(out["sad"]).reshape(4, 8)[1:3, 2:6] == 0).all()


def test_parity_planes_match_upsample_slices():
    """me.fme_parity_planes (elementwise, no upsample) == the strided slices
    of me.fme_upsample, zero-padded to the frame, with and without the
    row-pass wrap."""
    rng = np.random.default_rng(3)
    for wrap in (True, False):
        f = rng.integers(0, 256, (24, 40)).astype(np.uint8)
        up = M.fme_upsample(f if wrap else f.astype(np.int32), np, wrap_row_pass=wrap)
        planes = M.fme_parity_planes(f, np, wrap_row_pass=wrap)
        planes_j = np.asarray(M.fme_parity_planes(jnp.asarray(f), jnp, wrap_row_pass=wrap))
        for i, (py, px) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
            sl = up[py::2, px::2]
            exp = np.zeros((24, 40), np.int32)
            exp[: sl.shape[0], : sl.shape[1]] = sl
            np.testing.assert_array_equal(planes[i], exp, err_msg=f"plane {py}{px} wrap={wrap}")
            np.testing.assert_array_equal(planes_j[i], exp, err_msg=f"jnp plane {py}{px}")


@pytest.mark.parametrize("fme", [False, True])
def test_full_search_halo_band_matches_full_frame(fme):
    """Halo-band search (row_offset / grid_dims / valid_row_offset: a tile
    that holds only its rows plus sr+1 neighbour rows) == the matching slice
    of the full-frame search — the contract the row-sharded mesh encoder's
    ppermute halo relies on."""
    rng = np.random.default_rng(7)
    h, w, bs, sr, nref = 64, 128, 16, 4, 2
    nbc = w // bs
    cur = rng.integers(0, 256, (h, w)).astype(np.int32)
    raw = rng.integers(0, 256, (nref, h, w)).astype(np.uint8)
    s = 2 if fme else 1
    refs = np.stack([M.fme_upsample(r, np) for r in raw]) if fme else raw.astype(np.int32)
    grid_sr = s * sr
    halo, y0, h_t = sr + 1, 16, 32
    band = refs[:, s * (y0 - halo): s * (y0 + h_t + halo), :]
    full = M.full_search_fused(jnp.asarray(cur), jnp.asarray(refs), grid_sr, bs, 8, s, fme,
                               True, jnp)
    tile = M.full_search_fused(
        jnp.asarray(cur[y0:y0 + h_t]), jnp.asarray(band), grid_sr, bs, 8, s, fme, True, jnp,
        row_offset=s * halo, grid_dims=refs.shape[-2:], valid_row_offset=s * y0,
    )
    sel = slice((y0 // bs) * nbc, ((y0 + h_t) // bs) * nbc)
    for k in ("mv", "sad", "ok", "sub_mv", "sub_sad", "sub_ok"):
        np.testing.assert_array_equal(np.asarray(full[k])[sel], np.asarray(tile[k]), err_msg=k)


def test_full_search_jits():
    """Both forms trace under jit with static geometry (the engines' use)."""
    rng = np.random.default_rng(1)
    cur = jnp.asarray(rng.integers(0, 256, (32, 64)), jnp.int32)
    refs = jnp.asarray(rng.integers(0, 256, (2, 32, 64)), jnp.int32)
    outs = [jax.jit(lambda c, r, f=f: f(c, r, 4, 16, 8, 1, False, True, jnp))(cur, refs)
            for f in (M.full_search_materialized, M.full_search_fused)]
    for k in outs[0]:
        np.testing.assert_array_equal(np.asarray(outs[0][k]), np.asarray(outs[1][k]), err_msg=k)
