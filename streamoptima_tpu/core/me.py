"""Motion estimation: SAD candidate maps, exact tie-break argmin, FME upsample.

Reference semantics replicated exactly (integer SAD == float MAE ordering since
all MAEs share one power-of-two denominator):

- full search (Encoder.py:678-717): candidates (dx, dy) in [-sr, sr]^2 over all
  reference frames; winner = lexicographic argmin of
  (SAD, |dx|+|dy|, ref_idx, dx_scan_index, dy_scan_index)
  -- derived from the strict-improvement scan order (refs outer, dx asc, dy
  asc) with is_better_mv tie-break (Encoder.py:771-773).
- candidate validity: 0 <= x+dx < W - bs and 0 <= y+dy < H - bs (strict, the
  reference's off-by-one excludes x+dx == W-bs, Encoder.py:695); under FME
  additionally 0 <= x+dx+2bs < W - bs (Encoder.py:698).
- no valid candidate => mv=(0,0,0), SAD=+inf (Encoder.py:684-685).
- fractional ME upsample (Encoder.py:388-406): 2x in each dim by neighbor
  averaging; np.ceil applied on the column pass => all half-pel values are
  exact integers: ceil((a+b)/2) and ceil((a+b+c+d)/4).

SAD maps are computed once at sub-block granularity; a full-block SAD is the
sum of its four quadrant SADs at the same displacement, so VBS sub-block
search (Encoder.py:517-544) shares the same tables.
"""
from __future__ import annotations

import numpy as np

_INF32 = np.int32(2**31 - 1)


def fme_upsample(frame, xp, wrap_row_pass: bool | None = None):
    """Exact integer twin of frac_me_reference_frame for one frame.

    frame: (h, w) int array -> (2h-1, 2w-1) int32.
    even/even = original; halves = ceil of 2- and 4-neighbor averages.

    Quirk K17: the reference's *row* pass sums uint8 rows before dividing
    (``(row + np.roll(row,-1))/2.0``, Encoder.py:397) so horizontal averages
    wrap modulo 256 when the ref frame is a uint8 reconstruction; the column
    pass runs on the float intermediate and never wraps.  The initial all-128
    reference frame is float64 and does not wrap.  ``wrap_row_pass`` defaults
    to True iff ``frame`` is uint8 (matching the reference's dtype-driven
    behavior).
    """
    if wrap_row_pass is None:
        wrap_row_pass = frame.dtype == np.uint8 if xp is np else frame.dtype == xp.uint8
    f = frame.astype(xp.int32)
    h, w = f.shape
    a = f[:, :-1]
    b = f[:, 1:]
    row_sum = (a + b) & 255 if wrap_row_pass else a + b
    row_half = (row_sum + 1) >> 1  # ceil
    c = f[:-1, :]
    d = f[1:, :]
    col_half = (c + d + 1) >> 1  # column pass: float in the reference, no wrap
    rs_top = (f[:-1, :-1] + f[:-1, 1:]) & 255 if wrap_row_pass else f[:-1, :-1] + f[:-1, 1:]
    rs_bot = (f[1:, :-1] + f[1:, 1:]) & 255 if wrap_row_pass else f[1:, :-1] + f[1:, 1:]
    quad = (rs_top + rs_bot + 3) >> 2  # ceil of the averaged wrapped halves
    if xp is np:
        out = np.zeros((2 * h - 1, 2 * w - 1), dtype=np.int32)
        out[0::2, 0::2] = f
        out[0::2, 1::2] = row_half
        out[1::2, 0::2] = col_half
        out[1::2, 1::2] = quad
        return out
    # interleave via stack+reshape (a strided .at[] scatter lowers to a
    # general scatter)
    even_rows = xp.concatenate(
        [xp.stack([f[:, :-1], row_half], axis=2).reshape(h, 2 * (w - 1)), f[:, -1:]], axis=1
    )  # (h, 2w-1)
    odd_rows = xp.concatenate(
        [xp.stack([col_half[:, :-1], quad], axis=2).reshape(h - 1, 2 * (w - 1)), col_half[:, -1:]],
        axis=1,
    )  # (h-1, 2w-1)
    inter = xp.stack([even_rows[:-1], odd_rows], axis=1).reshape(2 * (h - 1), 2 * w - 1)
    return xp.concatenate([inter, even_rows[-1:]], axis=0)


def fme_parity_planes(frame, xp, wrap_row_pass: bool | None = None):
    """The four parity planes of ``fme_upsample(frame)`` computed directly.

    Plane (py, px) equals ``fme_upsample(frame)[py::2, px::2]`` zero-padded to
    (h, w) — but produced by pure elementwise arithmetic on the (h, w) frame.
    Materializing the (2h-1, 2w-1) upsample and strided-slicing it back lowers
    to XLA gathers; this form is elementwise only.

    Returns (4, h, w) int32 ordered [p00, p01, p10, p11] (py-major).
    """
    if wrap_row_pass is None:
        wrap_row_pass = frame.dtype == np.uint8 if xp is np else frame.dtype == xp.uint8
    f = frame.astype(xp.int32)
    h, w = f.shape
    zc = ((0, 0), (0, 1))  # pad one column
    zr = ((0, 1), (0, 0))  # pad one row
    rs = (f[:, :-1] + f[:, 1:]) & 255 if wrap_row_pass else f[:, :-1] + f[:, 1:]
    p01 = xp.pad((rs + 1) >> 1, zc)
    p10 = xp.pad((f[:-1, :] + f[1:, :] + 1) >> 1, zr)
    rs_top = (f[:-1, :-1] + f[:-1, 1:]) & 255 if wrap_row_pass else f[:-1, :-1] + f[:-1, 1:]
    rs_bot = (f[1:, :-1] + f[1:, 1:]) & 255 if wrap_row_pass else f[1:, :-1] + f[1:, 1:]
    p11 = xp.pad((rs_top + rs_bot + 3) >> 2, (zr[0], zc[1]))
    return xp.stack([f, p01, p10, p11])


def sad_maps(cur, ref, sr: int, sub_bs: int, stride: int, xp, row_offset=0, also_full=False):
    """SAD tables at sub-block granularity for every displacement.

    cur: (h, w) current frame (int); ref: (H, W) reference frame (int; the FME
    upsampled frame when stride == 2).  Displacements d in [-sr, sr] are in
    ref-grid units (half-pel when stride == 2).  Block (bi, bj) covers cur
    rows [bi*sub_bs, ...); its window in ref starts at
    (stride*bi*sub_bs + dy + row_offset, stride*bj*sub_bs + dx) with
    ``stride`` row/col step.

    ``row_offset`` (ref-grid units, may be traced) supports row-sharded
    multi-chip tiles: ``cur`` holds pixel rows [y0, y0+h) of the frame while
    ``ref`` is the full-height reference, with row_offset = stride*y0.

    Returns (ndy, ndx, nbr, nbc) int32 where entry [dyi, dxi, bi, bj] is the
    SAD; out-of-frame windows contribute garbage and MUST be masked by the
    caller via candidate_valid_mask (the reference never evaluates them).

    ``also_full=True`` returns a tuple (sub_maps, full_maps) where full_maps
    additionally sums 2x2 quads into (2*sub_bs)-block SADs — computed inside
    the dy loop where the partial sums are register-resident (summing the
    materialized sub map afterwards forces XLA into a layout-rotating copy
    of the whole candidate buffer; found dominant at 720p on a TPU, not yet
    measured on the H100).
    """
    h, w = cur.shape
    nbr, nbc = h // sub_bs, w // sub_bs
    nd = 2 * sr + 1
    c32 = cur.astype(xp.int32)
    # pad ref so every (possibly invalid) window read is in-range
    pad = sr + stride * sub_bs + 2
    if xp is np:
        rp = np.pad(ref.astype(np.int32), pad, mode="constant")
    else:
        rp = xp.pad(ref.astype(xp.int32), pad, mode="constant")

    if xp is np:

        def one_dy(dy):
            row_idx = stride * np.arange(h) + dy + pad + row_offset
            rows = rp[row_idx, :]  # (h, Wp)
            col_idx = stride * np.arange(w)[None, :] + np.arange(nd)[:, None] - sr + pad  # (nd, w)
            win = rows[:, col_idx]  # (h, nd, w)
            diff = abs(win - c32[:, None, :])
            d4 = diff.reshape(nbr, sub_bs, nd, nbc, sub_bs)
            return d4.sum(axis=(1, 4)).transpose(1, 0, 2)

        sub = np.stack([one_dy(dy) for dy in range(-sr, sr + 1)])
        if not also_full:
            return sub
        full = sub.reshape(nd, nd, nbr // 2, 2, nbc // 2, 2).sum(axis=(3, 5))
        return sub, full

    import jax
    from jax import lax

    # serial over dy (lax.map), static unroll over dx per step: each dx is a
    # static column slice of the row band (an XLA view, no gather), so the
    # abs-diff + blocked reduction fuse into one elementwise pass per dx.
    # Block sums <= 255*sub_bs^2 <= 16320 fit int16 for sub_bs <= 8.  (A 0/1-
    # aggregation matmul form was tried and rejected: a reduced-precision
    # matmul (bf16, TF32) may round its sums regardless of
    # preferred_element_type, breaking bit-exactness.)
    c16 = cur.astype(xp.int16)
    rp16 = rp.astype(xp.int16)
    sum_dtype = xp.int16 if sub_bs <= 8 else xp.int32

    def one_dy_jax(dy):
        rows = lax.dynamic_slice_in_dim(rp16, pad + dy + row_offset, stride * (h - 1) + 1, axis=0)[::stride]  # (h, Wp)
        if stride == 2:
            # destride columns ONCE into parity planes; each dx window is then
            # a contiguous view (a strided slice per dx materializes a copy)
            planes = (rows[:, 0::2], rows[:, 1::2])
        outs = []
        fulls = []
        for dxi in range(nd):
            c0 = dxi + pad - sr
            if stride == 1:
                win = rows[:, c0 : c0 + w]
            else:
                win = planes[c0 % 2][:, c0 // 2 : c0 // 2 + w]
            diff = abs(win - c16)
            # two-stage: minor-axis reduce first (fuses with the abs-diff, so
            # the (h, w) diff is never materialized), then the small sublane
            # reduce — a single strided (1, 3)-axes reduce defeats fusion and
            # quintuples HBM traffic (measured via XLA cost analysis)
            cols = diff.reshape(h, nbc, sub_bs).astype(sum_dtype).sum(axis=-1)  # (h, nbc)
            s = cols.reshape(nbr, sub_bs, nbc).sum(axis=1).astype(xp.int32)  # (nbr, nbc)
            outs.append(s)
            if also_full:
                f = s.reshape(nbr // 2, 2, nbc // 2, 2).sum(axis=(1, 3))
                fulls.append(f)
        if also_full:
            return xp.stack(outs), xp.stack(fulls)
        return xp.stack(outs)  # (nd, nbr, nbc)

    return jax.lax.map(one_dy_jax, xp.arange(-sr, sr + 1))  # (ndy, ndx, nbr, nbc)


def full_search_materialized(cur, refs, sr: int, bs: int, sub_bs: int, stride: int, fme: bool,
                             vbs: bool, xp, row_offset=0, nvalid=None, grid_dims=None,
                             valid_row_offset=None):
    """Full search via materialized candidate maps + exact-tie-break argmin.

    Same contract and bit-identical results as full_search_fused; the
    materialized form is the default of the per-frame step, the fused form
    avoids the (ndy, ndx, nbr2, nbc2) intermediate (the default inside the
    GOP scan).  Which wins on the H100 is not yet measured.  Works for NumPy
    (oracle) and JAX backends.

    ``grid_dims``: the FULL reference-grid (H, W) for validity when ``refs``
    is only a halo band of the frame (row-sharded tiles exchanging
    search-range-wide borders); defaults to refs' own dims.
    ``valid_row_offset``: GLOBAL ref-grid row of cur's first row for the
    validity math; defaults to ``row_offset`` (which is the READ offset into
    ``refs`` — the two differ when refs is a halo band).
    """
    h, w = cur.shape
    nref, H, W = refs.shape
    if grid_dims is not None:
        H, W = grid_dims
    if valid_row_offset is None:
        valid_row_offset = row_offset
    nd = 2 * sr + 1
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    nbr2, nbc2 = h // sub_bs, w // sub_bs
    if xp is np:
        pairs = [sad_maps(cur, refs[i], sr, sub_bs, stride, np, row_offset, also_full=True) for i in range(nref)]
        maps = np.stack([p[0] for p in pairs])
        full = np.stack([p[1] for p in pairs]).reshape(nref, nd, nd, -1)
    else:
        import jax

        maps, fullg = jax.vmap(
            lambda r: sad_maps(cur, r, sr, sub_bs, stride, xp, row_offset, also_full=True)
        )(refs)
        full = fullg.reshape(nref, nd, nd, -1)
    bxs = xp.asarray(np.tile(np.arange(nbc) * bs, nbr)) * stride
    bys = xp.asarray(np.repeat(np.arange(nbr) * bs, nbc)) * stride + valid_row_offset
    vm = candidate_valid_mask(bxs, bys, sr, bs, H, W, fme, xp)
    rv_shape = (nref, 1, 1, 1)
    rv = (xp.arange(nref) < (nref if nvalid is None else nvalid)).reshape(rv_shape)
    mv, sad, ok = argmin_displacement(full, xp.broadcast_to(vm[None] & rv, full.shape), sr, True, xp)
    out = {"mv": mv, "sad": sad, "ok": ok}
    if vbs:
        qxs = xp.asarray(np.tile(np.arange(nbc2) * sub_bs, nbr2)) * stride
        qys = xp.asarray(np.repeat(np.arange(nbr2) * sub_bs, nbc2)) * stride + valid_row_offset
        sub = maps.reshape(nref, nd, nd, -1)
        vs = candidate_valid_mask(qxs, qys, sr, sub_bs, H, W, fme, xp)
        smv, ssad, sok = argmin_displacement(sub, xp.broadcast_to(vs[None] & rv, sub.shape), sr, True, xp)

        # sub arrays are in (nbr2, nbc2) raster; regroup into per-block quads
        def regroup(a, tail):
            a = a.reshape((nbr, 2, nbc, 2) + tail)
            if xp is np:
                a = a.transpose((0, 2, 1, 3) + tuple(range(4, 4 + len(tail))))
            else:
                a = xp.transpose(a, (0, 2, 1, 3) + tuple(range(4, 4 + len(tail))))
            return a.reshape((nb, 4) + tail)

        out["sub_mv"] = regroup(smv, (3,))
        out["sub_sad"] = regroup(ssad, ())
        out["sub_ok"] = regroup(sok, ())
    return out


def full_search_fused(cur, refs, sr: int, bs: int, sub_bs: int, stride: int, fme: bool,
                      vbs: bool, xp, row_offset=0, nvalid=None, grid_dims=None,
                      valid_row_offset=None):
    """Streaming full search: SAD generation and winner selection in one pass.

    Functionally identical to sad_maps + candidate_valid_mask +
    argmin_displacement (the winner is the lexicographic min of
    (SAD, L1, ref, dx_idx, dy_idx) over valid candidates) but folds the
    reduction into the dy scan: no (ndy, ndx, nbr, nbc) intermediate is
    materialized — XLA otherwise re-reads that buffer across the two argmin
    passes, which dominates the 720p frame step.

    cur: (h, w) int local band; refs: (nref, H, W) int full-height reference
    stack (FME-upsampled when stride == 2); sr in ref-grid units;
    row_offset = stride * y0 for row-sharded tiles (may be traced);
    nvalid (traced int) masks refs[i >= nvalid] (reference FIFO warm-up).

    Returns dict mv (nb, 3) [dx, dy, ref], sad (nb,), ok (nb,) — plus
    sub_mv (nb, 4, 3), sub_sad, sub_ok when ``vbs``.  The NumPy path
    delegates to the materializing pipeline (golden-test oracle).
    """
    h, w = cur.shape
    nref, H, W = refs.shape
    nd = 2 * sr + 1
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc

    if xp is np:  # oracle path: materialize + argmin (bit-identical result)
        return full_search_materialized(cur, refs, sr, bs, sub_bs, stride, fme, vbs, np,
                                        row_offset=row_offset, nvalid=nvalid, grid_dims=grid_dims,
                                        valid_row_offset=valid_row_offset)

    import jax
    from jax import lax

    if grid_dims is not None:
        H, W = grid_dims
    if valid_row_offset is None:
        valid_row_offset = row_offset
    nbr2, nbc2 = h // sub_bs, w // sub_bs
    pad = sr + stride * sub_bs + 2
    c16 = cur.astype(xp.int16)
    sum_dtype = xp.int16 if sub_bs <= 8 else xp.int32

    d = xp.arange(nd) - sr  # displacement values per index
    # per-axis validity, precomputed for all (index, coordinate) pairs
    bx = xp.asarray(np.arange(nbc) * bs) * stride
    by = xp.asarray(np.arange(nbr) * bs) * stride + valid_row_offset
    px = bx[None, :] + d[:, None]  # (nd, nbc)
    py = by[None, :] + d[:, None]  # (nd, nbr)
    okx_f = (px >= 0) & (px < W - bs)
    oky_f = (py >= 0) & (py < H - bs)
    if fme:
        okx_f &= (px + 2 * bs >= 0) & (px + 2 * bs < W - bs)
        oky_f &= (py + 2 * bs >= 0) & (py + 2 * bs < H - bs)
    if vbs:
        qx = xp.asarray(np.arange(nbc2) * sub_bs) * stride
        qy = xp.asarray(np.arange(nbr2) * sub_bs) * stride + valid_row_offset
        pxq = qx[None, :] + d[:, None]
        pyq = qy[None, :] + d[:, None]
        okx_q = (pxq >= 0) & (pxq < W - sub_bs)
        oky_q = (pyq >= 0) & (pyq < H - sub_bs)
        if fme:
            okx_q &= (pxq + 2 * sub_bs >= 0) & (pxq + 2 * sub_bs < W - sub_bs)
            oky_q &= (pyq + 2 * sub_bs >= 0) & (pyq + 2 * sub_bs < H - sub_bs)

    l1 = abs(d)[:, None] + abs(d)[None, :]  # (ndy, ndx)

    carry = {
        "sad": xp.full((nb,), _INF32, xp.int32),
        "sec": xp.full((nb,), _INF32, xp.int32),
    }
    if vbs:
        carry["q_sad"] = xp.full((nb, 4), _INF32, xp.int32)
        carry["q_sec"] = xp.full((nb, 4), _INF32, xp.int32)

    def lex_update(best_sad, best_sec, cand, sec):
        better = (cand < best_sad) | ((cand == best_sad) & (cand != _INF32) & (sec < best_sec))
        return xp.where(better, cand, best_sad), xp.where(better, sec, best_sec)

    for refi in range(nref):
        rp16 = xp.pad(refs[refi].astype(xp.int16), pad)
        rv_ok = True if nvalid is None else refi < nvalid

        def body(c, dyi):
            dy = dyi - sr
            rows = lax.dynamic_slice_in_dim(
                rp16, pad + dy + row_offset, stride * (h - 1) + 1, axis=0
            )[::stride]
            for dxi in range(nd):
                if stride == 1:
                    win = rows[:, dxi + pad - sr : dxi + pad - sr + w]
                else:
                    win = rows[:, dxi + pad - sr : dxi + pad - sr + stride * (w - 1) + 1 : stride]
                diff = abs(win - c16)
                # NOTE: the single strided reduce is kept here deliberately —
                # it is the form the GOP scan was tuned with (not yet
                # re-measured on the H100)
                ss = diff.reshape(nbr2, sub_bs, nbc2, sub_bs).astype(sum_dtype).sum(axis=(1, 3)).astype(xp.int32)
                fs = ss.reshape(nbr, 2, nbc, 2).sum(axis=(1, 3)).reshape(-1)  # (nb,)
                sec = ((((l1[dyi, dxi].astype(xp.int32) << 3) | refi) << 8 | dxi) << 8) | dyi
                vf = (oky_f[dyi][:, None] & okx_f[dxi][None, :]).reshape(-1) & rv_ok
                c["sad"], c["sec"] = lex_update(c["sad"], c["sec"], xp.where(vf, fs, _INF32), sec)
                if vbs:
                    qs = ss.reshape(nbr, 2, nbc, 2).transpose(0, 2, 1, 3).reshape(nb, 4)
                    vq = (
                        oky_q[dyi].reshape(nbr, 2)[:, None, :, None]
                        & okx_q[dxi].reshape(nbc, 2)[None, :, None, :]
                    ).reshape(nb, 4) & rv_ok
                    c["q_sad"], c["q_sec"] = lex_update(
                        c["q_sad"], c["q_sec"], xp.where(vq, qs, _INF32), sec
                    )
            return c, None

        carry, _ = lax.scan(body, carry, xp.arange(nd))

    def unpack(sad, sec):
        ok = sad != _INF32
        wdy = (sec & 0xFF) - sr
        wdx = ((sec >> 8) & 0xFF) - sr
        wref = (sec >> 16) & 0x7
        zero = xp.zeros_like(wdx)
        mv = xp.stack(
            [xp.where(ok, wdx, zero), xp.where(ok, wdy, zero), xp.where(ok, wref, zero)], axis=-1
        ).astype(xp.int32)
        return mv, sad.astype(xp.int32), ok

    mv, sad, ok = unpack(carry["sad"], carry["sec"])
    out = {"mv": mv, "sad": sad, "ok": ok}
    if vbs:
        smv, ssad, sok = unpack(carry["q_sad"].reshape(-1), carry["q_sec"].reshape(-1))
        out["sub_mv"] = smv.reshape(nb, 4, 3)
        out["sub_sad"] = ssad.reshape(nb, 4)
        out["sub_ok"] = sok.reshape(nb, 4)
    return out


def _arange(xp, n):
    return xp.arange(n)


def candidate_valid_mask(bx, by, sr: int, bs: int, H: int, W: int, fme: bool, xp, extra_2bs: bool | None = None):
    """Validity of each displacement for each block (see module docstring).

    bx, by: (nb,) block top-left coords in ref-grid units (already doubled
    under FME).  Returns (ndy, ndx, nb) bool.
    ``extra_2bs``: apply the +2bs bound; defaults to ``fme`` (find_best_match)
    but fast ME applies it unconditionally (Encoder.py:730).
    """
    if extra_2bs is None:
        extra_2bs = fme
    d = _arange(xp, 2 * sr + 1) - sr
    px = bx[None, :] + d[:, None]  # (ndx, nb)
    py = by[None, :] + d[:, None]  # (ndy, nb)
    okx = (px >= 0) & (px < W - bs)
    oky = (py >= 0) & (py < H - bs)
    if extra_2bs:
        okx = okx & (px + 2 * bs >= 0) & (px + 2 * bs < W - bs)
        oky = oky & (py + 2 * bs >= 0) & (py + 2 * bs < H - bs)
    return oky[:, None, :] & okx[None, :, :]  # (ndy, ndx, nb)


def argmin_displacement(sads, valid, sr: int, ref_axis: bool, xp):
    """Reference-exact winner selection over (nref?, ndy, ndx) per block.

    sads: (nref, ndy, ndx, nb) int32; valid: same-shape bool.
    Returns (mv (nb, 3) int32 [dx, dy, ref], sad (nb,) int32, any_valid (nb,) bool).
    Winner minimizes (SAD, |dx|+|dy|, ref, dx_index, dy_index) among valid
    candidates; with none valid, mv=(0,0,0) and sad=INT32_MAX (stands in for
    the reference's float inf, Encoder.py:684).
    """
    if not ref_axis:
        sads = sads[None]
        valid = valid[None]
    nref, ndy, ndx, nb = sads.shape
    d = _arange(xp, 2 * sr + 1) - sr
    l1 = abs(d)[None, :, None] + abs(d)[None, None, :]  # (1, ndy, ndx)
    refi = _arange(xp, nref)[:, None, None]
    dxi = _arange(xp, ndx)[None, None, :]
    dyi = _arange(xp, ndy)[None, :, None]
    # secondary key: (L1, ref, dx_idx, dy_idx) -- 8+3+8+8 bits (sr <= 64 grid)
    sec = (((l1.astype(xp.int32) << 3 | refi) << 8 | dxi) << 8 | dyi)  # (nref, ndy, ndx)
    sads_m = xp.where(valid, sads, _INF32)
    # candidate axis last: minor-axis reductions are the VPU-native layout
    flat = sads_m.reshape(nref * ndy * ndx, nb).T  # (nb, ncand)
    best_sad = flat.min(axis=-1)
    sec_b = xp.broadcast_to(sec[..., None], sads.shape).reshape(nref * ndy * ndx, nb).T
    sec_m = xp.where((flat == best_sad[:, None]) & (flat != _INF32), sec_b, _INF32)
    win = sec_m.min(axis=-1)
    any_valid = win != _INF32
    wdy = (win & 0xFF) - sr
    wdx = ((win >> 8) & 0xFF) - sr
    wref = (win >> 16) & 0x7
    zero = xp.zeros_like(wdx)
    mv = xp.stack(
        [xp.where(any_valid, wdx, zero), xp.where(any_valid, wdy, zero), xp.where(any_valid, wref, zero)],
        axis=-1,
    ).astype(xp.int32)
    return mv, best_sad.astype(xp.int32), any_valid


# --------------------------------------------------------------- fast ME
def fast_candidates(cur_blk, refs_pad, pad, dims, X, Y, n, mvp, fme, nvalid=None):
    """SADs of the 3x3 window around ``mvp`` for one block; returns the
    winner with fast-ME semantics (Encoder.py:719-742): strict improvement
    in (ref, dx, dy) scan order, quirk-K7 candidate bound, fallback to the
    MVP itself when nothing is valid (K8).

    ``refs_pad``: reference stack padded by ``pad`` on each side (pad >= the
    3x3 window region for both block sizes, so valid candidates' slices are
    never clamped); ``dims`` the unpadded (H, W); ``X, Y`` the block origin
    in search coordinates (x2 under FME).  ``nvalid`` masks unpopulated
    slots of a fixed-size reference FIFO (the sharded engine's GOP scan
    carries all n_ref_frames slots from frame 1).  One small dynamic_slice
    per block — under vmap this is the batched Jacobi sweep's only gather.
    """
    import jax
    import jax.numpy as jnp

    H, W = dims
    nref = refs_pad.shape[0]
    d = jnp.arange(-1, 2)
    dx = mvp[0] + d  # (3,)
    dy = mvp[1] + d
    px = X + dx
    py = Y + dy
    okx = (px >= 0) & (px < W - n) & (px + 2 * n >= 0) & (px + 2 * n < W - n)
    oky = (py >= 0) & (py < H - n) & (py + 2 * n >= 0) & (py + 2 * n < H - n)
    valid = oky[:, None] & okx[None, :]  # (dy, dx) -> note loops dx outer
    step = 2 if fme else 1
    size = step * (n - 1) + 3
    region = jax.lax.dynamic_slice(
        refs_pad, (0, Y + mvp[1] - 1 + pad, X + mvp[0] - 1 + pad), (nref, size, size)
    )
    wins = []
    for dyi in range(3):
        row_w = []
        for dxi in range(3):
            row_w.append(region[:, dyi : dyi + step * (n - 1) + 1 : step, dxi : dxi + step * (n - 1) + 1 : step])
        wins.append(jnp.stack(row_w, axis=1))
    win = jnp.stack(wins, axis=1)  # (nref, dyi, dxi, n, n)
    sads = jnp.abs(win.astype(jnp.int32) - cur_blk[None, None, None]).sum(axis=(-2, -1))
    ok = valid[None]
    if nvalid is not None:
        ok = ok & (jnp.arange(nref)[:, None, None] < nvalid)
    sads = jnp.where(ok, sads, _INF32)
    # scan order (ref, dx, dy): strict improvement => first minimal in that order
    order = sads.transpose(0, 2, 1).reshape(-1)  # ref-major, dx, dy
    k = jnp.argmin(order)  # first occurrence of min (ties -> first)
    best = order[k]
    ref_i = k // 9
    dxi = (k % 9) // 3
    dyi = k % 3
    any_ok = best != _INF32
    mv = jnp.where(
        any_ok,
        jnp.stack([mvp[0] + dxi - 1, mvp[1] + dyi - 1, ref_i]).astype(jnp.int32),
        jnp.stack([mvp[0], mvp[1], mvp[2]]).astype(jnp.int32),  # fallback: mvp itself (K8)
    )
    sad = jnp.where(any_ok, best, _INF32)
    return mv, sad


def fast_sweep(cur_b, bx, by, refs_pad, pad, dims, n, fme, guesses, nvalid=None):
    """One Jacobi sweep of the fast-ME MVP chain: evaluate EVERY block's 3x3
    search against its guessed MVP in a single batched pass.  The chain
    recurrence mv[i] = f_i(mv[i-1]) (raster order, mv[-1] = 0) has a unique
    solution, so iterating sweep + shift(guesses) to a fixpoint reproduces
    the sequential scan bit-exactly — see JaxCodec._fast_search_fixpoint /
    ShardedCodec for the loops (single-chip and cross-tile)."""
    import jax

    return jax.vmap(
        lambda cb, x, y, g: fast_candidates(cb, refs_pad, pad, dims, x, y, n, g, fme, nvalid=nvalid)
    )(cur_b, bx, by, guesses)


def fast_quads_sweep(cur_q, qx, qy, refs_pad, pad, dims, sbs, fme, guesses, nvalid=None):
    """Batched VBS sub-block fast-ME: the four quads of block i all use the
    block-level MVP (= block i-1's MV) and never feed the chain — one pass
    at the converged guesses (Encoder.py:549-560 ordering)."""
    import jax

    return jax.vmap(
        jax.vmap(
            lambda cb, x, y, g: fast_candidates(cb, refs_pad, pad, dims, x, y, sbs, g, fme, nvalid=nvalid),
            in_axes=(0, 0, 0, None),
        )
    )(cur_q, qx, qy, guesses)
