"""Intra prediction: parallel masked search + sequential reconstruction scans.

Key structural insight (proved against Encoder.py:1238-1347): during intra
*search* the reference reconstructs each block from the UNQUANTIZED residual,
so the partially-reconstructed search frame equals the original frame under a
causal mask (already-coded pixels) and 128 elsewhere.  For mode 0 the search
window spans only the current 16-row band, where "already coded" reduces to
``col < x_parent`` - so the whole search is embarrassingly parallel:

  SAD(block, dx) = sum_{j < t} |cur[:, x_sub+j] - orig[:, x_sub+dx+j]|
                 + sum_{j >= t} |cur[:, x_sub+j] - 128|,
  t = clip(-delta - dx, 0, n),  delta = x_sub - x_parent (0 full; {0,s} quads)

Both terms come from per-dx column-SAD prefix sums shared across blocks.

A consequence the decoder relies on: windows with dx >= -delta are all-128 and
tie with dx=0, so the chosen mv is always <= 0 (reads never cross the write
frontier).

Tie-break (Encoder.py:1034-1043): strictly-better MAE wins; equal MAE wins
when |dx| <= |best| (so: minimal |dx|, then the later-scanned positive dx).
Validity: x+dx >= 0 and x+dx+n <= canvas_w (inclusive bound; Encoder.py:1029)
with canvas_w = 352 in compat mode (hardcoded canvas, Encoder.py:1248).
Border blocks (x==0, mode 0): forced mv=-1 vs an all-128 block
(Encoder.py:1020-1024).

Reconstruction with quantized residuals (reconstruct_frame_intra,
Encoder.py:1350-1417 / decode_frame_intra, decoder.py:330-432) IS sequential,
but only along each block row in mode 0: scan over block columns, vectorized
over block rows.

Mode 1 (vertical) is the transpose of mode 0; the reference implementation of
mode-1 reconstruction is unrunnable (decoder.py:404 inverts the split test and
then indexes a scalar/list inconsistently -> TypeError on any input), so only
the native engine supports mode 1, via transposition.
"""
from __future__ import annotations

import numpy as np

_INF32 = np.int32(2**31 - 1)

_QUAD_OFFS = ((0, 0), (0, 1), (1, 0), (1, 1))  # Z order: TL, TR, BL, BR


def intra_search_mode0(cur, bs: int, sr: int, canvas_w: int, vbs: bool, xp):
    """Mode-0 (horizontal) intra search for all blocks (and VBS quads).

    cur: (h, w) int frame.  Returns dict with:
      mv:   (nbr, nbc) int32 chosen dx per full block (border col 0: -1)
      sad:  (nbr, nbc) int32 (border col: SAD vs 128)
      sub_mv / sub_sad: (nbr, nbc, 4) int32 for VBS quads when ``vbs``.
    SADs are integer; the reference's float MAEs are SAD / n^2 (exact).
    """
    h, w = cur.shape
    s = bs // 2
    nbr, nbc = h // bs, w // bs
    nbr2 = h // s
    ndx = 2 * sr + 1
    c32 = cur.astype(xp.int32)
    # pad so shifted windows exist for all dx and canvas columns
    pad_ref = xp.pad(c32, ((0, 0), (sr, canvas_w - w + sr)), constant_values=128)

    # Per-dx column SADs at sub-row-band granularity.  A prefix-sum form
    # (per-dx cumsum over w + take_along_axis gathers at the block columns)
    # is not needed: every read is BLOCK-ALIGNED with a length t(dx) that is
    # STATIC per dx, so the per-block partial sums are plain reshape-group
    # static-slice sums:
    # no cumsum chains, no gathers, bit-identical int32 totals.
    # int16 band sums: |diff| <= 255 and an s-row band sum <= 8*255 = 2040,
    # so the 33 whole-frame abs-diff passes (the search's only large-array
    # traffic) run at half width; the grouped block sums below widen to
    # int32 BEFORE accumulating over up to 16 columns (which can reach
    # 65280 and must not wrap).
    c16 = c32.astype(xp.int16)
    pad16 = pad_ref.astype(xp.int16)
    colsums = []
    for dxi in range(ndx):
        shifted = pad16[:, dxi : dxi + w]  # shifted[c] = orig[c + dx] (128 outside)
        d16 = abs(shifted - c16)
        colsums.append(d16.reshape(nbr2, s, w).sum(axis=1, dtype=xp.int16))
    col128 = abs(c16 - xp.int16(128)).reshape(nbr2, s, w).sum(axis=1, dtype=xp.int16)

    dx = xp.arange(-sr, sr + 1)

    def search(band_rows, rows128, x_sub, delta: int, n: int, dc: int):
        """band_rows: per-dxi list of (R, w) column SADs; rows128 (R, w);
        x_sub (C,) block col coords (= c*bs + dc*n for quads).  Returns
        mv, sad each (R, C).

        SAD(dx) = sum_{j < t} band_dx[x_sub + j] + sum_{t <= j < n}
        rows128[x_sub + j], t = clip(-delta - dx, 0, n): both are segment
        sums at n-aligned starts with static per-dx lengths."""
        R = rows128.shape[0]
        C = x_sub.shape[0]
        ng = w // n

        def grouped(rows_w):  # (R, w) -> (R, C, n) at the x_sub alignment
            g = rows_w.reshape(R, ng, n)
            if ng == C:
                return g
            # quad offset dc: every 2nd n-group starting at dc
            return g.reshape(R, C, 2, n)[:, :, dc, :]

        g128 = grouped(rows128)
        sads = []
        for dxi in range(ndx):
            t = int(np.clip(-delta - (dxi - sr), 0, n))
            a = grouped(band_rows[dxi])[:, :, :t].sum(axis=2, dtype=xp.int32)
            b = g128[:, :, t:n].sum(axis=2, dtype=xp.int32)
            sads.append(a + b)
        sad = xp.stack(sads)  # (ndx, R, C)
        valid = (x_sub[None, :] + dx[:, None] >= 0) & (x_sub[None, :] + dx[:, None] + n <= canvas_w)
        sad_m = xp.where(valid[:, None, :], sad, _INF32)
        best = sad_m.min(axis=0)  # (R, C)
        sec = ((xp.abs(dx).astype(xp.int32) << 8) | (sr - dx))[:, None, None]
        sec_m = xp.where(sad_m == best[None], sec, _INF32)
        mv = sr - (sec_m.min(axis=0) & 0xFF)
        return mv.astype(xp.int32), best.astype(xp.int32)

    x_full = xp.arange(nbc) * bs
    # two-band combine <= 4080: still int16
    full_rows = [b.reshape(nbr, 2, w).sum(axis=1, dtype=xp.int16) for b in colsums]
    full128 = col128.reshape(nbr, 2, w).sum(axis=1, dtype=xp.int16)
    mv, sad = search(full_rows, full128, x_full, 0, bs, 0)

    d128 = abs(c32 - 128)
    # border col x==0: forced mv=-1, sad vs 128 (Encoder.py:1020-1024)
    b128 = d128.reshape(nbr, bs, nbc, bs).sum(axis=(1, 3))
    mv = _set_col(mv, 0, xp.full((nbr,), -1, dtype=xp.int32), xp)
    sad = _set_col(sad, 0, b128[:, 0], xp)

    out = {"mv": mv, "sad": sad}
    if vbs:
        qmv = []
        qsad = []
        for dr, dc in _QUAD_OFFS:
            x_sub = x_full + dc * s
            band_q = [b[dr::2, :] for b in colsums]  # (nbr, w) rows of this quad
            mv_q, sad_q = search(band_q, col128[dr::2, :], x_sub, dc * s, s, dc)
            qmv.append(mv_q)
            qsad.append(sad_q)
        out["sub_mv"] = xp.stack(qmv, axis=-1)
        out["sub_sad"] = xp.stack(qsad, axis=-1)
    return out


def _set_col(arr, c, vals, xp):
    if xp is np:
        arr = arr.copy()
        arr[:, c] = vals
        return arr
    return arr.at[:, c].set(vals)


def intra_residuals_mode0(cur, mv, sub_mv, bs: int, xp, sr: int | None = None):
    """Residuals for chosen intra MVs (unquantized: cur - masked window).

    mv: (nbr, nbc); sub_mv: (nbr, nbc, 4) or None.
    Returns full (nb, bs, bs) int32 and quads (nb, 4, s, s) int32 or None.
    Chosen mvs never read cols >= x_parent from the original (those windows
    are all-128 by the causal mask), so gathers stay in-frame.

    With ``sr`` given on the JAX path, the windows are assembled by a masked
    select over the sr+1 possible GLOBAL COLUMN SHIFTS of the frame instead
    of an element gather: the window of the block at x with mv=m reads pixel
    column x' from frame[:, x'+m] — one static slice per shift.
    """
    h, w = cur.shape
    s = bs // 2
    nbr, nbc = h // bs, w // bs
    c32 = cur.astype(xp.int32)

    ys, xs = xp.meshgrid(xp.arange(nbr) * bs, xp.arange(nbc) * bs, indexing="ij")
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)
    cur_blocks = c32.reshape(nbr, bs, nbc, bs).swapaxes(1, 2).reshape(-1, bs, bs)

    if xp is not np and sr is not None:
        import jax.numpy as jnp

        fp = jnp.pad(c32, ((0, 0), (sr, 0)), constant_values=128)
        xcols = jnp.arange(w)
        parent = (xcols // bs) * bs  # parent block x per pixel column

        def band(mv_px):
            """(h, w) prediction band for per-pixel-column mvs (block-const)."""
            pred = jnp.full((h, w), 128, jnp.int32)
            for m in range(-sr, 1):
                shifted = fp[:, sr + m : sr + m + w]
                cond = (mv_px == m) & (xcols[None, :] + m < parent[None, :])
                pred = jnp.where(cond, shifted, pred)
            return pred

        mv_px = jnp.broadcast_to(
            mv.reshape(nbr, 1, nbc, 1), (nbr, bs, nbc, bs)
        ).reshape(h, w)
        pf = band(mv_px)
        full_res = cur_blocks - pf.reshape(nbr, bs, nbc, bs).swapaxes(1, 2).reshape(-1, bs, bs)
        quads_res = None
        if sub_mv is not None:
            # quads share the mask structure (from_orig is 'read col <
            # PARENT block x' for quads too: d + j < -delta, delta = x_sub -
            # x_parent); expand sub_mv to pixel columns at quad granularity
            smv = sub_mv.reshape(nbr, nbc, 2, 2)  # [.., dr, dc] Z order
            smv_px = jnp.broadcast_to(
                smv.transpose(0, 2, 1, 3)[:, :, None, :, :, None], (nbr, 2, s, nbc, 2, s)
            ).reshape(h, w)
            pq = band(smv_px)
            qb = pq.reshape(nbr, bs, nbc, bs).swapaxes(1, 2).reshape(-1, bs, bs)
            quads_res = (
                (cur_blocks - qb).reshape(-1, 2, s, 2, s).swapaxes(2, 3).reshape(-1, 4, s, s)
            )
        return full_res, quads_res

    def window(x_sub, y_sub, d, delta: int, n: int):
        j = xp.arange(n)
        from_orig = (d[:, None] + j[None, :]) < -delta  # (nb, n)
        cols = xp.clip(x_sub[:, None] + d[:, None] + j[None, :], 0, w - 1)
        rows = y_sub[:, None] + j[None, :]
        vals = c32[rows[:, :, None], cols[:, None, :]]
        return xp.where(from_orig[:, None, :], vals, 128)

    mvf = mv.reshape(-1)
    win = window(xs, ys, mvf, 0, bs)
    border = (xs == 0)[:, None, None]
    win = xp.where(border, 128, win)
    full_res = cur_blocks - win

    quads_res = None
    if sub_mv is not None:
        qmv = sub_mv.reshape(-1, 4)
        parts = []
        for qi, (dr, dc) in enumerate(_QUAD_OFFS):
            wq = window(xs + dc * s, ys + dr * s, qmv[:, qi], dc * s, s)
            curq = cur_blocks[:, dr * s : dr * s + s, dc * s : dc * s + s]
            parts.append(curq - wq)
        quads_res = xp.stack(parts, axis=1)
    return full_res, quads_res


def intra_reconstruct_mode0(residual_full, residual_quads, split, mv, sub_mv, h: int, w: int, bs: int, xp,
                            sr: int | None = None):
    """Sequential intra reconstruction (quantized residuals), mode 0.

    residual_full: (nb, bs, bs) int (dequant+IDCT values); residual_quads:
    (nb, 4, s, s) or None; split: (nb,) bool; mv: (nb,), sub_mv: (nb, 4).
    Twin of reconstruct_frame_intra / decode_frame_intra for mode 0,
    vectorized over block rows, scanning block columns.  Returns (h, w) int32
    (caller applies the uint8 cast).

    ``sr`` (the search range bounding |mv|) switches the JAX scan step from a
    per-step element gather to a dynamic-sliced region + masked select over
    the sr+1 possible shifts.
    """
    s = bs // 2
    nbr, nbc = h // bs, w // bs
    rf = residual_full.reshape(nbr, nbc, bs, bs)
    rq = None if residual_quads is None else residual_quads.reshape(nbr, nbc, 4, s, s)
    sp = split.reshape(nbr, nbc)
    mvr = mv.reshape(nbr, nbc)
    smv = None if sub_mv is None else sub_mv.reshape(nbr, nbc, 4)

    if xp is np:
        band = np.full((nbr, bs, w), 128, dtype=np.int64)
        for c in range(nbc):
            band = _recon_step_np(band, c, bs, s, rf, rq, sp, mvr, smv, w)
        return band.reshape(h, w)
    if sr is not None and sr < bs:
        return _intra_reconstruct_jax_wavefront(rf, rq, sp, mvr, smv, h, w, bs, sr)
    if sr is not None:
        return _intra_reconstruct_jax_select(rf, rq, sp, mvr, smv, h, w, bs, sr)
    return _intra_reconstruct_jax(rf, rq, sp, mvr, smv, h, w, bs)


def _recon_step_np(band, c, bs, s, rf, rq, sp, mvr, smv, w):
    nbr = band.shape[0]
    x = c * bs
    j = np.arange(bs)
    if x == 0:
        win = np.full((nbr, bs, bs), 128, dtype=band.dtype)
    else:
        cols = (x + mvr[:, c])[:, None] + j[None, :]
        win = band[np.arange(nbr)[:, None, None], j[None, :, None], cols[:, None, :]]
    blk = win + rf[:, c]
    if rq is not None:
        sel = sp[:, c]
        if sel.any():
            js = np.arange(s)
            parts = []
            for qi, (dr, dc) in enumerate(_QUAD_OFFS):
                xq = x + dc * s
                colsq = (xq + smv[:, c, qi])[:, None] + js[None, :]
                rows = dr * s + js
                winq = band[np.arange(nbr)[:, None, None], rows[None, :, None], colsq[:, None, :]]
                parts.append(winq + rq[:, c, qi])
            top = np.concatenate([parts[0], parts[1]], axis=2)
            bot = np.concatenate([parts[2], parts[3]], axis=2)
            blk_sp = np.concatenate([top, bot], axis=1)
            blk = np.where(sel[:, None, None], blk_sp, blk)
    band = band.copy()
    band[:, :, x : x + bs] = blk
    return band


def _intra_reconstruct_jax(rf, rq, sp, mvr, smv, h, w, bs):
    import jax
    import jax.numpy as jnp

    s = bs // 2
    nbr, nbc = rf.shape[:2]
    band0 = jnp.full((nbr, bs, w), 128, dtype=jnp.int32)
    j = jnp.arange(bs)
    js = jnp.arange(s)

    def step(band, c):
        x = c * bs
        cols = jnp.clip(x + mvr[:, c], 0, w - bs)[:, None] + j[None, :]
        win = band[jnp.arange(nbr)[:, None, None], j[None, :, None], cols[:, None, :]]
        win = jnp.where(c == 0, 128, win)
        blk = win + rf[:, c]
        if rq is not None:
            parts = []
            for qi, (dr, dc) in enumerate(_QUAD_OFFS):
                xq = x + dc * s
                colsq = jnp.clip(xq + smv[:, c, qi], 0, w - s)[:, None] + js[None, :]
                rows = dr * s + js
                winq = band[jnp.arange(nbr)[:, None, None], rows[None, :, None], colsq[:, None, :]]
                parts.append(winq + rq[:, c, qi])
            top = jnp.concatenate([parts[0], parts[1]], axis=2)
            bot = jnp.concatenate([parts[2], parts[3]], axis=2)
            blk_sp = jnp.concatenate([top, bot], axis=1)
            blk = jnp.where(sp[:, c][:, None, None], blk_sp, blk)
        band = jax.lax.dynamic_update_slice(band, blk, (0, 0, x))
        return band, None

    band, _ = jax.lax.scan(step, band0, jnp.arange(nbc))
    return band.reshape(h, w)


def _intra_reconstruct_jax_select(rf, rq, sp, mvr, smv, h, w, bs, sr):
    """Column scan with a left-padded band: each step dynamic-slices the
    (sr + bs)-wide region left of the write frontier once, then assembles the
    window by selecting among the sr+1 static shifts (mv is always in
    [-sr, 0]: intra search never reads across the write frontier)."""
    import jax
    import jax.numpy as jnp

    s = bs // 2
    nbr, nbc = rf.shape[:2]
    band0 = jnp.full((nbr, bs, w + sr), 128, dtype=jnp.int32)  # sr pad cols on the left

    def select_win(region, mv_c, r0, c0, n):
        """region: (nbr, bs, sr+bs); window n x n at rows r0.., col offset c0
        with per-block-row shift mv_c (nbr,)."""
        win = jnp.full((nbr, n, n), 128, jnp.int32)
        for m in range(-sr, 1):
            cand = region[:, r0 : r0 + n, c0 + sr + m : c0 + sr + m + n]
            win = jnp.where((mv_c == m)[:, None, None], cand, win)
        return win

    def step(band, c):
        x = c * bs
        region = jax.lax.dynamic_slice(band, (0, 0, x), (nbr, bs, sr + bs))
        win = select_win(region, mvr[:, c], 0, 0, bs)
        win = jnp.where(c == 0, 128, win)
        blk = win + rf[:, c]
        if rq is not None:
            parts = []
            for qi, (dr, dc) in enumerate(_QUAD_OFFS):
                winq = select_win(region, smv[:, c, qi], dr * s, dc * s, s)
                parts.append(winq + rq[:, c, qi])
            top = jnp.concatenate([parts[0], parts[1]], axis=2)
            bot = jnp.concatenate([parts[2], parts[3]], axis=2)
            blk_sp = jnp.concatenate([top, bot], axis=1)
            blk = jnp.where(sp[:, c][:, None, None], blk_sp, blk)
        band = jax.lax.dynamic_update_slice(band, blk, (0, 0, x + sr))
        return band, None

    band, _ = jax.lax.scan(step, band0, jnp.arange(nbc))
    return band[:, :, sr:].reshape(h, w)


def _intra_reconstruct_jax_wavefront(rf, rq, sp, mvr, smv, h, w, bs, sr):
    """Bounded-depth parallel reconstruction for sr < bs (round-3).

    The column scan looks like an nbc-long chain, but the TRUE dependency
    depth is bounded: block c reads at most the last |mv| <= sr columns of
    block c-1, and column x-k of block c-1 holds real (non-fill) data only
    if |mv_{c-1}| > bs - k — so the reach decays by at least bs - sr per
    hop.  Worst-case depth D = ceil(bs / (bs - sr)) - 1 (sr=8, bs=16: D=1),
    so D+1 PARALLEL passes reach the sequential fixpoint exactly: every
    pass recomputes all blocks from the previous iterate, with the >= x
    half of each block's read region pinned to the 128 fill (the sequential
    semantics read pre-write state right of the frontier).  The 80-step
    720p scan of tiny serialized ops becomes 2 whole-frame passes.  Values carry unwrapped int32 exactly like the scans: wrap at
    the end == wrap before every read, mod 256.
    """
    import jax.numpy as jnp

    s = bs // 2
    nbr, nbc = rf.shape[:2]
    q, r = divmod(bs, bs - sr)
    iters = q + (1 if r else 0)  # D + 1
    tail128 = jnp.full((nbr, nbc, bs, bs), 128, jnp.int32)

    def select_all(regions, mv_cols, r0, c0, n):
        # regions: (nbr, nbc, bs, sr+bs); mv_cols: (nbr, nbc) in [-sr, 0]
        # (anything else keeps the 128 default — same corrupt-stream
        # hardening as the scan's select)
        win = jnp.full((nbr, nbc, n, n), 128, jnp.int32)
        for m in range(-sr, 1):
            cand = regions[:, :, r0 : r0 + n, c0 + sr + m : c0 + sr + m + n]
            win = jnp.where((mv_cols == m)[:, :, None, None], cand, win)
        return win

    band = jnp.full((nbr, bs, w), 128, jnp.int32)
    for _ in range(iters):
        padded = jnp.pad(band, ((0, 0), (0, 0), (sr, 0)), constant_values=128)
        # block c's read region: its last-sr-columns view of the previous
        # iterate (cols [x-sr, x)) plus bs columns of fill — positions >= x
        # are NEVER the iterate's values (the frontier rule above)
        left = jnp.stack([padded[:, :, c * bs : c * bs + sr] for c in range(nbc)], axis=1)
        regions = jnp.concatenate([left, tail128], axis=3)
        blk = select_all(regions, mvr, 0, 0, bs) + rf
        if rq is not None:
            parts = []
            for qi, (dr, dc) in enumerate(_QUAD_OFFS):
                winq = select_all(regions, smv[:, :, qi], dr * s, dc * s, s)
                parts.append(winq + rq[:, :, qi])
            top = jnp.concatenate([parts[0], parts[1]], axis=3)
            bot = jnp.concatenate([parts[2], parts[3]], axis=3)
            blk_sp = jnp.concatenate([top, bot], axis=2)
            blk = jnp.where(sp[:, :, None, None], blk_sp, blk)
        band = blk.transpose(0, 2, 1, 3).reshape(nbr, bs, w)
    return band.reshape(h, w)
