"""Fast-ME (3x3 MVP-chain search) as batched array programs.

The reference's fast ME (Encoder.py:719-742) recenters every block's 3x3
candidate window on its raster predecessor's MV, so each block reads a small
window at a *data-dependent* position, and the Jacobi chain solve needs tens
of sweeps on lossy references.  This module batches the whole eval:

* ``window_gather``: the per-block dynamic window read as two 0/1
  matmuls (one-hot row/column selectors).  Out-of-plane indices match no
  one-hot column and read EXACT zeros — which is precisely the reference's
  zero-fill semantics for out-of-frame reads, so no padding and no clamping
  exist anywhere on this path.
* ``eval9`` / ``pick9``: the 9-candidate SAD + winner logic of
  ``me.fast_candidates`` (strict-improvement scan order (ref, dx, dy),
  quirk-K7 candidate bounds, K8 fallback to the MVP itself) vectorized over
  blocks.  Under FME the windows come from the four half-pel parity planes
  (``me.fme_parity_planes``) — the (2H-1, 2W-1) upsample is never
  materialized — via a per-block parity decomposition: candidate
  (dy, dx) = g + (di-1, dj-1) lives in parity plane ((g+di+1) % 2, ...) at
  plane offset ((g+di+1) // 2 - (g+1) // 2) in {0, 1}, so one
  (n+2)-square region per parity plane serves all nine candidates through
  static slices + parity selects.
* ``confirm``: one extra batched pass at the converged MVPs that returns
  the four VBS quad searches (their windows live inside the SAME regions —
  no second gather) and the winner predictions with bit-exact ``pred.gather_predictions`` semantics
  (case A/B/C: the g2 stride-2 window, the all-128 margin fallback, and the
  g1 stride-1 zero-filled window are all reconstructed from the fetched
  regions; g1's parity interleave is a static 2x2 sub-grid merge).

Engines drive these through a row-segmented chain solve (see
JaxCodec._fast_search_rowscan / ShardedCodec._fast_tile_rowscan): a
lax.scan over block columns is EXACT within each block row, so the Jacobi
iteration runs only over the per-row seed MVs (the raster chain's
row-to-row hand-off) and converges in a couple of outer passes instead of
one sweep per MV-field discontinuity chain.
"""
from __future__ import annotations

import numpy as np

from . import me as M

_INF32 = np.int32(2**31 - 1)

_seg_mult_warned: set = set()


def resolve_seg_mult(req, nbc: int) -> int:
    """Resolved rowscan segment multiplier k (a divisor of nbc; the chain is
    cut into k*nbr segments of nbc/k blocks).  "auto" = 1: Jacobi seed
    corrections travel one segment per outer pass, so more segments mean
    more passes.  Explicit requests round
    DOWN to the nearest divisor of nbc, with a one-time warning when the
    effective k differs from the request (a benchmark asking for a specific
    k must not silently measure a different one)."""
    if req == "auto":
        return 1
    k = max(1, min(int(req), nbc))
    while nbc % k:
        k -= 1
    if k != req and (req, nbc) not in _seg_mult_warned:
        _seg_mult_warned.add((req, nbc))
        import warnings

        warnings.warn(
            f"fast_me_seg_mult={req} is not a divisor of nbc={nbc}; "
            f"running the nearest divisor k={k}",
            stacklevel=3,
        )
    return k


_lookahead_warned: set = set()


def resolve_lookahead(req, seg_len: int, n_segments: int) -> int:
    """Resolved rowscan lookahead (chain columns per scan step) — the ONE
    rule for both engines (JaxCodec and ShardedCodec share it so they
    cannot drift).

    "auto" = k=4 on >= 32-segment batches, else 1: per-pass gather work is
    k-independent while sequential steps drop k-fold, but on small frames the
    per-step cost is op-count-bound.  The rule is inherited from the first
    build and not yet measured on the H100.  Explicit requests clamp to
    [1, seg_len]; when the effective k differs from an explicit request a
    one-time warning fires (a benchmark asking for a specific k must not
    silently measure a different one — the resolve_seg_mult discipline)."""
    k = (4 if n_segments >= 32 else 1) if req == "auto" else int(req)
    k = max(1, min(k, seg_len))
    if req != "auto" and k != req and (req, seg_len) not in _lookahead_warned:
        _lookahead_warned.add((req, seg_len))
        import warnings

        warnings.warn(
            f"fast_me_lookahead={req} is not servable (segment length "
            f"{seg_len}); running the effective k={k}",
            stacklevel=3,
        )
    return k


def plane_stack(refs, fme: bool, xp, wrap_row_pass: bool = True):
    """(nref, h, w) raw reference frames -> bf16 candidate planes.

    FME: (nref*4, h, w) half-pel parity planes (me.fme_parity_planes order
    [p00, p01, p10, p11], py-major; plane (py, px) = upsample[py::2, px::2]
    zero-padded to (h, w) — those pad entries stand for upsample coordinates
    beyond 2h-2/2w-2 and must read as 0, which they do).  Whole-pel:
    (nref, h, w) the frames themselves.

    bf16 is exact for pixel-range integers (<= 255 after the ceil-average
    half-pel interpolation), so the one-hot window gather's bf16 products
    with f32 accumulation are exact.
    """
    import jax

    if fme:
        planes = jax.vmap(lambda r: M.fme_parity_planes(r, xp, wrap_row_pass=wrap_row_pass))(refs)
        planes = planes.reshape(-1, refs.shape[-2], refs.shape[-1])
    else:
        planes = refs.astype(xp.int32)
    return planes.astype(xp.bfloat16)


def window_gather(planes, by0, bx0, nwin: int, xp, chunk_bytes: int = 32 << 20,
                  nwin_c: int | None = None):
    """windows[b, p, i, j] = planes[p, by0[b]+i, bx0[b]+j], 0 out of plane.

    planes (P, H, W) bf16; by0/bx0 (nb,) int32 window origins in plane
    coordinates (any value — out-of-plane indices hit no one-hot column and
    produce exact zeros).  Returns (nb, P, nwin, nwin_c) int32 — windows are
    square unless ``nwin_c`` widens the column span (the lookahead chain
    step's multi-column wide windows).

    Two matmuls per chunk, ordered by window shape.  Square windows
    (the confirm pass, k=1 sweeps): columns first ((P*H, W) @ (W, nc*nwin_c)
    — one large plain matmul), then rows (per-block batched (nwin, H) @
    (H, P*nwin_c)); the (nc, P, H, nwin_c) f32 intermediate is the smaller
    one.  WIDE
    windows (nwin_c > nwin: the lookahead chain step, whose column span
    grows ~k-fold) flip to rows first — the first contraction's cost scales
    with the OUTPUT axis it keeps (rows: n+k+1 vs columns: ~k(n+1)), so
    rows-first cuts the per-step FLOPs ~wc/nwin-fold (3x at k=4) and
    shrinks the intermediate to (nc, P, nwin, W).  One-hot operands and
    integer plane values make both products exact in bf16 with f32
    accumulation.  ``chunk_bytes`` bounds the f32 intermediate; blocks are
    processed in equal chunks via lax.map.
    """
    import jax

    if nwin_c is None:
        nwin_c = nwin
    P, H, W = planes.shape
    nb = by0.shape[0]
    rows_first = nwin_c > nwin
    per_block = (P * nwin * W * 4) if rows_first else (P * H * nwin_c * 4)
    nc = max(1, min(nb, chunk_bytes // per_block))
    nchunk = -(-nb // nc)

    def fetch(args):
        byc, bxc = args  # (nc,)
        jj = bxc[:, None] + xp.arange(nwin_c)[None, :]  # (nc, nwin_c)
        cs = (jj[:, None, :] == xp.arange(W)[None, :, None]).astype(xp.bfloat16)
        ii = byc[:, None] + xp.arange(nwin)[None, :]
        rs = (ii[:, :, None] == xp.arange(H)[None, None, :]).astype(xp.bfloat16)
        if rows_first:
            rowf = xp.einsum("bih,phw->bpiw", rs, planes,
                             preferred_element_type=xp.float32)
            win = xp.einsum("bpiw,bwj->bpij", rowf.astype(xp.bfloat16), cs,
                            preferred_element_type=xp.float32)
        else:
            colf = xp.einsum("phw,bwj->bphj", planes, cs,
                             preferred_element_type=xp.float32)
            win = xp.einsum("bih,bphj->bpij", rs, colf.astype(xp.bfloat16),
                            preferred_element_type=xp.float32)
        return win.astype(xp.int32)

    if nchunk == 1:
        return fetch((by0, bx0))
    padn = nchunk * nc - nb
    byp = xp.concatenate([by0, xp.full((padn,), -(10**6), by0.dtype)])
    bxp = xp.concatenate([bx0, xp.full((padn,), -(10**6), bx0.dtype)])
    wins = jax.lax.map(fetch, (byp.reshape(nchunk, nc), bxp.reshape(nchunk, nc)))
    return wins.reshape(nchunk * nc, P, nwin, nwin_c)[:nb]


def resolve_fetch_mode(req: str, h: int, w: int, nplanes: int = 4) -> str:
    """Fast-ME window-fetch mode.  "auto" picks by total plane bytes: the
    one-hot gather's per-block cost is O(P*H*W) (it contracts every plane
    in full), so it suits small stacks, while the vmapped clamped-
    dynamic_slice gather is area-independent.  The 2.5 Mpx cut is inherited
    from the first build and not yet measured on the H100; explicit
    "xla"/"slice" force a path."""
    if req in ("xla", "slice"):
        return req
    return "slice" if nplanes * h * w > 2_500_000 else "xla"


def window_prep(planes, nwin: int, mode, wide=None):
    """Per-frame window-read preparation, by mode:

    * "slice": planes zero-padded by the LARGEST read extents and stored
      uint8 — window_read then uses clamped ``lax.dynamic_slice``, which is
      EXACT zero-fill: with pad >= the window extent on each axis, any
      clamped start lands entirely inside the zero pad exactly when the true
      window is entirely out of plane, and un-clamped reads see the same
      zeros the one-hot gather produces positionally.
    * "xla": the raw planes for the one-hot gather.

    ``wide`` = (rows, cols) of the lookahead wide window when larger than
    the square ``nwin`` (the pad must cover the largest read on both
    paths)."""
    if mode == "slice":
        import jax.numpy as jnp

        pr = max(nwin, wide[0] if wide else 0)
        pc = max(nwin, wide[1] if wide else 0)
        padded = jnp.pad(planes.astype(jnp.uint8), ((0, 0), (pr, pr), (pc, pc)))
        return ("slice", (padded, pr, pc))
    return ("xla", planes)


def window_read(prep, by0, bx0, nwin: int, xp, nwin_c: int | None = None):
    """windows[b, p, i, j] = planes[p, by0[b]+i, bx0[b]+j], 0 out of plane —
    through the handle from window_prep.  Bit-identical either way: a
    clamped dynamic_slice on zero-padded planes, or the one-hot gather
    (window_gather).  Rectangular windows (``nwin_c`` — the lookahead chain
    step's wide windows) are served by both."""
    import jax
    from jax import lax

    kind, data = prep
    with jax.named_scope("fastme_window"):
        if kind != "slice":
            return window_gather(data, by0, bx0, nwin, xp, nwin_c=nwin_c)
        padded, pr, pc = data
        nc = nwin if nwin_c is None else nwin_c
        P = padded.shape[0]

        def one(y, x):
            # negative starts must clamp to 0, not wrap from the far edge:
            # an origin beyond the pad (a K8 fallback MVP far out of frame)
            # would otherwise read real pixels where the window is all zeros
            return lax.dynamic_slice(padded, (0, y + pr, x + pc), (P, nwin, nc),
                                     allow_negative_indices=False)

        return jax.vmap(one)(by0, bx0).astype(xp.int32)


def _region_base(g, y, x, n: int, fme: bool, xp):
    """Window-stack origin for the 3x3 search around MVP ``g``.

    FME: plane coordinates (y + (gy-1)//2, x + (gx-1)//2) — floor division,
    so the nine candidates' parity-plane rows sit at static offsets {0, 1}
    from it.  Whole-pel: (y + gy - 1, x + gx - 1)."""
    gx, gy = g[:, 0], g[:, 1]
    if fme:
        return y + (gy - 1) // 2, x + (gx - 1) // 2
    return y + gy - 1, x + gx - 1


def _cand_valid(g, X, Y, n: int, dims, nref: int, nvalid, xp):
    """(nb, nref, 3, 3) candidate validity: quirk-K7 bounds of
    me.fast_candidates (strictly tighter than case A on both edges) plus the
    reference-FIFO population mask."""
    H, W = dims
    d = xp.arange(-1, 2)
    px = (X[:, None] + g[:, None, 0] + d[None, :])  # (nb, 3) by dxi
    py = (Y[:, None] + g[:, None, 1] + d[None, :])
    okx = (px >= 0) & (px < W - n) & (px + 2 * n >= 0) & (px + 2 * n < W - n)
    oky = (py >= 0) & (py < H - n) & (py + 2 * n >= 0) & (py + 2 * n < H - n)
    valid = oky[:, None, :, None] & okx[:, None, None, :]  # (nb, 1, dyi, dxi)
    ok = xp.broadcast_to(valid, (valid.shape[0], nref, 3, 3))
    if nvalid is not None:
        ok = ok & (xp.arange(nref)[None, :, None, None] < nvalid)
    return ok


def pick9(sads, valid, g, xp):
    """Winner of the 3x3 fast-ME search, me.fast_candidates semantics:
    first minimum in (ref, dx, dy) scan order (strict improvement), K8
    fallback to the MVP itself when no candidate is valid.

    sads/valid (nb, nref, 3, 3) indexed [ref, dyi, dxi]; g (nb, 3) the MVP
    [gx, gy, gref].  Returns mv (nb, 3), sad (nb,) int32."""
    nb, nref = sads.shape[:2]
    sm = xp.where(valid, sads, _INF32)
    order = sm.transpose(0, 1, 3, 2).reshape(nb, nref * 9)  # ref-major, dx, dy
    k = xp.argmin(order, axis=-1)
    best = xp.min(order, axis=-1)
    ref_i = (k // 9).astype(xp.int32)
    dxi = ((k % 9) // 3).astype(xp.int32)
    dyi = (k % 3).astype(xp.int32)
    ok = best != _INF32
    mv = xp.where(
        ok[:, None],
        xp.stack([g[:, 0] + dxi - 1, g[:, 1] + dyi - 1, ref_i], axis=-1),
        g,
    ).astype(xp.int32)
    return mv, xp.where(ok, best, _INF32).astype(xp.int32), dyi, dxi, ok


def _sad_stack(w, cur, n: int, no: int, xp):
    """out[..., oy, ox] = sum |w[..., oy:oy+n, ox:ox+n] - cur| for
    oy, ox in [0, no): the shifted-window SAD grid as TWO stacks of static
    slices + one abs-diff + one reduction.  The per-(oy, ox) slice-reduce
    form emits no^2 separate fusions whose fixed cost dominates latency-
    sensitive callers (the rowscan scan step).  ``cur`` must broadcast against
    w's leading dims with the trailing (n, n) window."""
    rstk = xp.stack([w[..., oy : oy + n, :] for oy in range(no)], axis=-3)
    cstk = xp.stack([rstk[..., ox : ox + n] for ox in range(no)], axis=-3)
    return xp.abs(cstk - cur[..., None, None, :, :]).sum((-2, -1))


def _sad16_select(sad16, ay, ax, dyi: int, dxi: int, xp):
    """Candidate (dyi, dxi) SAD from the 16 parity-combination SADs.

    sad16 (nb, nref, 2, 2, 2, 2) indexed [pyp, pxp, oy, ox]; the mapping
    (parity of the MVP, candidate index) -> (plane parity, region offset) is
    t = dyi + 1 - ay -> (t % 2, t // 2), selected per block over the four
    (ay, ax) combinations."""
    out = None
    for av in (0, 1):
        ty = dyi + 1 - av
        for bv in (0, 1):
            tx = dxi + 1 - bv
            cand = sad16[:, :, ty % 2, tx % 2, ty // 2, tx // 2]
            m = ((ay == av) & (ax == bv))[:, None]
            out = xp.where(m, cand, out) if out is not None else xp.where(m, cand, cand)
    return out


def eval9(win, cur_blk, g, X, Y, n: int, dims, fme: bool, nvalid, xp):
    """The batched 3x3 fast-ME step: windows from window_gather around each
    block's MVP, SADs + winner with me.fast_candidates semantics.

    win: (nb, P, nwin, nwin) int32 regions based at _region_base(g);
    cur_blk (nb, n, n) int32; g (nb, 3) MVPs; X/Y (nb,) block origins in
    search coordinates (x2 under FME).  Returns (mv, sad)."""
    nb = win.shape[0]
    if fme:
        nref = win.shape[1] // 4
        w4 = win.reshape(nb, nref, 4, win.shape[-2], win.shape[-1])
        sad16 = _sad_stack(w4, cur_blk[:, None, None], n, 2, xp)
        sad16 = sad16.reshape(nb, nref, 2, 2, 2, 2)  # [pyp, pxp, oy, ox]
        ay, ax = g[:, 1] % 2, g[:, 0] % 2
        sads = xp.stack([
            xp.stack([_sad16_select(sad16, ay, ax, dyi, dxi, xp) for dxi in range(3)], axis=-1)
            for dyi in range(3)
        ], axis=-2)  # (nb, nref, dyi, dxi)
    else:
        nref = win.shape[1]
        sads = _sad_stack(win, cur_blk[:, None], n, 3, xp)
    valid = _cand_valid(g, X, Y, n, dims, nref, nvalid, xp)
    mv, sad, _, _, _ = pick9(sads, valid, g, xp)
    return mv, sad


# ------------------- speculative multi-column lookahead chain steps --------
#
# The rowscan chain solve is bounded by information propagation: each lax.scan
# step resolves ONE block column per segment, and per-step latency dwarfs
# per-step compute.  The winner of a 3x3 fast-ME step always
# sits at MVP + delta with delta in {-1,0,1}^2 (the K8 fallback keeps the MVP
# position itself = the center candidate), so a step can resolve k columns at
# once: fetch ONE wide window per segment covering every hypothesis chain,
# compute each column's candidate SADs over its reachable (2i+3)^2 position
# grid with STATIC slices, then resolve the chain with per-column traced
# selects (cheap VPU work) — the expensive gather runs once per k columns at
# the SAME per-column FLOP cost as the k=1 step (the wide window's column
# span per resolved column is n+2 whole-pel / n+1 FME, vs n+2 for k=1).
# Bit-exactness: every sub-window slice of the wide window equals the
# per-column gather (zero-fill is positional), SADs are the same int32 sums,
# and the winner logic is pick9 itself — so the resolved chain is the same
# forward substitution, k columns per step instead of one.


def wide_window_spec(n: int, k: int, fme: bool):
    """(rows, cols) of the per-segment wide window serving k consecutive
    chain columns under every hypothesis chain.  Column i's MVP position
    drifts at most +-i from the seed MVP and its 9 candidates +-1 more, so
    whole-pel needs n+2k rows and n per extra column; FME plane coordinates
    halve the drift (offsets ride the parity decomposition) -> n+k+1 rows
    (k=1 reproduces eval9's n+2)."""
    rows = (n + k + 1) if fme else (n + 2 * k)
    return rows, n * (k - 1) + rows


def _wide_base(g, y, x0, k: int, fme: bool, xp):
    """Wide-window origin for the 3x3 searches of k chain columns whose
    first column's MVP is ``g`` (block origins (y, x0), unscaled pixels).
    FME: plane coordinates (floor((gy - k)/2)); k=1 reproduces _region_base."""
    gx, gy = _col(g, 0, xp), _col(g, 1, xp)
    if fme:
        return y + (gy - k) // 2, x0 + (gx - k) // 2
    return y + gy - k, x0 + gx - k


def _fme_off(p: int, e: int, k: int):
    """(plane parity, plane offset) of upsample offset ``e`` from the wide
    base when the seed MVP's coordinate parity is ``p``:
    q = (p+e) % 2, o = floor((p+e)/2) + (k-p+1)//2  (o in [0, k] for |e|<=k)."""
    t = p + e
    return t % 2, (t - (t % 2)) // 2 + (k - p + 1) // 2


def _sad_grid_wpel(wide, cur, i: int, n: int, k: int, xp):
    """Whole-pel candidate-position SAD grid for lookahead column ``i``:
    grid[s, ref, a, b] = SAD at window start (k-i-1+a, n*i + k-i-1+b),
    a, b in [0, 2i+2] — every position column i can reach (cumulative drift
    +-i plus candidate +-1).  wide (S, nref, R, C) int32, cur (S, n, n).

    Built as shifted-window STACKS (two concats of static slices) + ONE
    abs-diff + ONE reduction: the naive per-(a, b) slice-reduce form emits
    (2i+3)^2 separate fusions whose fixed per-fusion cost dominates the scan
    step."""
    na = 2 * i + 3
    o0 = k - i - 1
    span = wide[:, :, o0 : o0 + na - 1 + n, n * i + o0 : n * i + o0 + na - 1 + n]
    return _sad_stack(span, cur[:, None], n, na, xp)  # (S, nref, a, b)


def _sad_grid_fme(w4, cur, i: int, n: int, k: int, xp):
    """FME candidate SAD grid for lookahead column ``i`` over the parity
    planes: grid[s, ref, qy, oy, qx, ox] with (qy, qx) the plane parity and
    (oy, ox) plane offsets in [o_lo, o_hi] (the reachable range for
    |e| <= i+1; indices are stored relative to o_lo).  w4 (S, nref, 4, R, C).
    Returns (grid, o_lo).  Stack-then-reduce form (see _sad_grid_wpel)."""
    offs = [_fme_off(p, e, k)[1] for p in (0, 1) for e in range(-(i + 1), i + 2)]
    o_lo, o_hi = min(offs), max(offs)
    no = o_hi - o_lo + 1
    span = w4[:, :, :, o_lo : o_hi + n, n * i + o_lo : n * i + o_hi + n]
    g = _sad_stack(span, cur[:, None, None], n, no, xp)  # (S, nref, 4, oy, ox)
    S, nref = g.shape[:2]
    return g.reshape(S, nref, 2, 2, no, no).transpose(0, 1, 2, 4, 3, 5), o_lo


def _select_axis_wpel(grid, c, i: int, axis_from_end: int, xp):
    """Pick the 3 candidate entries (d in {0,1,2} -> index c + d + i) from a
    (2i+3)-long position axis, given the traced cumulative offset c (S,).
    axis_from_end: 2 = rows (second-to-last), 1 = cols (last).

    One-hot CONTRACTION, not a where-chain: a 3*(2i+3) take+where unroll
    puts ~100 separate fusions per resolved column into the scan body.  The
    contraction is exact: the
    one-hot is integer 0/1, exactly one entry per (s, d) matches (|c| <= i
    by construction — drift only accrues on accepted candidates), so the
    integer product-sum IS the selected SAD."""
    na = 2 * i + 3
    oh = ((c[:, None, None] + xp.arange(3)[None, :, None] + i)
          == xp.arange(na)[None, None, :]).astype(grid.dtype)  # (S, 3, na)
    if axis_from_end == 2:  # grid (S, nref, na, B) -> (S, nref, 3, B)
        return (grid[:, :, None, :, :] * oh[:, None, :, :, None]).sum(3)
    # last axis: grid (S, nref, 3, na) -> (S, nref, 3, 3)
    return (grid[:, :, :, None, :] * oh[:, None, None, :, :]).sum(-1)


def _fme_onehot(c, par, i: int, k: int, o_lo: int, no: int, xp):
    """(S, 3, 2, no) one-hot of the FME candidate location: for d in
    {0,1,2}, upsample offset e = c + d - 1 lives in plane parity q and
    plane offset o (_fme_off with the seed parity ``par``), both computed
    ARITHMETICALLY on the traced (c, par) vectors:
    t = par + e -> q = t % 2, o = (t - q)/2 + (k - par + 1)//2."""
    t = par[:, None] + c[:, None] + xp.arange(3)[None, :] - 1  # (S, 3)
    q = t % 2
    o = (t - q) // 2 + (k - par[:, None] + 1) // 2 - o_lo
    return ((xp.arange(2)[None, None, :, None] == q[:, :, None, None])
            & (xp.arange(no)[None, None, None, :] == o[:, :, None, None]))


def _select_axis_fme(grid, c, par, i: int, k: int, o_lo: int, pair_axis: int, xp):
    """FME per-axis candidate selection: for d in {0,1,2}, candidate upsample
    offset e = c + d - 1 lives in plane parity q and plane offset o
    (_fme_off with the seed parity ``par``); select the (q, o - o_lo) entry
    of the (2, no) axis pair starting at ``pair_axis``.  c, par (S,) traced.

    One-hot contraction over the (2, no) pair (see _select_axis_wpel).  Exact: integer 0/1 weights, exactly one match per (s, d)."""
    no = grid.shape[pair_axis + 1]
    oh = _fme_onehot(c, par, i, k, o_lo, no, xp).astype(grid.dtype)  # (S,3,2,no)
    if pair_axis == 2:   # grid (S, nref, 2, no, 2, no) -> (S, nref, 3, 2, no)
        return (grid[:, :, None] * oh[:, None, :, :, :, None, None]).sum((3, 4))
    # pair_axis == 3: grid (S, nref, 3, 2, no) -> (S, nref, 3, 3) [dyi, dxi]
    return (grid[:, :, :, None] * oh[:, None, None, :, :, :]).sum((-2, -1))


def eval_chain(wide, curs, g0, xs, ys, n: int, k: int, dims, fme: bool, nvalid,
               colmask, xp):
    """Resolve ``k`` consecutive chain columns from one wide window per
    segment (the speculative lookahead step).  wide (S, P, R, C) int32 from
    window_gather at _wide_base(g0); curs (k, S, n, n) current blocks; g0
    (S, 3) the first column's MVP; xs (k, S) / ys (S,) block origins in
    UNSCALED pixels; colmask (k,) bools — False columns are padding and
    propagate the MVP unchanged (their mv output is the MVP itself).
    Returns mvs (k, S, 3) with mvs[i] = f(mvs[i-1]) exactly (pick9
    semantics per column, K7 bounds, K8 fallback)."""
    S = wide.shape[0]
    scale = 2 if fme else 1
    if fme:
        nref = wide.shape[1] // 4
        w4 = wide.reshape(S, nref, 4, wide.shape[-2], wide.shape[-1])
        pay, pax = g0[:, 1] % 2, g0[:, 0] % 2  # seed MVP parities
    else:
        nref = wide.shape[1]
    g = g0
    cy = xp.zeros((S,), xp.int32)
    cx = xp.zeros((S,), xp.int32)
    mvs = []
    for i in range(k):
        if fme:
            grid, o_lo = _sad_grid_fme(w4, curs[i], i, n, k, xp)
            # grid (S, nref, 2, no, 2, no) [qy, oy, qx, ox]
            gy3 = _select_axis_fme(grid, cy, pay, i, k, o_lo, 2, xp)
            # gy3 (S, nref, 3, 2, no) [dyi, qx, ox]
            sads = _select_axis_fme(gy3, cx, pax, i, k, o_lo, 3, xp)
            # (S, nref, 3, 3) [dyi, dxi]
        else:
            grid = _sad_grid_wpel(wide, curs[i], i, n, k, xp)
            gy3 = _select_axis_wpel(grid, cy, i, 2, xp)  # rows -> (S,nref,3,b)
            sads = _select_axis_wpel(gy3, cx, i, 1, xp)  # cols -> (S,nref,3,3)
        valid = _cand_valid(g, xs[i] * scale, ys * scale, n, dims, nref, nvalid, xp)
        valid = valid & colmask[i]
        mv, _, dyi, dxi, ok = pick9(sads, valid, g, xp)
        mvs.append(mv)
        cy = cy + xp.where(ok, dyi - 1, 0)
        cx = cx + xp.where(ok, dxi - 1, 0)
        g = mv
    return xp.stack(mvs, axis=0)


def _col(a, j: int, xp):
    """a[:, j] as a static slice+squeeze."""
    if xp is np:
        return a[:, j]
    import jax

    return jax.lax.index_in_dim(a, j, 1, keepdims=False)


def confirm_windows_from_stack(wideT, g_fin, n: int, k: int, L: int, S: int,
                               fme: bool, xp):
    """Confirm-pass regions from the FINAL sweep pass's stacked wide windows
    — bit-identical to ``window_gather(planes, *_region_base(g_fin), n+2)``
    without re-gathering all blocks.

    The while-loop exits only after a pass whose seeds equal the converged
    seeds, so the last pass's chunk seeds are exactly g_fin at each chunk's
    first column, and every block's (n+2)-region lies INSIDE its chunk's
    wide window at an offset that is plain arithmetic on the converged MV
    field: with cy = gy_block - gy_chunkseed (drift, |cy| <= k-1),

      whole-pel: row offset a = cy + k - 1                    in [0, 2k-2]
      FME:       a = (p + cy - 1)//2 + (k - p + 1)//2         in [0, k-1]
                 (p = chunk-seed y parity; same for columns with x)

    and the wide window's (n+2k) / (n+k+1) extents fit the extreme offsets
    exactly.  wideT (Lp, S, P, wr, wc) int32 stacked by the scan; g_fin
    (S*L, 3) converged MVPs in chain order (segment-major).  Returns
    (S*L, P, n+2, n+2) in the same chain order."""
    Lp = wideT.shape[0]
    P = wideT.shape[2]
    nw = n + 2
    g = g_fin.reshape(S, L, 3)
    padc = Lp * k - L
    if padc:
        g = xp.concatenate([g, xp.broadcast_to(g[:, -1:], (S, padc, 3))], axis=1)
    gk = g.reshape(S, Lp, k, 3)
    na = k if fme else 2 * k - 1

    def offsets(axis):  # axis 0 = x (columns), 1 = y (rows)
        seed = gk[:, :, 0, axis]
        drift = gk[:, :, :, axis] - seed[:, :, None]  # (S, Lp, k)
        if fme:
            p = seed % 2
            return (p[:, :, None] + drift - 1) // 2 + ((k - p + 1) // 2)[:, :, None]
        return drift + (k - 1)

    ay = offsets(1).swapaxes(0, 1)  # (Lp, S, k)
    bx = offsets(0).swapaxes(0, 1)
    cols = []
    for i in range(k):
        racc = None
        for a0 in range(na):
            m = (ay[:, :, i] == a0)[:, :, None, None, None]
            sl = wideT[:, :, :, a0 : a0 + nw, n * i : n * i + na - 1 + nw]
            racc = sl if racc is None else xp.where(m, sl, racc)
        cacc = None
        for b0 in range(na):
            m = (bx[:, :, i] == b0)[:, :, None, None, None]
            sl = racc[..., b0 : b0 + nw]
            cacc = sl if cacc is None else xp.where(m, sl, cacc)
        cols.append(cacc)  # (Lp, S, P, nw, nw)
    wins = xp.stack(cols, axis=1).reshape(Lp * k, S, P, nw, nw)[:L]
    return wins.swapaxes(0, 1).reshape(S * L, P, nw, nw)


def _ref_select(w, ref, xp):
    """w (nb, nref, ...) -> (nb, ...) rows picked by the traced ref index
    (nref is small; an unrolled select beats a gather)."""
    nref = w.shape[1]
    out = w[:, 0]
    for r in range(1, nref):
        out = xp.where((ref == r).reshape((-1,) + (1,) * (out.ndim - 1)), w[:, r], out)
    return out


def _win16_select(w4, ref, ay, ax, dyi, dxi, n: int, row_extra, col_extra, xp):
    """The stride-2 (g2) window of candidate (dyi, dxi): region slice
    [oy + row_extra : +n, ox + col_extra : +n] of parity plane (pyp, pxp),
    all indices per-block traced -> unrolled static slices + selects.

    w4 (nb, nref, 4, nwin, nwin); dyi/dxi (nb,) traced in {0,1,2};
    row_extra/col_extra static (quad offsets).  Returns (nb, n, n) int32."""
    wr = _ref_select(w4, ref, xp)  # (nb, 4, nwin, nwin)
    out = None
    for av in (0, 1):
        for bv in (0, 1):
            m_ab = (ay == av) & (ax == bv)
            for dy in range(3):
                ty = dy + 1 - av
                for dx in range(3):
                    tx = dx + 1 - bv
                    pl = (ty % 2) * 2 + (tx % 2)
                    r0, c0 = ty // 2 + row_extra, tx // 2 + col_extra
                    cand = wr[:, pl, r0 : r0 + n, c0 : c0 + n]
                    m = (m_ab & (dyi == dy) & (dxi == dx))[:, None, None]
                    out = cand if out is None else xp.where(m, cand, out)
    return out


def _g1_fme(w4, ref, py, px, by0, bx0, n: int, row_extra: int, col_extra: int, xp):
    """The stride-1 zero-filled fallback window (gather_predictions' g1) of
    the FME path, rebuilt from the parity regions: upsample row u = py + r
    lives in parity plane u % 2 at plane row u // 2, so the four (row, col)
    parity sub-grids of g1 are static region slices interleaved back with a
    stack+reshape.  Out-of-upsample reads are exact zeros already (one-hot
    misses and the parity planes' own zero pad rows).

    w4 (nb, nref, 4, nwin, nwin) regions; (by0, bx0) the g1 window's OWN
    plane-coordinate base (the region base plus the quad offset), with
    row_extra/col_extra the static quad offset inside the region; py/px
    (nb,) the window origin in upsample coordinates.  floor(py/2) - by0 is
    in {0, 1} for every transmitted MV (winner or K8 fallback = the MVP,
    both within one half-pel row of the region center).
    Returns (nb, n, n) int32."""
    wr = _ref_select(w4, ref, xp)  # (nb, 4, nwin, nwin)
    a = py % 2  # (nb,) upsample row parity
    b = px % 2
    i0 = py // 2 - by0
    j0 = px // 2 - bx0
    h2 = n // 2
    subs = []
    for s in (0, 1):  # g1 rows s::2 come from row parity (a+s)%2
        row_sub = []
        for t in (0, 1):
            # plane row offset i0 + (a+s)//2: per-block traced in {0,1,2};
            # select among the static starts
            out = None
            for av in (0, 1):
                for bv in (0, 1):
                    pl = ((av + s) % 2) * 2 + ((bv + t) % 2)
                    m_ab = (a == av) & (b == bv)
                    for iv in (0, 1):
                        for jv in (0, 1):
                            r0 = row_extra + iv + (av + s) // 2
                            c0 = col_extra + jv + (bv + t) // 2
                            cand = wr[:, pl, r0 : r0 + h2, c0 : c0 + h2]
                            m = (m_ab & (i0 == iv) & (j0 == jv))[:, None, None]
                            out = cand if out is None else xp.where(m, cand, out)
            row_sub.append(out)
        # interleave columns t=0/1 -> (nb, h2, n)
        subs.append(xp.stack(row_sub, axis=-1).reshape(-1, h2, n))
    # interleave rows s=0/1 -> (nb, n, n)
    return xp.stack(subs, axis=2).reshape(-1, n, n)


def _pred_from_regions(w, ref, mv_x, mv_y, dyi, dxi, X, Y, by0, bx0, n: int,
                       dims, fme: bool, row_extra: int, col_extra: int, xp):
    """Bit-exact pred.gather_predictions for transmitted MVs that are region
    candidates (winner or K8 fallback = the center): FME selects among the
    g2 stride-2 window, the all-128 margin fallback, and the g1 stride-1
    zero-filled window; whole-pel is always the contiguous zero-filled
    window.  fme_margin = n (the block's own size, quirk-K18 residual-path
    semantics)."""
    H, W = dims
    if not fme:
        wr = _ref_select(w, ref, xp)  # (nb, nwin, nwin)
        out = None
        for dy in range(3):
            for dx in range(3):
                cand = wr[:, dy + row_extra : dy + row_extra + n, dx + col_extra : dx + col_extra + n]
                m = ((dyi == dy) & (dxi == dx))[:, None, None]
                out = cand if out is None else xp.where(m, cand, out)
        return out
    nb = w.shape[0]
    w4 = w.reshape(nb, -1, 4, w.shape[-2], w.shape[-1])
    px = X + mv_x
    py = Y + mv_y
    valid1 = (px >= 0) & (px < W - n) & (py >= 0) & (py < H - n)
    valid2 = (px + 2 * n >= 0) & (px + 2 * n < W - n) & (py + 2 * n >= 0) & (py + 2 * n < H - n)
    ay, ax = (mv_y - dyi + 1) % 2, (mv_x - dxi + 1) % 2  # = MVP parity
    g2 = _win16_select(w4, ref, ay, ax, dyi, dxi, n, row_extra, col_extra, xp)
    g1 = _g1_fme(w4, ref, py, px, by0, bx0, n, row_extra, col_extra, xp)
    return xp.where(
        valid1[:, None, None],
        xp.where(valid2[:, None, None], g2, 128),
        g1,
    ).astype(xp.int32)


def confirm(win, cur_blk, cur_quads, g, X, Y, bs: int, sbs: int, dims, fme: bool,
            vbs: bool, nvalid, by0, bx0, xp):
    """One batched pass at the converged MVPs ``g``: the full-block winner
    (identical to eval9 — the confirm re-derives it so its prediction and the
    quad searches come from the same fetched regions), the four VBS quad
    searches (Encoder.py:549-560: quads search the block-level MVP and never
    feed the chain), and winner predictions with gather_predictions
    semantics for both.

    cur_quads (nb, 4, sbs, sbs) quad-order current sub-blocks; X/Y block
    origins in search coordinates; by0/bx0 the region bases the windows were
    fetched at.  Returns dict(mv, sad, ok, pred_full[, sub_mv, sub_sad,
    sub_ok, pred_quads])."""
    nb = win.shape[0]
    scale = 2 if fme else 1
    nwin = win.shape[-1]
    if fme:
        nref = win.shape[1] // 4
        w4 = win.reshape(nb, nref, 4, nwin, nwin)
        sad16 = _sad_stack(w4, cur_blk[:, None, None], bs, 2, xp).reshape(
            nb, nref, 2, 2, 2, 2)
        ay, ax = g[:, 1] % 2, g[:, 0] % 2
        sads = xp.stack([
            xp.stack([_sad16_select(sad16, ay, ax, dyi, dxi, xp) for dxi in range(3)], axis=-1)
            for dyi in range(3)
        ], axis=-2)
    else:
        nref = win.shape[1]
        sads = _sad_stack(win, cur_blk[:, None], bs, 3, xp)
    valid = _cand_valid(g, X, Y, bs, dims, nref, nvalid, xp)
    mv, sad, dyi, dxi, okw = pick9(sads, valid, g, xp)
    # K8 fallback transmits the MVP itself = the center candidate (1, 1)
    one = xp.ones_like(dyi)
    dyi = xp.where(okw, dyi, one)
    dxi = xp.where(okw, dxi, one)
    pred_full = _pred_from_regions(
        win, mv[:, 2], mv[:, 0], mv[:, 1], dyi, dxi, X, Y, by0, bx0, bs, dims, fme, 0, 0, xp
    )
    out = {"mv": mv, "sad": sad, "ok": sad != _INF32, "pred_full": pred_full}
    if not vbs:
        return out
    smvs, ssads, spreds = [], [], []
    for q, (oy_q, ox_q) in enumerate(((0, 0), (0, sbs), (sbs, 0), (sbs, sbs))):
        Xq = X + scale * ox_q
        Yq = Y + scale * oy_q
        cq = cur_quads[:, q]
        if fme:
            span_q = w4[:, :, :, oy_q : oy_q + 1 + sbs, ox_q : ox_q + 1 + sbs]
            qsad16 = _sad_stack(span_q, cq[:, None, None], sbs, 2, xp).reshape(
                nb, nref, 2, 2, 2, 2)
            qsads = xp.stack([
                xp.stack([_sad16_select(qsad16, ay, ax, dyi_, dxi_, xp) for dxi_ in range(3)], axis=-1)
                for dyi_ in range(3)
            ], axis=-2)
        else:
            span_q = win[:, :, oy_q : oy_q + 2 + sbs, ox_q : ox_q + 2 + sbs]
            qsads = _sad_stack(span_q, cq[:, None], sbs, 3, xp)
        qvalid = _cand_valid(g, Xq, Yq, sbs, dims, nref, nvalid, xp)
        qmv, qsad, qdyi, qdxi, qok = pick9(qsads, qvalid, g, xp)
        qdyi = xp.where(qok, qdyi, one)
        qdxi = xp.where(qok, qdxi, one)
        qpred = _pred_from_regions(
            win, qmv[:, 2], qmv[:, 0], qmv[:, 1], qdyi, qdxi, Xq, Yq,
            by0 + oy_q, bx0 + ox_q, sbs, dims, fme, oy_q, ox_q, xp,
        )
        smvs.append(qmv)
        ssads.append(qsad)
        spreds.append(qpred)
    out["sub_mv"] = xp.stack(smvs, axis=1)
    out["sub_sad"] = xp.stack(ssads, axis=1)
    out["sub_ok"] = out["sub_sad"] != _INF32
    out["pred_quads"] = xp.stack(spreds, axis=1)
    return out
