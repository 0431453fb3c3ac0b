"""Native engine: fully-jitted per-frame encode/decode steps (JAX/XLA).

Same pipeline shape as the reference (SURVEY.md section 3) but built as
device array programs:

- per-block Python loops become array programs over the (nb, bs, bs) tiled
  layout: batched int32 DCT/quant, SAD candidate maps, vectorized RD
  selection;
- the exact fixed-point transform (core/transform.py) keeps every pixel
  bit-identical across backends - encode and decode agree on CPU and GPU;
- sequential chains (intra reconstruction, fast-ME MVP propagation) are
  lax.scans with vectorized inner steps;
- one jitted step per frame kind; the GOP loop stays host-side (scene-change
  promotion consumes one scalar per frame).

Deliberate deviations from the compat engine (documented in COMPAT_NOTES.md):
the transform is the exact int32 DCT rather than scipy float (values within
+-1), fast ME reports true SADs in the MAE slot (quirk K6 fixed), and RD
decisions run in float32 on device.  Search semantics (candidates, bounds,
tie-breaks) are identical, so motion vectors match the reference exactly.
"""
from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from streamoptima_tpu import rc as rc_mod
from streamoptima_tpu.config import CodecConfig
from streamoptima_tpu.core import intra as I
from streamoptima_tpu.core import me as M
from streamoptima_tpu.core import pred as P
from streamoptima_tpu.core import rd
from streamoptima_tpu.core.quant import quantize, rescale
from streamoptima_tpu.core.transform import dct2_int, idct2_int
from streamoptima_tpu.core.zigzag import rle_length
from streamoptima_tpu import metrics


def _qpm1_vec(qp):
    return jnp.where(qp > 0, qp - 1, qp)


class JaxCodec:
    """Native JAX encoder/decoder (engine='jax')."""

    def __init__(self, cfg: CodecConfig, y_frames=None):
        assert not cfg.compat
        self.cfg = cfg
        self.y = None if y_frames is None else np.asarray(y_frames, dtype=np.uint8)
        # clip uploaded to device memory once; per-frame device slices avoid
        # a host->device round trip per frame
        self._y_dev = None if self.y is None else jax.device_put(self.y)
        self.h, self.w = cfg.height, cfg.width
        self.bs = cfg.block_size
        self.sbs = cfg.sub_block_size
        self.nbr, self.nbc = cfg.block_rows, cfg.blocks_per_row
        self.nb = self.nbr * self.nbc
        ys, xs = np.meshgrid(np.arange(self.nbr) * self.bs, np.arange(self.nbc) * self.bs, indexing="ij")
        self.bx = jnp.asarray(xs.reshape(-1))
        self.by = jnp.asarray(ys.reshape(-1))
        offs = np.array([[0, 0], [0, 1], [1, 0], [1, 1]]) * self.sbs
        self.qx = jnp.asarray((xs.reshape(-1)[:, None] + offs[None, :, 1]))
        self.qy = jnp.asarray((ys.reshape(-1)[:, None] + offs[None, :, 0]))
        elig = (xs != 0) & (ys != 0)  # non-border blocks (VBS-eligible)
        self.vbs_eligible = jnp.asarray(elig.reshape(-1))
        # intra_mode-1 layout: same block SET, transposed raster order
        self.vbs_eligible_t = jnp.asarray(elig.T.reshape(-1))
        if cfg.rc_active:
            # native K9 fix: per-frame-type rate tables (the reference indexes
            # the intra table for inter frames; compat replicates that)
            self.row_qps_by_type = tuple(
                jnp.asarray(np.asarray(rc_mod.row_qp_sequence(cfg, t), dtype=np.int32)) for t in (0, 1)
            )
        else:
            const = jnp.asarray(np.full(self.nbr, cfg.qp, dtype=np.int32))
            self.row_qps_by_type = (const, const)
        self.row_qps = self.row_qps_by_type[0]
        if cfg.roi_qp_map is not None:
            roi = np.asarray(cfg.roi_qp_map, dtype=np.int32).reshape(-1)
            assert roi.shape[0] == self.nb, "roi_qp_map must have one offset per block"
            self.roi = jnp.asarray(roi)
        else:
            self.roi = None
        # jitted steps (donate nothing; frames are small relative to HBM)
        self._inter_step_j = jax.jit(self._inter_step, static_argnames=("nref", "initial_refs"))
        self._intra_step_j = jax.jit(self._intra_step)
        self._dec_inter_j = jax.jit(self._decode_inter_step, static_argnames=("nref", "initial_refs"))
        self._dec_intra_j = jax.jit(self._decode_intra_step)

    # ----------------------------------------------------------- utilities
    def _block_qps(self, row_qps, transposed: bool = False):
        """Per-block QPs in block raster order.  ``transposed`` = the
        intra_mode-1 layout (the search runs on the TRANSPOSED frame, so
        block b sits at pixel block (b % nbr, b // nbr)): row QPs and ROI
        offsets must land on PIXEL rows either way — the untransposed vector
        used to put them on transposed positions under mode 1 (invisible on
        square no-RC test frames; round-3 review fix)."""
        q = jnp.broadcast_to(row_qps.astype(jnp.int32)[:, None], (self.nbr, self.nbc))
        if self.roi is not None:
            q = jnp.clip(q + self.roi.reshape(self.nbr, self.nbc), 0, 12)
        if transposed:
            q = q.T
        return q.reshape(-1)

    def _prep_refs(self, refs, initial_refs: bool):
        """(nref, h, w) uint8/int32 -> search/pred ref stack (upsampled under
        FME; wrap only for real reconstructions, quirk K17)."""
        if self.cfg.fme_enable:
            up = jax.vmap(lambda r: M.fme_upsample(r, jnp, wrap_row_pass=not initial_refs))(refs)
            return up
        return refs.astype(jnp.int32)

    def _blockify(self, frame32):
        return frame32.reshape(self.nbr, self.bs, self.nbc, self.bs).swapaxes(1, 2).reshape(-1, self.bs, self.bs)

    def _quads_of(self, blocks):
        s = self.sbs
        return blocks.reshape(-1, 2, s, 2, s).swapaxes(2, 3).reshape(-1, 4, s, s)

    def _merge_quads(self, quads):
        s = self.sbs
        return quads.reshape(-1, 2, 2, s, s).swapaxes(2, 3).reshape(-1, self.bs, self.bs)

    def _quads_px(self, band):
        """(h, w) pixel band -> (nb, 4, sbs, sbs) quad blocks (Z order)."""
        s = self.sbs
        return band.reshape(self.nbr, 2, s, self.nbc, 2, s).transpose(0, 3, 1, 4, 2, 5).reshape(
            self.nb, 4, s, s
        )

    # ------------------------------------------------------------- search
    def _full_search(self, cur32, search_refs, fme):
        """Full-search dispatch (bit-identical results across kernels):
        materialized candidate maps + argmin by default, "fused" selects the
        streaming reduction (see CodecConfig.me_search)."""
        cfg = self.cfg
        sr = cfg.search_range * 2 if fme else cfg.search_range
        search = M.full_search_fused if cfg.me_search == "fused" else M.full_search_materialized
        with jax.named_scope("full_search"):
            return search(cur32, search_refs, sr, self.bs, self.sbs, 2 if fme else 1, fme,
                          cfg.vbs_enable, jnp)

    def _fast_candidates(self, cur_blk, refs_pad, pad, dims, X, Y, n, mvp, fme):
        """One block's 3x3 fast-ME step (shared kernel: core/me.py
        fast_candidates — strict improvement in (ref, dx, dy) scan order,
        quirk K7 bound, K8 fallback to the MVP itself).  One small
        dynamic_slice per step instead of a whole-frame gather."""
        return M.fast_candidates(cur_blk, refs_pad, pad, dims, X, Y, n, mvp, fme)

    def _fast_search_zero_mvp(self, cur32, search_refs, fme):
        """Vectorized fast ME for the chain-free mvp=(0,0,0) case (the
        ParallelMode-2 worker semantics, Encoder.py:642): every block
        evaluates the 3x3 window around zero independently, so the whole
        frame is one batched search — no 3600-step scan.  Same candidate
        bounds (quirk K7) and the fast-ME tie-break (first minimum in
        (ref, dx, dy) scan order — no L1 term, unlike full search)."""
        cfg = self.cfg
        scale = 2 if fme else 1
        H, W = search_refs.shape[-2:]
        nref = search_refs.shape[0]
        maps, fullg = jax.vmap(
            lambda r: M.sad_maps(cur32, r, 1, self.sbs, scale, jnp, also_full=True)
        )(search_refs)
        full = fullg.reshape(nref, 3, 3, -1)
        vmask = M.candidate_valid_mask(
            self.bx * scale, self.by * scale, 1, self.bs, H, W, fme, jnp, extra_2bs=True
        )

        def fast_argmin(sads, valid):
            ncand = sads.shape[0] * 9
            refi = jnp.arange(nref)[:, None, None]
            dyi = jnp.arange(3)[None, :, None]
            dxi = jnp.arange(3)[None, None, :]
            sec = refi * 9 + dxi * 3 + dyi  # (ref, dx, dy) scan order
            inf = np.int32(2**31 - 1)
            sm = jnp.where(valid, sads, inf)
            flat = sm.reshape(ncand, -1).T
            best = flat.min(axis=-1)
            sec_b = jnp.broadcast_to(sec[..., None], sads.shape).reshape(ncand, -1).T
            sec_m = jnp.where((flat == best[:, None]) & (flat != inf), sec_b, inf)
            win = sec_m.min(axis=-1)
            ok = win != inf
            wref = win // 9
            wdx = (win % 9) // 3
            wdy = win % 3
            zero = jnp.zeros_like(win)
            mv = jnp.stack(
                [jnp.where(ok, wdx - 1, zero), jnp.where(ok, wdy - 1, zero), jnp.where(ok, wref, zero)],
                axis=-1,
            ).astype(jnp.int32)
            return mv, jnp.where(ok, best, inf), ok

        mv, sad, ok = fast_argmin(full, vmask[None])
        outs = {"mv": mv, "sad": sad, "ok": ok}
        if cfg.vbs_enable:
            sub = maps.reshape(nref, 3, 3, -1)
            vs = M.candidate_valid_mask(
                self.qx.reshape(-1) * scale, self.qy.reshape(-1) * scale, 1, self.sbs, H, W, fme, jnp,
                extra_2bs=True,
            )
            # maps are in (nbr2, nbc2) raster; reorder columns to quad order
            # (vs was built from self.qx/qy and is already quad-ordered)
            qidx = ((self.qy // self.sbs) * (self.w // self.sbs) + (self.qx // self.sbs)).reshape(-1)
            smv, ssad, sok = fast_argmin(sub[..., qidx], vs[None])
            outs["sub_mv"] = smv.reshape(self.nb, 4, 3)
            outs["sub_sad"] = ssad.reshape(self.nb, 4)
            outs["sub_ok"] = sok.reshape(self.nb, 4)
        return outs

    def _fast_search_fixpoint(self, cur32, search_refs, fme, g0=None):
        """Fast-ME MVP chain solved by Jacobi fixpoint iteration.

        The reference's recurrence (Encoder.py:719-742) is
        ``mv[i] = f_i(mv[i-1])`` in raster order with ``mv[-1] = 0`` — the
        sub-block searches consume the block-level MVP but never feed the
        chain, so only the full-block MVs are coupled.  Instead of a
        #blocks-step lax.scan (latency-bound), iterate on the whole MV
        *vector*:

            m   <- f(g)          (every block batched — one vmapped pass)
            g'  <- shift(m)      (g'[i] = m[i-1], g'[0] = 0)

        until ``g' == g``.  At that point ``m[i] = f_i(m[i-1])`` for every i
        and ``m[0] = f_0(0)`` — exactly the forward-substitution solution,
        which is unique by induction, so the fixpoint is bit-identical to
        the scan.  Convergence needs one sweep per prefix block in the worst
        case (the loop is bounded by nb+1), but real content converges in
        O(#MV-field discontinuities) sweeps: wherever the previous sweep's
        guess already equals the true predecessor MV (smooth motion), the
        block is correct immediately.  Each sweep is a single batched
        9-candidate search (uint8 window gather + SAD), so the whole solve
        is a handful of parallel passes instead of thousands of dependent
        steps.

        ``g0`` warm-starts the iteration (the encode loop carries the
        previous frame's converged guesses; motion fields are temporally
        coherent, so most blocks land on their true MVP immediately).  ANY start converges to the
        same unique fixpoint, so warm-starting cannot change the result."""
        cfg = self.cfg
        scale = 2 if fme else 1
        cur_b = self._blockify(cur32)
        n = self.bs
        step_px = 2 if fme else 1
        pad = step_px * (n - 1) + 3
        dims = search_refs.shape[-2:]
        # values are pixel-range ([0,255] even after the ceil-average FME
        # upsample), so gather uint8 windows: the vmapped dynamic_slice is
        # the sweep's only HBM-bound op and this quarters its traffic
        refs_pad = jnp.pad(search_refs, ((0, 0), (pad, pad), (pad, pad))).astype(jnp.uint8)
        X = (self.bx * scale).astype(jnp.int32)
        Y = (self.by * scale).astype(jnp.int32)

        def eval_blocks(cb, x, y, g):
            return M.fast_sweep(cb, x, y, refs_pad, pad, dims, n, fme, g)

        def guesses_of(m):
            return jnp.concatenate([jnp.zeros((1, 3), jnp.int32), m[:-1]], axis=0)

        def body(state):
            g, _, _, _, it = state
            m, s = eval_blocks(cur_b, X, Y, g)
            g2 = guesses_of(m)
            return (g2, m, s, jnp.any(g2 != g), it + 1)

        def cond(state):
            _, _, _, changed, it = state
            return jnp.logical_and(changed, it <= self.nb)

        init = (
            jnp.zeros((self.nb, 3), jnp.int32) if g0 is None else g0,
            jnp.zeros((self.nb, 3), jnp.int32),
            jnp.zeros((self.nb,), jnp.int32),
            jnp.asarray(True),
            jnp.asarray(0, jnp.int32),
        )
        g_fin, mv, sad, _, _ = jax.lax.while_loop(cond, body, init)
        outs = {"mv": mv, "sad": sad, "ok": sad != np.int32(2**31 - 1), "g_next": g_fin}
        if cfg.vbs_enable:
            # quads use the block-level MVP (= predecessor block's MV) and
            # never feed the chain — one batched pass at the converged MVPs
            cur_q = self._quads_of(cur_b)
            smv, ssad = M.fast_quads_sweep(
                cur_q, (self.qx * scale).astype(jnp.int32), (self.qy * scale).astype(jnp.int32),
                refs_pad, pad, dims, self.sbs, fme, g_fin,
            )
            outs["sub_mv"] = smv
            outs["sub_sad"] = ssad
            outs["sub_ok"] = ssad != np.int32(2**31 - 1)
        return outs

    def _fast_me_seg_mult(self) -> int:
        """Resolved rowscan segment multiplier (fastme.resolve_seg_mult: a
        divisor of nbc, "auto" = 1, loud on silent rounding)."""
        from streamoptima_tpu.core.fastme import resolve_seg_mult

        return resolve_seg_mult(self.cfg.fast_me_seg_mult, self.nbc)

    def _fast_me_lookahead(self, seg_len: int, n_segments: int) -> int:
        """Resolved rowscan lookahead (fastme.resolve_lookahead: the shared
        rule — k=4 on >= 32-segment batches else 1, loud on silently
        overridden explicit requests)."""
        from streamoptima_tpu.core.fastme import resolve_lookahead

        return resolve_lookahead(self.cfg.fast_me_lookahead, seg_len, n_segments)

    def _fast_search_rowscan(self, cur32, refs, fme, initial_refs: bool, g0=None):
        """Fast-ME chain solved row-segmented (fast_me_chain "rowscan", the
        default): a lax.scan over block COLUMNS advances every
        block row simultaneously — within each row the recurrence
        mv[r, j] = f(mv[r, j-1]) is then EXACT forward substitution — so the
        Jacobi iteration runs only over the per-row seed MVs (the raster
        chain's hand-off mv[r, 0] = f(mv[r-1, nbc-1])) and converges in a
        couple of outer passes instead of one sweep per intra-row
        discontinuity (see _fast_search_fixpoint for the fixpoint =
        forward-substitution bit-exactness argument, which applies verbatim
        with rows in place of blocks).

        The block eval is core/fastme.py: per-block windows fetched from the
        half-pel parity planes (the 2x upsample is never materialized), and a
        final confirm pass at the converged MVPs re-derives the winners while
        folding in the VBS quad searches and the winner predictions (bit-exact
        pred.gather_predictions semantics) from the same fetched regions.

        The "row" segmentation generalizes (cfg.fast_me_seg_mult): the raster
        chain mv[i] = f_i(mv[i-1]) may be cut into S = k*nbr equal segments at
        ARBITRARY positions — the fixpoint argument never uses row alignment —
        and the column scan then runs L = nbc/k sequential steps over S-block
        batches; seed corrections travel one segment per outer Jacobi pass.

        ``refs`` are the RAW (nref, h, w) reconstructions; ``g0`` warm-starts
        the segment seeds from the previous frame's converged guesses (any
        start converges to the same unique fixpoint)."""
        cfg = self.cfg
        from streamoptima_tpu.core import fastme as FM

        scale = 2 if fme else 1
        n = self.bs
        nbr, nbc = self.nbr, self.nbc
        k = self._fast_me_seg_mult()
        S, L = nbr * k, nbc // k
        kl = self._fast_me_lookahead(L, S)
        planes = FM.plane_stack(refs, fme, jnp, wrap_row_pass=not initial_refs)
        # fetch mode by plane area (fastme.resolve_fetch_mode): one-hot
        # gather on small planes (it contracts the WHOLE plane per block),
        # clamped-dynamic-slice gather on large ones
        fmode = FM.resolve_fetch_mode(cfg.fast_me_fetch, self.h, self.w,
                                      int(planes.shape[0]))
        wr, wc = FM.wide_window_spec(n, kl, fme)
        wprep = FM.window_prep(planes, n + 2, fmode,
                               wide=(wr, wc) if kl > 1 else None)
        dims = (2 * self.h - 1, 2 * self.w - 1) if fme else (self.h, self.w)
        cur_b = self._blockify(cur32)
        curT = cur_b.reshape(S, L, n, n).swapaxes(0, 1)  # (L, S, n, n)
        # per-step block coordinates: element (j, s) is chain block s*L + j
        xsT = self.bx.astype(jnp.int32).reshape(S, L).swapaxes(0, 1)  # (L, S)
        ysT = self.by.astype(jnp.int32).reshape(S, L).swapaxes(0, 1)

        if kl > 1:
            # speculative lookahead (fastme.eval_chain): each scan step
            # resolves kl consecutive chain columns from ONE wide window per
            # segment; padded tail columns propagate the MVP unchanged, so
            # the row hand-off m_last stays the true last column's MV
            Lp = -(-L // kl)
            padc = Lp * kl - L
            ysv = ysT[0]  # y is constant along each segment's columns
            curK = jnp.concatenate(
                [curT, jnp.zeros((padc,) + curT.shape[1:], curT.dtype)]
            ).reshape(Lp, kl, S, n, n) if padc else curT.reshape(Lp, kl, S, n, n)
            xsK = jnp.concatenate(
                [xsT, jnp.broadcast_to(xsT[-1:], (padc, S))]
            ).reshape(Lp, kl, S) if padc else xsT.reshape(Lp, kl, S)
            cmK = jnp.asarray(
                (np.arange(Lp * kl) < L).reshape(Lp, kl))

            def row_pass(seeds):
                def step(g, inp):
                    cb, xv, cm = inp  # (kl, S, n, n), (kl, S), (kl,)
                    by0, bx0 = FM._wide_base(g, ysv, xv[0], kl, fme, jnp)
                    wide = FM.window_read(wprep, by0, bx0, wr, jnp, nwin_c=wc)
                    mvs = FM.eval_chain(wide, cb, g, xv, ysv, n, kl, dims,
                                        fme, None, cm, jnp)
                    return mvs[-1], (mvs, wide)

                m_last, (mK, wK) = jax.lax.scan(step, seeds, (curK, xsK, cmK))
                # wK: the pass's wide windows — the LAST pass ran at the
                # converged seeds, so the confirm regions are sub-windows
                # (confirm_windows_from_stack) and need no re-gather
                return m_last, (mK.reshape(Lp * kl, S, 3)[:L], wK)
        else:

            def row_pass(seeds):
                def step(g, inp):
                    cb, xv, yv = inp  # (S, n, n), (S,), (S,)
                    by0, bx0 = FM._region_base(g, yv, xv, n, fme, jnp)
                    win = FM.window_read(wprep, by0, bx0, n + 2, jnp)
                    mv, _ = FM.eval9(win, cb, g, xv * scale, yv * scale, n, dims,
                                     fme, None, jnp)
                    return mv, mv

                return jax.lax.scan(step, seeds, (curT, xsT, ysT))  # (m_last, mT)

        def body(state):
            seeds, _, _, it = state
            m_last, mT = row_pass(seeds)
            seeds2 = jnp.concatenate([jnp.zeros((1, 3), jnp.int32), m_last[:-1]], axis=0)
            return (seeds2, mT, jnp.any(seeds2 != seeds), it + 1)

        def cond(state):
            return jnp.logical_and(state[2], state[3] <= S + 1)

        seeds0 = (
            jnp.zeros((S, 3), jnp.int32) if g0 is None else g0.reshape(S, L, 3)[:, 0]
        )
        if kl > 1:
            extra0 = jnp.zeros((-(-L // kl), S, planes.shape[0], wr, wc), jnp.int32)
            init = (seeds0, (jnp.zeros((L, S, 3), jnp.int32), extra0),
                    jnp.asarray(True), jnp.asarray(0, jnp.int32))
            _, (mT, wT), _, _ = jax.lax.while_loop(cond, body, init)
        else:
            init = (seeds0, jnp.zeros((L, S, 3), jnp.int32), jnp.asarray(True),
                    jnp.asarray(0, jnp.int32))
            _, mT, _, _ = jax.lax.while_loop(cond, body, init)
        m = mT.swapaxes(0, 1).reshape(self.nb, 3)
        # at the seed fixpoint every block satisfies m[i] = f_i(m[i-1]), so
        # the confirm pass at the guesses vector re-derives m bit-exactly
        # while producing quads + predictions from the same regions
        g_fin = jnp.concatenate([jnp.zeros((1, 3), jnp.int32), m[:-1]], axis=0)
        by0, bx0 = FM._region_base(g_fin, self.by.astype(jnp.int32), self.bx.astype(jnp.int32),
                                   n, fme, jnp)
        if kl > 1:
            # the final pass ran at the converged seeds: confirm regions are
            # sub-windows of its stacked wide windows (no re-gather)
            win = FM.confirm_windows_from_stack(wT, g_fin, n, kl, L, S, fme, jnp)
        else:
            win = FM.window_read(wprep, by0, bx0, n + 2, jnp)
        cur_q = self._quads_of(cur_b) if cfg.vbs_enable else \
            jnp.zeros((self.nb, 4, self.sbs, self.sbs), jnp.int32)
        outs = FM.confirm(
            win, cur_b, cur_q, g_fin,
            (self.bx * scale).astype(jnp.int32), (self.by * scale).astype(jnp.int32),
            n, self.sbs, dims, fme, cfg.vbs_enable, None, by0, bx0, jnp,
        )
        outs["g_next"] = g_fin
        return outs

    def _fast_search(self, cur32, search_refs, fme, zero_mvp: bool, g0=None):
        """Fast-ME dispatch (all variants bit-identical): the chain-free
        zero-MVP case (ParallelMode-2 worker semantics) goes to the fully
        vectorized path; the real MVP chain is solved by Jacobi fixpoint
        sweeps by default (see _fast_search_fixpoint) or, under
        fast_me_chain="scan", by the literal lax.scan twin of
        Encoder.py:549-581 (kept as the semantics oracle — raster-sequential).
        Both report true SADs (quirk K6 fixed)."""
        cfg = self.cfg
        if zero_mvp:
            return self._fast_search_zero_mvp(cur32, search_refs, fme)
        if cfg.fast_me_chain != "scan":
            return self._fast_search_fixpoint(cur32, search_refs, fme, g0=g0)
        scale = 2 if fme else 1
        cur_b = self._blockify(cur32)
        cur_q = self._quads_of(cur_b) if cfg.vbs_enable else None
        n = self.bs
        step_px = 2 if fme else 1
        pad = step_px * (n - 1) + 3  # >= region size for both block sizes
        dims = search_refs.shape[-2:]
        refs_pad = jnp.pad(search_refs, ((0, 0), (pad, pad), (pad, pad)))

        def step(mvp, i):
            outs = {}
            if cfg.vbs_enable:
                qmv = []
                qsad = []
                for q in range(4):
                    m, s = self._fast_candidates(
                        cur_q[i, q], refs_pad, pad, dims, self.qx[i, q] * scale, self.qy[i, q] * scale,
                        self.sbs, mvp, fme,
                    )
                    qmv.append(m)
                    qsad.append(s)
                outs["sub_mv"] = jnp.stack(qmv)
                outs["sub_sad"] = jnp.stack(qsad)
            m, s = self._fast_candidates(cur_b[i], refs_pad, pad, dims, self.bx[i] * scale, self.by[i] * scale, n, mvp, fme)
            outs["mv"] = m
            outs["sad"] = s
            new_mvp = jnp.where(zero_mvp, jnp.zeros(3, jnp.int32), m)
            return new_mvp, outs

        _, outs = jax.lax.scan(step, jnp.zeros(3, jnp.int32), jnp.arange(self.nb))
        outs["ok"] = outs["sad"] != np.int32(2**31 - 1)
        if cfg.vbs_enable:
            outs["sub_ok"] = outs["sub_sad"] != np.int32(2**31 - 1)
        return outs

    # ----------------------------------------------------- shared encode
    def _transform_and_select(self, res_full, res_quads, sad_full, sad_quads, frame_type, row_qps,
                              ok_full=None, ok_quads=None, transposed: bool = False):
        """DCT both variants once, RD-select, quantize at the RC row QPs
        (shared logic in core/rd.py).  Returns per-block lens in place of the
        old scalar size; callers sum/row-sum as needed.  ``transposed`` =
        intra_mode-1 block order (QPs/ROI/eligibility remapped)."""
        cfg = self.cfg
        return rd.transform_and_select(
            res_full, res_quads, sad_full, sad_quads, frame_type,
            self._block_qps(row_qps, transposed),
            qp_nominal=int(cfg.qp), lam=cfg.lam, vbs_enable=cfg.vbs_enable,
            vbs_eligible=self.vbs_eligible_t if transposed else self.vbs_eligible,
            bs=self.bs, sbs=self.sbs,
            ok_full=ok_full, ok_quads=ok_quads,
        )

    def _dequant(self, qtc_full, qtc_quads, row_qps, transposed: bool = False):
        qps = self._block_qps(row_qps, transposed)
        # decode ships coefficients over the link as int16 (|qtc| <= 4080:
        # orthonormal 16x16 DCT of +-255 residuals); widen BEFORE rescale so
        # the 2^qp multiply never runs in 16-bit
        qtc_full = qtc_full.astype(jnp.int32)
        qtc_quads = qtc_quads.astype(jnp.int32)
        rf = idct2_int(rescale(qtc_full, qps).astype(jnp.int32))
        rq = idct2_int(rescale(qtc_quads, _qpm1_vec(qps)[:, None]).astype(jnp.int32))
        return rf, rq

    def _gather_preds(self, mv, sub_mv, pred_refs, fme):
        """Full-block and (under VBS) quad predictions for transmitted MVs —
        the reference's three boundary cases (core/pred.py)."""
        with jax.named_scope("pred_gather"):
            pred_full = P.gather_predictions(mv, pred_refs, self.bx, self.by, self.bs, fme, jnp)
            if not self.cfg.vbs_enable:
                return pred_full, None
            pred_q = P.gather_predictions(
                sub_mv.reshape(-1, 3), pred_refs, self.qx.reshape(-1), self.qy.reshape(-1),
                self.sbs, fme, jnp,
            ).reshape(self.nb, 4, self.sbs, self.sbs)
            return pred_full, pred_q

    def _recon_inter(self, pred_refs, mv, split, sub_mv, qtc_full, qtc_quads, row_qps, fme,
                     preds=None):
        rf, rq = self._dequant(qtc_full, qtc_quads, row_qps)
        # native fixes quirk K18: the reconstruction uses the same FME bound
        # as the residual path, so prediction always matches what the
        # residual was computed against (better edge quality; the compat
        # engine replicates the reference's mismatch instead).  That identity
        # is also why encode can reuse the search kernel's preds here.
        if preds is not None:
            pred_full, pred_q = preds
        else:
            pred_full, pred_q = self._gather_preds(mv, sub_mv, pred_refs, fme)
        full_blocks = P.wrap_uint8(pred_full + rf, jnp)
        if self.cfg.vbs_enable:
            quad_blocks = self._merge_quads(P.wrap_uint8(pred_q + rq, jnp))
            blocks = jnp.where(split[:, None, None], quad_blocks, full_blocks)
        else:
            blocks = full_blocks
        return blocks.reshape(self.nbr, self.nbc, self.bs, self.bs).swapaxes(1, 2).reshape(self.h, self.w)

    def _recon_intra(self, mv, split, sub_mv, qtc_full, qtc_quads, row_qps):
        rf, rq = self._dequant(qtc_full, qtc_quads, row_qps,
                               transposed=self.cfg.intra_mode == 1)
        sr = self.cfg.search_range
        if self.cfg.intra_mode == 1:
            # mode 1 = transpose of mode 0 (native-only; reference bug B2)
            frame = I.intra_reconstruct_mode0(
                rf.swapaxes(-1, -2), rq.swapaxes(-1, -2), split, mv, sub_mv, self.w, self.h, self.bs, jnp,
                sr=sr,
            ).T
        else:
            frame = I.intra_reconstruct_mode0(rf, rq, split, mv, sub_mv, self.h, self.w, self.bs, jnp, sr=sr)
        return P.wrap_uint8(frame, jnp)

    # ------------------------------------------------------------ steps
    def _inter_step(self, cur, refs, row_qps, orig, nref: int, initial_refs: bool, g0=None):
        cfg = self.cfg
        fme = cfg.fme_enable
        cur32 = cur.astype(jnp.int32)
        fast = cfg.fast_me and cfg.parallel_mode != 1
        rowscan = fast and cfg.parallel_mode != 2 and cfg.fast_me_chain in ("auto", "rowscan")
        if rowscan:
            # raw refs: the rowscan eval reads the parity planes directly and
            # its confirm pass returns the predictions — no upsample, no
            # prediction gathers
            search_refs = None
            with jax.named_scope("fastme_chain"):
                s = self._fast_search_rowscan(cur32, refs, fme, initial_refs, g0=g0)
            pred_full = s["pred_full"]
            pred_q = s.get("pred_quads")
        else:
            search_refs = self._prep_refs(refs, initial_refs)
            if fast:
                s = self._fast_search(cur32, search_refs, fme, zero_mvp=(cfg.parallel_mode == 2), g0=g0)
            else:
                s = self._full_search(cur32, search_refs, fme)
            pred_full, pred_q = self._gather_preds(s["mv"], s.get("sub_mv"), search_refs, fme)
        mv = s["mv"]
        cur_blocks = self._blockify(cur32)
        res_full = cur_blocks - pred_full
        if cfg.vbs_enable:
            smv = s["sub_mv"]
            res_quads = self._quads_of(cur_blocks) - pred_q
            sub_sad = s["sub_sad"]
        else:
            smv = jnp.zeros((self.nb, 4, 3), jnp.int32)
            res_quads = jnp.zeros((self.nb, 4, self.sbs, self.sbs), jnp.int32)
            sub_sad = jnp.zeros((self.nb, 4), jnp.int32)
        split, qtc_full, qtc_quads, lens, mae_pb = self._transform_and_select(
            res_full, res_quads, s["sad"], sub_sad, 1, row_qps,
            ok_full=s.get("ok"), ok_quads=s.get("sub_ok"),
        )
        recon = self._recon_inter(
            search_refs, mv, split, smv, qtc_full, qtc_quads, row_qps, fme,
            preds=(pred_full, pred_q),
        )
        out = {
            "mv": mv, "split": split, "sub_mv": smv,
            # int16 on device (|qtc| <= 4080: orthonormal 16x16 DCT of +-255
            # residuals): halves the dominant D2H payload of package/transmit
            # drains — the same narrowing every downstream consumer already
            # applies on host (frame_arrays_of, decode's int16 upload)
            "qtc_full": qtc_full.astype(jnp.int16),
            "qtc_quads": qtc_quads.astype(jnp.int16),
            "size": lens.sum(), "row_bits": lens.reshape(self.nbr, self.nbc).sum(axis=1),
            "recon": recon,
            "mae": mae_pb.mean(),
            "psnr": metrics.psnr_jax(orig, recon),
        }
        if "g_next" in s:  # fast-ME: converged guesses, warm start for the next frame
            out["g_next"] = s["g_next"]
        return out

    def _intra_step(self, cur, row_qps, orig):
        cfg = self.cfg
        work = cur.astype(jnp.int32)
        if cfg.intra_mode == 1:
            work = work.T
        canvas_w = cfg.intra_canvas[1] if cfg.intra_mode == 0 else cfg.intra_canvas[0]
        out = I.intra_search_mode0(work, self.bs, cfg.search_range, canvas_w, cfg.vbs_enable, jnp)
        res_full, res_quads = I.intra_residuals_mode0(
            work, out["mv"], out.get("sub_mv"), self.bs, jnp, sr=cfg.search_range
        )
        if cfg.intra_mode == 1:
            res_full = res_full.swapaxes(-1, -2)
            res_quads = None if res_quads is None else res_quads.swapaxes(-1, -2)
        if cfg.vbs_enable:
            sub_sad = out["sub_sad"].reshape(self.nb, 4)
            smv3 = out["sub_mv"].reshape(self.nb, 4)
        else:
            res_quads = jnp.zeros((self.nb, 4, self.sbs, self.sbs), jnp.int32)
            sub_sad = jnp.zeros((self.nb, 4), jnp.int32)
            smv3 = jnp.zeros((self.nb, 4), jnp.int32)
        split, qtc_full, qtc_quads, lens, mae_pb = self._transform_and_select(
            res_full, res_quads, out["sad"].reshape(-1), sub_sad, 0, row_qps,
            transposed=cfg.intra_mode == 1,
        )
        recon = self._recon_intra(out["mv"].reshape(-1), split, smv3, qtc_full, qtc_quads, row_qps)
        # block raster order is transposed under intra_mode 1 (search runs on
        # the transposed frame); map back to pixel-row bit sums either way
        if cfg.intra_mode == 1:
            row_bits = lens.reshape(self.nbc, self.nbr).T.sum(axis=1)
        else:
            row_bits = lens.reshape(self.nbr, self.nbc).sum(axis=1)
        return {
            "mv": out["mv"].reshape(-1), "split": split, "sub_mv": smv3,
            "qtc_full": qtc_full.astype(jnp.int16),
            "qtc_quads": qtc_quads.astype(jnp.int16),
            "size": lens.sum(), "row_bits": row_bits,
            "recon": recon,
            "mae": mae_pb.mean(),
            "psnr": metrics.psnr_jax(orig, recon),
        }

    def _decode_inter_step(self, refs, mv, split, sub_mv, qtc_full, qtc_quads, row_qps, nref: int, initial_refs: bool):
        pred_refs = self._prep_refs(refs, initial_refs)
        return self._recon_inter(pred_refs, mv, split, sub_mv, qtc_full, qtc_quads, row_qps, self.cfg.fme_enable)

    def _decode_intra_step(self, mv, split, sub_mv, qtc_full, qtc_quads, row_qps):
        return self._recon_intra(mv, split, sub_mv, qtc_full, qtc_quads, row_qps)

    # ------------------------------------------------------------ encode
    def _encode_pass(self, package: bool, ftypes_fixed=None, rqps_pf=None,
                     light: bool = False):
        """One GOP-structured encode pass over the clip.

        ``ftypes_fixed`` / ``rqps_pf``: per-frame frame types and row-QP
        vectors for the SECOND two-pass pass (frame types come from pass 1 —
        promotion is not re-decided, matching the mesh engine).  ``light``
        keeps only each frame's ``row_bits`` (first two-pass pass: the stats
        are all that survives, so the outputs' HBM is freed as the loop
        advances).  Returns (per_frame, ftypes)."""
        cfg = self.cfg
        ftypes = []
        per_frame = []
        refs = [jnp.full((self.h, self.w), 128, dtype=jnp.uint8)]
        initial = True
        # bounded HBM on long clips (the decode loop's drain, mirrored): a
        # frame's outputs (~75 MB at 4K with both coefficient sets) were
        # live on device for the whole clip; convert to host arrays a fixed
        # lag behind the dispatch frontier — the values were
        # copy_to_host_async'd at dispatch, so the np.asarray only joins a
        # transfer already riding the link.  The reference FIFO keeps its
        # own device handles, so reconstruction reuse is unaffected.  See
        # CodecConfig.encode_drain for the package=False gating.
        drain_on = not light and (package or cfg.encode_drain is not None)
        lag = 16 if cfg.encode_drain is None else max(int(cfg.encode_drain), 1)
        n_conv = 0

        def drain(upto):
            nonlocal n_conv
            while n_conv < upto:
                o = per_frame[n_conv]
                for k, v in o.items():
                    if isinstance(v, jax.Array):
                        o[k] = np.asarray(v)
                n_conv += 1

        # fast-ME: warm-start each frame's Jacobi solve from the previous
        # frame's converged guesses (unique fixpoint => bit-identical)
        g_carry = jnp.zeros((self.nb, 3), jnp.int32) if cfg.fast_me else None
        for i in range(cfg.frames):
            cur = self._y_dev[i]
            want_intra = (i % cfg.intra_dur == 0 and cfg.parallel_mode != 1) \
                if ftypes_fixed is None else ftypes_fixed[i] == 0
            rqp = rqps_pf[i] if rqps_pf is not None else None
            if want_intra:
                out = self._intra_step_j(cur, rqp if rqp is not None else self.row_qps_by_type[0], cur)
                ftype = 0
            else:
                if cfg.parallel_mode in (1, 3):
                    use, use_initial = [jnp.full((self.h, self.w), 128, dtype=jnp.uint8)], True
                else:
                    use, use_initial = refs, initial
                out = self._inter_step_j(cur, jnp.stack(use), rqp if rqp is not None else self.row_qps_by_type[1], cur, nref=len(use), initial_refs=use_initial, g0=g_carry)
                ftype = 1
                if ftypes_fixed is None and cfg.rc_flag is not None and cfg.rc_flag > 1 \
                        and int(out["size"]) > cfg.intra_thresh:
                    out = self._intra_step_j(cur, rqp if rqp is not None else self.row_qps_by_type[0], cur)
                    ftype = 0
            g_carry = out.pop("g_next", g_carry)
            ftypes.append(ftype)
            # start device->host copies now so they overlap the next frames'
            # compute
            if light:
                per_frame.append({"row_bits": out["row_bits"]})
                fetch = (out["row_bits"],)
            else:
                per_frame.append(out)
                fetch = out.values() if (package or drain_on) \
                    else (out["recon"], out["size"], out["psnr"], out["mae"])
            for v in fetch:
                try:
                    v.copy_to_host_async()
                except AttributeError:
                    pass
            if i < cfg.frames - 1:
                if ftype == 0:
                    refs = []
                if len(refs) >= cfg.n_ref_frames:
                    refs.pop(0)
                refs.append(out["recon"])
                initial = False
            if drain_on:
                drain(len(per_frame) - lag)
        if not light and not drain_on:
            # package=False keeps outputs as device arrays (the caller may
            # never need them on host) — but START host copies for all of
            # them now: a later transmit's np.asarray then joins an
            # in-flight pipelined transfer instead of paying a cold blocking
            # round trip per array
            for o in per_frame:
                for v in o.values():
                    try:
                        v.copy_to_host_async()
                    except AttributeError:
                        pass
        return per_frame, ftypes

    def encode(self, package: bool = True):
        """Encode the clip.  ``package=False`` skips the host-side conversion
        to the list-structured interchange format ("MVS per Frame" /
        "approx residual" left as device arrays in "per_frame") — use it when
        only reconstructions/metrics are needed (benchmarks, metric sweeps).

        Two-pass RC runs CLIP-LEVEL (the classic two-pass VBR structure,
        shared bitwise with the mesh engine): pass 1 encodes the whole clip
        at the table QPs (async-pipelined, no per-frame host sync beyond
        promotion's size check), the per-frame row bits come back in ONE
        device->host transfer, rc.second_pass_row_qps reallocates each
        frame's row budgets on the host, and pass 2 re-encodes the clip at
        the reallocated QPs with pass-1's frame types.  The earlier
        per-frame interleave (first pass -> sync -> second pass -> next
        frame) cost ~4 blocking syncs per frame; the clip-level form is two
        full async passes plus one round trip."""
        cfg = self.cfg
        assert self.y is not None, "construct with y_frames to encode"
        two_pass = cfg.two_pass and cfg.rc_active
        if two_pass:
            pf1, ftypes1 = self._encode_pass(False, light=True)
            rb = np.asarray(jnp.stack([o["row_bits"] for o in pf1]))  # ONE sync
            rqps = [
                rc_mod.second_pass_row_qps(cfg, rb[i], t, np.asarray(self.row_qps_by_type[t]))
                for i, t in enumerate(ftypes1)
            ]
            per_frame, ftypes = self._encode_pass(
                package, ftypes_fixed=ftypes1, rqps_pf=[jnp.asarray(q) for q in rqps]
            )
            qp_rows_pf = [[int(q) for q in r] for r in rqps]
        else:
            per_frame, ftypes = self._encode_pass(package)
            qp_rows_pf = [
                [int(q) for q in np.asarray(self.row_qps_by_type[t])] if cfg.rc_active else []
                for t in ftypes
            ]
        frames = [o["recon"] for o in per_frame]
        pkg = {
            "block size": self.bs,
            "num frames": cfg.frames,
            "height in pixels": self.h,
            "width in pixels": self.w,
            "search range": cfg.search_range,
            "PSNR per frame": [float(o["psnr"]) for o in per_frame],
            "MAE per Frame": [float(o["mae"]) for o in per_frame],
            "frame_type_seq": ftypes,
            "Qp_per_row_per_frame": qp_rows_pf,
            "residual size per frame": [int(o["size"]) for o in per_frame],
            "reconstructed frames": np.stack([np.asarray(f) for f in frames]),
        }
        if package:
            pkg["MVS per Frame"] = [self._mvs_to_list(o, ft) for o, ft in zip(per_frame, ftypes)]
            pkg["approx residual"] = [self._res_to_list(o) for o in per_frame]
        else:
            pkg["per_frame"] = per_frame
        return pkg

    # ------------------------------------------------------------ decode
    def decode(self, frame_types, residuals_per_frame, qp_rows_per_frame, mvs_per_frame):
        """In-memory decode of list-structured packages (same interchange
        structures as the compat engine / bitstream module).

        The clip ships in CHUNKs of frames, each chunk one H2D transfer per
        array (per-frame device_put would cost a blocking sync each).  Bytes
        are halved by the merged coefficient payload (a
        block is either split or not, so full-block and quad coefficients
        share one (bs, bs) slot — unpacked on device), and chunked uploads /
        stacked chunked drains let input transfers, compute and output
        transfers overlap instead of serializing."""
        cfg = self.cfg
        n, nb = cfg.frames, self.nb
        CHUNK = 8
        # ---- host pass: pack the clip (merged coefficient payload)
        mv_all = np.zeros((n, nb, 3), np.int32)
        split_all = np.zeros((n, nb), bool)
        smv_all = np.zeros((n, nb, 4, 3), np.int32)
        pay_all = np.zeros((n, nb, self.bs, self.bs), np.int16)
        rqp_all = np.full((n, self.nbr), cfg.qp, np.int32)
        nref_seq = [1] * n
        cnt = 1  # mirror of the device loop's reference-FIFO length
        s = self.sbs
        for i in range(n):
            ft = frame_types[i]
            mv_np, split_np, smv_np = list_to_mvs_np(mvs_per_frame[i], ft, nb)
            if ft == 0:
                mv_all[i, :, 0] = mv_np
                smv_all[i, :, :, 0] = smv_np
            else:
                mv_all[i] = mv_np
                smv_all[i] = smv_np
            split_all[i] = split_np
            qf, qq = list_to_res_np(residuals_per_frame[i], nb, self.bs, self.sbs)
            pay = qf
            if split_np.any():
                merged = qq.reshape(nb, 2, 2, s, s).swapaxes(2, 3).reshape(nb, self.bs, self.bs)
                pay = qf.copy()  # array-form interchange may be decoded again
                pay[split_np] = merged[split_np]
            pay_all[i] = pay
            if cfg.rc_active and len(qp_rows_per_frame[i]):
                rqp_all[i] = np.asarray(qp_rows_per_frame[i], dtype=np.int32)
            if ft != 0 or cfg.parallel_mode == 1:
                nref_seq[i] = 1 if cfg.parallel_mode in (1, 3) else cnt
            if i < n - 1:
                cnt = 1 if ft == 0 else min(cnt + 1, cfg.n_ref_frames)
        # device-side payload unpack: one jitted op per chunk (module-level
        # function so jit's cache hits across decode() calls — a fresh
        # lambda per call forced a retrace every decode)
        unpack = functools.partial(_unpack_payload, s)

        out_frames = []
        n_conv = 0  # frames already drained to host (bounded HBM footprint)

        def drain(lag):
            # frames were copy_to_host_async'd at dispatch, so np.asarray
            # only waits for the transfer already in flight
            nonlocal n_conv
            while len(out_frames) - n_conv > lag:
                out_frames[n_conv] = np.asarray(out_frames[n_conv])
                n_conv += 1

        refs = [jnp.full((self.h, self.w), 128, dtype=jnp.uint8)]
        initial = True
        for c0 in range(0, n, CHUNK):
            c1 = min(c0 + CHUNK, n)
            # chunked async uploads: the next chunk's transfer rides the link
            # while this chunk's steps execute
            d_mv, d_split, d_smv, d_pay, d_rqp = (
                jax.device_put(a[c0:c1])
                for a in (mv_all, split_all, smv_all, pay_all, rqp_all)
            )
            for i in range(c0, c1):
                j = i - c0
                mv, split, smv, row_qps = d_mv[j], d_split[j], d_smv[j], d_rqp[j]
                qf, qq = unpack(split, d_pay[j])
                if cfg.parallel_mode == 1:
                    ref128 = jnp.stack([jnp.full((self.h, self.w), 128, dtype=jnp.uint8)])
                    f = self._dec_inter_j(
                        ref128, mv, split, smv, qf, qq, row_qps, nref=1, initial_refs=True
                    )
                    out_frames.append(f)
                    try:
                        f.copy_to_host_async()
                    except AttributeError:
                        pass
                    continue
                if frame_types[i] == 0:
                    f = self._dec_intra_j(mv[:, 0], split, smv[:, :, 0], qf, qq, row_qps)
                    refs = []
                else:
                    if cfg.parallel_mode == 3:
                        use, use_init = [jnp.full((self.h, self.w), 128, dtype=jnp.uint8)], True
                    else:
                        use, use_init = refs, initial
                    assert len(use) == nref_seq[i]
                    f = self._dec_inter_j(
                        jnp.stack(use), mv, split, smv, qf, qq, row_qps,
                        nref=len(use), initial_refs=use_init,
                    )
                out_frames.append(f)
                try:  # start the output transfer now — it overlaps
                    f.copy_to_host_async()  # later chunks' upload/compute
                except AttributeError:
                    pass
                if i < n - 1:
                    if len(refs) >= cfg.n_ref_frames:
                        refs.pop(0)
                    refs.append(f)  # stays on device: no D2H/H2D round trip
                    initial = False
            # drain several chunks behind the frontier (the async copies make
            # the blocking np.asarray cheap); HBM stays bounded on long clips
            drain(4 * CHUNK)
        drain(0)
        return out_frames

    # ----------------------------------------------- interchange helpers
    def _mvs_to_list(self, out, ftype):
        return mvs_to_list(out, ftype, self.nb)

    def _res_to_list(self, out):
        return res_to_list(out, self.nb)

    def _list_to_mvs(self, mvs_list, ftype):
        return list_to_mvs(mvs_list, ftype, self.nb)

    def _list_to_res(self, res_list):
        return list_to_res(res_list, self.nb, self.bs, self.sbs)


# ------------------------------------------------ interchange (module level)
def frame_arrays_of(out, ftype):
    """One per_frame entry (encode(package=False)) -> the array interchange
    (bitstream.FrameMVArrays, FrameResArrays).  Intra MVs widen to the
    (nb, 3) component-0 layout the interchange fixes; coefficients narrow
    to int16 with the same loud overflow behavior as every sibling path
    (|qtc| <= 4080 holds by construction — a violation means a quant bug,
    not a stream to write)."""
    from streamoptima_tpu.bitstream import FrameMVArrays, FrameResArrays, widen_mvs

    sp = np.asarray(out["split"]).astype(bool)
    m3, s3 = widen_mvs(int(ftype), np.asarray(out["mv"]), np.asarray(out["sub_mv"]))

    def narrow(a, what):
        a = np.asarray(a)
        if a.size and (a.min() < -32768 or a.max() > 32767):
            raise OverflowError(f"{what} outside int16 range")
        return a.astype(np.int16)

    res = FrameResArrays(sp, narrow(out["qtc_full"], "qtc_full"),
                         narrow(out["qtc_quads"], "qtc_quads"))
    return FrameMVArrays(int(ftype), m3, sp, s3), res


def mvs_to_list(out, ftype, nb):
    """Device arrays -> the list-structured MV interchange format shared with
    the compat engine and the bitstream module."""
    mv = np.asarray(out["mv"])
    split = np.asarray(out["split"]).tolist()
    smv = np.asarray(out["sub_mv"])
    # one batched .tolist() per array (C speed) instead of nb int() calls
    if ftype == 0:
        mvl = (mv if mv.ndim == 1 else mv[:, 0]).tolist()
        smvl = (smv if smv.ndim == 2 else smv[:, :, 0]).tolist()
        return [(1, smvl[i]) if split[i] else (0, mvl[i]) for i in range(nb)]
    mvl = list(map(tuple, mv.tolist()))
    smvl = [[tuple(q) for q in b] for b in smv.tolist()]
    return [(1, smvl[i]) if split[i] else (0, mvl[i]) for i in range(nb)]


def res_to_list(out, nb):
    qf = np.asarray(out["qtc_full"])
    qq = np.asarray(out["qtc_quads"])
    split = np.asarray(out["split"])
    res = []
    for i in range(nb):
        if split[i]:
            res.append((1, [qq[i, q] for q in range(4)]))
        else:
            res.append((0, qf[i]))
    return res


@functools.partial(jax.jit, static_argnums=0)
def _unpack_payload(s, sp, pay):
    """Merged-coefficient payload -> (qtc_full, qtc_quads): a block is split
    or not, so both share one (bs, bs) slot over the link (halves decode
    H2D bytes); unpacked on device per chunk."""
    return (
        jnp.where(sp[:, None, None], jnp.int16(0), pay),
        jnp.where(
            sp[:, None, None, None],
            pay.reshape(-1, 2, s, 2, s).swapaxes(2, 3).reshape(-1, 4, s, s),
            jnp.int16(0),
        ),
    )


def list_to_mvs_np(mvs_list, ftype, nb):
    """Host-side list_to_mvs: returns NumPy arrays (the mesh packer consumes
    these directly — no device round trip).

    Also accepts the array-form interchange (bitstream.FrameMVArrays, the
    native text parser's output) and passes it through with the same
    (intra: scalar / inter: triple) shape contract as the list path.

    Batched np.array over index groups instead of per-block row assignment:
    element-wise `mv[i] = m` costs ~45 us each in NumPy, which made THIS
    loop (not the device step) the decode wall-time bottleneck at 720p."""
    from streamoptima_tpu.bitstream import FrameMVArrays

    if isinstance(mvs_list, FrameMVArrays):
        if ftype == 0:
            return mvs_list.mv[:, 0], mvs_list.split, mvs_list.smv[:, :, 0]
        return mvs_list.mv, mvs_list.split, mvs_list.smv
    split = np.fromiter((sp for sp, _ in mvs_list), dtype=bool, count=nb)
    if ftype == 0:
        mv = np.zeros(nb, dtype=np.int32)
        smv = np.zeros((nb, 4), dtype=np.int32)
    else:
        mv = np.zeros((nb, 3), dtype=np.int32)
        smv = np.zeros((nb, 4, 3), dtype=np.int32)
    fi = np.flatnonzero(~split)
    si = np.flatnonzero(split)
    if fi.size:
        mv[fi] = np.array([mvs_list[i][1] for i in fi], dtype=np.int32)
    if si.size:
        smv[si] = np.array([mvs_list[i][1] for i in si], dtype=np.int32)
    return mv, split, smv


def list_to_mvs(mvs_list, ftype, nb):
    mv, split, smv = list_to_mvs_np(mvs_list, ftype, nb)
    return jnp.asarray(mv), jnp.asarray(split), jnp.asarray(smv)


def list_to_res_np(res_list, nb, bs, sbs):
    """int16 on purpose: quantized coefficients are bounded by the DC of an
    orthonormal 16x16 DCT of +-255 residuals (|qtc| <= 4080), and int16
    halves decode's host-to-device bytes.  Out-of-range
    values (corrupt streams) raise OverflowError here instead of decoding
    garbage silently.

    Also accepts the array-form interchange (bitstream.FrameResArrays, the
    native text parser's output — already int16 with overflow rejected at
    parse time) and passes it through."""
    from streamoptima_tpu.bitstream import FrameResArrays

    if isinstance(res_list, FrameResArrays):
        return res_list.qf, res_list.qq
    split = np.fromiter((sp for sp, _ in res_list), dtype=bool, count=nb)
    qf = np.zeros((nb, bs, bs), dtype=np.int16)
    qq = np.zeros((nb, 4, sbs, sbs), dtype=np.int16)
    fi = np.flatnonzero(~split)
    si = np.flatnonzero(split)
    if fi.size:
        qf[fi] = np.array([res_list[i][1] for i in fi], dtype=np.int16)
    if si.size:
        qq[si] = np.array([res_list[i][1] for i in si], dtype=np.int16)
    return qf, qq


def list_to_res(res_list, nb, bs, sbs):
    qf, qq = list_to_res_np(res_list, nb, bs, sbs)
    return jnp.asarray(qf), jnp.asarray(qq)
