"""Multi-device encoding over a jax.sharding.Mesh (shard_map + collectives).

Device-mesh successor of the reference's ``multiprocessing`` ParallelModes
(Encoder.py:477-499, :1711-1787; SURVEY.md section 2.4) designed for exactness
instead of the reference's dependency-breaking approximations:

- **"data" axis — GOP parallelism.**  Every GOP opens with an intra frame
  (``i % intra_dur == 0``, Encoder.py:1841), so GOPs are temporally
  independent: sharding whole GOPs across chips is *exact* frame-level
  parallelism — the correct version of the reference's racy ParallelMode 3
  (its Manager.Queue sync, Encoder.py:1717-1723, is approximated-away there).
- **"tile" axis — spatial row parallelism.**  Each chip owns a horizontal
  band of block rows.  Mode-0 intra search/reconstruction only ever reads the
  current 16-row band (core/intra.py), so intra frames need **zero
  communication**.  Inter frames exchange (search_range+1)-row HALOS with
  their up/down neighbors via lax.ppermute — motion search, prediction and
  reconstruction then touch only the local band (+halo).
  ``tile_comm="all_gather"`` keeps the simpler full-frame gather as a
  debug/fallback path; both are bit-identical.  This is the device-mesh
  version of the reference's block/row-level modes 1-2 (which vmap already
  covers on a single device).

The mesh shape is an algorithm choice, not a wiring one: on NVLink every
device reaches every other at the same rate, so "data" x "tile" is picked by
make_mesh from the frame's block rows and the halo alone.

Fast-ME (the raster-sequential MVP chain, Encoder.py:719-742) runs sharded
too: the chain is solved as a global Jacobi fixpoint — each sweep evaluates
every tile's blocks in parallel and passes one (3,)-vector per tile boundary
(_fast_tile_fixpoint) — bit-identical to the single-chip chain.
intra_mode 1 shards the GOP axis only (its column chain crosses row tiles).
Scene-change promotion (RCFlag>1) runs via per-frame sharded steps — its
decision consumes one host scalar per frame (_encode_fsteps).  Two-pass RC
runs CLIP-LEVEL: one full GOP-scan pass for the row-bit stats, one host
reallocation, one per-frame-QP GOP-scan pass (_first_pass_rqps /
_encode_gops_shard_pf).  Decode shards exactly like encode (see decode) —
all bit-identical to the single-chip engine.

Output parity: with parallel_mode=0 the sharded encoder is bit-identical to
the single-chip JaxCodec (tested in tests/test_parallel.py).
"""
from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P_
from jax import shard_map

from streamoptima_tpu import jax_engine
from streamoptima_tpu import rc as rc_mod
from streamoptima_tpu.config import CodecConfig
from streamoptima_tpu.core import intra as I
from streamoptima_tpu.core import me as M
from streamoptima_tpu.core import pred as P
from streamoptima_tpu.core import rd
from streamoptima_tpu.core.quant import rescale
from streamoptima_tpu.core.transform import idct2_int

def _halo_band(refs_l, halo, ntile):
    """Neighbor halo exchange: each tile's (nref, h_t, w) local band grows
    ``halo`` rows from each vertical neighbor via two thin-band ppermutes
    over the "tile" axis (edge tiles receive ppermute's zero fill —
    those rows are outside the frame; every read is masked by global-
    coordinate validity).  ONE implementation for the three encode/decode
    sites.  Returns (nref, h_t + 2*halo, w)."""
    perm_dn = [(i, i + 1) for i in range(ntile - 1)]
    perm_up = [(i + 1, i) for i in range(ntile - 1)]
    top = jax.lax.ppermute(refs_l[:, -halo:, :], "tile", perm_dn)
    bot = jax.lax.ppermute(refs_l[:, :halo, :], "tile", perm_up)
    return jnp.concatenate([top, refs_l, bot], axis=1)


def _fifo_push(refs, nvalid, frame, nref):
    """Reference-FIFO update (Encoder.py:1864-1867): append the newest
    reconstruction, evicting the oldest once nref frames are valid.  ONE
    implementation for every encode/decode scan in this file — the four
    call sites must stay provably identical or encode/decode bit-parity
    silently breaks.  Returns (new_refs, new_nvalid)."""
    full = nvalid >= nref
    rolled = jnp.where(full, jnp.roll(refs, -1, axis=0), refs)
    idx = jnp.minimum(nvalid, nref - 1)
    new_refs = jax.lax.dynamic_update_slice_in_dim(rolled, frame[None], idx, axis=0)
    return new_refs, jnp.minimum(nvalid + 1, nref)


def make_mesh(cfg: CodecConfig, devices=None, tile: int | None = None) -> Mesh:
    """Build a ("data", "tile") mesh over ``devices`` (default: all).

    ``tile`` must divide both the device count and the frame's block-row
    count, and the inter halo (search_range + 1 border rows) must fit the
    per-tile band height; by default the largest such divisor is chosen,
    remaining devices go to GOP ("data") parallelism.  The choice depends on
    the frame only: the devices are assumed to reach each other at one rate
    (NVLink's all-to-all links), so no torus neighbourhood is modelled.
    """
    devices = list(jax.devices() if devices is None else devices)
    n = len(devices)
    nbr = cfg.block_rows
    halo = cfg.search_range + 1

    def halo_fits(t: int) -> bool:
        return t == 1 or halo <= (nbr // t) * cfg.block_size

    if cfg.intra_mode == 1:
        # mode 1's column chain spans all row tiles; only GOP ("data")
        # parallelism applies (VERDICT r2 item 8)
        if tile not in (None, 1):
            raise ValueError("intra_mode=1 requires tile=1 (the vertical intra "
                             "chain crosses row-tile boundaries)")
        tile = 1
    if tile is None:
        tile = 1
        for d in range(n, 0, -1):
            if n % d == 0 and nbr % d == 0 and halo_fits(d):
                tile = d
                break
    if n % tile or nbr % tile:
        raise ValueError(f"tile={tile} must divide device count {n} and block rows {nbr}")
    if not halo_fits(tile):
        raise ValueError(
            f"tile={tile} leaves {(nbr // tile) * cfg.block_size} pixel rows per band, "
            f"smaller than the search halo {halo}; lower the tile count"
        )
    data = n // tile
    arr = np.asarray(devices).reshape(data, tile)
    return Mesh(arr, ("data", "tile"))


class ShardedCodec:
    """GOP- and row-sharded encoder/decoder over a 2D device mesh.

    Same package format as JaxCodec.encode(); ``decode`` shards the same way
    (GOPs over "data", recon bands with ppermute halos over "tile") and is
    bit-identical to the single-chip decoder for GOP-regular streams.
    """

    def __init__(self, cfg: CodecConfig, mesh: Mesh, y_frames=None, tile_comm: str = "halo"):
        assert not cfg.compat, "sharded encoding requires the native engine"
        assert cfg.intra_mode == 0 or mesh.devices.shape[1] == 1, (
            "intra_mode=1 shards the 'data' (GOP) axis only: the vertical "
            "intra chain crosses row-tile boundaries (make_mesh forces tile=1)"
        )
        # scene-change promotion (RCFlag>1) consumes one host scalar per frame
        # (the inter residual size, Encoder.py:1851-1856); it runs on the mesh
        # through the per-frame-step path (_encode_fsteps).
        assert cfg.parallel_mode == 0, "mesh sharding replaces the reference's ParallelModes"
        # fast-ME is supported: the raster-sequential MVP chain
        # (Encoder.py:719-742) is solved as a global Jacobi fixpoint with a
        # per-sweep ppermute of each tile's last MV — see _fast_tile_fixpoint.
        # Bit-identical to the single-chip chain (test_parallel.py).
        assert tile_comm in ("halo", "all_gather")
        self.tile_comm = tile_comm
        self.cfg = cfg
        self.mesh = mesh
        self.y = None if y_frames is None else np.asarray(y_frames, dtype=np.uint8)
        self._frames_dev = None  # device-resident GOP-batched clip (lazy)
        self._decode_js = {}  # jitted sharded decodes, keyed by tile comm
        self._dsteps = {}  # per-frame decode steps for promoted streams, keyed comm
        self._fsteps = None  # jitted per-frame steps for two-pass RC (lazy)
        self._encode2_j = None  # per-frame-QP GOP scan (two-pass pass 2, lazy)
        self.ndata = mesh.devices.shape[0]
        self.ntile = mesh.devices.shape[1]
        self.h, self.w = cfg.height, cfg.width
        self.bs = cfg.block_size
        self.sbs = cfg.sub_block_size
        self.nbr, self.nbc = cfg.block_rows, cfg.blocks_per_row
        assert self.nbr % self.ntile == 0
        self.nbr_t = self.nbr // self.ntile  # block rows per tile
        self.h_t = self.nbr_t * self.bs  # pixel rows per tile
        self.nb_t = self.nbr_t * self.nbc
        self.gl = cfg.intra_dur  # GOP length
        if cfg.rc_active:
            # native K9 fix: per-frame-type rate tables (row 0 = intra, 1 = inter)
            row_qps = np.stack([
                np.asarray(rc_mod.row_qp_sequence(cfg, t), dtype=np.int32) for t in (0, 1)
            ])
        else:
            row_qps = np.broadcast_to(np.full(self.nbr, cfg.qp, dtype=np.int32), (2, self.nbr)).copy()
        self._row_qps = jnp.asarray(row_qps)
        if cfg.roi_qp_map is not None:
            self._roi = jnp.asarray(np.asarray(cfg.roi_qp_map, dtype=np.int32).reshape(self.nbr, self.nbc))
        else:
            self._roi = jnp.zeros((self.nbr, self.nbc), dtype=jnp.int32)
        # local block coords (x global; y local within the tile band)
        ys, xs = np.meshgrid(np.arange(self.nbr_t) * self.bs, np.arange(self.nbc) * self.bs, indexing="ij")
        self._bx = jnp.asarray(xs.reshape(-1))
        self._by_local = jnp.asarray(ys.reshape(-1))
        offs = np.array([[0, 0], [0, 1], [1, 0], [1, 1]]) * self.sbs
        self._qx = jnp.asarray(xs.reshape(-1)[:, None] + offs[None, :, 1])
        self._qy_local = jnp.asarray(ys.reshape(-1)[:, None] + offs[None, :, 0])
        self._encode_j = jax.jit(
            shard_map(
                self._encode_gops_shard,
                mesh=mesh,
                in_specs=(P_("data", None, "tile", None), P_(None, None), P_(None, None)),
                out_specs=self._out_specs(),
                check_vma=False,
            )
        )

    # ----------------------------------------------------------- out specs
    def _out_specs(self):
        return {
            "mv": P_("data", None, "tile", None, None),
            "split": P_("data", None, "tile", None),
            "sub_mv": P_("data", None, "tile", None, None, None),
            "qtc_full": P_("data", None, "tile", None, None, None),
            "qtc_quads": P_("data", None, "tile", None, None, None, None),
            "size": P_("data", None),
            "sqerr": P_("data", None),
            "mae_sum": P_("data", None),
            "recon": P_("data", None, "tile", None),
            "row_bits": P_("data", None, "tile"),
        }

    # ------------------------------------------------------ per-tile steps
    def _qps_blocks(self, row_qps_tile, roi_tile, transposed: bool = False):
        """Per-block QPs in block raster order; ``transposed`` = the
        intra_mode-1 layout (row QPs / ROI offsets land on PIXEL rows either
        way — same round-3 review fix as JaxCodec._block_qps)."""
        q = jnp.broadcast_to(row_qps_tile.astype(jnp.int32)[:, None], (self.nbr_t, self.nbc))
        if self.cfg.roi_qp_map is not None:
            q = jnp.clip(q + roi_tile.reshape(self.nbr_t, self.nbc), 0, 12)
        if transposed:
            q = q.T
        return q.reshape(-1)

    def _grid_out(self, out):
        """(nb_t, ...) flat block arrays -> (nbr_t, nbc, ...) grids."""
        g = {}
        g["mv"] = out["mv"].reshape(self.nbr_t, self.nbc, 3)
        g["split"] = out["split"].reshape(self.nbr_t, self.nbc)
        g["sub_mv"] = out["sub_mv"].reshape(self.nbr_t, self.nbc, 4, 3)
        g["qtc_full"] = out["qtc_full"].reshape(self.nbr_t, self.nbc, self.bs, self.bs)
        g["qtc_quads"] = out["qtc_quads"].reshape(self.nbr_t, self.nbc, 4, self.sbs, self.sbs)
        g["size"] = out["size"]
        g["sqerr"] = out["sqerr"]
        g["mae_sum"] = out["mae_sum"]
        g["recon"] = out["recon"]
        g["row_bits"] = out["row_bits"]  # (nbr_t,) — two-pass pass-1 stats
        return g

    def _intra_tile(self, cur_l, y0_blocks, row_qps_tile, roi_tile):
        """Intra-code the local band (zero communication; mode-0 search and
        reconstruction never leave the 16-row band).  ``row_qps_tile`` is the
        explicit (nbr_t,) per-row QP slice for THIS frame."""
        cfg = self.cfg
        work = cur_l.astype(jnp.int32)
        mode1 = cfg.intra_mode == 1  # tile=1 asserted: band == whole frame
        if mode1:
            # mode 1 = transpose of mode 0, exactly as the single-chip
            # _intra_step (native-only; reference bug B2).  QP/ROI and
            # eligibility vectors are remapped to the transposed block
            # raster so they land on PIXEL rows/blocks — bit-identical to
            # JaxCodec by construction.
            work = work.T
        canvas_w = self.h if mode1 else self.w
        out = I.intra_search_mode0(work, self.bs, cfg.search_range, canvas_w, cfg.vbs_enable, jnp)
        res_full, res_quads = I.intra_residuals_mode0(
            work, out["mv"], out.get("sub_mv"), self.bs, jnp, sr=cfg.search_range
        )
        if mode1:
            res_full = res_full.swapaxes(-1, -2)
            res_quads = None if res_quads is None else res_quads.swapaxes(-1, -2)
        if cfg.vbs_enable:
            sub_sad = out["sub_sad"].reshape(self.nb_t, 4)
            smv = out["sub_mv"].reshape(self.nb_t, 4)
        else:
            res_quads = jnp.zeros((self.nb_t, 4, self.sbs, self.sbs), jnp.int32)
            sub_sad = jnp.zeros((self.nb_t, 4), jnp.int32)
            smv = jnp.zeros((self.nb_t, 4), jnp.int32)
        by_g = self._by_local + y0_blocks * self.bs
        eligible = (self._bx != 0) & (by_g != 0)
        if mode1:  # same block SET, transposed raster order
            eligible = eligible.reshape(self.nbr_t, self.nbc).T.reshape(-1)
        qps = self._qps_blocks(row_qps_tile, roi_tile, transposed=mode1)
        split, qtc_full, qtc_quads, lens, mae_pb = rd.transform_and_select(
            res_full, res_quads, out["sad"].reshape(-1), sub_sad, 0, qps,
            qp_nominal=int(cfg.qp), lam=cfg.lam, vbs_enable=cfg.vbs_enable,
            vbs_eligible=eligible, bs=self.bs, sbs=self.sbs,
        )
        rf = idct2_int(rescale(qtc_full, qps).astype(jnp.int32))
        rq = idct2_int(rescale(qtc_quads, rd.qp_minus_1(qps)[:, None]).astype(jnp.int32))
        rqv = rq if cfg.vbs_enable else None
        if mode1:
            recon = I.intra_reconstruct_mode0(
                rf.swapaxes(-1, -2), None if rqv is None else rqv.swapaxes(-1, -2),
                split, out["mv"].reshape(-1), smv, self.w, self.h, self.bs, jnp,
                sr=cfg.search_range,
            ).T
        else:
            recon = I.intra_reconstruct_mode0(
                rf, rqv, split, out["mv"].reshape(-1), smv,
                self.h_t, self.w, self.bs, jnp, sr=cfg.search_range,
            )
        recon = P.wrap_uint8(recon, jnp)
        mv3 = jnp.zeros((self.nb_t, 3), jnp.int32).at[:, 0].set(out["mv"].reshape(-1))
        smv3 = jnp.zeros((self.nb_t, 4, 3), jnp.int32).at[:, :, 0].set(smv)
        if mode1:  # transposed raster: map lens back to pixel-row bit sums
            row_bits = lens.reshape(self.nbc, self.nbr_t).T.sum(axis=1)
        else:
            row_bits = lens.reshape(self.nbr_t, self.nbc).sum(axis=1)
        return {
            "mv": mv3, "split": split, "sub_mv": smv3,
            # int16 on device (|qtc| <= 4080), the JaxCodec._intra_step
            # narrowing: halves the sharded drain's dominant D2H payload and
            # keeps the two engines' device packages dtype-symmetric
            # (_dequant_tile widens before rescale)
            "qtc_full": qtc_full.astype(jnp.int16),
            "qtc_quads": qtc_quads.astype(jnp.int16),
            "size": jax.lax.psum(lens.sum(), "tile"), "recon": recon,
            "mae_sum": jax.lax.psum(mae_pb.sum(), "tile"),
            "row_bits": row_bits,
        }

    def _fast_tile_fixpoint(self, cur32, search_refs, nvalid, y0_px, fme, g0=None):
        """Fast-ME MVP chain on the mesh: global Jacobi fixpoint.

        The reference's recurrence mv[i] = f_i(mv[i-1]) runs in raster order
        across the WHOLE frame (Encoder.py:719-742) — it crosses tile
        boundaries, which is why round 1 guarded fast-ME off the mesh.  The
        Jacobi solve removes the obstacle: every sweep each tile evaluates
        only its local blocks against guessed MVPs (core/me.py fast_sweep),
        then hands its LAST block's MV to the next tile with a single
        (3,)-vector ppermute — tile 0's seed is ppermute's zero fill, which
        is exactly the chain's mv[-1] = 0.  Convergence is checked globally
        (psum), so all tiles leave the while_loop together; at the fixpoint
        the chain equations hold across the whole frame, giving the
        bit-exact forward-substitution solution (unique by induction).
        search_refs must be the FULL-height reference stack (all_gather) —
        the MVP walk is unbounded so halo bands cannot serve it.

        ``g0`` warm-starts the iteration (motion fields are temporally
        coherent, so the previous frame's converged guesses land most blocks
        on their true MVP immediately).  ANY start converges to the same unique fixpoint, so
        warm-starting cannot change the result."""
        cfg = self.cfg
        scale = 2 if fme else 1
        n = self.bs
        step_px = 2 if fme else 1
        pad = step_px * (n - 1) + 3
        dims = search_refs.shape[-2:]
        # pixel-range values ([0,255] even after the ceil-average upsample):
        # gather uint8 windows to quarter the sweep's HBM traffic
        refs_pad = jnp.pad(search_refs, ((0, 0), (pad, pad), (pad, pad))).astype(jnp.uint8)
        cur_b = cur32.reshape(self.nbr_t, self.bs, self.nbc, self.bs).swapaxes(1, 2).reshape(
            -1, self.bs, self.bs
        )
        X = (self._bx * scale).astype(jnp.int32)
        Y = ((self._by_local + y0_px) * scale).astype(jnp.int32)
        perm_dn = [(i, i + 1) for i in range(self.ntile - 1)]
        nb_total = self.nbr * self.nbc

        def body(state):
            g, _, _, _, it = state
            m, sad = M.fast_sweep(cur_b, X, Y, refs_pad, pad, dims, n, fme, g, nvalid=nvalid)
            seed = jax.lax.ppermute(m[-1], "tile", perm_dn)  # tile 0: zeros = mv[-1]
            g2 = jnp.concatenate([seed[None], m[:-1]], axis=0)
            # convergence over the WHOLE mesh, not just this tile group: the
            # ppermute above is one SPMD collective shared by every device,
            # so the while trip count must be uniform mesh-wide — "data"
            # groups whose GOP converged first keep sweeping (idempotent: a
            # fixpoint stays fixed) until the slowest group is done.  A
            # tile-only psum deadlocks the collective rendezvous.
            changed = jax.lax.psum(jnp.any(g2 != g).astype(jnp.int32), ("data", "tile")) > 0
            return (g2, m, sad, changed, it + 1)

        def cond(state):
            return jnp.logical_and(state[3], state[4] <= nb_total)

        init = (
            jnp.zeros((self.nb_t, 3), jnp.int32) if g0 is None else g0,
            jnp.zeros((self.nb_t, 3), jnp.int32),
            jnp.zeros((self.nb_t,), jnp.int32),
            jnp.asarray(True),
            jnp.asarray(0, jnp.int32),
        )
        g_fin, mv, sad, _, _ = jax.lax.while_loop(cond, body, init)
        outs = {"mv": mv, "sad": sad, "ok": sad != np.int32(2**31 - 1), "g_fin": g_fin}
        if cfg.vbs_enable:
            cur_q = cur_b.reshape(-1, 2, self.sbs, 2, self.sbs).swapaxes(2, 3).reshape(
                -1, 4, self.sbs, self.sbs
            )
            qx = (self._qx * scale).astype(jnp.int32)
            qy = ((self._qy_local + y0_px) * scale).astype(jnp.int32)
            smv, ssad = M.fast_quads_sweep(
                cur_q, qx, qy, refs_pad, pad, dims, self.sbs, fme, g_fin, nvalid=nvalid
            )
            outs["sub_mv"] = smv
            outs["sub_sad"] = ssad
            outs["sub_ok"] = ssad != np.int32(2**31 - 1)
        return outs

    def _fast_me_seg_mult(self) -> int:
        """Resolved rowscan segment multiplier for the TILE-local chain
        (fastme.resolve_seg_mult — the single-chip rule: a divisor of nbc,
        "auto" = 1, loud on silent rounding)."""
        from streamoptima_tpu.core.fastme import resolve_seg_mult

        return resolve_seg_mult(self.cfg.fast_me_seg_mult, self.nbc)

    def _fast_me_lookahead(self, seg_len: int, n_segments: int) -> int:
        """Resolved rowscan lookahead (fastme.resolve_lookahead — the shared
        single-chip rule, loud on silently overridden explicit requests)."""
        from streamoptima_tpu.core.fastme import resolve_lookahead

        return resolve_lookahead(self.cfg.fast_me_lookahead, seg_len, n_segments)

    def _fast_tile_rowscan(self, cur32, band, nvalid, y0_px, fme, g0=None):
        """Fast-ME on the mesh, row-segmented (fast_me_chain "rowscan", the
        default): a lax.scan over block COLUMNS advances every local block
        row simultaneously (exact forward substitution within each row), so
        the Jacobi iteration runs only over the per-row seed MVs — locally
        the hand-off mv[r, 0] = f(mv[r-1, nbc-1]), across tiles a single
        (3,)-vector ppermute of the tile's last MV exactly like
        _fast_tile_fixpoint (whose fixpoint = forward-substitution argument
        applies verbatim with rows in place of blocks).  Convergence is
        checked mesh-wide (psum) so the while trip count stays uniform.

        The block eval is core/fastme.py on the UNPADDED parity planes of
        the all_gather'd full-height band — the (2H-1, 2W-1) upsample is
        never materialized (~265 MB/ref at 4K) — and the confirm pass at the
        converged
        MVPs folds in the VBS quad searches and the winner predictions
        (bit-exact pred.gather_predictions semantics), so no prediction
        gathers remain anywhere on the fast path."""
        from streamoptima_tpu.core import fastme as FM

        cfg = self.cfg
        scale = 2 if fme else 1
        n = self.bs
        nbr_t, nbc = self.nbr_t, self.nbc
        planes = FM.plane_stack(band, fme, jnp, wrap_row_pass=True)
        dims = (2 * self.h - 1, 2 * self.w - 1) if fme else (self.h, self.w)
        # segment generalization (cfg.fast_me_seg_mult, same fixpoint argument
        # as the single-chip solve): the tile's local chain is cut into
        # S = k*nbr_t segments of L = nbc/k blocks; the cross-tile hand-off
        # stays one (3,)-vector ppermute of the tile's LAST MV per pass.
        k = self._fast_me_seg_mult()
        S, L = nbr_t * k, nbc // k
        kl = self._fast_me_lookahead(L, S)
        # fetch mode by plane area (fastme.resolve_fetch_mode, single-chip
        # rule): one-hot gather on small planes, clamped-dynamic-slice
        # gather on large ones
        fmode = FM.resolve_fetch_mode(cfg.fast_me_fetch, self.h, self.w,
                                      int(planes.shape[0]))
        wr, wc = FM.wide_window_spec(n, kl, fme)
        wprep = FM.window_prep(planes, n + 2, fmode,
                               wide=(wr, wc) if kl > 1 else None)
        cur_b = cur32.reshape(nbr_t, n, nbc, n).swapaxes(1, 2).reshape(-1, n, n)
        curT = cur_b.reshape(S, L, n, n).swapaxes(0, 1)  # (L, S, n, n)
        xsT = self._bx.astype(jnp.int32).reshape(S, L).swapaxes(0, 1)  # (L, S)
        ysT = (self._by_local + y0_px).astype(jnp.int32).reshape(S, L).swapaxes(0, 1)
        perm_dn = [(i, i + 1) for i in range(self.ntile - 1)]

        if kl > 1:
            # speculative lookahead (fastme.eval_chain — the single-chip
            # rule): kl chain columns per scan step from one wide window per
            # segment; padded tail columns propagate the MVP, so the
            # cross-tile ppermute still carries the true last column's MV
            Lp = -(-L // kl)
            padc = Lp * kl - L
            ysv = ysT[0]
            curK = jnp.concatenate(
                [curT, jnp.zeros((padc,) + curT.shape[1:], curT.dtype)]
            ).reshape(Lp, kl, S, n, n) if padc else curT.reshape(Lp, kl, S, n, n)
            xsK = jnp.concatenate(
                [xsT, jnp.broadcast_to(xsT[-1:], (padc, S))]
            ).reshape(Lp, kl, S) if padc else xsT.reshape(Lp, kl, S)
            cmK = jnp.asarray((np.arange(Lp * kl) < L).reshape(Lp, kl))

            def row_pass(seeds):
                def step(g, inp):
                    cb, xv, cm = inp
                    by0, bx0 = FM._wide_base(g, ysv, xv[0], kl, fme, jnp)
                    wide = FM.window_read(wprep, by0, bx0, wr, jnp, nwin_c=wc)
                    mvs = FM.eval_chain(wide, cb, g, xv, ysv, n, kl, dims,
                                        fme, nvalid, cm, jnp)
                    return mvs[-1], (mvs, wide)

                m_last, (mK, wK) = jax.lax.scan(step, seeds, (curK, xsK, cmK))
                # last pass's wide windows feed the confirm (single-chip rule)
                return m_last, (mK.reshape(Lp * kl, S, 3)[:L], wK)
        else:

            def row_pass(seeds):
                def step(g, inp):
                    cb, xv, yv = inp  # (S, n, n), (S,), (S,)
                    by0, bx0 = FM._region_base(g, yv, xv, n, fme, jnp)
                    win = FM.window_read(wprep, by0, bx0, n + 2, jnp)
                    mv, _ = FM.eval9(win, cb, g, xv * scale, yv * scale, n, dims,
                                     fme, nvalid, jnp)
                    return mv, mv

                return jax.lax.scan(step, seeds, (curT, xsT, ysT))

        def body(state):
            seeds, _, _, it = state
            m_last, mT = row_pass(seeds)
            cross = jax.lax.ppermute(m_last[-1], "tile", perm_dn)  # tile 0: zeros
            seeds2 = jnp.concatenate([cross[None], m_last[:-1]], axis=0)
            # mesh-wide convergence: the ppermute is one SPMD collective per
            # sweep shared by every device, so the trip count must be
            # uniform — converged "data" groups keep iterating idempotently
            changed = jax.lax.psum(jnp.any(seeds2 != seeds).astype(jnp.int32), ("data", "tile")) > 0
            return (seeds2, mT, changed, it + 1)

        def cond(state):
            return jnp.logical_and(state[2], state[3] <= self.nbr * k + 1)

        seeds0 = (
            jnp.zeros((S, 3), jnp.int32) if g0 is None else g0.reshape(S, L, 3)[:, 0]
        )
        if kl > 1:
            extra0 = jnp.zeros((-(-L // kl), S, planes.shape[0], wr, wc), jnp.int32)
            init = (seeds0, (jnp.zeros((L, S, 3), jnp.int32), extra0),
                    jnp.asarray(True), jnp.asarray(0, jnp.int32))
            seeds_fin, (mT, wT), _, _ = jax.lax.while_loop(cond, body, init)
        else:
            init = (seeds0, jnp.zeros((L, S, 3), jnp.int32), jnp.asarray(True),
                    jnp.asarray(0, jnp.int32))
            seeds_fin, mT, _, _ = jax.lax.while_loop(cond, body, init)
        m = mT.swapaxes(0, 1).reshape(self.nb_t, 3)
        # the guesses vector: local shift + the converged cross-tile seed
        # (seeds_fin[0] = the neighbor's last MV, already exchanged in-loop)
        g_fin = jnp.concatenate([seeds_fin[0][None], m[:-1]], axis=0)
        by0, bx0 = FM._region_base(
            g_fin, (self._by_local + y0_px).astype(jnp.int32), self._bx.astype(jnp.int32),
            n, fme, jnp,
        )
        if kl > 1:
            win = FM.confirm_windows_from_stack(wT, g_fin, n, kl, L, S, fme, jnp)
        else:
            win = FM.window_read(wprep, by0, bx0, n + 2, jnp)
        cur_q = cur_b.reshape(-1, 2, self.sbs, 2, self.sbs).swapaxes(2, 3).reshape(
            -1, 4, self.sbs, self.sbs
        ) if cfg.vbs_enable else jnp.zeros((self.nb_t, 4, self.sbs, self.sbs), jnp.int32)
        outs = FM.confirm(
            win, cur_b, cur_q, g_fin,
            (self._bx * scale).astype(jnp.int32),
            ((self._by_local + y0_px) * scale).astype(jnp.int32),
            n, self.sbs, dims, fme, cfg.vbs_enable, nvalid, by0, bx0, jnp,
        )
        outs["g_fin"] = g_fin
        return outs

    def _inter_tile(self, cur_l, refs_l, nvalid, y0_blocks, row_qps_tile, roi_tile, g0=None):
        """Inter-code the local band against the FIFO of reference bands.

        The tile's reference band is either the full-height stack (one
        all_gather over the "tile" axis) or its own rows plus ppermute halos;
        everything downstream touches only the local band.
        """
        cfg = self.cfg
        fme = cfg.fme_enable
        scale = 2 if fme else 1
        sr = cfg.search_range * 2 if fme else cfg.search_range
        y0_px = y0_blocks * self.bs
        cur32 = cur_l.astype(jnp.int32)
        grid_dims = (2 * self.h - 1, 2 * self.w - 1) if fme else (self.h, self.w)

        # fast-ME's MVP walk is unbounded (each block's window recenters on
        # its predecessor's MV, Encoder.py:719-742), so halo bands can't
        # serve it: always rebuild the full-height reference stack
        if cfg.fast_me or self.ntile == 1 or self.tile_comm == "all_gather":
            band = jax.lax.all_gather(refs_l, "tile", axis=1, tiled=True)  # (nref, h, w)
            origin_px = 0
            search_row_offset = scale * y0_px
            pred_origin = 0
        else:
            # halo exchange: each tile only needs the neighbors' search_range
            # (+1 for half-pel interpolation) border rows — a ppermute of thin
            # bands instead of an all_gather of whole frames.  Edge tiles
            # receive ppermute's zero fill; those rows are outside the
            # frame and every read of them is masked (validity uses global
            # coordinates via grid_dims/origin_row).
            halo = cfg.search_range + 1
            assert halo <= self.h_t, "halo exceeds tile height; lower the tile count"
            band = _halo_band(refs_l, halo, self.ntile)  # (nref, h_t+2halo, w)
            origin_px = y0_px - halo  # band row 0 in global pixel rows (traced)
            search_row_offset = scale * halo
            pred_origin = scale * origin_px

        if cfg.fast_me:
            if cfg.fast_me_chain in ("auto", "rowscan"):
                # rowscan reads the parity planes directly (no upsample) and
                # returns the predictions from its confirm pass
                search_refs = None
                with jax.named_scope("fastme_chain"):
                    s = self._fast_tile_rowscan(cur32, band, nvalid, y0_px, fme, g0=g0)
            else:
                # refs are real uint8 reconstructions (every GOP opens
                # intra), so the row-pass wrap (quirk K17) is always live
                if fme:
                    search_refs = jax.vmap(lambda r: M.fme_upsample(r, jnp, wrap_row_pass=True))(band)
                else:
                    search_refs = band.astype(jnp.int32)
                s = self._fast_tile_fixpoint(cur32, search_refs, nvalid, y0_px, fme, g0=g0)
        else:
            if fme:
                # refs are real uint8 reconstructions (every GOP opens intra),
                # so the row-pass wrap (quirk K17) is always live
                search_refs = jax.vmap(lambda r: M.fme_upsample(r, jnp, wrap_row_pass=True))(band)
            else:
                search_refs = band.astype(jnp.int32)
            # auto => fused inside the GOP scan: chosen on a TPU; not yet
            # measured on the H100 (ROADMAP Design 3)
            search = M.full_search_materialized if cfg.me_search == "materialized" else M.full_search_fused
            with jax.named_scope("full_search"):
                s = search(
                    cur32, search_refs, sr, self.bs, self.sbs, scale, fme, cfg.vbs_enable, jnp,
                    row_offset=search_row_offset, nvalid=nvalid, grid_dims=grid_dims,
                    valid_row_offset=scale * y0_px,
                )
        g_next = s.pop("g_fin", None)  # fast-ME: warm start for the next frame
        mv, sad, ok = s["mv"], s["sad"], s["ok"]
        by_g = self._by_local + y0_px

        cur_blocks = cur32.reshape(self.nbr_t, self.bs, self.nbc, self.bs).swapaxes(1, 2).reshape(-1, self.bs, self.bs)
        if "pred_full" in s:  # fast-ME rowscan: confirm-pass predictions
            pred_full = s["pred_full"]
        else:
            with jax.named_scope("pred_gather"):
                pred_full = P.gather_predictions(mv, search_refs, self._bx, by_g, self.bs, fme,
                                                 jnp, grid_dims=grid_dims, origin_row=pred_origin)
        res_full = cur_blocks - pred_full

        if cfg.vbs_enable:
            qy_g = self._qy_local + y0_px
            smv = s["sub_mv"]
            sub_sad = s["sub_sad"]
            sub_ok = s["sub_ok"]
            if "pred_quads" in s:  # rowscan confirm pass
                pred_q = s["pred_quads"]
            else:
                with jax.named_scope("pred_gather"):
                    pred_q = P.gather_predictions(
                        smv.reshape(-1, 3), search_refs, self._qx.reshape(-1), qy_g.reshape(-1),
                        self.sbs, fme, jnp, grid_dims=grid_dims, origin_row=pred_origin,
                    ).reshape(self.nb_t, 4, self.sbs, self.sbs)
            quads = cur_blocks.reshape(-1, 2, self.sbs, 2, self.sbs).swapaxes(2, 3).reshape(-1, 4, self.sbs, self.sbs)
            res_quads = quads - pred_q
        else:
            smv = jnp.zeros((self.nb_t, 4, 3), jnp.int32)
            res_quads = jnp.zeros((self.nb_t, 4, self.sbs, self.sbs), jnp.int32)
            sub_sad = jnp.zeros((self.nb_t, 4), jnp.int32)
            sub_ok = None

        eligible = (self._bx != 0) & (by_g != 0)
        qps = self._qps_blocks(row_qps_tile, roi_tile)
        split, qtc_full, qtc_quads, lens, mae_pb = rd.transform_and_select(
            res_full, res_quads, sad, sub_sad, 1, qps,
            qp_nominal=int(cfg.qp), lam=cfg.lam, vbs_enable=cfg.vbs_enable,
            vbs_eligible=eligible, bs=self.bs, sbs=self.sbs,
            ok_full=ok, ok_quads=sub_ok,
        )
        rf = idct2_int(rescale(qtc_full, qps).astype(jnp.int32))
        full_blocks = P.wrap_uint8(pred_full + rf, jnp)
        if cfg.vbs_enable:
            rq = idct2_int(rescale(qtc_quads, rd.qp_minus_1(qps)[:, None]).astype(jnp.int32))
            quad_blocks = P.wrap_uint8(pred_q + rq, jnp)
            quad_merged = quad_blocks.reshape(-1, 2, 2, self.sbs, self.sbs).swapaxes(2, 3).reshape(
                -1, self.bs, self.bs
            )
            blocks = jnp.where(split[:, None, None], quad_merged, full_blocks)
        else:
            blocks = full_blocks
        recon = blocks.reshape(self.nbr_t, self.nbc, self.bs, self.bs).swapaxes(1, 2).reshape(self.h_t, self.w)
        out = {
            "mv": mv, "split": split, "sub_mv": smv,
            # int16 on device (see _intra_tile_step / JaxCodec._inter_step)
            "qtc_full": qtc_full.astype(jnp.int16),
            "qtc_quads": qtc_quads.astype(jnp.int16),
            "size": jax.lax.psum(lens.sum(), "tile"), "recon": recon,
            "mae_sum": jax.lax.psum(mae_pb.sum(), "tile"),
            "row_bits": lens.reshape(self.nbr_t, self.nbc).sum(axis=1),
        }
        if g_next is not None:
            out["g_next"] = g_next  # fast-ME warm start (dropped by _grid_out)
        return out

    # -------------------------------------------------------- shard program
    def _encode_gop_local(self, frames_l, qps_pf_tile, roi_tile, y0_blocks):
        """Encode one GOP's local band: intra frame 0, scan over inter frames
        carrying the reference-band FIFO.  ``qps_pf_tile`` is (gl, nbr_t) —
        PER-FRAME row QPs (the normal path broadcasts the per-type rows to
        this shape in _encode_gops_shard; two-pass pass 2 supplies real
        per-frame reallocations)."""
        cfg = self.cfg
        nref = cfg.n_ref_frames
        cur0 = frames_l[0]
        out0 = self._intra_tile(cur0, y0_blocks, qps_pf_tile[0], roi_tile)
        out0["sqerr"] = jax.lax.psum(
            jnp.sum((out0["recon"].astype(jnp.float32) - cur0.astype(jnp.float32)) ** 2), "tile"
        )

        if self.gl == 1:
            return jax.tree.map(lambda a: a[None], self._grid_out(out0))

        refs0 = jnp.zeros((nref, self.h_t, self.w), dtype=jnp.uint8).at[0].set(out0["recon"])
        # fast-ME: the converged Jacobi guesses ride the scan carry so each
        # frame warm-starts from the previous frame's MV field (temporal
        # coherence => ~4x fewer sweeps; the fixpoint is unique so the warm
        # start cannot change results)
        g0 = jnp.zeros((self.nb_t, 3), jnp.int32) if cfg.fast_me else None

        def step(carry, x):
            cur, rqp = x
            refs, nvalid, g = carry
            out = self._inter_tile(cur, refs, nvalid, y0_blocks, rqp, roi_tile, g0=g)
            g_next = out.pop("g_next", None)
            out["sqerr"] = jax.lax.psum(
                jnp.sum((out["recon"].astype(jnp.float32) - cur.astype(jnp.float32)) ** 2), "tile"
            )
            # reference FIFO (Encoder.py:1864-1867): append newest, drop oldest
            new_refs, new_nv = _fifo_push(refs, nvalid, out["recon"], nref)
            return (new_refs, new_nv, g_next), self._grid_out(out)

        (_, _, _), outs = jax.lax.scan(step, (refs0, jnp.int32(1), g0), (frames_l[1:], qps_pf_tile[1:]))
        out0g = self._grid_out(out0)
        return jax.tree.map(lambda a, b: jnp.concatenate([a[None], b], axis=0), out0g, outs)

    def _encode_gops_shard(self, frames_g, row_qps, roi):
        """Per-device program: frames_g (G_local, gl, h_t, w); row_qps is the
        per-TYPE (2, nbr) table, broadcast to per-frame rows (frame 0 intra,
        rest inter — the GOP-regular sequence this scan serves)."""
        tile_idx = jax.lax.axis_index("tile")
        y0_blocks = tile_idx * self.nbr_t
        row_qps_tile = jax.lax.dynamic_slice_in_dim(row_qps, y0_blocks, self.nbr_t, axis=1)  # (2, nbr_t)
        roi_tile = jax.lax.dynamic_slice_in_dim(roi, y0_blocks, self.nbr_t, axis=0)
        qps_pf = jnp.concatenate(
            [row_qps_tile[0:1], jnp.broadcast_to(row_qps_tile[1], (self.gl - 1, self.nbr_t))]
        ) if self.gl > 1 else row_qps_tile[0:1]
        return jax.vmap(lambda fl: self._encode_gop_local(fl, qps_pf, roi_tile, y0_blocks))(frames_g)

    def _encode_gops_shard_pf(self, frames_g, qps_pf_g, roi):
        """Per-device program with PER-FRAME row QPs: qps_pf_g (G_local, gl,
        nbr) — the two-pass second pass (each frame re-encoded at its
        reallocated row budgets, rc.second_pass_row_qps)."""
        tile_idx = jax.lax.axis_index("tile")
        y0_blocks = tile_idx * self.nbr_t
        roi_tile = jax.lax.dynamic_slice_in_dim(roi, y0_blocks, self.nbr_t, axis=0)
        qps_t = jax.lax.dynamic_slice_in_dim(qps_pf_g, y0_blocks, self.nbr_t, axis=2)  # (G, gl, nbr_t)
        return jax.vmap(
            lambda fl, qp: self._encode_gop_local(fl, qp, roi_tile, y0_blocks)
        )(frames_g, qps_t)

    # -------------------------------------------------------------- encode
    def encode(self, fetch: str = "full"):
        """Full-clip encode; returns the same package dict as JaxCodec.

        GOPs are dispatched in fixed-shape batches of ``ndata`` (one GOP per
        "data"-axis device), so the shard program compiles once regardless of
        clip length.  ``fetch="light"`` skips the device->host transfer of
        coefficients/MVs and the list-interchange conversion ("MVS per Frame"
        / "approx residual" omitted) — for benchmarks and metric sweeps where
        only reconstructions and sizes matter.
        """
        cfg = self.cfg
        assert self.y is not None, "construct with y_frames to encode"
        if cfg.rc_flag is not None and cfg.rc_flag > 1:
            # scene promotion consumes one host scalar per frame: fsteps path
            # (handles the two-pass composition clip-level too)
            return self._encode_fsteps(fetch)
        n = cfg.frames
        gl = self.gl
        n_gops = math.ceil(n / gl)
        g_pad = math.ceil(n_gops / self.ndata) * self.ndata
        self._stage_frames(g_pad)
        rqp_pf = None
        if cfg.two_pass and cfg.rc_active:
            # clip-level two-pass (bitwise shared with JaxCodec.encode):
            # pass 1 = this same GOP scan at the table QPs, keeping only the
            # per-frame row bits; host reallocates each frame's row budgets;
            # pass 2 below re-runs the scan with per-frame QPs (two async
            # passes instead of four host syncs per frame).
            rqp_pf = self._first_pass_rqps(g_pad)
        out = self._run_scan_batches(g_pad, fetch, rqp_pf)

        nb = self.nbr * self.nbc
        rq = np.asarray(self._row_qps)
        row_qps_host = {0: [int(q) for q in rq[0]], 1: [int(q) for q in rq[1]]}
        mvs_pf, res_pf, psnr_pf, mae_pf, sizes, ftypes = [], [], [], [], [], []
        recon = None if fetch == "metrics" else np.zeros((n, self.h, self.w), dtype=np.uint8)
        for i in range(n):
            g, f = divmod(i, gl)
            ftype = 0 if f == 0 else 1
            ftypes.append(ftype)
            if fetch not in ("light", "metrics"):
                per = {
                    "mv": out["mv"][g, f].reshape(nb, 3),
                    "split": out["split"][g, f].reshape(nb),
                    "sub_mv": out["sub_mv"][g, f].reshape(nb, 4, 3),
                    "qtc_full": out["qtc_full"][g, f].reshape(nb, self.bs, self.bs),
                    "qtc_quads": out["qtc_quads"][g, f].reshape(nb, 4, self.sbs, self.sbs),
                }
                mvs_pf.append(jax_engine.mvs_to_list(per, ftype, nb))
                res_pf.append(jax_engine.res_to_list(per, nb))
            sizes.append(int(out["size"][g, f]))
            mse = out["sqerr"][g, f] / (self.h * self.w)
            psnr_pf.append(float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf"))
            mae_pf.append(float(out["mae_sum"][g, f]) / nb)
            if recon is not None:
                recon[i] = out["recon"][g, f]
        pkg = {
            "block size": self.bs,
            "num frames": n,
            "height in pixels": self.h,
            "width in pixels": self.w,
            "search range": cfg.search_range,
            "PSNR per frame": psnr_pf,
            "MAE per Frame": mae_pf,
            "frame_type_seq": ftypes,
            "Qp_per_row_per_frame": [
                ([int(q) for q in rqp_pf[divmod(i, gl)[0], divmod(i, gl)[1]]] if rqp_pf is not None
                 else row_qps_host[ftypes[i]] if cfg.rc_active else [])
                for i in range(n)
            ],
            "residual size per frame": sizes,
            "reconstructed frames": recon,
        }
        if fetch not in ("light", "metrics"):
            pkg["MVS per Frame"] = mvs_pf
            pkg["approx residual"] = res_pf
        return pkg

    def _stage_frames(self, g_pad):
        """Device-resident GOP-batched clip (one H2D upload for the clip;
        re-uploading every batch would serialize the upload against
        compute)."""
        n, gl = self.cfg.frames, self.gl
        if self._frames_dev is None or self._frames_dev.shape[0] != g_pad:
            frames_g = np.zeros((g_pad, gl, self.h, self.w), dtype=np.uint8)
            flat = frames_g.reshape(-1, self.h, self.w)
            flat[:n] = self.y[:n]
            # pad by repeating the last real frame (padding output is dropped)
            flat[n:] = self.y[n - 1]
            self._frames_dev = jax.device_put(jnp.asarray(frames_g))

    def _run_scan_batches(self, g_pad, fetch, rqp_pf=None):
        """Dispatch the GOP scan over fixed-shape ndata-sized batches and
        concatenate the host results.  ``rqp_pf`` (g_pad, gl, nbr) switches to
        the per-frame-QP program (two-pass pass 2)."""
        if rqp_pf is not None and self._encode2_j is None:
            self._encode2_j = jax.jit(
                shard_map(
                    self._encode_gops_shard_pf, mesh=self.mesh,
                    in_specs=(P_("data", None, "tile", None), P_("data", None, None), P_(None, None)),
                    out_specs=self._out_specs(), check_vma=False,
                )
            )
        rqp_dev = None if rqp_pf is None else jax.device_put(jnp.asarray(rqp_pf))
        outs = []
        light_keys = ("size", "sqerr", "mae_sum") if fetch == "metrics" else ("recon", "size", "sqerr", "mae_sum")
        for b in range(g_pad // self.ndata):
            sl = slice(b * self.ndata, (b + 1) * self.ndata)
            if rqp_dev is None:
                o = self._encode_j(self._frames_dev[sl], self._row_qps, self._roi)
            else:
                o = self._encode2_j(self._frames_dev[sl], rqp_dev[sl], self._roi)
            if fetch in ("light", "metrics"):
                o = {k: o[k] for k in light_keys}
            for v in o.values():  # overlap D2H with the next batch's compute
                try:
                    v.copy_to_host_async()
                except AttributeError:
                    pass
            outs.append(o)
            # bounded device memory (the single-chip engine's drain,
            # mirrored): convert the batch BEHIND the frontier to host
            # arrays — its async copies are already in flight — so
            # device residency stays ~2 batches regardless of clip length
            # (~75 MB/frame at 4K with both coefficient sets under "full")
            if len(outs) >= 2:
                outs[-2] = jax.tree.map(np.asarray, outs[-2])
        return jax.tree.map(lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=0), *outs)

    def _first_pass_rqps(self, g_pad):
        """Two-pass pass 1: run the normal GOP scan, keep each frame's row
        bits (tiny — one async D2H per batch), and reallocate every frame's
        row budgets on the host (rc.second_pass_row_qps, shared with
        JaxCodec so mesh two-pass stays bitwise identical to single-chip).
        Returns (g_pad, gl, nbr) int32 per-frame row QPs."""
        cfg = self.cfg
        rbs = []
        for b in range(g_pad // self.ndata):
            o = self._encode_j(
                self._frames_dev[b * self.ndata : (b + 1) * self.ndata], self._row_qps, self._roi
            )
            rb = o["row_bits"]
            try:
                rb.copy_to_host_async()
            except AttributeError:
                pass
            rbs.append(rb)
        row_bits = np.concatenate([np.asarray(r) for r in rbs], axis=0)  # (g_pad, gl, nbr)
        type_rows = np.asarray(self._row_qps)
        out = np.empty((g_pad, self.gl, self.nbr), np.int32)
        for g in range(g_pad):
            for f in range(self.gl):
                ft = 0 if f == 0 else 1
                out[g, f] = rc_mod.second_pass_row_qps(cfg, row_bits[g, f], ft, type_rows[ft])
        return out

    # -------------------------------------------------------------- decode
    # GOP- and row-sharded decode (round-1 VERDICT item 4): same mesh layout
    # as encode — the "data" axis decodes whole GOPs independently (every GOP
    # opens intra, so no cross-GOP state), the "tile" axis reconstructs
    # horizontal bands with a recon-halo ppermute per inter frame (the mirror
    # of the encoder's search halo; decode needs only search_range+1 border
    # rows for motion compensation).  Reference decode loop: decoder.py:487-545.

    def _dequant_tile(self, qtc_full, qtc_quads, row_qps_tile, roi_tile,
                      transposed: bool = False):
        qps = self._qps_blocks(row_qps_tile, roi_tile, transposed)
        # int16 on the host-device path (see JaxCodec._dequant); widen
        # before rescale
        qtc_full = qtc_full.astype(jnp.int32)
        qtc_quads = qtc_quads.astype(jnp.int32)
        rf = idct2_int(rescale(qtc_full, qps).astype(jnp.int32))
        rq = idct2_int(rescale(qtc_quads, rd.qp_minus_1(qps)[:, None]).astype(jnp.int32))
        return rf, rq

    def _merge_blocks(self, full_blocks, quad_blocks, split):
        if self.cfg.vbs_enable:
            qm = quad_blocks.reshape(-1, 2, 2, self.sbs, self.sbs).swapaxes(2, 3).reshape(
                -1, self.bs, self.bs
            )
            blocks = jnp.where(split[:, None, None], qm, full_blocks)
        else:
            blocks = full_blocks
        return blocks.reshape(self.nbr_t, self.nbc, self.bs, self.bs).swapaxes(1, 2).reshape(
            self.h_t, self.w
        )

    def _intra_tile_decode(self, mv, split, smv, qtc_full, qtc_quads, row_qps_tile, roi_tile):
        rf, rq = self._dequant_tile(qtc_full, qtc_quads, row_qps_tile, roi_tile,
                                    transposed=self.cfg.intra_mode == 1)
        rqv = rq if self.cfg.vbs_enable else None
        if self.cfg.intra_mode == 1:  # transpose of mode 0 (tile=1 asserted)
            frame = I.intra_reconstruct_mode0(
                rf.swapaxes(-1, -2), None if rqv is None else rqv.swapaxes(-1, -2),
                split, mv[:, 0], smv[:, :, 0], self.w, self.h, self.bs, jnp,
                sr=self.cfg.search_range,
            ).T
        else:
            frame = I.intra_reconstruct_mode0(
                rf, rqv, split, mv[:, 0], smv[:, :, 0],
                self.h_t, self.w, self.bs, jnp, sr=self.cfg.search_range,
            )
        return P.wrap_uint8(frame, jnp)

    def _inter_tile_decode(self, refs_l, y0_blocks, mv, split, smv,
                           qtc_full, qtc_quads, row_qps_tile, roi_tile, comm):
        cfg = self.cfg
        fme = cfg.fme_enable
        scale = 2 if fme else 1
        y0_px = y0_blocks * self.bs
        grid_dims = (2 * self.h - 1, 2 * self.w - 1) if fme else (self.h, self.w)
        if self.ntile == 1 or comm == "all_gather":
            band = jax.lax.all_gather(refs_l, "tile", axis=1, tiled=True)
            pred_origin = 0
        else:
            halo = cfg.search_range + 1
            band = _halo_band(refs_l, halo, self.ntile)
            pred_origin = scale * (y0_px - halo)
        if fme:
            pred_refs = jax.vmap(lambda r: M.fme_upsample(r, jnp, wrap_row_pass=True))(band)
        else:
            pred_refs = band.astype(jnp.int32)
        by_g = self._by_local + y0_px
        rf, rq = self._dequant_tile(qtc_full, qtc_quads, row_qps_tile, roi_tile)
        with jax.named_scope("pred_gather"):
            pred_full = P.gather_predictions(mv, pred_refs, self._bx, by_g, self.bs, fme, jnp,
                                             grid_dims=grid_dims, origin_row=pred_origin)
        full_blocks = P.wrap_uint8(pred_full + rf, jnp)
        if cfg.vbs_enable:
            qy_g = self._qy_local + y0_px
            with jax.named_scope("pred_gather"):
                pred_q = P.gather_predictions(
                    smv.reshape(-1, 3), pred_refs, self._qx.reshape(-1), qy_g.reshape(-1),
                    self.sbs, fme, jnp, grid_dims=grid_dims, origin_row=pred_origin,
                ).reshape(self.nb_t, 4, self.sbs, self.sbs)
            quad_blocks = P.wrap_uint8(pred_q + rq, jnp)
        else:
            quad_blocks = None
        return self._merge_blocks(full_blocks, quad_blocks, split)

    def _decode_gop_local(self, gop, row_qps_g, roi_tile, y0_blocks, comm="halo"):
        """Decode one GOP's local band: intra frame 0, scan over inter frames
        carrying the reconstruction-band FIFO (decoder.py:487-545 semantics:
        refs reset at each intra, FIFO of n_ref_frames).  ``comm`` is the
        EFFECTIVE tile communication: decode() downgrades "halo" to
        "all_gather" when the stream's MVs exceed what the halo band can
        serve (fast-ME MVP chains are unbounded)."""
        cfg = self.cfg
        nref = cfg.n_ref_frames
        nb_t = self.nb_t

        def per_frame(i):
            return (
                gop["mv"][i].reshape(nb_t, 3),
                gop["split"][i].reshape(nb_t),
                gop["sub_mv"][i].reshape(nb_t, 4, 3),
                gop["qtc_full"][i].reshape(nb_t, self.bs, self.bs),
                gop["qtc_quads"][i].reshape(nb_t, 4, self.sbs, self.sbs),
                row_qps_g[i],
            )

        mv0, split0, smv0, qf0, qq0, rqp0 = per_frame(0)
        f0 = self._intra_tile_decode(mv0, split0, smv0, qf0, qq0, rqp0, roi_tile)
        if self.gl == 1:
            return f0[None]

        refs0 = jnp.zeros((nref, self.h_t, self.w), dtype=jnp.uint8).at[0].set(f0)

        def step(carry, xs):
            refs, nvalid = carry
            mv, split, smv, qf, qq, rqp = xs
            f = self._inter_tile_decode(refs, y0_blocks, mv, split, smv, qf, qq, rqp,
                                        roi_tile, comm)
            new_refs, new_nv = _fifo_push(refs, nvalid, f, nref)
            return (new_refs, new_nv), f

        tail = tuple(
            jnp.stack([per_frame(i)[j] for i in range(1, self.gl)]) for j in range(6)
        )
        (_, _), frames = jax.lax.scan(step, (refs0, jnp.int32(1)), tail)
        return jnp.concatenate([f0[None], frames], axis=0)

    def _decode_gops_shard(self, mv_g, split_g, smv_g, qf_g, qq_g, rqp_g, roi, comm="halo"):
        tile_idx = jax.lax.axis_index("tile")
        y0_blocks = tile_idx * self.nbr_t
        roi_tile = jax.lax.dynamic_slice_in_dim(roi, y0_blocks, self.nbr_t, axis=0)
        rqp_tile = jax.lax.dynamic_slice_in_dim(rqp_g, y0_blocks, self.nbr_t, axis=2)  # (G, gl, nbr_t)

        def one(mv, split, smv, qf, qq, rqp):
            gop = {"mv": mv, "split": split, "sub_mv": smv, "qtc_full": qf, "qtc_quads": qq}
            return self._decode_gop_local(gop, rqp, roi_tile, y0_blocks, comm=comm)

        return jax.vmap(one)(mv_g, split_g, smv_g, qf_g, qq_g, rqp_tile)

    def _build_decode_j(self, comm: str = "halo"):
        spec_blk = P_("data", None, "tile", None)
        in_specs = (
            P_("data", None, "tile", None, None),      # mv (G, gl, nbr, nbc, 3)
            spec_blk,                                   # split
            P_("data", None, "tile", None, None, None),  # sub_mv
            P_("data", None, "tile", None, None, None),  # qtc_full
            P_("data", None, "tile", None, None, None, None),  # qtc_quads
            P_("data", None, None),                     # row_qps (G, gl, nbr)
            P_(None, None),                             # roi
        )

        def fn(*args):
            return self._decode_gops_shard(*args, comm=comm)

        return jax.jit(
            shard_map(
                fn,
                mesh=self.mesh,
                in_specs=in_specs,
                out_specs=P_("data", None, "tile", None),
                check_vma=False,
            )
        )

    def decode(self, frame_types, residuals_per_frame, qp_rows_per_frame, mvs_per_frame):
        """Sharded in-memory decode of list-structured packages (same
        interchange as JaxCodec.decode).  GOPs must open intra (frame
        i % intra_dur == 0 — anything else would carry state across the
        "data" axis), but mid-GOP intra frames from scene-change promotion
        (RCFlag>1, Encoder.py:1851-1856) are accepted: such streams decode
        through per-frame sharded steps with frame-type-driven step
        selection (_decode_fsteps) instead of the uniform GOP scan."""
        cfg = self.cfg
        n = cfg.frames
        gl = self.gl
        promoted = False
        for i, ft in enumerate(frame_types[:n]):
            if i % gl == 0:
                if ft != 0:
                    raise ValueError(
                        f"frame {i} has type {ft} but every GOP must open intra "
                        "(i % intra_dur == 0): the sharded decoder relies on GOP "
                        "independence; use the single-chip JaxCodec.decode"
                    )
            elif ft == 0:
                promoted = True  # mid-GOP intra: scene-change promotion
        n_gops = math.ceil(n / gl)
        g_pad = math.ceil(n_gops / self.ndata) * self.ndata
        nb = self.nbr * self.nbc
        mv_g = np.zeros((g_pad, gl, nb, 3), np.int32)
        split_g = np.zeros((g_pad, gl, nb), bool)
        smv_g = np.zeros((g_pad, gl, nb, 4, 3), np.int32)
        qf_g = np.zeros((g_pad, gl, nb, self.bs, self.bs), np.int16)
        qq_g = np.zeros((g_pad, gl, nb, 4, self.sbs, self.sbs), np.int16)
        rqp_g = np.full((g_pad, gl, self.nbr), cfg.qp, np.int32)
        for i in range(n):
            g, f = divmod(i, gl)
            ft = frame_types[i]
            # np variants: the arrays go straight into the host-side GOP
            # pack, so a device round trip per frame would be pure waste
            mv, split, smv = jax_engine.list_to_mvs_np(mvs_per_frame[i], ft, nb)
            qf, qq = jax_engine.list_to_res_np(residuals_per_frame[i], nb, self.bs, self.sbs)
            if ft == 0:  # intra MVs are scalars; pack into component 0
                mv_g[g, f, :, 0] = mv
                smv_g[g, f, :, :, 0] = smv
            else:
                mv_g[g, f] = mv
                smv_g[g, f] = smv
            split_g[g, f] = split
            qf_g[g, f] = qf
            qq_g[g, f] = qq
            if cfg.rc_active and len(qp_rows_per_frame[i]):
                rqp_g[g, f] = np.asarray(qp_rows_per_frame[i], np.int32)
        # Effective tile communication: the sr+1 halo band can only serve
        # |dy| <= sr (2*sr half-pel under FME).  Fast-ME MVP chains are
        # unbounded, so a mesh-encoded fast-ME stream can carry larger MVs —
        # the halo path would clamp those reads and silently corrupt the
        # reconstruction (encode forces all_gather for the same reason).
        # Scan the host-visible MVs and downgrade to the all_gather band
        # whenever the stream needs it.
        comm = self.tile_comm
        if self.ntile > 1 and comm == "halo":
            dy_bound = 2 * cfg.search_range if cfg.fme_enable else cfg.search_range
            max_dy = max(
                int(np.abs(mv_g[..., 1]).max(initial=0)),
                int(np.abs(smv_g[..., 1]).max(initial=0)),
            )
            if max_dy > dy_bound:
                # the sr+1 halo band cannot serve |dy| beyond the search
                # range — the halo path would clamp those reads and silently
                # corrupt the reconstruction (encode forces all_gather for
                # the same reason)
                comm = "all_gather"
        if promoted:
            return self._decode_fsteps(mv_g, split_g, smv_g, qf_g, qq_g, rqp_g,
                                       frame_types, comm, g_pad)
        if comm not in self._decode_js:
            self._decode_js[comm] = self._build_decode_j(comm=comm)
        dec_j = self._decode_js[comm]
        shp = lambda a: a.reshape((g_pad, gl, self.nbr, self.nbc) + a.shape[3:])  # noqa: E731
        outs = []
        for b in range(g_pad // self.ndata):
            sl = slice(b * self.ndata, (b + 1) * self.ndata)
            args = (
                jnp.asarray(shp(mv_g)[sl]), jnp.asarray(shp(split_g)[sl]),
                jnp.asarray(shp(smv_g)[sl]), jnp.asarray(shp(qf_g)[sl]),
                jnp.asarray(shp(qq_g)[sl]), jnp.asarray(rqp_g[sl]), self._roi,
            )
            o = dec_j(*args)
            outs.append(np.asarray(o))
        recon = np.concatenate(outs, axis=0).reshape(g_pad * gl, self.h, self.w)
        return [recon[i] for i in range(n)]

    # ------------------------------------------- per-frame sharded decode
    # Frame-type-driven decode for promoted streams (round-2 VERDICT item 4):
    # mid-GOP intra frames make the GOP scan non-uniform, so such clips
    # decode frame-by-frame — intra and inter steps dispatched by the
    # host-visible frame types, outputs selected per GOP when a batch
    # disagrees (one GOP promoted frame f, another didn't).

    def _build_dsteps(self, comm: str):
        refs_spec = P_("data", None, "tile", None)
        specs_frame = (
            P_("data", "tile", None, None),              # mv (G, nbr, nbc, 3)
            P_("data", "tile", None),                    # split
            P_("data", "tile", None, None, None),        # sub_mv
            P_("data", "tile", None, None, None),        # qtc_full
            P_("data", "tile", None, None, None, None),  # qtc_quads
            P_("data", None),                            # row_qps (G, nbr)
            P_(None, None),                              # roi
        )

        def flat(mv, split, smv, qf, qq):
            return (
                mv.reshape(self.nb_t, 3), split.reshape(self.nb_t),
                smv.reshape(self.nb_t, 4, 3),
                qf.reshape(self.nb_t, self.bs, self.bs),
                qq.reshape(self.nb_t, 4, self.sbs, self.sbs),
            )

        def intra_shard(mv_g, split_g, smv_g, qf_g, qq_g, rqp_g, roi):
            tile_idx = jax.lax.axis_index("tile")
            y0b = tile_idx * self.nbr_t
            roi_tile = jax.lax.dynamic_slice_in_dim(roi, y0b, self.nbr_t, axis=0)
            nref = self.cfg.n_ref_frames

            def one(mv, split, smv, qf, qq, rqp):
                rqp_t = jax.lax.dynamic_slice_in_dim(rqp, y0b, self.nbr_t, axis=0)
                mvf, splitf, smvf, qff, qqf = flat(mv, split, smv, qf, qq)
                f = self._intra_tile_decode(mvf, splitf, smvf, qff, qqf, rqp_t, roi_tile)
                # intra resets the reference FIFO (decoder.py:520)
                refs = jnp.zeros((nref, self.h_t, self.w), jnp.uint8).at[0].set(f)
                return f, refs

            return jax.vmap(one)(mv_g, split_g, smv_g, qf_g, qq_g, rqp_g)

        def inter_shard(refs_g, nvalid_g, mv_g, split_g, smv_g, qf_g, qq_g, rqp_g, roi):
            tile_idx = jax.lax.axis_index("tile")
            y0b = tile_idx * self.nbr_t
            roi_tile = jax.lax.dynamic_slice_in_dim(roi, y0b, self.nbr_t, axis=0)
            nref = self.cfg.n_ref_frames

            def one(refs_l, nvalid, mv, split, smv, qf, qq, rqp):
                rqp_t = jax.lax.dynamic_slice_in_dim(rqp, y0b, self.nbr_t, axis=0)
                mvf, splitf, smvf, qff, qqf = flat(mv, split, smv, qf, qq)
                f = self._inter_tile_decode(refs_l, y0b, mvf, splitf, smvf, qff, qqf,
                                            rqp_t, roi_tile, comm)
                new_refs, _ = _fifo_push(refs_l, nvalid, f, nref)
                return f, new_refs

            return jax.vmap(one)(refs_g, nvalid_g, mv_g, split_g, smv_g, qf_g, qq_g, rqp_g)

        out_spec = (P_("data", "tile", None), refs_spec)
        intra_j = jax.jit(shard_map(intra_shard, mesh=self.mesh, in_specs=specs_frame,
                                    out_specs=out_spec, check_vma=False))
        inter_j = jax.jit(shard_map(inter_shard, mesh=self.mesh,
                                    in_specs=(refs_spec, P_("data")) + specs_frame,
                                    out_specs=out_spec, check_vma=False))
        return intra_j, inter_j

    def _decode_fsteps(self, mv_g, split_g, smv_g, qf_g, qq_g, rqp_g, frame_types, comm, g_pad):
        cfg = self.cfg
        n, gl = cfg.frames, self.gl
        if comm not in self._dsteps:
            self._dsteps[comm] = self._build_dsteps(comm)
        intra_j, inter_j = self._dsteps[comm]
        shp = lambda a: a.reshape((g_pad, gl, self.nbr, self.nbc) + a.shape[3:])  # noqa: E731
        mv_s, split_s, smv_s, qf_s, qq_s = (shp(a) for a in (mv_g, split_g, smv_g, qf_g, qq_g))
        # frame types per (gop, frame); padded GOPs follow the regular pattern
        ft_g = np.tile(np.array([0] + [1] * (gl - 1), np.int32), (g_pad, 1))
        for i in range(n):
            g, f = divmod(i, gl)
            ft_g[g, f] = frame_types[i]
        out = np.zeros((g_pad * gl, self.h, self.w), np.uint8)
        nref = cfg.n_ref_frames
        for b in range(g_pad // self.ndata):
            sl = slice(b * self.ndata, (b + 1) * self.ndata)
            refs = None
            nvalid = np.zeros(self.ndata, np.int32)
            for f in range(gl):
                args = (jnp.asarray(mv_s[sl, f]), jnp.asarray(split_s[sl, f]),
                        jnp.asarray(smv_s[sl, f]), jnp.asarray(qf_s[sl, f]),
                        jnp.asarray(qq_s[sl, f]), jnp.asarray(rqp_g[sl, f]), self._roi)
                is_intra = ft_g[sl, f] == 0
                if is_intra.all():
                    fr, refs = intra_j(*args)
                elif not is_intra.any():
                    fr, refs = inter_j(refs, jnp.asarray(nvalid), *args)
                else:
                    frP, refsP = inter_j(refs, jnp.asarray(nvalid), *args)
                    frI, refsI = intra_j(*args)
                    fr = self._select_gops(is_intra, frI, frP)
                    refs = self._select_gops(is_intra, refsI, refsP)
                nvalid = np.where(is_intra, 1, np.minimum(nvalid + 1, nref)).astype(np.int32)
                out[(b * self.ndata + np.arange(self.ndata)) * gl + f] = np.asarray(fr)
        return [out[i] for i in range(n)]

    # ------------------------------------- per-frame steps (promotion path)
    # Scene-change promotion (RCFlag>1) consumes one host scalar per frame
    # (the measured inter size), so the GOP scan unrolls into per-frame
    # dispatches here (round-1 VERDICT item 8).  The tile programs are the
    # same _intra_tile/_inter_tile.  Two-pass WITHOUT promotion rides the
    # GOP scan instead (clip-level: _first_pass_rqps + _encode_gops_shard_pf);
    # the two-pass+promotion composition runs clip-level over these per-frame
    # steps (_encode_fsteps), host math rc.second_pass_row_qps shared with
    # JaxCodec, so mesh two-pass stays bitwise identical to single-chip.

    def _fstep_out_specs(self):
        return {
            "mv": P_("data", "tile", None, None),
            "split": P_("data", "tile", None),
            "sub_mv": P_("data", "tile", None, None, None),
            "qtc_full": P_("data", "tile", None, None, None),
            "qtc_quads": P_("data", "tile", None, None, None, None),
            "size": P_("data"),
            "sqerr": P_("data"),
            "mae_sum": P_("data"),
            "recon": P_("data", "tile", None),
            "row_bits": P_("data", "tile"),
        }

    def _build_fsteps(self):
        refs_spec = P_("data", None, "tile", None)

        def finish(out, cur_l):
            out["sqerr"] = jax.lax.psum(
                jnp.sum((out["recon"].astype(jnp.float32) - cur_l.astype(jnp.float32)) ** 2), "tile"
            )
            return self._grid_out(out)

        def intra_shard(cur_g, rqp_g, roi):
            tile_idx = jax.lax.axis_index("tile")
            y0b = tile_idx * self.nbr_t
            roi_tile = jax.lax.dynamic_slice_in_dim(roi, y0b, self.nbr_t, axis=0)

            def one(cur_l, rqp):
                rqp_t = jax.lax.dynamic_slice_in_dim(rqp, y0b, self.nbr_t, axis=0)
                out = self._intra_tile(cur_l, y0b, rqp_t, roi_tile)
                g = finish(out, cur_l)
                nref = self.cfg.n_ref_frames
                refs = jnp.zeros((nref, self.h_t, self.w), jnp.uint8).at[0].set(out["recon"])
                return g, refs

            return jax.vmap(one)(cur_g, rqp_g)

        def inter_shard(cur_g, refs_g, nvalid_g, rqp_g, roi):
            tile_idx = jax.lax.axis_index("tile")
            y0b = tile_idx * self.nbr_t
            roi_tile = jax.lax.dynamic_slice_in_dim(roi, y0b, self.nbr_t, axis=0)
            nref = self.cfg.n_ref_frames

            def one(cur_l, refs_l, nvalid, rqp):
                rqp_t = jax.lax.dynamic_slice_in_dim(rqp, y0b, self.nbr_t, axis=0)
                out = self._inter_tile(cur_l, refs_l, nvalid, y0b, rqp_t, roi_tile)
                g = finish(out, cur_l)
                new_refs, _ = _fifo_push(refs_l, nvalid, out["recon"], nref)
                return g, new_refs

            return jax.vmap(one)(cur_g, refs_g, nvalid_g, rqp_g)

        intra_j = jax.jit(
            shard_map(
                intra_shard, mesh=self.mesh,
                in_specs=(P_("data", "tile", None), P_("data", None), P_(None, None)),
                out_specs=(self._fstep_out_specs(), refs_spec),
                check_vma=False,
            )
        )
        # nvalid is a PER-GOP vector: scene promotion resets one GOP's
        # reference FIFO without touching its batch neighbors
        inter_j = jax.jit(
            shard_map(
                inter_shard, mesh=self.mesh,
                in_specs=(P_("data", "tile", None), refs_spec, P_("data"), P_("data", None), P_(None, None)),
                out_specs=(self._fstep_out_specs(), refs_spec),
                check_vma=False,
            )
        )
        return intra_j, inter_j

    def _select_gops(self, mask_np, take, keep):
        """Per-GOP select between two fstep results (dict-of-arrays or array),
        ``take`` where mask else ``keep`` — promotion picks the intra re-encode
        for exactly the GOPs whose inter residual crossed intra_thresh."""
        m = jnp.asarray(mask_np)

        def sel(a, b):
            return jnp.where(m.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

        if isinstance(take, dict):
            return {k: sel(take[k], keep[k]) for k in keep}
        return sel(take, keep)

    def _fsteps_pass(self, g_pad, ftypes_fixed=None, rqps_pf=None):
        """One per-frame sharded pass over the clip.

        Pass 1 (``ftypes_fixed`` None): table QPs, promotion decided per
        frame from the measured inter size (one host scalar per frame —
        inherent to RCFlag>1, Encoder.py:1851-1856).  Pass 2: frame types
        fixed from pass 1 and per-frame row QPs supplied — NO host syncs
        inside, so the whole pass pipelines asynchronously.  Returns
        (outs [(grid_out, rqp, ftypes_b) per (batch, frame)],
        ftypes (g_pad_batches, gl, ndata))."""
        cfg = self.cfg
        gl = self.gl
        promotion = ftypes_fixed is None and cfg.rc_flag is not None and cfg.rc_flag > 1
        if self._fsteps is None:
            self._fsteps = self._build_fsteps()
        intra_j, inter_j = self._fsteps
        type_rows = np.asarray(self._row_qps)  # (2, nbr)
        bcast = lambda t: jnp.asarray(np.broadcast_to(type_rows[t], (self.ndata, self.nbr)))  # noqa: E731
        outs = []  # per (batch, frame): (grid_out, rqp (ndata, nbr), ftypes (ndata,))
        ftypes_all = []
        n_conv = 0  # frames already drained to host (bounded HBM)
        nref = cfg.n_ref_frames
        for b in range(g_pad // self.ndata):
            refs = None
            nvalid = np.zeros(self.ndata, np.int32)
            for f in range(gl):
                k = b * gl + f
                cur = self._frames_dev[b * self.ndata : (b + 1) * self.ndata, f]
                refs_prev, nvalid_prev = refs, jnp.asarray(nvalid)
                rqp_j = None if rqps_pf is None else jnp.asarray(rqps_pf[k])
                if f == 0:
                    ftypes_b = np.zeros(self.ndata, np.int32)
                    o, refs_new = intra_j(cur, rqp_j if rqp_j is not None else bcast(0), self._roi)
                elif ftypes_fixed is not None:
                    ftypes_b = ftypes_fixed[k]
                    is_intra = ftypes_b == 0
                    use_q = rqp_j if rqp_j is not None else bcast(1)
                    if is_intra.all():
                        o, refs_new = intra_j(cur, use_q, self._roi)
                    elif not is_intra.any():
                        o, refs_new = inter_j(cur, refs_prev, nvalid_prev, use_q, self._roi)
                    else:
                        oP, refsP = inter_j(cur, refs_prev, nvalid_prev, use_q, self._roi)
                        oI, refsI = intra_j(cur, use_q, self._roi)
                        o = self._select_gops(is_intra, oI, oP)
                        refs_new = self._select_gops(is_intra, refsI, refsP)
                else:
                    ftypes_b = np.ones(self.ndata, np.int32)
                    o, refs_new = inter_j(cur, refs_prev, nvalid_prev, bcast(1), self._roi)
                    if promotion:
                        promote = np.asarray(o["size"]) > cfg.intra_thresh
                        if promote.any():
                            oI, refsI = intra_j(cur, bcast(0), self._roi)
                            o = self._select_gops(promote, oI, o)
                            refs_new = self._select_gops(promote, refsI, refs_new)
                            ftypes_b = np.where(promote, 0, 1).astype(np.int32)
                rqp = type_rows[ftypes_b] if rqps_pf is None else rqps_pf[k]
                refs = refs_new
                nvalid = np.where(ftypes_b == 0, 1, np.minimum(nvalid + 1, nref)).astype(np.int32)
                for v in o.values():  # D2H overlaps the next dispatches
                    try:
                        v.copy_to_host_async()
                    except AttributeError:
                        pass
                outs.append((o, rqp, ftypes_b))
                ftypes_all.append(ftypes_b)
                # bounded HBM on long clips (mirror of the GOP-scan batch
                # drain / jax_engine's encode drain): convert frames a fixed
                # lag behind the frontier — their async copies are already
                # in flight; the reference chain holds its own device arrays
                while n_conv < len(outs) - 8:
                    o0, r0, f0 = outs[n_conv]
                    outs[n_conv] = (jax.tree.map(np.asarray, o0), r0, f0)
                    n_conv += 1
        return outs, ftypes_all

    def _encode_fsteps(self, fetch: str = "full"):
        """Per-frame sharded encode for scene-change promotion (RCFlag>1) —
        the promotion decision consumes one host scalar per frame (the
        measured inter residual size, Encoder.py:1851-1856), so the GOP scan
        unrolls into per-frame dispatches here.  GOPs stay data-parallel;
        when GOPs in a batch disagree (one promotes, another doesn't) both
        step kinds run and the outputs select per GOP.

        The two-pass composition runs CLIP-LEVEL, mirroring the GOP-scan
        path and jax_engine.encode: pass 1 decides promotion and collects
        row bits, the host reallocates every frame's row budgets at once
        (rc.second_pass_row_qps), and pass 2 re-runs the per-frame steps
        with fixed frame types and NO host syncs — both engines share the
        semantics, so mesh two-pass stays bitwise identical to single-chip."""
        cfg = self.cfg
        n, gl = cfg.frames, self.gl
        two_pass = cfg.two_pass and cfg.rc_active
        n_gops = math.ceil(n / gl)
        g_pad = math.ceil(n_gops / self.ndata) * self.ndata
        self._stage_frames(g_pad)
        outs, ftypes_all = self._fsteps_pass(g_pad)
        if two_pass:
            type_rows = np.asarray(self._row_qps)
            # ONE stacked sync for the whole clip's row bits
            row_bits = np.asarray(jnp.stack([o["row_bits"] for o, _, _ in outs]))
            rqps_pf = []
            for k in range(len(outs)):
                ftypes_b = ftypes_all[k]
                rqps_pf.append(np.stack([
                    rc_mod.second_pass_row_qps(cfg, row_bits[k][g], int(ftypes_b[g]), type_rows[ftypes_b[g]])
                    for g in range(self.ndata)
                ]))
            outs, _ = self._fsteps_pass(g_pad, ftypes_fixed=ftypes_all, rqps_pf=rqps_pf)
        return self._package_fsteps(outs, g_pad, fetch)

    def _package_fsteps(self, outs, g_pad, fetch):
        cfg = self.cfg
        n, gl = cfg.frames, self.gl
        nb = self.nbr * self.nbc
        mvs_pf, res_pf, psnr_pf, mae_pf, sizes, ftypes, qp_rows = [], [], [], [], [], [], []
        recon = None if fetch == "metrics" else np.zeros((n, self.h, self.w), dtype=np.uint8)
        for i in range(n):
            g, f = divmod(i, gl)
            batch, g_loc = divmod(g, self.ndata)
            o, rqp2, ftypes_b = outs[batch * gl + f]
            ftype = int(ftypes_b[g_loc])
            ftypes.append(ftype)
            qp_rows.append([int(q) for q in rqp2[g_loc]] if cfg.rc_active else [])
            if fetch not in ("light", "metrics"):
                per = {
                    "mv": np.asarray(o["mv"][g_loc]).reshape(nb, 3),
                    "split": np.asarray(o["split"][g_loc]).reshape(nb),
                    "sub_mv": np.asarray(o["sub_mv"][g_loc]).reshape(nb, 4, 3),
                    "qtc_full": np.asarray(o["qtc_full"][g_loc]).reshape(nb, self.bs, self.bs),
                    "qtc_quads": np.asarray(o["qtc_quads"][g_loc]).reshape(nb, 4, self.sbs, self.sbs),
                }
                mvs_pf.append(jax_engine.mvs_to_list(per, ftype, nb))
                res_pf.append(jax_engine.res_to_list(per, nb))
            sizes.append(int(o["size"][g_loc]))
            mse = float(o["sqerr"][g_loc]) / (self.h * self.w)
            psnr_pf.append(float(10.0 * np.log10(255.0**2 / mse)) if mse > 0 else float("inf"))
            mae_pf.append(float(o["mae_sum"][g_loc]) / nb)
            if recon is not None:
                recon[i] = np.asarray(o["recon"][g_loc])
        pkg = {
            "block size": self.bs,
            "num frames": n,
            "height in pixels": self.h,
            "width in pixels": self.w,
            "search range": cfg.search_range,
            "PSNR per frame": psnr_pf,
            "MAE per Frame": mae_pf,
            "frame_type_seq": ftypes,
            "Qp_per_row_per_frame": qp_rows,
            "residual size per frame": sizes,
            "reconstructed frames": recon,
        }
        if fetch not in ("light", "metrics"):
            pkg["MVS per Frame"] = mvs_pf
            pkg["approx residual"] = res_pf
        return pkg
