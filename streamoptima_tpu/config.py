"""Codec configuration.

Replaces the reference's constructor-kwarg soup and the hardcoded constants in
main.main() (main.py:19-43) with a validated dataclass.  Field names map 1:1
onto the reference's Y_Video_codec.__init__ parameters (Encoder.py:24).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence


def parse_bitrate(target_br: str | int | None) -> int | None:
    """'<num> bps|kbps|mbps' -> bits/s (Encoder.py:78-88); ints pass through."""
    if target_br is None:
        return None
    if isinstance(target_br, (int, float)):
        return int(target_br)
    tokens = target_br.split(" ")
    num = int(tokens[0])
    unit = tokens[1]
    if unit == "kbps":
        return num * 1024
    if unit == "mbps":
        return num * 1048576
    return num


@dataclasses.dataclass
class CodecConfig:
    height: int
    width: int
    frames: int
    block_size: int = 16
    search_range: int = 16
    qp: int = 4
    intra_dur: int = 21
    intra_mode: int = 0
    lam: float | None = None
    vbs_enable: bool = False
    n_ref_frames: int = 1
    fast_me: bool = False
    fme_enable: bool = False
    rc_flag: int | None = None
    target_br: str | int | None = None
    frame_rate: int = 30
    qp_rate_tables: Sequence[Sequence[float]] | None = None
    intra_thresh: int | None = None
    parallel_mode: int = 0

    # --- native extensions -----------------------------------------------
    # "jax": native engine (exact int DCT, jitted device pipeline)
    # "compat": host engine, bit-exact with the NumPy reference
    engine: str = "jax"
    # compat text formatting: coefficient values serialized as np.int64(v)
    # (what the reference emits under numpy>=2).  None => True iff compat.
    numpy_repr_bitstream: bool | None = None
    # per-block QP offset map (ROI coding; README.md:17 promises ROI but the
    # reference contains no implementation - designed fresh here)
    roi_qp_map: Any = None
    # two-pass rate control (README.md:13; reference computes first-pass row
    # stats then discards them, Encoder.py:1627-1639)
    two_pass: bool = False
    # devices for multi-chip sharding (parallel/ modes); None => single chip
    mesh_devices: Any = None
    # full-search kernel: "auto" picks per context — "materialized"
    # (candidate maps + argmin) in the per-frame jitted step, "fused"
    # (streaming reduction) inside GOP-scan/sharded programs.  All
    # bit-identical (core/me.py).  The split is inherited from the first
    # build and not yet measured on the H100.
    me_search: str = "auto"
    # fast-ME MVP chain solver: the reference's chain (Encoder.py:719-742,
    # MVP = previous block's MV in raster order) is inherently sequential.
    # "scan" runs it as a lax.scan (one step per block); "fixpoint" solves
    # the same recurrence mv[i] = f_i(mv[i-1]) by Jacobi iteration:
    # evaluate EVERY block against its guessed MVP in one batched pass,
    # re-derive the guesses, repeat until unchanged.  Any fixpoint of the
    # chain equations equals forward substitution (unique by induction on
    # i), so the result is bit-identical; convergence takes
    # O(#MV-discontinuities) sweeps instead of #blocks steps.  "rowscan"
    # nests the two: a lax.scan over block COLUMNS is exact within every
    # block row simultaneously (blocks (r, j) all step together), so the
    # Jacobi iteration runs only over the per-row seed MVs — the raster
    # chain's row-to-row hand-off — and converges in a couple of outer
    # passes instead of one sweep per intra-row discontinuity; its block
    # eval is the window fetch of core/fastme.py, which also folds the VBS
    # quad search and the winner predictions into one confirm pass.  All
    # three are bit-identical.  "auto" => rowscan.
    fast_me_chain: str = "auto"
    # fast-ME window fetch: the rowscan chain solve reads one (bs+2)-square
    # window per block per sweep step at a data-dependent position.  "xla"
    # is the one-hot matmul gather (core/fastme.window_gather; its cost
    # grows with the plane area, since every block contracts the whole
    # plane).  "slice" is a vmapped clamped dynamic_slice on zero-padded
    # planes (plane-area-independent — with pad >= the window extent,
    # clamping is exact zero-fill).  "auto" picks by plane area
    # (fastme.resolve_fetch_mode): one-hot below ~2.5 Mpx of planes, slice
    # above; the cut is inherited from the first build and not yet measured
    # on the H100.  Bit-identical paths (tests/test_fastme.py).
    fast_me_fetch: str = "auto"
    # rowscan segment multiplier: the raster MVP chain is cut into
    # ``seg_mult * n_block_rows`` equal segments solved simultaneously by the
    # column scan (segments need not align with block rows — the Jacobi-over-
    # seeds fixpoint argument in fast_me_chain holds for ANY segmentation of
    # the 1-D chain, so every value is bit-identical; only divisors of the
    # block-column count are usable and the resolver rounds down to one).
    # Seed corrections propagate ONE segment per outer Jacobi pass, so the
    # pass count grows with the segment count; "auto" = 1 (block rows).
    fast_me_seg_mult: int | str = "auto"
    # Speculative lookahead of the rowscan chain step: each lax.scan step
    # resolves k consecutive chain columns from ONE wide window per segment
    # (core/fastme.eval_chain) — the winner of a 3x3 step always sits at
    # MVP+delta, delta in {-1,0,1}^2, so all k columns' candidate SADs come
    # from static slices of a window covering the hypothesis cone, and the
    # chain resolves with cheap traced selects.  Sequential step count drops
    # k-fold at the SAME per-column gather work.  "auto" = a per-shape rule
    # inherited from the first build (fastme.resolve_lookahead; not yet
    # measured on the H100); any k >= 1 is bit-identical.
    fast_me_lookahead: int | str = "auto"

    #: bounded-HBM encode: frames this far behind the dispatch frontier have
    #: their outputs converted to host arrays (freeing their device buffers —
    #: ~75 MB/frame at 4K with both coefficient sets, so unbounded residency
    #: OOMs long clips).  None = automatic: drain under ``encode(package=
    #: True)``, where every output is already copy_to_host_async'd at
    #: dispatch; ``encode(package=False)`` keeps outputs device-resident (its
    #: callers — benchmarks, metric sweeps — read only recon/metrics; the
    #: choice was made on a TPU and is not yet measured on the H100).  Set an int
    #: lag for long production encodes with package=False + transmit: outputs
    #: drain incrementally (overlapping compute) instead of cold-syncing per
    #: frame at serialization time.
    encode_drain: int | None = None

    def __post_init__(self) -> None:
        if self.height % self.block_size or self.width % self.block_size:
            raise ValueError(
                "height/width must be multiples of block_size (the reference "
                "crashes on non-multiples; pad input frames first)"
            )
        if self.vbs_enable and self.lam is None:
            # the RD constant the reference's driver uses (main.py:36); without
            # it the split decision crashed deep in the RD path (round-2 fix)
            self.lam = 0.015
        if self.intra_mode not in (0, 1):
            raise ValueError("intra_mode must be 0 (horizontal) or 1 (vertical)")
        # the search kernels pack the lexicographic tie-break as
        # (l1<<3 | ref)<<8 | dxi)<<8 | dyi (core/me.py argmin and its fused
        # twin): 3 bits of reference index and 8 bits per grid
        # displacement index.  Out-of-range configs would OVERFLOW the
        # packing and silently pick wrong winners — refuse them loudly.
        # (The reference itself has no such limits but degrades to hours of
        # runtime long before sr=64; these bounds cover its whole usable
        # envelope.)
        if not 1 <= self.n_ref_frames <= 8:
            raise ValueError("n_ref_frames must be in [1, 8] (3-bit ref field "
                             "in the search tie-break packing)")
        grid_sr = 2 * self.search_range if self.fme_enable else self.search_range
        if not 1 <= self.search_range or grid_sr > 127:
            raise ValueError(
                f"search_range {self.search_range} out of range: the ref-grid "
                f"range {grid_sr} must stay <= 127 (8-bit displacement-index "
                "fields in the search tie-break packing; under FME the grid "
                "range is 2*search_range)"
            )
        if self.engine not in ("jax", "compat"):
            raise ValueError("engine must be 'jax' or 'compat'")
        if self.me_search not in ("auto", "materialized", "fused"):
            raise ValueError(f"me_search must be 'auto', 'materialized' or 'fused' "
                             f"(got {self.me_search!r})")
        if self.fast_me_chain not in ("auto", "scan", "fixpoint", "rowscan"):
            raise ValueError("fast_me_chain must be 'auto', 'scan', 'fixpoint' or 'rowscan'")
        if self.fast_me_fetch not in ("auto", "xla", "slice"):
            raise ValueError(f"fast_me_fetch must be 'auto', 'xla' or 'slice' "
                             f"(got {self.fast_me_fetch!r})")
        if self.fast_me_seg_mult != "auto" and (
            not isinstance(self.fast_me_seg_mult, int)
            or isinstance(self.fast_me_seg_mult, bool)
            or self.fast_me_seg_mult < 1
        ):
            raise ValueError("fast_me_seg_mult must be 'auto' or a positive int")
        if self.fast_me_lookahead != "auto" and (
            not isinstance(self.fast_me_lookahead, int)
            or isinstance(self.fast_me_lookahead, bool)
            or self.fast_me_lookahead < 1
        ):
            raise ValueError("fast_me_lookahead must be 'auto' or a positive int")
        if self.roi_qp_map is not None and self.engine != "jax":
            raise ValueError("roi_qp_map is a native-engine feature (the reference's README "
                             "promises ROI but ships no implementation)")
        if self.two_pass:
            if self.engine != "jax":
                raise ValueError("two_pass is a native-engine feature (the reference only gathers "
                                 "first-pass stats and discards them, Encoder.py:1627-1639)")
            if not (self.rc_flag is not None and self.rc_flag > 0 and self.target_br is not None
                    and self.qp_rate_tables is not None):
                raise ValueError("two_pass requires rate control (rc_flag>0, target_br, qp_rate_tables)")

    # ------------------------------------------------------------------ API
    @property
    def compat(self) -> bool:
        return self.engine == "compat"

    @property
    def sub_block_size(self) -> int:
        return self.block_size // 2

    @property
    def blocks_per_row(self) -> int:
        return self.width // self.block_size

    @property
    def block_rows(self) -> int:
        return self.height // self.block_size

    @property
    def n_blocks(self) -> int:
        return self.blocks_per_row * self.block_rows

    @property
    def target_bitrate(self) -> int | None:
        return parse_bitrate(self.target_br)

    @property
    def bitrate_per_row(self) -> float | None:
        """(bitrate // frame_rate) / (h / bs)  (Encoder.py:88)."""
        tb = self.target_bitrate
        if tb is None:
            return None
        return (tb // self.frame_rate) / (self.height / self.block_size)

    @property
    def rc_active(self) -> bool:
        return self.rc_flag is not None and self.rc_flag > 0

    @property
    def bitstream_numpy_repr(self) -> bool:
        if self.numpy_repr_bitstream is None:
            return self.compat
        return self.numpy_repr_bitstream

    @property
    def intra_canvas(self) -> tuple[int, int]:
        """Intra search canvas. The reference hardcodes a 288x352 all-128
        canvas (Encoder.py:1248, :1165) - frames smaller than CIF search into
        the 128 padding beyond the frame edge, and frames larger than CIF
        cannot be intra-coded at all by the reference.  Compat replicates the
        CIF canvas; the native engine uses the frame dims."""
        if self.compat:
            if self.height > 288 or self.width > 352:
                raise ValueError(
                    "compat engine replicates the reference's hardcoded "
                    "288x352 intra canvas (Encoder.py:1248) and cannot intra-"
                    "code larger frames; use engine='jax'"
                )
            return (288, 352)
        return (self.height, self.width)
