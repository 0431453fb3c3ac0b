"""2D DCT-II / IDCT transforms.

The reference applies ``scipy.fftpack.dct(..., norm='ortho')`` per block and
rounds to the nearest integer (Encoder.py:779-784, :810-817).  A float
transform cannot be made backend-deterministic (accelerators reorder sums,
and a GPU may run an f32 matmul in TF32), so this module offers three
implementations with precisely defined semantics:

``dct2_int`` / ``idct2_int``
    The *native* transform: an exact fixed-point integer DCT, the same design
    real hardware codecs (H.264/HEVC) use.  The orthonormal DCT-II matrix ``D``
    is rounded to a 12-bit fixed-point integer matrix ``A = round(D * 2**12)``
    and the two-pass product is evaluated entirely in int32 with exact
    round-half-even rescaling.  Every intermediate is proven to fit int32 (see
    bounds in the code), so the result is bit-identical on CPU and GPU and
    jit/vmap-friendly (integer dot_generals; no tensor-core path is involved,
    so no matmul precision setting can change a value).

``dct2_f64`` / ``idct2_f64``
    Host-side (NumPy) float64 matmul transform.  Matches scipy's values except
    on exact half-integer ties at coefficients whose basis rows are exactly
    +-1/4 (only (0,0), (0,N/2), (N/2,0), (N/2,N/2)), where scipy's FFT error
    direction is data-dependent.

``dct2_scipy`` / ``idct2_scipy``
    Host-side scipy, bit-exact with the reference (used by the compat engine
    and the golden-parity tests).

All functions operate on batched blocks shaped ``(..., n, n)``.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np

SCALE_BITS = 17


def dct_matrix_f64(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, nearest-float64 entries (scipy convention)."""
    i = np.arange(n)
    d = np.cos(np.pi * (2 * i[None, :] + 1) * i[:, None] / (2 * n)) * np.sqrt(2.0 / n)
    d[0, :] = np.sqrt(1.0 / n)
    return d


@functools.lru_cache(maxsize=None)
def dct_matrix_fixed(n: int, scale_bits: int = SCALE_BITS) -> np.ndarray:
    """Fixed-point DCT matrix ``A = round(D * 2**scale_bits)`` as int32."""
    return np.round(dct_matrix_f64(n) * (1 << scale_bits)).astype(np.int32)


def _round_half_even_from_parts(q_hi, inner, inner_bits: int):
    """round-half-even of ``q_hi + inner / 2**inner_bits`` (inner may be negative).

    Backend-agnostic: works on NumPy and JAX int32 arrays (operators only).
    """
    qt = q_hi + (inner >> inner_bits)
    rr = inner & ((1 << inner_bits) - 1)
    half = 1 << (inner_bits - 1)
    inc = (rr > half) | ((rr == half) & ((qt & 1) == 1))
    return qt + inc.astype(qt.dtype)


def _einsum(xp, spec, a, b):
    """Exact int32 einsum (NumPy: via int64; JAX: native int dot_general)."""
    if xp is np:
        return np.einsum(spec, a.astype(np.int64), b.astype(np.int64)).astype(np.int32)
    return xp.einsum(spec, a, b)


def _stage(xp):
    """Profiler scope naming the transform's ops on the JAX path."""
    if xp is np:
        return contextlib.nullcontext()
    import jax

    return jax.named_scope("int_dct")


def dct2_int(x, xp=None):
    """Exact fixed-point 2D DCT-II (ortho) with final round-half-even to int32.

    ``x``: int32 blocks ``(..., n, n)`` with ``|x| <= 512`` (residuals are in
    [-255, 255]).  Native equivalent of Encoder.py:779-784.

    Three int32 matmuls with a 17-bit matrix ``A = round(D * 2**17)``; every
    intermediate is proven below to fit int32, so results are bit-identical
    across CPU and GPU.  Worst-case deviation from the exact real transform
    is ~0.15, so values round identically to scipy's except within ~0.15 of a
    half-integer boundary.  int64 is avoided deliberately: 64-bit integer
    dot_generals are not lowered by every XLA backend.
    """
    if xp is None:
        xp = np if isinstance(x, np.ndarray) else _jnp()
    with _stage(xp):
        return _dct2_int(x, xp)


def _dct2_int(x, xp):
    n = x.shape[-1]
    a = _const(xp, dct_matrix_fixed(n))
    # pass 1: M = A @ X, scale 2**17. |M| <= n*maxA*512 <= 16*46341*512 = 2**28.5
    m = _einsum(xp, "kn,...nm->...km", a, x)
    # drop 6 fraction bits (error 2**-12 in real units): M1 scale 2**11, |M1| <= 2**22
    m1 = _rhe_shift_static(m, 6)
    # pass 2 split at 11 bits: |Sh|,|Sl| <= 16*2048*46341 = 2**30.5
    mh = m1 >> 11
    ml = m1 - (mh << 11)
    sh = _einsum(xp, "...km,jm->...kj", mh, a)
    sl = _einsum(xp, "...km,jm->...kj", ml, a)
    # T = rhe((Sh*2**11 + Sl) / 2**28)
    q = sh >> 17
    r = sh - (q << 17)
    inner = (r << 11) + sl  # <= 2**28 + 2**30.5 < 2**31
    return _round_half_even_from_parts(q, inner, 28)


def idct2_int(t, xp=None):
    """Exact fixed-point 2D IDCT (ortho), round-half-even to int32.

    ``t``: int32 rescaled coefficients ``(..., n, n)`` with ``|t| <= 12288``
    (|DCT| <= n*255 plus half a quantization step, requiring qp+band <= 14).
    Native equivalent of Encoder.py:810-817 / decoder.py:455-462.
    Four int32 matmuls, same 17-bit matrix and exactness guarantees as
    ``dct2_int``.
    """
    if xp is None:
        xp = np if isinstance(t, np.ndarray) else _jnp()
    with _stage(xp):
        return _idct2_int(t, xp)


def _idct2_int(t, xp):
    n = t.shape[-1]
    a = _const(xp, dct_matrix_fixed(n))
    # split the (14-bit) input so pass 1 fits int32
    th = t >> 7
    tl = t - (th << 7)
    # P = A^T @ Th, Q = A^T @ Tl: |.| <= 16*46341*128 = 2**26.5
    p = _einsum(xp, "nk,...nm->...km", a, th)
    qm = _einsum(xp, "nk,...nm->...km", a, tl)
    # M1 = rhe((P*2**7 + Q) / 2**11): scale 2**6, |M1| <= 4*12288*2**6 = 2**21.6
    q1 = p >> 4
    r1 = p - (q1 << 4)
    m1 = _round_half_even_from_parts(q1, (r1 << 7) + qm, 11)
    # pass 2 split at 11 bits: |Sh| <= 16*1532*46341 = 2**30.1, |Sl| <= 2**30.5
    mh = m1 >> 11
    ml = m1 - (mh << 11)
    sh = _einsum(xp, "...km,mj->...kj", mh, a)
    sl = _einsum(xp, "...km,mj->...kj", ml, a)
    # out = rhe((Sh*2**11 + Sl) / 2**23)
    q = sh >> 12
    r = sh - (q << 12)
    inner = (r << 11) + sl  # <= 2**23 + 2**30.5 < 2**31
    return _round_half_even_from_parts(q, inner, 23)


def _rhe_shift_static(num, k: int):
    """round-half-even(num / 2**k) for a static positive int k."""
    q = num >> k
    r = num - (q << k)
    half = 1 << (k - 1)
    inc = (r > half) | ((r == half) & ((q & 1) == 1))
    return q + inc.astype(q.dtype)


# ---------------------------------------------------------------------------
# host-side float implementations


def dct2_f64(x: np.ndarray) -> np.ndarray:
    """Float64 matmul 2D DCT, rounded half-even to int (host only)."""
    n = x.shape[-1]
    d = dct_matrix_f64(n)
    t = d @ x.astype(np.float64) @ d.T
    return np.round(t).astype(np.int64)


def idct2_f64(t: np.ndarray) -> np.ndarray:
    n = t.shape[-1]
    d = dct_matrix_f64(n)
    r = d.T @ t.astype(np.float64) @ d
    return np.round(r).astype(np.int64)


def dct2_scipy(x: np.ndarray) -> np.ndarray:
    """Bit-exact twin of the reference's apply_2d_dct (Encoder.py:779-784).

    Batched: the reference applies scipy per block; scipy's pocketfft treats
    the transformed axis independently, so batching is value-identical.
    """
    from scipy.fftpack import dct

    t = dct(dct(np.asarray(x, dtype=np.float64), axis=-2, norm="ortho"), axis=-1, norm="ortho")
    return np.round(t).astype(int)


def idct2_scipy(t: np.ndarray) -> np.ndarray:
    """Bit-exact twin of apply_2d_idct (Encoder.py:810-817, decoder.py:455-462)."""
    from scipy.fftpack import idct

    r = idct(idct(np.asarray(t, dtype=np.float64), axis=-2, norm="ortho"), axis=-1, norm="ortho")
    return np.round(r).astype(int)


# ---------------------------------------------------------------------------
# small backend helpers


def _jnp():
    import jax.numpy as jnp

    return jnp


@functools.lru_cache(maxsize=None)
def _jnp_const_cache():
    return {}


def _const(xp, arr: np.ndarray):
    if xp is np:
        return arr
    return xp.asarray(arr)
