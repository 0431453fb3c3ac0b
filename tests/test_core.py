"""Unit tests for core transform / quant / zigzag / blocks vs the reference
semantics (scipy + numpy oracles)."""
import numpy as np
import pytest
from scipy.fftpack import dct, idct

from streamoptima_tpu.core import blocks as B
from streamoptima_tpu.core import quant as Q
from streamoptima_tpu.core import transform as T
from streamoptima_tpu.core import zigzag as Z


def ref_dct2(x):
    return np.round(dct(dct(x.astype(np.float64), axis=-2, norm="ortho"), axis=-1, norm="ortho")).astype(int)


def ref_idct2(t):
    return np.round(idct(idct(t.astype(np.float64), axis=-2, norm="ortho"), axis=-1, norm="ortho")).astype(int)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_int_dct_close_to_scipy_and_exactly_invertible_contract(n):
    rng = np.random.default_rng(0)
    x = rng.integers(-255, 256, size=(500, n, n)).astype(np.int32)
    t_int = T.dct2_int(x, xp=np)
    t_ref = ref_dct2(x)
    # fixed-point transform is within 1 unit of the scipy transform
    assert np.abs(t_int - t_ref).max() <= 1
    # and mostly identical
    assert (t_int != t_ref).mean() < 0.06


@pytest.mark.parametrize("n", [4, 8, 16])
def test_int_dct_jax_matches_numpy(n):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = rng.integers(-255, 256, size=(64, n, n)).astype(np.int32)
    t_np = T.dct2_int(x, xp=np)
    t_jx = np.asarray(T.dct2_int(jnp.asarray(x)))
    assert np.array_equal(t_np, t_jx)
    r_np = T.idct2_int(t_np, xp=np)
    r_jx = np.asarray(T.idct2_int(jnp.asarray(t_np)))
    assert np.array_equal(r_np, r_jx)


@pytest.mark.parametrize("n", [8, 16])
def test_int_idct_close_to_scipy(n):
    rng = np.random.default_rng(2)
    t = rng.integers(-4096, 4097, size=(500, n, n)).astype(np.int32)
    r_int = T.idct2_int(t, xp=np)
    r_ref = ref_idct2(t)
    assert np.abs(r_int - r_ref).max() <= 1
    assert (r_int != r_ref).mean() < 0.06


def test_scipy_impl_bit_exact():
    rng = np.random.default_rng(3)
    x = rng.integers(-255, 256, size=(200, 16, 16))
    assert np.array_equal(T.dct2_scipy(x), ref_dct2(x))
    t = ref_dct2(x)
    assert np.array_equal(T.idct2_scipy(t), ref_idct2(t))


def test_roundtrip_quality():
    # transform+quant roundtrip reconstructs within quantization error
    rng = np.random.default_rng(4)
    x = rng.integers(-64, 65, size=(100, 16, 16)).astype(np.int32)
    for qp in (0, 3, 6):
        t = T.dct2_int(x, xp=np)
        qtc = Q.quantize(t, qp)
        rec = T.idct2_int(Q.rescale(qtc, qp).astype(np.int32), xp=np)
        rms = np.sqrt(np.mean((rec - x) ** 2.0))
        assert rms <= (1 << (qp + 1))  # quantization-noise scale


def ref_q_matrix(i, qp):
    q = np.zeros((i, i), dtype=int)
    for x in range(i):
        for y in range(i):
            if x + y < i - 1:
                q[x][y] = 2 ** qp
            elif x + y == i - 1:
                q[x][y] = 2 ** (qp + 1)
            else:
                q[x][y] = 2 ** (qp + 2)
    return q


@pytest.mark.parametrize("qp", [0, 1, 4, 9])
def test_quantize_matches_numpy_round(qp):
    rng = np.random.default_rng(5)
    for n in (8, 16):
        tc = rng.integers(-4096, 4097, size=(200, n, n))
        qm = ref_q_matrix(n, qp)
        ref = np.round(tc / qm).astype(int)  # reference quantize_TC (Encoder.py:787-789)
        got = Q.quantize(tc.astype(np.int64), qp)
        assert np.array_equal(got, ref)
        assert np.array_equal(Q.rescale(got, qp), got * qm)
        assert np.array_equal(Q.generate_q_matrix(n, qp), qm)


def test_quantize_half_even_ties():
    # explicit .5 ties: numpy rounds half to even
    tc = np.array([[[6, 2], [2, 2]]], dtype=np.int64)  # n=2: bands [[0,1],[1,2]]
    qm = ref_q_matrix(2, 2)  # [[4,8],[8,16]]
    assert np.array_equal(Q.quantize(tc, 2), np.round(tc / qm).astype(int))
    tc2 = np.array([[[-6, -12], [20, 24]]], dtype=np.int64)
    assert np.array_equal(Q.quantize(tc2, 2), np.round(tc2 / qm).astype(int))


def test_per_block_qp_vector():
    rng = np.random.default_rng(6)
    tc = rng.integers(-2048, 2049, size=(10, 16, 16)).astype(np.int64)
    qps = rng.integers(0, 8, size=(10,))
    got = Q.quantize(tc, qps)
    for b in range(10):
        assert np.array_equal(got[b], Q.quantize(tc[b : b + 1], int(qps[b]))[0])


def ref_entropy_encoder_block(residual_block, block_size):
    # verbatim-semantics reimplementation used only as a test oracle
    non_zero_count = 0
    non_zero_values = []
    n = block_size
    result = []
    flag = 1
    zero_count = 0
    for k in range(2 * n - 1):
        if k < n:
            i, j = 0, k
        else:
            i, j = k - n + 1, n - 1
        while i < n and j >= 0:
            if residual_block[i][j] != 0:
                if flag == 0:
                    if zero_count:
                        result.append(zero_count)
                        zero_count = 0
                    non_zero_values = []
                    non_zero_count = 0
                    flag = 1
                non_zero_values.append(residual_block[i][j])
                non_zero_count += 1
            else:
                if flag == 1:
                    if non_zero_count:
                        result.append(-non_zero_count)
                        result.extend(non_zero_values)
                        non_zero_values = []
                        non_zero_count = 0
                    zero_count = 0
                    flag = 0
                zero_count += 1
            i += 1
            j -= 1
    if non_zero_count:
        result.append(-non_zero_count)
        result.extend(non_zero_values)
    if zero_count:
        result.extend([0])
    return result


@pytest.mark.parametrize("n,density", [(4, 0.5), (8, 0.2), (16, 0.1), (16, 0.9), (16, 0.0)])
def test_rle_encode_matches_reference_and_length(n, density):
    rng = np.random.default_rng(7)
    for _ in range(50):
        mask = rng.random((n, n)) < density
        block = np.where(mask, rng.integers(-99, 100, size=(n, n)), 0).astype(np.int64)
        ref = [int(v) for v in ref_entropy_encoder_block(block, n)]
        got = [int(v) for v in Z.rle_encode_block(block)]
        assert got == ref
        assert Z.rle_length(block[None])[0] == len(ref)
        dec = Z.rle_decode_block(got, n)
        assert np.array_equal(dec, block)


def test_rle_length_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    blocks = np.where(rng.random((40, 16, 16)) < 0.15, rng.integers(-9, 10, size=(40, 16, 16)), 0)
    want = np.array([len(Z.rle_encode_block(b)) for b in blocks])
    got = np.asarray(Z.rle_length(jnp.asarray(blocks)))
    assert np.array_equal(got, want)


def test_blockify_roundtrip_and_raster_order():
    rng = np.random.default_rng(9)
    f = rng.integers(0, 256, size=(32, 48))
    blks = B.blockify(f, 16)
    assert blks.shape == (6, 16, 16)
    assert np.array_equal(blks[1], f[0:16, 16:32])  # raster order
    assert np.array_equal(B.unblockify(blks, 32, 48), f)
    quads = B.split_quads(blks, 16)
    assert np.array_equal(quads[0, 1], f[0:8, 8:16])  # Z order: TL,TR,BL,BR
    assert np.array_equal(B.merge_quads(quads, 16), blks)


def test_pad_hw():
    f = np.arange(12).reshape(3, 4).astype(np.int32)
    out = B.pad_hw(f, 3, 4, 16)
    assert out.shape == (16, 16)
    assert np.array_equal(out[:3, :4], f)
    assert (out[3:, :] == 128).all() and (out[:, 4:] == 128).all()


def test_config_rejects_tiebreak_packing_overflow():
    """n_ref_frames > 8 or ref-grid search range > 127 would overflow the
    search kernels' tie-break packing (3-bit ref, 8-bit displacement
    indices) and silently pick wrong winners — the config refuses them."""
    import pytest

    from streamoptima_tpu.config import CodecConfig

    base = dict(height=64, width=64, frames=2, qp=4, intra_dur=2)
    CodecConfig(n_ref_frames=8, search_range=63, fme_enable=True, **base)
    CodecConfig(search_range=127, **base)
    with pytest.raises(ValueError, match="n_ref_frames"):
        CodecConfig(n_ref_frames=9, **base)
    with pytest.raises(ValueError, match="search_range"):
        CodecConfig(search_range=64, fme_enable=True, **base)
    with pytest.raises(ValueError, match="search_range"):
        CodecConfig(search_range=128, **base)
    with pytest.raises(ValueError, match="search_range"):
        CodecConfig(search_range=0, **base)


@pytest.mark.parametrize("qp", range(13))
def test_int_transform_exact_at_residual_extremes(qp):
    """The exact int32 transform at the +-255 residual extremes (every DCT
    basis sign pattern, constant blocks, random signs) for every QP: the
    JAX int32 path equals the NumPy int64 path bit for bit — no int32
    overflow anywhere — for 16x16 blocks at qp and 8x8 quads at qp-1, and
    stays within one unit of the float64 transform."""
    import jax.numpy as jnp

    from chip_smoke import extreme_blocks

    for n, q in ((16, qp), (8, Q.qpm1(qp))):
        x = extreme_blocks(2 + 2 * n * n + 40, n, seed=qp)
        t_np = T.dct2_int(x, xp=np)
        np.testing.assert_array_equal(np.asarray(T.dct2_int(jnp.asarray(x))), t_np)
        assert np.abs(t_np - T.dct2_f64(x)).max() <= 1
        rs = np.asarray(Q.rescale(Q.quantize(t_np.astype(np.int64), q), q)).astype(np.int32)
        np.testing.assert_array_equal(np.asarray(T.idct2_int(jnp.asarray(rs))),
                                      T.idct2_int(rs, xp=np))
