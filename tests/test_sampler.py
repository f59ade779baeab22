"""Sampler tests: bit-exact oracle vs the C semantics + statistical checks."""

import numpy as np
import jax.numpy as jnp
import pytest

from strelka_tpu.ops import sampler as S

M32 = 0xFFFFFFFF


# --- independent Python-int transliteration of RandomSampler.h (the oracle) ---

def _part1by1(x):
    x &= 0x0000FFFF
    x = (x ^ (x << 8)) & 0x00FF00FF
    x = (x ^ (x << 4)) & 0x0F0F0F0F
    x = (x ^ (x << 2)) & 0x33333333
    x = (x ^ (x << 1)) & 0x55555555
    return x & M32


def _morton2(x, y):
    return ((_part1by1(y) << 1) + _part1by1(x)) & M32


def _hash(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return x


def _hash_combine(seed, v):
    return (seed ^ ((v + ((seed << 6) & M32) + (seed >> 2)) & M32)) & M32


def _reverse_bits(v):
    v = (((v & 0xAAAAAAAA) >> 1) | ((v & 0x55555555) << 1)) & M32
    v = (((v & 0xCCCCCCCC) >> 2) | ((v & 0x33333333) << 2)) & M32
    v = (((v & 0xF0F0F0F0) >> 4) | ((v & 0x0F0F0F0F) << 4)) & M32
    v = (((v & 0xFF00FF00) >> 8) | ((v & 0x00FF00FF) << 8)) & M32
    return ((v >> 16) | (v << 16)) & M32


def _lk_perm(value, seed):
    value = (value + seed) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        value ^= (value * c) & M32
        value &= M32
    return value


def _nus(value, seed):
    return _reverse_bits(_lk_perm(_reverse_bits(value), seed))


def _sobol_uint(index, dim):
    x = 0
    for bit in range(32):
        if (index >> bit) & 1:
            x ^= int(S._SB_MATRIX[dim][bit])
    return x & M32


def _sobol_scramble(index, dim, seed):
    seed = _hash(seed)
    index = _nus(index, seed)
    result = _nus(_sobol_uint(index, dim), _hash_combine(seed, dim))
    return min(result * 2.0 ** -32, float(S.FLOAT_ONE_MINUS_EPS))


def test_morton_exact():
    xs = np.array([0, 1, 2, 3, 1023, 511, 65535], dtype=np.uint32)
    ys = np.array([0, 1, 5, 7, 767, 300, 65535], dtype=np.uint32)
    got = np.asarray(S.encode_morton2(jnp.array(xs), jnp.array(ys)))
    want = np.array([_morton2(int(x), int(y)) for x, y in zip(xs, ys)], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_hashes_exact():
    vals = np.array([0, 1, 52, 12345, 0xDEADBEEF, M32], dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(S.hash_u32(jnp.array(vals))), np.array([_hash(int(v)) for v in vals], dtype=np.uint32)
    )
    np.testing.assert_array_equal(
        np.asarray(S.reverse_bits(jnp.array(vals))),
        np.array([_reverse_bits(int(v)) for v in vals], dtype=np.uint32),
    )
    np.testing.assert_array_equal(
        np.asarray(S.hash_combine(jnp.array(vals), 3)),
        np.array([_hash_combine(int(v), 3) for v in vals], dtype=np.uint32),
    )


def test_sobol_uint_exact():
    for dim in range(5):
        idx = np.array([0, 1, 2, 3, 1000, 123456789, M32], dtype=np.uint32)
        got = np.asarray(S.sobol_uint(jnp.array(idx), dim))
        want = np.array([_sobol_uint(int(i), dim) for i in idx], dtype=np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f"dim={dim}")


@pytest.mark.parametrize("dim", range(5))
def test_sobol_scramble_exact(dim):
    idx = np.array([0, 1, 7, 52, 99991, 2**31], dtype=np.uint32)
    for seed in (52, 53, 56):
        got = np.asarray(S.sobol_scramble(jnp.array(idx), dim, jnp.uint32(seed)))
        want = np.array([_sobol_scramble(int(i), dim, seed) for i in idx], dtype=np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=0)


def test_random_dim_matches_reference_dimension_folding():
    """(Dim + depth*10) % 5 == Dim % 5 — depth enters only via the seed."""
    idx = jnp.arange(64, dtype=jnp.uint32)
    a = np.asarray(S.random_dim(idx, 2, S.SampleDimension.eBSDF0))
    b = np.array(
        [_sobol_scramble(int(i), int(S.SampleDimension.eBSDF0) % 5, 52 + 2) for i in range(64)],
        dtype=np.float32,
    )
    np.testing.assert_allclose(a, b, rtol=0, atol=0)


def test_uniformity():
    n = 1 << 14
    idx = jnp.arange(n, dtype=jnp.uint32)
    for dim in range(5):
        u = np.asarray(S.sobol_scramble(idx, dim, jnp.uint32(52)))
        assert 0.0 <= u.min() and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 5e-3
        # low-discrepancy: stratification into 64 bins is near-perfect
        hist, _ = np.histogram(u, bins=64, range=(0, 1))
        assert hist.min() > 0.5 * n / 64
        assert hist.max() < 1.5 * n / 64


def test_decorrelated_pixels():
    """Neighboring pixels get decorrelated sequences via Morton+Owen."""
    max_spp = 64
    xs = jnp.array([10], dtype=jnp.uint32)
    ys = jnp.array([20], dtype=jnp.uint32)
    i0 = S.make_sample_index(xs, ys, 0, max_spp)
    i1 = S.make_sample_index(xs + 1, ys, 0, max_spp)
    seq0 = np.array([float(S.sobol_scramble(i0 + k * max_spp * 0, 0, jnp.uint32(52))[0]) for k in range(8)])
    # same index repeated must be deterministic
    assert len(set(seq0.tolist())) == 1
    a = np.asarray(S.sobol_scramble(i0, 0, jnp.uint32(52)))
    b = np.asarray(S.sobol_scramble(i1, 0, jnp.uint32(52)))
    assert a[0] != b[0]


def test_random_dims_batch_matches_single():
    """Batched draw is bit-identical to per-dim random_dim."""
    idx = jnp.arange(512, dtype=jnp.uint32) * 977
    for depth in (0, 2, 5):
        batch = np.asarray(S.random_dims(idx, depth, (0, 1, 2, 3, 4)))
        for dim in range(5):
            single = np.asarray(S.random_dim(idx, depth, S.SampleDimension(dim)))
            np.testing.assert_array_equal(batch[dim], single)


def test_uniform_hash_statistics_and_decorrelation():
    """The auxiliary cutout uniform is uniform-ish and decorrelated from the
    Sobol dims at the same index."""
    import jax.numpy as jnp
    from strelka_tpu.ops import sampler as S

    idx = jnp.arange(1 << 16, dtype=jnp.uint32)
    u = np.asarray(S.uniform_hash(idx, 1))
    assert 0.49 < u.mean() < 0.51
    assert u.min() >= 0.0 and u.max() < 1.0
    # depth changes the stream
    u2 = np.asarray(S.uniform_hash(idx, 2))
    assert abs(np.corrcoef(u, u2)[0, 1]) < 0.02
    # decorrelated from sobol dim 0 at the same depth
    s0 = np.asarray(S.random_dims(idx, 1, (0,)))[0]
    assert abs(np.corrcoef(u, s0)[0, 1]) < 0.02


@pytest.mark.parametrize("depth", [0, 3])
def test_numpy_reference_matches_random_dims_and_oracle(depth):
    """The uint32 numpy sampler reference (ops/reference.py, used by the
    on-card check) is bit-exact against random_dims and the per-element
    Python oracle above."""
    from strelka_tpu.ops import reference as R

    rng = np.random.default_rng(depth)
    idx = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    dims = (0, 1, 2, 3, 4)
    ref = R.random_dims(idx, depth, dims, S._SB_MATRIX)
    got = np.asarray(S.random_dims(jnp.asarray(idx), depth, dims))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    for k in range(0, 512, 97):
        for dim in dims:
            assert ref[dim, k] == np.float32(_sobol_scramble(int(idx[k]), dim, 52 + depth))
