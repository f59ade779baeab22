"""Owen-scrambled Sobol sampler — exact vectorized port of the reference RNG.

Reference: src/render/optix/RandomSampler.h. The reference draws every path
decision from a 5-dimensional scrambled Sobol sequence indexed by a
Morton-coded per-pixel sample index:

  sampleIdx = EncodeMorton2(px, py) * maxSampleCount + pixelSampleIndex   (:130-137)
  dimension = (Dim + depth * NUM_DIMENSIONS) % 5                          (:221-226)
  value     = sobol_scramble(sampleIdx, dimension, seed=52 + depth)       (:213-219)

NUM_DIMENSIONS == 10, so (Dim + depth*10) % 5 == Dim % 5: the bounce depth
only enters through the scramble seed. All functions here operate on uint32
jnp arrays of any shape and are jit/vmap-safe (pure elementwise bit math,
no gathers).
"""

from __future__ import annotations

from enum import IntEnum

import jax.numpy as jnp
import numpy as np

FLOAT_ONE_MINUS_EPS = np.float32(1.0 - 2.0 ** -24)  # 0x1.fffffep-1
SAMPLER_BASE_SEED = 52  # OptixRender.cu:101


class SampleDimension(IntEnum):
    """RandomSampler.h:13-26."""

    ePixelX = 0
    ePixelY = 1
    eLightId = 2
    eLightPointX = 3
    eLightPointY = 4
    eBSDF0 = 5
    eBSDF1 = 6
    eBSDF2 = 7
    eBSDF3 = 8
    eRussianRoulette = 9
    eNUM_DIMENSIONS = 10


# Sobol direction-number matrices for 5 dimensions (RandomSampler.h:139-164).
_SB_MATRIX = np.array(
    [
        [
            0x80000000, 0x40000000, 0x20000000, 0x10000000, 0x08000000, 0x04000000, 0x02000000, 0x01000000,
            0x00800000, 0x00400000, 0x00200000, 0x00100000, 0x00080000, 0x00040000, 0x00020000, 0x00010000,
            0x00008000, 0x00004000, 0x00002000, 0x00001000, 0x00000800, 0x00000400, 0x00000200, 0x00000100,
            0x00000080, 0x00000040, 0x00000020, 0x00000010, 0x00000008, 0x00000004, 0x00000002, 0x00000001,
        ],
        [
            0x80000000, 0xC0000000, 0xA0000000, 0xF0000000, 0x88000000, 0xCC000000, 0xAA000000, 0xFF000000,
            0x80800000, 0xC0C00000, 0xA0A00000, 0xF0F00000, 0x88880000, 0xCCCC0000, 0xAAAA0000, 0xFFFF0000,
            0x80008000, 0xC000C000, 0xA000A000, 0xF000F000, 0x88008800, 0xCC00CC00, 0xAA00AA00, 0xFF00FF00,
            0x80808080, 0xC0C0C0C0, 0xA0A0A0A0, 0xF0F0F0F0, 0x88888888, 0xCCCCCCCC, 0xAAAAAAAA, 0xFFFFFFFF,
        ],
        [
            0x80000000, 0xC0000000, 0x60000000, 0x90000000, 0xE8000000, 0x5C000000, 0x8E000000, 0xC5000000,
            0x68800000, 0x9CC00000, 0xEE600000, 0x55900000, 0x80680000, 0xC09C0000, 0x60EE0000, 0x90550000,
            0xE8808000, 0x5CC0C000, 0x8E606000, 0xC5909000, 0x6868E800, 0x9C9C5C00, 0xEEEE8E00, 0x5555C500,
            0x8000E880, 0xC0005CC0, 0x60008E60, 0x9000C590, 0xE8006868, 0x5C009C9C, 0x8E00EEEE, 0xC5005555,
        ],
        [
            0x80000000, 0xC0000000, 0x20000000, 0x50000000, 0xF8000000, 0x74000000, 0xA2000000, 0x93000000,
            0xD8800000, 0x25400000, 0x59E00000, 0xE6D00000, 0x78080000, 0xB40C0000, 0x82020000, 0xC3050000,
            0x208F8000, 0x51474000, 0xFBEA2000, 0x75D93000, 0xA0858800, 0x914E5400, 0xDBE79E00, 0x25DB6D00,
            0x58800080, 0xE54000C0, 0x79E00020, 0xB6D00050, 0x800800F8, 0xC00C0074, 0x200200A2, 0x50050093,
        ],
        [
            0x80000000, 0x40000000, 0x20000000, 0xB0000000, 0xF8000000, 0xDC000000, 0x7A000000, 0x9D000000,
            0x5A800000, 0x2FC00000, 0xA1600000, 0xF0B00000, 0xDA880000, 0x6FC40000, 0x81620000, 0x40BB0000,
            0x22878000, 0xB3C9C000, 0xFB65A000, 0xDDB2D000, 0x78022800, 0x9C0B3C00, 0x5A0FB600, 0x2D0DDB00,
            0xA2878080, 0xF3C9C040, 0xDB65A020, 0x6DB2D0B0, 0x800228F8, 0x400B3CDC, 0x200FB67A, 0xB00DDB9D,
        ],
    ],
    dtype=np.uint32,
)

_U32 = jnp.uint32


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x).astype(_U32)


def part1by1(x: jnp.ndarray) -> jnp.ndarray:
    """Insert a 0 bit after each of the 16 low bits (RandomSampler.h:115-123)."""
    x = _u32(x) & _U32(0x0000FFFF)
    x = (x ^ (x << 8)) & _U32(0x00FF00FF)
    x = (x ^ (x << 4)) & _U32(0x0F0F0F0F)
    x = (x ^ (x << 2)) & _U32(0x33333333)
    x = (x ^ (x << 1)) & _U32(0x55555555)
    return x


def encode_morton2(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """RandomSampler.h:125-128."""
    return (part1by1(y) << 1) + part1by1(x)


def hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    """murmurhash3 finalizer (RandomSampler.h:86-95)."""
    x = _u32(x)
    x = x ^ (x >> 16)
    x = x * _U32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * _U32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_combine(seed: jnp.ndarray, v) -> jnp.ndarray:
    """RandomSampler.h:50-53."""
    seed = _u32(seed)
    return seed ^ (_u32(v) + (seed << 6) + (seed >> 2))


def reverse_bits(v: jnp.ndarray) -> jnp.ndarray:
    """RandomSampler.h:192-203 (portable branch)."""
    v = _u32(v)
    v = ((v & _U32(0xAAAAAAAA)) >> 1) | ((v & _U32(0x55555555)) << 1)
    v = ((v & _U32(0xCCCCCCCC)) >> 2) | ((v & _U32(0x33333333)) << 2)
    v = ((v & _U32(0xF0F0F0F0)) >> 4) | ((v & _U32(0x0F0F0F0F)) << 4)
    v = ((v & _U32(0xFF00FF00)) >> 8) | ((v & _U32(0x00FF00FF)) << 8)
    return (v >> 16) | (v << 16)


def laine_karras_permutation(value: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """RandomSampler.h:182-190."""
    value = _u32(value) + _u32(seed)
    value = value ^ (value * _U32(0x6C50B47C))
    value = value ^ (value * _U32(0xB82F1E52))
    value = value ^ (value * _U32(0xC7AFE638))
    value = value ^ (value * _U32(0x8D22F6E6))
    return value


def nested_uniform_scramble(value: jnp.ndarray, seed: jnp.ndarray) -> jnp.ndarray:
    """RandomSampler.h:205-211."""
    return reverse_bits(laine_karras_permutation(reverse_bits(value), seed))


def sobol_uint(index: jnp.ndarray, dim: int) -> jnp.ndarray:
    """XOR-fold of direction numbers selected by index bits (RandomSampler.h:166-175).

    ``dim`` must be a static Python int in [0, 5). The 32-step loop is
    unrolled at trace time into pure elementwise bit ops (no gathers).
    """
    index = _u32(index)
    x = jnp.zeros_like(index)
    col = _SB_MATRIX[dim]
    for bit in range(32):
        mask = (index >> _U32(bit)) & _U32(1)
        # mask is 0/1; (0 - mask) gives an all-ones/all-zeros select mask.
        x = x ^ ((_U32(0) - mask) & _U32(int(col[bit])))
    return x


def sobol_scramble(index: jnp.ndarray, dim: int, seed: jnp.ndarray) -> jnp.ndarray:
    """Owen-scrambled Sobol sample in [0, 1) as float32 (RandomSampler.h:213-219)."""
    seed = hash_u32(seed)
    index = nested_uniform_scramble(index, seed)
    result = nested_uniform_scramble(sobol_uint(index, dim), hash_combine(seed, dim))
    return jnp.minimum(result.astype(jnp.float32) * jnp.float32(2.0 ** -32), FLOAT_ONE_MINUS_EPS)


def make_sample_index(
    pixel_x: jnp.ndarray, pixel_y: jnp.ndarray, sample_index, max_sample_count
) -> jnp.ndarray:
    """sampleIdx of initSampler (RandomSampler.h:130-137)."""
    return encode_morton2(pixel_x, pixel_y) * _u32(max_sample_count) + _u32(sample_index)


def random_dim(sample_idx: jnp.ndarray, depth, dim: SampleDimension) -> jnp.ndarray:
    """random<Dim>(state) (RandomSampler.h:221-226).

    depth may be a traced scalar (it only feeds the scramble seed); dim must
    be static. dimension = (dim + depth*10) % 5 == dim % 5 exactly.
    """
    dimension = int(dim) % 5
    seed = _u32(SAMPLER_BASE_SEED) + _u32(depth)
    return sobol_scramble(sample_idx, dimension, seed)


def sobol_uint_multi(index: jnp.ndarray, dims: tuple) -> jnp.ndarray:
    """XOR-fold for several dimensions at once -> [D, N] uint32.

    The index-bit mask is dimension-independent, so one 32-step sweep serves
    all D dimensions (vs D separate sweeps) — the hot-path form used by the
    integrator (bit-identical to sobol_uint per dim).
    """
    index = _u32(index)
    cols = np.asarray(_SB_MATRIX[list(dims)])  # [D, 32]
    x = jnp.zeros((len(dims),) + index.shape, _U32)
    for bit in range(32):
        mask = (_U32(0) - ((index >> _U32(bit)) & _U32(1)))[None, :]
        x = x ^ (mask & jnp.asarray(cols[:, bit])[:, None])
    return x


def random_dims(sample_idx: jnp.ndarray, depth, dims) -> jnp.ndarray:
    """Batched random<Dim> for several dims at one depth -> [D, N] float32.

    Bit-identical to stacking random_dim per dim, but the per-depth Owen
    scramble of the sample index is computed ONCE and the direction-number
    fold is shared across dims (~4x fewer ops than D separate draws).
    """
    dims = tuple(int(d) % 5 for d in dims)
    seed = hash_u32(_u32(SAMPLER_BASE_SEED) + _u32(depth))
    index = nested_uniform_scramble(sample_idx, seed)
    su = sobol_uint_multi(index, dims)
    seeds2 = hash_combine(seed, jnp.asarray(np.asarray(dims, np.uint32))[:, None])
    result = nested_uniform_scramble(su, seeds2)
    return jnp.minimum(result.astype(jnp.float32) * jnp.float32(2.0 ** -32), FLOAT_ONE_MINUS_EPS)


# ---------------------------------------------------------------------------
# Auxiliary generators kept for capability parity (RandomSampler.h also ships
# halton/lcg/pcg/jenkins/wang utilities; the Metal backend uses seeded halton,
# src/render/metal/shaders/random.h:107-123).
# ---------------------------------------------------------------------------


def uniform_hash(sample_idx: jnp.ndarray, depth: int) -> jnp.ndarray:
    """Independent auxiliary uniform in [0,1) from the sample index.

    Decorrelated from the 5 folded Sobol dimensions (used for effects the
    reference handles out-of-band, e.g. stochastic alpha cutout)."""
    salt = (0x9E3779B9 + 0x85EBCA6B * (depth + 1)) & 0xFFFFFFFF
    bits = pcg_hash(_u32(sample_idx) ^ _U32(salt))
    return bits.astype(jnp.float32) * (1.0 / 4294967296.0)


def pcg_hash(seed: jnp.ndarray) -> jnp.ndarray:
    """RandomSampler.h:38-43."""
    state = _u32(seed) * _U32(747796405) + _U32(2891336453)
    word = ((state >> ((state >> _U32(28)) + _U32(4))) ^ state) * _U32(277803737)
    return (word >> _U32(22)) ^ word


def wang_hash(seed: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """hash_with (RandomSampler.h:55-63)."""
    seed = (_u32(seed) ^ _U32(61)) ^ _u32(h)
    seed = seed + (seed << 3)
    seed = seed ^ (seed >> 4)
    seed = seed * _U32(0x27D4EB2D)
    return seed


def jenkins_hash(a: jnp.ndarray) -> jnp.ndarray:
    """RandomSampler.h:75-84."""
    a = _u32(a)
    a = (a + _U32(0x7ED55D16)) + (a << 12)
    a = (a ^ _U32(0xC761C23C)) ^ (a >> 19)
    a = (a + _U32(0x165667B1)) + (a << 5)
    a = (a + _U32(0xD3A2646C)) ^ (a << 9)
    a = (a + _U32(0xFD7046C5)) + (a << 3)
    a = (a ^ _U32(0xB55A4F09)) ^ (a >> 16)
    return a


def halton(index: jnp.ndarray, base: int, n_iters: int = 32) -> jnp.ndarray:
    """Radical inverse in a prime base (RandomSampler.h:97-111), fixed trip count."""
    i = _u32(index)
    s = jnp.float32(1.0 / base)
    result = jnp.zeros(i.shape, jnp.float32)
    f = jnp.full(i.shape, s, jnp.float32)
    for _ in range(n_iters):
        digit = i % _U32(base)
        result = result + f * digit.astype(jnp.float32)
        i = (i - digit) // _U32(base)
        f = f * s
    return jnp.clip(result, 0.0, FLOAT_ONE_MINUS_EPS)
