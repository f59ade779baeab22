"""Component-major 3-vectors (structure-of-arrays) for device code.

A [N, 3] vector array has a minor dimension of 3, so every elementwise op
over it reads strided, padded rows. Storing vectors as three separate [N]
arrays (this module) keeps every op a contiguous, coalesced [N] stream.

Vec3 is a NamedTuple(x, y, z) of same-shaped arrays with the usual algebra.
Convert at module boundaries only: `from_rows` ([N,3] -> Vec3) and `to_rows`
(Vec3 -> [N,3]); `gather_rows(table, idx)` gathers a [T,3] host-layout table
into a Vec3 with three [N] gathers (each full-lane).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- algebra --
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def full(shape, v, dtype=jnp.float32) -> Vec3:
    return Vec3(
        jnp.full(shape, v, dtype), jnp.full(shape, v, dtype), jnp.full(shape, v, dtype)
    )


def splat(c, shape, dtype=jnp.float32) -> Vec3:
    """Vec3 from a length-3 python/np constant, broadcast to shape."""
    return Vec3(
        jnp.full(shape, float(c[0]), dtype),
        jnp.full(shape, float(c[1]), dtype),
        jnp.full(shape, float(c[2]), dtype),
    )


def from_rows(a) -> Vec3:
    """[..., 3] -> Vec3 of [...]. Boundary-only (bad-layout source)."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def to_rows(v: Vec3):
    """Vec3 -> [..., 3]. Boundary-only."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def gather_rows(table, idx) -> Vec3:
    """Gather rows of a [T, 3] table -> Vec3 of [N].

    ONE row gather of whole rows + three column slices, instead of three
    per-component element gathers (table[idx, k]).
    """
    rows = gather_rows_t(table, idx)
    return Vec3(rows[0], rows[1], rows[2])


def gather_rows_t(table, idx):
    """Gather rows of a [T, F] table and transpose -> [F, N].

    The gather output [N, F] has minor dim F; transposing once makes all
    downstream component slices contiguous [N] rows.
    """
    return table[idx].T


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: Vec3):
    return jnp.sqrt(dot(a, a))


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = 1.0 / jnp.maximum(length(a), eps)
    return a * inv


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Select with a SCALAR-shaped mask (same shape as components)."""
    return Vec3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y), jnp.where(mask, a.z, b.z))


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a + (b - a) * t


def clip(a: Vec3, lo, hi) -> Vec3:
    return Vec3(jnp.clip(a.x, lo, hi), jnp.clip(a.y, lo, hi), jnp.clip(a.z, lo, hi))


def vmin(a: Vec3):
    return jnp.minimum(a.x, jnp.minimum(a.y, a.z))


def vmax(a: Vec3):
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))


def any_nan(a: Vec3):
    return jnp.isnan(a.x) | jnp.isnan(a.y) | jnp.isnan(a.z)


def all_nonzero(a: Vec3):
    return (a.x != 0.0) & (a.y != 0.0) & (a.z != 0.0)


def any_nonzero(a: Vec3):
    return (a.x != 0.0) | (a.y != 0.0) | (a.z != 0.0)


def luminance(a: Vec3):
    """Rec601 luma (Tonemappers.cu:6-9 weights)."""
    return 0.299 * a.x + 0.587 * a.y + 0.114 * a.z


def maximum(a: Vec3, v) -> Vec3:
    return Vec3(jnp.maximum(a.x, v), jnp.maximum(a.y, v), jnp.maximum(a.z, v))


def matvec(m, v: Vec3, w=None) -> Vec3:
    """Row-major 3x4/4x4 matrix applied to (v, w): returns m[:3] @ [v, w].

    m: [4,4] or [3,4] traced array (tiny, scalar entries broadcast).
    w: the homogeneous coordinate (scalar/array); None = 0 (direction).
    """
    out = [
        m[i, 0] * v.x + m[i, 1] * v.y + m[i, 2] * v.z + (m[i, 3] * w if w is not None else 0.0)
        for i in range(3)
    ]
    return Vec3(*out)


def octant(d: Vec3) -> jnp.ndarray:
    """Direction octant id [0, 8): bit c set iff component c is positive
    (the low bits of the wavefront sort key)."""
    return (
        (d.x > 0).astype(jnp.int32)
        | ((d.y > 0).astype(jnp.int32) << 1)
        | ((d.z > 0).astype(jnp.int32) << 2)
    )
