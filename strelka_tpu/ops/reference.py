"""Plain numpy references for the device code (tests and on-card checks).

Each function restates the semantics of a device path in float64 (or
uint32 for the sampler) with no JAX, no acceleration structure and no
shared code, so agreement with it says the device path is right:

  * ray_triangles: closest/any hit, Moller-Trumbore (ops/intersect.py,
    ops/bvh.py);
  * ray_round_cones: closest hit over round cones (ops/curves.py);
  * random_dims: the Owen-scrambled Sobol draw (ops/sampler.random_dims);
  * tonemap_planar: Reinhard / ACES / filmic + gamma (ops/tonemap.py).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

_BIG = 1e16


def _chunked(n_rays: int, ray_chunk: int, fn, workers: int):
    starts = range(0, n_rays, ray_chunk)
    if workers <= 1:
        return [fn(s) for s in starts]
    with ThreadPoolExecutor(workers) as ex:  # numpy ufuncs release the GIL
        return list(ex.map(fn, starts))


def ray_triangles(o, d, v0, e1, e2, tmin, tmax, *, tri_mask=None, ray_mask=None,
                  exclude=None, active=None, any_hit=False, ray_chunk=64,
                  tri_chunk=8192, workers=1):
    """Rays [N,3] x triangles (v0, e1, e2: [T,3]) -> (t [N], prim [N]).

    prim is the lowest-t triangle (-1 = miss, t = 1e16); a triangle counts
    when |det| > 1e-12, u >= 0, v >= 0, u + v <= 1 and tmin < t < tmax, its
    mask shares a bit with ray_mask, and it is not the ray's exclude id.
    any_hit=True returns (occluded [N] bool, None)."""
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    tmin = np.asarray(tmin, np.float64)
    tmax = np.asarray(tmax, np.float64)
    n, ntri = o.shape[0], v0.shape[0]
    tri_ok = np.ones(ntri, bool)
    if tri_mask is not None and ray_mask is not None:
        tri_ok = (np.asarray(tri_mask) & ray_mask) != 0
    best_t = np.full(n, _BIG)
    best_p = np.full(n, -1, np.int64)

    tri = [c[:, k][None, :] for c in (v0, e1, e2) for k in range(3)]

    def run(r0):
        r1 = min(r0 + ray_chunk, n)
        ox, oy, oz = (o[r0:r1, k, None] for k in range(3))
        dx, dy, dz = (d[r0:r1, k, None] for k in range(3))
        lo, hi = tmin[r0:r1, None], tmax[r0:r1, None]
        for c0 in range(0, ntri, tri_chunk):
            c1 = min(c0 + tri_chunk, ntri)
            px, py, pz, ax, ay, az, bx, by, bz = (c[:, c0:c1] for c in tri)
            qx, qy, qz = dy * bz - dz * by, dz * bx - dx * bz, dx * by - dy * bx
            det = ax * qx + ay * qy + az * qz
            ok = np.abs(det) > 1e-12
            inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
            tx, ty, tz = ox - px, oy - py, oz - pz
            u = (tx * qx + ty * qy + tz * qz) * inv
            rx, ry, rz = ty * az - tz * ay, tz * ax - tx * az, tx * ay - ty * ax
            v = (dx * rx + dy * ry + dz * rz) * inv
            t = (bx * rx + by * ry + bz * rz) * inv
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > lo) & (t < hi)
            hit &= tri_ok[None, c0:c1]
            if exclude is not None:
                hit &= np.arange(c0, c1)[None, :] != np.asarray(exclude)[r0:r1, None]
            t = np.where(hit, t, _BIG)
            arg = np.argmin(t, axis=1)
            tb = t[np.arange(r1 - r0), arg]
            better = tb < best_t[r0:r1]
            best_t[r0:r1] = np.where(better, tb, best_t[r0:r1])
            best_p[r0:r1] = np.where(better, c0 + arg, best_p[r0:r1])

    _chunked(n, ray_chunk, run, workers)
    if active is not None:
        dead = ~np.asarray(active, bool)
        best_t[dead] = _BIG
        best_p[dead] = -1
    if any_hit:
        return best_p >= 0, None
    return best_t, best_p


def ray_round_cones(o, d, a, b, ra, rb, tmin, tmax, *, ray_chunk=256,
                    cone_chunk=8192, workers=1):
    """Rays [N,3] x round cones (a, b: [M,3], radii ra, rb: [M]) ->
    (t [N], cone [N], y [N]): nearest hit over the cone body and its two
    end spheres with tmin < t < tmax; cones with a negative start radius
    never hit; y is the axial position of the hit in [0, 1]."""
    o = np.asarray(o, np.float64)
    d = np.asarray(d, np.float64)
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ra = np.asarray(ra, np.float64)
    rb = np.asarray(rb, np.float64)
    tmin = np.asarray(tmin, np.float64)
    tmax = np.asarray(tmax, np.float64)
    n, m = o.shape[0], a.shape[0]
    best_t = np.full(n, _BIG)
    best_c = np.full(n, -1, np.int64)
    best_y = np.zeros(n)

    def sphere(ro, rd, c, r):
        oc = ro - c
        bq = np.einsum("rmk,rmk->rm", oc, np.broadcast_to(rd, oc.shape))
        cq = np.einsum("rmk,rmk->rm", oc, oc) - r * r
        h = bq * bq - cq
        return np.where(h > 0, -bq - np.sqrt(np.maximum(h, 0.0)), _BIG)

    def run(r0):
        r1 = min(r0 + ray_chunk, n)
        ro, rd = o[r0:r1, None, :], d[r0:r1, None, :]
        lo, hi = tmin[r0:r1, None], tmax[r0:r1, None]
        for c0 in range(0, m, cone_chunk):
            c1 = min(c0 + cone_chunk, m)
            ca, cb = a[None, c0:c1], b[None, c0:c1]
            r_a, r_b = ra[None, c0:c1], rb[None, c0:c1]
            ba = cb - ca
            oa = ro - ca
            rdb = np.broadcast_to(rd, oa.shape)
            rr = r_a - r_b
            m0 = np.einsum("rmk,rmk->rm", np.broadcast_to(ba, oa.shape), np.broadcast_to(ba, oa.shape))
            m1 = np.einsum("rmk,rmk->rm", oa, np.broadcast_to(ba, oa.shape))
            m2 = np.einsum("rmk,rmk->rm", rdb, np.broadcast_to(ba, oa.shape))
            m3 = np.einsum("rmk,rmk->rm", rdb, oa)
            m5 = np.einsum("rmk,rmk->rm", oa, oa)
            d2 = m0 - rr * rr
            k2 = d2 - m2 * m2
            k1 = d2 * m3 - m1 * m2 + m2 * rr * r_a
            k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * r_a - d2 * r_a * r_a
            h = k1 * k1 - k0 * k2
            k2s = np.where(np.abs(k2) > 1e-12, k2, 1e-12)
            tb = (-np.sqrt(np.maximum(h, 0.0)) - k1) / k2s
            y = m1 + tb * m2
            t_body = np.where((h > 0) & (y > 0) & (y < d2), tb, _BIG)
            t_ca = sphere(ro, rd, ca, r_a)
            t_cb = sphere(ro, rd, cb, r_b)
            t = np.minimum(t_body, np.minimum(t_ca, t_cb))
            yn = np.clip(y / np.maximum(d2, 1e-12), 0.0, 1.0)
            yn = np.where(t == t_ca, 0.0, np.where(t == t_cb, 1.0, yn))
            hit = (t < _BIG) & (t > lo) & (t < hi) & (r_a >= 0)
            t = np.where(hit, t, _BIG)
            arg = np.argmin(t, axis=1)
            rows = np.arange(r1 - r0)
            tk = t[rows, arg]
            better = tk < best_t[r0:r1]
            best_t[r0:r1] = np.where(better, tk, best_t[r0:r1])
            best_c[r0:r1] = np.where(better, c0 + arg, best_c[r0:r1])
            best_y[r0:r1] = np.where(better, yn[rows, arg], best_y[r0:r1])

    _chunked(n, ray_chunk, run, workers)
    return best_t, best_c, best_y


# ---- sampler (uint32 numpy; RandomSampler.h) ---------------------------------

_U = np.uint32


def _hash(x):
    x = x ^ (x >> _U(16))
    x = x * _U(0x85EBCA6B)
    x = x ^ (x >> _U(13))
    x = x * _U(0xC2B2AE35)
    return x ^ (x >> _U(16))


def _hash_combine(seed, v):
    return seed ^ (v + (seed << _U(6)) + (seed >> _U(2)))


def _reverse_bits(v):
    v = ((v & _U(0xAAAAAAAA)) >> _U(1)) | ((v & _U(0x55555555)) << _U(1))
    v = ((v & _U(0xCCCCCCCC)) >> _U(2)) | ((v & _U(0x33333333)) << _U(2))
    v = ((v & _U(0xF0F0F0F0)) >> _U(4)) | ((v & _U(0x0F0F0F0F)) << _U(4))
    v = ((v & _U(0xFF00FF00)) >> _U(8)) | ((v & _U(0x00FF00FF)) << _U(8))
    return (v >> _U(16)) | (v << _U(16))


def _nested_uniform_scramble(value, seed):
    v = _reverse_bits(value) + seed
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        v = v ^ (v * _U(c))
    return _reverse_bits(v)


def random_dims(sample_idx, depth: int, dims, sobol_matrix) -> np.ndarray:
    """[D, N] float32 draws: sobol_scramble(sample_idx, dim % 5, 52 + depth)
    per dim (RandomSampler.h:213-226). sobol_matrix: the [5, 32] direction
    numbers (RandomSampler.h:139-164)."""
    with np.errstate(over="ignore"):
        idx = np.asarray(sample_idx, np.uint32)
        seed = _hash(np.asarray(52 + depth, np.uint32))
        index = _nested_uniform_scramble(idx, seed)
        out = []
        for dim in dims:
            dim = int(dim) % 5
            x = np.zeros_like(index)
            for bit in range(32):
                sel = ((index >> _U(bit)) & _U(1)).astype(bool)
                x = np.where(sel, x ^ _U(int(sobol_matrix[dim][bit])), x)
            r = _nested_uniform_scramble(x, _hash_combine(seed, _U(dim)))
            f = r.astype(np.float32) * np.float32(2.0 ** -32)
            out.append(np.minimum(f, np.float32(1.0 - 2.0 ** -24)))
    return np.stack(out)


# ---- tonemap (float64; Tonemappers.cu) ---------------------------------------

_ACES_IN = np.array(
    [[0.59719, 0.35458, 0.04823], [0.07600, 0.90834, 0.01566], [0.02840, 0.13383, 0.83777]]
)
_ACES_OUT = np.array(
    [[1.60475, -0.53108, -0.07367], [-0.10208, 1.10813, -0.00605], [-0.00327, -0.07276, 1.07602]]
)


def tonemap_planar(image, kind: int, exposure, gamma: float) -> np.ndarray:
    """[3, H, W] HDR -> tonemapped [3, H, W] in float64. kind: 0 Reinhard,
    1 ACES (Hill fit), 2 filmic (Narkowicz), 3 none."""
    c = np.asarray(image, np.float64)
    if kind in (0, 1, 2):
        c = c * np.asarray(exposure, np.float64).reshape(3, 1, 1)
    if kind == 0:
        lum = 0.299 * c[0] + 0.587 * c[1] + 0.114 * c[2]
        c = c / (lum + 1.0)
    elif kind == 1:
        c = np.einsum("ij,jhw->ihw", _ACES_IN, c)
        c = (c * (c + 0.0245786) - 0.000090537) / (c * (0.983729 * c + 0.4329510) + 0.238081)
        c = np.clip(np.einsum("ij,jhw->ihw", _ACES_OUT, c), 0.0, 1.0)
    elif kind == 2:
        c = np.clip((c * (2.51 * c + 0.03)) / (c * (2.43 * c + 0.59) + 0.14), 0.0, 1.0)
    if gamma > 0.0:
        c = np.maximum(c, 0.0) ** (1.0 / gamma)
    return c
