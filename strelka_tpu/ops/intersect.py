"""Ray-scene intersection dispatch + jnp brute-force kernels.

Replaces OptiX hardware traversal (optixTrace, OptixRender.cu:120-129).
Rays are component-major Vec3 (ops/vec.py). Threaded-BVH traversal when the
scene has a BVH, else the jnp brute-force sweep (also the correctness
oracle of the BVH path).

Also hosts offset_ray, the exact port of the Ray Tracing Gems self-
intersection offset (OptixRender_radiance_closest_hit.cu:218-233).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import jax
import jax.numpy as jnp

from strelka_tpu.ops import vec as V
from strelka_tpu.ops.vec import Vec3

if TYPE_CHECKING:  # break render<->ops import cycle; type-only use
    from strelka_tpu.render.device_scene import DeviceScene
else:
    DeviceScene = "DeviceScene"

_BIG = 1e16


class Hit(NamedTuple):
    t: jnp.ndarray  # [N] f32, 1e16 = miss
    prim: jnp.ndarray  # [N] int32, -1 = miss
    u: jnp.ndarray  # [N] f32 barycentric (reference: attr weight of v1)
    v: jnp.ndarray  # [N] f32


def _offset_component(p, n):
    of_i = (jnp.float32(256.0) * n).astype(jnp.int32)
    p_i = (p.view(jnp.int32) + jnp.where(p < 0, -of_i, of_i)).view(jnp.float32)
    return jnp.where(jnp.abs(p) < 1.0 / 32.0, p + (1.0 / 65536.0) * n, p_i)


def offset_ray(p: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact port of offset_ray (RT Gems ch.6), cu:218-233. p,n: [...,3]."""
    return _offset_component(p, n)


def offset_ray_vec(p: Vec3, n: Vec3) -> Vec3:
    return Vec3(
        _offset_component(p.x, n.x),
        _offset_component(p.y, n.y),
        _offset_component(p.z, n.z),
    )


def _ray_tri_block(o: Vec3, d: Vec3, v0, e1, e2, tmin, tmax):
    """Moller-Trumbore: rays Vec3 of [N] x tri SoA [B,3] -> t,u,v,hit [N,B].

    All intermediates are [N,B] (minor dim B -> full lanes); the tri arrays
    enter as per-component [B] rows broadcast against ray columns [N,1].
    """
    oc = (o.x[:, None], o.y[:, None], o.z[:, None])
    dc = (d.x[:, None], d.y[:, None], d.z[:, None])
    v0c = (v0[:, 0][None, :], v0[:, 1][None, :], v0[:, 2][None, :])
    e1c = (e1[:, 0][None, :], e1[:, 1][None, :], e1[:, 2][None, :])
    e2c = (e2[:, 0][None, :], e2[:, 1][None, :], e2[:, 2][None, :])

    def cross(a, b):
        return (
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        )

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    pvec = cross(dc, e2c)
    det = dot(e1c, pvec)
    # backface culling OFF (OptiX default w/o flags): accept |det| > eps
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tv = (oc[0] - v0c[0], oc[1] - v0c[1], oc[2] - v0c[2])
    u = dot(tv, pvec) * inv_det
    qvec = cross(tv, e1c)
    vv = dot(dc, qvec) * inv_det
    t = dot(e2c, qvec) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (vv >= 0.0)
        & (u + vv <= 1.0)
        & (t > tmin[:, None])
        & (t < tmax[:, None])
    )
    return t, u, vv, hit


def _as_vec3(x) -> Vec3:
    return x if isinstance(x, Vec3) else V.from_rows(jnp.asarray(x))


def intersect_closest(
    scene: DeviceScene,
    origins,
    directions,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    ray_mask: int,
    active: jnp.ndarray | None = None,
    exclude: jnp.ndarray | None = None,
) -> Hit:
    """Closest hit: threaded-BVH traversal when the scene has a BVH, else
    the brute-force sweep (ops/backend.py decides which the scene gets).
    origins/directions: Vec3 (or [N,3]).

    exclude: [N] i32 primitive id each ray originated from (-1 = none); it
    is rejected exactly (self-intersection guard on top of the epsilon
    scheme of OptixRender_radiance_closest_hit.cu:218-233)."""
    origins = _as_vec3(origins)
    directions = _as_vec3(directions)
    if scene.bvh is not None:
        from strelka_tpu.ops.bvh import intersect_bvh

        t, prim, u, v = intersect_bvh(
            scene.bvh,
            scene.v0,
            scene.e1,
            scene.e2,
            scene.geom_mask,
            V.to_rows(origins),
            V.to_rows(directions),
            tmin,
            tmax,
            ray_mask,
            active=active,
            exclude=exclude,
        )
        return Hit(t=t, prim=prim, u=u, v=v)
    return intersect_closest_bruteforce(scene, origins, directions, tmin, tmax, ray_mask, active, exclude=exclude)


def intersect_any(
    scene: DeviceScene,
    origins,
    directions,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    ray_mask: int,
    active: jnp.ndarray | None = None,
    exclude: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Occlusion -> [N] bool: BVH any-hit traversal or the brute-force sweep."""
    origins = _as_vec3(origins)
    directions = _as_vec3(directions)
    if scene.bvh is not None:
        from strelka_tpu.ops.bvh import intersect_bvh

        _, prim, _, _ = intersect_bvh(
            scene.bvh,
            scene.v0,
            scene.e1,
            scene.e2,
            scene.geom_mask,
            V.to_rows(origins),
            V.to_rows(directions),
            tmin,
            tmax,
            ray_mask,
            active=active,
            any_hit=True,
            exclude=exclude,
        )
        return prim >= 0
    return intersect_any_bruteforce(scene, origins, directions, tmin, tmax, ray_mask, active, exclude=exclude)


def intersect_closest_bruteforce(
    scene: DeviceScene,
    origins,
    directions,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    ray_mask: int,
    active: jnp.ndarray | None = None,
    block: int = 512,
    exclude: jnp.ndarray | None = None,
) -> Hit:
    """Closest hit over all triangles whose geom_mask intersects ray_mask."""
    origins = _as_vec3(origins)
    directions = _as_vec3(directions)
    n = tmin.shape[0]
    num_tri = scene.v0.shape[0]
    block = min(block, num_tri)
    num_blocks = (num_tri + block - 1) // block
    if active is None:
        active = jnp.ones(n, bool)
    # pad to a block multiple: dynamic_slice clamps at the array end, which
    # would re-test a shifted window and mis-number prims
    pad = num_blocks * block - num_tri
    tri_v0, tri_e1, tri_e2, tri_mask = scene.v0, scene.e1, scene.e2, scene.geom_mask
    if pad:
        z = jnp.zeros((pad, 3), tri_v0.dtype)
        tri_v0 = jnp.concatenate([tri_v0, z])
        tri_e1 = jnp.concatenate([tri_e1, z])
        tri_e2 = jnp.concatenate([tri_e2, z])
        tri_mask = jnp.concatenate([tri_mask, jnp.zeros(pad, tri_mask.dtype)])

    def body(carry, bi):
        best_t, best_prim, best_u, best_v = carry
        start = bi * block
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, block, axis=0)
        t, u, v, hit = _ray_tri_block(origins, directions, sl(tri_v0), sl(tri_e1), sl(tri_e2), tmin, tmax)
        mask_ok = (sl(tri_mask) & ray_mask) != 0
        hit = hit & mask_ok[None, :] & active[:, None]
        if exclude is not None:
            ids = start + jnp.arange(block, dtype=jnp.int32)
            hit = hit & (ids[None, :] != exclude[:, None])
        t = jnp.where(hit, t, _BIG)
        arg = jnp.argmin(t, axis=1)
        rows = jnp.arange(n)
        t_blk = t[rows, arg]
        better = t_blk < best_t
        best_prim = jnp.where(better, (start + arg).astype(jnp.int32), best_prim)
        best_u = jnp.where(better, u[rows, arg], best_u)
        best_v = jnp.where(better, v[rows, arg], best_v)
        best_t = jnp.where(better, t_blk, best_t)
        return (best_t, best_prim, best_u, best_v), None

    init = (
        jnp.full(n, _BIG),
        jnp.full(n, -1, jnp.int32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, jnp.float32),
    )
    (t, prim, u, v), _ = jax.lax.scan(body, init, jnp.arange(num_blocks))
    return Hit(t=t, prim=prim, u=u, v=v)


def intersect_any_bruteforce(
    scene: DeviceScene,
    origins,
    directions,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    ray_mask: int,
    active: jnp.ndarray | None = None,
    block: int = 512,
    exclude: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Any-hit (occlusion) query -> [N] bool. Shadow rays use RAY_MASK_SHADOW."""
    origins = _as_vec3(origins)
    directions = _as_vec3(directions)
    n = tmin.shape[0]
    num_tri = scene.v0.shape[0]
    block = min(block, num_tri)
    num_blocks = (num_tri + block - 1) // block
    if active is None:
        active = jnp.ones(n, bool)
    pad = num_blocks * block - num_tri
    tri_v0, tri_e1, tri_e2, tri_mask = scene.v0, scene.e1, scene.e2, scene.geom_mask
    if pad:
        z = jnp.zeros((pad, 3), tri_v0.dtype)
        tri_v0 = jnp.concatenate([tri_v0, z])
        tri_e1 = jnp.concatenate([tri_e1, z])
        tri_e2 = jnp.concatenate([tri_e2, z])
        tri_mask = jnp.concatenate([tri_mask, jnp.zeros(pad, tri_mask.dtype)])

    def body(occluded, bi):
        start = bi * block
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, block, axis=0)
        _, _, _, hit = _ray_tri_block(origins, directions, sl(tri_v0), sl(tri_e1), sl(tri_e2), tmin, tmax)
        mask_ok = (sl(tri_mask) & ray_mask) != 0
        hit = hit & mask_ok[None, :] & active[:, None]
        if exclude is not None:
            ids = start + jnp.arange(block, dtype=jnp.int32)
            hit = hit & (ids[None, :] != exclude[:, None])
        return occluded | jnp.any(hit, axis=1), None

    occluded, _ = jax.lax.scan(body, jnp.zeros(n, bool), jnp.arange(num_blocks))
    return occluded
