"""Ray / cubic-B-spline curve (hair) intersection.

The reference uses OptiX's built-in ROUND_CUBIC_BSPLINE phantom intersector
(OptixRender.cpp:554-560) with cuda/curve.h interpolators for shading
normals/tangents (OptixRender_radiance_closest_hit.cu:423-454). Here each
B-spline segment is FLATTENED at build time into K round-cone (sphere-swept
line) subsegments with closed-form intersection — dense elementwise math
over (ray x subsegment) blocks — and the winning candidate is refined to
the exact swept envelope by a per-lane Newton step (ops/curve_refine.py).

Shading attributes are evaluated on the true spline: the hit's spline
parameter u is recovered from the subsegment index + local cone axial
position, then position/tangent come from the exact cubic basis
(CubicInterpolator::initializeFromBSpline semantics) and the normal is the
offset from the spine (surfaceNormal semantics).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

_BIG = 1e16
# round-cone subsegments per cubic segment (broad phase). The exact Newton
# refinement (ops/curve_refine.py) recovers the true swept envelope from the
# seed cone, so the flattening sets seed quality, not the final surface.
CURVE_SUBDIV = 8


def bspline_basis(u):
    """Uniform cubic B-spline basis weights for p0..p3 at parameter u."""
    u2 = u * u
    u3 = u2 * u
    b0 = (1.0 - 3.0 * u + 3.0 * u2 - u3) / 6.0
    b1 = (4.0 - 6.0 * u2 + 3.0 * u3) / 6.0
    b2 = (1.0 + 3.0 * u + 3.0 * u2 - 3.0 * u3) / 6.0
    b3 = u3 / 6.0
    return b0, b1, b2, b3


def bspline_basis_deriv(u):
    u2 = u * u
    d0 = (-3.0 + 6.0 * u - 3.0 * u2) / 6.0
    d1 = (-12.0 * u + 9.0 * u2) / 6.0
    d2 = (3.0 + 6.0 * u - 9.0 * u2) / 6.0
    d3 = 3.0 * u2 / 6.0
    return d0, d1, d2, d3


def eval_bspline(p0, p1, p2, p3, u):
    """Position on the spline; p*: [...,3], u: [...]. -> [...,3]."""
    b0, b1, b2, b3 = bspline_basis(u)
    return (
        b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2 + b3[..., None] * p3
    )


def eval_bspline_scalar(w0, w1, w2, w3, u):
    b0, b1, b2, b3 = bspline_basis(u)
    return b0 * w0 + b1 * w1 + b2 * w2 + b3 * w3


def eval_bspline_tangent(p0, p1, p2, p3, u):
    d0, d1, d2, d3 = bspline_basis_deriv(u)
    return (
        d0[..., None] * p0 + d1[..., None] * p1 + d2[..., None] * p2 + d3[..., None] * p3
    )


class FlatCones(NamedTuple):
    """Flattened curve subsegments (round cones). Leading dim S*K."""

    a: jnp.ndarray  # [M,3] start point
    b: jnp.ndarray  # [M,3] end point
    ra: jnp.ndarray  # [M] start radius
    rb: jnp.ndarray  # [M] end radius
    seg_id: jnp.ndarray  # [M] i32 parent cubic segment
    u0: jnp.ndarray  # [M] spline parameter at a
    u1: jnp.ndarray  # [M] spline parameter at b


def flatten_curves(curves) -> FlatCones:
    """DeviceCurves -> round-cone list (host/build time, runs under jit too).

    Cone radii are INFLATED by the mid-subsegment chord deviation so the
    swept-cone broad phase COVERS the exact envelope that the Newton
    refinement then finds — a chord always undercuts the arc, and at coarse
    subdivision the sagitta is wide enough to miss silhouette hits. Ghost
    candidates the inflation admits are rejected by the seed-residual check
    in curve_refine.refine_scene_curve_hit."""
    us = jnp.linspace(0.0, 1.0, CURVE_SUBDIV + 1)
    p0, p1, p2, p3 = curves.p0, curves.p1, curves.p2, curves.p3
    w0, w1, w2, w3 = curves.w0, curves.w1, curves.w2, curves.w3
    s = p0.shape[0]
    # [K+1, S, 3] spline points
    pts = jax.vmap(lambda u: eval_bspline(p0, p1, p2, p3, jnp.full(s, u)))(us)
    rads = jax.vmap(lambda u: eval_bspline_scalar(w0, w1, w2, w3, jnp.full(s, u)))(us)
    a = pts[:-1].reshape(-1, 3)
    b = pts[1:].reshape(-1, 3)
    ra = rads[:-1].reshape(-1)
    rb = rads[1:].reshape(-1)
    ums = 0.5 * (us[:-1] + us[1:])
    mid_pts = jax.vmap(lambda u: eval_bspline(p0, p1, p2, p3, jnp.full(s, u)))(ums)
    mid_rads = jax.vmap(lambda u: eval_bspline_scalar(w0, w1, w2, w3, jnp.full(s, u)))(ums)
    chord_mid = 0.5 * (pts[:-1] + pts[1:])
    dev_c = jnp.linalg.norm(mid_pts - chord_mid, axis=-1)
    dev_r = jnp.maximum(mid_rads - 0.5 * (rads[:-1] + rads[1:]), 0.0)
    # 4/3 safety: the cubic's max chord deviation is near but not exactly
    # at the midpoint
    pad = (4.0 / 3.0) * (dev_c + dev_r).reshape(-1)
    ra = ra + pad
    rb = rb + pad
    seg = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None, :], (CURVE_SUBDIV, s)).reshape(-1)
    u0 = jnp.broadcast_to(us[:-1, None], (CURVE_SUBDIV, s)).reshape(-1)
    u1 = jnp.broadcast_to(us[1:, None], (CURVE_SUBDIV, s)).reshape(-1)
    return FlatCones(a=a, b=b, ra=ra, rb=rb, seg_id=seg, u0=u0, u1=u1)


def flatten_curves_np(curves_np: dict) -> FlatCones:
    """Pure-numpy flatten_curves (host/build time): one upload per field
    afterwards instead of a traced flatten at scene-build time."""
    us = np.linspace(0.0, 1.0, CURVE_SUBDIV + 1, dtype=np.float32)
    p = [np.asarray(curves_np[f"p{j}"], np.float32) for j in range(4)]
    w = [np.asarray(curves_np[f"w{j}"], np.float32) for j in range(4)]
    s = p[0].shape[0]
    b = bspline_basis(us)  # 4 x [K+1]
    pts = sum(b[j][:, None, None] * p[j][None] for j in range(4))  # [K+1, S, 3]
    rads = sum(b[j][:, None] * w[j][None] for j in range(4))  # [K+1, S]
    ra = rads[:-1].reshape(-1)
    rb = rads[1:].reshape(-1)
    # envelope-covering radius inflation — see flatten_curves
    ums = (0.5 * (us[:-1] + us[1:])).astype(np.float32)
    bm = bspline_basis(ums)
    mid_pts = sum(bm[j][:, None, None] * p[j][None] for j in range(4))
    mid_rads = sum(bm[j][:, None] * w[j][None] for j in range(4))
    chord_mid = 0.5 * (pts[:-1] + pts[1:])
    dev_c = np.linalg.norm(mid_pts - chord_mid, axis=-1)
    dev_r = np.maximum(mid_rads - 0.5 * (rads[:-1] + rads[1:]), 0.0)
    pad = ((4.0 / 3.0) * (dev_c + dev_r)).reshape(-1).astype(np.float32)
    ra = ra + pad
    rb = rb + pad
    seg = np.broadcast_to(np.arange(s, dtype=np.int32)[None, :], (CURVE_SUBDIV, s))
    u0 = np.broadcast_to(us[:-1, None], (CURVE_SUBDIV, s))
    u1 = np.broadcast_to(us[1:, None], (CURVE_SUBDIV, s))
    return FlatCones(
        a=pts[:-1].reshape(-1, 3),
        b=pts[1:].reshape(-1, 3),
        ra=ra,
        rb=rb,
        seg_id=seg.reshape(-1),
        u0=u0.reshape(-1).astype(np.float32),
        u1=u1.reshape(-1).astype(np.float32),
    )


def _ray_round_cone(o, d, a, b, ra, rb, tmin, tmax):
    """Closed-form ray vs sphere-swept line segment (round cone).

    o,d: Vec3 of [N]; a,b: [M,3]; ra,rb: [M]. Returns (t [N,M], axial y in
    [0,1], hit mask). All intermediates are [N,M] per component (no
    [N,M,3] minor-dim-3 arrays). Quadratic from the standard swept-sphere
    derivation (cf. Quilez's roundcone).
    """
    from strelka_tpu.ops.vec import Vec3

    # component broadcasts: ray [N,1] x segment [1,M]
    ox, oy, oz = o.x[:, None], o.y[:, None], o.z[:, None]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    ax, ay, az = a[:, 0][None, :], a[:, 1][None, :], a[:, 2][None, :]
    bax = (b[:, 0] - a[:, 0])[None, :]
    bay = (b[:, 1] - a[:, 1])[None, :]
    baz = (b[:, 2] - a[:, 2])[None, :]
    oax, oay, oaz = ox - ax, oy - ay, oz - az
    rr = (ra - rb)[None, :]
    m0 = bax * bax + bay * bay + baz * baz
    m1 = oax * bax + oay * bay + oaz * baz
    m2 = dx * bax + dy * bay + dz * baz
    m3 = dx * oax + dy * oay + dz * oaz
    m5 = oax * oax + oay * oay + oaz * oaz
    ra_b = ra[None, :]
    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra_b
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * ra_b - d2 * ra_b * ra_b
    h = k1 * k1 - k0 * k2
    safe_k2 = jnp.where(jnp.abs(k2) > 1e-12, k2, 1e-12)
    t_body = (-jnp.sqrt(jnp.maximum(h, 0.0)) - k1) / safe_k2
    y = m1 + t_body * m2  # axial position * m0
    body_ok = (h > 0.0) & (y > 0.0) & (y < d2)

    # cap spheres at a (radius ra) and b (radius rb)
    def sphere(cx, cy, cz, r):
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        bq = ocx * dx + ocy * dy + ocz * dz
        cq = ocx * ocx + ocy * ocy + ocz * ocz - (r * r)[None, :]
        hq = bq * bq - cq
        tq = -bq - jnp.sqrt(jnp.maximum(hq, 0.0))
        return tq, hq > 0.0

    t_ca, ok_ca = sphere(ax, ay, az, ra)
    t_cb, ok_cb = sphere(b[:, 0][None, :], b[:, 1][None, :], b[:, 2][None, :], rb)

    t_body_m = jnp.where(body_ok, t_body, _BIG)
    t_ca_m = jnp.where(ok_ca, t_ca, _BIG)
    t_cb_m = jnp.where(ok_cb, t_cb, _BIG)
    t = jnp.minimum(t_body_m, jnp.minimum(t_ca_m, t_cb_m))
    in_range = (t > tmin[:, None]) & (t < tmax[:, None])
    hit = (t < _BIG) & in_range
    y_norm = jnp.clip(y / jnp.maximum(d2, 1e-12), 0.0, 1.0)
    y_norm = jnp.where(t == t_ca_m, 0.0, jnp.where(t == t_cb_m, 1.0, y_norm))
    return jnp.where(hit, t, _BIG), y_norm, hit


class CurveHit(NamedTuple):
    t: jnp.ndarray  # [N]
    seg: jnp.ndarray  # [N] i32, -1 miss
    u: jnp.ndarray  # [N] spline parameter


def intersect_curves_closest(
    cones: FlatCones,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    active: Optional[jnp.ndarray] = None,
    block: int = 256,
) -> CurveHit:
    """Closest hit over all cone subsegments (blocked dense sweep).

    origins/directions: Vec3 of [N] (or [N,3], converted)."""
    from strelka_tpu.ops import vec as V
    from strelka_tpu.ops.vec import Vec3

    if not isinstance(origins, Vec3):
        origins = V.from_rows(origins)
    if not isinstance(directions, Vec3):
        directions = V.from_rows(directions)
    n = tmin.shape[0]
    m = cones.a.shape[0]
    if active is None:
        active = jnp.ones(n, bool)
    block = min(block, m)
    num_blocks = (m + block - 1) // block
    pad = num_blocks * block - m
    cn = cones
    if pad:
        zero3 = jnp.zeros((pad, 3), jnp.float32)
        cn = FlatCones(
            a=jnp.concatenate([cn.a, zero3]),
            b=jnp.concatenate([cn.b, zero3 + 1.0]),
            ra=jnp.concatenate([cn.ra, jnp.full(pad, -1.0)]),  # negative radius = never hit
            rb=jnp.concatenate([cn.rb, jnp.full(pad, -1.0)]),
            seg_id=jnp.concatenate([cn.seg_id, jnp.full(pad, -1, jnp.int32)]),
            u0=jnp.concatenate([cn.u0, jnp.zeros(pad)]),
            u1=jnp.concatenate([cn.u1, jnp.zeros(pad)]),
        )

    def body(carry, bi):
        best_t, best_seg, best_u = carry
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, bi * block, block, axis=0)
        t, y, hit = _ray_round_cone(
            origins, directions, sl(cn.a), sl(cn.b), sl(cn.ra), sl(cn.rb), tmin, tmax
        )
        t = jnp.where(hit & active[:, None] & (sl(cn.ra) >= 0.0)[None, :], t, _BIG)
        arg = jnp.argmin(t, axis=1)
        rows = jnp.arange(n)
        t_blk = t[rows, arg]
        better = t_blk < best_t
        u_hit = sl(cn.u0)[arg] + (sl(cn.u1)[arg] - sl(cn.u0)[arg]) * y[rows, arg]
        best_seg = jnp.where(better, sl(cn.seg_id)[arg], best_seg)
        best_u = jnp.where(better, u_hit, best_u)
        best_t = jnp.where(better, t_blk, best_t)
        return (best_t, best_seg, best_u), None

    init = (jnp.full(n, _BIG), jnp.full(n, -1, jnp.int32), jnp.zeros(n))
    (t, seg, u), _ = jax.lax.scan(body, init, jnp.arange(num_blocks))
    return CurveHit(t=t, seg=seg, u=u)


def intersect_curves_any(
    cones: FlatCones,
    origins: jnp.ndarray,
    directions: jnp.ndarray,
    tmin: jnp.ndarray,
    tmax: jnp.ndarray,
    active: Optional[jnp.ndarray] = None,
    block: int = 256,
) -> jnp.ndarray:
    """Occlusion sweep -> [N] bool."""
    hit = intersect_curves_closest(cones, origins, directions, tmin, tmax, active, block)
    return hit.seg >= 0


def curve_shading_frame(curves, seg, u, hit_position):
    """Normal/tangent at a curve hit (fillCurveGeomData semantics, cu:423-454).

    normal = offset from spine point (sphere-like), tangent = spline tangent.
    """
    s = jnp.maximum(seg, 0)
    p0, p1, p2, p3 = curves.p0[s], curves.p1[s], curves.p2[s], curves.p3[s]
    spine = eval_bspline(p0, p1, p2, p3, u)
    tangent = eval_bspline_tangent(p0, p1, p2, p3, u)
    tangent = tangent / jnp.maximum(jnp.linalg.norm(tangent, axis=-1, keepdims=True), 1e-12)
    n = hit_position - spine
    # remove axial component so the normal is perpendicular to the hair fiber
    n = n - jnp.sum(n * tangent, axis=-1, keepdims=True) * tangent
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = jnp.where(norm > 1e-9, n / jnp.maximum(norm, 1e-9), jnp.array([0.0, 0.0, 1.0]))
    binormal = jnp.cross(n, tangent)
    return n, tangent, binormal


def curve_shading_frame_vec(curves, seg, u, hit_position):
    """Vec3 variant of curve_shading_frame (component-major hot path)."""
    from strelka_tpu.ops import vec as V
    from strelka_tpu.ops.vec import Vec3

    s = jnp.maximum(seg, 0)
    b0, b1, b2, b3 = bspline_basis(u)
    d0, d1, d2, d3 = bspline_basis_deriv(u)
    g = lambda t: V.gather_rows(t, s)
    p0, p1, p2, p3 = g(curves.p0), g(curves.p1), g(curves.p2), g(curves.p3)
    spine = p0 * b0 + p1 * b1 + p2 * b2 + p3 * b3
    tangent = V.normalize(p0 * d0 + p1 * d1 + p2 * d2 + p3 * d3, eps=1e-12)
    n = hit_position - spine
    n = n - tangent * V.dot(n, tangent)
    norm = V.length(n)
    ok = norm > 1e-9
    inv = 1.0 / jnp.maximum(norm, 1e-9)
    fallback = V.splat((0.0, 0.0, 1.0), norm.shape)
    n = V.where(ok, n * inv, fallback)
    binormal = V.cross(n, tangent)
    return n, tangent, binormal


def intersect_curves_closest_scene(scene, origins, directions, tmin, tmax,
                                   active=None) -> CurveHit:
    """Closest curve hit of a DeviceScene (the blocked cone sweep)."""
    return intersect_curves_closest(scene.cones, origins, directions, tmin, tmax, active)


def intersect_curves_any_scene(scene, origins, directions, tmin, tmax,
                               active=None) -> jnp.ndarray:
    """Curve occlusion of a DeviceScene (the blocked cone sweep)."""
    return intersect_curves_any(scene.cones, origins, directions, tmin, tmax, active)
