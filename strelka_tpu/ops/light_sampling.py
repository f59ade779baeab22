"""Light sampling library — vectorized port of include/render/Lights.h.

Light types: 0 rect, 1 disc, 2 sphere, 3 distant. All vectors are
component-major Vec3 (see ops/vec.py). Per-ray gathered light parameters:
four corner Vec3s (p0..p3), color/normal Vec3, type [N], half_angle [N].
Branches become masked selects — every ray computes every light-type formula
(4 cheap closed forms) and picks by type, the divergence-free analog of
the reference's switch (Lights.h:245-362).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from strelka_tpu.ops import vec as V
from strelka_tpu.ops.vec import Vec3

M_PI = 3.14159265358979323846


class LightParams(NamedTuple):
    """Per-ray gathered UniformLight fields (Lights.h:5-14)."""

    p0: Vec3
    p1: Vec3
    p2: Vec3
    p3: Vec3
    color: Vec3
    normal: Vec3
    type: jnp.ndarray  # [N] int32
    half_angle: jnp.ndarray  # [N]
    radius: jnp.ndarray  # [N] == points[0].x for disc/sphere


class LightSampleData(NamedTuple):
    """Lights.h:16-26."""

    point_on_light: Vec3
    pdf: jnp.ndarray
    normal: Vec3
    area: jnp.ndarray
    L: Vec3
    dist_to_light: jnp.ndarray


def mis_weight_balance(a, b):
    """Lights.h:28-31 (note: NOT guarded against a==0; callers guard)."""
    return 1.0 / (1.0 + b / a)


def calc_light_area(lp: LightParams):
    """Lights.h:33-52."""
    e1 = lp.p1 - lp.p0
    e2 = lp.p3 - lp.p0
    rect_area = V.length(V.cross(e1, e2))
    disc_area = M_PI * lp.radius * lp.radius
    sphere_area = 4.0 * M_PI * lp.radius * lp.radius
    return jnp.where(
        lp.type == 0,
        rect_area,
        jnp.where(lp.type == 1, disc_area, jnp.where(lp.type == 2, sphere_area, 0.0)),
    )


def calc_light_normal(lp: LightParams, hit_point: Vec3) -> Vec3:
    """Lights.h:54-74."""
    e1 = lp.p1 - lp.p0
    e2 = lp.p3 - lp.p0
    rect_n = -V.normalize(V.cross(e1, e2))
    sphere_n = V.normalize(hit_point - lp.p1)
    zero = V.full(lp.type.shape, 0.0)
    return V.where(
        lp.type == 0,
        rect_n,
        V.where(lp.type == 1, lp.normal, V.where(lp.type == 2, sphere_n, zero)),
    )


class SphQuad(NamedTuple):
    """Urena spherical rectangle precomputation (Lights.h:86-161)."""

    o: Vec3
    x: Vec3
    y: Vec3
    z: Vec3
    z0: jnp.ndarray
    z0sq: jnp.ndarray
    x0: jnp.ndarray
    y0: jnp.ndarray
    y0sq: jnp.ndarray
    x1: jnp.ndarray
    y1: jnp.ndarray
    y1sq: jnp.ndarray
    b0: jnp.ndarray
    b1: jnp.ndarray
    b0sq: jnp.ndarray
    k: jnp.ndarray
    S: jnp.ndarray


def sph_quad_init(lp: LightParams, o: Vec3) -> SphQuad:
    """Lights.h:97-161."""
    ex = lp.p1 - lp.p0
    ey = lp.p3 - lp.p0
    s = lp.p0
    exl = V.length(ex)
    eyl = V.length(ey)
    x = ex * (1.0 / jnp.maximum(exl, 1e-20))
    y = ey * (1.0 / jnp.maximum(eyl, 1e-20))
    z = V.cross(x, y)
    d = s - o
    z0 = V.dot(d, z)
    flip = z0 > 0
    z = V.where(flip, -z, z)
    z0 = jnp.where(flip, -z0, z0)
    x0 = V.dot(d, x)
    y0 = V.dot(d, y)
    x1 = x0 + exl
    y1 = y0 + eyl
    v00 = Vec3(x0, y0, z0)
    v01 = Vec3(x0, y1, z0)
    v10 = Vec3(x1, y0, z0)
    v11 = Vec3(x1, y1, z0)
    n0 = V.normalize(V.cross(v00, v10))
    n1 = V.normalize(V.cross(v10, v11))
    n2 = V.normalize(V.cross(v11, v01))
    n3 = V.normalize(V.cross(v01, v00))
    g0 = jnp.arccos(jnp.clip(-V.dot(n0, n1), -1.0, 1.0))
    g1 = jnp.arccos(jnp.clip(-V.dot(n1, n2), -1.0, 1.0))
    g2 = jnp.arccos(jnp.clip(-V.dot(n2, n3), -1.0, 1.0))
    g3 = jnp.arccos(jnp.clip(-V.dot(n3, n0), -1.0, 1.0))
    b0 = n0.z
    b1 = n2.z
    k = 2.0 * M_PI - g2 - g3
    s_solid = g0 + g1 - k
    return SphQuad(o, x, y, z, z0, z0 * z0, x0, y0, y0 * y0, x1, y1, y1 * y1, b0, b1, b0 * b0, k, s_solid)


def sph_quad_sample(q: SphQuad, u, v) -> Vec3:
    """Lights.h:163-189."""
    au = u * q.S + q.k
    sin_au = jnp.sin(au)
    fu = (jnp.cos(au) * q.b0 - q.b1) / jnp.where(jnp.abs(sin_au) > 1e-20, sin_au, 1e-20)
    cu = 1.0 / jnp.sqrt(fu * fu + q.b0sq) * jnp.where(fu > 0.0, 1.0, -1.0)
    cu = jnp.clip(cu, -1.0, 1.0)
    xu = -(cu * q.z0) / jnp.sqrt(jnp.maximum(1.0 - cu * cu, 1e-20))
    xu = jnp.clip(xu, q.x0, q.x1)
    d = jnp.sqrt(xu * xu + q.z0sq)
    h0 = q.y0 / jnp.sqrt(d * d + q.y0sq)
    h1 = q.y1 / jnp.sqrt(d * d + q.y1sq)
    hv = h0 + v * (h1 - h0)
    hv2 = hv * hv
    yv = jnp.where(hv < 1.0 - 1e-5, (hv * d) / jnp.sqrt(jnp.maximum(1.0 - hv2, 1e-20)), q.y1)
    return q.o + q.x * xu + q.y * yv + q.z * q.z0


def _fill_light_data(lp: LightParams, hit_point: Vec3, point_on_light: Vec3):
    """Lights.h:76-84."""
    area = calc_light_area(lp)
    n = calc_light_normal(lp, hit_point)
    to_light = point_on_light - hit_point
    dist = V.length(to_light)
    L = to_light * (1.0 / jnp.maximum(dist, 1e-20))
    return area, n, L, dist


def sample_rect_light_uniform(lp: LightParams, u, v, hit_point: Vec3) -> LightSampleData:
    """Lights.h:277-289: uniform area sample + area->solid-angle pdf."""
    e1 = lp.p1 - lp.p0
    e2 = lp.p3 - lp.p0
    pol = lp.p0 + e1 * u + e2 * v
    area, n, L, dist = _fill_light_data(lp, hit_point, pol)
    pdf = dist * dist / (-V.dot(L, n) * area)
    return LightSampleData(pol, pdf, n, area, L, dist)


def sample_rect_light_sphquad(lp: LightParams, u, v, hit_point: Vec3) -> LightSampleData:
    """Lights.h:245-275: Urena solid-angle sampling with small-S fallbacks."""
    q = sph_quad_init(lp, hit_point)
    uni = sample_rect_light_uniform(lp, u, v, hit_point)
    pol = sph_quad_sample(q, u, v)
    area, n, L, dist = _fill_light_data(lp, hit_point, pol)
    use_sph = q.S >= 1e-3
    out = LightSampleData(
        point_on_light=V.where(use_sph, pol, uni.point_on_light),
        pdf=jnp.where(use_sph, 1.0 / jnp.maximum(q.S, 1e-20), uni.pdf),
        normal=V.where(use_sph, n, uni.normal),
        area=jnp.where(use_sph, area, uni.area),
        L=V.where(use_sph, L, uni.L),
        dist_to_light=jnp.where(use_sph, dist, uni.dist_to_light),
    )
    return out._replace(pdf=jnp.where(q.S <= 0.0, 0.0, out.pdf))


def sample_sphere_light(lp: LightParams, u, v, hit_point: Vec3) -> LightSampleData:
    """Visible-cap solid-angle sampling of a sphere light.

    DELIBERATE deviation from the reference: Lights.h:335-362 samples a
    uniform point on the sphere SURFACE but reports pdf = 1/4pi as if it
    were a solid-angle density — radiometrically wrong (a plane point under
    a small sphere light comes out ~30x hot; caught by
    tests/test_radiometric_oracle.py::test_sphere_light_inverse_square).
    We instead sample the cone of directions subtending the sphere
    (cos_a = sqrt(1 - (r/d)^2)) with the exact pdf 1/(2pi(1-cos_a)), which
    is both correct and lower-variance (no wasted back-half samples).
    Shading points inside the sphere get pdf 0 (NEE disabled; BSDF
    sampling covers that case)."""
    c = lp.p1 - hit_point
    d = V.length(c)
    d_safe = jnp.maximum(d, 1e-20)
    axis = c * (1.0 / d_safe)
    sin_a = jnp.clip(lp.radius / d_safe, 0.0, 1.0)
    cos_a = jnp.sqrt(jnp.maximum(1.0 - sin_a * sin_a, 0.0))
    # 1-cos_a computed stably as sin^2/(1+cos): the naive difference loses
    # all bits for small/distant lights (underflows to 0 at d/r ~ 1e4,
    # blowing the pdf up unboundedly and collapsing NEE+MIS to black)
    one_minus_cos = sin_a * sin_a / (1.0 + cos_a)
    # cone sample around the center direction (solid-angle uniform)
    phi = 2.0 * M_PI * u
    cos_t = 1.0 - v * one_minus_cos
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    tu, tv = create_coordinate_system(axis)
    L = V.normalize(tu * (jnp.cos(phi) * sin_t) + tv * (jnp.sin(phi) * sin_t) + axis * cos_t)
    # nearest ray-sphere intersection along L is the sampled surface point
    disc = jnp.maximum(lp.radius * lp.radius - d * d * sin_t * sin_t, 0.0)
    dist = jnp.maximum(d * cos_t - jnp.sqrt(disc), 0.0)
    light_point = hit_point + L * dist
    normal = V.normalize(light_point - lp.p1)
    outside = d > lp.radius
    pdf = jnp.where(outside, 1.0 / (2.0 * M_PI * jnp.maximum(one_minus_cos, 1e-12)), 0.0)
    return LightSampleData(light_point, pdf, normal, jnp.zeros_like(pdf), L, dist)


def create_coordinate_system(n: Vec3):
    """Lights.h:291-300."""
    use_x = jnp.abs(n.x) > jnp.abs(n.y)
    inv_len_x = 1.0 / jnp.sqrt(n.x * n.x + n.z * n.z + 1e-20)
    inv_len_y = 1.0 / jnp.sqrt(n.y * n.y + n.z * n.z + 1e-20)
    nt = Vec3(
        jnp.where(use_x, -n.z * inv_len_x, 0.0),
        jnp.where(use_x, 0.0, n.z * inv_len_y),
        jnp.where(use_x, n.x * inv_len_x, -n.y * inv_len_y),
    )
    nb = V.cross(n, nt)
    return nt, nb


def sample_cone(u, v, angle, direction: Vec3):
    """Lights.h:302-317."""
    phi = 2.0 * M_PI * u
    cos_theta = 1.0 - v * (1.0 - jnp.cos(angle))
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    tu, tv = create_coordinate_system(direction)
    d = V.normalize(tu * (jnp.cos(phi) * sin_theta) + tv * (jnp.sin(phi) * sin_theta) + direction * cos_theta)
    pdf = 1.0 / (2.0 * M_PI * (1.0 - jnp.cos(angle)))
    return d, pdf


def sample_distant_light(lp: LightParams, u, v) -> LightSampleData:
    """Lights.h:319-333."""
    cone, pdf = sample_cone(u, v, lp.half_angle, -lp.normal)
    return LightSampleData(
        point_on_light=cone,
        pdf=pdf,
        normal=lp.normal,
        area=jnp.zeros_like(pdf),
        L=cone,
        dist_to_light=jnp.full(u.shape, 1e9),
    )


def sample_light(lp: LightParams, u, v, hit_point: Vec3, rect_sampling_method: int) -> LightSampleData:
    """Type dispatch (closest-hit sampleLight, cu:260-310) as masked selects.

    Disc lights (type 1) are not sampled by the reference either (case 1
    commented out, cu:281-283) -> pdf 0.
    """
    if rect_sampling_method == 0:
        rect = sample_rect_light_uniform(lp, u, v, hit_point)
    else:
        rect = sample_rect_light_sphquad(lp, u, v, hit_point)
    sphere = sample_sphere_light(lp, u, v, hit_point)
    distant = sample_distant_light(lp, u, v)
    t = lp.type
    zero = V.full(t.shape, 0.0)

    def sel_v(r, s, d):
        return V.where(t == 0, r, V.where(t == 2, s, V.where(t == 3, d, zero)))

    def sel_s(r, s, d):
        return jnp.where(t == 0, r, jnp.where(t == 2, s, jnp.where(t == 3, d, 0.0)))

    out = LightSampleData(
        point_on_light=sel_v(rect.point_on_light, sphere.point_on_light, distant.point_on_light),
        pdf=sel_s(rect.pdf, sphere.pdf, distant.pdf),
        normal=sel_v(rect.normal, sphere.normal, distant.normal),
        area=sel_s(rect.area, sphere.area, distant.area),
        L=sel_v(rect.L, sphere.L, distant.L),
        dist_to_light=sel_s(rect.dist_to_light, sphere.dist_to_light, distant.dist_to_light),
    )
    return out._replace(pdf=jnp.where(t == 1, 0.0, out.pdf))


def get_light_pdf(lp: LightParams, light_hit_point: Vec3, surface_hit_point: Vec3):
    """Lights.h:221-243 — pdf used for MIS on BSDF-sampled emitter hits.

    NOTE reference quirk kept: rect lights use the UNIFORM area pdf here even
    when NEE sampled with the spherical-quad method (Lights.h:201-209).
    """
    area, n, L, dist = _fill_light_data(lp, surface_hit_point, light_hit_point)
    rect_pdf = dist * dist / (V.dot(-L, n) * area)
    # sphere: cone pdf consistent with sample_sphere_light (NOT the
    # reference's 1/4pi — see the deviation note there)
    dc = V.length(lp.p1 - surface_hit_point)
    sin_a = jnp.clip(lp.radius / jnp.maximum(dc, 1e-20), 0.0, 1.0)
    cos_a = jnp.sqrt(jnp.maximum(1.0 - sin_a * sin_a, 0.0))
    # stable 1-cos (see sample_sphere_light) — MUST match the sampling pdf
    one_minus_cos = sin_a * sin_a / (1.0 + cos_a)
    sphere_pdf = jnp.where(
        dc > lp.radius, 1.0 / (2.0 * M_PI * jnp.maximum(one_minus_cos, 1e-12)), 0.0
    )
    distant_pdf = 1.0 / (2.0 * M_PI * (1.0 - jnp.cos(lp.half_angle)))
    return jnp.where(
        lp.type == 0,
        rect_pdf,
        jnp.where(lp.type == 2, sphere_pdf, jnp.where(lp.type == 3, distant_pdf, 0.0)),
    )
