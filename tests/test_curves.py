"""Curve (hair) intersection tests: B-spline eval, round-cone hits, render."""

import numpy as np
import jax.numpy as jnp
import pytest

from strelka_tpu.ops.curves import (
    CURVE_SUBDIV,
    FlatCones,
    curve_shading_frame,
    eval_bspline,
    eval_bspline_scalar,
    flatten_curves,
    intersect_curves_any,
    intersect_curves_closest,
)
from strelka_tpu.render.device_scene import DeviceCurves


def _straight_curve(radius=0.2):
    """One cubic segment along +x from (0,0,0) to (3,0,0) (uniform spacing)."""
    p = np.array([[-1, 0, 0], [0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    # uniform cubic bspline through collinear points spans x in [~0, ~1]
    w = np.full(4, radius, np.float32)
    return DeviceCurves(
        p0=jnp.asarray(p[0:1]),
        p1=jnp.asarray(p[1:2]),
        p2=jnp.asarray(p[2:3]),
        p3=jnp.asarray(p[3:4]),
        w0=jnp.asarray(w[0:1]),
        w1=jnp.asarray(w[1:2]),
        w2=jnp.asarray(w[2:3]),
        w3=jnp.asarray(w[3:4]),
        material_id=jnp.zeros(1, jnp.int32),
    )


def test_bspline_eval():
    c = _straight_curve()
    # collinear uniform control points: spline is linear in x from 0 to 1
    u = jnp.asarray([0.0, 0.5, 1.0])
    p = np.asarray(eval_bspline(
        jnp.tile(c.p0, (3, 1)), jnp.tile(c.p1, (3, 1)), jnp.tile(c.p2, (3, 1)), jnp.tile(c.p3, (3, 1)), u
    ))
    np.testing.assert_allclose(p[:, 0], [0.0, 0.5, 1.0], atol=1e-6)
    np.testing.assert_allclose(p[:, 1:], 0.0, atol=1e-6)
    r = np.asarray(eval_bspline_scalar(c.w0[0], c.w1[0], c.w2[0], c.w3[0], jnp.asarray(0.3)))
    assert r == pytest.approx(0.2, abs=1e-6)


def test_flatten_and_hit():
    c = _straight_curve(radius=0.2)
    cones = flatten_curves(c)
    assert cones.a.shape[0] == CURVE_SUBDIV
    # ray down -z through the fiber at x=0.5
    o = jnp.asarray([[0.5, 0.0, 5.0], [0.5, 0.0, 5.0], [0.5, 5.0, 5.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1], [0, 1, 0], [0, 0, -1]], jnp.float32)
    hit = intersect_curves_closest(
        cones, o, d, jnp.zeros(3, jnp.float32), jnp.full(3, 1e16, jnp.float32)
    )
    t = np.asarray(hit.t)
    seg = np.asarray(hit.seg)
    assert seg[0] == 0 and t[0] == pytest.approx(5.0 - 0.2, abs=1e-2)
    assert seg[1] == -1  # pointing away
    assert seg[2] == -1  # offset ray misses
    assert np.asarray(hit.u)[0] == pytest.approx(0.5, abs=0.1)
    # occlusion variant agrees
    occ = np.asarray(
        intersect_curves_any(cones, o, d, jnp.zeros(3, jnp.float32), jnp.full(3, 1e16, jnp.float32))
    )
    np.testing.assert_array_equal(occ, [True, False, False])


def test_curve_shading_frame():
    c = _straight_curve(radius=0.2)
    # hit on top of the fiber at x=0.5: normal +z, tangent +x
    pos = jnp.asarray([[0.5, 0.0, 0.2]], jnp.float32)
    n, t, b = curve_shading_frame(c, jnp.zeros(1, jnp.int32), jnp.asarray([0.5]), pos)
    np.testing.assert_allclose(np.asarray(t)[0], [1, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(n)[0], [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(np.asarray(b)[0], np.cross([0, 0, 1.0], [1.0, 0, 0]), atol=1e-5)


def test_radius_taper():
    """Varying control radii: hit distance reflects interpolated radius."""
    p = np.array([[-1, 0, 0], [0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    c = DeviceCurves(
        p0=jnp.asarray(p[0:1]), p1=jnp.asarray(p[1:2]), p2=jnp.asarray(p[2:3]), p3=jnp.asarray(p[3:4]),
        w0=jnp.asarray([0.4]), w1=jnp.asarray([0.4]), w2=jnp.asarray([0.1]), w3=jnp.asarray([0.1]),
        material_id=jnp.zeros(1, jnp.int32),
    )
    cones = flatten_curves(c)
    o = jnp.asarray([[0.1, 0.0, 5.0], [0.9, 0.0, 5.0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1], [0, 0, -1]], jnp.float32)
    hit = intersect_curves_closest(cones, o, d, jnp.zeros(2, jnp.float32), jnp.full(2, 1e16, jnp.float32))
    t = np.asarray(hit.t)
    # radius near u=0.1 is larger than near u=0.9 -> closer hit
    assert t[0] < t[1]


def test_hair_render_end_to_end():
    """Scene with curves renders; curve pixels differ from background."""
    import jax

    from strelka_tpu.ops import integrator as I
    from strelka_tpu.render.device_scene import build_device_scene
    from strelka_tpu.scene.camera import Camera
    from strelka_tpu.scene.scene import CurveType, InstanceType, Scene, UniformLightDesc
    from strelka_tpu.scene.testscenes import _diffuse_material
    from strelka_tpu.utils import math3d as m3

    scene = Scene()
    mat = scene.add_material(_diffuse_material("hair", [0.6, 0.4, 0.2]))
    # a few hair strands across the view
    pts, counts = [], []
    for k in range(5):
        x = -0.5 + 0.25 * k
        pts += [[x, -1.5, 0], [x, -0.5, 0], [x, 0.5, 0], [x, 1.5, 0]]
        counts.append(4)
    cid = scene.create_curve(CurveType.eCubic, counts, np.asarray(pts, np.float32), np.full(20, 0.05, np.float32))
    scene.create_instance(InstanceType.eCurve, cid, mat, m3.identity4())
    scene.create_light(
        UniformLightDesc(type=3, orientation=np.array([0.0, 0.0, 0.0]), half_angle=0.1, intensity=5000.0)
    )
    cam = Camera(name="c", aspect=1.0)
    cam.set_position([0, 0, 4])
    scene.add_camera(cam)

    dev = build_device_scene(scene)
    assert dev.cones is not None
    params = I.LaunchParams(
        subframe_index=jnp.int32(0),
        clip_to_view=jnp.asarray(cam.clip_to_view(), jnp.float32),
        view_to_world=jnp.asarray(cam.view_to_world(), jnp.float32),
        exposure=jnp.asarray([1e-3] * 3),
        bg_color=jnp.asarray([0.0, 0.0, 0.1]),
    )
    state = I.make_frame_state(32, 32)
    _, img = jax.jit(
        lambda s, p, st: I.render_launch(
            s, p, st, width=32, height=32, samples_per_launch=2,
            max_sample_count=4, max_depth=2, enable_accumulation=True,
        )
    )(dev, params, state)
    img = np.asarray(img)  # planar [3, H, W]
    assert not np.isnan(img).any()
    # strands visible: some pixels have red>blue (hair color), bg has blue only
    assert (img[0] > img[2]).any()
    assert (img[2] > img[0]).any()


def _curved_curve(radius=0.15):
    """A genuinely curved cubic (arc bending in +y) for refinement tests."""
    p = np.array(
        [[-1, -0.6, 0], [0, 0, 0], [1, 0.8, 0], [2, 0.1, 0]], np.float32
    )
    w = np.full(4, radius, np.float32)
    return DeviceCurves(
        p0=jnp.asarray(p[0:1]), p1=jnp.asarray(p[1:2]),
        p2=jnp.asarray(p[2:3]), p3=jnp.asarray(p[3:4]),
        w0=jnp.asarray(w[0:1]), w1=jnp.asarray(w[1:2]),
        w2=jnp.asarray(w[2:3]), w3=jnp.asarray(w[3:4]),
        material_id=jnp.zeros(1, jnp.int32),
    )


def _flatten_at(c, subdiv, inflate):
    """flatten_curves at an explicit subdiv with the same inflation rule
    (module CURVE_SUBDIV is load-time; tests build cones directly)."""
    from strelka_tpu.ops.curves import bspline_basis

    us = np.linspace(0.0, 1.0, subdiv + 1, dtype=np.float32)
    p = [np.asarray(getattr(c, f"p{j}"), np.float32) for j in range(4)]
    w = [np.asarray(getattr(c, f"w{j}"), np.float32) for j in range(4)]
    s = p[0].shape[0]
    b = bspline_basis(us)
    pts = sum(b[j][:, None, None] * p[j][None] for j in range(4))
    rads = sum(b[j][:, None] * w[j][None] for j in range(4))
    ra = rads[:-1].reshape(-1)
    rb = rads[1:].reshape(-1)
    if inflate:
        bm = bspline_basis((0.5 * (us[:-1] + us[1:])).astype(np.float32))
        mid_pts = sum(bm[j][:, None, None] * p[j][None] for j in range(4))
        mid_rads = sum(bm[j][:, None] * w[j][None] for j in range(4))
        dev_c = np.linalg.norm(mid_pts - 0.5 * (pts[:-1] + pts[1:]), axis=-1)
        dev_r = np.maximum(mid_rads - 0.5 * (rads[:-1] + rads[1:]), 0.0)
        pad = ((4.0 / 3.0) * (dev_c + dev_r)).reshape(-1)
        ra = ra + pad
        rb = rb + pad
    seg = np.broadcast_to(np.arange(s, dtype=np.int32)[None, :], (subdiv, s))
    return FlatCones(
        a=jnp.asarray(pts[:-1].reshape(-1, 3)),
        b=jnp.asarray(pts[1:].reshape(-1, 3)),
        ra=jnp.asarray(ra), rb=jnp.asarray(rb),
        seg_id=jnp.asarray(seg.reshape(-1)),
        u0=jnp.asarray(np.broadcast_to(us[:-1, None], (subdiv, s)).reshape(-1)),
        u1=jnp.asarray(np.broadcast_to(us[1:, None], (subdiv, s)).reshape(-1)),
    )


def test_refine_recovers_exact_envelope_from_coarse_cones():
    """Newton refinement from inflated subdiv-2 chord cones matches a
    subdiv-128 dense cone sweep (the exact-envelope stand-in) to 1e-3, and
    ghost candidates admitted only by the inflation are rejected
    (VERDICT r4 task 5: cone count 8 -> 2-4 at equal quality)."""
    from strelka_tpu.ops.curve_refine import refine_scene_curve_hit
    from strelka_tpu.ops.vec import Vec3

    c = _curved_curve(radius=0.15)
    coarse = _flatten_at(c, 2, inflate=True)
    fine = _flatten_at(c, 128, inflate=False)

    # rays shooting down -z at the strand's curved mid-span (x in [0.2, 0.8])
    n = 33
    xs = np.linspace(0.05, 0.95, n).astype(np.float32)
    o = np.stack([xs, np.full(n, 0.0, np.float32), np.full(n, 5.0, np.float32)], 1)
    # aim at the local spline height so every ray crosses the strand
    from strelka_tpu.ops.curves import eval_bspline

    spline_y = np.asarray(
        eval_bspline(
            jnp.tile(c.p0, (n, 1)), jnp.tile(c.p1, (n, 1)),
            jnp.tile(c.p2, (n, 1)), jnp.tile(c.p3, (n, 1)), jnp.asarray(xs),
        )
    )[:, 1]
    o[:, 1] = spline_y
    d = np.tile(np.array([[0, 0, -1]], np.float32), (n, 1))
    tmin = jnp.zeros(n, jnp.float32)
    tmax = jnp.full(n, 1e16, jnp.float32)

    hc = intersect_curves_closest(coarse, jnp.asarray(o), jnp.asarray(d), tmin, tmax)
    hf = intersect_curves_closest(fine, jnp.asarray(o), jnp.asarray(d), tmin, tmax)

    ov = Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]), jnp.asarray(o[:, 2]))
    dv = Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]), jnp.asarray(d[:, 2]))
    rt, ru, keep = refine_scene_curve_hit(c, ov, dv, hc.t, hc.seg, hc.u)

    hit_f = np.asarray(hf.seg) >= 0
    hit_c = (np.asarray(hc.seg) >= 0) & np.asarray(keep)
    # the inflated coarse broad phase + refinement finds every true hit
    assert (hit_f & ~hit_c).sum() == 0, "refinement lost true hits"
    both = hit_f & hit_c
    assert both.sum() >= n // 2
    np.testing.assert_allclose(
        np.asarray(rt)[both], np.asarray(hf.t)[both], atol=2e-3, rtol=0
    )

    # ghost rejection: rays that graze PAST the exact envelope but through
    # the inflated cones must not report hits
    o2 = o.copy()
    o2[:, 1] = spline_y + 0.15 * 1.25  # just outside the true radius
    h2 = intersect_curves_closest(coarse, jnp.asarray(o2), jnp.asarray(d), tmin, tmax)
    ov2 = Vec3(jnp.asarray(o2[:, 0]), jnp.asarray(o2[:, 1]), jnp.asarray(o2[:, 2]))
    _, _, keep2 = refine_scene_curve_hit(c, ov2, dv, h2.t, h2.seg, h2.u)
    h2f = intersect_curves_closest(fine, jnp.asarray(o2), jnp.asarray(d), tmin, tmax)
    ghosts = (np.asarray(h2.seg) >= 0) & np.asarray(keep2) & (np.asarray(h2f.seg) < 0)
    assert ghosts.sum() == 0, f"{ghosts.sum()} inflated ghosts survived refinement"
