"""Triangle and curve intersection against the float64 numpy reference.

Every case runs through the public dispatch (ops/intersect.py) on both
triangle paths the backend module can choose: the threaded BVH and the
brute-force sweep. Curves run the blocked cone sweep.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from strelka_tpu.ops import reference as R
from strelka_tpu.ops.bvh import ThreadedBvh, build_bvh_sah, thread_bvh
from strelka_tpu.ops.curves import FlatCones, intersect_curves_any, intersect_curves_closest
from strelka_tpu.ops.intersect import intersect_any, intersect_closest
from strelka_tpu.render.device_scene import (
    GEOMETRY_MASK_LIGHT,
    GEOMETRY_MASK_TRIANGLE,
    RAY_MASK_PRIMARY,
    RAY_MASK_SHADOW,
)

PATHS = ("bvh", "bruteforce")


class _Scene:
    """The fields of a DeviceScene that triangle intersection reads; prim
    ids are mapped back to the caller's triangle order."""

    def __init__(self, v0, e1, e2, mask, path):
        n = v0.shape[0]
        self.perm = np.arange(n)
        self.bvh = None
        if path == "bvh":
            nodes, perm = build_bvh_sah(v0, e1, e2)
            self.perm = np.asarray(perm)
            self.bvh = ThreadedBvh(*[jnp.asarray(np.asarray(x)) for x in thread_bvh(nodes)])
        p = self.perm
        self.v0, self.e1, self.e2 = (jnp.asarray(a[p]) for a in (v0, e1, e2))
        self.geom_mask = jnp.asarray(mask[p])
        self.inv = np.empty(n, np.int64)
        self.inv[p] = np.arange(n)

    def to_scene_ids(self, ids):
        """Caller-order triangle ids -> this scene's (reordered) ids."""
        ids = np.asarray(ids)
        return np.where(ids >= 0, self.inv[np.maximum(ids, 0)], -1).astype(np.int32)

    def to_caller_ids(self, prim):
        prim = np.asarray(prim)
        return np.where(prim >= 0, self.perm[np.maximum(prim, 0)], -1)


def _tris(n, rng, spread=10.0, offset=0.0):
    v0 = (rng.uniform(-spread, spread, (n, 3)) + offset).astype(np.float32)
    e1 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    return v0, e1, e2


def _rays(n, rng, spread=12.0, offset=0.0):
    o = (rng.uniform(-spread, spread, (n, 3)) + offset).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _assert_closest(t, prim, t_ref, prim_ref, rtol=1e-4, min_prim=0.99):
    hit, hit_ref = prim >= 0, prim_ref >= 0
    np.testing.assert_array_equal(hit, hit_ref)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=rtol)
    if hit.any():  # same primitive unless a coplanar/edge tie
        assert (prim[hit] == prim_ref[hit]).mean() >= min_prim


def _run_closest(sc, o, d, tmin, tmax, ray_mask=RAY_MASK_PRIMARY, active=None, exclude=None):
    hit = intersect_closest(
        sc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin, jnp.float32),
        jnp.asarray(tmax, jnp.float32), ray_mask,
        active=None if active is None else jnp.asarray(active),
        exclude=None if exclude is None else jnp.asarray(sc.to_scene_ids(exclude)),
    )
    return np.asarray(hit.t), sc.to_caller_ids(hit.prim)


def _run_any(sc, o, d, tmin, tmax, ray_mask=RAY_MASK_SHADOW, active=None, exclude=None):
    return np.asarray(intersect_any(
        sc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin, jnp.float32),
        jnp.asarray(tmax, jnp.float32), ray_mask,
        active=None if active is None else jnp.asarray(active),
        exclude=None if exclude is None else jnp.asarray(sc.to_scene_ids(exclude)),
    ))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("ntri,nray", [(100, 700), (1000, 300), (5000, 2000)])
def test_closest_matches_reference(ntri, nray, path):
    rng = np.random.default_rng(ntri + nray)
    v0, e1, e2 = _tris(ntri, rng)
    o, d = _rays(nray, rng)
    sc = _Scene(v0, e1, e2, np.ones(ntri, np.int32), path)
    tmin, tmax = np.zeros(nray), np.full(nray, 1e16)
    t, prim = _run_closest(sc, o, d, tmin, tmax)
    t_ref, p_ref = R.ray_triangles(o, d, v0, e1, e2, tmin, tmax)
    _assert_closest(t, prim, t_ref, p_ref)


@pytest.mark.parametrize("path", PATHS)
def test_any_hit_matches_reference(path):
    rng = np.random.default_rng(7)
    v0, e1, e2 = _tris(800, rng)
    mask = np.full(800, GEOMETRY_MASK_TRIANGLE, np.int32)
    mask[::3] = GEOMETRY_MASK_LIGHT  # light proxies: invisible to shadow rays
    o, d = _rays(600, rng)
    tmin, tmax = np.zeros(600), rng.uniform(0.0, 30.0, 600)
    sc = _Scene(v0, e1, e2, mask, path)
    occ = _run_any(sc, o, d, tmin, tmax)
    occ_ref, _ = R.ray_triangles(o, d, v0, e1, e2, tmin, tmax, tri_mask=mask,
                                 ray_mask=RAY_MASK_SHADOW, any_hit=True)
    np.testing.assert_array_equal(occ, occ_ref)
    assert 0 < occ.sum() < occ.size


@pytest.mark.parametrize("path", PATHS)
def test_ray_mask_filtering(path):
    """Primary rays see light proxies; shadow rays do not."""
    rng = np.random.default_rng(3)
    v0, e1, e2 = _tris(600, rng)
    mask = np.where(rng.uniform(size=600) < 0.5, GEOMETRY_MASK_LIGHT,
                    GEOMETRY_MASK_TRIANGLE).astype(np.int32)
    o, d = _rays(500, rng)
    tmin, tmax = np.zeros(500), np.full(500, 1e16)
    sc = _Scene(v0, e1, e2, mask, path)
    for ray_mask in (RAY_MASK_PRIMARY, RAY_MASK_SHADOW):
        t, prim = _run_closest(sc, o, d, tmin, tmax, ray_mask=ray_mask)
        t_ref, p_ref = R.ray_triangles(o, d, v0, e1, e2, tmin, tmax, tri_mask=mask,
                                       ray_mask=ray_mask)
        _assert_closest(t, prim, t_ref, p_ref)
    _, prim = _run_closest(sc, o, d, tmin, tmax, ray_mask=RAY_MASK_SHADOW)
    assert (mask[prim[prim >= 0]] == GEOMETRY_MASK_TRIANGLE).all()


@pytest.mark.parametrize("path", PATHS)
def test_exclude_prim(path):
    """The excluded primitive is rejected by id; the next one is found."""
    rng = np.random.default_rng(11)
    v0, e1, e2 = _tris(400, rng, spread=4.0)
    o, d = _rays(400, rng, spread=5.0)
    tmin, tmax = np.zeros(400), np.full(400, 1e16)
    sc = _Scene(v0, e1, e2, np.ones(400, np.int32), path)
    _, first = _run_closest(sc, o, d, tmin, tmax)
    assert (first >= 0).sum() > 50
    excl = first.copy()
    t, prim = _run_closest(sc, o, d, tmin, tmax, exclude=excl)
    t_ref, p_ref = R.ray_triangles(o, d, v0, e1, e2, tmin, tmax, exclude=excl)
    assert not np.any((prim == excl) & (excl >= 0))
    _assert_closest(t, prim, t_ref, p_ref)


@pytest.mark.parametrize("path", PATHS)
def test_exclude_prim_shadow_semantics(path):
    """A shadow ray leaving a triangle toward a light is not occluded by
    the triangle it starts on, but is by a blocker in between."""
    v0 = np.array([[-1, 0, -1], [-1, 1, -1]], np.float32)  # floor y=0, blocker y=1
    e1 = np.array([[2, 0, 0], [2, 0, 0]], np.float32)
    e2 = np.array([[0, 0, 2], [0, 0, 2]], np.float32)
    v0 = np.concatenate([v0, np.full((60, 3), 50.0, np.float32)])  # far filler
    e1 = np.concatenate([e1, np.tile([[1, 0, 0]], (60, 1)).astype(np.float32)])
    e2 = np.concatenate([e2, np.tile([[0, 1, 0]], (60, 1)).astype(np.float32)])
    n_tri = v0.shape[0]
    sc = _Scene(v0, e1, e2, np.ones(n_tri, np.int32), path)
    o = np.array([[-0.5, 0.0, -0.5], [-0.5, 0.0, -0.5]], np.float32)  # on the floor
    d = np.array([[0, 1, 0], [0, -1, 0]], np.float32)
    excl = np.array([0, 0])
    occ = _run_any(sc, o, d, np.zeros(2), np.array([5.0, 5.0]), exclude=excl)
    np.testing.assert_array_equal(occ, [True, False])  # blocker above, nothing below
    occ_short = _run_any(sc, o, d, np.zeros(2), np.array([0.5, 0.5]), exclude=excl)
    np.testing.assert_array_equal(occ_short, [False, False])  # light below the blocker


@pytest.mark.parametrize("path", PATHS)
def test_world_scale_coordinates(path):
    """Geometry and rays offset by 1e4: f32 keeps hits within 1e-4 relative."""
    rng = np.random.default_rng(5)
    v0, e1, e2 = _tris(500, rng, offset=1e4)
    o, d = _rays(500, rng, offset=1e4)
    tmin, tmax = np.zeros(500), np.full(500, 1e16)
    sc = _Scene(v0, e1, e2, np.ones(500, np.int32), path)
    t, prim = _run_closest(sc, o, d, tmin, tmax)
    t_ref, p_ref = R.ray_triangles(o, d, v0, e1, e2, tmin, tmax)
    hit, hit_ref = prim >= 0, p_ref >= 0
    assert (hit == hit_ref).mean() >= 0.99  # grazing hits may flip at this scale
    both = hit & hit_ref & (prim == p_ref)
    assert both.sum() > 20
    np.testing.assert_allclose(t[both], t_ref[both], rtol=1e-3)


@pytest.mark.parametrize("path", PATHS)
def test_inactive_lanes(path):
    rng = np.random.default_rng(9)
    v0, e1, e2 = _tris(300, rng, spread=3.0)
    o, d = _rays(256, rng, spread=4.0)
    active = rng.uniform(size=256) < 0.5
    tmin, tmax = np.zeros(256), np.full(256, 1e16)
    sc = _Scene(v0, e1, e2, np.ones(300, np.int32), path)
    t, prim = _run_closest(sc, o, d, tmin, tmax, active=active)
    t_ref, p_ref = R.ray_triangles(o, d, v0, e1, e2, tmin, tmax, active=active)
    _assert_closest(t, prim, t_ref, p_ref)
    assert (prim[~active] == -1).all()
    occ = _run_any(sc, o, d, tmin, tmax, ray_mask=RAY_MASK_PRIMARY, active=active)
    assert not occ[~active].any()
    assert occ[active].any()


@pytest.mark.parametrize("path", PATHS)
def test_tmin_tmax_bounds(path):
    """Only hits with tmin < t < tmax count, for closest and any."""
    rng = np.random.default_rng(13)
    v0, e1, e2 = _tris(500, rng, spread=4.0)
    o, d = _rays(512, rng, spread=5.0)
    tmin = rng.uniform(0.0, 3.0, 512)
    tmax = tmin + rng.uniform(0.0, 6.0, 512)
    sc = _Scene(v0, e1, e2, np.ones(500, np.int32), path)
    t, prim = _run_closest(sc, o, d, tmin, tmax)
    t_ref, p_ref = R.ray_triangles(o, d, v0, e1, e2, tmin, tmax)
    _assert_closest(t, prim, t_ref, p_ref)
    hit = prim >= 0
    assert ((t[hit] > tmin[hit]) & (t[hit] < tmax[hit])).all()
    occ = _run_any(sc, o, d, tmin, tmax, ray_mask=RAY_MASK_PRIMARY)
    np.testing.assert_array_equal(occ, p_ref >= 0)


@pytest.mark.parametrize("path", PATHS)
def test_degenerate_triangles_never_hit(path):
    rng = np.random.default_rng(17)
    v0, e1, e2 = _tris(1200, rng, spread=4.0)
    e2[::2] = e1[::2] * 0.5  # collinear edges: zero area
    e1[1::4] = 0.0  # a collapsed edge
    o, d = _rays(512, rng, spread=5.0)
    tmin, tmax = np.zeros(512), np.full(512, 1e16)
    sc = _Scene(v0, e1, e2, np.ones(1200, np.int32), path)
    t, prim = _run_closest(sc, o, d, tmin, tmax)
    t_ref, p_ref = R.ray_triangles(o, d, v0, e1, e2, tmin, tmax)
    _assert_closest(t, prim, t_ref, p_ref)
    degenerate = np.zeros(1200, bool)
    degenerate[::2] = True
    degenerate[1::4] = True
    assert not degenerate[prim[prim >= 0]].any()


@pytest.mark.parametrize("path", PATHS)
def test_axis_parallel_rays(path):
    """Rays along +-x/y/z (zero direction components: the slab test's
    1/d must not produce NaN) against an axis-aligned box of quads."""
    rng = np.random.default_rng(19)
    v0, e1, e2 = _tris(1500, rng, spread=3.0)
    axes = np.eye(3, dtype=np.float32)
    d = np.concatenate([axes, -axes] * 100)
    o = rng.uniform(-3.5, 3.5, (d.shape[0], 3)).astype(np.float32)
    tmin, tmax = np.zeros(d.shape[0]), np.full(d.shape[0], 1e16)
    sc = _Scene(v0, e1, e2, np.ones(1500, np.int32), path)
    t, prim = _run_closest(sc, o, d, tmin, tmax)
    t_ref, p_ref = R.ray_triangles(o, d, v0, e1, e2, tmin, tmax)
    _assert_closest(t, prim, t_ref, p_ref)
    assert (prim >= 0).sum() > 50


# ---- curves -------------------------------------------------------------------


def _cones(m, rng, pad_negative=0):
    a = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.5, (m, 3)).astype(np.float32)
    ra = rng.uniform(0.02, 0.2, m).astype(np.float32)
    rb = rng.uniform(0.02, 0.2, m).astype(np.float32)
    if pad_negative:
        ra[-pad_negative:] = -1.0
        rb[-pad_negative:] = -1.0
    return FlatCones(
        a=jnp.asarray(a), b=jnp.asarray(b), ra=jnp.asarray(ra), rb=jnp.asarray(rb),
        seg_id=jnp.arange(m, dtype=jnp.int32),
        u0=jnp.zeros(m, jnp.float32), u1=jnp.ones(m, jnp.float32),
    )


def _cone_ref(cones, o, d, tmin, tmax):
    return R.ray_round_cones(o, d, *(np.asarray(x) for x in cones[:4]), tmin, tmax)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cone_sweep_closest_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    cones = _cones(700, rng)  # not a block multiple: exercises the padding
    o, d = _rays(600, rng, spread=6.0)
    tmin, tmax = np.zeros(600, np.float32), np.full(600, 1e16, np.float32)
    hit = intersect_curves_closest(cones, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmin), jnp.asarray(tmax))
    t_ref, c_ref, y_ref = _cone_ref(cones, o, d, tmin, tmax)
    seg = np.asarray(hit.seg)
    np.testing.assert_array_equal(seg >= 0, c_ref >= 0)
    h = c_ref >= 0
    assert h.sum() > 10
    assert (seg[h] == c_ref[h]).mean() >= 0.99
    same = h & (seg == c_ref)
    np.testing.assert_allclose(np.asarray(hit.t)[same], t_ref[same], rtol=1e-3)
    np.testing.assert_allclose(np.asarray(hit.u)[same], y_ref[same], atol=5e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cone_sweep_any_matches_reference(seed):
    rng = np.random.default_rng(200 + seed)
    cones = _cones(520, rng)
    o, d = _rays(600, rng, spread=6.0)
    tmin = np.zeros(600, np.float32)
    tmax = rng.uniform(0.0, 8.0, 600).astype(np.float32)
    active = rng.uniform(size=600) < 0.8
    occ = np.asarray(intersect_curves_any(cones, jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(tmin), jnp.asarray(tmax),
                                          active=jnp.asarray(active)))
    t_ref, c_ref, _ = _cone_ref(cones, o, d, tmin, tmax)
    np.testing.assert_array_equal(occ, (c_ref >= 0) & active)


def test_cone_negative_radius_padding_never_hits():
    """Padded cones carry a negative radius and are never hit, even when a
    ray passes straight through their axis."""
    rng = np.random.default_rng(5)
    cones = _cones(300, rng, pad_negative=44)
    a = np.asarray(cones.a)[-44:]
    b = np.asarray(cones.b)[-44:]
    mid = 0.5 * (a + b)
    o = (mid + np.array([0.0, 0.0, 20.0], np.float32)).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (44, 1))
    tmin, tmax = np.zeros(44, np.float32), np.full(44, 1e16, np.float32)
    hit = intersect_curves_closest(cones, jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(tmin), jnp.asarray(tmax))
    seg = np.asarray(hit.seg)
    assert not np.isin(seg, np.arange(256, 300)).any()
    _, c_ref, _ = _cone_ref(cones, o, d, tmin, tmax)
    np.testing.assert_array_equal(seg >= 0, c_ref >= 0)
