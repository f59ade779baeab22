"""Wavefront path-tracing integrator — the replacement for the OptiX
megakernel (__raygen__rg, OptixRender.cu:80-248 + __closesthit__radiance,
OptixRender_radiance_closest_hit.cu:456-606).

Control flow is replicated exactly, restructured for SPMD: all W*H*spp rays
advance in lockstep through a statically-unrolled bounce loop; branch
divergence becomes masked selects; each bounce issues one closest-hit sweep
(radiance ray, mask PRIMARY) and one any-hit sweep (NEE shadow ray, mask
SHADOW). All 3-vectors/colors are component-major Vec3 ([N] per component,
ops/vec.py).

Reference quirks intentionally preserved for image parity:
  * NEE radiance includes cos(N,L) AND the MDL-style evaluate() also folds
    cos in — the cosine is squared in next-event contributions (cu:306+586).
  * BSDF-hit emitter MIS uses the uniform-area rect pdf regardless of the
    NEE rect sampling method (Lights.h:221-243).
  * lastBsdfPdf = 1.0 for specular events (cu:602-603).
  * Russian roulette starts after depth 3 with 1/(p+1e-5) boost
    (OptixRender.cu:134-142); throughput cutoff |T|^2 < 1e-5 (:144-147).
  * NaN canary paints radiance (1e4,0,0) (cu:552-558, 573-579).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from strelka_tpu.ops import bsdf as B
from strelka_tpu.ops import light_sampling as LS
from strelka_tpu.ops import sampler as S
from strelka_tpu.ops import vec as V
from strelka_tpu.ops.intersect import (
    Hit,
    intersect_any,
    intersect_closest,
    offset_ray_vec,
)
from strelka_tpu.ops.vec import Vec3
from strelka_tpu.render.device_scene import (
    RAY_MASK_PRIMARY,
    RAY_MASK_SHADOW,
    DeviceScene,
)

Dim = S.SampleDimension


class EventType:
    """OptixRenderParams.h:68-76."""

    eUndef = 0
    eAbsorb = 1
    eDiffuse = 2
    eSpecular = 3


class LaunchParams(NamedTuple):
    """Traced per-launch values (subset of Params, OptixRenderParams.h:38-68).

    Static knobs (depth, spp, debug, ...) are passed to render_launch as
    Python values and baked into the trace, mirroring how the reference
    re-reads settings host-side each frame.
    """

    subframe_index: jnp.ndarray  # i32 scalar — accumulated spp so far
    clip_to_view: jnp.ndarray  # [4,4] f32
    view_to_world: jnp.ndarray  # [4,4] f32
    exposure: jnp.ndarray  # [3] f32
    bg_color: jnp.ndarray  # [3] f32


class FrameState(NamedTuple):
    """Accumulation history, PLANAR layout [3, H, W] (lane-friendly)."""

    accum: jnp.ndarray  # [3,H,W] f32
    diffuse: jnp.ndarray  # [3,H,W] f32
    diffuse_counter: jnp.ndarray  # [H,W] i32 (uint16 in reference)
    specular: jnp.ndarray  # [3,H,W] f32
    specular_counter: jnp.ndarray  # [H,W] i32


def make_frame_state(height: int, width: int) -> FrameState:
    # distinct buffers (donation requires unique buffers per argument)
    z3 = lambda: jnp.zeros((3, height, width), jnp.float32)
    zc = lambda: jnp.zeros((height, width), jnp.int32)
    return FrameState(z3(), z3(), zc(), z3(), zc())


def generate_camera_rays(params: LaunchParams, px, py, jx, jy, width, height):
    """generateCameraRay (OptixRender.cu:38-58)."""
    ndc_x = (px.astype(jnp.float32) + jx) / width * 2.0 - 1.0
    ndc_y = (py.astype(jnp.float32) + jy) / height * 2.0 - 1.0
    c2v = params.clip_to_view
    ones = jnp.ones_like(ndc_x)
    view = Vec3(
        c2v[0, 0] * ndc_x + c2v[0, 1] * ndc_y + c2v[0, 2] + c2v[0, 3],
        c2v[1, 0] * ndc_x + c2v[1, 1] * ndc_y + c2v[1, 2] + c2v[1, 3],
        c2v[2, 0] * ndc_x + c2v[2, 1] * ndc_y + c2v[2, 2] + c2v[2, 3],
    )
    v2w = params.view_to_world
    direction = V.normalize(V.matvec(v2w, view))
    origin = Vec3(v2w[0, 3] * ones, v2w[1, 3] * ones, v2w[2, 3] * ones)
    return origin, direction


def _oct_decode24(code: jnp.ndarray) -> Vec3:
    """[N] f32 of 24-bit (12:12) octahedral codes -> unit Vec3 (the decode
    half of device_scene._oct_encode24; Cigolle et al. clamp-fold form)."""
    qu = jnp.floor(code * (1.0 / 4096.0))
    qv = code - qu * 4096.0
    u = qu * (2.0 / 4094.0) - 1.0
    v = qv * (2.0 / 4094.0) - 1.0
    z = 1.0 - jnp.abs(u) - jnp.abs(v)
    t = jnp.maximum(-z, 0.0)
    x = u + jnp.where(u >= 0.0, -t, t)
    y = v + jnp.where(v >= 0.0, -t, t)
    return V.normalize(Vec3(x, y, z))


def _gather_surface(scene: DeviceScene, hit: Hit, inside):
    """fillTriangleGeomData (cu:365-421): interpolate attributes at the hit.

    ONE fat row-gather from attr_table per hit (instead of one gather per
    attribute). Returns (position, uv, frame, material_id, light_id,
    uv_density_log2, rows).
    """
    prim = jnp.maximum(hit.prim, 0)
    rows = V.gather_rows_t(scene.attr_table, prim)  # [ATTR_JOINED, N]
    wu = hit.u
    wv = hit.v
    w0 = 1.0 - wu - wv
    from strelka_tpu.render.device_scene import ATTR_N, ATTR_T, ATTR_UV, ATTR_MAT, ATTR_LIGHT

    col = lambda a, b=None: rows[a] if b is None else Vec3(rows[a], rows[a + 1], rows[a + 2])
    v0 = col(0, 3)
    e1 = col(3, 3)
    e2 = col(6, 3)
    position = v0 + e1 * wu + e2 * wv
    # normals/tangents ride as 12:12 octahedral 24-bit codes (packed attr
    # layout, device_scene.py — the reference's 10:10:12 packed vertex
    # equivalent)
    n0d, n1d, n2d = (_oct_decode24(rows[ATTR_N + i]) for i in range(3))
    t0d, t1d, t2d = (_oct_decode24(rows[ATTR_T + i]) for i in range(3))
    normal = V.normalize(n0d * w0 + n1d * wu + n2d * wv)
    tangent = V.normalize(t0d * w0 + t1d * wu + t2d * wv)
    uv_u = rows[ATTR_UV + 0] * w0 + rows[ATTR_UV + 2] * wu + rows[ATTR_UV + 4] * wv
    uv_v = rows[ATTR_UV + 1] * w0 + rows[ATTR_UV + 3] * wu + rows[ATTR_UV + 5] * wv
    gcross = V.cross(e1, e2)
    # per-prim UV density for mip selection: log2 sqrt(uv_area / world_area)
    # (both areas share the 1/2 factor, so the parallelogram ratio is exact)
    uv_area2 = jnp.abs(
        (rows[ATTR_UV + 2] - rows[ATTR_UV + 0]) * (rows[ATTR_UV + 5] - rows[ATTR_UV + 1])
        - (rows[ATTR_UV + 4] - rows[ATTR_UV + 0]) * (rows[ATTR_UV + 3] - rows[ATTR_UV + 1])
    )
    world_area2 = V.length(gcross)
    uv_density_log2 = 0.5 * (
        jnp.log2(jnp.maximum(uv_area2, 1e-20)) - jnp.log2(jnp.maximum(world_area2, 1e-20))
    )
    geom_normal = V.normalize(gcross)
    flip = jnp.where(inside, -1.0, 1.0)
    normal = normal * flip
    geom_normal = geom_normal * flip
    binormal = V.cross(normal, tangent)
    frame = B.ShadingFrame(normal=normal, tangent_u=tangent, tangent_v=binormal, geom_normal=geom_normal)
    material_id = rows[ATTR_MAT].astype(jnp.int32)
    light_id = rows[ATTR_LIGHT].astype(jnp.int32)
    return position, (uv_u, uv_v), frame, material_id, light_id, uv_density_log2, rows


def _gather_material(scene: DeviceScene, prim) -> B.SurfaceParams:
    mid = jnp.maximum(scene.material_id[jnp.maximum(prim, 0)], 0)
    return _gather_material_by_id(scene, mid)


def _material_from_rows(rows):
    """SurfaceParams from 24 material rows (a mat_table gather or the
    material columns joined into the attr table)."""
    params = B.SurfaceParams(
        bsdf_type=rows[0].astype(jnp.int32),
        diffuse_color=Vec3(rows[1], rows[2], rows[3]),
        metallic=rows[4],
        roughness=rows[5],
        specular_level=rows[6],
        ior=rows[7],
        glass_color=Vec3(rows[8], rows[9], rows[10]),
        opacity=rows[11],
        emission_color=Vec3(rows[20], rows[21], rows[22]),
        thin_walled=rows[23] > 0.5,
    )
    return params, rows


def _gather_material_by_id(scene: DeviceScene, mid):
    """Returns (SurfaceParams, mat_rows [24, N]) from one fat row-gather."""
    rows = V.gather_rows_t(scene.mat_table, mid)
    return _material_from_rows(rows)


def _select_material(mask, a: B.SurfaceParams, b: B.SurfaceParams) -> B.SurfaceParams:
    return B.SurfaceParams(
        bsdf_type=jnp.where(mask, a.bsdf_type, b.bsdf_type),
        diffuse_color=V.where(mask, a.diffuse_color, b.diffuse_color),
        metallic=jnp.where(mask, a.metallic, b.metallic),
        roughness=jnp.where(mask, a.roughness, b.roughness),
        specular_level=jnp.where(mask, a.specular_level, b.specular_level),
        ior=jnp.where(mask, a.ior, b.ior),
        glass_color=V.where(mask, a.glass_color, b.glass_color),
        opacity=jnp.where(mask, a.opacity, b.opacity),
        emission_color=V.where(mask, a.emission_color, b.emission_color),
        thin_walled=jnp.where(mask, a.thin_walled, b.thin_walled),
    )


def _light_from_rows(rows) -> LS.LightParams:
    """LightParams from 20 light rows (a light_table gather or the light
    columns joined into the attr table)."""
    c3 = lambda a: Vec3(rows[a], rows[a + 1], rows[a + 2])
    return LS.LightParams(
        p0=c3(0),
        p1=c3(3),
        p2=c3(6),
        p3=c3(9),
        color=c3(12),
        normal=c3(15),
        type=rows[18].astype(jnp.int32),
        half_angle=rows[19],
        radius=rows[0],
    )


def _gather_light(scene: DeviceScene, light_id) -> LS.LightParams:
    lid = jnp.clip(light_id, 0, scene.light_table.shape[0] - 1)
    if scene.light_table.shape[0] == 1:
        # single light: broadcast scalars, no gather at all
        n = lid.shape[0]
        rows = [jnp.broadcast_to(scene.light_table[0, c], (n,)) for c in range(20)]
    else:
        rows = V.gather_rows_t(scene.light_table, lid)
    c3 = lambda a: Vec3(rows[a], rows[a + 1], rows[a + 2])
    return LS.LightParams(
        p0=c3(0),
        p1=c3(3),
        p2=c3(6),
        p3=c3(9),
        color=c3(12),
        normal=c3(15),
        type=rows[18].astype(jnp.int32),
        half_angle=rows[19],
        radius=rows[0],
    )


def _apply_textures(
    scene: DeviceScene, mat: B.SurfaceParams, frame: B.ShadingFrame, mat_rows, uv,
    lod_uv=None, tex_rnd=None,
):
    """Texture lookups modulating material params + normal mapping.

    The tex_lookup path of the MDL runtime (texture_support_cuda.h:287-528):
    diffuse texture replaces the constant color, roughness/metallic textures
    override their scalars (R channel), normal map perturbs the frame.
    mat_rows: [N,20] fat material rows (cols 12-15 tex ids, 16-19 uv xform).

    lod_uv: [N] log2 footprint of the sample in UV units (ray-cone estimate);
    when given, lookups are trilinear across the atlas mip chain (the
    hardware-mipmap path of the reference's cudaArray textures). The UV
    transform's scale compresses/stretches the footprint, so its log2 is
    added per-material.

    tex_rnd: callable slot -> 3 x [N] f32 uniforms. When given (the
    integrator's default), every filtered lookup is ONE-texel stochastic
    trilinear (textures.sample_trilinear_stochastic): same expectation as
    the exact filter, 8x fewer per-lane texel gathers.
    """
    from strelka_tpu.textures import (
        sample_bilinear,
        sample_trilinear,
        sample_trilinear_stochastic,
    )

    uv_u, uv_v = uv
    uv_t = jnp.stack(
        [
            uv_u * mat_rows[16] + mat_rows[18],
            uv_v * mat_rows[17] + mat_rows[19],
        ],
        -1,
    )
    if lod_uv is not None:
        uv_scale = jnp.maximum(
            jnp.maximum(jnp.abs(mat_rows[16]), jnp.abs(mat_rows[17])), 1e-8
        )
        lod_t = lod_uv + jnp.log2(uv_scale)
        if tex_rnd is not None:
            slot = [0]

            def tex(tid):
                r3 = tex_rnd(slot[0])
                slot[0] += 1
                return sample_trilinear_stochastic(scene.textures, tid, uv_t, lod_t, r3)
        else:
            tex = lambda tid: sample_trilinear(scene.textures, tid, uv_t, lod_t)
    else:
        tex = lambda tid: sample_bilinear(scene.textures, tid, uv_t)
    d_id = mat_rows[12].astype(jnp.int32)
    diff = tex(d_id)
    mat = mat._replace(
        diffuse_color=V.where(d_id >= 0, V.from_rows(diff[..., :3]), mat.diffuse_color)
    )
    r_id = mat_rows[14].astype(jnp.int32)
    rough = tex(r_id)
    mat = mat._replace(roughness=jnp.where(r_id >= 0, rough[..., 0], mat.roughness))
    mt_id = mat_rows[15].astype(jnp.int32)
    metal = tex(mt_id)
    mat = mat._replace(metallic=jnp.where(mt_id >= 0, metal[..., 0], mat.metallic))
    n_id = mat_rows[13].astype(jnp.int32)
    n_ts = V.from_rows(tex(n_id)[..., :3]) * 2.0 - 1.0
    n_map = V.normalize(
        frame.tangent_u * n_ts.x + frame.tangent_v * n_ts.y + frame.normal * n_ts.z
    )
    new_n = V.where(n_id >= 0, n_map, frame.normal)
    frame = frame._replace(normal=new_n, tangent_v=V.cross(new_n, frame.tangent_u))
    return mat, frame


import functools as _functools


@_functools.lru_cache(maxsize=8)
def _pixel_zorder(width: int, height: int):
    """Static Z-order (Morton) pixel enumeration + its inverse (numpy).

    zorder[k] = linear pixel index of the k-th ray; inv[p] = rank of pixel p.
    Works for arbitrary (non-pow2) sizes via argsort of interleaved coords.
    """
    import numpy as _np

    yy, xx = _np.mgrid[0:height, 0:width].astype(_np.uint64)

    def part1by1(v):
        v &= 0xFFFF
        v = (v | (v << 8)) & _np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & _np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & _np.uint64(0x33333333)
        v = (v | (v << 1)) & _np.uint64(0x55555555)
        return v

    code = (part1by1(xx) | (part1by1(yy) << _np.uint64(1))).ravel()
    zorder = _np.argsort(code, kind="stable").astype(_np.int64)
    inv = _np.empty_like(zorder)
    inv[zorder] = _np.arange(zorder.size, dtype=_np.int64)
    return zorder, inv


def _spread3(v):
    """Spread the low 10 bits of a u32 to every third bit (Morton)."""
    v = (v | (v << 16)) & jnp.uint32(0x030000FF)
    v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
    v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
    v = (v | (v << 2)) & jnp.uint32(0x09249249)
    return v


def _ray_sort_key(scene: DeviceScene, position: Vec3, direction: Vec3):
    """Spatial sort key: 24-bit position Morton (static world bounds) with
    the direction octant in the low 3 bits. Rays sorted by this key are
    neighbours in space and direction, so neighbouring lanes walk similar
    parts of the acceleration structure."""
    lo, hi = scene.world_lo, scene.world_hi

    def q(c, lo_c, hi_c):
        ext = max(hi_c - lo_c, 1e-9)
        x = jnp.clip((c - lo_c) * (1.0 / ext), 0.0, 1.0)
        return (x * 255.0).astype(jnp.uint32)

    mx = _spread3(q(position.x, lo[0], hi[0]))
    my = _spread3(q(position.y, lo[1], hi[1]))
    mz = _spread3(q(position.z, lo[2], hi[2]))
    octant = V.octant(direction).astype(jnp.uint32)
    morton = mx | (my << 1) | (mz << 2)  # 24 bits (8/axis)
    return (morton << 3) | octant


def _sort_wavefront(scene, origin, direction, alive, state_f32, state_bits):
    """Reorder the whole wavefront by spatial key; DEAD lanes get the max key
    so they cluster at the tail — stream compaction without any queue
    machinery."""
    key = _ray_sort_key(scene, origin, direction)
    key = jnp.where(alive, key, jnp.uint32(0xFFFFFFFF))
    perm = jnp.argsort(key)
    return _permute_packed(perm, state_f32, state_bits)


def _permute_packed(perm, f32_cols, bit_cols):
    """Permute many [N] state arrays with ONE [N,F] row-gather + transpose.

    The table is INT32: floats ride as i32 bitcasts (never the reverse — an
    int bitcast to f32 is a subnormal that a flush-to-zero path would
    destroy)."""
    def to_i32(c):
        if c.dtype == jnp.bool_:
            return c.astype(jnp.int32)  # exact 0/1
        if c.dtype in (jnp.int32, jnp.uint32):
            return jax.lax.bitcast_convert_type(c, jnp.int32)
        return jax.lax.bitcast_convert_type(c, jnp.int32)

    cols = [to_i32(c) for c in f32_cols] + [to_i32(c) for c in bit_cols]
    table = jnp.stack(cols, axis=1)  # [N, F] i32
    rows = table[perm].T  # [F, N]
    nf = len(f32_cols)
    out_f32 = [jax.lax.bitcast_convert_type(rows[i], jnp.float32) for i in range(nf)]
    out_bits = []
    for i, c in enumerate(bit_cols):
        r = rows[nf + i]
        if c.dtype == jnp.bool_:
            out_bits.append(r != 0)
        else:
            out_bits.append(jax.lax.bitcast_convert_type(r, c.dtype))
    return out_f32, out_bits


def trace_paths(
    scene: DeviceScene,
    params: LaunchParams,
    sample_idx: jnp.ndarray,  # [N] uint32 sobol sample indices
    origin: Vec3,
    direction: Vec3,
    *,
    max_depth: int,
    rect_light_sampling_method: int,
    shadow_ray_tmin: float,
    material_ray_tmin: float,
    debug: int,
    sort_rays: bool = False,
    cone_spread=None,
    collect_stats: bool = False,
    lane_id=None,
):
    """One path per entry; returns (radiance Vec3, first_event [N]) — plus a
    stats dict (alive closest/shadow ray counts summed over bounces) when
    collect_stats is set (bench honesty: Mrays/s over lanes actually alive,
    not the full masked-SIMD wavefront).

    lane_id: [N] uint32 identity of each path that does not depend on how
    the wavefront is laid out or sharded (render_launch passes the global
    sample/pixel index); it keys the stochastic texture filter. Defaults to
    the lane index.

    cone_spread: traced scalar — the per-pixel ray-cone angle (radians,
    ~2*tan(fov/2)/height). When given, texture lookups become trilinear with
    the mip level chosen from footprint = cone_spread * path_length.

    sort_rays: after the first bounce, reorder the whole wavefront by a
    position-Morton/direction-octant key (one argsort + one packed
    row-gather) so neighbouring lanes stay spatially coherent on secondary
    rays. Off by default. Results are restored to the original ray order
    before returning.
    """
    n = sample_idx.shape[0]
    radiance = V.full(n, 0.0)
    throughput = V.full(n, 1.0)
    inside = jnp.zeros(n, bool)
    specular_bounce = jnp.zeros(n, bool)
    last_bsdf_pdf = jnp.zeros(n, jnp.float32)
    first_event = jnp.zeros(n, jnp.int32)
    alive = jnp.ones(n, bool)
    # primitive the ray originates from: rejected BY ID in the intersector
    # (exact self-intersection guard on top of offset_ray)
    prev_prim = jnp.full(n, -1, jnp.int32)
    num_lights = scene.num_lights
    bg = params.bg_color

    tmin_mat = jnp.full(n, material_ray_tmin, jnp.float32)
    tmax_big = jnp.full(n, 1e16, jnp.float32)
    # ray-cone mip selection state: accumulated path length (footprint =
    # cone_spread * t_total at the hit; Akenine-Möller ray cones, constant
    # spread — good for the primary-visible aliasing mips exist to kill)
    t_total = jnp.zeros(n, jnp.float32)

    # ray_id[i] = the original wavefront slot of lane i (identity unless sorted)
    ray_id = None
    if lane_id is None:
        lane_id = jnp.arange(n, dtype=jnp.uint32)
    stat_closest = jnp.zeros((), jnp.float32)
    stat_shadow = jnp.zeros((), jnp.float32)
    for depth in range(max_depth):
        if sort_rays and depth >= 1:
            if ray_id is None:
                ray_id = jnp.arange(n, dtype=jnp.int32)
            f32s, bits = _sort_wavefront(
                scene, origin, direction, alive,
                [
                    origin.x, origin.y, origin.z,
                    direction.x, direction.y, direction.z,
                    radiance.x, radiance.y, radiance.z,
                    throughput.x, throughput.y, throughput.z,
                    last_bsdf_pdf, t_total,
                ],
                [sample_idx, first_event, prev_prim, inside, specular_bounce, alive, ray_id,
                 lane_id],
            )
            origin = Vec3(*f32s[0:3])
            direction = Vec3(*f32s[3:6])
            radiance = Vec3(*f32s[6:9])
            throughput = Vec3(*f32s[9:12])
            last_bsdf_pdf = f32s[12]
            t_total = f32s[13]
            (sample_idx, first_event, prev_prim, inside, specular_bounce,
             alive, ray_id, lane_id) = bits[:8]

        # One batched draw of the 5 folded Sobol dimensions per bounce
        # (dimension = Dim % 5, RandomSampler.h:224 — e.g. eBSDF2 and
        # eLightId collide on dim 2 in the reference too).
        dim_rows = S.random_dims(sample_idx, depth, (0, 1, 2, 3, 4))
        rnd = lambda dim: dim_rows[int(dim) % 5]

        if collect_stats:
            stat_closest = stat_closest + alive.astype(jnp.float32).sum()
        hit = intersect_closest(
            scene, origin, direction, tmin_mat, tmax_big, RAY_MASK_PRIMARY,
            active=alive, exclude=prev_prim,
        )
        # curve (hair) primitives: blocked round-cone sweep, closest wins
        is_curve = jnp.zeros(n, bool)
        chit = None
        if scene.cones is not None:
            from strelka_tpu.ops.curves import intersect_curves_closest_scene

            chit = intersect_curves_closest_scene(
                scene, origin, direction, tmin_mat, tmax_big, active=alive,
            )
            # exact swept-B-spline refinement of the cone candidate
            # (phantom-style Newton, ops/curve_refine.py): the reference
            # gets the exact envelope from OptiX's builtin
            # ROUND_CUBIC_BSPLINE IS (OptixRender.cpp:554-560); here the
            # cone broad phase seeds per-lane Newton — pure elementwise jnp,
            # fused by XLA into the shade epilogue
            from strelka_tpu.ops.curve_refine import refine_scene_curve_hit

            rt, ru, keep = refine_scene_curve_hit(
                scene.curves, origin, direction, chit.t, chit.seg, chit.u
            )
            # ghosts admitted by the inflated broad-phase radii -> miss
            chit = chit._replace(
                t=jnp.where(keep, rt, jnp.float32(1e30)),
                u=jnp.where(keep, ru, 0.0),
                seg=jnp.where(keep, chit.seg, -1),
            )
            is_curve = alive & (chit.seg >= 0) & (chit.t < hit.t)
        missed = alive & (hit.prim < 0) & ~is_curve

        # __miss__ms (cu:250-257)
        radiance = V.where(
            missed,
            radiance + throughput * Vec3(bg[0], bg[1], bg[2]),
            radiance,
        )
        throughput = V.where(missed, V.full(n, 0.0), throughput)

        position, uv, frame, mat_id, raw_light_id, uv_density_log2, attr_rows = _gather_surface(
            scene, hit, inside
        )
        # material/light rows joined into the attr table ([T, ATTR_JOINED],
        # see device_scene) ride the SAME row gather — no extra fat gathers
        from strelka_tpu.render.device_scene import (
            ATTR_JOINED, ATTR_LIGHT_ROW, ATTR_MAT_ROW,
        )

        joined = scene.attr_table is not None and scene.attr_table.shape[1] >= ATTR_JOINED
        prim_light_id = jnp.where(hit.prim >= 0, raw_light_id, -1)
        hit_light = alive & ~missed & (prim_light_id >= 0) & ~is_curve
        hit_surface = alive & ~missed & ~hit_light

        # ---- __closesthit__light (cu:315-341)
        if num_lights > 0:
            lp = _light_from_rows(attr_rows[ATTR_LIGHT_ROW:ATTR_JOINED]) if joined else _gather_light(scene, prim_light_id)
            hit_point_l = origin + direction * hit.t
            light_n = LS.calc_light_normal(lp, hit_point_l)
            cos_l = -V.dot(direction, light_n)
            direct_vis = (depth == 0) | specular_bounce
            light_pdf_hit = LS.get_light_pdf(lp, hit_point_l, origin) / num_lights
            mis_w = LS.mis_weight_balance(jnp.maximum(last_bsdf_pdf, 1e-20), light_pdf_hit)
            w = cos_l * jnp.where(direct_vis, 1.0, mis_w)
            add = hit_light & (cos_l > 0.0)
            radiance = V.where(add, radiance + throughput * lp.color * w, radiance)
        throughput = V.where(hit_light, V.full(n, 0.0), throughput)

        # ---- __closesthit__radiance (surface shading)
        if joined:
            mat, mat_rows = _material_from_rows(attr_rows[ATTR_MAT_ROW:ATTR_LIGHT_ROW])
        else:
            mat, mat_rows = _gather_material_by_id(scene, jnp.maximum(mat_id, 0))
        # advance the ray cone to this hit (curve hits use the cone t too)
        t_eff = hit.t
        if chit is not None:
            t_eff = jnp.where(is_curve, chit.t, hit.t)
        t_hit = t_total + jnp.where(alive & ~missed, t_eff, 0.0)
        if scene.textures is not None:
            lod_uv = None
            if cone_spread is not None:
                lod_uv = jnp.log2(jnp.maximum(cone_spread * t_hit, 1e-20)) + uv_density_log2
            tex_rnd = None
            if lod_uv is not None:
                # per-lane uniforms for one-texel stochastic filtering:
                # (pixel, sample, bounce, lookup slot)-keyed murmur hashes —
                # decorrelated from the Sobol BSDF/light dims, deterministic
                # across backends (CPU goldens draw the same texels)
                _tex_seed = S.hash_combine(
                    S.hash_u32(sample_idx), lane_id * jnp.uint32(2654435761) + jnp.uint32(depth)
                )

                def tex_rnd(slot, _seed=_tex_seed):
                    h = S.hash_u32(S.hash_combine(_seed, jnp.uint32(slot + 1)))
                    # 3 decorrelated 10/11-bit-plus lanes from one hash are
                    # too short; re-hash per component instead (cheap)
                    h2 = S.hash_u32(h ^ jnp.uint32(0x68BC21EB))
                    h3 = S.hash_u32(h ^ jnp.uint32(0x02E5BE93))
                    to_f = lambda u: (u >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
                    return (to_f(h), to_f(h2), to_f(h3))

            mat, frame = _apply_textures(
                scene, mat, frame, mat_rows, uv, lod_uv=lod_uv, tex_rnd=tex_rnd
            )
        t_total = t_hit
        if chit is not None:
            # fillCurveGeomData (cu:423-454): spine-offset normal, spline tangent
            from strelka_tpu.ops.curves import curve_shading_frame_vec

            pos_curve = origin + direction * chit.t
            cn, ct, cb = curve_shading_frame_vec(scene.curves, chit.seg, chit.u, pos_curve)
            flip = jnp.where(inside, -1.0, 1.0)
            cn = cn * flip
            position = V.where(is_curve, pos_curve, position)
            frame = B.ShadingFrame(
                normal=V.where(is_curve, cn, frame.normal),
                tangent_u=V.where(is_curve, ct, frame.tangent_u),
                tangent_v=V.where(is_curve, V.cross(cn, ct), frame.tangent_v),
                geom_normal=V.where(is_curve, cn, frame.geom_normal),
            )
            cmat, _ = _gather_material_by_id(
                scene, jnp.maximum(scene.curves.material_id[jnp.maximum(chit.seg, 0)], 0)
            )
            mat = _select_material(is_curve, cmat, mat)

        if debug == 1:
            normals_col = (frame.normal + 1.0) * 0.5
            radiance = V.where(hit_surface, normals_col, radiance)
            first_event = jnp.where(hit_surface, EventType.eUndef, first_event)
            break

        # ---- emissive materials (EDF): the reference links per-material MDL
        # emission functions into the hit program (mdlPtxCodeGen.cpp:133-172).
        # Emissive surfaces are NOT in the NEE light list, so the full
        # contribution is added on every BSDF/camera hit (unbiased, no MIS).
        # cutout decision FIRST: a lane that passes through as transparent
        # must not collect emission either (emission would otherwise be
        # overcounted by 1/opacity on emissive+cutout materials)
        u_cut = S.uniform_hash(sample_idx, depth)
        cut = hit_surface & (mat.opacity < 1.0) & (u_cut >= mat.opacity)

        emissive = hit_surface & ~cut & V.any_nonzero(mat.emission_color)
        front = V.dot(frame.geom_normal, direction) < 0.0
        radiance = V.where(
            emissive & front, radiance + throughput * mat.emission_color, radiance
        )

        ior1 = jnp.where(inside, mat.ior, 1.0)
        ior2 = jnp.where(inside, 1.0, mat.ior)
        xi = (rnd(Dim.eBSDF0), rnd(Dim.eBSDF1), rnd(Dim.eBSDF2), rnd(Dim.eBSDF3))
        k1 = -direction
        enable_hair = scene.cones is not None or bool(getattr(scene, "has_hair", False))
        smp = B.bsdf_sample(mat, frame, k1, xi, ior1, ior2, enable_hair=enable_hair)

        # ---- stochastic alpha cutout (opacity < 1): pass straight through as
        # a specular-transmission event without flipping the medium. Maps the
        # reference's alpha-mode -> OmniGlass/enable_opacity handling
        # (gltfloader.cpp:358-421) onto any material's opacity value.
        ones3 = V.full(n, 1.0)
        smp = B.BsdfSample(
            k2=V.where(cut, direction, smp.k2),
            pdf=jnp.where(cut, 0.0, smp.pdf),
            bsdf_over_pdf=V.where(cut, ones3, smp.bsdf_over_pdf),
            event_type=jnp.where(
                cut, B.BSDF_EVENT_SPECULAR_TRANSMISSION, smp.event_type
            ).astype(jnp.int32),
        )

        absorbed = hit_surface & (smp.event_type == B.BSDF_EVENT_ABSORB)
        if depth == 0:
            first_event = jnp.where(absorbed, EventType.eAbsorb, first_event)
            first_event = jnp.where(
                hit_surface & ((smp.event_type & B.BSDF_EVENT_DIFFUSE) != 0),
                EventType.eDiffuse,
                first_event,
            )
            first_event = jnp.where(
                hit_surface & ((smp.event_type & B.BSDF_EVENT_GLOSSY) != 0),
                EventType.eSpecular,
                first_event,
            )
        throughput = V.where(absorbed, V.full(n, 0.0), throughput)
        shade = hit_surface & ~absorbed
        specular_bounce = jnp.where(
            shade, (smp.event_type & B.BSDF_EVENT_SPECULAR) != 0, specular_bounce
        )

        # ---- NEE (estimateDirectLighting, cu:312-324 + sampleLight :260-310)
        if num_lights > 0:
            nee_able = shade & (
                (smp.event_type & (B.BSDF_EVENT_DIFFUSE | B.BSDF_EVENT_GLOSSY)) != 0
            )
            u_l = rnd(Dim.eLightId)
            light_id = jnp.clip((num_lights * u_l).astype(jnp.int32), 0, num_lights - 1)
            lp = _gather_light(scene, light_id)
            ls = LS.sample_light(
                lp,
                rnd(Dim.eLightPointX),
                rnd(Dim.eLightPointY),
                position,
                rect_light_sampling_method,
            )
            to_light = ls.L
            li_all_nonzero = V.all_nonzero(lp.color)
            cos_nl = V.dot(frame.normal, to_light)
            geom_ok = (cos_nl > 0.0) & (-V.dot(to_light, ls.normal) > 0.0) & li_all_nonzero
            shadow_org = offset_ray_vec(position, frame.geom_normal)
            shadow_excl = jnp.where(is_curve, -1, hit.prim)
            if collect_stats:
                stat_shadow = stat_shadow + (nee_able & geom_ok).astype(jnp.float32).sum()
            occluded = intersect_any(
                scene,
                shadow_org,
                to_light,
                jnp.full(n, shadow_ray_tmin, jnp.float32),
                ls.dist_to_light,
                RAY_MASK_SHADOW,
                active=nee_able & geom_ok,
                exclude=shadow_excl,
            )
            if scene.cones is not None:
                from strelka_tpu.ops.curves import intersect_curves_any_scene

                occluded = occluded | intersect_curves_any_scene(
                    scene,
                    shadow_org,
                    to_light,
                    jnp.full(n, shadow_ray_tmin, jnp.float32),
                    ls.dist_to_light,
                    active=nee_able & geom_ok,
                )
            visibility = jnp.where(geom_ok & ~occluded, 1.0, 0.0)
            nee_w = visibility * jnp.clip(cos_nl, 0.0, 1.0)
            nee_radiance = lp.color * nee_w

            # NaN canary #1 (cu:552-558)
            light_pdf = jnp.where(geom_ok, ls.pdf, 0.0) * (1.0 / num_lights)
            nan1 = nee_able & (V.any_nan(nee_radiance) | jnp.isnan(light_pdf))

            next_event_valid = ((cos_nl > 0.0) != inside) & (light_pdf != 0.0) & nee_able
            ev = B.bsdf_evaluate(mat, frame, k1, to_light, enable_hair=enable_hair)
            nan2 = nee_able & (V.any_nan(ev.bsdf_diffuse) | V.any_nan(ev.bsdf_glossy))
            contribute = next_event_valid & (ev.pdf > 0.0) & ~nan1 & ~nan2
            inv_lpdf = 1.0 / jnp.maximum(light_pdf, 1e-20)
            mis_w = LS.mis_weight_balance(jnp.maximum(light_pdf, 1e-20), ev.pdf)
            nee_contrib = throughput * nee_radiance * (inv_lpdf * mis_w) * (
                ev.bsdf_diffuse + ev.bsdf_glossy
            )
            radiance = V.where(contribute, radiance + nee_contrib, radiance)
            # canary: radiance = (1e4, 0, 0), kill
            canary = nan1 | nan2
            radiance = V.where(canary, V.splat((1e4, 0.0, 0.0), n), radiance)
            throughput = V.where(canary, V.full(n, 0.0), throughput)
            shade = shade & ~canary

        # ---- next segment setup (cu:591-605)
        transmission = (smp.event_type & B.BSDF_EVENT_TRANSMISSION) != 0
        offset_n = V.where(transmission, -frame.geom_normal, frame.geom_normal)
        new_origin = offset_ray_vec(position, offset_n)
        origin = V.where(shade, new_origin, origin)
        direction = V.where(shade, smp.k2, direction)
        prev_prim = jnp.where(shade, jnp.where(is_curve, -1, hit.prim), prev_prim)
        # cutout pass-through and thin-walled transmission stay in the same
        # medium; only real refraction through a closed interface flips it
        flips = shade & transmission & ~cut & ~mat.thin_walled
        inside = jnp.where(flips, ~inside, inside)
        last_bsdf_pdf = jnp.where(
            shade,
            jnp.where((smp.event_type & B.BSDF_EVENT_SPECULAR) != 0, 1.0, smp.pdf),
            last_bsdf_pdf,
        )
        throughput = V.where(shade, throughput * smp.bsdf_over_pdf, throughput)

        # ---- Russian roulette (OptixRender.cu:134-147)
        if depth > 3:
            p = V.vmax(throughput)
            kill_rr = rnd(Dim.eRussianRoulette) > p
            throughput = V.where(kill_rr, throughput, throughput * (1.0 / (p + 1e-5)))
            alive = alive & ~kill_rr
        alive = alive & (V.dot(throughput, throughput) >= 1e-5)

    if ray_id is not None:
        # restore original wavefront order: one i32 scatter builds the
        # inverse permutation, then one packed row-gather
        inv = jnp.zeros(n, jnp.int32).at[ray_id].set(jnp.arange(n, dtype=jnp.int32))
        f32s, bits = _permute_packed(
            inv, [radiance.x, radiance.y, radiance.z], [first_event]
        )
        radiance = Vec3(*f32s)
        first_event = bits[0]
    stats = (
        {"closest_rays": stat_closest, "shadow_rays": stat_shadow}
        if collect_stats
        else None
    )
    return radiance, first_event, stats


def render_launch(
    scene: DeviceScene,
    params: LaunchParams,
    state: FrameState,
    *,
    width: int,
    height: int,
    samples_per_launch: int,
    max_sample_count: int,
    max_depth: int,
    enable_accumulation: bool,
    rect_light_sampling_method: int = 0,
    shadow_ray_tmin: float = 0.0,
    material_ray_tmin: float = 0.0,
    debug: int = 0,
    sort_rays: bool = False,
    zorder_pixels: bool = False,
    py_offset=None,
    full_height: int | None = None,
    collect_stats: bool = False,
):
    """__raygen__rg equivalent: run samples_per_launch paths/pixel, update
    the accumulators, and return (new_state, hdr_image [3,H,W]).

    sort_rays / zorder_pixels: wavefront reordering options (Morton re-sort
    of bounce rays, Z-order pixel enumeration); both off by default and
    image-neutral up to float op order.

    Tonemap is applied by the Render host layer (matching the reference's
    separate tonemap kernel dispatch).

    py_offset/full_height: multi-chip row sharding — each shard renders a
    [height, width] horizontal band of a [full_height, width] frame starting
    at global row py_offset (a traced scalar: jax.lax.axis_index inside
    shard_map). Pixel coordinates fed to the Sobol seed and the camera NDC
    stay GLOBAL, so the sharded render equals the single-chip render, while
    every permute (Z-order, wavefront sort) stays shard-local — no per-launch
    cross-chip collectives.
    """
    n = width * height
    spl = 1 if debug == 1 else samples_per_launch

    # All samples of the launch ride ONE wavefront of spl*W*H rays.
    # With zorder_pixels, pixels are enumerated in Z-ORDER so neighbouring
    # lanes form compact square screen blocks instead of thin row strips;
    # results are unsorted once at the end with a packed row-gather.
    zorder = None
    if zorder_pixels:
        zorder, z_inv = _pixel_zorder(width, height)
        px = jnp.tile(jnp.asarray(zorder % width, jnp.uint32), spl)
        py = jnp.tile(jnp.asarray(zorder // width, jnp.uint32), spl)
    else:
        idx = jnp.arange(n, dtype=jnp.uint32)
        px = jnp.tile(idx % jnp.uint32(width), spl)
        py = jnp.tile(idx // jnp.uint32(width), spl)
    if py_offset is not None:
        py = py + jnp.uint32(py_offset)
    fh = height if full_height is None else full_height
    s_of_ray = jnp.repeat(jnp.arange(spl, dtype=jnp.uint32), n)
    sample_index = params.subframe_index.astype(jnp.uint32) + s_of_ray
    sample_idx = S.make_sample_index(px, py, sample_index, max_sample_count)
    # global (sample, pixel) lane identity: equal to the lane index of an
    # unsharded row-major launch, and the same for a pixel on every shard
    lane_id = s_of_ray * jnp.uint32(width * fh) + py * jnp.uint32(width) + px
    jxy = S.random_dims(sample_idx, 0, (Dim.ePixelX, Dim.ePixelY))
    origin, direction = generate_camera_rays(params, px, py, jxy[0], jxy[1], width, fh)
    out = trace_paths(
        scene,
        params,
        sample_idx,
        origin,
        direction,
        max_depth=max_depth,
        rect_light_sampling_method=rect_light_sampling_method,
        shadow_ray_tmin=shadow_ray_tmin,
        material_ray_tmin=material_ray_tmin,
        debug=debug,
        sort_rays=sort_rays,
        # per-pixel cone angle from the projection (clip_to_view[1,1] is
        # tan(fov_y/2)); drives mip selection in texture lookups
        cone_spread=2.0 * jnp.abs(params.clip_to_view[1, 1]) / fh,
        collect_stats=collect_stats,
        lane_id=lane_id,
    )
    radiance, first_event, stats = out
    # [spl*n] components -> [spl, n] -> reduce over samples
    rad = Vec3(*[c.reshape(spl, n) for c in radiance])
    fe = first_event.reshape(spl, n)
    result = Vec3(rad.x.sum(0), rad.y.sum(0), rad.z.sum(0))
    is_d = fe == EventType.eDiffuse
    is_s = fe == EventType.eSpecular
    dsum = Vec3(*[jnp.where(is_d, c, 0.0).sum(0) for c in rad])
    ssum = Vec3(*[jnp.where(is_s, c, 0.0).sum(0) for c in rad])
    dcount = is_d.astype(jnp.int32).sum(0)
    scount = is_s.astype(jnp.int32).sum(0)

    if zorder is not None:
        # restore row-major pixel order (one packed [n, 11] row-gather)
        f32s, bits = _permute_packed(
            jnp.asarray(z_inv, jnp.int32),
            [
                result.x, result.y, result.z,
                dsum.x, dsum.y, dsum.z,
                ssum.x, ssum.y, ssum.z,
            ],
            [dcount, scount],
        )
        result = Vec3(*f32s[0:3])
        dsum = Vec3(*f32s[3:6])
        ssum = Vec3(*f32s[6:9])
        dcount, scount = bits

    # planar [3, H, W] images
    img = lambda v: jnp.stack([v.x, v.y, v.z]).reshape(3, height, width)
    result_img = img(result * (1.0 / spl))
    dcount2 = dcount.reshape(height, width)
    scount2 = scount.reshape(height, width)
    d_mean = img(dsum) / jnp.maximum(dcount2, 1)
    s_mean = img(ssum) / jnp.maximum(scount2, 1)

    exposure = params.exposure.reshape(3, 1, 1)
    sub = params.subframe_index

    # --- diffuse/specular AOV accumulation (OptixRender.cu:157-210)
    prev_d = jnp.where(sub > 0, state.diffuse_counter, 0)
    prev_s = jnp.where(sub > 0, state.specular_counter, 0)
    new_diffuse = jnp.where(
        (dcount2 > 0)[None],
        _accumulate_planar(state.diffuse, d_mean, exposure, prev_d),
        jnp.where(sub == 0, jnp.zeros_like(state.diffuse), state.diffuse),
    )
    new_dcount = jnp.where(dcount2 > 0, prev_d + dcount2, jnp.where(sub == 0, 0, state.diffuse_counter))
    new_specular = jnp.where(
        (scount2 > 0)[None],
        _accumulate_planar(state.specular, s_mean, exposure, prev_s),
        jnp.where(sub == 0, jnp.zeros_like(state.specular), state.specular),
    )
    new_scount = jnp.where(scount2 > 0, prev_s + scount2, jnp.where(sub == 0, 0, state.specular_counter))

    # --- main accumulation (OptixRender.cu:223-247)
    if enable_accumulation and debug == 0:
        new_accum = _accumulate_planar(state.accum, result_img, exposure, sub)
        image = new_accum
    else:
        new_accum = state.accum
        image = result_img

    if debug == 2:
        image = new_diffuse
    elif debug == 3:
        image = jnp.where((new_scount > 0)[None], new_specular, 0.0)

    new_state = FrameState(
        accum=new_accum,
        diffuse=new_diffuse,
        diffuse_counter=new_dcount,
        specular=new_specular,
        specular_counter=new_scount,
    )
    if collect_stats:
        return new_state, image, stats
    return new_state, image


def _accumulate_planar(history, value, exposure, subframe_index):
    """accumulate() on planar [3,H,W] images (OptixRender.cu:60-78 formula)."""
    idx = jnp.asarray(subframe_index)
    if idx.ndim == 0:
        idx = jnp.broadcast_to(idx, history.shape[1:])
    a = (1.0 / (idx.astype(jnp.float32) + 1.0))[None]

    def tm(c):
        c = c * exposure
        return c / (c + 1.0)

    def itm(c):
        return c / (exposure - c * exposure)

    lerped = itm(tm(history) + (tm(value) - tm(history)) * a)
    return jnp.where((idx > 0)[None], lerped, value)
