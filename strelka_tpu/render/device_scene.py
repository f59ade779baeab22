"""Device scene arrays: host Scene -> jit-consumable SoA pytrees.

The analog of the reference's scene upload + acceleration structure build
(OptixRender.cpp:1059-1175: vertex/index/light buffers, GAS per mesh, IAS
over instances). Instead of a two-level BVH with per-instance transforms,
instances are FLATTENED into a world-space triangle soup at build time: one
flat primitive array and one single-level BVH, at the cost of duplicating
geometry per instance. Which intersector a scene gets is decided by
ops/backend.py from the scene alone.

Geometry masks mirror OptixRenderParams.h:9-17: radiance rays intersect
triangles|curves|lights, shadow rays intersect triangles|curves only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from strelka_tpu import log
from strelka_tpu.materials import MaterialManager, MaterialTable
from strelka_tpu.scene.scene import InstanceType, Scene

GEOMETRY_MASK_TRIANGLE = 1
GEOMETRY_MASK_CURVE = 2
GEOMETRY_MASK_LIGHT = 4
RAY_MASK_PRIMARY = GEOMETRY_MASK_TRIANGLE | GEOMETRY_MASK_CURVE | GEOMETRY_MASK_LIGHT
RAY_MASK_SHADOW = GEOMETRY_MASK_TRIANGLE | GEOMETRY_MASK_CURVE


class DeviceLights(NamedTuple):
    """SoA mirror of UniformLight (include/render/Lights.h:5-14)."""

    points: jnp.ndarray  # [L,4,3]
    color: jnp.ndarray  # [L,3]
    normal: jnp.ndarray  # [L,3]
    type: jnp.ndarray  # [L] int32
    half_angle: jnp.ndarray  # [L] f32


class DeviceCurves(NamedTuple):
    """Cubic B-spline segments, world space (one record per curve segment)."""

    p0: jnp.ndarray  # [S,3] control points
    p1: jnp.ndarray
    p2: jnp.ndarray
    p3: jnp.ndarray
    w0: jnp.ndarray  # [S] per-control-point widths (radius)
    w1: jnp.ndarray
    w2: jnp.ndarray
    w3: jnp.ndarray
    material_id: jnp.ndarray  # [S] int32


# Packed attr_table column layout (per-tri; the reference packs vertices to
# 32 bytes via 10:10:12 normals/tangents + 16:16 uv, scene.h:80-89 — here
# normals/tangents are 12:12 octahedral 24-bit codes riding as exact f32
# values so both gather paths move them losslessly):
ATTR_N = 9  # 9:12  oct normal code per corner
ATTR_T = 12  # 12:15 oct tangent code per corner
ATTR_UV = 15  # 15:21 uv f32 (f16 pairs would bitcast into subnormal flushes)
ATTR_MAT = 21
ATTR_LIGHT = 22
ATTR_MASK = 23
ATTR_COLS = 24
ATTR_MAT_ROW = 24  # 24:48 joined per-prim material row
ATTR_LIGHT_ROW = 48  # 48:68 joined emissive-hit light row
ATTR_JOINED = 68
_OCT_Q = 4094.0  # 12-bit quantizer (EVEN so f=0 has an exact code: flat
# axis-aligned normals must not pick up quantization tilt)


def _oct_encode24(v: np.ndarray) -> np.ndarray:
    """[M,3] vectors -> [M] f32 of 24-bit (12:12) octahedral codes.

    Zero vectors encode as the +Z axis (degenerate tangents were already
    normalize-guarded downstream). Axis-aligned unit vectors round-trip
    exactly (u,v hit the quantizer midpoints)."""
    norm = np.linalg.norm(v, axis=1, keepdims=True)
    n = v / np.maximum(norm, 1e-20)
    ax = np.abs(n).sum(axis=1)
    ax = np.maximum(ax, 1e-20)
    px = n[:, 0] / ax
    py = n[:, 1] / ax
    south = n[:, 2] < 0.0
    sx = np.where(px >= 0.0, 1.0, -1.0)
    sy = np.where(py >= 0.0, 1.0, -1.0)
    fx = np.where(south, (1.0 - np.abs(py)) * sx, px)
    fy = np.where(south, (1.0 - np.abs(px)) * sy, py)
    qu = np.rint((fx + 1.0) * 0.5 * _OCT_Q)
    qv = np.rint((fy + 1.0) * 0.5 * _OCT_Q)
    return (qu * 4096.0 + qv).astype(np.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Flattened world-space scene, ready for the integrator.

    num_lights/num_triangles are STATIC metadata (baked into the jit trace);
    everything else is device data.
    """

    # triangles: v0 + edges for Moller-Trumbore
    v0: jnp.ndarray  # [T,3]
    e1: jnp.ndarray  # [T,3] v1-v0
    e2: jnp.ndarray  # [T,3] v2-v0
    # shading attributes per corner
    n0: jnp.ndarray  # [T,3]
    n1: jnp.ndarray
    n2: jnp.ndarray
    t0: jnp.ndarray  # [T,3] tangents
    t1: jnp.ndarray
    t2: jnp.ndarray
    uv0: jnp.ndarray  # [T,2]
    uv1: jnp.ndarray
    uv2: jnp.ndarray
    material_id: jnp.ndarray  # [T] int32
    light_id: jnp.ndarray  # [T] int32, -1 unless emissive light proxy
    geom_mask: jnp.ndarray  # [T] int32
    lights: DeviceLights
    materials: MaterialTable  # jnp-ified
    curves: Optional[DeviceCurves]
    bvh: Optional[object] = None  # BvhNodes (triangles reordered leaf-contiguous)
    textures: Optional[object] = None  # TextureAtlas
    cones: Optional[object] = None  # FlatCones (curves flattened to round cones)
    # Fat row-gather tables (ONE whole-row gather per hit instead of many
    # scalar gathers):
    attr_table: Optional[jnp.ndarray] = None  # [T, ATTR_COLS] packed surface attrs
    mat_table: Optional[jnp.ndarray] = None  # [M, 24] material params
    light_table: Optional[jnp.ndarray] = None  # [L, 20] light params
    num_lights: int = dataclasses.field(metadata=dict(static=True), default=0)
    num_triangles: int = dataclasses.field(metadata=dict(static=True), default=0)
    # static world AABB (host floats baked into the trace) — used to build
    # spatial ray-reordering keys without a traced reduction
    world_lo: tuple = dataclasses.field(metadata=dict(static=True), default=(0.0, 0.0, 0.0))
    world_hi: tuple = dataclasses.field(metadata=dict(static=True), default=(1.0, 1.0, 1.0))
    # any material uses the hair df (static: gates the fiber-lobe trace)
    has_hair: bool = dataclasses.field(metadata=dict(static=True), default=False)

    @property
    def num_curve_segments(self) -> int:
        return 0 if self.curves is None else int(self.curves.p0.shape[0])


def _pad_to(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    """Pad leading dim to n (static shapes in multiples of pad_multiple)."""
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    pad_block = np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)
    return np.concatenate([arr, pad_block], axis=0)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if n > 0 else m


def build_device_lights(scene: Scene) -> DeviceLights:
    lights = scene.lights
    if not lights:
        # keep a one-entry dummy so shapes stay static; num_lights=0 guards use
        return DeviceLights(
            points=jnp.zeros((1, 4, 3), jnp.float32),
            color=jnp.zeros((1, 3), jnp.float32),
            normal=jnp.zeros((1, 3), jnp.float32),
            type=jnp.zeros((1,), jnp.int32),
            half_angle=jnp.zeros((1,), jnp.float32),
        )
    return DeviceLights(
        points=jnp.asarray(np.stack([l.points[:, :3] for l in lights]), jnp.float32),
        color=jnp.asarray(np.stack([l.color[:3] for l in lights]), jnp.float32),
        normal=jnp.asarray(np.stack([l.normal[:3] for l in lights]), jnp.float32),
        type=jnp.asarray(np.array([l.type for l in lights], np.int32)),
        half_angle=jnp.asarray(np.array([l.half_angle for l in lights], np.float32)),
    )


def flatten_scene_geometry(scene: Scene):
    """Bake instance transforms into a world-space triangle soup (numpy)."""
    positions, normals, tangents, uvs, indices = scene.vertex_pools()
    removed = set(getattr(scene, "_del_instances", ()))
    tri_chunks = []
    for inst_id, inst in enumerate(scene.instances):
        if inst.type == InstanceType.eCurve or inst_id in removed:
            continue
        mesh = scene.meshes[inst.geom_id]
        tri = indices[mesh.index : mesh.index + mesh.count].reshape(-1, 3).astype(np.int64)
        tri = tri + mesh.vb_offset
        m = inst.transform
        rot = m[:3, :3]
        inv_t = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot
        p = positions[tri.reshape(-1)].astype(np.float64) @ rot.T + m[:3, 3]
        n = normals[tri.reshape(-1)].astype(np.float64) @ inv_t.T
        t = tangents[tri.reshape(-1)].astype(np.float64) @ rot.T
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
        t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-20)
        uv = uvs[tri.reshape(-1)]
        ntri = tri.shape[0]
        is_light = inst.type == InstanceType.eLight
        chunk = {
            "p": p.reshape(ntri, 3, 3).astype(np.float32),
            "n": n.reshape(ntri, 3, 3).astype(np.float32),
            "t": t.reshape(ntri, 3, 3).astype(np.float32),
            "uv": uv.reshape(ntri, 3, 2).astype(np.float32),
            "material_id": np.full(ntri, max(inst.material_id, 0), np.int32),
            "light_id": np.full(ntri, inst.light_id if is_light else -1, np.int32),
            "geom_mask": np.full(
                ntri, GEOMETRY_MASK_LIGHT if is_light else GEOMETRY_MASK_TRIANGLE, np.int32
            ),
        }
        tri_chunks.append(chunk)

    if tri_chunks:
        cat = {k: np.concatenate([c[k] for c in tri_chunks]) for k in tri_chunks[0]}
    else:
        cat = {
            "p": np.zeros((0, 3, 3), np.float32),
            "n": np.zeros((0, 3, 3), np.float32),
            "t": np.zeros((0, 3, 3), np.float32),
            "uv": np.zeros((0, 3, 2), np.float32),
            "material_id": np.zeros(0, np.int32),
            "light_id": np.zeros(0, np.int32),
            "geom_mask": np.zeros(0, np.int32),
        }
    return cat


def flatten_scene_curves(scene: Scene) -> Optional[dict]:
    """World-space cubic B-spline segments from curve instances."""
    segs = {k: [] for k in ("p0", "p1", "p2", "p3", "w0", "w1", "w2", "w3", "material_id")}
    any_seg = False
    for inst in scene.instances:
        if inst.type != InstanceType.eCurve:
            continue
        curve = scene.curves[inst.geom_id]
        pts_all = np.concatenate(scene.curve_points) if scene.curve_points else np.zeros((0, 3), np.float32)
        wid_all = np.concatenate(scene.curve_widths) if scene.curve_widths else np.zeros(0, np.float32)
        cnt_all = (
            np.concatenate(scene.curve_vertex_counts) if scene.curve_vertex_counts else np.zeros(0, np.uint32)
        )
        counts = cnt_all[
            curve.vertex_counts_start : curve.vertex_counts_start + curve.vertex_counts_count
        ]
        m = inst.transform
        base = curve.points_start
        wbase = curve.widths_start
        # uniform scale factor for widths
        s = float(np.cbrt(abs(np.linalg.det(m[:3, :3])))) or 1.0
        for c in counts:
            c = int(c)
            pts = pts_all[base : base + c].astype(np.float64) @ m[:3, :3].T + m[:3, 3]
            if wbase >= 0 and curve.widths_count > 0:
                ws = wid_all[wbase : wbase + c] * s
                wbase += c
            else:
                ws = np.full(c, 0.1 * s, np.float32)
            base += c
            # sliding window of 4 control points per segment (cubic B-spline)
            for i in range(c - 3):
                any_seg = True
                for j in range(4):
                    segs[f"p{j}"].append(pts[i + j].astype(np.float32))
                    segs[f"w{j}"].append(np.float32(ws[i + j]))
                segs["material_id"].append(np.int32(max(inst.material_id, 0)))
    if not any_seg:
        return None
    return {k: np.stack(v) if v and np.ndim(v[0]) else np.array(v) for k, v in segs.items()}


def build_device_scene(
    scene: Scene,
    material_manager: Optional[MaterialManager] = None,
    pad_multiple: int = 128,
    use_bvh: Optional[bool] = None,
) -> DeviceScene:
    """Full host->device build: flatten, compile materials, build BVH
    (the optixAccelBuild analog), reorder leaf-contiguous, pad, upload.

    use_bvh None = the choice of ops/backend.py for this triangle count;
    True/False forces the BVH or the brute-force sweep (tests compare them).
    """
    from strelka_tpu.ops.backend import TRIANGLES_BVH, choose_intersectors

    cat = flatten_scene_geometry(scene)
    num_tri = int(cat["p"].shape[0])

    if use_bvh is None:
        use_bvh = choose_intersectors(num_tri, False).triangles == TRIANGLES_BVH
    bvh_nodes = None
    if use_bvh and num_tri > 0:
        from strelka_tpu.ops.bvh import ThreadedBvh, build_bvh_sah, thread_bvh

        p = cat["p"]
        nodes, perm = build_bvh_sah(p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        for k in cat:
            cat[k] = cat[k][perm]
        threaded = thread_bvh(nodes)
        bvh_nodes = ThreadedBvh(*[jnp.asarray(np.asarray(x)) for x in threaded])
        log.info("BVH built: {} nodes over {} triangles", len(np.asarray(threaded.count)), num_tri)
    padded = _round_up(num_tri, pad_multiple)
    # padding triangles are degenerate (zero-area at origin) with mask 0
    p = _pad_to(cat["p"], padded)
    n = _pad_to(cat["n"], padded)
    t = _pad_to(cat["t"], padded)
    uv = _pad_to(cat["uv"], padded)
    material_id = _pad_to(cat["material_id"], padded)
    light_id = _pad_to(cat["light_id"], padded, fill=-1)
    geom_mask = _pad_to(cat["geom_mask"], padded, fill=0)

    mm = material_manager or MaterialManager()
    if mm.texture_manager is None:
        from strelka_tpu.textures import TextureManager

        mm.texture_manager = TextureManager(search_path=scene.get_scene_dir())
    compiled = mm.compile_scene_materials(scene.materials)
    table, mat_remap = mm.generate_target_code_deduped(compiled)
    table = MaterialTable(*[jnp.asarray(x) for x in table])
    atlas = mm.texture_manager.build_atlas()
    # rewrite instance material ids onto deduped rows (source array AND the
    # already-padded copy)
    cat["material_id"] = mat_remap[np.clip(cat["material_id"], 0, len(mat_remap) - 1)]
    material_id = _pad_to(cat["material_id"], padded)

    curves_np = flatten_scene_curves(scene)
    curves = None
    if curves_np is not None:
        curves_np["material_id"] = mat_remap[
            np.clip(curves_np["material_id"], 0, len(mat_remap) - 1)
        ]
        ns = int(curves_np["p0"].shape[0])
        nsp = _round_up(ns, pad_multiple)
        curves = DeviceCurves(
            p0=jnp.asarray(_pad_to(curves_np["p0"], nsp)),
            p1=jnp.asarray(_pad_to(curves_np["p1"], nsp)),
            p2=jnp.asarray(_pad_to(curves_np["p2"], nsp)),
            p3=jnp.asarray(_pad_to(curves_np["p3"], nsp)),
            w0=jnp.asarray(_pad_to(curves_np["w0"], nsp)),
            w1=jnp.asarray(_pad_to(curves_np["w1"], nsp)),
            w2=jnp.asarray(_pad_to(curves_np["w2"], nsp)),
            w3=jnp.asarray(_pad_to(curves_np["w3"], nsp)),
            material_id=jnp.asarray(_pad_to(curves_np["material_id"], nsp)),
        )
        log.info("Device scene: {} curve segments ({} padded)", ns, nsp)
        # padded segments get negative radius -> never hit
        if nsp > ns:
            neg = jnp.where(jnp.arange(nsp) < ns, 1.0, -1.0)
            curves = curves._replace(
                w0=curves.w0 * neg, w1=curves.w1 * neg, w2=curves.w2 * neg, w3=curves.w3 * neg
            )

    # fat gather tables — PACKED attribute layout (the analog of the
    # reference's 32-byte packed vertex, scene.h:80-89 10:10:12 + 16:16):
    # shading normals/tangents ride as 12:12 octahedral codes, one 24-bit
    # integer per corner stored as an exact f32 VALUE (<= 2^24, so the
    # row-gather moves it losslessly). 36 -> 24 attr cols = 96B/tri geometry+attrs,
    # byte parity with the reference's 3x32B packed corners; uv stays f32
    # (f16 pairs would ride bitcast -> subnormal-flush hazard).
    num_pad = p.shape[0]
    attr_table = np.zeros((num_pad, ATTR_COLS), np.float32)
    attr_table[:, 0:3] = p[:, 0]
    attr_table[:, 3:6] = p[:, 1] - p[:, 0]
    attr_table[:, 6:9] = p[:, 2] - p[:, 0]
    attr_table[:, ATTR_N : ATTR_N + 3] = _oct_encode24(n.reshape(num_pad * 3, 3)).reshape(num_pad, 3)
    attr_table[:, ATTR_T : ATTR_T + 3] = _oct_encode24(t.reshape(num_pad * 3, 3)).reshape(num_pad, 3)
    attr_table[:, ATTR_UV : ATTR_UV + 6] = uv.reshape(num_pad, 6)
    attr_table[:, ATTR_MAT] = material_id
    attr_table[:, ATTR_LIGHT] = light_id
    attr_table[:, ATTR_MASK] = geom_mask

    tbl = table  # jnp MaterialTable
    mat_table = jnp.concatenate(
        [
            tbl.bsdf_type.astype(jnp.float32)[:, None],
            tbl.diffuse_color,
            tbl.metallic[:, None],
            tbl.roughness[:, None],
            tbl.specular_level[:, None],
            tbl.ior[:, None],
            tbl.glass_color,
            tbl.opacity[:, None],
            tbl.diffuse_tex.astype(jnp.float32)[:, None],
            tbl.normal_tex.astype(jnp.float32)[:, None],
            tbl.roughness_tex.astype(jnp.float32)[:, None],
            tbl.metallic_tex.astype(jnp.float32)[:, None],
            tbl.uv_scale,
            tbl.uv_offset,
            tbl.emission_color,
            tbl.thin_walled.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )
    if num_tri > 0:
        pts = cat["p"].reshape(-1, 3)
        world_lo = tuple(float(x) for x in pts.min(axis=0))
        world_hi = tuple(float(x) for x in pts.max(axis=0))
    else:
        world_lo, world_hi = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)

    # cones flatten in numpy (one upload per field, no eager device ops)
    cones_flat = None
    if curves_np is not None:
        from strelka_tpu.ops.curves import FlatCones, flatten_curves_np

        cones_flat = FlatCones(*[jnp.asarray(f) for f in flatten_curves_np(curves_np)])

    dl = build_device_lights(scene)
    light_table = jnp.concatenate(
        [
            jnp.asarray(dl.points).reshape(-1, 12),
            jnp.asarray(dl.color),
            jnp.asarray(dl.normal),
            dl.type.astype(jnp.float32)[:, None],
            dl.half_angle[:, None],
        ],
        axis=1,
    )

    # Join the per-prim material row (24 cols) and hit-light row (20 cols)
    # into the attr table -> [T, ATTR_JOINED]. This eliminates two of the
    # three per-bounce fat gathers (the material row and the emissive-hit
    # light row ride along with the attributes).
    mat_np = np.asarray(mat_table, np.float32)
    light_np = np.asarray(light_table, np.float32)
    if mat_np.shape[0] and light_np.shape[0]:
        mj = np.clip(material_id.astype(np.int64), 0, mat_np.shape[0] - 1)
        lj = np.clip(light_id.astype(np.int64), 0, light_np.shape[0] - 1)
        attr_table = np.concatenate(
            [attr_table, mat_np[mj], light_np[lj]], axis=1
        )

    log.info(
        "Device scene: {} triangles ({} padded, {}), {} lights, {} materials",
        num_tri,
        padded,
        "bvh" if bvh_nodes is not None else "brute force",
        len(scene.lights),
        len(compiled),
    )
    return DeviceScene(
        v0=jnp.asarray(p[:, 0]),
        e1=jnp.asarray(p[:, 1] - p[:, 0]),
        e2=jnp.asarray(p[:, 2] - p[:, 0]),
        n0=jnp.asarray(n[:, 0]),
        n1=jnp.asarray(n[:, 1]),
        n2=jnp.asarray(n[:, 2]),
        t0=jnp.asarray(t[:, 0]),
        t1=jnp.asarray(t[:, 1]),
        t2=jnp.asarray(t[:, 2]),
        uv0=jnp.asarray(uv[:, 0]),
        uv1=jnp.asarray(uv[:, 1]),
        uv2=jnp.asarray(uv[:, 2]),
        material_id=jnp.asarray(material_id),
        light_id=jnp.asarray(light_id),
        geom_mask=jnp.asarray(geom_mask),
        lights=dl,
        materials=table,
        curves=curves,
        bvh=bvh_nodes,
        textures=atlas,
        cones=cones_flat,
        attr_table=jnp.asarray(attr_table),
        mat_table=mat_table,
        light_table=light_table,
        num_lights=len(scene.lights),
        num_triangles=num_tri,
        has_hair=bool((np.asarray(table.bsdf_type) == 3).any()),
        world_lo=world_lo,
        world_hi=world_hi,
    )


def rejoin_attr_tables(scene: "DeviceScene") -> "DeviceScene":
    """Recompute the joined material/light columns of the attr table from the
    CURRENT mat_table / light_table. Anything that mutates mat_table or
    light_table on a built scene (live material edits, tests patching
    params) must call this, or the shade epilogue — which reads the joined
    copy, not the tables — will keep using stale values."""
    import dataclasses

    at = scene.attr_table
    if at is None or at.shape[1] < ATTR_JOINED:
        return scene
    mid = jnp.clip(at[:, ATTR_MAT].astype(jnp.int32), 0, scene.mat_table.shape[0] - 1)
    lid = jnp.clip(at[:, ATTR_LIGHT].astype(jnp.int32), 0, scene.light_table.shape[0] - 1)
    at = at.at[:, ATTR_MAT_ROW:ATTR_LIGHT_ROW].set(scene.mat_table[mid])
    at = at.at[:, ATTR_LIGHT_ROW:ATTR_JOINED].set(scene.light_table[lid])
    return dataclasses.replace(scene, attr_table=at)


