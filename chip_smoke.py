"""Smoke test of the renderer on one GPU, through the entry points a user calls.

    python chip_smoke.py            # phases 1-4 on one card
    python chip_smoke.py --multi    # phase 5 only: pixel-row sharding over all cards

Phases, each printed as it finishes:
  1. device: card name and power limit, JAX version, compile-cache directory,
     native BVH builder;
  2. main path: the generated kitchen (binary .usdc, >=100k triangles,
     4 textures, 4 lights) at 1024x768, depth 4, through
     strelka_tpu.app.cli.main and then strelka_tpu.app.usd_runner.main;
  3. fidelity: cornell, box_field, coffeetable, kitchen and hair_patch at
     their golden configs (bench.GOLDEN_CONFIGS) against goldens/*.png;
  4. kernel checks at real widths, each against a plain reference
     (strelka_tpu/ops/reference.py) with its tolerance, plus per-sweep times;
  5. (--multi) kitchen at 1024x768 sharded over every card vs one card.

Any failed check raises, so the script exits non-zero and prints no result
line. It exits non-zero at once when JAX finds no GPU. The last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_SCENES = ("cornell", "box_field", "coffeetable", "kitchen", "hair_patch")
SSIM_MIN = 0.98  # tests/test_render_features.py golden threshold
AGREE_MIN = 0.999  # hit/miss and primitive agreement (grazing ties allowed)
T_RTOL = 1e-4


class CheckFailed(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def say(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    """Card name and power limit, read by nvidia-smi (a child that never
    touches JAX)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def _timed(fn, *args, reps: int = 3):
    """(result, median seconds) of fn(*args) after one warm-up call; every
    call ends in block_until_ready."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


# ---- phase 1 -----------------------------------------------------------------


def phase_device() -> dict:
    import jax

    from strelka_tpu.native import get_library

    d = jax.devices()[0]
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or jax.config.jax_compilation_cache_dir
    native = get_library() is not None
    info = {
        "jax": jax.__version__,
        "platform": d.platform,
        "kind": d.device_kind,
        "count": len(jax.devices()),
        "compile_cache": cache,
        "native_bvh_builder": native,
    }
    say(f"[device] jax {info['jax']}  {info['platform']} '{info['kind']}' x{info['count']}")
    say(f"[device] compile cache: {cache}")
    say(
        "[device] native C++ BVH builder: "
        + ("loaded" if native else "NOT loaded (BVH builds fall back to Python)")
    )
    return info


# ---- phase 2 -----------------------------------------------------------------


def _summarize_run(tag: str, st: dict) -> dict:
    import jax

    from strelka_tpu.ops.backend import describe

    img = st["image"]
    frames = st["frame_s"]
    steady = frames[1:]
    row = {
        "scene_build_s": st["scene_build_s"],
        "first_launch_s": frames[0] - st["scene_build_s"],
        "median_ms_per_launch": 1e3 * statistics.median(steady) if steady else None,
        "launches": len(frames),
        "spp": st["spp"],
        "finite": bool(np.isfinite(img).all()),
        "mean": float(img.mean()),
        "textures": st["render"].material_manager.texture_manager.count,
        "intersectors": describe(st["render"].device_scene())._asdict(),
        "peak_bytes_in_use": jax.devices()[0].memory_stats().get("peak_bytes_in_use")
        if jax.devices()[0].memory_stats() else None,
    }
    say(
        f"[main:{tag}] scene build {row['scene_build_s']:.2f} s, first launch "
        f"(compile) {row['first_launch_s']:.2f} s, median "
        + (f"{row['median_ms_per_launch']:.2f}" if steady else "n/a")
        + f" ms/launch over {len(steady)}, spp {row['spp']}"
    )
    say(
        f"[main:{tag}] image finite={row['finite']} mean={row['mean']:.6f} "
        f"textures={row['textures']} peak_bytes_in_use={row['peak_bytes_in_use']} "
        f"intersectors={row['intersectors']}"
    )
    check(row["finite"], f"{tag}: image has NaN/Inf")
    check(row["mean"] > 0.0, f"{tag}: black image")
    check(row["textures"] >= 4, f"{tag}: kitchen rendered with {row['textures']} textures")
    return row


def phase_main_path(out_dir: str, width: int = 1024, height: int = 768, depth: int = 4,
                    launches: int = 8, runner_launches: int = 3) -> dict:
    from strelka_tpu.app import cli, usd_runner
    from strelka_tpu.scene.kitchen_gen import ensure_kitchen

    os.makedirs(out_dir, exist_ok=True)
    kitchen = ensure_kitchen()
    common = ["-s", kitchen, "-f", "1", "--width", str(width), "--height", str(height),
              "--depth", str(depth), "-c"]
    rows = {}
    st: dict = {}
    rc = cli.main(common + ["-t", str(launches), "-o", os.path.join(out_dir, "kitchen.png")],
                  stats_out=st)
    check(rc == 0, f"cli.main returned {rc}")
    rows["cli"] = _summarize_run("cli", st)
    st = {}
    rc = usd_runner.main(
        common + ["-t", str(runner_launches), "-o", os.path.join(out_dir, "kitchen_usd_runner.png")],
        stats_out=st,
    )
    check(rc == 0, f"usd_runner.main returned {rc}")
    rows["usd_runner"] = _summarize_run("usd_runner", st)
    return rows


# ---- phase 3 -----------------------------------------------------------------


def phase_fidelity(names=GOLDEN_SCENES) -> dict:
    import bench
    from strelka_tpu.utils.image import read_png, ssim

    out = {}
    for name in names:
        t0 = time.perf_counter()
        img = bench.render_golden_config(name)
        golden = read_png(os.path.join(REPO, "goldens", f"{name}_golden.png"))[..., :3]
        out[name] = float(ssim(img, golden))
        say(
            f"[fidelity] {name}: SSIM {out[name]:.5f} (min {SSIM_MIN}) "
            f"config {bench.GOLDEN_CONFIGS[name]}, {time.perf_counter() - t0:.1f} s"
        )
    bad = {k: v for k, v in out.items() if not v >= SSIM_MIN}
    check(not bad, f"golden SSIM below {SSIM_MIN}: {bad}")
    return out


# ---- phase 4 -----------------------------------------------------------------


def _camera_rays(host, width: int, height: int, spp: int, seed: int):
    """[width*height*spp] jittered primary rays of the scene's camera (the
    integrator's own ray generation), as [N,3] device arrays."""
    import jax
    import jax.numpy as jnp

    from strelka_tpu.ops import integrator as I
    from strelka_tpu.ops import vec as V

    cam = host.get_camera(0)
    cam.update_aspect_ratio(width / height)
    params = I.LaunchParams(
        subframe_index=jnp.int32(0),
        clip_to_view=jnp.asarray(cam.clip_to_view(), jnp.float32),
        view_to_world=jnp.asarray(cam.view_to_world(), jnp.float32),
        exposure=jnp.ones(3, jnp.float32),
        bg_color=jnp.zeros(3, jnp.float32),
    )
    n = width * height * spp
    idx = jnp.arange(n, dtype=jnp.uint32) % jnp.uint32(width * height)
    key = jax.random.PRNGKey(seed)
    jx, jy = jax.random.uniform(key, (2, n))
    o, d = I.generate_camera_rays(params, idx % width, idx // width, jx, jy, width, height)
    return V.to_rows(o), V.to_rows(d)


def _interior_rays(lo, hi, n: int, seed: int):
    """n rays from uniform points of the world box in uniform directions
    (incoherent, like bounce rays)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _agreement(tag, hit_a, prim_a, t_a, hit_b, prim_b, t_b) -> dict:
    """A ray agrees when both miss, or both hit the same primitive at t
    within T_RTOL; at least AGREE_MIN of the rays must agree (the rest are
    grazing ties and near-tangent hits)."""
    both = hit_a & hit_b
    same = both & (prim_a == prim_b)
    rel = np.abs(t_a - t_b) / np.maximum(np.abs(t_b), 1e-30)
    match = (~hit_a & ~hit_b) | (same & (rel <= T_RTOL))
    row = {
        "rays": int(hit_a.size),
        "hit_agree": float((hit_a == hit_b).mean()),
        "agree": float(match.mean()),
        "t_rel_err_worst": float(rel[same].max()) if same.any() else 0.0,
        "t_rel_err_over_tol": int((same & (rel > T_RTOL)).sum()),
    }
    say(
        f"[kernels] {tag}: hit/miss agree {row['hit_agree']:.6f}, hit+prim+t agree "
        f"{row['agree']:.6f} (min {AGREE_MIN}), worst t rel err {row['t_rel_err_worst']:.3e} "
        f"({row['t_rel_err_over_tol']} same-prim rays over {T_RTOL})"
    )
    check(row["agree"] >= AGREE_MIN, f"{tag}: agreement {row['agree']} below {AGREE_MIN}")
    return row


def check_triangles(name: str, host, cam_w: int, cam_h: int, cam_spp: int, n_bf: int,
                    n_ref: int, seed: int = 0, scene=None) -> dict:
    """BVH closest/any sweeps on camera and interior rays: timed, iteration
    counts, against the on-card brute force (first n_bf rays of each set)
    and the float64 numpy reference (first n_ref rays)."""
    import jax
    import jax.numpy as jnp

    from strelka_tpu.ops import reference as R
    from strelka_tpu.ops.bvh import intersect_bvh
    from strelka_tpu.ops.intersect import intersect_any_bruteforce, intersect_closest_bruteforce
    from strelka_tpu.render.device_scene import RAY_MASK_PRIMARY, build_device_scene

    t0 = time.perf_counter()
    if scene is None:
        scene = jax.block_until_ready(build_device_scene(host, use_bvh=True))
    build_s = time.perf_counter() - t0
    ntri = scene.num_triangles
    nodes = int(scene.bvh.skip.shape[0])
    say(f"[kernels] {name}: {ntri} triangles, {nodes} BVH nodes, build {build_s:.2f} s")

    co, cd = _camera_rays(host, cam_w, cam_h, cam_spp, seed)
    n_cam = int(co.shape[0])
    io, idr = _interior_rays(np.asarray(scene.world_lo), np.asarray(scene.world_hi), n_cam, seed + 1)
    diag = float(np.linalg.norm(np.subtract(scene.world_hi, scene.world_lo)))
    rng = np.random.default_rng(seed + 2)
    sets = {
        "camera": (co, cd),
        "interior": (jnp.asarray(io), jnp.asarray(idr)),
    }

    # the scene is an argument, never a closure constant baked into the program
    def closest(sc, o, d, tmin, tmax):
        return intersect_bvh(sc.bvh, sc.v0, sc.e1, sc.e2, sc.geom_mask,
                             o, d, tmin, tmax, RAY_MASK_PRIMARY, with_steps=True)

    def any_hit(sc, o, d, tmin, tmax):
        return intersect_bvh(sc.bvh, sc.v0, sc.e1, sc.e2, sc.geom_mask,
                             o, d, tmin, tmax, RAY_MASK_PRIMARY, any_hit=True, with_steps=True)

    closest_j, any_j = jax.jit(closest), jax.jit(any_hit)
    bf_closest = jax.jit(lambda sc, o, d, a, b: intersect_closest_bruteforce(
        sc, o, d, a, b, RAY_MASK_PRIMARY))
    bf_any = jax.jit(lambda sc, o, d, a, b: intersect_any_bruteforce(
        sc, o, d, a, b, RAY_MASK_PRIMARY))
    out = {"triangles": ntri, "bvh_nodes": nodes, "build_s": build_s}
    for tag, (o, d) in sets.items():
        n = int(o.shape[0])
        tmin = jnp.zeros(n, jnp.float32)
        tmax = jnp.full(n, 1e16, jnp.float32)
        tmax_any = jnp.asarray(rng.uniform(0.0, diag, n).astype(np.float32))
        (t, prim, _u, _v, steps), sec_c = _timed(closest_j, scene, o, d, tmin, tmax)
        (_, prim_any, _, _, steps_any), sec_a = _timed(any_j, scene, o, d, tmin, tmax_any)
        row = {
            "rays": n,
            "closest_ms": 1e3 * sec_c, "closest_steps": int(steps),
            "any_ms": 1e3 * sec_a, "any_steps": int(steps_any),
        }
        say(
            f"[kernels] {name}/{tag}: {n} rays, BVH closest {row['closest_ms']:.2f} ms "
            f"({row['closest_steps']} loop iterations), any {row['any_ms']:.2f} ms "
            f"({row['any_steps']} iterations)"
        )
        t, prim, occ = np.asarray(t), np.asarray(prim), np.asarray(prim_any) >= 0
        if n_bf:
            m = min(n_bf, n)
            hb = bf_closest(scene, o[:m], d[:m], tmin[:m], tmax[:m])
            ob = np.asarray(bf_any(scene, o[:m], d[:m], tmin[:m], tmax_any[:m]))
            pb, tb = np.asarray(hb.prim), np.asarray(hb.t)
            row["vs_bruteforce"] = _agreement(
                f"{name}/{tag} BVH vs on-card brute force ({m} rays)",
                prim[:m] >= 0, prim[:m], t[:m], pb >= 0, pb, tb)
            any_agree = float((occ[:m] == ob).mean())
            say(f"[kernels] {name}/{tag} any-hit BVH vs brute force: agree {any_agree:.6f}")
            check(any_agree >= AGREE_MIN, f"{name}/{tag}: any-hit agreement {any_agree}")
        if n_ref:
            m = min(n_ref, n)
            o_np, d_np = np.asarray(o[:m]), np.asarray(d[:m])
            t0 = time.perf_counter()
            tr, pr = R.ray_triangles(
                o_np, d_np, np.asarray(scene.v0), np.asarray(scene.e1), np.asarray(scene.e2),
                np.zeros(m), np.full(m, 1e16), tri_mask=np.asarray(scene.geom_mask),
                ray_mask=RAY_MASK_PRIMARY, workers=os.cpu_count() or 1,
            )
            row["vs_numpy_f64"] = _agreement(
                f"{name}/{tag} BVH vs float64 numpy ({m} rays, {time.perf_counter() - t0:.1f} s)",
                prim[:m] >= 0, prim[:m], t[:m], pr >= 0, pr, tr)
            occ_ref = (pr >= 0) & (tr < np.asarray(tmax_any[:m]))
            any_agree = float((occ[:m] == occ_ref).mean())
            say(f"[kernels] {name}/{tag} any-hit BVH vs float64 numpy: agree {any_agree:.6f}")
            check(any_agree >= AGREE_MIN, f"{name}/{tag}: any-hit vs numpy {any_agree}")
        out[tag] = row
    return out


def check_cones(name: str, host, cam_w: int, cam_h: int, cam_spp: int, n_ref: int,
                seed: int = 0) -> dict:
    """Blocked cone sweep (closest/any) on camera rays: timed, and against
    the float64 numpy round-cone reference on the first n_ref rays."""
    import jax
    import jax.numpy as jnp

    from strelka_tpu.ops import reference as R
    from strelka_tpu.ops.curves import intersect_curves_any, intersect_curves_closest
    from strelka_tpu.render.device_scene import build_device_scene

    scene = jax.block_until_ready(build_device_scene(host))
    cones = scene.cones
    m_cones = int(cones.a.shape[0])
    o, d = _camera_rays(host, cam_w, cam_h, cam_spp, seed)
    n = int(o.shape[0])
    tmin = jnp.zeros(n, jnp.float32)
    tmax = jnp.full(n, 1e16, jnp.float32)
    tmax_any = jnp.asarray(np.random.default_rng(seed + 2).uniform(0.0, 8.0, n), jnp.float32)
    hit, sec_c = _timed(jax.jit(intersect_curves_closest), cones, o, d, tmin, tmax)
    occ, sec_a = _timed(jax.jit(intersect_curves_any), cones, o, d, tmin, tmax_any)
    row = {"cones": m_cones, "rays": n, "closest_ms": 1e3 * sec_c, "any_ms": 1e3 * sec_a}
    say(
        f"[kernels] {name}: {m_cones} cones, {n} rays, cone sweep closest "
        f"{row['closest_ms']:.2f} ms, any {row['any_ms']:.2f} ms"
    )
    if n_ref:
        k = min(n_ref, n)
        seg_id = np.asarray(cones.seg_id)
        tr, cr, _ = R.ray_round_cones(
            np.asarray(o[:k]), np.asarray(d[:k]), np.asarray(cones.a), np.asarray(cones.b),
            np.asarray(cones.ra), np.asarray(cones.rb), np.zeros(k), np.full(k, 1e16),
            workers=os.cpu_count() or 1,
        )
        sr = np.where(cr >= 0, seg_id[np.maximum(cr, 0)], -1)
        sd, td = np.asarray(hit.seg[:k]), np.asarray(hit.t[:k])
        row["vs_numpy_f64"] = _agreement(
            f"{name} cone sweep vs float64 numpy ({k} rays)", sd >= 0, sd, td, sr >= 0, sr, tr)
        occ_ref = (cr >= 0) & (tr < np.asarray(tmax_any[:k]))
        any_agree = float((np.asarray(occ[:k]) == occ_ref).mean())
        say(f"[kernels] {name} cone any-hit vs float64 numpy: agree {any_agree:.6f}")
        check(any_agree >= AGREE_MIN, f"{name}: cone any-hit agreement {any_agree}")
    return row


def _count_fusions(compiled_text: str) -> int:
    return len(re.findall(r"\bfusion\(", compiled_text))


def check_sampler(n: int, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from strelka_tpu.ops import reference as R
    from strelka_tpu.ops import sampler as S

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    fn = jax.jit(lambda i: S.random_dims(i, 1, (0, 1, 2, 3, 4)))
    idx_d = jnp.asarray(idx)
    fusions = _count_fusions(fn.lower(idx_d).compile().as_text())
    got, sec = _timed(fn, idx_d)
    ref = R.random_dims(idx, 1, (0, 1, 2, 3, 4), S._SB_MATRIX)
    mism = int((np.asarray(got).view(np.uint32) != ref.view(np.uint32)).sum())
    say(
        f"[kernels] random_dims: {n} lanes x 5 dims, {mism} bit mismatches vs numpy u32 "
        f"(must be 0), {1e3 * sec:.3f} ms, {fusions} fusion(s) in the compiled draw"
    )
    check(mism == 0, f"random_dims differs from the numpy reference in {mism} values")
    return {"lanes": n, "mismatches": mism, "ms": 1e3 * sec, "fusions": fusions}


def check_gather(table, n: int, tag: str, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from strelka_tpu.ops.vec import gather_rows_t

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, table.shape[0], n).astype(np.int32)
    got, sec = _timed(jax.jit(gather_rows_t), table, jnp.asarray(idx))
    exact = bool(np.array_equal(np.asarray(got), np.asarray(table)[idx].T))
    say(
        f"[kernels] gather_rows_t {tag} [{table.shape[0]}, {table.shape[1]}] x {n}: "
        f"exact={exact}, {1e3 * sec:.3f} ms"
    )
    check(exact, f"gather_rows_t {tag} not exact")
    return {"rows": int(table.shape[0]), "cols": int(table.shape[1]), "n": n, "exact": exact,
            "ms": 1e3 * sec}


def check_tonemap(width: int, height: int, seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from strelka_tpu.ops import reference as R
    from strelka_tpu.ops import tonemap as TM

    rng = np.random.default_rng(seed)
    img = rng.gamma(0.7, 400.0, (3, height, width)).astype(np.float32)
    exposure = np.array([6.25e-4, 7e-4, 5.5e-4], np.float32)
    out = {}
    for kind, name in ((0, "reinhard"), (1, "aces"), (2, "filmic")):
        # the curves alone (gamma 0): a gamma pow near 0 amplifies any f32
        # rounding beyond an absolute bound
        fn = jax.jit(lambda x, e, k=kind: TM.apply_tonemap_planar(x, k, e, 0.0))
        got = np.asarray(fn(jnp.asarray(img), jnp.asarray(exposure)))
        err = float(np.abs(got - R.tonemap_planar(img, kind, exposure, 0.0)).max())
        out[name] = err
        say(f"[kernels] tonemap {name}: worst abs err vs float64 {err:.3e} (max 1e-6)")
    check(max(out.values()) <= 1e-6, f"tonemap error {out}")
    return out


def phase_kernels(box_grid: int = 48, bvh_cam=(512, 512, 2), kitchen_cam=(1024, 768, 1),
                  hair_cam=(384, 384, 2), n_bf: int = 65536, n_ref: int = 4096,
                  n_lanes: int = 1024 * 768) -> dict:
    import jax

    from strelka_tpu.render.device_scene import build_device_scene
    from strelka_tpu.scene import testscenes as TS

    import bench

    out = {}
    out["box_field"] = check_triangles("box_field", TS.box_field(grid=box_grid), *bvh_cam,
                                       n_bf=n_bf, n_ref=n_ref)
    kitchen = bench.build_host_scene("kitchen")
    ks = jax.block_until_ready(build_device_scene(kitchen))
    out["kitchen"] = check_triangles("kitchen", kitchen, *kitchen_cam, n_bf=0, n_ref=0,
                                     scene=ks)
    out["hair_patch"] = check_cones("hair_patch", TS.hair_patch(n_curves=256), *hair_cam,
                                    n_ref=n_ref)
    out["random_dims"] = check_sampler(n_lanes)
    out["gather_attr"] = check_gather(ks.attr_table, n_lanes, "kitchen attr table")
    out["gather_light"] = check_gather(ks.light_table, n_lanes, "kitchen light table")
    out["tonemap"] = check_tonemap(*kitchen_cam[:2])
    return out


# ---- phase 5 -----------------------------------------------------------------


def _render_kitchen(width: int, height: int, launches: int, use_sharding: bool):
    from strelka_tpu.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu.render.render import RenderFactory
    from strelka_tpu.settings import SharedContext, make_default_settings

    import bench

    s = make_default_settings(width, height)
    s.set("render/pt/sppTotal", launches)
    s.set("render/pt/spp", 1)
    s.set("render/pt/depth", 4)
    r = RenderFactory.create_render(use_sharding=use_sharding)
    r.set_scene(bench.build_host_scene("kitchen"))
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(width, height, BufferFormat.FLOAT4))
    times = []
    for _ in range(launches):
        t0 = time.perf_counter()
        r.render(buf)
        buf.device().block_until_ready()
        times.append(time.perf_counter() - t0)
    return r, np.asarray(buf.map()), times


def phase_multi(width: int = 1024, height: int = 768, launches: int = 6) -> dict:
    import jax

    n = len(jax.devices())
    r1, img1, t1 = _render_kitchen(width, height, launches, use_sharding=False)
    rn, imgn, tn = _render_kitchen(width, height, launches, use_sharding=True)
    diff = float(np.abs(imgn - img1).max())
    bitwise = bool(np.array_equal(imgn, img1))
    text = next(iter(rn._launch_cache.values())).lower().compile().as_text()
    found = [op for op in ("all-to-all", "collective-permute", "all-gather", "all-reduce",
                           "reduce-scatter") if op in text]
    ms1 = 1e3 * statistics.median(t1[1:])
    msn = 1e3 * statistics.median(tn[1:])
    say(f"[multi] kitchen {width}x{height} depth 4, {launches} launches of 1 spp")
    say(f"[multi] 1 card: first launch {t1[0]:.2f} s, median {ms1:.2f} ms/launch")
    say(f"[multi] {n} cards: first launch {tn[0]:.2f} s, median {msn:.2f} ms/launch")
    say(f"[multi] sharded vs single: max abs diff {diff:.3e}, bitwise equal {bitwise}")
    say(f"[multi] collectives in the compiled sharded launch: {found or 'none'}")
    check(not found, f"per-launch collectives in the sharded launch: {found}")
    check(np.isfinite(imgn).all(), "sharded image has NaN/Inf")
    return {"cards": n, "ms_1": ms1, "ms_n": msn, "max_abs_diff": diff, "bitwise": bitwise}


# ---- driver ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true", help="phase 5 only, on every card")
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"),
                    help="directory for the kitchen PNGs and the JSON of every phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); nothing run",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    say(f"[device] nvidia-smi: {smi}")
    results = {"nvidia_smi": smi}
    if args.multi:
        results["multi"] = phase_multi()
    else:
        results["device"] = phase_device()
        results["main_path"] = phase_main_path(args.out)
        results["fidelity"] = phase_fidelity()
        results["kernels"] = phase_kernels()
    os.makedirs(args.out, exist_ok=True)
    name = "multi.json" if args.multi else "smoke.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(results, f, indent=1, default=str)
    say(f"[done] {time.perf_counter() - t_start:.1f} s")
    say(smi)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
