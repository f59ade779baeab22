"""Benchmark suite on the GPU: one JSON line per scene, headline last.

Scenes:
  cornell     512x512/4spp/4d analytic interior (reference default-app class)
  box_field   512x512/2spp/4d ~410k-tri field (Kitchen-Set-class geometry)
  coffeetable 512x512/2spp/4d textured-material USD stage (usda ingestion)
  kitchen     512x512/2spp/4d generated binary-usdc interior, textured
  hair_patch  384x384/2spp/4d ~10k cone subsegments (hairmat/einar class)
  hair_long   384x384/2spp/4d ~800k cone subsegments

Ray accounting: per pixel sample and bounce the integrator traces one
radiance ray (closest-hit sweep) and one NEE shadow ray (any-hit sweep); all
lanes run every bounce (masked SIMD), so rays = W*H*spp*2*depth per launch.

Timing: launches chained, ending in block_until_ready. Every row names the
device (platform, device_kind, card count) and the card's nvidia-smi name
and power limit. The run exits non-zero when JAX finds no GPU, and a scene
that fails fails the run.

The final line is the headline (cornell alive Mrays/s per card) with a
per-scene summary and the SSIM of each scene against its CPU golden.
"""

from __future__ import annotations

import json
import os
import sys
import time


def build_host_scene(name: str):
    """ONE host-scene construction per bench scene — the bench rows and the
    per-scene golden SSIM render the SAME variant by construction."""
    from strelka_tpu.scene import testscenes as TS

    if name == "cornell":
        return TS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True)
    if name == "box_field":
        return TS.box_field(grid=48)
    if name == "hair_patch":
        return TS.hair_patch(n_curves=256)
    if name == "hair_long":
        # einar-class scale: 20k strands -> 100k cubic segments (~800k cones)
        return TS.hair_patch(n_curves=20000)
    if name == "coffeetable":
        from strelka_tpu.loaders.usd import UsdLoader
        from strelka_tpu.scene.scene import Scene

        host = Scene()
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "scenes", "coffeetable.usda")
        if not UsdLoader().load(path, host):
            raise RuntimeError("coffeetable.usda failed to load")
        return host
    if name == "kitchen":
        # Kitchen-Set-class interior (>=100k tris, 10 materials, 4 textures,
        # 4 lights) ingested from a generated BINARY usdc stage — the full
        # crate-reader + material-network + texture-atlas path at scale
        from strelka_tpu.loaders.usd import UsdLoader
        from strelka_tpu.scene.kitchen_gen import ensure_kitchen
        from strelka_tpu.scene.scene import Scene

        host = Scene()
        if not UsdLoader().load(ensure_kitchen(), host):
            raise RuntimeError("kitchen.usdc failed to load")
        return host
    raise ValueError(name)


def build_scene(name: str, width: int, height: int):
    import jax.numpy as jnp

    from strelka_tpu.ops import integrator as I
    from strelka_tpu.render.device_scene import build_device_scene

    host = build_host_scene(name)
    scene = build_device_scene(host)
    cam = host.get_camera(0)
    cam.update_aspect_ratio(width / height)
    params = I.LaunchParams(
        subframe_index=jnp.int32(0),
        clip_to_view=jnp.asarray(cam.clip_to_view(), jnp.float32),
        view_to_world=jnp.asarray(cam.view_to_world(), jnp.float32),
        exposure=jnp.asarray([6.25e-4] * 3, jnp.float32),
        bg_color=jnp.zeros(3, jnp.float32),
    )
    return scene, params


def bench_scene(name: str, width: int, height: int, spp: int, depth: int, iters: int,
                stats: bool = True):
    import jax
    import numpy as np

    from strelka_tpu.ops import integrator as I

    scene, params = build_scene(name, width, height)
    state = I.make_frame_state(height, width)

    def step(scene, params, state):
        return I.render_launch(
            scene, params, state, width=width, height=height,
            samples_per_launch=spp, max_sample_count=100000, max_depth=depth,
            enable_accumulation=True,
        )

    fn = jax.jit(step, donate_argnums=(2,))
    t0 = time.perf_counter()
    state, image = jax.block_until_ready(fn(scene, params, state))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = state
    for _ in range(iters):
        st, image = fn(scene, params, st)
    jax.block_until_ready(image)
    dt = (time.perf_counter() - t0) / iters
    rays = width * height * spp * 2 * depth
    img = np.asarray(image)

    # Honest lane accounting (the wavefront is masked SIMD: the dense count
    # above includes dead lanes). One instrumented launch — same config, a
    # representative mid-accumulation subframe — counts lanes actually alive
    # at each closest sweep + shadow rays actually cast.
    def stat_step(scene, params, state):
        return I.render_launch(
            scene, params, state, width=width, height=height,
            samples_per_launch=spp, max_sample_count=100000, max_depth=depth,
            enable_accumulation=True, collect_stats=True,
        )

    # The stats launch is a SECOND full compile of the scene (different
    # jaxpr), so a config can opt out.
    if stats:
        _, _, st_out = jax.jit(stat_step)(scene, params, st)
        alive_rays = float(st_out["closest_rays"]) + float(st_out["shadow_rays"])
    else:
        alive_rays = -1.0
    return {
        **device_fields(),
        "scene": name,
        "tris": int(scene.num_triangles),
        "curve_segments": int(scene.num_curve_segments),
        "mrays_per_sec": round(rays / dt / 1e6, 2),
        "alive_mrays_per_sec": round(alive_rays / dt / 1e6, 2) if alive_rays >= 0 else -1.0,
        "alive_ray_frac": round(alive_rays / rays, 3) if alive_rays >= 0 else -1.0,
        "ms_per_launch": round(dt * 1e3, 2),
        "config": f"{width}x{height} spp={spp} depth={depth}",
        "compile_s": round(compile_s, 1),
        "finite": bool(np.isfinite(img).all()),
        "mean": round(float(img.mean()), 5),
    }


# per-scene golden configs (width, height, spp per launch, launches) —
# small enough to render on CPU (scripts/gen_goldens.py) AND cheap to
# re-render at bench time on the current backend for a per-scene SSIM
GOLDEN_CONFIGS = {
    "cornell": (64, 64, 4, 4),
    "box_field": (64, 64, 4, 4),
    # specular-heavy scenes need more spp: at fewer spp individual firefly
    # paths that diverge across backends (float op order on borderline
    # glossy bounces) dominate SSIM at 64^2
    "coffeetable": (64, 64, 4, 16),
    "hair_patch": (64, 64, 4, 16),
    "kitchen": (64, 64, 2, 8),
    # einar-class curve scale (100k cubic segments); no golden is committed
    # yet (golden_ssim returns -1.0)
    "hair_long": (32, 32, 2, 4),
}


def render_golden_config(name: str):
    """Render a bench scene at its golden config on the CURRENT backend
    -> [H, W, 3] f32 in [0, 1] (the library-API path, not the bare
    integrator — the same frames a user's Render produces)."""
    import numpy as np

    from strelka_tpu.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu.render.render import RenderFactory
    from strelka_tpu.settings import SharedContext, make_default_settings

    w, h, spp, launches = GOLDEN_CONFIGS[name]
    s = make_default_settings(w, h)
    s.set("render/pt/sppTotal", spp * launches)
    s.set("render/pt/spp", spp)
    r = RenderFactory.create_render()
    r.set_scene(build_host_scene(name))
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))
    for _ in range(launches):
        r.render(buf)
    return np.clip(np.asarray(buf.map())[..., :3], 0.0, 1.0)


def golden_ssim(name: str = "cornell") -> float:
    """SSIM of the current-backend render vs the stored CPU golden (per-scene
    cross-backend fidelity of the same renderer; absolute radiometry is
    pinned separately by the analytic oracles in
    tests/test_radiometric_oracle.py)."""
    from strelka_tpu.utils.image import read_png, ssim

    gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
    golden_path = os.path.join(gdir, f"{name}_golden.png")
    if not os.path.exists(golden_path) and name == "cornell":
        golden_path = os.path.join(gdir, "cornell_64_16spp.png")
    if not os.path.exists(golden_path):
        return -1.0
    img = render_golden_config(name)
    golden = read_png(golden_path)[..., :3]
    return float(ssim(img, golden))


def device_fields() -> dict:
    """The device every row ran on: JAX's view and nvidia-smi's."""
    import subprocess

    import jax

    d = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": smi[0] if smi else "",
    }


def main() -> int:
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU (JAX found {jax.devices()[0].platform})", file=sys.stderr)
        return 2
    quick = "--quick" in sys.argv
    n_chips = max(jax.device_count(), 1)
    results = {}
    configs = [
        ("cornell", 512, 512, 4, 4, 16, True),
        ("box_field", 512, 512, 2, 4, 4, True),
        ("coffeetable", 512, 512, 2, 4, 8, True),
        ("kitchen", 512, 512, 2, 4, 4, True),
        ("hair_patch", 384, 384, 2, 4, 4, True),
        ("hair_long", 384, 384, 2, 4, 2, True),
    ]
    if quick:
        configs = [("cornell", 256, 256, 2, 4, 8, True)]
    for name, w, h, spp, depth, iters, stats in configs:
        row = bench_scene(name, w, h, spp, depth, iters, stats=stats)
        print(json.dumps(row), flush=True)
        results[name] = row

    ssims = {}
    for name in results:
        if name not in GOLDEN_CONFIGS or quick and name != "cornell":
            continue
        ssims[name] = round(golden_ssim(name), 4)

    head = results.get("cornell", {})
    # HEADLINE = alive-ray throughput (rays that actually needed tracing:
    # lanes alive at each closest sweep + shadow rays actually cast, counted
    # by the instrumented stats launch). The padded masked-SIMD count
    # (W*H*spp*2*depth, dead lanes included) is reported alongside.
    alive = head.get("alive_mrays_per_sec", -1.0)
    padded = head.get("mrays_per_sec", 0.0)
    value = (alive if alive >= 0 else padded) / n_chips
    print(
        json.dumps(
            {
                **device_fields(),
                "metric": "cornell_box_alive_mrays_per_sec_per_chip",
                "value": round(value, 2),
                "unit": "Mrays/s/chip",
                "padded_mrays_per_sec": round(padded / n_chips, 2),
                "config": head.get("config", ""),
                "ms_per_launch": head.get("ms_per_launch", -1.0),
                "ssim_vs_cpu_golden": ssims.get("cornell", -1.0),
                "scenes": {
                    k: dict(
                        {
                            kk: v[kk]
                            for kk in (
                                "alive_mrays_per_sec",
                                "mrays_per_sec",
                                "ms_per_launch",
                                "tris",
                                "curve_segments",
                                "alive_ray_frac",
                            )
                            if kk in v
                        },
                        **({"ssim": ssims[k]} if k in ssims else {}),
                    )
                    for k, v in results.items()
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
