"""Render the showcase images (images/) with the current renderer on the default device."""
import sys, time
import numpy as np
sys.path.insert(0, ".")
import jax, jax.numpy as jnp
from strelka_tpu.ops import integrator as I
from strelka_tpu.ops import tonemap as TM
from strelka_tpu.render.device_scene import build_device_scene
from strelka_tpu.scene import testscenes as TS
from strelka_tpu.utils.image import write_png

def render(name, host, spp_total, spl, depth, W=512, H=512, exposure=6.25e-4, bg=0.0):
    scene = build_device_scene(host)
    cam = host.get_camera(0); cam.update_aspect_ratio(W / H)
    params = I.LaunchParams(subframe_index=jnp.int32(0),
        clip_to_view=jnp.asarray(cam.clip_to_view(), jnp.float32),
        view_to_world=jnp.asarray(cam.view_to_world(), jnp.float32),
        exposure=jnp.asarray([exposure]*3, jnp.float32), bg_color=jnp.full(3, bg, jnp.float32))
    state = I.make_frame_state(H, W)
    def step(scene, params, state):
        st, img = I.render_launch(scene, params, state, width=W, height=H,
            samples_per_launch=spl, max_sample_count=spp_total, max_depth=depth,
            enable_accumulation=True)
        img = TM.apply_tonemap_planar(img, TM.ToneMapperType.eReinhard, params.exposure, 2.4)
        return st, img
    fn = jax.jit(step)
    t0 = time.perf_counter()
    for i in range(spp_total // spl):
        state, img = fn(scene, params, state)
        params = params._replace(subframe_index=params.subframe_index + spl)
    out = np.clip(np.asarray(img).transpose(1, 2, 0), 0, 1)
    dt = time.perf_counter() - t0
    path = f"images/{name}_{spp_total}spp_{depth}d.png"
    write_png(path, out)  # default flip matches app screenshot orientation
    print(f"{path}: {dt:.1f}s", flush=True)

render("cornell", TS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True), 512, 8, 4)
# coffeetable via USD
from strelka_tpu.loaders.usd import UsdLoader
from strelka_tpu.scene.scene import Scene
host = Scene()
UsdLoader().load("data/scenes/coffeetable.usda", host)
render("coffeetable", host, 512, 8, 4)
render("hair_patch", TS.hair_patch(n_curves=256), 128, 4, 4, exposure=8e-4, bg=0.35)
render("box_field", TS.box_field(grid=48), 32, 2, 4, exposure=2e-4)

# Kitchen-class interior (multi-material/multi-texture USD stage, 2 sphere
# lights) — the reference's headline scene class (images/Kitchen_*.png)
from strelka_tpu.scene.kitchen_gen import ensure_kitchen
host = Scene()
UsdLoader().load(ensure_kitchen(), host)
render("kitchen", host, 64, 2, 4, exposure=1.2e-3, bg=0.02)
