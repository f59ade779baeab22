"""North-star render: Kitchen at the reference's converged config.

The reference's headline showcase is Kitchen Set at 2048 iterations / depth 4 /
2048 spp (`/root/reference/images/Kitchen_2048i_4d_2048spp_0.png`, naming
scheme hdRunner/main.cpp:729-733). This renders the bench kitchen stage at the
same spp/depth on the default device (the GPU), checkpointed every
--ckpt-every launches so a restart resumes instead of restarting, and records
wall-clock + Mrays/s to northstar.json.

  python scripts/northstar.py [--spp 2048] [--depth 4] [--w 1024 --h 768]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# checkpoint inside the checkout (gitignored), not in a temporary directory
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    ".northstar_kitchen.npz")
OUT_JSON = "northstar.json"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=2048)
    ap.add_argument("--spl", type=int, default=2, help="spp per launch")
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--w", type=int, default=1024)
    ap.add_argument("--h", type=int, default=768)
    ap.add_argument("--ckpt-every", type=int, default=64, help="launches")
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="wall-clock budget; 0 = unbounded. On expiry the run "
                         "checkpoints and exits cleanly (resume by re-running).")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from strelka_tpu.loaders.usd import UsdLoader
    from strelka_tpu.ops import integrator as I
    from strelka_tpu.ops import tonemap as TM
    from strelka_tpu.render.checkpoint import load_checkpoint, save_checkpoint
    from strelka_tpu.render.device_scene import build_device_scene
    from strelka_tpu.scene.kitchen_gen import ensure_kitchen
    from strelka_tpu.scene.scene import Scene
    from strelka_tpu.utils.image import write_png

    W, H = args.w, args.h
    host = Scene()
    assert UsdLoader().load(ensure_kitchen(), host)
    scene = build_device_scene(host)
    cam = host.get_camera(0)
    cam.update_aspect_ratio(W / H)
    params = I.LaunchParams(
        subframe_index=jnp.int32(0),
        clip_to_view=jnp.asarray(cam.clip_to_view(), jnp.float32),
        view_to_world=jnp.asarray(cam.view_to_world(), jnp.float32),
        exposure=jnp.asarray([6.25e-4] * 3, jnp.float32),
        bg_color=jnp.full(3, 0.1, jnp.float32),
    )
    start_launch = 0
    elapsed_prev = 0.0
    if os.path.exists(CKPT):
        state, sub = load_checkpoint(CKPT)
        start_launch = sub // args.spl
        if os.path.exists(CKPT + ".meta"):
            with open(CKPT + ".meta") as f:
                elapsed_prev = json.load(f).get("elapsed_s", 0.0)
        print(f"resuming at launch {start_launch} ({sub} spp, {elapsed_prev:.0f}s so far)", flush=True)
    else:
        state = I.make_frame_state(H, W)

    def step(scene, params, state):
        return I.render_launch(
            scene, params, state, width=W, height=H,
            samples_per_launch=args.spl, max_sample_count=args.spp,
            max_depth=args.depth, enable_accumulation=True,
        )

    fn = jax.jit(step, donate_argnums=(2,))
    n_launches = args.spp // args.spl
    t0 = time.perf_counter()
    params = params._replace(subframe_index=jnp.int32(start_launch * args.spl))
    img = state.accum  # a finished checkpoint resumes straight to the image
    for i in range(start_launch, n_launches):
        state, img = fn(scene, params, state)
        params = params._replace(subframe_index=params.subframe_index + args.spl)
        if (i + 1) % args.ckpt_every == 0 or i == n_launches - 1:
            jax.block_until_ready(img)
            el = elapsed_prev + (time.perf_counter() - t0)
            save_checkpoint(CKPT, state, (i + 1) * args.spl)
            with open(CKPT + ".meta", "w") as f:
                json.dump({"elapsed_s": el}, f)
            print(f"launch {i+1}/{n_launches} ({(i+1)*args.spl} spp) elapsed {el:.0f}s", flush=True)
            # interim north-star row at every checkpoint: a session cut
            # mid-run still records honest progress (spp_done < spp marks
            # it in-progress; the completion path below overwrites)
            done_spp = (i + 1) * args.spl
            with open(OUT_JSON, "w") as f:
                json.dump({
                    "metric": "northstar_kitchen_wall_clock",
                    "value": round(el, 1),
                    "unit": "s",
                    "config": f"{W}x{H} {args.spp}spp depth={args.depth}",
                    "spp_done": done_spp,
                    "complete": done_spp >= args.spp,
                    "projected_total_s": round(el * args.spp / done_spp, 1),
                    "reference_config": "images/Kitchen_2048i_4d_2048spp_0.png (hdRunner/main.cpp:729-733)",
                }, f, indent=1)
            if args.max_seconds and (time.perf_counter() - t0) > args.max_seconds:
                print(f"wall-clock budget reached at {done_spp} spp; checkpointed — rerun to resume", flush=True)
                return

    img = TM.apply_tonemap_planar(img, TM.ToneMapperType.eReinhard, params.exposure, 2.4)
    out = np.clip(np.asarray(img).transpose(1, 2, 0), 0, 1)
    elapsed = elapsed_prev + (time.perf_counter() - t0)
    path = f"images/kitchen_{args.spp}spp_{args.depth}d_{W}x{H}.png"
    write_png(path, out)
    rays = W * H * args.spp * 2 * args.depth
    row = {
        "metric": "northstar_kitchen_wall_clock",
        "value": round(elapsed, 1),
        "unit": "s",
        "config": f"{W}x{H} {args.spp}spp depth={args.depth}",
        "spp_done": args.spp,
        "complete": True,
        "padded_mrays_per_sec": round(rays / elapsed / 1e6, 2),
        "image": path,
        "reference_config": "images/Kitchen_2048i_4d_2048spp_0.png (hdRunner/main.cpp:729-733)",
    }
    with open(OUT_JSON, "w") as f:
        json.dump(row, f, indent=1)
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
