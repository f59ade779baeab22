"""Manual smoke render (CPU; --gpu for the default device): python tests/smoke_cornell.py [W H spp] [--png]"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--gpu" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import time

import numpy as np


def main():
    from strelka_tpu.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu.render.render import RenderFactory
    from strelka_tpu.scene.testscenes import cornell_box
    from strelka_tpu.settings import SharedContext, make_default_settings

    W = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    H = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    spp = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    s = make_default_settings(W, H)
    s.set("render/pt/sppTotal", spp)
    s.set("render/pt/spp", spp)
    ctx = SharedContext(s)
    scene = cornell_box()
    render = RenderFactory.create_render()
    render.set_scene(scene)
    render.set_shared_context(ctx)
    render.init()
    buf = render.create_buffer(BufferDesc(W, H, BufferFormat.FLOAT4))
    t0 = time.time()
    render.render(buf)
    img = buf.map()
    t1 = time.time()
    print(f"render+compile {t1 - t0:.1f}s")
    rgb = img[..., :3]
    print("shape", img.shape, "min %.4f max %.4f mean %.4f" % (rgb.min(), rgb.max(), rgb.mean()))
    print("nan?", np.isnan(img).any())
    # second frame (cached compile)
    t0 = time.time()
    render.render(buf)
    buf.map()
    print(f"second frame {time.time() - t0:.2f}s; subframe={ctx.subframe_index}")
    if "--png" in sys.argv:
        from strelka_tpu.utils.image import write_png

        write_png("/tmp/cornell.png", img[..., :3])
        print("wrote /tmp/cornell.png")


if __name__ == "__main__":
    main()
