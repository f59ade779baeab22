"""Emit the north-star kitchen PNG from the render checkpoint — no accelerator
needed (the accumulator in .northstar_kitchen.npz is already the mean
radiance; tonemap runs on CPU). Lets a budget-bounded northstar.py run
publish its partially-converged showcase image at any point.

  python scripts/northstar_image.py [out.png]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from strelka_tpu.ops import tonemap as TM
from strelka_tpu.render.checkpoint import load_checkpoint
from strelka_tpu.utils.image import write_png

CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    ".northstar_kitchen.npz")


def main():
    state, spp = load_checkpoint(CKPT)
    img = TM.apply_tonemap_planar(
        jnp.asarray(state.accum), TM.ToneMapperType.eReinhard,
        jnp.asarray([6.25e-4] * 3, jnp.float32), 2.4,
    )
    out = np.clip(np.asarray(img).transpose(1, 2, 0), 0, 1)
    h, w = out.shape[:2]
    path = sys.argv[1] if len(sys.argv) > 1 else f"images/kitchen_{spp}spp_4d_{w}x{h}.png"
    write_png(path, out)
    print(f"wrote {path} ({spp} spp, mean={out.mean():.4f})")


if __name__ == "__main__":
    main()
