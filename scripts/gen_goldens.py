"""Generate small CPU golden renders for every bench scene.

The goldens are CPU renders of THIS renderer, so SSIM against them (bench.py,
chip_smoke.py) is a per-scene cross-backend (GPU-vs-CPU) fidelity check —
absolute radiometry is pinned externally by the closed-form oracles in
tests/test_radiometric_oracle.py.

Run on CPU:  python scripts/gen_goldens.py [scene ...]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

from bench import GOLDEN_CONFIGS, render_golden_config

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "goldens")


def main():
    from strelka_tpu.utils.image import write_png

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    names = sys.argv[1:] or list(GOLDEN_CONFIGS)
    for name in names:
        t0 = time.time()
        img = render_golden_config(name)
        out = os.path.join(GOLDEN_DIR, f"{name}_golden.png")
        write_png(out, img, flip=False)
        print(f"{name}: wrote {out} mean={img.mean():.4f} ({time.time()-t0:.0f}s)", flush=True)


if __name__ == "__main__":
    main()
