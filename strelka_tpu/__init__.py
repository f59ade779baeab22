"""strelka_tpu — a progressive physically-based path-tracing framework in JAX.

A ground-up re-design of the capabilities of the Strelka renderer
(reference: arhix52/Strelka, C++/OptiX/Metal):

* device compute path is JAX/XLA (wavefront path tracing, optionally
  pixel-sharded over a ``jax.sharding.Mesh`` of several cards),
* host orchestration is Python (scene model, loaders, settings, CLI),
* hot host-side preprocessing (BVH build, USD crate decoding) has a native
  C++ path.

Layer map (mirrors reference layers, see SURVEY.md §1):
  L0 device kernels   -> strelka_tpu.ops        (sampler, intersect, bsdf, ...)
  L1 host render      -> strelka_tpu.render     (Render, Buffer, factory)
  L2 materials        -> strelka_tpu.materials  (MaterialManager equivalent)
  L3 scene model      -> strelka_tpu.scene      (Scene, Camera, lights)
  L4 scene ingestion  -> strelka_tpu.loaders    (glTF, USDA subset)
  L5 Hydra-style      -> strelka_tpu.hydra      (render delegate shaped API)
  L6 applications     -> strelka_tpu.app        (CLI runner, usd_runner)
  X2 config           -> strelka_tpu.settings   (SettingsManager)
  X3 logging          -> strelka_tpu.log
"""

__version__ = "0.1.0"

import os as _os

# persistent XLA compilation cache of this checkout (a fixed path: the path
# is part of the cache key, so a directory that moves never hits)
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _enable_compilation_cache() -> None:
    """Persistent XLA compilation cache (the analog of the driver-side OptiX
    pipeline cache): repeated launch configs compile once per checkout.
    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    directory is set here; otherwise the cache is CACHE_DIR."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    try:
        _os.makedirs(CACHE_DIR, exist_ok=True)
    except OSError:  # read-only checkout: run without a persistent cache
        return
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


_enable_compilation_cache()

from strelka_tpu.settings import SettingsManager, SharedContext  # noqa: F401
