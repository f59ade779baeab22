"""The backend module's choice of intersector, the compile-cache placement,
and the wavefront reordering options (image-neutral, off by default)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from strelka_tpu.ops import backend as BK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("has_curves", [False, True])
@pytest.mark.parametrize(
    "ntri,expect",
    [
        (0, None),
        (12, BK.TRIANGLES_BRUTEFORCE),
        (BK.BVH_MIN_TRIANGLES, BK.TRIANGLES_BRUTEFORCE),
        (BK.BVH_MIN_TRIANGLES + 1, BK.TRIANGLES_BVH),
        (411_000, BK.TRIANGLES_BVH),
    ],
)
def test_choice_by_triangle_count_and_curves(ntri, expect, has_curves):
    got = BK.choose_intersectors(ntri, has_curves)
    assert got.triangles == expect
    assert got.curves == (BK.CURVES_SWEEP if has_curves else None)


def test_device_scene_on_gpu_backend_builds_bvh_without_pallas():
    """With JAX reporting a GPU backend, build_device_scene still takes the
    scene-size decision (BVH above the threshold, brute force below, cone
    sweep for curves) and never imports Pallas."""
    code = """
import sys, jax
jax.default_backend = lambda: "gpu"
from strelka_tpu.ops.backend import describe
from strelka_tpu.render.device_scene import build_device_scene
from strelka_tpu.scene import testscenes as TS
big = describe(build_device_scene(TS.box_field(grid=4)))
small = describe(build_device_scene(TS.cornell_box()))
hair = describe(build_device_scene(TS.hair_patch(n_curves=4)))
print(big.triangles, small.triangles, hair.triangles, hair.curves)
print(any(m.startswith("jax.experimental.pallas") for m in sys.modules))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-2].split() == ["bvh", "bruteforce", "bruteforce", "cone_sweep"]
    assert lines[-1] == "False"


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import strelka_tpu

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        strelka_tpu._enable_compilation_cache()
        assert jax.config.jax_compilation_cache_dir == strelka_tpu.CACHE_DIR
        assert strelka_tpu.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_environment(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the program sets no directory of
    its own and compiled programs land in the named one."""
    code = """
import jax, jax.numpy as jnp
import strelka_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
print(jax.config.jax_compilation_cache_dir)
jax.jit(lambda x: jnp.sin(x) * 3.0 + x)(jnp.arange(1000.0)).block_until_ready()
"""
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == str(cache)
    assert cache.exists() and any(cache.iterdir())
    assert not os.path.exists(os.path.join(str(tmp_path), ".jax_cache"))


def _cornell_launch(**opts):
    from strelka_tpu.ops import integrator as I
    from strelka_tpu.render.device_scene import build_device_scene
    from strelka_tpu.scene.testscenes import cornell_box

    host = cornell_box(light_intensity=5000.0)
    cam = host.get_camera(0)
    params = I.LaunchParams(
        subframe_index=jnp.int32(0),
        clip_to_view=jnp.asarray(cam.clip_to_view(), jnp.float32),
        view_to_world=jnp.asarray(cam.view_to_world(), jnp.float32),
        exposure=jnp.asarray([1e-3] * 3),
        bg_color=jnp.zeros(3),
    )
    fn = jax.jit(lambda s, p, st: I.render_launch(
        s, p, st, width=20, height=16, samples_per_launch=2, max_sample_count=8,
        max_depth=3, enable_accumulation=True, **opts))
    _, img = fn(build_device_scene(host), params, I.make_frame_state(16, 20))
    return np.asarray(img)


@pytest.mark.parametrize("opt", ["sort_rays", "zorder_pixels"])
def test_wavefront_reordering_is_image_neutral(opt):
    """The Morton re-sort of bounce rays and the Z-order pixel enumeration
    only permute lanes: the image matches the default launch."""
    base = _cornell_launch()
    img = _cornell_launch(**{opt: True})
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, base, atol=1e-4)


def test_ray_sort_key_orders_by_position_then_octant():
    from strelka_tpu.ops import integrator as I
    from strelka_tpu.ops.vec import Vec3

    class _S:
        world_lo, world_hi = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)

    p = Vec3(jnp.asarray([0.0, 0.0, 0.9]), jnp.asarray([0.0, 0.0, 0.9]), jnp.asarray([0.0, 0.0, 0.9]))
    d = Vec3(jnp.asarray([1.0, -1.0, 1.0]), jnp.asarray([1.0, -1.0, 1.0]), jnp.asarray([1.0, -1.0, 1.0]))
    key = np.asarray(I._ray_sort_key(_S(), p, d))
    assert key.dtype == np.uint32
    assert key[0] & 7 == 7 and key[1] & 7 == 0  # octant in the low bits
    assert key[0] >> 3 == key[1] >> 3  # same cell
    assert key[2] >> 3 > key[0] >> 3  # far corner sorts later
    zorder, inv = I._pixel_zorder(6, 4)
    np.testing.assert_array_equal(np.sort(zorder), np.arange(24))
    np.testing.assert_array_equal(zorder[inv], np.arange(24))
