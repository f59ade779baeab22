"""chip_smoke.py: refuses to run without a GPU, and its phases run at a
tiny size on the CPU (the same code the card runs at full size)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_main_exits_nonzero_without_gpu(capsys):
    assert jax.devices()[0].platform == "cpu"
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails_without_the_repo(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script exits non-zero and prints no result line."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_phase_device():
    info = chip_smoke.phase_device()
    assert info["platform"] == "cpu" and info["count"] >= 1
    assert info["compile_cache"]


def test_phase_main_path_tiny(tmp_path):
    rows = chip_smoke.phase_main_path(str(tmp_path), width=24, height=16, depth=2,
                                      launches=2, runner_launches=1)
    for tag in ("cli", "usd_runner"):
        assert rows[tag]["finite"] and rows[tag]["textures"] >= 4
        assert rows[tag]["intersectors"]["triangles"] == "bvh"
    assert (tmp_path / "kitchen.png").exists()
    assert (tmp_path / "kitchen_usd_runner.png").exists()


def test_phase_kernels_tiny():
    out = chip_smoke.phase_kernels(box_grid=4, bvh_cam=(12, 8, 1), kitchen_cam=(8, 8, 1),
                                   hair_cam=(12, 8, 1), n_bf=96, n_ref=32, n_lanes=777)
    assert out["box_field"]["camera"]["vs_numpy_f64"]["agree"] == 1.0
    assert out["random_dims"]["mismatches"] == 0
    assert out["gather_attr"]["exact"]
    assert max(out["tonemap"].values()) <= 1e-6


def test_agreement_allows_only_rare_mismatches():
    n = 10000
    hit = np.ones(n, bool)
    prim = np.arange(n)
    t = np.ones(n)
    row = chip_smoke._agreement("ok", hit, prim, t, hit, prim, t * (1 + 5e-5))
    assert row["agree"] == 1.0
    t2 = t.copy()
    t2[:20] *= 1.01  # 0.2% of rays off in t: fails
    with pytest.raises(chip_smoke.CheckFailed):
        chip_smoke._agreement("bad", hit, prim, t2, hit, prim, t)


def test_render_band_equals_rows_of_full_frame():
    """A pixel-row band rendered with its global row offset (the sharded
    launch) equals those rows of the full frame bitwise, textures included:
    the stochastic texture filter is keyed by the global lane id."""
    import dataclasses

    from strelka_tpu.materials import MaterialManager
    from strelka_tpu.ops import integrator as I
    from strelka_tpu.render.device_scene import build_device_scene, rejoin_attr_tables
    from strelka_tpu.scene.testscenes import cornell_box
    from strelka_tpu.textures import TextureManager

    host = cornell_box(light_intensity=5000.0)
    mm = MaterialManager()
    mm.texture_manager = TextureManager()
    rng = np.random.default_rng(0)
    tid = mm.texture_manager.add_array(rng.uniform(size=(16, 16, 3)))
    scene = build_device_scene(host, mm)
    # every material's diffuse texture (mat_table column 12) -> the noise
    scene = rejoin_attr_tables(
        dataclasses.replace(scene, mat_table=scene.mat_table.at[:, 12].set(float(tid)))
    )
    cam = host.get_camera(0)
    params = I.LaunchParams(
        subframe_index=jnp.int32(0),
        clip_to_view=jnp.asarray(cam.clip_to_view(), jnp.float32),
        view_to_world=jnp.asarray(cam.view_to_world(), jnp.float32),
        exposure=jnp.asarray([1e-3] * 3),
        bg_color=jnp.zeros(3),
    )
    w, h, band = 16, 16, 8

    def launch(height, offset):
        return jax.jit(lambda s, p, st: I.render_launch(
            s, p, st, width=w, height=height, samples_per_launch=2, max_sample_count=8,
            max_depth=2, enable_accumulation=True,
            py_offset=None if offset is None else jnp.uint32(offset), full_height=h,
        ))(scene, params, I.make_frame_state(height, w))[1]

    full = np.asarray(launch(h, None))
    part = np.asarray(launch(band, band))
    np.testing.assert_array_equal(part, full[:, band:])


@pytest.mark.gpu
def test_kernel_checks_on_gpu(gpu):
    """On a card: the phase-4 checks at a reduced size."""
    chip_smoke.phase_kernels(box_grid=16, bvh_cam=(128, 128, 1), kitchen_cam=(128, 96, 1),
                             hair_cam=(128, 128, 1), n_bf=4096, n_ref=256, n_lanes=65536)
