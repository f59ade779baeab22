"""Render backend — JAX equivalent of OptiXRender/MetalRender (layer L1).

Mirrors the per-frame flow of OptiXRender::render (OptixRender.cpp:874-1057):
frame-0 device-scene build (the GAS/IAS + SBT analog is build_device_scene),
camera/settings change detection resetting progressive accumulation
(:895-934), launch-budget computation (:989-1004), the launch itself (the
jitted wavefront integrator), and tonemap dispatch (:1045-1049).

The launch function is jit-compiled per static-config key (resolution, spp,
depth, debug view, tonemapper, ...) and cached — the analog of the OptiX
pipeline cache. Multi-chip execution shards pixel rows across a
jax.sharding.Mesh (see strelka_tpu.parallel).
"""

from __future__ import annotations

import enum
import time
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from strelka_tpu import log
from strelka_tpu.materials import MaterialManager
from strelka_tpu.ops import integrator as I
from strelka_tpu.ops import tonemap as TM
from strelka_tpu.render.buffer import Buffer, BufferDesc
from strelka_tpu.render.device_scene import build_device_scene
from strelka_tpu.settings import SharedContext


class RenderType(enum.IntEnum):
    eTpu = 0


class Render:
    """Abstract backend interface (include/render/render.h:19-63)."""

    def __init__(self) -> None:
        self._scene = None
        self._ctx: Optional[SharedContext] = None

    def set_scene(self, scene) -> None:
        self._scene = scene

    def get_scene(self):
        return self._scene

    def set_shared_context(self, ctx: SharedContext) -> None:
        self._ctx = ctx

    def get_shared_context(self) -> SharedContext:
        return self._ctx

    def init(self) -> None:
        raise NotImplementedError

    def render(self, output: Buffer) -> None:
        raise NotImplementedError

    def create_buffer(self, desc: BufferDesc) -> Buffer:
        return Buffer(desc)

    def device_scene(self):
        """The built device scene (None before the first frame)."""
        return None


# Settings keys that reset accumulation when changed (OptixRender.cpp:910-934)
_WATCHED_KEYS = (
    "render/pt/depth",
    "render/pt/sppTotal",
    "render/pt/spp",
    "render/pt/rectLightSamplingMethod",
    "render/pt/enableAcc",
    "render/pt/debug",
    "render/pt/dev/shadowRayTmin",
    "render/pt/dev/materialRayTmin",
    "render/bgColor",
)


class TpuRender(Render):
    """The JAX/XLA wavefront path tracer."""

    def __init__(self, use_sharding: bool = False) -> None:
        super().__init__()
        self._device_scene = None
        self._state: Optional[I.FrameState] = None
        self._state_dims: Tuple[int, int] = (0, 0)
        self._prev_view: Optional[np.ndarray] = None
        self._prev_settings: Optional[tuple] = None
        self._launch_cache: Dict[tuple, object] = {}
        self._resume = False
        self._mesh = None
        self._use_sharding = use_sharding
        self.material_manager = MaterialManager()
        self.last_scene_build_s = 0.0  # host+upload seconds of the last device-scene build

    def device_scene(self):
        return self._device_scene

    # ------------------------------------------------------------------
    def init(self) -> None:
        if self._use_sharding:
            from strelka_tpu.parallel.sharding import make_render_mesh

            self._mesh = make_render_mesh()
        log.info("TpuRender init: devices={}", jax.devices())

    # ------------------------------------------------------------------
    def _settings_snapshot(self, s) -> tuple:
        return tuple(repr(s.get(k)) for k in _WATCHED_KEYS)

    def _build_launch(self, key: tuple):
        """Compile (and cache) a launch function for a static config key."""
        (width, height, spp, max_spp, depth, acc, rect_m, debug, tm_type, gamma, s_tmin, m_tmin) = key

        def make_launch(local_height, full_height):
            def launch(scene, params, state, py_offset=None):
                new_state, image = I.render_launch(
                    scene,
                    params,
                    state,
                    width=width,
                    height=local_height,
                    samples_per_launch=spp,
                    max_sample_count=max_spp,
                    max_depth=depth,
                    enable_accumulation=acc,
                    rect_light_sampling_method=rect_m,
                    shadow_ray_tmin=s_tmin,
                    material_ray_tmin=m_tmin,
                    debug=debug,
                    py_offset=py_offset,
                    full_height=full_height,
                )
                if debug == 0:
                    image = TM.apply_tonemap_planar(image, tm_type, params.exposure, gamma)
                elif gamma > 0.0 and debug in (2, 3):
                    image = TM.gamma_correction(image, gamma)
                # [3,H,W] -> [H,W,4] once per frame at the display boundary
                hwc = TM.planar_to_hwc(image)
                alpha = jnp.ones(hwc.shape[:-1] + (1,), jnp.float32)
                return new_state, jnp.concatenate([hwc, alpha], axis=-1)

            return launch

        if self._mesh is not None:
            from strelka_tpu.parallel.sharding import shard_launch

            fn = shard_launch(make_launch, self._mesh)
        else:
            launch = make_launch(height, height)

            def single(scene, params, state):
                return launch(scene, params, state)

            fn = jax.jit(single, donate_argnums=(2,))
        self._launch_cache[key] = fn
        return fn

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Persist the progressive accumulator (checkpoint/resume parity)."""
        from strelka_tpu.render.checkpoint import save_checkpoint

        if self._state is None:
            raise RuntimeError("nothing rendered yet")
        save_checkpoint(path, self._state, self._ctx.subframe_index)

    def load_checkpoint(self, path: str) -> None:
        from strelka_tpu.render.checkpoint import load_checkpoint

        state, subframe = load_checkpoint(path)
        self._state = state
        self._state_dims = tuple(state.accum.shape[1:])
        self._ctx.subframe_index = subframe
        # prime the change detectors so the next frame CONTINUES accumulating
        self._prev_settings = None
        self._resume = True

    # ------------------------------------------------------------------
    def render(self, output: Buffer) -> None:
        ctx = self._ctx
        settings = ctx.settings
        scene = self._scene
        out_width, out_height = output.width(), output.height()
        # upscale mode: path-trace at reduced internal resolution and
        # bilinear-upscale for display (render/pt/upscaleFactor semantics)
        upscale = settings.get_bool("render/pt/enableUpscale")
        factor = settings.get_float("render/pt/upscaleFactor") if upscale else 1.0
        width = max(int(out_width * factor) // 8 * 8, 8) if upscale else out_width
        height = max(int(out_height * factor) // 8 * 8, 8) if upscale else out_height

        # frame-0 / dirty scene: rebuild device arrays (GAS/SBT analog)
        if self._device_scene is None or scene.dirty:
            t0 = time.perf_counter()
            self._device_scene = jax.block_until_ready(
                build_device_scene(scene, self.material_manager)
            )
            self.last_scene_build_s = time.perf_counter() - t0
            scene.dirty = False
            if not self._resume:
                ctx.subframe_index = 0

        # resize -> reset (updatePathtracerParams, OptixRender.cpp:827-872)
        if self._state is None or self._state_dims != (height, width):
            self._state = I.make_frame_state(height, width)
            self._state_dims = (height, width)
            ctx.subframe_index = 0

        # camera: view change resets accumulation (OptixRender.cpp:895-908)
        camera = scene.get_camera(0)
        camera.update_aspect_ratio(width / height)
        view = camera.matrices.view
        if not self._resume and (self._prev_view is None or not np.allclose(view, self._prev_view)):
            ctx.subframe_index = 0
        self._prev_view = view.copy()
        self._resume = False

        # settings change resets accumulation (OptixRender.cpp:910-934)
        snap = self._settings_snapshot(settings)
        if self._prev_settings is not None and snap != self._prev_settings:
            ctx.subframe_index = 0
        self._prev_settings = snap

        enable_acc = settings.get_bool("render/pt/enableAcc")
        debug = settings.get_int("render/pt/debug")
        total_spp = settings.get_int("render/pt/sppTotal")
        spp = settings.get_int("render/pt/spp")
        left_spp = total_spp - ctx.subframe_index
        samples_this_launch = min(spp, left_spp) if enable_acc else spp
        if debug == 1:
            samples_this_launch, enable_acc = 1, False

        exposure = TM.compute_exposure_value(settings)
        tm_type = settings.get_int("render/pt/tonemapperType")
        if not settings.get_bool("render/pt/enableTonemap"):
            tm_type = TM.ToneMapperType.eNone
        gamma = settings.get_float("render/post/gamma")

        if samples_this_launch > 0:
            key = (
                width,
                height,
                samples_this_launch,
                max(total_spp, 1),
                settings.get_int("render/pt/depth"),
                enable_acc,
                settings.get_int("render/pt/rectLightSamplingMethod"),
                debug,
                tm_type,
                gamma,
                settings.get_float("render/pt/dev/shadowRayTmin"),
                settings.get_float("render/pt/dev/materialRayTmin"),
            )
            fn = self._launch_cache.get(key) or self._build_launch(key)
            params = I.LaunchParams(
                subframe_index=jnp.int32(ctx.subframe_index),
                clip_to_view=jnp.asarray(camera.clip_to_view(), jnp.float32),
                view_to_world=jnp.asarray(camera.view_to_world(), jnp.float32),
                exposure=jnp.asarray(exposure, jnp.float32),
                bg_color=jnp.asarray(settings.get("render/bgColor"), jnp.float32),
            )
            self._state, image = fn(self._device_scene, params, self._state)
            ctx.subframe_index += samples_this_launch
        else:
            # budget exhausted: re-emit accumulated buffer (OptixRender.cpp:1022-1049)
            if debug == 2:
                planar = self._state.diffuse
            elif debug == 3:
                planar = self._state.specular
            else:
                planar = self._state.accum
            if debug == 0:
                planar = TM.apply_tonemap_planar(planar, tm_type, jnp.asarray(exposure), gamma)
            elif gamma > 0.0:
                planar = TM.gamma_correction(planar, gamma)
            hwc = TM.planar_to_hwc(planar)
            alpha = jnp.ones(hwc.shape[:-1] + (1,), jnp.float32)
            image = jnp.concatenate([hwc, alpha], axis=-1)

        if (height, width) != (out_height, out_width):
            image = jax.image.resize(
                image, (out_height, out_width, image.shape[-1]), method="bilinear"
            )
        if settings.get_bool("render/enableValidation"):
            # validation mode parity (OptixRender.cpp:178-185): device NaN
            # canaries paint red pixels; host check reports them per frame
            nan_count = int(jnp.isnan(image).sum())
            canary = int((image[..., 0] >= 1e4).sum()) if image.ndim == 3 else 0
            if nan_count or canary:
                log.error(
                    "validation: {} NaN values, {} canary pixels in frame {}",
                    nan_count,
                    canary,
                    ctx.frame_number,
                )
        output.set_device(image)
        ctx.frame_number += 1


class RenderFactory:
    """render.cpp:10-35 — compile-time backend select becomes a registry."""

    @staticmethod
    def create_render(render_type: RenderType = RenderType.eTpu, **kwargs) -> Render:
        if render_type == RenderType.eTpu:
            return TpuRender(**kwargs)
        raise ValueError(f"Unknown render type {render_type}")
