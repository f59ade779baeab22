"""Tonemapping, exposure, and progressive accumulation — XLA elementwise ops.

Ports: src/render/optix/postprocessing/Tonemappers.cu (Reinhard, ACES fitted,
ACES filmic, gamma), postprocessing/Utils.h (LDR-lerp accumulation helpers),
and the photographic exposure computation (OptixRender.cpp:956-987).

All functions take/return [..., 3] float32 arrays and are jit-safe. The
colour matrices are applied as explicit weighted sums, not as dot products:
a float32 dot may be lowered to a reduced-precision (TF32) matrix unit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


class ToneMapperType:
    """Matches the settings encoding (app/main.cpp:306, Display.cpp combo)."""

    eReinhard = 0
    eACES = 1
    eFilmic = 2
    eNone = 3


def calc_luminance(color: jnp.ndarray) -> jnp.ndarray:
    """Tonemappers.cu:6-9."""
    return 0.299 * color[..., 0] + 0.587 * color[..., 1] + 0.114 * color[..., 2]


def reinhard(color: jnp.ndarray) -> jnp.ndarray:
    """Tonemappers.cu:11-15 (luminance-based)."""
    return color / (calc_luminance(color)[..., None] + 1.0)


def aces_film(x: jnp.ndarray) -> jnp.ndarray:
    """Narkowicz ACES filmic fit (Tonemappers.cu:30-38)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


_ACES_INPUT = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    dtype=np.float32,
)
_ACES_OUTPUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    dtype=np.float32,
)


def _mat3(m: np.ndarray, c) -> list:
    """3x3 matrix times the colour whose channels are c[0], c[1], c[2]."""
    return [
        float(m[i, 0]) * c[0] + float(m[i, 1]) * c[1] + float(m[i, 2]) * c[2]
        for i in range(3)
    ]


def _aces_rrt_odt(c):
    a = c * (c + 0.0245786) - 0.000090537
    b = c * (0.983729 * c + 0.4329510) + 0.238081
    return a / b


def aces_fitted(color: jnp.ndarray) -> jnp.ndarray:
    """Stephen Hill ACES fit (Tonemappers.cu:52-85). Matrices verbatim."""
    c = _mat3(_ACES_INPUT, [color[..., k] for k in range(3)])
    c = _mat3(_ACES_OUTPUT, [_aces_rrt_odt(x) for x in c])
    return jnp.clip(jnp.stack(c, axis=-1), 0.0, 1.0)


def gamma_correction(color: jnp.ndarray, gamma: float) -> jnp.ndarray:
    """Tonemappers.cu:99-109."""
    return jnp.power(jnp.maximum(color, 0.0), 1.0 / gamma)


def apply_tonemap(image: jnp.ndarray, tonemapper_type: int, exposure, gamma: float) -> jnp.ndarray:
    """Host dispatch equivalent of tonemap() (Tonemappers.cu:111-135).

    tonemapper_type and gamma are static Python values (settings are
    recompile triggers, matching the reference's host-side switch).
    """
    exposure = jnp.asarray(exposure, jnp.float32)
    if tonemapper_type == ToneMapperType.eReinhard:
        image = reinhard(image * exposure)
    elif tonemapper_type == ToneMapperType.eACES:
        image = aces_fitted(image * exposure)
    elif tonemapper_type == ToneMapperType.eFilmic:
        image = aces_film(image * exposure)
    if gamma > 0.0:
        image = gamma_correction(image, gamma)
    return image


# --- accumulation in LDR space (postprocessing/Utils.h:5-14) ---


def _tm(color: jnp.ndarray, exposure: jnp.ndarray) -> jnp.ndarray:
    color = color * exposure
    return color / (color + 1.0)


def _inv_tm(color: jnp.ndarray, exposure: jnp.ndarray) -> jnp.ndarray:
    return color / (exposure - color * exposure)


def accumulate(
    history: jnp.ndarray,
    value: jnp.ndarray,
    exposure,
    subframe_index: jnp.ndarray,
) -> jnp.ndarray:
    """Running mean with the lerp-in-LDR-space trick (OptixRender.cu:60-78).

    history/value: [..., 3] float32. subframe_index: traced int scalar or
    per-pixel array ([...]) of already-accumulated sample counts. Returns the
    new history. When subframe_index == 0 the value is stored as-is.
    """
    exposure = jnp.asarray(exposure, jnp.float32)
    idx = jnp.asarray(subframe_index)
    if idx.ndim < value.ndim - 1:
        idx = jnp.broadcast_to(idx, value.shape[:-1])
    a = (1.0 / (idx.astype(jnp.float32) + 1.0))[..., None]
    lerped = _inv_tm(_tm(history, exposure) + (_tm(value, exposure) - _tm(history, exposure)) * a, exposure)
    return jnp.where((idx > 0)[..., None], lerped, value)


# --- planar ([3, H, W]) variants used by the device hot path -------------


def _lum_planar(color):
    return 0.299 * color[0] + 0.587 * color[1] + 0.114 * color[2]


def apply_tonemap_planar(image: jnp.ndarray, tonemapper_type: int, exposure, gamma: float) -> jnp.ndarray:
    """apply_tonemap for planar [3, H, W] images (lane-friendly layout)."""
    exposure = jnp.asarray(exposure, jnp.float32).reshape(3, 1, 1)
    if tonemapper_type == ToneMapperType.eReinhard:
        c = image * exposure
        image = c / (_lum_planar(c)[None] + 1.0)
    elif tonemapper_type == ToneMapperType.eACES:
        c = image * exposure
        c = _mat3(_ACES_INPUT, [c[0], c[1], c[2]])
        c = _mat3(_ACES_OUTPUT, [_aces_rrt_odt(x) for x in c])
        image = jnp.clip(jnp.stack(c), 0.0, 1.0)
    elif tonemapper_type == ToneMapperType.eFilmic:
        x = image * exposure
        image = jnp.clip((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    if gamma > 0.0:
        image = jnp.power(jnp.maximum(image, 0.0), 1.0 / gamma)
    return image


def planar_to_hwc(image: jnp.ndarray) -> jnp.ndarray:
    """[3, H, W] -> [H, W, 3] (display/PNG boundary, once per frame)."""
    return jnp.transpose(image, (1, 2, 0))


def compute_exposure_value(settings) -> np.ndarray:
    """Photographic exposure from ISO/fStop/shutter (OptixRender.cpp:956-987)."""
    film_iso = settings.get_float("render/post/tonemapper/filmIso")
    cm2_factor = settings.get_float("render/post/tonemapper/cm2_factor")
    f_stop = settings.get_float("render/post/tonemapper/fStop")
    shutter_speed = settings.get_float("render/post/tonemapper/shutterSpeed")
    white_point = np.array([1.0, 1.0, 1.0], dtype=np.float32)
    exposure_value = np.where(np.all(white_point != 0.0), 1.0 / white_point, np.ones(3, np.float32))
    lum = float(np.dot(exposure_value, [0.299, 0.587, 0.114]))
    if film_iso > 0.0:
        exposure_value = exposure_value * (cm2_factor * film_iso / (shutter_speed * f_stop * f_stop) / 100.0)
    else:
        exposure_value = exposure_value * cm2_factor
    return (exposure_value / lum).astype(np.float32)
