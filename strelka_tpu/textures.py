"""Texture system: host-side manager + device atlas with filtered sampling.

The replacement for CUDA texture objects (OptixRender::loadTextureFromFile
stb->cudaArray + filtered tex objects, OptixRender.cpp:1191-1268, and the MDL
texture runtime tex_lookup_float4_2d, texture_support_cuda.h:287-528).

Design: textures keep their NATIVE resolution (capped at MAX_DIM); a full mip
chain is built per texture at pack time (box-filtered in linear space) and
every (texture, level) image is shelf-packed into ONE [H, W, 4] sheet. A
per-rect row table maps rect ids to sheet regions; rect id == texture id for
level 0, and a texture's levels 1..k occupy CONSECUTIVE rect ids starting at
its mip_base column — so level selection is pure arithmetic on one fat row
gather (see ops/vec.gather_rows_t). Sampling is a branchless bilinear gather
with per-texture wrap OR clamp addressing, batched over the whole wavefront;
trilinear adds a second level and one blend, with the level chosen from a
ray-cone footprint (see integrator._apply_textures).

Storage is u8 by default (4x less HBM than f32 and 4x less gather bandwidth):
color textures are stored sRGB-ENCODED and decoded to linear at sample time
BEFORE filtering — bit-faithful to the source file's own 8-bit payload and
matching the hardware decode-then-filter order the reference's cudaArray path
gets (texture_support_cuda.h). Linear/HDR textures store u8 with a per-texture
scale (max value), so values > 1 survive. dtype="f32" keeps the old exact
float sheet for tests and HDR-critical content.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np

from strelka_tpu import log

MAX_DIM = 2048  # native detail preserved up to this edge length
MAX_MIP = 12  # 2048 -> 1x1 chain length

ADDRESS_WRAP = 0  # cudaAddressModeWrap
ADDRESS_CLAMP = 1  # cudaAddressModeClamp

FLAG_SRGB = 1  # rect stores sRGB-encoded u8 (decode before filtering)

# Optional Quilez smootherstep coordinate warp before the bilinear blend —
# parity with the reference's compile-time USE_SMOOTHERSTEP_FILTER
# (texture_support_cuda.h:262-280, default off there too).
SMOOTHERSTEP = os.environ.get("STRELKA_TEX_SMOOTHERSTEP") == "1"

# rects table columns
RC_X0, RC_Y0, RC_W, RC_H, RC_MODE, RC_FLAGS, RC_SCALE, RC_COUNT, RC_BASE = range(9)


class TextureAtlas(NamedTuple):
    """Device-side texture sheet.

    data:  jnp [H, W, 4] u8 (sRGB or scaled-linear, per-rect) or f32 linear
    rects: jnp [R, 9] i32 — (x0, y0, w, h, address_mode, flags, scale_bits,
           mip_count, mip_base) per rect. Rects 0..L-1 are the level-0 rects
           of the L textures; texture i's level l>=1 is rect mip_base + l - 1
           (consecutive). scale_bits is an f32 bitcast (u8 decode scale).
    """

    data: object
    rects: object
    size: int  # sheet width (kept for back-compat introspection)
    # [n_tex, 3] i32 (kind, depth, base): kind 0 = 2d, 1 = 3d volume
    # (depth slices at consecutive rect ids base..base+D-1), 2 = cubemap
    # (6 faces at base..base+5, CUDA face order +x -x +y -y +z -z)
    meta: object = None


def _resize_bilinear(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host-side bilinear resize of an [H,W,C] f32 image (no PIL dependency
    for in-memory arrays). At exactly half size this is the 2x2 box filter."""
    h, w = im.shape[:2]
    yy = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xx = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(yy).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xx).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    ty = np.clip(yy - y0, 0.0, 1.0)[:, None, None]
    tx = np.clip(xx - x0, 0.0, 1.0)[None, :, None]
    top = im[y0][:, x0] * (1 - tx) + im[y0][:, x1] * tx
    bot = im[y1][:, x0] * (1 - tx) + im[y1][:, x1] * tx
    return (top * (1 - ty) + bot * ty).astype(np.float32)


def _read_rgba(path: str) -> np.ndarray:
    """Image file -> [H,W,4] f32 in [0, 1]. PNG is decoded by the stdlib
    codec (utils/image.py); other formats (JPEG) need Pillow, and a missing
    Pillow is an error that names the file, never an untextured render."""
    if path.lower().endswith(".png"):
        from strelka_tpu.utils.image import read_png_u8

        u8 = read_png_u8(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(f"texture {path}: reading this format needs Pillow") from e
        u8 = np.asarray(Image.open(path).convert("RGBA"))
    c = u8.shape[-1]
    if c < 3:  # grey (+ alpha) -> RGB (+ alpha)
        u8 = np.concatenate([np.repeat(u8[..., :1], 3, axis=-1), u8[..., 1:]], axis=-1)
    if u8.shape[-1] == 3:
        u8 = np.concatenate([u8, np.full(u8.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return u8.astype(np.float32) / 255.0


def _srgb_encode(rgb: np.ndarray) -> np.ndarray:
    return np.where(
        rgb <= 0.0031308, rgb * 12.92, 1.055 * np.maximum(rgb, 1e-12) ** (1 / 2.4) - 0.055
    )


class TextureManager:
    """Host registry: load images at native size, dedupe by path, shelf-pack
    the sheet. The 'registerResource' analog (materialmanager.cpp:611-618):
    textures get integer ids that material params reference.
    """

    def __init__(self, atlas_size: int = MAX_DIM, search_path: str = ""):
        self.max_dim = atlas_size
        self.search_path = search_path
        self._images: List[np.ndarray] = []  # linear f32 [H,W,4]
        self._modes: List[int] = []
        self._srgb: List[bool] = []  # store sRGB-encoded u8 for this texture
        self._nomip: List[bool] = []  # volume slices / cube faces: level 0 only
        self._meta = {}  # head tex id -> (kind, depth, base)
        self._path_to_id = {}

    def load(self, path: str, srgb: bool = True, address_mode: int = ADDRESS_WRAP) -> int:
        """Load (or look up) an image file; returns texture id or -1."""
        key = (path, srgb)
        if key in self._path_to_id:
            return self._path_to_id[key]
        full = path
        if not os.path.isabs(full) and self.search_path:
            cand = os.path.join(self.search_path, path)
            if os.path.exists(cand):
                full = cand
        if not os.path.exists(full):
            log.warning("Texture not found: {}", path)
            return -1
        arr = _read_rgba(full)
        h, w = arr.shape[:2]
        if max(w, h) > self.max_dim:
            s = self.max_dim / max(w, h)
            arr = _resize_bilinear(arr, max(1, int(h * s)), max(1, int(w * s)))
        if srgb:
            rgb = arr[..., :3]
            # exact sRGB EOTF (cuda/helpers.h toSRGB inverse)
            lin = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
            arr = np.concatenate([lin, arr[..., 3:]], axis=-1)
        tex_id = len(self._images)
        self._images.append(arr.astype(np.float32))
        self._modes.append(address_mode)
        self._srgb.append(bool(srgb))
        self._nomip.append(False)
        self._path_to_id[key] = tex_id
        log.debug("Loaded texture {} ({}x{}) -> id {}", path, arr.shape[1], arr.shape[0], tex_id)
        return tex_id

    def add_array(self, arr: np.ndarray, name: str = "", address_mode: int = ADDRESS_WRAP) -> int:
        """Register an in-memory [H,W,3|4] float image (tests, procedural)."""
        a = np.asarray(arr, np.float32)
        if a.shape[-1] == 3:
            a = np.concatenate([a, np.ones(a.shape[:-1] + (1,), np.float32)], -1)
        tex_id = len(self._images)
        self._images.append(a)
        self._modes.append(address_mode)
        self._srgb.append(False)
        self._nomip.append(False)
        if name:
            self._path_to_id[(name, False)] = tex_id
        return tex_id

    def add_volume(self, vol: np.ndarray, name: str = "", address_mode: int = ADDRESS_WRAP) -> int:
        """Register an in-memory [D,H,W,3|4] float volume as a texture_3d
        (tex_lookup_float4_3d, texture_support_cuda.h:433-463).

        Layout: the D slices become D consecutive level-0 rects in the
        one 2D sheet; trilinear-in-w = two bilinear slice samples + a lerp
        (sample_3d). Returns the head texture id."""
        v = np.asarray(vol, np.float32)
        if v.ndim != 4:
            raise ValueError(f"volume must be [D,H,W,C], got {v.shape}")
        head = len(self._images)
        for k in range(v.shape[0]):
            self.add_array(v[k], address_mode=address_mode)
            self._nomip[-1] = True
        self._meta[head] = (1, v.shape[0], head)
        if name:
            self._path_to_id[(name, False)] = head
        return head

    def add_cubemap(self, faces: np.ndarray, name: str = "", ) -> int:
        """Register an in-memory [6,H,W,3|4] cubemap, CUDA face order
        (+x -x +y -y +z -z; tex_lookup_float4_cube,
        texture_support_cuda.h:522-558). Faces sample with clamp addressing.
        Returns the head texture id."""
        f = np.asarray(faces, np.float32)
        if f.ndim != 4 or f.shape[0] != 6:
            raise ValueError(f"cubemap must be [6,H,W,C], got {f.shape}")
        head = len(self._images)
        for k in range(6):
            self.add_array(f[k], address_mode=ADDRESS_CLAMP)
            self._nomip[-1] = True
        self._meta[head] = (2, 6, head)
        if name:
            self._path_to_id[(name, False)] = head
        return head

    @property
    def count(self) -> int:
        return len(self._images)

    def build_atlas(self, dtype: str = "u8", mipmaps: bool = True) -> Optional[TextureAtlas]:
        """Shelf-pack all textures (and their mip chains) into one sheet.

        dtype: "u8" (default; sRGB-encoded color / scaled-linear, 4x less
        memory) or "f32" (exact linear floats). mipmaps=False packs level 0
        only (mip_count all 1)."""
        import jax.numpy as jnp

        if not self._images:
            return None
        sheet_w = max(128, min(self.max_dim, max(im.shape[1] for im in self._images)))
        sheet_w = 1 << (sheet_w - 1).bit_length()  # pow2 lanes
        # downscale (never crop) any registered image wider than the sheet —
        # loader-capped images are safe, in-memory add_array() ones may not be
        for i, im in enumerate(self._images):
            h, w = im.shape[:2]
            if w > sheet_w:
                s = sheet_w / w
                self._images[i] = _resize_bilinear(im, max(1, int(round(h * s))), sheet_w)
                log.warning(
                    "Texture {} ({}x{}) wider than sheet ({}); downscaled", i, w, h, sheet_w
                )

        # ---- build the full rect list: level-0 rects first (rect id ==
        # texture id, back-compat), then each texture's levels 1..k in
        # CONSECUTIVE rect slots (level selection becomes arithmetic)
        n_tex = len(self._images)
        rect_imgs: List[np.ndarray] = list(self._images)
        rect_mode: List[int] = list(self._modes)
        rect_srgb: List[bool] = list(self._srgb)
        counts = np.ones(n_tex, np.int32)
        bases = np.arange(n_tex, dtype=np.int32)  # unused when count == 1
        if mipmaps:
            for i in range(n_tex):
                if self._nomip[i]:
                    continue  # volume slices / cube faces: level 0 only
                im = self._images[i]
                bases[i] = len(rect_imgs)
                level = 1
                while max(im.shape[0], im.shape[1]) > 1 and level < MAX_MIP:
                    im = _resize_bilinear(
                        im, max(1, im.shape[0] // 2), max(1, im.shape[1] // 2)
                    )
                    rect_imgs.append(im)
                    rect_mode.append(self._modes[i])
                    rect_srgb.append(self._srgb[i])
                    level += 1
                counts[i] = level

        # ---- shelf-pack (tallest first)
        order = sorted(range(len(rect_imgs)), key=lambda i: -rect_imgs[i].shape[0])
        rects = np.zeros((len(rect_imgs), 9), np.int32)
        x = y = shelf_h = 0
        for i in order:
            h, w = rect_imgs[i].shape[:2]
            if x + w > sheet_w:
                y += shelf_h
                x = shelf_h = 0
            rects[i, :5] = (x, y, w, h, rect_mode[i])
            x += w
            shelf_h = max(shelf_h, h)
        total_h = y + shelf_h
        rects[:n_tex, RC_COUNT] = counts
        rects[:n_tex, RC_BASE] = bases
        rects[:, RC_SCALE] = np.float32(1.0).view(np.int32)

        # ---- encode the sheet
        if dtype == "u8":
            sheet = np.zeros((total_h, sheet_w, 4), np.uint8)
            for i, im in enumerate(rect_imgs):
                x0, y0, w, h = rects[i, :4]
                if rect_srgb[i]:
                    enc = np.concatenate(
                        [_srgb_encode(im[..., :3]), im[..., 3:]], axis=-1
                    )
                    rects[i, RC_FLAGS] |= FLAG_SRGB
                else:
                    s = float(max(1.0, im.max())) if im.size else 1.0
                    rects[i, RC_SCALE] = np.float32(s).view(np.int32)
                    enc = im / s
                sheet[y0 : y0 + h, x0 : x0 + w] = np.clip(
                    np.round(enc[:h, :w] * 255.0), 0, 255
                ).astype(np.uint8)
        else:
            sheet = np.zeros((total_h, sheet_w, 4), np.float32)
            for i, im in enumerate(rect_imgs):
                x0, y0, w, h = rects[i, :4]
                sheet[y0 : y0 + h, x0 : x0 + w] = im[:h, :w]
        log.info(
            "Texture sheet: {} textures / {} rects packed into {}x{} {} ({:.1f} MB)",
            n_tex, len(rect_imgs), sheet_w, total_h, dtype, sheet.nbytes / 1e6,
        )
        meta = np.zeros((n_tex, 3), np.int32)
        meta[:, 1] = 1
        meta[:, 2] = np.arange(n_tex)
        for head, (kind, depth, base) in self._meta.items():
            meta[head] = (kind, depth, base)
        return TextureAtlas(
            data=jnp.asarray(sheet), rects=jnp.asarray(rects), size=sheet_w,
            meta=jnp.asarray(meta),
        )


def _texel_setup(r, uv):
    """Shared bilinear addressing math for rect rows r [9, N] i32 + uv [N,2].
    Returns (xb, yb, tx, ty, addr) where (xb, yb) is the base texel, (tx, ty)
    the (optionally smootherstep-warped) filter fractions [N], and addr the
    per-rect wrap/clamp address function. V flipped (row 0 = v 1, GL)."""
    import jax.numpy as jnp

    w, h = r[RC_W], r[RC_H]
    wf = w.astype(jnp.float32)
    hf = h.astype(jnp.float32)
    u = uv[..., 0]
    v = 1.0 - uv[..., 1]
    clamp = r[RC_MODE] == ADDRESS_CLAMP
    uu = jnp.where(clamp, jnp.clip(u, 0.0, 1.0), u % 1.0)
    vv = jnp.where(clamp, jnp.clip(v, 0.0, 1.0), v % 1.0)
    fu = uu * wf - 0.5
    fv = vv * hf - 0.5
    xb = jnp.floor(fu)
    yb = jnp.floor(fv)
    tx = fu - xb
    ty = fv - yb
    if SMOOTHERSTEP:
        # quintic warp of the texel fraction (APPLY_SMOOTHERSTEP_FILTER,
        # texture_support_cuda.h:265-280)
        tx = tx * tx * tx * (tx * (tx * 6.0 - 15.0) + 10.0)
        ty = ty * ty * ty * (ty * (ty * 6.0 - 15.0) + 10.0)

    def addr(i, extent):
        wrapped = jnp.mod(i, extent)
        clamped = jnp.clip(i, 0, extent - 1)
        return jnp.where(clamp, clamped, wrapped)

    return xb.astype(jnp.int32), yb.astype(jnp.int32), tx, ty, addr


def _decode_fetch(atlas: TextureAtlas, r, yi, xi):
    """One texel fetch at rect-local (yi, xi), decoded to linear f32 [N,4].
    u8 sheets decode (sRGB or scale) per texel, like hardware decode-then-
    filter (texture_support_cuda.h)."""
    import jax
    import jax.numpy as jnp

    c = atlas.data[r[RC_Y0] + yi, r[RC_X0] + xi]
    if atlas.data.dtype != jnp.uint8:
        return c
    srgb = ((r[RC_FLAGS] & FLAG_SRGB) != 0)[..., None]
    scale = jax.lax.bitcast_convert_type(r[RC_SCALE], jnp.float32)[..., None]
    cf = c.astype(jnp.float32) * (1.0 / 255.0)
    lin = jnp.where(cf <= 0.04045, cf / 12.92, ((cf + 0.055) / 1.055) ** 2.4)
    out = jnp.where(srgb, lin, cf * scale)
    # alpha is stored linear even for sRGB rects
    alpha = jnp.where(srgb[..., 0], cf[..., 3], cf[..., 3] * scale[..., 0])
    return jnp.concatenate([out[..., :3], alpha[..., None]], axis=-1)


def _sample_rect_rows(atlas: TextureAtlas, r, uv):
    """Bilinear lookup given pre-gathered rect rows r [9, N] i32.
    uv: [N,2]. -> [N,4] f32 linear. u8 sheets decode each texel (sRGB or
    scale) BEFORE the bilinear blend, like hardware decode-then-filter.
    V flipped (row 0 = v 1, GL convention)."""
    w, h = r[RC_W], r[RC_H]
    xb, yb, tx, ty, addr = _texel_setup(r, uv)
    tx = tx[..., None]
    ty = ty[..., None]
    x0i = addr(xb, w)
    y0i = addr(yb, h)
    x1i = addr(xb + 1, w)
    y1i = addr(yb + 1, h)
    c00 = _decode_fetch(atlas, r, y0i, x0i)
    c10 = _decode_fetch(atlas, r, y0i, x1i)
    c01 = _decode_fetch(atlas, r, y1i, x0i)
    c11 = _decode_fetch(atlas, r, y1i, x1i)
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def _sample_rect_rows_stochastic(atlas: TextureAtlas, r, uv, rx, ry):
    """ONE-texel stochastic bilinear: picks the x1/y1 neighbor with
    probability equal to its filter weight (rx, ry: [N] uniforms), so
    E[result] == _sample_rect_rows exactly (decode is per-texel in both).
    1 sheet gather instead of 4 — gathers are the texture pipeline's
    entire cost, and the variance folds into path-tracing noise."""
    w, h = r[RC_W], r[RC_H]
    xb, yb, tx, ty, addr = _texel_setup(r, uv)
    xi = addr(xb + (rx < tx).astype(xb.dtype), w)
    yi = addr(yb + (ry < ty).astype(yb.dtype), h)
    return _decode_fetch(atlas, r, yi, xi)


def sample_bilinear(atlas: TextureAtlas, tex_id, uv):
    """Level-0 bilinear lookup (tex_lookup_float4_2d equivalent,
    texture_support_cuda.h:287-528). tex_id: [N] i32 (< 0 -> ones).
    uv: [N,2]. -> [N,4] f32 linear."""
    import jax.numpy as jnp

    from strelka_tpu.ops.vec import gather_rows_t

    ridx = jnp.clip(tex_id, 0, atlas.rects.shape[0] - 1)
    r = gather_rows_t(atlas.rects, ridx)
    out = _sample_rect_rows(atlas, r, uv)
    return jnp.where((tex_id >= 0)[..., None], out, jnp.ones_like(out))


def sample_trilinear(atlas: TextureAtlas, tex_id, uv, lod_uv):
    """Trilinear (mipmapped) lookup. lod_uv: [N] f32 = log2 of the sample
    footprint in UV units (texture-size independent); the per-texture texel
    LOD adds log2(max(w, h)). Blends the two straddling mip levels — the
    filtered tex_lookup path the reference gets from hardware mipmapping
    (texture_support_cuda.h:287-528; OptixRender.cpp:1191-1268).

    Cost: TWO fat rect-row gathers + two bilinear rect samples; level
    selection is pure arithmetic (mip rects are consecutive, no index table).
    """
    import jax.numpy as jnp

    from strelka_tpu.ops.vec import gather_rows_t

    tid = jnp.clip(tex_id, 0, atlas.rects.shape[0] - 1)
    r0 = gather_rows_t(atlas.rects, tid)  # level-0 rows carry count/base
    dim = jnp.maximum(r0[RC_W], r0[RC_H]).astype(jnp.float32)
    count = r0[RC_COUNT]
    lod = lod_uv + jnp.log2(jnp.maximum(dim, 1.0))
    lod = jnp.clip(lod, 0.0, count.astype(jnp.float32) - 1.0)
    l0 = jnp.floor(lod)
    frac = (lod - l0)[..., None]
    l0i = l0.astype(jnp.int32)
    l1i = jnp.minimum(l0i + 1, count - 1)
    base = r0[RC_BASE]
    ridx0 = jnp.where(l0i == 0, tid, base + l0i - 1)
    ridx1 = jnp.where(l1i == 0, tid, base + l1i - 1)
    a = _sample_rect_rows(atlas, gather_rows_t(atlas.rects, ridx0), uv)
    b = _sample_rect_rows(atlas, gather_rows_t(atlas.rects, ridx1), uv)
    out = a * (1.0 - frac) + b * frac
    return jnp.where((tex_id >= 0)[..., None], out, jnp.ones_like(out))


def sample_trilinear_stochastic(atlas: TextureAtlas, tex_id, uv, lod_uv, rnd3):
    """ONE-texel stochastic trilinear: the mip level is drawn with
    probability equal to its blend weight and the bilinear footprint is
    sampled with one texel (see _sample_rect_rows_stochastic), so
    E[result] == sample_trilinear while touching 1 sheet texel per lane
    instead of 8 and gathering 1 rect-row set instead of 3.

    This is the integrator's default filtered-lookup path: per-lane gathers
    are ~the whole cost of the reference's hardware tex fetch here
    (texture_support_cuda.h:287-528 reads filtered cudaArray for free), and
    a path tracer re-draws every lookup each subframe — filter variance
    converges with spp exactly like every other Monte-Carlo dimension.

    rnd3: 3 x [N] f32 uniforms (level pick, x pick, y pick), decorrelated
    from the BSDF/light dims (integrator hashes them per lookup slot).
    """
    import jax.numpy as jnp

    from strelka_tpu.ops.vec import gather_rows_t

    tid = jnp.clip(tex_id, 0, atlas.rects.shape[0] - 1)
    r0 = gather_rows_t(atlas.rects, tid)  # level-0 rows carry count/base
    dim = jnp.maximum(r0[RC_W], r0[RC_H]).astype(jnp.float32)
    count = r0[RC_COUNT]
    lod = lod_uv + jnp.log2(jnp.maximum(dim, 1.0))
    lod = jnp.clip(lod, 0.0, count.astype(jnp.float32) - 1.0)
    l0 = jnp.floor(lod)
    frac = lod - l0
    li = l0.astype(jnp.int32) + (rnd3[0] < frac).astype(jnp.int32)
    li = jnp.minimum(li, count - 1)
    ridx = jnp.where(li == 0, tid, r0[RC_BASE] + li - 1)
    r = gather_rows_t(atlas.rects, ridx)
    out = _sample_rect_rows_stochastic(atlas, r, uv, rnd3[1], rnd3[2])
    return jnp.where((tex_id >= 0)[..., None], out, jnp.ones_like(out))


def sample_3d(atlas: TextureAtlas, tex_id, uvw):
    """texture_3d lookup (tex_lookup_float4_3d, texture_support_cuda.h:433-463).

    tex_id: [N] i32 head ids from TextureManager.add_volume (< 0 -> ones).
    uvw: [N,3]. Trilinear: bilinear on the two straddling slices (consecutive
    rect ids, one fat row-gather each) + a lerp in w. w addressing follows
    the texture's wrap/clamp mode like u and v."""
    import jax.numpy as jnp

    from strelka_tpu.ops.vec import gather_rows_t

    if atlas.meta is None:
        return jnp.ones(uvw.shape[:-1] + (4,), jnp.float32)
    tid = jnp.clip(tex_id, 0, atlas.meta.shape[0] - 1)
    m = gather_rows_t(atlas.meta, tid)  # [3, N]
    depth = jnp.maximum(m[1], 1)
    base = m[2]
    df = depth.astype(jnp.float32)
    head = gather_rows_t(atlas.rects, jnp.clip(base, 0, atlas.rects.shape[0] - 1))
    clamp = head[RC_MODE] == ADDRESS_CLAMP
    w = uvw[..., 2]
    ww = jnp.where(clamp, jnp.clip(w, 0.0, 1.0), w % 1.0)
    fd = ww * df - 0.5
    k = jnp.floor(fd)
    tw = (fd - k)[..., None]
    k0 = k.astype(jnp.int32)
    k1 = k0 + 1
    k0 = jnp.where(clamp, jnp.clip(k0, 0, depth - 1), jnp.mod(k0, depth))
    k1 = jnp.where(clamp, jnp.clip(k1, 0, depth - 1), jnp.mod(k1, depth))
    rmax = atlas.rects.shape[0] - 1
    a = _sample_rect_rows(
        atlas, gather_rows_t(atlas.rects, jnp.clip(base + k0, 0, rmax)), uvw[..., :2]
    )
    b = _sample_rect_rows(
        atlas, gather_rows_t(atlas.rects, jnp.clip(base + k1, 0, rmax)), uvw[..., :2]
    )
    out = a * (1.0 - tw) + b * tw
    ok = (tex_id >= 0) & (m[0] == 1)
    return jnp.where(ok[..., None], out, jnp.ones_like(out))


def sample_cube(atlas: TextureAtlas, tex_id, direction):
    """texture_cube lookup (tex_lookup_float4_cube,
    texture_support_cuda.h:522-558). direction: [N,3] (need not be
    normalized). CUDA cubemap convention: face = major axis, and

      +x: (sc,tc) = (-z,-y)   -x: (+z,-y)
      +y: (+x,+z)             -y: (+x,-z)
      +z: (+x,-y)             -z: (-x,-y)

    with u = (sc/|ma| + 1)/2, v flipped by the sampler's GL convention
    (so tc maps through 1-v like 2D lookups). Faces use clamp addressing."""
    import jax.numpy as jnp

    from strelka_tpu.ops.vec import gather_rows_t

    if atlas.meta is None:
        return jnp.ones(direction.shape[:-1] + (4,), jnp.float32)
    tid = jnp.clip(tex_id, 0, atlas.meta.shape[0] - 1)
    m = gather_rows_t(atlas.meta, tid)
    base = m[2]
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    is_z = ~(is_x | is_y)
    face = jnp.where(
        is_x,
        jnp.where(x >= 0, 0, 1),
        jnp.where(is_y, jnp.where(y >= 0, 2, 3), jnp.where(z >= 0, 4, 5)),
    ).astype(jnp.int32)
    ma = jnp.where(is_x, ax, jnp.where(is_y, ay, az))
    ma = jnp.maximum(ma, 1e-20)
    sc = jnp.where(
        is_x, jnp.where(x >= 0, -z, z), jnp.where(is_y, x, jnp.where(z >= 0, x, -x))
    )
    tc = jnp.where(is_x, -y, jnp.where(is_y, jnp.where(y >= 0, z, -z), -y))
    u = (sc / ma + 1.0) * 0.5
    # _sample_rect_rows flips v (GL convention); feed 1-v so tc lands as-is
    v = 1.0 - (tc / ma + 1.0) * 0.5
    rmax = atlas.rects.shape[0] - 1
    r = gather_rows_t(atlas.rects, jnp.clip(base + face, 0, rmax))
    out = _sample_rect_rows(atlas, r, jnp.stack([u, v], axis=-1))
    ok = (tex_id >= 0) & (m[0] == 2)
    return jnp.where(ok[..., None], out, jnp.ones_like(out))


def apply_normal_map(normal, tangent, binormal, tex_rgb):
    """Perturb the shading normal with a tangent-space normal map sample."""
    import jax.numpy as jnp

    n_ts = tex_rgb * 2.0 - 1.0
    out = (
        n_ts[..., 0:1] * tangent + n_ts[..., 1:2] * binormal + n_ts[..., 2:3] * normal
    )
    norm = jnp.linalg.norm(out, axis=-1, keepdims=True)
    return jnp.where(norm > 1e-8, out / jnp.maximum(norm, 1e-8), normal)
