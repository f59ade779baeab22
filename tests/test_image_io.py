"""The stdlib PNG codec, Pillow-free texture loading, and tonemapping
against float64 references."""

import glob
import os
import struct
import sys
import zlib

import numpy as np
import jax.numpy as jnp
import pytest

from strelka_tpu.ops import reference as R
from strelka_tpu.ops import tonemap as TM
from strelka_tpu.utils.image import decode_png, encode_png, read_png_u8, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_PNGS = sorted(
    os.path.relpath(p, REPO)
    for pattern in ("goldens/*.png", "images/*.png", "data/gen/kitchen/textures/*.png")
    for p in glob.glob(os.path.join(REPO, pattern))
)


@pytest.mark.parametrize("rel", COMMITTED_PNGS)
def test_png_reader_matches_pillow_on_committed_files(rel):
    Image = pytest.importorskip("PIL.Image")
    path = os.path.join(REPO, rel)
    ours = read_png_u8(path)
    with Image.open(path) as im:
        ref = np.asarray(im)
    if ref.ndim == 2:
        ref = ref[..., None]
    np.testing.assert_array_equal(ours, ref)
    # and the writer round-trips what was read
    np.testing.assert_array_equal(decode_png(encode_png(ours)), ours)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_roundtrip_colour_types(channels, tmp_path):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (9, 13, channels), dtype=np.uint8)
    buf = encode_png(img)
    assert struct.unpack(">B", buf[25:26])[0] == {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    np.testing.assert_array_equal(decode_png(buf), img)


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """Encode an RGB uint8 image with one PNG row filter on every row (the
    filters written out from the PNG specification, section 9)."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    for y in range(h):
        cur = raw[y]
        prev = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(ftype)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    idat = zlib.compress(bytes(out))
    # two IDAT chunks: the decoder must concatenate them
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", idat[:10])
            + chunk(b"IDAT", idat[10:]) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decoder_handles_every_filter(ftype):
    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 256, (11, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(_filtered_png(img, ftype)), img)


def test_png_rejects_unsupported(tmp_path):
    img = np.zeros((2, 2, 3), np.uint8)
    buf = bytearray(encode_png(img))
    buf[24] = 16  # bit depth 16
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(bytes(buf))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a....")


def test_write_png_flips_rows_and_drops_alpha(tmp_path):
    img = np.zeros((4, 3, 4), np.float32)
    img[0, :, 0] = 1.0  # bottom row red in framebuffer order
    p = str(tmp_path / "o.png")
    write_png(p, img)
    out = read_png_u8(p)
    assert out.shape == (4, 3, 3)
    assert (out[-1, :, 0] == 255).all() and (out[0] == 0).all()


def test_kitchen_textures_load_without_pillow(monkeypatch, tmp_path):
    """Hide Pillow: every kitchen texture still loads (PNG is decoded by
    the stdlib codec), and a JPEG fails loudly, naming the file."""
    from strelka_tpu.textures import TextureManager

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    tdir = os.path.join(REPO, "data", "gen", "kitchen", "textures")
    tm = TextureManager(search_path=tdir)
    ids = [tm.load(name) for name in sorted(os.listdir(tdir)) if name.endswith(".png")]
    assert len(ids) == 4 and min(ids) >= 0
    atlas = tm.build_atlas()
    assert atlas is not None and np.asarray(atlas.data).max() > 0
    jpg = tmp_path / "missing_codec.jpg"
    jpg.write_bytes(b"\xff\xd8\xff")
    with pytest.raises(RuntimeError, match="missing_codec.jpg"):
        tm.load(str(jpg))


def test_texture_downscale_without_pillow(tmp_path):
    """Textures above the size cap are resized in numpy (box-like at 1/2)."""
    from strelka_tpu.textures import TextureManager

    img = np.zeros((64, 32, 3), np.uint8)
    img[:, ::2] = 255  # 1-texel stripes average to grey at half size
    p = str(tmp_path / "big.png")
    write_png(p, img, flip=False)
    tm = TextureManager(atlas_size=32)
    tid = tm.load(p, srgb=False)
    arr = tm._images[tid]
    assert arr.shape == (32, 16, 4)
    np.testing.assert_allclose(arr[..., :3], 0.5, atol=1e-6)


@pytest.mark.parametrize(
    "kind", [TM.ToneMapperType.eReinhard, TM.ToneMapperType.eACES, TM.ToneMapperType.eFilmic]
)
def test_tonemap_planar_matches_float64(kind):
    """The tonemap curves (colour matrices included) agree with float64 to
    1e-6: they are weighted sums, never a reduced-precision dot."""
    rng = np.random.default_rng(int(kind))
    img = rng.gamma(0.7, 400.0, (3, 24, 40)).astype(np.float32)
    exposure = np.array([6.25e-4, 7e-4, 5.5e-4], np.float32)
    got = np.asarray(TM.apply_tonemap_planar(jnp.asarray(img), kind, exposure, 0.0))
    np.testing.assert_allclose(got, R.tonemap_planar(img, kind, exposure, 0.0), atol=1e-6, rtol=0)


def test_gamma_matches_float64():
    """Gamma after the curve (or alone, tonemapper none): relative 1e-6."""
    rng = np.random.default_rng(4)
    img = rng.uniform(1e-3, 4.0, (3, 24, 40)).astype(np.float32)
    kind = TM.ToneMapperType.eNone
    got = np.asarray(TM.apply_tonemap_planar(jnp.asarray(img), kind, np.ones(3), 2.4))
    np.testing.assert_allclose(got, R.tonemap_planar(img, kind, np.ones(3), 2.4), rtol=1e-6)


@pytest.mark.parametrize(
    "fn,kind",
    [(TM.reinhard, TM.ToneMapperType.eReinhard), (TM.aces_fitted, TM.ToneMapperType.eACES),
     (TM.aces_film, TM.ToneMapperType.eFilmic)],
)
def test_tonemap_hwc_matches_float64(fn, kind):
    rng = np.random.default_rng(3)
    img = rng.gamma(0.7, 1.0, (8, 5, 3)).astype(np.float32)
    got = np.asarray(fn(jnp.asarray(img)))
    ref = R.tonemap_planar(np.moveaxis(img, -1, 0), kind, np.ones(3), 0.0)
    np.testing.assert_allclose(got, np.moveaxis(ref, 0, -1), atol=1e-6, rtol=0)
