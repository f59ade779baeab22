"""Image IO + metrics: a stdlib PNG codec (screenshot path parity) and SSIM.

Reference: screenshots via stb/HioImage (hdRunner/main.cpp:407-441). Row 0 of
the framebuffer is pixel y=0 which is the BOTTOM of the view (NDC y=-1), so
PNGs are written flipped to read upright.

The PNG reader/writer needs only zlib and numpy: 8-bit samples, colour types
0 (grey), 2 (RGB), 4 (grey+alpha) and 6 (RGBA), all five row filters,
non-interlaced.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """[H,W] / [H,W,1|2|3|4] uint8 -> PNG bytes (filter 0 on every row)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png wants uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (
        _PNG_SIG
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        cur = rows[y, 1:].astype(np.int32)
        if ftype == 1:
            # left-neighbour prediction == a running sum per channel
            recon = np.cumsum(cur.reshape(w, bpp), axis=0).reshape(stride) & 0xFF
        elif ftype == 3 or ftype == 4:
            # depends on the reconstructed left neighbour: walk the row
            # one pixel (bpp bytes) at a time
            recon = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                left = recon[x - bpp : x] if x else np.zeros(bpp, np.int32)
                up = prev[x : x + bpp]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    upleft = prev[x - bpp : x] if x else np.zeros(bpp, np.int32)
                    pred = _paeth(left, up, upleft)
                recon[x : x + bpp] = (cur[x : x + bpp] + pred) & 0xFF
        elif ftype == 2:
            recon = (cur + prev) & 0xFF
        elif ftype == 0:
            recon = cur
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = recon
        prev = recon
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> [H,W,C] uint8 with C = 1, 2, 3 or 4 (as stored)."""
    if buf[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        tag = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, interlace {interlace})"
        )
    c = _CHANNELS[ctype]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w, c)
    return pixels.reshape(h, w, c)


def write_png(path: str, img: np.ndarray, flip: bool = True) -> None:
    """img: [H,W,3|4] float (0..1) or uint8; written as 8-bit RGB."""
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if flip:
        img = img[::-1]
    with open(path, "wb") as f:
        f.write(encode_png(np.ascontiguousarray(img[..., :3])))


def read_png_u8(path: str) -> np.ndarray:
    """[H,W,C] uint8 as stored (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_png(path: str) -> np.ndarray:
    """[H,W,C] float32 in [0, 1], channels as stored (grey stays [H,W])."""
    a = read_png_u8(path).astype(np.float32) / 255.0
    return a[..., 0] if a.shape[-1] == 1 else a


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM over channels (Wang et al. 2004, 11x11 gaussian window)."""
    from scipy.ndimage import gaussian_filter

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    sig = 1.5
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mu_x = gaussian_filter(x, sig)
        mu_y = gaussian_filter(y, sig)
        sxx = gaussian_filter(x * x, sig) - mu_x**2
        syy = gaussian_filter(y * y, sig) - mu_y**2
        sxy = gaussian_filter(x * y, sig) - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / ((mu_x**2 + mu_y**2 + c1) * (sxx + syy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))
