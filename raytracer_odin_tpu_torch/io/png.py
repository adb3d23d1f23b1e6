"""From-scratch PNG codec (decode + encode).

Replaces the reference's `vendor:stb/image` load (textures.odin:37-52) and
`stb_image_write.write_png` (output.odin:95-103). Pure Python chunk/zlib
handling; row unfiltering runs in the native C++ helper
(csrc/rtnative.cpp), or in numpy with RT_TPU_NO_NATIVE set.

Supported: bit depths 8/16, color types gray(0), RGB(2), palette(3),
gray+alpha(4), RGBA(6), non-interlaced. Encode: 8-bit RGB/RGBA/gray.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from raytracer_odin_tpu_torch.io import native

_PNG_SIG = b"\x89PNG\r\n\x1a\n"

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = int(a) + int(b) - int(c)
    pa, pb, pc = abs(p - int(a)), abs(p - int(b)), abs(p - int(c))
    if pa <= pb and pa <= pc:
        return a
    if pb <= pc:
        return b
    return c


def _unfilter_py(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """The numpy (slow) unfilter of RT_TPU_NO_NATIVE; `raw` is
    [height, 1 + stride] uint8."""
    out = np.zeros((height, stride), np.uint8)
    for y in range(height):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        prev = (out[y - 1].astype(np.int32) if y > 0
                else np.zeros(stride, np.int32))
        if ftype == 0:
            cur = line
        elif ftype == 1:  # sub: cumulative along bpp-strided lanes
            cur = line.copy()
            for i in range(bpp, stride):
                cur[i] = (cur[i] + cur[i - bpp]) & 0xFF
        elif ftype == 2:  # up
            cur = (line + prev) & 0xFF
        elif ftype == 3:  # average
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ftype == 4:  # paeth
            cur = line.copy()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                above_left = prev[i - bpp] if i >= bpp else 0
                cur[i] = (cur[i] + _paeth(left, prev[i], above_left)) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur.astype(np.uint8)
    return out


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters; `raw` holds height rows of 1 + stride bytes
    (filter byte first). Runs in the native helper, which raises on a bad
    filter byte, or with RT_TPU_NO_NATIVE set in `_unfilter_py`."""
    lib = native.load()
    if lib is None:
        return _unfilter_py(raw.reshape(height, 1 + stride), height, stride,
                            bpp)
    buf = np.ascontiguousarray(raw.reshape(height, 1 + stride))
    out = np.zeros((height, stride), np.uint8)
    return lib.png_unfilter(buf, out, height, stride, bpp)


def decode(data: bytes) -> np.ndarray:
    """Decode PNG bytes -> uint8 array [H, W, C] (16-bit input is scaled to
    8-bit like stb_image's default 8-bit load path, textures.odin:49-52)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos = 8
    idat = bytearray()
    palette = None
    trns = None
    width = height = depth = ctype = interlace = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctag = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctag == b"IHDR":
            width, height, depth, ctype, comp, filt, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
            if comp != 0 or filt != 0:
                raise ValueError("unsupported PNG compression/filter method")
            if interlace != 0:
                raise ValueError("interlaced PNG not supported")
            if depth not in (8, 16):
                raise ValueError(f"unsupported PNG bit depth {depth}")
        elif ctag == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctag == b"tRNS":
            trns = np.frombuffer(chunk, np.uint8)
        elif ctag == b"IDAT":
            idat.extend(chunk)
        elif ctag == b"IEND":
            break
    if width is None:
        raise ValueError("PNG missing IHDR")
    nch = _CHANNELS[ctype]
    bpp = max(1, nch * depth // 8)
    stride = (width * nch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    if raw.size != height * (1 + stride):
        raise ValueError("PNG data size mismatch")
    raw = raw.reshape(height, 1 + stride)
    img = _unfilter(raw, height, stride, bpp)
    if depth == 16:
        img16 = img.reshape(height, width, nch, 2)
        # stb-style 16->8 reduction: take the high byte.
        img = img16[..., 0]
    else:
        img = img.reshape(height, width, nch)
    if ctype == 3:
        if palette is None:
            raise ValueError("paletted PNG missing PLTE")
        rgb = palette[img[..., 0]]
        if trns is not None:
            alpha = np.full((height, width, 1), 255, np.uint8)
            idx = img[..., 0]
            mask = idx < trns.size
            alpha[mask, 0] = trns[idx[mask]]
            return np.concatenate([rgb, alpha], axis=-1)
        return rgb
    return img


def encode(img: np.ndarray) -> bytes:
    """Encode uint8 [H, W] / [H, W, {1,2,3,4}] to PNG bytes."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1
    )
    idat = zlib.compress(rows.tobytes(), 6)
    return (
        _PNG_SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", idat)
        + chunk(b"IEND", b"")
    )
