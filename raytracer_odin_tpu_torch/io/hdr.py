"""Radiance RGBE (.hdr) decoder + encoder.

Replaces stb_image's HDR path (`stbi.loadf_from_memory`, textures.odin:36-47).
RGBE -> float conversion follows stb: rgb = c * 2^(e-136), so decoded values
match the reference renderer's env-map radiances.
"""

from __future__ import annotations

import numpy as np


def is_hdr(data: bytes) -> bool:
    return data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")


def decode(data: bytes) -> np.ndarray:
    """Decode .hdr bytes -> float32 [H, W, 3]."""
    if not is_hdr(data):
        raise ValueError("not a Radiance HDR file")
    pos = data.index(b"\n") + 1
    # Header: key=value lines until a blank line.
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        if line == b"":
            break
    end = data.index(b"\n", pos)
    resline = data[pos:end].split()
    pos = end + 1
    if len(resline) != 4 or resline[0] != b"-Y" or resline[2] != b"+X":
        raise ValueError(f"unsupported HDR resolution line: {resline}")
    height, width = int(resline[1]), int(resline[3])

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(height):
        if pos + 4 > len(data):
            raise ValueError("truncated HDR data")
        header = buf[pos : pos + 4]
        if header[0] == 2 and header[1] == 2 and (int(header[2]) << 8 | int(header[3])) == width and width >= 8:
            pos += 4
            # New-style RLE: each channel run-length encoded separately.
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[pos])
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[pos + 1]
                        x += count - 128
                        pos += 2
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[pos + 1 : pos + 1 + count]
                        x += count
                        pos += 1 + count
        else:
            # Flat RGBE scanline (old style; no ancient len>8 RLE support).
            row = buf[pos : pos + width * 4]
            rgbe[y] = row.reshape(width, 4)
            pos += width * 4

    mant = rgbe[..., :3].astype(np.float32)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.exp2(exp - 136).astype(np.float32))
    return mant * scale[..., None]


def encode(img: np.ndarray) -> bytes:
    """Encode float32 [H, W, 3] to a flat (non-RLE) .hdr file."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    nz = maxc > 1e-32
    exp[nz] = np.floor(np.log2(maxc[nz])).astype(np.int32) + 1
    # Stored exponent byte is exp+128; decoder scales by 2^(stored-136)
    # = 2^(exp-8), so the mantissa is img * 2^(8-exp).
    scale = np.exp2(8 - exp).astype(np.float32)
    mant = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe = np.concatenate(
        [mant, np.where(nz, exp + 128, 0).astype(np.uint8)[..., None]], axis=-1
    )
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    return header + rgbe.tobytes()
