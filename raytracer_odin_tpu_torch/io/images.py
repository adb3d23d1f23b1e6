"""Host-side texture loading.

Replaces `load_texture` (textures.odin:25-68): sniffs the format, decodes
PNG / JPEG / Radiance HDR (and PPM, the CLI's other output format), and
returns a float32 [H, W, C] array plus an ``is_hdr`` flag. LDR images are
returned as value/255.0 exactly like the reference's u8 path
(textures.odin:88-90); HDR images keep raw radiance.

PNG and HDR use our from-scratch codecs; baseline-sequential JPEG uses the
from-scratch decoder in io/jpeg.py (progressive JPEGs fall back to PIL
when available).
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from raytracer_odin_tpu_torch.io import hdr as hdr_codec
from raytracer_odin_tpu_torch.io import png as png_codec


@dataclass
class LoadedImage:
    """Decoded image: data float32 [H, W, C] (C = native channel count),
    mirroring `Texture` (textures.odin:14-19)."""

    data: np.ndarray
    is_hdr: bool

    @property
    def dims(self):
        return (self.data.shape[1], self.data.shape[0])  # (w, h)

    @property
    def channels(self) -> int:
        return self.data.shape[2]


def decode_image(data: bytes) -> LoadedImage:
    if hdr_codec.is_hdr(data):
        return LoadedImage(hdr_codec.decode(data), True)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        img = png_codec.decode(data)
        return LoadedImage(img.astype(np.float32) / 255.0, False)
    if data[:2] == b"\xff\xd8":  # JPEG SOI
        from raytracer_odin_tpu_torch.io import jpeg as jpeg_codec

        try:
            img = jpeg_codec.decode(data)
        except jpeg_codec.JpegError:
            # Progressive / exotic JPEG: fall back to PIL if present.
            try:
                from PIL import Image
            except ImportError as e:  # pragma: no cover
                raise ValueError(
                    "unsupported JPEG variant and PIL is unavailable"
                ) from e
            img = np.asarray(Image.open(_io.BytesIO(data)))
            if img.ndim == 2:
                img = img[..., None]
        return LoadedImage(img.astype(np.float32) / 255.0, False)
    if data[:2] in (b"P6", b"P5", b"P3"):
        return LoadedImage(decode_ppm(data), False)
    raise ValueError("unrecognized image format")


def load_image(path) -> LoadedImage:
    return decode_image(Path(path).read_bytes())


def decode_ppm(data: bytes) -> np.ndarray:
    """Decode binary/ASCII PPM/PGM -> float32 [H, W, C]: reads back the
    P6 images io/writers.py writes (output.odin:88-94)."""
    fields: list[bytes] = []
    pos = 0
    while len(fields) < 4:
        # Skip whitespace and comments.
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(data[start:pos])
    magic, w, h, maxval = (fields[0], int(fields[1]), int(fields[2]),
                           int(fields[3]))
    pos += 1  # single whitespace after maxval
    nch = 3 if magic in (b"P6", b"P3") else 1
    if magic in (b"P6", b"P5"):
        raw = np.frombuffer(data, np.uint8, count=w * h * nch, offset=pos)
    else:
        raw = np.array(data[pos:].split(), np.uint16)[:w * h * nch]
    return raw.reshape(h, w, nch).astype(np.float32) / float(maxval)
