"""Image output writers: binary PPM (P6) and PNG (port of
raytracer_odin_tpu/io/writers.py).

Mirrors `save_result` (output.odin:82-107): `.ppm` gets a P6 header and raw
RGB, `.png` goes through the PNG encoder; other extensions raise.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from raytracer_odin_tpu_torch.io import png as png_codec


def write_ppm(path, rgb: np.ndarray) -> None:
    rgb = np.asarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())


def write_png(path, rgb: np.ndarray) -> None:
    Path(path).write_bytes(png_codec.encode(rgb))


def save_image(path, rgb: np.ndarray) -> None:
    """Dispatch on the extension; unknown formats raise, as output.odin:105
    panics."""
    p = str(path)
    if p.endswith(".ppm"):
        write_ppm(p, rgb)
    elif p.endswith(".png"):
        write_png(p, rgb)
    else:
        raise ValueError(f"Unsupported file format: {p}")
