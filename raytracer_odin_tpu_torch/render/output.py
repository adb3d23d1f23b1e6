"""Statistics -> displayable RGB with ACES tone mapping and gamma, and the
PNG writer (port of raytracer_odin_tpu/render/output.py, output.odin:10-80).

Modes (Output_Mode, output.odin:10-19): mean, variance, first, last, count,
weight (a stub in the reference, zeros), hash, naninf.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from raytracer_odin_tpu_torch.io import png as png_codec


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def tone_map_aces(x: np.ndarray) -> np.ndarray:
    """ACES filmic curve (output.odin:21-28)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def layer_to_rgb(stats, layer: int = 0, mode: str = "mean") -> np.ndarray:
    """One accumulator layer as uint8 RGB (get_rgb_image,
    output.odin:30-80). `stats` fields may be torch tensors on any device."""
    first = _np(stats.first[layer])
    last = _np(stats.last[layer])
    total = _np(stats.total[layer])
    total_sq = _np(stats.total_sq[layer])
    count = _np(stats.count[layer])[..., None]

    with np.errstate(divide="ignore", invalid="ignore"):
        if mode == "mean":
            raw = total / count
        elif mode == "variance":
            raw = total_sq / count - (total / count) ** 2
        elif mode == "first":
            raw = first
        elif mode == "last":
            raw = last
        elif mode == "count":
            c = count[..., 0]
            raw = np.stack([c, c / 10.0, c / 100.0], axis=-1)
        elif mode == "weight":
            raw = np.zeros_like(total)  # stub, like output.odin:44-51
        elif mode == "hash":
            reprs = total.astype(np.float32).view(np.uint32)
            h = (reprs * np.uint32(87334379)) & np.uint32(0xFF)
            raw = 1.0 + h.astype(np.float32) / 256.0
        elif mode == "naninf":
            mean = total / count
            raw = tone_map_aces(np.nan_to_num(mean, nan=0.0)) / 10.0
            raw = raw.copy()
            raw[..., 0] = np.where(np.isnan(total[..., 0]), 100.0, raw[..., 0])
            raw[..., 1] = np.where(np.isinf(total[..., 1]), 100.0, raw[..., 1])
        else:
            raise ValueError(f"unknown output mode: {mode}")

    raw = np.maximum(np.nan_to_num(raw, nan=0.0), 0.0)
    big = ~np.isfinite(raw)
    mapped = np.where(big, 1.0, tone_map_aces(np.where(big, 0.0, raw)))
    gamma = np.power(mapped, 1.0 / 2.2)
    return np.clip(np.round(gamma * 255.0), 0, 255).astype(np.uint8)


def save_png(stats, path, layer: int = 0, mode: str = "mean") -> None:
    """Write one layer as a tone-mapped 8-bit PNG (output.odin:95-103)."""
    Path(path).write_bytes(png_codec.encode(layer_to_rgb(stats, layer, mode)))
