"""Per-pixel sample statistics (port of raytracer_odin_tpu/render/accum.py).

Per pixel and layer: first sample, last sample, running total, total of
squares and sample count (Sample_Stats, main.odin:34-40). The JAX package
updates a donated pytree functionally; here the tensors are updated in
place, which is what the donation achieves there.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F


@dataclass
class Stats:
    first: Any          # [L, H, W, 3]
    last: Any           # [L, H, W, 3]
    total: Any          # [L, H, W, 3]
    total_sq: Any       # [L, H, W, 3]
    count: Any          # [L, H, W]


def init_stats(num_layers: int, height: int, width: int,
               device="cuda") -> Stats:
    def z3():
        return torch.zeros((num_layers, height, width, 3),
                           dtype=torch.float32, device=device)

    return Stats(
        first=z3(), last=z3(), total=z3(), total_sq=z3(),
        count=torch.zeros((num_layers, height, width), dtype=torch.float32,
                          device=device),
    )


def crop(stats: Stats, height: int, width: int) -> Stats:
    """Views without the padding rows/cols beyond [height, width] (padded
    accumulators keep the user's resolution at every readout)."""
    if stats.count.shape[1] == height and stats.count.shape[2] == width:
        return stats
    return Stats(
        first=stats.first[:, :height, :width],
        last=stats.last[:, :height, :width],
        total=stats.total[:, :height, :width],
        total_sq=stats.total_sq[:, :height, :width],
        count=stats.count[:, :height, :width],
    )


def pad_rows(stats: Stats, height_pad: int) -> Stats:
    """Zero-pad rows up to height_pad (the inverse of crop, for resume)."""
    h = stats.count.shape[1]
    if h == height_pad:
        return stats

    def pad(x, trailing):
        return F.pad(x, (0, 0) * trailing + (0, height_pad - h))

    return Stats(
        first=pad(stats.first, 2), last=pad(stats.last, 2),
        total=pad(stats.total, 2), total_sq=pad(stats.total_sq, 2),
        count=pad(stats.count, 1),
    )


def update_layers(stats: Stats, vals) -> Stats:
    """Record one sample per pixel on layers [0, L) in place (rc_set_pixel
    semantics, main.odin:89-102). vals: [L, H, W, 3]."""
    L = vals.shape[0]
    is_first = (stats.count[:L] == 0)[..., None]
    stats.first[:L] = torch.where(is_first, vals, stats.first[:L])
    stats.last[:L] = vals
    stats.total[:L] += vals
    stats.total_sq[:L] += vals * vals
    stats.count[:L] += 1.0
    return stats


def update_layer(stats: Stats, layer: int, color) -> Stats:
    """Record one sample per pixel on `layer` in place (rc_set_pixel
    semantics, main.odin:89-102). color: [H, W, 3]."""
    is_first = (stats.count[layer] == 0)[..., None]
    stats.first[layer] = torch.where(is_first, color, stats.first[layer])
    stats.last[layer] = color
    stats.total[layer] += color
    stats.total_sq[layer] += color * color
    stats.count[layer] += 1.0
    return stats
