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
