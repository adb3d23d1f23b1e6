"""Render configuration (port of raytracer_odin_tpu/config.py).

Mirrors the reference's ``Rendering_Config`` (main.odin:27-32) plus the
execution knobs the port honours, under the JAX package's field names and
defaults. Fields of the JAX configuration that select paths the port does
not have yet (debug AOV layers, the pool and refill schedulers, the light
chunk, multi-device) come with those paths (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render parameters.

    Attributes:
      width/height: output image dimensions (main.odin:199-204).
      ray_depth: maximum path depth; depth 0 contributes nothing
        (raytracer.odin:433).
      samples: total samples per pixel; continuous renders ignore it and
        run until interrupted (main.odin:207).
      samples_per_step: samples per pixel computed in one render step, the
        unit of accumulation between host checks (interrupt, checkpoint).
      seed: the render's seed (prng.key_from_seed).
      intersector: "pallas" (the exact-culled K1 + K2/K4 path),
        "pallas_brute" (K3, every cluster, uncompacted), "brute" (the
        chunked dense sweep), "bvh" (the stackless BVH walk) or "auto"
        ("pallas" on the card; on the CPU "brute" up to brute_max_tris
        triangles, "bvh" above).
      brute_chunk: triangles per chunk of the "brute" sweep.
      brute_max_tris: the triangle count up to which "auto" means "brute"
        on the CPU.
      compact: "auto" calibrates per-bounce lane budgets from a 1-spp
        measurement (runtime.auto_lane_schedule) and compacts dead lanes;
        "off" keeps full-width masked lanes.
      compact_margin: safety factor on the measured alive counts; an
        undershoot is detected and re-rendered uncompacted, never biased.
      compact_schedule: explicit lane budgets for bounces 1..ray_depth-1
        (overrides compact="auto").
    """

    width: int = 512
    height: int = 512
    ray_depth: int = 8
    samples: int = 1024
    continuous: bool = False
    samples_per_step: int = 4
    seed: int = 0
    intersector: str = "auto"
    brute_chunk: int = 512
    brute_max_tris: int = 512
    compact: str = "off"
    compact_margin: float = 1.04
    compact_schedule: Optional[tuple] = None

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
