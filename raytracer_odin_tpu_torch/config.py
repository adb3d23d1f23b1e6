"""Render configuration (port of raytracer_odin_tpu/config.py).

Mirrors the reference's ``Rendering_Config`` (main.odin:27-32) plus the
execution knobs the port honours, under the JAX package's field names and
defaults, but for `debug_features` (see RenderConfig). Every field of the
JAX configuration is here.
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
      debug_features: accumulate the debug AOV layers (every registered
        probe of ops/probes.py after the beauty layer; main.odin:17, :48).
        They need full-width lanes every bounce, so they turn compaction
        off. Default False, where the JAX package's is True: the port's
        callers render beauty only, compacted, and a True default would
        silently turn compaction off for all of them (ROADMAP.md queue C).
        The CLI sets it from --debug, as the JAX CLI does.
      intersector: "pallas" (the exact-culled K1 + K2/K4 path),
        "pallas_brute" (K3, every cluster, uncompacted), "brute" (the
        chunked dense sweep), "bvh" (the stackless BVH walk) or "auto"
        ("pallas" on the card; on the CPU "brute" up to brute_max_tris
        triangles, "bvh" above).
      light_chunk: lights a step of the dense light pdf
        (shading.light_pdf_sum's chunk).
      brute_chunk: triangles per chunk of the "brute" sweep.
      brute_max_tris: the triangle count up to which "auto" means "brute"
        on the CPU.
      precision: "f32", the only precision the port renders in (the JAX
        package accepts "bf16" and reads neither); anything else raises
        ValueError.
      wavefront_pool: render each step through the persistent lane pool
        (ops/wavefront.py) instead of the batched wavefront; beauty only.
      pool_fraction: the pool's lanes as a fraction of the pixels.
      compact: "auto" calibrates per-bounce lane budgets from a 1-spp
        measurement (runtime.auto_lane_schedule) and compacts dead lanes;
        "off" keeps full-width masked lanes; "refill" runs the cross-sample
        refill scheduler (ops/refill.py) where it applies (refill_applies),
        the batched wavefront elsewhere, as in the JAX package.
      compact_margin: safety factor on the measured alive counts; an
        undershoot is detected and re-rendered uncompacted, never biased.
      compact_schedule: explicit lane budgets for bounces 1..ray_depth-1
        (overrides compact="auto").
      num_devices: devices to shard the image over (None = all of them);
        parallel/mesh.py and the CLI's --devices.
    """

    width: int = 512
    height: int = 512
    ray_depth: int = 8
    samples: int = 1024
    continuous: bool = False
    samples_per_step: int = 4
    seed: int = 0
    debug_features: bool = False
    intersector: str = "auto"
    light_chunk: int = 256
    brute_chunk: int = 512
    brute_max_tris: int = 512
    precision: str = "f32"
    wavefront_pool: bool = False
    pool_fraction: float = 0.5
    compact: str = "off"
    compact_margin: float = 1.04
    compact_schedule: Optional[tuple] = None
    num_devices: Optional[int] = None

    def __post_init__(self):
        if self.precision != "f32":
            raise ValueError(f"precision={self.precision!r}: the port "
                             "renders in 'f32' only")

    @property
    def num_layers(self) -> int:
        """Stats layers: 1 (beauty), or with debug_features beauty plus one
        per registered probe (10 with the builtin set; NUM_LAYERS,
        main.odin:48)."""
        if not self.debug_features:
            return 1
        from raytracer_odin_tpu_torch.ops import probes

        return probes.num_layers()

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# AOV layer indices with debug_features: layer 0 is the beauty render, the
# others are the builtin probes in registry order (ops/probes.py).
LAYER_BEAUTY = 0
LAYER_NORMAL = 1       # first-hit shading normal, mapped to [0,1]
LAYER_DEPTH = 2        # first-hit distance t
LAYER_ALBEDO = 3       # first-hit material color
LAYER_EMISSION = 4     # first-hit emission
LAYER_UV = 5           # first-hit texcoords
LAYER_BOUNCES = 6      # number of path vertices before termination
LAYER_ANOMALY = 7      # firefly indicator: ||exitance||_1 > 1e3 (raytracer.odin:502)
LAYER_PDF = 8          # first-bounce sampling pdf
LAYER_MISS = 9         # primary-ray miss mask
