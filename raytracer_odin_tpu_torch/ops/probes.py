"""Layered debug-probe registry (port of raytracer_odin_tpu/ops/probes.py).

The reference lets any render code write any debug layer through
``debug_rc_set`` (main.odin:104-124, layer machinery main.odin:42-102). Here
a probe is a registered function evaluated at every path vertex inside the
full-width trace (integrator.trace with want_aux), folded into a per-lane
accumulator by a declared reduction. The registry is read each time a trace
runs, so a probe registered before a render is a stats layer of that render
(index 1 + its registry position; layer 0 is always beauty), shows up in
the preview's layer selector, and is selectable with the CLI's --layer.

Adding a probe is one line, like ``debug_rc_set``::

    from raytracer_odin_tpu_torch.ops import probes

    probes.register("first_pos", lambda ctx: ctx.material["pos"],
                    reduce="first_hit")

Reductions:
  first_hit  write ``fn(ctx)`` at the lane's first live hit vertex
  first      write at the lane's first live vertex (hit or env miss)
  sum        accumulate ``fn(ctx)`` over every live vertex
  final      evaluated once after the loop; ctx carries only
             ``radiance`` (e.g. the firefly anomaly mask)

A probe's fn receives torch tensors and returns a tensor (or a number) that
broadcasts to the lane shape, with `channels` trailing values. The builtin
AOV set (config.LAYER_*) is registered below through this same API, in the
JAX package's order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from raytracer_odin_tpu_torch.utils.math3d import norm_l1


class ProbeCtx(NamedTuple):
    """What a probe sees at one path vertex (after shading).

    For ``reduce="final"`` probes only ``radiance`` is populated."""

    bounce: object = None       # int: vertex index
    o: object = None            # [..., 3] incoming ray origin
    d: object = None            # [..., 3] incoming ray direction
    t: object = None            # [...] hit distance (BIG on a miss)
    hit: object = None          # [...] bool: live lane hit a triangle
    missed: object = None       # [...] bool: live lane escaped to env
    alive: object = None        # [...] bool: lane was live at this vertex
    material: object = None     # the point material dict (color, emission,
                                # texcoords, pos, metallic, roughness, ...)
    normal: object = None       # [..., 3] shading normal
    pdf: object = None          # [...] mixture pdf of the sampled dir
    value: object = None        # [..., 3] BRDF value for the sampled dir
    new_d: object = None        # [..., 3] sampled continuation direction
    throughput: object = None   # [..., 3] path throughput after update
    radiance: object = None     # [..., 3] accumulated radiance so far


class Probe(NamedTuple):
    name: str
    fn: Callable[[ProbeCtx], object]
    reduce: str               # "first_hit" | "first" | "sum" | "final"
    channels: int             # 1, 2 or 3 (accumulator trailing dim)
    display: Optional[Callable]  # accumulator -> [..., 3] view (None=auto)

    def init(self, batch_shape, device):
        shape = tuple(batch_shape) + (
            () if self.channels == 1 else (self.channels,))
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def value_of(self, ctx: ProbeCtx, device):
        return torch.as_tensor(self.fn(ctx), dtype=torch.float32,
                               device=device)

    def fold(self, acc, ctx: ProbeCtx, first):
        v = self.value_of(ctx, acc.device)
        if self.reduce == "first_hit":
            m = first & ctx.alive & ctx.hit
        elif self.reduce == "first":
            m = first & ctx.alive
        elif self.reduce == "sum":
            a = ctx.alive if self.channels == 1 else ctx.alive[..., None]
            return acc + torch.where(a, v, 0.0)
        else:
            raise ValueError(f"unknown reduce {self.reduce!r}")
        m = m if self.channels == 1 else m[..., None]
        return torch.where(m, v, acc)

    def display_value(self, acc):
        if self.display is not None:
            return self.display(acc)
        if self.channels == 1:
            return acc[..., None].expand(tuple(acc.shape) + (3,))
        if self.channels == 2:
            return torch.cat([acc, torch.zeros_like(acc[..., :1])], dim=-1)
        return acc


_REGISTRY: dict[str, Probe] = {}


def register(name: str, fn: Callable[[ProbeCtx], object], *,
             reduce: str = "first_hit", channels: int = 3,
             display: Optional[Callable] = None) -> None:
    """Register (or replace) a debug layer. One call, like debug_rc_set."""
    if reduce not in ("first_hit", "first", "sum", "final"):
        raise ValueError(f"unknown reduce {reduce!r}")
    _REGISTRY[name] = Probe(name, fn, reduce, channels, display)


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def active() -> list[Probe]:
    return list(_REGISTRY.values())


def names() -> list[str]:
    return list(_REGISTRY)


def num_layers() -> int:
    """Total stats layers in debug mode: beauty + one per probe."""
    return 1 + len(_REGISTRY)


def layer_names() -> list[str]:
    return ["beauty"] + names()


# ---------------------------------------------------------------------------
# Builtin AOV set (config.LAYER_* indices = 1 + registry position), the JAX
# package's standing layers, through the public API.
# ---------------------------------------------------------------------------

register("normal", lambda c: c.normal, reduce="first_hit",
         display=lambda v: v * 0.5 + 0.5)
register("depth", lambda c: c.t, reduce="first_hit", channels=1)
register("albedo", lambda c: c.material["color"], reduce="first_hit")
register("emission", lambda c: c.material["emission"], reduce="first_hit")
register("uv", lambda c: c.material["texcoords"], reduce="first_hit",
         channels=2)
register("bounces", lambda c: 1.0, reduce="sum", channels=1)
register("anomaly", lambda c: (norm_l1(c.radiance) > 1e3).float(),
         reduce="final", channels=1)
register("pdf", lambda c: c.pdf, reduce="first_hit", channels=1)
register("miss", lambda c: c.missed.float(), reduce="first", channels=1)
