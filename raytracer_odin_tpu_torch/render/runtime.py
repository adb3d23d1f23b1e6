"""Render runtime: camera rays, the per-step sample loop and the host
driver (port of raytracer_odin_tpu/render/runtime.py).

One render step computes `samples_per_step` full-image samples and folds
them into the device-resident Stats; the host loop repeats steps until the
target spp. With compact="auto" one uncompacted 1-spp sample first
calibrates the per-bounce lane budgets of the compacted wavefront; if a
budget undershoots (overflow), the render is redone uncompacted.

Entry points take a `device` (default "cuda") and refuse a scene that
lives elsewhere: nothing moves work to the CPU behind the caller's back.
Benchmark trials, continuous mode, interrupts, previews, row sharding, the
pool and refill schedulers and the multi-device path are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops.integrator import (
    TraceOptions,
    compaction_applies,
    trace,
)
from raytracer_odin_tpu_torch.render import accum
from raytracer_odin_tpu_torch.utils import prng
from raytracer_odin_tpu_torch.utils.math3d import normalize


def _require_device(scene, device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    sdev = scene.device
    if sdev.type != dev.type or (dev.index is not None
                                 and sdev.index != dev.index):
        raise ValueError(f"the scene lives on {sdev}, not on {dev}")
    return sdev


def generate_rays(cam_pos, cam_basis, fov_x: float, width: int, height: int,
                  jitter):
    """Camera rays with per-pixel jitter ([H, W, 2] uniforms). Image row r
    is reference pixel py = height - 1 - r (the flip on store,
    main.odin:95, baked into ray generation). The basis rotation is written
    out in f32 multiplies and adds, so no matmul precision mode touches it.

    Returns (o [H, W, 3], d [H, W, 3])."""
    dev = jitter.device
    aspect = width / height
    tan_fx = torch.tan(torch.tensor(fov_x / 2.0, dtype=torch.float32,
                                    device=dev))
    tan_fy = tan_fx / aspect

    r = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    py = (height - 1.0) - r

    x = px + jitter[..., 0]
    y = py + jitter[..., 1]
    ndc_x = x / (width / 2.0) - 1.0
    ndc_y = y / (height / 2.0) - 1.0
    vx = ndc_x * tan_fx
    vy = ndc_y * tan_fy
    b = cam_basis
    d = torch.stack(
        [vx * b[i, 0] + vy * b[i, 1] + b[i, 2] for i in range(3)], dim=-1
    )
    d = normalize(d, eps=1e-20)
    o = cam_pos.expand(d.shape).contiguous()
    return o, d


def camera_rays(scene, key, sample, fov_x: float, width: int, height: int):
    """One full-image sample's jittered camera rays, with per-pixel
    counter-based streams (stream id = pixel index). Returns (o, d)
    [H, W, 3]."""
    dev = scene.device
    rows = torch.arange(height, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    stream_ids = rows * width + cols

    jitter = prng.uniforms(key, sample, prng.JITTER_TAG, stream_ids, 2)
    return generate_rays(scene.cam_pos, scene.cam_basis, fov_x, width,
                         height, jitter)


def sample_pass(scene, key, sample, fov_x: float, width: int, height: int,
                opts: TraceOptions):
    """One full-image sample: jittered camera rays + wavefront trace.
    Returns (radiance [H, W, 3], aux)."""
    o, d = camera_rays(scene, key, sample, fov_x, width, height)
    return trace(scene, o, d, key, sample, opts)


def _trace_options(cfg: RenderConfig, lane_schedule=None) -> TraceOptions:
    if cfg.compact not in ("auto", "off"):
        raise ValueError(f"compact={cfg.compact!r}: the port has 'auto' and "
                         "'off'")
    return TraceOptions(
        depth=cfg.ray_depth,
        intersector=cfg.intersector,
        lane_schedule=tuple(lane_schedule) if lane_schedule else None,
    )


def make_render_step(cfg: RenderConfig, fov_x: float, lane_schedule=None,
                     device="cuda") -> Callable:
    """Build the step: (scene, stats, key, sample_start) -> (stats, info).
    Computes cfg.samples_per_step full-image samples in order and folds
    them into `stats` in place. `info` is an int64 tensor on the device:
    [rays cast, compaction overflow lanes, live lanes entering bounce
    0..depth-1], summed over the step's samples (the JAX step returns the
    first two)."""
    opts = _trace_options(cfg, cfg.compact_schedule or lane_schedule)
    H, W = cfg.height, cfg.width

    def step(scene, stats, key, sample_start: int):
        _require_device(scene, device)
        info = None
        for k in range(cfg.samples_per_step):
            radiance, aux = sample_pass(
                scene, key, sample_start + k, fov_x, W, H, opts
            )
            accum.update_layers(stats, radiance[None])
            vals = torch.cat([aux["rays_cast"].reshape(1),
                              aux["overflow"].reshape(1),
                              aux["alive_counts"]])
            info = vals if info is None else info + vals
        return stats, info

    return step


def auto_lane_schedule(scene, cfg: RenderConfig, fov_x: float,
                       device="cuda"):
    """Per-bounce lane budgets from one uncompacted 1-spp sample:
    budget[b-1] = alive entering bounce b times cfg.compact_margin plus two ray
    blocks, rounded up to a ray-block multiple and capped at the padded
    frame."""
    _require_device(scene, device)
    _, aux = sample_pass(scene, prng.key_from_seed(cfg.seed), 0, fov_x,
                         cfg.width, cfg.height, _trace_options(cfg))
    counts = aux["alive_counts"].tolist()
    rb = pi.RB
    n0p = -(-(cfg.height * cfg.width) // rb) * rb
    sched = []
    for c in counts[1:]:
        s = int(c * cfg.compact_margin) + 2 * rb
        sched.append(min(n0p, -(-s // rb) * rb))
    return tuple(sched)


@dataclasses.dataclass
class RenderResult:
    stats: accum.Stats
    samples_done: int
    # Host wall time of the steps (after calibration), the device finished.
    seconds: float
    # Live path segments cast (the JAX package's accounting: dead lanes are
    # not credited).
    rays_cast: int = 0
    # Live lanes that the compacted attempt's lane budgets cut off. Non-zero
    # means that attempt was thrown away and `stats` is the uncompacted
    # re-render (lane_schedule None).
    overflow: int = 0
    # Live lanes entering each bounce, summed over every sample rendered.
    alive_counts: tuple = ()
    # The lane budgets the returned render used (None: uncompacted).
    lane_schedule: Optional[tuple] = None


def render_scene(scene, cfg: RenderConfig, fov_x: float, device="cuda",
                 on_step: Optional[Callable] = None) -> RenderResult:
    """Full render (render_scene, raytracer.odin:602-665) of cfg.samples
    samples. on_step(stats, samples_done) runs after every step."""
    dev = _require_device(scene, device)
    lane_schedule = None
    if compaction_applies(_trace_options(cfg)):
        lane_schedule = cfg.compact_schedule
        if cfg.compact == "auto" and lane_schedule is None:
            lane_schedule = auto_lane_schedule(scene, cfg, fov_x,
                                               device=device)
    step = make_render_step(cfg, fov_x, lane_schedule=lane_schedule,
                            device=device)
    key = prng.key_from_seed(cfg.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    stats = accum.init_stats(1, cfg.height, cfg.width, device=dev)
    samples_done = 0
    info_total = None  # device-side sums; read once at the end
    sync()
    start = time.perf_counter()
    while samples_done < cfg.samples:
        stats, info = step(scene, stats, key, samples_done)
        info_total = info if info_total is None else info_total + info
        samples_done += cfg.samples_per_step
        if on_step is not None:
            on_step(stats, samples_done)
    sync()
    seconds = time.perf_counter() - start

    totals = [] if info_total is None else info_total.tolist()
    rays = totals[0] if totals else 0
    overflow = totals[1] if totals else 0
    if overflow > 0:
        # A compaction slice truncated live lanes: the render is invalid.
        # Re-render uncompacted, which is correct by construction.
        print(f"WARNING: lane-schedule overflow ({overflow} lanes); "
              "re-rendering uncompacted")
        redo = render_scene(
            scene, cfg.replace(compact="off", compact_schedule=None), fov_x,
            device=device, on_step=on_step,
        )
        return dataclasses.replace(redo, overflow=int(overflow))
    return RenderResult(
        stats=stats,
        samples_done=samples_done,
        seconds=seconds,
        rays_cast=int(rays),
        overflow=int(overflow),
        alive_counts=tuple(int(c) for c in totals[2:]),
        lane_schedule=tuple(lane_schedule) if lane_schedule else None,
    )
