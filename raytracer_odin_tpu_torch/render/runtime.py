"""Render runtime: camera rays, the per-step sample loop and the host
driver with trials, continuous mode and interrupts (port of
raytracer_odin_tpu/render/runtime.py).

One render step computes `samples_per_step` full-image samples and folds
them into the device-resident Stats; the host loop repeats steps until the
target spp, or in continuous mode until interrupted or converged, checking
the interrupt flag only between steps (raytracer.odin:554). With
compact="auto" one uncompacted 1-spp sample first calibrates the
per-bounce lane budgets of the compacted wavefront; if a budget undershoots
(overflow), the render is redone uncompacted. With cfg.debug_features
every sample also folds the registered probes' AOV layers, uncompacted and
without calibration; with debug_nans every sample's values are checked
for NaN before they are folded (make_render_step).

Entry points take a `device` (default "cuda") and refuse a scene that
lives elsewhere: nothing moves work to the CPU behind the caller's back.
The pool and refill schedulers and the multi-device path are not ported
yet.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import torch

from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops import probes
from raytracer_odin_tpu_torch.ops.integrator import (
    TraceOptions,
    compaction_applies,
    trace,
)
from raytracer_odin_tpu_torch.render import accum
from raytracer_odin_tpu_torch.utils import prng
from raytracer_odin_tpu_torch.utils.math3d import normalize


class InterruptFlag:
    """Cooperative interrupt (async_interrupt / is_interrupted,
    main.odin:20-25): install() routes SIGINT to the flag; the host loop
    tests it between steps."""

    def __init__(self):
        self._flag = False
        self._prev = None

    def install(self):
        def handler(signum, frame):
            self._flag = True
        self._prev = signal.signal(signal.SIGINT, handler)
        return self

    def uninstall(self):
        if self._prev is not None:
            signal.signal(signal.SIGINT, self._prev)

    def set(self):
        self._flag = True

    def __bool__(self):
        return self._flag


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
                  jitter, row_offset: int = 0, n_rows: Optional[int] = None):
    """Camera rays with per-pixel jitter for rows [row_offset, row_offset +
    n_rows) of a height-`height` image (jitter: [n_rows, W, 2] uniforms, or
    any shape that broadcasts to it). Image row r is reference pixel
    py = height - 1 - r (the flip on store, main.odin:95, baked into ray
    generation). The basis rotation is written out in f32 multiplies and
    adds, so no matmul precision mode touches it; a pixel's ray is the same
    bits whatever rows are generated with it.

    Returns (o [n_rows, W, 3], d [n_rows, W, 3])."""
    if n_rows is None:
        n_rows = height
    dev = jitter.device
    aspect = width / height
    tan_fx = torch.tan(torch.tensor(fov_x / 2.0, dtype=torch.float32,
                                    device=dev))
    tan_fy = tan_fx / aspect

    r = row_offset + torch.arange(n_rows, dtype=torch.float32,
                                  device=dev)[:, None]
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
        brute_chunk=cfg.brute_chunk,
        brute_max_tris=cfg.brute_max_tris,
        want_aux=cfg.debug_features,
        lane_schedule=tuple(lane_schedule) if lane_schedule else None,
    )


def sample_layer_values(radiance, aux, debug: bool):
    """One sample's per-layer values [L, ..., 3]: L = 1 (beauty only) or
    1 + len(probes) (beauty first, then every registered probe in registry
    order; the builtin set keeps the config.LAYER_* indices)."""
    if not debug:
        return radiance[None]
    vals = [radiance]
    for p in probes.active():
        vals.append(p.display_value(aux[p.name]))
    return torch.stack(vals, dim=0)


def _raise_on_nans(scene, key, sample, vals, fov_x, width, height, opts,
                   debug: bool):
    """--debug-nans (the port's counterpart of jax_debug_nans, which checks
    what a step outputs): if the values a sample folds in hold a NaN,
    re-run the sample uncompacted with the live-lane check after each
    bounce's cast and shade (TraceOptions.check_nans), which raises
    FloatingPointError naming the bounce and the stage; if no live lane
    holds one there, raise naming the layers and pixels of the output."""
    nan = torch.isnan(vals).any(dim=-1)  # [L, H, W]
    if not bool(nan.any()):
        return
    sample_pass(scene, key, sample, fov_x, width, height,
                opts._replace(lane_schedule=None, check_nans=True))
    names = probes.layer_names() if debug else ["beauty"]
    layers = [names[i] for i in range(nan.shape[0]) if bool(nan[i].any())]
    ids = torch.nonzero(nan.any(dim=0).reshape(-1))[:8, 0].tolist()
    raise FloatingPointError(
        f"NaN in the values sample {int(sample)} folds in (layers {layers}; "
        f"first pixel ids {ids}); no live lane of its uncompacted re-run "
        "holds one after a cast or a shade")


def make_render_step(cfg: RenderConfig, fov_x: float, lane_schedule=None,
                     device="cuda", debug_nans: bool = False) -> Callable:
    """Build the step: (scene, stats, key, sample_start) -> (stats, info).
    Computes cfg.samples_per_step full-image samples in order and folds
    them into `stats` in place: the beauty layer, and with
    cfg.debug_features every registered probe's layer. `info` is an int64
    tensor on the device: [rays cast, compaction overflow lanes, live lanes
    entering bounce 0..depth-1], summed over the step's samples (the JAX
    step returns the first two).

    debug_nans: check every sample's values for NaN before they are folded
    (one device sync a sample) and raise FloatingPointError naming the
    sample, the bounce, the stage and the first pixel ids (_raise_on_nans).
    Off, the step runs no check and no sync."""
    opts = _trace_options(cfg, cfg.compact_schedule or lane_schedule)
    H, W = cfg.height, cfg.width

    def step(scene, stats, key, sample_start: int):
        _require_device(scene, device)
        info = None
        for k in range(cfg.samples_per_step):
            radiance, aux = sample_pass(
                scene, key, sample_start + k, fov_x, W, H, opts
            )
            vals = sample_layer_values(radiance, aux, cfg.debug_features)
            if debug_nans:
                _raise_on_nans(scene, key, sample_start + k, vals, fov_x, W,
                               H, opts, cfg.debug_features)
            accum.update_layers(stats, vals)
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
    # Host wall time of each trial's steps (after calibration), the device
    # finished.
    trial_seconds: list
    # Live path segments cast over every trial (the JAX package's
    # accounting: dead lanes are not credited).
    rays_cast: int = 0
    # Live lanes that the compacted attempt's lane budgets cut off. Non-zero
    # means that attempt was thrown away and `stats` is the uncompacted
    # re-render (lane_schedule None).
    overflow: int = 0
    # Live lanes entering each bounce, summed over every sample rendered.
    alive_counts: tuple = ()
    # The lane budgets the returned render used (None: uncompacted).
    lane_schedule: Optional[tuple] = None


def render_scene(
    scene,
    cfg: RenderConfig,
    fov_x: float,
    device="cuda",
    trials: int = 1,
    interrupt: Optional[InterruptFlag] = None,
    on_step: Optional[Callable] = None,
    initial_stats: Optional[accum.Stats] = None,
    initial_samples: int = 0,
    verbose: bool = False,
    make_stats: Optional[Callable] = None,
    converge_se: float = 0.0,
    converge_check_every: int = 16,
    debug_nans: bool = False,
) -> RenderResult:
    """Full render with benchmark trials (render_scene,
    raytracer.odin:602-665). Each trial renders cfg.samples samples, or in
    continuous mode (cfg.continuous) runs until `interrupt` is set;
    on_step(stats, samples_done) runs after every step (checkpoint hook).
    The first trial resumes from initial_stats / initial_samples when
    given; `make_stats` overrides the fresh-accumulator factory.

    converge_se > 0 adds a convergence stop to continuous mode: every
    `converge_check_every` steps the median per-pixel standard error of
    the beauty mean (mean_standard_error) is computed, and the render stops
    once it drops below the threshold.

    With cfg.debug_features the stats hold cfg.num_layers layers and the
    render runs uncompacted, without calibration. debug_nans: see
    make_render_step.

    The step counters stay on the device and are read once at the end."""
    dev = _require_device(scene, device)
    lane_schedule = None
    if compaction_applies(_trace_options(cfg), dev):
        lane_schedule = cfg.compact_schedule
        if cfg.compact == "auto" and lane_schedule is None:
            lane_schedule = auto_lane_schedule(scene, cfg, fov_x,
                                               device=device)
    step = make_render_step(cfg, fov_x, lane_schedule=lane_schedule,
                            device=device, debug_nans=debug_nans)
    if make_stats is None:
        def make_stats():
            return accum.init_stats(cfg.num_layers, cfg.height, cfg.width,
                                    device=dev)
    key = prng.key_from_seed(cfg.seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings = []
    result_stats = None
    samples_done = 0
    info_total = None  # device-side sums; read once at the end
    target = None if cfg.continuous else cfg.samples
    for trial in range(trials):
        stats = (initial_stats if (initial_stats is not None and trial == 0)
                 else make_stats())
        samples_done = initial_samples if trial == 0 else 0
        sync()
        start = time.perf_counter()
        while target is None or samples_done < target:
            if interrupt:
                break
            stats, info = step(scene, stats, key, samples_done)
            info_total = info if info_total is None else info_total + info
            samples_done += cfg.samples_per_step
            if on_step is not None:
                on_step(stats, samples_done)
            if (converge_se > 0.0 and cfg.continuous
                    and (samples_done // cfg.samples_per_step)
                    % converge_check_every == 0):
                se = float(mean_standard_error(
                    accum.crop(stats, cfg.height, cfg.width)))
                if verbose:
                    print(f"{samples_done} spp, median standard error "
                          f"{se:.2e} (target {converge_se:.1e})")
                if se < converge_se:
                    if verbose:
                        print(f"Converged at {samples_done} spp")
                    break
        sync()
        elapsed = time.perf_counter() - start
        timings.append(elapsed)
        if verbose:
            print(f"Trial {trial} >>> Rendered in {elapsed*1000:.2f}ms")
        result_stats = stats
        if interrupt:
            break

    if verbose and trials > 1:
        print_perf_summary(timings)

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
            device=device, trials=trials, interrupt=interrupt,
            on_step=on_step, verbose=verbose, make_stats=make_stats,
            converge_se=converge_se,
            converge_check_every=converge_check_every, debug_nans=debug_nans,
        )
        return dataclasses.replace(redo, overflow=int(overflow))
    return RenderResult(
        stats=result_stats,
        samples_done=samples_done,
        trial_seconds=timings,
        rays_cast=int(rays),
        overflow=int(overflow),
        alive_counts=tuple(int(c) for c in totals[2:]),
        lane_schedule=tuple(lane_schedule) if lane_schedule else None,
    )


def mean_standard_error(stats: accum.Stats):
    """Median per-pixel standard error of the beauty-layer mean
    (sqrt(sample variance / count), median over pixels and channels): the
    convergence statistic of continuous mode. The median, not the mean:
    one-sample-MIS firefly samples have heavy-tailed variance, so the mean
    can jump when a firefly lands, while the median tracks typical-pixel
    noise. For an even count it is the mean of the two middle values, as
    jnp.median gives it (torch.median would return the lower one). Returns
    a 0-dim tensor on the stats' device."""
    n = torch.clamp(stats.count[0], min=1.0)[..., None]
    mean = stats.total[0] / n
    var = torch.clamp(stats.total_sq[0] / n - mean * mean, min=0.0)
    se = torch.sort(torch.sqrt(var / n).reshape(-1)).values
    m = se.numel()
    return (se[(m - 1) // 2] + se[m // 2]) * 0.5


def print_perf_summary(timings_s: list) -> None:
    """Mean +/- Bessel-corrected std, best/median/worst
    (raytracer.odin:648-664)."""
    n = len(timings_s)
    ts = sorted(timings_s)
    mean = sum(ts) / n
    var = sum(t * t for t in ts) / n - mean * mean
    std = (var * n / max(n - 1, 1)) ** 0.5 if n > 1 else float("inf")
    median = (ts[n // 2] + ts[(n + 1) // 2 if (n + 1) // 2 < n else n - 1]) / 2
    print(">>>>>>>>> Performance Summary <<<<<<<<<")
    print(f"Trials: {n}")
    print(f"Time: {mean*1000:.02f}±{std*1000:.02f}ms")
    print(
        f"Best: {ts[0]*1000:.02f}ms, Median: {median*1000:.02f}ms, "
        f"Worst: {ts[-1]*1000:.02f}ms"
    )
    print(">>>>>>>>> Performance Summary <<<<<<<<<")
