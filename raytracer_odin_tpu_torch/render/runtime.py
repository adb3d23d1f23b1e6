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

The step is chosen as in the JAX package: the persistent pool
(ops/wavefront.py) with cfg.wavefront_pool, cross-sample refill
(ops/refill.py) with compact="refill" where it applies, else the batched
wavefront, compacted or not; a caller's step_fn (parallel/mesh.py's
sharded step) replaces the choice.

Entry points take a `device` (default "cuda") and refuse a scene that
lives elsewhere: nothing moves work to the CPU behind the caller's back.
"""

from __future__ import annotations

import dataclasses
import functools
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
from raytracer_odin_tpu_torch.utils import prng, profiling
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
                  jitter, row_offset: int = 0, n_rows: Optional[int] = None,
                  pixel=None):
    """Camera rays with per-pixel jitter for rows [row_offset, row_offset +
    n_rows) of a height-`height` image (jitter: [n_rows, W, 2] uniforms, or
    any shape that broadcasts to it), or for the flat pixel ids `pixel`
    [N] (row-major image order; jitter [N, 2]: the pool's and refill's
    lanes). Image row r is reference pixel py = height - 1 - r (the flip
    on store, main.odin:95, baked into ray generation). The basis rotation
    is written out in f32 multiplies and adds, so no matmul precision mode
    touches it; a pixel's ray is the same bits whatever pixels are
    generated with it.

    Returns (o, d) [n_rows, W, 3], or [N, 3] for `pixel`."""
    dev = jitter.device
    aspect = width / height
    tan_fx = torch.tan(torch.full((), fov_x / 2.0, dtype=torch.float32,
                                  device=dev))
    tan_fy = tan_fx / aspect

    if pixel is None:
        if n_rows is None:
            n_rows = height
        r = row_offset + torch.arange(n_rows, dtype=torch.float32,
                                      device=dev)[:, None]
        px = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    else:
        r = (pixel // width).to(torch.float32)
        px = (pixel % width).to(torch.float32)
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


def _stream_ids(width: int, row_offset: int, n_rows: int, dev):
    """Per-pixel stream ids (the flat pixel index) of rows [row_offset,
    row_offset + n_rows): [n_rows, W] int32."""
    rows = row_offset + torch.arange(n_rows, dtype=torch.int32,
                                     device=dev)[:, None]
    cols = torch.arange(width, dtype=torch.int32, device=dev)[None, :]
    return rows * width + cols


def camera_rays(scene, key, sample, fov_x: float, width: int, height: int,
                row_offset: int = 0, n_rows: Optional[int] = None):
    """One sample's jittered camera rays for rows [row_offset, row_offset +
    n_rows) (the full image by default), with per-pixel counter-based
    streams (stream id = pixel index). Returns (o, d) [n_rows, W, 3]."""
    if n_rows is None:
        n_rows = height
    stream_ids = _stream_ids(width, row_offset, n_rows, scene.device)
    jitter = prng.uniforms(key, sample, prng.JITTER_TAG, stream_ids, 2)
    return generate_rays(scene.cam_pos, scene.cam_basis, fov_x, width,
                         height, jitter, row_offset=row_offset,
                         n_rows=n_rows)


def sample_pass(scene, key, sample, fov_x: float, width: int, height: int,
                opts: TraceOptions, row_offset: int = 0,
                n_rows: Optional[int] = None):
    """One sample for rows [row_offset, row_offset + n_rows) (the full
    image by default): jittered camera rays + wavefront trace. The draws
    are addressed by pixel, so a row window renders what the full frame
    renders for its pixels. Returns (radiance [n_rows, W, 3], aux)."""
    if n_rows is None:
        n_rows = height
    o, d = camera_rays(scene, key, sample, fov_x, width, height,
                       row_offset, n_rows)
    # a row window's stream ids are row_offset * W + its flat lane position
    return trace(scene, o, d, key, sample, opts,
                 stream_base=row_offset * width)


def _trace_options(cfg: RenderConfig, lane_schedule=None) -> TraceOptions:
    if cfg.compact not in ("auto", "off", "refill"):
        raise ValueError(f"compact={cfg.compact!r}: one of 'auto', 'off', "
                         "'refill'")
    return TraceOptions(
        depth=cfg.ray_depth,
        intersector=cfg.intersector,
        brute_chunk=cfg.brute_chunk,
        brute_max_tris=cfg.brute_max_tris,
        light_chunk=cfg.light_chunk,
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
    profiling.count("host_syncs")
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
                     device="cuda", debug_nans: bool = False,
                     refill_plan=None) -> Callable:
    """Build the step: (scene, stats, key, sample_start) -> (stats, info).
    Computes cfg.samples_per_step full-image samples in order and folds
    them into `stats` in place: the beauty layer, and with
    cfg.debug_features every registered probe's layer. `info` is an int64
    tensor on the device: [rays cast, compaction overflow lanes, live lanes
    entering bounce 0..depth-1], summed over the step's samples (the JAX
    step returns the first two).

    As in the JAX package, cfg.wavefront_pool gives the pool's step
    (make_pool_render_step) and a refill_plan the refill scheduler's
    (make_refill_render_step); they fold the same stats and info.

    debug_nans: check every sample's values for NaN before they are folded
    (one device sync a sample) and raise FloatingPointError naming the
    sample, the bounce, the stage and the first pixel ids (_raise_on_nans).
    The pool and refill steps check the beauty totals after the step
    instead, and on a NaN re-run each of its samples through that check.
    Off, the step runs no check and no sync."""
    if cfg.wavefront_pool or refill_plan is not None:
        step = (make_pool_render_step(cfg, fov_x, device=device)
                if cfg.wavefront_pool else
                make_refill_render_step(cfg, fov_x, refill_plan,
                                        device=device))
        return _nan_checked(step, cfg, fov_x) if debug_nans else step
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
            with profiling.span("accumulate"):
                accum.update_layers(stats, vals)
                vals = torch.cat([aux["rays_cast"].reshape(1),
                                  aux["overflow"].reshape(1),
                                  aux["alive_counts"]])
                info = vals if info is None else info + vals
        return stats, info

    return step


def _nan_checked(step, cfg: RenderConfig, fov_x: float) -> Callable:
    """--debug-nans for the steps that fold their samples together (the
    pool, refill, a sharded step): one isnan over the beauty totals after
    the step (one sync); on a NaN each of the step's samples re-runs on one
    device through _raise_on_nans, whose values equal the step's."""
    opts = _trace_options(cfg)
    H, W = cfg.height, cfg.width

    @functools.wraps(step)
    def checked(scene, stats, key, sample_start: int):
        stats, info = step(scene, stats, key, sample_start)
        profiling.count("host_syncs")
        if bool(torch.isnan(stats.total[0]).any()):
            # a sharded step's scene is one copy a device
            if isinstance(scene, dict):
                scene = scene[scene.device]
            for k in range(cfg.samples_per_step):
                radiance, _ = sample_pass(scene, key, sample_start + k,
                                          fov_x, W, H, opts)
                _raise_on_nans(scene, key, sample_start + k, radiance[None],
                               fov_x, W, H, opts, False)
            raise FloatingPointError(
                f"NaN in the beauty totals after the step of samples "
                f"{sample_start}..{sample_start + cfg.samples_per_step - 1}"
                "; none of them re-rendered holds one")
        return stats, info

    return checked


class PoolStep:
    """The persistent pool's step (ops/wavefront.py): the batched step's
    signature, stats and info (overflow 0: the pool cuts no live lane),
    beauty layer only. Records the waves of every step it runs (waves)."""

    def __init__(self, cfg: RenderConfig, fov_x: float, device="cuda"):
        if cfg.debug_features:
            raise ValueError("wavefront_pool requires debug_features=False")
        self.cfg, self.fov_x, self.device = cfg, fov_x, device
        self.opts = _trace_options(cfg)
        n = cfg.height * cfg.width
        pool = max(1024, int(n * cfg.pool_fraction))
        # whole ray blocks, as the kernels take them
        self.pool_size = -(-pool // pi.RB) * pi.RB
        self.waves = []

    def __call__(self, scene, stats, key, sample_start: int):
        from raytracer_odin_tpu_torch.ops import wavefront

        _require_device(scene, self.device)
        cfg = self.cfg
        n = cfg.height * cfg.width
        ps = wavefront.PoolStats(*(getattr(stats, f)[0].view(n, 3) for f in
                                   ("first", "last", "total", "total_sq")))
        run = wavefront.render_pool_step(
            scene, ps, key, sample_start, width=cfg.width,
            height=cfg.height, fov_x=self.fov_x,
            samples=cfg.samples_per_step, pool_size=self.pool_size,
            opts=self.opts)
        stats.count[0] += float(cfg.samples_per_step)
        self.waves.append(run.waves)
        info = torch.cat([run.rays.reshape(1),
                          torch.zeros(1, dtype=torch.int64,
                                      device=run.rays.device),
                          run.alive_counts])
        return stats, info


def make_pool_render_step(cfg: RenderConfig, fov_x: float,
                          device="cuda") -> PoolStep:
    """Persistent-wavefront step (ops/wavefront.py): the pool holds
    max(1024, pixels x cfg.pool_fraction) lanes rounded up to RB; same
    signature and accumulator semantics as the batched step, beauty layer
    only."""
    return PoolStep(cfg, fov_x, device=device)


def make_refill_render_step(cfg: RenderConfig, fov_x: float, plan,
                            device="cuda") -> Callable:
    """Step of the cross-sample refill scheduler (ops/refill.py): one
    wavefront renders all cfg.samples_per_step samples; their values are
    folded in sample order, as the batched step folds them, so the stats
    match it sample for sample. Beauty layer only; info as the batched
    step's, with the plan's overflow."""
    if cfg.debug_features:
        raise ValueError("refill scheduler requires debug_features=False")
    from raytracer_odin_tpu_torch.ops import refill

    opts = _trace_options(cfg)
    H, W, S = cfg.height, cfg.width, cfg.samples_per_step

    def step(scene, stats, key, sample_start: int):
        _require_device(scene, device)
        run = refill.trace_refill(scene, key, sample_start, opts, plan, W,
                                  H, fov_x, S)
        r = run.radiance.reshape(H, W, S, 3)
        for k in range(S):
            accum.update_layer(stats, 0, r[:, :, k])
        info = torch.cat([run.rays.reshape(1), run.overflow.reshape(1),
                          run.alive_counts])
        return stats, info

    return step


def _calibration_counts(scene, cfg: RenderConfig, fov_x: float, device,
                        row_offset: int = 0, n_rows: Optional[int] = None):
    """Live lanes entering each bounce in one uncompacted sample (sample 0
    of the seed) of rows [row_offset, row_offset + n_rows)."""
    _require_device(scene, device)
    with profiling.span("calibrate"):
        _, aux = sample_pass(scene, prng.key_from_seed(cfg.seed), 0, fov_x,
                             cfg.width, cfg.height, _trace_options(cfg),
                             row_offset=row_offset, n_rows=n_rows)
        profiling.count("host_syncs")
        return aux["alive_counts"].tolist()


def auto_lane_schedule(scene, cfg: RenderConfig, fov_x: float,
                       device="cuda", row_offset: int = 0,
                       n_rows: Optional[int] = None):
    """Per-bounce lane budgets from one uncompacted 1-spp sample of rows
    [row_offset, row_offset + n_rows) (the full frame by default):
    budget[b-1] = alive entering bounce b times cfg.compact_margin plus two
    ray blocks, rounded up to a ray-block multiple and capped at the padded
    lane count."""
    if n_rows is None:
        n_rows = cfg.height
    counts = _calibration_counts(scene, cfg, fov_x, device, row_offset,
                                 n_rows)
    rb = pi.RB
    n0p = -(-(n_rows * cfg.width) // rb) * rb
    sched = []
    for c in counts[1:]:
        s = int(c * cfg.compact_margin) + 2 * rb
        sched.append(min(n0p, -(-s // rb) * rb))
    return tuple(sched)


def auto_refill_plan(scene, cfg: RenderConfig, fov_x: float,
                     device="cuda"):
    """The refill schedule (ops/refill.plan_refill) from the same 1-spp
    alive-count probe auto_lane_schedule uses."""
    from raytracer_odin_tpu_torch.ops import refill

    counts = _calibration_counts(scene, cfg, fov_x, device)
    return refill.plan_refill(counts, cfg.width * cfg.height,
                              cfg.samples_per_step, cfg.ray_depth, pi.RB,
                              cfg.compact_margin)


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
    # The lane budgets the returned render used (None: uncompacted; a
    # sharded step's: one tuple a tile).
    lane_schedule: Optional[tuple] = None
    # The refill schedule the returned render used (None: another step).
    refill_plan: Optional[tuple] = None
    # The pool's waves in each step (empty: another step).
    pool_waves: tuple = ()
    # What the call added to profiling.PROCESS: its spans and counters
    # (calibration included; step_spans / step_counters: inside its steps).
    phases: profiling.PhaseTimer = dataclasses.field(
        default_factory=profiling.PhaseTimer)


def render_scene(
    scene,
    cfg: RenderConfig,
    fov_x: float,
    device="cuda",
    trials: int = 1,
    interrupt: Optional[InterruptFlag] = None,
    on_step: Optional[Callable] = None,
    step_fn: Optional[Callable] = None,
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
    given; `make_stats` overrides the fresh-accumulator factory and
    `step_fn` the step (a sharded render passes both: parallel/mesh.py).

    Without step_fn the step is chosen as the JAX package's render_scene
    chooses it: the pool with cfg.wavefront_pool; refill, planned from one
    calibration sample, with compact="refill" where refill_applies; else
    the batched step, compacted with calibrated lane budgets where
    compaction applies.

    converge_se > 0 adds a convergence stop to continuous mode: every
    `converge_check_every` steps the median per-pixel standard error of
    the beauty mean (mean_standard_error) is computed, and the render stops
    once it drops below the threshold.

    With cfg.debug_features the stats hold cfg.num_layers layers and the
    render runs uncompacted, without calibration. debug_nans: see
    make_render_step.

    A compacted or refilled render whose budgets cut a live lane (overflow)
    is redone uncompacted; a step_fn that can overflow must offer
    `uncompacted()`, the step to redo it with.

    The step counters stay on the device and are read once at the end.
    RenderResult.phases holds the spans and counters the call recorded
    (utils/profiling.py): one "step" span a step."""
    from raytracer_odin_tpu_torch.ops import refill

    tally = profiling.PROCESS.snapshot()
    dev = _require_device(scene, device)
    lane_schedule = None
    refill_plan = None
    step = step_fn
    if step is None:
        opts = _trace_options(cfg)
        if cfg.wavefront_pool:
            pass
        elif cfg.compact == "refill" and refill.refill_applies(opts, dev):
            refill_plan = auto_refill_plan(scene, cfg, fov_x, device=device)
        elif compaction_applies(opts, dev):
            lane_schedule = cfg.compact_schedule
            if cfg.compact == "auto" and lane_schedule is None:
                lane_schedule = auto_lane_schedule(scene, cfg, fov_x,
                                                   device=device)
        step = make_render_step(cfg, fov_x, lane_schedule=lane_schedule,
                                device=device, debug_nans=debug_nans,
                                refill_plan=refill_plan)
    else:
        lane_schedule = getattr(step, "lane_schedule", None)
        if debug_nans:
            step = _nan_checked(step, cfg, fov_x)
    if make_stats is None:
        def make_stats():
            return accum.init_stats(cfg.num_layers, cfg.height, cfg.width,
                                    device=dev)
    key = prng.key_from_seed(cfg.seed)

    def sync():
        # every card: a sharded step's shards may run on several
        if dev.type == "cuda":
            profiling.count("host_syncs")
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

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
            with profiling.span(profiling.STEP):
                stats, info = step(scene, stats, key, samples_done)
                info_total = (info if info_total is None
                              else info_total + info)
            samples_done += cfg.samples_per_step
            if on_step is not None:
                on_step(stats, samples_done)
            if (converge_se > 0.0 and cfg.continuous
                    and (samples_done // cfg.samples_per_step)
                    % converge_check_every == 0):
                profiling.count("host_syncs")
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

    totals = []
    if info_total is not None:
        profiling.count("host_syncs")
        totals = info_total.tolist()
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
            on_step=on_step,
            step_fn=None if step_fn is None else step_fn.uncompacted(),
            verbose=verbose, make_stats=make_stats,
            converge_se=converge_se,
            converge_check_every=converge_check_every, debug_nans=debug_nans,
        )
        return dataclasses.replace(redo, overflow=int(overflow),
                                   phases=profiling.PROCESS.since(tally))
    return RenderResult(
        stats=result_stats,
        samples_done=samples_done,
        trial_seconds=timings,
        rays_cast=int(rays),
        overflow=int(overflow),
        alive_counts=tuple(int(c) for c in totals[2:]),
        lane_schedule=tuple(lane_schedule) if lane_schedule else None,
        refill_plan=refill_plan,
        pool_waves=tuple(getattr(step, "waves", ())),
        phases=profiling.PROCESS.since(tally),
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
