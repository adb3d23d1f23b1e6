"""Multi-device rendering over a ("tile", "spp") grid of devices (port of
raytracer_odin_tpu/parallel/mesh.py).

* tile axis: image rows split into n_tile row blocks, one a device; the
  scene is copied to every device once.
* spp axis: the samples of a step split over n_spp devices; each renders
  its tile's rows with a disjoint range of sample indices.

The JAX package runs one program over a jax Mesh and merges the spp
partials with psum. Here the mesh is an explicit n_tile x n_spp grid of
torch.devices (a device may repeat: [cuda:0] * 2 rehearses a two-shard
mesh on one card, [cpu] * 8 is the CPU tests' counterpart of the JAX
tests' eight virtual devices), one host thread enqueues every shard's
work, and no collective library is used: each spp shard's partial sums
move to its tile's device and are added there in spp order. Each tile's
row block of the stats stays on its tile's device from step to step;
only the partial sums and the ray counts cross devices.

Per-pixel counter-based draws make every mesh render the same samples.
A tile-only mesh (n_spp = 1) is bit-identical to one device, across steps:
spp shard 0 folds its samples into the incoming stats in sample order,
which is the single device's chain. An spp mesh differs only by the order
of the sum across its shards.

A difference by design: the JAX sharded step runs its shards uncompacted
(its TraceOptions carry no lane_schedule). Here every tile calibrates its
own lane budgets over its own rows (runtime.auto_lane_schedule, shared by
the tile's spp shards) and runs the compacted trace, since sky rows and
floor rows die at different rates; an overflow in any shard makes
runtime.render_scene redo the render on the same mesh uncompacted
(ShardedStep.uncompacted).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.models.scene import (
    BVH_FIELDS,
    TENSOR_FIELDS,
    DeviceBVH,
)
from raytracer_odin_tpu_torch.ops.integrator import compaction_applies
from raytracer_odin_tpu_torch.render import accum, runtime
from raytracer_odin_tpu_torch.utils import profiling

STATS_FIELDS = ("first", "last", "total", "total_sq", "count")


def padded_height(height: int, n_tile: int) -> int:
    """Internal row count for tile sharding: the smallest multiple of
    n_tile covering the image. The extra rows are rendered and cropped at
    readout (accum.crop), so any resolution works."""
    return -(-height // n_tile) * n_tile


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An n_tile x n_spp grid of devices: devices[t][s] renders tile t's
    rows for spp shard s."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"tile": len(self.devices), "spp": len(self.devices[0])}

    @property
    def distinct(self) -> tuple:
        """The mesh's devices, each once, in mesh order."""
        out = []
        for row in self.devices:
            for dev in row:
                if dev not in out:
                    out.append(dev)
        return tuple(out)


def make_mesh(n_tile: Optional[int] = None, n_spp: int = 1,
              devices=None) -> Mesh:
    """Build a ("tile", "spp") mesh over `devices` (default: every CUDA
    device). n_tile defaults to len(devices) // n_spp; the first
    n_tile * n_spp devices are used, row-major."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_tile is None:
        n_tile = len(devices) // n_spp
    if n_tile < 1 or n_spp < 1 or n_tile * n_spp > len(devices):
        raise ValueError(f"a {n_tile} x {n_spp} mesh needs {n_tile * n_spp} "
                         f"devices; {len(devices)} given")
    return Mesh(tuple(tuple(devices[t * n_spp + s] for s in range(n_spp))
                      for t in range(n_tile)))


class ReplicatedScene(dict):
    """The scene copied to each distinct device of a mesh: device ->
    DeviceScene. `device` is the first device's, so runtime.render_scene
    checks it as it checks a scene."""

    @property
    def device(self) -> torch.device:
        return next(iter(self))


def replicate_scene(scene, mesh: Mesh) -> ReplicatedScene:
    """The scene on every distinct device of the mesh, copied once (the
    scene itself where it already lives there). Tallied as the
    "replicate" span."""
    out = ReplicatedScene()
    with profiling.span("replicate"):
        for dev in mesh.distinct:
            if scene.device == dev:
                out[dev] = scene
                continue
            out[dev] = dataclasses.replace(
                scene, **{f: getattr(scene, f).to(dev)
                          for f in TENSOR_FIELDS},
                bvh=DeviceBVH(**{f: getattr(scene.bvh, f).to(dev)
                                 for f in BVH_FIELDS}))
    return out


@dataclasses.dataclass
class ShardedStats:
    """The accumulator split into the mesh's tile row blocks: blocks[t] is
    an accum.Stats of rows [t * h, (t + 1) * h) on tile t's device
    (mesh.devices[t][0]). Each field reads as the whole [L, H_pad, W, ...]
    tensor gathered onto tile 0's device (for readout: on_step, the
    checkpoint, the PNG, accum.crop); writing to what it returns does not
    write the blocks."""

    blocks: list

    def _gather(self, field):
        dev = getattr(self.blocks[0], field).device
        return torch.cat([getattr(b, field).to(dev) for b in self.blocks],
                         dim=1)

    first = property(lambda self: self._gather("first"))
    last = property(lambda self: self._gather("last"))
    total = property(lambda self: self._gather("total"))
    total_sq = property(lambda self: self._gather("total_sq"))
    count = property(lambda self: self._gather("count"))

    def gather(self) -> accum.Stats:
        """The whole accumulator as one accum.Stats on tile 0's device."""
        return accum.Stats(**{f: self._gather(f) for f in STATS_FIELDS})


def shard_stats(stats: accum.Stats, mesh: Mesh) -> ShardedStats:
    """Split the accumulator into the mesh's tile row blocks, each on its
    tile's device; rows are zero-padded to padded_height first (a resumed
    render's stats have the image's height)."""
    n_tile = mesh.shape["tile"]
    stats = accum.pad_rows(stats, padded_height(stats.count.shape[1],
                                                n_tile))
    h = stats.count.shape[1] // n_tile
    return ShardedStats([
        accum.Stats(**{f: getattr(stats, f)[:, t * h:(t + 1) * h]
                       .to(mesh.devices[t][0]).contiguous()
                       for f in STATS_FIELDS})
        for t in range(n_tile)])


class ShardedStep:
    """The mesh's render step: (scene, stats, key, sample_start) ->
    (stats, info), runtime.make_render_step's contract over a mesh. `scene`
    is replicate_scene's, `stats` shard_stats'. info sums every shard's
    [rays cast, overflow, live lanes entering each bounce] on tile 0's
    device: the exact global counts (rows padded to padded_height count as
    rendered rows, as in the JAX package). Each tile's body is tallied as
    the "tile" span.

    lane_schedule: one tuple of lane budgets a tile (None: uncompacted)."""

    def __init__(self, cfg: RenderConfig, fov_x: float, mesh: Mesh,
                 lane_schedule: Optional[tuple]):
        self.cfg, self.fov_x, self.mesh = cfg, fov_x, mesh
        self.lane_schedule = lane_schedule
        n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
        self.h_pad = padded_height(cfg.height, n_tile)
        self.h_local = self.h_pad // n_tile
        self.s_local = cfg.samples_per_step // n_spp

    def uncompacted(self) -> "ShardedStep":
        """The same step with every shard uncompacted (the redo of a render
        whose budgets overflowed)."""
        return ShardedStep(self.cfg, self.fov_x, self.mesh, None)

    def _shard(self, scene, t: int, s: int, key, sample_start: int,
               seed: Optional[accum.Stats]):
        """Shard (t, s): its s_local samples of tile t's rows, folded in
        sample order into `seed` (the tile's stats block, in place) or from
        zero. Returns (total, total_sq, first sample, last sample, info),
        the last four None where a step does not need them."""
        cfg = self.cfg
        dev = self.mesh.devices[t][s]
        sched = None if self.lane_schedule is None else self.lane_schedule[t]
        opts = runtime._trace_options(cfg, sched)
        total = None if seed is None else seed.total
        total_sq = None if seed is None else seed.total_sq
        first = last = info = None
        for k in range(self.s_local):
            radiance, aux = runtime.sample_pass(
                scene[dev], key, sample_start + s * self.s_local + k,
                self.fov_x, cfg.width, cfg.height, opts,
                row_offset=t * self.h_local, n_rows=self.h_local)
            vals = runtime.sample_layer_values(radiance, aux,
                                               cfg.debug_features)
            if total is None:
                total, total_sq = vals.clone(), vals * vals
            else:
                total += vals
                total_sq += vals * vals
            if k == 0:
                first = vals
            last = vals
            v = torch.cat([aux["rays_cast"].reshape(1),
                           aux["overflow"].reshape(1), aux["alive_counts"]])
            info = v if info is None else info + v
        return total, total_sq, first, last, info

    def __call__(self, scene, stats: ShardedStats, key, sample_start: int):
        cfg = self.cfg
        n_tile, n_spp = self.mesh.shape["tile"], self.mesh.shape["spp"]
        info_dev = self.mesh.devices[0][0]
        info = None
        for t in range(n_tile):
            with profiling.span("tile"):
                block = stats.blocks[t]
                tdev = block.count.device
                is_first = (block.count == 0)[..., None]
                parts = [self._shard(scene, t, s, key, sample_start,
                                     block if s == 0 else None)
                         for s in range(n_spp)]
                # spp shard 0 folded into the block in place; add the
                # others there in spp order
                for total, total_sq, _, _, _ in parts[1:]:
                    block.total += total.to(tdev)
                    block.total_sq += total_sq.to(tdev)
                first = parts[0][2]
                block.first.copy_(torch.where(is_first, first, block.first))
                block.last.copy_(parts[-1][3].to(tdev))
                block.count += float(cfg.samples_per_step)
                for part in parts:
                    v = part[4].to(info_dev)
                    info = v if info is None else info + v
        return stats, info


def make_sharded_render_step(cfg: RenderConfig, fov_x: float, mesh: Mesh,
                             scene) -> ShardedStep:
    """The mesh's step, computing cfg.samples_per_step global samples per
    pixel a step into every cfg.num_layers layer (AOVs included with
    cfg.debug_features). `scene`: replicate_scene's. With compaction
    applying (runtime's rule: compact="auto", or a compact_schedule, on
    the exact-culled path), each tile's lane budgets are calibrated here
    over its own rows, cfg.compact_schedule overriding them.

    cfg.samples_per_step must be divisible by the spp axis size. Any image
    height works: the stats passed in and out are [L, padded_height(H,
    n_tile), W] (crop with accum.crop at readout)."""
    n_tile, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    if cfg.samples_per_step % n_spp:
        raise ValueError(
            f"samples_per_step {cfg.samples_per_step} not divisible by spp "
            f"axis {n_spp}")
    for dev in mesh.distinct:
        if dev not in scene:
            raise ValueError(f"the scene has no copy on {dev}: pass "
                             "replicate_scene's")
    schedule = None
    if compaction_applies(runtime._trace_options(cfg), mesh.devices[0][0]):
        h_local = padded_height(cfg.height, n_tile) // n_tile
        if cfg.compact_schedule is not None:
            schedule = (tuple(cfg.compact_schedule),) * n_tile
        elif cfg.compact == "auto":
            schedule = tuple(
                runtime.auto_lane_schedule(
                    scene[mesh.devices[t][0]], cfg, fov_x,
                    device=mesh.devices[t][0], row_offset=t * h_local,
                    n_rows=h_local)
                for t in range(n_tile))
    return ShardedStep(cfg, fov_x, mesh, schedule)
