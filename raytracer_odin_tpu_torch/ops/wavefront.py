"""Persistent wavefront pool with stream compaction (port of
raytracer_odin_tpu/ops/wavefront.py).

A fixed pool of P lanes works through the step's queue of (sample, pixel)
items. Each wave:

  refill:  dead lanes take the next queue items (rank by a cumsum of the
           dead mask) and emit their camera rays;
  cast:    traverse.cast_rays with sort=opts.sort_rays and the alive mask:
           on the card, "pallas" sorts the pool by (dead|octant, K1 masks)
           and sweeps it with K2 (cast_rays_pallas(sort=True, alive=...));
  shade:   integrator.eval_bounce, radiance/throughput update, the
           continuation rule and the depth limit;
  flush:   lanes whose path just ended add their radiance into the
           per-pixel stats.

The draws are the batched trace's counter chain (prng.uniforms addressed
by sample, bounce and pixel), so the pool renders the same sample set;
only the order of each pixel's sum differs (samples are added as their
paths end), and a ray that meets a triangle whose cluster box its own K1
mask rounds out, whose hit depends on the rays that share its list block
(ROADMAP.md queue C item 4).

Two differences from the JAX package. Its lax.while_loop becomes a host
loop whose condition (items left, or a lane alive) is read on the host, a
sync a wave, once ceil(items / P) waves have run (a wave pulls at most P
items, so no earlier wave can be the last). Its scatter-adds become gathers and scatters whose rows are unique, so every
run adds the same values in the same order, with no atomics: a wave adds
the ending paths of sample k in round k (one item per pixel and sample, so
no pixel repeats in a round), and "first" and "last" are assignments (one
path per pixel holds sample 0, one sample S-1). A lane with nothing to
write writes its own spare row past the image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytracer_odin_tpu_torch.ops import texture, traverse
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions, eval_bounce
from raytracer_odin_tpu_torch.render.runtime import generate_rays
from raytracer_odin_tpu_torch.utils import prng, profiling


class PoolStats(NamedTuple):
    """Flat [N, 3] accumulator fields the pool updates in place (views of
    the stats' beauty layer)."""

    first: torch.Tensor
    last: torch.Tensor
    total: torch.Tensor
    total_sq: torch.Tensor


class PoolRun(NamedTuple):
    """What one pool step did: live path segments cast (int64 scalar
    tensor), live lanes entering each bounce ([depth] int64 tensor) and
    the waves run."""

    rays: torch.Tensor
    alive_counts: torch.Tensor
    waves: int


def render_pool_step(scene, pstats: PoolStats, key, sample_start: int, *,
                     width: int, height: int, fov_x: float, samples: int,
                     pool_size: int, opts: TraceOptions) -> PoolRun:
    """Render `samples` spp of the full image through a pool of
    `pool_size` lanes into `pstats` (in place). sample_start is the global
    spp offset of the step's first sample."""
    n = width * height
    total_items = samples * n
    P = pool_size
    dev = scene.device
    has_lights = scene.light_p.shape[0] > 0
    depth = opts.depth

    # Work copies with a spare row a lane (n + lane) for the lanes that
    # write nothing: every scatter below has unique rows.
    spare = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    first, last, total, total_sq = (torch.cat([f, spare]) for f in pstats)

    next_item = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.zeros(P, dtype=torch.bool, device=dev)
    lane_bounce = torch.zeros(P, dtype=torch.int64, device=dev)
    lane_sample = torch.zeros(P, dtype=torch.int64, device=dev)
    lane_pixel = torch.zeros(P, dtype=torch.int64, device=dev)
    o = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    d = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    d[:, 0] = 1.0
    throughput = torch.ones((P, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((P, 3), dtype=torch.float32, device=dev)
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    alive_counts = torch.zeros(depth, dtype=torch.int64, device=dev)
    jitter_tag = torch.full((P,), prng.JITTER_TAG, dtype=torch.int32,
                            device=dev)
    spare_row = n + torch.arange(P, dtype=torch.int64, device=dev)

    min_waves = -(-total_items // P)
    waves = 0
    while True:
        # ---- refill: dead lanes pull queue items ----
        dead = ~alive
        dead_i = dead.to(torch.int64)
        item = next_item + torch.cumsum(dead_i, 0) - dead_i
        take = dead & (item < total_items)
        lane_sample = torch.where(take, item // n, lane_sample)
        lane_pixel = torch.where(take, item % n, lane_pixel)
        lane_bounce = torch.where(take, 0, lane_bounce)
        pix32 = lane_pixel.to(torch.int32)
        samp32 = (sample_start + lane_sample).to(torch.int32)
        jitter = prng.uniforms(key, samp32, jitter_tag, pix32, 2)
        cam_o, cam_d = generate_rays(scene.cam_pos, scene.cam_basis, fov_x,
                                     width, height, jitter, pixel=lane_pixel)
        t2 = take[:, None]
        o = torch.where(t2, cam_o, o)
        d = torch.where(t2, cam_d, d)
        throughput = torch.where(t2, 1.0, throughput)
        radiance = torch.where(t2, 0.0, radiance)
        alive = alive | take
        next_item = next_item + take.sum()

        # ---- cast + shade ----
        alive_i = alive.to(torch.int64)
        rays = rays + alive_i.sum()
        alive_counts.index_add_(0, torch.clamp(lane_bounce, max=depth - 1),
                                alive_i)
        t, tri_idx = traverse.cast_rays(
            scene, o, d, intersector=opts.intersector,
            brute_chunk=opts.brute_chunk,
            brute_max_tris=opts.brute_max_tris, sort=opts.sort_rays,
            alive=alive,
        )
        hit = (tri_idx >= 0) & alive
        missed = (~(tri_idx >= 0)) & alive
        if scene.env_tex >= 0:
            env = texture.sample_env(scene, d, scene.env_tex)
            radiance = radiance + torch.where(missed[:, None],
                                              throughput * env, 0.0)
        uniforms = prng.uniforms(key, samp32, lane_bounce.to(torch.int32),
                                 pix32, 6)
        ev = eval_bounce(scene, o, d, t, tri_idx, uniforms, has_lights,
                         opts.light_chunk)
        radiance = radiance + torch.where(
            hit[:, None], throughput * ev["material"]["emission"], 0.0)
        cont = ev["cont"] & hit & (lane_bounce < depth - 1)
        throughput = torch.where(
            cont[:, None], throughput * (ev["value"] / ev["pdf"][:, None]),
            throughput)
        o = torch.where(hit[:, None], ev["material"]["pos"], o)
        d = torch.where(cont[:, None], ev["new_d"], d)
        lane_bounce = lane_bounce + alive_i

        # ---- flush the paths that ended ----
        died = alive & ~cont
        alive = cont
        sq = radiance * radiance
        for k in range(samples):
            rows = torch.where(died & (lane_sample == k), lane_pixel,
                               spare_row)
            total[rows] = total[rows] + radiance
            total_sq[rows] = total_sq[rows] + sq
        is_first = died & (sample_start + lane_sample == 0)
        first[torch.where(is_first, lane_pixel, spare_row)] = radiance
        is_last = died & (lane_sample == samples - 1)
        last[torch.where(is_last, lane_pixel, spare_row)] = radiance

        waves += 1
        if waves >= min_waves:
            profiling.count("host_syncs")
            if not bool((next_item < total_items) | alive.any()):
                break

    for dst, src in zip(pstats, (first, last, total, total_sq)):
        dst.copy_(src[:n])
    return PoolRun(rays=rays, alive_counts=alive_counts, waves=waves)
