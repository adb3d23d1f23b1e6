"""Cross-sample lane refill: the sorted-ring wavefront scheduler (port of
raytracer_odin_tpu/ops/refill.py).

One wavefront of about constant width works through a whole step's
(pixel x sample) queue: each iteration appends fresh camera rays of the
next items, masks every lane with K1, sorts the lanes by (dead|octant,
mask words) so the dead ones form the tail, retires that tail, casts the
kept prefix through the presorted sweep (K2) and shades it with the
batched trace's physics (integrator.later_segment). The fresh and kept
widths of every iteration are planned on the host from the 1-spp alive
counts that calibrate compaction (plan_refill); live lanes cut by a plan
that undershoots are counted as overflow, and the caller then re-renders
uncompacted. Each item retires once, so one scatter by (pixel, sample)
restores image order.

The draws are the batched trace's counter chain (sample, bounce, pixel),
and every lane's arithmetic is the batched trace's, so a pixel's sample
has the same value on either schedule, but where a ray meets a triangle
whose cluster box its own K1 mask rounds out: its hit depends on the rays
that share its list block (ROADMAP.md queue C item 4). plan_refill is host
numpy, copied from the JAX package line for line.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raytracer_odin_tpu_torch.ops import traverse
from raytracer_odin_tpu_torch.ops.integrator import (
    TraceOptions,
    later_segment,
    sort_lanes,
)
from raytracer_odin_tpu_torch.render.runtime import generate_rays
from raytracer_odin_tpu_torch.utils import prng, profiling


class RefillPlan(NamedTuple):
    """Static per-iteration schedule (host-planned; see plan_refill).

    fresh[k]: lanes appended before iteration k's sort (multiple of RB).
    keep[k]:  width after iteration k's sort slice (multiple of RB); the
              tail [keep[k], N_k + fresh[k]) must be dead lanes (checked
              on the device through the overflow counter).
    """

    fresh: tuple
    keep: tuple


def plan_refill(counts, n_pixels: int, n_samples: int, depth: int,
                rb: int, margin: float, width: Optional[int] = None
                ) -> RefillPlan:
    """Plan static refill/keep widths from measured per-bounce alive counts.

    counts: alive lanes entering bounce b (length >= depth) for one full
    sample, the probe auto_lane_schedule uses. The plan evolves the
    expected wavefront composition with the measured conditional survival
    rates (a fluid model): each iteration refills the predicted free lanes
    (keeping `margin` + 2*rb of headroom so live lanes are almost never
    cut) and keeps alive_pred * margin + 2*rb lanes after the sort. The
    drain runs `depth` iterations past the last refill, by when every lane
    has had its full bounce budget and is dead.

    width: steady-state wavefront width (default: n_pixels padded to rb).
    """
    c = [max(float(x), 0.0) for x in counts[:depth]]
    surv = [
        (c[b + 1] / c[b]) if b + 1 < depth and c[b] > 0 else 0.0
        for b in range(depth)
    ]
    n0 = n_pixels
    w = width if width is not None else -(-n0 // rb) * rb
    w = -(-w // rb) * rb
    total = n_samples * n0

    def up(x):
        return -(-int(x) // rb) * rb

    a = [0.0] * depth  # expected alive entering the iteration, by bounce
    cursor = 0
    since_refill = 0
    n = 0  # current physical width
    fresh_plan = []
    keep_plan = []
    for _ in range(2 * n_samples * (depth + 4) + 2 * depth + 8):  # bound
        alive_pred = sum(a)
        remaining = total - cursor
        # Safe width for the carried lanes alone (margin + 2 blocks slack,
        # like auto_lane_schedule); fresh lanes are a deterministic count
        # and need no margin of their own.
        base = max(rb, up(alive_pred * margin + 2 * rb))
        if remaining > 0:
            r = min(up(remaining), max(0, (w - base) // rb * rb))
            if r == 0:
                r = rb  # guaranteed progress; width exceeds w temporarily
        else:
            r = 0
        valid = min(r, remaining)
        # A lane refilled at iteration j has its last possible cast (bounce
        # depth-1) at iteration j + depth - 1; one iteration later it is
        # dead.
        if r == 0 and since_refill >= depth - 1:
            break
        m = n + r
        if m == 0:
            break
        keep = min(m, base + r)
        fresh_plan.append(r)
        keep_plan.append(keep)
        cursor += r
        since_refill = 0 if valid > 0 else since_refill + 1
        n = keep
        a = [float(valid)] + [a[b] * surv[b] for b in range(depth - 1)]
    return RefillPlan(fresh=tuple(fresh_plan), keep=tuple(keep_plan))


def refill_applies(opts: TraceOptions, device) -> bool:
    """Refill needs the exact-culled sorted cast and no per-lane
    instrumentation, as dead-lane compaction does (but depth 1 is enough):
    "pallas", or "auto" on the card (the JAX package's refill_applies)."""
    if (opts.depth < 1 or opts.want_aux or opts.log_paths
            or opts.check_nans or not opts.sort_rays):
        return False
    if opts.intersector == "pallas":
        return True
    return (opts.intersector == "auto"
            and torch.device(device).type != "cpu")


class RefillRun(NamedTuple):
    """What trace_refill rendered: radiance [H*W, S, 3] (samples ascending
    per pixel), live path segments cast and overflow lanes (int64 scalar
    tensors), and live lanes entering each bounce ([depth] int64)."""

    radiance: torch.Tensor
    rays: torch.Tensor
    overflow: torch.Tensor
    alive_counts: torch.Tensor


def trace_refill(scene, key, sample_start: int, opts: TraceOptions,
                 plan: RefillPlan, width: int, height: int, fov_x: float,
                 n_samples: int) -> RefillRun:
    """Render `n_samples` full-image samples through one refilled
    wavefront (see the module docstring)."""
    dev = scene.device
    n0 = width * height
    total = n_samples * n0
    depth = opts.depth
    _g, n_super, aabb8 = traverse.exact_cull_layout(scene)

    # The wavefront: state [N, 12] (o, d, throughput, radiance), item ids
    # (sample * n0 + pixel; ids >= total were never issued) and bounces.
    state = torch.zeros((0, 12), dtype=torch.float32, device=dev)
    gid = torch.zeros(0, dtype=torch.int64, device=dev)
    bnc = torch.zeros(0, dtype=torch.int64, device=dev)
    alive = torch.zeros(0, dtype=torch.bool, device=dev)
    cursor = 0
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    alive_counts = torch.zeros(depth, dtype=torch.int64, device=dev)
    retired_gid = []
    retired_rad = []

    for r_k, keep in zip(plan.fresh, plan.keep):
        # ---- append fresh camera rays (the queue pull) ----
        if r_k:
            gid_f = cursor + torch.arange(r_k, dtype=torch.int64, device=dev)
            gid_c = torch.clamp(gid_f, max=total - 1)
            pixel_f = gid_c % n0
            jitter = prng.uniforms(
                key, (sample_start + gid_c // n0).to(torch.int32),
                prng.JITTER_TAG, pixel_f.to(torch.int32), 2)
            of, df = generate_rays(scene.cam_pos, scene.cam_basis, fov_x,
                                   width, height, jitter, pixel=pixel_f)
            fresh = torch.zeros((r_k, 12), dtype=torch.float32, device=dev)
            fresh[:, 0:3] = of
            fresh[:, 3:6] = df
            fresh[:, 6:9] = 1.0
            state = torch.cat([state, fresh])
            gid = torch.cat([gid, gid_f])
            bnc = torch.cat([bnc, torch.zeros(r_k, dtype=torch.int64,
                                              device=dev)])
            alive = torch.cat([alive, gid_f < total])
            cursor += r_k

        # ---- K1 masks + coherence sort (dead lanes last), slice ----
        alive_i = alive.to(torch.int64)
        n_alive = alive_i.sum()
        alive_counts.index_add_(0, torch.clamp(bnc, max=depth - 1), alive_i)
        state, perm, rays_sorted, s_words = sort_lanes(
            state, alive, aabb8, n_super, keep)
        gid = gid[perm]
        bnc = bnc[perm]
        overflow = overflow + torch.clamp(n_alive - keep, min=0)

        # ---- retire the (dead) tail ----
        retired_gid.append(gid[keep:])
        retired_rad.append(state[keep:, 9:12])
        state = state[:keep].contiguous()
        gid = gid[:keep]
        bnc = bnc[:keep]
        alive = torch.arange(keep, device=dev) < n_alive
        rays = rays + torch.clamp(n_alive, max=keep)

        # ---- cast + shade (the batched trace's physics) ----
        t, tri_idx = traverse.cast_presorted_rows(scene, rays_sorted,
                                                  words=s_words)
        uniforms = prng.uniforms(
            key, (sample_start + gid // n0).to(torch.int32),
            bnc.to(torch.int32), (gid % n0).to(torch.int32), 6)
        with profiling.span("shade"):
            state, cont = later_segment(scene, state, t, tri_idx, alive,
                                        uniforms, opts.light_chunk)
        alive = cont & (bnc < depth - 1)
        bnc = bnc + 1

    # ---- final retire-all (the plan's drain leaves every lane dead) ----
    overflow = overflow + alive.sum()
    retired_gid.append(gid)
    retired_rad.append(state[:, 9:12])
    all_gid = torch.cat(retired_gid)
    # (pixel, sample) order; ids never issued go to a spare row past it
    slot = torch.where(all_gid < total,
                       (all_gid % n0) * n_samples + all_gid // n0, total)
    merged = torch.zeros((total + 1, 3), dtype=torch.float32, device=dev)
    merged[slot] = torch.cat(retired_rad, dim=0)
    return RefillRun(radiance=merged[:total].reshape(n0, n_samples, 3),
                     rays=rays, overflow=overflow, alive_counts=alive_counts)
