#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (raytracer_odin_tpu_torch).

Drives the port's main path on one NVIDIA GPU, one phase per line with its
wall time:

  1. card      name and power limit (nvidia-smi)
  2. build     the CUDA kernels (nvcc, ptxas -v report) and the host lib
  3. scene     the demo scene through the port's own assets, glTF reader
               and finish_scene(device="cuda")
  4. kernels   K1 (mask) and K2 (sweep) against their plain PyTorch
               versions, bit for bit, on the bounce-0 camera rays of the
               full frame and on the sorted, compacted bounce-1 batch of the
               calibration sample; CUDA-event times and bounds
  5. render    render_scene at 1920x1080, depth 8, 1 spp per step,
               intersector="pallas", compact="auto": calibration plus the
               timed steps; Mrays/s over live path segments, per-bounce
               alive counts, overflow (must be 0), peak memory, and the
               launch counts of K1 and K2 (8 per step and 8 in calibration)
  6. check     the render is finite and of the frame's shape, and the
               golden images of tests/golden/ reproduce on the card
  7. the kernels JSON line, then the {"ok": true, ...} line.

Any failure exits non-zero before the last line is printed. Run it from the
repository root:

    python3 chip_smoke.py                  # needs one CUDA card
    python3 chip_smoke.py --cpu-rehearsal  # tiny CPU run of the same
                                           # phases; never prints "ok"
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# Render and profile table: in the port's gitignored build directory.
OUT_DIR = ROOT / "raytracer_odin_tpu_torch" / "build" / "smoke"

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# fp32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# fp32 operations per ray-box slab test (K1): per axis 2 sub, 2 mul, 1 min,
# 1 max; near/far 2 max + 2 min; 2 compares.
K1_OPS_PER_TEST = 24
# fp32 operations per ray-triangle test (K2): d x v 9, det 5, 1/det 1,
# o - p 3, bu 6, q 9, bv 6, t 6, inside 5, t > 0 and t < best 2, select 2.
K2_OPS_PER_TEST = 54
# The demo frame of bench.py, and the timed steps after calibration.
WIDTH, HEIGHT, DEPTH = 1920, 1080, 8
STEPS = 5
GOLDEN = [("cube_16x16_d2_s4", "cube", 16, 16, 2, 4),
          ("cornell_32x32_d4_s4", "cornell", 32, 32, 4, 4)]


class Phases:
    def __init__(self):
        self.t0 = time.perf_counter()

    def done(self, name: str, start: float, detail: str = "") -> None:
        now = time.perf_counter()
        print(f"[{name}] {now - start:.3f} s (total {now - self.t0:.1f} s)"
              + (f": {detail}" if detail else ""), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev, reps: int) -> float:
    """Mean milliseconds per call: CUDA events around `reps` calls after one
    warm-up call on the card, the host clock on the CPU."""
    import torch

    fn()
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def measure_k1(pi, aabb8, rays, n_bits, dev, reps):
    """K1 on (aabb8, rays): bit equality with the plain version, times and
    bound."""
    import torch

    got = pi.cluster_masks_rows(aabb8, rays, n_bits)
    want = pi._cluster_masks_plain(aabb8, rays, n_bits)
    sync(dev)
    if not torch.equal(got, want):
        raise AssertionError(
            f"K1 differs from its plain version in "
            f"{int((got != want).sum())} words")
    n = rays.shape[1]
    s_pad = aabb8.shape[0]
    ms = time_ms(lambda: pi.cluster_masks_rows(aabb8, rays, n_bits), dev,
                 reps)
    plain_ms = time_ms(lambda: pi._cluster_masks_plain(aabb8, rays, n_bits),
                       dev, 1)
    nbytes = 6 * 4 * n + s_pad * 8 * 4 + got.shape[0] * 4 * n
    ops = K1_OPS_PER_TEST * n * s_pad + 3 * n
    b_ms, b_by = bound_ms(nbytes, ops)
    return {"rays": n, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "max_abs_err": float((got.long() - want.long()).abs().max())}


def measure_k2(pi, trav, scene, words, rays, n_super, dev, reps):
    """K2 on the exact lists of (words, rays): bit equality with the plain
    version, times and the bound from this batch's list lengths."""
    import torch

    counts, lists = trav.exact_lists(words, n_super)
    tris = scene.ptri
    got = pi.intersect_culled_rows(tris, counts, lists, rays)
    want = pi._culled_plain(counts, lists, rays, tris)
    sync(dev)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(
            f"K2 differs from its plain version in "
            f"{int((got != want).sum())} values")
    n = rays.shape[1]
    n_clusters = tris.shape[0] // pi.LEAF
    swept = int(torch.where(counts < 0, n_clusters, counts).sum())
    ms = time_ms(lambda: pi.intersect_culled_rows(tris, counts, lists, rays),
                 dev, reps)
    plain_ms = time_ms(lambda: pi._culled_plain(counts, lists, rays, tris),
                       dev, 1)
    nbytes = (6 * 4 * n + 8 * 4 * n + counts.numel() * 4 + lists.numel() * 4
              + tris.numel() * 4)
    tests = swept * pi.LEAF * pi.RB_SUB
    b_ms, b_by = bound_ms(nbytes, K2_OPS_PER_TEST * tests)
    hits = int((got[1] >= 0).sum())
    finite = got[0][got[1] >= 0]
    return {"rays": n, "hits": hits, "ray_triangle_tests": tests,
            "mean_list": swept / counts.numel(), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": float(max(
                (got[1] - want[1]).abs().max(),
                (finite - want[0][want[1] >= 0]).abs().max()
                if finite.numel() else 0.0))}


def kernel_batches(rt, integ, trav, prng, pi, scene, cfg, fov_x, dev):
    """The kernels' inputs in the calibration sample of `cfg`, built by the
    main path's own functions: the bounce-0 camera rays in tile order with
    their masks, and the sorted bounce-1 batch cut to the lane budget that
    auto_lane_schedule gives it, with its masks. Returns (rays0, words0,
    rays1, words1, aabb8, n_super, live lanes entering bounce 1)."""
    budget = rt.auto_lane_schedule(scene, cfg, fov_x, device=dev)[0]
    key = prng.key_from_seed(cfg.seed)
    o, d = rt.camera_rays(scene, key, 0, fov_x, cfg.width, cfg.height)
    _, n_super, aabb8 = trav.exact_cull_layout(scene)
    rays0, _ = trav.tiled_rows(o + d * trav.RAY_EPS, d)
    words0 = pi.cluster_masks_rows(aabb8, rays0, n_super)
    state, alive = integ.first_bounce(scene, o, d, key, 0)
    n_alive = int(alive.sum())
    _, _, rays1, words1 = integ.sort_lanes(state, alive, aabb8, n_super,
                                           budget)
    return rays0, words0, rays1, words1, aabb8, n_super, n_alive


def profile_step(rt, stats, scene, cfg, fov_x, schedule, dev):
    """Two more compacted render steps into `stats`, the second under
    torch.profiler: device time by kernel (top rows printed, the whole
    table written next to the render) and the device's busy share of the
    step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from raytracer_odin_tpu_torch.utils import prng

    step = rt.make_render_step(cfg, fov_x, lane_schedule=schedule,
                               device=dev)
    key = prng.key_from_seed(cfg.seed)
    step(scene, stats, key, 1000)  # warm-up outside the trace
    sync(dev)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        step(scene, stats, key, 1001)
        sync(dev)
        wall = time.perf_counter() - t
    ka = prof.key_averages()
    (OUT_DIR / "profile.txt").write_text(ka.table(
        sort_by="self_device_time_total" if dev.type == "cuda"
        else "self_cpu_time_total", row_limit=60))
    from torch.autograd import DeviceType

    kern = [e for e in ka
            if getattr(e, "device_type", None) == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kern)
    buckets = {}
    for e in kern:
        name = e.key.lower()
        b = ("K1 mask" if "mask_kernel" in name
             else "K2 sweep" if "culled_kernel" in name
             else "sort" if ("sort" in name or "radix" in name)
             else "gather/scatter" if ("index" in name or "gather" in name
                                       or "scatter" in name)
             else "reduce" if "reduce" in name
             else "copy" if ("copy" in name or "cat" in name)
             else "elementwise" if "elementwise" in name
             else "other")
        t, c = buckets.get(b, (0.0, 0))
        buckets[b] = (t + e.self_device_time_total, c + e.count)
    for b, (t, c) in sorted(buckets.items(), key=lambda kv: -kv[1][0]):
        print(f"  {b:15s} {t / 1e3:9.3f} ms  {c:6d} kernels  "
              f"{t / max(device_us, 1e-9):.3f} of device time", flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<5} "
              f"{e.key[:110]}", flush=True)
    busy = device_us / 1e6 / wall if wall > 0 else 0.0
    print(f"  traced step wall {wall * 1e3:.3f} ms; device time "
          f"{device_us / 1e3:.3f} ms ("
          + ("not measured on the CPU" if dev.type != "cuda"
             else f"device busy share {busy:.3f}") + ")", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase on the CPU at a tiny size; never "
                         "prints the ok line")
    ap.add_argument("--profile", action="store_true",
                    help="after the checks, trace one more render step with "
                         "torch.profiler and print where its device time "
                         "goes")
    args = ap.parse_args(argv)

    try:
        import torch

        import raytracer_odin_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port: {e}", file=sys.stderr)
        return 2
    if args.cpu_rehearsal:
        dev = torch.device("cpu")
        w, h, steps, reps = 64, 36, 2, 2
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda", 0)
        w, h, steps, reps = WIDTH, HEIGHT, STEPS, 20

    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.io import gltf, native
    from raytracer_odin_tpu_torch.models import assets, build
    from raytracer_odin_tpu_torch.ops import cuda_build
    from raytracer_odin_tpu_torch.ops import integrator as integ
    from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
    from raytracer_odin_tpu_torch.ops import traverse as trav
    from raytracer_odin_tpu_torch.render import output
    from raytracer_odin_tpu_torch.render import runtime as rt
    from raytracer_odin_tpu_torch.utils import prng

    ph = Phases()
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    # 1. card
    s = time.perf_counter()
    card = "cpu rehearsal" if args.cpu_rehearsal else card_line()
    print(card, flush=True)
    ph.done("card", s)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on after importing the port")

    # 2. build: nvcc and g++ start together
    s = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host_build = pool.submit(native.load)
        report = "skipped (no nvcc in a CPU rehearsal)"
        if not args.cpu_rehearsal:
            report = cuda_build.build()
            cuda_build.load()
        host_build.result()  # raises if g++ failed
    print(report.strip(), flush=True)
    ph.done("build", s)

    # 3. scene
    s = time.perf_counter()
    scene_dir = tempfile.mkdtemp(prefix="chip_smoke_scenes_")
    host = gltf.read_gltf(assets.generate("demo", scene_dir)["gltf"])
    scene = build.finish_scene(host, device=dev)
    fov_x = host.cam.fov_x * (WIDTH / HEIGHT)  # as bench.py sets it
    sync(dev)
    ph.done("scene", s, f"{scene.num_triangles} triangles, "
            f"{scene.cluster_lo.shape[0]} clusters, {scene.num_lights} lights")

    cfg = RenderConfig(width=w, height=h, ray_depth=DEPTH, samples=steps,
                       samples_per_step=1, seed=0,
                       intersector="pallas", compact="auto")

    # 4. kernel checks at the main path's shapes
    s = time.perf_counter()
    rays0, words0, rays1, words1, aabb8, n_super, n_alive1 = kernel_batches(
        rt, integ, trav, prng, pi, scene, cfg, fov_x, dev)
    k1_b0 = measure_k1(pi, aabb8, rays0, n_super, dev, reps)
    k1_b1 = measure_k1(pi, aabb8, rays1, n_super, dev, reps)
    k2_b0 = measure_k2(pi, trav, scene, words0, rays0, n_super, dev, reps)
    k2_b1 = measure_k2(pi, trav, scene, words1, rays1, n_super, dev, reps)
    for name, m in (("K1 bounce 0", k1_b0), ("K1 bounce 1", k1_b1),
                    ("K2 bounce 0", k2_b0), ("K2 bounce 1", k2_b1)):
        print(f"  {name}: {json.dumps(m)}", flush=True)
    if not args.cpu_rehearsal and rays1.shape[1] < 128 * 1024:
        raise AssertionError(f"bounce-1 batch has {rays1.shape[1]} rays")
    ph.done("kernels", s, f"bit-equal; bounce-1 batch {rays1.shape[1]} rays "
            f"({n_alive1} alive)")

    # 5. render: the main path, launches counted from zero
    s = time.perf_counter()
    wrappers = {"K1": pi.cluster_masks_rows, "K2": pi.intersect_culled_rows}
    for fn in wrappers.values():
        fn.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step_end = []
    # the launch counts after each step: calibration plus steps so far
    step_counts = []

    def on_step(_stats, _done):
        sync(dev)
        step_end.append(time.perf_counter())
        step_counts.append({k: fn.launches for k, fn in wrappers.items()})

    t_cal = time.perf_counter()
    res = rt.render_scene(scene, cfg, fov_x, device=dev, on_step=on_step)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    # launches of each step (differences between steps) and of calibration
    # (the count after step 1 less one step's launches)
    per_step = {k: sorted({b[k] - a[k]
                           for a, b in zip(step_counts, step_counts[1:])})
                for k in wrappers}
    calibration = {k: step_counts[0][k] - (per_step[k] or [0])[0]
                   for k in wrappers}
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    render_s = res.seconds
    trial_start = step_end[-1] - render_s
    step_s = [b - a for a, b in zip([trial_start] + step_end[:-1], step_end)]
    mrays = res.rays_cast / render_s / 1e6
    print(f"  schedule {res.lane_schedule}", flush=True)
    print(f"  alive_counts (summed over {steps} samples) "
          f"{list(res.alive_counts)}", flush=True)
    print(f"  overflow {res.overflow}; rays_cast {res.rays_cast}; "
          f"calibration {trial_start - t_cal:.4f} s; {steps} steps in "
          f"{render_s:.4f} s, each {[round(x, 4) for x in step_s]}",
          flush=True)
    print(f"  Mrays/s {mrays:.3f} over the {steps} steps "
          f"({card}); peak device memory {peak / 2**30:.3f} GiB", flush=True)
    print(f"  launches {launches}; per step {per_step}; in calibration "
          f"{calibration} (want {DEPTH} per step and {DEPTH} in "
          "calibration)", flush=True)
    if res.overflow != 0 or res.lane_schedule is None:
        raise AssertionError(f"compaction overflow {res.overflow}: the "
                             "render fell back to uncompacted")
    if len(step_counts) != steps:
        raise AssertionError(f"{len(step_counts)} steps ran, not {steps}")
    if not args.cpu_rehearsal:
        for k in wrappers:
            if per_step[k] != [DEPTH] or calibration[k] != DEPTH:
                raise AssertionError(
                    f"{k} launched {per_step[k]} times per step and "
                    f"{calibration[k]} in calibration")
    ph.done("render", s, f"{mrays:.3f} Mrays/s")

    # 6. what came out is right
    s = time.perf_counter()
    img = res.stats.total[0] / res.stats.count[0][..., None]
    if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("render is not a finite frame of the right "
                             "shape")
    output.save_png(res.stats, OUT_DIR / "demo.png")
    worst = []
    for gname, sname, gw, gh, gd, gs in GOLDEN:
        import numpy as np

        ghost = gltf.read_gltf(assets.generate(sname, scene_dir)["gltf"])
        gscene = build.finish_scene(ghost, device=dev)
        gcfg = RenderConfig(width=gw, height=gh, ray_depth=gd, samples=gs,
                            samples_per_step=gs, seed=0, intersector="pallas",
                            compact="auto")
        got = rt.render_scene(gscene, gcfg, ghost.cam.fov_x,
                              device=dev).stats.total[0].cpu().numpy()
        want = np.load(ROOT / "tests" / "golden" / f"{gname}.npy")
        err = np.abs(got - want)
        # The golden images come from the JAX package on the CPU. The
        # card's sin/cos/pow/atan2 round differently, so the gate is
        # 1e-3 relative per pixel, ten times the CPU test's.
        ok = np.allclose(got, want, rtol=1e-3, atol=1e-4)
        within = np.isclose(got, want, rtol=1e-4, atol=1e-5).mean()
        worst.append(f"{gname} max abs {err.max():.3g} "
                     f"(mean {err.mean():.3g}; {within:.4f} of values within "
                     "the CPU test's rtol 1e-4, atol 1e-5)")
        if not ok:
            raise AssertionError(f"golden {gname} differs: {worst[-1]}")
    ph.done("check", s, "finite demo frame; " + "; ".join(worst))

    if args.profile:
        s = time.perf_counter()
        profile_step(rt, res.stats, scene, cfg, fov_x,
                     res.lane_schedule, dev)
        ph.done("profile", s)

    kernels = []
    for name, replaces, b0, b1 in (
        ("K1 cluster_masks_rows",
         "raytracer_odin_tpu/ops/pallas_intersect.py:275", k1_b0, k1_b1),
        ("K2 intersect_culled_rows",
         "raytracer_odin_tpu/ops/pallas_intersect.py:162", k2_b0, k2_b1),
    ):
        key = name.split()[0]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "raytracer_odin_tpu_torch/csrc/intersect_kernels.cu",
            "replaces": replaces,
            "launches": launches[key],
            "launches_per_step": per_step[key][0],
            "launches_in_calibration": calibration[key],
            # main entries: the sorted, compacted bounce-1 batch (7 of a
            # step's 8 launches are sorted batches); bounce0: the camera rays
            "max_abs_err": b1["max_abs_err"], "ms": b1["ms"],
            "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
            "bound_by": b1["bound_by"], "library_ms": None,
            "rays": b1["rays"], "bounce0": b0,
            "plain_is_yardstick": False,
            "card": card,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    if args.cpu_rehearsal:
        print("chip_smoke: CPU rehearsal finished (no result)", flush=True)
        return 3
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
