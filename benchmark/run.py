"""The benchmark of raytracer_odin_tpu_torch: one run of one cell.

    python3 -m benchmark --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (benchmark/configs/
<config>.json: the scene and the render's settings) and a traffic mix
(benchmark/traffic/<traffic>.json: how the image is rendered);
benchmark/workloads/<cell>.json holds the cell's own settings (the
program's RT_TPU_* overrides, the traced steps, the size of the check and
its limits). The scene generator is benchmark/scenes/<generator>.py and
each per-layer metric's reader benchmark/metrics/<metric>.py, all found by
name.

A run: set-up (the scene written under TMPDIR from the configuration, the
program's glTF ingest and scene build, the kernels built on a checkout's
first run, a warm-up render of the cell's own shapes), then the window:
one continuous render_scene call of the program, a viewer's hook
synchronising every card after each frame and closing the window once
`--seconds` have passed. Then the check (benchmark/check.py) against the
plain reference (benchmark/reference/), and one JSON line on stdout.

With --trace 1 the profiler records a few steps inside the window, the
kernel entries run inside the benchmark's spans (benchmark/tracing.py),
and the line holds the per-layer metrics instead of the end-to-end ones.

--control N runs no program: on seeds n..n+N-1 it renders the sampled
rows with the reference in TF32 (the control) in the program's place, at
the spp a window accumulates, and prints its numbers; the limits were set
from these readings and from the program's. It needs one card.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names the run may not hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_odin_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path):
    """The module in the file `path` (a reader, a scene generator)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files under
    root/benchmark/."""
    spec = _json(root / "BENCHMARK.json")
    wl = {w["name"]: w for w in spec["workloads"]}.get(name)
    if wl is None:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    bench = root / "benchmark"

    def mine(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name, chips=int(wl["chips"]),
        config=_json(bench / "configs" / f"{wl['config']}.json"),
        traffic=_json(bench / "traffic" / f"{wl['traffic']}.json"),
        settings=_json(bench / "workloads" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)],
        bench_dir=bench)


def set_environment(cell: Cell, root: Path = ROOT) -> None:
    """Only the cell's RT_TPU_* overrides reach the program; caches of
    compilers the program may use stay inside the checkout."""
    for k in [k for k in os.environ if k.startswith("RT_TPU_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in
                       cell.settings.get("env", {}).items()})
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def host_state() -> dict:
    """The main thread's CPU time and context switches so far, to tell a
    host that ran slower through a window from one that stood still in
    it."""
    ru = resource.getrusage(resource.RUSAGE_THREAD)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "voluntary": ru.ru_nvcsw,
            "involuntary": ru.ru_nivcsw}


def step_summary(iv: list, before: dict, after: dict) -> str:
    """One stderr line on the window's frame times and its host."""
    if len(iv) < 2:
        return "frames: too few"
    ms = sorted(1e3 * v for v in iv)
    q1, med, q3 = statistics.quantiles(ms, n=4)
    far = [v for v in ms if v > 1.5 * med]
    host = {k: after[k] - before[k] for k in after if k in before}
    return (f"frames: {len(ms)}, ms min {ms[0]:.2f} q1 {q1:.2f} median "
            f"{med:.2f} q3 {q3:.2f} max {ms[-1]:.2f}; over 1.5x the median "
            f"{len(far)} ({sum(far) - med * len(far):.1f} ms beyond it); "
            f"main thread over the window {json.dumps(host)}")


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


class Window:
    """The viewer's hook and the window's clock. render_scene tests the
    interrupt first right after it starts its step loop's clock, so the
    first test marks the window's start; after every step the hook
    synchronises every card (the frame is shown), stamps it, and sets the
    interrupt once `seconds` have passed."""

    def __init__(self, flag_cls, seconds: float, sync, traced=None):
        self.flag = _ClockedFlag(flag_cls)()
        self.seconds = seconds
        self.sync = sync
        self.traced = traced
        self.enter, self.stamps, self.exit = [], [], []

    @property
    def start(self):
        return self.flag.first

    def on_step(self, stats, samples_done):
        self.enter.append(time.perf_counter())
        self.sync()
        now = time.perf_counter()
        self.stamps.append(now)
        if self.traced is not None:
            self.traced.step(len(self.stamps), now)
        if now - self.start >= self.seconds:
            self.flag.set()
        self.exit.append(time.perf_counter())

    def intervals(self) -> list:
        return [b - a for a, b in zip([self.start] + self.stamps, self.stamps)]

    def host_times(self, skip=()) -> list:
        """Host time of each step from the end of the previous hook to the
        start of its own: the step's enqueue."""
        prev = [self.start] + self.exit
        return [e - p for k, (p, e) in enumerate(zip(prev, self.enter), 1)
                if k not in skip]


def _ClockedFlag(flag_cls):
    class ClockedFlag(flag_cls):
        first = None

        def __bool__(self):
            if self.first is None:
                self.first = time.perf_counter()
            return super().__bool__()

    return ClockedFlag


class TracedSteps:
    """Starts the profiler after step `start` and stops it after `steps`
    more, the spans recording meanwhile."""

    def __init__(self, spans, start: int, steps: int):
        self.spans, self.start, self.steps = spans, start, steps
        self.prof = None
        self.t0 = self.t1 = None
        self.done = 0

    def step(self, k: int, now: float):
        import torch

        if k == self.start:
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self.spans.active = True
            self.t0 = time.perf_counter()
        elif self.prof is not None and self.t1 is None and \
                k == self.start + self.steps:
            self.finish(now, self.steps)

    def finish(self, now: float, steps: int):
        self.spans.active = False
        self.t1 = now
        self.done = steps
        self.prof.stop()

    def skipped(self) -> set:
        """Steps whose host time the profiler's start, stop or overhead
        touches."""
        return set(range(self.start, self.start + self.steps + 2))


@dataclass
class Context:
    """What the per-layer readers see."""
    result: object
    width: int
    height_pad: int
    steps: int
    samples_per_step: int
    ray_depth: int
    step_host_s: list
    trace: object
    work: dict
    peak_mem_bytes: int
    devices: list


def read_metrics(cell: Cell, metrics: list, ctx) -> dict:
    out = {}
    for m in metrics:
        reader = load_module(cell.bench_dir / "metrics" / f"{m['name']}.py")
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None):
    """One run of `cell`: the result line as a dict."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    from benchmark import check, tracing
    from benchmark.reference import scene as ref_scene_mod
    from benchmark.reference.tracer import Tracer
    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.io import gltf
    from raytracer_odin_tpu_torch.models import build
    from raytracer_odin_tpu_torch.parallel import mesh as pmesh
    from raytracer_odin_tpu_torch.render import accum, runtime

    conf, traffic, settings = cell.config, cell.traffic, cell.settings
    W, H, depth = conf["width"], conf["height"], conf["ray_depth"]
    n_tile, n_spp = conf["devices"], conf["spp_devices"]
    n_dev = n_tile * n_spp
    on_card = device == "cuda"
    dev0 = torch.device("cuda", 0) if on_card else torch.device(device)
    dev_ids = list(range(n_dev)) if on_card else []

    def sync():
        for i in dev_ids:
            torch.cuda.synchronize(i)

    spans = tracing.Spans().install() if trace else None
    traced = (TracedSteps(spans, settings["trace"]["start_step"],
                          settings["trace"]["steps"]) if trace else None)
    with tempfile.TemporaryDirectory(prefix="rt_bench_") as tmp:
        scene_spec = dict(conf["scene"])
        path = Path(tmp) / "scene.gltf"
        phases = {}

        def phase(name):
            phases[name] = time.perf_counter() - t_start

        load_module(cell.bench_dir / "scenes"
                    / f"{scene_spec.pop('generator')}.py").write(
            path, **scene_spec)
        phase("scene_written")
        host = gltf.read_gltf(path)
        phase("gltf_read")
        scene = build.finish_scene(host, device=dev0)
        phase("scene_built")
        got = (host.num_triangles, int(scene.light_p.shape[0]))
        if got != (conf["triangles"], conf["lights"]):
            raise RuntimeError(f"scene has {got} triangles and lights, the "
                               f"configuration states "
                               f"{(conf['triangles'], conf['lights'])}")
        fov_x = host.cam.fov_x * W / H
        cfg = RenderConfig(
            width=W, height=H, ray_depth=depth,
            samples=traffic["warmup_samples"], continuous=False,
            samples_per_step=traffic["samples_per_step"], seed=seed,
            intersector=conf["intersector"], compact=conf["compact"],
            num_devices=n_dev)
        step_fn = make_stats = None
        if n_dev > 1:
            devs = ([torch.device("cuda", i) for i in dev_ids] if on_card
                    else [dev0] * n_dev)
            mesh = pmesh.make_mesh(n_tile=n_tile, n_spp=n_spp, devices=devs)
            scene = pmesh.replicate_scene(scene, mesh)
            step_fn = pmesh.make_sharded_render_step(cfg, fov_x, mesh, scene)
            h_pad = pmesh.padded_height(H, n_tile)

            def make_stats():
                return pmesh.shard_stats(accum.init_stats(
                    cfg.num_layers, h_pad, W, device=mesh.devices[0][0]),
                    mesh)

            phase("mesh_ready")
        warm = runtime.render_scene(scene, cfg, fov_x, device=dev0,
                                    step_fn=step_fn, make_stats=make_stats)
        del warm
        sync()
        phase("warmed_up")
        log(f"set-up phases (s from the start): {json.dumps(phases)}")
        window = Window(runtime.InterruptFlag, seconds, sync, traced)
        host_before = host_state()
        res = runtime.render_scene(
            scene, cfg.replace(continuous=True), fov_x, device=dev0,
            interrupt=window.flag, on_step=window.on_step, step_fn=step_fn,
            make_stats=make_stats)
        t_end = time.perf_counter()
        log(step_summary(window.intervals(), host_before, host_state()))
        setup_s = window.start - t_start
        if traced is not None and traced.prof is not None and \
                traced.t1 is None:
            traced.finish(window.stamps[-1], len(window.stamps)
                          - traced.start)
        peak = max((torch.cuda.max_memory_allocated(i) for i in dev_ids),
                   default=0)

        # what the window produced, read for the check
        steps = len(window.stamps)
        stats = res.stats.gather() if hasattr(res.stats, "gather") \
            else res.stats
        count = stats.count[0]
        h_rows = count.shape[0]   # a mesh pads rows to its tiles
        chk = settings["check"]
        rows = check.sample_rows(seed, H, chk["rows"])
        prog = {
            "total": stats.total[0, rows].double().cpu(),
            "total_sq": stats.total_sq[0, rows].double().cpu(),
            "count": count[rows].double().cpu(),
            "count_off": int((count[:H] != res.samples_done).sum()),
            "segments_per_path": res.rays_cast / max(
                res.samples_done * W * h_rows, 1),
        }
        ctx = Context(
            result=res, width=W, height_pad=h_rows, steps=steps,
            samples_per_step=cfg.samples_per_step, ray_depth=depth,
            step_host_s=window.host_times(
                traced.skipped() if traced is not None else ()),
            trace=None, work={}, peak_mem_bytes=peak, devices=dev_ids)
        info = {"steps": steps, "samples": res.samples_done,
                "rays_cast": res.rays_cast, "overflow": res.overflow,
                "window_s": res.trial_seconds[0] if res.trial_seconds
                else 0.0, "setup_s": setup_s,
                "lane_schedule": res.lane_schedule}
        del stats, count, res, scene, step_fn, make_stats, host
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        if trace:
            spans.uninstall()
            if traced.prof is not None and traced.done > 0:
                ctx.trace = tracing.reduce(traced.prof, traced.done,
                                           traced.t1 - traced.t0,
                                           dev_ids or [0])
                ctx.work = spans.work()
                log(f"trace: {traced.done} steps, {len(ctx.trace.ops)} "
                    "device ops")

        t_ref = time.perf_counter()
        rscene = ref_scene_mod.read(path, dev0)
        tracer = Tracer(rscene)
        fov_ref = rscene.yfov * W / H
        ref = check.reference_rows(tracer, rows, W, H, fov_ref, depth,
                                   chk["spp"], seed, salt=1)
        seg = check.segments_rows(chk, seed, H)
        if seg is not None:
            ref["segments_per_path"] = check.reference_rows(
                tracer, seg[0], W, H, fov_ref, depth, seg[1], seed,
                salt=4)["segments_per_path"]
        log(f"reference: {len(rows)} rows at {chk['spp']} spp in "
            f"{time.perf_counter() - t_ref:.3f} s")
    values = check.numbers(prog, ref, chk["segment_px"])
    correct, checks = check.judge(values, chk["limits"])
    if info["overflow"] > 0 or steps == 0:
        correct = False
    log(f"window: {json.dumps(info)}; set-up ended at "
        f"{setup_s:.3f} s, window closed at {t_end - t_start:.3f} s")

    if trace:
        metrics = read_metrics(cell, cell.per_layer, ctx)
    else:
        iv = window.intervals()
        e2e = {
            "setup_s": setup_s,
            "mrays_per_s": info["rays_cast"] / info["window_s"] / 1e6
            if info["window_s"] > 0 else 0.0,
            "step_ms_p95": (statistics.quantiles(
                iv, n=100, method="inclusive")[94] * 1e3
                if len(iv) > 1 else sum(iv) * 1e3),
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": steps,
              "failed": 0 if correct else steps,
              "metrics": metrics, "device": dev}
    if trace and ctx.trace is not None:
        busy = [ctx.trace.busy_s.get(i, 0.0) for i in (dev_ids or [0])]
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = tracing.breakdown(ctx.trace)
    # a number that is not finite fails its check; JSON has no infinity
    result["checks"] = {k: {"value": v["value"] if math.isfinite(v["value"])
                            else None, "limit": v["limit"]}
                        for k, v in checks.items()}
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def control(cell: Cell, seed: int, n: int, device: str = "cuda") -> int:
    """The control's readings (the reference in TF32 in the program's place,
    at `control_spp`) on seeds seed..seed+n-1, at the cell's check size."""
    import torch

    from benchmark import check
    from benchmark.reference import scene as ref_scene_mod
    from benchmark.reference.tracer import Tracer

    conf, chk = cell.config, cell.settings["check"]
    W, H, depth = conf["width"], conf["height"], conf["ray_depth"]
    dev0 = torch.device("cuda", 0) if device == "cuda" else torch.device(
        device)
    with tempfile.TemporaryDirectory(prefix="rt_bench_") as tmp:
        spec = dict(conf["scene"])
        path = Path(tmp) / "scene.gltf"
        load_module(cell.bench_dir / "scenes"
                    / f"{spec.pop('generator')}.py").write(path, **spec)
        sc = ref_scene_mod.read(path, dev0)
    fov = sc.yfov * W / H
    for s in range(seed, seed + n):
        rows = check.sample_rows(s, H, chk["rows"])
        seg = check.segments_rows(chk, s, H)
        t = time.perf_counter()
        ref = check.reference_rows(Tracer(sc), rows, W, H, fov, depth,
                                   chk["spp"], s, salt=1)
        if seg is not None:
            ref["segments_per_path"] = check.reference_rows(
                Tracer(sc), seg[0], W, H, fov, depth, seg[1], s,
                salt=4)["segments_per_path"]
        t_ref = time.perf_counter() - t
        t = time.perf_counter()
        tf32 = Tracer(sc, precision="tf32")
        other = check.reference_rows(tf32, rows, W, H, fov, depth,
                                     chk["control_spp"], s, salt=2)
        if seg is not None:
            # the control's count, as the program's, over more of the image
            other["segments_per_path"] = check.reference_rows(
                tf32, seg[0], W, H, fov, depth, seg[1], s,
                salt=5)["segments_per_path"]
        other["count_off"] = 0
        values = check.numbers(other, ref, chk["segment_px"])
        print(json.dumps({"cell": cell.name, "seed": s, "kind": "control",
                          "spp": chk["control_spp"], "numbers": values,
                          "ref_s": t_ref, "s": time.perf_counter() - t}),
              flush=True)
    return 0


def main(argv=None, device: str = "cuda", root: Path = ROOT,
         t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(prog="python3 -m benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, default=0,
                   help="run the control on this many seeds instead")
    args = p.parse_args(argv)
    cell = load_cell(args.workload, root)
    set_environment(cell, root)
    import torch

    if device == "cuda":
        need = 1 if args.control else cell.chips
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < need:
            log(f"{args.workload} needs {need} CUDA device(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                " available")
            return 3
        log(f"card: {card_line()}")
    if args.control:
        return control(cell, args.seed, args.control, device)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device,
                 t_start)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {', '.join(bad)}: no result")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
