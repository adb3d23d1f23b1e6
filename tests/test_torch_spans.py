"""The port's spans and counters (utils/profiling.py): the tally's
nesting, self time, counts and counters, on one thread and on two at
once; the spans a render records (RenderResult.phases) on the compacted
path, on a two-tile mesh and in ingest; the host-sync counter's sites;
the CLI's report; and the spans' ranges on torch.profiler's host
timeline, on the CPU here and, with the `gpu` marker, on the card, where
no range may appear as a device event.

Imports no jax, so the card test runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_spans.py -m gpu
"""

import threading
import time

import pytest
import torch

from raytracer_odin_tpu_torch import cli
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.io import gltf
from raytracer_odin_tpu_torch.models import assets, build
from raytracer_odin_tpu_torch.ops import culling
from raytracer_odin_tpu_torch.parallel import mesh as pmesh
from raytracer_odin_tpu_torch.render import accum, runtime
from raytracer_odin_tpu_torch.utils import profiling
from raytracer_odin_tpu_torch.utils.profiling import PhaseTimer, SpanStat


@pytest.fixture(autouse=True)
def fresh_tally():
    profiling.PROCESS.reset()
    yield
    profiling.PROCESS.reset()


@pytest.fixture(scope="module")
def cube_gltf(tmp_path_factory):
    return assets.generate("cube", tmp_path_factory.mktemp("spans"))["gltf"]


def _scene(path, device="cpu"):
    host = gltf.read_gltf(path)
    return host, build.finish_scene(host, device=device)


def _ticks(monkeypatch, *ns):
    it = iter(ns)
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(it))


def test_nesting_self_time_and_step_part(monkeypatch):
    t = PhaseTimer()
    # step [0, 100] holds a [10, 70], which holds b [20, 50]; c [200, 205]
    # runs after the step
    _ticks(monkeypatch, 0, 10, 20, 50, 70, 100, 200, 205)
    with t.span("step"):
        with t.span("a"):
            with t.span("b"):
                t.count("syncs")
            t.count("syncs", 2)
    with t.span("c") as c:
        t.count("syncs")
    assert t.spans == {"b": SpanStat(1, 30, 30), "a": SpanStat(1, 60, 30),
                       "step": SpanStat(1, 100, 40),
                       "c": SpanStat(1, 5, 5)}
    assert t.step_spans == {"b": SpanStat(1, 30, 30),
                            "a": SpanStat(1, 60, 30),
                            "step": SpanStat(1, 100, 40)}
    assert t.counters == {"syncs": 4} and t.step_counters == {"syncs": 3}
    assert c.seconds == pytest.approx(5e-9)
    assert t.spans["a"].total_s == pytest.approx(60e-9)


def test_calls_summed_by_name_and_exceptions_recorded(monkeypatch):
    t = PhaseTimer()
    _ticks(monkeypatch, 0, 3, 10, 14, 20, 21)
    for _ in range(2):
        with t.span("x"):
            pass
    with pytest.raises(ValueError):
        with t.span("x"):
            raise ValueError
    assert t.spans == {"x": SpanStat(3, 8, 8)} and t.step_spans == {}
    assert t._threads.stack == [] and t._threads.steps == 0


def test_two_threads_at_once():
    """Each thread nests its own spans; only the thread inside a step
    records a step part; the shared tally loses no call."""
    t = PhaseTimer()
    both_open = threading.Barrier(2)
    n = 200

    def worker(in_step):
        outer = t.span("step") if in_step else t.span("idle")
        with outer:
            with t.span("work"):
                both_open.wait()
                for _ in range(n):
                    with t.span("inner"):
                        t.count("ticks")

    threads = [threading.Thread(target=worker, args=(s,))
               for s in (True, False)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.spans["inner"].calls == 2 * n
    assert t.spans["work"].calls == 2
    assert t.step_spans["inner"].calls == n
    assert t.step_spans["work"].calls == 1
    assert set(t.step_spans) == {"step", "work", "inner"}
    assert t.counters == {"ticks": 2 * n} and t.step_counters == {"ticks": n}
    for name in ("step", "idle", "work"):
        s = t.spans[name]
        assert 0 <= s.self_ns <= s.total_ns
    # work's self time excludes the inner calls of its own thread only
    assert t.spans["work"].self_ns == (t.spans["work"].total_ns
                                       - t.spans["inner"].total_ns)


def test_snapshot_since_and_reset():
    t = PhaseTimer()
    with t.span("a"):
        t.count("k")
    before = t.snapshot()
    with t.span("step"):
        with t.span("a"):
            pass
        with t.span("b"):
            t.count("k", 3)
    d = t.since(before)
    assert {k: v.calls for k, v in d.spans.items()} == {"a": 1, "b": 1,
                                                       "step": 1}
    assert d.counters == {"k": 3} and d.step_counters == {"k": 3}
    assert t.spans["a"].calls == 2 and before.spans["a"].calls == 1
    t.reset()
    assert not (t.spans or t.step_spans or t.counters or t.step_counters)


def test_report_keeps_phases_and_adds_spans(monkeypatch):
    """Phases alone report as before (the JAX package's text); spans and
    counters add their own section."""
    t = PhaseTimer()
    monkeypatch.setattr(time, "perf_counter",
                        lambda it=iter([0.0, 0.5]): next(it))
    with t.phase("render"):
        pass
    phases_only = t.report(1_000_000)
    assert phases_only.splitlines() == [
        "--- phase timings ---",
        "      render:     500.0 ms (100.0%)",
        "       total:     500.0 ms",
        "  throughput:      2.00 Mrays/s"]
    assert PhaseTimer().report() == ("--- phase timings ---\n"
                                     "       total:       0.0 ms")
    _ticks(monkeypatch, 0, 1_000_000, 2_000_000, 5_000_000)
    with t.span("step"):
        t.count("host_syncs")
    with t.span("cast"):
        pass
    rep = t.report(1_000_000)
    assert rep.startswith(phases_only + "\n--- spans (host ms) ---\n")
    assert "        step:        1        1.0        1.0        1.0" in rep
    assert "        cast:        1        3.0        3.0        0.0" in rep
    assert "  host_syncs:        1 (1 in steps)" in rep


def test_render_phases_compacted(cube_gltf):
    """A compacted CPU render (pallas, compact="auto"): one step span a
    step; inside the steps a cast, a shade and a draw a bounce, a draw for
    the camera jitter, and a sort a bounce after the first; one
    calibration, uncompacted, whose casts, shades and draws fall outside
    the steps; the host syncs are the calibration's and the final read's."""
    host, scene = _scene(cube_gltf)
    depth, steps = 3, 3
    cfg = RenderConfig(width=32, height=16, ray_depth=depth, samples=steps,
                       samples_per_step=1, intersector="pallas",
                       compact="auto")
    res = runtime.render_scene(scene, cfg, host.cam.fov_x, device="cpu")
    assert res.lane_schedule is not None and res.overflow == 0
    ph = res.phases
    calls = {k: v.calls for k, v in ph.spans.items()}
    in_step = {k: v.calls for k, v in ph.step_spans.items()}
    assert in_step == {"step": steps, "cast": steps * depth,
                       "shade": steps * depth, "sort": steps * (depth - 1),
                       "merge": steps, "accumulate": steps,
                       "draw": steps * (depth + 1)}
    assert calls == dict(in_step, calibrate=1, cast=(steps + 1) * depth,
                         shade=(steps + 1) * depth,
                         draw=(steps + 1) * (depth + 1))
    assert ph.counters == {"host_syncs": 2} and ph.step_counters == {}
    step = ph.spans["step"]
    assert step.self_ns < step.total_ns
    inside = sum(ph.step_spans[k].total_ns
                 for k in ("cast", "shade", "sort", "merge", "accumulate"))
    assert inside <= step.total_ns
    assert ph.spans["calibrate"].total_ns >= (
        ph.spans["cast"].total_ns - ph.step_spans["cast"].total_ns)
    # the call's difference, not the process's: the load's spans are not in
    # it, and PROCESS holds both
    assert "scene_build" not in ph.spans
    assert profiling.PROCESS.spans["scene_build"].calls == 1
    assert profiling.PROCESS.spans["step"].calls == steps


def test_render_phases_uncompacted_and_debug_nans(cube_gltf):
    """Uncompacted: no sort or merge span, no calibration, a draw a bounce
    and one for the jitter each sample; --debug-nans counts one host sync
    a sample inside its step."""
    host, scene = _scene(cube_gltf)
    cfg = RenderConfig(width=16, height=16, ray_depth=2, samples=4,
                       samples_per_step=2, intersector="pallas",
                       compact="off")
    ph = runtime.render_scene(scene, cfg, host.cam.fov_x, device="cpu",
                              debug_nans=True).phases
    assert {k: v.calls for k, v in ph.step_spans.items()} == {
        "step": 2, "cast": 8, "shade": 8, "accumulate": 4, "draw": 12}
    assert ph.step_counters == {"host_syncs": 4}
    assert ph.counters == {"host_syncs": 5}


def test_two_tile_mesh_tiles(cube_gltf):
    """A two-tile CPU mesh: one tile span a tile a step, each tile's
    calibration once when the step is made, the replication once."""
    host, scene = _scene(cube_gltf)
    cfg = RenderConfig(width=16, height=16, ray_depth=2, samples=3,
                       samples_per_step=1, intersector="pallas",
                       compact="auto", num_devices=2)
    mesh = pmesh.make_mesh(n_tile=2, n_spp=1, devices=["cpu"] * 2)
    rs = pmesh.replicate_scene(scene, mesh)
    step_fn = pmesh.make_sharded_render_step(cfg, host.cam.fov_x, mesh, rs)
    assert profiling.PROCESS.spans["replicate"].calls == 1
    assert profiling.PROCESS.spans["calibrate"].calls == 2

    def make_stats():
        return pmesh.shard_stats(
            accum.init_stats(1, 16, 16, device="cpu"), mesh)

    res = runtime.render_scene(rs, cfg, host.cam.fov_x, device="cpu",
                               step_fn=step_fn, make_stats=make_stats)
    in_step = {k: v.calls for k, v in res.phases.step_spans.items()}
    assert in_step["step"] == 3 and in_step["tile"] == 2 * 3
    assert in_step["sort"] == 2 * 3 and in_step["cast"] == 2 * 3 * 2
    assert "calibrate" not in res.phases.spans
    tile = res.phases.step_spans["tile"]
    assert tile.total_ns <= res.phases.step_spans["step"].total_ns


def test_ingest_spans(cube_gltf, capsys):
    host = gltf.read_gltf(cube_gltf)
    build.finish_scene(host, device="cpu", verbose=True)
    spans = profiling.PROCESS.spans
    assert {k: spans[k].calls for k in ("gltf_read", "scene_build",
                                        "bvh_build")} == {
        "gltf_read": 1, "scene_build": 1, "bvh_build": 1}
    assert spans["bvh_build"].total_ns <= spans["scene_build"].total_ns
    assert "Scene BVH built in" in capsys.readouterr().out


@pytest.mark.parametrize("overflow_ids,syncs", [(True, 1), (False, 0)])
def test_build_lists_counts_its_sync(overflow_ids, syncs):
    """The streamed lists' width (int(counts.max())) is a host sync."""
    mask = torch.zeros((4, 8), dtype=torch.bool)
    mask[0, :6] = True
    counts, lists = culling.build_lists(mask, cap=2,
                                        overflow_ids=overflow_ids)
    assert lists.shape[1] == (6 if overflow_ids else 2)
    assert profiling.PROCESS.counters.get("host_syncs", 0) == syncs


@pytest.mark.parametrize("quiet", [False, True])
def test_cli_prints_the_span_report(cube_gltf, tmp_path, capsys, quiet):
    args = [str(cube_gltf), str(tmp_path / "o.png"), "--width", "16",
            "--height", "16", "--ray-depth", "2", "--num-samples", "2",
            "--intersector", "pallas"] + (["--quiet"] if quiet else [])
    assert cli.main(args, device="cpu") == 0
    out = capsys.readouterr().out
    assert ("--- spans (host ms) ---" in out) != quiet
    assert ("        step:" in out) != quiet
    assert ("  host_syncs:" in out) != quiet


def _host_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


def test_spans_are_host_ranges_on_the_profiler(cube_gltf):
    """Under torch.profiler each span is a CPU op rt::<name> (not a user
    annotation), nested as the spans nest, and tallied as always, but for
    the step part, which a profiled step does not open."""
    from torch.profiler import ProfilerActivity, profile

    host, scene = _scene(cube_gltf)
    cfg = RenderConfig(width=16, height=16, ray_depth=2, samples=1,
                       samples_per_step=1, intersector="pallas",
                       compact="off")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runtime.render_scene(scene, cfg, host.cam.fov_x, device="cpu")
    ev = [e for e in _host_events(prof) if e.name().startswith("rt::")]
    names = [e.name() for e in ev]
    assert names.count("rt::step") == 1 and names.count("rt::shade") == 2
    assert names.count("rt::cast") == 2
    assert not any(e.is_user_annotation() for e in ev)
    step = next(e for e in ev if e.name() == "rt::step")
    for e in ev:
        if e.name() in ("rt::cast", "rt::shade"):
            assert step.start_ns() <= e.start_ns() <= e.end_ns() \
                <= step.end_ns()
    assert profiling.PROCESS.spans["step"].calls == 1
    # a step under a profiler runs at the profiler's pace: no step part
    assert profiling.PROCESS.step_spans == {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (this machine has none)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_no_device_event_of_a_span(cuda, cube_gltf):
    """A traced compacted render on the card: the spans' ranges are host
    events only; the profiler mirrors none of them on the device's
    timeline, so no device event is named rt::*."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    host, scene = _scene(cube_gltf, device=cuda)
    cfg = RenderConfig(width=256, height=128, ray_depth=4, samples=2,
                       samples_per_step=1, intersector="pallas",
                       compact="auto")
    runtime.render_scene(scene, cfg, host.cam.fov_x, device=cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runtime.render_scene(scene, cfg, host.cam.fov_x, device=cuda)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    hosts = [e.name() for e in events if e.device_type() == DeviceType.CPU]
    assert dev, "the trace holds no device event"
    assert hosts.count("rt::step") == 2 and "rt::shade" in hosts
    assert [e.name() for e in dev if e.name().startswith("rt::")] == []
