"""The compacted sample's shading segments and their CUDA graphs
(ops/shade_graph.py): on the CPU the segments run eagerly and no graph
counter moves, the engagement rule reads the device alone, and the cache
key separates what the segment's Python reads; with the `gpu` marker, on
the card, graphed and eager renders are bit-equal on one card, on a 4 x 1
mesh of one card, on the env-map and on the textured scene, and on the
culled light path (K5 eager between each segment's two graphs) on the
night city at 1 and 4 tiles and on the demo pushed over the threshold,
where a wrapper on light_cull.light_sums_rows sees every K5 launch; the
column layout (integrator.COLS) on the demo and on the night city.

Imports no jax, so the card tests run on a machine without it:

    python -m pytest --noconftest tests/test_torch_shade_graph.py -m gpu
"""

import functools
from types import SimpleNamespace

import pytest
import torch

from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.io import gltf
from raytracer_odin_tpu_torch.models import assets, build
from raytracer_odin_tpu_torch.ops import integrator, light_cull, shade_graph
from raytracer_odin_tpu_torch.parallel import mesh as pmesh
from raytracer_odin_tpu_torch.render import accum, runtime
from raytracer_odin_tpu_torch.utils import profiling

COUNTERS = (shade_graph.REPLAYS, shade_graph.CAPTURES)


@pytest.fixture(autouse=True)
def fresh_graphs():
    shade_graph.GRAPHS.clear()
    yield
    shade_graph.GRAPHS.clear()


def _scene(path, device="cpu"):
    host = gltf.read_gltf(path)
    return host, build.finish_scene(host, device=device)


def _counts():
    return {k: profiling.PROCESS.counters.get(k, 0) for k in COUNTERS}


def test_compacted_sample_runs_eagerly_on_the_cpu(tmp_path):
    """A compacted CPU render: one shade span a bounce, no replay, no
    capture, no graph in the cache."""
    host, scene = _scene(assets.generate("cornell", tmp_path)["gltf"])
    depth, steps = 4, 2
    cfg = RenderConfig(width=32, height=16, ray_depth=depth, samples=steps,
                       samples_per_step=1, intersector="pallas",
                       compact="auto")
    before = _counts()
    res = runtime.render_scene(scene, cfg, host.cam.fov_x, device="cpu")
    assert res.lane_schedule is not None and res.overflow == 0
    assert res.phases.step_spans["shade"].calls == steps * depth
    assert _counts() == before
    assert not set(COUNTERS) & set(res.phases.counters)
    assert len(shade_graph.GRAPHS) == 0


def _fake_scene(n_lights=4, env_tex=-1):
    return SimpleNamespace(light_p=torch.zeros((n_lights, 3)),
                           env_tex=env_tex)


@pytest.mark.parametrize("device,lights,engaged", [
    ("cpu", 4, False),
    ("cpu", 0, False),
    ("cuda", 600, True),
])
def test_engages_reads_device_and_light_path(monkeypatch, device, lights,
                                             engaged):
    """The CPU never engages a graph; a card does, on the culled light
    path (from light_cull.threshold() lights on) too."""
    monkeypatch.delenv("RT_TPU_LIGHT_CULL_MIN", raising=False)
    assert shade_graph.engages(_fake_scene(lights),
                               torch.device(device)) is engaged


@pytest.mark.parametrize("cull_min,culled", [("4", True), ("5", False)])
def test_engages_follows_the_light_threshold(monkeypatch, cull_min, culled):
    """RT_TPU_LIGHT_CULL_MIN moves a four-light scene onto the culled path
    (light_cull.serves, which run serves by the segment's halves) or keeps
    it on the dense one; a card engages graphs on both."""
    monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", cull_min)
    assert light_cull.serves(_fake_scene(4)) is culled
    assert shade_graph.engages(_fake_scene(4), torch.device("cuda"))


def _key_inputs(width=1024):
    return (torch.zeros((width, 12)), torch.zeros(width),
            torch.zeros(width, dtype=torch.int32),
            torch.zeros(width, dtype=torch.bool), torch.zeros((width, 6)))


def _key(scene, segment=integrator.later_segment, width=1024, chunk=256,
         tile=0):
    return shade_graph.graph_key(segment, scene, _key_inputs(width), chunk,
                                 tile)


@pytest.mark.parametrize("change", [
    dict(segment=integrator.first_segment),
    dict(segment=integrator.later_segment_cols),
    dict(width=1536),
    dict(chunk=128),
    dict(tile=270 * 1920),
    dict(lights=0),
    dict(env_tex=0),
    dict(threshold="4"),
])
def test_graph_key_separates(monkeypatch, change):
    """Each fact the segment's Python reads gives another key for the same
    scene object: bounce 0 against a later bounce, the row layout's
    segment against the column layout's, the width, the light chunk, the
    tile, lights or none, the env map, and the light path (the
    threshold)."""
    monkeypatch.delenv("RT_TPU_LIGHT_CULL_MIN", raising=False)
    scene = _fake_scene()
    base = _key(scene)
    change = dict(change)
    if "threshold" in change:
        monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", change.pop("threshold"))
    if "lights" in change:
        scene.light_p = torch.zeros((change.pop("lights"), 3))
    if "env_tex" in change:
        scene.env_tex = change.pop("env_tex")
    assert _key(scene, **change) != base


def test_graph_key_same_inputs_and_scene_identity():
    """Equal facts give the equal key; another scene object another tile
    with the same segment key."""
    scene = _fake_scene()
    assert _key(scene) == _key(scene)
    assert _key(scene)[0] != _key(_fake_scene())[0]
    assert _key(scene)[1] == _key(_fake_scene())[1]


# ---- on the card ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (this machine has none)")
    return torch.device("cuda", 0)


def _render(scene, host, cfg, dev, tiles: int):
    """render_scene on one card, or over a tiles x 1 mesh of it; returns
    (result, gathered stats)."""
    fov = host.cam.fov_x * cfg.width / cfg.height
    if tiles == 1:
        res = runtime.render_scene(scene, cfg, fov, device=dev)
        return res, res.stats
    mesh = pmesh.make_mesh(n_tile=tiles, n_spp=1, devices=[dev] * tiles)
    rs = pmesh.replicate_scene(scene, mesh)
    step = pmesh.make_sharded_render_step(cfg, fov, mesh, rs)
    h_pad = pmesh.padded_height(cfg.height, tiles)
    res = runtime.render_scene(
        rs, cfg, fov, device=dev, step_fn=step,
        make_stats=lambda: pmesh.shard_stats(
            accum.init_stats(1, h_pad, cfg.width, device=dev), mesh))
    return res, res.stats.gather()


@pytest.mark.gpu
@pytest.mark.parametrize("name,tiles,cols", [
    pytest.param("demo", 1, 0, id="demo-1"),
    pytest.param("demo", 4, 0, id="demo-4"),
    pytest.param("envmap", 1, 0, id="envmap-1"),
    pytest.param("textured", 1, 0, id="textured-1"),
    pytest.param("demo", 1, 1, id="demo-1-cols"),
])
def test_graphed_render_bit_equal(cuda, tmp_path, monkeypatch, name, tiles,
                                  cols):
    """Two steps of 2 spp (each graph replays twice a step) graphed, then
    eagerly: bit-equal Stats, rays cast and live lanes a bounce; every
    shade span of the steps is a replay; on the 4 x 1 mesh each tile has
    its own graphs. cols: the column layout (integrator.COLS = 1), its
    segments graphed as the row layout's are."""
    monkeypatch.delenv("RT_TPU_LIGHT_CULL_MIN", raising=False)
    monkeypatch.setattr(integrator, "COLS", cols)
    host, scene = _scene(assets.generate(name, tmp_path)["gltf"], cuda)
    cfg = RenderConfig(width=320, height=184, ray_depth=8, samples=4,
                       samples_per_step=2, intersector="pallas",
                       compact="auto")
    graphed, g_stats = _render(scene, host, cfg, cuda, tiles)
    ph = graphed.phases
    assert graphed.overflow == 0 and graphed.lane_schedule is not None
    shades = ph.step_spans["shade"].calls
    assert shades == 2 * 2 * tiles * cfg.ray_depth
    assert ph.step_counters[shade_graph.REPLAYS] == shades
    captures = ph.counters[shade_graph.CAPTURES]
    assert captures == len(shade_graph.GRAPHS)
    assert len(shade_graph.GRAPHS._tiles) == tiles
    assert tiles * 2 <= captures <= tiles * cfg.ray_depth

    monkeypatch.setattr(shade_graph, "engages", lambda scene, device: False)
    eager, e_stats = _render(scene, host, cfg, cuda, tiles)
    assert shade_graph.REPLAYS not in eager.phases.counters
    assert eager.lane_schedule == graphed.lane_schedule
    assert eager.rays_cast == graphed.rays_cast
    assert eager.alive_counts == graphed.alive_counts
    for f in ("first", "last", "total", "total_sq", "count"):
        assert torch.equal(getattr(g_stats, f), getattr(e_stats, f)), f


def _k5_wrapped(monkeypatch):
    """A wrapper on light_cull.light_sums_rows, as the benchmark's K5 span
    installs it: the K5 launches each of its calls made (the program's
    light_launches counter)."""
    seen = []
    orig = light_cull.light_sums_rows

    def launches():
        return profiling.PROCESS.counters.get("light_launches", 0)

    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        before = launches()
        out = orig(*args, **kwargs)
        seen.append(launches() - before)
        return out

    monkeypatch.setattr(light_cull, "light_sums_rows", wrapper)
    return seen


def _night_or_demo(name, tmp_path, monkeypatch):
    if name == "citynight":
        monkeypatch.delenv("RT_TPU_LIGHT_CULL_MIN", raising=False)
    else:
        monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", "1")
    return assets.generate(name, tmp_path)["gltf"]


@pytest.mark.gpu
@pytest.mark.parametrize("name,tiles,cols", [
    pytest.param("citynight", 1, 0, id="citynight-1"),
    pytest.param("citynight", 4, 0, id="citynight-4"),
    pytest.param("demo", 1, 0, id="demo-1"),
    pytest.param("citynight", 1, 1, id="citynight-1-cols"),
])
def test_culled_light_path_graphed_bit_equal(cuda, tmp_path, monkeypatch,
                                             name, tiles, cols):
    """The night city (1,728 lights) at 1 and 4 tiles, and the demo pushed
    over the threshold (RT_TPU_LIGHT_CULL_MIN=1): each segment's head and
    tail graphed, K5 eager between them, then every segment eager:
    bit-equal Stats, rays cast and live lanes a bounce, one replay a shade
    span, two graphs a segment, and the same K5 launches. cols: the night
    city in the column layout (integrator.COLS = 1)."""
    monkeypatch.setattr(integrator, "COLS", cols)
    host, scene = _scene(_night_or_demo(name, tmp_path, monkeypatch), cuda)
    assert light_cull.serves(scene)
    cfg = RenderConfig(width=320, height=184, ray_depth=8, samples=4,
                       samples_per_step=2, intersector="pallas",
                       compact="auto")
    graphed, g_stats = _render(scene, host, cfg, cuda, tiles)
    ph = graphed.phases
    assert graphed.overflow == 0 and graphed.lane_schedule is not None
    shades = ph.step_spans["shade"].calls
    assert shades == 2 * 2 * tiles * cfg.ray_depth
    assert ph.step_counters[shade_graph.REPLAYS] == shades
    assert ph.step_spans["light"].calls == shades
    captures = ph.counters[shade_graph.CAPTURES]
    assert captures == len(shade_graph.GRAPHS)
    assert len(shade_graph.GRAPHS._tiles) == tiles
    assert captures % 2 == 0
    assert tiles * 2 * 2 <= captures <= tiles * 2 * cfg.ray_depth

    monkeypatch.setattr(shade_graph, "engages", lambda scene, device: False)
    eager, e_stats = _render(scene, host, cfg, cuda, tiles)
    assert shade_graph.REPLAYS not in eager.phases.counters
    assert eager.lane_schedule == graphed.lane_schedule
    assert eager.rays_cast == graphed.rays_cast
    assert eager.alive_counts == graphed.alive_counts
    assert (eager.phases.counters["light_launches"]
            == graphed.phases.counters["light_launches"])
    for f in ("first", "last", "total", "total_sq", "count"):
        assert torch.equal(getattr(g_stats, f), getattr(e_stats, f)), f


@pytest.mark.gpu
def test_k5_wrapper_sees_every_launch_of_a_graphed_render(cuda, tmp_path,
                                                           monkeypatch):
    """A wrapper monkeypatched onto light_cull.light_sums_rows (the
    benchmark's K5 span) is called for every K5 launch of a graphed night
    city render, one launch a call, one call a shade span: K5 stays out
    of the graphs."""
    host, scene = _scene(_night_or_demo("citynight", tmp_path, monkeypatch),
                         cuda)
    seen = _k5_wrapped(monkeypatch)
    cfg = RenderConfig(width=320, height=184, ray_depth=8, samples=4,
                       samples_per_step=2, intersector="pallas",
                       compact="auto")
    res, _ = _render(scene, host, cfg, cuda, 1)
    ph = res.phases
    assert ph.step_counters[shade_graph.REPLAYS] == ph.step_spans[
        "shade"].calls > 0
    assert ph.counters[shade_graph.CAPTURES] > 0
    assert seen and set(seen) == {1}
    assert len(seen) == ph.counters["light_launches"]
    assert len(seen) == ph.spans["light"].calls
