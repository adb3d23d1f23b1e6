"""The shade kernel (ops/shade_kernel.py, csrc/shade_kernels.cu): the row
layout's shading segments and their halves launch it on a CUDA device and
run their PyTorch (the plain version) on the CPU. The plain version runs
on a card too with the kernel's engagement (`shade_kernel.engages`)
patched off, as `_plain` does here.

On the CPU: each segment is its halves around the light pdf, launches no
kernel, and raises for any other device; the kernel's scene arguments
(`shade_kernel.scene_layout`, the light table) match every generator
scene's row layout; and the `shade_kernel` counter counts one for each
shade span in which the kernel launched, shown by patching the engagement
(and the kernel's forms, which the CPU cannot launch) in the test.

With the `gpu` marker, on the card: the kernel against the plain segment
on the demo's bounce-0 and bounce-1 segments, on the accuracy scenes
(cfg3_textured, cfg4_envmap with its sky), on the night city's halves
around K5, and on a 288-light night city under the threshold, whose
dense light pdf sums chunks of 256, 200 and 64 lights (the vectorised and
the plain reduction order); then a 4-spp demo render through the kernel
and through the plain segments with one seed. Floats compare bit for bit
(a NaN equal to a NaN; +0 equal to -0) and alive exactly. Imports no
jax, so the card tests run on a machine without it:

    python -m pytest --noconftest tests/test_torch_shade_kernel.py -m gpu
"""

import importlib.util
import inspect
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.io import gltf, images
from raytracer_odin_tpu_torch.models import assets, build
from raytracer_odin_tpu_torch.models.scene import HostTexture
from raytracer_odin_tpu_torch.ops import (
    integrator,
    light_cull,
    shade_graph,
    shade_kernel,
    shading,
    traverse,
)
from raytracer_odin_tpu_torch.render import runtime
from raytracer_odin_tpu_torch.utils import prng, profiling

SEED = 3_000_000_019
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_graphs():
    shade_graph.GRAPHS.clear()
    yield
    shade_graph.GRAPHS.clear()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (this machine has none)")
    return torch.device("cuda", 0)


def _scene(name, tmp_path, device="cpu", **gen):
    """(host, DeviceScene) of generator scene `name`, with its env map."""
    if gen:
        path = tmp_path / f"{name}.gltf"
        assets.GENERATORS[name](path, **gen)
        info = {"gltf": str(path)}
    else:
        info = assets.generate(name, tmp_path)
    host = gltf.read_gltf(info["gltf"])
    env = None
    if "env" in info:
        li = images.load_image(info["env"])
        env = HostTexture(li.data, li.is_hdr)
    return host, build.finish_scene(host, env_map=env, device=device)


def _first_inputs(host, scene, w, h):
    """Bounce 0's segment inputs of a w x h frame."""
    key = prng.key_from_seed(SEED)
    fov = host.cam.fov_x * w / h
    o, d = runtime.camera_rays(scene, key, 0, fov, w, h)
    t, tri_idx = traverse.cast_rays(scene, o, d, intersector="pallas",
                                    sort=False)
    sids = torch.arange(w * h, dtype=torch.int32,
                        device=o.device).reshape(h, w)
    return (o, d, t, tri_idx, prng.uniforms(key, 0, 0, sids, 6))


def _plain():
    """Inside the block the row layout's segments run their PyTorch on any
    device: the kernel's engagement patched off."""
    return mock.patch.object(shade_kernel, "engages", lambda device: False)


def _later_inputs(host, scene, w, h, light_chunk=256):
    """Bounce 1's segment inputs, from bounce 0's plain segment: its lane
    state and alive mask, the hits of its rays, the draws of its lanes."""
    with _plain():
        state, alive = integrator.first_segment(
            scene, *_first_inputs(host, scene, w, h), light_chunk)
    t, tri_idx = traverse.cast_rays(scene, state[:, 0:3], state[:, 3:6],
                                    intersector="pallas", sort=True,
                                    alive=alive)
    sids = torch.arange(state.shape[0], dtype=torch.int32,
                        device=state.device)
    uniforms = prng.uniforms(prng.key_from_seed(SEED), 0, 1, sids, 6)
    return (state, t, tri_idx, alive, uniforms)


INPUTS = {"first": _first_inputs, "later": _later_inputs}
SEGMENTS = {"first": integrator.first_segment,
            "later": integrator.later_segment}


def _differ(got, want) -> int:
    """Elements where got and want differ: floats by value (a NaN equals a
    NaN), the rest exactly."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype.is_floating_point:
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    else:
        same = got == want
    return int((~same).sum())


def _assert_same(got, want, what=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.reshape(w.shape) if g.numel() == w.numel() else g
        n = _differ(g, w)
        assert n == 0, f"{what} output {i}: {n} of {w.numel()} differ"


# ---------------------------------------------------------------------------
# The CPU: the plain version, the layout, the counter.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_scenes(tmp_path_factory):
    out = {}
    for name in ("demo", "citynight"):
        out[name] = _scene(name, tmp_path_factory.mktemp(name))
    return out


@pytest.mark.parametrize("name", ["demo", "citynight"])
@pytest.mark.parametrize("which", ["first", "later"])
def test_cpu_segment_is_the_plain_version(cpu_scenes, name, which):
    """On the CPU a segment returns exactly its halves' outputs around the
    light pdf (dense or culled), and launches no kernel."""
    host, scene = cpu_scenes[name]
    inputs = INPUTS[which](host, scene, 24, 16)
    seg = SEGMENTS[which]
    head, tail = seg.halves
    before = shade_kernel.launch.launches
    got = seg(scene, *inputs, 256)
    h = head(scene, *inputs, 256)
    p_light = shading.light_pdf(scene, h[0], h[1], 256)
    _assert_same(got, tail(scene, *h, p_light, 256))
    assert shade_kernel.launch.launches == before


@pytest.mark.parametrize("fn", [integrator.first_segment,
                                integrator.later_segment,
                                integrator.first_head, integrator.first_tail,
                                integrator.later_head,
                                integrator.later_tail],
                         ids=lambda f: f.__name__)
def test_other_devices_raise(fn):
    """Tensors on a device that is neither the CPU nor a CUDA card raise:
    there is no fallback."""
    meta = torch.zeros((4, 12), device="meta")
    tensors = len(inspect.signature(fn).parameters) - 2
    with pytest.raises(ValueError, match="no shading for tensors on meta"):
        fn(SimpleNamespace(), *[meta] * tensors, 256)


GEN_SCENES = ("demo", "cornell", "city", "citynight", "textured", "envmap")


@pytest.mark.parametrize("name", GEN_SCENES)
def test_scene_layout_matches_the_row_layout(tmp_path, name):
    """The kernel's scene arguments are the scene's: each block of the
    shade row at its row_spec offset (absent: -1) and wide as the kernel
    reads it, the texture kinds, the env map, the light count and the
    dense sum's step; and the light table it reads holds the plain
    version's lights, row for row."""
    _host, scene = _scene(name, tmp_path)
    lay = shade_kernel.scene_layout(scene, 256)
    spec = dict(scene.row_spec)
    assert lay.row_width == scene.shade_row.shape[1]
    for (block, width), off in zip(shade_kernel.ROW_BLOCKS, lay.offsets):
        assert off == spec.get(block, -1), block
    # the blocks tile the row in row_spec order at the kernel's widths
    widths = dict(shade_kernel.ROW_BLOCKS)
    ends = [off + widths[b] for b, off in scene.row_spec]
    assert [off for _, off in scene.row_spec][1:] == ends[:-1]
    assert ends[-1] <= lay.row_width
    assert lay.kinds == tuple(int(k) for k in scene.tex_kinds)
    assert lay.env_tex == scene.env_tex
    assert (lay.env_tex >= 0) == (name == "envmap")
    n = scene.light_p.shape[0]
    assert lay.n_lights == n and (n > 0) == (name != "envmap")
    assert lay.pdf_lanes == shading.pdf_lanes(n, 256)
    rows = scene.light_rows[:n]
    for cols, field in ((slice(0, 3), scene.light_p),
                        (slice(3, 6), scene.light_u),
                        (slice(6, 9), scene.light_v),
                        (slice(9, 12), scene.light_ng)):
        assert torch.equal(rows[:, cols], field)
    assert torch.equal(rows[:, 12], scene.light_pdf_factor)
    assert bool((rows[:, 13] == 1).all())
    args = shade_kernel._scene_args(scene, 256, scene.shade_row.device)
    assert args.row_width == lay.row_width
    assert args.off_tri_v == spec["tri_v"] and args.n_lights == n


def test_scene_layout_refuses_a_row_it_cannot_read(tmp_path):
    _host, scene = _scene("cornell", tmp_path)
    broken = SimpleNamespace(**{**scene.__dict__, "row_spec": tuple(
        (b, off) for b, off in scene.row_spec if b != "tri_p")})
    with pytest.raises(ValueError, match="tri_p"):
        shade_kernel.scene_layout(broken, 256)
    with pytest.raises(ValueError, match="light_chunk"):
        shade_kernel.scene_layout(scene, 0)


class _EagerGraphs:
    """Stands in for shade_graph.GRAPHS on the CPU: a replay calls the
    segment."""

    def replay(self, segment, scene, tensors, light_chunk, tile, widths):
        return segment(scene, *tensors, light_chunk)


def _kernel_on_the_cpu(monkeypatch, log):
    """The shade kernel engaged on the CPU, its three forms standing in
    with the plain version (logged, each counted as one launch)."""
    monkeypatch.setattr(shade_kernel, "engages", lambda device: True)
    monkeypatch.setattr(shade_kernel.launch, "launches", 0)

    def stand_in(name, first_fn, later_fn, takes_rays):
        def form(scene, first, *args):
            log.append(name)
            shade_kernel.launch.launches += 1
            if takes_rays:
                x, d, t, tri_idx, alive, uniforms, light_chunk = args
                args = ((x, d, t, tri_idx, uniforms, light_chunk) if first
                        else (x, t, tri_idx, alive, uniforms, light_chunk))
            with _plain():
                return (first_fn if first else later_fn)(scene, *args)
        monkeypatch.setattr(shade_kernel, name, form)

    stand_in("fused", integrator.first_segment, integrator.later_segment,
             True)
    stand_in("head", integrator.first_head, integrator.later_head, True)
    stand_in("tail", integrator.first_tail, integrator.later_tail, False)


@pytest.mark.parametrize("engaged", [True, False])
@pytest.mark.parametrize("segment,inputs,served", [
    ("first_segment", _first_inputs, True),
    ("later_segment", _later_inputs, True),
    ("first_segment_cols", _first_inputs, False),
])
def test_counter_one_a_served_shade_span(cpu_scenes, monkeypatch, engaged,
                                         segment, inputs, served):
    """shade_graph.run counts `shade_kernel` once for a shade span in which
    the kernel launched: the row layout's segments where the kernel
    engages (one fused launch on the demo's dense light path), never the
    column layout's."""
    host, scene = cpu_scenes["demo"]
    args = inputs(host, scene, 24, 16)
    log = []
    if engaged:
        _kernel_on_the_cpu(monkeypatch, log)
    monkeypatch.setattr(shade_graph, "engages", lambda scene, device: True)
    monkeypatch.setattr(shade_graph, "GRAPHS", _EagerGraphs())
    before = profiling.PROCESS.snapshot()
    shade_graph.run(getattr(integrator, segment), scene, args, 256, tile=0)
    added = profiling.PROCESS.since(before)
    want = int(engaged and served)
    assert added.counters.get(shade_kernel.COUNTER, 0) == want
    assert added.spans["shade"].calls == 1
    assert log == (["fused"] if want else [])


def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("engaged", [True, False])
def test_counter_over_a_compacted_render(tmp_path, monkeypatch, engaged):
    """A compacted CPU render with the kernel's engagement patched in: the
    kernel's form launches in every shade span of its steps (the
    benchmark's shade_kernel_share reads 1.0); without the patch in none
    (0.0)."""
    host, scene = _scene("cornell", tmp_path)
    log = []
    if engaged:
        _kernel_on_the_cpu(monkeypatch, log)
    depth, steps = 4, 2
    cfg = RenderConfig(width=32, height=16, ray_depth=depth, samples=steps,
                       samples_per_step=1, intersector="pallas",
                       compact="auto")
    res = runtime.render_scene(scene, cfg, host.cam.fov_x, device="cpu")
    ph = res.phases
    shades = ph.step_spans["shade"].calls
    assert shades == steps * depth
    served = ph.step_counters.get(shade_kernel.COUNTER, 0)
    assert served == (shades if engaged else 0)
    share = _reader("shade_kernel_share").read(SimpleNamespace(result=res))
    assert share == (1.0 if engaged else 0.0)
    if engaged:
        assert len(log) == shade_kernel.launch.launches >= ph.counters[
            shade_kernel.COUNTER]


def test_share_reader_without_the_kernel(monkeypatch):
    """The reader reports nothing for a program without the shade kernel
    (no ops/shade_kernel.py) or without a step."""
    reader = _reader("shade_kernel_share")
    assert reader.read(SimpleNamespace(result=None)) is None
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name.endswith("shade_kernel") else real(
            name, *a))
    res = SimpleNamespace(phases=profiling.PhaseTimer())
    assert reader.read(SimpleNamespace(result=res)) is None


# ---------------------------------------------------------------------------
# The card: the kernel against the plain segment.
# ---------------------------------------------------------------------------

def _check_segment(scene, inputs, which, light_chunk=256):
    """The segment through the kernel and through its plain version, and
    the launches it made."""
    seg = SEGMENTS[which]
    before = shade_kernel.launch.launches
    got = seg(scene, *inputs, light_chunk)
    launches = shade_kernel.launch.launches - before
    with _plain():
        want = seg(scene, *inputs, light_chunk)
    _assert_same(got, want, which)
    assert bool(got[1].any()), "no lane carries on"
    return launches


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["first", "later"])
@pytest.mark.parametrize("name", ["demo", "textured", "envmap"])
def test_kernel_segment_bit_equal(cuda, tmp_path, name, which):
    """The demo (4 lights, a textured floor; the benchmark's main path) and
    the accuracy scenes cfg3_textured (every texture kind, normal maps)
    and cfg4_envmap (its sky on a miss), bounce 0 and bounce 1: one launch
    a segment, bit-equal to the plain segment."""
    host, scene = _scene(name, tmp_path, cuda)
    assert not light_cull.serves(scene)
    inputs = INPUTS[which](host, scene, 480, 272)
    assert _check_segment(scene, inputs, which) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["first", "later"])
def test_kernel_halves_around_k5_bit_equal(cuda, tmp_path, which):
    """The night city (1,728 lights, the culled light pdf): the head
    kernel's eight tensors equal the plain head's, K5 over either gives
    the same light pdf, and the tail kernel's state and alive equal the
    plain tail's; the whole segment is the two launches."""
    host, scene = _scene("citynight", tmp_path, cuda)
    assert light_cull.serves(scene)
    inputs = INPUTS[which](host, scene, 480, 272)
    head, tail = SEGMENTS[which].halves
    h = head(scene, *inputs, 256)
    with _plain():
        hp = head(scene, *inputs, 256)
    _assert_same(h, hp, "head")
    p_light = light_cull.light_pdf_sum_culled(scene, h[0], h[1])
    _assert_same((p_light,), (light_cull.light_pdf_sum_culled(
        scene, hp[0], hp[1]),), "light pdf")
    got = tail(scene, *h, p_light, 256)
    with _plain():
        want = tail(scene, *hp, p_light.reshape(hp[2].shape), 256)
    _assert_same(got, want, "tail")
    assert _check_segment(scene, inputs, which) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("light_chunk", [256, 200, 64])
@pytest.mark.parametrize("which", ["first", "later"])
def test_kernel_dense_sum_of_many_lights(cuda, tmp_path, which,
                                         light_chunk):
    """A night city of 288 lights, under the 512-light threshold: the
    dense light pdf in chunks of 256 (vectorised: 256, then 32 lights),
    200 (rows off 16-byte boundaries: 200, then 88) and 64 lights, each in
    PyTorch's reduction order: bit-equal."""
    host, scene = _scene("citynight", tmp_path, cuda, windows_per_tower=1)
    assert scene.light_p.shape[0] == 288 and not light_cull.serves(scene)
    inputs = INPUTS[which](host, scene, 320, 184)
    assert _check_segment(scene, inputs, which, light_chunk) == 1


@pytest.mark.gpu
def test_render_through_kernel_and_plain_segments(cuda, tmp_path):
    """A 4-spp demo render (two steps of 2 spp, graphed) through the
    kernel and through the plain segments (the engagement patched off, the
    graphs captured anew), one seed: the same rays cast, live lanes a
    bounce and Stats, bit for bit; the kernel ran in every shade span of
    the kernel's steps, and its launches count the graphs' replays, one a
    span, and not their captures."""
    host, scene = _scene("demo", tmp_path, cuda)
    cfg = RenderConfig(width=480, height=272, ray_depth=8, samples=4,
                       samples_per_step=2, intersector="pallas",
                       compact="auto", seed=SEED)
    fov = host.cam.fov_x * cfg.width / cfg.height
    before = shade_kernel.launch.launches
    kern = runtime.render_scene(scene, cfg, fov, device=cuda)
    ph = kern.phases
    assert (ph.step_counters[shade_kernel.COUNTER]
            == ph.step_spans["shade"].calls > 0)
    assert (shade_kernel.launch.launches - before
            == ph.counters[shade_kernel.COUNTER])
    shade_graph.GRAPHS.clear()
    with _plain():
        plain = runtime.render_scene(scene, cfg, fov, device=cuda)
    assert shade_kernel.COUNTER not in plain.phases.counters
    assert kern.overflow == plain.overflow == 0
    assert kern.rays_cast == plain.rays_cast
    assert kern.alive_counts == plain.alive_counts
    for f in ("first", "last", "total", "total_sq", "count"):
        a, b = getattr(kern.stats, f), getattr(plain.stats, f)
        assert _differ(a, b) == 0, f


@pytest.mark.gpu
def test_kernel_launches_on_any_card(cuda, tmp_path):
    """The demo's bounce-1 segment on every card, launched while cuda:0 is
    the current device (a mesh's tiles on cuda:1..): bit-equal to the
    plain segment on that card."""
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        host, scene = _scene("demo", tmp_path / str(i), dev)
        inputs = _later_inputs(host, scene, 320, 184)
        with torch.cuda.device(cuda):
            assert _check_segment(scene, inputs, "later") == 1
