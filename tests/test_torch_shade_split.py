"""The shading segments split at the light pdf (ops/integrator.py's
segment halves, ops/shade_graph.py's culled light path): a segment's head,
then the culled light pdf (K5's plain version on the CPU), then its tail
give, bit for bit, the segment called whole and the vertex shade written
out in one piece; and shade_graph.run, with graphs standing in, serves a
scene on the culled light pdf as head, K5, tail, and a scene on the dense
sum as the whole segment, one replay a shade span. On the night city
(1,728 lights, over the default threshold) and on the demo pushed over
the threshold (RT_TPU_LIGHT_CULL_MIN=1); each segment in both lane
layouts: packed rows (first, later) and the column table (first_cols,
later_cols, shaded through ops/shading_cols.py, whose one-piece shade
takes shading_cols.mixture_pdf).
"""

import functools

import pytest
import torch

from raytracer_odin_tpu_torch.io import gltf
from raytracer_odin_tpu_torch.models import assets, build
from raytracer_odin_tpu_torch.ops import (
    integrator,
    light_cull,
    shade_graph,
    shading,
    shading_cols,
    texture,
    traverse,
)
from raytracer_odin_tpu_torch.render import runtime
from raytracer_odin_tpu_torch.utils import prng, profiling
from raytracer_odin_tpu_torch.utils import vec3c as v3c
from raytracer_odin_tpu_torch.utils.math3d import norm_l1, sq

W, H = 24, 16  # 384 camera lanes
SEED = 2_900_000_017


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    out = {}
    for name in ("citynight", "demo"):
        host = gltf.read_gltf(
            assets.generate(name, tmp_path_factory.mktemp(name))["gltf"])
        out[name] = (host, build.finish_scene(host, device="cpu"))
    return out


@pytest.fixture
def night_or_demo(request, scenes, monkeypatch):
    """The scene by name, on the culled light path: the demo's 4 lights
    are over the threshold at RT_TPU_LIGHT_CULL_MIN=1."""
    name = request.param
    if name == "demo":
        monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", "1")
    else:
        monkeypatch.delenv("RT_TPU_LIGHT_CULL_MIN", raising=False)
    host, scene = scenes[name]
    assert light_cull.serves(scene)
    return host, scene


def _k5_calls(monkeypatch, log):
    orig = light_cull.light_sums_rows

    @functools.wraps(orig)
    def counted(*a, **k):
        log.append("K5")
        return orig(*a, **k)

    monkeypatch.setattr(light_cull, "light_sums_rows", counted)


def _reference_shade(scene, o, d, t, tri_idx, alive, uniforms, throughput,
                     radiance):
    """One path vertex in one piece, the culled light pdf in the middle of
    the mixture pdf: (pos, new_d, throughput, radiance, cont)."""
    hit = (tri_idx >= 0) & alive
    missed = (~(tri_idx >= 0)) & alive
    if scene.env_tex >= 0:
        env = texture.sample_env(scene, d, scene.env_tex)
        radiance = radiance + torch.where(missed[..., None],
                                          throughput * env, 0.0)
    m = integrator._point_material(scene, o, d, t, tri_idx)
    normal = torch.where(m["inside"][..., None], -m["normal"], m["normal"])
    new_d = shading.sample_direction(scene, m["pos"], normal,
                                     m["roughness"], d, uniforms, True)
    p_cos = shading.cosine_weighted_pdf(normal, new_d)
    p_vndf = shading.vndf_pdf(normal, -d, sq(m["roughness"]), new_d)
    p_light = light_cull.light_pdf_sum_culled(scene, m["pos"], new_d)
    pdf = (p_cos + p_light + p_vndf) / 3.0
    value = shading.shade(m["color"], normal, m["metallic"], m["roughness"],
                          d, new_d)
    cont = norm_l1(value) / pdf > 1e-5
    radiance = radiance + torch.where(hit[..., None],
                                      throughput * m["emission"], 0.0)
    cont = cont & hit
    throughput = torch.where(cont[..., None],
                             throughput * (value / pdf[..., None]),
                             throughput)
    return m["pos"], new_d, throughput, radiance, cont


def _reference_shade_cols(scene, o, d, t, tri_idx, alive, uniforms,
                          throughput, radiance):
    """_reference_shade of column triples o, d, throughput, radiance
    [3, N] and six uniform columns, through ops/shading_cols.py, the
    light pdf inside shading_cols.mixture_pdf: (pos, new_d, throughput,
    radiance [3, N], cont [N])."""
    hit = (tri_idx >= 0) & alive
    missed = (~(tri_idx >= 0)) & alive
    if scene.env_tex >= 0:
        env = texture.sample_env_cols(scene, d, scene.env_tex)
        radiance = radiance + torch.where(missed, throughput * env, 0.0)
    m = integrator._point_material(scene, v3c.stack(o), v3c.stack(d), t,
                                   tri_idx)
    normal = v3c.splat(m["normal"])
    normal = torch.where(m["inside"], -normal, normal)
    pos = o + d * t
    new_d = shading_cols.sample_direction(scene, pos, normal,
                                          m["roughness"], d, uniforms, True)
    pdf = shading_cols.mixture_pdf(scene, pos, normal, m["roughness"], d,
                                   new_d, True)
    value = shading_cols.shade(v3c.splat(m["color"]), normal,
                               m["metallic"], m["roughness"], d, new_d)
    cont = (v3c.norm_l1(value) / pdf > 1e-5) & hit
    radiance = radiance + torch.where(hit, throughput
                                      * v3c.splat(m["emission"]), 0.0)
    throughput = torch.where(cont, throughput * (value / pdf), throughput)
    return pos, new_d, throughput, radiance, cont


def _first_inputs(host, scene):
    key = prng.key_from_seed(SEED)
    fov = host.cam.fov_x * W / H
    o, d = runtime.camera_rays(scene, key, 0, fov, W, H)
    t, tri_idx = traverse.cast_rays(scene, o, d, intersector="pallas",
                                    sort=False)
    sids = torch.arange(W * H, dtype=torch.int32).reshape(H, W)
    return (o, d, t, tri_idx, prng.uniforms(key, 0, 0, sids, 6))


def _later_inputs(host, scene, first=integrator.first_segment):
    """Bounce 1's inputs from bounce 0's eager segment `first`: its lane
    state and alive mask, the hits of its rays, the draws of its lanes."""
    state, alive = first(scene, *_first_inputs(host, scene), 256)
    rows = state if first is integrator.first_segment else state.T
    t, tri_idx = traverse.cast_rays(scene, rows[:, 0:3], rows[:, 3:6],
                                    intersector="pallas", sort=True,
                                    alive=alive)
    sids = torch.arange(rows.shape[0], dtype=torch.int32)
    uniforms = prng.uniforms(prng.key_from_seed(SEED), 0, 1, sids, 6)
    return (state, t, tri_idx, alive, uniforms)


def _later_inputs_cols(host, scene):
    return _later_inputs(host, scene, integrator.first_segment_cols)


def _padded_cols(inputs):
    """Bounce 0's inputs flattened into column form and padded to whole RB
    blocks (padding lanes dead: tri_idx -1), as first_head_cols takes
    them: (o, d, t, tri_idx, alive, uniform columns)."""
    o, d, t, tri_idx, uniforms = inputs
    n0 = t.numel()
    n0p = -(-n0 // integrator.pi.RB) * integrator.pi.RB
    pad = n0p - n0
    o, d = (torch.cat([x.reshape(n0, 3), torch.zeros(pad, 3)]).T
            for x in (o, d))
    t = torch.cat([t.reshape(n0), torch.zeros(pad)])
    tri_idx = torch.cat([tri_idx.reshape(n0),
                         torch.full((pad,), -1, dtype=tri_idx.dtype)])
    uniforms = torch.cat([uniforms.reshape(n0, 6), torch.zeros(pad, 6)])
    return (o, d, t, tri_idx, torch.arange(n0p) < n0, uniforms.unbind(-1))


def _reference(segment, scene, inputs):
    if segment == "first":
        o, d, t, tri_idx, uniforms = inputs
        shape = tuple(o.shape[:-1])
        pos, new_d, thr, rad, cont = _reference_shade(
            scene, o, d, t, tri_idx, torch.ones(shape, dtype=torch.bool),
            uniforms, torch.ones(shape + (3,)), torch.zeros(shape + (3,)))
        n0 = pos.shape[:-1].numel()
        n0p = -(-n0 // integrator.pi.RB) * integrator.pi.RB
        state = torch.zeros((n0p, 12))
        for i, x in enumerate((pos, new_d, thr, rad)):
            state[:n0, 3 * i:3 * i + 3] = x.reshape(n0, 3)
        alive = torch.zeros(n0p, dtype=torch.bool)
        alive[:n0] = cont.reshape(n0)
        return state, alive
    if segment == "later":
        state, t, tri_idx, alive, uniforms = inputs
        pos, new_d, thr, rad, cont = _reference_shade(
            scene, state[:, 0:3], state[:, 3:6], t, tri_idx, alive,
            uniforms, state[:, 6:9], state[:, 9:12])
        return torch.cat([pos, new_d, thr, rad], dim=1), cont
    if segment == "first_cols":
        o, d, t, tri_idx, alive, uniforms = _padded_cols(inputs)
        n = t.numel()
        out = _reference_shade_cols(scene, o, d, t, tri_idx, alive,
                                    uniforms, torch.ones(3, n),
                                    torch.zeros(3, n))
    else:
        state, t, tri_idx, alive, uniforms = inputs
        out = _reference_shade_cols(
            scene, state[0:3], state[3:6], t, tri_idx, alive,
            uniforms.unbind(-1), state[6:9], state[9:12])
    return torch.cat(out[:4]), out[4]


def _bits(x):
    """The tensor's bits: float NaNs compare by their pattern."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_bit_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(_bits(g), _bits(w))


# Each segment by its lane layout: rows (first, later), columns
# (first_cols, later_cols).
SEGMENTS = {"first": (integrator.first_segment, _first_inputs),
            "later": (integrator.later_segment, _later_inputs),
            "first_cols": (integrator.first_segment_cols, _first_inputs),
            "later_cols": (integrator.later_segment_cols,
                           _later_inputs_cols)}


@pytest.mark.parametrize("night_or_demo", ["citynight", "demo"],
                         indirect=True)
@pytest.mark.parametrize("which", list(SEGMENTS))
def test_split_segment_bit_equal(night_or_demo, which, monkeypatch):
    """head, light_pdf_sum_culled of its pos along new_d, tail: bit-equal
    to the segment called whole and to the shade in one piece, with one K5
    call between the halves; live lanes carry on."""
    host, scene = night_or_demo
    segment, make_inputs = SEGMENTS[which]
    inputs = make_inputs(host, scene)
    head, tail = segment.halves
    log = []
    _k5_calls(monkeypatch, log)
    h = head(scene, *inputs, 256)
    assert len(h) == 8
    assert log == []
    p_light = light_cull.light_pdf_sum_culled(scene, h[0], h[1])
    assert log == ["K5"]
    split = tail(scene, *h, p_light, 256)
    assert log == ["K5"]
    _assert_bit_equal(split, segment(scene, *inputs, 256))
    _assert_bit_equal(split, _reference(which, scene, inputs))
    assert 0 < int(split[1].sum()) < split[1].numel()


class _EagerGraphs:
    """Stands in for shade_graph.GRAPHS: each replay calls its segment
    eagerly and logs the segment's name."""

    def __init__(self, log):
        self.log = log

    def replay(self, segment, scene, tensors, light_chunk, tile, widths):
        self.log.append(segment.__name__)
        return segment(scene, *tensors, light_chunk)


def _run_as_on_the_card(monkeypatch, segment, scene, inputs):
    """shade_graph.run with graphs engaged and served eagerly: (outputs,
    the log of replays and K5 calls, replays tallied, shade spans)."""
    log = []
    _k5_calls(monkeypatch, log)
    monkeypatch.setattr(shade_graph, "engages", lambda scene, device: True)
    monkeypatch.setattr(shade_graph, "GRAPHS", _EagerGraphs(log))
    before = profiling.PROCESS.snapshot()
    out = shade_graph.run(segment, scene, inputs, 256, tile=0,
                          widths=(128,))
    added = profiling.PROCESS.since(before)
    return (out, log, added.counters.get(shade_graph.REPLAYS, 0),
            added.spans["shade"].calls)


@pytest.mark.parametrize("night_or_demo", ["citynight", "demo"],
                         indirect=True)
@pytest.mark.parametrize("which", list(SEGMENTS))
def test_run_serves_the_culled_path_by_halves(night_or_demo, which,
                                              monkeypatch):
    """On the culled light path run replays the head, calls K5 once
    through light_cull's module attribute, replays the tail, and tallies
    one replay for its one shade span; its outputs are the eager
    segment's."""
    host, scene = night_or_demo
    segment, make_inputs = SEGMENTS[which]
    inputs = make_inputs(host, scene)
    want = segment(scene, *inputs, 256)
    out, log, replays, shades = _run_as_on_the_card(monkeypatch, segment,
                                                    scene, inputs)
    head, tail = segment.halves
    assert log == [head.__name__, "K5", tail.__name__]
    assert replays == shades == 1
    _assert_bit_equal(out, want)


@pytest.mark.parametrize("which", list(SEGMENTS))
def test_run_serves_the_dense_path_whole(scenes, which, monkeypatch):
    """The demo's 4 lights under the default threshold: the dense sum
    inside one replay of the whole segment, no K5."""
    monkeypatch.delenv("RT_TPU_LIGHT_CULL_MIN", raising=False)
    host, scene = scenes["demo"]
    assert not light_cull.serves(scene)
    segment, make_inputs = SEGMENTS[which]
    inputs = make_inputs(host, scene)
    want = segment(scene, *inputs, 256)
    out, log, replays, shades = _run_as_on_the_card(monkeypatch, segment,
                                                    scene, inputs)
    assert log == [segment.__name__]
    assert replays == shades == 1
    _assert_bit_equal(out, want)
