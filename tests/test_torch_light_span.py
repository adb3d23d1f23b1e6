"""The culled light pdf's span and counter (ops/light_cull.py): the span
"light" is tallied once a call of K5 (light_sums_rows) on a many-light
render, the counter "light_launches" counts K5's launches, neither
appears on a scene of a few lights, and neither changes a value: the
culled sums are bit-equal inside and outside a step and equal to K5
called directly and divided by the light count.

Imports no jax, so the card case runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_light_span.py -m gpu
"""

import functools

import pytest
import torch

from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.io import gltf
from raytracer_odin_tpu_torch.models import assets, build
from raytracer_odin_tpu_torch.ops import light_cull
from raytracer_odin_tpu_torch.render import runtime
from raytracer_odin_tpu_torch.utils import profiling

# citynight at blocks=3 holds 108 light triangles: the threshold is lowered
# below that so that the culled pdf serves it.
CULL_MIN = "64"


@pytest.fixture(autouse=True)
def fresh_tally():
    profiling.PROCESS.reset()
    yield
    profiling.PROCESS.reset()


@pytest.fixture(scope="module")
def night_gltf(tmp_path_factory):
    path = tmp_path_factory.mktemp("night") / "night.gltf"
    assets.make_citynight_scene(path, blocks=3)
    return str(path)


def _scene(path, device="cpu"):
    host = gltf.read_gltf(path)
    return host, build.finish_scene(host, device=device)


def _k5_calls(monkeypatch):
    """Counts the calls of light_sums_rows (K5's entry) in a list; the
    wrapper carries the entry's launch count on."""
    calls = []
    orig = light_cull.light_sums_rows

    @functools.wraps(orig)
    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(light_cull, "light_sums_rows", counted)
    return calls


def _render(path, device, width=16, height=8, depth=3, samples=2):
    host, scene = _scene(path, device)
    cfg = RenderConfig(width=width, height=height, ray_depth=depth,
                       samples=samples, samples_per_step=1,
                       intersector="pallas", compact="auto")
    return runtime.render_scene(scene, cfg, host.cam.fov_x, device=device)


def test_span_once_a_k5_call(night_gltf, monkeypatch):
    monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", CULL_MIN)
    launches = light_cull.light_sums_rows.launches
    calls = _k5_calls(monkeypatch)
    ph = _render(night_gltf, "cpu").phases
    assert len(calls) > 0
    assert ph.spans["light"].calls == len(calls)
    # inside each bounce's shade, and inside the steps' part
    assert ph.spans["light"].total_ns <= ph.spans["shade"].total_ns
    assert 0 < ph.step_spans["light"].calls < len(calls)
    # the CPU runs K5's plain version: no launch, and the counter says so
    assert ph.counters.get("light_launches", 0) \
        == light_cull.light_sums_rows.launches - launches == 0


def test_neither_on_few_lights(tmp_path, monkeypatch):
    """The demo's 4 lights take the dense sum: no light span, no counter
    (the threshold lowered to 64 as above)."""
    monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", CULL_MIN)
    calls = _k5_calls(monkeypatch)
    ph = _render(assets.generate("demo", tmp_path)["gltf"], "cpu",
                 depth=2, samples=1).phases
    assert calls == []
    assert "shade" in ph.spans and "light" not in ph.spans
    assert "light_launches" not in profiling.PROCESS.counters


def _rays(scene, n, seed):
    """Rays from random points above the ground toward random points of
    the light triangles, and some in random directions."""
    g = torch.Generator().manual_seed(seed)
    lp, lu, lv = (x.cpu() for x in (scene.light_p, scene.light_u,
                                    scene.light_v))
    i = torch.randint(0, lp.shape[0], (n,), generator=g)
    a, b = torch.rand(2, n, 1, generator=g) * 0.5
    target = lp[i] + a * lu[i] + b * lv[i]
    o = (torch.rand(n, 3, generator=g) * torch.tensor([18.0, 9.0, 18.0])
         - torch.tensor([9.0, -0.05, 9.0]))
    d = target - o
    d[: n // 4] = torch.randn(n // 4, 3, generator=g)
    return o, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.gpu)])
def test_values_unchanged(night_gltf, device):
    """The culled sums inside an open step span, outside it, and through
    K5 called directly with the same lists and division: bit-equal."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (this machine has none)")
    _, scene = _scene(night_gltf, device)
    o, d = (x.to(device) for x in _rays(scene, 3000, 5))
    outside = light_cull.light_pdf_sum_culled(scene, o, d)
    with profiling.span(profiling.STEP):
        inside = light_cull.light_pdf_sum_culled(scene, o, d)
    counts, lists, rays, n = light_cull.light_lists(scene, o, d)
    direct = light_cull.light_sums_rows(scene.light_rows, counts, lists,
                                        rays)[:n] / scene.light_p.shape[0]
    assert int((outside > 0).sum()) > 1000
    assert torch.equal(outside, inside) and torch.equal(outside, direct)
    assert profiling.PROCESS.spans["light"].calls == 2
    assert profiling.PROCESS.step_spans["light"].calls == 1


@pytest.mark.gpu
def test_counter_counts_launches_on_the_card(night_gltf, monkeypatch):
    """On the card every K5 call launches: the counter, the wrapper's
    launch count and the span's calls agree, inside steps as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (this machine has none)")
    monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", CULL_MIN)
    launches = light_cull.light_sums_rows.launches
    ph = _render(night_gltf, torch.device("cuda", 0), width=256,
                 height=128, depth=4).phases
    n = light_cull.light_sums_rows.launches - launches
    assert n > 0
    assert ph.counters["light_launches"] == n == ph.spans["light"].calls
    assert ph.step_counters["light_launches"] \
        == ph.step_spans["light"].calls > 0
