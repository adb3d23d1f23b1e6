"""The PyTorch port's whole slice on the CPU: golden images, the demo scene
against the JAX package, and dead-lane compaction against the full-width
wavefront (mirrors tests/test_golden.py and
tests/test_integrator.py:229,248,289).

Tolerances. Cube and cornell reproduce their golden images at the golden
test's own rtol=1e-4, atol=1e-5. The glossy scenes (textured, envmap,
demo) do not: camera rays already differ from XLA's by an ulp (its f32
matmul fuses multiply-adds), sin/cos/atan2/pow round differently, and the
GGX lobe at roughness 0.05-0.2 amplifies such differences bounce after
bounce (ROADMAP hazard 3; ARCHITECTURE.md "TPU numerics" measures the
same effect between CPU and TPU). For them every live-lane count and ray
count must still be equal, the image mean must agree to MEAN_RTOL, at
least PASS_FRACTION of the values must meet the golden tolerance, and
none may differ by more than MAX_ABS (measured on the CPU: at most 2.8% of
values outside, 0.032 the largest difference, on images of mean radiance
~1.5)."""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.ops.integrator import TraceOptions as JTraceOptions
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.io import gltf, images
from raytracer_odin_tpu_torch.models import assets, build
from raytracer_odin_tpu_torch.models.scene import HostTexture
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.render import output, runtime
from raytracer_odin_tpu_torch.utils import prng
from tests.torch_parity import torch_scene

GOLDEN_DIR = Path(__file__).parent / "golden"
GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 1e-5
MEAN_RTOL = 1e-3
PASS_FRACTION = 0.95
MAX_ABS = 0.1

# name, scene, W, H, depth, spp, exact (golden tolerance holds everywhere)
GOLDEN = [
    ("cube_16x16_d2_s4", "cube", 16, 16, 2, 4, True),
    ("cornell_32x32_d4_s4", "cornell", 32, 32, 4, 4, True),
    ("textured_32x32_d4_s4", "textured", 32, 32, 4, 4, False),
    ("envmap_32x32_d4_s4", "envmap", 32, 32, 4, 4, False),
]


def _near(got, want):
    """The glossy-scene gate described in the module docstring."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert abs(got.mean() - want.mean()) <= MEAN_RTOL * abs(want.mean())
    ok = np.isclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    assert ok.mean() >= PASS_FRACTION, ok.mean()
    assert np.abs(got - want).max() <= MAX_ABS


def _load(name, tmp_path):
    info = assets.generate(name, tmp_path)
    host = gltf.read_gltf(info["gltf"])
    env = None
    if "env" in info:
        li = images.load_image(info["env"])
        env = HostTexture(li.data, li.is_hdr)
    return host, build.finish_scene(host, env_map=env, device="cpu")


@pytest.mark.parametrize("compact", ["off", "auto"])
@pytest.mark.parametrize("gname,scene,w,h,depth,spp,exact", GOLDEN)
def test_golden_images(gname, scene, w, h, depth, spp, exact, compact,
                       tmp_path):
    host, sc = _load(scene, tmp_path)
    cfg = RenderConfig(width=w, height=h, ray_depth=depth, samples=spp,
                       samples_per_step=spp, seed=0,
                       intersector="pallas", compact=compact)
    res = runtime.render_scene(sc, cfg, host.cam.fov_x, device="cpu")
    got = res.stats.total[0].numpy()
    want = np.load(GOLDEN_DIR / f"{gname}.npy")
    assert res.overflow == 0 and res.samples_done == spp
    assert (res.lane_schedule is not None) == (compact == "auto")
    if exact:
        assert np.allclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL), (
            np.abs(got - want).max())
    else:
        _near(got, want)
    rgb = output.layer_to_rgb(res.stats)
    assert rgb.shape == (h, w, 3) and rgb.dtype == np.uint8


@pytest.fixture(scope="module")
def demo_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    host = jgltf.read_gltf(jassets.generate("demo", d)["gltf"])
    js = jbuild.finish_scene(host)
    return host, js, torch_scene(js)


@pytest.mark.parametrize("schedule", [None, (512,) * 7])
def test_demo_sample_matches_jax(demo_pair, schedule):
    """One demo sample at depth 8 through both packages, uncompacted and
    compacted (111 clusters: 4 mask words with the sort-key header folded
    into the last): equal live-lane counts per bounce, equal ray counts,
    radiance within the glossy-scene gate."""
    host, js, ts = demo_pair
    w, h, depth = 32, 18, 8
    fov = host.cam.fov_x * w / h
    jr, ja = jax.jit(lambda k: jruntime.sample_pass(
        js, k, jnp.int32(0), fov, w, h,
        JTraceOptions(depth=depth, intersector="pallas",
                      lane_schedule=schedule)))(jax.random.PRNGKey(0))
    tr, ta = runtime.sample_pass(
        ts, prng.key_from_seed(0), 0, fov, w, h,
        TraceOptions(depth=depth, intersector="pallas",
                     lane_schedule=schedule))
    assert ta["alive_counts"].tolist() == np.asarray(ja["alive_counts"]).tolist()
    assert int(ta["rays_cast"]) == int(ja["rays_cast"])
    assert int(ta["overflow"]) == int(ja["overflow"]) == 0
    _near(tr.numpy(), jr)


def _pass(scene, fov, w, h, depth, schedule):
    return runtime.sample_pass(
        scene, prng.key_from_seed(0), 0, fov, w, h,
        TraceOptions(depth=depth, intersector="pallas",
                     lane_schedule=schedule))


@pytest.mark.parametrize("name,w,h,depth,schedule", [
    ("cornell", 48, 48, 5, (2304, 2048, 1536, 1024)),
    ("demo", 48, 27, 8, (1536, 1024, 1024, 512, 512, 512, 512)),
])
def test_compacted_matches_full(name, w, h, depth, schedule, tmp_path):
    """Compacted trace = full-width trace lane for lane: every per-lane
    operation is the same elementwise f32 arithmetic in another lane order,
    so the radiance is bit-equal here (the JAX test allows 1e-4 for XLA
    fusion differences), with the same ray count and alive schedule."""
    host, sc = _load(name, tmp_path)
    fov = host.cam.fov_x
    r_full, a_full = _pass(sc, fov, w, h, depth, None)
    r_comp, a_comp = _pass(sc, fov, w, h, depth, schedule)
    assert int(a_comp["overflow"]) == 0
    assert int(a_full["rays_cast"]) == int(a_comp["rays_cast"])
    assert torch.equal(a_full["alive_counts"], a_comp["alive_counts"])
    assert torch.equal(r_full, r_comp)


def test_overflow_detected_and_rerendered(tmp_path, capsys):
    """A schedule below the real alive counts is counted as overflow, and
    render_scene then re-renders uncompacted (equal to compact="off"),
    reporting the compacted attempt's overflow and no lane schedule."""
    host, sc = _load("cornell", tmp_path)
    fov = host.cam.fov_x
    _, a_full = _pass(sc, fov, 48, 48, 5, None)
    _, a_comp = _pass(sc, fov, 48, 48, 5, (512,) * 4)
    expect = max(0, int(a_full["alive_counts"][1]) - 512)
    assert int(a_comp["overflow"]) >= expect > 0
    cfg = RenderConfig(width=48, height=48, ray_depth=5, samples=2,
                       samples_per_step=2,
                       intersector="pallas", compact="off",
                       compact_schedule=(512,) * 4)
    res = runtime.render_scene(sc, cfg, fov, device="cpu")
    assert "re-rendering uncompacted" in capsys.readouterr().out
    ref = runtime.render_scene(sc, cfg.replace(compact_schedule=None), fov,
                               device="cpu")
    assert res.overflow >= expect and res.lane_schedule is None
    assert ref.overflow == 0 and res.rays_cast == ref.rays_cast
    assert torch.equal(res.stats.total, ref.stats.total)


def test_auto_schedule_shape(tmp_path):
    """auto_lane_schedule: one budget per bounce after the first, RB
    multiples, at least the alive count, at most the padded frame."""
    host, sc = _load("demo", tmp_path)
    cfg = RenderConfig(width=40, height=30, ray_depth=6, samples=1,
                       samples_per_step=1,
                       intersector="pallas", compact="auto")
    sched = runtime.auto_lane_schedule(sc, cfg, host.cam.fov_x, device="cpu")
    _, aux = _pass(sc, host.cam.fov_x, 40, 30, 6, None)
    counts = aux["alive_counts"].tolist()
    n0p = -(-40 * 30 // pi.RB) * pi.RB
    assert len(sched) == 5
    for s, c in zip(sched, counts[1:]):
        assert s % pi.RB == 0 and c <= s <= n0p
