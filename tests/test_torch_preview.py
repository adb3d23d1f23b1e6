"""The port's debug overlay, ray logs and headless preview against the JAX
package's, on the CPU: the projection helpers, the oracle's and the
device's per-pixel ray paths, the device ray log against the render's own
AOVs, the BVH wireframe, and the preview's frames, HTTP server and
snapshots (mirrors tests/test_preview.py and tests/test_diagnostics.py).

Tolerances: the projection helpers and the oracle's paths are numpy on
both sides and held bit for bit, and so are the BVH wireframes where both
packages build the BVH natively (ROADMAP.md queue C item 3). The device
paths' bounce, sample and colour are equal; the camera segment's origin,
end and t within 16 ulp (XLA's CPU backend fuses multiply-adds,
tests/test_torch_intersectors.py); later segments' at the golden test's
rtol 1e-4, atol 1e-5: a sampled direction's sin/cos round differently in
XLA, and each bounce carries the difference on (measured on the CPU: up
to 2.6e-6 relative in t at bounce 1, 2e-6 in the end point 100 units
along a miss; tests/test_torch_render.py). Within the port, the ray log of
one lane reproduces the full frame's depth and bounces AOVs bit for
bit."""

import urllib.request

import jax
import numpy as np
import pytest

from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.render import debug_rays as jdebug_rays
from raytracer_odin_tpu.render import preview as jpreview
from raytracer_odin_tpu.utils import math3d as jmath3d
from raytracer_odin_tpu_torch import config
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.io import gltf, png
from raytracer_odin_tpu_torch.models import assets, build
from raytracer_odin_tpu_torch.ops import probes
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.render import debug_rays, preview, runtime
from raytracer_odin_tpu_torch.utils import math3d, prng
from tests.torch_parity import torch_scene, within_16_ulp

W = H = 16


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """name -> (fov, JAX scene, the port's scene holding its arrays, the
    port's own scene)."""
    d = tmp_path_factory.mktemp("preview_scenes")
    out = {}
    for name in ("cube", "cornell"):
        host = jgltf.read_gltf(jassets.generate(name, d / "j")["gltf"])
        js = jbuild.finish_scene(host)
        thost = gltf.read_gltf(assets.generate(name, d / "t")["gltf"])
        own = build.finish_scene(thost, device="cpu")
        out[name] = (host.cam.fov_x, js, torch_scene(js), own)
    return out


def _camera(scene):
    return scene.cam_pos.cpu().numpy(), scene.cam_basis.cpu().numpy()


def test_projection_bit_equal(pairs):
    """world_to_screen and line_to_screen (clipped, culled and straddling
    the camera plane) equal the JAX package's bit for bit."""
    fov, _, ts, _ = pairs["cornell"]
    pos, basis = _camera(ts)
    rng = np.random.default_rng(11)
    pts = rng.uniform(-6, 6, (64, 3)).astype(np.float32)
    pts[0] = pos  # in the camera plane: NaN
    for dims in ((16, 16), (64, 36)):
        for p in pts:
            assert np.array_equal(
                math3d.world_to_screen(pos, basis, fov, dims, p),
                jmath3d.world_to_screen(pos, basis, fov, dims, p),
                equal_nan=True)
        oks = 0
        for a, b in zip(pts[:-1], pts[1:]):
            got = math3d.line_to_screen(pos, basis, fov, dims, a, b)
            want = jmath3d.line_to_screen(pos, basis, fov, dims, a, b)
            assert got[2] == want[2]
            if got[2]:
                oks += 1
                assert np.array_equal(got[0], want[0])
                assert np.array_equal(got[1], want[1])
        assert 0 < oks < len(pts) - 1


def _same_segments(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.bounce, g.sample, g.color) == (w.bounce, w.sample, w.color)
        yield g, w


def test_oracle_paths_bit_equal(pairs):
    """trace_pixel_paths (the numpy oracle) is the JAX package's, bit for
    bit, on the port's copy of the scene."""
    fov, js, ts, _ = pairs["cornell"]
    kw = dict(depth=4, px=7, py=9, samples=4, seed=3)
    got = debug_rays.trace_pixel_paths(ts, 32, 32, fov, **kw)
    want = jdebug_rays.trace_pixel_paths(js, 32, 32, fov, **kw)
    for g, w in _same_segments(got, want):
        assert np.array_equal(g.origin, w.origin)
        assert np.array_equal(g.end, w.end)
        assert g.t == w.t or (np.isinf(g.t) and np.isinf(w.t))


@pytest.mark.parametrize("name,px,py", [("cube", 8, 9), ("cornell", 7, 3),
                                        ("cornell", 0, 15)])
def test_device_paths_match_jax(pairs, name, px, py):
    """trace_pixel_paths_device through "pallas" in both packages: the
    same segments, their positions and t within the module's
    tolerances."""
    fov, js, ts, _ = pairs[name]
    got = debug_rays.trace_pixel_paths_device(ts, W, H, fov, 3, px, py,
                                              samples=2, intersector="pallas")
    want = jdebug_rays.trace_pixel_paths_device(js, W, H, fov, 3, px, py,
                                                samples=2,
                                                intersector="pallas")
    for g, w in _same_segments(got, want):
        if g.bounce == 0:
            assert within_16_ulp(g.origin, w.origin)
            assert within_16_ulp(g.end, w.end)
            assert ((np.isinf(g.t) and np.isinf(w.t))
                    or within_16_ulp(g.t, w.t))
        else:
            for a, b in ((g.origin, w.origin), (g.end, w.end), (g.t, w.t)):
                assert np.allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["cube", "cornell"])
def test_device_ray_log_matches_render(pairs, name):
    """One lane re-traced with its stream id reproduces the full frame's
    sampled path (port of tests/test_preview.py's test): its first t is
    the depth AOV bit for bit (0 and inf on a primary miss), its segment
    count the bounces AOV, on every pixel of a 4x4 grid, and it starts at
    the camera."""
    fov, _, ts, _ = pairs[name]
    depth = 3
    opts = TraceOptions(depth=depth, intersector="pallas", want_aux=True)
    _, aux = runtime.sample_pass(ts, prng.key_from_seed(0), 0, fov, W, H,
                                 opts)
    misses = 0
    for px in range(1, W, 4):
        for py in range(2, H, 4):
            row = H - 1 - py
            segs = debug_rays.trace_pixel_paths_device(
                ts, W, H, fov, depth, px, py, samples=1, seed=0,
                intersector="pallas")
            first = segs[0]
            assert first.bounce == 0 and first.sample == 0
            want_t = float(aux["depth"][row, px])
            if np.isinf(first.t):
                misses += 1
                assert want_t == 0.0 and aux["miss"][row, px] == 1
            else:
                assert first.t == want_t
            assert len(segs) == int(aux["bounces"][row, px])
            assert np.allclose(first.origin, ts.cam_pos.numpy(), atol=1e-5)
    assert misses > 0 or name == "cornell"


@pytest.mark.parametrize("name", ["cube", "cornell"])
def test_bvh_lines_equal_jax(pairs, name):
    """bvh_debug_lines over the port's own BVH equals the JAX package's
    over its own (both built natively), every level and one level."""
    _, js, _, own = pairs[name]
    for level in (None, 2):
        got = preview.bvh_debug_lines(own.bvh, level)
        want = jpreview.bvh_debug_lines(js.bvh, level)
        assert len(got) == len(want) > 0 and len(got) % 12 == 0
        for (a, b, c, lv), (wa, wb, wc, wl) in zip(got, want):
            assert np.array_equal(a, wa) and np.array_equal(b, wb)
            assert c == wc and lv == wl


def _rendered(ts, fov):
    cfg = RenderConfig(width=W, height=H, ray_depth=2, samples=2,
                       samples_per_step=2, intersector="pallas",
                       debug_features=True)
    return runtime.render_scene(ts, cfg, fov, device="cpu")


def _preview(ts, fov, **kw):
    pos, basis = _camera(ts)
    return preview.Preview(pos, basis, fov, (W, H), flat_bvh=ts.bvh,
                           scene=ts, ray_depth=2, intersector="pallas", **kw)


def test_frame_overlays_and_layers(pairs):
    """frame(): None before the first update; every layer; the BVH level
    overlay and the pixel-path overlay (device and oracle) draw; an index
    past the last layer shows the last."""
    fov, _, ts, _ = pairs["cube"]
    res = _rendered(ts, fov)
    pv = _preview(ts, fov)
    assert pv.frame() is None
    pv.update(res.stats, 2)
    base = pv.frame(config.LAYER_NORMAL, "mean")
    assert base.shape == (H, W, 3) and base.dtype == np.uint8
    assert not np.array_equal(base, pv.frame(config.LAYER_NORMAL, "mean",
                                             lines_level=1))
    assert not np.array_equal(base, pv.frame(config.LAYER_NORMAL, "mean",
                                             pixel=(8, 8)))
    assert not np.array_equal(base, pv.frame(config.LAYER_NORMAL, "mean",
                                             pixel=(8, 8),
                                             pixel_src="oracle"))
    assert np.array_equal(pv.frame(99, "first"),
                          pv.frame(config.LAYER_MISS, "first"))


def test_http_server(pairs):
    """serve(0) answers / with the registry's layer names and /frame.png
    with a PNG of the frame (layer, mode, BVH level, pixel); unknown paths
    404; stop() closes it."""
    fov, _, ts, _ = pairs["cube"]
    res = _rendered(ts, fov)
    pv = _preview(ts, fov)
    port = pv.serve(0)
    base = f"http://127.0.0.1:{port}"
    try:
        with pytest.raises(urllib.error.HTTPError):  # no stats yet: 503
            urllib.request.urlopen(f"{base}/frame.png", timeout=10)
        pv.update(res.stats, 2)
        html = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"preview" in html
        for i, name in enumerate(probes.layer_names()):
            assert f"{i}: {name}".encode() in html
        frame = urllib.request.urlopen(
            f"{base}/frame.png?layer=2&mode=first&lines=1&pixel=8,8",
            timeout=10).read()
        img = png.decode(frame)
        assert np.array_equal(img, pv.frame(2, "first", 1, (8, 8)))
        var = urllib.request.urlopen(
            f"{base}/frame.png?mode=variance&lines=off", timeout=10).read()
        assert png.decode(var).shape == (H, W, 3)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{base}/nope", timeout=10)
    finally:
        pv.stop()
    with pytest.raises(OSError):
        urllib.request.urlopen(f"{base}/", timeout=2)


def test_snapshot_writer(pairs, tmp_path):
    """The on_step hook updates the preview and writes the frame of its
    layer and mode, at most once per period."""
    fov, _, ts, _ = pairs["cube"]
    res = _rendered(ts, fov)
    pv = _preview(ts, fov)
    snap = tmp_path / "snap.png"
    w = preview.SnapshotWriter(pv, snap, every_s=0.0,
                               layer=config.LAYER_DEPTH, mode="first")
    w(res.stats, 2)
    assert pv.samples_done == 2
    assert np.array_equal(png.decode(snap.read_bytes()),
                          pv.frame(config.LAYER_DEPTH, "first"))
    snap.unlink()
    slow = preview.SnapshotWriter(pv, snap, every_s=3600.0)
    slow(res.stats, 2)
    assert snap.exists()
    snap.unlink()
    slow(res.stats, 4)
    assert not snap.exists() and pv.samples_done == 4


def test_frame_matches_jax_preview(pairs):
    """The port's frame of each layer (no overlay) is the JAX preview's
    frame of the JAX stats, within one 8-bit level."""
    fov, js, ts, _ = pairs["cube"]
    kw = dict(width=W, height=H, ray_depth=2, samples=2, samples_per_step=2,
              intersector="pallas", debug_features=True)
    from raytracer_odin_tpu.config import RenderConfig as JRenderConfig
    from raytracer_odin_tpu.render import runtime as jruntime

    jres = jruntime.render_scene(js, JRenderConfig(**kw), fov)
    res = runtime.render_scene(ts, RenderConfig(**kw), fov, device="cpu")
    pos, basis = _camera(ts)
    pv = preview.Preview(pos, basis, fov, (W, H))
    jpv = jpreview.Preview(pos, basis, fov, (W, H))
    pv.update(res.stats, 2)
    jpv.update(jax.device_get(jres.stats), 2)
    for layer in range(10):
        got = pv.frame(layer, "mean").astype(int)
        want = jpv.frame(layer, "mean").astype(int)
        assert np.abs(got - want).max() <= 1, layer
