"""The port's persistent wavefront pool (ops/wavefront.py,
runtime.make_pool_render_step) on the CPU, against the port's batched
render and the JAX package's pool (mirrors tests/test_wavefront.py).

The pool renders the batched path's sample set (the same counter-chained
draws and per-lane arithmetic), so its ray count and per-bounce live
lanes equal the batched render's exactly, and so do its first and last
samples; a pixel's sums add its samples as their paths end, in another
order than the batched render's, so totals are held at
tests/test_wavefront.py's rtol 1e-5, atol 1e-6. Against the JAX pool
(interpret-mode kernels, XLA's fused arithmetic) at the golden test's
rtol 1e-4, atol 1e-5, ray counts equal."""

import numpy as np
import pytest
import torch

from raytracer_odin_tpu.config import RenderConfig as JRenderConfig
from raytracer_odin_tpu.models.scene import HostTexture as JHostTexture
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.ops import wavefront
from raytracer_odin_tpu_torch.render import accum, runtime
from raytracer_odin_tpu_torch.utils import prng
from tests.test_integrator import single_quad_scene
from tests.torch_parity import torch_scene

FIELDS = ("first", "last", "total", "total_sq", "count")


def base(**kw):
    out = dict(width=16, height=16, ray_depth=3, samples=4,
               samples_per_step=4, debug_features=False)
    out.update(kw)
    return out


@pytest.fixture(scope="module")
def cube(cube_scene):
    host, js = cube_scene
    return host, js, torch_scene(js)


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    host, js = cornell_scene
    return host, js, torch_scene(js)


def port(scene, fov, **kw):
    res = runtime.render_scene(scene, RenderConfig(**base(**kw)), fov,
                               device="cpu")
    return res, {f: getattr(res.stats, f)[0].numpy() for f in FIELDS}


def jax_render(scene, fov, **kw):
    res = jruntime.render_scene(scene, JRenderConfig(**base(**kw)), fov)
    return res, {f: np.asarray(getattr(res.stats, f)[0]) for f in FIELDS}


def assert_pool_close(pool, batch):
    """The pool against the batched render (module docstring)."""
    for f in ("first", "last", "count"):
        assert np.array_equal(pool[f], batch[f]), f
    assert np.allclose(pool["total"], batch["total"], rtol=1e-5,
                       atol=1e-6), np.abs(pool["total"] - batch["total"]).max()
    assert np.allclose(pool["total_sq"], batch["total_sq"], rtol=1e-5,
                       atol=1e-6)


def assert_jax_close(got, want):
    for f in FIELDS:
        assert np.allclose(got[f], want[f], rtol=1e-4, atol=1e-5), (
            f, np.abs(got[f] - want[f]).max())


@pytest.mark.parametrize("pool_fraction", [0.3, 1.0])
def test_pool_matches_batch(cube, pool_fraction):
    host, js, ts = cube
    fov = host.cam.fov_x
    bres, batch = port(ts, fov)
    pres, pool = port(ts, fov, wavefront_pool=True,
                      pool_fraction=pool_fraction)
    assert pres.rays_cast == bres.rays_cast
    assert pres.alive_counts == bres.alive_counts
    assert pres.overflow == 0 and len(pres.pool_waves) == 1
    assert_pool_close(pool, batch)
    jres, jpool = jax_render(js, fov, wavefront_pool=True,
                             pool_fraction=pool_fraction)
    assert jres.rays_cast == pres.rays_cast
    assert_jax_close(pool, jpool)


def test_pool_multi_step_resume(cube):
    """Two pool steps of 2 spp == one batched run of 4 spp."""
    host, js, ts = cube
    fov = host.cam.fov_x
    bres, batch = port(ts, fov)
    pres, pool = port(ts, fov, wavefront_pool=True, samples_per_step=2)
    assert pres.samples_done == 4 and len(pres.pool_waves) == 2
    assert pres.rays_cast == bres.rays_cast
    assert_pool_close(pool, batch)
    _, jpool = jax_render(js, fov, wavefront_pool=True, samples_per_step=2)
    assert_jax_close(pool, jpool)


def test_pool_env_scene():
    """Env-map misses flush their radiance as hits do."""
    env = JHostTexture(np.full((4, 8, 3), 0.6, np.float32), True)
    js = single_quad_scene(color=(0.5, 0.5, 0.5), env=env, metallic=0.0)
    ts = torch_scene(js)
    kw = dict(width=8, height=8)
    bres, batch = port(ts, 0.8, **kw)
    pres, pool = port(ts, 0.8, wavefront_pool=True, **kw)
    assert pres.rays_cast == bres.rays_cast
    assert_pool_close(pool, batch)
    assert float(pool["total"].mean()) > 0
    _, jpool = jax_render(js, 0.8, wavefront_pool=True, **kw)
    assert_jax_close(pool, jpool)


def test_pool_sorted_pallas_cast(cornell):
    """The pool through "pallas": each wave sorts the pool by K1's masks,
    dead lanes last, and sweeps it (the card's route, with the kernels'
    plain versions here); the JAX pool through its interpret-mode
    kernels."""
    host, js, ts = cornell
    fov = host.cam.fov_x
    kw = dict(width=24, height=24, ray_depth=4, samples=2,
              samples_per_step=2, intersector="pallas")
    bres, batch = port(ts, fov, compact="off", **kw)
    pres, pool = port(ts, fov, wavefront_pool=True, pool_fraction=0.5, **kw)
    assert pres.rays_cast == bres.rays_cast
    assert pres.alive_counts == bres.alive_counts
    assert_pool_close(pool, batch)
    jres, jpool = jax_render(js, fov, wavefront_pool=True, pool_fraction=0.5,
                             **kw)
    assert jres.rays_cast == pres.rays_cast
    assert_jax_close(pool, jpool)


def test_pool_reproducible_and_check_every(cube, monkeypatch):
    """Two runs give the same bits; the loop condition, read every wave
    once ceil(items / pool) waves have run, ends the step as soon as no
    item is left and no lane is alive: every wave it casts has live
    lanes."""
    host, _, ts = cube
    cfg = RenderConfig(**base(wavefront_pool=True, pool_fraction=0.3))
    cast = wavefront.traverse.cast_rays
    live = []

    def counting_cast(scene, o, d, *, alive, **kw):
        live.append(int(alive.sum()))
        return cast(scene, o, d, alive=alive, **kw)

    monkeypatch.setattr(wavefront.traverse, "cast_rays", counting_cast)
    out = []
    for _ in range(2):
        live.clear()
        step = runtime.make_pool_render_step(cfg, host.cam.fov_x,
                                             device="cpu")
        stats = accum.init_stats(1, 16, 16, device="cpu")
        stats, info = step(ts, stats, prng.key_from_seed(0), 0)
        out.append((stats, info, step.waves[0], list(live)))
    (s1, i1, w1, l1), (s2, i2, w2, l2) = out
    assert w1 == w2 == len(l1) and l1 == l2
    assert w1 >= -(-4 * 16 * 16 // step.pool_size)
    assert all(n > 0 for n in l1)
    for f in FIELDS:
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    assert torch.equal(i1, i2)
    assert step.pool_size == 1024  # max(1024, 256 x 0.3) in whole blocks
    with pytest.raises(ValueError):
        runtime.make_pool_render_step(cfg.replace(debug_features=True), 1.0,
                                      device="cpu")


def test_camera_rays_match_generate_rays(cube):
    """The pool's per-lane camera rays (generate_rays of flat pixel ids)
    are the full frame's bits, in any pixel order."""
    _, _, ts = cube
    key = prng.key_from_seed(4)
    w, h, fov = 20, 12, 0.9
    o, d = runtime.camera_rays(ts, key, 3, fov, w, h)
    pixel = torch.arange(w * h).flip(0)
    jitter = prng.uniforms(key, 3, prng.JITTER_TAG, pixel.to(torch.int32), 2)
    o2, d2 = runtime.generate_rays(ts.cam_pos, ts.cam_basis, fov, w, h,
                                   jitter, pixel=pixel)
    o2, d2 = o2.flip(0), d2.flip(0)
    assert torch.equal(o2, o.reshape(-1, 3))
    assert torch.equal(d2, d.reshape(-1, 3))
