"""The port's cross-sample refill scheduler (ops/refill.py,
runtime.auto_refill_plan / make_refill_render_step, compact="refill") on
the CPU, against the port's full-width render and the JAX package's
refill render (mirrors tests/test_integrator.py's refill tests).

plan_refill is host numpy on both sides and is held tuple for tuple. A
refilled sample runs each lane's arithmetic of the full-width trace and
the step folds the samples in sample order, as the batched step does, so
the port's refill render is bit-equal to its full-width render, ray and
live-lane counts included. Against the JAX refill render (interpret-mode
kernels, XLA's fused arithmetic, its sum of a step's samples before the
fold) at the golden test's rtol 1e-4, atol 1e-5 (tests/test_integrator.py
allows 1e-4, 1e-4 between its own refill and full renders), ray counts
equal."""

import numpy as np
import pytest
import torch

from raytracer_odin_tpu.config import RenderConfig as JRenderConfig
from raytracer_odin_tpu.models.scene import HostTexture as JHostTexture
from raytracer_odin_tpu.ops import refill as jrefill
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.ops import refill
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.render import runtime
from tests.test_integrator import single_quad_scene
from tests.torch_parity import torch_scene

FIELDS = ("first", "last", "total", "total_sq", "count")


@pytest.mark.parametrize("counts,n_pixels,n_samples,depth,margin,width", [
    ([10000, 7000, 4200, 2500, 1400, 700], 10000, 8, 6, 1.04, None),
    ([1024, 1000, 10, 0], 1024, 4, 4, 1.04, None),
    ([2073600, 1888000, 1250000, 850000, 560000, 380000, 250000, 170000],
     2073600, 4, 8, 1.04, None),
    ([576, 500, 300, 100], 576, 2, 4, 1.5, 2048),
    ([300, 0, 0], 300, 3, 3, 1.0, None),
])
def test_plan_refill_matches_jax(counts, n_pixels, n_samples, depth, margin,
                                 width):
    """The copied planner gives the JAX package's plan, and the plan
    conserves the queue (tests/test_integrator.py:394-408): fresh lanes
    cover every item, every width is a block multiple, and the last
    depth - 1 iterations refill nothing."""
    want = jrefill.plan_refill(counts, n_pixels, n_samples, depth, 512,
                               margin, width)
    got = refill.plan_refill(counts, n_pixels, n_samples, depth, 512,
                             margin, width)
    assert tuple(got) == tuple(want)
    assert got.fresh == tuple(want.fresh) and got.keep == tuple(want.keep)
    assert sum(got.fresh) >= n_samples * n_pixels
    assert all(r % 512 == 0 and k % 512 == 0
               for r, k in zip(got.fresh, got.keep))
    assert all(r == 0 for r in got.fresh[-(depth - 1):])


def test_refill_applies():
    """Refill takes the exact-culled sorted cast without instrumentation:
    "pallas" anywhere, "auto" on the card only."""
    ok = TraceOptions(depth=2, intersector="pallas")
    assert refill.refill_applies(ok, "cpu")
    assert refill.refill_applies(ok._replace(depth=1), "cpu")
    assert not refill.refill_applies(ok._replace(depth=0), "cpu")
    for bad in (dict(want_aux=True), dict(log_paths=True),
                dict(check_nans=True), dict(sort_rays=False),
                dict(intersector="brute"), dict(intersector="auto")):
        assert not refill.refill_applies(ok._replace(**bad), "cpu"), bad
    assert refill.refill_applies(ok._replace(intersector="auto"), "meta")


def base(**kw):
    out = dict(width=24, height=24, ray_depth=4, samples=4,
               samples_per_step=4, debug_features=False,
               intersector="pallas", compact="refill")
    out.update(kw)
    return out


def port(scene, fov, **kw):
    res = runtime.render_scene(scene, RenderConfig(**base(**kw)), fov,
                               device="cpu")
    return res, {f: getattr(res.stats, f).numpy() for f in FIELDS}


def jax_render(scene, fov, **kw):
    res = jruntime.render_scene(scene, JRenderConfig(**base(**kw)), fov)
    return res, {f: np.asarray(getattr(res.stats, f)) for f in FIELDS}


def assert_jax_close(got, want):
    for f in FIELDS:
        assert np.allclose(got[f], want[f], rtol=1e-4, atol=1e-5), (
            f, np.abs(got[f] - want[f]).max())


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    host, js = cornell_scene
    return host, js, torch_scene(js)


def test_refill_matches_full_and_jax(cornell):
    host, js, ts = cornell
    fov = host.cam.fov_x
    rres, got = port(ts, fov)
    fres, full = port(ts, fov, compact="off")
    assert rres.refill_plan is not None and rres.lane_schedule is None
    assert rres.overflow == 0
    assert rres.rays_cast == fres.rays_cast
    assert rres.alive_counts == fres.alive_counts
    for f in FIELDS:
        assert np.array_equal(got[f], full[f]), f
    jres, want = jax_render(js, fov)
    assert jres.rays_cast == rres.rays_cast
    assert_jax_close(got, want)


def test_refill_env_and_multi_step():
    """Two steps of 2 spp (sample_start offsets) on a scene with env-map
    misses, so retired env radiance rides the merge."""
    env = JHostTexture(np.full((4, 8, 3), 0.4, np.float32), True)
    js = single_quad_scene(color=(0.5, 0.5, 0.5), env=env, metallic=0.0)
    ts = torch_scene(js)
    kw = dict(ray_depth=3, samples_per_step=2)
    rres, got = port(ts, 1.2, **kw)
    fres, full = port(ts, 1.2, compact="off", **kw)
    assert rres.samples_done == 4 and rres.refill_plan is not None
    assert rres.rays_cast == fres.rays_cast
    for f in FIELDS:
        assert np.array_equal(got[f], full[f]), f
    jres, want = jax_render(js, 1.2, **kw)
    assert jres.rays_cast == rres.rays_cast
    assert_jax_close(got, want)


def test_refill_overflow_rerenders_uncompacted(cornell, capsys):
    """A margin below the measured survival makes the plan cut live lanes:
    the overflow is counted and the render redone uncompacted, equal to
    compact="off"."""
    host, _, ts = cornell
    fov = host.cam.fov_x
    kw = dict(width=48, height=48, samples=2, samples_per_step=2)
    res, got = port(ts, fov, compact_margin=0.1, **kw)
    assert "re-rendering uncompacted" in capsys.readouterr().out
    assert res.overflow > 0 and res.refill_plan is None
    fres, full = port(ts, fov, compact="off", **kw)
    assert res.rays_cast == fres.rays_cast
    for f in FIELDS:
        assert np.array_equal(got[f], full[f]), f


def test_refill_elsewhere_is_batched(cornell):
    """Where refill does not apply ("auto" on the CPU, or debug layers)
    compact="refill" renders through the batched step, as in the JAX
    package."""
    host, _, ts = cornell
    fov = host.cam.fov_x
    res, got = port(ts, fov, intersector="auto", samples=2,
                    samples_per_step=2)
    ref, want = port(ts, fov, intersector="auto", compact="off", samples=2,
                     samples_per_step=2)
    assert res.refill_plan is None and res.lane_schedule is None
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f
    with pytest.raises(ValueError):
        runtime.make_refill_render_step(
            RenderConfig(**base(debug_features=True)), fov,
            refill.RefillPlan((512,), (512,)), device="cpu")
    dbg = runtime.render_scene(ts, RenderConfig(**base(debug_features=True,
                                                       samples=1,
                                                       samples_per_step=1)),
                               fov, device="cpu")
    assert dbg.refill_plan is None and dbg.stats.count.shape[0] == 10
    assert torch.all(dbg.stats.count == 1)
