"""The re-sort cadence of the compacted trace (integrator.SORT_EVERY, the
JAX package's RT_TPU_SORT_EVERY) in the PyTorch port against the JAX
package, on the CPU, in the row form and the columnar form (COLS).

On a skip-sort bounce every lane is cast and shaded in the previous
bounce's order, dead lanes as far rays, and each lane draws with its own
stream id, so the physics of a lane does not change: held against the JAX
package under the same setting with equal live-lane counts, ray counts and
overflow 0, and radiance within the glossy-scene gate of
tests/test_torch_render.py; against the port's own sorted route bit for bit
(the row form; on the CPU no ray meets a hit its own K1 mask rounds out
here, ROADMAP.md queue C item 4). Refill and the pool never read
SORT_EVERY: refill's frame is bit-equal whatever it is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_odin_tpu.ops import integrator as jinteg
from raytracer_odin_tpu.ops.integrator import TraceOptions as JTraceOptions
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.ops import integrator as tinteg
from raytracer_odin_tpu_torch.ops import pallas_intersect as tpi
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.render import runtime as truntime
from raytracer_odin_tpu_torch.utils import prng
from tests.test_torch_render import _near
from tests.torch_parity import torch_scene

W, H, DEPTH = 24, 24, 5
SCHEDULE = (1024,) * (DEPTH - 1)


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    host, js = cornell_scene
    return host, js, torch_scene(js)


def _port(ts, fov):
    return truntime.sample_pass(
        ts, prng.key_from_seed(0), 0, fov, W, H,
        TraceOptions(depth=DEPTH, intersector="pallas",
                     lane_schedule=SCHEDULE))


@pytest.mark.parametrize("cols", [0, 1])
@pytest.mark.parametrize("every", [2, 3])
def test_sort_every_matches_jax(monkeypatch, cornell, every, cols):
    """A compacted cornell sample (24x24, depth 5) with SORT_EVERY 2 and 3,
    row form and columnar, against the JAX package under the same setting
    and against the port's sorted route of the same form; the skip-sort
    bounces run at the previous bounce's width."""
    host, js, ts = cornell
    fov = host.cam.fov_x
    monkeypatch.setattr(jinteg, "COLS", cols)
    monkeypatch.setattr(tinteg, "COLS", cols)
    sorted_r, sorted_a = _port(ts, fov)
    widths = []
    real = tpi.cluster_masks_rows

    def record(aabb8, rays, n_bits, tmax_row=False):
        widths.append(rays.shape[1])
        return real(aabb8, rays, n_bits, tmax_row=tmax_row)

    monkeypatch.setattr(jinteg, "SORT_EVERY", every)
    monkeypatch.setattr(tinteg, "SORT_EVERY", every)
    monkeypatch.setattr(tpi, "cluster_masks_rows", record)
    tr, ta = _port(ts, fov)
    jr, ja = jax.jit(lambda k: jruntime.sample_pass(
        js, k, jnp.int32(0), fov, W, H,
        JTraceOptions(depth=DEPTH, intersector="pallas",
                      lane_schedule=SCHEDULE)))(jax.random.PRNGKey(0))
    assert ta["alive_counts"].tolist() == np.asarray(
        ja["alive_counts"]).tolist() == sorted_a["alive_counts"].tolist()
    assert int(ta["rays_cast"]) == int(ja["rays_cast"]) == int(
        sorted_a["rays_cast"])
    assert int(ta["overflow"]) == int(ja["overflow"]) == 0
    _near(tr.numpy(), jr)
    if not cols:
        assert torch.equal(tr, sorted_r)
    else:
        _near(tr.numpy(), sorted_r.numpy())
    # K1's batches: bounce 0's tiles, then a sorted bounce, and each
    # skip-sort bounce at the width of the bounce before it
    for b in range(2, DEPTH):
        if (b - 1) % every:
            assert widths[b] == widths[b - 1]


def test_refill_ignores_sort_every(monkeypatch, cornell):
    """Refill's frame is bit-equal whatever SORT_EVERY is."""
    host, _, ts = cornell
    cfg = RenderConfig(width=W, height=H, ray_depth=DEPTH, samples=4,
                       samples_per_step=4, intersector="pallas",
                       compact="refill")
    want = truntime.render_scene(ts, cfg, host.cam.fov_x, device="cpu")
    monkeypatch.setattr(tinteg, "SORT_EVERY", 3)
    got = truntime.render_scene(ts, cfg, host.cam.fov_x, device="cpu")
    assert got.refill_plan is not None and got.overflow == 0
    for f in ("first", "last", "total", "total_sq", "count"):
        assert torch.equal(getattr(got.stats, f), getattr(want.stats, f)), f
    assert got.rays_cast == want.rays_cast
