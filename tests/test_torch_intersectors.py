"""The port's "brute" and "bvh" intersectors, its ray-AABB test and device
BVH, and the "auto" dispatch, against the JAX package on the CPU (mirrors
tests/test_geometry.py:43-78 and tests/test_bvh.py:53-103).

Tolerances: hit/miss and, away from ties, hit indices bit-equal; t within
T_RTOL, since XLA's CPU backend fuses the Moller-Trumbore multiply-adds
(up to 16 ulp, tests/test_torch_kernels.py). A hit index may differ only
where two triangles are hit at equal t (shared edges), the rule the JAX
package's own test_bvh holds brute and BVH to. The cube and cornell golden
images (made by the JAX package's CPU "auto" -> "brute" path) hold at the
golden test's rtol 1e-4, atol 1e-5 through both intersectors."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.ops import geometry as jgeom
from raytracer_odin_tpu.ops import traverse as jtrav
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.io import gltf as tgltf
from raytracer_odin_tpu_torch.models import assets as tassets
from raytracer_odin_tpu_torch.models import build as tbuild
from raytracer_odin_tpu_torch.models.scene import BVH_FIELDS
from raytracer_odin_tpu_torch.ops import geometry as tgeom
from raytracer_odin_tpu_torch.ops import integrator as tinteg
from raytracer_odin_tpu_torch.ops import pallas_intersect as tpi
from raytracer_odin_tpu_torch.ops import traverse as ttrav
from raytracer_odin_tpu_torch.render import runtime as truntime
from tests.test_torch_kernels import T_ATOL, T_RTOL, _scene_pair
from tests.test_torch_render import GOLDEN, GOLDEN_ATOL, GOLDEN_RTOL, _load
from tests.torch_parity import torch_scene

GOLDEN_DIR = Path(__file__).parent / "golden"


def _t(a):
    return torch.from_numpy(np.array(a))


# (o, d, lo, hi, max_t) of tests/test_geometry.py:43-78
AABB_CASES = {
    "basic": ((0, 0, 0), (0, 0, 1), (-1, -1, 2), (1, 1, 3), 1e30),
    "inside": ((0, 0, 0), (0, 0, 1), (-1, -1, -1), (1, 1, 1), 1e30),
    "behind": ((0, 0, 5), (0, 0, 1), (-1, -1, 2), (1, 1, 3), 1e30),
    "pruned": ((0, 0, 0), (0, 0, 1), (-1, -1, 2), (1, 1, 3), 1.0),
    "on_boundary": ((1, 0, 0), (0, 0, 1), (-1, -1, 2), (1, 1, 3), 1e30),
}


@pytest.mark.parametrize("case", sorted(AABB_CASES))
def test_intersect_aabb_cases(case):
    o, d, lo, hi, max_t = (np.float32(x) for x in AABB_CASES[case])
    want_t, want_hit = jgeom.intersect_aabb(
        jnp.asarray(o), 1.0 / jnp.asarray(d), jnp.asarray(lo),
        jnp.asarray(hi), jnp.float32(max_t))
    with np.errstate(divide="ignore"):
        inv = 1.0 / d
    got_t, got_hit = tgeom.intersect_aabb(_t(o), _t(inv), _t(lo), _t(hi),
                                          torch.tensor(max_t))
    assert bool(got_hit) == bool(want_hit)
    assert got_t.dtype == torch.float32
    assert np.array_equal(got_t.numpy(), np.asarray(want_t))
    expect = {"basic": (True, 2.0), "inside": (True, 0.0),
              "behind": (False, None), "pruned": (False, None),
              "on_boundary": (True, 2.0)}[case]
    assert bool(got_hit) == expect[0]
    if expect[1] is not None:
        assert float(got_t) == expect[1]


def test_intersect_aabb_batch_nan_slabs():
    """Random boxes and rays with zero direction components (0 * inf NaN
    slabs) and pruning bounds: bit-equal entry and hit."""
    rng = np.random.default_rng(3)
    n = 4000
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::3, 0] = 0.0
    d[::5, 1] = 0.0
    o[::6, 0] = 1.0  # on the boxes' x = 1 plane
    lo = rng.uniform(-3, 0, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.5, 3, (n, 3)).astype(np.float32)
    lo[::6, 0] = -1.0
    hi[::6, 0] = 1.0
    max_t = rng.uniform(0, 6, n).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv = (1.0 / d).astype(np.float32)
    jt, jh = jgeom.intersect_aabb(jnp.asarray(o), jnp.asarray(inv),
                                  jnp.asarray(lo), jnp.asarray(hi),
                                  jnp.asarray(max_t))
    tt, th = tgeom.intersect_aabb(_t(o), _t(inv), _t(lo), _t(hi), _t(max_t))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert 0 < int(th.sum()) < n


def _check(jt, ji, tt, ti):
    """The port's cast against the JAX package's: hit/miss equal, t within
    T_RTOL, index equal except at equal-t ties."""
    jt, ji = np.asarray(jt), np.asarray(ji)
    tt, ti = tt.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and ti.shape == ji.shape
    assert np.array_equal(ji >= 0, ti >= 0)
    assert np.allclose(jt, tt, rtol=T_RTOL, atol=T_ATOL)
    flip = (ji != ti)
    assert np.allclose(jt[flip], tt[flip], rtol=1e-4, atol=1e-4)


def _both(js, ts, o, d, chunk=512):
    """brute and bvh casts of both packages; the port's brute and bvh
    agree with each other under the same rule."""
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jb = jtrav.cast_rays_brute(js, jo, jd, chunk=chunk)
    jv = jtrav.cast_rays_bvh(js, jo, jd)
    tb = ttrav.cast_rays_brute(ts, _t(o), _t(d), chunk=chunk)
    tv = ttrav.cast_rays_bvh(ts, _t(o), _t(d))
    _check(jb[0], jb[1], *tb)
    _check(jv[0], jv[1], *tv)
    _check(tb[0].numpy(), tb[1].numpy(), *tv)
    return tb


def _random_rays(rng, n):
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_brute_bvh_random():
    rng = np.random.default_rng(0)
    js, ts = _scene_pair(rng, 300)
    o, d = _random_rays(rng, 512)
    t, i = _both(js, ts, o, d)
    assert int((i >= 0).sum()) > 30
    # chunking changes nothing: 7 triangles a chunk, and rays in groups
    t7, i7 = ttrav.cast_rays_brute(ts, _t(o), _t(d), chunk=7)
    assert torch.equal(i7, i) and torch.equal(t7, t)


def test_brute_bvh_axis_rays():
    """Axis-aligned rays: the NaN slab cases and all octants."""
    rng = np.random.default_rng(1)
    js, ts = _scene_pair(rng, 100)
    dirs = []
    for sx in (-1.0, 1.0):
        for axis in range(3):
            e = np.zeros(3, np.float32)
            e[axis] = sx
            dirs += [e] * 20
    d = np.stack(dirs)
    o = rng.uniform(-8, 8, (d.shape[0], 3)).astype(np.float32)
    _both(js, ts, o, d)


def test_brute_bvh_all_octants():
    rng = np.random.default_rng(2)
    js, ts = _scene_pair(rng, 200)
    for ox in range(8):
        sign = np.array([-1 if ox & 1 else 1, -1 if ox & 2 else 1,
                         -1 if ox & 4 else 1], np.float32)
        d = np.abs(rng.normal(size=(64, 3))).astype(np.float32) * sign
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = rng.uniform(-8, 8, (64, 3)).astype(np.float32)
        _both(js, ts, o, d)


@pytest.mark.parametrize("n", [1, 2, 4, 5])
def test_brute_bvh_few_triangles(n):
    rng = np.random.default_rng(3 + n)
    js, ts = _scene_pair(rng, n)
    o, d = _random_rays(rng, 64)
    _both(js, ts, o, d)


@pytest.fixture(scope="module")
def demo_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo3")
    host = jgltf.read_gltf(jassets.generate("demo", d)["gltf"])
    js = jbuild.finish_scene(host)
    return host, js, torch_scene(js)


def test_brute_bvh_demo(demo_pair):
    """The demo's camera rays (7,090 triangles: "auto" means "bvh" on the
    CPU) through both packages' brute and BVH casts."""
    host, js, ts = demo_pair
    w, h = 24, 14
    fov = host.cam.fov_x * w / h
    jit = np.full((h, w, 2), 0.5, np.float32)
    o, d = truntime.generate_rays(ts.cam_pos, ts.cam_basis, fov, w, h,
                                  _t(jit))
    o, d = o.numpy(), d.numpy()
    t, i = _both(js, ts, o, d, chunk=2048)
    assert int((i >= 0).sum()) > 200
    _, ia = ttrav.cast_rays(ts, _t(o), _t(d))
    assert torch.equal(ia, ttrav.cast_rays_bvh(ts, _t(o), _t(d))[1])


@pytest.mark.parametrize("name", ["cube", "cornell", "demo"])
def test_device_bvh_matches(name, tmp_path):
    """The port's flattened BVH arrays equal the JAX package's DeviceBVH,
    and torch_scene carries a JAX scene's BVH across."""
    jhost = jgltf.read_gltf(jassets.generate(name, tmp_path / "j")["gltf"])
    js = jbuild.finish_scene(jhost)
    thost = tgltf.read_gltf(tassets.generate(name, tmp_path / "t")["gltf"])
    scene = tbuild.finish_scene(thost, device="cpu")
    carried = torch_scene(js)
    for f in BVH_FIELDS:
        want = np.asarray(getattr(js.bvh, f))
        got = getattr(scene.bvh, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
        assert np.array_equal(getattr(carried.bvh, f).numpy(), want), f


def test_auto_dispatch_and_compaction_gating(tmp_path):
    """"auto" on CPU tensors: "brute" up to brute_max_tris triangles, "bvh"
    above, no compaction and no calibration; on the card "pallas", which
    compacts."""
    assert ttrav.resolve_intersector("auto", 512, "cpu") == "brute"
    assert ttrav.resolve_intersector("auto", 513, "cpu") == "bvh"
    assert ttrav.resolve_intersector("auto", 513, "cpu", 1000) == "brute"
    assert ttrav.resolve_intersector("auto", 10, "cuda") == "pallas"
    assert ttrav.resolve_intersector("bvh", 10, "cuda") == "bvh"
    opts = tinteg.TraceOptions(intersector="auto")
    assert not tinteg.compaction_applies(opts, "cpu")
    assert tinteg.compaction_applies(opts, "cuda")
    for name in ("brute", "bvh", "pallas_brute"):
        assert not tinteg.compaction_applies(opts._replace(intersector=name),
                                             "cuda")
    assert not tinteg.compaction_applies(opts._replace(depth=1), "cuda")
    host, sc = _load("cube", tmp_path)
    before = tpi.cluster_masks_rows.launches
    cfg = RenderConfig(width=8, height=8, ray_depth=3, samples=1,
                       samples_per_step=1, compact="auto")
    res = truntime.render_scene(sc, cfg, host.cam.fov_x, device="cpu")
    assert res.lane_schedule is None and res.overflow == 0
    assert tpi.cluster_masks_rows.launches == before
    with pytest.raises(ValueError):
        ttrav.cast_rays(sc, torch.zeros(4, 3), torch.ones(4, 3),
                        intersector="nope")


@pytest.mark.parametrize("intersector", ["brute", "bvh"])
@pytest.mark.parametrize("gname,scene,w,h,depth,spp,exact",
                         [g for g in GOLDEN if g[6]])
def test_golden_images(gname, scene, w, h, depth, spp, exact, intersector,
                       tmp_path):
    """Cube and cornell golden images through "brute" and "bvh"."""
    host, sc = _load(scene, tmp_path)
    cfg = RenderConfig(width=w, height=h, ray_depth=depth, samples=spp,
                       samples_per_step=spp, seed=0, intersector=intersector,
                       compact="auto")
    res = truntime.render_scene(sc, cfg, host.cam.fov_x, device="cpu")
    got = res.stats.total[0].numpy()
    want = np.load(GOLDEN_DIR / f"{gname}.npy")
    assert res.lane_schedule is None and res.samples_done == spp
    assert np.allclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL), (
        np.abs(got - want).max())


def test_render_config_brute_options(tmp_path):
    """RenderConfig's brute_chunk and brute_max_tris reach the cast: the
    cube (12 triangles) renders bit for bit the same through 5-triangle
    brute chunks as through one chunk (first minimum within a chunk,
    strict < across chunks), and "auto" with brute_max_tris 0 is "bvh"."""
    host, sc = _load("cube", tmp_path)

    def render(**kw):
        cfg = RenderConfig(width=8, height=8, ray_depth=3, samples=2,
                           samples_per_step=2, seed=0, **kw)
        return truntime.render_scene(sc, cfg, host.cam.fov_x,
                                     device="cpu").stats.total[0]

    assert torch.equal(render(intersector="brute", brute_chunk=5),
                       render(intersector="brute"))
    assert torch.equal(render(intersector="auto", brute_max_tris=0),
                       render(intersector="bvh"))


def test_coherence_keys_match_jax():
    """culling.coherence_keys gives the JAX package's keys bit for bit,
    dead lanes included."""
    from raytracer_odin_tpu.ops import culling as jcull
    from raytracer_odin_tpu_torch.ops import culling as tcull

    rng = np.random.default_rng(12)
    o = rng.uniform(-6, 6, (4000, 3)).astype(np.float32)
    d = rng.normal(size=(4000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    alive = rng.uniform(size=4000) < 0.8
    lo = np.float32([-4, -5, -3])
    hi = np.float32([4, 3, 5])
    want = jcull.coherence_keys(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(alive), jnp.asarray(lo),
                                jnp.asarray(hi))
    got = tcull.coherence_keys(_t(o), _t(d), _t(alive), _t(lo), _t(hi))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_brute_sorted_cast():
    """cast_rays_pallas(culled=False, sort=True): K3 over the lanes sorted
    by the coherence keys, scattered back. Every cluster is tested for
    every ray, so each live lane's hit is the unsorted cast's (and the JAX
    package's unsorted cast's), and dead lanes miss. The JAX package's
    sorted unculled cast scatters its results back by the wrong
    permutation (ROADMAP.md queue C): its lanes get other lanes' hits."""
    rng = np.random.default_rng(13)
    js, ts = _scene_pair(rng, 300)
    o = rng.uniform(-8, 8, (1500, 3)).astype(np.float32)
    d = rng.normal(size=(1500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    alive = rng.uniform(size=1500) < 0.7
    before = tpi.intersect_brute_rows.launches
    ts_t, ts_i = ttrav.cast_rays_pallas(ts, _t(o), _t(d), culled=False,
                                        sort=True, alive=_t(alive))
    tu_t, tu_i = ttrav.cast_rays_pallas(ts, _t(o), _t(d), culled=False)
    assert tpi.intersect_brute_rows.launches == before
    assert int((tu_i >= 0).sum()) > 100
    live = _t(alive)
    assert torch.equal(ts_i[live], tu_i[live])
    assert torch.equal(ts_t[live], tu_t[live])
    assert bool((ts_i[~live] < 0).all())
    jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o), jnp.asarray(d),
                                          culled=False)
    assert np.array_equal(np.asarray(ji), tu_i.numpy())
    assert np.allclose(np.asarray(jt), tu_t.numpy(), rtol=T_RTOL,
                       atol=T_ATOL)
    _, jsi, _, _ = jtrav.cast_rays_pallas(
        js, jnp.asarray(o), jnp.asarray(d), culled=False, sort=True,
        alive=jnp.asarray(alive))
    assert not np.array_equal(np.asarray(jsi)[alive], np.asarray(ji)[alive])
