"""The port's multi-device rendering (parallel/mesh.py) on the CPU: meshes
of the CPU device repeated ([cpu] * 8, the counterpart of the JAX tests'
eight virtual CPU devices of tests/conftest.py), each held against the
port's single-device render and against the JAX package's mesh of the
same shape on its virtual devices (mirrors tests/test_parallel.py).

Tolerances are tests/test_parallel.py's: a tile-only mesh is bit-identical
to one device (np.array_equal), across steps; an spp mesh differs only by
the order of the sum across shards, so its totals are held at rtol 1e-4,
atol 1e-5 and its first/last samples at rtol 1e-5, atol 1e-6. Port against
JAX: the cube through "auto" ("brute" on the CPU in both) at the golden
test's rtol 1e-4, atol 1e-5 (tests/test_torch_render.py), ray counts
equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.config import RenderConfig as JRenderConfig
from raytracer_odin_tpu.parallel import mesh as jmesh
from raytracer_odin_tpu.render import accum as jaccum
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.parallel import mesh as pmesh
from raytracer_odin_tpu_torch.render import accum, runtime
from raytracer_odin_tpu_torch.utils import prng
from tests.test_torch_render import _load
from tests.torch_parity import torch_scene

FIELDS = ("first", "last", "total", "total_sq", "count")
CPU8 = ["cpu"] * 8


def cfg16(**kw):
    base = dict(width=16, height=16, ray_depth=2, samples=8,
                samples_per_step=8, debug_features=False)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def cube(cube_scene):
    host, js = cube_scene
    return host, js, torch_scene(js)


def run_mesh(scene, cfg, fov_x, n_tile, n_spp, steps=1):
    """The port's mesh, driven as the CLI drives it (runtime.render_scene
    with the sharded step and sharded stats). Returns (the result, stats
    cropped to the image as numpy, the step)."""
    mesh = pmesh.make_mesh(n_tile=n_tile, n_spp=n_spp, devices=CPU8)
    rs = pmesh.replicate_scene(scene, mesh)
    step = pmesh.make_sharded_render_step(cfg, fov_x, mesh, rs)
    h_pad = pmesh.padded_height(cfg.height, n_tile)
    res = runtime.render_scene(
        rs, cfg.replace(samples=steps * cfg.samples_per_step), fov_x,
        device="cpu", step_fn=step,
        make_stats=lambda: pmesh.shard_stats(
            accum.init_stats(cfg.num_layers, h_pad, cfg.width,
                             device="cpu"), mesh))
    st = accum.crop(res.stats, cfg.height, cfg.width)
    return res, {f: getattr(st, f).numpy() for f in FIELDS}, step


def run_jax_mesh(scene, cfg, fov_x, n_tile, n_spp, steps=1):
    """tests/test_parallel.py's run_mesh, with the padded rows cropped."""
    mesh = jmesh.make_mesh(n_tile=n_tile, n_spp=n_spp)
    scene_r = jmesh.replicate_scene(scene, mesh)
    h_pad = jmesh.padded_height(cfg.height, n_tile)
    stats = jmesh.shard_stats(
        jaccum.init_stats(cfg.num_layers, h_pad, cfg.width), mesh)
    step = jmesh.make_sharded_render_step(cfg, fov_x, mesh, scene_r)
    key = jax.random.PRNGKey(cfg.seed)
    rays = 0
    for i in range(steps):
        stats, step_rays = step(scene_r, stats, key,
                                jnp.int32(i * cfg.samples_per_step))
        rays += int(step_rays)
    st = jaccum.crop(stats, cfg.height, cfg.width)
    return rays, {f: np.asarray(getattr(st, f)) for f in FIELDS}


def single(scene, cfg, fov_x):
    res = runtime.render_scene(scene, cfg, fov_x, device="cpu")
    return res, {f: getattr(res.stats, f).numpy() for f in FIELDS}


def assert_spp_close(got, want, layers=slice(0, 1)):
    """tests/test_parallel.py's spp-mesh tolerances."""
    for f, (rtol, atol) in (("total", (1e-4, 1e-5)),
                            ("total_sq", (1e-4, 1e-5)),
                            ("first", (1e-5, 1e-6)),
                            ("last", (1e-5, 1e-6))):
        assert np.allclose(got[f][layers], want[f][layers], rtol=rtol,
                           atol=atol), f


def assert_golden_close(got, want, layers=slice(0, 1)):
    for f in FIELDS:
        assert np.allclose(got[f][layers], want[f][layers], rtol=1e-4,
                           atol=1e-5), (f, np.abs(got[f] - want[f]).max())


@pytest.mark.parametrize("n_tile,n_spp",
                         [(8, 1), (4, 1), (4, 2), (2, 4), (1, 8), (2, 2)])
def test_sharded_matches_single_device(cube, n_tile, n_spp):
    """Tile-only meshes are bit-identical to the single-device render, spp
    meshes within the float-accumulation tolerance; the ray count is the
    exact sum; each matches the JAX package's mesh of the same shape."""
    host, js, ts = cube
    fov = host.cam.fov_x
    cfg = RenderConfig(**cfg16())
    sres, want = single(ts, cfg, fov)
    res, got, _ = run_mesh(ts, cfg, fov, n_tile, n_spp)
    assert res.rays_cast == sres.rays_cast
    assert res.alive_counts == sres.alive_counts
    if n_spp == 1:
        for f in FIELDS:
            assert np.array_equal(got[f], want[f]), f
    else:
        assert_spp_close(got, want)
    assert np.array_equal(got["count"], want["count"])
    jrays, jgot = run_jax_mesh(js, JRenderConfig(**cfg16()), fov, n_tile,
                               n_spp)
    assert jrays == res.rays_cast
    assert_golden_close(got, jgot)


def test_sharded_multiple_steps(cube):
    """Two steps: a tile-only mesh stays bit-identical to one device, an
    spp mesh within tolerance; both against the JAX meshes."""
    host, js, ts = cube
    fov = host.cam.fov_x
    cfg = RenderConfig(**cfg16(samples=8, samples_per_step=4))
    _, want = single(ts, cfg, fov)
    _, got, _ = run_mesh(ts, cfg, fov, 8, 1, steps=2)
    assert np.all(got["count"] == 8)
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f
    _, jgot = run_jax_mesh(js, JRenderConfig(**cfg16(samples_per_step=4)),
                           fov, 8, 1, steps=2)
    assert_golden_close(got, jgot)
    _, got, _ = run_mesh(ts, cfg, fov, 4, 2, steps=2)
    assert np.all(got["count"] == 8)
    assert_spp_close(got, want)


def test_divisibility_errors(cube):
    host, _, ts = cube
    mesh = pmesh.make_mesh(n_tile=2, n_spp=4, devices=CPU8)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.make_sharded_render_step(
            RenderConfig(width=16, height=16, samples_per_step=3), 1.0, mesh,
            pmesh.replicate_scene(ts, mesh))


def test_mesh_needs_its_devices(cube):
    """make_mesh refuses a mesh larger than its devices, and the sharded
    step a scene without a copy on every mesh device."""
    with pytest.raises(ValueError, match="needs 6 devices; 4 given"):
        pmesh.make_mesh(n_tile=3, n_spp=2, devices=["cpu"] * 4)
    mesh = pmesh.make_mesh(n_tile=2, devices=["cpu", "meta"])
    assert mesh.shape == {"tile": 2, "spp": 1}
    assert mesh.distinct == (torch.device("cpu"), torch.device("meta"))
    _, _, ts = cube
    with pytest.raises(ValueError, match="no copy on meta"):
        pmesh.make_sharded_render_step(RenderConfig(**cfg16()), 1.0, mesh,
                                       pmesh.ReplicatedScene(
                                           {torch.device("cpu"): ts}))


def test_padded_height_matches_single_device(cube):
    """H = 37 over 4 tiles pads to 40 rows; the crop is bit-identical to
    the single-device render and matches the JAX mesh of the same shape
    (the padded rows' rays count in both packages)."""
    host, js, ts = cube
    fov = host.cam.fov_x
    cfg = RenderConfig(**cfg16(height=37, samples=4, samples_per_step=4))
    assert pmesh.padded_height(37, 4) == 40
    _, want = single(ts, cfg, fov)
    res, got, step = run_mesh(ts, cfg, fov, 4, 1)
    assert step.h_local == 10 and got["total"].shape == (1, 37, 16, 3)
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f
    jrays, jgot = run_jax_mesh(
        js, JRenderConfig(**cfg16(height=37, samples_per_step=4)), fov, 4, 1)
    assert jrays == res.rays_cast
    assert_golden_close(got, jgot)


def test_stats_stay_sharded(cube):
    """Each tile's row block lives on its tile's device across steps, and
    the fields read as the whole frame."""
    host, _, ts = cube
    cfg = RenderConfig(**cfg16())
    mesh = pmesh.make_mesh(n_tile=8, devices=CPU8)
    rs = pmesh.replicate_scene(ts, mesh)
    assert list(rs) == [torch.device("cpu")] and rs[rs.device] is ts
    stats = pmesh.shard_stats(accum.init_stats(1, 16, 16, device="cpu"),
                              mesh)
    step = pmesh.make_sharded_render_step(cfg, host.cam.fov_x, mesh, rs)
    out, info = step(rs, stats, prng.key_from_seed(0), 0)
    assert out is stats and len(out.blocks) == 8
    assert {tuple(b.total.shape) for b in out.blocks} == {(1, 2, 16, 3)}
    assert out.total.shape == (1, 16, 16, 3)
    assert torch.equal(out.gather().count, out.count)
    assert info.dtype == torch.int64 and int(info[0]) > 0


def test_sharded_aov_layers(cube):
    """AOV layers accumulate on the mesh as on one device (4 x 2 mesh,
    every layer at the spp tolerance) and as on the JAX mesh."""
    host, js, ts = cube
    fov = host.cam.fov_x
    kw = cfg16(debug_features=True, samples=4, samples_per_step=4)
    cfg = RenderConfig(**kw)
    sres, want = single(ts, cfg, fov)
    res, got, _ = run_mesh(ts, cfg, fov, 4, 2)
    assert res.rays_cast == sres.rays_cast
    layers = slice(0, 10)
    assert got["total"].shape == (10, 16, 16, 3)
    for f in ("total", "first", "last", "total_sq"):
        assert np.allclose(got[f], want[f], rtol=1e-4, atol=1e-5), f
    assert np.all(got["count"] == 4)
    jrays, jgot = run_jax_mesh(js, JRenderConfig(**kw), fov, 4, 2)
    assert jrays == res.rays_cast
    assert_golden_close(got, jgot, layers)


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    return _load("cornell", tmp_path_factory.mktemp("cornell_mesh"))


@pytest.mark.parametrize("row_offset,n_rows", [(0, 9), (9, 9), (27, 9),
                                               (13, 20)])
def test_compacted_shard_stream_base(cornell, row_offset, n_rows):
    """A "pallas" compacted row shard (trace with stream_base) draws what
    the full compacted frame draws for its pixels: its rows are bit-equal
    to the same rows of the full frame, with the same stream ids carried
    through the sorts or promised by stream_base."""
    host, sc = cornell
    fov = host.cam.fov_x
    w, h = 24, 36
    key = prng.key_from_seed(3)
    opts = TraceOptions(depth=4, intersector="pallas",
                        lane_schedule=(1024,) * 3)
    full, fa = runtime.sample_pass(sc, key, 1, fov, w, h, opts)
    assert int(fa["overflow"]) == 0
    part, aux = runtime.sample_pass(sc, key, 1, fov, w, h, opts,
                                    row_offset=row_offset, n_rows=n_rows)
    assert int(aux["overflow"]) == 0
    assert torch.equal(part, full[row_offset:row_offset + n_rows])
    # the same shard, its stream ids carried through the sorts
    o, d = runtime.camera_rays(sc, key, 1, fov, w, h, row_offset, n_rows)
    sids = runtime._stream_ids(w, row_offset, n_rows, sc.device)
    from raytracer_odin_tpu_torch.ops.integrator import trace

    carried, _ = trace(sc, o, d, key, 1, opts, stream_ids=sids)
    assert torch.equal(carried, part)


def test_compacted_shard_matches_jax(cube):
    """The compacted shard against the JAX package's sample_pass of the
    same rows (its compacted trace under the stream_base promise)."""
    host, js, ts = cube
    fov = host.cam.fov_x
    w, h, r0, nr = 16, 16, 5, 7
    from raytracer_odin_tpu.ops.integrator import TraceOptions as JOpts

    jr, ja = jax.jit(lambda k: jruntime.sample_pass(
        js, k, jnp.int32(2), fov, w, h,
        JOpts(depth=2, intersector="pallas", lane_schedule=(512,)),
        row_offset=r0, n_rows=nr))(jax.random.PRNGKey(0))
    tr, ta = runtime.sample_pass(
        ts, prng.key_from_seed(0), 2, fov, w, h,
        TraceOptions(depth=2, intersector="pallas", lane_schedule=(512,)),
        row_offset=r0, n_rows=nr)
    assert int(ta["rays_cast"]) == int(ja["rays_cast"])
    assert np.allclose(tr.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5)


def test_compacted_mesh_bit_equal_and_overflow(cornell, capsys):
    """A "pallas" tile mesh with compact="auto" calibrates each tile's own
    budgets and is bit-identical to the single-device compacted render; an
    explicit schedule that overflows redoes the whole mesh uncompacted,
    equal to the uncompacted render."""
    host, sc = cornell
    fov = host.cam.fov_x
    cfg = RenderConfig(width=24, height=36, ray_depth=4, samples=2,
                       samples_per_step=2, intersector="pallas",
                       compact="auto")
    sres, want = single(sc, cfg, fov)
    assert sres.lane_schedule is not None
    res, got, step = run_mesh(sc, cfg, fov, 3, 1)
    assert len(step.lane_schedule) == 3 == len(res.lane_schedule)
    assert all(len(s) == 3 for s in step.lane_schedule)
    assert res.overflow == 0 and res.rays_cast == sres.rays_cast
    for f in FIELDS:
        assert np.array_equal(got[f], want[f]), f
    # 48 x 48 over two tiles: 1,152 lanes a tile, most alive at bounce 1
    tight = cfg.replace(width=48, height=48, compact="off",
                        compact_schedule=(512,) * 3)
    res, got, _ = run_mesh(sc, tight, fov, 2, 1)
    assert "re-rendering uncompacted" in capsys.readouterr().out
    assert res.overflow > 0 and res.lane_schedule is None
    _, off = single(sc, tight.replace(compact_schedule=None), fov)
    for f in FIELDS:
        assert np.array_equal(got[f], off[f]), f
