"""Parity of the port's big-scene and brute paths with the JAX package's, on
the CPU: the bundle-interval cull and nearest-first lists, the two-level
exact layout (g > 1) with capped and chunk-major lists, the streamed sweep
(plain K4) and the brute sweep (plain K3), the scene build of city and
citynight, and small renders of citynight, city, a streamed scene and the
brute intersector. The Pallas kernels run in interpret mode.

Gates. Masks, counts, lists, hit indices and scene arrays are compared bit
for bit, except the order of list entries at equal `near`: the JAX package
sorts them with an unstable sort, the port by ascending id, so lists are
compared as the set of ids per row and the near keys in list order. Hit t
agrees within T_RTOL (XLA's CPU backend fuses multiply-adds;
tests/test_torch_kernels.py). Renders: cube and cornell at the golden
tolerance; citynight and city at the glossy-scene gate of
tests/test_torch_render.py (citynight's light pdf is the culled sum in the
port and the dense sum in JAX's CPU trace: the same terms in another
association), with equal live-lane and ray counts."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.ops import culling as jcull
from raytracer_odin_tpu.ops import pallas_intersect as jpi
from raytracer_odin_tpu.ops import traverse as jtrav
from raytracer_odin_tpu.ops.integrator import TraceOptions as JTraceOptions
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.io import gltf as tgltf
from raytracer_odin_tpu_torch.models import assets as tassets
from raytracer_odin_tpu_torch.models import build as tbuild
from raytracer_odin_tpu_torch.models.scene import (
    HostMaterial as THostMaterial,
    HostScene as THostScene,
)
from raytracer_odin_tpu_torch.ops import culling as tcull
from raytracer_odin_tpu_torch.ops import pallas_intersect as tpi
from raytracer_odin_tpu_torch.ops import traverse as ttrav
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.render import runtime as truntime
from raytracer_odin_tpu_torch.utils import prng
from tests.conftest import random_triangles
from tests.test_bvh import make_scene
from tests.test_torch_render import GOLDEN_ATOL, GOLDEN_RTOL, _near
from tests.torch_parity import torch_scene

T_RTOL, T_ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_hits(jt, ji, tt, ti):
    ji, ti = np.asarray(ji), ti.numpy()
    assert np.array_equal(ji, ti)
    assert np.allclose(np.asarray(jt), tt.numpy(), rtol=T_RTOL, atol=T_ATOL)


def _rays(rng, n, spread=8):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _same_lists(jc, jl, tc, tl, near, offset=0):
    """Equal counts; per row the same ids among the first `count` entries
    and the same near keys in list order (ties may be ordered apart)."""
    jc, jl, tc, tl = (np.asarray(x) for x in (jc, jl, tc, tl))
    near = np.asarray(near)
    assert np.array_equal(jc, tc)
    for r, k in enumerate(jc):
        if k < 0:
            continue
        a, b = jl[r, :k] + offset, tl[r, :k]
        assert np.array_equal(np.sort(a), np.sort(b)), r
        assert np.array_equal(near[r, a], near[r, b]), r


def _host(p, u, v):
    """The port's HostScene of tests/test_bvh.py's make_scene."""
    host = THostScene()
    n = p.shape[0]
    ng = np.cross(u, v)
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-20)
    host.p, host.u, host.v, host.ng = p, u, v, ng.astype(np.float32)
    host.n1 = host.n2 = host.n3 = ng.astype(np.float32)
    host.tex1 = host.tex2 = host.tex3 = np.zeros((n, 2), np.float32)
    host.tan1 = host.tan2 = host.tan3 = np.zeros((n, 4), np.float32)
    host.mat_index = np.zeros(n, np.int32)
    host.materials = [THostMaterial()]
    return host


def _bundles(rng, nb, c):
    """Block bounds of `nb` bundles and `c` cluster boxes, with zero and
    touching-zero direction intervals (axis-parallel bundles) and origins
    inside boxes (near clamps to 0: ties)."""
    clo = rng.uniform(-8, 8, (c, 3)).astype(np.float32)
    chi = clo + rng.uniform(0.5, 4, (c, 3)).astype(np.float32)
    o_lo = rng.uniform(-9, 9, (nb, 3)).astype(np.float32)
    o_hi = o_lo + rng.uniform(0, 1.5, (nb, 3)).astype(np.float32)
    d_lo = rng.uniform(-1, 1, (nb, 3)).astype(np.float32)
    d_hi = d_lo + rng.uniform(0, 0.4, (nb, 3)).astype(np.float32)
    d_lo[0:4, 1] = d_hi[0:4, 1] = 0.0
    d_lo[4:8, 0] = 0.0
    d_hi[8:12, 2] = 0.0
    o_lo[12:20] = clo[:8] + 0.1
    o_hi[12:20] = clo[:8] + 0.2
    return o_lo, o_hi, d_lo, d_hi, clo, chi


def test_block_bounds_match():
    rng = np.random.default_rng(1)
    o, d = _rays(rng, 2048)
    rows, _, _ = jpi.pack_rays(jnp.asarray(o), jnp.asarray(d))
    for block in (256, 512):
        want = jcull.block_bounds(jnp.asarray(o), jnp.asarray(d), block)
        got = tcull.block_bounds(_t(o), _t(d), block)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b.numpy())
        want = jcull.block_bounds_rows(rows, block)
        got = tcull.block_bounds_rows(_t(rows), block)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b.numpy())


def test_cull_clusters_and_lists_match():
    """cull_clusters bit-equal (mask and clamped near, axis-parallel
    overlap rule included); build_lists(near=) nearest-first with the same
    counts, ids and near keys, capped (count -1) and uncapped."""
    rng = np.random.default_rng(2)
    args = _bundles(rng, 40, 300)
    jm, jn = jcull.cull_clusters(*(jnp.asarray(a) for a in args))
    tm, tn = tcull.cull_clusters(*(_t(a) for a in args))
    assert np.array_equal(np.asarray(jm), tm.numpy())
    assert np.array_equal(np.asarray(jn), tn.numpy())
    jm_, tn_ = np.asarray(jm), tn.numpy()
    assert 0 < jm_.mean() < 0.9
    assert (jm_ & (tn_ == 0)).sum(-1).max() > 1  # near ties at 0
    assert jm_[0:4].sum() < jm_[20:24].sum()  # the overlap rule bites
    for cap in (None, 256, 20):
        jc, jl = jcull.build_lists(jm, cap=cap, near=jn)
        tc, tl = tcull.build_lists(tm, cap=cap, near=tn)
        assert jl.shape == tuple(tl.shape)
        _same_lists(jc, jl, tc, tl, tn_)
        for r, k in enumerate(tc.numpy()):
            if k > 1:
                keys = tn_[r, tl.numpy()[r, :k]]
                assert (np.diff(keys) >= 0).all()


def test_chunk_major_lists_match_chunks():
    """The uncapped chunk-major list of one row holds, chunk after chunk,
    JAX's per-chunk nearest-first list (traverse._sweep_exact's chunks)."""
    rng = np.random.default_rng(3)
    args = _bundles(rng, 30, 200)
    jm, jn = jcull.cull_clusters(*(jnp.asarray(a) for a in args))
    tm, tn = tcull.cull_clusters(*(_t(a) for a in args))
    chunk = 48
    tc, tl = tcull.build_lists(tm, near=tn, chunk=chunk)
    tc_, tl_ = tc.numpy(), tl.numpy()
    for a in range(0, 200, chunk):
        b = min(200, a + chunk)
        jc, jl = jcull.build_lists(jm[:, a:b], cap=None, near=jn[:, a:b])
        jc, jl = np.asarray(jc), np.asarray(jl)
        seg_c = np.zeros_like(jc)
        seg_l = np.zeros_like(jl)
        for r in range(tl_.shape[0]):
            ids = tl_[r, :tc_[r]]
            seg = ids[(ids >= a) & (ids < b)]
            seg_c[r] = len(seg)
            seg_l[r, :len(seg)] = seg
            first = np.searchsorted(ids // chunk, a // chunk)
            assert np.array_equal(ids[first:first + len(seg)], seg)
        _same_lists(jc, jl, seg_c, seg_l, np.asarray(jn), offset=a)


def _two_level_pair(monkeypatch, rng, n_tri, max_exact):
    monkeypatch.setattr(jtrav, "MAX_EXACT_CLUSTERS", max_exact)
    monkeypatch.setattr(ttrav, "MAX_EXACT_CLUSTERS", max_exact)
    p, u, v = random_triangles(rng, n_tri)
    js = make_scene(p, u, v)
    return js, torch_scene(js)


@pytest.mark.parametrize("chunked", [False, True])
def test_two_level_cast_matches(monkeypatch, chunked):
    """g > 1 (MAX_EXACT_CLUSTERS lowered to 4 in both packages): super
    masks, interval refine, nearest-first lists; one capped list (at most
    CHUNK_TRIS / LEAF clusters) or, with the chunk size lowered, JAX's
    chunked sweep against the port's single chunk-major sweep. Tiled and
    sorted casts, hits bit-equal."""
    rng = np.random.default_rng(5)
    js, ts = _two_level_pair(monkeypatch, rng, 1100, 4)  # 18 clusters
    g, n_super, aabb8 = jtrav.exact_cull_layout(js)
    tg, tns, taabb8 = ttrav.exact_cull_layout(ts)
    assert (g, n_super) == (tg, tns) == (5, 4)
    assert np.array_equal(np.asarray(aabb8), taabb8.numpy())
    if chunked:
        monkeypatch.setenv("RT_TPU_CHUNK_TRIS", str(5 * jpi.LEAF))
        monkeypatch.setattr(tpi, "CHUNK_TRIS", 5 * tpi.LEAF)
    h, w = 40, 40
    o = rng.uniform(-8, 8, (h, w, 3)).astype(np.float32)
    d = rng.normal(size=(h, w, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o), jnp.asarray(d))
    tt, ti = ttrav.cast_rays_pallas(ts, _t(o), _t(d))
    assert (np.asarray(ji) >= 0).sum() > 300
    _same_hits(jt, ji, tt, ti)
    o2, d2 = o.reshape(-1, 3), d.reshape(-1, 3)
    alive = rng.random(h * w) < 0.8
    jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o2), jnp.asarray(d2),
                                          sort=True, alive=jnp.asarray(alive))
    tt, ti = ttrav.cast_rays_pallas(ts, _t(o2), _t(d2), sort=True,
                                    alive=_t(alive))
    _same_hits(jt, ji, tt, ti)


def test_chunk_major_lists_are_uncapped(monkeypatch):
    """Above CHUNK_TRIS the lists are uncapped (no count -1) and ordered
    chunk-major; at or below it they are capped at 256 and nearest-first."""
    rng = np.random.default_rng(6)
    _, ts = _two_level_pair(monkeypatch, rng, 1100, 4)
    g, n_super, aabb8 = ttrav.exact_cull_layout(ts)
    o, d = _rays(rng, 1024, spread=9)
    rays, _, _ = tpi.pack_rays(_t(o), _t(d))
    words = tpi.cluster_masks_rows(aabb8, rays, n_super)
    c, lst = ttrav.sweep_lists(ts, words, rays, g, n_super, cap=3)
    assert lst.shape == (4, 3) and (c == -1).any()
    monkeypatch.setattr(tpi, "CHUNK_TRIS", 5 * tpi.LEAF)
    c, lst = ttrav.sweep_lists(ts, words, rays, g, n_super, cap=3)
    assert lst.shape == (4, 18) and (c > 3).any() and (c >= 0).all()
    for r, k in enumerate(c.tolist()):
        assert (np.diff(lst[r, :k].numpy() // 5) >= 0).all()


def _streamed_pair(monkeypatch, rng, max_exact):
    """(JAX scene, port scene) of 700 random triangles, the streaming
    threshold (and MAX_EXACT_CLUSTERS) lowered in both packages before the
    build: the port's own build decides `stream`."""
    monkeypatch.setattr(jtrav, "MAX_EXACT_CLUSTERS", max_exact)
    monkeypatch.setattr(ttrav, "MAX_EXACT_CLUSTERS", max_exact)
    p, u, v = random_triangles(rng, 700)
    monkeypatch.setenv("RT_TPU_STREAM_TRIS", "1")
    monkeypatch.setattr(tpi, "STREAM_TRIS", 1)
    js = make_scene(p, u, v)
    assert js.ptri.shape[1] == 128
    arrays, statics = tbuild.scene_arrays(_host(p, u, v))
    assert statics["stream"] and arrays["ptri"].shape[1] == 12
    assert np.array_equal(arrays["ptri"], np.asarray(js.ptri)[:, :12])
    ts = tbuild.finish_scene(_host(p, u, v), device="cpu")
    assert ts.stream and tpi.list_block(ts) == tpi.RB
    return js, ts


@pytest.mark.parametrize("max_exact, cap", [
    pytest.param(256, None, id="256"), pytest.param(4, None, id="4"),
    pytest.param(4, 3, id="4-cap3")])
def test_streamed_cast_matches(monkeypatch, max_exact, cap):
    """The streamed sweep (plain K4, one list per RB-ray block) against
    JAX's DMA-streamed kernel, the threshold lowered in both before the
    scene build: the port's own build decides `stream` and keeps the JAX
    rows' first 12 columns; hits bit-equal, g == 1 and g > 1. With the
    list cap lowered to `cap` in both packages (g > 1), most blocks
    overflow: JAX sweeps every cluster for them, the port its uncapped
    ascending-id lists (traverse._sweep_exact), and the hits are the
    same."""
    rng = np.random.default_rng(7)
    js, ts = _streamed_pair(monkeypatch, rng, max_exact)
    if cap is None:
        o, d = _rays(rng, 1500)
    else:
        # a pinhole camera's 64 x 64 rays, tiled: each 512-ray block sees
        # part of the scene
        for mod in (jtrav, ttrav):
            monkeypatch.setattr(mod, "_sweep_exact", functools.partial(
                mod._sweep_exact, cap=cap))
        y, x = np.meshgrid(np.linspace(-0.5, 0.5, 64),
                           np.linspace(-0.5, 0.5, 64), indexing="ij")
        d = np.stack([x, y, np.ones_like(x)], -1).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.broadcast_to(np.float32([0, 0, -12]), d.shape).copy()
    lists = []
    real = tpi.intersect_stream_rows
    monkeypatch.setattr(tpi, "intersect_stream_rows",
                        lambda *a: lists.append(a[1:3]) or real(*a))
    jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o), jnp.asarray(d))
    tt, ti = ttrav.cast_rays_pallas(ts, _t(o), _t(d))
    assert lists and (np.asarray(ji) >= 0).sum() > 200
    _same_hits(jt, ji, tt, ti)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    alive = rng.random(o.shape[0]) < 0.7
    jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o), jnp.asarray(d),
                                          sort=True, alive=jnp.asarray(alive))
    tt, ti = ttrav.cast_rays_pallas(ts, _t(o), _t(d), sort=True,
                                    alive=_t(alive))
    _same_hits(jt, ji, tt, ti)
    if cap is not None:
        counts = torch.cat([c for c, _ in lists])
        n_clusters = ts.cluster_lo.shape[0]
        over = counts > cap
        assert (counts >= 0).all() and over.float().mean() > 0.5
        # some overflowing list is shorter than the sweep of every cluster
        assert (counts[over] < n_clusters).any()


def test_streamed_overflow_lists(monkeypatch):
    """sweep_lists of a streamed scene at g > 1 (MAX_EXACT_CLUSTERS 4),
    cap 3: a row beyond the cap lists exactly its block mask's clusters in
    ascending id order with its true count; every other row is
    build_lists(cap, near)'s; and plain K4 over the new lists is bit-equal
    to plain K4 over the capped ones (count -1 beyond the cap)."""
    rng = np.random.default_rng(17)
    cap = 3
    _, ts = _streamed_pair(monkeypatch, rng, 4)
    g, n_super, aabb8 = ttrav.exact_cull_layout(ts)
    n_clusters = ts.cluster_lo.shape[0]
    assert g > 1
    o, d = _rays(rng, 16 * tpi.RB)
    rays, _, _ = tpi.pack_rays(_t(o), _t(d))
    words = tpi.cluster_masks_rows(aabb8, rays, n_super)
    # lanes sorted by mask word, as the main path sorts them
    perm = torch.sort(words[0], stable=True).indices
    rays, words = rays[:, perm].contiguous(), words[:, perm].contiguous()
    c, lst = ttrav.sweep_lists(ts, words, rays, g, n_super, cap=cap)
    # the block masks, as sweep_lists starts from them
    smask = tcull.unpack_mask(tcull.or_blocks_packed(words, tpi.RB), n_super)
    imask, near = tcull.cull_clusters(
        *tcull.block_bounds_rows(rays, tpi.RB), ts.cluster_lo, ts.cluster_hi)
    bmask = smask.repeat_interleave(g, dim=1)[:, :n_clusters] & imask
    over = c > cap
    assert 0 < int(over.sum()) < c.numel()
    assert (c[over] < n_clusters).any()
    assert torch.equal(c, bmask.sum(-1).to(torch.int32))
    assert lst.shape == (c.numel(), int(c.max()))
    c0, lst0 = tcull.build_lists(bmask, cap=cap, near=near)
    assert torch.equal(c0, torch.where(over, -1, c))
    for r in range(c.numel()):
        k = int(c[r])
        if over[r]:
            ids = torch.nonzero(bmask[r])[:, 0].to(torch.int32)
            assert torch.equal(lst[r, :k], ids)
        else:
            assert torch.equal(lst[r, :k], lst0[r, :k])
    got = tpi.intersect_stream_rows(ts.ptri, c, lst, rays)
    want = tpi.intersect_stream_rows(ts.ptri, c0, lst0, rays)
    assert int((want[1] >= 0).sum()) > 500
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_stream_plain_matches_pallas(monkeypatch):
    """Plain K4 against JAX's stream kernel on given lists: shuffled lists,
    an overflow (-1) block and an empty block."""
    rng = np.random.default_rng(11)
    p, u, v = random_triangles(rng, 700)
    monkeypatch.setenv("RT_TPU_STREAM_TRIS", "1")
    tris = jpi.pad_triangles(p, u, v)
    assert tris.shape[1] == 128
    o = rng.uniform(-6, 6, (2048, 3)).astype(np.float32)
    # aimed near (not at) triangle corners: a ray through a corner or an
    # edge hits or misses by the rounding of fused multiply-adds
    d = (p[rng.integers(0, 700, 2048)] + 0.3 * u[rng.integers(0, 700, 2048)]
         - o)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rows, _, _ = jpi.pack_rays(jnp.asarray(o), jnp.asarray(d))
    nc = tris.shape[0] // jpi.LEAF
    counts = rng.integers(0, nc + 1, 4).astype(np.int32)
    counts[1], counts[2] = -1, 0
    lists = np.stack([rng.permutation(nc) for _ in range(4)]).astype(np.int32)
    want = np.asarray(jpi.intersect_culled_rows(
        jnp.asarray(tris), jnp.asarray(counts), jnp.asarray(lists), rows))
    got = tpi.intersect_stream_rows(_t(tris[:, :12]), _t(counts), _t(lists),
                                    _t(rows)).numpy()
    assert (want[1] >= 0).sum() > 500
    assert np.array_equal(got[1:], want[1:])
    assert np.allclose(got[0], want[0], rtol=T_RTOL, atol=T_ATOL)


def test_brute_matches():
    """Plain K3 against JAX's intersect_brute, and equal to the sweep with
    every count -1; cast_rays(intersector="pallas_brute") on a tiled batch
    against JAX's."""
    rng = np.random.default_rng(13)
    p, u, v = random_triangles(rng, 500)
    js = make_scene(p, u, v)
    ts = torch_scene(js)
    o, d = _rays(rng, 1100)
    oo = o + d * 1e-3
    jt, ji, _, _ = jpi.intersect_brute(js.ptri, jnp.asarray(oo),
                                       jnp.asarray(d))
    tt, ti = tpi.intersect_brute(ts.ptri, _t(oo), _t(d))
    assert (np.asarray(ji) >= 0).sum() > 100
    _same_hits(jt, ji, tt, ti)
    rows, _, _ = tpi.pack_rays(_t(oo), _t(d))
    nb = rows.shape[1] // tpi.RB
    every = tpi.intersect_stream_rows(
        ts.ptri, torch.full((nb,), -1, dtype=torch.int32),
        torch.zeros((nb, 1), dtype=torch.int32), rows)
    assert torch.equal(every, tpi.intersect_brute_rows(ts.ptri, rows))
    h, w = 24, 40
    o = rng.uniform(-8, 8, (h, w, 3)).astype(np.float32)
    d = rng.normal(size=(h, w, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jt, ji, _, _ = jtrav.cast_rays(js, jnp.asarray(o), jnp.asarray(d),
                                   intersector="pallas_brute")
    tt, ti = ttrav.cast_rays(ts, _t(o), _t(d), intersector="pallas_brute")
    assert ti.shape == (h, w)
    _same_hits(jt, ji, tt, ti)


@pytest.fixture(scope="module")
def city_scenes(tmp_path_factory):
    """(JAX scene, port host) of citynight and city (blocks 12)."""
    out = {}
    for name in ("citynight", "city"):
        d = tmp_path_factory.mktemp(name)
        jhost = jgltf.read_gltf(jassets.generate(name, d / "jax")["gltf"])
        thost = tgltf.read_gltf(tassets.generate(name, d / "torch")["gltf"])
        out[name] = (jhost, jbuild.finish_scene(jhost), thost)
    return out


@pytest.mark.parametrize("name,n_tri,n_lights,layout", [
    ("citynight", 3458, 1728, (1, 55, 2)),
    ("city", 51858, 4, (4, 203, 7)),
])
def test_city_scene_build_matches(city_scenes, name, n_tri, n_lights,
                                  layout):
    """finish_scene on citynight and city: the light rows, light-cluster
    and cluster AABBs and the triangle rows equal the JAX builder's; the
    exact layout (g, n_super, mask words) as the JAX package computes it."""
    jhost, js, thost = city_scenes[name]
    arrays, statics = tbuild.scene_arrays(thost)
    assert arrays["tri_p"].shape[0] == n_tri
    assert arrays["light_p"].shape[0] == n_lights
    assert not statics["stream"] and np.asarray(js.ptri).shape[1] == 12
    for f in ("light_rows", "light_cluster_lo", "light_cluster_hi",
              "cluster_lo", "cluster_hi", "ptri"):
        want = np.asarray(getattr(js, f))
        assert arrays[f].shape == want.shape, f
        assert np.array_equal(arrays[f], want), f
    ts = tbuild.finish_scene(thost, device="cpu")
    g, n_super, aabb8 = ttrav.exact_cull_layout(ts)
    assert (g, n_super, aabb8.shape[0] // 32) == layout
    jg, jns, jaabb8 = jtrav.exact_cull_layout(js)
    assert (jg, jns) == (g, n_super)
    assert np.array_equal(np.asarray(jaabb8), aabb8.numpy())


def test_city24_is_streamed(tmp_path):
    """city with blocks=24 is the smallest repo scene above STREAM_TRIS at
    the default threshold: 207,234 triangles, streamed, g = 13."""
    tassets.make_city_scene(tmp_path / "city24.gltf", blocks=24)
    host = tgltf.read_gltf(str(tmp_path / "city24.gltf"))
    ts = tbuild.finish_scene(host, device="cpu")
    assert ts.num_triangles == 207234 and ts.ptri.shape == (207296, 12)
    assert ts.stream and tpi.list_block(ts) == tpi.RB
    g, n_super, aabb8 = ttrav.exact_cull_layout(ts)
    assert (g, n_super, aabb8.shape[0]) == (13, 250, 256)


def _sample(js, ts, fov, w, h, depth, schedule, intersector="pallas"):
    jr, ja = jax.jit(lambda k: jruntime.sample_pass(
        js, k, jnp.int32(0), fov, w, h,
        JTraceOptions(depth=depth, intersector=intersector,
                      lane_schedule=schedule)))(jax.random.PRNGKey(0))
    tr, ta = truntime.sample_pass(
        ts, prng.key_from_seed(0), 0, fov, w, h,
        TraceOptions(depth=depth, intersector=intersector,
                     lane_schedule=schedule))
    assert ta["alive_counts"].tolist() == np.asarray(ja["alive_counts"]).tolist()
    assert int(ta["rays_cast"]) == int(ja["rays_cast"])
    assert int(ta["overflow"]) == int(ja["overflow"]) == 0
    return np.asarray(jr), tr.numpy()


@pytest.mark.parametrize("name,w,h,depth", [
    ("citynight", 32, 32, 3),
    ("city", 24, 16, 3),
])
def test_city_render_matches_jax(city_scenes, name, w, h, depth):
    """A compacted sample of citynight (K5's path) and city (two-level,
    chunked: 811 clusters) through both packages, the lane budgets from the
    port's calibration: equal live lanes and rays, radiance within the
    glossy gate. render_scene runs the same config end to end."""
    jhost, js, thost = city_scenes[name]
    ts = tbuild.finish_scene(thost, device="cpu")
    fov = jhost.cam.fov_x * w / h
    cfg = RenderConfig(width=w, height=h, ray_depth=depth, samples=1,
                       samples_per_step=1, seed=0, intersector="pallas",
                       compact="auto")
    sched = truntime.auto_lane_schedule(ts, cfg, fov, device="cpu")
    jr, tr = _sample(js, ts, fov, w, h, depth, sched)
    assert (jr > 0).sum() > 20  # a dark scene at 1 spp, but not black
    _near(tr, jr)
    res = truntime.render_scene(ts, cfg, fov, device="cpu")
    assert res.overflow == 0 and res.lane_schedule == sched
    assert np.array_equal(res.stats.total[0].numpy(), tr)


def test_streamed_render_matches_jax(monkeypatch, tmp_path):
    """cornell with the streaming threshold lowered in both packages: a
    compacted sample at the golden tolerance through plain K4."""
    monkeypatch.setenv("RT_TPU_STREAM_TRIS", "1")
    monkeypatch.setattr(tpi, "STREAM_TRIS", 1)
    jhost = jgltf.read_gltf(jassets.generate("cornell", tmp_path)["gltf"])
    js = jbuild.finish_scene(jhost)
    ts = tbuild.finish_scene(
        tgltf.read_gltf(tassets.generate("cornell", tmp_path / "t")["gltf"]),
        device="cpu")
    assert js.ptri.shape[1] == 128 and ts.stream
    jr, tr = _sample(js, ts, jhost.cam.fov_x, 24, 24, 4, (1024,) * 3)
    assert np.allclose(tr, jr, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)


def test_brute_render_matches_jax(tmp_path):
    """intersector="pallas_brute" on cube: uncompacted as in JAX (no
    calibration, no lane schedule, compact="auto" notwithstanding), K3's
    plain version on every bounce, the image at the golden tolerance."""
    jhost = jgltf.read_gltf(jassets.generate("cube", tmp_path)["gltf"])
    js = jbuild.finish_scene(jhost)
    ts = torch_scene(js)
    fov = jhost.cam.fov_x
    jr, tr = _sample(js, ts, fov, 16, 16, 3, None, "pallas_brute")
    assert np.allclose(tr, jr, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    cfg = RenderConfig(width=16, height=16, ray_depth=3, samples=1,
                       samples_per_step=1, seed=0,
                       intersector="pallas_brute", compact="auto")
    res = truntime.render_scene(ts, cfg, fov, device="cpu")
    assert res.lane_schedule is None and res.overflow == 0
    assert np.array_equal(res.stats.total[0].numpy(), tr)
