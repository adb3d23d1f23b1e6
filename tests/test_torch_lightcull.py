"""Parity of the port's many-light pdf (ops/light_cull.py: light rows,
cluster AABBs, the bundle cull and the plain version of K5) with the JAX
package's, on the CPU. The Pallas kernel `light_cull._kernel` runs in
interpret mode, where its reciprocal is an exact division.

Tolerance: rtol=2e-4, atol=1e-6 with equal finiteness patterns, the JAX
package's own culled-vs-dense gate (tests/test_lightcull.py). The two sums
add the same terms in another association (the port adds a cluster's 32
terms in row order, XLA's reduction in a tree) and XLA's CPU backend fuses
the Moller-Trumbore products into multiply-adds. Light rows, AABBs, masks
and lists are compared bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.ops import light_cull as jlc
from raytracer_odin_tpu.ops import shading as jsh
from raytracer_odin_tpu_torch.ops import light_cull as tlc
from raytracer_odin_tpu_torch.ops import shading as tsh
from tests.test_lightcull import grid_light_scene
from tests.torch_parity import torch_scene
from tests.test_torch_smoke_sass import _chip_smoke

RTOL, ATOL = 2e-4, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(want, got):
    want, got = np.asarray(want), got.numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL), (
        np.abs(got[fin] - want[fin]).max())


def _down_rays(rng, n, lo, hi, dy=0.1):
    """Rays from a box above the scene, pointing downward."""
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - dy
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _coherent_rays(rng, n):
    """Near-vertical rays over one corner of the grid-light scene: each
    block's bundle meets a few of its 9 light clusters."""
    o = rng.uniform([0, 2.0, 0], [6, 6.0, 6], (n, 3)).astype(np.float32)
    # no direction interval straddles 0: every axis constrains the cull
    d = np.stack([0.2 + np.abs(rng.normal(0, 0.1, n)), -np.ones(n),
                  0.2 + np.abs(rng.normal(0, 0.1, n))], axis=-1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.fixture(scope="module")
def grid_pair():
    js = grid_light_scene(12, 12)  # 288 lights, 9 clusters of 32
    return js, torch_scene(js)


@pytest.fixture(scope="module")
def citynight_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("citynight")
    host = jgltf.read_gltf(jassets.generate("citynight", d)["gltf"])
    js = jbuild.finish_scene(host)
    return js, torch_scene(js)


def test_light_rows_and_aabbs_match():
    """pack_light_rows, light_cluster_aabbs and morton_order are the JAX
    package's, bit for bit (padding rows invalid, padding clusters
    collapsed to (BIG, -BIG))."""
    rng = np.random.default_rng(0)
    n = 77
    p, u, v, ng = (rng.normal(size=(n, 3)).astype(np.float32)
                   for _ in range(4))
    fac = rng.uniform(0.5, 3, n).astype(np.float32)
    want = jlc.pack_light_rows(p, u, v, ng, fac)
    got = tlc.pack_light_rows(p, u, v, ng, fac)
    assert got.shape == want.shape == (96, 16)
    assert np.array_equal(got, want)
    for a, b in zip(jlc.light_cluster_aabbs(want),
                    tlc.light_cluster_aabbs(got)):
        assert np.array_equal(a, b)
    c = rng.normal(size=(300, 3)).astype(np.float32)
    assert np.array_equal(jlc.morton_order(c), tlc.morton_order(c))


@pytest.mark.parametrize("cap", [128, 3])
def test_culled_pdf_matches_jax_grid(grid_pair, cap):
    """The grid-light scene of tests/test_lightcull.py: the port's culled
    sum equals JAX's, with lists short enough that blocks overflow (cap 3:
    count -1, every cluster swept) and with the default cap."""
    js, ts = grid_pair
    rng = np.random.default_rng(3)
    o, d = _down_rays(rng, 1100, [0, 2.0, 0], [24, 6.0, 24])
    counts, _, _, _ = tlc.light_lists(ts, _t(o), _t(d), cap=cap)
    assert counts.shape == (3,)
    if cap == 3:
        assert (counts == -1).any()
    want = jlc.light_pdf_sum_culled(js, jnp.asarray(o), jnp.asarray(d),
                                    cap=cap)
    got = tlc.light_pdf_sum_culled(ts, _t(o), _t(d), cap=cap)
    assert np.isfinite(np.asarray(want)).mean() > 0.9
    assert (np.asarray(want) > 0).sum() > 50  # the rays really hit lights
    _close(want, got)
    # and the port's culled sum agrees with its dense sum
    _close(tsh.light_pdf_sum(ts, _t(o), _t(d)).numpy(), got)


def test_light_lists_match_jax(grid_pair):
    """The bundle cull of the light clusters: counts and ascending lists
    bit-equal to the JAX package's (block_bounds + cull_clusters +
    build_lists at cap 128) on full blocks. The padded last block: the
    port leaves the padding lanes out of its bounds, so its list is a
    subset of JAX's (whose padding lanes widen the bounds to BIG)."""
    from raytracer_odin_tpu.ops import culling as jcull
    from raytracer_odin_tpu.ops.geometry import RAY_EPS

    js, ts = grid_pair
    rng = np.random.default_rng(8)
    n = 1300  # three blocks, the last one padded
    o, d = _coherent_rays(rng, n)
    oo = jnp.asarray(o) + jnp.asarray(d) * RAY_EPS
    npad = 3 * 512
    o_p = jnp.pad(oo, ((0, npad - n), (0, 0)), constant_values=jcull.BIG)
    d_p = jnp.pad(jnp.asarray(d), ((0, npad - n), (0, 0)))
    mask, _ = jcull.cull_clusters(*jcull.block_bounds(o_p, d_p),
                                  js.light_cluster_lo, js.light_cluster_hi)
    jc, jl = (np.asarray(x) for x in jcull.build_lists(mask, cap=128))
    tc, tl, rays, tn = tlc.light_lists(ts, _t(o), _t(d))
    tc, tl = tc.numpy(), tl.numpy()
    assert tn == n and rays.shape == (8, npad)
    assert np.array_equal(jc[:2], tc[:2]) and (tc[:2] < 9).all()
    assert np.array_equal(jl[:2], tl[:2])
    assert 0 < tc[2] < jc[2]
    assert set(tl[2, :tc[2]]) < set(jl[2, :jc[2]])


def test_unread_lanes_leave_bounds(grid_pair):
    """Lanes with NaN origins or directions (dead lanes of an uncompacted
    trace) and missed rays' far points share blocks with real lanes: the
    real lanes' culled sums still equal the dense sums (JAX's culled
    bounds turn NaN there and drop the whole block)."""
    js, ts = grid_pair
    rng = np.random.default_rng(9)
    o, d = _coherent_rays(rng, 1024)
    junk = np.zeros(1024, bool)
    junk[::7] = True
    o[::7][::2] = np.nan
    d[1::7][:40] = np.nan
    junk[1::7][:40] = True
    o[3::7] = d[3::7] * 3.0e38
    junk[3::7] = True
    got = tlc.light_pdf_sum_culled(ts, _t(o), _t(d)).numpy()
    dense = np.asarray(jsh.light_pdf_sum(js, jnp.asarray(o), jnp.asarray(d)))
    real = ~junk
    assert (dense[real] > 0).sum() > 30
    _close(dense[real], torch.from_numpy(got[real]))
    counts, _, _, _ = tlc.light_lists(ts, _t(o), _t(d))
    assert (counts.numpy() < 9).all()  # the cull still culls


def test_culled_pdf_matches_jax_citynight(citynight_pair):
    """citynight (1,728 window lights in 54 clusters) with rays like
    tests/test_lightcull.py's over the city."""
    js, ts = citynight_pair
    assert ts.light_rows.shape == (1728, 16)
    rng = np.random.default_rng(2)
    o, d = _down_rays(rng, 600, [-20, 3, -20], [20, 10, 20], dy=0.2)
    # and rays from the street toward the lit +x/+z faces
    o2 = rng.uniform([-20, 0.5, -20], [20, 6, 20], (424, 3)).astype(
        np.float32)
    d2 = rng.normal(size=(424, 3))
    d2[:, 0] = -np.abs(d2[:, 0])
    d2[:, 2] = -np.abs(d2[:, 2])
    d2 = (d2 / np.linalg.norm(d2, axis=-1, keepdims=True)).astype(np.float32)
    o, d = np.concatenate([o, o2]), np.concatenate([d, d2])
    want = jlc.light_pdf_sum_culled(js, jnp.asarray(o), jnp.asarray(d))
    got = tlc.light_pdf_sum_culled(ts, _t(o), _t(d))
    assert (np.asarray(want) > 0).sum() > 20
    _close(want, got)


def test_many_lights_take_culled_pdf(citynight_pair, monkeypatch):
    """mixture_pdf takes the culled sum from light_cull.threshold() lights
    on, on the CPU too (the JAX package takes the dense sum on its CPU
    backend), and the mixture agrees with JAX's dense one within the
    gate."""
    js, ts = citynight_pair
    assert ts.light_p.shape[0] >= tlc.threshold()
    calls = []
    real = tlc.light_pdf_sum_culled

    def spy(scene, o, d, cap=tlc.LIST_CAP):
        calls.append(o.shape)
        return real(scene, o, d, cap)

    monkeypatch.setattr(tlc, "light_pdf_sum_culled", spy)
    rng = np.random.default_rng(5)
    n = 700
    pos, _ = _down_rays(rng, n, [-20, 0.0, -20], [20, 0.0, 20])
    nrm = np.tile(np.float32([[0, 1, 0]]), (n, 1))
    in_d = _down_rays(rng, n, [0, 0, 0], [0, 0, 0])[1]
    out_d = -_down_rays(rng, n, [0, 0, 0], [0, 0, 0])[1]
    rough = rng.uniform(0.2, 1.0, n).astype(np.float32)
    want = jsh.mixture_pdf(js, jnp.asarray(pos), jnp.asarray(nrm),
                           jnp.asarray(rough), jnp.asarray(in_d),
                           jnp.asarray(out_d), True)
    got = tsh.mixture_pdf(ts, _t(pos), _t(nrm), _t(rough), _t(in_d),
                          _t(out_d), True)
    assert calls == [(n, 3)]
    _close(want, got)


@pytest.mark.parametrize("lanes", [1, 7, 512, 1000])
def test_dense_pdf_lane_steps_bit_equal(grid_pair, lanes):
    """The dense light pdf (288 lights: two chunks of lights) in steps of
    `lanes` lanes gives every lane the bits of the sum over the whole
    batch at once, NaN lanes, far points and [..., 3] batch shapes
    included."""
    _, ts = grid_pair
    rng = np.random.default_rng(12)
    o, d = _down_rays(rng, 3000, [0, 2.0, 0], [24, 6.0, 24])
    o[::13] = np.nan
    d[5::17] = np.nan
    o[3::19] = d[3::19] * 3.0e38
    o, d = _t(o).reshape(100, 30, 3), _t(d).reshape(100, 30, 3)
    whole = tsh.light_pdf_sum(ts, o, d, lanes=o.shape[0] * o.shape[1])
    got = tsh.light_pdf_sum(ts, o, d, lanes=lanes)
    assert got.shape == (100, 30)
    assert int((whole > 0).sum()) > 200
    assert torch.equal(got.view(torch.int32), whole.view(torch.int32))
    # by default a 1080p batch against a few lights is one step (no more
    # launches than one sum), and against 256 lights at a time 65,536 lanes
    assert tsh.pdf_lanes(4) >= 1920 * 1080 and tsh.pdf_lanes(288) == 65536


@pytest.fixture(scope="module")
def citynight1(tmp_path_factory):
    """citynight with one window a tower: 288 lights, below the threshold
    (the dense sum's scenes), windows on faces in three orientations."""
    from raytracer_odin_tpu_torch.io import gltf as tgltf
    from raytracer_odin_tpu_torch.models import assets as tassets
    from raytracer_odin_tpu_torch.models import build as tbuild

    path = tmp_path_factory.mktemp("citynight1") / "citynight1.gltf"
    tassets.make_citynight_scene(path, windows_per_tower=1)
    ts = tbuild.finish_scene(tgltf.read_gltf(str(path)), device="cpu")
    assert ts.light_p.shape[0] == 288
    return ts


def _edge_rays(ts, n, seed):
    """Rays aimed at points on light triangles' edges: the edge bv = 0 and
    the diagonal a quad's two triangles share."""
    rng = np.random.default_rng(seed)
    lp, lu, lv = (x.numpy() for x in (ts.light_p, ts.light_u, ts.light_v))
    i = rng.integers(0, len(lp), n)
    s = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    q = np.where((np.arange(n) % 2 == 0)[:, None], lp[i] + s * lu[i],
                 lp[i] + lu[i] + s * (lv[i] - lu[i])).astype(np.float32)
    o = (q + rng.normal(0, 10, (n, 3))).astype(np.float32)
    d = q - o
    return _t(o), _t((d / np.linalg.norm(d, axis=-1, keepdims=True))
                     .astype(np.float32))


@pytest.mark.parametrize("case", ["same_order", "other_order", "tampered"])
def test_edge_flips_explained(citynight1, monkeypatch, case):
    """chip_smoke's culled-vs-dense gate at full frame (edge_flips): where
    the dense sum rounds its dot products in another order than K5 (as
    torch's sum over three lanes does on the card: (a0 + a2) + a1), rays
    through light edges are hit in one arithmetic and not the other; each
    such lane is explained by lights on an edge. On the CPU both sums
    round alike and no lane differs; a lane that differs otherwise (a
    culled sum scaled by 3) is refused."""
    from raytracer_odin_tpu_torch.ops import geometry

    cs = _chip_smoke()
    o, d = _edge_rays(citynight1, 4000, 13)
    culled = tlc.light_pdf_sum_culled(citynight1, o, d)
    if case == "other_order":
        def tree_dot(a, b):
            return ((a[..., 0] * b[..., 0] + a[..., 2] * b[..., 2])
                    + a[..., 1] * b[..., 1])

        monkeypatch.setattr(geometry, "dot", tree_dot)
        monkeypatch.setattr(tsh, "dot", tree_dot)
    dense = tsh.light_pdf_sum(citynight1, o, d)
    assert int((dense > 0).sum()) > 1000
    if case == "tampered":
        lane = int(torch.nonzero(dense > 0)[0])
        culled[lane] *= 3
        with pytest.raises(AssertionError, match="triangle edge"):
            cs.edge_flips(tlc, citynight1, o, d, culled, dense)
        return
    flips = cs.edge_flips(tlc, citynight1, o, d, culled, dense)
    assert (flips > 100) == (case == "other_order")


def test_light_wrapper_refuses_bad_input(grid_pair):
    _, ts = grid_pair
    rays = torch.zeros((8, 512))
    with pytest.raises(ValueError):
        tlc.light_sums_rows(ts.light_rows, torch.zeros(1, dtype=torch.int64),
                            torch.zeros((1, 1), dtype=torch.int32), rays)
    with pytest.raises(ValueError):
        tlc.light_sums_rows(ts.light_rows[:, :12].contiguous(),
                            torch.zeros(1, dtype=torch.int32),
                            torch.zeros((1, 1), dtype=torch.int32), rays)
