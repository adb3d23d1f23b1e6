"""Two-phase t-bounded culling in the PyTorch port against the JAX package,
on the CPU: K1's tmax row (the plain version against the Pallas kernel in
interpret mode), `_two_phase_exact` against the JAX package's and against
the port's single sweep, and a compacted demo sample with two-phase culling
through both packages.

Tolerances are those of tests/test_torch_kernels.py: mask words and hit
indices bit-equal, t within T_RTOL (XLA's CPU backend fuses the
Moller-Trumbore multiply-adds: up to 16 ulp). Against the JAX package a
hit index may also differ where two clusters hold hits at exactly equal t:
the JAX package sorts its nearest-first lists with the unstable lax.sort,
the port by (near, id), so the cluster swept first in phase A can differ
among equal entry distances (ROADMAP.md queue C, list order among equal
near). The demo sample is held at the glossy-scene gate of
tests/test_torch_render.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.ops import pallas_intersect as jpi
from raytracer_odin_tpu.ops import traverse as jtrav
from raytracer_odin_tpu.ops.integrator import TraceOptions as JTraceOptions
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch.ops import integrator as tinteg
from raytracer_odin_tpu_torch.ops import pallas_intersect as tpi
from raytracer_odin_tpu_torch.ops import traverse as ttrav
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.render import runtime as truntime
from raytracer_odin_tpu_torch.utils import prng
from tests.test_torch_kernels import T_ATOL, T_RTOL, _aabb8, _rays, _scene_pair
from tests.test_torch_render import _near
from tests.torch_parity import torch_scene

K = 2  # the value the JAX package was measured at (ARCHITECTURE.md)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("c", [20, 111])
def test_mask_tmax_plain_matches_pallas(c):
    """K1 with tmax_row, 1 and 4 mask words: finite bounds, BIG, NaN, zero
    and negative bounds, and padding lanes, bit-equal to the Pallas kernel;
    and a BIG bound changes nothing against the plain mask."""
    rng = np.random.default_rng(c)
    lo = rng.uniform(-8, 8, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 3.0, (c, 3)).astype(np.float32)
    aabb8 = _aabb8(lo, hi)
    o, d = _rays(rng, 700, spread=10)
    d[5] = [1.0, 0.0, 0.0]
    d[9] = [np.nan, 0.5, 0.5]
    rows, _, _ = jpi.pack_rays(jnp.asarray(o), jnp.asarray(d))
    rows = np.array(rows)
    tmax = rng.uniform(0.0, 20.0, rows.shape[1]).astype(np.float32)
    tmax[::7] = jpi.BIG
    tmax[3::11] = np.nan
    tmax[4::13] = 0.0
    tmax[6::17] = -1.0
    tmax[700:] = rng.uniform(-1, 5, rows.shape[1] - 700)  # padding lanes
    rows[6] = tmax
    want = np.asarray(jpi.cluster_masks_rows(jnp.asarray(aabb8),
                                             jnp.asarray(rows), c,
                                             tmax_row=True))
    got = tpi.cluster_masks_rows(_t(aabb8), _t(rows), c,
                                 tmax_row=True).numpy()
    assert got.shape == want.shape == (-(-c // 32), 1024)
    assert np.array_equal(got, want)
    plain = tpi.cluster_masks_rows(_t(aabb8), _t(rows), c).numpy()
    big = tmax == jpi.BIG
    assert np.array_equal(got[:, big], plain[:, big])
    assert (got[:, np.isnan(tmax)] == 0).all()
    assert (got & ~plain == 0).all()
    assert (got != plain).any()


def _presorted(js, ts, o, d):
    """Kernel rows and exact masks of o, d for both packages."""
    _, n_super, aabb8 = jtrav.exact_cull_layout(js)
    rows, _, _ = jpi.pack_rays(jnp.asarray(o) + jnp.asarray(d) * 1e-3,
                               jnp.asarray(d))
    words = jpi.cluster_masks_rows(aabb8, rows, n_super)
    return rows, words


def _same_up_to_ties(jt, ji, tt, ti):
    """Hit/miss equal, t within T_RTOL, index equal except at exact-t ties
    (t equal within the same tolerance). Returns the index flips."""
    jt, ji = np.asarray(jt), np.asarray(ji)
    tt, ti = tt.numpy(), ti.numpy()
    assert np.array_equal(ji >= 0, ti >= 0)
    assert np.allclose(jt, tt, rtol=T_RTOL, atol=T_ATOL)
    return int((ji != ti).sum())


@pytest.mark.parametrize("seed,n_tris", [(11, 300), (12, 1500)])
def test_two_phase_matches_jax(monkeypatch, seed, n_tris):
    """Random triangles (mirrors tests/test_pallas.py:245): the port's
    two-phase cast against the JAX package's, both at K = 2, and against
    the port's single sweep: t bit-equal there, indices equal except at
    exact-t ties."""
    rng = np.random.default_rng(seed)
    js, ts = _scene_pair(rng, n_tris)
    o, d = _rays(rng, 4 * jpi.RB)
    rows, words = _presorted(js, ts, o, d)
    t1, i1 = ttrav.cast_presorted_rows(ts, _t(rows), _t(words))
    monkeypatch.setattr(jtrav, "TWO_PHASE_K", K)
    monkeypatch.setattr(ttrav, "TWO_PHASE_K", K)
    before = tpi.cluster_masks_rows.tmax_launches
    jt, ji, _, _ = jtrav.cast_presorted_rows(js, rows, words=words)
    tt, ti = ttrav.cast_presorted_rows(ts, _t(rows), _t(words))
    assert tpi.cluster_masks_rows.tmax_launches == before  # CPU: plain
    assert int((ti >= 0).sum()) > 150
    _same_up_to_ties(jt, ji, tt, ti)
    assert torch.equal(tt, t1)
    assert np.array_equal((ti >= 0).numpy(), (i1 >= 0).numpy())


@pytest.fixture(scope="module")
def demo_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo2")
    host = jgltf.read_gltf(jassets.generate("demo", d)["gltf"])
    js = jbuild.finish_scene(host)
    return host, js, torch_scene(js)


def _demo_batch(host, ts, w=64, h=36):
    """The sorted, compacted bounce-1 batch of a small demo frame (the
    batch two-phase culling serves on the main path), built by the port's
    own first_bounce and sort_lanes: (kernel rows, mask words)."""
    fov = host.cam.fov_x * w / h
    key = prng.key_from_seed(0)
    o, d = truntime.camera_rays(ts, key, 0, fov, w, h)
    state, alive = tinteg.first_bounce(ts, o, d, key, 0)
    _, n_super, aabb8 = ttrav.exact_cull_layout(ts)
    _, _, rays1, words1 = tinteg.sort_lanes(state, alive, aabb8, n_super,
                                            state.shape[0])
    return rays1, words1


def test_two_phase_sorted_demo_batch(monkeypatch, demo_pair):
    """The sorted demo batch cast through both packages' two-phase path
    and the port's single sweep; the two phases together sweep fewer
    clusters than the single sweep's lists hold (the tmax row prunes
    clusters entered beyond phase A's hits)."""
    host, js, ts = demo_pair
    rays1, words1 = _demo_batch(host, ts)
    t1, i1 = ttrav.cast_presorted_rows(ts, rays1, words1)
    _, n_super, _ = ttrav.exact_cull_layout(ts)
    single = int(ttrav.exact_lists(words1, n_super)[0].sum())
    monkeypatch.setattr(jtrav, "TWO_PHASE_K", K)
    monkeypatch.setattr(ttrav, "TWO_PHASE_K", K)
    jt, ji, _, _ = jtrav.cast_presorted_rows(
        js, jnp.asarray(rays1.numpy()), words=jnp.asarray(words1.numpy()))
    swept = []
    real = tpi.intersect_culled_rows

    def record(tris, counts, lists, r):
        swept.append(int(counts.sum()))
        return real(tris, counts, lists, r)

    monkeypatch.setattr(tpi, "intersect_culled_rows", record)
    tt, ti = ttrav.cast_presorted_rows(ts, rays1, words1)
    assert int((ti >= 0).sum()) > 500
    _same_up_to_ties(jt, ji, tt, ti)
    assert torch.equal(tt, t1)
    assert len(swept) == 2 and swept[0] + swept[1] < single


def test_two_phase_demo_sample_matches_jax(monkeypatch, demo_pair):
    """One compacted demo sample at depth 4 with two-phase culling through
    both packages: equal live-lane counts per bounce and ray counts,
    radiance within the glossy-scene gate, and equal to the port's
    single-phase sample under the same gate."""
    host, js, ts = demo_pair
    w, h, depth = 32, 18, 4
    fov = host.cam.fov_x * w / h
    schedule = (512,) * 3
    opts = TraceOptions(depth=depth, intersector="pallas",
                        lane_schedule=schedule)
    single, _ = truntime.sample_pass(ts, prng.key_from_seed(0), 0, fov, w,
                                     h, opts)
    monkeypatch.setattr(jtrav, "TWO_PHASE_K", K)
    monkeypatch.setattr(ttrav, "TWO_PHASE_K", K)
    jr, ja = jax.jit(lambda k: jruntime.sample_pass(
        js, k, jnp.int32(0), fov, w, h,
        JTraceOptions(depth=depth, intersector="pallas",
                      lane_schedule=schedule)))(jax.random.PRNGKey(0))
    tr, ta = truntime.sample_pass(ts, prng.key_from_seed(0), 0, fov, w, h,
                                  opts)
    assert ta["alive_counts"].tolist() == np.asarray(
        ja["alive_counts"]).tolist()
    assert int(ta["rays_cast"]) == int(ja["rays_cast"])
    assert int(ta["overflow"]) == int(ja["overflow"]) == 0
    _near(tr.numpy(), jr)
    _near(tr.numpy(), single.numpy())


@pytest.mark.parametrize("k", [1, 2, 5])
def test_swept_words_matches_bit_loop(k):
    """swept_words equals the JAX package's per-word, per-entry bit loop
    (traverse._two_phase_exact) on nearest-first lists of 111 clusters,
    bit 31 of each word included, with counts from 0 to k."""
    rng = np.random.default_rng(k)
    nb, c, n_words = 300, 111, 4
    lists = np.stack([rng.permutation(c) for _ in range(nb)]).astype(np.int32)
    lists[:4, 0] = [31, 63, 95, 0]
    counts = rng.integers(0, k + 1, nb).astype(np.int32)
    want = np.zeros((n_words, nb), np.int32)
    for w in range(n_words):
        for kk in range(k):
            cid = lists[:, kk]
            use = (kk < counts) & (cid // 32 == w)
            want[w] |= np.where(use, np.left_shift(np.int32(1), cid % 32),
                                0).astype(np.int32)
    got = ttrav.swept_words(_t(lists[:, :k]), _t(counts), n_words)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
