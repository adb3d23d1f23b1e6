"""Parity of the port's intersection path with the JAX package's Pallas
path, on the CPU: the Pallas kernels run in interpret mode (exact
division), the port's wrappers run their plain PyTorch versions of the CUDA
kernels (K1 mask, K2 sweep). Inputs are made with numpy from a seed and fed
to both. Integer outputs (mask words, lists, counts, hit indices) must be
bit-equal. Hit distances agree to T_RTOL: XLA's CPU backend contracts the
Moller-Trumbore products into fused multiply-adds, so its t differs from
the separately rounded IEEE expressions (the port's, and numpy's) by up to
16 ulp (1.03e-6 relative) where the numerator cancels. On the card the
CUDA kernels and the plain versions are held bit-equal instead
(tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.ops import culling as jcull
from raytracer_odin_tpu.ops import pallas_intersect as jpi
from raytracer_odin_tpu.ops import traverse as jtrav
from raytracer_odin_tpu_torch.ops import culling as tcull
from raytracer_odin_tpu_torch.ops import pallas_intersect as tpi
from raytracer_odin_tpu_torch.ops import traverse as ttrav
from tests.conftest import random_triangles
from tests.test_bvh import make_scene
from tests.torch_parity import torch_scene


T_RTOL, T_ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_hits(jt, ji, tt, ti):
    """Bit-equal hit indices, t within T_RTOL."""
    ji, ti = np.asarray(ji), ti.numpy()
    assert np.array_equal(ji, ti)
    assert np.allclose(np.asarray(jt), tt.numpy(), rtol=T_RTOL, atol=T_ATOL)


def _rays(rng, n, spread=8):
    o = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _aabb8(lo, hi):
    c = lo.shape[0]
    c_pad = -(-c // 32) * 32
    aabb8 = np.zeros((c_pad, 8), np.float32)
    aabb8[:, 0:3] = jpi.BIG
    aabb8[:, 3:6] = -jpi.BIG
    aabb8[:c, 0:3] = lo
    aabb8[:c, 3:6] = hi
    return aabb8


@pytest.mark.parametrize("n_clusters", [None, 111])
def test_mask_plain_matches_pallas(n_clusters):
    """K1's plain version is bit-equal to cluster_masks_rows, including
    axis-parallel rays, zero and NaN direction components, dead far lanes
    and the n_bits zeroing (mirrors tests/test_pallas.py:134,153)."""
    rng = np.random.default_rng(7)
    c = 111  # the demo scene's cluster count: 4 words, 17 pad bits
    lo = rng.uniform(-8, 8, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 3.0, (c, 3)).astype(np.float32)
    aabb8 = _aabb8(lo, hi)
    o, d = _rays(rng, 700, spread=10)
    d[5] = [1.0, 0.0, 0.0]
    d[6] = [0.0, -1.0, 0.0]
    d[8] = [0.0, 0.0, 0.0]
    d[9] = [np.nan, 0.5, 0.5]
    o[7] = jpi.BIG
    d[7] = [1.0, 0.0, 0.0]
    rows, _, _ = jpi.pack_rays(jnp.asarray(o), jnp.asarray(d))
    want = np.asarray(jpi.cluster_masks_rows(jnp.asarray(aabb8), rows,
                                             n_clusters))
    got = tpi.cluster_masks_rows(_t(aabb8), _t(rows), n_clusters).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (4, 1024)
    assert np.array_equal(got, want)
    if n_clusters is not None:
        assert (got[3].view(np.uint32) >> 15 == 0).all()


def test_mask_plain_many_words():
    """More than 8 words (410 clusters): bit-equal, pad bits zeroed."""
    rng = np.random.default_rng(23)
    c = 410
    lo = rng.uniform(-8, 8, (c, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 3.0, (c, 3)).astype(np.float32)
    aabb8 = _aabb8(lo, hi)
    o, d = _rays(rng, 80, spread=10)
    rows, _, _ = jpi.pack_rays(jnp.asarray(o), jnp.asarray(d))
    want = np.asarray(jpi.cluster_masks_rows(jnp.asarray(aabb8), rows, c))
    got = tpi.cluster_masks_rows(_t(aabb8), _t(rows), c).numpy()
    assert got.shape == want.shape == (13, 512)
    assert np.array_equal(got, want)


def test_pack_rays_and_pad_triangles_match():
    rng = np.random.default_rng(3)
    o, d = _rays(rng, 700)
    jr, jshape, jn = jpi.pack_rays(jnp.asarray(o), jnp.asarray(d))
    tr, tshape, tn = tpi.pack_rays(_t(o), _t(d))
    assert (jshape, jn) == (tshape, tn)
    assert np.array_equal(np.asarray(jr), tr.numpy())
    p, u, v = random_triangles(rng, 150)
    assert np.array_equal(jpi.pad_triangles(p, u, v),
                          tpi.pad_triangles(p, u, v))


def test_cull_glue_matches():
    """or_blocks_packed, unpack_mask and build_lists (ascending ids, cap
    overflow -> -1) are bit-equal to the JAX glue."""
    rng = np.random.default_rng(5)
    words = rng.integers(-2**31, 2**31, (4, 2048), dtype=np.int64)
    words = words.astype(np.int32)
    words[:, :256] &= rng.integers(0, 2, (4, 256)).astype(np.int32) << 7
    jor = jcull.or_blocks_packed(jnp.asarray(words), 256)
    tor = tcull.or_blocks_packed(_t(words), 256)
    assert np.array_equal(np.asarray(jor), tor.numpy())
    jm = jcull.unpack_mask(jor, 111)
    tm = tcull.unpack_mask(tor, 111)
    assert np.array_equal(np.asarray(jm), tm.numpy())
    for cap in (None, 256, 40):
        jc, jl = jcull.build_lists(jm, cap=cap)
        tc, tl = tcull.build_lists(tm, cap=cap)
        assert np.array_equal(np.asarray(jc), tc.numpy()), cap
        assert np.array_equal(np.asarray(jl), tl.numpy()), cap
    img = rng.normal(size=(40, 70, 3)).astype(np.float32)
    jt = jcull.to_tiles(jnp.asarray(img), 40, 70, pad_value=3.0)
    tt = tcull.to_tiles(_t(img), 40, 70, pad_value=3.0)
    assert np.array_equal(np.asarray(jt), tt.numpy())
    assert np.array_equal(tcull.from_tiles(tt, 40, 70).numpy(), img)


def test_lex_sort_matches_lax_sort():
    """The packed stable cascade orders lanes as lax.sort does (signed
    int32 keys, most significant first); on unique keys the permutation is
    the same."""
    rng = np.random.default_rng(9)
    n = 3000
    keys = [rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
            for _ in range(3)]
    keys[0][:1000] = rng.integers(-3, 3, 1000).astype(np.int32)
    keys[1][:500] = 0
    iota = np.arange(n, dtype=np.int32)
    want = jax.lax.sort(tuple(jnp.asarray(k) for k in keys)
                        + (jnp.asarray(iota),), num_keys=3)[-1]
    got = ttrav.lex_sort_perm([_t(k) for k in keys])
    assert np.array_equal(np.asarray(want), got.numpy())


def test_lex_sort_keys_header_fold():
    rng = np.random.default_rng(4)
    n = 600
    alive = rng.random(n) < 0.6
    d = rng.normal(size=(n, 3)).astype(np.float32)
    w = [rng.integers(0, 2**31, n).astype(np.int32) for _ in range(3)]
    w.append(rng.integers(0, 1 << 15, n).astype(np.int32))
    jk, js = jtrav._lex_sort_keys(jnp.asarray(alive),
                                  jtrav._ray_octant(jnp.asarray(d)),
                                  [jnp.asarray(x) for x in w], 111)
    tk, ts = ttrav._lex_sort_keys(_t(alive), ttrav._ray_octant(_t(d)),
                                  [_t(x) for x in w], 111)
    assert js == ts
    for a, b in zip(jk, tk):
        assert np.array_equal(np.asarray(a), b.numpy())


def _sweep_inputs(rng, n_tris, n_rays):
    p, u, v = random_triangles(rng, n_tris)
    tris = jpi.pad_triangles(p, u, v)
    o = rng.uniform(-6, 6, (n_rays, 3)).astype(np.float32)
    tgt = p[rng.integers(0, n_tris, n_rays)] + 0.3 * u[
        rng.integers(0, n_tris, n_rays)]
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rows, _, _ = jpi.pack_rays(jnp.asarray(o), jnp.asarray(d))
    return tris, np.asarray(rows)


def test_sweep_plain_matches_pallas():
    """K2's plain version equals the Pallas culled kernel bit for bit on
    shuffled lists, an overflow (-1) block and an empty block (mirrors
    tests/test_pallas.py:23)."""
    rng = np.random.default_rng(11)
    tris, rows = _sweep_inputs(rng, 700, 1024)
    nc = tris.shape[0] // jpi.LEAF
    nsb = rows.shape[1] // jpi.RB_SUB
    counts = rng.integers(0, nc + 1, nsb).astype(np.int32)
    counts[1] = -1
    counts[2] = 0
    lists = np.stack([rng.permutation(nc) for _ in range(nsb)]).astype(
        np.int32)
    want = np.asarray(jpi.intersect_culled_rows(
        jnp.asarray(tris), jnp.asarray(counts), jnp.asarray(lists),
        jnp.asarray(rows)))
    got = tpi.intersect_culled_rows(_t(tris), _t(counts), _t(lists),
                                    _t(rows)).numpy()
    assert (want[1] >= 0).sum() > 200  # the rays really hit
    assert np.array_equal(got[1:], want[1:])
    assert np.allclose(got[0], want[0], rtol=T_RTOL, atol=T_ATOL)


def _scene_pair(rng, n_tris):
    p, u, v = random_triangles(rng, n_tris)
    js = make_scene(p, u, v)
    return js, torch_scene(js)


def test_cast_tiled_matches():
    """Bounce-0 tiled branch: an [H, W] grid through the tile order (mirrors
    tests/test_pallas.py:80)."""
    rng = np.random.default_rng(1)
    js, ts = _scene_pair(rng, 300)
    h, w = 40, 70  # not tile-aligned: padding lanes exercised
    o = rng.uniform(-8, 8, (h, w, 3)).astype(np.float32)
    d = rng.normal(size=(h, w, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o), jnp.asarray(d))
    tt, ti = ttrav.cast_rays_pallas(ts, _t(o), _t(d))
    assert (np.asarray(ji) >= 0).sum() > 100
    _same_hits(jt, ji, tt, ti)


def test_cast_sorted_matches():
    """Sorted exact branch with dead lanes (mirrors
    tests/test_pallas.py:61): same hits lane by lane, dead lanes miss."""
    rng = np.random.default_rng(7)
    js, ts = _scene_pair(rng, 300)
    o, d = _rays(rng, 1500)
    alive = rng.random(1500) < 0.7
    jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o), jnp.asarray(d),
                                          sort=True, alive=jnp.asarray(alive))
    tt, ti = ttrav.cast_rays_pallas(ts, _t(o), _t(d), sort=True,
                                    alive=_t(alive))
    _same_hits(jt, ji, tt, ti)
    assert (ti.numpy()[~alive] == -1).all()
    # and the same hits as the unsorted cast
    ut, ui = ttrav.cast_rays_pallas(ts, _t(o), _t(d))
    assert np.array_equal(ui.numpy()[alive], ti.numpy()[alive])


def test_cast_presorted_rows_matches():
    rng = np.random.default_rng(13)
    js, ts = _scene_pair(rng, 300)
    o, d = _rays(rng, 2 * jpi.RB)
    g, n_super, aabb8 = jtrav.exact_cull_layout(js)
    _, _, taabb8 = ttrav.exact_cull_layout(ts)
    assert np.array_equal(np.asarray(aabb8), taabb8.numpy())
    rows, _, _ = jpi.pack_rays(jnp.asarray(o) + jnp.asarray(d) * 1e-3,
                               jnp.asarray(d))
    words = jpi.cluster_masks_rows(aabb8, rows, n_super)
    jt, ji, _, _ = jtrav.cast_presorted_rows(js, rows, words=words)
    tt, ti = ttrav.cast_presorted_rows(ts, _t(rows), _t(words))
    _same_hits(jt, ji, tt, ti)


def test_wrapper_refuses_bad_input():
    rays = torch.zeros((8, 512))
    with pytest.raises(ValueError):
        tpi.cluster_masks_rows(torch.zeros((100, 8)), rays)
    with pytest.raises(ValueError):
        tpi.intersect_culled_rows(torch.zeros((64, 12)),
                                  torch.zeros(2, dtype=torch.int64),
                                  torch.zeros((2, 1), dtype=torch.int32),
                                  rays)
