"""The port's CUDA kernels (K1-K5; K2, K3 and K4 are instances of one sweep
kernel) against their plain PyTorch versions, on the card.

Every test here carries the `gpu` marker and takes the `cuda` fixture,
which skips when no CUDA device is present (decided inside the fixture, so
every test process collects the same tests). On the card:

    python -m pytest tests/test_torch_gpu.py -m gpu

With -fmad=false and IEEE division the kernels round every expression as
the plain versions do, so the comparisons are bit for bit."""

import numpy as np
import pytest
import torch

from raytracer_odin_tpu_torch.ops import culling, light_cull
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops import traverse
import kernel_batches as kb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (this machine has none)")
    return torch.device("cuda", 0)


def _rays(rng, n, tris=None):
    """Random rays; with `tris` (the packed rows), aimed at their real
    (non-padding) triangles' corners."""
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    if tris is None:
        d = rng.normal(size=(n, 3)).astype(np.float32)
    else:
        real = tris[tris[:, 0] < pi.BIG]
        d = real[rng.integers(0, len(real), n), 0:3] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    # axis-parallel rays, both signs
    d[:6] = (np.eye(3, dtype=np.float32).repeat(2, 0)
             * np.float32([1, -1] * 3)[:, None])
    rays, _, _ = pi.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    return rays


def _tris(rng, n):
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    u = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return pi.pad_triangles(p, u, v)


@pytest.mark.gpu
@pytest.mark.parametrize("n_clusters", [111, 256])
def test_mask_kernel_bit_equal(cuda, n_clusters):
    rng = np.random.default_rng(n_clusters)
    lo = rng.uniform(-8, 8, (n_clusters, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 3, (n_clusters, 3)).astype(np.float32)
    s_pad = -(-n_clusters // 32) * 32
    aabb = np.zeros((s_pad, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = pi.BIG, -pi.BIG
    aabb[:n_clusters, 0:3], aabb[:n_clusters, 3:6] = lo, hi
    rays = _rays(rng, 70_000).to(cuda)
    a = torch.from_numpy(aabb).to(cuda)
    before = pi.cluster_masks_rows.launches
    got = pi.cluster_masks_rows(a, rays, n_clusters)
    want = pi._cluster_masks_plain(a, rays, n_clusters)
    torch.cuda.synchronize()
    assert pi.cluster_masks_rows.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_mask_kernel_tmax_bit_equal(cuda):
    """K1 with its tmax row: finite, BIG, NaN, zero and negative bounds, and
    a NaN direction; counted in tmax_launches, not launches."""
    rng = np.random.default_rng(6)
    n_clusters = 111
    lo = rng.uniform(-8, 8, (n_clusters, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 3, (n_clusters, 3)).astype(np.float32)
    aabb = np.zeros((128, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = pi.BIG, -pi.BIG
    aabb[:n_clusters, 0:3], aabb[:n_clusters, 3:6] = lo, hi
    rays = _rays(rng, 70_000)
    tmax = torch.from_numpy(
        rng.uniform(0, 20, rays.shape[1]).astype(np.float32))
    tmax[::7] = pi.BIG
    tmax[3::11] = float("nan")
    tmax[4::13] = 0.0
    tmax[6::17] = -1.0
    rays[6] = tmax
    rays[3, 9] = float("nan")
    rays = rays.to(cuda)
    a = torch.from_numpy(aabb).to(cuda)
    before = (pi.cluster_masks_rows.launches,
              pi.cluster_masks_rows.tmax_launches)
    got = pi.cluster_masks_rows(a, rays, n_clusters, tmax_row=True)
    want = pi._cluster_masks_plain(a, rays, n_clusters, tmax_row=True)
    plain = pi._cluster_masks_plain(a, rays, n_clusters)
    torch.cuda.synchronize()
    assert (pi.cluster_masks_rows.launches,
            pi.cluster_masks_rows.tmax_launches) == (before[0],
                                                     before[1] + 1)
    assert torch.equal(got, want)
    big = (tmax == pi.BIG).to(cuda)
    assert torch.equal(got[:, big], plain[:, big])
    assert not bool(got[:, torch.isnan(tmax).to(cuda)].any())
    assert bool((got != plain).any())


@pytest.mark.gpu
def test_sweep_kernel_bit_equal(cuda):
    rng = np.random.default_rng(1)
    tris = _tris(rng, 7090)
    nc = tris.shape[0] // pi.LEAF
    rays = _rays(rng, 65_536, tris).to(cuda)
    nsb = rays.shape[1] // pi.RB_SUB
    counts = rng.integers(0, 40, nsb).astype(np.int32)
    counts[::17] = -1
    lists = np.stack([rng.permutation(nc) for _ in range(nsb)]).astype(
        np.int32)
    t = torch.from_numpy(tris).to(cuda)
    c = torch.from_numpy(counts).to(cuda)
    lst = torch.from_numpy(lists).to(cuda)
    before = pi.intersect_culled_rows.launches
    got = pi.intersect_culled_rows(t, c, lst, rays)
    want = pi._culled_plain(c, lst, rays, t)
    torch.cuda.synchronize()
    assert pi.intersect_culled_rows.launches == before + 1
    assert int((got[1] >= 0).sum()) > 1000
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", kb.MASK_CASES)
@pytest.mark.parametrize("tmax_row", [False, True])
def test_mask_kernel_adversarial(cuda, case, tmax_row):
    """K1 and K1-tmax on tests/kernel_batches.py's adversarial batches: NaN
    dead lanes, +-0 and clamped direction components, rays through shared
    edges and vertices of flat boxes, -0 / +0 slab bounds, n_bits not a
    multiple of 32, tmax bounds at a slab entry, +-0, BIG and NaN."""
    aabb, rays, n_bits = (x.to(cuda) if torch.is_tensor(x) else x
                          for x in kb.mask_batch(case, tmax_row))
    got = pi.cluster_masks_rows(aabb, rays, n_bits, tmax_row=tmax_row)
    want = pi._cluster_masks_plain(aabb, rays, n_bits, tmax_row)
    torch.cuda.synchronize()
    assert bool(want.any())
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel, case", [
    pytest.param(k, c, id=c if k == "K2" else f"{k}-{c}")
    for k, c in kb.KERNEL_CASES])
def test_sweep_kernel_adversarial(cuda, kernel, case):
    """The sweep kernel's instances K2 (256-ray lists), K4 (512-ray lists)
    and K3 (every cluster) on tests/kernel_batches.py's adversarial
    batches: NaN dead lanes, zero direction components, counts -1 and 0,
    one-entry lists, equal t in two listed clusters, BIG pad rows, rays
    through shared edges and vertices, and warps where one lane alone
    passes the bu test (the warp skips)."""
    block, _ = kb.SWEEPS[kernel]
    tris, counts, lists, rays = (x.to(cuda)
                                 for x in kb.sweep_batch(case, kernel))
    fn = kb.WRAPPERS[kernel]
    before = fn.launches
    got = (fn(tris, rays) if kernel == "K3"
           else fn(tris, counts, lists, rays))
    want = pi._culled_plain(counts, lists, rays, tris, block)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert int((want[1] >= 0).sum()) > 50
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_stream_kernel_overflow_lists(cuda):
    """K4 over a streamed cast's lists for blocks beyond the cap (their
    clusters in ascending id order, uncapped, true counts) gives the same
    hits bit for bit as K4 over the same blocks at count -1 (every
    cluster), and as the plain version."""
    tris, _, _, rays = kb.sweep_batch("shared_edges", "K4")
    aabb, n_bits = kb.cluster_boxes(tris.numpy())
    words = pi._cluster_masks_plain(torch.from_numpy(aabb), rays, n_bits)
    # lanes sorted by mask, as the main path sorts them: blocks of 3-7 of
    # the 7 clusters
    perm = torch.sort(words[0], stable=True).indices
    rays, words = rays[:, perm].contiguous(), words[:, perm].contiguous()
    cap = 5
    counts, lists = culling.build_lists(
        culling.unpack_mask(culling.or_blocks_packed(words, pi.RB), n_bits),
        cap=cap, overflow_ids=True)
    over = counts > cap
    assert int(over.sum()) >= 2 and not bool(over.all())
    assert bool((counts[over] < tris.shape[0] // pi.LEAF).any())
    capped = torch.where(over, -1, counts)
    t, c, lst, r, cc = (x.to(cuda) for x in (tris, counts, lists, rays,
                                             capped))
    got = pi.intersect_stream_rows(t, c, lst, r)
    every = pi.intersect_stream_rows(t, cc, lst, r)
    want = pi._culled_plain(c, lst, r, t, pi.RB)
    torch.cuda.synchronize()
    assert int((want[1] >= 0).sum()) > 50
    assert torch.equal(got.view(torch.int32), every.view(torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_exact_lists_sweep_bit_equal(cuda):
    """K1 masks -> exact lists -> K2, as the main path chains them."""
    rng = np.random.default_rng(2)
    tris = _tris(rng, 3000)
    nc = tris.shape[0] // pi.LEAF
    t = torch.from_numpy(tris).to(cuda)
    lo, hi = culling.cluster_aabbs(
        np.minimum(tris[:3000, 0:3], np.minimum(
            tris[:3000, 0:3] + tris[:3000, 3:6],
            tris[:3000, 0:3] + tris[:3000, 6:9])),
        np.maximum(tris[:3000, 0:3], np.maximum(
            tris[:3000, 0:3] + tris[:3000, 3:6],
            tris[:3000, 0:3] + tris[:3000, 6:9])))
    s_pad = -(-nc // 32) * 32
    aabb = np.zeros((s_pad, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = pi.BIG, -pi.BIG
    aabb[:nc, 0:3], aabb[:nc, 3:6] = lo, hi
    rays = _rays(rng, 32_768, tris).to(cuda)
    words = pi.cluster_masks_rows(torch.from_numpy(aabb).to(cuda), rays, nc)
    counts, lists = traverse.exact_lists(words, nc)
    got = pi.intersect_culled_rows(t, counts, lists, rays)
    want = pi._culled_plain(counts, lists, rays, t)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_sorted_dead_lane_frame_bit_equal(cuda, monkeypatch):
    """The uncompacted trace's sorted cast: traverse.sort_exact on a frame
    whose dead lanes carry NaN. K1 on the rows it packs for every lane (the
    dead ones as far rays) and K2 on the sorted batch, dead lanes last, each
    bit-equal to its plain version; the dead lanes miss."""
    scene, o, d, alive, aabb, n_bits, tris = kb.dead_lane_frame()
    scene.cluster_lo = scene.cluster_lo.to(cuda)
    scene.cluster_hi = scene.cluster_hi.to(cuda)
    aabb, tris = aabb.to(cuda), tris.to(cuda)
    # K1's input: the rows sort_exact packs (dead lanes as far rays)
    packed = []
    real_pack = pi.pack_rays

    def record(o_, d_):
        out = real_pack(o_, d_)
        packed.append(out[0].clone())
        return out

    monkeypatch.setattr(pi, "pack_rays", record)
    before = pi.cluster_masks_rows.launches
    rays2, words, perm = traverse.sort_exact(
        scene, o.to(cuda), d.to(cuda), alive.to(cuda), aabb, n_bits)
    monkeypatch.undo()
    assert pi.cluster_masks_rows.launches == before + 1
    (rays_pre,) = packed
    got_k1 = pi.cluster_masks_rows(aabb, rays_pre, n_bits)
    assert torch.equal(got_k1,
                       pi._cluster_masks_plain(aabb, rays_pre, n_bits))
    n, n_alive = o.shape[0], int(alive.sum())
    assert 0 < n_alive < n < rays2.shape[1]
    assert bool(alive.to(cuda)[perm][:n_alive].all())
    assert not bool(alive.to(cuda)[perm][n_alive:].any())
    counts, lists = traverse.exact_lists(words, n_bits)
    got = pi.intersect_culled_rows(tris, counts, lists, rays2)
    want = pi._culled_plain(counts, lists, rays2, tris)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int((got[1, :n_alive] >= 0).sum()) > n_alive // 2
    assert bool((got[1, n_alive:] < 0).all())


@pytest.mark.gpu
def test_wrappers_refuse_cpu_cuda_mix(cuda):
    rays = torch.zeros((8, 512), device=cuda)
    with pytest.raises(ValueError):
        pi.cluster_masks_rows(torch.zeros((32, 8)), rays)


def _lists(rng, nb, nc, width):
    counts = rng.integers(0, min(nc, width) + 1, nb).astype(np.int32)
    counts[::11] = -1
    counts[5] = 0
    lists = np.stack([rng.permutation(nc)[:width] for _ in range(nb)])
    return counts, lists.astype(np.int32)


@pytest.mark.gpu
def test_stream_kernel_bit_equal(cuda):
    """K4: one list per 512-ray block, overflow blocks sweep everything."""
    rng = np.random.default_rng(3)
    tris = _tris(rng, 20_000)
    nc = tris.shape[0] // pi.LEAF
    rays = _rays(rng, 65_536, tris).to(cuda)
    counts, lists = _lists(rng, rays.shape[1] // pi.RB, nc, 256)
    t = torch.from_numpy(tris).to(cuda)
    c = torch.from_numpy(counts).to(cuda)
    lst = torch.from_numpy(lists).to(cuda)
    before = pi.intersect_stream_rows.launches
    got = pi.intersect_stream_rows(t, c, lst, rays)
    want = pi._culled_plain(c, lst, rays, t, pi.RB)
    torch.cuda.synchronize()
    assert pi.intersect_stream_rows.launches == before + 1
    assert int((got[1] >= 0).sum()) > 1000
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_brute_kernel_bit_equal(cuda):
    """K3 equals its plain version and K4 with every count -1."""
    rng = np.random.default_rng(4)
    tris = _tris(rng, 7090)
    rays = _rays(rng, 32_768, tris).to(cuda)
    t = torch.from_numpy(tris).to(cuda)
    before = pi.intersect_brute_rows.launches
    got = pi.intersect_brute_rows(t, rays)
    want = pi._brute_plain(rays, t)
    nb = rays.shape[1] // pi.RB
    every = pi.intersect_stream_rows(
        t, torch.full((nb,), -1, dtype=torch.int32, device=cuda),
        torch.zeros((nb, 1), dtype=torch.int32, device=cuda), rays)
    torch.cuda.synchronize()
    assert pi.intersect_brute_rows.launches == before + 1
    assert int((got[1] >= 0).sum()) > 1000
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), every.view(torch.int32))


@pytest.mark.gpu
def test_light_kernel_bit_equal(cuda):
    """K5: light rows of random small triangles, rays aimed at them, lists
    with overflow and empty blocks; the per-cluster partial sums in row
    order make kernel and plain version bit-equal."""
    rng = np.random.default_rng(5)
    n = 1700
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    u = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    v = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    ng = np.cross(u, v)
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    fac = (2.0 / np.linalg.norm(np.cross(u, v), axis=-1)).astype(np.float32)
    rows = light_cull.pack_light_rows(p, u, v, ng, fac)
    nc = rows.shape[0] // light_cull.LEAF_L
    lo = rng.uniform(-8, 8, (65_536, 3)).astype(np.float32)
    d = p[rng.integers(0, n, 65_536)] + 0.3 * u[rng.integers(0, n, 65_536)]
    d = d - lo
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r, _, _ = pi.pack_rays(torch.from_numpy(lo), torch.from_numpy(d))
    counts, lists = _lists(rng, r.shape[1] // pi.RB, nc, 40)
    lr = torch.from_numpy(rows).to(cuda)
    c = torch.from_numpy(counts).to(cuda)
    lst = torch.from_numpy(lists).to(cuda)
    r = r.to(cuda)
    before = light_cull.light_sums_rows.launches
    got = light_cull.light_sums_rows(lr, c, lst, r)
    want = light_cull._light_sums_plain(c, lst, r, lr)
    torch.cuda.synchronize()
    assert light_cull.light_sums_rows.launches == before + 1
    assert int((got > 0).sum()) > 1000
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case", kb.LIGHT_CASES)
def test_light_kernel_adversarial(cuda, case):
    """K5 on tests/kernel_batches.py's adversarial light batches: NaN dead
    lanes, +-0 and clamped direction components, rays through shared edges,
    warps where one lane alone passes bu (the warp skips), counts -1 and 0,
    one-entry lists; lights with |ng.d| = 0 and fac of both signs (+-inf
    and +inf + -inf partials), invalid rows with real geometry, subnormal
    edges (the full reciprocal), fac NaN, +inf, -0 and subnormal, and pad
    rows."""
    lr, counts, lists, rays = (x.to(cuda) for x in kb.light_batch(case))
    before = light_cull.light_sums_rows.launches
    got = light_cull.light_sums_rows(lr, counts, lists, rays)
    want = light_cull._light_sums_plain(counts, lists, rays, lr)
    torch.cuda.synchronize()
    assert light_cull.light_sums_rows.launches == before + 1
    assert int((want > 0).sum()) > 40
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_light_kernel_refuses_misaligned_rows(cuda):
    """The kernel copies a cluster's rows in 16-byte pieces: light rows
    that do not start on a 16-byte boundary are refused, not launched."""
    lr, counts, lists, rays = (x.to(cuda) for x in kb.light_batch("counts"))
    flat = torch.zeros(lr.numel() + 1, device=cuda)
    shifted = flat[1:].view(lr.shape)
    shifted.copy_(lr)
    before = light_cull.light_sums_rows.launches
    with pytest.raises(ValueError):
        light_cull.light_sums_rows(shifted, counts, lists, rays)
    assert light_cull.light_sums_rows.launches == before


def _cornell_on(cuda, tmp_path):
    from raytracer_odin_tpu_torch.io import gltf
    from raytracer_odin_tpu_torch.models import assets, build

    host = gltf.read_gltf(assets.generate("cornell", tmp_path)["gltf"])
    return host, build.finish_scene(host, device=cuda)


@pytest.mark.gpu
def test_pool_wave_kernels_bit_equal(cuda, monkeypatch, tmp_path):
    """K1 and K2 on a pool wave's batch (ops/wavefront.py through
    "pallas": lanes of different bounces and samples, sorted by their masks,
    dead lanes last), recorded as the route builds them, each bit-equal to
    its plain version."""
    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.render import accum, runtime
    from raytracer_odin_tpu_torch.utils import prng

    host, sc = _cornell_on(cuda, tmp_path)
    packed, swept = [], []
    real_pack, real_sweep = pi.pack_rays, traverse._sweep_exact

    def pack(o, d):
        out = real_pack(o, d)
        packed.append(out[0].clone())
        return out

    def sweep(scene, words, rays, g, n_super, cap=256):
        swept.append((words.clone(), rays.clone()))
        return real_sweep(scene, words, rays, g, n_super, cap)

    monkeypatch.setattr(pi, "pack_rays", pack)
    monkeypatch.setattr(traverse, "_sweep_exact", sweep)
    cfg = RenderConfig(width=64, height=64, ray_depth=4, samples=2,
                       samples_per_step=2, intersector="pallas",
                       wavefront_pool=True, pool_fraction=0.5)
    step = runtime.make_pool_render_step(cfg, host.cam.fov_x, device=cuda)
    stats = accum.init_stats(1, 64, 64, device=cuda)
    step(sc, stats, prng.key_from_seed(0), 0)
    monkeypatch.undo()
    assert step.waves[0] == len(swept) == len(packed) > 4
    _, n_super, aabb8 = traverse.exact_cull_layout(sc)
    k = len(swept) // 2  # a wave of the steady state
    words, rays = swept[k]
    got_k1 = pi.cluster_masks_rows(aabb8, packed[k], n_super)
    assert torch.equal(got_k1,
                       pi._cluster_masks_plain(aabb8, packed[k], n_super))
    counts, lists = traverse.exact_lists(words, n_super)
    got = pi.intersect_culled_rows(sc.ptri, counts, lists, rays)
    want = pi._culled_plain(counts, lists, rays, sc.ptri)
    torch.cuda.synchronize()
    assert int((want[1] >= 0).sum()) > 100
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _compacted_batches(cuda, tmp_path, monkeypatch, **switches):
    """The sweeps' (words, rays) of one compacted cornell sample (64x64,
    depth 5) with the integrator's `switches` set, recorded as the route
    builds them: bounce 0's tiles, then one batch a bounce."""
    from raytracer_odin_tpu_torch.ops import integrator
    from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
    from raytracer_odin_tpu_torch.render import runtime
    from raytracer_odin_tpu_torch.utils import prng

    host, sc = _cornell_on(cuda, tmp_path)
    swept = []
    real_sweep = traverse._sweep_exact

    def sweep(scene, words, rays, g, n_super, cap=256):
        swept.append((words.clone(), rays.clone()))
        return real_sweep(scene, words, rays, g, n_super, cap)

    for name, value in switches.items():
        monkeypatch.setattr(integrator, name, value)
    monkeypatch.setattr(traverse, "_sweep_exact", sweep)
    opts = TraceOptions(depth=5, intersector="pallas",
                        lane_schedule=(4096,) * 4)
    _, aux = runtime.sample_pass(sc, prng.key_from_seed(0), 0,
                                 host.cam.fov_x, 64, 64, opts)
    monkeypatch.undo()
    assert int(aux["overflow"]) == 0 and len(swept) == 5
    return sc, swept


def _k1_k2_bit_equal(sc, words, rays):
    _, n_super, aabb8 = traverse.exact_cull_layout(sc)
    assert torch.equal(pi.cluster_masks_rows(aabb8, rays, n_super),
                       pi._cluster_masks_plain(aabb8, rays, n_super))
    counts, lists = traverse.exact_lists(words, n_super)
    got = pi.intersect_culled_rows(sc.ptri, counts, lists, rays)
    want = pi._culled_plain(counts, lists, rays, sc.ptri)
    torch.cuda.synchronize()
    assert int((want[1] >= 0).sum()) > 100
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_cols_bounce1_kernels_bit_equal(cuda, monkeypatch, tmp_path):
    """K1 and K2 on the columnar trace's sorted bounce-1 batch (COLS = 1:
    kernel rows built from the [12, N] column state), each bit-equal to
    its plain version."""
    sc, swept = _compacted_batches(cuda, tmp_path, monkeypatch, COLS=1)
    _k1_k2_bit_equal(sc, *swept[1])


def _subprocess(env, code):
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    full = dict(os.environ, **env)
    full["PYTHONPATH"] = os.pathsep.join(
        [str(root), str(root / "tests"), full.get("PYTHONPATH", "")])
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=full,
                          capture_output=True, text=True, timeout=900)


@pytest.mark.gpu
def test_refused_rb_sub_raises_before_launch(cuda):
    """RT_TPU_RB_SUB=384 (no divisor of RT_TPU_RB=512) stops the port's
    import with a ValueError naming it: nothing is built or launched."""
    proc = _subprocess({"RT_TPU_RB_SUB": "384"}, (
        "import torch\n"
        "import raytracer_odin_tpu_torch.ops.integrator\n"
        "print('launched')"))
    assert proc.returncode != 0 and "launched" not in proc.stdout
    last = proc.stderr.strip().splitlines()[-1]
    assert last.startswith("ValueError") and "RT_TPU_RB_SUB" in last


_LAYOUT_KERNELS = """
import numpy as np, torch
from raytracer_odin_tpu_torch.ops import cuda_build, traverse
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
dev = torch.device("cuda", 0)
rng = np.random.default_rng(2)
p = rng.uniform(-5, 5, (900, 3)).astype(np.float32)
u = rng.uniform(-1, 1, (900, 3)).astype(np.float32)
v = rng.uniform(-1, 1, (900, 3)).astype(np.float32)
tris = torch.from_numpy(pi.pad_triangles(p, u, v)).to(dev)
o = rng.uniform(-8, 8, (4 * pi.RB, 3)).astype(np.float32)
d = p[rng.integers(0, 900, 4 * pi.RB)] - o
d /= np.linalg.norm(d, axis=-1, keepdims=True)
rays, _, _ = pi.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
rays = rays.to(dev)
nc = tris.shape[0] // pi.LEAF
lo = tris[:, 0:3].reshape(nc, pi.LEAF, 3)
aabb8 = torch.zeros((-(-nc // 32) * 32, 8), device=dev)
aabb8[:, 0:3] = pi.BIG
aabb8[:, 3:6] = -pi.BIG
corners = torch.stack([lo, lo + tris[:, 3:6].reshape(nc, pi.LEAF, 3),
                       lo + tris[:, 6:9].reshape(nc, pi.LEAF, 3)])
real = (tris[:, 0] < pi.BIG).reshape(nc, pi.LEAF)[None, :, :, None]
aabb8[:nc, 0:3] = torch.where(real, corners, pi.BIG).amin((0, 2))
aabb8[:nc, 3:6] = torch.where(real, corners, -pi.BIG).amax((0, 2))
words = pi.cluster_masks_rows(aabb8, rays, nc)
assert torch.equal(words, pi._cluster_masks_plain(aabb8, rays, nc))
counts, lists = traverse.exact_lists(words, nc, cap=nc)
for got, want in (
        (pi.intersect_culled_rows(tris, counts, lists, rays),
         pi._culled_plain(counts, lists, rays, tris, pi.RB_SUB)),
        (pi.intersect_brute_rows(tris, rays),
         pi._culled_plain(torch.full((rays.shape[1] // pi.RB,), -1,
                                     dtype=torch.int32, device=dev),
                          torch.zeros((rays.shape[1] // pi.RB, 1),
                                      dtype=torch.int32, device=dev),
                          rays, tris, pi.RB))):
    torch.cuda.synchronize()
    assert int((want[1] >= 0).sum()) > 100
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
print(cuda_build._SO.name)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("env", [{"RT_TPU_LEAF": "32"},
                                 {"RT_TPU_RB": "256", "RT_TPU_RB_SUB": "128"}],
                         ids=["leaf32", "rb256_sub128"])
def test_honoured_layout_kernels_bit_equal(cuda, env):
    """A layout the JAX package's variables set builds its own library
    (nvcc with the layout's defines) whose K1, K2 and K3 are bit-equal to
    their plain versions at that layout."""
    proc = _subprocess(env, _LAYOUT_KERNELS)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "_".join(env.get(k, dflt) for k, dflt in (
        ("RT_TPU_LEAF", "64"), ("RT_TPU_RB", "512"),
        ("RT_TPU_RB_SUB", "256"))) in proc.stdout


def _mesh_matches_single(cuda, tmp_path, devices):
    """A 2 x 1 tile mesh over `devices`, compacted with each tile's own
    budgets, is bit-identical to the single-card compacted render on
    `cuda`."""
    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.parallel import mesh as pmesh
    from raytracer_odin_tpu_torch.render import accum, runtime

    host, sc = _cornell_on(cuda, tmp_path)
    cfg = RenderConfig(width=96, height=64, ray_depth=4, samples=4,
                       samples_per_step=2, intersector="pallas",
                       compact="auto")
    fov = host.cam.fov_x
    single = runtime.render_scene(sc, cfg, fov, device=cuda)
    mesh = pmesh.make_mesh(n_tile=2, devices=devices)
    rs = pmesh.replicate_scene(sc, mesh)
    step = pmesh.make_sharded_render_step(cfg, fov, mesh, rs)
    res = runtime.render_scene(
        rs, cfg, fov, device=cuda, step_fn=step,
        make_stats=lambda: pmesh.shard_stats(
            accum.init_stats(1, 64, 96, device=cuda), mesh))
    assert res.overflow == 0 and step.lane_schedule is not None
    assert res.rays_cast == single.rays_cast
    for f in ("first", "last", "total", "total_sq", "count"):
        assert torch.equal(getattr(res.stats, f), getattr(single.stats, f)), f


def _cards(n: int) -> list:
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices ({torch.cuda.device_count()} "
                    "here)")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.gpu
def test_two_shard_mesh_bit_equal(cuda, tmp_path):
    """A 2 x 1 tile mesh of cuda:0 twice is bit-identical to the
    single-card compacted render."""
    _mesh_matches_single(cuda, tmp_path, [cuda, cuda])


@pytest.mark.gpu
def test_two_card_mesh_bit_equal(cuda, tmp_path):
    """The 2 x 1 tile mesh over cuda:0 and cuda:1: tile 1's kernels launch
    on cuda:1 while cuda:0 is the current device, and the frame is
    bit-identical to the single card's."""
    _mesh_matches_single(cuda, tmp_path, _cards(2))


@pytest.mark.gpu
def test_kernels_launch_on_any_card(cuda):
    """K1 and K2 on every card, each launched while cuda:0 is the current
    device, equal their plain versions bit for bit."""
    rng = np.random.default_rng(12)
    n_clusters = 111
    lo = rng.uniform(-8, 8, (n_clusters, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.2, 3, (n_clusters, 3)).astype(np.float32)
    aabb = np.zeros((128, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = pi.BIG, -pi.BIG
    aabb[:n_clusters, 0:3], aabb[:n_clusters, 3:6] = lo, hi
    tris = _tris(rng, 3000)
    nc = tris.shape[0] // pi.LEAF
    rays = _rays(rng, 8192, tris)
    nsb = rays.shape[1] // pi.RB_SUB
    counts = rng.integers(0, 40, nsb).astype(np.int32)
    lists = np.stack([rng.permutation(nc) for _ in range(nsb)]).astype(
        np.int32)
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        r, a = rays.to(dev), torch.from_numpy(aabb).to(dev)
        t = torch.from_numpy(tris).to(dev)
        c = torch.from_numpy(counts).to(dev)
        lst = torch.from_numpy(lists).to(dev)
        with torch.cuda.device(cuda):
            words = pi.cluster_masks_rows(a, r, n_clusters)
            hits = pi.intersect_culled_rows(t, c, lst, r)
        torch.cuda.synchronize(dev)
        assert torch.equal(words, pi._cluster_masks_plain(a, r, n_clusters))
        want = pi._culled_plain(c, lst, r, t)
        assert torch.equal(hits.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_cli_every_card(cuda, tmp_path):
    """--devices 0 renders over every card (a tile mesh): its PNG is the
    bytes of --devices 1's."""
    from raytracer_odin_tpu_torch import cli
    from raytracer_odin_tpu_torch.models import assets

    _cards(2)
    scene = assets.generate("cornell", tmp_path)["gltf"]
    pngs = []
    for n in ("1", "0"):
        out = tmp_path / f"devices{n}.png"
        rc = cli.main([str(scene), str(out), "--width", "64", "--height",
                       "40", "--ray-depth", "3", "--num-samples", "2",
                       "--intersector", "pallas", "--devices", n, "--quiet"])
        assert rc == 0
        pngs.append(out.read_bytes())
    assert pngs[0] == pngs[1]


@pytest.mark.gpu
@pytest.mark.parametrize("scene,depth", [("textured", 8), ("envmap", 8)])
def test_accuracy_step_sizes_bit_equal(cuda, monkeypatch, tmp_path, scene,
                                       depth):
    """The accuracy harness's proxy and draw step (a step's samples traced
    as one batch of lanes through K1 + K2) gives the same statistics on
    the card whether a step holds 1 or 16 samples, and the same as the
    runtime's own uncompacted step, mean and variance; it launches K1 and
    K2 once a bounce of each trace."""
    from raytracer_odin_tpu_torch.accuracy import configs, render
    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.render import runtime as rt

    monkeypatch.setattr(configs, "SCENE_DIR", tmp_path)
    host, sc = configs.load_scene(scene, cuda)
    w, h = 128, 96
    fov = host.cam.fov_x * (w / h)
    one = render.render_stats(sc, fov, w, h, depth, 16, device=cuda,
                              batch=1)
    k1, k2 = pi.cluster_masks_rows.launches, pi.intersect_culled_rows.launches
    batched = render.render_stats(sc, fov, w, h, depth, 16, device=cuda,
                                  batch=16)
    assert pi.cluster_masks_rows.launches - k1 == depth
    assert pi.intersect_culled_rows.launches - k2 == depth
    cfg = RenderConfig(width=w, height=h, ray_depth=depth, samples=16,
                       samples_per_step=8, debug_features=False,
                       compact="off")
    st = rt.render_scene(sc, cfg, fov, device=cuda).stats
    n = st.count[0].cpu().numpy().astype(np.float64)[..., None]
    mean = st.total[0].cpu().numpy().astype(np.float64) / n
    var = np.maximum(st.total_sq[0].cpu().numpy().astype(np.float64) / n
                     - mean**2, 0.0)
    for a, b, c in zip(one, batched, (mean, var)):
        assert np.array_equal(a, b)
        assert np.array_equal(a, c.astype(np.float32))
