"""Intersection kernels (port of raytracer_odin_tpu/ops/pallas_intersect.py).

The JAX module holds the Pallas TPU kernels; this module holds their
Hopper replacements, written by hand in CUDA (csrc/intersect_kernels.cu),
next to a plain PyTorch version of each:

  * K1 `cluster_masks_rows` — exact per-ray cluster masks, bit-packed,
    optionally bounded by a per-ray tmax (replaces `_mask_kernel`).
  * K2 `intersect_culled_rows` — list-driven Moller-Trumbore sweep of each
    RB_SUB-ray sub-block's cluster list (replaces `_culled_kernel`).
  * K3 `intersect_brute_rows` — every RB-ray block against every cluster
    (replaces `_brute_kernel`).
  * K4 `intersect_stream_rows` — the K2 sweep with one list per RB-ray
    block, for scenes above STREAM_TRIS (replaces `_culled_stream_kernel`).

K2, K3 and K4 share one cluster test and winner rule: `_culled_plain`
here, and in CUDA one kernel, `culled_kernel`, of which each is an instance
(its list width in rays, and K3's sweep of every cluster, are template
parameters), with warp skips that change no bit.

A wrapper launches its CUDA kernel for tensors on a CUDA device and counts
the launch in its `launches` attribute; it runs the plain version only for
tensors on the CPU, and raises for anything else. There is no fallback from
the kernel to the plain version. The plain versions repeat the kernels'
arithmetic expression by expression, so on the card the two agree bit for
bit (chip_smoke.py checks it at the main path's shapes).

Layouts are the JAX package's: rays [8, Npad] f32 rows (o.xyz, d.xyz, 2
spare), masks [W, Npad] int32 words, hits [8, Npad] f32 rows (t, triangle
index as f32 with -1 on a miss, 6 zero rows), triangles [Tpad, 12] f32 rows
(p.xyz u.xyz v.xyz, 3 pad) in BVH order, LEAF-padded. Streamed scenes keep
the 12-wide rows: the JAX package widens them to 128 only because Mosaic
DMA slices must be 128-lane aligned, and a CUDA block reads 12-wide rows
from device memory as K2 does.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_odin_tpu_torch.utils.env import env_int

# The JAX package's kernel layout, read at import under its variables. The
# CUDA build takes each as a define (ops/cuda_build.py keys its library by
# them), within what its kernels can hold: the sweep stages two clusters of
# LEAF 48-byte rows in shared memory and tests four triangles a step (K3:
# two), and a list covers whole 128-ray thread blocks, as does K5's.
LEAF = env_int("RT_TPU_LEAF", 64, lambda v: v % 4 == 0 and 4 <= v <= 512,
               "a multiple of 4 from 4 to 512 (triangles per cluster)")
RB = env_int("RT_TPU_RB", 512, lambda v: v % 128 == 0 and v > 0,
             "a positive multiple of 128 (rays per bundle)")
RB_SUB = env_int("RT_TPU_RB_SUB", 256, lambda v: v % 128 == 0 and v > 0,
                 "a positive multiple of 128 that divides RT_TPU_RB "
                 "(rays per cluster list)")
if RB % RB_SUB:
    raise ValueError(f"RT_TPU_RB_SUB={RB_SUB} must divide RT_TPU_RB={RB}")
BIG = 3.0e38
# The JAX package's per-call VMEM triangle budget. Resident scenes above it
# are swept there in chunks of this many triangles, merged by strict min-t
# in ascending chunk order; the port sweeps once over chunk-major lists
# (traverse.sweep_lists), which gives the same hits, equal-t ties included.
# RT_TPU_CHUNK_TRIS overrides it at every call (chunk_tris).
CHUNK_TRIS = 24 * 1024
# Above this many padded triangles a scene is streamed: decided once at
# scene build (DeviceScene.stream), it selects RB-lane lists and K4.
# RT_TPU_STREAM_TRIS overrides it at the build (stream_tris).
STREAM_TRIS = 8 * CHUNK_TRIS


def chunk_tris() -> int:
    """Triangles a chunk of the JAX package's resident sweep:
    RT_TPU_CHUNK_TRIS, else CHUNK_TRIS."""
    return env_int("RT_TPU_CHUNK_TRIS", CHUNK_TRIS, lambda v: v >= 1,
                   "an integer >= 1 (triangles)")


def stream_tris() -> int:
    """Padded triangles above which a scene is streamed:
    RT_TPU_STREAM_TRIS, else STREAM_TRIS."""
    return env_int("RT_TPU_STREAM_TRIS", STREAM_TRIS, lambda v: v >= 0,
                   "an integer >= 0 (padded triangles)")


# Mask kernel |d| clamp (sign kept) before the exact reciprocal.
TINY = 1e-30

# Plain-version working-set bounds (elements per intermediate tensor).
_MASK_CHUNK_RAYS = 1 << 16
_SWEEP_CHUNK_ELEMS = 1 << 23


def pack_rays(o, d):
    """[..., 3] x2 -> ([8, Npad], batch_shape, n), Npad a multiple of RB;
    padding lanes are far +x rays that hit nothing."""
    batch_shape = tuple(o.shape[:-1])
    o2 = o.reshape(-1, 3)
    d2 = d.reshape(-1, 3)
    n = o2.shape[0]
    npad = ((n + RB - 1) // RB) * RB
    rays = torch.zeros((8, npad), dtype=torch.float32, device=o.device)
    rays[0:3, :n] = o2.T
    rays[3:6, :n] = d2.T
    if npad != n:
        rays[0, n:] = BIG
        rays[3, n:] = 1.0
    return rays, batch_shape, n


def unpack_hits(out, batch_shape, n):
    """Kernel output rows -> (t, idx int32)."""
    t = out[0, :n].reshape(batch_shape)
    idx = out[1, :n].reshape(batch_shape).to(torch.int32)
    return t, idx


def pad_triangles(tri_p, tri_u, tri_v) -> np.ndarray:
    """Host-side packed triangle rows [Tpad, 12] (numpy), padded to a LEAF
    multiple with degenerate far-away rows."""
    t = np.asarray(tri_p).shape[0]
    tpad = max(((t + LEAF - 1) // LEAF) * LEAF, LEAF)
    arr = np.zeros((tpad, 12), np.float32)
    arr[:t, 0:3] = np.asarray(tri_p)
    arr[:t, 3:6] = np.asarray(tri_u)
    arr[:t, 6:9] = np.asarray(tri_v)
    arr[t:, 0:3] = BIG
    return arr


def list_block(scene) -> int:
    """Lane granularity of the scene's cluster lists: RB for streamed
    scenes (K4), RB_SUB for resident ones (K2)."""
    return RB if scene.stream else RB_SUB


def _check(name, x, dtype, ndim, device):
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} with {ndim} dims, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, want {device}")


def _launch(entry, *args, device):
    """Call a kernel's launch entry with `args` and `device`'s current
    stream, `device` made the current CUDA device for the call: the entries
    set no device, and CUDA refuses a launch into another device's stream
    (a mesh shard on cuda:1 while cuda:0 is current)."""
    with torch.cuda.device(device):
        return entry(*args, torch.cuda.current_stream(device).cuda_stream)


# ---------------------------------------------------------------------------
# K1: exact per-ray cluster masks.
# ---------------------------------------------------------------------------

def _cluster_masks_plain(aabb8, rays, n_bits: int, tmax_row: bool = False):
    """Plain PyTorch version of K1: the same slab test, rays in chunks."""
    n_words = aabb8.shape[0] // 32
    npad = rays.shape[1]
    dev = rays.device
    out = torch.empty((n_words, npad), dtype=torch.int32, device=dev)
    lo = aabb8[:, 0:3]
    hi = aabb8[:, 3:6]
    # Bit b of a word as int64; bit 31 weighs -2^31, so the sum of the
    # disjoint set bits is the word's int32 value exactly.
    bits = torch.tensor(
        [1 << b for b in range(31)] + [-(1 << 31)], dtype=torch.int64,
        device=dev,
    )
    tiny = torch.tensor(TINY, dtype=torch.float32, device=dev)
    for s in range(0, npad, _MASK_CHUNK_RAYS):
        e = min(npad, s + _MASK_CHUNK_RAYS)
        o = rays[0:3, s:e]
        d = rays[3:6, s:e]
        d = torch.where(torch.abs(d) >= tiny, d,
                        torch.where(d < 0, -tiny, tiny))
        iv = 1.0 / d
        for w in range(n_words):
            blo = lo[w * 32:(w + 1) * 32, :, None]  # [32, 3, 1]
            bhi = hi[w * 32:(w + 1) * 32, :, None]
            t1 = (blo - o[None]) * iv[None]          # [32, 3, n]
            t2 = (bhi - o[None]) * iv[None]
            tn = torch.minimum(t1, t2)
            tx = torch.maximum(t1, t2)
            near = torch.maximum(torch.maximum(tn[:, 0], tn[:, 1]), tn[:, 2])
            far = torch.minimum(torch.minimum(tx[:, 0], tx[:, 1]), tx[:, 2])
            hit = (near <= far) & (far >= 0)          # [32, n]
            if tmax_row:
                hit = hit & (near <= rays[6, s:e][None])
            word = torch.where(hit, bits[:, None], 0).sum(dim=0)
            used = n_bits - w * 32
            if used <= 0:
                word = torch.zeros_like(word)
            elif used < 32:
                word = word & ((1 << used) - 1)
            out[w, s:e] = word.to(torch.int32)
    return out


def cluster_masks_rows(aabb8, rays, n_clusters: int | None = None,
                       tmax_row: bool = False):
    """Exact per-ray cluster masks (K1). aabb8 [S_pad, 8] f32 (S_pad % 32
    == 0; pad rows (BIG, -BIG)), rays [8, Npad] f32 rows. Returns [W, Npad]
    int32 words, W = S_pad // 32: bit c % 32 of word c // 32 is the slab hit
    of cluster c. With n_clusters set, bits >= n_clusters are zeroed (the
    sort-key header fold and dead-lane compaction require it).

    tmax_row=True reads a per-ray bound from ray row 6 and adds
    `near <= tmax` to the hit test: a cluster whose slab entry lies beyond
    a hit already found holds no nearer one (two-phase culling's second
    pass, traverse._two_phase_exact). A NaN entry or bound clears the bit.
    Launches are counted in `launches`, those with tmax_row in
    `tmax_launches`."""
    dev = rays.device
    _check("rays", rays, torch.float32, 2, dev)
    _check("aabb8", aabb8, torch.float32, 2, dev)
    s_pad = aabb8.shape[0]
    if rays.shape[0] != 8 or aabb8.shape[1] != 8 or s_pad % 32:
        raise ValueError(f"bad shapes {tuple(rays.shape)} {tuple(aabb8.shape)}")
    n_words = s_pad // 32
    n_bits = s_pad if n_clusters is None else int(n_clusters)
    if dev.type == "cpu":
        return _cluster_masks_plain(aabb8, rays, n_bits, tmax_row)
    if dev.type != "cuda":
        raise ValueError(f"cluster_masks_rows: unsupported device {dev}")
    # the kernel stages the boxes as their 32-byte aabb8 rows
    if s_pad * 8 * 4 > 48 * 1024:
        raise ValueError(f"{s_pad} boxes exceed the kernel's shared memory")
    from raytracer_odin_tpu_torch.ops import cuda_build

    npad = rays.shape[1]
    out = torch.empty((n_words, npad), dtype=torch.int32, device=dev)
    if npad == 0:
        return out
    rc = _launch(
        cuda_build.load().rt_mask_launch, rays.data_ptr(), aabb8.data_ptr(),
        out.data_ptr(), npad, s_pad, n_words, n_bits, int(tmax_row),
        device=dev,
    )
    if rc != 0:
        raise RuntimeError(f"mask kernel launch failed: cudaError {rc}")
    if tmax_row:
        cluster_masks_rows.tmax_launches += 1
    else:
        cluster_masks_rows.launches += 1
    return out


cluster_masks_rows.launches = 0
cluster_masks_rows.tmax_launches = 0


# ---------------------------------------------------------------------------
# K2: list-driven culled sweep.
# ---------------------------------------------------------------------------

def moller_trumbore(tr, ox, oy, oz, dx, dy, dz):
    """The sweep's ray-triangle terms (bu, bv, t), each product and sum
    rounded separately in the kernels' order. tr [..., 9] rows p u v
    (broadcast against the ray components with a trailing axis)."""
    px, py, pz = tr[..., 0:1], tr[..., 1:2], tr[..., 2:3]
    ux, uy, uz = tr[..., 3:4], tr[..., 4:5], tr[..., 5:6]
    vx, vy, vz = tr[..., 6:7], tr[..., 7:8], tr[..., 8:9]
    # pvec = d x v
    pvx = dy * vz - dz * vy
    pvy = dz * vx - dx * vz
    pvz = dx * vy - dy * vx
    det = ux * pvx + uy * pvy + uz * pvz
    inv = 1.0 / det
    tx = ox - px
    ty = oy - py
    tz = oz - pz
    bu = (tx * pvx + ty * pvy + tz * pvz) * inv
    # qvec = tvec x u
    qx = ty * uz - tz * uy
    qy = tz * ux - tx * uz
    qz = tx * uy - ty * ux
    bv = (dx * qx + dy * qy + dz * qz) * inv
    t = (vx * qx + vy * qy + vz * qz) * inv
    return bu, bv, t


def inside_triangle(bu, bv):
    """The sweep's inside test, false on NaN. It implies 0 <= bu <= 1,
    which makes K2's warp skip exact (csrc/intersect_kernels.cu, K2)."""
    return torch.minimum(torch.minimum(bu, bv), 1.0 - (bu + bv)) >= 0


def _culled_plain(counts, lists, rays, tris, block: int = RB_SUB):
    """Plain PyTorch version of K2 (block RB_SUB), K4 (block RB) and K3
    (block RB, every count -1): list position k of every `block`-ray list
    at once, lists in chunks so intermediates stay near 1 GB at most."""
    npad = rays.shape[1]
    dev = rays.device
    nsb = npad // block
    n_clusters = tris.shape[0] // LEAF
    width = lists.shape[1]
    tri9 = tris[:, :9].reshape(n_clusters, LEAF, 9)
    rows = torch.arange(LEAF, dtype=torch.float32, device=dev)[None, :, None]
    overflow = counts < 0
    n_of = torch.where(overflow, n_clusters, counts)
    out = torch.zeros((8, npad), dtype=torch.float32, device=dev)
    chunk = max(1, _SWEEP_CHUNK_ELEMS // (LEAF * block))
    for s0 in range(0, nsb, chunk):
        s1 = min(nsb, s0 + chunk)
        r = rays[:, s0 * block:s1 * block].reshape(8, s1 - s0, 1, block)
        ox, oy, oz, dx, dy, dz = (r[i] for i in range(6))  # [nb, 1, block]
        best_t = torch.full((s1 - s0, 1, block), BIG, dtype=torch.float32,
                            device=dev)
        best_i = torch.full_like(best_t, -1.0)
        n_c = n_of[s0:s1]
        ov_c = overflow[s0:s1]
        for k in range(int(n_c.max()) if s1 > s0 else 0):
            active = k < n_c
            listed = lists[s0:s1, min(k, width - 1)]
            # rows past their count read no list entry (cluster 0 is a
            # stand-in that `active` discards)
            cid = torch.where(ov_c, k, torch.where(active, listed, 0)).long()
            # [nb, LEAF, block]
            bu, bv, t = moller_trumbore(tri9[cid], ox, oy, oz, dx, dy, dz)
            ok = inside_triangle(bu, bv) & (t > 0) & (t < best_t)
            t_ok = torch.where(ok, t, BIG)
            tmin = t_ok.amin(dim=1, keepdim=True)           # [nb, 1, block]
            better = (tmin < best_t) & active[:, None, None]
            # smallest row achieving tmin
            win_row = torch.where(t_ok <= tmin, rows, float(LEAF)).amin(
                dim=1, keepdim=True)
            idx = (cid * LEAF).to(torch.float32)[:, None, None] + win_row
            best_i = torch.where(better, idx, best_i)
            best_t = torch.where(better, tmin, best_t)
        out[0, s0 * block:s1 * block] = best_t.reshape(-1)
        out[1, s0 * block:s1 * block] = best_i.reshape(-1)
    return out


def _check_sweep(scene_tris, counts, lists, rays, block: int):
    dev = rays.device
    _check("rays", rays, torch.float32, 2, dev)
    _check("scene_tris", scene_tris, torch.float32, 2, dev)
    _check("counts", counts, torch.int32, 1, dev)
    _check("lists", lists, torch.int32, 2, dev)
    npad = rays.shape[1]
    if (rays.shape[0] != 8 or npad % block or scene_tris.shape[1] != 12
            or scene_tris.shape[0] % LEAF
            or counts.shape[0] != npad // block
            or lists.shape[0] != counts.shape[0] or lists.shape[1] < 1):
        raise ValueError(
            f"bad shapes rays {tuple(rays.shape)} tris "
            f"{tuple(scene_tris.shape)} counts {tuple(counts.shape)} "
            f"lists {tuple(lists.shape)} for {block}-ray lists"
        )
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _sweep_launch(wrapper, entry, scene_tris, rays, counts=None,
                  lists=None):
    """Launch one instance of the sweep kernel (K2, K4 with their lists;
    K3 without) into a new [8, Npad] output, counted in
    `wrapper.launches`."""
    from raytracer_odin_tpu_torch.ops import cuda_build

    if scene_tris.data_ptr() % 16:
        # the kernel copies each cluster's rows in 16-byte pieces
        raise ValueError("scene_tris must start on a 16-byte boundary")
    dev = rays.device
    npad = rays.shape[1]
    out = torch.empty((8, npad), dtype=torch.float32, device=dev)
    if npad == 0:
        return out
    listed = (() if counts is None
              else (counts.data_ptr(), lists.data_ptr(), lists.shape[1]))
    rc = _launch(
        getattr(cuda_build.load(), entry), *listed, rays.data_ptr(), npad,
        scene_tris.data_ptr(), scene_tris.shape[0] // LEAF, out.data_ptr(),
        device=dev,
    )
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError {rc}")
    wrapper.launches += 1
    return out


def intersect_culled_rows(scene_tris, counts, lists, rays):
    """Nearest hit of every ray against its RB_SUB sub-block's cluster list
    (K2). scene_tris [Tpad, 12] f32; counts [NSB] int32 (-1: sweep every
    cluster); lists [NSB, C] int32 (entries beyond the count are ignored);
    rays [8, Npad] f32 rows with the RAY_EPS offset applied, Npad a multiple
    of RB_SUB. Returns [8, Npad] f32 rows (t, index as f32, 6 zero rows);
    t is BIG and the index -1 on a miss."""
    dev = _check_sweep(scene_tris, counts, lists, rays, RB_SUB)
    if dev.type == "cpu":
        return _culled_plain(counts, lists, rays, scene_tris, RB_SUB)
    return _sweep_launch(intersect_culled_rows, "rt_culled_launch",
                         scene_tris, rays, counts, lists)


intersect_culled_rows.launches = 0


# ---------------------------------------------------------------------------
# K4: streamed sweep (one list per RB-ray block).
# ---------------------------------------------------------------------------

def intersect_stream_rows(scene_tris, counts, lists, rays):
    """intersect_culled_rows for streamed scenes (K4): one cluster list per
    RB-ray block, of any length. counts [NB] int32 (-1: sweep every
    cluster), lists [NB, C] int32, rays [8, Npad] RAY_EPS-offset rows, Npad
    a multiple of RB. Returns [8, Npad] f32 rows (t, index as f32, 6 zero
    rows)."""
    dev = _check_sweep(scene_tris, counts, lists, rays, RB)
    if dev.type == "cpu":
        return _culled_plain(counts, lists, rays, scene_tris, RB)
    return _sweep_launch(intersect_stream_rows, "rt_stream_launch",
                         scene_tris, rays, counts, lists)


intersect_stream_rows.launches = 0


# ---------------------------------------------------------------------------
# K3: brute sweep (every RB-ray block against every cluster).
# ---------------------------------------------------------------------------

def _brute_plain(rays, tris):
    """Plain PyTorch version of K3: K4's plain sweep with every count -1."""
    nb = rays.shape[1] // RB
    counts = torch.full((nb,), -1, dtype=torch.int32, device=rays.device)
    lists = torch.zeros((nb, 1), dtype=torch.int32, device=rays.device)
    return _culled_plain(counts, lists, rays, tris, RB)


def intersect_brute_rows(scene_tris, rays):
    """Nearest hit of every ray against every triangle cluster (K3).
    scene_tris [Tpad, 12] f32; rays [8, Npad] f32 rows with the RAY_EPS
    offset applied, Npad a multiple of RB. Returns [8, Npad] f32 rows (t,
    index as f32, 6 zero rows); t is BIG and the index -1 on a miss."""
    dev = rays.device
    _check("rays", rays, torch.float32, 2, dev)
    _check("scene_tris", scene_tris, torch.float32, 2, dev)
    npad = rays.shape[1]
    if (rays.shape[0] != 8 or npad % RB or scene_tris.shape[1] != 12
            or scene_tris.shape[0] % LEAF):
        raise ValueError(f"bad shapes rays {tuple(rays.shape)} tris "
                         f"{tuple(scene_tris.shape)}")
    if dev.type == "cpu":
        return _brute_plain(rays, scene_tris)
    if dev.type != "cuda":
        raise ValueError(f"intersect_brute_rows: unsupported device {dev}")
    return _sweep_launch(intersect_brute_rows, "rt_brute_launch",
                         scene_tris, rays)


intersect_brute_rows.launches = 0


def intersect_brute(scene_tris, o, d):
    """Nearest hit of rays o, d [..., 3] against the packed triangle array
    through K3. Returns (t, idx int32) in the batch shape, idx into the
    packed (BVH-permuted) order and -1 on a miss; t WITHOUT the RAY_EPS
    handling (the JAX package's zero bu/bv are not carried)."""
    rays, batch_shape, n = pack_rays(o, d)
    return unpack_hits(intersect_brute_rows(scene_tris, rays), batch_shape, n)
