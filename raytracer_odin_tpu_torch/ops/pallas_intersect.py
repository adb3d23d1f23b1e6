"""Intersection kernels (port of raytracer_odin_tpu/ops/pallas_intersect.py).

The JAX module holds the Pallas TPU kernels; this module holds their
Hopper replacements, written by hand in CUDA (csrc/intersect_kernels.cu),
next to a plain PyTorch version of each:

  * K1 `cluster_masks_rows` — exact per-ray cluster masks, bit-packed
    (replaces `_mask_kernel`).
  * K2 `intersect_culled_rows` — list-driven Moller-Trumbore sweep of each
    RB_SUB-ray sub-block's cluster list (replaces `_culled_kernel`).

A wrapper launches its CUDA kernel for tensors on a CUDA device and counts
the launch in its `launches` attribute; it runs the plain version only for
tensors on the CPU, and raises for anything else. There is no fallback from
the kernel to the plain version. The plain versions repeat the kernels'
arithmetic expression by expression, so on the card the two agree bit for
bit (chip_smoke.py checks it at the main path's shapes).

Layouts are the JAX package's: rays [8, Npad] f32 rows (o.xyz, d.xyz, 2
spare), masks [W, Npad] int32 words, hits [8, Npad] f32 rows (t, triangle
index as f32 with -1 on a miss, 6 zero rows), triangles [Tpad, 12] f32 rows
(p.xyz u.xyz v.xyz, 3 pad) in BVH order, LEAF-padded.
"""

from __future__ import annotations

import numpy as np
import torch

LEAF = 64      # triangles per cluster
RB = 512       # rays per bundle: lane counts are padded to RB multiples
RB_SUB = 256   # rays per cluster list (one K2 thread block)
BIG = 3.0e38
# Above this many padded triangles the JAX package streams the triangle
# array through K4 (`_culled_stream_kernel`, 128-wide rows), not ported yet.
STREAM_TRIS = 8 * 24 * 1024
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
    if tpad > STREAM_TRIS:
        raise NotImplementedError(
            f"{tpad} padded triangles need the streamed sweep (K4), which "
            "is not ported yet"
        )
    arr = np.zeros((tpad, 12), np.float32)
    arr[:t, 0:3] = np.asarray(tri_p)
    arr[:t, 3:6] = np.asarray(tri_u)
    arr[:t, 6:9] = np.asarray(tri_v)
    arr[t:, 0:3] = BIG
    return arr


def _check(name, x, dtype, ndim, device):
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{name}: want contiguous {dtype} with {ndim} dims, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, want {device}")


def _stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: exact per-ray cluster masks.
# ---------------------------------------------------------------------------

def _cluster_masks_plain(aabb8, rays, n_bits: int):
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
            word = torch.where(hit, bits[:, None], 0).sum(dim=0)
            used = n_bits - w * 32
            if used <= 0:
                word = torch.zeros_like(word)
            elif used < 32:
                word = word & ((1 << used) - 1)
            out[w, s:e] = word.to(torch.int32)
    return out


def cluster_masks_rows(aabb8, rays, n_clusters: int | None = None):
    """Exact per-ray cluster masks (K1). aabb8 [S_pad, 8] f32 (S_pad % 32
    == 0; pad rows (BIG, -BIG)), rays [8, Npad] f32 rows. Returns [W, Npad]
    int32 words, W = S_pad // 32: bit c % 32 of word c // 32 is the slab hit
    of cluster c. With n_clusters set, bits >= n_clusters are zeroed (the
    sort-key header fold and dead-lane compaction require it)."""
    dev = rays.device
    _check("rays", rays, torch.float32, 2, dev)
    _check("aabb8", aabb8, torch.float32, 2, dev)
    s_pad = aabb8.shape[0]
    if rays.shape[0] != 8 or aabb8.shape[1] != 8 or s_pad % 32:
        raise ValueError(f"bad shapes {tuple(rays.shape)} {tuple(aabb8.shape)}")
    n_words = s_pad // 32
    n_bits = s_pad if n_clusters is None else int(n_clusters)
    if dev.type == "cpu":
        return _cluster_masks_plain(aabb8, rays, n_bits)
    if dev.type != "cuda":
        raise ValueError(f"cluster_masks_rows: unsupported device {dev}")
    if s_pad * 6 * 4 > 48 * 1024:
        raise ValueError(f"{s_pad} boxes exceed the kernel's shared memory")
    from raytracer_odin_tpu_torch.ops import cuda_build

    npad = rays.shape[1]
    out = torch.empty((n_words, npad), dtype=torch.int32, device=dev)
    if npad == 0:
        return out
    rc = cuda_build.load().rt_mask_launch(
        rays.data_ptr(), aabb8.data_ptr(), out.data_ptr(),
        npad, s_pad, n_words, n_bits, _stream_of(dev),
    )
    if rc != 0:
        raise RuntimeError(f"mask kernel launch failed: cudaError {rc}")
    cluster_masks_rows.launches += 1
    return out


cluster_masks_rows.launches = 0


# ---------------------------------------------------------------------------
# K2: list-driven culled sweep.
# ---------------------------------------------------------------------------

def _culled_plain(counts, lists, rays, tris):
    """Plain PyTorch version of K2: list position k of every sub-block at
    once, sub-blocks in chunks so intermediates stay near 1 GB at most."""
    npad = rays.shape[1]
    dev = rays.device
    nsb = npad // RB_SUB
    n_clusters = tris.shape[0] // LEAF
    width = lists.shape[1]
    tri9 = tris[:, :9].reshape(n_clusters, LEAF, 9)
    rows = torch.arange(LEAF, dtype=torch.float32, device=dev)[None, :, None]
    overflow = counts < 0
    n_of = torch.where(overflow, n_clusters, counts)
    out = torch.zeros((8, npad), dtype=torch.float32, device=dev)
    chunk = max(1, _SWEEP_CHUNK_ELEMS // (LEAF * RB_SUB))
    for s0 in range(0, nsb, chunk):
        s1 = min(nsb, s0 + chunk)
        r = rays[:, s0 * RB_SUB:s1 * RB_SUB].reshape(8, s1 - s0, 1, RB_SUB)
        ox, oy, oz, dx, dy, dz = (r[i] for i in range(6))  # [nb, 1, RB_SUB]
        best_t = torch.full((s1 - s0, 1, RB_SUB), BIG, dtype=torch.float32,
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
            tr = tri9[cid]                                  # [nb, LEAF, 9]
            px, py, pz = tr[..., 0:1], tr[..., 1:2], tr[..., 2:3]
            ux, uy, uz = tr[..., 3:4], tr[..., 4:5], tr[..., 5:6]
            vx, vy, vz = tr[..., 6:7], tr[..., 7:8], tr[..., 8:9]
            # pvec = d x v  -> [nb, LEAF, RB_SUB]
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
            inside = torch.minimum(torch.minimum(bu, bv), 1.0 - (bu + bv)) >= 0
            ok = inside & (t > 0) & (t < best_t)
            t_ok = torch.where(ok, t, BIG)
            tmin = t_ok.amin(dim=1, keepdim=True)           # [nb, 1, RB_SUB]
            better = (tmin < best_t) & active[:, None, None]
            # smallest row achieving tmin
            win_row = torch.where(t_ok <= tmin, rows, float(LEAF)).amin(
                dim=1, keepdim=True)
            idx = (cid * LEAF).to(torch.float32)[:, None, None] + win_row
            best_i = torch.where(better, idx, best_i)
            best_t = torch.where(better, tmin, best_t)
        out[0, s0 * RB_SUB:s1 * RB_SUB] = best_t.reshape(-1)
        out[1, s0 * RB_SUB:s1 * RB_SUB] = best_i.reshape(-1)
    return out


def intersect_culled_rows(scene_tris, counts, lists, rays):
    """Nearest hit of every ray against its RB_SUB sub-block's cluster list
    (K2). scene_tris [Tpad, 12] f32; counts [NSB] int32 (-1: sweep every
    cluster); lists [NSB, C] int32 (entries beyond the count are ignored);
    rays [8, Npad] f32 rows with the RAY_EPS offset applied, Npad a multiple
    of RB_SUB. Returns [8, Npad] f32 rows (t, index as f32, 6 zero rows);
    t is BIG and the index -1 on a miss."""
    dev = rays.device
    _check("rays", rays, torch.float32, 2, dev)
    _check("scene_tris", scene_tris, torch.float32, 2, dev)
    _check("counts", counts, torch.int32, 1, dev)
    _check("lists", lists, torch.int32, 2, dev)
    npad = rays.shape[1]
    if (rays.shape[0] != 8 or npad % RB_SUB or scene_tris.shape[1] != 12
            or scene_tris.shape[0] % LEAF
            or counts.shape[0] != npad // RB_SUB
            or lists.shape[0] != counts.shape[0] or lists.shape[1] < 1):
        raise ValueError(
            f"bad shapes rays {tuple(rays.shape)} tris "
            f"{tuple(scene_tris.shape)} counts {tuple(counts.shape)} "
            f"lists {tuple(lists.shape)}"
        )
    if dev.type == "cpu":
        return _culled_plain(counts, lists, rays, scene_tris)
    if dev.type != "cuda":
        raise ValueError(f"intersect_culled_rows: unsupported device {dev}")
    from raytracer_odin_tpu_torch.ops import cuda_build

    out = torch.empty((8, npad), dtype=torch.float32, device=dev)
    if npad == 0:
        return out
    rc = cuda_build.load().rt_culled_launch(
        counts.data_ptr(), lists.data_ptr(), lists.shape[1],
        rays.data_ptr(), npad, scene_tris.data_ptr(),
        scene_tris.shape[0] // LEAF, out.data_ptr(), _stream_of(dev),
    )
    if rc != 0:
        raise RuntimeError(f"sweep kernel launch failed: cudaError {rc}")
    intersect_culled_rows.launches += 1
    return out


intersect_culled_rows.launches = 0
