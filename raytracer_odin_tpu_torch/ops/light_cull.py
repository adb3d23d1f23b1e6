"""Many-light pdf sums over Morton-clustered lights (port of
raytracer_odin_tpu/ops/light_cull.py).

Lights are sorted by the Morton code of their centroid and grouped into
LEAF_L-sized clusters with AABBs at scene build (models/build.py). Each
RB-ray block conservatively culls the light clusters with the bundle
interval test (culling.cull_clusters), and K5 sums fac * t^2/|ng.d| over
the light triangles of only the listed clusters. Clusters admitted by the
conservative cull contribute exact zeros, so a lane's sum does not depend
on its block: it is the sum, in ascending cluster order, of each hit
cluster's 32 contributions added in row order. Unlike the JAX package, the
block bounds leave out lanes whose sum is never read (light_lists).

  * K5 `light_sums_rows` — the cluster-list sum (replaces `_kernel`), a
    CUDA kernel in csrc/intersect_kernels.cu beside its plain PyTorch
    version `_light_sums_plain`. The kernel has the triangle sweep's
    design: each listed cluster's 32 rows staged by cp.async into one of
    two shared-memory stages while the other is tested, each row read as
    four 16-byte loads, 128-ray blocks (four to a 512-ray list), and exact
    warp skips: a 32-ray warp in which no ray has 0 <= bu <= 1 skips the
    rest of a light, and one in which no ray is inside (`light_inside`)
    skips t, the weight and the add. A skipped test is an add of +0 to a
    partial that is never -0, which changes no bit (the kernel's note says
    why), so kernel and plain version agree bit for bit.

The JAX package splits the lists into chunks of ray blocks because its
kernel reads them from the TPU's scalar memory; one CUDA launch takes the
whole list.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_odin_tpu_torch.ops import culling
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops.geometry import BIG, RAY_EPS
from raytracer_odin_tpu_torch.utils import profiling
from raytracer_odin_tpu_torch.utils.env import env_int

LEAF_L = 32  # lights per cluster


def threshold() -> int:
    """The light count from which the culled light pdf (K5) serves a scene;
    below it the dense sum (shading.light_pdf_sum) does. RT_TPU_LIGHT_CULL_MIN
    (default 512), read at every call as the JAX package reads it."""
    return env_int("RT_TPU_LIGHT_CULL_MIN", 512, lambda v: v >= 0,
                   "an integer >= 0 (lights)")


def serves(scene) -> bool:
    """Whether the culled light pdf (K5) serves `scene`: it has lights, and
    at least threshold() of them."""
    n = scene.light_p.shape[0]
    return n > 0 and n >= threshold()


# Light-cluster list length per ray block; longer lists sweep every cluster.
LIST_CAP = 128
ROW_WIDTH = 16  # p(3) u(3) v(3) ng(3) fac valid pad(2)
# Shading points at or beyond this distance are missed rays (o + BIG * d):
# light_lists leaves them out of the block bounds.
FAR = 1e30


def morton_order(centroids: np.ndarray) -> np.ndarray:
    """Sort order by 30-bit Morton code of normalized centroids:
    consecutive lights are spatial neighbours."""
    if len(centroids) == 0:
        return np.zeros(0, np.int64)
    lo = centroids.min(axis=0)
    # uniform scale: a thin axis must not contribute pure noise bits
    span = max(float((centroids.max(axis=0) - lo).max()), 1e-20)
    q = np.clip(((centroids - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def pack_light_rows(p, u, v, ng, fac) -> np.ndarray:
    """[Lpad, 16] f32 rows (Morton-ordered input): p(3) u(3) v(3) ng(3)
    fac(1) valid(1) pad(2); padded with invalid rows to a LEAF_L multiple."""
    n = len(p)
    npad = max(-(-n // LEAF_L) * LEAF_L, LEAF_L)
    rows = np.zeros((npad, ROW_WIDTH), np.float32)
    if n:
        rows[:n, 0:3] = p
        rows[:n, 3:6] = u
        rows[:n, 6:9] = v
        rows[:n, 9:12] = ng
        rows[:n, 12] = fac
        rows[:n, 13] = 1.0
    return rows


def light_cluster_aabbs(rows: np.ndarray):
    """Per-cluster AABBs over the packed rows ([C, 3] lo, [C, 3] hi);
    padding clusters collapse to (BIG, -BIG)."""
    c = rows.shape[0] // LEAF_L
    p = rows[:, 0:3].reshape(c, LEAF_L, 3)
    u = rows[:, 3:6].reshape(c, LEAF_L, 3)
    v = rows[:, 6:9].reshape(c, LEAF_L, 3)
    valid = rows[:, 13].reshape(c, LEAF_L, 1) > 0.5
    corners = np.stack([p, p + u, p + v], axis=2)  # [c, LEAF_L, 3, 3]
    big = np.broadcast_to(np.float32(BIG), corners.shape)
    lo = np.where(valid[..., None], corners, big).min(axis=(1, 2))
    hi = np.where(valid[..., None], corners, -big).max(axis=(1, 2))
    return lo.astype(np.float32), hi.astype(np.float32)


# ---------------------------------------------------------------------------
# K5: per-block light-cluster pdf sums.
# ---------------------------------------------------------------------------

def _light_sums_plain(counts, lists, rays, light_rows):
    """Plain PyTorch version of K5, in the kernel's order: list position k
    of every block at once; within a cluster the 32 contributions are
    added in row order, then the partial sum joins the accumulator. Blocks
    go in chunks so intermediates stay near 1 GB at most."""
    npad = rays.shape[1]
    nb = npad // pi.RB
    out = torch.zeros((npad,), dtype=torch.float32, device=rays.device)
    chunk = max(1, pi._SWEEP_CHUNK_ELEMS // (LEAF_L * pi.RB))
    for b0 in range(0, nb, chunk):
        b1 = min(nb, b0 + chunk)
        out[b0 * pi.RB:b1 * pi.RB] = _light_sums_chunk(
            counts[b0:b1], lists[b0:b1],
            rays[:, b0 * pi.RB:b1 * pi.RB], light_rows)
    return out


def light_inside(bu, bv):
    """The hit test's barycentric terms, in the plain version's form
    (every comparison false on NaN). K5's warp skips rest on it implying
    0 <= bu <= 1."""
    return (bu >= 0) & (bv >= 0) & (bu + bv <= 1)


def light_terms(c, ox, oy, oz, dx, dy, dz):
    """bu, bv and the contribution fac * t^2/|ng.d| (0 where the ray
    misses, at t < 0, for an invalid row, and where it is NaN) of light
    rows c [..., 16] for ray components broadcast against them."""
    px, py, pz = c[..., 0:1], c[..., 1:2], c[..., 2:3]
    ux, uy, uz = c[..., 3:4], c[..., 4:5], c[..., 5:6]
    vx, vy, vz = c[..., 6:7], c[..., 7:8], c[..., 8:9]
    ngx, ngy, ngz = c[..., 9:10], c[..., 10:11], c[..., 11:12]
    fac, valid = c[..., 12:13], c[..., 13:14]
    pvx = dy * vz - dz * vy
    pvy = dz * vx - dx * vz
    pvz = dx * vy - dy * vx
    det = ux * pvx + uy * pvy + uz * pvz
    inv = 1.0 / det
    tx = ox - px
    ty = oy - py
    tz = oz - pz
    bu = (tx * pvx + ty * pvy + tz * pvz) * inv
    qx = ty * uz - tz * uy
    qy = tz * ux - tx * uz
    qz = tx * uy - ty * ux
    bv = (dx * qx + dy * qy + dz * qz) * inv
    t = (vx * qx + vy * qy + vz * qz) * inv
    ok = light_inside(bu, bv) & (t >= 0) & (valid > 0.5)
    # true division: |ng.d| == 0 gives +inf, which is kept
    w = t * t / torch.abs(ngx * dx + ngy * dy + ngz * dz)
    contrib = torch.where(ok, fac * w, 0.0)
    contrib = torch.where(torch.isnan(contrib), 0.0, contrib)
    return bu, bv, contrib


def _light_sums_chunk(counts, lists, rays, light_rows):
    nb = counts.shape[0]
    n_clusters = light_rows.shape[0] // LEAF_L
    width = lists.shape[1]
    lt = light_rows.reshape(n_clusters, LEAF_L, ROW_WIDTH)
    r = rays.reshape(8, nb, pi.RB)
    comps = [r[i][:, None, :] for i in range(6)]
    overflow = counts < 0
    n_of = torch.where(overflow, n_clusters, counts)
    acc = torch.zeros((nb, pi.RB), dtype=torch.float32, device=rays.device)
    for k in range(int(n_of.max())):
        active = k < n_of
        listed = lists[:, min(k, width - 1)]
        # rows past their count read no list entry (cluster 0 is a
        # stand-in that `active` discards)
        cid = torch.where(overflow, k, torch.where(active, listed, 0)).long()
        _, _, contrib = light_terms(lt[cid], *comps)   # [nb, LEAF_L, RB]
        part = torch.zeros_like(acc)
        for j in range(LEAF_L):
            part = part + contrib[:, j]
        acc = torch.where(active[:, None], acc + part, acc)
    return acc.reshape(-1)


def light_sums_rows(light_rows, counts, lists, rays):
    """Per-lane light pdf sums over each RB-ray block's light-cluster list
    (K5). light_rows [Lpad, 16] f32 (pack_light_rows); counts [NB] int32
    (-1: sweep every cluster); lists [NB, C] int32 (entries beyond the
    count are ignored); rays [8, Npad] f32 rows with the RAY_EPS offset
    applied, Npad a multiple of RB. Returns [Npad] f32: the sum of
    fac * t^2/|ng.d| over the listed light triangles hit at t >= 0 (not
    yet divided by the light count)."""
    dev = rays.device
    pi._check("rays", rays, torch.float32, 2, dev)
    pi._check("light_rows", light_rows, torch.float32, 2, dev)
    pi._check("counts", counts, torch.int32, 1, dev)
    pi._check("lists", lists, torch.int32, 2, dev)
    npad = rays.shape[1]
    if (rays.shape[0] != 8 or npad % pi.RB
            or light_rows.shape[1] != ROW_WIDTH
            or light_rows.shape[0] % LEAF_L
            or counts.shape[0] != npad // pi.RB
            or lists.shape[0] != counts.shape[0] or lists.shape[1] < 1):
        raise ValueError(
            f"bad shapes rays {tuple(rays.shape)} light_rows "
            f"{tuple(light_rows.shape)} counts {tuple(counts.shape)} "
            f"lists {tuple(lists.shape)}"
        )
    if dev.type == "cpu":
        return _light_sums_plain(counts, lists, rays, light_rows)
    if dev.type != "cuda":
        raise ValueError(f"light_sums_rows: unsupported device {dev}")
    from raytracer_odin_tpu_torch.ops import cuda_build

    if light_rows.data_ptr() % 16:
        # the kernel copies each cluster's rows in 16-byte pieces
        raise ValueError("light_rows must start on a 16-byte boundary")
    out = torch.empty((npad,), dtype=torch.float32, device=dev)
    if npad == 0:
        return out
    rc = pi._launch(
        cuda_build.load().rt_light_launch, counts.data_ptr(),
        lists.data_ptr(), lists.shape[1], rays.data_ptr(), npad,
        light_rows.data_ptr(), light_rows.shape[0] // LEAF_L, out.data_ptr(),
        device=dev,
    )
    if rc != 0:
        raise RuntimeError(f"light kernel launch failed: cudaError {rc}")
    light_sums_rows.launches += 1
    profiling.count("light_launches")
    return out


light_sums_rows.launches = 0


def light_lists(scene, o, d, cap: int = LIST_CAP):
    """The inputs of K5 for rays o, d [..., 3]: (counts [NB], lists
    [NB, <= cap] ascending light-cluster ids of each RB-ray block's
    conservative bundle cull, rays [8, Npad] RAY_EPS-offset kernel rows,
    lane count).

    Lanes whose sum nobody reads stay out of the block bounds: padding
    lanes, lanes with a non-finite origin or direction (the dead lanes of
    an uncompacted trace carry NaN) and origins beyond FAR (a missed ray's
    o + BIG * d, the far rays of dead compacted lanes). The JAX package
    bounds every lane: one NaN lane makes its block's bounds NaN, the cull
    then drops every cluster and the block's light pdf is 0 for all its
    lanes. Leaving such lanes out keeps every other lane's sum exact, as
    the bounds still cover its ray."""
    o = o + d * RAY_EPS
    o2 = o.reshape(-1, 3)
    d2 = d.reshape(-1, 3)
    n = o2.shape[0]
    npad = -(-n // pi.RB) * pi.RB
    dev = o.device
    keep = torch.zeros((npad, 1), dtype=torch.bool, device=dev)
    keep[:n, 0] = (torch.isfinite(o2).all(-1) & torch.isfinite(d2).all(-1)
                   & (o2.abs().amax(-1) < FAR))
    keep = keep.reshape(npad // pi.RB, pi.RB, 1)
    od = torch.zeros((npad, 6), dtype=torch.float32, device=dev)
    od[:n, 0:3] = o2
    od[:n, 3:6] = d2
    od = od.reshape(npad // pi.RB, pi.RB, 6)
    lo = torch.where(keep, od, float("inf")).amin(1)
    hi = torch.where(keep, od, float("-inf")).amax(1)
    o_lo, d_lo, o_hi, d_hi = lo[:, 0:3], lo[:, 3:6], hi[:, 0:3], hi[:, 3:6]
    mask, _ = culling.cull_clusters(
        o_lo, o_hi, d_lo, d_hi, scene.light_cluster_lo,
        scene.light_cluster_hi,
    )
    counts, lists = culling.build_lists(mask, cap=cap)
    rays, _, _ = pi.pack_rays(o2, d2)
    return counts, lists, rays, n


def light_pdf_sum_culled(scene, o, d, cap: int = LIST_CAP):
    """Culled equivalent of shading.light_pdf_sum (same semantics: RAY_EPS
    offset, t >= 0 hits, fac * t^2/|ng.d|, NaN contributions 0, divided by
    the light count). o, d [..., 3] -> [...]. Tallied as the span
    "light"."""
    with profiling.span("light"):
        counts, lists, rays, n = light_lists(scene, o, d, cap)
        total = light_sums_rows(scene.light_rows, counts, lists, rays)
        return total[:n].reshape(o.shape[:-1]) / scene.light_p.shape[0]
