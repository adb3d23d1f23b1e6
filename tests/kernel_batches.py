"""Adversarial inputs for the port's mask kernel (K1), the sweep kernel of
K2, K3 and K4 and the light kernel K5, and CPU models of the sweep's and
K5's warp skips.

The batches are built with numpy from a seed. Each holds what a sweep's
rounding rules are most likely to get wrong: triangles of a grid mesh that
share edges and vertices, rays aimed exactly at those edges and vertices,
a cluster repeated under another id (equal t in two listed clusters), BIG
pad rows, dead lanes carrying NaN, direction components at +-0 and at the
1e-30 clamp, and warps in which a single lane can pass the bu test.
`dead_lane_frame` is the uncompacted trace's sorted cast at a later
bounce: a whole frame of lanes, a third of them dead with NaN rays, that
traverse.sort_exact turns into K1's and K2's inputs.
The sweep batches come in three forms, one per instance of the sweep
kernel (SWEEPS): K2's 256-ray lists, K4's 512-ray lists, and K3's sweep of
every cluster by every 512-ray block. K5's batches (light_batch) aim the
same rays at light rows: the meshes again, with fac of either sign, and
rows with |ng.d| = 0 for rays straight down, invalid rows with real
geometry, subnormal edges, special fac values and zero pad rows.
`tests/test_torch_gpu.py` holds the CUDA kernels bit-equal to their plain
versions on them; `tests/test_torch_kernel_rules.py` holds the warp-skip
models bit-equal to the plain versions on them, on the CPU. Neither imports
jax, so the card tests run where there is none."""

import numpy as np
import torch

from raytracer_odin_tpu_torch.ops import culling
from raytracer_odin_tpu_torch.ops import light_cull as lc
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops import traverse

GRID = 8          # quads a side of each mesh: 128 triangles, 2 clusters
WARP_RAYS = 32    # rays behind one sweep warp vote: 32 lanes, a ray each
N_RAYS = 16 * pi.RB_SUB  # whole 512-ray blocks
# The sweep kernel's instances: rays a list, and whether every block
# sweeps every cluster (no counts or lists).
SWEEPS = {"K2": (pi.RB_SUB, False), "K4": (pi.RB, False),
          "K3": (pi.RB, True)}


def mesh_rows(z: float, flip: bool = False) -> np.ndarray:
    """[2 * GRID^2, 9] rows p u v of a GRID x GRID quad mesh in the plane
    at height z over [0, GRID]^2: two triangles a quad, sharing its
    diagonal, quads sharing edges and vertices; unit edges, so every
    barycentric on an edge or a vertex is exact."""
    rows = []
    for i in range(GRID):
        for j in range(GRID):
            rows.append([i, j, z, 1, 0, 0, 0, 1, 0])
            rows.append([i + 1, j + 1, z, -1, 0, 0, 0, -1, 0])
    a = np.asarray(rows, np.float32)
    if flip:  # the other winding: det changes sign
        a[:, 3:9] = np.concatenate([a[:, 6:9], a[:, 3:6]], axis=1)
    return a


def triangles() -> np.ndarray:
    """[Tpad, 12] packed rows: clusters 0-1 the mesh at z = 0, 2-3 the
    same rows again (equal t under other ids), 4-5 the mesh at z = -1
    with the other winding, then 20 small triangles and BIG pad rows."""
    rng = np.random.default_rng(70)
    mesh = mesh_rows(0.0)
    small_p = rng.uniform(0, GRID, (20, 3)).astype(np.float32)
    small_p[:, 2] = 0.5
    small = np.concatenate([small_p, np.full((20, 3), 0.25, np.float32),
                            np.float32([[0, 0.25, 0]]).repeat(20, 0)], 1)
    rows = np.concatenate([mesh, mesh, mesh_rows(-1.0, flip=True), small])
    return pi.pad_triangles(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])


def cluster_boxes(tris: np.ndarray, extra: int = 0, seed: int = 71):
    """aabb8 [S_pad, 8] of the clusters of `tris` (flat boxes: lo.z ==
    hi.z), then `extra` random boxes, two of them at +-0 bounds; pad rows
    (BIG, -BIG). Returns (aabb8, n_bits)."""
    rng = np.random.default_rng(seed)
    real = tris[:, 0] < pi.BIG
    p, u, v = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    corners = np.stack([p, p + u, p + v])
    lo_t = np.where(real[:, None], corners.min(0), pi.BIG)
    hi_t = np.where(real[:, None], corners.max(0), -pi.BIG)
    lo, hi = culling.cluster_aabbs(lo_t[real], hi_t[real])
    elo = rng.uniform(-2, GRID + 2, (extra, 3)).astype(np.float32)
    ehi = elo + rng.uniform(0, 3, (extra, 3)).astype(np.float32)
    if extra >= 2:
        elo[0], ehi[0] = np.float32([-0.0, -0.0, -0.0]), np.float32(
            [0.0, 0.0, 0.0])
        elo[1], ehi[1] = np.float32([0.0, -1, -0.0]), np.float32(
            [GRID, -0.0, 0.0])
    lo, hi = np.concatenate([lo, elo]), np.concatenate([hi, ehi])
    n = lo.shape[0]
    s_pad = -(-n // 32) * 32
    aabb = np.zeros((s_pad, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = pi.BIG, -pi.BIG
    aabb[:n, 0:3], aabb[:n, 3:6] = lo, hi
    return aabb, n


def rays(case: str, seed: int = 72) -> torch.Tensor:
    """[8, N_RAYS] f32 ray rows of one adversarial case (o, d; rows 6-7
    zero). Every case mixes in rays aimed at random mesh points so that
    most lists are not empty."""
    rng = np.random.default_rng(seed)
    n = N_RAYS
    target = np.concatenate([rng.uniform(0, GRID, (n, 2)),
                             np.zeros((n, 1))], 1).astype(np.float32)
    o = np.concatenate([rng.uniform(-2, GRID + 2, (n, 2)),
                        rng.uniform(1, 6, (n, 1))], 1).astype(np.float32)
    if case == "shared_edges":
        # grid vertices (up to six triangles meet), edge midpoints and
        # quad diagonals (two triangles share them)
        k = n // 3
        ij = rng.integers(0, GRID + 1, (n, 2)).astype(np.float32)
        target[:k, :2] = ij[:k]
        target[k:2 * k, :2] = ij[k:2 * k] + np.float32([0.5, 0.0])
        target[2 * k:, :2] = np.minimum(ij[2 * k:], GRID - 1) + 0.5
    d = target - o
    if case == "zero_dirs":
        # straight down (dx = dy = +-0), grazing (dz = +-0, origin in the
        # plane), one component at and below the 1e-30 clamp
        d[0::4, 0:2] = np.float32([0.0, -0.0])
        o[1::4, 2] = rng.choice(np.float32([0.0, -0.0]), n // 4)
        d[1::4, 2] = rng.choice(np.float32([0.0, -0.0]), n // 4)
        d[2::4, 0] = np.float32(1e-30)
        d[3::4, 1] = np.float32(-1e-31)
    if case == "nan_lanes":
        # dead lanes: NaN origins and directions, or NaN in one component
        o[0::3] = np.nan
        d[0::3] = np.nan
        d[1::5, 2] = np.nan
        o[2::7, 0] = np.nan
    if case == "one_lane":
        # each warp: every ray meets the mesh plane far outside the mesh
        # (bu fails for every triangle), but one lane aimed at the mesh
        o[:] = np.float32([1000.0, 1500.0, 5.0])
        d[:] = np.float32([0.0, 0.0, -1.0])
        lane = np.arange(0, n, WARP_RAYS) + rng.integers(0, WARP_RAYS,
                                                          n // WARP_RAYS)
        o[lane] = np.float32([4.0, 4.0, 5.0])
        d[lane] = target[lane] - o[lane]
    r, _, _ = pi.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    return r


RAY_CASES = ("nan_lanes", "zero_dirs", "shared_edges", "one_lane")
SWEEP_CASES = ("nan_lanes", "zero_dirs", "shared_edges", "counts", "width1",
               "equal_t", "one_lane")
# K3 reads no counts or lists: its batches differ only in their rays.
KERNEL_CASES = ([(k, c) for k in ("K2", "K4") for c in SWEEP_CASES]
                + [("K3", c) for c in RAY_CASES])


def sweep_batch(case: str, kernel: str = "K2"):
    """(tris, counts, lists, rays) of one adversarial case of a sweep
    instance (SWEEPS), on the CPU. Lists come from the plain K1 masks
    (ascending ids, one a 256- or 512-ray block) unless the case makes its
    own: "counts" sets counts of -1 and 0, "width1" keeps one entry a list
    with counts -1, 0, 1 and 2, "equal_t" lists the mesh and its copy in
    both orders. K3's counts are all -1 (every cluster)."""
    block, every = SWEEPS[kernel]
    tris = torch.from_numpy(triangles())
    nc = tris.shape[0] // pi.LEAF
    aabb, n_bits = cluster_boxes(tris.numpy())
    r = rays(case if case in RAY_CASES else "shared_edges")
    words = pi._cluster_masks_plain(torch.from_numpy(aabb), r, n_bits)
    counts, lists = traverse.exact_lists(words, n_bits, block=block)
    nsb = counts.shape[0]
    if every:
        counts = torch.full((nsb,), -1, dtype=torch.int32)
        lists = torch.zeros((nsb, 1), dtype=torch.int32)
    elif case == "counts":
        counts[0::5] = -1
        counts[3::7] = 0
    elif case == "width1":
        lists = lists[:, :1].contiguous()
        counts = torch.tensor([-1, 0, 1, 2], dtype=torch.int32).repeat(
            -(-nsb // 4))[:nsb].contiguous()
    elif case == "equal_t":
        # clusters 0-1 and 2-3 hold the same rows: the first listed wins
        a = torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.int32)
        b = torch.tensor([2, 3, 0, 1, 5, 4], dtype=torch.int32)
        lists = torch.stack([a if s % 2 else b for s in range(nsb)])
        counts = torch.full((nsb,), 6, dtype=torch.int32)
    assert int(counts.max()) <= nc
    return tris, counts, lists.contiguous(), r


def dead_lane_frame(seed: int = 75):
    """The inputs of traverse.sort_exact on the uncompacted trace's sorted
    cast (cast_rays_pallas(sort=True, alive=...)), on the CPU: (scene, o, d,
    alive, aabb8, n_bits, tris). `scene` holds the cluster boxes sort_exact
    reads; o (RAY_EPS-offset) and d [N, 3] are a frame of N_RAYS - 100
    lanes (the last 512-ray block padded), aimed at the meshes; every third
    lane and a run of 700 are dead and carry NaN, as the trace's dead lanes
    carry garbage."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    n = N_RAYS - 100
    tris = triangles()
    aabb, n_bits = cluster_boxes(tris)
    target = np.concatenate([rng.uniform(0, GRID, (n, 2)),
                             rng.choice(np.float32([0.0, -1.0]), (n, 1))],
                            1).astype(np.float32)
    o = np.concatenate([rng.uniform(-2, GRID + 2, (n, 2)),
                        rng.uniform(1, 6, (n, 1))], 1).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    alive = np.ones(n, bool)
    alive[0::3] = False
    alive[1000:1700] = False
    o[~alive] = np.nan
    d[~alive] = np.nan
    o = o + d * np.float32(traverse.RAY_EPS)
    scene = SimpleNamespace(cluster_lo=torch.from_numpy(aabb[:n_bits, 0:3]),
                            cluster_hi=torch.from_numpy(aabb[:n_bits, 3:6]))
    return (scene, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(alive), torch.from_numpy(aabb), n_bits,
            torch.from_numpy(tris))


# Each instance's wrapper: its `launches` counts the kernel's launches.
WRAPPERS = {"K2": pi.intersect_culled_rows, "K4": pi.intersect_stream_rows,
            "K3": pi.intersect_brute_rows}


def sweep_with_warp_skips(counts, lists, rays_, tris, block=pi.RB_SUB):
    """A CPU model of the CUDA sweep's control flow (K2 at block RB_SUB;
    K4 at block RB; K3 at block RB with every count -1): the plain sweep,
    except that a triangle counts for a ray only when some ray of its
    WARP_RAYS-ray warp has 0 <= bu <= 1 and some ray of it is inside, as
    the kernel skips the rest of the test otherwise. Returns hits
    [8, Npad] like the plain version."""
    npad = rays_.shape[1]
    nsb = npad // block
    n_clusters = tris.shape[0] // pi.LEAF
    tri9 = tris[:, :9].reshape(n_clusters, pi.LEAF, 9)
    out = torch.zeros((8, npad), dtype=torch.float32)
    rows = torch.arange(pi.LEAF, dtype=torch.float32)[:, None]
    for s in range(nsb):
        r = rays_[:, s * block:(s + 1) * block]
        ox, oy, oz, dx, dy, dz = (r[i][None] for i in range(6))
        best_t = torch.full((1, block), pi.BIG)
        best_i = torch.full((1, block), -1.0)
        count = int(counts[s])
        n = n_clusters if count < 0 else count
        for k in range(n):
            cid = k if count < 0 else int(lists[s, min(k, lists.shape[1] - 1)])
            bu, bv, t = pi.moller_trumbore(tri9[cid], ox, oy, oz, dx, dy, dz)
            inside = pi.inside_triangle(bu, bv)             # [LEAF, block]
            warp = (lambda m: m.reshape(pi.LEAF, -1, WARP_RAYS).any(-1)
                    .repeat_interleave(WARP_RAYS, 1))
            tested = warp((bu >= 0) & (bu <= 1)) & warp(inside)
            ok = tested & inside & (t > 0) & (t < best_t)
            t_ok = torch.where(ok, t, pi.BIG)
            tmin = t_ok.amin(0, keepdim=True)
            win = torch.where(t_ok <= tmin, rows, float(pi.LEAF)).amin(
                0, keepdim=True)
            better = tmin < best_t
            best_i = torch.where(better, float(cid * pi.LEAF) + win, best_i)
            best_t = torch.where(better, tmin, best_t)
        out[0, s * block:(s + 1) * block] = best_t[0]
        out[1, s * block:(s + 1) * block] = best_i[0]
    return out


def lanes_passing_bu(counts, lists, rays_, tris, block=pi.RB_SUB):
    """For every (warp, listed triangle) of the sweep of `block`-ray
    lists, how many of the warp's rays have 0 <= bu <= 1: a flat int
    tensor."""
    npad = rays_.shape[1]
    n_clusters = tris.shape[0] // pi.LEAF
    tri9 = tris[:, :9].reshape(n_clusters, pi.LEAF, 9)
    got = []
    for s in range(npad // block):
        r = rays_[:, s * block:(s + 1) * block]
        count = int(counts[s])
        for k in range(n_clusters if count < 0 else count):
            cid = k if count < 0 else int(lists[s, min(k, lists.shape[1] - 1)])
            bu, _, _ = pi.moller_trumbore(tri9[cid], *(r[i][None]
                                                       for i in range(6)))
            p = ((bu >= 0) & (bu <= 1)).reshape(pi.LEAF, -1, WARP_RAYS)
            got.append(p.sum(-1).flatten())
    return torch.cat(got)


def signed_zero_batch():
    """(aabb8, rays, n_bits): boxes with -0 / +0 bounds and rays whose
    origins sit on those bounds, directions +-0, at the clamp and NaN, row 6
    +-0, 1 or NaN. Their slab values are -0 / +0 pairs, where a
    NaN-propagating min or max may return either zero."""
    rng = np.random.default_rng(74)
    faces = np.float32([-0.0, 0.0, 1.0, -1.0])
    lo = rng.choice(faces, (40, 3))
    hi = np.maximum(lo, rng.choice(faces, (40, 3)))
    hi = np.where((hi == 0) & (lo == 0), np.float32(0.0), hi)  # -0 .. +0
    lo[::3] = np.where(lo[::3] == 0, np.float32(-0.0), lo[::3])
    aabb = np.zeros((64, 8), np.float32)
    aabb[:, 0:3], aabb[:, 3:6] = pi.BIG, -pi.BIG
    aabb[:40, 0:3], aabb[:40, 3:6] = lo, hi
    n = 2048
    o = rng.choice(np.float32([-0.0, 0.0, 1.0, -1.0, 0.5]), (n, 3))
    d = rng.choice(np.float32([-0.0, 0.0, 1.0, -1.0, 1e-30, -1e-31, np.nan]),
                   (n, 3))
    r, _, _ = pi.pack_rays(torch.from_numpy(o), torch.from_numpy(d))
    r[6] = torch.from_numpy(rng.choice(np.float32([0.0, -0.0, 1.0, np.nan]),
                                       r.shape[1]))
    return torch.from_numpy(aabb), r, 40


def mask_batch(case: str, tmax_row: bool):
    """(aabb8, rays, n_bits) of one adversarial K1 case on the CPU. For
    "signed_zeros", signed_zero_batch(); else the cluster boxes of
    `triangles()` plus 45 random boxes (n_bits not a multiple of 32; two
    boxes with +-0 bounds) and the rays of the case. With tmax_row, row 6
    of the latter holds bounds that are finite, equal to a slab entry, +-0,
    negative, BIG and NaN."""
    if case == "signed_zeros":
        return signed_zero_batch()
    aabb, n_bits = cluster_boxes(triangles(), extra=45)
    r = rays(case)
    if tmax_row:
        rng = np.random.default_rng(73)
        n = r.shape[1]
        tmax = rng.uniform(0, 8, n).astype(np.float32)
        # rays straight down from z = 5 enter the flat boxes at t = 5
        tmax[0::6] = 5.0
        tmax[1::6] = np.float32(-0.0)
        tmax[2::11] = 0.0
        tmax[3::13] = -1.0
        tmax[4::7] = pi.BIG
        tmax[5::17] = np.nan
        r[6] = torch.from_numpy(tmax)
        r[0:3, 0::6] = torch.tensor([3.5, 2.5, 5.0])[:, None]
        r[3:6, 0::6] = torch.tensor([0.0, 0.0, -1.0])[:, None]
    return torch.from_numpy(aabb), r, n_bits


MASK_CASES = ("nan_lanes", "zero_dirs", "shared_edges", "one_lane",
              "signed_zeros")


# ---------------------------------------------------------------------------
# K5: the light-cluster pdf sum.
# ---------------------------------------------------------------------------

def light_rows() -> np.ndarray:
    """[Lpad, 16] light rows (p u v ng fac valid pad, 10 clusters of 32):
    clusters 0-3 the mesh at z = 0 (ng +z, fac 2), 4-7 the mesh at z = -1
    with the other winding and fac -3, then one cluster of special rows:
    pairs at z = 0.5 with ng along +x (|ng.d| = 0 for rays straight down)
    and fac 2 and -2 (+inf and -inf, a NaN partial), invalid rows with real
    geometry, rows with subnormal edges (det subnormal: the full
    reciprocal), fac NaN, +inf, -0 and subnormal; and the last cluster
    zero pad rows but one, as pack_light_rows pads."""
    rng = np.random.default_rng(75)
    mesh = mesh_rows(0.0)
    lower = mesh_rows(-1.0, flip=True)
    rows = np.zeros((10 * 32, 16), np.float32)
    rows[0:128, 0:9] = mesh
    rows[0:128, 9:12] = [0, 0, 1]
    rows[0:128, 12] = 2.0
    rows[128:256, 0:9] = lower
    rows[128:256, 9:12] = [0, 0, -1]
    rows[128:256, 12] = -3.0
    rows[0:256, 13] = 1.0
    sp = rows[256:288]
    base = mesh[rng.integers(0, len(mesh), 32)]
    sp[:, 0:9] = base
    sp[:, 2] = 0.5
    sp[:, 9:12] = [0, 0, 1]
    sp[:, 12] = rng.uniform(0.5, 4, 32)
    sp[:, 13] = 1.0
    # |ng.d| = 0 for rays straight down, fac of both signs on one spot
    sp[0:8, 9:12] = [1, 0, 0]
    sp[0:8:2, 0:9] = sp[1:8:2, 0:9]
    sp[0:8:2, 12] = 2.0
    sp[1:8:2, 12] = -2.0
    sp[8:14, 13] = 0.0                     # invalid, real geometry
    sp[14:18, 3:9] *= np.float32(1e-39)    # subnormal edges
    sp[18, 12], sp[19, 12] = np.nan, np.inf
    sp[20, 12], sp[21, 12] = -0.0, np.float32(1e-40)
    last = rows[288:320]
    last[0] = sp[24]
    return rows


LIGHT_CASES = ("nan_lanes", "zero_dirs", "shared_edges", "one_lane",
               "counts", "width1")


def light_batch(case: str):
    """(light_rows, counts, lists, rays) of one adversarial K5 case on the
    CPU, one list per 512-ray block: every cluster, in an order that
    differs between blocks, unless the case makes its own: "counts" sets
    counts of -1 and 0 and short lists, "width1" keeps one entry a list
    with counts -1, 0, 1 and 2 (a count past the width repeats the entry)."""
    lr = torch.from_numpy(light_rows())
    nc = lr.shape[0] // 32
    r = rays(case if case in RAY_CASES else "zero_dirs")
    nb = r.shape[1] // pi.RB
    rng = np.random.default_rng(76)
    lists = torch.from_numpy(np.stack([rng.permutation(nc) for _ in
                                       range(nb)]).astype(np.int32))
    counts = torch.full((nb,), nc, dtype=torch.int32)
    if case == "counts":
        counts = torch.tensor([-1, 0, 3, nc, -1, 1, 0, 7],
                              dtype=torch.int32)[:nb].contiguous()
    elif case == "width1":
        lists = lists[:, :1].contiguous()
        counts = torch.tensor([-1, 0, 1, 2], dtype=torch.int32).repeat(
            -(-nb // 4))[:nb].contiguous()
    return lr, counts, lists, r


def light_with_warp_skips(counts, lists, rays_, light_rows_):
    """A CPU model of the CUDA K5's control flow: the plain sum, except
    that a light is added for a ray only when some ray of its WARP_RAYS-ray
    warp has 0 <= bu <= 1 and some ray of it is inside (light_inside), as
    the kernel skips the rest of the test otherwise; a skipped light adds
    nothing to the partial. Returns [Npad] like the plain version."""
    npad = rays_.shape[1]
    n_clusters = light_rows_.shape[0] // lc.LEAF_L
    lt = light_rows_.reshape(n_clusters, lc.LEAF_L, lc.ROW_WIDTH)
    out = torch.zeros((npad,), dtype=torch.float32)

    def warp(m):
        return (m.reshape(lc.LEAF_L, -1, WARP_RAYS).any(-1)
                .repeat_interleave(WARP_RAYS, 1))

    for s in range(npad // pi.RB):
        r = rays_[:, s * pi.RB:(s + 1) * pi.RB]
        comps = [r[i][None] for i in range(6)]
        acc = torch.zeros((pi.RB,), dtype=torch.float32)
        count = int(counts[s])
        for k in range(n_clusters if count < 0 else count):
            cid = k if count < 0 else int(lists[s, min(k, lists.shape[1] - 1)])
            bu, bv, contrib = lc.light_terms(lt[cid], *comps)  # [LEAF_L, RB]
            tested = (warp((bu >= 0) & (bu <= 1))
                      & warp(lc.light_inside(bu, bv)))
            part = torch.zeros((pi.RB,), dtype=torch.float32)
            for j in range(lc.LEAF_L):
                part = torch.where(tested[j], part + contrib[j], part)
            acc = acc + part
        out[s * pi.RB:(s + 1) * pi.RB] = acc
    return out
