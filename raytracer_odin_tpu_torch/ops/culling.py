"""Cull glue between the mask kernel (K1) and the sweeps (K2, K4), and the
conservative bundle-interval cull: port of raytracer_odin_tpu/ops/culling.py.

Per-ray cluster masks are OR-ed over each list block into that block's
exact union work list (ascending cluster ids). The bundle-interval cull
(block_bounds*, cull_clusters) refines the super-cluster masks of the
two-level layout (traverse.sweep_lists) and culls the light clusters of
the many-light pdf (light_cull), and gives the nearest-first list order.
The coherence keys (coherence_keys) order the sorted cast that has no
masks: the brute sweep's (traverse.cast_rays_pallas(culled=False,
sort=True)).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from raytracer_odin_tpu_torch.ops.pallas_intersect import BIG, LEAF
from raytracer_odin_tpu_torch.utils import profiling


def cluster_aabbs(tri_lo: np.ndarray, tri_hi: np.ndarray) -> tuple:
    """Host-side AABBs of consecutive LEAF-sized triangle clusters (BVH
    order), padding clusters collapsed to an unhittable box (numpy)."""
    t = tri_lo.shape[0]
    c = max((t + LEAF - 1) // LEAF, 1)
    lo = np.full((c * LEAF, 3), BIG, np.float32)
    hi = np.full((c * LEAF, 3), -BIG, np.float32)
    lo[:t] = tri_lo
    hi[:t] = tri_hi
    return (
        lo.reshape(c, LEAF, 3).min(axis=1),
        hi.reshape(c, LEAF, 3).max(axis=1),
    )


def block_bounds(o, d, block: int):
    """Per-block bounds of o, d [Npad, 3] (Npad % block == 0). Returns
    (o_lo, o_hi, d_lo, d_hi), [NB, 3] each."""
    nb = o.shape[0] // block
    ob = o.reshape(nb, block, 3)
    db = d.reshape(nb, block, 3)
    return ob.amin(1), ob.amax(1), db.amin(1), db.amax(1)


def block_bounds_rows(rays, block: int):
    """block_bounds of rays packed as [8, Npad] kernel rows (rows 0-2
    origin, 3-5 direction)."""
    nb = rays.shape[1] // block
    o = rays[0:3].reshape(3, nb, block)
    d = rays[3:6].reshape(3, nb, block)
    return (o.amin(2).T, o.amax(2).T, d.amin(2).T, d.amax(2).T)


def cull_clusters(o_lo, o_hi, d_lo, d_hi, clo, chi):
    """Conservative bundle-vs-AABB test of every block [NB, 3] bound
    against every cluster [C, 3]. Returns (hit mask [NB, C] bool, entry
    distance max(near, 0) [NB, C] f32).

    Per axis: the loosest entry over the (origin x direction) intervals and
    the loosest exit; direction intervals straddling or touching zero leave
    the axis unconstrained. Hit iff max(entry) <= min(exit) and exit >= 0.
    Axis-parallel bundles (a direction interval exactly zero) never move on
    that axis, so there the test is origin-interval overlap."""
    o_lo = o_lo[:, None]
    o_hi = o_hi[:, None]
    d_lo = d_lo[:, None]
    d_hi = d_hi[:, None]
    clo = clo[None]
    chi = chi[None]

    straddle = (d_lo <= 0) & (d_hi >= 0)
    # IEEE division: zero endpoints give +/-inf (and straddle anyway)
    inv_a = 1.0 / d_lo
    inv_b = 1.0 / d_hi
    inv_lo = torch.minimum(inv_a, inv_b)
    inv_hi = torch.maximum(inv_a, inv_b)

    # slab offsets: s1 = clo - o in [clo - o_hi, clo - o_lo]
    s1_lo = clo - o_hi
    s1_hi = clo - o_lo
    s2_lo = chi - o_hi
    s2_hi = chi - o_lo

    def imul(a_lo, a_hi, b_lo, b_hi):
        p1 = a_lo * b_lo
        p2 = a_lo * b_hi
        p3 = a_hi * b_lo
        p4 = a_hi * b_hi
        return (
            torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
            torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)),
        )

    t1_lo, t1_hi = imul(s1_lo, s1_hi, inv_lo, inv_hi)
    t2_lo, t2_hi = imul(s2_lo, s2_hi, inv_lo, inv_hi)
    entry_lo = torch.where(straddle, -BIG, torch.minimum(t1_lo, t2_lo))
    exit_hi = torch.where(straddle, BIG, torch.maximum(t1_hi, t2_hi))

    near = entry_lo.amax(dim=-1)
    far = exit_hi.amin(dim=-1)
    hit = (near <= far) & (far >= 0)

    para = (d_lo == 0) & (d_hi == 0)
    overlap = (o_hi >= clo) & (o_lo <= chi)
    hit = hit & torch.where(para, overlap, True).all(dim=-1)
    return hit, torch.clamp(near, min=0.0)


def or_blocks_packed(words, block: int):
    """Row-major [W, Npad] mask words -> per-block OR [NB, W] (a halving
    tree, `block` a power of two: torch has no bitwise-or reduction)."""
    w, npad = words.shape
    x = words.reshape(w, npad // block, block)
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] | x[..., h:]
    return x[..., 0].T.contiguous()


def unpack_mask(words, c: int):
    """[NB, W] int32 -> [NB, C] bool."""
    idx = torch.arange(c, dtype=torch.int32, device=words.device)
    w = words[:, (idx // 32).long()]
    return ((w >> (idx % 32)) & 1).bool()


def build_lists(hit_mask, cap: int | None = None, near=None,
                chunk: int | None = None, overflow_ids: bool = False):
    """[NB, C] bool -> (counts [NB] i32, lists [NB, min(C, cap)] i32): the
    hit cluster ids of each row first, then the others. Order of the hit
    ids: ascending; with `near` [NB, C] (cull_clusters' entry distances)
    nearest-first, equal distances by ascending id (the JAX package's
    unstable sort leaves that tie order open); with `chunk` as well,
    chunk-major (id // chunk) and nearest-first within a chunk. Rows hitting
    more than `cap` clusters get count -1 (sweep every cluster); with
    overflow_ids they keep their true count and list their hit ids in
    ascending order instead, and the lists widen to the longest count."""
    nb, c = hit_mask.shape
    dev = hit_mask.device
    ids = torch.arange(c, dtype=torch.int32, device=dev)
    counts = hit_mask.sum(dim=-1).to(torch.int32)
    capped = cap is not None and cap < c
    if near is None:
        key = torch.where(hit_mask, ids, c + ids)  # unique keys
        lists = torch.argsort(key, dim=-1)
    else:
        if capped and overflow_ids:
            # ids (exact in float32) in place of near on overflowing rows
            over = (counts > cap)[:, None]
            near = torch.where(over, ids.to(near.dtype), near)
        key = torch.where(hit_mask, near, BIG)
        lists = torch.sort(key, dim=-1, stable=True).indices
        if chunk is not None:
            ck = torch.where(hit_mask, ids // chunk, -(-c // chunk))
            ck = torch.gather(ck, 1, lists)
            lists = torch.gather(
                lists, 1, torch.sort(ck, dim=-1, stable=True).indices)
    lists = lists.to(torch.int32)
    if capped:
        width = cap
        if not overflow_ids:
            counts = torch.where(counts > cap, -1, counts)
        elif nb:
            profiling.count("host_syncs")
            width = max(cap, int(counts.max()))
        lists = lists[:, :width]
    return counts, lists.contiguous()


def coherence_keys(o, d, alive, scene_lo, scene_hi):
    """Sort keys grouping rays into coherent bundles without masks:
    (dead last) | direction octant | origin Morton cell on an 8x8x8 grid
    over the scene box | a 4-bit direction cell in the octant. [N] int32,
    the JAX package's keys bit for bit."""
    ext = torch.clamp(scene_hi - scene_lo, min=1e-6)
    cell = torch.clamp(((o - scene_lo) / ext * 8.0).to(torch.int32), 0, 7)

    def spread3(x):
        x = (x | (x << 8)) & 0x0300F
        x = (x | (x << 4)) & 0x030C3
        x = (x | (x << 2)) & 0x09249
        return x

    morton = (spread3(cell[..., 0]) | (spread3(cell[..., 1]) << 1)
              | (spread3(cell[..., 2]) << 2))
    octant = ((d[..., 0] < 0).to(torch.int32)
              + 2 * (d[..., 1] < 0).to(torch.int32)
              + 4 * (d[..., 2] < 0).to(torch.int32))
    ax = torch.abs(d[..., 0])
    ay = torch.abs(d[..., 1])
    dq = ((ax > 0.35).to(torch.int32) + 2 * (ax > 0.75).to(torch.int32)
          + 4 * (ay > 0.35).to(torch.int32) + 8 * (ay > 0.75).to(torch.int32))
    dead = (~alive).to(torch.int32)
    return (dead << 19) | (octant << 16) | (morton << 4) | dq


def tile_shape(h: int, w: int, th: int = 16, tw: int = 32):
    """Padded image shape whose (th x tw) tiling covers [H, W]."""
    return -(-h // th) * th, -(-w // tw) * tw


def to_tiles(x, h, w, th=16, tw=32, pad_value=0.0):
    """[..., H, W, k] -> flat tile-major [Hp*Wp, k], padding the image to
    the covering tiling with `pad_value`."""
    hp, wp = tile_shape(h, w, th, tw)
    if (hp, wp) != (h, w):
        x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h), value=pad_value)
    lead = tuple(x.shape[:-3])
    k = x.shape[-1]
    y = x.reshape(*lead, hp // th, th, wp // tw, tw, k)
    y = y.transpose(-4, -3)  # [..., H/th, W/tw, th, tw, k]
    return y.reshape(*lead, hp * wp, k)


def from_tiles(x, h, w, th=16, tw=32):
    """Inverse of to_tiles: flat tile-major -> [..., H, W, k], dropping the
    padding rows/cols."""
    hp, wp = tile_shape(h, w, th, tw)
    lead = tuple(x.shape[:-2])
    k = x.shape[-1]
    y = x.reshape(*lead, hp // th, wp // tw, th, tw, k)
    y = y.transpose(-4, -3)
    y = y.reshape(*lead, hp, wp, k)
    return y[..., :h, :w, :]
