"""Cull glue between the mask kernel (K1) and the sweep kernel (K2): port
of the exact-cull half of raytracer_odin_tpu/ops/culling.py.

Per-ray cluster masks are OR-ed over each RB_SUB-lane sub-block into that
block's exact union work list (ascending cluster ids). The conservative
bundle-interval cull (cull_clusters, block_bounds*, coherence_keys) serves
scenes on the two-level layout and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from raytracer_odin_tpu_torch.ops.pallas_intersect import BIG, LEAF


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


def build_lists(hit_mask, cap: int | None = None):
    """[NB, C] bool -> (counts [NB] i32, lists [NB, min(C, cap)] i32): the
    hit cluster ids of each row in ascending order, then the others. Rows
    hitting more than `cap` clusters get count -1 (sweep every cluster)."""
    nb, c = hit_mask.shape
    ids = torch.arange(c, dtype=torch.int32, device=hit_mask.device)
    key = torch.where(hit_mask, ids, c + ids)  # unique keys
    lists = torch.argsort(key, dim=-1).to(torch.int32)
    counts = hit_mask.sum(dim=-1).to(torch.int32)
    if cap is not None and cap < c:
        counts = torch.where(counts > cap, -1, counts)
        lists = lists[:, :cap]
    return counts, lists.contiguous()


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
