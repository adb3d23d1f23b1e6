"""Host-side BVH construction (port of raytracer_odin_tpu/ops/bvh.py).

Build semantics follow the reference (bvh_build, raytracer.odin:227-342):
full SAH sweep, leaf threshold 4. The build runs in the port's own copy of
the native builder (csrc/rtnative.cpp `bvh_build`). Its triangle
permutation orders the triangles into spatially tight 64-triangle clusters
for the intersection kernels; its flattened nodes and per-octant links are
uploaded as the DeviceBVH the "bvh" intersector walks. The numpy build
(`_build_py`, `_flatten_py`, the JAX package's) runs only with
RT_TPU_NO_NATIVE set: it orders the demo's triangles otherwise than the
native builder, so a silent fallback would change every cluster.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LEAF_SIZE = 4  # LEAF_NODE_THRESHOLD, raytracer.odin:230


@dataclass
class FlatBVH:
    """Host-side flattened BVH (numpy)."""

    perm: np.ndarray       # [T] triangle permutation (leaf ranges index this order)
    lo: np.ndarray         # [B, 3]
    hi: np.ndarray         # [B, 3]
    first: np.ndarray      # [B]
    count: np.ndarray      # [B]
    hit_link: np.ndarray   # [8, B]
    miss_link: np.ndarray  # [8, B]

    @property
    def num_nodes(self) -> int:
        return self.lo.shape[0]


def _area(lo, hi):
    s = np.maximum(hi - lo, 0)
    return s[..., 0] * s[..., 1] + s[..., 1] * s[..., 2] + s[..., 2] * s[..., 0]


def _build_py(lo: np.ndarray, hi: np.ndarray, leaf_size: int):
    """Numpy SAH build; returns (perm, nodes), nodes a list of (lo, hi,
    left, right, first, count, axis) with children before their parent
    (the reference's post-order append, raytracer.odin:320-327)."""
    n = lo.shape[0]
    perm = np.arange(n)
    nodes = []

    def recurse(first: int, count: int) -> int:
        if count <= leaf_size:
            sl = perm[first:first + count]
            box_lo = (lo[sl].min(axis=0) if count
                      else np.full(3, np.inf, np.float32))
            box_hi = (hi[sl].max(axis=0) if count
                      else np.full(3, -np.inf, np.float32))
            nodes.append([box_lo, box_hi, -1, -1, first, count, 0])
            return len(nodes) - 1

        best = (np.inf, 0, 1)  # (sah, axis, split)
        for axis in range(3):
            order = np.argsort(lo[perm[first:first + count], axis],
                               kind="stable")
            perm[first:first + count] = perm[first:first + count][order]
            slo = lo[perm[first:first + count]]
            shi = hi[perm[first:first + count]]
            # prefix/suffix merged boxes
            pre_lo = np.minimum.accumulate(slo, axis=0)
            pre_hi = np.maximum.accumulate(shi, axis=0)
            suf_lo = np.minimum.accumulate(slo[::-1], axis=0)[::-1]
            suf_hi = np.maximum.accumulate(shi[::-1], axis=0)[::-1]
            i = np.arange(1, count)
            sah = (_area(pre_lo[:-1], pre_hi[:-1]) * i
                   + _area(suf_lo[1:], suf_hi[1:]) * (count - i))
            k = int(np.argmin(sah))
            if sah[k] < best[0]:
                best = (float(sah[k]), axis, k + 1)
        _, axis, split = best
        order = np.argsort(lo[perm[first:first + count], axis],
                           kind="stable")
        perm[first:first + count] = perm[first:first + count][order]
        sl = perm[first:first + count]
        box_lo = lo[sl].min(axis=0)
        box_hi = hi[sl].max(axis=0)
        left = recurse(first, split)
        right = recurse(first + split, count - split)
        nodes.append([box_lo, box_hi, left, right, 0, 0, axis])
        return len(nodes) - 1

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * n))
    try:
        recurse(0, n)
    finally:
        sys.setrecursionlimit(old_limit)
    return perm, nodes


def _flatten_py(nodes) -> tuple:
    """Depth-first flattening of `_build_py`'s nodes with per-octant
    (hit, miss) links, near child first; returns (lo, hi, first, count,
    hit_link, miss_link)."""
    nb = len(nodes)
    sizes = np.zeros(nb, np.int64)
    for i, nd in enumerate(nodes):  # children always precede parents
        sizes[i] = 1 if nd[2] < 0 else 1 + sizes[nd[2]] + sizes[nd[3]]

    lo = np.zeros((nb, 3), np.float32)
    hi = np.zeros((nb, 3), np.float32)
    first = np.zeros(nb, np.int32)
    count = np.zeros(nb, np.int32)
    hit_link = np.zeros((8, nb), np.int32)
    miss_link = np.zeros((8, nb), np.int32)

    root = nb - 1
    for oct_ in range(8):
        # iterative DFS carrying (node_id, miss)
        stack = [(root, nb)]
        out = 0
        while stack:
            nid, miss = stack.pop()
            nd = nodes[nid]
            self_idx = out
            out += 1
            if oct_ == 0:
                lo[self_idx] = nd[0]
                hi[self_idx] = nd[1]
                first[self_idx] = nd[4]
                count[self_idx] = nd[5] if nd[2] < 0 else 0
            if nd[2] < 0:
                hit_link[oct_, self_idx] = miss
                miss_link[oct_, self_idx] = miss
            else:
                left_idx = out
                right_idx = out + sizes[nd[2]]
                neg = (oct_ >> nd[6]) & 1
                hit_link[oct_, self_idx] = right_idx if neg else left_idx
                miss_link[oct_, self_idx] = miss
                left_miss = miss if neg else right_idx
                right_miss = left_idx if neg else miss
                # canonical order: left subtree then right: push right first
                stack.append((nd[3], right_miss))
                stack.append((nd[2], left_miss))
        assert out == nb
    return lo, hi, first, count, hit_link, miss_link


def build_flat_bvh(tri_lo: np.ndarray, tri_hi: np.ndarray,
                   leaf_size: int = LEAF_SIZE) -> FlatBVH:
    """Build the flattened BVH over per-triangle AABBs."""
    n = tri_lo.shape[0]
    if n == 0:
        return FlatBVH(
            perm=np.zeros(0, np.int32),
            lo=np.zeros((1, 3), np.float32),
            hi=np.full((1, 3), -np.inf, np.float32),
            first=np.zeros(1, np.int32),
            count=np.zeros(1, np.int32),
            hit_link=np.ones((8, 1), np.int32),
            miss_link=np.ones((8, 1), np.int32),
        )
    from raytracer_odin_tpu_torch.io import native

    tri_lo = np.asarray(tri_lo, np.float32)
    tri_hi = np.asarray(tri_hi, np.float32)
    lib = native.load()
    if lib is None:  # RT_TPU_NO_NATIVE
        perm, nodes = _build_py(tri_lo, tri_hi, leaf_size)
        lo, hi, first, count, hit_link, miss_link = _flatten_py(nodes)
        return FlatBVH(perm=perm.astype(np.int32), lo=lo, hi=hi,
                       first=first, count=count, hit_link=hit_link,
                       miss_link=miss_link)
    perm, lo, hi, first, count, links, _ = lib.bvh_build(
        tri_lo, tri_hi, leaf_size)
    return FlatBVH(
        perm=perm, lo=lo, hi=hi, first=first, count=count,
        hit_link=links[:, 0], miss_link=links[:, 1],
    )
