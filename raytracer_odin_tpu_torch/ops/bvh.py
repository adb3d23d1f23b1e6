"""Host-side BVH construction (port of raytracer_odin_tpu/ops/bvh.py).

Build semantics follow the reference (bvh_build, raytracer.odin:227-342):
full SAH sweep, leaf threshold 4. The build runs in the port's own copy of
the native builder (csrc/rtnative.cpp `bvh_build`). Its triangle
permutation orders the triangles into spatially tight 64-triangle clusters
for the intersection kernels; its flattened nodes and per-octant links are
uploaded as the DeviceBVH the "bvh" intersector walks. There is
deliberately no numpy fallback: the JAX package's `_build_py` yields a
different permutation than the native builder on the demo scene, so a
fallback would silently change every cluster.
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

    perm, lo, hi, first, count, links, _ = native.load().bvh_build(
        np.asarray(tri_lo, np.float32), np.asarray(tri_hi, np.float32),
        leaf_size,
    )
    return FlatBVH(
        perm=perm, lo=lo, hi=hi, first=first, count=count,
        hit_link=links[:, 0], miss_link=links[:, 1],
    )
