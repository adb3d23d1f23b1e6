"""Ray-triangle test and per-triangle AABBs (port of
raytracer_odin_tpu/ops/geometry.py; the ray-AABB test belongs to the BVH
intersector, which is not ported).

Reference semantics (raytracer.odin:105-209): solve [u v -d] x = o - p for
(u, v, t) in the Moller-Trumbore form; reject u < 0, v < 0 or u + v > 1.
"""

from __future__ import annotations

import numpy as np

from raytracer_odin_tpu_torch.utils.math3d import cross, dot

RAY_EPS = 1e-3  # origin offset, raytracer.odin:418
BIG = 3.0e38


def intersect_triangle(o, d, p, u, v):
    """Moller-Trumbore solve of o + t*d = p + bu*u + bv*v; broadcasts over
    leading axes. Returns (t, bu, bv, valid), valid from the barycentric
    test only (callers apply their own t predicates)."""
    pvec = cross(d, v)
    det = dot(u, pvec)
    inv_det = 1.0 / det  # inf/NaN on degenerate; comparisons reject below
    tvec = o - p
    bu = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, u)
    bv = dot(d, qvec) * inv_det
    t = dot(v, qvec) * inv_det
    valid = (bu >= 0) & (bv >= 0) & (bu + bv <= 1)
    return t, bu, bv, valid


def aabb_of_triangles(p, u, v):
    """Per-triangle AABB (aabb_of_triangle, raytracer.odin:197-204), numpy."""
    pts = np.stack([p, p + u, p + v], axis=1)
    return pts.min(axis=1), pts.max(axis=1)
