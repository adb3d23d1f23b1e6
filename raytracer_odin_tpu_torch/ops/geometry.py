"""Ray-primitive tests and per-triangle AABBs (port of
raytracer_odin_tpu/ops/geometry.py).

Reference semantics (raytracer.odin:105-209):
  * ray-AABB: slab test returning the entry distance, boxes behind the ray
    rejected and the entry clamped to 0;
  * ray-triangle: solve [u v -d] x = o - p for (u, v, t) in the
    Moller-Trumbore form; reject u < 0, v < 0 or u + v > 1.
"""

from __future__ import annotations

import numpy as np
import torch

from raytracer_odin_tpu_torch.utils.math3d import cross, dot

RAY_EPS = 1e-3  # origin offset, raytracer.odin:418
BIG = 3.0e38


def intersect_aabb(o, inv_d, lo, hi, max_t):
    """Slab test (check_intersect_ray_aabb, raytracer.odin:119-134); o,
    inv_d (1 / d, IEEE inf on zeros), lo, hi [..., 3], max_t [...]: boxes
    entered beyond max_t are rejected. A NaN slab (0 * inf: a ray parallel
    to and on the slab plane) counts as unbounded on that axis, so the
    other axes decide. Returns (t_entry clamped to 0, hit)."""
    t1 = (lo - o) * inv_d
    t2 = (hi - o) * inv_d
    tmin = torch.minimum(t1, t2)
    tmax = torch.maximum(t1, t2)
    t_near = torch.where(torch.isnan(tmin), -BIG, tmin).amax(dim=-1)
    t_far = torch.where(torch.isnan(tmax), BIG, tmax).amin(dim=-1)
    entry = torch.clamp(t_near, min=0.0)
    hit = (t_near <= t_far) & (t_far >= 0) & (entry <= max_t)
    return entry, hit


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
