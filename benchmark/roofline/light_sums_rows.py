"""K5, the culled light pdf's sum: every ray of a list's block against
every light triangle of the light clusters its list holds."""

import torch

MODULE = "raytracer_odin_tpu_torch.ops.light_cull"
# Light triangles a cluster (light_cull.LEAF_L).
LEAF_L = 32
# fp32 operations a ray-light test: d x v 9, det 5, 1/det 1, o - p 3, bu 6,
# q 9, bv 6, t 6 (45 up to t); the hit test 6 (bu >= 0, bv >= 0, bu + bv,
# <= 1, t >= 0, valid); t^2/|ng.d| 8 (t * t, the dot 5, abs, the
# division); fac * w, the select, the NaN check and the partial sum's add 4.
OPS_PER_TEST = 63


def capture(args, kwargs):
    """(light_rows [Lpad, 16] f32, counts [NB] int32, lists [NB, C] int32,
    rays [8, Npad]) -> sums [Npad] f32. A count of -1 sums every cluster.
    Keeps a reference to `counts` (a few KiB) for work()."""
    light_rows, counts, lists, rays = args
    n = rays.shape[1]
    return {"n": n, "block": n // counts.shape[0], "counts": counts,
            "n_clusters": light_rows.shape[0] // LEAF_L,
            "bytes": (8 * 4 * n + counts.numel() * 4 + lists.numel() * 4
                      + light_rows.numel() * 4 + 4 * n)}


def work(cap):
    c = cap["counts"]
    swept = int(torch.where(c < 0, cap["n_clusters"], c).sum())
    tests = swept * LEAF_L * cap["block"]
    return {"ops": OPS_PER_TEST * tests, "bytes": cap["bytes"],
            "clusters": swept, "lists": c.numel()}
