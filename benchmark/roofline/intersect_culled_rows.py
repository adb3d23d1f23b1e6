# Frozen copy of chip_smoke.py's sweep work count (measure_sweep's work) at
# commit 6dc2ca8.
"""K2, the list-driven triangle sweep: every ray of a list's block against
every triangle of the clusters its list holds."""

import os

import torch

MODULE = "raytracer_odin_tpu_torch.ops.pallas_intersect"
# fp32 operations a ray-triangle test: d x v 9, det 5, 1/det 1, o - p 3,
# bu 6, q 9, bv 6, t 6, inside 5, t > 0 and t < best 2, select 2.
OPS_PER_TEST = 54


def _leaf() -> int:
    """Triangles a cluster: the layout the run's environment sets."""
    return int(os.environ.get("RT_TPU_LEAF", "64"))


def capture(args, kwargs):
    """(scene_tris [Tpad, 12], counts [NB] int32, lists [NB, C] int32,
    rays [8, Npad]) -> hits [8, Npad] f32. A count of -1 sweeps every
    cluster. Keeps a reference to `counts` (a few KiB) for work()."""
    tris, counts, lists, rays = args
    n = rays.shape[1]
    return {"n": n, "block": n // counts.shape[0], "counts": counts,
            "n_clusters": tris.shape[0] // _leaf(),
            "bytes": (6 * 4 * n + 8 * 4 * n + counts.numel() * 4
                      + lists.numel() * 4 + tris.numel() * 4)}


def work(cap):
    c = cap["counts"]
    swept = int(torch.where(c < 0, cap["n_clusters"], c).sum())
    tests = swept * _leaf() * cap["block"]
    return {"ops": OPS_PER_TEST * tests, "bytes": cap["bytes"],
            "clusters": swept, "lists": c.numel()}
