"""The work and bound arithmetic of the kernel entries against hand counts
on tiny batches."""

from __future__ import annotations

import pytest
import torch

from benchmark import roofline


def test_entries_name_the_program():
    e = roofline.entries()
    assert set(e) >= {"cluster_masks_rows", "intersect_culled_rows",
                      "intersect_stream_rows"}
    import importlib

    for name, mod in e.items():
        assert hasattr(importlib.import_module(mod.MODULE), name)


@pytest.mark.parametrize("tmax", [False, True])
def test_k1_counts(tmax):
    aabb8 = torch.zeros(64, 8)           # two words of 32 boxes
    rays = torch.zeros(8, 512)
    cap = roofline.entries()["cluster_masks_rows"].capture(
        (aabb8, rays, 40, tmax), {})
    per = 25 if tmax else 24
    # 40 real boxes a ray; rays' 6 (7) rows read, boxes read, 2 words out
    assert cap["ops"] == per * 512 * 40 + 3 * 512
    assert cap["bytes"] == (7 if tmax else 6) * 4 * 512 + 40 * 32 \
        + 2 * 4 * 512
    cap = roofline.entries()["cluster_masks_rows"].capture(
        (aabb8, rays), {})
    assert cap["ops"] == 24 * 512 * 64 + 3 * 512


@pytest.mark.parametrize("entry,block", [("intersect_culled_rows", 256),
                                         ("intersect_stream_rows", 512)])
def test_sweep_counts(entry, block):
    mod = roofline.entries()[entry]
    tris = torch.zeros(10 * 64, 12)       # 10 clusters of 64
    counts = torch.tensor([3, -1, 0, 2], dtype=torch.int32)
    lists = torch.zeros(4, 5, dtype=torch.int32)
    rays = torch.zeros(8, 4 * block)
    w = mod.work(mod.capture((tris, counts, lists, rays), {}))
    swept = 3 + 10 + 0 + 2                # -1 sweeps every cluster
    assert (w["clusters"], w["lists"]) == (swept, 4)
    assert w["ops"] == 54 * swept * 64 * block
    n = 4 * block
    assert w["bytes"] == 14 * 4 * n + 4 * 4 + 20 * 4 + tris.numel() * 4


def test_bound_is_the_larger():
    assert roofline.bound_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(67e12, 6.7e12) == pytest.approx(2.0)
