"""The streamed night city's cell: the configuration's counts, a tiny cell
that streams through K4's plain version and sums its light pdf through
K5's, with most light lists past their cap, whose sound run is correct and
whose planted faults (overflowing lists summed as empty, the doubled light
pdf) are caught, and K5's work count on lists of -1 against a hand
count."""

from __future__ import annotations

import functools
import json
import shutil

import pytest
import torch

from benchmark import roofline, run
from benchmark.tests.conftest import DATA, TINY_LIMITS, run_cell
from raytracer_odin_tpu_torch.ops import light_cull
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi

CELL = "tinycity24night.preview"
# blocks=3: 9 towers, 3,326 triangles, 108 light triangles in 4 clusters.
BLOCKS, TRIANGLES, LIGHTS = 3, 3326, 108
# The cell's overrides: the culled pdf serves 108 lights, and a scene of a
# few thousand triangles streams.
ENV = {"RT_TPU_LIGHT_CULL_MIN": 64, "RT_TPU_STREAM_TRIS": 1}
# The light lists' cap in the tiny cell: a block whose cull admits 3 or 4
# of the 4 clusters gets count -1, as a block past 128 of the full scene's
# 216 clusters does.
CAP = 2
# As the night city's tiny cell: small bright windows spread a pixel's
# samples widely, so the check reads many samples in short segments.
WIDTH, HEIGHT = 64, 32
CHECK = {"rows": 32, "spp": 128, "segment_px": 16, "control_spp": 128,
         "limits": TINY_LIMITS}
SECONDS = 15.0


def add_city24night_cell(root, name=CELL):
    bench = root / "benchmark"
    conf = json.loads((bench / "configs" / "city24night_1080p.json")
                      .read_text())
    conf["scene"]["blocks"] = BLOCKS
    conf.update(width=WIDTH, height=HEIGHT, ray_depth=3,
                triangles=TRIANGLES, lights=LIGHTS)
    (bench / "configs" / "tinycity24night.json").write_text(json.dumps(conf))
    (bench / "workloads" / f"{name}.json").write_text(json.dumps({
        "env": ENV, "trace": {"start_step": 1, "steps": 1},
        "check": CHECK}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": "tinycity24night",
                              "traffic": "preview", "chips": 1,
                              "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def root(tmp_path):
    bench = tmp_path / "benchmark"
    for d in DATA:
        shutil.copytree(run.BENCH / d, bench / d)
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    add_city24night_cell(tmp_path)
    return tmp_path


@pytest.fixture
def k5_counts(monkeypatch):
    """Lowers the light lists' cap to CAP and keeps the counts of every
    list built for K5; counts the stream sweep's calls."""
    seen = {"k5": [], "k4": 0}
    lists, stream = light_cull.light_lists, pi.intersect_stream_rows

    def capped(scene, o, d, cap=light_cull.LIST_CAP):
        out = lists(scene, o, d, CAP)
        seen["k5"].append(out[0].clone())
        return out

    @functools.wraps(stream)
    def swept(*a, **k):
        seen["k4"] += 1
        return stream(*a, **k)

    monkeypatch.setattr(light_cull, "light_lists", capped)
    monkeypatch.setattr(pi, "intersect_stream_rows", swept)
    return seen


def test_configuration_counts():
    conf = json.loads((run.BENCH / "configs" / "city24night_1080p.json")
                      .read_text())
    assert (conf["triangles"], conf["lights"]) == (214142, 6912)
    assert conf["triangles"] > pi.STREAM_TRIS
    assert conf["lights"] >= light_cull.threshold()
    assert conf["lights"] // light_cull.LEAF_L > light_cull.LIST_CAP


def test_sound_run_is_correct(root, capsys, k5_counts):
    rc, line = run_cell(root, capsys, CELL, seconds=SECONDS)
    assert rc == 0 and line["correct"] is True, line["checks"]
    counts = torch.cat(k5_counts["k5"])
    assert k5_counts["k4"] > 0
    assert (counts == -1).float().mean() > 0.5, "the lists do not overflow"


def test_overflow_as_empty_is_caught(root, capsys, k5_counts, monkeypatch):
    """K5 reading a list past the cap (count -1) as an empty list: the
    light pdf of most blocks is then 0."""
    sums = light_cull.light_sums_rows

    def empty(light_rows, counts, *a):
        return sums(light_rows, torch.clamp(counts, min=0), *a)

    monkeypatch.setattr(light_cull, "light_sums_rows", empty)
    rc, line = run_cell(root, capsys, CELL, seconds=SECONDS)
    assert (torch.cat(k5_counts["k5"]) == -1).any()
    assert rc == 0 and line["correct"] is False, line["checks"]


def test_doubled_light_pdf_is_caught(root, capsys, k5_counts, monkeypatch):
    orig = light_cull.light_pdf_sum_culled
    monkeypatch.setattr(light_cull, "light_pdf_sum_culled",
                        lambda *a, **k: orig(*a, **k) * 2.0)
    rc, line = run_cell(root, capsys, CELL, seconds=SECONDS)
    assert k5_counts["k5"], "the cell did not take the culled light pdf"
    assert rc == 0 and line["correct"] is False, line["checks"]


def test_traced_run_reads_overflowing_lists(root, capsys, k5_counts):
    """A list of -1 counts as every one of the 4 clusters, so the mean
    lies between the mean of the listed counts and 4."""
    rc, line = run_cell(root, capsys, CELL, seconds=SECONDS, trace=1)
    assert rc == 0
    got = line["metrics"]
    assert 2.0 < got["light_list_clusters_mean"]["value"] <= 4.0
    assert 0.0 < got["light_host_ms"]["value"] <= got["shade_host_ms"]["value"]
    # the CPU runs K4's and K5's plain versions, which have no device time
    assert "k4_roofline" not in got and "k5_roofline" not in got


def test_k5_counts_at_216_clusters():
    """K5's work at the full scene's 216 clusters: a count of -1 sums all
    216, against a hand count."""
    mod = roofline.entries()["light_sums_rows"]
    light_rows = torch.zeros(216 * 32, 16)
    counts = torch.tensor([-1, 128, -1, 0, 57, -1], dtype=torch.int32)
    lists = torch.zeros(6, 128, dtype=torch.int32)
    rays = torch.zeros(8, 6 * 512)
    w = mod.work(mod.capture((light_rows, counts, lists, rays), {}))
    swept = 216 + 128 + 216 + 0 + 57 + 216
    assert (w["clusters"], w["lists"]) == (swept, 6)
    assert w["ops"] == 63 * swept * 32 * 512
    assert w["bytes"] == (8 * 4 * 6 * 512 + 6 * 4 + 6 * 128 * 4
                          + 216 * 32 * 16 * 4 + 4 * 6 * 512)
