"""The night city's cell: the configuration's counts, a tiny many-light
cell whose sound run is correct and whose planted fault in the culled
light pdf is caught, the port's culled pdf against the reference's brute
sum, and K5's work count against a hand count."""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

from benchmark import roofline, run
from benchmark.reference import scene as ref_scene
from benchmark.reference.tracer import Tracer
from benchmark.tests.conftest import DATA, TINY_LIMITS, run_cell
from raytracer_odin_tpu_torch.io import gltf
from raytracer_odin_tpu_torch.models import build
from raytracer_odin_tpu_torch.ops import light_cull

CELL = "tinynight.preview"
# blocks=3: 9 towers, 218 triangles, 108 light triangles in 4 clusters.
BLOCKS, TRIANGLES, LIGHTS = 3, 218, 108
# Below the scene's 108 lights, so that the culled pdf (K5's plain version
# on the CPU) serves it.
CULL_MIN = 64


# The night cell is larger than conftest's tiny cells, and its check
# reads more samples in smaller segments: its image is lit by small bright
# windows, so a pixel's samples spread widely (the dim ground's about seven
# times their mean), and the light-pdf fault below halves the ground's
# light while it leaves the windows seen directly as they are. At 32x16
# with 8 rows at 16 spp the doubled pdf read z2_mean 1.2-1.4 against a
# sound 0.8; here it reads 6.4-6.9 against 0.7-0.8 (two seeds each).
WIDTH, HEIGHT = 64, 32
CHECK = {"rows": 32, "spp": 128, "segment_px": 16, "control_spp": 128,
         "limits": TINY_LIMITS}
SECONDS = 15.0


def add_night_cell(root, name=CELL, width=WIDTH, height=HEIGHT, depth=3):
    """A tiny citynight cell `name` under root, built as conftest.add_cell
    builds the demo's, listed with every per-layer metric."""
    bench = root / "benchmark"
    conf = json.loads((bench / "configs" / "citynight_1080p.json")
                      .read_text())
    conf["scene"]["blocks"] = BLOCKS
    conf.update(width=width, height=height, ray_depth=depth,
                triangles=TRIANGLES, lights=LIGHTS)
    (bench / "configs" / "tinynight.json").write_text(json.dumps(conf))
    (bench / "workloads" / f"{name}.json").write_text(json.dumps({
        "env": {"RT_TPU_LIGHT_CULL_MIN": CULL_MIN},
        "trace": {"start_step": 1, "steps": 1},
        "check": CHECK}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": "tinynight",
                              "traffic": "preview", "chips": 1,
                              "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def night_root(tmp_path):
    bench = tmp_path / "benchmark"
    for d in DATA:
        shutil.copytree(run.BENCH / d, bench / d)
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    add_night_cell(tmp_path)
    return tmp_path


def test_configuration_counts():
    conf = json.loads((run.BENCH / "configs" / "citynight_1080p.json")
                      .read_text())
    assert (conf["triangles"], conf["lights"]) == (3458, 1728)
    assert conf["lights"] >= light_cull.threshold()


def test_sound_run_is_correct(night_root, capsys):
    rc, line = run_cell(night_root, capsys, CELL, seconds=SECONDS)
    assert rc == 0 and line["correct"] is True, line["checks"]


def test_light_pdf_fault_is_caught(night_root, capsys, monkeypatch):
    """The culled light pdf doubled: every light-sampled and every
    MIS-weighted direction is then weighted wrong."""
    orig = light_cull.light_pdf_sum_culled
    calls = []

    def doubled(*a, **k):
        calls.append(1)
        return orig(*a, **k) * 2.0

    monkeypatch.setattr(light_cull, "light_pdf_sum_culled", doubled)
    rc, line = run_cell(night_root, capsys, CELL, seconds=SECONDS)
    assert calls, "the cell did not take the culled light pdf"
    assert rc == 0 and line["correct"] is False, line["checks"]


def test_traced_run_reports_light_metrics(night_root, capsys):
    rc, line = run_cell(night_root, capsys, CELL, seconds=SECONDS, trace=1)
    assert rc == 0
    got = line["metrics"]
    assert got["light_host_ms"]["value"] > 0.0
    assert got["light_host_ms"]["value"] <= got["shade_host_ms"]["value"]
    # a list holds at most the scene's 4 light clusters
    assert 0.0 <= got["light_list_clusters_mean"]["value"] <= 4.0
    # the CPU runs K5's plain version, which has no device time
    assert "k5_roofline" not in got


@pytest.fixture(scope="module")
def night_scenes(tmp_path_factory):
    path = tmp_path_factory.mktemp("night") / "night.gltf"
    run.load_module(run.BENCH / "scenes" / "citynight.py").write(
        path, blocks=BLOCKS)
    port = build.finish_scene(gltf.read_gltf(path), device="cpu")
    ref = ref_scene.read(path, "cpu")
    assert (ref.num_triangles, ref.num_lights) == (TRIANGLES, LIGHTS)
    return port, ref


def _light_rays(ref, n, seed, edges=False):
    """Rays from random points of the scene's box: half aimed at random
    points inside light triangles (most meet a light, some several), half
    in uniform random directions; with `edges`, every ray aimed at a point
    of a light triangle's edge bv = 0 or of the diagonal a quad's two
    triangles share."""
    rng = np.random.default_rng(seed)
    lp, lu, lv = (x.numpy().astype(np.float64) for x in (
        ref.light_p, ref.light_u, ref.light_v))
    i = rng.integers(0, len(lp), n)
    a, b = rng.uniform(0, 1, (2, n, 1))
    if edges:
        target = np.where((np.arange(n) % 2 == 0)[:, None], lp[i] + a * lu[i],
                          lp[i] + lu[i] + a * (lv[i] - lu[i]))
    else:
        flip = a + b > 1
        a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
        target = lp[i] + a * lu[i] + b * lv[i]
    o = rng.uniform([-9, 0.05, -9], [9, 9, 9], (n, 3))
    d = target - o
    if not edges:
        d[n // 2:] = rng.normal(size=(n - n // 2, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.from_numpy(o.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


# How near an edge, in barycentric terms, the two arithmetics may place
# one ray on opposite sides of it: on these rays their barycentrics differ
# by up to 3e-3 at grazing incidence (|ng.d| near 1e-3, where a light's
# term reaches 1e7), and by about 1e-6 elsewhere.
EDGE = 1e-2
RTOL, ATOL = 2e-4, 1e-6


def _straddles(bu, bv, rbu, rbv):
    """Where the two arithmetics place the ray on opposite sides of one of
    the triangle's edges (bu = 0, bv = 0, bu + bv = 1), within EDGE of
    it."""
    out = torch.zeros_like(bu, dtype=torch.bool)
    for a, b in ((bu, rbu), (bv, rbv), (1 - (bu + bv), 1 - (rbu + rbv))):
        out |= (((a >= 0) != (b >= 0)) & (a.abs() <= EDGE)
                & (b.abs() <= EDGE))
    return out


def _morton_to_gltf(port, ref):
    """For each of the port's (Morton-ordered) light rows, the reference's
    light index."""
    rows = port.light_rows[:LIGHTS, 0:9]
    refs = torch.cat([ref.light_p, ref.light_u, ref.light_v], 1)
    dist = (rows[:, None, :] - refs[None]).abs().amax(-1)
    assert bool((dist.min(1).values <= 1e-6).all())
    idx = dist.argmin(1)
    assert idx.unique().numel() == LIGHTS
    return idx


def _explain(port, ref, o, d, got, want) -> int:
    """How many lanes' sums differ beyond RTOL, ATOL; each must be
    explained by lights on a triangle edge: every light whose hit decision
    differs between the port's arithmetic (light_cull.light_terms) and the
    reference's (Cramer's rule) is one whose edge the two place the ray on
    either side of (_straddles), and the sums over the other lights agree.
    Raises for a lane not so explained."""
    from raytracer_odin_tpu_torch.ops.geometry import RAY_EPS

    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    bad = torch.nonzero(~torch.isclose(got, want, rtol=RTOL, atol=ATOL)
                        & torch.isfinite(want)).flatten()
    if bad.numel() == 0:
        return 0
    oo, dd = o[bad] + d[bad] * RAY_EPS, d[bad]
    bu, bv, con = (x[:LIGHTS].T for x in light_cull.light_terms(
        port.light_rows, *(x[None, :] for x in (*oo.T, *dd.T))))
    tr = Tracer(ref)
    t, rbu, rbv, ok = tr._solve(tr._ray_rows(oo, dd), tr._light_mat)
    cos = (ref.light_ng[None] * dd[:, None]).sum(-1).abs()
    rcon = torch.nan_to_num(torch.where(
        ok & (t >= 0), ref.light_pdf_factor[None] * t * t / cos, 0.0),
        nan=0.0)
    order = _morton_to_gltf(port, ref)
    rbu, rbv, rcon = rbu[:, order], rbv[:, order], rcon[:, order]
    flip = (con != 0) != (rcon != 0)
    if not bool(flip.any(-1).all()):
        raise AssertionError("a lane differs where every light's hit agrees")
    if not bool(_straddles(bu, bv, rbu, rbv)[flip].all()):
        raise AssertionError("a light off every triangle edge flips")
    rest = torch.where(flip, 0.0, con).double().sum(-1) / LIGHTS
    ref_rest = torch.where(flip, 0.0, rcon).double().sum(-1) / LIGHTS
    if not bool(torch.isclose(rest, ref_rest, rtol=RTOL, atol=ATOL).all()):
        raise AssertionError("the sums over the lights off the edges differ")
    return bad.numel()


@pytest.mark.parametrize("case", ["interior", "edges", "tampered"])
def test_culled_pdf_against_reference(night_scenes, case):
    """K5's plain version (light_pdf_sum_culled) against the reference's
    brute sum (Tracer.light_pdf) on 4,096 seeded rays. Tolerance rtol
    2e-4, atol 1e-6, the culled-vs-dense gate's (chip_smoke.edge_flips):
    the two solve each ray-light pair in other arithmetic (Moller-Trumbore
    with a reciprocal against Cramer's rule through one matrix product),
    in other orders of the lights, a few ulp apart on each term. Exempt
    are only lanes whose ray passes through a light triangle's edge
    (ROADMAP queue C item 5), where one arithmetic may count a light that
    the other misses: rays aimed at edges give many; a lane tampered with
    (a sum scaled by 3) is refused."""
    port, ref = night_scenes
    o, d = _light_rays(ref, 4096, 2024, edges=case == "edges")
    got = light_cull.light_pdf_sum_culled(port, o, d)
    want = Tracer(ref).light_pdf(o, d)
    assert int((want > 0).sum()) > 1500
    if case == "tampered":
        lane = int(torch.nonzero(want > 0)[0])
        got[lane] *= 3
        with pytest.raises(AssertionError, match="every light's hit agrees"):
            _explain(port, ref, o, d, got, want)
        return
    n_bad = _explain(port, ref, o, d, got, want)
    assert (n_bad > 100) == (case == "edges"), n_bad


def test_k5_counts():
    mod = roofline.entries()["light_sums_rows"]
    light_rows = torch.zeros(10 * 32, 16)   # 10 clusters of 32 lights
    counts = torch.tensor([3, -1, 0, 2], dtype=torch.int32)
    lists = torch.zeros(4, 5, dtype=torch.int32)
    block = 512
    rays = torch.zeros(8, 4 * block)
    w = mod.work(mod.capture((light_rows, counts, lists, rays), {}))
    listed = 3 + 10 + 0 + 2               # -1 sums every cluster
    assert (w["clusters"], w["lists"]) == (listed, 4)
    assert w["ops"] == 63 * listed * 32 * block
    n = 4 * block
    # rays' 8 rows, counts, lists and rows read once; the sums written once
    assert w["bytes"] == 8 * 4 * n + 4 * 4 + 20 * 4 + 320 * 16 * 4 + 4 * n


def test_k5_bound_matches_the_kernel_table():
    """At citynight's bounce 0 (2,073,600 rays, 34.5 clusters a list) the
    bound is the kernel table's 2.1527 ms (PERF.md section 6)."""
    mod = roofline.entries()["light_sums_rows"]
    n = 2_073_600
    nb = n // 512
    counts = torch.full((nb,), 34, dtype=torch.int32)
    counts[: nb // 2] = 35                 # 34.5 a list
    cap = mod.capture((torch.zeros(54 * 32, 16), counts,
                       torch.zeros(nb, 54, dtype=torch.int32),
                       torch.zeros(8, n)), {})
    w = mod.work(cap)
    assert w["clusters"] / w["lists"] == pytest.approx(34.5)
    assert roofline.bound_s(w["ops"], w["bytes"]) * 1e3 == pytest.approx(
        2.1527, abs=5e-4)
