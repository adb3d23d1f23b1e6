"""The streamed night city (benchmark/scenes/city24night.py) and the port's
streamed, many-light path against the benchmark's plain reference.

The scene: its non-emissive triangles are the city's at blocks=24 less its
two area-light quads, bit for bit; its window quads touch no other window,
each lies on a side face of a tower's box, 0.01 outside it and inside the
face's edges; its counts are the configuration's, which streams and
takes the culled light pdf.

The port at a small size: a few towers, streamed (RT_TPU_STREAM_TRIS),
the light pdf culled (RT_TPU_LIGHT_CULL_MIN) with the light lists' cap
lowered so that most 512-ray blocks overflow (count -1: K5 sums every
cluster, as past 128 of the full scene's 216). The culled sums against
the reference's brute sum lane for lane, and a small render against the
reference's statistically. Each comparison is also run with the fault
planted (a list of -1 summed as empty), which it must refuse.

Imports no jax.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import check, run
from benchmark.reference import scene as ref_scene
from benchmark.reference.tracer import Tracer
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.io import gltf
from raytracer_odin_tpu_torch.models import build
from raytracer_odin_tpu_torch.ops import light_cull
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.render import runtime

CONFIG = json.loads((run.BENCH / "configs" / "city24night_1080p.json")
                    .read_text())
# The small scene: blocks=4, 16 towers, 5,942 triangles, 192 light
# triangles in 6 clusters; lists past CAP clusters overflow.
BLOCKS, CAP = 4, 2


def _write(name, path, **kw):
    run.load_module(run.BENCH / "scenes" / f"{name}.py").write(path, **kw)
    return ref_scene.read(path, "cpu")


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """(night scene, city scene) at the configuration's settings, as the
    reference's reader reads them."""
    d = tmp_path_factory.mktemp("city24night")
    spec = dict(CONFIG["scene"])
    night = _write(spec.pop("generator"), d / "night.gltf", **spec)
    city = _write("city", d / "city.gltf", blocks=spec["blocks"],
                  seed=spec["seed"])
    return night, city


def _emissive(sc):
    return sc.mat_emission[sc.tri_mat].abs().sum(-1) > ref_scene.EMISSIVE_EPS


def test_counts_are_the_configurations(full):
    night, _ = full
    assert (night.num_triangles, night.num_lights) == (
        CONFIG["triangles"], CONFIG["lights"]) == (214142, 6912)
    # padded triangles are at least the triangles: the scene streams
    assert CONFIG["triangles"] > pi.STREAM_TRIS
    assert night.num_lights >= light_cull.threshold()
    assert -(-night.num_lights // light_cull.LEAF_L) == 216


def test_towers_are_the_citys(full):
    """Every non-emissive triangle of the night scene is the city's, in the
    city's order, bit for bit: positions, normals, texcoords and its
    material; the city's emissive triangles are its 4 area-light ones."""
    night, city = full
    keep_n, keep_c = ~_emissive(night), ~_emissive(city)
    assert int((~keep_c).sum()) == 4
    assert int(keep_n.sum()) == int(keep_c.sum()) == 207230
    for f in ("tri_p", "tri_u", "tri_v", "tri_ng", "tri_n", "tri_uv"):
        assert torch.equal(getattr(night, f)[keep_n],
                           getattr(city, f)[keep_c]), f
    for f in ("mat_color", "mat_metallic", "mat_roughness"):
        assert torch.equal(getattr(night, f)[night.tri_mat[keep_n]],
                           getattr(city, f)[city.tri_mat[keep_c]]), f


def _boxes(sc, mask):
    """Axis-aligned bounding boxes [n, 2, 3] (float64) of the triangles
    in `mask`."""
    p = sc.tri_p[mask].double()
    corners = torch.stack([p, p + sc.tri_u[mask], p + sc.tri_v[mask]], 1)
    return torch.stack([corners.amin(1), corners.amax(1)], 1).numpy()


def _windows(sc):
    """Each window quad's box, from its two triangles (consecutive in the
    file)."""
    b = _boxes(sc, _emissive(sc)).reshape(-1, 2, 2, 3)
    return np.stack([b[:, :, 0].min(1), b[:, :, 1].max(1)], 1)


def test_windows_touch_no_other_window(full):
    night, _ = full
    w = _windows(night)
    assert len(w) == 3456
    lo, hi = w[:, 0], w[:, 1]
    touch = np.ones((len(w), len(w)), bool)
    for a in range(3):
        touch &= (lo[:, None, a] <= hi[None, :, a]) & (
            lo[None, :, a] <= hi[:, None, a])
    np.fill_diagonal(touch, False)
    assert not touch.any()


def test_windows_lie_on_box_faces(full):
    """Each window is flat on x or z, 0.28 wide and 0.24-0.28 high, and
    lies 0.01 outside a side face of a tower's box (a non-emissive
    triangle flat on the same axis, whose box is the face), away from the
    tower's axis, and at least 0.01 inside the face's edges: it reaches
    into no box above or below its own."""
    night, _ = full
    win = _windows(night)
    faces = _boxes(night, ~_emissive(night))
    ext = faces[:, 1] - faces[:, 0]
    for axis in (0, 2):
        other = 2 - axis
        w = win[(win[:, 1, axis] - win[:, 0, axis]) == 0]
        f = faces[(ext[:, axis] == 0) & (ext[:, 1] > 0)
                  & (ext[:, other] > 0)]
        assert np.allclose(w[:, 1, other] - w[:, 0, other], 0.28)
        high = w[:, 1, 1] - w[:, 0, 1]
        assert ((high > 0.24) & (high < 0.28 + 1e-6)).all()
        coord = w[:, 0, axis]
        # the tower's axis: the centre of its 3 x 3 grid cell
        centre = np.floor(coord / 3.0) * 3.0 + 1.5
        gap = coord[:, None] - f[None, :, 0, axis]
        out = np.abs(coord - centre)[:, None] > np.abs(
            f[None, :, 0, axis] - centre[:, None])
        inside = np.ones_like(out)
        for a in (1, other):
            inside &= (w[:, None, 0, a] >= f[None, :, 0, a] + 0.0099) & (
                w[:, None, 1, a] <= f[None, :, 1, a] - 0.0099)
        ok = (np.abs(np.abs(gap) - 0.01) < 1e-5) & out & inside
        assert ok.any(1).all(), f"axis {axis}: {int((~ok.any(1)).sum())}"


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(port scene, reference scene, port's host scene) of the night city at
    BLOCKS, the port's scene built streamed and on the culled light
    pdf."""
    path = tmp_path_factory.mktemp("small") / "night.gltf"
    ref = _write("city24night", path, blocks=BLOCKS)
    mp = pytest.MonkeyPatch()
    mp.setenv("RT_TPU_STREAM_TRIS", "1")
    try:
        host = gltf.read_gltf(path)
        port = build.finish_scene(host, device="cpu")
    finally:
        mp.undo()
    assert port.stream
    assert (ref.num_triangles, ref.num_lights) == (5942, 192)
    return port, ref, host


@pytest.fixture
def overflowing(monkeypatch):
    """The culled light pdf on (RT_TPU_LIGHT_CULL_MIN below the small
    scene's 192 lights) with the lists' cap at CAP; keeps every list's
    counts."""
    monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", "64")
    counts = []
    lists = light_cull.light_lists

    def capped(scene, o, d, cap=light_cull.LIST_CAP):
        out = lists(scene, o, d, CAP)
        counts.append(out[0])
        return out

    monkeypatch.setattr(light_cull, "light_lists", capped)
    return counts


def plant_overflow_as_empty(monkeypatch):
    """The fault: K5 reads a list of -1 as an empty list."""
    sums = light_cull.light_sums_rows
    monkeypatch.setattr(
        light_cull, "light_sums_rows",
        lambda rows, counts, *a: sums(rows, torch.clamp(counts, min=0), *a))


def _rays(ref, n, seed):
    """Rays from random points of the towers' box, three in four aimed at
    points well inside light triangles, the rest in random directions."""
    g = torch.Generator().manual_seed(seed)
    i = torch.randint(0, ref.num_lights, (n,), generator=g)
    a, b = torch.rand(2, n, 1, generator=g) * 0.45 + 0.05
    target = ref.light_p[i] + a * ref.light_u[i] + b * ref.light_v[i]
    half = 3.0 * BLOCKS / 2
    o = torch.rand(n, 3, generator=g) * torch.tensor(
        [2 * half, 6.0, 2 * half]) - torch.tensor([half, -0.05, half])
    d = target - o
    d[: n // 4] = torch.randn(n // 4, 3, generator=g)
    return o, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


# The culled-vs-dense gate's tolerance (chip_smoke.edge_flips): the port
# and the reference solve each ray-light pair in other arithmetic, a few
# ulp apart on each term.
RTOL, ATOL = 2e-4, 1e-6
# A lane whose ray passes within this of a light triangle's edge, in the
# reference's barycentrics, is left out: there the two arithmetics may
# disagree on whether the light is hit.
EDGE = 1e-3


def light_pdf_mismatches(port, ref, o, d) -> tuple:
    """(lanes whose culled sum differs from the reference's, lanes
    compared, the lanes' hit lights)."""
    got = light_cull.light_pdf_sum_culled(port, o, d)
    want = Tracer(ref).light_pdf(o, d)
    tr = Tracer(ref)
    oo = o + d * 1e-3
    t, bu, bv, _ = tr._solve(tr._ray_rows(oo, d), tr._light_mat)
    edge = torch.stack([bu, bv, 1 - bu - bv], -1).abs().amin(-1)
    near = ((edge < EDGE) & (t >= 0)).any(-1)
    bad = ~torch.isclose(got, want, rtol=RTOL, atol=ATOL) & ~near
    return int(bad.sum()), int((~near).sum()), int((want > 0).sum())


@pytest.mark.parametrize("fault", [False, True], ids=["sound",
                                                      "overflow_as_empty"])
def test_light_pdf_against_reference(small, overflowing, monkeypatch, fault):
    """The port's culled sums (K5's plain version over lists mostly past
    the cap) equal the reference's brute sum on every lane not grazing a
    light's edge; with -1 read as empty most of them differ."""
    port, ref, _ = small
    if fault:
        plant_overflow_as_empty(monkeypatch)
    o, d = _rays(ref, 4096, 22)
    bad, compared, lit = light_pdf_mismatches(port, ref, o, d)
    counts = torch.cat(overflowing)
    assert (counts == -1).float().mean() > 0.5
    assert compared > 0.97 * 4096 and lit > 2500
    if fault:
        assert bad > 0.5 * lit, bad
    else:
        assert bad == 0, bad


# The render: 32 x 16 at depth 3, 16 spp against the reference's 64,
# every row in 8-pixel segments. The sound run reads z2_mean 0.59 and
# image_z 1.37; with -1 read as empty, 5.04 and 15.83.
W, H, DEPTH, SPP, REF_SPP, SEG, SEED = 32, 16, 3, 16, 64, 8, 2026
LIMITS = {"count_off": 0, "z2_mean": 3.0, "image_z": 5.0,
          "segments_gap": 0.1}


@pytest.fixture(scope="module")
def ref_rows(small):
    _, ref, _ = small
    return check.reference_rows(Tracer(ref), list(range(H)), W, H,
                                ref.yfov * W / H, DEPTH, REF_SPP, SEED,
                                salt=1)


@pytest.mark.parametrize("fault", [False, True], ids=["sound",
                                                      "overflow_as_empty"])
def test_render_against_reference(small, ref_rows, overflowing, monkeypatch,
                                  fault):
    """The port's render of every row, streamed and on overflowing light
    lists, against the reference's: the check's numbers within the tiny
    cells' limits; with -1 read as empty, not."""
    port, _, host = small
    if fault:
        plant_overflow_as_empty(monkeypatch)
    cfg = RenderConfig(width=W, height=H, ray_depth=DEPTH, samples=SPP,
                       samples_per_step=SPP, seed=SEED,
                       intersector="pallas", compact="auto")
    res = runtime.render_scene(port, cfg, host.cam.fov_x * W / H,
                               device="cpu")
    st = res.stats
    prog = {"total": st.total[0].double(), "total_sq": st.total_sq[0].double(),
            "count": st.count[0].double(),
            "count_off": int((st.count[0] != res.samples_done).sum()),
            "segments_per_path": res.rays_cast / (res.samples_done * W * H)}
    ok, checks = check.judge(check.numbers(prog, ref_rows, SEG), LIMITS)
    assert (torch.cat(overflowing) == -1).any()
    assert ok != fault, checks


def test_gltf_ingest_joins_primitives_once(small, monkeypatch, tmp_path):
    """The glTF reader joins its primitives' triangle arrays once (joined
    one primitive at a time, the full scene's 5,750 primitives took 18 s
    of copies): one append for the small scene's 160 primitives,
    and the triangles are the reference reader's, in file order."""
    from raytracer_odin_tpu_torch.models import scene as host_scene

    _, ref, _ = small
    calls = []
    append = host_scene.HostScene.append_triangles

    def counted(self, **arrays):
        calls.append(len(arrays["p"]))
        return append(self, **arrays)

    monkeypatch.setattr(host_scene.HostScene, "append_triangles", counted)
    path = tmp_path / "night.gltf"
    run.load_module(run.BENCH / "scenes" / "city24night.py").write(
        path, blocks=BLOCKS)
    host = gltf.read_gltf(path)
    assert calls == [ref.num_triangles]
    assert len(host.materials) == 160
    for mine, theirs in (("p", "tri_p"), ("u", "tri_u"), ("v", "tri_v")):
        assert torch.equal(torch.from_numpy(getattr(host, mine)),
                           getattr(ref, theirs)), mine
