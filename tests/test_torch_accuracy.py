"""The port's accuracy harness (raytracer_odin_tpu_torch/accuracy) against
the JAX repo's (tools/rmse_common.py, rmse_tpu.py, rmse_tpu_draws.py,
rmse_report.py), on the CPU.

- the config table, the proxy spp and the draws' seed base are the tools';
- render_stats matches the tools' on the JAX CPU backend at small sizes:
  the cube at the golden tolerance, the textured scene at the glossy gate
  of tests/test_torch_render.py;
- the proxy and draw halves' step (all of a step's samples traced as
  one batch of lanes) gives statistics, mean and variance, bit-equal
  across step sizes and to the runtime's own uncompacted step, on the
  CPU's "auto" intersectors and on the card's sorted "pallas" route (the
  kernels' plain versions): the condition under which they take steps
  larger than the tools' 8 samples;
- the report equals the tools' record for record on seeded synthetic
  arrays that run every branch (oracle2 pooling, the A/A envelope
  fallback and its stale null, stale shapes, the empirical two-sample z),
  after the tools' "tpu" keys are renamed "card";
- load_scene builds the same scene as the tools';
- the entry point runs end to end on the CPU, renders fresh draws under
  --part all and extends them only under --part draws, and without
  --device and a card it raises.
"""

import json
import sys
from pathlib import Path

import jax  # noqa: F401  (the JAX package renders on the CPU backend)
import numpy as np
import pytest
import torch

from raytracer_odin_tpu_torch.accuracy import __main__ as entry
from raytracer_odin_tpu_torch.accuracy import configs, render, report
from raytracer_odin_tpu_torch.models.scene import BVH_FIELDS, TENSOR_FIELDS
from raytracer_odin_tpu_torch.ops import traverse
from tests.torch_parity import torch_scene

TOOLS = Path(__file__).resolve().parents[1] / "tools"
sys.path.insert(0, str(TOOLS))
import rmse_common  # noqa: E402
import rmse_report  # noqa: E402
import rmse_tpu  # noqa: E402
import rmse_tpu_draws  # noqa: E402

GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 1e-5
# The glossy-scene gate of tests/test_torch_render.py.
MEAN_RTOL, PASS_FRACTION, MAX_ABS = 1e-3, 0.95, 0.1


@pytest.fixture
def scene_dirs(tmp_path, monkeypatch):
    """Both harnesses generate their scenes under tmp_path."""
    monkeypatch.setattr(rmse_common, "SCENE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(configs, "SCENE_DIR", tmp_path / "torch")
    return tmp_path


def test_tables_match_tools():
    assert configs.CONFIGS == rmse_common.CONFIGS
    assert configs.PROXY_SPP == rmse_common.TPU_PROXY_SPP
    assert render.SEED_BASE == rmse_tpu_draws.SEED_BASE
    for spp in (1, 2, 6, 8, 16, 96, 1024):
        cfg_step = min(spp, 8)
        while spp % cfg_step:
            cfg_step -= 1
        assert render.tools_step(spp) == cfg_step
    for spp, pixels in ((1024, 128 * 96), (1024, 256 * 256), (512, 128 * 72),
                        (96, 7), (4096, 1 << 22)):
        s = render.step_samples(spp, pixels)
        assert spp % s == 0 and (s == 1 or s * pixels <= render.STEP_LANES)


def _glossy(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert abs(got.mean() - want.mean()) <= MEAN_RTOL * abs(want.mean())
    ok = np.isclose(got, want, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    assert ok.mean() >= PASS_FRACTION, ok.mean()
    assert np.abs(got - want).max() <= MAX_ABS


@pytest.mark.parametrize("scene,w,h,depth,spp,exact", [
    ("cube", 32, 24, 2, 4, True),
    ("textured", 32, 24, 3, 2, False),
])
def test_render_stats_match_tools(scene_dirs, scene, w, h, depth, spp,
                                  exact):
    jhost, jscene = rmse_common.load_scene(scene)
    want = rmse_tpu.render_stats(jscene, jhost.cam.fov_x * (w / h), w, h,
                                 depth, spp)
    host, tscene = configs.load_scene(scene, "cpu")
    got = render.render_stats(tscene, host.cam.fov_x * (w / h), w, h, depth,
                              spp, device="cpu")
    for g, x in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (h, w, 3)
        if exact:
            assert np.allclose(g, x, rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL), (
                np.abs(g - x).max())
        else:
            _glossy(g, x)


@pytest.mark.parametrize("route,scene,depth", [
    ("auto", "cube", 2), ("auto", "textured", 3),
    ("pallas", "cube", 2), ("pallas", "textured", 3),
    ("pallas", "envmap", 3),
])
def test_stats_bit_equal_across_step_sizes(scene_dirs, monkeypatch, route,
                                           scene, depth):
    """Batched steps of 1, 2 and 4 samples (each traced as one batch of
    lanes) give the same mean and variance bit for bit as the runtime's
    own step, which traces sample by sample (uncompacted on the CPU): on
    the CPU's "auto" intersectors and on the card's route ("auto"
    resolving to "pallas": K1 + K2's plain versions behind the sorted
    cast)."""
    if route == "pallas":
        real = traverse.resolve_intersector
        monkeypatch.setattr(
            traverse, "resolve_intersector",
            lambda i, n, dev, brute_max_tris=512: real(
                "pallas" if i == "auto" else i, n, dev, brute_max_tris))
    host, sc = configs.load_scene(scene, "cpu")
    w, h = 16, 12
    fov = host.cam.fov_x * (w / h)
    want = render.render_stats(sc, fov, w, h, depth, 4, seed=3,
                               device="cpu")
    assert want[1].max() > 0
    for s in (1, 2, 4):
        got = render.render_stats(sc, fov, w, h, depth, 4, seed=3,
                                  device="cpu", batch=s)
        for a, b in zip(got, want):
            assert np.array_equal(a, b), s


# --- the report ----------------------------------------------------------

# Synthetic rows: (name, W, H, proxy W, proxy H); every branch of the
# report runs on one of them.
SYN = [
    # same-seed pass; oracle2 pooled; draws on both sides (empirical z)
    ("s1_pool", 10, 8, 6, 4),
    # no same-seed half; card proxy biased past the strict limits, an A/A
    # null at the oracle's spp widens them (the envelope fallback)
    ("s2_full", 10, 8, 6, 4),
    # stale shapes: the card proxy at another resolution
    ("s3_stale", 10, 8, 6, 4),
    # biased halves (both fail); the A/A null at another spp (stale null);
    # card draws without oracle draws
    ("s4_bias", 12, 6, 5, 3),
]


def _syn_rows():
    return [(n, "cube", w, h, 2, 16, 8, (pw, ph, 64))
            for n, w, h, pw, ph in SYN]


def _lay_out(rng, tools_dir, card_dir, ref_dir):
    """Seeded synthetic arrays under both naming schemes: the tools' (every
    file in tools_dir) and the port's (card arrays in card_dir, the
    references in ref_dir)."""
    def save(name, arr, *dirs):
        for d in dirs:
            np.save(d / name, arr)

    for name, w, h, pw, ph in SYN:
        if name != "s2_full":
            cpu = rng.gamma(2.0, 0.5, (h, w, 3)).astype(np.float32)
            var = rng.gamma(2.0, 0.2, (h, w, 3)).astype(np.float32)
            card = cpu + rng.normal(0, 1e-3, cpu.shape).astype(np.float32)
            if name == "s4_bias":
                card = card + 0.5
            save(f"{name}_cpu_sameseed.npy", cpu, tools_dir, ref_dir)
            save(f"{name}_cpu_sameseed_var.npy", var, tools_dir, ref_dir)
            save(f"{name}_tpu_sameseed.npy", card, tools_dir)
            save(f"{name}_tpu_sameseed_var.npy", var * 1.1, tools_dir)
            save(f"{name}_card_sameseed.npy", card, card_dir)
            save(f"{name}_card_sameseed_var.npy", var * 1.1, card_dir)
        o_spp = 256
        o_mean = rng.gamma(2.0, 0.5, (ph, pw, 3))
        o_var = rng.gamma(2.0, 0.3, (ph, pw, 3))
        noise = np.sqrt(o_var / o_spp + o_var / configs.PROXY_SPP)
        t_mean = o_mean + rng.normal(0, 1, o_mean.shape) * noise
        if name in ("s2_full", "s4_bias"):
            t_mean = t_mean + (0.9 if name == "s2_full" else 1.2) * noise
        if name == "s3_stale":
            t_mean = t_mean[:-1]
        for arr, fn in ((o_mean, "oracle_mean"), (o_var, "oracle_var")):
            save(f"{name}_{fn}.npy", arr.astype(np.float32), tools_dir,
                 ref_dir)
        save(f"{name}_oracle_spp.npy", np.int64(o_spp), tools_dir, ref_dir)
        for side in ("tpu", "card"):
            d = tools_dir if side == "tpu" else card_dir
            save(f"{name}_{side}_proxy_mean.npy", t_mean.astype(np.float32), d)
            save(f"{name}_{side}_proxy_var.npy",
                 (o_var * 1.05).astype(np.float32), d)
        if name == "s1_pool":
            o2 = o_mean + rng.normal(0, 1, o_mean.shape) * noise
            save(f"{name}_oracle2_mean.npy", o2.astype(np.float32), tools_dir,
                 ref_dir)
            save(f"{name}_oracle2_var.npy", o_var.astype(np.float32),
                 tools_dir, ref_dir)
            save(f"{name}_oracle2_spp.npy", np.int64(128), tools_dir, ref_dir)
        if name in ("s1_pool", "s4_bias"):
            draws = {
                "means": (t_mean[None] + rng.normal(0, 0.01, (6,) + t_mean.shape)
                          ).astype(np.float32),
                "vars": np.repeat(o_var[None], 6, 0).astype(np.float32),
                "chunk": np.int64(32)}
            np.savez(tools_dir / f"{name}_tpu_draws.npz", **draws)
            np.savez(card_dir / f"{name}_card_draws.npz", **draws)
        if name == "s1_pool":
            for suffix, k in (("", 5), ("_b", 3)):
                od = {"means": (o_mean[None] + rng.normal(
                          0, 0.01, (k,) + o_mean.shape)).astype(np.float32),
                      "vars": np.repeat(o_var[None], k, 0).astype(np.float32),
                      "chunk": np.int64(64)}
                for d in (tools_dir, ref_dir):
                    np.savez(d / f"{name}_oracle_draws{suffix}.npz", **od)
        if name in ("s2_full", "s4_bias"):
            null = {"config": name, "low_spp": o_spp if name == "s2_full"
                    else 4 * o_spp, "ref_spp": 1024, "n": 3,
                    "mean_shift_z": [40.0, -35.5, 20.0],
                    "rmse_over_floor": [1.2, 1.4, 1.1],
                    "frac_z_gt4": [0.01, 0.0, 0.02]}
            for d in (tools_dir, ref_dir):
                (d / f"{name}_aa_null.json").write_text(json.dumps(null))


_RENAME = {"tpu_proxy_spp": "card_proxy_spp",
           "variance_ratio_tpu_over_oracle": "variance_ratio_card_over_oracle",
           "tpu_spp_pooled": "card_spp_pooled", "se_tpu": "se_card"}


def _renamed(rec):
    if isinstance(rec, dict):
        return {_RENAME.get(k, k): _renamed(v) for k, v in rec.items()}
    if isinstance(rec, str):
        return rec.replace("tpu (", "card (")
    return rec


def test_report_matches_tools(tmp_path, monkeypatch, capsys):
    tools_dir, card_dir, ref_dir = (tmp_path / d for d in ("tools", "card",
                                                          "ref"))
    for d in (tools_dir, card_dir, ref_dir):
        d.mkdir()
    _lay_out(np.random.default_rng(20), tools_dir, card_dir, ref_dir)
    rows = _syn_rows()
    monkeypatch.setattr(rmse_report, "CONFIGS", rows)
    monkeypatch.setattr(rmse_report, "OUT_DIR", str(tools_dir))
    monkeypatch.setattr(configs, "NO_SAME_SEED", ("s2_full",))
    rmse_report.main()
    want = [json.loads(x) for x in
            (tools_dir / "report.jsonl").read_text().splitlines()]
    got = report.report(card_dir, ref_dir, rows, "cpu", log=lambda s: None)
    assert [json.loads(x) for x in
            (card_dir / "report.jsonl").read_text().splitlines()] == got
    assert len(got) == len(want) == len(SYN)
    for g, w in zip(got, want):
        assert g.pop("device") == "cpu"
        assert g == _renamed(w)
    by = {r["config"]: r for r in got}
    # every branch ran
    assert "oracle_two_draws" in by["s1_pool"]
    assert by["s1_pool"]["mean_test"] == "empirical_two_sample"
    assert by["s1_pool"]["oracle_emp"]["card_spp_pooled"] > 0
    assert "aa_null" in by["s2_full"] and "same_seed_rmse" not in by["s2_full"]
    assert by["s3_stale"]["oracle_stale_shapes"].startswith("card (")
    assert "aa_null_stale" in by["s4_bias"]
    assert by["s4_bias"]["mean_test"] == "claimed_se_aa_envelope"
    assert report.failures(got) == [("s3_stale", "distribution_agrees"),
                                    ("s4_bias", "same_seed_pass"),
                                    ("s4_bias", "distribution_agrees")]


def test_reference_files(tmp_path):
    """The committed references cover every row; a missing required file
    raises naming it; cfg1_cube_full reads no same-seed pair."""
    have = configs.require_references()
    assert len(have) == 39 and all(p.exists() for p in have)
    names = {p.name for p, _ in configs.reference_files(["cfg1_cube_full"])}
    assert not any("sameseed" in n for n in names)
    with pytest.raises(FileNotFoundError, match="cfg2_cornell_cpu_sameseed"):
        configs.require_references(["cfg2_cornell"], tmp_path)


@pytest.mark.parametrize("scene", ["cube", "textured"])
def test_load_scene_matches_tools(scene_dirs, scene):
    jhost, jscene = rmse_common.load_scene(scene)
    host, got = configs.load_scene(scene, "cpu")
    want = torch_scene(jscene)
    assert host.cam.fov_x == jhost.cam.fov_x
    for f in TENSOR_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    for f in BVH_FIELDS:
        assert torch.equal(getattr(got.bvh, f), getattr(want.bvh, f)), f
    for f in ("env_tex", "row_spec", "tex_kinds", "stream"):
        assert getattr(got, f) == getattr(want, f), f


# --- the entry point ------------------------------------------------------

def _tiny(monkeypatch):
    row = ("tiny_cube", "cube", 16, 12, 2, 4, 4, (16, 12, 64))
    monkeypatch.setattr(configs, "CONFIGS", [row])
    monkeypatch.setattr(configs, "PROXY_SPP", 64)
    monkeypatch.setattr(configs, "DRAW_CONFIGS", ("tiny_cube",))
    return row


def test_entry_point_end_to_end(scene_dirs, monkeypatch, capsys):
    """--part all on the CPU: the references are the JAX package's CPU
    render (same seed) and an independent render of the port (the
    oracle's place); every half is written and the row passes."""
    name, scene, w, h, depth, _c, ss_spp, (pw, ph, _p) = _tiny(monkeypatch)
    ref, out = scene_dirs / "ref", scene_dirs / "out"
    ref.mkdir()
    jhost, jscene = rmse_common.load_scene(scene)
    m, v = rmse_tpu.render_stats(jscene, jhost.cam.fov_x * (w / h), w, h,
                                 depth, ss_spp)
    np.save(ref / f"{name}_cpu_sameseed.npy", m)
    np.save(ref / f"{name}_cpu_sameseed_var.npy", v)
    host, tscene = configs.load_scene(scene, "cpu")
    om, ov = render.render_stats(tscene, host.cam.fov_x * (pw / ph), pw, ph,
                                 depth, 256, seed=99, device="cpu")
    np.save(ref / f"{name}_oracle_mean.npy", om)
    np.save(ref / f"{name}_oracle_var.npy", ov)
    np.save(ref / f"{name}_oracle_spp.npy", np.int64(256))
    rc = entry.main(["--device", "cpu", "--out", str(out), "--ref", str(ref),
                     "--draws", "4", "--chunk", "16", "--no-var-sweep"])
    text = capsys.readouterr().out
    assert rc == 0, text
    for f in ("card_sameseed.npy", "card_sameseed_var.npy",
              "card_proxy_mean.npy", "card_proxy_var.npy", "card_draws.npz"):
        assert (out / f"{name}_{f}").exists(), f
    assert np.load(out / f"{name}_card_draws.npz")["means"].shape == (
        4, ph, pw, 3)
    (rec,) = [json.loads(x) for x in
              (out / "report.jsonl").read_text().splitlines()]
    assert rec["device"] == "cpu" and rec["same_seed_pass"]
    assert rec["same_seed_rmse"] < 1e-5 and rec["distribution_agrees"]
    # the same-seed half is the JAX render's, sample for sample
    assert np.allclose(np.load(out / f"{name}_card_sameseed.npy"), m,
                       rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    # a missing reference raises before anything renders
    (ref / f"{name}_oracle_spp.npy").unlink()
    with pytest.raises(FileNotFoundError, match="oracle_spp"):
        entry.main(["--device", "cpu", "--out", str(out), "--ref", str(ref)])


def test_entry_point_draws_fresh_unless_resumed(scene_dirs, monkeypatch):
    """--part all renders its draws anew: run again after a change (here
    another seed base), it reports on its own draws, not on those the
    first run left in --out. --part draws extends the draws there."""
    name, scene, w, h, depth, _c, ss_spp, (pw, ph, _p) = _tiny(monkeypatch)
    ref, out = scene_dirs / "ref", scene_dirs / "out"
    ref.mkdir()
    host, sc = configs.load_scene(scene, "cpu")

    def stats(rw, rh, spp, seed):
        return render.render_stats(sc, host.cam.fov_x * (rw / rh), rw, rh,
                                   depth, spp, seed=seed, device="cpu")

    m, v = stats(w, h, ss_spp, 0)
    np.save(ref / f"{name}_cpu_sameseed.npy", m)
    np.save(ref / f"{name}_cpu_sameseed_var.npy", v)
    om, ov = stats(pw, ph, 256, 99)
    np.save(ref / f"{name}_oracle_mean.npy", om)
    np.save(ref / f"{name}_oracle_var.npy", ov)
    np.save(ref / f"{name}_oracle_spp.npy", np.int64(256))
    od = [stats(pw, ph, 16, 500 + k) for k in range(4)]
    np.savez(ref / f"{name}_oracle_draws.npz",
             means=np.stack([d[0] for d in od]),
             vars=np.stack([d[1] for d in od]), chunk=np.int64(16))
    argv = ["--device", "cpu", "--out", str(out), "--ref", str(ref),
            "--draws", "4", "--chunk", "16", "--no-var-sweep"]
    path = out / f"{name}_card_draws.npz"

    def run(args):
        assert entry.main(args) == 0
        (rec,) = [json.loads(x) for x in
                  (out / "report.jsonl").read_text().splitlines()]
        return np.load(path)["means"], rec

    first, rec1 = run(argv)
    assert rec1["mean_test"] == "empirical_two_sample"
    monkeypatch.setattr(render, "SEED_BASE", render.SEED_BASE + 7)
    second, rec2 = run(argv)
    assert second.shape == first.shape == (4, ph, pw, 3)
    for k in range(4):
        assert not np.array_equal(first[k], second[k]), k
        want = stats(pw, ph, 16, render.SEED_BASE + k)[0]
        assert np.array_equal(second[k], want), k
    assert (rec2["oracle_emp"]["mean_diff"]
            != rec1["oracle_emp"]["mean_diff"])
    third, _ = run(argv[:-5] + ["--part", "draws", "--draws", "6",
                                "--chunk", "16", "--no-var-sweep"])
    assert third.shape[0] == 6 and np.array_equal(third[:4], second)


def test_entry_point_needs_a_card(scene_dirs, monkeypatch):
    """Without --device the harness renders on the card; with none it
    raises instead of falling back to the CPU."""
    _tiny(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.main(["--part", "sameseed", "--out", str(scene_dirs / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.Harness()
