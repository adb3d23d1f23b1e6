"""The port's command-line driver, run in process on the CPU
(`cli.main(argv, device="cpu")`; mirrors tests/test_cli.py:35-117), the
mesh, pool and refill flags against the JAX CLI's, its option records
against the JAX package's, its debug flags (--debug with --layer,
--preview-file, --debug-nans), its output against the JAX package's CLI
from the same argv, and its numpy oracle against the JAX package's.

Tolerance of the CLI comparison: the two renders agree to the golden
test's rtol 1e-4, atol 1e-5 (tests/test_torch_render.py), which tone
mapping and 8-bit rounding turn into at most one level in a few values;
measured on the CPU: equal images. The oracle is numpy on both sides and
is held bit for bit."""

import numpy as np
import pytest

from raytracer_odin_tpu import cli as jcli
from raytracer_odin_tpu.ops import probes as jprobes
from raytracer_odin_tpu.render import checkpoint as jcheckpoint
from raytracer_odin_tpu.render import output as joutput
from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.io import images as jimages
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.oracle import cpu_reference as joracle
from raytracer_odin_tpu.utils import compile_cache
from raytracer_odin_tpu_torch import cli
from raytracer_odin_tpu_torch.io import gltf, hdr, images, png
from raytracer_odin_tpu_torch.ops import probes
from raytracer_odin_tpu_torch.models import assets, build
from raytracer_odin_tpu_torch.oracle import cpu_reference as oracle
from tests.torch_parity import torch_scene


def run_cli(*args):
    return cli.main([str(a) for a in args], device="cpu")


@pytest.fixture(scope="module")
def cube_gltf(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_scenes")
    return assets.generate("cube", d)["gltf"]


SMALL = ("--width", "16", "--height", "16", "--ray-depth", "2",
         "--num-samples", "2")


def test_basic_render(cube_gltf, tmp_path):
    out = tmp_path / "out.png"
    assert run_cli(cube_gltf, out, "--width", "24", "--height", "24",
                   "--ray-depth", "2", "--num-samples", "2", "--quiet") == 0
    img = images.load_image(out)
    assert img.data.shape == (24, 24, 3)
    assert img.data.max() > 0


def test_ppm_output_and_modes(cube_gltf, tmp_path):
    out = tmp_path / "out.ppm"
    assert run_cli(cube_gltf, out, *SMALL, "--mode", "count",
                   "--quiet") == 0
    img = images.load_image(out)
    assert img.data.shape == (16, 16, 3)
    data = out.read_bytes()
    assert data.startswith(b"P6\n16 16\n255\n")
    assert np.array_equal(images.decode_ppm(data), jimages.decode_ppm(data))


def test_times_benchmark_summary(cube_gltf, capsys):
    assert run_cli(cube_gltf, *SMALL, "--times", "2") == 0
    out = capsys.readouterr().out
    assert "Performance Summary" in out
    assert "Trials: 2" in out and "Throughput:" in out


def test_checkpoint_flag(cube_gltf, tmp_path, capsys):
    ck = tmp_path / "ck.npz"
    out = tmp_path / "o.png"
    assert run_cli(cube_gltf, out, *SMALL, "--checkpoint", ck,
                   "--quiet") == 0
    assert ck.exists()
    assert run_cli(cube_gltf, out, "--width", "16", "--height", "16",
                   "--ray-depth", "2", "--num-samples", "4",
                   "--spp-per-step", "2", "--checkpoint", ck,
                   "--resume") == 0
    printed = capsys.readouterr().out
    assert f"Resumed 2 samples from {ck}" in printed
    assert "(4 spp)" in printed


def test_oracle_mode(cube_gltf, tmp_path):
    out = tmp_path / "oracle.png"
    assert run_cli(cube_gltf, out, *SMALL, "--oracle", "--quiet") == 0
    assert images.load_image(out).data.shape == (16, 16, 3)


def test_missing_scene_fails():
    with pytest.raises(OSError):
        run_cli("/nonexistent/scene.gltf", "--quiet")


def test_env_map_flag(tmp_path):
    gltf_path = assets.generate("cube", tmp_path)["gltf"]
    hdr_path = tmp_path / "sky.hdr"
    hdr_path.write_bytes(hdr.encode(assets.procedural_sky(32, 16)))
    out = tmp_path / "env.png"
    assert run_cli(gltf_path, out, *SMALL, "--env-map", hdr_path,
                   "--quiet") == 0
    assert out.exists()


def test_profile_dir(cube_gltf, tmp_path):
    prof = tmp_path / "prof"
    assert run_cli(cube_gltf, *SMALL, "--profile-dir", prof, "--quiet") == 0
    assert (prof / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("flags,item", [
    (["--devices", "2"], "item 1"),
    (["--spp-devices", "2"], "item 1"),
    (["--pool"], "item 2"),
    (["--compact", "refill"], "item 2"),
])
def test_unported_flags_raise(cube_gltf, tmp_path, monkeypatch, flags,
                              item):
    """The flags the port once refused (ROADMAP.md queue A `item`, now
    ported) run, and write the JAX CLI's image from the same argv within
    one 8-bit level. The mesh flags render on [cpu] * 2 in the port and on
    the JAX CLI's virtual devices (--spp-devices 2 makes it a 4 x 2 mesh:
    the same samples, summed in another order); --compact refill runs
    through "pallas" (on the CPU "auto" means the batched step in both)."""
    monkeypatch.setattr(compile_cache, "enable", lambda *a, **k: None)
    argv = [*SMALL, *flags, "--seed", "2", "--quiet"]
    if flags == ["--compact", "refill"]:
        argv += ["--intersector", "pallas"]
    jout, tout = tmp_path / "j.png", tmp_path / "t.png"
    assert jcli.main([str(cube_gltf), str(jout), *argv]) == 0
    assert run_cli(cube_gltf, tout, *argv) == 0
    want = np.round(jimages.load_image(jout).data * 255)
    got = np.round(images.load_image(tout).data * 255)
    assert got.shape == want.shape == (16, 16, 3)
    assert np.abs(got - want).max() <= 1


def test_devices_above_the_count_raise(cube_gltf, monkeypatch):
    """On the card, a mesh larger than the cards there are raises, naming
    the count; --devices 0 means every card, as in the JAX CLI."""
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards; 1 CUDA device"):
        cli.main([str(cube_gltf), *SMALL, "--devices", "2", "--quiet"])
    with pytest.raises(ValueError, match="needs 2 cards; 1 CUDA device"):
        cli.main([str(cube_gltf), *SMALL, "--spp-devices", "2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    n_tile, n_spp, devs = cli.mesh_devices(0, 1, "cuda")
    assert (n_tile, n_spp) == (4, 1)
    assert devs == [torch.device("cuda", i) for i in range(4)]
    assert cli.mesh_devices(0, 2, "cuda")[:2] == (2, 2)
    assert cli.mesh_devices(0, 1, "cpu") == (1, 1, [torch.device("cpu")])
    assert cli.mesh_devices(3, 1, "cuda:0")[2] == [torch.device("cuda",
                                                                0)] * 3


def test_option_records_match_jax():
    """RenderConfig and TraceOptions carry every field of the JAX
    package's, in its order, with its defaults, but for RenderConfig's
    debug_features (False in the port: ROADMAP.md queue C item 6) and
    TraceOptions' check_nans (the port's --debug-nans, last)."""
    import dataclasses

    from raytracer_odin_tpu.config import RenderConfig as JRenderConfig
    from raytracer_odin_tpu.ops.integrator import TraceOptions as JOpts
    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.ops.integrator import TraceOptions

    jf = {f.name: f.default for f in dataclasses.fields(JRenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert list(tf) == list(jf)
    assert {k: v for k, v in tf.items() if k != "debug_features"} == {
        k: v for k, v in jf.items() if k != "debug_features"}
    assert jf["debug_features"] is True and tf["debug_features"] is False
    assert list(TraceOptions._fields) == list(JOpts._fields) + [
        "check_nans"]
    assert {k: v for k, v in TraceOptions._field_defaults.items()
            if k != "check_nans"} == JOpts._field_defaults
    with pytest.raises(ValueError, match="f32"):
        RenderConfig(precision="bf16")


def test_accepted_parity_flags(cube_gltf, tmp_path):
    """--threads is accepted and ignored; --layer beauty and --devices 1
    name what the port has."""
    out = tmp_path / "o.png"
    assert run_cli(cube_gltf, out, *SMALL, "--threads", "8", "--layer",
                   "beauty", "--devices", "1", "--quiet") == 0
    assert out.exists()


def test_cli_matches_jax_cli(cube_gltf, tmp_path, monkeypatch):
    """The same argv through both CLIs (on the CPU both resolve "auto" to
    "brute"; --devices 1 keeps the JAX CLI on one device): images within
    one 8-bit level (measured: equal)."""
    monkeypatch.setattr(compile_cache, "enable", lambda *a, **k: None)
    argv = ["--width", "20", "--height", "12", "--ray-depth", "3",
            "--num-samples", "4", "--seed", "3", "--devices", "1",
            "--quiet"]
    jout, tout = tmp_path / "j.png", tmp_path / "t.png"
    assert jcli.main([cube_gltf, str(jout), *argv]) == 0
    assert cli.main([cube_gltf, str(tout), *argv], device="cpu") == 0
    want = np.round(jimages.load_image(jout).data * 255)
    got = np.round(images.load_image(tout).data * 255)
    assert got.shape == want.shape == (12, 20, 3)
    assert np.abs(got - want).max() <= 1


def test_oracle_bit_equal(tmp_path):
    """The port's numpy oracle reproduces the JAX package's bit for bit on
    the cube (8 x 8, 2 spp)."""
    jhost = jgltf.read_gltf(jassets.generate("cube", tmp_path)["gltf"])
    js = jbuild.finish_scene(jhost)
    ts = torch_scene(js)
    thost = gltf.read_gltf(assets.generate("cube", tmp_path / "t")["gltf"])
    own = build.finish_scene(thost, device="cpu")
    fov = jhost.cam.fov_x
    want = joracle.render(js, 8, 8, fov, 4, 2, seed=5)
    got = oracle.render(ts, 8, 8, fov, 4, 2, seed=5)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(oracle.render(own, 8, 8, fov, 4, 2, seed=5), want)
    assert np.isfinite(got).all() and got.max() > 0


def test_cli_defaults_to_cuda(cube_gltf):
    """Without device=, the CLI asks for the card and raises here instead
    of rendering on the CPU."""
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main([cube_gltf, *SMALL, "--quiet"])


DEBUG_ARGV = ("--width", "16", "--height", "16", "--ray-depth", "3",
              "--num-samples", "2", "--seed", "1", "--mode", "mean",
              "--quiet")


@pytest.fixture(scope="module")
def jax_debug_stats(cube_gltf, tmp_path_factory):
    """The JAX CLI's --debug render of the cube (ten layers), through its
    checkpoint."""
    ck = tmp_path_factory.mktemp("jax_debug") / "ck.npz"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compile_cache, "enable", lambda *a, **k: None)
        assert jcli.main([str(cube_gltf), "--debug", "--devices", "1",
                          "--checkpoint", str(ck), *DEBUG_ARGV]) == 0
    stats, samples, _ = jcheckpoint.load(str(ck))
    assert samples == 2
    return stats


@pytest.mark.parametrize("name", jprobes.layer_names())
def test_debug_layer_by_name_matches_jax(cube_gltf, tmp_path, name,
                                         jax_debug_stats):
    """--debug --layer <name> writes that layer, equal to the JAX CLI's PNG
    of the same layer from the same argv within one 8-bit level (on the
    CPU both resolve "auto" to "brute")."""
    out = tmp_path / f"{name}.png"
    assert run_cli(cube_gltf, out, "--debug", "--layer", name,
                   *DEBUG_ARGV) == 0
    got = png.decode(out.read_bytes()).astype(int)
    index = probes.layer_names().index(name)
    want = joutput.layer_to_rgb(jax_debug_stats, index, "mean").astype(int)
    assert got.shape == want.shape == (16, 16, 3)
    assert np.abs(got - want).max() <= 1
    if name != "beauty":
        assert run_cli(cube_gltf, tmp_path / "i.png", "--debug", "--layer",
                       str(index), *DEBUG_ARGV) == 0
        assert (tmp_path / "i.png").read_bytes() == out.read_bytes()


def test_unknown_layer_lists_names(cube_gltf, capsys):
    with pytest.raises(SystemExit):
        run_cli(cube_gltf, *SMALL, "--layer", "nope")
    err = capsys.readouterr().err
    assert "unknown layer 'nope'; known: " + ", ".join(
        probes.layer_names()) in err


def test_aov_layer_needs_debug(cube_gltf):
    """Without --debug the render has the beauty layer only (the JAX CLI
    would clamp the index and write the beauty layer)."""
    with pytest.raises(ValueError, match="need --debug"):
        run_cli(cube_gltf, *SMALL, "--layer", "depth", "--quiet")


def test_preview_file_snapshot(cube_gltf, tmp_path):
    """--debug --preview-file writes the snapshot of --layer/--mode."""
    snap = tmp_path / "snap.png"
    out = tmp_path / "o.png"
    assert run_cli(cube_gltf, out, *SMALL, "--debug", "--preview-file",
                   snap, "--layer", "normal", "--mode", "first",
                   "--quiet") == 0
    assert png.decode(snap.read_bytes()).shape == (16, 16, 3)
    assert snap.read_bytes() == out.read_bytes()


def test_debug_nans_flag(cube_gltf, tmp_path):
    """--debug-nans checks every sample and changes nothing in the image."""
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    assert run_cli(cube_gltf, a, *SMALL, "--debug", "--debug-nans",
                   "--quiet") == 0
    assert run_cli(cube_gltf, b, *SMALL, "--quiet") == 0
    assert a.read_bytes() == b.read_bytes()
