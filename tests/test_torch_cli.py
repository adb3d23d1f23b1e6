"""The port's command-line driver, run in process on the CPU
(`cli.main(argv, device="cpu")`; mirrors tests/test_cli.py:35-117), the
flags it does not port yet, its output against the JAX package's CLI from
the same argv, and its numpy oracle against the JAX package's.

Tolerance of the CLI comparison: the two renders agree to the golden
test's rtol 1e-4, atol 1e-5 (tests/test_torch_render.py), which tone
mapping and 8-bit rounding turn into at most one level in a few values;
measured on the CPU: equal images. The oracle is numpy on both sides and
is held bit for bit."""

import numpy as np
import pytest

from raytracer_odin_tpu import cli as jcli
from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.io import images as jimages
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.oracle import cpu_reference as joracle
from raytracer_odin_tpu.utils import compile_cache
from raytracer_odin_tpu_torch import cli
from raytracer_odin_tpu_torch.io import gltf, hdr, images
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
    (["--debug"], "item 1"),
    (["--layer", "2"], "item 1"),
    (["--preview-port", "8000"], "item 1"),
    (["--preview-file", "p.png"], "item 1"),
    (["--debug-nans"], "item 1"),
    (["--devices", "2"], "item 2"),
    (["--spp-devices", "2"], "item 2"),
    (["--pool"], "item 3"),
    (["--compact", "refill"], "item 3"),
])
def test_unported_flags_raise(cube_gltf, flags, item):
    with pytest.raises(NotImplementedError, match=f"queue A {item}"):
        run_cli(cube_gltf, *SMALL, *flags, "--quiet")


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
