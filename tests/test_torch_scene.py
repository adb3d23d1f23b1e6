"""PyTorch port: RNG bits, scene upload, package rules.

The counter-based PCG4D uniforms and the seed's key words must be
bit-equal to the JAX package's; every scene-upload array must equal the
JAX builder's (both use the native BVH builder, whose triangle permutation
the numpy fallback does not reproduce)."""

import ast
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.io import images as jimages
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.models.scene import HostTexture as JHostTexture
from raytracer_odin_tpu.utils import prng as jprng
from raytracer_odin_tpu_torch.io import gltf as tgltf
from raytracer_odin_tpu_torch.io import images as timages
from raytracer_odin_tpu_torch.models import assets as tassets
from raytracer_odin_tpu_torch.models import build as tbuild
from raytracer_odin_tpu_torch.models.scene import (
    TENSOR_FIELDS,
    HostTexture as THostTexture,
)
from raytracer_odin_tpu_torch.utils import prng as tprng

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("seed", [0, 1, 123456, 2**31 - 1])
def test_key_words_match_prng_key(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert tuple(int(x) for x in want) == tprng.key_from_seed(seed)


@pytest.mark.parametrize("sample,tag,n", [
    (0, 0, 6), (5, 3, 6), (2**31 - 7, jprng.JITTER_TAG, 2), (17, 7, 5),
])
def test_uniforms_bit_equal(sample, tag, n):
    rng = np.random.default_rng(sample % 1000)
    sids = rng.integers(0, 2**31 - 1, (33, 31)).astype(np.int32)
    for seed in (0, 42):
        want = np.asarray(jprng.uniforms(jax.random.PRNGKey(seed), sample, tag,
                                         jnp.asarray(sids), n))
        got = tprng.uniforms(tprng.key_from_seed(seed), sample, tag,
                             torch.from_numpy(sids), n).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)


def test_uniforms_per_lane_counters():
    """Per-lane sample and tag tensors (the pool's addressing) also match."""
    rng = np.random.default_rng(3)
    n = 500
    samples = rng.integers(0, 1000, n).astype(np.int32)
    tags = rng.integers(0, 8, n).astype(np.int32)
    sids = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    want = np.asarray(jprng.uniforms(jax.random.PRNGKey(9), jnp.asarray(samples),
                                     jnp.asarray(tags), jnp.asarray(sids), 6))
    got = tprng.uniforms(tprng.key_from_seed(9), torch.from_numpy(samples),
                         torch.from_numpy(tags), torch.from_numpy(sids), 6)
    assert np.array_equal(got.numpy(), want)


def _scenes(name, tmp_path):
    jinfo = jassets.generate(name, tmp_path / "jax")
    tinfo = tassets.generate(name, tmp_path / "torch")
    jhost = jgltf.read_gltf(jinfo["gltf"])
    thost = tgltf.read_gltf(tinfo["gltf"])
    jenv = tenv = None
    if "env" in jinfo:
        li = jimages.load_image(jinfo["env"])
        jenv = JHostTexture(li.data, li.is_hdr)
        li = timages.load_image(tinfo["env"])
        tenv = THostTexture(li.data, li.is_hdr)
    return jbuild.finish_scene(jhost, env_map=jenv), thost, tenv


@pytest.mark.parametrize("name", ["cube", "cornell", "textured", "envmap",
                                  "demo"])
def test_scene_upload_matches(name, tmp_path):
    """Every DeviceScene array of the port equals the JAX builder's, and so
    do the static row layout, texture kinds and env-map id."""
    js, thost, tenv = _scenes(name, tmp_path)
    arrays, statics = tbuild.scene_arrays(thost, tenv)
    for f in TENSOR_FIELDS:
        want = np.asarray(getattr(js, f))
        got = np.asarray(arrays[f]).astype(want.dtype)
        assert got.shape == want.shape and np.array_equal(got, want), f
    assert statics["row_spec"] == js.row_spec
    assert statics["tex_kinds"] == js.tex_kinds
    assert statics["env_tex"] == js.env_tex
    scene = tbuild.finish_scene(thost, env_map=tenv, device="cpu")
    assert scene.device == torch.device("cpu")
    assert scene.tri_mat.dtype == torch.int32
    assert torch.equal(scene.ptri, torch.from_numpy(np.array(js.ptri)))


def test_demo_scene_layout(tmp_path):
    """The demo scene of the main path: 7,090 triangles in 111 clusters of
    64 (4 mask words at g = 1), 4 lights, a [7104, 12] triangle array."""
    arrays, _ = tbuild.scene_arrays(tgltf.read_gltf(
        tassets.generate("demo", tmp_path)["gltf"]))
    assert arrays["tri_p"].shape[0] == 7090
    assert arrays["cluster_lo"].shape[0] == 111
    assert arrays["ptri"].shape == (7104, 12)
    assert arrays["light_p"].shape[0] == 4


def test_tf32_off_after_import():
    import raytracer_odin_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (AST scan of every import statement)."""
    pkg = ROOT / "raytracer_odin_tpu_torch"
    # build/ holds build outputs (gitignored), not the package's modules
    files = sorted(p for p in pkg.rglob("*.py")
                   if p.relative_to(pkg).parts[0] != "build")
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for must in ("cli.py", "__main__.py", "oracle/cpu_reference.py",
                 "render/checkpoint.py", "io/writers.py",
                 "utils/profiling.py", "ops/shading_cols.py",
                 "utils/vec3c.py", "utils/env.py", "accuracy/render.py",
                 "accuracy/report.py"):
        assert pkg / must in files, must
    for path in files:
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "raytracer_odin_tpu"), (
                    path, name)


def test_entry_points_default_to_cuda(tmp_path):
    """Without device=, the entry points ask for the card and raise here
    instead of running on the CPU."""
    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.render import runtime

    host = tgltf.read_gltf(tassets.generate("cube", tmp_path)["gltf"])
    with pytest.raises((RuntimeError, AssertionError)):
        tbuild.finish_scene(host)
    scene = tbuild.finish_scene(host, device="cpu")
    cfg = RenderConfig(width=8, height=8, ray_depth=2, samples=1,
                       samples_per_step=1,
                       intersector="pallas")
    with pytest.raises(RuntimeError):
        runtime.render_scene(scene, cfg, host.cam.fov_x)
    step = runtime.make_render_step(cfg, host.cam.fov_x)
    with pytest.raises(RuntimeError):
        step(scene, None, tprng.key_from_seed(0), 0)
    with pytest.raises(RuntimeError):
        runtime.auto_lane_schedule(scene, cfg, host.cam.fov_x)
