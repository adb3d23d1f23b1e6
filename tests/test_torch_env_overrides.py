"""The JAX package's environment overrides in the PyTorch port, on the CPU.

Each variable is read under its JAX name at the moment the JAX package
reads it, and either honoured or refused with a ValueError that names it:
  * at import: RT_TPU_LEAF, RT_TPU_RB, RT_TPU_RB_SUB, RT_TPU_MAX_EXACT,
    RT_TPU_COLS, RT_TPU_SORT_EVERY (one subprocess each: honoured values
    are held against the JAX package under the same environment, refused
    ones must stop the import; RT_TPU_SORT_EVERY takes 1 only, since the
    port has no skip-sort cadence);
  * at call: RT_TPU_CHUNK_TRIS, RT_TPU_LIGHT_CULL_MIN (monkeypatch.setenv);
  * at scene build: RT_TPU_STREAM_TRIS;
  * RT_TPU_NO_NATIVE: the BVH and the PNG unfilter take the JAX package's
    numpy paths, and give their results bit for bit;
  * RT_ORACLE_MP_CONTEXT (tests/test_torch_oracle.py).

Tolerances: mask words, lists and hit indices bit-equal; hit t within
T_RTOL of tests/test_torch_bigscene.py (XLA's CPU backend fuses
multiply-adds); a render sample at the glossy-scene gate of
tests/test_torch_render.py with equal live-lane and ray counts."""

import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.io import png as jpng
from raytracer_odin_tpu.ops import bvh as jbvh
from raytracer_odin_tpu.ops import pallas_intersect as jpi
from raytracer_odin_tpu.ops import traverse as jtrav
from raytracer_odin_tpu_torch.io import native as tnative
from raytracer_odin_tpu_torch.io import png as tpng
from raytracer_odin_tpu_torch.models import build as tbuild
from raytracer_odin_tpu_torch.ops import bvh as tbvh
from raytracer_odin_tpu_torch.ops import light_cull as tlc
from raytracer_odin_tpu_torch.ops import pallas_intersect as tpi
from raytracer_odin_tpu_torch.ops import shading as tshading
from raytracer_odin_tpu_torch.ops import traverse as ttrav
from tests.conftest import random_triangles
from tests.test_torch_bigscene import (
    _host,
    _rays,
    _same_hits,
    _t,
    _two_level_pair,
)

ROOT = Path(__file__).resolve().parents[1]
IMPORT_VARS = ("RT_TPU_LEAF", "RT_TPU_RB", "RT_TPU_RB_SUB",
               "RT_TPU_MAX_EXACT", "RT_TPU_COLS", "RT_TPU_SORT_EVERY")


def _run(env, code, timeout=240):
    """Run `code` in a fresh interpreter at the repository root with the
    variables of `env` set (and every other import-time variable unset);
    returns the completed process."""
    full = {k: v for k, v in os.environ.items() if k not in IMPORT_VARS}
    full.update(env, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
                JAX_PLATFORM_NAME="cpu")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("env", [
    {"RT_TPU_LEAF": "30"}, {"RT_TPU_LEAF": "1024"}, {"RT_TPU_RB": "500"},
    {"RT_TPU_RB_SUB": "384"}, {"RT_TPU_MAX_EXACT": "2000"},
    {"RT_TPU_MAX_EXACT": "many"}, {"RT_TPU_COLS": "2"},
    {"RT_TPU_SORT_EVERY": "0"}, {"RT_TPU_SORT_EVERY": "2"},
], ids=lambda e: "=".join(next(iter(e.items()))))
def test_refused_import_values(env):
    """A value the port cannot honour stops its import with a ValueError
    naming the variable (the card and the CPU accept the same settings)."""
    (name, value), = env.items()
    proc = _run(env, "import raytracer_odin_tpu_torch.ops.integrator")
    assert proc.returncode != 0
    last = proc.stderr.strip().splitlines()[-1]
    assert last.startswith("ValueError") and name in last, proc.stderr


# A random-triangle scene through both packages' casts: the tiled cast and
# the sorted cast of the exact-cull path, hits compared lane for lane.
_CAST = """
import tests.conftest
import numpy as np, jax.numpy as jnp, torch
from tests.conftest import random_triangles
from tests.test_bvh import make_scene
from tests.torch_parity import torch_scene
from raytracer_odin_tpu.ops import pallas_intersect as jpi
from raytracer_odin_tpu.ops import traverse as jtrav
from raytracer_odin_tpu_torch.ops import cuda_build
from raytracer_odin_tpu_torch.ops import pallas_intersect as tpi
from raytracer_odin_tpu_torch.ops import traverse as ttrav
assert (tpi.LEAF, tpi.RB, tpi.RB_SUB) == (jpi.LEAF, jpi.RB, jpi.RB_SUB)
assert ttrav.MAX_EXACT_CLUSTERS == jtrav.MAX_EXACT_CLUSTERS
assert cuda_build.LAYOUT == {"RT_LEAF": tpi.LEAF, "RT_RB": tpi.RB,
                             "RT_RB_SUB": tpi.RB_SUB}
rng = np.random.default_rng(4)
p, u, v = random_triangles(rng, 700)
js = make_scene(p, u, v)
ts = torch_scene(js)
assert ttrav.exact_cull_layout(ts)[:2] == jtrav.exact_cull_layout(js)[:2]


def _t(a):
    return torch.from_numpy(np.array(a))


def _same_hits(jt, ji, tt, ti):  # tests/test_torch_bigscene.py's gate
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.allclose(np.asarray(jt), tt.numpy(), rtol=1e-5, atol=1e-6)


h, w = 16, 32
o = rng.uniform(-8, 8, (h, w, 3)).astype(np.float32)
d = rng.normal(size=(h, w, 3)).astype(np.float32)
d /= np.linalg.norm(d, axis=-1, keepdims=True)
jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o), jnp.asarray(d))
tt, ti = ttrav.cast_rays_pallas(ts, _t(o), _t(d))
assert (np.asarray(ji) >= 0).sum() > 50
_same_hits(jt, ji, tt, ti)
o2, d2 = o.reshape(-1, 3), d.reshape(-1, 3)
alive = rng.random(h * w) < 0.8
jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o2), jnp.asarray(d2),
                                      sort=True, alive=jnp.asarray(alive))
tt, ti = ttrav.cast_rays_pallas(ts, _t(o2), _t(d2), sort=True,
                                alive=_t(alive))
_same_hits(jt, ji, tt, ti)
"""


@pytest.mark.parametrize("env", [
    {"RT_TPU_LEAF": "32"},
    {"RT_TPU_RB": "256", "RT_TPU_RB_SUB": "128"},
    {"RT_TPU_MAX_EXACT": "4"},
], ids=["leaf32", "rb256_sub128", "max_exact4"])
def test_honoured_layout_matches_jax(env):
    """Triangles a cluster, rays a bundle and a list, and mask bits, set in
    both packages' environment: the same layout and the same hits on a
    tiled and a sorted cast (at MAX_EXACT 4 the scene's 11 clusters take
    the two-level layout)."""
    proc = _run(env, _CAST)
    assert proc.returncode == 0, proc.stderr[-4000:]


_TRACE = """
import tests.conftest
import numpy as np, jax, jax.numpy as jnp
from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.ops import integrator as jinteg
from raytracer_odin_tpu.ops.integrator import TraceOptions as JTraceOptions
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch.ops import integrator as tinteg
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.render import runtime as truntime
from raytracer_odin_tpu_torch.utils import prng
from tests.test_torch_render import _near
from tests.torch_parity import torch_scene
import tempfile
assert tinteg.COLS == jinteg.COLS == 1
host = jgltf.read_gltf(jassets.generate("cornell", tempfile.mkdtemp())["gltf"])
js = jbuild.finish_scene(host)
ts = torch_scene(js)
w = h = 16
sched = (512,) * 3
jr, ja = jax.jit(lambda k: jruntime.sample_pass(
    js, k, jnp.int32(0), host.cam.fov_x, w, h,
    JTraceOptions(depth=4, intersector="pallas", lane_schedule=sched)))(
    jax.random.PRNGKey(0))
tr, ta = truntime.sample_pass(
    ts, prng.key_from_seed(0), 0, host.cam.fov_x, w, h,
    TraceOptions(depth=4, intersector="pallas", lane_schedule=sched))
assert ta["alive_counts"].tolist() == np.asarray(ja["alive_counts"]).tolist()
assert int(ta["rays_cast"]) == int(ja["rays_cast"])
assert int(ta["overflow"]) == int(ja["overflow"]) == 0
_near(tr.numpy(), jr)
"""


def test_honoured_trace_switches_match_jax():
    """RT_TPU_COLS=1 in both packages' environment: the column layout of
    the compacted trace, a compacted cornell sample (16x16, depth 4)
    against the JAX package's columnar trace."""
    proc = _run({"RT_TPU_COLS": "1"}, _TRACE)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_chunk_tris_at_call(monkeypatch):
    """RT_TPU_CHUNK_TRIS is read at every call, as the JAX package reads
    it: set alone (no module constant patched), it makes a two-level scene's
    lists chunk-major in the port as it chunks the JAX package's sweep, with
    the same hits; a value below 1 is refused."""
    rng = np.random.default_rng(5)
    js, ts = _two_level_pair(monkeypatch, rng, 1100, 4)  # 18 clusters
    g, n_super, _ = ttrav.exact_cull_layout(ts)
    o, d = _rays(rng, 1024, spread=9)
    rays, _, _ = tpi.pack_rays(_t(o), _t(d))
    words = tpi.cluster_masks_rows(ttrav.exact_cull_layout(ts)[2], rays,
                                   n_super)
    c, lst = ttrav.sweep_lists(ts, words, rays, g, n_super, cap=3)
    assert (c == -1).any()
    monkeypatch.setenv("RT_TPU_CHUNK_TRIS", str(5 * tpi.LEAF))
    assert tpi.chunk_tris() == jpi.chunk_tris() == 5 * tpi.LEAF
    c, lst = ttrav.sweep_lists(ts, words, rays, g, n_super, cap=3)
    assert (c > 3).any() and (c >= 0).all()
    h = w = 32
    o = rng.uniform(-8, 8, (h, w, 3)).astype(np.float32)
    d = rng.normal(size=(h, w, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jt, ji, _, _ = jtrav.cast_rays_pallas(js, jnp.asarray(o), jnp.asarray(d))
    tt, ti = ttrav.cast_rays_pallas(ts, _t(o), _t(d))
    _same_hits(jt, ji, tt, ti)
    monkeypatch.setenv("RT_TPU_CHUNK_TRIS", "0")
    with pytest.raises(ValueError, match="RT_TPU_CHUNK_TRIS"):
        ttrav.sweep_lists(ts, words, rays, g, n_super, cap=3)


def test_stream_tris_at_build(monkeypatch):
    """RT_TPU_STREAM_TRIS is read where the scene is built, as the JAX
    package's pad_triangles reads it: set alone, it streams the port's
    scene as it widens the JAX package's rows; a negative value is
    refused."""
    rng = np.random.default_rng(6)
    p, u, v = random_triangles(rng, 300)
    _, statics = tbuild.scene_arrays(_host(p, u, v))
    assert not statics["stream"]
    monkeypatch.setenv("RT_TPU_STREAM_TRIS", "1")
    arrays, statics = tbuild.scene_arrays(_host(p, u, v))
    assert statics["stream"] and tpi.stream_tris() == 1
    assert jpi.pad_triangles(p, u, v).shape[1] == 128
    monkeypatch.setenv("RT_TPU_STREAM_TRIS", "-1")
    with pytest.raises(ValueError, match="RT_TPU_STREAM_TRIS"):
        tbuild.scene_arrays(_host(p, u, v))


def test_light_cull_min_at_call(monkeypatch, cornell_scene):
    """RT_TPU_LIGHT_CULL_MIN is read at every call (light_cull.threshold):
    lowered, the row-form mixture pdf of cornell's two emitters takes the
    culled sum, equal to the dense sum at rtol 2e-4 (tests/
    test_torch_lightcull.py); a negative value is refused. (The columnar
    trace under the same setting: tests/test_torch_shading_cols.py.)"""
    from tests.torch_parity import torch_scene

    _, js = cornell_scene
    ts = torch_scene(js)
    assert tlc.threshold() == 512
    rng = np.random.default_rng(8)
    o, d = _rays(rng, 600, spread=0.9)
    _, out = _rays(rng, 600)
    args = (ts, _t(o), _t(np.tile([0.0, 1.0, 0.0], (600, 1))).float(),
            torch.full((600,), 0.5), _t(d), _t(out), True)
    calls = []
    real = tlc.light_pdf_sum_culled
    monkeypatch.setattr(tlc, "light_pdf_sum_culled",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    dense = tshading.mixture_pdf(*args)
    assert not calls
    monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", "1")
    assert tlc.threshold() == 1
    culled = tshading.mixture_pdf(*args)
    assert calls
    assert torch.allclose(culled, dense, rtol=2e-4, atol=1e-6,
                          equal_nan=True)
    assert int(torch.isfinite(dense).sum()) > 500
    monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", "-3")
    with pytest.raises(ValueError, match="RT_TPU_LIGHT_CULL_MIN"):
        tshading.mixture_pdf(*args)


def test_no_native_bvh_matches_jax_numpy(monkeypatch):
    """With RT_TPU_NO_NATIVE the port builds its BVH with the JAX package's
    numpy SAH build: permutation, boxes, leaf ranges and links bit-equal to
    jbvh._build_py + _flatten_py; without it, the native builder."""
    rng = np.random.default_rng(9)
    p, u, v = random_triangles(rng, 900)
    lo = np.minimum(np.minimum(p, p + u), p + v).astype(np.float32)
    hi = np.maximum(np.maximum(p, p + u), p + v).astype(np.float32)
    monkeypatch.setenv("RT_TPU_NO_NATIVE", "1")
    assert tnative.load() is None
    got = tbvh.build_flat_bvh(lo, hi)
    perm, nodes = jbvh._build_py(lo, hi, jbvh.LEAF_SIZE)
    want = jbvh._flatten_py(nodes)
    assert np.array_equal(got.perm, perm.astype(np.int32))
    for g, w in zip((got.lo, got.hi, got.first, got.count, got.hit_link,
                     got.miss_link), want):
        assert np.array_equal(g, w)
    monkeypatch.delenv("RT_TPU_NO_NATIVE")
    assert tnative.load() is not None
    native = tbvh.build_flat_bvh(lo, hi)
    assert native.num_nodes == got.num_nodes


def _png(rng, width, height, ctype, nch):
    """PNG bytes of random filtered rows: every filter type 0-4 in turn."""
    stride = width * nch
    raw = rng.integers(0, 256, (height, 1 + stride), dtype=np.uint8)
    raw[:, 0] = np.arange(height) % 5

    def chunk(tag, payload):
        import struct

        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    import struct

    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,nch", [(2, 3), (6, 4), (0, 1)])
def test_no_native_png_matches_jax_numpy(monkeypatch, ctype, nch):
    """With RT_TPU_NO_NATIVE a PNG of every filter type decodes through the
    numpy unfilter, bit-equal to the JAX package's _unfilter_py and to the
    native decode."""
    data = _png(np.random.default_rng(ctype), 23, 11, ctype, nch)
    native = tpng.decode(data)
    monkeypatch.setenv("RT_TPU_NO_NATIVE", "1")
    got = tpng.decode(data)
    stride = 23 * nch
    raw = np.frombuffer(zlib.decompress(data[8 + 25 + 8:-12]), np.uint8)
    want = jpng._unfilter_py(raw.reshape(11, 1 + stride), 11, stride, nch)
    assert np.array_equal(got.reshape(11, stride), want)
    assert np.array_equal(got, native)
    assert np.array_equal(
        tpng._unfilter_py(raw.reshape(11, 1 + stride), 11, stride, nch),
        want)
