"""The columnar shade stage and trace of the PyTorch port against the JAX
package, on the CPU: utils/vec3c.py, ops/shading_cols.py,
prng.uniforms_cols, texture.sample_env_cols and the columnar compacted
trace (the compacted loop in its column layout, integrator.COLUMNS,
RT_TPU_COLS=1).

Tolerances. Each shading_cols function is held against the JAX package's
columnar function and against the port's row form at the tolerances of
tests/test_shading_cols.py (3e-6 relative and absolute; the VNDF sample 5e-4,
whose frame amplifies reduction-order ulps on near-degenerate half-vectors;
the VNDF pdf, light and mixture pdfs 2e-5; the BRDF 1e-5): the two packages
and the two forms differ only in the order of three-term reductions. The
draws (uniforms_cols) are bit-equal. The columnar trace is held against the
JAX package's columnar trace with equal live-lane counts, ray counts and
overflow 0, and radiance within the glossy-scene gate of
tests/test_torch_render.py; against the port's row form the same gate
holds, and most values are bit-equal."""

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
from raytracer_odin_tpu.ops import integrator as jinteg
from raytracer_odin_tpu.ops import shading_cols as jcols
from raytracer_odin_tpu.ops import texture as jtexture
from raytracer_odin_tpu.ops.integrator import TraceOptions as JTraceOptions
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu.utils import prng as jprng
from raytracer_odin_tpu.utils import vec3c as jv3c
from raytracer_odin_tpu_torch.ops import integrator as tinteg
from raytracer_odin_tpu_torch.ops import shading as tshading
from raytracer_odin_tpu_torch.ops import shading_cols as tcols
from raytracer_odin_tpu_torch.ops import texture as ttexture
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.render import runtime as truntime
from raytracer_odin_tpu_torch.utils import math3d, prng
from raytracer_odin_tpu_torch.utils import vec3c as tv3c
from tests.test_torch_render import _near
from tests.torch_parity import torch_scene

N = 257  # not a lane multiple, as tests/test_shading_cols.py


def _t(a):
    return torch.from_numpy(np.array(a))


def _c(a):
    """[N, 3] numpy -> the port's [3, N] column triple."""
    return tv3c.splat(_t(a))


def _jc(a):
    """[N, 3] numpy -> the JAX package's column tuple."""
    return tuple(jnp.asarray(a[:, i]) for i in range(a.shape[1]))


def _close(got, want, tol):
    """got: the port's column triple [3, N] or [N] column; want: the JAX
    package's column tuple, a [N, 3] array or an [N] column."""
    got = got.numpy()
    if isinstance(want, tuple):
        want = np.stack([np.asarray(c) for c in want])
    else:
        want = np.asarray(want)
        if want.ndim == 2 and got.ndim == 2:
            want = want.T
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(7)

    def unit():
        v = rng.normal(size=(N, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    return {"n": unit(), "d": unit(), "out": unit(),
            "pos": rng.normal(size=(N, 3)).astype(np.float32),
            "u": rng.random((N, 6), np.float32),
            "rough": rng.uniform(0.03, 1.0, N).astype(np.float32),
            "metal": rng.random(N, np.float32),
            "color": rng.random((N, 3), np.float32)}


@pytest.fixture(scope="module")
def cornell_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("cornell_cols")
    host = jgltf.read_gltf(jassets.generate("cornell", d)["gltf"])
    js = jbuild.finish_scene(host)
    return host, js, torch_scene(js)


@pytest.fixture(scope="module")
def envmap_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("envmap_cols")
    info = jassets.generate("envmap", d)
    host = jgltf.read_gltf(info["gltf"])
    li = jimages.load_image(info["env"])
    js = jbuild.finish_scene(host, env_map=JHostTexture(li.data, li.is_hdr))
    return host, js, torch_scene(js)


def test_vec3c_round_trip_and_ops(arrays):
    """splat/stack round trip, and each helper against the JAX module's
    columns and the port's row forms of math3d: bit-equal where an
    operation has one rounding (add, sub, neg, scale, mul, where), else
    within 3e-6 (XLA's CPU backend fuses multiply-adds)."""
    a = np.arange(12, dtype=np.float32).reshape(4, 3)
    assert np.array_equal(tv3c.stack(tv3c.splat(_t(a))).numpy(), a)
    assert tv3c.splat(_t(a)).is_contiguous()
    x, y = arrays["n"], arrays["pos"]
    s = arrays["rough"]
    jx, jy = _jc(x), _jc(y)
    pairs = [
        (tv3c.add(_c(x), _c(y)), jv3c.add(jx, jy)),
        (tv3c.sub(_c(x), _c(y)), jv3c.sub(jx, jy)),
        (tv3c.neg(_c(x)), jv3c.neg(jx)),
        (tv3c.scale(_c(x), _t(s)), jv3c.scale(jx, jnp.asarray(s))),
        (tv3c.mul(_c(x), _c(y)), jv3c.mul(jx, jy)),
        (tv3c.where(_t(s > 0.5), _c(x), _c(y)),
         jv3c.where(jnp.asarray(s > 0.5), jx, jy)),
    ]
    for got, want in pairs:
        _close(got, want, 0)
    for got, want in ((tv3c.cross(_c(x), _c(y)), jv3c.cross(jx, jy)),
                      (tv3c.normalize(_c(y), eps=1e-20),
                       jv3c.normalize(jy, eps=1e-20)),
                      (tv3c.dot(_c(x), _c(y)), jv3c.dot(jx, jy)),
                      (tv3c.norm_l1(_c(y)), jv3c.norm_l1(jy)),
                      (tv3c.length(_c(y)), jv3c.length(jy))):
        _close(got, want, 3e-6)
    _close(tv3c.dot(_c(x), _c(y)), math3d.dot(_t(x), _t(y)), 3e-6)
    _close(tv3c.cross(_c(x), _c(y)), math3d.cross(_t(x), _t(y)), 0)
    q = tv3c.quat_from_z_to(_c(x))
    jq = jv3c.quat_from_z_to(jx)
    _close(q, jq, 3e-6)
    _close(tv3c.quat_conj(q), jv3c.quat_conj(jq), 3e-6)
    _close(tv3c.quat_rotate(q, _c(y)), jv3c.quat_rotate(jq, jy), 3e-6)
    _close(tv3c.quat_rotate(q, _c(y)),
           math3d.quat_rotate(math3d.quat_from_z_to(_t(x)), _t(y)), 3e-6)
    # n.z == -1 takes the 180-degree turn about x
    flip = tv3c.quat_from_z_to(_t([[0.0], [0.0], [-1.0]]))
    assert flip[:, 0].tolist() == [1.0, 0.0, 0.0, 0.0]


def test_uniforms_cols_bitwise():
    """prng.uniforms_cols: the JAX package's columns and the port's
    uniforms, bit for bit."""
    sids = np.arange(100, dtype=np.int32)
    key = prng.key_from_seed(3)
    got = prng.uniforms_cols(key, 5, 2, _t(sids), 6)
    want = jprng.uniforms_cols(jax.random.PRNGKey(3), 5, 2,
                               jnp.asarray(sids), 6)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    rows = prng.uniforms(key, 5, 2, _t(sids), 6)
    assert torch.equal(torch.stack(got, dim=-1), rows)


def test_sphere_cosine(arrays):
    u1, u2 = arrays["u"][:, 0], arrays["u"][:, 1]
    n = arrays["n"]
    _close(tcols.sphere_uniform(_t(u1), _t(u2)),
           jcols.sphere_uniform(jnp.asarray(u1), jnp.asarray(u2)), 3e-6)
    _close(tcols.sphere_uniform(_t(u1), _t(u2)),
           tshading.sphere_uniform(_t(u1), _t(u2)), 3e-6)
    got = tcols.cosine_weighted(_c(n), _t(u1), _t(u2))
    _close(got, jcols.cosine_weighted(_jc(n), jnp.asarray(u1),
                                      jnp.asarray(u2)), 3e-6)
    _close(got, tshading.cosine_weighted(_t(n), _t(u1), _t(u2)), 3e-6)
    pdf = tcols.cosine_weighted_pdf(_c(n), _c(arrays["out"]))
    _close(pdf, jcols.cosine_weighted_pdf(_jc(n), _jc(arrays["out"])), 3e-6)
    _close(pdf, tshading.cosine_weighted_pdf(_t(n), _t(arrays["out"])),
           3e-6)


def test_vndf(arrays):
    n, d, out = arrays["n"], arrays["d"], arrays["out"]
    alpha = arrays["rough"] ** 2
    u4, u5 = arrays["u"][:, 4], arrays["u"][:, 5]
    got = tcols.vndf_sample(_c(n), _c(-d), _t(alpha), _t(u4), _t(u5))
    _close(got, jcols.vndf_sample(_jc(n), _jc(-d), jnp.asarray(alpha),
                                  jnp.asarray(u4), jnp.asarray(u5)), 5e-4)
    _close(got, tshading.vndf_sample(_t(n), _t(-d), _t(alpha), _t(u4),
                                     _t(u5)), 5e-4)
    pdf = tcols.vndf_pdf(_c(n), _c(-d), _t(alpha), _c(out))
    _close(pdf, jcols.vndf_pdf(_jc(n), _jc(-d), jnp.asarray(alpha),
                               _jc(out)), 2e-5)
    _close(pdf, tshading.vndf_pdf(_t(n), _t(-d), _t(alpha), _t(out)), 2e-5)


def test_shade(arrays):
    r = arrays
    got = tcols.shade(_c(r["color"]), _c(r["n"]), _t(r["metal"]),
                      _t(r["rough"]), _c(r["d"]), _c(r["out"]))
    _close(got, jcols.shade(_jc(r["color"]), _jc(r["n"]),
                            jnp.asarray(r["metal"]), jnp.asarray(r["rough"]),
                            _jc(r["d"]), _jc(r["out"])), 1e-5)
    _close(got, tshading.shade(_t(r["color"]), _t(r["n"]), _t(r["metal"]),
                               _t(r["rough"]), _t(r["d"]), _t(r["out"])),
           1e-5)


def test_lights_and_mixture(arrays, cornell_pair, monkeypatch):
    """surface_sample, light_pdf_sum, sample_direction and mixture_pdf on
    cornell's emitters against the JAX package's columns and the port's
    row forms; with RT_TPU_LIGHT_CULL_MIN lowered to 1, mixture_pdf takes
    the culled sum (plain K5 on the CPU) behind its stack boundary, held
    against the row form's culled sum (the same function on the same rows:
    bit-equal) and the JAX package's dense sum (2e-5)."""
    _, js, ts = cornell_pair
    r = arrays
    pos, n, d, u = r["pos"], r["n"], r["d"], r["u"]
    ucols = tuple(_t(u[:, i]) for i in range(6))
    jucols = tuple(jnp.asarray(u[:, i]) for i in range(6))
    got = tcols.surface_sample(ts, _c(pos), *ucols[3:6])
    _close(got, jcols.surface_sample(js, _jc(pos), *jucols[3:6]), 3e-6)
    _close(got, tshading.surface_sample(ts, _t(pos), *ucols[3:6]), 3e-6)
    lp = tcols.light_pdf_sum(ts, _c(pos), _c(r["out"]))
    _close(lp, jcols.light_pdf_sum(js, _jc(pos), _jc(r["out"])), 2e-5)
    _close(lp, tshading.light_pdf_sum(ts, _t(pos), _t(r["out"])), 2e-5)
    got_d = tcols.sample_direction(ts, _c(pos), _c(n), _t(r["rough"]),
                                   _c(d), ucols, True)
    want_d = jcols.sample_direction(js, _jc(pos), _jc(n),
                                    jnp.asarray(r["rough"]), _jc(d), jucols,
                                    True)
    _close(got_d, want_d, 3e-6)
    _close(got_d, tshading.sample_direction(ts, _t(pos), _t(n),
                                            _t(r["rough"]), _t(d), _t(u),
                                            True), 3e-6)
    # the mixture pdf at the JAX package's direction (a direction that
    # differs in the last ulp may cross a light's edge)
    wd = tv3c.splat(_t(np.stack([np.asarray(c) for c in want_d], -1)))
    mix = tcols.mixture_pdf(ts, _c(pos), _c(n), _t(r["rough"]), _c(d), wd,
                            True)
    jmix = jcols.mixture_pdf(js, _jc(pos), _jc(n), jnp.asarray(r["rough"]),
                             _jc(d), want_d, True)
    _close(mix, jmix, 2e-5)
    row = tshading.mixture_pdf(ts, _t(pos), _t(n), _t(r["rough"]), _t(d),
                               tv3c.stack(wd), True)
    _close(mix, row, 2e-5)
    monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", "1")
    culled = tcols.mixture_pdf(ts, _c(pos), _c(n), _t(r["rough"]), _c(d),
                               wd, True)
    assert torch.equal(culled, tshading.mixture_pdf(
        ts, _t(pos), _t(n), _t(r["rough"]), _t(d), tv3c.stack(wd), True))
    _close(culled, jmix, 2e-5)
    # no lights: VNDF takes the light branch's mass
    _close(tcols.mixture_pdf(ts, _c(pos), _c(n), _t(r["rough"]), _c(d), wd,
                             False),
           jcols.mixture_pdf(js, _jc(pos), _jc(n), jnp.asarray(r["rough"]),
                             _jc(d), want_d, False), 2e-5)


def test_sample_env_cols(arrays, envmap_pair):
    """texture.sample_env_cols against the JAX package's and the port's
    row form, bit-equal to the row form (the same operations), 3e-6 to the
    JAX package (atan2/asin round differently in XLA)."""
    _, js, ts = envmap_pair
    d = arrays["d"]
    got = ttexture.sample_env_cols(ts, _c(d), ts.env_tex)
    assert got.shape == (3, N)
    assert torch.equal(got, tv3c.splat(ttexture.sample_env(ts, _t(d),
                                                          ts.env_tex)))
    want = jtexture.sample_env_cols(js, _jc(d), js.env_tex)
    _close(got, want, 3e-6)


def _sample(ts, js, host, w, h, depth, schedule, **jax_kw):
    fov = host.cam.fov_x * w / h
    jr, ja = jax.jit(lambda k: jruntime.sample_pass(
        js, k, jnp.int32(0), fov, w, h,
        JTraceOptions(depth=depth, intersector="pallas",
                      lane_schedule=schedule)))(jax.random.PRNGKey(0))
    opts = TraceOptions(depth=depth, intersector="pallas",
                        lane_schedule=schedule)
    tr, ta = truntime.sample_pass(ts, prng.key_from_seed(0), 0, fov, w, h,
                                  opts)
    return (jr, ja), (tr, ta)


def _same_counts(ja, ta):
    assert ta["alive_counts"].tolist() == np.asarray(
        ja["alive_counts"]).tolist()
    assert int(ta["rays_cast"]) == int(ja["rays_cast"])
    assert int(ta["overflow"]) == int(ja["overflow"]) == 0


@pytest.fixture(scope="module")
def demo_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo_cols")
    host = jgltf.read_gltf(jassets.generate("demo", d)["gltf"])
    js = jbuild.finish_scene(host)
    return host, js, torch_scene(js)


def test_columnar_demo_sample_matches_jax(monkeypatch, demo_pair):
    """One compacted demo sample (32x18, depth 8, schedule (512,) * 7)
    through both packages' columnar traces: equal live-lane counts and ray
    counts, overflow 0, radiance within the glossy-scene gate; against the
    port's row form the same counts and gate, the draws being the same."""
    host, js, ts = demo_pair
    w, h, depth = 32, 18, 8
    row = truntime.sample_pass(
        ts, prng.key_from_seed(0), 0, host.cam.fov_x * w / h, w, h,
        TraceOptions(depth=depth, intersector="pallas",
                     lane_schedule=(512,) * 7))
    monkeypatch.setattr(jinteg, "COLS", 1)
    monkeypatch.setattr(tinteg, "COLS", 1)
    (jr, ja), (tr, ta) = _sample(ts, js, host, w, h, depth, (512,) * 7)
    _same_counts(ja, ta)
    _near(tr.numpy(), jr)
    assert ta["alive_counts"].tolist() == row[1]["alive_counts"].tolist()
    _near(tr.numpy(), row[0].numpy())
    assert (tr == row[0]).float().mean() > 0.5


@pytest.mark.parametrize("case", ["envmap", "culled_lights"])
def test_columnar_sample_cases(monkeypatch, case, envmap_pair,
                               cornell_pair):
    """The columnar trace on an env-lit scene (misses read the env map
    through sample_env_cols) and on cornell with RT_TPU_LIGHT_CULL_MIN
    lowered to 1 (the port's mixture pdf takes the culled sum, plain K5;
    the JAX package takes the dense sum on the CPU whatever the count):
    against the JAX package's columnar trace, 16x16, depth 4."""
    host, js, ts = envmap_pair if case == "envmap" else cornell_pair
    if case == "culled_lights":
        monkeypatch.setenv("RT_TPU_LIGHT_CULL_MIN", "1")
    monkeypatch.setattr(jinteg, "COLS", 1)
    monkeypatch.setattr(tinteg, "COLS", 1)
    (jr, ja), (tr, ta) = _sample(ts, js, host, 16, 16, 4, (512,) * 3)
    _same_counts(ja, ta)
    _near(tr.numpy(), jr)
    if case == "envmap":
        assert ts.env_tex >= 0 and float(tr.mean()) > 0
