"""PyTorch port vs JAX package: shading, textures, material evaluation and
camera rays on random inputs made with numpy from a seed.

Tolerance: rtol=RTOL, atol=ATOL. Both sides evaluate the same f32
formulas, but XLA's CPU backend fuses multiply-adds and its sin/cos/atan2
/asin/pow round differently from PyTorch's by an ulp or two; the GGX and
VNDF terms divide by small cosines and amplify that to ~1e-5 relative.
Boolean and integer outputs (the continuation rule, strategy choice) are
compared exactly on lanes away from their thresholds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.ops import integrator as jinteg
from raytracer_odin_tpu.ops import shading as jsh
from raytracer_odin_tpu.ops import texture as jtex
from raytracer_odin_tpu.render import runtime as jrt
from raytracer_odin_tpu_torch.ops import integrator as tinteg
from raytracer_odin_tpu_torch.ops import shading as tsh
from raytracer_odin_tpu_torch.ops import texture as ttex
from raytracer_odin_tpu_torch.render import runtime as trt
from tests.torch_parity import torch_scene

RTOL, ATOL = 1e-4, 1e-5
BOUNCE_RTOL = 2e-3
N = 4000


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(want, got, rtol=RTOL, atol=ATOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.shape == got.shape, (want.shape, got.shape)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.allclose(want[fin], got[fin], rtol=rtol, atol=atol), (
        np.abs(want[fin] - got[fin]).max())


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    n = _unit(rng, N)
    in_d = _unit(rng, N)
    # keep the incoming direction in the normal's lower hemisphere
    flip = (in_d * n).sum(-1) > 0
    in_d[flip] = -in_d[flip]
    return {
        "n": n, "in_d": in_d, "out_d": _unit(rng, N),
        "rough": rng.uniform(0.1, 1.0, N).astype(np.float32),
        "metal": rng.integers(0, 2, N).astype(np.float32),
        "color": rng.uniform(0.05, 0.95, (N, 3)).astype(np.float32),
        "u": rng.random((N, 6), dtype=np.float32),
        "pos": rng.uniform(-4, 4, (N, 3)).astype(np.float32),
    }


def test_samplers_and_pdfs(inputs):
    x = inputs
    u = x["u"]
    _close(jsh.sphere_uniform(u[:, 0], u[:, 1]),
           tsh.sphere_uniform(_t(u[:, 0]), _t(u[:, 1])))
    _close(jsh.cosine_weighted(x["n"], u[:, 0], u[:, 1]),
           tsh.cosine_weighted(_t(x["n"]), _t(u[:, 0]), _t(u[:, 1])))
    _close(jsh.cosine_weighted_pdf(x["n"], x["out_d"]),
           tsh.cosine_weighted_pdf(_t(x["n"]), _t(x["out_d"])))
    alpha = x["rough"] ** 2
    _close(jsh.vndf_sample(x["n"], -x["in_d"], alpha, u[:, 4], u[:, 5]),
           tsh.vndf_sample(_t(x["n"]), _t(-x["in_d"]), _t(alpha),
                           _t(u[:, 4]), _t(u[:, 5])))
    _close(jsh.vndf_pdf(x["n"], -x["in_d"], alpha, x["out_d"]),
           tsh.vndf_pdf(_t(x["n"]), _t(-x["in_d"]), _t(alpha),
                        _t(x["out_d"])))


def test_brdf(inputs):
    x = inputs
    _close(jsh.shade(x["color"], x["n"], x["metal"], x["rough"], x["in_d"],
                     x["out_d"]),
           tsh.shade(_t(x["color"]), _t(x["n"]), _t(x["metal"]),
                     _t(x["rough"]), _t(x["in_d"]), _t(x["out_d"])))


def test_small_table_lookup_is_exact():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(7, 3)).astype(np.float32)
    idx = rng.integers(0, 7, 300).astype(np.int32)
    want = np.asarray(jsh._small_table_lookup(jnp.asarray(table),
                                              jnp.asarray(idx)))
    assert np.array_equal(want, tsh._small_table_lookup(_t(table),
                                                        _t(idx)).numpy())


def test_light_sampling_and_pdf(cornell_scene, inputs):
    """surface_sample, the dense light_pdf_sum, sample_direction and
    mixture_pdf on the cornell scene's two emissive triangles."""
    _host, js = cornell_scene
    ts = torch_scene(js)
    x = inputs
    u = x["u"]
    pos = x["pos"] * 0.2 + np.float32([0.0, 0.5, 0.0])
    _close(jsh.surface_sample(js, pos, u[:, 3], u[:, 4], u[:, 5]),
           tsh.surface_sample(ts, _t(pos), _t(u[:, 3]), _t(u[:, 4]),
                              _t(u[:, 5])))
    # directions that really hit the light: toward sampled light points
    d_light = np.asarray(jsh.surface_sample(js, pos, u[:, 3], u[:, 4],
                                            u[:, 5]))
    want = np.asarray(jsh.light_pdf_sum(js, pos, d_light))
    got = tsh.light_pdf_sum(ts, _t(pos), _t(d_light))
    assert (want > 0).mean() > 0.5
    _close(want, got)
    nd = jsh.sample_direction(js, pos, x["n"], x["rough"], x["in_d"], u,
                              True)
    td = tsh.sample_direction(ts, _t(pos), _t(x["n"]), _t(x["rough"]),
                              _t(x["in_d"]), _t(u), True)
    _close(nd, td)
    _close(jsh.mixture_pdf(js, pos, x["n"], x["rough"], x["in_d"], nd, True),
           tsh.mixture_pdf(ts, _t(pos), _t(x["n"]), _t(x["rough"]),
                           _t(x["in_d"]), _t(np.asarray(nd)), True))
    _close(jsh.mixture_pdf(js, pos, x["n"], x["rough"], x["in_d"], nd, False),
           tsh.mixture_pdf(ts, _t(pos), _t(x["n"]), _t(x["rough"]),
                           _t(x["in_d"]), _t(np.asarray(nd)), False))


def test_texture_sampling(textured_scene):
    """Bilinear atlas taps (linear and sRGB pools, wrap, tex id -1 default)
    and the equirect env lookup."""
    _host, js = textured_scene
    ts = torch_scene(js)
    rng = np.random.default_rng(4)
    n_tex = int(js.tex_width.shape[0])
    tid = rng.integers(-1, n_tex, N).astype(np.int32)
    uv = rng.uniform(-2.0, 3.0, (N, 2)).astype(np.float32)
    for srgb in (False, True):
        _close(jtex.sample(js, jnp.asarray(tid), jnp.asarray(uv), srgb=srgb,
                           default=(0.5, 1.0, 0.5, 0.0)),
               ttex.sample(ts, _t(tid), _t(uv), srgb=srgb,
                           default=(0.5, 1.0, 0.5, 0.0)))
    d = _unit(rng, N)
    _close(jtex.sample_env(js, jnp.asarray(d), 0),
           ttex.sample_env(ts, _t(d), 0))


def _hits(js, rng, n):
    """Rays aimed at random triangles' interiors from either side, at least
    ~30 degrees off the triangle plane (grazing rays make the recomputed
    barycentrics ill-conditioned on both sides alike)."""
    area2 = np.linalg.norm(np.cross(np.asarray(js.tri_u),
                                    np.asarray(js.tri_v)), axis=-1)
    # degenerate triangles (sphere poles) are never hit by the sweep
    tri = rng.choice(np.nonzero(area2 > 1e-6)[0], n)
    p = np.asarray(js.tri_p)[tri]
    u = np.asarray(js.tri_u)[tri]
    v = np.asarray(js.tri_v)[tri]
    ng = np.asarray(js.tri_ng)[tri]
    a, b = rng.uniform(0.05, 0.45, (2, n, 1)).astype(np.float32)
    target = p + a * u + b * v
    side = np.where(rng.random((n, 1)) < 0.5, -1.0, 1.0).astype(np.float32)
    off = side * ng + 0.5 * _unit(rng, n)
    o = target + 2.0 * off / np.linalg.norm(off, axis=-1, keepdims=True)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linalg.norm(target - o, axis=-1).astype(np.float32)
    idx = tri.astype(np.int32)
    idx[: n // 10] = -1  # some misses
    return o.astype(np.float32), d.astype(np.float32), t, idx


@pytest.mark.parametrize("fixture", ["textured_scene", "cornell_scene"])
def test_point_material_and_bounce(fixture, request):
    """_point_material (normal map, textures, sRGB color) and eval_bounce:
    material fields, sampled direction, pdf, BRDF value and the
    continuation rule on the same hit set."""
    _host, js = request.getfixturevalue(fixture)
    ts = torch_scene(js)
    rng = np.random.default_rng(5)
    o, d, t, idx = _hits(js, rng, N)
    uni = rng.random((N, 6), dtype=np.float32)
    hit = idx >= 0  # fields on miss lanes are garbage the caller masks
    jm = jinteg._point_material(js, o, d, t, jnp.asarray(idx))
    tm = tinteg._point_material(ts, _t(o), _t(d), _t(t), _t(idx))
    for k in ("pos", "normal", "ng", "texcoords", "color", "emission",
              "roughness", "metallic"):
        _close(np.asarray(jm[k])[hit], tm[k][hit])
    assert np.array_equal(np.asarray(jm["inside"]), tm["inside"].numpy())
    has_lights = js.light_p.shape[0] > 0
    jopts = jinteg.TraceOptions(intersector="pallas")
    jev = jinteg.eval_bounce(js, o, d, t, jnp.asarray(idx), uni, jopts,
                             has_lights)
    tev = tinteg.eval_bounce(ts, _t(o), _t(d), _t(t), _t(idx), _t(uni),
                             has_lights)
    for k in ("normal", "new_d"):
        _close(np.asarray(jev[k])[hit], tev[k][hit])
    # The sampled directions already differ by ~3e-5 (sin/cos rounding in
    # the VNDF sampler); the GGX lobe at roughness ~0.17 turns that into
    # ~3e-4 relative in the BRDF value and pdf (ROADMAP hazard 3), so this
    # chained comparison allows BOUNCE_RTOL.
    for k in ("pdf", "value"):
        _close(np.asarray(jev[k])[hit], tev[k][hit], rtol=BOUNCE_RTOL,
               atol=1e-4)
    ratio = np.asarray(jnp.sum(jnp.abs(jev["value"]), -1) / jev["pdf"])
    away = hit & (np.abs(ratio - 1e-5) > 1e-7)
    assert np.array_equal(np.asarray(jev["cont"])[away],
                          tev["cont"].numpy()[away])


def test_generate_rays():
    rng = np.random.default_rng(6)
    w, h = 37, 23
    jitter = rng.random((h, w, 2), dtype=np.float32)
    pos = np.float32([0.3, 1.2, 4.0])
    basis = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
    jo, jd = jrt.generate_rays(jnp.asarray(pos), jnp.asarray(basis), 0.9, w, h,
                               jnp.asarray(jitter))
    to, td = trt.generate_rays(_t(pos), _t(basis), 0.9, w, h, _t(jitter))
    assert np.array_equal(np.asarray(jo), to.numpy())
    # XLA's f32 matmul fuses the basis rotation's multiply-adds: 1-2 ulp
    _close(jd, td, rtol=1e-6, atol=1e-7)
