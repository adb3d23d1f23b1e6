"""The port's debug AOVs against the JAX package's, on the CPU: the probe
registry and its layer indices, every builtin AOV of one sample, a
user-registered probe, a debug render through render_scene, beauty with
AOVs against beauty without, and --debug-nans (mirrors
tests/test_integrator.py:145-187 and tests/test_runtime.py:117).

Both packages trace the same scenes with the same seed through "pallas"
(the JAX package's kernels in interpret mode, the port's plain versions).
Tolerances: the integer-valued layers (miss, bounces, anomaly) and the
alive counts are equal; depth within 16 ulp (XLA's CPU backend fuses
multiply-adds, tests/test_torch_intersectors.py); normal, albedo,
emission and uv at rtol 1e-5, atol 1e-6, but for albedo on a lane whose
uv differs (by an ulp, within its tolerance): a texture's slope turns
that into up to 2.7e-5 relative (measured on the CPU: textured, 5 lanes
of 256), held at the golden test's rtol 1e-4, atol 1e-5; pdf at rtol 2e-4 (the light and
VNDF pdfs' transcendentals round differently), but for a lane whose
sampled direction grazes a light's plane (|ng.d| < GRAZE in both
packages): there the light pdf's t^2/|ng.d| is singular and the
direction's last bits (XLA's fused multiply-adds) decide between a few
tenths and ~1e6 (measured on the CPU: cornell, one lane of 256, a point on
the ceiling light sampling the light, its direction's y 0 in the port and
2.7e-7 in the JAX package); render_scene's layers at
the glossy-scene gate of tests/test_torch_render.py. Beauty with AOVs is
bit-equal to beauty without them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_odin_tpu import config as jconfig
from raytracer_odin_tpu.config import RenderConfig as JRenderConfig
from raytracer_odin_tpu.io import gltf as jgltf
from raytracer_odin_tpu.models import assets as jassets
from raytracer_odin_tpu.models import build as jbuild
from raytracer_odin_tpu.ops import probes as jprobes
from raytracer_odin_tpu.ops.integrator import TraceOptions as JTraceOptions
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch import config
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.ops import integrator, probes
from raytracer_odin_tpu_torch.ops.integrator import TraceOptions
from raytracer_odin_tpu_torch.render import runtime
from raytracer_odin_tpu_torch.utils import prng
from tests.test_torch_render import GOLDEN, _load, _near
from tests.torch_parity import torch_scene, within_16_ulp

W = H = 16
DEPTH = 3
BUILTIN = ["normal", "depth", "albedo", "emission", "uv", "bounces",
           "anomaly", "pdf", "miss"]
EXACT = ("miss", "bounces", "anomaly")
GRAZE = 1e-5
CLOSE = ("normal", "albedo", "emission", "uv")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (fov, JAX scene, the port's scene holding its arrays)."""
    d = tmp_path_factory.mktemp("probe_scenes")
    out = {}
    for name in ("cube", "cornell", "textured"):
        host = jgltf.read_gltf(jassets.generate(name, d)["gltf"])
        js = jbuild.finish_scene(host)
        out[name] = (host.cam.fov_x, js, torch_scene(js))
    return out


def _jax_pass(js, fov, opts, sample=0):
    return jax.jit(lambda k: jruntime.sample_pass(
        js, k, jnp.int32(sample), fov, W, H, opts))(jax.random.PRNGKey(0))


def _port_pass(ts, fov, opts, sample=0):
    return runtime.sample_pass(ts, prng.key_from_seed(0), sample, fov, W, H,
                               opts)


def _grazing(ts, d):
    """[...] bool: direction d [..., 3] lies within GRAZE of a light's
    plane (|ng.d| < GRAZE for some light)."""
    ng = ts.light_ng
    return (torch.abs(torch.from_numpy(np.array(d)) @ ng.T)
            < GRAZE).any(dim=-1)


def _check_pdf(got, want, graze):
    """The pdf layer's gate: rtol 2e-4 on every lane but those whose
    direction sampled at the first vertex grazes a light's plane in both
    packages (`graze`), of which at most one may differ."""
    off = ~np.isclose(got, want, rtol=2e-4)
    assert not (off & ~graze).any() and off.sum() <= 1


def _first_graze(js, ts, fov, sample, depth=DEPTH):
    """The lanes of `sample` whose direction sampled at the first vertex
    grazes a light's plane in both packages (a primary miss samples none,
    and its pdf layer stays 0)."""
    opts = dict(depth=depth, intersector="pallas", log_paths=True)
    _, ja = _jax_pass(js, fov, JTraceOptions(**opts), sample)
    _, ta = _port_pass(ts, fov, TraceOptions(**opts), sample)
    return (_grazing(ts, ta["ray_log"]["d"][1])
            & _grazing(ts, ja["ray_log"]["d"][1])).numpy()


def test_layer_names_and_indices():
    """The registry's order is the JAX package's, so every LAYER_* index and
    the layer count agree; the port's default is beauty only."""
    assert probes.layer_names() == jprobes.layer_names()
    assert probes.names() == BUILTIN
    for name in ["beauty"] + BUILTIN:
        const = f"LAYER_{name.upper()}"
        assert getattr(config, const) == getattr(jconfig, const)
        assert probes.layer_names()[getattr(config, const)] == name
    assert (RenderConfig(debug_features=True).num_layers
            == JRenderConfig(debug_features=True).num_layers == 10)
    assert RenderConfig().num_layers == 1
    for p, q in zip(probes.active(), jprobes.active()):
        assert (p.name, p.reduce, p.channels) == (q.name, q.reduce,
                                                  q.channels)


@pytest.mark.parametrize("name", ["cube", "cornell", "textured"])
def test_aux_matches_jax(scenes, name):
    """Every AOV of one sample_pass(want_aux=True) against the JAX one."""
    fov, js, ts = scenes[name]
    jr, ja = _jax_pass(js, fov, JTraceOptions(depth=DEPTH,
                                              intersector="pallas",
                                              want_aux=True))
    tr, ta = _port_pass(ts, fov, TraceOptions(depth=DEPTH,
                                              intersector="pallas",
                                              want_aux=True))
    assert ta["alive_counts"].tolist() == np.asarray(
        ja["alive_counts"]).tolist()
    assert int(ta["rays_cast"]) == int(ja["rays_cast"])
    for p in BUILTIN:
        got, want = ta[p].numpy(), np.asarray(ja[p])
        assert got.shape == want.shape, p
        if p in EXACT:
            assert np.array_equal(got, want), p
        elif p == "depth":
            assert within_16_ulp(got, want), p
        elif p in CLOSE:
            near = np.isclose(got, want, rtol=1e-5, atol=1e-6)
            if p == "albedo":
                uv_off = (ta["uv"].numpy() != np.asarray(ja["uv"])).any(-1)
                near |= uv_off[..., None] & np.isclose(got, want, rtol=1e-4,
                                                       atol=1e-5)
            assert near.all(), p
        else:
            _check_pdf(got, want, _first_graze(js, ts, fov, 0))
    assert set(np.unique(ta["bounces"].numpy())) <= set(range(1, DEPTH + 1))


@pytest.fixture
def first_pos():
    """A user probe registered in both packages, removed afterwards."""
    def fn(c):
        return c.material["pos"]

    probes.register("first_pos", fn, reduce="first_hit")
    jprobes.register("first_pos", fn, reduce="first_hit")
    yield
    probes.unregister("first_pos")
    jprobes.unregister("first_pos")


def test_user_probe_is_layer_ten(scenes, first_pos):
    """One register() call adds a layer: index 10, in the stats, equal to
    the JAX package's (the hit position o + d*t: t within 16 ulp)."""
    assert probes.layer_names().index("first_pos") == 10
    assert RenderConfig(debug_features=True).num_layers == 11
    fov, js, ts = scenes["cornell"]
    _, ja = _jax_pass(js, fov, JTraceOptions(depth=2, intersector="pallas",
                                             want_aux=True))
    tr, ta = _port_pass(ts, fov, TraceOptions(depth=2, intersector="pallas",
                                              want_aux=True))
    assert np.allclose(ta["first_pos"].numpy(), np.asarray(ja["first_pos"]),
                       rtol=1e-5, atol=1e-5)
    vals = runtime.sample_layer_values(tr, ta, True)
    assert vals.shape == (11, H, W, 3)
    assert torch.equal(vals[10], ta["first_pos"])


@pytest.mark.parametrize("name", ["cube", "cornell"])
def test_render_scene_debug_layers(scenes, name):
    """render_scene(debug_features=True, compact="auto") runs uncompacted
    without calibration, and its ten layers match the JAX package's
    stats."""
    fov, js, ts = scenes[name]
    kw = dict(width=W, height=H, ray_depth=DEPTH, samples=2,
              samples_per_step=1, seed=0, intersector="pallas",
              compact="auto", debug_features=True)
    before = integrator.pi.cluster_masks_rows.launches
    res = runtime.render_scene(ts, RenderConfig(**kw), fov, device="cpu")
    # plain K1 (the "launches" count its kernel only)
    assert integrator.pi.cluster_masks_rows.launches == before
    assert res.lane_schedule is None and res.overflow == 0
    want = jruntime.render_scene(js, JRenderConfig(**kw), fov).stats
    assert res.stats.count.shape == (10, H, W)
    for layer in range(10):
        if layer == config.LAYER_PDF:
            # sample 0 is `first`, sample 1 `last`
            for f, s in (("first", 0), ("last", 1)):
                _check_pdf(getattr(res.stats, f)[layer, ..., 0].numpy(),
                           np.asarray(getattr(want, f)[layer, ..., 0]),
                           _first_graze(js, ts, fov, s))
            continue
        _near(res.stats.total[layer].numpy(), np.asarray(want.total[layer]))
    assert np.array_equal(res.stats.count.numpy(), np.asarray(want.count))


@pytest.mark.parametrize("name", ["cornell", "textured"])
def test_beauty_bit_equal_with_aux(scenes, name):
    """The probes read the trace and write nothing back: radiance with
    want_aux is bit-equal to radiance without, and a debug render's beauty
    layer to a beauty-only render."""
    fov, _, ts = scenes[name]
    opts = TraceOptions(depth=DEPTH, intersector="pallas")
    r0, a0 = _port_pass(ts, fov, opts)
    r1, a1 = _port_pass(ts, fov, opts._replace(want_aux=True))
    assert torch.equal(r0, r1)
    assert torch.equal(a0["alive_counts"], a1["alive_counts"])
    cfg = RenderConfig(width=W, height=H, ray_depth=DEPTH, samples=2,
                       samples_per_step=2, intersector="pallas",
                       compact="off")
    plain = runtime.render_scene(ts, cfg, fov, device="cpu").stats
    debug = runtime.render_scene(ts, cfg.replace(debug_features=True), fov,
                                 device="cpu").stats
    for f in ("first", "last", "total", "total_sq", "count"):
        assert torch.equal(getattr(debug, f)[0], getattr(plain, f)[0]), f


def test_ray_log_and_depth_zero(scenes):
    """log_paths records [depth, lanes] per bounce, its t equal to the cast
    (the depth AOV where the first vertex hits); depth 0 returns zero
    radiance, empty counts and the probes' initial values."""
    fov, _, ts = scenes["cube"]
    opts = TraceOptions(depth=DEPTH, intersector="pallas", want_aux=True,
                        log_paths=True)
    _, aux = _port_pass(ts, fov, opts)
    log = aux["ray_log"]
    assert set(log) == {"o", "d", "t", "alive", "hit", "value_over_pdf",
                        "throughput_l1"}
    assert log["t"].shape == (DEPTH, H, W)
    hit0 = log["hit"][0]
    assert torch.equal(log["t"][0][hit0], aux["depth"][hit0])
    assert torch.equal(log["alive"].sum(0).float(), aux["bounces"])
    r, aux0 = _port_pass(ts, fov, opts._replace(depth=0))
    assert not r.any() and aux0["alive_counts"].numel() == 0
    assert "ray_log" not in aux0 and not aux0["depth"].any()


def _poison_emission(monkeypatch, bounce, depth):
    """Make the emission of every hit NaN at `bounce` of each trace."""
    real = integrator._point_material
    calls = [0]

    def poisoned(scene, o, d, t, tri_idx):
        m = real(scene, o, d, t, tri_idx)
        if calls[0] % depth == bounce:
            m = dict(m, emission=torch.where(
                (tri_idx >= 0)[..., None], torch.nan, m["emission"]))
        calls[0] += 1
        return m

    monkeypatch.setattr(integrator, "_point_material", poisoned)


@pytest.mark.parametrize("compact", ["off", "auto"])
def test_debug_nans_names_bounce(scenes, monkeypatch, compact):
    """A NaN injected into live lanes' emission at bounce 1 reaches the
    beauty; --debug-nans re-traces the sample and names sample, bounce,
    stage and pixels."""
    fov, _, ts = scenes["cornell"]
    _poison_emission(monkeypatch, 1, DEPTH)
    cfg = RenderConfig(width=W, height=H, ray_depth=DEPTH, samples=2,
                       samples_per_step=1, intersector="pallas",
                       compact=compact)
    with pytest.raises(FloatingPointError,
                       match=r"radiance .* at sample 0, bounce 1, after the "
                             r"shade; first pixel ids \[\d+"):
        runtime.render_scene(ts, cfg, fov, device="cpu", debug_nans=True)
    # without the check the render folds the NaN in
    res = runtime.render_scene(ts, cfg, fov, device="cpu")
    assert torch.isnan(res.stats.total[0]).any()


def test_debug_nans_output_only(scenes, monkeypatch):
    """A NaN that no live lane holds after a cast or shade (here written
    into the folded values) is still reported, by layer and pixel."""
    fov, _, ts = scenes["cube"]
    real = runtime.sample_layer_values

    def poisoned(radiance, aux, debug):
        vals = real(radiance, aux, debug).clone()
        vals[0, 3, 5, 1] = torch.nan
        return vals

    monkeypatch.setattr(runtime, "sample_layer_values", poisoned)
    cfg = RenderConfig(width=W, height=H, ray_depth=DEPTH, samples=1,
                       samples_per_step=1, intersector="pallas")
    with pytest.raises(FloatingPointError,
                       match=r"sample 0 folds in \(layers \['beauty'\]; "
                             r"first pixel ids \[53\]\)"):
        runtime.render_scene(ts, cfg, fov, device="cpu", debug_nans=True)


@pytest.mark.parametrize("gname,scene,w,h,depth,spp,exact", GOLDEN)
def test_goldens_with_debug_nans(gname, scene, w, h, depth, spp, exact,
                                 tmp_path):
    """The four golden configurations render with the NaN check on, AOVs
    included, and raise nothing; the beauty is the unchecked render's."""
    host, sc = _load(scene, tmp_path)
    cfg = RenderConfig(width=w, height=h, ray_depth=depth, samples=spp,
                       samples_per_step=spp, intersector="pallas",
                       compact="auto", debug_features=True)
    checked = runtime.render_scene(sc, cfg, host.cam.fov_x, device="cpu",
                                   debug_nans=True)
    plain = runtime.render_scene(sc, cfg.replace(debug_features=False),
                                 host.cam.fov_x, device="cpu")
    assert torch.equal(checked.stats.total[0], plain.stats.total[0])
