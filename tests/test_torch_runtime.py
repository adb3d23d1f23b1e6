"""The port's host driver on the CPU: accumulation across steps,
determinism, interrupts and continuous mode, trials and the performance
summary, the convergence statistic, checkpoints and the accumulator
helpers (mirrors tests/test_runtime.py:20-115 without the debug layers,
and holds the port against the JAX package where both compute the same
thing).

The cube renders through "auto", which on CPU tensors means the "brute"
intersector, as in the JAX package's own runtime tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raytracer_odin_tpu.render import accum as jaccum
from raytracer_odin_tpu.render import checkpoint as jcheckpoint
from raytracer_odin_tpu.render import runtime as jruntime
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.render import accum, checkpoint, runtime
from tests.test_torch_render import _load


def small_cfg(**kw):
    base = dict(width=16, height=16, ray_depth=2, samples=4,
                samples_per_step=2)
    base.update(kw)
    return RenderConfig(**base)


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    return _load("cube", tmp_path_factory.mktemp("cube"))


def _render(cube, cfg, **kw):
    host, scene = cube
    return runtime.render_scene(scene, cfg, host.cam.fov_x, device="cpu",
                                **kw)


def test_step_accumulation(cube):
    res = _render(cube, small_cfg())
    assert res.samples_done == 4
    assert torch.all(res.stats.count[0] == 4)
    total = res.stats.total[0]
    assert bool(torch.isfinite(total).all()) and float(total.max()) > 0
    assert len(res.trial_seconds) == 1 and res.rays_cast > 0


def test_determinism_across_step_sizes(cube):
    """Same seed, different samples_per_step: the same totals (the
    per-(pixel, sample) counter-based streams make batching irrelevant)."""
    r1 = _render(cube, small_cfg(samples_per_step=1))
    r2 = _render(cube, small_cfg(samples_per_step=4))
    assert torch.allclose(r1.stats.total[0], r2.stats.total[0], rtol=1e-5,
                          atol=1e-5)
    assert torch.equal(r1.stats.first[0], r2.stats.first[0])
    assert torch.equal(r1.stats.last[0], r2.stats.last[0])


def test_seed_changes_result(cube):
    r1 = _render(cube, small_cfg(seed=0))
    r2 = _render(cube, small_cfg(seed=1))
    assert not torch.allclose(r1.stats.total[0], r2.stats.total[0])


def test_interrupt_stops_render(cube):
    flag = runtime.InterruptFlag()
    flag.set()
    res = _render(cube, small_cfg(continuous=True), interrupt=flag)
    assert res.samples_done == 0  # interrupted before the first step


def test_continuous_via_on_step_interrupt(cube):
    """Continuous mode runs until the flag is set mid-render; the partial
    accumulation survives (graceful SIGINT semantics, main.odin:170-172)."""
    flag = runtime.InterruptFlag()
    steps = []

    def on_step(stats, n):
        steps.append(n)
        if len(steps) >= 3:
            flag.set()

    res = _render(cube, small_cfg(continuous=True), interrupt=flag,
                  on_step=on_step)
    assert res.samples_done == 6  # 3 steps x 2 spp
    assert torch.all(res.stats.count[0] == 6)


def test_install_routes_sigint():
    import signal

    flag = runtime.InterruptFlag().install()
    try:
        assert not flag
        signal.raise_signal(signal.SIGINT)
        assert flag
    finally:
        flag.uninstall()
    assert signal.getsignal(signal.SIGINT) is not None


def test_convergence_stop(cube, capsys):
    """converge_se stops a continuous render at the first check below the
    threshold, and says so."""
    res = _render(cube, small_cfg(continuous=True), converge_se=1e9,
                  converge_check_every=2, verbose=True)
    assert res.samples_done == 4  # the check after the second step
    out = capsys.readouterr().out
    assert "median standard error" in out and "Converged at 4 spp" in out


def test_trials_benchmark(cube, capsys):
    res = _render(cube, small_cfg(), trials=3, verbose=True)
    assert len(res.trial_seconds) == 3
    out = capsys.readouterr().out
    assert "Performance Summary" in out
    assert "Best:" in out and "Median:" in out and "Worst:" in out
    assert out.count("Trial ") == 3


@pytest.mark.parametrize("timings", [[0.5], [0.25, 0.125],
                                     [0.3, 0.1, 0.2, 0.4]])
def test_perf_summary_text_matches(timings, capsys):
    """print_perf_summary prints the JAX package's text letter for
    letter."""
    jruntime.print_perf_summary(timings)
    want = capsys.readouterr().out
    runtime.print_perf_summary(timings)
    assert capsys.readouterr().out == want


@pytest.mark.parametrize("h,w", [(16, 16), (7, 10)])
def test_mean_standard_error_matches(h, w):
    """The median standard error equals jnp.median's (the mean of the two
    middle values for an even count; 16 x 16 x 3 and 7 x 10 x 3 are
    even)."""
    rng = np.random.default_rng(h)
    count = rng.integers(1, 9, (1, h, w)).astype(np.float32)
    total = rng.normal(1.0, 0.5, (1, h, w, 3)).astype(np.float32) * count[
        ..., None]
    total_sq = (total * total / count[..., None]
                + rng.uniform(0, 2, (1, h, w, 3)).astype(np.float32))
    zeros = np.zeros_like(total)
    jstats = jaccum.Stats(first=jnp.asarray(zeros), last=jnp.asarray(zeros),
                          total=jnp.asarray(total),
                          total_sq=jnp.asarray(total_sq),
                          count=jnp.asarray(count))
    tstats = accum.Stats(first=torch.from_numpy(zeros),
                         last=torch.from_numpy(zeros),
                         total=torch.from_numpy(total),
                         total_sq=torch.from_numpy(total_sq),
                         count=torch.from_numpy(count))
    want = float(jruntime.mean_standard_error(jstats))
    got = runtime.mean_standard_error(tstats)
    assert got.dim() == 0
    # within an ulp: XLA may fuse total_sq / n - mean * mean into an FMA
    assert float(got) == pytest.approx(want, rel=2e-7)
    se = np.sort(np.sqrt(np.maximum(
        total_sq[0] / count[0][..., None]
        - (total[0] / count[0][..., None]) ** 2, 0) / count[0][..., None]),
        axis=None)
    lower = se[(se.size - 1) // 2]
    assert float(got) != pytest.approx(float(lower), rel=1e-9)


def test_checkpoint_roundtrip_and_resume(cube, tmp_path):
    host, scene = cube
    cfg = small_cfg()
    res = _render(cube, cfg)
    p = tmp_path / "ck.npz"
    checkpoint.save(p, res.stats, res.samples_done, {"scene": "cube"})
    assert checkpoint.exists(p)
    stats2, n, meta = checkpoint.load(p, device="cpu")
    assert n == res.samples_done and meta["scene"] == "cube"
    assert torch.equal(stats2.total, res.stats.total)
    # resume: continue to 8 samples and compare with a straight run
    res2 = _render(cube, cfg.replace(samples=8), initial_stats=stats2,
                   initial_samples=n)
    ref = _render(cube, cfg.replace(samples=8))
    assert res2.samples_done == 8
    assert torch.allclose(res2.stats.total[0], ref.stats.total[0],
                          rtol=1e-5, atol=1e-5)


def test_checkpoint_cross_loads_with_jax(tmp_path):
    """A checkpoint written by either package loads in the other."""
    rng = np.random.default_rng(4)
    arrays = {f: rng.normal(size=(1, 5, 6, 3)).astype(np.float32)
              for f in ("first", "last", "total", "total_sq")}
    arrays["count"] = rng.integers(0, 9, (1, 5, 6)).astype(np.float32)
    jp = tmp_path / "jax.npz"
    jcheckpoint.save(jp, jaccum.Stats(**{k: jnp.asarray(v)
                                         for k, v in arrays.items()}),
                     12, {"scene": "j"})
    ts, n, meta = checkpoint.load(jp, device="cpu")
    assert n == 12 and meta["scene"] == "j"
    for f, v in arrays.items():
        assert np.array_equal(getattr(ts, f).numpy(), v), f
    tp = tmp_path / "torch.npz"
    checkpoint.save(tp, ts, 13, {"scene": "t"})
    js, n, meta = jcheckpoint.load(tp)
    assert n == 13 and meta["scene"] == "t"
    for f, v in arrays.items():
        assert np.array_equal(np.asarray(getattr(js, f)), v), f
    bad = tmp_path / "bad.npz"
    np.savez(bad, meta='{"version": 2, "samples_done": 0}')
    with pytest.raises(ValueError):
        checkpoint.load(bad, device="cpu")


def test_accum_helpers_match_jax():
    """crop, pad_rows and update_layer agree with the JAX package's."""
    rng = np.random.default_rng(6)
    arrays = {f: rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
              for f in ("first", "last", "total", "total_sq")}
    arrays["count"] = rng.integers(0, 3, (2, 5, 6)).astype(np.float32)
    color = rng.normal(size=(5, 6, 3)).astype(np.float32)

    def both():
        return (jaccum.Stats(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                accum.Stats(**{k: torch.from_numpy(v.copy())
                               for k, v in arrays.items()}))

    def same(j, t):
        for f in ("first", "last", "total", "total_sq", "count"):
            assert np.array_equal(np.asarray(getattr(j, f)),
                                  getattr(t, f).numpy()), f

    j, t = both()
    same(jaccum.pad_rows(j, 8), accum.pad_rows(t, 8))
    same(jaccum.crop(jaccum.pad_rows(j, 8), 5, 6),
         accum.crop(accum.pad_rows(t, 8), 5, 6))
    same(jaccum.crop(j, 3, 4), accum.crop(t, 3, 4))
    assert accum.crop(t, 5, 6) is t and accum.pad_rows(t, 5) is t
    same(jaccum.update_layer(j, 1, jnp.asarray(color)),
         accum.update_layer(t, 1, torch.from_numpy(color)))


def test_render_entry_refuses_wrong_device(cube):
    host, scene = cube
    with pytest.raises(ValueError):
        runtime.render_scene(scene, small_cfg(), host.cam.fov_x,
                             device="meta")
    assert jax.default_backend() == "cpu"


def test_phase_timer_matches_jax(monkeypatch):
    """utils/profiling.PhaseTimer against the JAX package's on the same
    clock: phases summed by name in first-use order, the same report text,
    the throughput line only with rays and a render phase."""
    import time

    from raytracer_odin_tpu.utils import profiling as jprof
    from raytracer_odin_tpu_torch.utils import profiling

    def run(module):
        ticks = iter([0.0, 0.25, 1.0, 3.5, 4.0, 4.125])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        t = module.PhaseTimer()
        for name in ("ingest", "render", "ingest"):
            with t.phase(name):
                pass
        return t

    got, want = run(profiling), run(jprof)
    assert got.order == want.order == ["ingest", "render"]
    assert got.phases == want.phases == {"ingest": 0.375, "render": 2.5}
    assert got.report(5_000_000) == want.report(5_000_000)
    assert "2.00 Mrays/s" in got.report(5_000_000)
    assert got.report() == want.report()
    assert "throughput" not in got.report()
