"""The numpy oracle's row bands, variance output and process fan-out in the
PyTorch port (oracle/cpu_reference.py: render(return_var=, row_offset=,
n_rows=), render_mp, RT_ORACLE_MP_CONTEXT) against the JAX package's, on
the CPU; mirrors tests/test_integrator.py::test_oracle_render_mp_bands.

The port's oracle is the JAX package's numpy code on the same scene arrays,
and render_mp's bands draw from the same seed streams (seed, band), so the
images and variances are held bit for bit."""

import numpy as np
import pytest

from raytracer_odin_tpu.oracle import cpu_reference as joracle
from raytracer_odin_tpu_torch.oracle import cpu_reference as toracle
from tests.torch_parity import torch_scene


@pytest.fixture(scope="module")
def cornell(cornell_scene):
    host, js = cornell_scene
    return host, js, torch_scene(js)


def test_render_bands_and_variance(cornell):
    """A band of rows equals those rows of the whole frame; the mean and
    variance equal the JAX package's."""
    host, js, ts = cornell
    fov = host.cam.fov_x
    mean, var = toracle.render(ts, 16, 16, fov, 2, 3, seed=4,
                               return_var=True)
    jmean, jvar = joracle.render(js, 16, 16, fov, 2, 3, seed=4,
                                 return_var=True)
    assert np.array_equal(mean, jmean) and np.array_equal(var, jvar)
    assert (var >= 0).all() and var.max() > 0
    assert np.array_equal(mean, toracle.render(ts, 16, 16, fov, 2, 3,
                                               seed=4))
    band = toracle.render(ts, 16, 16, fov, 2, 3, seed=4, row_offset=5,
                          n_rows=6)
    assert np.array_equal(band, joracle.render(js, 16, 16, fov, 2, 3,
                                               seed=4, row_offset=5,
                                               n_rows=6))
    assert band.shape == (6, 16, 3)


@pytest.mark.parametrize("workers", [1, 2])
def test_render_mp_matches_jax(cornell, workers):
    """render_mp at workers 1 (render itself) and 2 (bands of 8 rows on a
    forked pool), with return_var: bit-equal to the JAX package's."""
    host, js, ts = cornell
    fov = host.cam.fov_x
    kw = dict(seed=3, workers=workers, band_rows=8, return_var=True)
    got = toracle.render_mp(ts, 24, 24, fov, 2, 4, **kw)
    want = joracle.render_mp(js, 24, 24, fov, 2, 4, **kw)
    for g, w in zip(got, want):
        assert g.shape == (24, 24, 3) and np.array_equal(g, w)
    if workers == 1:
        assert np.array_equal(got[0], toracle.render(ts, 24, 24, fov, 2, 4,
                                                     seed=3))


def test_mp_context(monkeypatch, cornell):
    """RT_ORACLE_MP_CONTEXT: "spawn" starts the pool otherwise and gives
    the same bands; a name multiprocessing has no context for is refused
    with a ValueError naming the variable."""
    host, _, ts = cornell
    fov = host.cam.fov_x
    want = toracle.render_mp(ts, 8, 16, fov, 1, 1, seed=2, workers=2,
                             band_rows=8)
    monkeypatch.setenv("RT_ORACLE_MP_CONTEXT", "spawn")
    got = toracle.render_mp(ts, 8, 16, fov, 1, 1, seed=2, workers=2,
                            band_rows=8)
    assert np.array_equal(got, want)
    monkeypatch.setenv("RT_ORACLE_MP_CONTEXT", "threads")
    with pytest.raises(ValueError, match="RT_ORACLE_MP_CONTEXT"):
        toracle.render_mp(ts, 8, 16, fov, 1, 1, workers=2)
