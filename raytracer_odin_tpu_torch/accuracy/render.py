"""The card's side of the accuracy harness (the counterpart of the JAX
repo's tools/rmse_tpu.py, rmse_tpu_one.py and rmse_tpu_draws.py): the
same-seed, proxy and draw halves of each config, written to OUT_DIR as
{cfg}_card_sameseed{,_var}.npy, {cfg}_card_proxy_{mean,var}.npy and
{cfg}_card_draws.npz (means, vars, chunk: the layout of the oracle's
draws).

The same-seed half renders as the JAX tools do, through
runtime.render_scene's own step at the tools' samples a step: the user's
path (uncompacted under RenderConfig's default compact "off", as in the
tools). The proxy and draw halves take 1024 and 16 x 512 samples at the
proxy resolution; for them a step traces all of its samples as one
batch of lanes (batched_step): sample k of the step occupies image rows
[k H, (k + 1) H) of a tall batch, each lane drawing with its own sample
index and its pixel's stream id, so every sample's values are those of
a sample traced alone, and the samples are folded in order
(tests/test_torch_accuracy.py holds the statistics bit-equal to the
runtime's step). A step holds up to STEP_LANES lanes (step_samples), so
a 1024-spp proxy is eight traces on the card, not 1024.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from raytracer_odin_tpu_torch.accuracy import configs
from raytracer_odin_tpu_torch.config import RenderConfig
from raytracer_odin_tpu_torch.ops.integrator import trace
from raytracer_odin_tpu_torch.render import accum
from raytracer_odin_tpu_torch.render import runtime as rt
from raytracer_odin_tpu_torch.utils import prng

# Disjoint from the oracle draw bases (555000, 888000), the primary
# triplet (777000+), seed2 and the harness seed.
SEED_BASE = 444_000
# The most lanes one step of the proxy and draw halves traces (a 1080p
# frame's worth).
STEP_LANES = 1 << 21


def step_samples(spp: int, pixels: int, lanes: int = STEP_LANES) -> int:
    """The largest divisor of spp whose samples of `pixels` pixels fit in
    `lanes` lanes (at least 1)."""
    s = max(1, min(spp, lanes // max(pixels, 1)))
    while spp % s:
        s -= 1
    return s


def tools_step(spp: int) -> int:
    """The JAX tools' samples a step: min(spp, 8), lowered to a divisor of
    spp."""
    return step_samples(spp, 1, lanes=8)


def batched_step(cfg: RenderConfig, fov_x: float, device):
    """A render step (runtime.render_scene's step_fn) that traces the
    step's cfg.samples_per_step samples as one [S H, W] batch of lanes
    through integrator.trace, uncompacted, and folds them into the stats
    in sample order; info as runtime.make_render_step's (rays cast,
    overflow, live lanes entering each bounce, summed over the
    samples)."""
    opts = rt._trace_options(cfg)
    H, W, S = cfg.height, cfg.width, cfg.samples_per_step
    dev = torch.device(device)
    pixel = torch.arange(H * W, dtype=torch.int32, device=dev)
    sids = pixel.repeat(S).reshape(S * H, W)
    offsets = torch.arange(S, dtype=torch.int32,
                           device=dev).repeat_interleave(H * W)

    def step(scene, stats, key, sample_start: int):
        samples = (offsets + sample_start).reshape(S * H, W)
        jitter = prng.uniforms(key, samples, prng.JITTER_TAG, sids, 2)
        o, d = rt.generate_rays(scene.cam_pos, scene.cam_basis, fov_x, W,
                                H, jitter.reshape(-1, 2),
                                pixel=sids.reshape(-1))
        radiance, aux = trace(scene, o.reshape(S * H, W, 3),
                              d.reshape(S * H, W, 3), key, samples, opts,
                              stream_ids=sids)
        radiance = radiance.reshape(S, H, W, 3)
        for k in range(S):
            accum.update_layers(stats, radiance[k][None])
        info = torch.cat([aux["rays_cast"].reshape(1),
                          aux["overflow"].reshape(1), aux["alive_counts"]])
        return stats, info

    return step


def render_stats(scene, fov_x, w, h, depth, spp, seed=0, *, device="cuda",
                 batch=None):
    """Per-pixel mean and variance of a render of `spp` samples (the JAX
    tools' render_stats): the same RenderConfig (debug_features off, the
    "auto" intersector: K1 + K2 on the card) through runtime.render_scene.
    Without `batch`, with the runtime's own step at the tools' samples a
    step (tools_step), as the tools render; with `batch`, with
    batched_step at `batch` samples a step. The moments come from the
    beauty layer's count, total and total_sq in float64, returned as
    float32 [h, w, 3]."""
    cfg = RenderConfig(
        width=w, height=h, ray_depth=depth, samples=spp,
        samples_per_step=batch or tools_step(spp),
        debug_features=False, seed=seed,
    )
    step = None if batch is None else batched_step(cfg, fov_x, device)
    res = rt.render_scene(scene, cfg, fov_x, device=device, step_fn=step)
    n = res.stats.count[0].cpu().numpy().astype(np.float64)[..., None]
    total = res.stats.total[0].cpu().numpy().astype(np.float64)
    total_sq = res.stats.total_sq[0].cpu().numpy().astype(np.float64)
    mean = total / n
    var = np.maximum(total_sq / n - mean**2, 0.0)
    return mean.astype(np.float32), var.astype(np.float32)


class Harness:
    """The halves of the configs, rendered on `device` into `out_dir`.
    Scenes are built once each. `seconds` sums each config's render time
    (scene builds excluded)."""

    def __init__(self, device="cuda", out_dir=None, log=print):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the accuracy harness renders on the card: "
                               "no CUDA device (pass device='cpu' to render "
                               "on the CPU)")
        self.out = Path(out_dir or configs.OUT_DIR)
        self.out.mkdir(parents=True, exist_ok=True)
        self.log = log
        self.seconds = {}
        self._scenes = {}

    def scene(self, scene_name: str):
        if scene_name not in self._scenes:
            self._scenes[scene_name] = configs.load_scene(scene_name,
                                                          self.device)
        return self._scenes[scene_name]

    def _render(self, name, scene_name, w, h, depth, spp, seed=0,
                batch=None):
        host, scene = self.scene(scene_name)
        t0 = time.perf_counter()
        out = render_stats(scene, host.cam.fov_x * (w / h), w, h, depth,
                           spp, seed, device=self.device, batch=batch)
        dt = time.perf_counter() - t0
        self.seconds[name] = self.seconds.get(name, 0.0) + dt
        return out, dt

    def same_seed(self, name: str) -> None:
        """Full resolution at the harness spp, seed 0, through the
        runtime's own step."""
        if name in configs.NO_SAME_SEED:
            return
        _, scene_name, w, h, depth, _cfg, ss_spp, _p = configs.row(name)
        (mean, var), dt = self._render(name, scene_name, w, h, depth,
                                       ss_spp)
        np.save(self.out / f"{name}_card_sameseed.npy", mean)
        np.save(self.out / f"{name}_card_sameseed_var.npy", var)
        self.log(f"{name}: same-seed {w}x{h}@{ss_spp}spp in {dt:.1f}s")

    def proxy(self, name: str) -> None:
        """Proxy resolution at PROXY_SPP, seed 0, batched steps."""
        _, scene_name, _w, _h, depth, _cfg, _ss, (pw, ph, _) = (
            configs.row(name))
        spp = configs.PROXY_SPP
        (mean, var), dt = self._render(name, scene_name, pw, ph, depth, spp,
                                       batch=step_samples(spp, pw * ph))
        np.save(self.out / f"{name}_card_proxy_mean.npy", mean)
        np.save(self.out / f"{name}_card_proxy_var.npy", var)
        self.log(f"{name}: proxy {pw}x{ph}@{spp}spp in {dt:.1f}s")

    def draws(self, name: str, draws: int = 16, chunk: int = 512,
              var_sweep: bool = True, resume: bool = False) -> None:
        """`draws` independent proxy renders of `chunk` spp each (seeds
        SEED_BASE + k), batched steps. With resume, an npz of the same
        chunk already in out_dir is extended; without, it is replaced.
        With var_sweep, the variance-estimate spp dependence of the same
        implementation (fresh seeds) is printed."""
        _, scene_name, _w, _h, depth, _cfg, _ss, (pw, ph, _) = (
            configs.row(name))
        path = self.out / f"{name}_card_draws.npz"
        step = step_samples(chunk, pw * ph)
        means, vars_ = [], []
        if resume and path.exists():
            prev = np.load(path)
            if int(prev["chunk"]) == chunk:
                means, vars_ = list(prev["means"]), list(prev["vars"])
                self.log(f"{name}: resuming with {len(means)} draws")
        elif path.exists():
            path.unlink()
        k = len(means)
        while k < draws:
            (m, v), dt = self._render(name, scene_name, pw, ph, depth,
                                      chunk, SEED_BASE + k, step)
            means.append(m)
            vars_.append(v)
            k += 1
            tmp = path.with_suffix(".tmp.npz")
            np.savez(tmp, means=np.stack(means), vars=np.stack(vars_),
                     chunk=np.int64(chunk))
            tmp.replace(path)
            self.log(f"{name}: draw {k}/{draws} ({chunk} spp) in {dt:.1f}s")
        im = np.stack([m.mean() for m in means])
        c_hat = im.var(ddof=1) * chunk if len(im) > 1 else float("nan")
        self.log(f"{name}: image means {im}")
        self.log(f"{name}: empirical c = Var[draw mean]*chunk = {c_hat:.3e}"
                 f" -> SE at {chunk} spp = {np.sqrt(c_hat / chunk):.3e}")
        if var_sweep:
            base = None
            for spp in (128, 512, 1024, 4096):
                (_m, v), _dt = self._render(
                    name, scene_name, pw, ph, depth, spp,
                    SEED_BASE + 1000 + spp, step_samples(spp, pw * ph))
                lum = float(v.mean())
                base = base or lum
                self.log(f"{name}:   spp {spp:5d}: mean var {lum:.5e} "
                         f"(x{lum / base:.3f} of spp-128)")
