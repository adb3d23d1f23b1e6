"""Phase timing and device tracing (port of
raytracer_odin_tpu/utils/profiling.py).

  * `PhaseTimer` — host wall time per named phase (ingest, build, upload,
    render, readback, ...) with a printable report and Mrays/s over the
    "render" phase;
  * `trace()` wraps `torch.profiler` around a block and writes a Chrome
    trace (chrome://tracing, Perfetto) into a directory: the CLI's
    `--profile-dir`.

A phase's time is the host's: work a phase enqueues on the card is in it
only where the phase waits for the card (torch.cuda.synchronize).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@dataclass
class PhaseTimer:
    phases: dict = field(default_factory=dict)
    order: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Add the block's wall time to phase `name`."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self.phases:
                self.order.append(name)
                self.phases[name] = 0.0
            self.phases[name] += dt

    def report(self, rays_cast: int | None = None) -> str:
        """Each phase's ms and share, the total, and with `rays_cast` the
        Mrays/s of the "render" phase."""
        lines = ["--- phase timings ---"]
        total = sum(self.phases.values())
        for name in self.order:
            dt = self.phases[name]
            lines.append(f"{name:>12}: {dt * 1000:9.1f} ms "
                         f"({dt / max(total, 1e-9) * 100:4.1f}%)")
        lines.append(f"{'total':>12}: {total * 1000:9.1f} ms")
        if rays_cast and self.phases.get("render", 0) > 0:
            mrays = rays_cast / self.phases["render"] / 1e6
            lines.append(f"{'throughput':>12}: {mrays:9.2f} Mrays/s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """Trace the block's host activity, and the card's kernels when
    `device` is a CUDA device, into log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
