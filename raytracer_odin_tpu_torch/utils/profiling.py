"""Device tracing (port of raytracer_odin_tpu/utils/profiling.py).

`trace()` wraps `torch.profiler` around a block and writes a Chrome trace
(chrome://tracing, Perfetto) into a directory: the CLI's `--profile-dir`.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


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
