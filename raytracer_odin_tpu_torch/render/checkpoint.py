"""Accumulator checkpoint / resume (port of
raytracer_odin_tpu/render/checkpoint.py).

The reference never serializes its accumulation state; here continuous
renders survive restarts: the Stats tensors and the render metadata
round-trip through one .npz file, in the JAX package's format
(FORMAT_VERSION 1), so a checkpoint written by either package loads in the
other. The CLI's `--resume` picks it up.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from raytracer_odin_tpu_torch.render import accum

FORMAT_VERSION = 1
_FIELDS = ("first", "last", "total", "total_sq", "count")


def save(path, stats: accum.Stats, samples_done: int,
         meta: dict | None = None) -> None:
    np.savez_compressed(
        path,
        **{f: getattr(stats, f).detach().cpu().numpy() for f in _FIELDS},
        meta=json.dumps({"version": FORMAT_VERSION,
                         "samples_done": samples_done, **(meta or {})}),
    )


def load(path, device="cuda"):
    """Returns (stats on `device`, samples_done, meta)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"unsupported checkpoint version: {meta.get('version')}")
    stats = accum.Stats(**{
        f: torch.tensor(z[f], dtype=torch.float32, device=device)
        for f in _FIELDS})
    return stats, int(meta["samples_done"]), meta


def exists(path) -> bool:
    return Path(path).exists()
