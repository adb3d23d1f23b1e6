"""Fixtures of the benchmark's tests: a copy of the benchmark's data under
a temporary root, with tiny cells that run on the CPU in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmark import run

DATA = ("configs", "workloads", "traffic", "metrics", "scenes")
# Limits of the tiny cells: their sound runs (about 15 samples a pixel in a
# 4 s window) read z2_mean about 1, image_z under 2 and segments_gap under
# 0.01; the planted faults read above these.
TINY_LIMITS = {"count_off": 0, "z2_mean": 3.0, "image_z": 5.0,
               "segments_gap": 0.1}


def add_cell(root: Path, name: str, config: str, devices: int = 1,
             width: int = 32, height: int = 16, depth: int = 3):
    """A tiny demo cell `name` with its configuration `config` under
    root, listed in root/BENCHMARK.json with every per-layer metric."""
    bench = root / "benchmark"
    conf = json.loads((bench / "configs" / "demo_1080p.json").read_text())
    conf.update(width=width, height=height, ray_depth=depth,
                devices=devices)
    (bench / "configs" / f"{config}.json").write_text(json.dumps(conf))
    (bench / "workloads" / f"{name}.json").write_text(json.dumps({
        "env": {}, "trace": {"start_step": 1, "steps": 1},
        "check": {"rows": 8, "spp": 16, "segment_px": 8, "control_spp": 16,
                  "limits": TINY_LIMITS}}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": "preview",
                              "chips": 1 if devices == 1 else 4,
                              "why": "tiny"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture
def tiny_root(tmp_path):
    """A root holding BENCHMARK.json and the benchmark's data, with the
    tiny cells tiny.preview (one device) and tiny4.preview (a four-tile
    mesh of the CPU)."""
    bench = tmp_path / "benchmark"
    for d in DATA:
        shutil.copytree(run.BENCH / d, bench / d)
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    add_cell(tmp_path, "tiny.preview", "tiny")
    add_cell(tmp_path, "tiny4.preview", "tiny4", devices=4)
    return tmp_path


def run_cell(root, capsys, name, seed=12345, seconds=3.0, trace=0):
    """One CPU run of cell `name`: (exit code, the last stdout line as a
    dict or None)."""
    rc = run.main(["--workload", name, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  device="cpu", root=root)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
