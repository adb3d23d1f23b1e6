"""BENCHMARK.json against the contract's rules, the harness's discovery of
its files by name, and the keys of a run's last line."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import run
from benchmark.tests.conftest import run_cell

SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_limits():
    assert set(SPEC) == KEYS
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"]
    cells = len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, cells // 4)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert (run.BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_found_by_name(wl):
    cell = run.load_cell(wl["name"])
    assert cell.chips == wl["chips"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "mrays_per_s"}
    assert cell.per_layer
    assert (run.BENCH / "scenes"
            / f"{cell.config['scene']['generator']}.py").exists()
    assert set(cell.settings["check"]["limits"]) == set(
        __import__("benchmark.check", fromlist=["NUMBERS"]).NUMBERS)


def test_added_cell_config_and_metric_are_found(tiny_root, capsys):
    """A cell, its configuration and a per-layer metric added as new files
    run without an edit to any file that was there."""
    (tiny_root / "benchmark" / "metrics" / "tiny_steps.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "tiny_steps", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "host loop (render.runtime)",
                              "moves": "mrays_per_s",
                              "workloads": ["tiny.preview"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line = run_cell(tiny_root, capsys, "tiny.preview", trace=1)
    assert rc == 0
    assert line["metrics"]["tiny_steps"]["value"] == line["attempted"]


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(tiny_root, capsys, trace):
    rc, line = run_cell(tiny_root, capsys, "tiny.preview", trace=trace)
    assert rc == 0 and line["correct"] is True
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown"] if trace else []
    assert list(line) == want + ["checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"setup_s", "mrays_per_s",
                                        "step_ms_p95"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(capsys):
    """Without the cards a cell asks for, the run exits non-zero and
    prints no result (run where there is no card)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "demo_1080p.preview", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
