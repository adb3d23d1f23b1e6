"""The readers of the program's spans and counters (benchmark/metrics/
shade_host_ms.py and the six beside it) on the tiny cells: a traced run
reports each metric its cell lists, as a number, and an untraced run none
of them."""

from __future__ import annotations

import pytest

from benchmark.tests.conftest import run_cell

ONE_CARD = ("shade_host_ms", "sort_host_ms", "cast_host_ms",
            "host_syncs_per_step", "calibrate_s", "scene_build_s")


@pytest.mark.parametrize("cell,names", [
    ("tiny.preview", ONE_CARD),
    ("tiny4.preview", ONE_CARD + ("tile_enqueue_ms",)),
])
def test_span_readers_report_numbers(tiny_root, capsys, cell, names):
    rc, line = run_cell(tiny_root, capsys, cell, trace=1)
    assert rc == 0
    got = line["metrics"]
    for name in names:
        assert isinstance(got[name]["value"], float), name
        assert got[name]["value"] >= 0.0, name
    assert got["host_syncs_per_step"]["value"] == 0.0
    assert got["shade_host_ms"]["value"] > 0.0
    assert got["calibrate_s"]["value"] > 0.0
    assert got["scene_build_s"]["value"] > 0.0
    assert ("tile_enqueue_ms" in got) == (cell == "tiny4.preview")


def test_span_readers_silent_untraced(tiny_root, capsys):
    rc, line = run_cell(tiny_root, capsys, "tiny.preview", trace=0)
    assert rc == 0
    assert not set(line["metrics"]) & set(ONE_CARD + ("tile_enqueue_ms",))
