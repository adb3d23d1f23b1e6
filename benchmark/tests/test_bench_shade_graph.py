"""benchmark/metrics/shade_graph_share.py on synthetic phases: replayed
segments inside the steps over the shade spans inside them, and nothing
where the steps or their shade spans are missing."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import run
from raytracer_odin_tpu_torch.utils.profiling import PhaseTimer, SpanStat

READER = run.load_module(run.BENCH / "metrics" / "shade_graph_share.py")


def _ctx(steps, shades, replays):
    spans = {}
    if steps:
        spans["step"] = SpanStat(steps, 10**9, 10**8)
    if shades:
        spans["shade"] = SpanStat(shades, 10**8, 10**8)
    counters = {"shade_graph_replays": replays} if replays else {}
    return SimpleNamespace(result=SimpleNamespace(phases=PhaseTimer(
        spans=dict(spans), step_spans=spans, counters=dict(counters),
        step_counters=counters)))


@pytest.mark.parametrize("steps,shades,replays,want", [
    (10, 80, 80, 1.0),
    (10, 80, 20, 0.25),
    (10, 80, 0, 0.0),
    (0, 80, 80, None),
    (10, 0, 0, None),
])
def test_share_from_synthetic_phases(steps, shades, replays, want):
    assert READER.read(_ctx(steps, shades, replays)) == want


def test_no_phases_no_share():
    assert READER.read(SimpleNamespace(result=None)) is None
