"""The run with its timed path broken underneath: the harness's look for
a card is skipped (device="cpu") and the rest of a run is driven on a tiny
cell; each fault the cells can have turns `correct` false, where the
unbroken run is correct."""

from __future__ import annotations

import pytest
import torch

from benchmark.tests.conftest import run_cell
from raytracer_odin_tpu_torch.parallel import mesh as pmesh
from raytracer_odin_tpu_torch.render import accum, runtime


def _state_unchanged(monkeypatch):
    """Every step returns the accumulator it was given."""
    monkeypatch.setattr(accum, "update_layers", lambda stats, vals: stats)


def _half_batch(monkeypatch):
    """Half of each sample's rows left out, their pixels given the mean of
    the rest."""
    orig = runtime.sample_pass

    def broken(*a, **k):
        radiance, aux = orig(*a, **k)
        h = radiance.shape[0] // 2
        radiance = radiance.clone()
        radiance[h:] = radiance[:h].mean(dim=(0, 1))
        return radiance, aux

    monkeypatch.setattr(runtime, "sample_pass", broken)


def _answer_altered(monkeypatch):
    """Each sample's radiance altered where it is produced."""
    orig = runtime.sample_pass

    def broken(*a, **k):
        radiance, aux = orig(*a, **k)
        return radiance * 0.5, aux

    monkeypatch.setattr(runtime, "sample_pass", broken)


def _count_altered(monkeypatch):
    """The live segments counted twice."""
    orig = runtime.sample_pass

    def broken(*a, **k):
        radiance, aux = orig(*a, **k)
        return radiance, dict(aux, rays_cast=aux["rays_cast"] * 2)

    monkeypatch.setattr(runtime, "sample_pass", broken)


def _exchange_left_out(monkeypatch):
    """The tiles never leave their devices: the frame read back on the
    first tile's device holds only that tile's rows."""

    def gather(self, field):
        b = getattr(self.blocks[0], field)
        return torch.cat([b] + [torch.zeros_like(b)] * (len(self.blocks) - 1),
                         dim=1)

    monkeypatch.setattr(pmesh.ShardedStats, "_gather", gather)


FAULTS = [("tiny.preview", _state_unchanged),
          ("tiny.preview", _half_batch),
          ("tiny.preview", _answer_altered),
          ("tiny.preview", _count_altered),
          ("tiny4.preview", _exchange_left_out)]


@pytest.mark.parametrize("cell", ["tiny.preview", "tiny4.preview"])
def test_sound_run_is_correct(tiny_root, capsys, cell):
    rc, line = run_cell(tiny_root, capsys, cell, seconds=4.0)
    assert rc == 0 and line["correct"] is True, line["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f.__name__[1:] for _, f in FAULTS])
def test_fault_is_caught(tiny_root, capsys, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line = run_cell(tiny_root, capsys, cell, seconds=4.0)
    assert rc == 0 and line["correct"] is False, line["checks"]
