"""The control on the card: the reference in TF32, one precision step
below the float32 the configurations state, put in the program's place at
each cell's check size and the spp a window accumulates, fails the cell's
limits on three seeds. Card only (the reference at these sizes takes
minutes on a CPU):

    python -m pytest benchmark/tests -m gpu
"""

from __future__ import annotations

import json

import pytest

from benchmark import check, run

SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_is_not_correct(cell, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert run.main(["--workload", cell, "--seed", "4100000001",
                     "--seconds", "1", "--control", "3"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    limits = run.load_cell(cell).settings["check"]["limits"]
    assert len(lines) == 3
    for line in lines:
        correct, checks = check.judge(line["numbers"], limits)
        assert not correct, checks
