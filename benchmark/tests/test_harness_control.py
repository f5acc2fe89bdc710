"""The control (the reference one precision lower, in the program's place)
fails where the program passes.  On the CPU at a tiny size it reads at
least three times the program on a cell's numbers; on the card
(``-m gpu``) at the cells' own sizes it breaks the configured limits."""

import json

import pytest
import torch

from benchmark import control
from conftest import ROOT, run_cell


@pytest.mark.parametrize("workload, numbers", [
    ("tracker-1080p.s512", ("ncc_err", "match_err")),
    ("haar-scan-544p.faces1", ("recog_err",)),
])
def test_the_control_reads_far_above_the_program(tiny_root, workload, numbers):
    rc, result, err = run_cell(tiny_root, workload, seed=11)
    assert rc == 0 and result["correct"], err
    low = control.readings(workload, 11, torch.device("cpu"), root=tiny_root)
    for name in numbers:
        assert low[name] >= 3 * result["checks"][name]["value"], (name, low, result["checks"])
        assert low[name] > result["checks"][name]["limit"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_the_control_breaks_the_limits_on_the_card(card, workload):
    from benchmark.harness import Cell

    limits = Cell(workload).limits
    low = control.readings(workload, 3, card)
    assert any(low[name] > limits[name] for name in limits), (low, limits)
