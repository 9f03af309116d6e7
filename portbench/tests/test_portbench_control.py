"""The controls on the card: the reference put in the program's place and
computed with TF32 on (and, for fine-tuning, with half of each batch left
out) fails the cell's check. At the published widths, on fewer rows than a
run compares; `portbench/control.py` reads them at each cell's own size.

    python -m pytest portbench/tests -q -m cuda    # on the card
"""
import json
import os

import pytest

from conftest import ROOT

from portbench import harness

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
SMALLER = {
    "offline-b8-mixed": ({"batches": 1}, {}),
    "stream-hub-knee80": ({"utterances": 4}, {}),
    "finetune-b32-10s": ({}, {"batch": 8}),
}
CASES = [(c, "tf32") for c in SMALLER] + [("finetune-b32-10s", "half_batch")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,mode", CASES)
def test_control_fails_the_check(card, name, mode):
    import torch
    cell = harness.Cell(BENCH, name)
    check, params = SMALLER[name]
    cell.traffic["check"].update(check)
    cell.traffic["params"].update(params)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = cell.driver(2 ** 31 + 11, card).control(mode)
    limits = cell.traffic["limits"]
    assert any(not numbers[k] <= limits[k] for k in limits), numbers
