"""Tests of the benchmark itself: on the CPU at tiny geometry, and (marked
`cuda`) the controls on the card. Run from the repository root:

    python -m pytest portbench/tests -q
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(d_model=32, n_heads=2, ffn_dim=64, encoder_layers=2,
            decoder_layers=2, vocab_size=64)


def tiny_cell(name, **params):
    """The cell of BENCHMARK.json at a tiny geometry, its traffic params
    overridden."""
    from portbench import harness
    cell = harness.Cell(harness.load_json(os.path.join(ROOT,
                                                       "BENCHMARK.json")),
                        name)
    cell.config["model"].update(TINY)
    cell.traffic["params"].update(params)
    return cell


SMALL = {
    "offline-b8-mixed": dict(batches=4),
    "stream-hub-knee80": dict(sessions=3, utterance_s=[1.0, 2.5]),
    "finetune-b32-10s": dict(batch=4, frames=20, k_max=8, target_len=[3, 8]),
}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return torch.device("cuda")
