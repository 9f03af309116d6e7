"""The TTS cell's check catches a fault of its timed path: a run is driven
on the CPU at tiny geometry with the program broken underneath, and
`correct` comes out false; the same run of the sound program comes out
true."""
import dataclasses
import time

import pytest

from conftest import tiny_cell

from portbench import harness

SMALL = dict(paragraphs=3, chars={"median": 30, "sigma": 0.5, "min": 12,
                                  "max": 60},
             trace={"after_s": 0.2, "seconds": 0.3})


def run():
    cell = tiny_cell("tts-paragraph", **SMALL)
    cell.config["duration_bias"]["calibration_segments"] = 4
    return harness.run(cell, 5 * 2 ** 31 + 3, 1.0, False, "cpu",
                       time.perf_counter(), time.perf_counter,
                       log=lambda s: None)


def _h_band_dropped(monkeypatch):
    """The PNCA decoder attends over all the memory, not its band."""
    from toolbox_for_asr_and_tts_tpu_torch.models import sambert
    scan = sambert._pnca_scan

    def unbanded(pnca, memory, mask, cfg):
        return scan(pnca, memory, mask, dataclasses.replace(cfg, h_band=-1))
    monkeypatch.setattr(sambert, "_pnca_scan", unbanded)


def _step_zeroed(monkeypatch):
    """One decoder step's output (its r frames) zeroed."""
    from toolbox_for_asr_and_tts_tpu_torch.models import sambert
    scan = sambert._pnca_scan

    def zeroed(pnca, memory, mask, cfg):
        mel = scan(pnca, memory, mask, cfg).clone()
        r = cfg.outputs_per_step
        mel[:, 2 * r:3 * r] = 0.0
        return mel
    monkeypatch.setattr(sambert, "_pnca_scan", zeroed)


@pytest.mark.parametrize("fault", [_h_band_dropped, _step_zeroed],
                         ids=["h_band_dropped", "step_zeroed"])
def test_a_fault_fails_the_check(monkeypatch, fault):
    fault(monkeypatch)
    out = run()
    assert not out["correct"], out["checks"]
    assert out["checks"]["pcm_gap_lsb"]["value"] > \
        out["checks"]["pcm_gap_lsb"]["limit"]


def test_the_sound_program_passes():
    out = run()
    assert out["correct"], out["checks"]
