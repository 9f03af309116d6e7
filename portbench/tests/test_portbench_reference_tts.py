"""The plain reference of Sambert + HiFi-GAN against the port, on the CPU at
the family's tiny geometry with seeded weights, stage by stage: durations
and mel lengths exact; the PNCA mel (the port's cached, static-mask scan
against the reference's uncached loop) and HiFi-GAN alone within 1e-5 of
their largest magnitude (float32 sums in another order); a whole job's WAV
through the service within 1 LSB."""
import os
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_cell

from portbench import check_tts, harness
from portbench.reference import sambert_hifigan as ref

DRIVER = harness.load_module(os.path.join(ROOT, "portbench", "drivers",
                                          "tts.py"), "portbench_driver_tts")
REL = 1e-5
MARGIN = 1e-4       # least distance of a duration from k + 0.5
SMALL = dict(paragraphs=3, chars={"median": 30, "sigma": 0.5, "min": 12,
                                  "max": 60},
             trace={"after_s": 0.2, "seconds": 0.3})


def _tiny_config():
    cfg = tiny_cell("tts-paragraph").config
    return cfg, DRIVER.configs(cfg)


def _close(got, want):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= REL * scale, (err, scale)


@pytest.fixture(scope="module")
def trees():
    _, (acfg, vcfg) = _tiny_config()
    from toolbox_for_asr_and_tts_tpu_torch.models import hifigan, sambert
    g = torch.Generator().manual_seed(3)
    return sambert.init_params(g, acfg), hifigan.init_params(g, vcfg)


def _rows(l=16, lens=(16, 11, 5), seed=4):
    cfg, (acfg, _) = _tiny_config()
    rng = np.random.default_rng(seed)
    sizes = (acfg.vocab_size, acfg.tone_size, acfg.sylfl_size,
             acfg.wseg_size)
    ids = np.stack([rng.integers(0, n, (len(lens), l)) for n in sizes], -1)
    return ids.astype(np.int32), np.asarray(lens, np.int32)


def test_acoustic_model_matches(trees):
    """Durations, mel lengths and the postnet's mel of the port's
    `forward_ar` on a padded batch against the reference row by row."""
    from toolbox_for_asr_and_tts_tpu_torch.models import sambert
    cfg, (acfg, _) = _tiny_config()
    ap, _ = trees
    ids, lens = _rows()
    l, t_mel = ids.shape[1], 96
    with torch.inference_mode():
        got = sambert.forward_ar(ap, torch.from_numpy(ids),
                                 torch.from_numpy(lens),
                                 torch.zeros(len(lens), dtype=torch.int32),
                                 acfg, t_mel=t_mel)
        for i, n in enumerate(lens):
            want = ref.acoustic(ap, cfg["sambert"],
                                torch.from_numpy(ids[i, :n]).long(), 0, l,
                                t_mel)
            assert not check_tts.fragile(want["before_rounding"], MARGIN,
                                         acfg.max_duration)
            assert got["durations"][i, :n].tolist() == \
                want["durations"].tolist()
            assert int(got["mel_lens"][i]) == want["mel_len"]
            assert got["mel"].shape[1] == want["mel"].shape[0] == 96
            _close(got["mel"][i], want["mel"])


def test_vocoder_matches(trees):
    from toolbox_for_asr_and_tts_tpu_torch.models import hifigan
    cfg, (_, vcfg) = _tiny_config()
    _, vp = trees
    mel = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 13, vcfg.n_mels)).astype(np.float32))
    with torch.inference_mode():
        got = hifigan.forward(vp, mel, vcfg)
        for i in range(2):
            want = ref.vocoder(vp, cfg["hifigan"], mel[i])
            assert want.shape == (13 * 200,)
            _close(got[i], want)


def test_assemble_is_the_services_concatenation():
    from toolbox_for_asr_and_tts_tpu_torch.tts.concat import concat_segments
    rng = np.random.default_rng(6)
    segs = [rng.uniform(-1, 1, n).astype(np.float32)
            for n in (3000, 500, 4000, 2000)]
    pauses = [120, 200, 120]
    np.testing.assert_array_equal(ref.assemble(segs, pauses, 16000, 60),
                                  concat_segments(segs, pauses, 16000, 60))


def test_a_served_job_is_within_one_lsb():
    """Jobs through `TTSJobManager` (2 workers, the streamed path) against
    the reference's WAV of the same text."""
    cell = tiny_cell("tts-paragraph", **SMALL)
    cell.config["duration_bias"]["calibration_segments"] = 4
    out = harness.run(cell, 2 ** 31 + 11, 1.0, False, "cpu",
                      time.perf_counter(), time.perf_counter,
                      log=lambda s: None)
    assert out["correct"] and out["attempted"] > 0
    assert out["checks"]["dur_changed"]["value"] == 0
    assert out["checks"]["pcm_gap_lsb"]["value"] <= 1
