"""The Sambert + HiFi-GAN family's configurations (those whose `reference`
is `portbench/reference/sambert_hifigan.py`) are the program's: field for
field the port's `SambertConfig` and `HifiGanConfig`, hop 200, the
published KAN-TTS widths where the port has a counterpart, the service's
default `TTSConfig`; and the weights the driver draws calibrate the
durations."""
import dataclasses
import json
import math
import os

import pytest

from conftest import ROOT

from portbench import harness

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CONFIGS = [c for c in (json.load(open(os.path.join(ROOT, e["file"])))
                       for e in BENCH["configs"])
           if harness.family_name(c) == "sambert_hifigan"]
TINY = harness.load_family("sambert_hifigan").TINY
DRIVER = harness.load_module(os.path.join(ROOT, "portbench", "drivers",
                                          "tts.py"), "portbench_driver_tts")


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c["name"] for c in CONFIGS])
def test_configs_are_the_programs(cfg):
    acfg, vcfg = DRIVER.configs(cfg)
    assert dataclasses.asdict(acfg) == cfg["sambert"]
    got = json.loads(json.dumps(dataclasses.asdict(vcfg)))
    assert got == cfg["hifigan"]
    assert vcfg.hop_length == 200
    pub = cfg["published"]
    assert (acfg.d_model, acfg.n_heads, acfg.ffn_dim, acfg.encoder_layers) \
        == (pub["encoder_num_units"], pub["encoder_num_heads"],
            pub["encoder_ffn_inner_dim"], pub["encoder_num_layers"])
    assert (acfg.pnca_layers, acfg.prenet_units, acfg.outputs_per_step,
            acfg.n_mels) == (pub["decoder_num_layers"],
                             pub["decoder_prenet_units"][-1],
                             pub["outputs_per_step"], pub["num_mels"])
    assert (pub["decoder_num_units"], pub["decoder_num_heads"],
            pub["decoder_ffn_inner_dim"]) == (acfg.d_model, acfg.n_heads,
                                              acfg.ffn_dim)
    assert (vcfg.upsample_initial_channel, list(vcfg.upsample_rates),
            list(vcfg.upsample_kernels), list(vcfg.resblock_kernels)) == \
        (pub["channels"], pub["upsample_scales"],
         pub["upsample_kernal_sizes"], pub["resblock_kernel_sizes"])
    assert vcfg.hop_length == pub["hop_length"]
    assert cfg["reduced"] == []


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c["name"] for c in CONFIGS])
def test_service_is_the_default_tts_config(cfg):
    from toolbox_for_asr_and_tts_tpu_torch.runtime.config import TTSConfig
    default = TTSConfig()
    svc = cfg["service"]
    for k, v in svc.items():
        if hasattr(default, k):
            assert getattr(default, k) == v, k
    assert svc["decoder_mode"] == "pnca" and svc["two_phase"]


def test_weights_calibrate_the_durations():
    """The duration bias puts the median duration before rounding over
    the calibration segments at the configuration's frames per phone, a
    seed draws the same tree twice, and another seed draws the same timing
    subtrees (from the timing seed) and other weights elsewhere."""
    import torch
    from portbench.reference import sambert_hifigan as ref
    cfg = json.loads(json.dumps(CONFIGS[0]))
    for group, keys in TINY.items():
        cfg[group].update(keys)
    drv = DRIVER.Driver(cfg, {"params": dict(
        json.load(open(os.path.join(ROOT, "portbench/traffic/"
                                    "tts-paragraph.json")))["params"],
        paragraphs=2), "check": {}}, 7, "cpu")
    ap, vp = DRIVER.make_params(cfg, 7, "cpu", drv.calibration, 5)
    pre = torch.cat([ref.encode(ap, cfg["sambert"], torch.as_tensor(x), 0,
                                len(x))[1] for x in drv.calibration])
    median = float((torch.exp(pre) - 1).median())
    assert math.isclose(median, cfg["duration_bias"]["frames_per_phone"],
                        rel_tol=1e-4)
    again, _ = DRIVER.make_params(cfg, 7, "cpu", drv.calibration, 5)
    assert torch.equal(ap["duration"]["out"]["b"],
                       again["duration"]["out"]["b"])
    assert torch.equal(ap["pnca"]["layers"][0]["q"]["w"],
                       again["pnca"]["layers"][0]["q"]["w"])
    other, _ = DRIVER.make_params(cfg, 8, "cpu", drv.calibration, 5)
    for key in DRIVER.TIMING:
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(ap[key]), _leaves(other[key]))), key
    assert not torch.equal(ap["pnca"]["layers"][0]["q"]["w"],
                           other["pnca"]["layers"][0]["q"]["w"])
    assert not torch.equal(ap["pitch"]["out"]["w"], other["pitch"]["out"]["w"])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
