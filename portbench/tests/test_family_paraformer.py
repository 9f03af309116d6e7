"""The Paraformer family's configurations (those whose `reference` is
`portbench/reference/paraformer.py`) are the program's: the port's
Paraformer-large, the FunASR frontend and the streaming geometry, and the
benchmark's weights have the program's parameter tree."""
import json
import os

import pytest

from conftest import ROOT

from portbench import harness

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CONFIGS = [c for c in (json.load(open(os.path.join(ROOT, e["file"])))
                       for e in BENCH["configs"])
           if harness.family_name(c) == "paraformer"]
TINY = harness.load_family("paraformer").TINY


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c["name"] for c in CONFIGS])
def test_configs_are_the_programs(cfg):
    """The configuration holds the port's Paraformer-large, FunASR frontend
    and streaming geometry (the hub takes `OnlineConfig()` as it is)."""
    import dataclasses
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import \
        ParaformerConfig
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import \
        OnlineConfig
    from toolbox_for_asr_and_tts_tpu_torch.ops.frontend import FrontendConfig
    want = dataclasses.asdict(ParaformerConfig())
    assert all(want[k] == v for k, v in cfg["model"].items())
    fe = FrontendConfig()
    got = cfg["frontend"]
    assert (got["sample_rate"], got["frame_length"], got["frame_shift"],
            got["n_mels"], got["preemphasis"], got["low_freq"]) == \
        (fe.sample_rate, fe.frame_length, fe.frame_shift, fe.n_mels,
         fe.preemphasis, fe.low_freq)
    if cfg["online"]:
        o = dataclasses.asdict(OnlineConfig())
        assert all(o[k] == v for k, v in cfg["online"].items())


def test_weights_have_the_programs_tree():
    import torch
    from portbench import weights
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer
    cfg = json.load(open(os.path.join(
        ROOT, "portbench/configs/paraformer-large-zh-offline.json")))
    m = dict(cfg["model"], **TINY["model"])
    ours = weights.leaves_of(weights.make_params(m, 5, "cpu"))
    theirs = weights.leaves_of(paraformer.init_params(
        paraformer.ParaformerConfig(**m), torch.Generator().manual_seed(0)))
    assert [(k, tuple(v.shape)) for k, v in ours] == \
        [(k, tuple(v.shape)) for k, v in theirs]
    again = weights.leaves_of(weights.make_params(m, 5, "cpu"))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(ours, again))
