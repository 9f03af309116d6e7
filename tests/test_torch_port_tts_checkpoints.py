"""Loading a mounted KAN-TTS package: the port's `Synthesizer.from_model_dir`
against the reference's.

A synthetic `speech_sambert-hifigan_tts_zh-cn_16k` package in the KAN-TTS
layout (`voices/<voice>/{am,voc}/ckpt/checkpoint_*.pth` with a config.json
beside each ckpt dir, whose `embedding_dim` lies: shapes must win) is
written with `torch.save` from a random tree (converter invert mode) or
from the hand-built KAN-TTS torch module of the reference's tests
(`tests/ref_kantts_sambert.py`, BatchNorm postnet with random statistics),
the vocoder always weight-normed. Both packages load it. The configs must
be equal, and the trees leaf for leaf except Sambert's framework-only NAR
decoder (`decoder.*`, `mel_out.*`), which real checkpoints lack and each
package keeps from its own random draw. Outputs in PNCA mode: durations
and mel lengths exactly, mel within 1e-5 of its largest magnitude, PCM
within 1 LSB. Then the caches (the port's `.torch.npz` serves alone, the
reference's `.jax.npz` is ignored), the package scan and the configs.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.models import hifigan as JH  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import sambert as JS  # noqa: E402
from toolbox_for_asr_and_tts_tpu.runtime import checkpoints as jckpt  # noqa: E402
from toolbox_for_asr_and_tts_tpu.tts.text_frontend import LingVocab  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import hifigan as TH  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import sambert as TS  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ckpt  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import (  # noqa: E402
    Synthesizer, scan_tts_package)

ACFG = JS.SambertConfig(
    vocab_size=len(LingVocab.default()), n_speakers=4, d_model=32, n_heads=2,
    ffn_dim=64, encoder_layers=1, var_channels=32, postnet_channels=32,
    postnet_layers=3, pnca_layers=2, prenet_units=24)
VCFG = JH.HifiGanConfig(
    upsample_initial_channel=32, upsample_rates=(5, 5, 4, 2),
    upsample_kernels=(11, 11, 8, 4), resblock_kernels=(3,),
    resblock_dilations=((1, 3),))
VOICE = "zhitian_emo"
AM = f"voices/{VOICE}/am/ckpt/checkpoint_2400000.pth"
VOC = f"voices/{VOICE}/voc/ckpt/checkpoint_2400000.pth"
SEGMENTS = ["今天天气很好。", "请按时吃药，多休息。"]
REL = 1e-5


def _save(sd, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: torch.from_numpy(np.array(v, np.float32, copy=True))
                for k, v in sd.items()}, path)


def _weight_normed(sd):
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and np.ndim(v) >= 2:
            v = np.asarray(v, np.float32)
            g = np.sqrt((v * v).sum(axis=tuple(range(1, v.ndim)),
                                    keepdims=True))
            out[k[:-len(".weight")] + ".weight_g"] = g
            out[k[:-len(".weight")] + ".weight_v"] = v
        else:
            out[k] = v
    return out


def _port_cfg(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


def am_state_dict(source, cfg=ACFG, seed=7):
    """KAN-TTS Sambert state dict: a CPU draw of the tree inverted, or the
    hand-built KAN-TTS module with BatchNorm postnet statistics drawn."""
    if source == "module":
        from ref_kantts_sambert import RefKanTtsSambert
        torch.manual_seed(seed)
        ref = RefKanTtsSambert(cfg).eval()
        with torch.no_grad():
            for m in ref.modules():
                if isinstance(m, torch.nn.BatchNorm1d):
                    m.running_mean.uniform_(-0.5, 0.5)
                    m.running_var.uniform_(0.5, 2.0)
        return {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    return jckpt.invert_to_state_dict(
        TS.init_params(torch.Generator().manual_seed(seed),
                       _port_cfg(TS.SambertConfig, cfg)),
        jckpt.sambert_rules(cfg.encoder_layers, cfg.pnca_layers,
                            cfg.postnet_layers))


def voc_state_dict(cfg=VCFG, seed=8):
    """A weight-normed HiFi-GAN generator state dict (a CPU draw)."""
    return _weight_normed(jckpt.invert_to_state_dict(
        TH.init_params(torch.Generator().manual_seed(seed),
                       _port_cfg(TH.HifiGanConfig, cfg)),
        jckpt.hifigan_rules(len(cfg.upsample_rates), len(cfg.resblock_kernels),
                            len(cfg.resblock_dilations[0]))))


def write_package(root, am_sd, voc_sd, acfg=ACFG, vcfg=VCFG):
    """The KAN-TTS layout under `root`; the am config lies about
    embedding_dim (shape-derivable) and carries what shapes cannot give."""
    root = str(root)
    _save(am_sd, os.path.join(root, AM))
    _save(voc_sd, os.path.join(root, VOC))
    with open(os.path.join(root, f"voices/{VOICE}/am/config.json"), "w",
              encoding="utf-8") as f:
        json.dump({"Model": {"KanTtsSAMBERT": {"params": {
            "embedding_dim": 999, "encoder_num_heads": acfg.n_heads,
            "outputs_per_step": acfg.outputs_per_step,
            "decoder_prenet_units": [64, acfg.prenet_units]}}}}, f)
    with open(os.path.join(root, f"voices/{VOICE}/voc/config.json"), "w",
              encoding="utf-8") as f:
        json.dump({"Model": {"Generator": {"params": {
            "upsample_rates": list(vcfg.upsample_rates),
            "resblock_dilation_sizes": [list(d)
                                        for d in vcfg.resblock_dilations]}}}},
                  f)
    return root


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    """Whole-batch grouping (set, which also spares the reference its
    dispatch probe) and no TTS_DECODER: a loaded package defaults to PNCA."""
    monkeypatch.setenv("TTS_GROUP_BY_LENGTH", "0")
    monkeypatch.setenv("TTS_MEL_GROUP", "0")
    monkeypatch.delenv("TTS_DECODER", raising=False)


def _flat(tree):
    return ckpt.flatten_params(jax.tree.map(np.asarray, tree))


def _framework_only(cfg):
    """Sambert's leaves that no KAN-TTS tensor maps onto."""
    mapped = {p for p, _ in ckpt.sambert_rules(
        cfg.encoder_layers, cfg.pnca_layers, cfg.postnet_layers)}
    leaves = ckpt.flatten_params(TS.init_params(torch.Generator(), cfg))
    return set(leaves) - mapped


def _assert_loaded_like(ours, ref):
    assert dataclasses.asdict(ours.acfg) == dataclasses.asdict(ref.acfg)
    assert dataclasses.asdict(ours.vcfg) == dataclasses.asdict(ref.vcfg)
    kept = _framework_only(ours.acfg)
    assert kept and all(k.startswith(("decoder.", "mel_out.")) for k in kept)
    got, want = ckpt.flatten_params(ours.ap), _flat(ref.ap)
    assert sorted(got) == sorted(want)
    for k in set(want) - kept:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, want = ckpt.flatten_params(ours.vp), _flat(ref.vp)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _pcm(wav):
    return np.round(np.asarray(wav, np.float64) * 32767.0).astype(np.int64)


def _close(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got, np.float64) - want).max()) \
        <= REL * scale


@pytest.mark.parametrize("source", ["invert", "module"])
def test_from_model_dir_matches_reference(tmp_path, source):
    """Geometry pinned from the shapes (not the lying config), n_heads and
    strides from the configs, BatchNorm and weight norm folded; the trees
    equal the reference's but for the named NAR leaves; PNCA synthesis of
    two segments within 1 LSB, durations equal; forward_ar's mel within
    1e-5 and its mel lengths equal."""
    from toolbox_for_asr_and_tts_tpu.tts.synthesizer import (
        Synthesizer as JSynth)
    root = write_package(tmp_path / "tts", am_state_dict(source),
                         voc_state_dict())
    ref = JSynth.from_model_dir(root)
    ours = Synthesizer.from_model_dir(root, device="cpu")
    assert ours.acfg.d_model == ACFG.d_model and ours.acfg.n_heads == 2
    assert TS.SambertConfig(**dataclasses.asdict(ACFG)) == ours.acfg
    assert TH.HifiGanConfig(**dataclasses.asdict(VCFG)) == ours.vcfg
    assert ours.decoder_mode == ref.decoder_mode == "pnca"
    _assert_loaded_like(ours, ref)
    am, voc = scan_tts_package(root, VOICE)
    for p in (am, voc):
        assert os.path.exists(p + ".torch.npz")
        assert os.path.exists(p + ".torch.cfg.json")

    rng = np.random.default_rng(3)
    l = 10
    ids = np.stack([rng.integers(0, ACFG.vocab_size, (2, l)),
                    rng.integers(0, ACFG.tone_size, (2, l)),
                    rng.integers(0, ACFG.sylfl_size, (2, l)),
                    rng.integers(0, ACFG.wseg_size, (2, l))], -1)
    arrays = (ids.astype(np.int32), np.array([10, 6], np.int32),
              np.array([0, 1], np.int32))
    want = JS.forward_ar(ref.ap, *map(jnp.asarray, arrays), ref.acfg,
                         t_mel=48)
    with torch.inference_mode():
        got = TS.forward_ar(ours.ap, *map(torch.from_numpy, arrays),
                            ours.acfg, t_mel=48)
    for k in ("durations", "mel_lens"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    _close(got["mel"].numpy(), want["mel"])

    wavs, durs = ours.synthesize_segments(SEGMENTS, VOICE)
    jwavs, jdurs = ref.synthesize_segments(SEGMENTS, VOICE)
    assert durs == jdurs and all(d > 0 for d in durs)
    for a, b in zip(wavs, jwavs):
        assert len(a) == len(b) and len(a) % VCFG.hop_length == 0
        assert np.abs(_pcm(a) - _pcm(b)).max() <= 1


def test_cache_serves_alone_and_ignores_the_reference_cache(tmp_path):
    """With the checkpoints deleted, the port loads from its own
    `.torch.npz` caches, equal to the first load; a `.jax.npz` beside them
    (zeroed here) is never read; a package holding only the reference's
    caches has no checkpoint pair for the port."""
    from toolbox_for_asr_and_tts_tpu.tts.synthesizer import (
        Synthesizer as JSynth)
    root = write_package(tmp_path / "tts", am_state_dict("invert"),
                         voc_state_dict())
    first = Synthesizer.from_model_dir(root, device="cpu")
    JSynth.from_model_dir(root)
    am, voc = scan_tts_package(root, VOICE)
    for p in (am, voc):
        with np.load(p + ".jax.npz") as z:
            zeros = {k: np.zeros_like(z[k]) for k in z.files}
        np.savez(p + ".jax.npz", **zeros)
        os.unlink(p)
    assert scan_tts_package(root, VOICE) == (am, voc)
    again = Synthesizer.from_model_dir(root, device="cpu")
    assert again.acfg == first.acfg and again.vcfg == first.vcfg
    for a, b in ((again.ap, first.ap), (again.vp, first.vp)):
        fa, fb = ckpt.flatten_params(a), ckpt.flatten_params(b)
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    for p in (am, voc):
        os.unlink(p + ".torch.npz")
    assert scan_tts_package(root, VOICE) == (None, None)
    with pytest.raises(FileNotFoundError):
        Synthesizer.from_model_dir(root, device="cpu")


def test_stale_cache_is_reconverted(tmp_path):
    """A checkpoint newer than its `.torch.npz` is converted again."""
    root = write_package(tmp_path / "tts", am_state_dict("invert"),
                         voc_state_dict())
    Synthesizer.from_model_dir(root, device="cpu")
    second = voc_state_dict(seed=9)
    _save(second, os.path.join(root, VOC))
    cache = os.path.join(root, VOC) + ".torch.npz"
    os.utime(cache, (1_000_000, 1_000_000))
    os.utime(os.path.join(root, VOC), (2_000_000, 2_000_000))
    synth = Synthesizer.from_model_dir(root, device="cpu")
    want = ckpt.fold_weight_norm(second)["conv_pre.weight"]
    np.testing.assert_allclose(synth.vp["conv_pre"]["w"].numpy(), want,
                               rtol=1e-6, atol=1e-7)


def test_scan_prefers_voice_and_latest_step(tmp_path):
    root = write_package(tmp_path / "tts", am_state_dict("invert"),
                         voc_state_dict())
    _save({"x": np.zeros(1, np.float32)},
          os.path.join(root, f"voices/{VOICE}/am/ckpt/checkpoint_100.pth"))
    _save({"x": np.zeros(1, np.float32)}, os.path.join(
        root, "voices/zhibei_emo/am/ckpt/checkpoint_999999999.pth"))
    am, voc = scan_tts_package(root, VOICE)
    assert am == os.path.join(root, AM) and voc == os.path.join(root, VOC)


def test_from_model_dir_requires_both_checkpoints(tmp_path):
    with pytest.raises(FileNotFoundError):
        Synthesizer.from_model_dir(str(tmp_path), device="cpu")
    _save(voc_state_dict(), os.path.join(str(tmp_path), VOC))
    with pytest.raises(FileNotFoundError, match="am=None"):
        Synthesizer.from_model_dir(str(tmp_path), device="cpu")


def test_tts_decoder_env_is_kept(tmp_path, monkeypatch):
    root = write_package(tmp_path / "tts", am_state_dict("invert"),
                         voc_state_dict())
    monkeypatch.setenv("TTS_DECODER", "nar")
    assert Synthesizer.from_model_dir(root, device="cpu").decoder_mode == "nar"


CONFIGS = [
    {},
    {"Model": {"KanTtsSAMBERT": {"params": {
        "embedding_dim": 128, "encoder_num_heads": 8, "encoder_num_layers": 6,
        "decoder_num_layers": 4, "num_mels": 82, "outputs_per_step": 2,
        "decoder_prenet_units": [256, 128], "postnet_num_layers": 3,
        "predictor_kernel_size": 5, "speaker_units": 12}}}},
    {"model": {"am": {"d_model": 64, "n_heads": 2, "postnet_kernel": 3},
               "vocoder": {"upsample_rates": [8, 8, 2, 2],
                           "upsample_kernel_sizes": [16, 16, 4, 4],
                           "resblock_kernel_sizes": [3, 7],
                           "resblock_dilation_sizes": [[1, 3], [1, 3]],
                           "upsample_initial_channel": 256}}},
]


@pytest.mark.parametrize("conf", CONFIGS, ids=["empty", "kantts", "nested"])
def test_configs_from_package_match_reference(conf):
    got = TS.SambertConfig.from_kantts(conf)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JS.SambertConfig.from_kantts(conf))
    got = TH.HifiGanConfig.from_config(conf)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JH.HifiGanConfig.from_config(conf))
