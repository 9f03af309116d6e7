"""Checkpoint loading of the port's ASR families against the reference's.

FunASR-named state dicts, made from random trees with the converter's
invert mode or taken from the hand-built FunASR torch modules of the
reference's tests (`TorchParaformer`, `TorchFSMN`, `TorchKwsFSMN`,
`TorchCAMPPlus`), are `torch.save`d into a temporary model directory (with
a FunASR-style config.json, token list and am.mvn) and loaded through
BOTH packages' `from_model_dir`. The trees must be equal leaf for leaf and
the outputs agree: integer outputs (token ids, fire frames, VAD decisions,
punctuation ids) exactly, Paraformer logits within 1e-4, VAD posteriors
and KWS scores within 1e-5, CAM++ embeddings within 1e-4. Then the
converter's own cases (stale-cache guard, read-only directory, the
reference's cache beside the port's, unparseable configs, BiCIF detection
both ways) and the `convert_checkpoint --diff` and `check_cache` tools.
"""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.asr.recognizer import Recognizer as JRecognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu.asr.speaker import SpeakerVerifier as JVerifier  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import campplus as jcp  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import ct_transformer as jct  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import fsmn_vad as jfv  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import kws_ctc as jkws  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.runtime import checkpoints as jckpt  # noqa: E402
from toolbox_for_asr_and_tts_tpu.runtime.bucketing import Bucketer as JBucketer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import campplus as cp  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import ct_transformer as ct  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import kws_ctc as kws  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ckpt  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime.bucketing import Bucketer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tools import check_cache  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tools import convert_checkpoint as cc  # noqa: E402

SR = 16000
BUCKETS = (SR, 2 * SR)
# Paraformer at the recognizer's frontend width (80 mel x LFR 7)
PARA = dict(input_dim=560, d_model=16, n_heads=2, ffn_dim=32,
            encoder_layers=2, decoder_layers=1, vocab_size=32)
VAD = dict(input_dim=400, input_affine_dim=12, linear_dim=16, proj_dim=8,
           fsmn_layers=2, lorder=5, output_affine_dim=12, output_dim=6)
PUNC = dict(vocab_size=64, num_layers=2, d_model=16, embed_dim=24, n_heads=2,
            ffn_dim=32)
KWS = dict(input_dim=240, input_affine_dim=12, hidden_dim=16, proj_dim=8,
           num_layers=2, lorder=4, rorder=1, output_affine_dim=12,
           vocab_size=32)
CAMPP = dict(feat_dim=80, fcm_channels=4, init_channels=8, growth_rate=4,
             bn_size=2, block_layers=(2, 2), block_dilations=(1, 2),
             embedding_size=12, cam_seg_len=10)


# ---------------------------------------------------------------- helpers
def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _save(sd, path):
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    torch.save({k: torch.from_numpy(np.array(v, np.float32, copy=True))
                for k, v in sd.items()}, str(path))


def _module_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def _assert_trees_equal(ref_tree, port_tree):
    """Leaf for leaf, exactly: both packages convert the same tensors."""
    want = ckpt.flatten_params(_np_tree(ref_tree))
    got = ckpt.flatten_params(port_tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _assert_cfg_equal(port_cfg, ref_cfg):
    """The port's config equals the reference's, field for field."""
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)


def _write_mvn(path, dim, seed):
    rng = np.random.default_rng(seed)
    means = -rng.uniform(5, 12, dim).astype(np.float32)
    istd = rng.uniform(0.1, 0.5, dim).astype(np.float32)
    fmt = " ".join
    text = (f"<Nnet>\n<Splice> {dim} {dim}\n[ 0 ]\n<AddShift> {dim} {dim}\n"
            f"<LearnRateCoef> 0 [ {fmt(f'{v:.6f}' for v in means)} ]\n"
            f"<Rescale> {dim} {dim}\n"
            f"<LearnRateCoef> 0 [ {fmt(f'{v:.6f}' for v in istd)} ]\n"
            "</Nnet>\n")
    path.write_text(text, encoding="utf-8")


def _tokens(n):
    return (["<blank>", "<s>", "</s>"]
            + [chr(0x4E00 + i) for i in range(n - 4)] + ["<unk>"])


def _wav(secs, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * secs)) / SR
    return (0.3 * np.sin(2 * np.pi * (220 + 40 * seed) * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


ROWS = [_wav(1.0, 0), _wav(0.7, 1), _wav(0.4, 2)]


# ------------------------------------------------------------- Paraformer
def _paraformer_dir(root, sd, cfg,
                    name="speech_paraformer-large_asr_nat-zh-cn-16k-common-"
                         "vocab8404"):
    d = root / name
    _save(sd, d / "model.pt")
    (d / "config.json").write_text(json.dumps({
        "encoder_conf": {"output_size": cfg.d_model,
                         "attention_heads": cfg.n_heads,
                         "linear_units": cfg.ffn_dim,
                         "num_blocks": cfg.encoder_layers},
        "decoder_conf": {"num_blocks": cfg.decoder_layers},
        "frontend_conf": {"n_mels": 80, "lfr_m": 7, "lfr_n": 6}}),
        encoding="utf-8")
    (d / "tokens.json").write_text(
        json.dumps(_tokens(cfg.vocab_size), ensure_ascii=False),
        encoding="utf-8")
    _write_mvn(d / "am.mvn", cfg.input_dim, seed=5)
    return str(d)


def _paraformer_sd(source, bicif=False):
    jcfg = jpf.ParaformerConfig(**PARA, bicif=bicif)
    if source == "module":
        from test_full_layer_parity import TorchParaformer
        torch.manual_seed(3)
        return _module_sd(TorchParaformer(jcfg).eval()), jcfg
    params = pf.init_params(pf.ParaformerConfig(**PARA, bicif=bicif),
                            torch.Generator().manual_seed(3))
    rules = jckpt.paraformer_rules(jcfg.encoder_layers, jcfg.decoder_layers,
                                   bicif=bicif)
    return jckpt.invert_to_state_dict(params, rules), jcfg


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert g.text == w.text
        assert g.timestamps_ms == w.timestamps_ms
        assert [tuple(s) for s in g.timestamp] == \
            [tuple(s) for s in w.timestamp]


@pytest.mark.parametrize("source", ["invert", "module"])
def test_recognizer_from_model_dir_matches_reference(tmp_path, source):
    """The recognizer loaded from a Paraformer directory: config, vocab,
    CMVN and tree equal to the reference's; logits within 1e-4 and token
    ids, fire frames and transcripts exactly equal."""
    sd, jcfg = _paraformer_sd(source)
    d = _paraformer_dir(tmp_path, sd, jcfg)
    ref = JRecognizer.from_model_dir(d, bucketer=JBucketer(BUCKETS),
                                     use_mesh=False)
    ours = Recognizer.from_model_dir(d, bucketer=Bucketer(BUCKETS),
                                     device="cpu")
    _assert_cfg_equal(ours.cfg, ref.cfg)
    assert not ours.cfg.bicif and not ours.has_bicif
    assert ours.tokenizer.tokens == ref.tokenizer.tokens
    for a, b in zip(ours.cmvn, ref.cmvn):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_trees_equal(ref.params, ours.params)
    assert os.path.exists(os.path.join(d, "torch_params.npz"))

    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 30, jcfg.input_dim)).astype(np.float32)
    lens = np.array([30, 19], np.int32)
    k_max = pf.max_tokens_for(30)
    got = pf.forward(ours.params, torch.from_numpy(feats),
                     torch.from_numpy(lens), k_max, ours.cfg)
    want = jpf.forward(ref.params, jnp.asarray(feats), jnp.asarray(lens),
                       k_max, ref.cfg)
    for key in ("token_count", "tokens", "fire_frame"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=1e-4,
                               atol=1e-4)
    assert int(got["token_count"].max()) > 0, "no token fired"
    _same_results(ours.transcribe(ROWS), ref.transcribe(ROWS))


def test_recognizer_module_tree_encodes_as_the_module():
    """The port's encoder on a tree converted from `TorchParaformer`'s
    state dict computes what the FunASR-named module computes."""
    from toolbox_for_asr_and_tts_tpu_torch.ops import nn
    sd, jcfg = _paraformer_sd("module")
    from test_full_layer_parity import TorchParaformer
    torch.manual_seed(3)
    tmodel = TorchParaformer(jcfg).eval()
    cfg = pf.ParaformerConfig(**PARA)
    params = ckpt.convert_state_dict(
        sd, ckpt.paraformer_rules(cfg.encoder_layers, cfg.decoder_layers),
        ckpt.shape_template(lambda g: pf.init_params(cfg, g)))
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import (
        params_from_numpy)
    params = params_from_numpy(params, "cpu")
    rng = np.random.default_rng(1)
    feats = torch.from_numpy(
        rng.standard_normal((2, 20, cfg.input_dim)).astype(np.float32) * 0.5)
    lens = torch.tensor([20, 14])
    mask = nn.length_mask(lens, 20)
    with torch.no_grad():
        want = tmodel.encode(feats, mask.float()).numpy()
    got = pf.encode(params, feats, mask, cfg).numpy()
    valid = mask.numpy()[..., None]
    np.testing.assert_allclose(got * valid, want * valid, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("bicif", [True, False])
def test_bicif_detection_matches_reference(tmp_path, bicif):
    """A checkpoint with the BiCIF timestamp predictor loads as BiCIF and
    one without it as plain, in both packages, from the tensors alone; the
    cached tree loads the same way the second time."""
    sd, jcfg = _paraformer_sd("invert", bicif=bicif)
    d = _paraformer_dir(tmp_path, sd, jcfg)
    ref = JRecognizer.from_model_dir(d, use_mesh=False)
    for _ in range(2):    # converted, then from the cache
        ours = Recognizer.from_model_dir(d, device="cpu")
        assert ours.cfg.bicif is bicif and ours.has_bicif is bicif
        assert ref.cfg.bicif is bicif
        _assert_trees_equal(ref.params, ours.params)


# --------------------------------------------------------------- FSMN-VAD
def _vad_dir(root, sd, cfg):
    d = root / "speech_fsmn_vad_zh-cn-16k-common-pytorch"
    _save(sd, d / "model.pt")
    enc = {k: getattr(cfg, k) for k in (
        "input_dim", "input_affine_dim", "linear_dim", "proj_dim", "lorder",
        "rorder", "output_affine_dim", "output_dim")}
    enc["fsmn_layers"] = cfg.fsmn_layers
    (d / "config.json").write_text(json.dumps({
        "encoder_conf": enc, "model_conf": {"sil_pdf_ids": [0, 1]}}),
        encoding="utf-8")
    _write_mvn(d / "am.mvn", cfg.input_dim, seed=6)
    return str(d)


@pytest.mark.parametrize("source", ["invert", "module"])
def test_fsmn_vad_from_model_dir_matches_reference(tmp_path, source):
    """(params, cfg, cmvn) equal to the reference's; posteriors within
    1e-5 and speech decisions exactly equal."""
    jcfg = jfv.FsmnVadConfig(**VAD)
    if source == "module":
        from test_fsmn_vad_torch_parity import TorchFSMN
        torch.manual_seed(6)
        sd = _module_sd(TorchFSMN(jcfg).eval())
    else:
        sd = jckpt.invert_to_state_dict(
            fv.init_params(fv.FsmnVadConfig(**VAD),
                           torch.Generator().manual_seed(6)),
            jckpt.fsmn_vad_rules(jcfg.fsmn_layers))
    d = _vad_dir(tmp_path, sd, jcfg)
    jparams, jcfg2, jcmvn = jfv.from_model_dir(d)
    params, cfg, cmvn = fv.from_model_dir(d, device="cpu")
    _assert_cfg_equal(cfg, jcfg2)
    assert cfg.sil_pdf_ids == (0, 1)
    for a, b in zip(cmvn, jcmvn):
        np.testing.assert_array_equal(a, b)
    _assert_trees_equal(jparams, params)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 24, cfg.input_dim)).astype(np.float32)
    got = fv.speech_prob(fv.apply(params, torch.from_numpy(feats), cfg),
                         cfg).numpy()
    want = np.asarray(jfv.speech_prob(
        jfv.apply(jparams, jnp.asarray(feats), jcfg2), jcfg2))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got > 0.5, want > 0.5)


# ---------------------------------------------------------- CT-Transformer
def _punc_dir(root, sd, cfg):
    d = root / "punc_ct-transformer_cn-en-common-vocab471067-large"
    _save(sd, d / "model.pt")
    (d / "config.json").write_text(json.dumps({
        "encoder_conf": {"attention_heads": cfg.n_heads,
                         "linear_units": cfg.ffn_dim,
                         "num_blocks": cfg.num_layers,
                         "output_size": cfg.d_model,
                         "input_size": cfg.embed_dim},
        "model_conf": {"punc_list": list(cfg.punc_list),
                       "vocab_size": cfg.vocab_size}},
        ensure_ascii=False), encoding="utf-8")
    toks = ["<unk>"] + [chr(0x4E00 + i) for i in range(cfg.vocab_size - 1)]
    (d / "tokens.json").write_text(json.dumps(toks, ensure_ascii=False),
                                   encoding="utf-8")
    return str(d)


def test_punctuator_from_model_dir_matches_reference(tmp_path):
    """Config, vocab and tree equal to the reference's; logits within 1e-5
    and punctuation ids exactly equal."""
    jcfg = jct.CTTransformerConfig(**PUNC)
    sd = jckpt.invert_to_state_dict(
        ct.init_params(ct.CTTransformerConfig(**PUNC),
                       torch.Generator().manual_seed(8)),
        jckpt.ct_transformer_rules(jcfg.num_layers))
    d = _punc_dir(tmp_path, sd, jcfg)
    ref = jct.Punctuator.from_model_dir(d)
    ours = ct.Punctuator.from_model_dir(d, device="cpu")
    _assert_cfg_equal(ours.cfg, ref.cfg)
    assert ours.vocab.tokens == ref.vocab.tokens
    _assert_trees_equal(ref.params, ours.params)
    rng = np.random.default_rng(9)
    ids = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    got = ct.forward(ours.params, torch.from_numpy(ids),
                     torch.from_numpy(lens), ours.cfg).numpy()
    want = np.asarray(jct.forward(ref.params, jnp.asarray(ids),
                                  jnp.asarray(lens), ref.cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    words = [chr(0x4E00 + int(i)) for i in rng.integers(0, 60, 23)]
    np.testing.assert_array_equal(ours.classify(words),
                                  np.asarray(ref.classify(words)))


# -------------------------------------------------------------------- KWS
def _kws_dir(root, sd, cfg):
    d = root / "speech_charctc_kws_phone-xiaohu"
    _save(sd, d / "model.pt")
    (d / "config.json").write_text(json.dumps({"encoder_conf": {
        "input_dim": cfg.input_dim, "input_affine_dim": cfg.input_affine_dim,
        "linear_dim": cfg.hidden_dim, "proj_dim": cfg.proj_dim,
        "fsmn_layers": cfg.num_layers, "lorder": cfg.lorder,
        "rorder": cfg.rorder, "output_affine_dim": cfg.output_affine_dim,
        "output_dim": cfg.vocab_size}}), encoding="utf-8")
    toks = ["<blank>", "小", "护"] + [chr(0x4E00 + i)
                                     for i in range(cfg.vocab_size - 3)]
    (d / "tokens.txt").write_text(
        "".join(f"{t} {i}\n" for i, t in enumerate(toks)), encoding="utf-8")
    return str(d)


@pytest.mark.parametrize("source", ["invert", "module"])
def test_keyword_spotter_from_model_dir_matches_reference(tmp_path, source):
    """Config, token map and tree equal to the reference's; log-posteriors
    and keyword scores within 1e-5, detections exactly equal."""
    jcfg = jkws.KwsConfig(**KWS)
    if source == "module":
        from test_kws_torch_parity import TorchKwsFSMN
        torch.manual_seed(10)
        sd = _module_sd(TorchKwsFSMN(jcfg).eval())
    else:
        sd = jckpt.invert_to_state_dict(
            kws.init_params(kws.KwsConfig(**KWS),
                            torch.Generator().manual_seed(10)),
            jckpt.kws_rules(jcfg.num_layers, jcfg.rorder))
    d = _kws_dir(tmp_path, sd, jcfg)
    ref = jkws.KeywordSpotter.from_model_dir(d, threshold=-5.0)
    ours = kws.KeywordSpotter.from_model_dir(d, threshold=-5.0, device="cpu")
    _assert_cfg_equal(ours.cfg, ref.cfg)
    assert ours.char_to_id == ref.char_to_id
    assert ours.keyword == ref.keyword == "小护"
    _assert_trees_equal(ref.params, ours.params)
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((2, 30, jcfg.input_dim)).astype(np.float32)
    got = kws.forward(ours.params, torch.from_numpy(feats), ours.cfg).numpy()
    want = np.asarray(jkws.forward(ref.params, jnp.asarray(feats), ref.cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    windows = [_wav(1.6, s) for s in range(3)]
    a, b = ours.detect_audio_batch(windows), ref.detect_audio_batch(windows)
    assert [x for x, _ in a] == [x for x, _ in b]
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ CAM++
@pytest.mark.parametrize("source", ["invert", "module"])
def test_speaker_verifier_from_model_dir_matches_reference(tmp_path, source):
    """The BatchNorm statistics convert as leaves; tree equal to the
    reference's; embeddings within 1e-4."""
    jcfg = jcp.CampPlusConfig(**CAMPP)
    if source == "module":
        from test_campplus_torch_parity import TorchCAMPPlus
        torch.manual_seed(12)
        sd = _module_sd(TorchCAMPPlus(jcfg).eval())
    else:
        sd = jckpt.invert_to_state_dict(
            cp.init_params(cp.CampPlusConfig(**CAMPP),
                           torch.Generator().manual_seed(12)),
            jckpt.campplus_rules(jcfg.block_layers))
    d = tmp_path / "speech_campplus_sv_zh-cn_16k-common"
    _save(sd, d / "model.pt")
    cfg = cp.CampPlusConfig(**CAMPP)
    ref = JVerifier.from_model_dir(str(d), cfg=jcfg)
    ours = SpeakerVerifier.from_model_dir(str(d), cfg=cfg, device="cpu")
    _assert_trees_equal(ref.params, ours.params)
    wavs = [_wav(1.3, 3), _wav(0.9, 4)]
    np.testing.assert_allclose(ours.embed(wavs), np.asarray(ref.embed(wavs)),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ converter cases
def _vad_checkpoint(tmp_path, seed=6):
    jcfg = jfv.FsmnVadConfig(**VAD)
    jparams = fv.init_params(fv.FsmnVadConfig(**VAD),
                             torch.Generator().manual_seed(seed))
    sd = jckpt.invert_to_state_dict(jparams, jckpt.fsmn_vad_rules(2))
    return _vad_dir(tmp_path, sd, jcfg), jparams


def test_stale_cache_is_reconverted(tmp_path):
    """A model.pt newer than its cache is converted again; an older one is
    served from the cache (modification times set explicitly)."""
    d, first = _vad_checkpoint(tmp_path)
    fv.from_model_dir(d, device="cpu")
    cache = os.path.join(d, "torch_params.npz")
    _, second = _vad_checkpoint(tmp_path / "other", seed=7)
    sd2 = jckpt.invert_to_state_dict(second, jckpt.fsmn_vad_rules(2))
    _save(sd2, os.path.join(d, "model.pt"))
    os.utime(os.path.join(d, "model.pt"), (1_000_000, 1_000_000))
    os.utime(cache, (2_000_000, 2_000_000))
    params, _, _ = fv.from_model_dir(d, device="cpu")
    _assert_trees_equal(first, params)          # older source: the cache
    os.utime(os.path.join(d, "model.pt"), (3_000_000, 3_000_000))
    params, _, _ = fv.from_model_dir(d, device="cpu")
    _assert_trees_equal(second, params)         # newer source: reconverted
    assert os.path.getmtime(cache) > 3_000_000 - 1   # cache rewritten


def test_legacy_torch_file_loads(tmp_path):
    """A checkpoint in torch's legacy (pre-zip) format, which cannot be
    memory-mapped, is read whole and converts to the same tree."""
    jcfg = jfv.FsmnVadConfig(**VAD)
    tree = fv.init_params(fv.FsmnVadConfig(**VAD),
                          torch.Generator().manual_seed(6))
    sd = jckpt.invert_to_state_dict(tree, jckpt.fsmn_vad_rules(2))
    d = _vad_dir(tmp_path, sd, jcfg)
    torch.save({k: torch.from_numpy(np.array(v, np.float32))
                for k, v in sd.items()}, os.path.join(d, "model.pt"),
               _use_new_zipfile_serialization=False)
    params, _, _ = fv.from_model_dir(d, device="cpu")
    _assert_trees_equal(tree, params)


def test_unwritable_cache_still_converts(tmp_path, monkeypatch, caplog):
    """A read-only model directory: the conversion succeeds, only the cache
    write is skipped, with a warning."""
    d, jparams = _vad_checkpoint(tmp_path)

    def refuse(path, params):
        raise PermissionError(13, "Read-only file system", path)
    monkeypatch.setattr(ckpt, "save_converted", refuse)
    with caplog.at_level("WARNING", logger="toolbox.checkpoints"):
        params, _, _ = fv.from_model_dir(d, device="cpu")
    _assert_trees_equal(jparams, params)
    assert not os.path.exists(os.path.join(d, "torch_params.npz"))
    assert "could not write converted cache" in caplog.text


def test_reference_cache_beside_is_ignored(tmp_path):
    """The reference's `jax_params.npz` in the same directory (here a
    corrupt one of zeros) is neither read nor overwritten."""
    d, jparams = _vad_checkpoint(tmp_path)
    bogus = {k: np.zeros_like(v) for k, v in
             ckpt.flatten_params(_np_tree(jparams)).items()}
    np.savez(os.path.join(d, "jax_params.npz"), **bogus)
    before = os.path.getmtime(os.path.join(d, "jax_params.npz"))
    for _ in range(2):
        params, _, _ = fv.from_model_dir(d, device="cpu")
        _assert_trees_equal(jparams, params)
    assert os.path.getmtime(os.path.join(d, "jax_params.npz")) == before
    with np.load(os.path.join(d, "jax_params.npz")) as z:
        assert not any(z[k].any() for k in z.files)


def test_unparseable_config_raises(tmp_path, monkeypatch):
    """A config.yaml that does not parse, or that cannot be read without
    PyYAML, raises with its path, unless a config.json beside it parses."""
    d = tmp_path / "m"
    d.mkdir()
    (d / "config.yaml").write_text("encoder_conf: [unclosed\n",
                                   encoding="utf-8")
    with pytest.raises(ValueError, match="config.yaml"):
        ckpt.load_model_config(str(d))
    (d / "config.json").write_text('{"encoder_conf": {"proj_dim": 8}}',
                                   encoding="utf-8")
    assert ckpt.load_model_config(str(d)) == {"encoder_conf": {"proj_dim": 8}}
    (d / "config.json").write_text("{not json", encoding="utf-8")
    with pytest.raises(ValueError, match="config.yaml"):
        ckpt.load_model_config(str(d))
    (d / "config.json").unlink()
    (d / "config.yaml").write_text("encoder_conf: {proj_dim: 8}\n",
                                   encoding="utf-8")
    assert ckpt.load_model_config(str(d)) == {"encoder_conf": {"proj_dim": 8}}
    monkeypatch.setitem(sys.modules, "yaml", None)   # no PyYAML installed
    with pytest.raises(ValueError, match="config.yaml: ModuleNotFoundError"):
        ckpt.load_model_config(str(d))
    with pytest.raises(ValueError, match="config.yaml"):
        fv.from_model_dir(str(d), device="cpu")
    assert ckpt.load_model_config(str(tmp_path)) == {}


def test_missing_and_misshapen_tensors_raise():
    """KeyError for a missing tensor, ValueError for a shape that disagrees
    with the template (the two that BiCIF detection relies on)."""
    cfg = pf.ParaformerConfig(**PARA)
    template = ckpt.shape_template(lambda g: pf.init_params(cfg, g))
    rules = ckpt.paraformer_rules(cfg.encoder_layers, cfg.decoder_layers)
    sd = ckpt.invert_to_state_dict(
        pf.init_params(cfg, torch.Generator().manual_seed(0)), rules)
    bad = dict(sd, **{"decoder.output_layer.weight": np.zeros((7, 7))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.convert_state_dict(bad, rules, template)
    del bad["decoder.output_layer.weight"]
    with pytest.raises(KeyError):
        ckpt.convert_state_dict(bad, rules, template)
    with pytest.raises(FileNotFoundError):
        ckpt.convert_or_load_cached("/nonexistent-model-dir", template, rules)


def test_shape_template_allocates_nothing():
    """The meta-device template of the full-width CT-Transformer (a
    471067 x 256 embedding) has the reference tree's paths and shapes."""
    cfg = ct.CTTransformerConfig()
    tree = ckpt.shape_template(lambda g: ct.init_params(cfg, g))
    leaves = []
    jax.tree.map(leaves.append, tree,
                 is_leaf=lambda x: isinstance(x, torch.Tensor))
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert tuple(tree["embed"]["table"].shape) == (471067, 256)
    small = jct.CTTransformerConfig(**PUNC)
    want = ckpt.flatten_params(_np_tree(
        jct.init_params(jax.random.PRNGKey(0), small)))
    got = ckpt.shape_template(lambda g: ct.init_params(
        ct.CTTransformerConfig(**PUNC), g))
    flat = {}

    def walk(t, prefix=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{prefix}{i}.")
        elif t is not None:
            flat[prefix[:-1]] = tuple(t.shape)
    walk(got)
    assert flat == {k: tuple(v.shape) for k, v in want.items()}


# ---------------------------------------------------------------- tools
TINY = {
    "paraformer": PARA,
    "fsmn_vad": VAD,
    "sambert": {"vocab_size": 32, "n_speakers": 2, "d_model": 16,
                "n_heads": 2, "ffn_dim": 32, "encoder_layers": 2,
                "decoder_layers": 1, "pnca_layers": 2, "postnet_layers": 2,
                "var_channels": 16},
    "hifigan": {"n_mels": 8, "upsample_initial_channel": 16,
                "upsample_rates": [2, 2], "upsample_kernels": [4, 4],
                "resblock_kernels": [3], "resblock_dilations": [[1, 2]]},
    "campplus": {**CAMPP, "block_layers": [2, 2], "block_dilations": [1, 2]},
    "punc": PUNC,
    "kws": KWS,
}


@pytest.mark.parametrize("family", sorted(TINY))
def test_cli_convert_and_diff(family, tmp_path, capsys, monkeypatch):
    """`convert_checkpoint --family X --diff --config-json` on a synthetic
    checkpoint (HiFi-GAN's weight-normed): the port's cache written and
    holding the checkpoint's tensors, zero unmapped tensors, an exact round
    trip."""
    overrides = TINY[family]
    template, rules, kwargs = cc._family_setup(family, overrides)
    sd = ckpt.invert_to_state_dict(template, rules)
    if kwargs.get("pre_transform") is ckpt.fold_weight_norm:
        from test_torch_port_tts_checkpoints import _weight_normed
        sd = _weight_normed(sd)
    model_dir = tmp_path / family
    _save(sd, model_dir / "model.pt")
    cfg_path = tmp_path / f"{family}.json"
    cfg_path.write_text(json.dumps(overrides))
    monkeypatch.setattr(sys, "argv", [
        "convert_checkpoint", "--family", family,
        "--model-dir", str(model_dir), "--diff",
        "--config-json", str(cfg_path)])
    cc.main()
    out = capsys.readouterr().out.strip().splitlines()
    convert_report, diff_report = json.loads(out[0]), json.loads(out[-1])
    assert convert_report["out"] == str(model_dir / "torch_params.npz")
    assert convert_report["n_params"] > 0
    assert diff_report["n_unmapped"] == 0, diff_report
    assert diff_report["worst_roundtrip_err"] <= 1e-5, diff_report
    assert not (model_dir / "jax_params.npz").exists()
    want = ckpt.flatten_params(template)
    with np.load(model_dir / "torch_params.npz") as z:
        assert sorted(z.files) == sorted(want)
        for k, _ in rules:
            np.testing.assert_allclose(z[k], want[k], rtol=1e-6, atol=1e-6,
                                       err_msg=k)


def test_cli_rejects_unknown_config_field(tmp_path, monkeypatch):
    cfg_path = tmp_path / "bad.json"
    cfg_path.write_text(json.dumps({"no_such_field": 1}))
    monkeypatch.setattr(sys, "argv", [
        "convert_checkpoint", "--family", "fsmn_vad",
        "--model-dir", str(tmp_path), "--config-json", str(cfg_path)])
    with pytest.raises(SystemExit):
        cc.main()


def test_check_cache_reports_the_port_cache(tmp_path):
    root = tmp_path / "damo"
    d, _ = _vad_checkpoint(root)
    (root / "speech_campplus_sv_zh-cn_16k-common").mkdir()
    np.savez(root / "speech_campplus_sv_zh-cn_16k-common" / "jax_params.npz")
    report = check_cache.check(str(root))
    assert report["root_exists"]
    vad = report["models"]["speech_fsmn_vad_zh-cn-16k-common-pytorch"]
    assert vad == {"present": True, "has_torch_ckpt": True,
                   "has_converted_npz": False, "has_cmvn": True}
    fv.from_model_dir(d, device="cpu")
    vad = check_cache.check(str(root))["models"][
        "speech_fsmn_vad_zh-cn-16k-common-pytorch"]
    assert vad["has_converted_npz"]
    sv = report["models"]["speech_campplus_sv_zh-cn_16k-common"]
    assert sv["present"] and not sv["has_converted_npz"]
    assert not report["models"][
        "speech_sambert-hifigan_tts_zh-cn_16k"]["present"]
