"""The port's TTS models vs the reference's, on the same numpy inputs and the
same parameter tree (drawn by the reference's `init_params` from a fixed
key, carried by `params_from_numpy`), at the tiny geometry of
`Synthesizer.random(tiny=True)`.

Integer outputs (durations, mel lengths, the length regulator's frames) must
be equal; float outputs agree within 1e-5 of their largest magnitude (float32
sums in another order). The duration tests first require every
exp(log_dur) − 1 to lie at least 1e-4 from a half-integer, so that a
rounding flip between the two packages is reported as such.

Mirrors the reference's `tests/test_tts.py::test_length_regulate_static`
and `::test_hifigan_output_length`, on both packages at once."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.models import hifigan as JH  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import sambert as JS  # noqa: E402
from toolbox_for_asr_and_tts_tpu.ops import nn as jnn  # noqa: E402
from toolbox_for_asr_and_tts_tpu.tts.text_frontend import LingVocab  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import hifigan as TH  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import sambert as TS  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.ops import nn  # noqa: E402

REL = 1e-5          # float outputs: max |Δ| ≤ REL · max |reference|
MARGIN = 1e-4       # least distance of exp(log_dur) − 1 from k + 0.5

# the reference's `Synthesizer.random(tiny=True)` geometry
ACFG = JS.SambertConfig(vocab_size=len(LingVocab.default()), d_model=32,
                        n_heads=2, ffn_dim=64, encoder_layers=1,
                        decoder_layers=1, var_channels=32,
                        postnet_channels=32, frames_per_phone=8)
VCFG = JH.HifiGanConfig(upsample_initial_channel=32,
                        upsample_rates=(5, 5, 4, 2),
                        upsample_kernels=(11, 11, 8, 4),
                        resblock_kernels=(3,), resblock_dilations=((1, 3),))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pt(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


def _port_cfg(cls, jcfg):
    return cls(**dataclasses.asdict(jcfg))


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want).max())
    assert err <= rel * scale, (err, scale)


# ------------------------------------------------------------------ ops
def test_mha_with_a_partial_key_mask():
    p = jnn.mha_init(jax.random.PRNGKey(0), 16, 2)
    x = _x(3, 7, 16)
    lens = np.array([7, 4, 1], np.int32)
    mask = np.array(jnn.length_mask(jnp.asarray(lens), 7))
    want = jnn.mha(p, jnp.asarray(x), 2, jnp.asarray(mask))
    got = nn.mha(_pt(p), torch.from_numpy(x), 2, torch.from_numpy(mask))
    _close(got, want)
    # the masked keys change the result (the mask is not a no-op)
    free = nn.mha(_pt(p), torch.from_numpy(x), 2, None)
    assert float((free[1] - got[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("stride,kernel", [(5, 11), (4, 8), (2, 4), (3, 7),
                                           (10, 20)])
def test_conv_transpose1d_matches_jax(stride, kernel):
    key = jax.random.PRNGKey(stride)
    p = {"w": jax.random.uniform(key, (12, 6, kernel), jnp.float32, -0.3, 0.3),
         "b": jax.random.uniform(jax.random.fold_in(key, 1), (6,),
                                 jnp.float32, -0.3, 0.3)}
    x = _x(2, 9, 12, seed=stride)
    pad = (kernel - stride) // 2
    want = jnn.conv_transpose1d(p, jnp.asarray(x), stride=stride, padding=pad)
    got = nn.conv_transpose1d(_pt(p), torch.from_numpy(x), stride=stride,
                              padding=pad)
    assert got.shape[1] == (9 - 1) * stride - 2 * pad + kernel
    _close(got, want)


@pytest.mark.parametrize("kernel,dilation", [(3, 1), (3, 3), (7, 5), (11, 3)])
def test_dilated_conv1d_matches_jax(kernel, dilation):
    p = jnn.conv1d_init(jax.random.PRNGKey(kernel), 8, 8, kernel)
    x = _x(2, 40, 8, seed=dilation)
    span = dilation * (kernel - 1)
    pad = (span // 2, span - span // 2)
    want = jnn.conv1d(p, jnp.asarray(x), padding=pad, dilation=dilation)
    got = nn.conv1d(_pt(p), torch.from_numpy(x), padding=pad,
                    dilation=dilation)
    assert got.shape == (2, 40, 8)
    _close(got, want)


# --------------------------------------------------------------- Sambert
def test_length_regulate_is_exact():
    x = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2)
    dur = np.asarray([[2, 1, 3], [1, 0, 0]], np.int32)
    out, mask = TS.length_regulate(torch.from_numpy(x), torch.from_numpy(dur),
                                   t_mel=8)
    assert out[0, :4].tolist() == [x[0, 0].tolist()] * 2 + [x[0, 1].tolist(),
                                                             x[0, 2].tolist()]
    assert mask.sum(1).tolist() == [6.0, 1.0]
    rng = np.random.default_rng(3)
    x = _x(4, 11, 5, seed=3)
    dur = rng.integers(0, 6, (4, 11)).astype(np.int32)
    for t_mel in (16, 40, 64):   # shorter and longer than the durations
        want = JS.length_regulate(jnp.asarray(x), jnp.asarray(dur), t_mel)
        got = TS.length_regulate(torch.from_numpy(x), torch.from_numpy(dur),
                                 t_mel)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def acoustic():
    jp = JS.init_params(jax.random.PRNGKey(0), ACFG)
    return jp, _pt(jp)


def _batch(seed=0, b=3, l=16, lens=(16, 9, 4)):
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.integers(0, ACFG.vocab_size, (b, l)),
                    rng.integers(0, ACFG.tone_size, (b, l)),
                    rng.integers(0, ACFG.sylfl_size, (b, l)),
                    rng.integers(0, ACFG.wseg_size, (b, l))], -1)
    return (ids.astype(np.int32), np.asarray(lens, np.int32),
            np.arange(b, dtype=np.int32) % ACFG.n_speakers)


def _both(jfn, tfn, jp, tp, arrays, **kw):
    want = jfn(jp, *map(jnp.asarray, arrays), **kw)
    with torch.inference_mode():
        got = tfn(tp, *map(torch.from_numpy, arrays), **kw)
    return got, want


def _check_margin(log_dur, lens):
    """No exp(log_dur) − 1 of a valid phone sits within MARGIN of k + 0.5."""
    v = np.exp(np.asarray(log_dur, np.float64)) - 1.0
    valid = np.arange(v.shape[1])[None, :] < np.asarray(lens)[:, None]
    gap = np.abs(v - np.floor(v) - 0.5)[valid]
    assert gap.min() >= MARGIN, f"duration within {gap.min():.2e} of a .5"


def test_predict_mel_lens_equal(acoustic):
    jp, tp = acoustic
    arrays = _batch(seed=1)
    got, want = _both(JS.predict_mel_lens, TS.predict_mel_lens, jp, tp,
                      arrays, cfg=ACFG)
    with torch.inference_mode():   # within 1e-5 of the reference's
        full = TS.forward(tp, *map(torch.from_numpy, arrays),
                          _port_cfg(TS.SambertConfig, ACFG))
    _check_margin(full["log_duration"].numpy(), arrays[1])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("override", [False, True], ids=["predicted",
                                                         "duration_override"])
def test_sambert_forward_nar(acoustic, override):
    jp, tp = acoustic
    arrays = _batch(seed=2)
    kw = {}
    if override:   # 0 on some valid phones, capped by t_mel below
        dur = np.random.default_rng(4).integers(0, 9, arrays[0].shape[:2])
        kw["duration_override"] = dur.astype(np.int32)
    t_mel = 48 if override else 96
    want = JS.forward(jp, *map(jnp.asarray, arrays), ACFG, t_mel=t_mel,
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.inference_mode():
        got = TS.forward(tp, *map(torch.from_numpy, arrays),
                         _port_cfg(TS.SambertConfig, ACFG), t_mel=t_mel,
                         **{k: torch.from_numpy(v) for k, v in kw.items()})
    if not override:
        _check_margin(want["log_duration"], arrays[1])
    for k in ("durations", "mel_lens"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for k in ("log_duration", "pitch", "energy", "mel"):
        _close(got[k], want[k])
    assert got["mel"].shape == (3, t_mel, ACFG.n_mels)
    if override:
        assert int(got["mel_lens"].max()) == t_mel   # some row is cut


@pytest.mark.parametrize("bands", [dict(h_band=20, x_band=-1),
                                   dict(h_band=-1, x_band=-1),
                                   dict(h_band=2, x_band=4),
                                   dict(h_band=20, x_band=-1, n_heads=8)],
                         ids=["h_band20", "unbounded", "both_banded",
                              "heads8"])
def test_sambert_forward_ar_pnca(acoustic, bands):
    jp, tp = acoustic
    jcfg = dataclasses.replace(ACFG, **bands)
    arrays = _batch(seed=5, l=12, lens=(12, 7, 3))
    want = JS.forward_ar(jp, *map(jnp.asarray, arrays), jcfg, t_mel=64)
    with torch.inference_mode():
        got = TS.forward_ar(tp, *map(torch.from_numpy, arrays),
                            _port_cfg(TS.SambertConfig, jcfg), t_mel=64)
    _check_margin(want["log_duration"], arrays[1])
    for k in ("durations", "mel_lens"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["mel"].shape == (3, 66, ACFG.n_mels)   # ⌈64 / 3⌉ steps of 3
    _close(got["mel"], want["mel"])


# -------------------------------------------------------------- HiFi-GAN
@pytest.mark.parametrize("cfg", [
    VCFG,
    JH.HifiGanConfig(upsample_initial_channel=16, resblock_kernels=(3, 7),
                     resblock_dilations=((1, 3, 5), (1, 3, 5))),
    # the KAN-TTS 16 kHz upsampling: ×10 with a kernel of 20 (2 taps per
    # phase in the port's transposed convolution), then ×5, ×2, ×2
    JH.HifiGanConfig(upsample_initial_channel=16,
                     upsample_rates=(10, 5, 2, 2),
                     upsample_kernels=(20, 11, 4, 4), resblock_kernels=(3,),
                     resblock_dilations=((1, 3),))],
    ids=["tiny", "two_resblocks", "kantts_16k"])
def test_hifigan_forward_matches_jax(cfg):
    jp = JH.init_params(jax.random.PRNGKey(1), cfg)
    mel = _x(2, 13, cfg.n_mels, seed=6)
    want = JH.forward(jp, jnp.asarray(mel), cfg)
    with torch.inference_mode():
        got = TH.forward(_pt(jp), torch.from_numpy(mel),
                         _port_cfg(TH.HifiGanConfig, cfg))
    assert got.shape == (2, 13 * cfg.hop_length) and cfg.hop_length == 200
    _close(got, want)


# ----------------------------------------------------- trees and configs
def test_params_from_numpy_carries_both_trees_leaf_for_leaf():
    """Every leaf of the Sambert and HiFi-GAN trees (lists of layer dicts,
    postnet norm g/b, pnca.layers[i].fc, the (C_in, C_out, K) upsample
    weights) arrives with its path, shape and values."""
    for jp in (JS.init_params(jax.random.PRNGKey(0), ACFG),
               JH.init_params(jax.random.PRNGKey(1), VCFG)):
        want = jax.tree_util.tree_flatten_with_path(_np_tree(jp))[0]
        got = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.numpy(), _pt(jp)))[0]
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.dtype == np.float32 and g.shape == w.shape, path
            np.testing.assert_array_equal(g, w)
    keys = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(
                JS.init_params(jax.random.PRNGKey(0), ACFG))[0]]
    assert "['postnet'][4]['norm']['g']" in keys
    assert "['pnca']['layers'][5]['fc']['w']" in keys


def test_port_init_params_have_the_reference_tree():
    """The port's own random draw has the reference's paths and shapes."""
    for jp, tp in ((JS.init_params(jax.random.PRNGKey(0), ACFG),
                    TS.init_params(torch.Generator().manual_seed(0),
                                   _port_cfg(TS.SambertConfig, ACFG))),
                   (JH.init_params(jax.random.PRNGKey(1), VCFG),
                    TH.init_params(torch.Generator().manual_seed(1),
                                   _port_cfg(TH.HifiGanConfig, VCFG)))):
        want = jax.tree_util.tree_flatten_with_path(_np_tree(jp))[0]
        got = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.numpy(), tp))[0]
        assert [(p, g.shape) for p, g in got] == \
            [(p, w.shape) for p, w in want]
    dur_b = float(TS.init_params(torch.Generator().manual_seed(0),
                                 _port_cfg(TS.SambertConfig, ACFG)
                                 )["duration"]["out"]["b"][0])
    assert abs(dur_b - np.log(6.0)) <= 1.0 / np.sqrt(ACFG.var_channels)


def test_config_from_state_dict_matches_reference():
    class W:
        def __init__(self, *shape):
            self.shape = shape
    sd = {"text_encoder.sy_emb.weight": W(300, 48),
          "text_encoder.tone_emb.weight": W(9, 48),
          "emo_tokenizer.weight": W(3, 48),
          "spk_tokenizer.weight": W(5, 48),
          "text_encoder.layer_stack.0.pos_ffn.w_1.weight": W(96, 48),
          "text_encoder.layer_stack.2.x.weight": W(1),
          "mel_decoder.layer_stack.4.x.weight": W(1),
          "mel_postnet.conv_stack.0.conv.weight": W(64, 40, 3),
          "mel_postnet.conv_stack.3.conv.weight": W(40, 64, 3),
          "mel_decoder.mel_out.weight": W(80, 48),
          "mel_decoder.prenet.fc1.weight": W(128, 80),
          "dur_predictor.conv1.weight": W(32, 48, 5)}
    got = TS.config_from_state_dict(sd, TS.SambertConfig())
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JS.config_from_state_dict(sd, JS.SambertConfig()))
    vsd = {"conv_pre.weight": W(64, 80, 7), "ups.0.weight": W(64, 32, 16),
           "ups.1.weight": W(32, 16, 8),
           **{f"resblocks.{j}.convs1.{i}.weight": W(8, 8, k)
              for j, k in enumerate((3, 5, 3, 5)) for i in range(2)}}
    got = TH.config_from_state_dict(vsd, TH.HifiGanConfig())
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JH.config_from_state_dict(vsd, JH.HifiGanConfig()))
    assert got.upsample_rates == (8, 4) and got.hop_length == 32
