"""Port `models/fsmn_vad.py`, `asr/vad.py` and `ops/vad_energy.py` vs the
reference on the same seeded numpy inputs and the reference's
`init_params` tree (through `params_from_numpy`).

Geometries: the VAD of tests/test_fsmn_vad_torch_parity.py (proj 8,
3 layers, lorder 5, 10 outputs) with a 400-dim input, so it also runs
behind the 80-mel × LFR 5 frontend, and half its pdfs silent, so P(speech)
straddles the 0.5 threshold; and the default FsmnVadConfig (K1 at K 20,
D 128). Posteriors within 1e-5 (the same f32 ops in another order),
decisions and segments identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.asr import vad as jvad  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import fsmn_vad as jfv  # noqa: E402
from toolbox_for_asr_and_tts_tpu.ops import vad_energy as jve  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr import vad  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.ops import vad_energy as ve  # noqa: E402

SMALL = dict(input_dim=400, input_affine_dim=12, linear_dim=16, proj_dim=8,
             fsmn_layers=3, lorder=5, output_affine_dim=12, output_dim=10,
             sil_pdf_ids=(0, 1, 2, 3, 4))
GEOMS = {"small": SMALL, "full": {}}


@pytest.fixture(scope="module", params=sorted(GEOMS))
def model(request):
    cfg, jcfg = fv.FsmnVadConfig(**GEOMS[request.param]), \
        jfv.FsmnVadConfig(**GEOMS[request.param])
    jparams = jfv.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return cfg, jcfg, params, jparams


def _feats(seed, t, d=400, b=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, t, d)).astype(np.float32)


def test_apply_and_speech_prob_match_reference(model):
    cfg, jcfg, p, jp = model
    x = _feats(0, 50)
    got = fv.apply(p, torch.from_numpy(x), cfg)
    want = jfv.apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(fv.speech_prob(got, cfg).numpy(),
                               np.asarray(jfv.speech_prob(want, jcfg)),
                               rtol=1e-5, atol=1e-5)


def test_apply_streaming_matches_reference_and_whole_stream(model):
    """Chunks of 7, 13, 1 and 29 frames: posteriors and caches within 1e-5
    of the reference's (its valid conv, the port's K1 on [cache ‖ h]),
    and the port's chunks together equal its own whole-stream apply."""
    cfg, jcfg, p, jp = model
    x = _feats(1, 50)
    cache = fv.init_cache(2, cfg, device="cpu")
    jcache = jfv.init_cache(2, jcfg)
    assert cache.shape == (cfg.fsmn_layers, 2, cfg.lorder - 1, cfg.proj_dim)
    outs, start = [], 0
    for n in (7, 13, 1, 29):
        chunk = x[:, start:start + n]
        start += n
        post, cache = fv.apply_streaming(p, torch.from_numpy(chunk), cache, cfg)
        jpost, jcache = jfv.apply_streaming(jp, jnp.asarray(chunk), jcache,
                                            jcfg)
        np.testing.assert_allclose(post.numpy(), np.asarray(jpost),
                                   rtol=1e-5, atol=1e-5)
        for layer, jlayer in zip(cache, jcache):
            np.testing.assert_allclose(layer.numpy(), np.asarray(jlayer),
                                       rtol=1e-5, atol=1e-5)
        outs.append(post.numpy())
    whole = fv.apply(p, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(np.concatenate(outs, axis=1), whole,
                               rtol=1e-5, atol=1e-6)


def test_streaming_refuses_future_taps():
    cfg = fv.FsmnVadConfig(**SMALL, rorder=1)
    p = fv.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        fv.apply_streaming(p, torch.zeros(1, 3, 400),
                           fv.init_cache(1, cfg, device="cpu"), cfg)


def test_init_params_tree_and_config_mirror_reference():
    for geom in GEOMS.values():
        cfg, jcfg = fv.FsmnVadConfig(**geom), jfv.FsmnVadConfig(**geom)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        mine = fv.init_params(cfg, torch.Generator().manual_seed(0))
        theirs = jfv.init_params(jax.random.PRNGKey(0), jcfg)
        a = jax.tree_util.tree_flatten_with_path(jax.tree.map(
            lambda t: tuple(t.shape), mine,
            is_leaf=lambda t: isinstance(t, torch.Tensor)))
        b = jax.tree_util.tree_flatten_with_path(jax.tree.map(
            lambda t: tuple(t.shape), theirs))
        assert a == b
    conf = {"encoder_conf": {"input_dim": 400, "fsmn_layer_num": 2,
                             "lorder": 10, "proj_dim": 64},
            "model_conf": {"sil_pdf_ids": [0, 3]}}
    assert dataclasses.asdict(fv.FsmnVadConfig.from_funasr(conf)) == \
        dataclasses.asdict(jfv.FsmnVadConfig.from_funasr(conf))


def _probs(seed, n=400):
    """Frame probabilities with speech runs, dips and a long silence."""
    rng = np.random.default_rng(seed)
    p = np.clip(rng.normal(0.2, 0.15, n), 0, 1)
    p[40:120] = np.clip(rng.normal(0.8, 0.2, 80), 0, 1)
    p[200:320] = np.clip(rng.normal(0.75, 0.25, 120), 0, 1)
    return p.astype(np.float32)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(speech_noise_thres=0.5, sil_to_speech_ms=30, max_end_silence_ms=200,
         speech_pad_ms=20),
    dict(window_ms=50, vote_ratio=0.6, max_single_segment_ms=500),
], ids=["default", "short", "voting"])
def test_vad_state_machine_matches_reference(opts):
    """Segments (offline and pushed in chunks) and the per-chunk
    in_speech flag identical."""
    probs = _probs(3)
    assert vad.segments_from_probs(probs, vad.VadOptions(**opts)) == \
        jvad.segments_from_probs(probs, jvad.VadOptions(**opts))
    sm, jsm = vad.VadStateMachine(vad.VadOptions(**opts)), \
        jvad.VadStateMachine(jvad.VadOptions(**opts))
    for s in range(0, len(probs), 37):
        assert sm.push(probs[s:s + 37]) == jsm.push(probs[s:s + 37])
        assert sm.in_speech == jsm.in_speech
    assert sm.finalize() == jsm.finalize()
    assert sm.segments == jsm.segments and sm.segments


def _wave(seed, n, amp):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal(n)).astype(np.float32)


def test_streaming_vad_stepper_matches_reference():
    """Per-chunk decisions identical over 0.4 s chunks, a chunk too short
    for a frame, and a reset; both decisions occur."""
    cfg, jcfg = fv.FsmnVadConfig(**SMALL), jfv.FsmnVadConfig(**SMALL)
    jparams = jfv.init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    mine = vad.StreamingVadStepper(params, cfg, device="cpu")
    ref = jvad.StreamingVadStepper(jparams, jcfg)
    chunks = [_wave(10 + i, 6400, a) for i, a in
              enumerate((0.3, 0.001, 0.2, 0.0, 0.5, 0.05))]
    chunks.insert(2, _wave(5, 100, 0.2))
    got, want = [], []
    for c in chunks:
        got.append(mine(c))
        want.append(ref(c))
    mine.reset()
    ref.reset()
    got.append(mine(chunks[0]))
    want.append(ref(chunks[0]))
    assert got == want
    assert True in got and False in got


def test_vad_energy_matches_reference(tmp_path):
    """The numpy path and the tensor path against the reference's numpy
    and jnp paths; the clipped-audio dump writes the same WAV bytes."""
    loud, mid, silent = _wave(0, 6400, 0.3), _wave(1, 6400, 0.04), \
        np.zeros(6400, np.float32)
    for x in (loud, mid, silent, np.zeros(0, np.float32)):
        assert ve.energy_stats(x) == jve.energy_stats(x)
        assert ve.is_speech_energy(x) == jve.is_speech_energy(x)
        assert ve.rms(x) == jve.rms(x)
        assert ve.audio_quality_stats(x) == jve.audio_quality_stats(x)
    for x in (loud, mid, silent):
        m, pk = ve.energy_stats(torch.from_numpy(x))
        jm, jpk = jve.energy_stats(jnp.asarray(x))
        np.testing.assert_allclose([float(m), float(pk)],
                                   [float(jm), float(jpk)], rtol=1e-6)
        assert bool(ve.is_speech_energy(torch.from_numpy(x))) == \
            bool(jve.is_speech_energy(jnp.asarray(x)))
        np.testing.assert_allclose(float(ve.rms(torch.from_numpy(x))),
                                   float(jve.rms(jnp.asarray(x))), rtol=1e-6)
    assert ve.is_speech_energy(loud) and not ve.is_speech_energy(mid)
    assert (ve.MEAN_THRESHOLD, ve.PEAK_THRESHOLD) == \
        (jve.MEAN_THRESHOLD, jve.PEAK_THRESHOLD) == (0.03, 0.17)
    clipped = np.clip(_wave(2, 1600, 2.0), -1.0, 1.0)
    assert ve.dump_clipped_audio(loud, dump_dir=str(tmp_path / "a")) is None
    path = ve.dump_clipped_audio(clipped, dump_dir=str(tmp_path / "a"))
    jpath = jve.dump_clipped_audio(clipped, dump_dir=str(tmp_path / "b"))
    with open(path, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
