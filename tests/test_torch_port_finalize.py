"""Port `models/ct_transformer.py`, `models/campplus.py`, `asr/speaker.py`
and `asr/diarization.py` vs the reference, on the reference's
`init_params` trees (through `params_from_numpy`) and seeded numpy inputs.

Geometries: `Punctuator.random()`'s CT-Transformer (2 layers, d 64, vocab
4096) and a 2-layer d 32 one with embed_dim 24 ≠ d_model; CAM++ as
`SpeakerVerifier.random()` builds it (blocks (2, 2, 2), 64 channels,
64-dim embedding) with non-trivial BatchNorm statistics, so a layout slip
shows; the diarizer over the `service/engines.py:54-55` Paraformer.
Logits within 1e-5, embeddings within 1e-4, scores within 1e-5; classes,
texts, speakers and timestamps equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.asr import diarization as jdiar  # noqa: E402
from toolbox_for_asr_and_tts_tpu.asr import recognizer as jrec  # noqa: E402
from toolbox_for_asr_and_tts_tpu.asr import speaker as jspk  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import campplus as jcam  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import ct_transformer as jct  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr import diarization as diar  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr import recognizer as rec  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr import speaker as spk  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import campplus as cam  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import ct_transformer as ct  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


# ---------------------------------------------------------- CT-Transformer
@pytest.mark.parametrize("embed_dim", [32, 24])
@pytest.mark.parametrize("right_context", [-1, 2])
def test_ct_forward_matches_reference(embed_dim, right_context):
    """Logits within 1e-5, masked rows included; with embed_dim 24 layer 0
    has no residual, with right_context 2 the delay mask and the shifted
    FSMN window apply."""
    jcfg = jct.CTTransformerConfig(vocab_size=128, embed_dim=embed_dim,
                                   d_model=32, n_heads=2, ffn_dim=64,
                                   num_layers=2, right_context=right_context)
    cfg = ct.CTTransformerConfig(**dataclasses.asdict(jcfg))
    jp = jct.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (3, 16)).astype(np.int32)
    lens = np.array([16, 9, 1], np.int32)
    want = np.asarray(jax.jit(jct.forward, static_argnums=3)(
        jp, jnp.asarray(ids), jnp.asarray(lens), jcfg))
    got = ct.forward(_to_port(jp), torch.from_numpy(ids),
                     torch.from_numpy(lens), cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def punctuators():
    jp = jct.Punctuator.random()
    p = ct.Punctuator(_to_port(jp.params),
                      ct.CTTransformerConfig(**dataclasses.asdict(jp.cfg)),
                      ct.PuncVocab.dummy(jp.cfg.vocab_size), device="cpu")
    return jp, p


def _texts(seed=0, lengths=(5, 12, 20, 3, 0, 27)):
    rng = np.random.default_rng(seed)
    return ["".join(chr(0x4E00 + int(c)) for c in rng.integers(0, 4000, n))
            for n in lengths]


def test_punctuator_classify_and_punctuate_many_match(punctuators):
    """Class ids equal for every text; punctuate_many over a batch that
    spans the 16 and 32 length buckets (plus an empty text) equal; the
    split_words/PuncVocab path equal on mixed latin text."""
    jp, p = punctuators
    texts = _texts() + ["hello world 心率120次 ok"]
    for t in texts:
        words = ct.split_words(t)
        assert words == jct.split_words(t)
        np.testing.assert_array_equal(p.classify(words),
                                      jp.classify(words))
    assert p.punctuate_many(texts) == jp.punctuate_many(texts)
    assert p.punctuate(texts[1]) == jp.punctuate(texts[1])
    assert sorted({k[1] for k in p._fns}) == [16, 32]


def test_punctuator_bucket_cache_builds_once_under_threads(punctuators):
    """Concurrent first calls of a bucket build its forward once."""
    import threading
    _, p = punctuators
    p._fns.pop((4, 64), None)
    got = []
    threads = [threading.Thread(target=lambda: got.append(p._fn(4, 64)))
               for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len({id(f) for f in got}) == 1


# ------------------------------------------------------------------ CAM++
def _randomize_bn(tree, rng):
    """Non-trivial BatchNorm statistics and affines on every BN leaf set."""
    if isinstance(tree, dict):
        if "mean" in tree and "var" in tree:
            d = np.asarray(tree["mean"]).shape[0]
            out = dict(tree)
            out["mean"] = (0.3 * rng.standard_normal(d)).astype(np.float32)
            out["var"] = rng.uniform(0.5, 2.0, d).astype(np.float32)
            if "g" in tree:
                out["g"] = rng.uniform(0.5, 1.5, d).astype(np.float32)
                out["b"] = (0.2 * rng.standard_normal(d)).astype(np.float32)
            return out
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_bn(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def campp():
    jcfg = jcam.CampPlusConfig(block_layers=(2, 2, 2), init_channels=64,
                               embedding_size=64)
    cfg = cam.CampPlusConfig(**dataclasses.asdict(jcfg))
    tree = _randomize_bn(_np_tree(jcam.init_params(jax.random.PRNGKey(0),
                                                   jcfg)),
                         np.random.default_rng(1))
    return cfg, jcfg, params_from_numpy(tree, device="cpu"), tree


@pytest.mark.parametrize("t", [150, 260])
@pytest.mark.parametrize("masked", [False, True])
def test_campplus_forward_matches_reference(campp, t, masked):
    """T 150 and 260 fbank frames: 75 and 130 after the stride-2 TDNN,
    below and above cam_seg_len 100; masked rows of 60 % length."""
    cfg, jcfg, p, tree = campp
    assert p["fcm"]["layer1"][1]["sc"] is None
    rng = np.random.default_rng(t)
    feats = rng.standard_normal((2, t, 80)).astype(np.float32)
    lens = np.array([t, int(0.6 * t)], np.int32) if masked else None
    want = np.asarray(jax.jit(jcam.forward, static_argnums=3)(
        tree, jnp.asarray(feats), None if lens is None else jnp.asarray(lens),
        jcfg))
    got = cam.forward(p, torch.from_numpy(feats),
                      None if lens is None else torch.from_numpy(lens),
                      cfg).numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _speech(seed, secs):
    rng = np.random.default_rng(seed)
    n = int(16000 * secs)
    t = np.arange(n) / 16000
    f0 = 110 + 60 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    x = sum(0.2 / h * np.sin(2 * np.pi * h * np.cumsum(f0) / 16000)
            for h in range(1, 5))
    return (x + 0.02 * rng.standard_normal(n)).astype(np.float32)


def test_speaker_verifier_matches_reference(campp):
    """embed (one bucket, rows of different lengths), verify and
    verify_embedding: embeddings within 1e-4, scores within 1e-5,
    decisions equal; a threshold between the two scores makes one
    decision true and one false on both sides."""
    cfg, jcfg, p, tree = campp
    jv = jspk.SpeakerVerifier(tree, jcfg)
    v = spk.SpeakerVerifier(p, cfg, device="cpu")
    wavs = [_speech(0, 1.7), _speech(1, 0.9), _speech(0, 1.2)]
    np.testing.assert_allclose(v.embed(wavs), np.asarray(jv.embed(wavs)),
                               rtol=1e-4, atol=1e-4)
    same = v.verify(wavs[0], wavs[2])[1], jv.verify(wavs[0], wavs[2])[1]
    other = v.verify(wavs[0], wavs[1])[1], jv.verify(wavs[0], wavs[1])[1]
    for got, want in (same, other):
        assert abs(got - want) < 1e-5
    mid = (same[1] + other[1]) / 2
    v.threshold = jv.threshold = mid
    for a, b in ((wavs[0], wavs[2]), (wavs[0], wavs[1])):
        d, s = v.verify(a, b)
        jd, js = jv.verify(a, b)
        assert d == jd and abs(s - js) < 1e-5
        emb = v.embed([a])[0]
        d, s = v.verify_embedding(emb, b)
        jd, js = jv.verify_embedding(np.asarray(jv.embed([a]))[0], b)
        assert d == jd and abs(s - js) < 1e-5
    assert [v.verify(wavs[0], w)[0] for w in wavs[1:]].count(True) == 1


# -------------------------------------------------------------- Diarizer
TINY = dict(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
            encoder_layers=2, decoder_layers=2, vocab_size=64)


@pytest.fixture(scope="module")
def diarizers(campp, punctuators):
    cfg, jcfg, p, tree = campp
    jpunc, punc = punctuators
    jcfg_pf = jpf.ParaformerConfig(**TINY)
    jreco = jrec.Recognizer.random(jcfg_pf, use_mesh=False)
    reco = rec.Recognizer(_to_port(jreco.params), pf.ParaformerConfig(**TINY),
                          CharTokenizer.dummy(64), device="cpu")
    jd = jdiar.Diarizer(jreco, jspk.SpeakerVerifier(tree, jcfg),
                        punctuator=jpunc)
    d = diar.Diarizer(reco, spk.SpeakerVerifier(p, cfg, device="cpu"),
                      punctuator=punc)
    return jd, d


def _sent_tuple(s):
    return (s.text, s.start_ms, s.end_ms, s.spk, s.overlap_spk)


@pytest.mark.parametrize("need_spk", [True, False])
def test_diarize_and_diarize_batch_match_reference(diarizers, need_spk):
    """Sentences equal (text, timestamps, speakers, overlaps) between the
    port and the reference, and between diarize and diarize_batch."""
    jd, d = diarizers
    wavs = [np.concatenate([_speech(2, 2.5), np.zeros(8000, np.float32),
                            _speech(3, 2.0)]), _speech(4, 1.6)]
    got = [[_sent_tuple(s) for s in r]
           for r in d.diarize_batch(wavs, need_spk=need_spk)]
    want = [[_sent_tuple(s) for s in r]
            for r in jd.diarize_batch(wavs, need_spk=need_spk)]
    assert got == want
    assert sum(len(r) for r in got) > 0
    one = [_sent_tuple(s) for s in d.diarize(wavs[0], need_spk=need_spk)]
    assert one == got[0]
