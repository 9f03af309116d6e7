"""Port `Recognizer` vs the reference's, with the same parameters and the
dummy tokenizer: text, token ids, timestamps and spans must be identical,
with and without hotwords and an ARPA LM, and through `transcribe_long`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from toolbox_for_asr_and_tts_tpu.asr.ngram_lm import ArpaLM as JArpaLM  # noqa: E402
from toolbox_for_asr_and_tts_tpu.asr.recognizer import Recognizer as JRecognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu.asr.tokenizer import CharTokenizer as JTok  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.runtime.bucketing import Bucketer as JBucketer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.ngram_lm import ArpaLM  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime.bucketing import Bucketer  # noqa: E402

TINY = dict(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
            encoder_layers=2, decoder_layers=2, vocab_size=64)
SR = 16000
BUCKETS = (SR, 2 * SR)


def _wav(secs, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * secs)) / SR
    return (0.3 * np.sin(2 * np.pi * 300 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _bursty(total_s, silence_at=(0.3, 0.6)):
    rng = np.random.default_rng(4)
    n = int(total_s * SR)
    x = 0.1 * rng.standard_normal(n).astype(np.float32)
    for rel in silence_at:
        c = int(rel * n)
        x[c - SR // 5: c + SR // 5] = 0.0
    return x


ROWS = [_wav(1.0), _wav(0.7, seed=1), _wav(0.33, seed=2)]


@pytest.fixture(scope="module")
def pair():
    jparams = jpf.init_params(jax.random.PRNGKey(0), jpf.ParaformerConfig(**TINY))
    ref = JRecognizer(jparams, jpf.ParaformerConfig(**TINY), JTok.dummy(64),
                      bucketer=JBucketer(BUCKETS), use_mesh=False)
    ours = Recognizer(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu"),
                      pf.ParaformerConfig(**TINY), CharTokenizer.dummy(64),
                      bucketer=Bucketer(BUCKETS), device="cpu")
    return ours, ref


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.text == w.text
        assert g.token_ids == w.token_ids
        assert g.tokens == w.tokens
        assert g.timestamps_ms == w.timestamps_ms
        assert [tuple(s) for s in g.timestamp] == \
            [tuple(s) for s in w.timestamp]
        assert g.audio_s == pytest.approx(w.audio_s)


def test_transcribe_matches_reference(pair):
    ours, ref = pair
    got = ours.transcribe(ROWS)
    _same(got, ref.transcribe(ROWS))
    assert sum(len(r.token_ids) for r in got) > 0, "no tokens: not probative"
    assert got[0].rtf is not None and got[0].rtf > 0


def _hotwords(res):
    """A boosted pair that disagrees with the greedy output in one place (so
    the logit margin decides) and a banned pair seen in it (demoted to the
    runner-up token, which the logits decide)."""
    ids = res.token_ids
    toks = CharTokenizer.dummy(64).tokens
    boosted = toks[ids[0]] + toks[(ids[1] + 1) % 60 + 4]
    banned = toks[ids[2]] + toks[ids[3]]
    return {boosted: 20, banned: -10}


def test_transcribe_with_hotwords_matches_reference(pair):
    ours, ref = pair
    hw = _hotwords(ours.transcribe(ROWS)[0])
    got = ours.transcribe(ROWS, hotwords=hw)
    _same(got, ref.transcribe(ROWS, hotwords=hw))
    plain = ours.transcribe(ROWS)
    assert got[0].token_ids != plain[0].token_ids, "hotwords changed nothing"


ARPA_HEAD = "\\data\\\nngram 1={}\nngram 2={}\n\n\\1-grams:\n"


def _arpa(tmp_path, res):
    toks = CharTokenizer.dummy(64).tokens
    uni = sorted({toks[i] for r in res for i in r.token_ids
                  if toks[i] not in ("<blank>", "<s>", "</s>", "<unk>")})
    lines = [f"-{1.0 + 0.1 * (i % 5):.1f}\t{t}\t-0.3" for i, t in
             enumerate(uni)]
    bi = [f"-0.1\t{a} {b}" for a, b in zip(uni, uni[1:])]
    text = ARPA_HEAD.format(len(lines), len(bi)) + "\n".join(lines) + \
        "\n\n\\2-grams:\n" + "\n".join(bi) + "\n\n\\end\\\n"
    path = tmp_path / "lm.arpa"
    path.write_text(text, encoding="utf-8")
    return str(path)


def test_transcribe_with_lm_matches_reference(pair, tmp_path):
    ours, ref = pair
    path = _arpa(tmp_path, ours.transcribe(ROWS))
    ours.lm, ref.lm = ArpaLM.load(path), JArpaLM.load(path)
    try:
        _same(ours.transcribe(ROWS, hotwords={"丁七": 20}),
              ref.transcribe(ROWS, hotwords={"丁七": 20}))
        _same(ours.transcribe(ROWS), ref.transcribe(ROWS))
    finally:
        ours.lm = ref.lm = None


def test_transcribe_long_matches_reference(pair):
    ours, ref = pair
    wav = _bursty(5.0)
    assert len(ours.split_long(wav)) > 1
    for a, b in zip(ours.split_long(wav), ref.split_long(wav)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    _same([ours.transcribe_long(wav)], [ref.transcribe_long(wav)])
    hw = {"丁七": 20}
    _same([ours.transcribe_long(wav, hotwords=hw)],
          [ref.transcribe_long(wav, hotwords=hw)])


def test_warmup_rescoring_runs(pair):
    ours, _ = pair
    ours.warmup_rescoring(2, SR)
