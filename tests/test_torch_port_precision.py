"""Reduced-precision serving in the port against the reference, on the CPU:
W8A8 int8 (`ops/nn.py::quantize_linear_int8` / `_linear_int8`,
`models/paraformer.py::quantize_encoder_int8`, PARAFORMER_QUANT=int8 in the
`Recognizer` and, through `reco.params`, the chunked ticker) and bf16 trees
(`param_dtype` of the `Recognizer` and the `Synthesizer`), plus the
`NGRAM_LM_FILE` gate of the `Recognizer` and `ops/nn.py::glu`.

One weight tree is drawn by the reference from a seed and carried across
with `models/convert.py::params_from_numpy`; inputs are numpy draws from a
seed. Geometry: `tests/test_int8_quant.py`'s tiny Paraformer (d 32, 3 + 2
layers, vocab 64) and the reference's tiny Synthesizer.

Tolerances, stated per test: int8 weights `q` and scales `s` exact; a
quantized `linear` within 1e-5 of the reference's largest output in f32
(the int32 product is exact; the dequantizing multiply rounds alike) and
one bf16 step in bf16; token counts and ids equal; quantized logits within
1e-2 of their largest magnitude (an activation code that rounds the other
way at a half step moves them by one int8 step); tiny-TTS PCM at bf16
within 2 int16 steps.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.asr.recognizer import Recognizer as JRecognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu.asr.tokenizer import CharTokenizer as JTok  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer_online as jpo  # noqa: E402
from toolbox_for_asr_and_tts_tpu.ops import nn as jnn  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import stream_batcher as jsb  # noqa: E402
from toolbox_for_asr_and_tts_tpu.runtime.bucketing import Bucketer as JBucketer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import (  # noqa: E402
    params_from_numpy, tree_map)
from toolbox_for_asr_and_tts_tpu_torch.ops import nn  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import stream_batcher as sb  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime.bucketing import Bucketer  # noqa: E402

TINY = dict(d_model=32, n_heads=2, ffn_dim=64, encoder_layers=3,
            decoder_layers=2, vocab_size=64)      # tests/test_int8_quant.py
SR = 16000
BUCKETS = (SR, 2 * SR)
ENV = ("PARAFORMER_QUANT", "NGRAM_LM_FILE", "FUNASR_DISABLE_LM")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PARAFORMER_TRANSFER_INT16", "0")


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _port_tree(jtree, dtype=torch.float32):
    return params_from_numpy(_np_tree(jtree), device="cpu", dtype=dtype)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _paths(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _paths(sub, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in _paths(sub, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _as_np(a):
    """A port tensor or a reference array as a float64 / int numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.float() if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.array(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def tiny():
    cfg = jpf.ParaformerConfig(**TINY)
    return cfg, jpf.init_params(jax.random.PRNGKey(0), cfg)


# ---------------------------------------------------------------- nn
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_in,d_out", [(64, 48), (32, 96), (560, 96)])
def test_quantize_linear_int8_matches_reference(d_in, d_out, dtype):
    """q equal to the reference's int8 weights exactly and s equal, from
    an f32 and a bf16 linear; b stays f32; q column-major."""
    jp = jnn.linear_init(jax.random.PRNGKey(d_in + d_out), d_in, d_out)
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    want = jnn.quantize_linear_int8(jp)
    got = nn.quantize_linear_int8(_port_tree(jp, dtype=None))
    assert got["w"].dtype == torch.int8 and got["s"].dtype == torch.float32
    assert got["b"].dtype == torch.float32
    # [in, out] seen over [out, in] storage: cuBLASLt's int8 layout
    assert got["w"].shape == (d_in, d_out) and got["w"].t().is_contiguous()
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 9, 16, 17, 40])
def test_linear_int8_matches_reference(rows, xdtype):
    """`linear` dispatches on the int8 dtype; at every row count (fewer
    than `_int_mm` takes are padded) the result equals the reference's
    within 1e-5 of its largest value in f32 and one bf16 step in bf16, and
    keeps x's dtype. The reference's own accuracy check (median relative
    error against f32 < 0.02) holds too."""
    jp = jnn.linear_init(jax.random.PRNGKey(0), 64, 48)
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((2, rows, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(xdtype)
    want = np.asarray(jnn.linear(jnn.quantize_linear_int8(jp), jx)
                      .astype(jnp.float32))
    q = nn.quantize_linear_int8(_port_tree(jp))
    tx = torch.from_numpy(_as_np(jx))
    tx = tx.to(torch.bfloat16) if xdtype == "bfloat16" else tx
    got = nn.linear(q, tx)
    assert got.dtype == tx.dtype and got.shape == (2, rows, 48)
    scale = np.abs(want).max()
    if xdtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=2.0 ** -7, atol=1e-5 * scale)
    ref = np.asarray(jnn.linear(jp, jnp.asarray(x)))
    rel = np.abs(got.float().numpy() - ref) / np.maximum(np.abs(ref), 1e-3)
    assert float(np.median(rel)) < 0.02, float(np.median(rel))


def test_glu_matches_reference():
    x = np.random.default_rng(3).standard_normal((3, 6, 16)).astype(np.float32)
    for axis in (-1, 1):
        want = np.asarray(jnn.glu(jnp.asarray(x), axis=axis))
        got = nn.glu(torch.from_numpy(x), axis=axis).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- trees
def test_params_from_numpy_keeps_int8_and_bf16_leaves(tiny):
    """A tree the reference quantized and a bf16 tree from the reference
    cross leaf for leaf with each leaf's dtype (dtype=None) and bits; the
    default still casts floating leaves to f32 and keeps int8."""
    _, jparams = tiny
    jq = jpf.quantize_encoder_int8(jparams)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    torch_dtype = {"int8": torch.int8, "float32": torch.float32,
                   "bfloat16": torch.bfloat16}
    for jtree in (jq, jb):
        got, want = _paths(_port_tree(jtree, dtype=None)), _paths(jtree)
        assert sorted(got) == sorted(want)
        for k, a in want.items():
            assert got[k].dtype == torch_dtype[str(a.dtype)], k
            assert tuple(got[k].shape) == a.shape, k
            np.testing.assert_array_equal(_as_np(got[k]), _as_np(a), k)
    default = _paths(_port_tree(jq))
    for k, a in _paths(jq).items():
        want = torch.int8 if a.dtype == jnp.int8 else torch.float32
        assert default[k].dtype == want, k
    assert all(t.dtype == torch.float32 for t in _leaves(_port_tree(jb)))


def test_quantize_encoder_int8_matches_reference(tiny):
    """The same tree keys and leaf dtypes as the reference's quantized
    tree, q and s equal; every leaf outside the four encoder linears of
    each layer unchanged."""
    _, jparams = tiny
    jq = jpf.quantize_encoder_int8(jparams)
    ours = _port_tree(jparams)
    q = pf.quantize_encoder_int8(ours)
    got, want, plain = _paths(q), _paths(jq), _paths(ours)
    assert sorted(got) == sorted(want)
    n_int8 = 0
    for k, a in want.items():
        assert str(got[k].dtype).split(".")[-1] == str(a.dtype), k
        np.testing.assert_array_equal(_as_np(got[k]), _as_np(a), k)
        quantized = any(f"/{n}/" in k for n in ("qkv", "out", "w1", "w2")) \
            and k.startswith("/encoder/layers/")
        if not quantized:
            assert got[k] is plain[k], k
        n_int8 += got[k].dtype == torch.int8
    assert n_int8 == 4 * TINY["encoder_layers"]


def _forward_inputs(cfg):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, 50, cfg.input_dim)).astype(np.float32)
    return feats, np.asarray([50, 37, 20], np.int32)


def test_quantized_forward_matches_reference(tiny):
    """The tiny forward on the quantized tree: token_count and tokens equal
    to the reference's quantized forward, logits within 1e-2 of their
    largest magnitude (one activation code's rounding); the reference's tree quantized by the reference and
    carried across gives the port's own results; and the reference's
    accuracy bound against f32 (logit cosine > 0.995, equal counts)."""
    jcfg, jparams = tiny
    cfg = pf.ParaformerConfig(**TINY)
    feats, lens = _forward_inputs(jcfg)
    want = jpf.forward(jpf.quantize_encoder_int8(jparams), jnp.asarray(feats),
                       jnp.asarray(lens), 12, jcfg)
    ours = pf.quantize_encoder_int8(_port_tree(jparams))
    carried = _port_tree(jpf.quantize_encoder_int8(jparams), dtype=None)
    f32 = _port_tree(jparams)
    with torch.inference_mode():
        args = (torch.from_numpy(feats), torch.from_numpy(lens), 12, cfg)
        got = pf.forward(ours, *args)
        got_carried = pf.forward(carried, *args)
        got_f32 = pf.forward(f32, *args)
    np.testing.assert_array_equal(got["token_count"].numpy(),
                                  np.asarray(want["token_count"]))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    # the two packages' f32 sums differ in the last bits, so a per-token
    # activation code can round the other way at a half step: one int8
    # step of that input moves the logits by up to ~1e-2 of their scale
    wl = np.asarray(want["logits"])
    np.testing.assert_allclose(got["logits"].numpy(), wl, rtol=0,
                               atol=1e-2 * np.abs(wl).max())
    for k in ("logits", "tokens", "token_count", "enc"):
        assert torch.equal(got_carried[k], got[k]), k
    a, c = got_f32["logits"].numpy().ravel(), got["logits"].numpy().ravel()
    assert float(a @ c / (np.linalg.norm(a) * np.linalg.norm(c))) > 0.995
    assert torch.equal(got_f32["token_count"], got["token_count"])
    assert int(got["token_count"].sum()) > 0, "no tokens: not probative"


def test_bf16_activation_dtypes_match_reference(tiny):
    """With a bf16 tree, each stage's output has the dtype the reference's
    promotion gives it: f32 products (`dot`, `conv1d`) and f32 onwards
    from f32 features; Sambert's bf16 embedding sums stay bf16 until the
    first product."""
    from toolbox_for_asr_and_tts_tpu.models import sambert as js
    from toolbox_for_asr_and_tts_tpu_torch.models import sambert as ts
    jcfg, jparams = tiny
    cfg = pf.ParaformerConfig(**TINY)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    tb = _port_tree(jparams, dtype=torch.bfloat16)
    feats, lens = _forward_inputs(jcfg)
    want = jpf.forward(jb, jnp.asarray(feats), jnp.asarray(lens), 12, jcfg)
    with torch.inference_mode():
        got = pf.forward(tb, torch.from_numpy(feats), torch.from_numpy(lens),
                         12, cfg)
    for k in ("logits", "enc", "embeds", "alphas", "token_center"):
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))

    acfg = js.SambertConfig(vocab_size=40, d_model=32, n_heads=2, ffn_dim=64,
                            encoder_layers=1, decoder_layers=1,
                            var_channels=32, postnet_channels=32)
    jsp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                       js.init_params(jax.random.PRNGKey(1), acfg))
    tsp = params_from_numpy(_np_tree(jsp), device="cpu", dtype=None)
    tcfg = ts.SambertConfig(**dataclasses.asdict(acfg))
    ids = np.random.default_rng(2).integers(0, 4, (2, 7, 4)).astype(np.int32)
    ids[..., 0] = np.random.default_rng(3).integers(0, 40, (2, 7))
    spk = np.zeros((2,), np.int32)
    jx = js._embed_inputs(jsp, jnp.asarray(ids), jnp.asarray(spk), None, acfg)
    tx = ts._embed_inputs(tsp, torch.from_numpy(ids), torch.from_numpy(spk),
                          None, tcfg)
    assert jx.dtype == jnp.bfloat16 and tx.dtype == torch.bfloat16
    np.testing.assert_allclose(_as_np(tx), _as_np(jx), rtol=2.0 ** -7,
                               atol=1e-3)
    mask = np.ones((2, 7), np.float32)
    jl = js._transformer_layer(jsp["encoder"][0], jx, acfg.n_heads,
                               jnp.asarray(mask))
    with torch.inference_mode():
        tl = ts._transformer_layer(tsp["encoder"][0], tx, tcfg.n_heads,
                                   torch.from_numpy(mask))
    assert jl.dtype == jnp.float32 and tl.dtype == torch.float32


# ----------------------------------------------------- the Recognizer
ROWS_S = (1.0, 0.7, 0.33)


def _wavs():
    out = []
    for i, secs in enumerate(ROWS_S):
        rng = np.random.default_rng(i)
        t = np.arange(int(SR * secs)) / SR
        out.append((0.3 * np.sin(2 * np.pi * 300 * t)
                    + 0.05 * rng.standard_normal(len(t))).astype(np.float32))
    return out


def _recognizers(jparams, jdtype=None, tdtype=None):
    cfg = pf.ParaformerConfig(**TINY)
    ref = JRecognizer(jparams, jpf.ParaformerConfig(**TINY), JTok.dummy(64),
                      bucketer=JBucketer(BUCKETS), use_mesh=False,
                      param_dtype=jdtype)
    ours = Recognizer(_port_tree(jparams), cfg, CharTokenizer.dummy(64),
                      bucketer=Bucketer(BUCKETS), device="cpu",
                      param_dtype=tdtype)
    return ours, ref


def _ids(reco, wavs, **kw):
    return [r.token_ids for r in reco.transcribe(wavs, **kw)]


@pytest.mark.parametrize("quant,bf16", [("int8", False), ("", True),
                                        ("int8", True)],
                         ids=["int8", "bf16", "bf16+int8"])
def test_recognizer_precision_matches_reference(tiny, monkeypatch, quant,
                                                bf16):
    """Under PARAFORMER_QUANT=int8 (set before construction), with
    param_dtype bf16, and both (cast first, then quantized, as the
    reference): the ids equal the reference Recognizer's, with and without
    hotwords; int8 leaves exactly where the reference has them, every other
    floating leaf in the chosen dtype."""
    monkeypatch.setenv("PARAFORMER_QUANT", quant)
    ours, ref = _recognizers(tiny[1], jnp.bfloat16 if bf16 else None,
                             torch.bfloat16 if bf16 else None)
    got, want = _paths(ours.params), _paths(ref.params)
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert str(got[k].dtype).split(".")[-1] == str(a.dtype), k
    n_int8 = sum(t.dtype == torch.int8 for t in got.values())
    assert n_int8 == (4 * TINY["encoder_layers"] if quant else 0)
    wavs = _wavs()
    ids = _ids(ours, wavs)
    assert ids == _ids(ref, wavs)
    assert sum(map(len, ids)) > 0, "no tokens: not probative"
    hw = {CharTokenizer.dummy(64).tokens[ids[0][0]] * 2: 20}
    assert _ids(ours, wavs, hotwords=hw) == _ids(ref, wavs, hotwords=hw)


def test_unknown_quant_value_leaves_the_tree(tiny, monkeypatch):
    """Only PARAFORMER_QUANT=int8 quantizes, as in the reference."""
    monkeypatch.setenv("PARAFORMER_QUANT", "fp8")
    ours, _ = _recognizers(tiny[1])
    assert all(t.dtype == torch.float32 for t in _leaves(ours.params))


ARPA_HEAD = "\\data\\\nngram 1={}\nngram 2={}\n\n\\1-grams:\n"


def _arpa(tmp_path, ids):
    """A tiny ARPA LM over the tokens the greedy pass emits (as
    tests/test_ngram_lm.py and tests/test_torch_port_recognizer.py)."""
    toks = CharTokenizer.dummy(64).tokens
    uni = sorted({toks[i] for row in ids for i in row
                  if toks[i] not in ("<blank>", "<s>", "</s>", "<unk>")})
    lines = [f"-{1.0 + 0.1 * (i % 5):.1f}\t{t}\t-0.3"
             for i, t in enumerate(uni)]
    bi = [f"-0.1\t{a} {b}" for a, b in zip(uni, uni[1:])]
    path = tmp_path / "lm.arpa"
    path.write_text(ARPA_HEAD.format(len(lines), len(bi)) + "\n".join(lines)
                    + "\n\n\\2-grams:\n" + "\n".join(bi) + "\n\n\\end\\\n",
                    encoding="utf-8")
    return str(path)


def test_ngram_lm_file_is_read_as_the_reference(tiny, monkeypatch, tmp_path):
    """NGRAM_LM_FILE set, no `lm` passed, FUNASR_DISABLE_LM unset: both
    Recognizers load the LM and fuse it; the ids are equal."""
    plain, _ = _recognizers(tiny[1])
    wavs = _wavs()
    monkeypatch.setenv("NGRAM_LM_FILE", _arpa(tmp_path, _ids(plain, wavs)))
    ours, ref = _recognizers(tiny[1])
    assert ours.lm is not None and ref.lm is not None
    assert ours.lm.order == ref.lm.order == 2
    assert _ids(ours, wavs) == _ids(ref, wavs)


def test_ngram_lm_file_gated_by_funasr_disable_lm(tiny, monkeypatch,
                                                  tmp_path):
    """FUNASR_DISABLE_LM set as well: no LM, the plain greedy ids; a file
    that does not load raises (the reference logs and goes on)."""
    plain, _ = _recognizers(tiny[1])
    wavs = _wavs()
    greedy = _ids(plain, wavs)
    monkeypatch.setenv("NGRAM_LM_FILE", _arpa(tmp_path, greedy))
    monkeypatch.setenv("FUNASR_DISABLE_LM", "1")
    ours, ref = _recognizers(tiny[1])
    assert ours.lm is None and ref.lm is None
    assert _ids(ours, wavs) == greedy == _ids(ref, wavs)
    monkeypatch.delenv("FUNASR_DISABLE_LM")
    monkeypatch.setenv("NGRAM_LM_FILE", str(tmp_path / "missing.arpa"))
    with pytest.raises(OSError):
        _recognizers(tiny[1])


# ------------------------------------------------ the chunked ticker
@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_chunked_ticker_on_a_reduced_tree_matches_reference(tiny, mode):
    """`BatchedChunkedASR(partials=True)` on the quantized tree (what
    `service/engines.py` hands it as `reco.params` under
    PARAFORMER_QUANT=int8) and on the bf16 tree: per-session ids equal to
    the reference ticker's on its own such tree, tick for tick and at
    finalize, for one session (a chunked step of 9 window rows: the padded
    `_int_mm` path) and for three."""
    _, jparams = tiny
    if mode == "int8":
        jq = jpf.quantize_encoder_int8(jparams)
        tq = pf.quantize_encoder_int8(_port_tree(jparams))
    else:
        jq = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
        tq = _port_tree(jparams, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    audio = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in (25600, 19200, 12800)]
    chunk = 6400
    n_tokens = 0
    for n_sessions in (1, 3):
        mine = sb.BatchedChunkedASR(tq, pf.ParaformerConfig(**TINY),
                                    po.OnlineConfig(), capacity=4,
                                    partials=True, device="cpu")
        ref = jsb.BatchedChunkedASR(jq, jpf.ParaformerConfig(**TINY),
                                    jpo.OnlineConfig(), capacity=4,
                                    partials=True)
        slots = [(mine.join(), ref.join()) for _ in range(n_sessions)]
        for k in range(4):
            chunks = [audio[i][k * chunk:(k + 1) * chunk]
                      for i in range(n_sessions)]
            got = mine.tick({s: c for (s, _), c in zip(slots, chunks)
                             if len(c)})
            want = ref.tick({s: c for (_, s), c in zip(slots, chunks)
                             if len(c)})
            for (a, b) in slots:
                assert list(got.get(a, [])) == \
                    [int(t) for t in want.get(b, [])], (n_sessions, k)
                n_tokens += len(got.get(a, []))
        for a, b in slots:
            fin = mine.finalize_slot(a)
            assert list(fin.get(a, [])) == \
                [int(t) for t in ref.finalize_slot(b).get(b, [])]
            n_tokens += len(fin.get(a, []))
        assert mine.steps > 0
    assert n_tokens > 5, "no tokens: not probative"


# -------------------------------------------------- the Synthesizer
def test_synthesizer_bf16_matches_reference(monkeypatch):
    """`Synthesizer(param_dtype=torch.bfloat16)` (tiny, NAR, one batch) on
    the reference's f32 draw against the reference's
    `Synthesizer(param_dtype=jnp.bfloat16)`: every floating leaf bf16,
    segment durations equal, PCM within 2 int16 steps."""
    from toolbox_for_asr_and_tts_tpu.tts.synthesizer import Synthesizer as J
    from toolbox_for_asr_and_tts_tpu_torch.models import hifigan as TH
    from toolbox_for_asr_and_tts_tpu_torch.models import sambert as TS
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    for k, v in (("TTS_DECODER", "nar"), ("TTS_GROUP_BY_LENGTH", "0"),
                 ("TTS_MEL_GROUP", "0")):
        monkeypatch.setenv(k, v)
    jf = J.random(tiny=True)
    ref = J(jf.ap, jf.acfg, jf.vp, jf.vcfg, vocab=jf.vocab,
            param_dtype=jnp.bfloat16)
    ours = Synthesizer(
        _port_tree(jf.ap), TS.SambertConfig(**dataclasses.asdict(jf.acfg)),
        _port_tree(jf.vp), TH.HifiGanConfig(**dataclasses.asdict(jf.vcfg)),
        device="cpu", param_dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in
               _leaves(ours.ap) + _leaves(ours.vp) if t.is_floating_point())
    text = "今天天气很好。病人血压一百二，心率正常,没有出血。请多休息，按时吃药。"
    want, got = ref.synthesize(text), ours.synthesize(text)
    assert got.segments == want.segments and len(got.segments) >= 2
    assert got.seg_durations_s == want.seg_durations_s
    pcm = [np.round(np.asarray(w, np.float64) * 32767.0).astype(np.int64)
           for w in (got.wav, want.wav)]
    assert len(pcm[0]) == len(pcm[1]) > 0
    assert np.abs(pcm[0] - pcm[1]).max() <= 2


# ------------------------------------------------------ fine-tuning
def test_a_quantized_tree_does_not_train(tiny):
    """`parallel/trainstep.py` refuses a quantized tree: at `init_opt` and
    at a step given one."""
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep
    cfg = pf.ParaformerConfig(**TINY)
    init_opt, step = trainstep.make_train_step(cfg, device="cpu")
    q = pf.quantize_encoder_int8(_port_tree(tiny[1]))
    with pytest.raises(ValueError, match="quantized"):
        init_opt(q)
    plain = _port_tree(tiny[1])
    opt = init_opt(plain)
    batch = {"feats": np.zeros((1, 8, cfg.input_dim), np.float32),
             "feat_lens": np.asarray([8]), "targets": np.ones((1, 4), np.int32),
             "target_lens": np.asarray([2])}
    with pytest.raises(ValueError, match="quantized"):
        step(q, opt, batch)
