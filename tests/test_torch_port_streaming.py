"""Port `models/paraformer_streaming.py` and `models/paraformer_online.py`
vs the reference at the tiny geometry of `service/engines.py:54-55` (d 32,
2 + 2 layers, vocab 64) with the default OnlineConfig (chunk [0, 4, 5],
look-back 4): the reference's `init_params` goes through
`params_from_numpy`, and both sides run on the same seeded numpy inputs.

Integer outputs are equal: fired counts, `kv_len`, token ids, text. The
CIF integers come from floor(cumsum α), and a cumsum in another order can
move a boundary that lies within ~1e-6 of an integer; each test that
compares them first asserts that its own masses keep 1e-5 away from every
integer, so the exact comparison really runs. Floats: the encoder window
and caches within 1e-5 (the same f32 ops in another order), fbank features
within 1e-3 (two f32 FFTs, amplified by the log in quiet bins)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.asr.tokenizer import CharTokenizer as JTok  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer_online as jpo  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer_streaming as jps  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_streaming as ps  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import frame_window as k2  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import fsmn_conv as k1  # noqa: E402

TINY = dict(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
            encoder_layers=2, decoder_layers=2, vocab_size=64)
CFG, JCFG = pf.ParaformerConfig(**TINY), jpf.ParaformerConfig(**TINY)
OCFG, JOCFG = po.OnlineConfig(), jpo.OnlineConfig()
MARGIN = 1e-5
# the reference's step functions, compiled once (eager JAX is slow)
J_ENCODE = jax.jit(lambda p, s, f: jpo.encode_chunk(p, s, f, JCFG, JOCFG))
J_PREDICT = jax.jit(lambda p, e, a, s: jpo.predictor_chunk(p, e, a, s, JCFG, 8))
J_DECODE = jax.jit(lambda p, d, e, n: jpo.decode_chunk(p, d, e, n, JCFG))
J_FUSED = {dp: jax.jit(lambda p, s, a, cm, dp=dp: jpo.fused_step(
    p, s, a, JCFG, JOCFG, cmvn=cm, decode_partials=dp)) for dp in (False, True)}


@pytest.fixture(scope="module")
def params():
    jparams = jpf.init_params(jax.random.PRNGKey(0), JCFG)
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             device="cpu"), jparams


def _audio(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.1).astype(np.float32)


def _assert_off_integers(mass):
    """The masses whose floors the test compares keep MARGIN away from
    every integer (else the exact comparison is not probative)."""
    mass = np.asarray(mass, np.float64)
    assert np.abs(mass - np.round(mass)).min() > MARGIN, mass


def _unstack(state):
    """The port's stacked caches back into the reference's per-layer
    lists, leaf for leaf."""
    out = {k: v.numpy() for k, v in state.items()
           if k not in ("k", "v", "fsmn")}
    out["kv"] = [{"k": state["k"][i].numpy(), "v": state["v"][i].numpy()}
                 for i in range(state["k"].shape[0])]
    if "fsmn" in state:
        out["fsmn"] = [c.numpy() for c in state["fsmn"]]
    return out


def _assert_state_close(got, want, atol=1e-5, feats_atol=1e-5):
    """Every leaf within rtol 1e-5 and `atol`; the embedded-window leaf
    "feats" within `feats_atol` (from audio: fbank's 1e-3 times √d)."""
    got = _unstack(got)
    want = jax.tree.map(np.asarray, want)
    assert set(got) == set(want)
    for key in ("start_idx", "kv_len", "step_idx", "hist_len", "mem_len"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, a), (_, b) in zip(flat_g, flat_w):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=feats_atol if name == "['feats']" else atol,
            err_msg=name)


def test_cif_step_matches_reference():
    """The batched cif_step vs the reference's, vmapped over B, over
    several chunks with carried state."""
    rng = np.random.default_rng(0)
    b, t, d, k_cap = 3, 9, 16, 8
    mass, acc = np.zeros(b, np.float32), np.zeros((b, d), np.float32)
    jmass, jacc = jnp.asarray(mass), jnp.asarray(acc)
    step = jax.vmap(lambda e, a, m, c: jps.cif_step(e, a, m, c, k_cap))
    masses = []
    for i in range(5):
        enc = rng.standard_normal((b, t, d)).astype(np.float32)
        alphas = rng.uniform(0.0, 0.6, (b, t)).astype(np.float32)
        alphas[1, :] = 0.0 if i == 2 else alphas[1, :]   # a chunk with no fire
        got = ps.cif_step(torch.from_numpy(enc), torch.from_numpy(alphas),
                          torch.from_numpy(mass), torch.from_numpy(acc), k_cap)
        want = step(jnp.asarray(enc), jnp.asarray(alphas), jmass, jacc)
        masses.append(np.asarray(want[2]))
        masses.append(mass[:, None] + np.cumsum(alphas, axis=1))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].dtype == torch.int32
        for a, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
        mass, acc = got[2].numpy(), got[3].numpy()
        jmass, jacc = want[2], want[3]
    _assert_off_integers(np.concatenate([m.ravel() for m in masses]))
    assert int(np.floor(mass).sum()) > 0


def test_streaming_frontend_push_and_flush_match_reference():
    """0.4 s pushes then a flush, with and without CMVN: the same LFR rows
    at the same pushes, features within 1e-3; K2's plain version on the
    CPU (no launch)."""
    audio = _audio(1, 15760 + 100)      # 97 fbank frames: flush emits
    rng = np.random.default_rng(2)
    cmvn = (rng.standard_normal(560).astype(np.float32),
            rng.uniform(0.5, 1.5, 560).astype(np.float32))
    for cm in (None, cmvn):
        mine = ps.StreamingFrontend(CFG.frontend, cm, device="cpu")
        ref = jps.StreamingFrontend(JCFG.frontend, cm)
        before = k2.launches
        for s in range(0, len(audio), 6400):
            got, want = mine.push(audio[s:s + 6400]), ref.push(audio[s:s + 6400])
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        got, want = mine.flush(), ref.flush()
        assert got.shape == want.shape and len(got) > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
        assert k2.launches == before
        mine.reset()
        assert mine.push(audio[:100]).shape == (0, 560)


def test_encode_and_predictor_chunks_match_reference(params):
    """Several encode_chunk + predictor_chunk steps for 2 streams: window
    output and k/v caches within 1e-5, kv_len equal, fired counts equal."""
    p, jp = params
    rng = np.random.default_rng(3)
    state = po.init_state(CFG, OCFG, b=2, device="cpu")
    jstate = jpo.init_state(JCFG, JOCFG, b=2)
    active = np.zeros((2, OCFG.window), np.float32)
    active[:, :OCFG.c1] = 1.0
    masses = []
    for _ in range(6):
        feats = rng.standard_normal((2, OCFG.c1, 560)).astype(np.float32)
        state, enc = po.encode_chunk(p, state, torch.from_numpy(feats), CFG,
                                     OCFG)
        jstate, jenc = J_ENCODE(jp, jstate, jnp.asarray(feats))
        np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=1e-5,
                                   atol=1e-5)
        state, emb, n = po.predictor_chunk(p, enc, torch.from_numpy(active),
                                           state, CFG, 8)
        jstate, jemb, jn = J_PREDICT(jp, jenc, jnp.asarray(active), jstate)
        masses.append(np.asarray(jstate["cif_mass"]))
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
        np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-5,
                                   atol=1e-5)
        _assert_state_close(state, jstate)
    assert state["kv_len"].tolist() == [OCFG.kv_frames] * 2
    _assert_off_integers(np.concatenate(masses))
    assert float(state["cif_mass"].min()) > 1.0


@pytest.mark.parametrize("partials", [False, True], ids=["embeds", "partials"])
def test_fused_step_matches_reference(params, partials):
    """fused_step over 5 steps of 2 streams (with CMVN): fired counts and
    token ids equal, embeddings (bf16, as returned) within one bf16
    rounding; the state's features (from audio) within fbank's 1e-3 × √d,
    every other leaf within 1e-4 (those features, through the encoder)."""
    p, jp = params
    rng = np.random.default_rng(4)
    cmvn = (rng.standard_normal(560).astype(np.float32) * 0.1,
            rng.uniform(0.5, 1.5, 560).astype(np.float32))
    a = po.fused_buf_len(CFG, OCFG) - 480
    state = po.init_fused_state(CFG, OCFG, b=2, decode_partials=partials,
                                device="cpu")
    jstate = jpo.init_fused_state(JCFG, JOCFG, b=2, decode_partials=partials)
    cm = tuple(torch.from_numpy(c) for c in cmvn)
    jcm = tuple(jnp.asarray(c) for c in cmvn)
    masses, total = [], 0
    for i in range(5):
        audio = np.stack([_audio(10 + i, a), _audio(20 + i, a)])
        got = po.fused_step(p, state, torch.from_numpy(audio), CFG, OCFG,
                            cmvn=cm, decode_partials=partials)
        want = J_FUSED[partials](jp, jstate, jnp.asarray(audio), jcm)
        assert len(got) == len(want) == (4 if partials else 3)
        state, jstate = got[0], want[0]
        masses.append(np.asarray(jstate["cif_mass"]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        total += int(got[2].sum())
        assert got[1].dtype == torch.bfloat16
        np.testing.assert_allclose(got[1].float().numpy(),
                                   np.asarray(want[1], np.float32),
                                   rtol=1e-2, atol=1e-2)
        if partials:
            np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        _assert_state_close(state, jstate, atol=1e-4,
                            feats_atol=1e-3 * CFG.d_model ** 0.5)
    _assert_off_integers(np.concatenate(masses))
    assert total > 0
    assert state["step_idx"].tolist() == [5, 5]


def test_fused_step_is_encode_then_decode(params):
    """fused_encode then fused_decode (the halves that return the f32
    embeddings and the decoder's logits) give fused_step's state, fired
    counts, bf16 embeddings and greedy ids exactly, over 4 steps."""
    p, _ = params
    a = po.fused_buf_len(CFG, OCFG) - 480
    state = po.init_fused_state(CFG, OCFG, b=2, decode_partials=True,
                                device="cpu")
    halves, total = dict(state), 0
    for i in range(4):
        audio = torch.from_numpy(np.stack([_audio(30 + i, a), _audio(40 + i, a)]))
        state, emb, n, ids = po.fused_step(p, state, audio, CFG, OCFG,
                                           decode_partials=True)
        halves, enc, emb32, n2 = po.fused_encode(p, halves, audio, CFG, OCFG)
        halves, logits, mask = po.fused_decode(p, halves, enc, emb32, n2, CFG,
                                               OCFG)
        assert emb32.dtype == torch.float32
        assert torch.equal(n2, n) and torch.equal(emb32.to(torch.bfloat16), emb)
        assert torch.equal(logits.argmax(-1).int() * mask.int(), ids)
        assert set(halves) == set(state)
        for key in state:
            assert torch.equal(halves[key], state[key]), key
        total += int(n.sum())
    assert total > 0


def test_decode_chunk_and_flush_tail_match_reference(params):
    """decode_chunk over a few chunks (0 to 3 tokens per row, a ring that
    fills and a history past kernel − 1): logits-argmax ids equal, caches
    within 1e-5; flush_tail's fire decisions equal."""
    p, jp = params
    rng = np.random.default_rng(5)
    ds = po.init_decoder_state(CFG, OCFG, b=3, device="cpu")
    jds = jpo.init_decoder_state(JCFG, JOCFG, b=3)
    for i in range(6):
        frames = rng.standard_normal((3, 4, 32)).astype(np.float32)
        nv = np.array([4, 4, 2], np.int32)
        ds = po.decoder_push_memory(ds, torch.from_numpy(frames),
                                    torch.from_numpy(nv))
        jds = jpo.decoder_push_memory(jds, jnp.asarray(frames),
                                      jnp.asarray(nv))
        emb = rng.standard_normal((3, 8, 32)).astype(np.float32)
        n = np.array([3, i % 3, 1], np.int32)
        ds, ids = po.decode_chunk(p, ds, torch.from_numpy(emb),
                                  torch.from_numpy(n), CFG)
        jds, jids = J_DECODE(jp, jds, jnp.asarray(emb), jnp.asarray(n))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        assert ids.dtype == torch.int32
        np.testing.assert_array_equal(ds["hist_len"].numpy(),
                                      np.asarray(jds["hist_len"]))
        np.testing.assert_array_equal(ds["mem_len"].numpy(),
                                      np.asarray(jds["mem_len"]))
        np.testing.assert_allclose(ds["mem"].numpy(), np.asarray(jds["mem"]),
                                   rtol=1e-6, atol=1e-6)
        for li in range(CFG.decoder_layers):
            np.testing.assert_allclose(ds["fsmn"][li].numpy(),
                                       np.asarray(jds["fsmn"][li]),
                                       rtol=1e-5, atol=1e-5)
    mass = np.array([2.3, 4.6, 0.0, 7.55, 1.0], np.float32)
    acc = rng.standard_normal((5, 32)).astype(np.float32)
    st = {"cif_mass": torch.from_numpy(mass), "cif_acc": torch.from_numpy(acc)}
    emb, fired = po.flush_tail(st, 0.45)
    jemb, jfired = jpo.flush_tail({"cif_mass": jnp.asarray(mass),
                                   "cif_acc": jnp.asarray(acc)}, 0.45)
    np.testing.assert_array_equal(fired.numpy(), np.asarray(jfired))
    assert fired.tolist() == [False, True, False, True, False]
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))


@pytest.mark.parametrize("mode", ["redecode", "incremental"])
def test_online_recognizer_matches_reference(params, mode):
    """OnlineRecognizer over 1.2 s in 0.4 s pushes, then finalize: every
    partial text, the fired ids and the final text identical; the encoder
    runs 2 plain K1 calls per chunk and no kernel launch on the CPU."""
    p, jp = params
    tok, jtok = CharTokenizer.dummy(64), JTok.dummy(64)
    mine = po.OnlineRecognizer(p, CFG, tok, OCFG, partial_mode=mode,
                               device="cpu")
    ref = jpo.OnlineRecognizer(jp, JCFG, jtok, JOCFG, partial_mode=mode)
    audio = _audio(30, 19200)
    before = k1.launches
    for s in range(0, len(audio), 6400):
        assert mine.push_audio(audio[s:s + 6400]) == \
            ref.push_audio(audio[s:s + 6400])
    assert mine._inc_ids == ref._inc_ids
    assert len(mine._embeds) == len(ref._embeds) > 0
    np.testing.assert_allclose(np.stack(mine._embeds), np.stack(ref._embeds),
                               rtol=1e-4, atol=1e-5)
    _assert_off_integers(np.asarray(ref._state["cif_mass"]))
    assert mine.finalize() == ref.finalize()
    assert k1.launches == before
    assert int(mine._state["start_idx"][0]) == 0 and not mine._embeds


def test_streaming_recognizer_matches_reference(params):
    """The windowed StreamingRecognizer (offline `encode` over 5 chunks of
    context, masked): every partial text and the final text identical."""
    p, jp = params
    tok, jtok = CharTokenizer.dummy(64), JTok.dummy(64)
    mine = ps.StreamingRecognizer(p, CFG, tok, device="cpu")
    ref = jps.StreamingRecognizer(jp, JCFG, jtok)
    audio = _audio(31, 16000 + 3000)
    for s in range(0, len(audio), 6400):
        assert mine.push_audio(audio[s:s + 6400]) == \
            ref.push_audio(audio[s:s + 6400])
    assert len(mine._embeds) == len(ref._embeds) > 0
    np.testing.assert_allclose(np.stack(mine._embeds), np.stack(ref._embeds),
                               rtol=1e-4, atol=1e-5)
    _assert_off_integers(np.asarray(ref._mass))
    assert mine.finalize() == ref.finalize()
    assert not mine._embeds and len(mine._window) == 0


def test_configs_mirror_reference():
    import dataclasses
    assert dataclasses.asdict(OCFG) == dataclasses.asdict(JOCFG)
    assert (OCFG.window, OCFG.kv_frames) == (9, 16)
    assert dataclasses.asdict(ps.StreamingConfig()) == \
        dataclasses.asdict(jps.StreamingConfig())
    assert po.fused_buf_len(pf.ParaformerConfig(), OCFG) == \
        jpo.fused_buf_len(jpf.ParaformerConfig(), JOCFG) == 4320
