"""The port's voice service vs the reference: the session FSM over both
packages' test engines built from the same parameters, the port's app over
its own `http.App` through a raw RFC 6455 client, the pydantic-free
`VoiceConfig` / `ASRRequest` against the pydantic ones, and hub teardown.

The session parity case runs both packages' engines under
CHUNKED_PIPELINE=0 (partials fetched every tick) and =1 (the serving
default: partials one tick late), with VOICE_AOT_TICKS=0."""
import base64
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from toolbox_for_asr_and_tts_tpu_torch.asr import session as S  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.corrections import (  # noqa: E402
    apply_hard_corrections)
from toolbox_for_asr_and_tts_tpu_torch.runtime import config as C  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.service import engines as E  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.service import hub as H  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.service import schemas  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.utils.audio import encode_wav_bytes  # noqa: E402

from _torch_port_helpers import (  # noqa: E402
    CHUNK, SR, RawWS, ServerThread, _chunks, _http, _hub_thread_set,
    _hub_threads, _pcm, _port_engines_like, _speech)


# ------------------------------------------------------- session parity
def _drive(sess_mod, engines):
    """One scripted session through all four modes; returns its events."""
    sess = sess_mod.StreamingASRSession(engines, use_wake=True, use_sv=True)
    events = [("mode", sess.mode)]
    speech = _chunks(_speech(0, 40))
    silence = [np.zeros(CHUNK, np.float32)] * 7
    it = iter(speech)
    for _ in range(6):                              # wake word
        woke = sess.process_wakeup_chunk(next(it))
        events.append(("wake", woke, sess.mode))
        if woke:
            break
    done = False
    for c in [next(it) for _ in range(8)] + silence:   # enrollment
        done = sess.process_enrollment_chunk(c)["completed"]
        events.append(("enroll", done, sess.mode))
        if done:
            break
    events.append(("start_asr", sess.confirm_start_asr(), sess.mode))
    for c in [next(it) for _ in range(6)] + silence:   # one utterance
        r = sess.process_chunk(c)
        events.append(("chunk", r["is_speech"], r["intermediate_text"],
                       r["should_finalize"]))
        if r["should_finalize"]:
            events.append(("final", sess.finalize()))
            break
    sess.reset_asr_state()
    for c in _chunks(_speech(5, 5)) + silence:         # SV off: plain text
        sess.set_use_sv(False)
        r = sess.process_chunk(c)
        events.append(("chunk", r["is_speech"], r["intermediate_text"],
                       r["should_finalize"]))
        if r["should_finalize"]:
            events.append(("final", sess.finalize()))
            break
    sess.close()
    return events


@pytest.mark.parametrize("pipeline", ["0", "1"])
def test_session_four_modes_match_reference(monkeypatch, pipeline):
    """Wake (a KWS threshold that fires on the first full window) →
    enrollment → start_asr → an utterance with SV on → an utterance with
    SV off: modes, intermediate texts, sentinels and final texts equal,
    with the chunked hubs of both packages unpipelined and pipelined."""
    from toolbox_for_asr_and_tts_tpu.asr import session as JS
    from toolbox_for_asr_and_tts_tpu.service import engines as JE
    monkeypatch.setenv("CHUNKED_PIPELINE", pipeline)
    monkeypatch.setenv("VOICE_AOT_TICKS", "0")
    jeng = JE.build_test_engines()
    jeng.kws.inner.threshold = -1e9
    eng = _port_engines_like(jeng)
    try:
        want = _drive(JS, jeng)
        got = _drive(S, eng)
    finally:
        jeng.close()
        eng.close()
    assert got == want
    kinds = [e[0] for e in got]
    assert ("wake", True, S.WAITING_FOR_ENROLLMENT) in got
    assert ("enroll", True, S.WAITING_FOR_ENROLLMENT_CONFIRM) in got
    assert ("start_asr", True, S.ASR_ACTIVE) in got
    assert kinds.count("final") == 2
    assert any(e[0] == "chunk" and e[2] for e in got)   # partial texts
    assert not _hub_threads()


# ------------------------------------------------------------- the app


@pytest.fixture(scope="module")
def server():
    from toolbox_for_asr_and_tts_tpu_torch.service.voice_app import create_app
    engines = E.build_test_engines(device="cpu")
    app = create_app(engines=engines, cfg=C.VoiceConfig(disable_llm=True))
    srv = ServerThread(app).start()
    srv.engines = engines
    yield srv
    srv.stop()
    assert not _hub_threads()


def test_ws_session_and_error_frames(server):
    """welcome → binary PCM chunks → partials → finalizing → result; an
    invalid JSON text frame and an odd-length binary frame get
    INVALID_JSON / INVALID_PCM_FRAME and the connection stays up."""
    ws = RawWS(server.app.port)
    try:
        hello = ws.recv_json()
        assert hello["type"] == "welcome"
        assert hello["mode"] == S.WAITING_FOR_WAKEUP and hello["use_wake"]
        ws.send(0x1, json.dumps({"use_wake": False, "use_sv": False,
                                 "audio_data": base64.b64encode(
                                     encode_wav_bytes(np.zeros(CHUNK, np.float32),
                                                      SR)).decode()}).encode())
        ws.send(0x1, b"{{{not json")
        msg = ws.recv_json()
        assert msg["type"] == "error" and msg["code"] == "INVALID_JSON"
        ws.send(0x2, b"\x01\x02\x03")
        msg = ws.recv_json()
        assert msg["type"] == "error" and msg["code"] == "INVALID_PCM_FRAME"
        seen = []
        for c in _chunks(_speech(1, 8)) + [np.zeros(CHUNK, np.float32)] * 7:
            ws.send(0x2, _pcm(c))
        while True:
            msg = ws.recv_json()
            seen.append(msg)
            if msg["type"] == "result":
                break
        partials = [m for m in seen if m["type"] == "processing"
                    and m.get("intermediate_text")]
        assert partials, seen
        assert any(m["type"] == "processing" and m["status"] == "finalizing"
                   for m in seen)
        assert seen[-1]["status"] == "completed"
        ws.send(0x1, json.dumps({"type": "end_conversation"}).encode())
        assert ws.recv_json()["status"] == "conversation_ended"
    finally:
        ws.close()


def test_rest_matches_direct_diarize_and_refuses_bad_bodies(server):
    wav = _speech(2, 10)
    b64 = base64.b64encode(encode_wav_bytes(wav, SR)).decode()
    status, out = _http(server.app.port, "POST", "/api/v1/voice/asr",
                        json.dumps({"audio_data": b64,
                                    "use_wake": False}).encode())
    assert status == 200 and out["success"], out
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import base64_to_audio_np
    sents = server.engines.diarizer.diarize(base64_to_audio_np(b64))
    assert out["text"] == apply_hard_corrections("".join(s.text for s in sents))
    assert out["text"]
    for body in (b"{}", json.dumps({"audio_data": 5}).encode(), b"[]",
                 json.dumps({"audio_data": b64, "use_wake": "maybe"}).encode()):
        status, out = _http(server.app.port, "POST", "/api/v1/voice/asr", body)
        assert status == 422 and "validation error" in out["detail"], out
    status, out = _http(server.app.port, "GET", "/health")
    assert status == 200 and out["status"] == "healthy"


# --------------------------------------------- config and schema tables
from toolbox_for_asr_and_tts_tpu.runtime import config as JC  # noqa: E402
from toolbox_for_asr_and_tts_tpu.service import schemas as JSC  # noqa: E402

REQUESTS = [{}, {"audio_data": 1}, {"audio_data": "x"}, {"audio_data": None},
            {"audio_data": ["a"]}, {"audio_data": "x", "use_wake": "yes"},
            {"audio_data": "x", "use_wake": 1}, {"audio_data": "x", "use_wake": 2},
            {"audio_data": "x", "use_wake": 1.0},
            {"audio_data": "x", "use_wake": 0.5},
            {"audio_data": "x", "use_wake": "maybe"},
            {"audio_data": "x", "use_wake": None},
            {"audio_data": "x", "use_llm": "OFF", "save_sample": "t"},
            {"audio_data": "x", "save_sample": None},
            {"audio_data": "x", "sample_id": 5},
            {"audio_data": "x", "sample_id": "s1", "extra": 1},
            [], None, "str"]


@pytest.mark.parametrize("body", REQUESTS, ids=[repr(r) for r in REQUESTS])
def test_asr_request_accepts_and_refuses_as_pydantic(body):
    from pydantic import ValidationError as PydanticError
    try:
        want = JSC.ASRRequest.model_validate(body).model_dump()
    except PydanticError as e:
        want = ("refused", sorted(err["loc"] for err in e.errors()))
    try:
        got = schemas.ASRRequest.model_validate(body).model_dump()
    except schemas.ValidationError as e:
        got = ("refused", sorted(err["loc"] for err in e.errors()))
    assert got == want


CONFIGS = [{}, {"disable_llm": "yes"}, {"server": {"port": "8002"}},
           {"chunk_ms": 3.0}, {"chunk_ms": 3.5}, {"chunk_ms": True},
           {"sv_threshold": 1}, {"sv_threshold": "0.5"}, {"model_dir": 5},
           {"security": {"allowed_hosts": ("a", "b")}},
           {"ssl": {"certfile": None, "enabled": "on"}},
           {"server": {"port": "x"}}, {"server": 3}, {"unknown": 3}]


@pytest.mark.parametrize("kw", CONFIGS, ids=[repr(c) for c in CONFIGS])
def test_voice_config_validates_as_pydantic(kw):
    from pydantic import ValidationError as PydanticError
    try:
        want = JC.VoiceConfig.model_validate(kw).model_dump()
    except PydanticError as e:
        want = ("refused", sorted(err["loc"] for err in e.errors()))
    try:
        got = C.VoiceConfig.model_validate(kw).model_dump()
    except C.ValidationError as e:
        got = ("refused", sorted(err["loc"] for err in e.errors()))
    assert got == want


ENV = [{}, {"VOICE_PORT": "9001", "VOICE_HOST": "127.0.0.1"},
       {"VOICE_DISABLE_LLM": "0", "SSL_ENABLED": "yes",
        "SSL_CERTFILE": "c.pem", "ALLOWED_HOSTS": "a, b,,c"},
       {"VOICE_REQUIRE_WAKE": "TRUE", "GENERATED_DIR": "/tmp/g",
        "VOICE_MODEL_DIR": "/m", "FUNASR_DISABLE_LM": "on"}]


@pytest.mark.parametrize("env", ENV, ids=[repr(e) for e in ENV])
def test_load_voice_config_reads_env_as_reference(monkeypatch, env):
    for k in ("VOICE_PORT", "VOICE_HOST", "VOICE_DISABLE_LLM", "SSL_ENABLED",
              "SSL_CERTFILE", "SSL_KEYFILE", "ALLOWED_HOSTS", "CORS_ORIGINS",
              "VOICE_REQUIRE_WAKE", "GENERATED_DIR", "VOICE_MODEL_DIR",
              "FUNASR_DISABLE_LM", "VOICE_ALWAYS_SAVE_SAMPLE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert C.load_voice_config().model_dump() == \
        JC.load_voice_config().model_dump()


# ------------------------------------------------------------- the hubs
def test_hub_errors_reach_every_caller():
    """A model error in a gather hub's batch raises in the caller (no
    default answer), and the hub keeps serving afterwards."""
    class Boom:
        calls = 0

        def detect_audio_batch(self, windows):
            Boom.calls += 1
            if Boom.calls == 1:
                raise RuntimeError("model failed")
            return [(False, 0.0)] * len(windows)

    hub = H.KwsHub(Boom(), window_ms=1.0, workers=1)
    try:
        with pytest.raises(RuntimeError, match="model failed"):
            hub.detect_audio(np.zeros(10, np.float32))
        assert hub.detect_audio(np.zeros(10, np.float32)) == (False, 0.0)
    finally:
        hub.close()
    assert not any(t.is_alive() for t in hub._threads)


def _tiny_recognizer():
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    return Recognizer.random(
        ParaformerConfig(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
                         encoder_layers=2, decoder_layers=2, vocab_size=64),
        device="cpu")


def _laned_factory(kind):
    """(factory, the same factory's per-session kind) with the env set."""
    if kind == "chunked":
        from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import (
            OnlineRecognizer)
        return E._streaming_factory(_tiny_recognizer(), device="cpu"), \
            H.HubStreamingRecognizer, OnlineRecognizer
    from toolbox_for_asr_and_tts_tpu_torch.asr.vad import StreamingVadStepper
    return E._vad_factory(device="cpu"), H.HubVadStepper, StreamingVadStepper


@pytest.mark.parametrize("kind", ["chunked", "vad"])
def test_tick_lanes_join_at_capacity_and_overflow(monkeypatch, kind):
    """VOICE_TICK_LANES=2 with 4 rows in all: six concurrent joins fill each
    lane to its 2 rows and overflow twice to per-session engines; a laned
    session answers as a one-lane hub's session on the same chunks; leaving
    frees the rows, and no lane's tick thread outlives close."""
    before = _hub_thread_set()
    monkeypatch.setenv("VOICE_AOT_TICKS", "0")
    monkeypatch.setenv("VOICE_BATCH_CAPACITY", "4")
    monkeypatch.setenv("VOICE_TICK_LANES", "2")
    factory, on_hub, own = _laned_factory(kind)
    hub = factory.hub
    monkeypatch.setenv("VOICE_TICK_LANES", "1")
    one, _, _ = _laned_factory(kind)
    try:
        assert isinstance(hub, H.LanedHub) and hub.n == 2
        made = [None] * 6
        gate = threading.Barrier(6)

        def join(i):
            gate.wait()
            made[i] = factory()

        threads = [threading.Thread(target=join, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        laned = [m for m in made if isinstance(m, on_hub)]
        assert len(laned) == 4 and hub._live == [2, 2]
        assert len({m.slot for m in laned}) == 4
        assert sum(isinstance(m, own) for m in made) == 2
        ref = one()
        sess = next(m for m in laned if m.slot % 2 == 1)
        feed = (lambda m, c: m.push_audio(c)) if kind == "chunked" else \
            (lambda m, c: m(c))
        got = [feed(sess, c) for c in _chunks(_speech(3, 8))]
        want = [feed(ref, c) for c in _chunks(_speech(3, 8))]
        assert got == want
        assert any(got)
        for m in laned:
            m.close()
        ref.close()
        assert hub._live == [0, 0]
    finally:
        hub.close()
        one.hub.close()
    assert _hub_thread_set() <= before


def _calls_of(monkeypatch):
    """Count the kernel wrappers' calls (on the CPU they run the plain
    versions): the stand-in for the card's launch counters."""
    from toolbox_for_asr_and_tts_tpu_torch.ops import frontend, nn
    calls = {"k1": 0, "k2": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(nn, "fsmn_depthwise",
                        counting("k1", nn.fsmn_depthwise))
    monkeypatch.setattr(frontend, "frame_window",
                        counting("k2", frontend.frame_window))
    return calls


def test_models_count_the_programs_that_launch_the_kernels(monkeypatch):
    """The program counters that `chip_smoke.py` holds each served run's
    launches to: K1 once per layer of a transcribe (encoder and decoder), a
    rescoring (decoder), a punctuate forward, a KWS forward and a VAD step;
    K2 once per transcribe, embed, KWS fbank and VAD fbank."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier
    from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad
    from toolbox_for_asr_and_tts_tpu_torch.models.ct_transformer import (
        Punctuator)
    from toolbox_for_asr_and_tts_tpu_torch.models.kws_ctc import KeywordSpotter
    from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (
        BatchedVadTicker)
    calls = _calls_of(monkeypatch)
    reco = _tiny_recognizer()
    sv, punc = SpeakerVerifier.random(device="cpu"), Punctuator.random(
        device="cpu")
    kws = KeywordSpotter.random(device="cpu")
    vcfg = fsmn_vad.FsmnVadConfig()
    vad = BatchedVadTicker(fsmn_vad.init_params(
        vcfg, torch.Generator().manual_seed(1)), vcfg, capacity=4,
        device="cpu")
    enc, dec = reco.cfg.encoder_layers, reco.cfg.decoder_layers

    def counts():
        return dict(transcribes=reco.forwards.n, rescorings=reco.rescorings.n,
                    punctuate=punc.forwards.n, embeds=sv.forwards.n,
                    kws=kws.forwards.n, kws_fbanks=kws.fbanks.n,
                    vad_steps=vad.steps, vad_fbanks=vad.fbanks)

    def run(fn, **want):
        before = counts()
        calls.update(k1=0, k2=0)
        fn()
        n = {k: v - before[k] for k, v in counts().items()}
        assert {k: v for k, v in n.items() if v} == want
        assert calls["k1"] == ((enc + dec) * n["transcribes"]
                               + dec * n["rescorings"]
                               + punc.cfg.num_layers * n["punctuate"]
                               + kws.cfg.num_layers * n["kws"]
                               + vcfg.fsmn_layers * n["vad_steps"])
        assert calls["k2"] == (n["transcribes"] + n["embeds"]
                               + n["kws_fbanks"] + n["vad_fbanks"])

    speech = _speech(6, 10)
    run(lambda: reco.transcribe([speech, speech[:CHUNK * 4]]), transcribes=1)
    run(lambda: reco.warmup_rescoring(1, SR), rescorings=1)
    run(lambda: punc.punctuate_many(["一二三", "四" * 40, "五六"]),
        punctuate=2)
    run(lambda: sv.embed([speech[:SR], speech[:2 * SR]]), embeds=1)
    run(lambda: kws.detect_audio_batch([speech[:25600]] * 3 + [speech[:SR]]),
        kws=2, kws_fbanks=2)
    slots = [vad.join() for _ in range(2)]
    run(lambda: vad.tick({s: c for s, c in zip(slots, _chunks(speech))}),
        vad_steps=1, vad_fbanks=1)


SERVING = [{}, {"VOICE_TICK_LANES": "2"}, {"VOICE_BATCH_SERVING": "0"},
           {"VOICE_STREAMING_IMPL": "windowed"}]


@pytest.mark.parametrize("env", SERVING, ids=[repr(e) for e in SERVING])
def test_serving_options_give_the_same_final(monkeypatch, env):
    """`build_test_engines` under each serving option: one utterance with
    wake and SV off gets partial texts and the final text of a direct
    `Diarizer.diarize` of the speech it buffered."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.diarization import Diarizer
    before = _hub_thread_set()
    monkeypatch.setenv("VOICE_AOT_TICKS", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    engines = E.build_test_engines(device="cpu")
    try:
        batched = env.get("VOICE_BATCH_SERVING") != "0"
        assert isinstance(engines.diarizer, H.FinalizeHub) == batched
        assert bool(_hub_thread_set() - before) == batched
        if "VOICE_TICK_LANES" in env:
            assert isinstance(engines.streaming_factory.hub, H.LanedHub)
        sess = S.StreamingASRSession(engines, use_wake=False, use_sv=False)
        partials, final = [], None
        for c in _chunks(_speech(4, 10)) + [np.zeros(CHUNK, np.float32)] * 7:
            r = sess.process_chunk(c)
            partials.append(r["intermediate_text"])
            if r["should_finalize"]:
                wav = sess.audio_buffer.copy()
                final = sess.finalize()
                break
        sess.close()
        inner = engines.diarizer.inner if batched else engines.diarizer
        assert isinstance(inner, Diarizer)
        want = "".join(s.text for s in inner.diarize(wav, need_spk=False))
        assert final == want and final
        assert any(partials)
    finally:
        engines.close()
    assert _hub_thread_set() <= before


def test_build_engines_refuses_a_mounted_checkpoint(tmp_path):
    """A resolvable checkpoint directory that holds no checkpoint raises
    FileNotFoundError before any hub is built: random weights never stand
    in for a mounted model."""
    before = _hub_threads()
    (tmp_path / "speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404"
     ).mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        E.build_engines(str(tmp_path), device="cpu")
    assert _hub_threads() == before


def test_build_engines_serves_mounted_checkpoints(tmp_path, monkeypatch):
    """Every family under a mounted root loads from its directory (the
    partials from the online checkpoint, the VAD with its am.mvn), the app
    serves a REST request on those weights, and closing it leaves no hub
    thread."""
    import test_torch_port_checkpoints as T
    from toolbox_for_asr_and_tts_tpu_torch.models import (
        campplus, ct_transformer, fsmn_vad, kws_ctc, paraformer)
    from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ckpt
    from toolbox_for_asr_and_tts_tpu_torch.service.voice_app import create_app
    monkeypatch.setenv("VOICE_BATCH_CAPACITY", "4")
    monkeypatch.setenv("VOICE_AOT_TICKS", "0")
    before = _hub_threads()
    g = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    pcfg = paraformer.ParaformerConfig(**T.PARA)
    prules = ckpt.paraformer_rules(pcfg.encoder_layers, pcfg.decoder_layers)
    trees = {"offline": paraformer.init_params(pcfg, g(1)),
             "online": paraformer.init_params(pcfg, g(2))}
    T._paraformer_dir(tmp_path, ckpt.invert_to_state_dict(
        trees["offline"], prules), pcfg)
    T._paraformer_dir(tmp_path, ckpt.invert_to_state_dict(
        trees["online"], prules), pcfg,
        name="speech_paraformer-large_asr_nat-zh-cn-16k-common-vocab8404-"
             "online")
    vcfg = fsmn_vad.FsmnVadConfig(**T.VAD)
    trees["vad"] = fsmn_vad.init_params(vcfg, g(3))
    T._vad_dir(tmp_path, ckpt.invert_to_state_dict(
        trees["vad"], ckpt.fsmn_vad_rules(vcfg.fsmn_layers)), vcfg)
    ccfg = ct_transformer.CTTransformerConfig(**T.PUNC)
    trees["punc"] = ct_transformer.init_params(ccfg, g(4))
    T._punc_dir(tmp_path, ckpt.invert_to_state_dict(
        trees["punc"], ckpt.ct_transformer_rules(ccfg.num_layers)), ccfg)
    kcfg = kws_ctc.KwsConfig(**T.KWS)
    trees["kws"] = kws_ctc.init_params(kcfg, g(5))
    T._kws_dir(tmp_path, ckpt.invert_to_state_dict(
        trees["kws"], ckpt.kws_rules(kcfg.num_layers, kcfg.rorder)), kcfg)
    scfg = campplus.CampPlusConfig()     # the loader's default: full width
    trees["sv"] = campplus.init_params(scfg, g(6))
    T._save(ckpt.invert_to_state_dict(
        trees["sv"], ckpt.campplus_rules(scfg.block_layers)),
        tmp_path / "speech_campplus_sv_zh-cn_16k-common" / "model.pt")

    engines = E.build_engines(str(tmp_path), device="cpu")
    srv = None
    try:
        diar = engines.diarizer.inner
        loaded = {"offline": diar.recognizer.params,
                  "online": engines.streaming_factory.hub.ticker.params,
                  "vad": engines.vad_factory.hub.ticker.params,
                  "punc": diar.punctuator.params,
                  "kws": engines.kws.inner.params,
                  "sv": engines.verifier.params}
        for name, tree in trees.items():
            want, got = ckpt.flatten_params(tree), ckpt.flatten_params(
                loaded[name])
            assert sorted(got) == sorted(want), name
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name} {k}")
        assert engines.vad_factory.hub.ticker.cmvn is not None
        assert diar.recognizer.cmvn is not None
        assert diar.recognizer.tokenizer.tokens == T._tokens(pcfg.vocab_size)
        srv = ServerThread(create_app(
            engines=engines, cfg=C.VoiceConfig(disable_llm=True))).start()
        wav = _speech(2, 10)
        b64 = base64.b64encode(encode_wav_bytes(wav, SR)).decode()
        status, out = _http(srv.app.port, "POST", "/api/v1/voice/asr",
                            json.dumps({"audio_data": b64,
                                        "use_wake": False}).encode())
        assert status == 200 and out["success"], out
        from toolbox_for_asr_and_tts_tpu_torch.utils.audio import (
            base64_to_audio_np)
        sents = diar.diarize(base64_to_audio_np(b64))
        assert out["text"] == apply_hard_corrections(
            "".join(s.text for s in sents))
    finally:
        if srv is not None:
            srv.stop()
        else:
            engines.close()
    assert _hub_threads() == before


def test_serve_outlives_a_slow_shutdown():
    """A server thread whose loop runs `app.serve()` to completion keeps
    the loop up until the coroutine that called `shutdown()` has finished,
    so that coroutine's result always arrives (it hung when `serve()`
    returned first and the loop stopped under it)."""
    import asyncio
    from toolbox_for_asr_and_tts_tpu_torch.service.http import App

    class SlowStop(App):
        async def shutdown(self):
            await super().shutdown()
            await asyncio.sleep(0.2)   # work after the listener closed
            return "stopped"

    app = SlowStop("slow-stop")
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=lambda: loop.run_until_complete(
        app.serve("127.0.0.1", 0)), daemon=True)
    th.start()
    for _ in range(400):
        if getattr(app, "port", None):
            break
        time.sleep(0.01)
    assert asyncio.run_coroutine_threadsafe(app.shutdown(),
                                            loop).result(10) == "stopped"
    th.join(10)
    assert not th.is_alive()
    loop.close()
