"""The port's TTS service vs the reference: the copied text front end, the
`Synthesizer` (NAR and PNCA, both groupings) on the reference's parameters,
the stream against one-shot synthesis, the job manager, the TTS app over
the port's `http.App` through a raw RFC 6455 client, and the pydantic-free
`TTSConfig` / `TTSRequest` / `CancelRequest` against the pydantic ones.

Mirrors, on the port: the reference's `tests/test_tts.py` (front-end golden
sets, `test_synthesize_end_to_end`, `test_synthesize_empty`,
`test_job_manager_lifecycle`, `test_job_ttl_sweep`, `test_job_cancel`) and
`tests/test_tts_stream.py` (`test_stream_matches_one_shot`,
`test_stream_cancel_stops_early`, `test_stream_empty_text`,
`test_job_partial_results`, `test_job_partial_poll_reuses_encoded_prefix`,
`test_job_cancel_mid_stream`, `test_ws_stream_matches_job_api`,
`test_ws_stream_bad_request`).

PCM is compared as int16 samples: the port's waveform within 1 LSB of the
reference's, per-segment sample counts equal."""
import ast
import base64
import dataclasses
import json
import os
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from test_torch_port_service import RawWS, ServerThread, _http  # noqa: E402
from toolbox_for_asr_and_tts_tpu.runtime import config as JC  # noqa: E402
from toolbox_for_asr_and_tts_tpu.service import schemas as JSC  # noqa: E402
from toolbox_for_asr_and_tts_tpu.tts import text_frontend as JF  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import hifigan as TH  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import sambert as TS  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import config as C  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.service import schemas  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tts import text_frontend as TF  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tts.jobs import TTSJobManager  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.utils.audio import decode_wav_bytes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = "今天天气很好。病人血压一百二，心率正常,没有出血。请多休息，按时吃药。谢谢。"
GROUPING_ENV = ("TTS_GROUP_BY_LENGTH", "TTS_MEL_GROUP", "TTS_DECODER")


def _golden_sets():
    """The Chinese strings of each test of the reference's
    `tests/test_tts.py`, by test name (its golden sets and sentences)."""
    with open(os.path.join(ROOT, "tests", "test_tts.py"),
              encoding="utf-8") as f:
        tree = ast.parse(f.read())
    cjk = re.compile("[一-鿿]")
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            texts = [n.value for n in ast.walk(node)
                     if isinstance(n, ast.Constant) and isinstance(n.value, str)
                     and cjk.search(n.value)]
            if texts:
                out[node.name] = texts
    return out


GOLDEN = _golden_sets()


# ------------------------------------------------------------ front end
@pytest.fixture(scope="module")
def g2ps():
    return (JF.G2P(), JF.LingVocab.default()), (TF.G2P(), TF.LingVocab.default())


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_front_end_matches_reference(g2ps, name):
    """Normalization, segments, pauses, pinyin and the four-stream ids of
    the copied front end equal the reference's on each golden set."""
    (jg, jv), (tg, tv) = g2ps
    assert len(tv) == len(jv)
    for text in GOLDEN[name]:
        assert TF.normalize_text(text) == JF.normalize_text(text)
        for targets in ((18, 14, 22), (6, 4, 8)):
            segs = TF.split_text_for_tts(text, *targets)
            assert segs == JF.split_text_for_tts(text, *targets)
            assert [TF.pause_after(s) for s in segs] == \
                [JF.pause_after(s) for s in segs]
        assert tg.pinyin(text) == jg.pinyin(text)
        assert TF.text_to_ling_ids(text, tg, tv) == \
            JF.text_to_ling_ids(text, jg, jv)


# ---------------------------------------------------- synthesizer parity
def _set_env(env):
    saved = {k: os.environ.get(k) for k in GROUPING_ENV}
    os.environ.update(env)
    return saved


def _restore_env(saved):
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def _port_like(jsynth):
    """The port's Synthesizer on the reference synthesizer's parameters."""
    tree = lambda t: params_from_numpy(jax.tree.map(np.asarray, t),  # noqa: E731
                                       device="cpu")
    return Synthesizer(
        tree(jsynth.ap), TS.SambertConfig(**dataclasses.asdict(jsynth.acfg)),
        tree(jsynth.vp), TH.HifiGanConfig(**dataclasses.asdict(jsynth.vcfg)),
        device="cpu")


@pytest.fixture(scope="module", params=["nar", "pnca"])
def pair(request):
    """(reference, port) tiny synthesizers with one parameter tree, built
    under TTS_DECODER=mode (the groupings are set per test)."""
    from toolbox_for_asr_and_tts_tpu.tts.synthesizer import Synthesizer as J
    saved = _set_env({"TTS_DECODER": request.param, "TTS_GROUP_BY_LENGTH": "0",
                      "TTS_MEL_GROUP": "0"})
    try:
        jsynth = J.random(tiny=True)
        port = _port_like(jsynth)
    finally:
        _restore_env(saved)
    assert jsynth.decoder_mode == port.decoder_mode == request.param
    return jsynth, port


def _pcm(wav):
    return np.round(np.asarray(wav, np.float64) * 32767.0).astype(np.int64)


@pytest.mark.parametrize("per_segment", [False, True],
                         ids=["whole_batch", "per_segment"])
def test_synthesize_matches_reference(pair, per_segment):
    jsynth, port = pair
    for s in pair:
        s.group_by_length = s.mel_group = per_segment
    want = jsynth.synthesize(TEXT)
    probes, synths = port.probes.n, port.synths.n
    got = port.synthesize(TEXT)
    assert got.segments == want.segments and len(got.segments) >= 3
    assert got.seg_durations_s == want.seg_durations_s
    assert got.sample_rate == want.sample_rate == 16000
    assert got.wav.dtype == np.float32 and len(got.wav) == len(want.wav)
    assert np.abs(_pcm(got.wav) - _pcm(want.wav)).max() <= 1
    assert np.abs(got.wav).max() <= 1.0 and got.rtf > 0
    # one probe per phone-bucket group, one synth per (group, mel bucket)
    assert port.probes.n - probes == (2 if per_segment else 1)
    assert port.synths.n - synths >= port.probes.n - probes


def test_synthesize_empty_and_cancelled(pair):
    _, port = pair
    res = port.synthesize("")
    assert res is not None and len(res.wav) == 0 and res.segments == []
    assert port.synthesize(TEXT, cancelled=lambda: True) is None


# ---------------------------------------------------- stream vs one-shot
@pytest.fixture(scope="module")
def synth():
    """The port's tiny synthesizer with per-segment grouping: each segment
    runs in its own (phone bucket, mel bucket) group, as the reference's
    stream tests pin it."""
    saved = _set_env({"TTS_GROUP_BY_LENGTH": "1", "TTS_MEL_GROUP": "1",
                      "TTS_DECODER": "nar"})
    try:
        s = Synthesizer.random(tiny=True, device="cpu")
    finally:
        _restore_env(saved)
    assert s.group_by_length and s.mel_group
    return s


def _stream_vs_one_shot(synth):
    ref = synth.synthesize(TEXT)
    events = list(synth.synthesize_stream(TEXT))
    assert events[-1]["event"] == "done"
    assert [e["event"] for e in events[:-1]] == ["chunk"] * (len(events) - 1)
    idxs = [e["segment_index"] for e in events[:-1]]
    assert idxs == sorted(idxs)
    assert events[0]["n_segments"] == len(ref.segments)
    assert events[-1]["segments"] == ref.segments
    return np.concatenate([e["audio"] for e in events]), ref.wav


def test_stream_matches_one_shot_exactly(synth):
    """Concatenated chunks equal `synthesize()` sample for sample. The first
    segment runs alone in the stream and beside another segment of its
    buckets in the one-shot job, so the convolutions must not depend on the
    batch size: PyTorch's native CPU convolutions do not, oneDNN's do (see
    the next test), so this one runs with oneDNN off."""
    with torch.backends.mkldnn.flags(enabled=False):
        got, want = _stream_vs_one_shot(synth)
    assert np.array_equal(got, want)


def test_stream_against_one_shot_with_onednn(synth):
    """With oneDNN's convolutions (PyTorch's CPU default), which pick their
    algorithm by batch size, the stream keeps every length and stays within
    1 LSB of the one-shot job; the card's cuDNN is held to the same."""
    got, want = _stream_vs_one_shot(synth)
    assert len(got) == len(want)
    assert np.abs(_pcm(got) - _pcm(want)).max() <= 1


def test_stream_cancel_stops_early(synth):
    calls = {"n": 0}

    def cancelled():
        calls["n"] += 1
        return calls["n"] > 1   # the first batch only

    events = list(synth.synthesize_stream(TEXT, cancelled=cancelled))
    assert events and all(e["event"] == "chunk" for e in events)
    assert len(events) < len(synth.synthesize(TEXT).segments)


def test_stream_empty_text(synth):
    events = list(synth.synthesize_stream("   "))
    assert len(events) == 1 and events[0]["event"] == "done"
    assert len(events[0]["audio"]) == 0


# ----------------------------------------------------------- job manager
def _job_threads():
    return [t for t in threading.enumerate() if t.name.startswith("tts-job")]


def _wait(mgr, job_id, partial=False, until=("completed", "error")):
    for _ in range(600):
        r = mgr.get_result(job_id, partial=partial)
        if r["status"] in until:
            return r
        time.sleep(0.02)
    raise AssertionError(f"job {job_id} stuck at {r['status']}")


def _decode(b64):
    wav, sr = decode_wav_bytes(base64.b64decode(b64))
    assert sr == 16000
    return wav[:, 0]


@pytest.mark.parametrize("stream_jobs", ["1", "0"])
def test_job_manager_lifecycle(synth, monkeypatch, stream_jobs):
    """start → completed with the one-shot job's audio (streamed or not)
    → cleanup; `close` stops the workers."""
    monkeypatch.setenv("TTS_STREAM_JOBS", stream_jobs)
    mgr = TTSJobManager(synth, max_workers=2)
    try:
        assert mgr.stream_jobs == (stream_jobs == "1")
        job_id = mgr.start_task("你好。测试语音合成。")
        r = _wait(mgr, job_id)
        assert r["status"] == "completed", r["error"]
        assert r["detailed_timing"]["rtf"] > 0
        with torch.backends.mkldnn.flags(enabled=False):
            one_shot = synth.synthesize("你好。测试语音合成。")
            want = one_shot.wav
            r = mgr.get_result(mgr.start_task("你好。测试语音合成。"))
            r = _wait(mgr, r["job_id"])
        assert r["segments_done"] == r["n_segments"] == len(one_shot.segments)
        got = _decode(r["audio_base64"])
        assert len(got) == len(want)
        # the WAV holds the float wav as int16 (×32767 then /32768)
        assert np.abs(np.round(got * 32768.0) - _pcm(want)).max() <= 1
        assert mgr.cleanup_job(job_id) and mgr.get_result(job_id) is None
        assert not mgr.cleanup_job(job_id)
    finally:
        mgr.close()
    assert not _job_threads()


def test_job_ttl_sweep(synth):
    mgr = TTSJobManager(synth, max_workers=1, job_ttl_s=0.2)
    try:
        job_id = mgr.start_task("你好。")
        assert _wait(mgr, job_id)["status"] == "completed"
        time.sleep(0.3)
        other = mgr.start_task("第二个任务。")     # sweeps on start
        assert mgr.get_result(job_id) is None
        assert mgr.get_result(other) is not None  # pending jobs stay
    finally:
        mgr.close()


def test_job_cancel_queued(synth):
    mgr = TTSJobManager(synth, max_workers=1)
    try:
        mgr.start_task("一" * 200)
        b = mgr.start_task("二" * 200)    # queued behind the first
        assert mgr.cancel_task(b)
        assert not mgr.cancel_task("nope")
        time.sleep(0.2)
        assert mgr.get_result(b)["status"] == "cancelled"
    finally:
        mgr.close()


class _StubSynth:
    """A synthesize_stream with a gate between its two segments, for the
    manager's progressive state."""

    sample_rate = 16000

    def __init__(self):
        self.gate = threading.Event()
        self.chunk = np.ones(1600, np.float32) * 0.1

    def synthesize_stream(self, text, voice="zhitian_emo",
                          cancelled=lambda: False):
        yield {"event": "chunk", "audio": self.chunk, "segment_index": 0,
               "n_segments": 2, "text": "a"}
        self.gate.wait(timeout=10)
        if cancelled():
            return
        yield {"event": "chunk", "audio": self.chunk * 2, "segment_index": 1,
               "n_segments": 2, "text": "b"}
        yield {"event": "done", "audio": np.zeros(0, np.float32), "rtf": 0.01,
               "duration_s": 0.2, "segments": ["a", "b"],
               "seg_times_ms": [1.0, 1.0], "seg_durations_s": [0.1, 0.1]}


def _first_chunk(mgr, job_id):
    for _ in range(300):
        r = mgr.get_result(job_id, partial=True)
        if r["segments_done"] >= 1:
            return r
        time.sleep(0.02)
    raise AssertionError("no chunk published")


def test_job_partial_results_and_cached_prefix():
    """?partial=1 while processing gives the audio so far (a prefix of the
    final WAV), re-encoded only when a chunk arrives; a plain poll gives no
    audio until the job completes."""
    stub = _StubSynth()
    mgr = TTSJobManager(stub, max_workers=1)
    try:
        job_id = mgr.start_task("ab")
        r = _first_chunk(mgr, job_id)
        assert r["status"] == "processing" and r["n_segments"] == 2
        partial = _decode(r["audio_base64"])
        assert np.allclose(partial, stub.chunk, atol=2e-4)
        assert mgr.get_result(job_id, partial=True)["audio_base64"] \
            is r["audio_base64"]
        plain = mgr.get_result(job_id)
        assert plain["audio_base64"] is None and plain["segments_done"] >= 1
        stub.gate.set()
        r = _wait(mgr, job_id)
        final = _decode(r["audio_base64"])
        assert len(final) == 3200 and np.allclose(final[:1600], partial,
                                                  atol=2e-4)
        assert r["segments_done"] == r["n_segments"] == 2
        assert r["detailed_timing"]["rtf"] == 0.01
    finally:
        stub.gate.set()
        mgr.close()


def test_job_cancel_mid_stream():
    stub = _StubSynth()
    mgr = TTSJobManager(stub, max_workers=1)
    try:
        job_id = mgr.start_task("ab")
        _first_chunk(mgr, job_id)
        assert mgr.cancel_task(job_id)
        stub.gate.set()
        time.sleep(0.2)
        r = mgr.get_result(job_id)
        assert r["status"] == "cancelled" and r["audio_base64"] is None
    finally:
        stub.gate.set()
        mgr.close()


# ------------------------------------------------------------------ app
@pytest.fixture(scope="module")
def tts_server(synth):
    from toolbox_for_asr_and_tts_tpu_torch.service.tts_app import create_app
    srv = ServerThread(create_app(synthesizer=synth,
                                  cfg=C.TTSConfig())).start()
    yield srv
    srv.stop()
    assert not _job_threads()


def _json(port, method, path, obj=None):
    body = b"" if obj is None else json.dumps(obj).encode()
    return _http(port, method, path, body)


def test_rest_start_poll_cancel_delete(tts_server):
    port = tts_server.app.port
    status, out = _json(port, "POST", "/api/v1/tts/start", {"text": TEXT})
    assert status == 200 and out["status"] == "pending", out
    job_id = out["job_id"]
    for _ in range(600):
        status, body = _json(port, "GET",
                             f"/api/v1/tts/result/{job_id}?partial=1")
        assert status == 200
        if body["status"] in ("completed", "error"):
            break
        time.sleep(0.05)
    assert body["status"] == "completed", body
    assert body["audio_size"] == len(body["audio_base64"]) > 0
    assert "detailed_timing" not in body
    status, _ = _json(port, "POST", "/api/v1/tts/cancel", {"job_id": job_id})
    assert status == 404                         # finished jobs stay finished
    status, out = _json(port, "DELETE", f"/api/v1/tts/jobs/{job_id}")
    assert status == 200 and out["message"] == "job cleaned up"
    for method, path in (("GET", f"/api/v1/tts/result/{job_id}"),
                         ("DELETE", f"/api/v1/tts/jobs/{job_id}")):
        assert _json(port, method, path)[0] == 404
    status, out = _json(port, "GET", "/health")
    assert status == 200 and out["model_loaded"] and out["active_jobs"] == 0
    assert _json(port, "GET", "/")[1]["engine"] == \
        "toolbox_for_asr_and_tts_tpu_torch"


@pytest.mark.parametrize("path,body,code", [
    ("/api/v1/tts/start", {}, 422),
    ("/api/v1/tts/start", {"text": 5}, 422),
    ("/api/v1/tts/start", [], 422),
    ("/api/v1/tts/start", {"text": "hi", "voice": None}, 422),
    ("/api/v1/tts/start", {"text": "   "}, 400),
    ("/api/v1/tts/cancel", {}, 422),
    ("/api/v1/tts/cancel", {"job_id": "nope"}, 404),
])
def test_rest_refusals(tts_server, path, body, code):
    status, out = _json(tts_server.app.port, "POST", path, body)
    assert status == code, out
    if code == 422:
        assert "validation error" in out["detail"], out


def _ws_stream(port, text):
    ws = RawWS(port, path="/api/v1/tts/ws")
    try:
        ws.send(0x1, json.dumps({"text": text}).encode())
        pcm, msgs = [], []
        while True:
            msg = ws.recv_json()
            msgs.append(msg)
            assert msg["type"] != "error", msg
            if msg["type"] == "done":
                break
            assert msg["sample_rate"] == 16000
            pcm.append(np.frombuffer(base64.b64decode(msg["pcm16_base64"]),
                                     "<i2"))
        return np.concatenate(pcm), msgs
    finally:
        ws.close()


def test_ws_stream_equals_job_wav(tts_server):
    """The WS chunks' pcm16, concatenated, equal the REST job's WAV samples
    (the same synthesizer, the same programs), with the crossfade tail as
    its own chunk one index past the segments."""
    port = tts_server.app.port
    streamed, msgs = _ws_stream(port, TEXT)
    done = msgs[-1]
    assert done["n_segments"] >= 3
    chunks = [m for m in msgs if m["type"] == "chunk"]
    assert chunks[-1].get("tail") and \
        chunks[-1]["segment_index"] == done["n_segments"]
    _, out = _json(port, "POST", "/api/v1/tts/start", {"text": TEXT})
    for _ in range(600):
        _, body = _json(port, "GET", f"/api/v1/tts/result/{out['job_id']}")
        if body["status"] in ("completed", "error"):
            break
        time.sleep(0.05)
    assert body["status"] == "completed", body
    final = np.round(_decode(body["audio_base64"]) * 32768.0).astype(np.int64)
    assert np.array_equal(streamed.astype(np.int64), final)


@pytest.mark.parametrize("frame", [json.dumps({"text": "   "}).encode(),
                                   json.dumps({"voice": "x"}).encode(),
                                   b"{{not json"], ids=["empty", "no_text",
                                                        "not_json"])
def test_ws_stream_bad_request(tts_server, frame):
    ws = RawWS(tts_server.app.port, path="/api/v1/tts/ws")
    try:
        ws.send(0x1, frame)
        assert ws.recv_json()["type"] == "error"
    finally:
        ws.close()


def test_create_app_refuses_a_mounted_checkpoint(tmp_path):
    """A resolvable `tts` checkpoint directory without a checkpoint pair
    raises FileNotFoundError at `create_app`, before any request or job
    worker: random weights never stand in for a mounted model."""
    from toolbox_for_asr_and_tts_tpu_torch.service.tts_app import create_app
    before = _job_threads()
    (tmp_path / "speech_sambert-hifigan_tts_zh-cn_16k").mkdir()
    with pytest.raises(FileNotFoundError, match="no acoustic/vocoder"):
        create_app(cfg=C.TTSConfig(model_dir=str(tmp_path)))
    assert _job_threads() == before


def test_create_app_serves_a_mounted_checkpoint(tmp_path, monkeypatch):
    """A mounted package (TTS_MODEL_DIR's root) loads once at `create_app`
    and serves a REST job in PNCA mode whose WAV equals a direct
    `synthesize` on the loaded weights."""
    from test_torch_port_tts_checkpoints import (am_state_dict,
                                                 voc_state_dict,
                                                 write_package)
    from toolbox_for_asr_and_tts_tpu_torch.service.tts_app import create_app
    write_package(tmp_path / "speech_sambert-hifigan_tts_zh-cn_16k",
                  am_state_dict("invert"), voc_state_dict())
    for k in GROUPING_ENV:
        monkeypatch.delenv(k, raising=False)
    before = _job_threads()
    calls = []
    load = Synthesizer.from_model_dir.__func__
    monkeypatch.setattr(Synthesizer, "from_model_dir", classmethod(
        lambda cls, d, **kw: calls.append(d) or load(cls, d, device="cpu",
                                                     **kw)))
    app = create_app(cfg=C.TTSConfig(model_dir=str(tmp_path)))
    assert calls == [str(tmp_path / "speech_sambert-hifigan_tts_zh-cn_16k")]
    srv = ServerThread(app).start()
    try:
        synth = app.manager().synth
        assert synth.decoder_mode == "pnca" and synth.acfg.d_model == 32
        status, out = _json(srv.app.port, "POST", "/api/v1/tts/start",
                            {"text": "今天天气很好。"})
        assert status == 200, out
        for _ in range(600):
            _, body = _json(srv.app.port, "GET",
                            f"/api/v1/tts/result/{out['job_id']}")
            if body["status"] in ("completed", "error"):
                break
            time.sleep(0.05)
        assert body["status"] == "completed", body
        want = synth.synthesize("今天天气很好。").wav
        got = _decode(body["audio_base64"])
        assert len(got) == len(want) > 0
        assert np.abs(np.round(got * 32768.0)
                      - np.round(want * 32768.0)).max() <= 1
    finally:
        srv.stop()
    assert calls == [str(tmp_path / "speech_sambert-hifigan_tts_zh-cn_16k")]
    assert _job_threads() == before


# --------------------------------------------- config and schema tables
# the reference TTSConfig's knobs that neither package reads; the port
# leaves them out
TTS_LEFT_OUT = ("beam_size", "parallel_segments", "max_parallel_segments",
                "use_batch", "default_voice")


def _ported(dump):
    return {k: v for k, v in dump.items() if k not in TTS_LEFT_OUT}


def _both_validate(jcls, tcls, data):
    from pydantic import ValidationError as PydanticError
    try:
        want = _ported(jcls.model_validate(data).model_dump())
    except PydanticError as e:
        want = ("refused", sorted(err["loc"] for err in e.errors()))
    try:
        got = tcls.model_validate(data).model_dump()
    except schemas.ValidationError as e:
        got = ("refused", sorted(err["loc"] for err in e.errors()))
    return got, want


BODIES = [("TTSRequest", {}), ("TTSRequest", {"text": "a"}),
          ("TTSRequest", {"text": 5}), ("TTSRequest", {"text": b"ab"}),
          ("TTSRequest", {"text": "a", "voice": None}),
          ("TTSRequest", {"text": "a", "voice": "zhizhe_emo", "x": 1}),
          ("TTSRequest", []), ("CancelRequest", {"job_id": "j"}),
          ("CancelRequest", {"job_id": 3}), ("CancelRequest", {}),
          ("TTSResponse", {"job_id": "j"}),
          ("TTSResponse", {"job_id": "j", "status": "done", "message": 1})]


@pytest.mark.parametrize("name,body", BODIES,
                         ids=[f"{n}:{b!r}" for n, b in BODIES])
def test_tts_schemas_accept_and_refuse_as_pydantic(name, body):
    got, want = _both_validate(getattr(JSC, name), getattr(schemas, name),
                               body)
    assert got == want


TTS_CONFIGS = [{}, {"server": {"port": "7002"}}, {"batch_size": 4.0},
               {"batch_size": 4.5}, {"ssl": {"enabled": "off"}},
               {"crossfade_ms": "x"}, {"ssl": {"enabled": "yes"}},
               {"model_dir": 3}, {"unknown": 1}]


@pytest.mark.parametrize("kw", TTS_CONFIGS, ids=[repr(c) for c in TTS_CONFIGS])
def test_tts_config_validates_as_pydantic(kw):
    got, want = _both_validate(JC.TTSConfig, C.TTSConfig, kw)
    assert got == want


TTS_ENV = [{}, {"TTS_PORT": "7100", "TTS_HOST": "127.0.0.1",
                "TTS_BATCH_SIZE": "4", "TTS_MAX_JOBS": "3"},
           {"TTS_SEG_TARGET": "10", "TTS_SEG_FIRST": "8",
            "TTS_SEG_HARD_MAX": "12", "TTS_CROSSFADE_MS": "0",
            "TTS_PAUSE_SOFT_MS": "90", "SSL_ENABLED": "1",
            "SSL_KEYFILE": "k.pem", "TTS_MODEL_DIR": "/m"}]


@pytest.mark.parametrize("env", TTS_ENV, ids=[repr(e) for e in TTS_ENV])
def test_load_tts_config_reads_env_as_reference(monkeypatch, env):
    for k in list(os.environ):
        if k.startswith(("TTS_", "SSL_")):
            monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = C.load_tts_config().model_dump()
    assert got == _ported(JC.load_tts_config().model_dump())
    assert got["server"]["port"] == int(env.get("TTS_PORT", 7001))
