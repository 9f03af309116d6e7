"""The port's native pieces on the CPU: the libraries' build into the
package's `_native_build/` (six processes at once), the FunASR WebSocket
server's protocol (as `tests/test_native_ws.py` and
`tests/test_native_ws_streaming.py` check the reference's), its answers
over the port's engines against the reference's server over the
reference's engines (same weights), model errors closing with 1011, hub
rows released, the native WAV ingest against the reference's decoder, and
the epoll load generator against the port's voice app."""
import base64
import json
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from toolbox_for_asr_and_tts_tpu_torch.native import bridge  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import config as C  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.service import engines as E  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.utils import audio as A  # noqa: E402

from _torch_port_helpers import (  # noqa: E402
    FunasrWS, ServerThread, _port_engines_like, _speech, funasr_utterance)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAGIC = 12345   # a first sample that makes the fake streaming model fail


# ----------------------------------------------------------------- build
def test_build_is_safe_from_six_processes_at_once(tmp_path):
    """Six first uses at once (as six test workers make them) each get the
    same complete targets under <root>/<hash of the sources>/, loadable."""
    code = ("import sys, ctypes\n"
            "from toolbox_for_asr_and_tts_tpu_torch.native import bridge\n"
            "bridge.BUILD_ROOT = sys.argv[1]\n"
            "paths = [bridge.build_library(t) for t in bridge.TARGETS]\n"
            "ctypes.CDLL(paths[0], mode=ctypes.RTLD_LOCAL)\n"
            "ctypes.CDLL(paths[1], mode=ctypes.RTLD_LOCAL)\n"
            "print('|'.join(paths))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    built = paths.pop().split("|")
    assert [os.path.basename(p) for p in built] == list(bridge.TARGETS)
    assert {os.path.dirname(p) for p in built} == {
        os.path.join(str(tmp_path), bridge._digest())}
    assert sorted(os.listdir(os.path.dirname(built[0]))) == sorted(
        bridge.TARGETS)   # no temporary directory left behind


def test_default_build_lands_in_the_package():
    path = bridge.build_library()
    assert os.path.dirname(os.path.dirname(path)) == os.path.join(
        ROOT, "toolbox_for_asr_and_tts_tpu_torch", "_native_build")
    assert os.access(bridge.build_library(bridge.WSLOAD), os.X_OK)


# --------------------------------------------------------------- protocol
class _FakeStreaming:
    """Stands in for the streaming recognizer: accumulates sample counts;
    a chunk starting with MAGIC raises."""
    closed = []

    def __init__(self):
        self.total = 0

    def push_audio(self, arr):
        if round(float(arr[0]) * 32768) == MAGIC:
            raise RuntimeError("streaming model failed")
        self.total += len(arr)
        return f"partial:{self.total}"

    def finalize(self):
        return f"final:{self.total}"

    def close(self):
        _FakeStreaming.closed.append(self.total)


class TestProtocol:
    @pytest.fixture(scope="class")
    def server(self):
        calls = []

        def recognize(audio, hotwords):
            if "__raise__" in hotwords:
                raise RuntimeError("model failed")
            calls.append((len(audio), hotwords))
            return f"识别了{len(audio)}个采样点"

        srv = bridge.NativeWSServer(recognize, port=0,
                                    streaming_factory=_FakeStreaming)
        srv.start()
        srv.calls = calls
        yield srv
        srv.stop()

    def test_funasr_protocol_roundtrip(self, server):
        ws = FunasrWS(server.port)
        try:
            ws.send_json({"mode": "offline", "wav_name": "test1",
                          "is_speaking": True, "hotwords": "{\"心衰\": 20}",
                          "chunk_size": [5, 10, 5], "wav_format": "pcm",
                          "audio_fs": 16000})
            raw = (np.sin(np.arange(16000) * 0.05) * 10000).astype(
                "<i2").tobytes()
            for i in range(0, len(raw), 8192):  # 8 KB chunks
                ws.send(0x2, raw[i:i + 8192])
            ws.send_json({"is_speaking": False})
            kind, msg = ws.recv()
        finally:
            ws.close()
        assert kind == "text" and msg == {
            "mode": "offline", "wav_name": "test1",
            "text": "识别了16000个采样点", "is_final": True}
        n, hw = server.calls[-1]
        assert n == 16000
        assert "心衰" in json.loads(hw)  # \uXXXX escapes kept: valid JSON

    def test_end_without_audio_still_answers(self, server):
        """No PCM: still an is_final frame, with empty text (not an
        error)."""
        ws = FunasrWS(server.port)
        try:
            ws.send_json({"mode": "offline", "wav_name": "empty",
                          "is_speaking": True})
            ws.send_json({"is_speaking": False})
            kind, msg = ws.recv()
        finally:
            ws.close()
        assert kind == "text" and msg["is_final"] is True
        assert msg["text"] == "" and msg["wav_name"] == "empty"

    def test_two_utterances_per_connection(self, server):
        ws = FunasrWS(server.port)
        try:
            for name, n in (("a", 8000), ("b", 3000)):
                ws.send_json({"mode": "offline", "wav_name": name,
                              "is_speaking": True})
                ws.send(0x2, np.zeros(n, "<i2").tobytes())
                ws.send_json({"is_speaking": False})
                kind, msg = ws.recv()
                assert kind == "text" and msg["wav_name"] == name
                assert msg["text"] == f"识别了{n}个采样点"
        finally:
            ws.close()

    def test_concurrent_connections(self, server):
        results = []

        def run(idx):
            ws = FunasrWS(server.port)
            try:
                ws.send_json({"wav_name": f"c{idx}", "is_speaking": True})
                ws.send(0x2, np.zeros(4000 + idx * 2, "<i2").tobytes())
                ws.send_json({"is_speaking": False})
                results.append(ws.recv()[1])
            finally:
                ws.close()

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert sorted((m["wav_name"], m["text"]) for m in results) == [
            (f"c{i}", f"识别了{4000 + i * 2}个采样点") for i in range(4)]

    def test_online_mode_partials(self, server):
        closed = len(_FakeStreaming.closed)
        ws = FunasrWS(server.port)
        try:
            ws.send_json({"mode": "online", "wav_name": "s",
                          "is_speaking": True})
            ws.send(0x2, np.zeros(4000, "<i2").tobytes())
            assert ws.recv()[1] == {"mode": "online", "wav_name": "s",
                                    "text": "partial:4000",
                                    "is_final": False}
            ws.send(0x2, np.zeros(2000, "<i2").tobytes())
            assert ws.recv()[1]["text"] == "partial:6000"
            ws.send_json({"is_speaking": False})
            assert ws.recv()[1] == {"mode": "online", "wav_name": "s",
                                    "text": "final:6000", "is_final": True}
            # the finalized session was closed at once (its hub row freed)
            assert _FakeStreaming.closed[closed:] == [6000]
            assert server.sessions() == 0
        finally:
            ws.close()

    def test_2pass_mode(self, server):
        ws = FunasrWS(server.port)
        try:
            ws.send_json({"mode": "2pass", "wav_name": "t",
                          "is_speaking": True})
            ws.send(0x2, np.zeros(4000, "<i2").tobytes())
            m1 = ws.recv()[1]
            assert m1["mode"] == "2pass-online" and m1["is_final"] is False
            ws.send_json({"is_speaking": False})
            m2 = ws.recv()[1]
            assert m2["mode"] == "2pass-offline" and m2["is_final"] is True
            assert m2["text"] == "识别了4000个采样点"
        finally:
            ws.close()

    def test_offline_mode_unaffected_by_streaming_factory(self, server):
        ws = FunasrWS(server.port)
        try:
            ws.send_json({"mode": "offline", "wav_name": "u",
                          "is_speaking": True})
            ws.send(0x2, np.zeros(4000, "<i2").tobytes())
            ws.send_json({"is_speaking": False})
            m = ws.recv()[1]
        finally:
            ws.close()
        assert m["mode"] == "offline" and m["text"] == "识别了4000个采样点"

    @pytest.mark.parametrize("mode", ["offline", "2pass", "online"])
    def test_model_error_closes_with_1011(self, server, mode):
        """A recognize (offline, 2pass) or a streaming push (online) that
        raises closes the connection with 1011: never an empty is_final.
        The server goes on serving."""
        ws = FunasrWS(server.port)
        try:
            hot = "{\"__raise__\": 1}" if mode != "online" else ""
            ws.send_json({"mode": mode, "wav_name": "boom",
                          "is_speaking": True, "hotwords": hot})
            pcm = np.zeros(4000, "<i2")
            if mode == "online":
                pcm[0] = MAGIC
            ws.send(0x2, pcm.tobytes())
            ws.send_json({"is_speaking": False})
            got = [ws.recv()]
            while got[-1][0] != "close":
                got.append(ws.recv())
        finally:
            ws.close()
        assert got[-1] == ("close", 1011)
        assert not any(k == "text" and m["is_final"] for k, m in got)
        assert funasr_utterance(server.port, "offline",
                                np.zeros(100, "<i2").tobytes())[-1][1][
            "text"] == "识别了100个采样点"


# -------------------------------------- the port's server vs the reference's
def _utterance_pcm():
    x = np.concatenate([_speech(11, 12), np.zeros(3200, np.float32)])
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")


class TestAgainstReference:
    """The port's start_offline_asr_server over the port's test engines and
    the reference's over the reference's, with the same weights, both
    running in this process (each package loads its own library)."""

    @pytest.fixture(scope="class")
    def servers(self):
        from toolbox_for_asr_and_tts_tpu.native import bridge as jbridge
        from toolbox_for_asr_and_tts_tpu.service import engines as JE
        saved = {k: os.environ.get(k) for k in ("CHUNKED_PIPELINE",
                                                "VOICE_AOT_TICKS")}
        os.environ.update(CHUNKED_PIPELINE="0", VOICE_AOT_TICKS="0")
        jeng = JE.build_test_engines()
        eng = _port_engines_like(jeng)
        jsrv = jbridge.start_offline_asr_server(jeng, port=0)
        srv = bridge.start_offline_asr_server(eng, port=0)
        yield jsrv, srv, eng
        srv.stop()
        jsrv.stop()
        jeng.close()
        eng.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    @pytest.mark.parametrize("mode", ["offline", "2pass"])
    def test_offline_text_equals_reference(self, servers, mode):
        """The offline (and 2pass-offline) final text: Diarizer.diarize,
        then ITN, equal to the reference server's for the same PCM."""
        jsrv, srv, eng = servers
        pcm = _utterance_pcm().tobytes()
        want = funasr_utterance(jsrv.port, mode, pcm)
        got = funasr_utterance(srv.port, mode, pcm)
        assert got[-1][0] == "text" and got[-1][1]["is_final"]
        assert got[-1] == want[-1]
        from toolbox_for_asr_and_tts_tpu_torch.asr.itn import apply_itn
        direct = eng.diarizer.diarize(_utterance_pcm() / 32768.0)
        assert got[-1][1]["text"] == apply_itn("".join(s.text for s in direct))
        assert got[-1][1]["text"]

    def test_online_partials_equal_reference(self, servers):
        """mode "online" in 60 ms frames: the same sequence of partials and
        the same final, frame for frame."""
        jsrv, srv, _ = servers
        pcm = _utterance_pcm().tobytes()
        want = funasr_utterance(jsrv.port, "online", pcm)
        got = funasr_utterance(srv.port, "online", pcm)
        assert got == want
        assert len([m for k, m in got if not m["is_final"]]) >= 2
        assert got[-1][1]["is_final"] and got[-1][1]["mode"] == "online"

    def test_hub_rows_released_after_connections_close(self, servers):
        """Five online connections at once, three ended by is_speaking
        false and two just dropped: afterwards no streaming session and no
        ChunkedHub row stays in use."""
        _, srv, eng = servers
        ticker = eng.streaming_factory.hub.ticker
        pcm = _utterance_pcm().tobytes()[: 16 * 960 * 2]

        def one(i):
            ws = FunasrWS(srv.port)
            try:
                ws.send_json({"mode": "online", "wav_name": f"r{i}",
                              "is_speaking": True})
                for j in range(0, len(pcm), 960 * 2):
                    ws.send(0x2, pcm[j:j + 960 * 2])
                if i < 3:
                    ws.send_json({"is_speaking": False})
                    while not ws.recv()[1]["is_final"]:
                        pass
            finally:
                ws.close()

        threads = [threading.Thread(target=one, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
        deadline = time.time() + 60
        while (ticker.n_live or srv.sessions()) and time.time() < deadline:
            time.sleep(0.05)
        assert ticker.n_live == 0 and srv.sessions() == 0


# ----------------------------------------------------------- native ingest
def _wav(x: np.ndarray, sr: int, bits=16, fmt=1, extensible=False) -> bytes:
    """WAV encoder for the full format matrix (the production encoder only
    writes 16-bit), as `tests/test_native_audio.py`'s."""
    if x.ndim == 1:
        x = x[:, None]
    ch = x.shape[1]
    if fmt == 3:
        raw = x.astype("<f4" if bits == 32 else "<f8").tobytes()
    elif bits == 8:
        raw = (np.clip(x * 128.0 + 128.0, 0, 255)).astype(np.uint8).tobytes()
    elif bits == 16:
        raw = np.clip(np.round(x * 32767), -32768, 32767).astype("<i2").tobytes()
    elif bits == 24:
        v = np.clip(np.round(x * (1 << 23)), -(1 << 23), (1 << 23) - 1
                    ).astype("<i4")
        b = v.tobytes()
        raw = b"".join(b[i:i + 3] for i in range(0, len(b), 4))
    else:
        v = np.clip(np.round(x * 2147483647.0), -2147483648, 2147483647)
        raw = v.astype("<i4").tobytes()
    block = ch * bits // 8
    if extensible:
        guid = struct.pack("<H", fmt) + bytes.fromhex(
            "000000001000800000aa00389b71")
        body = struct.pack("<HHIIHH", 0xFFFE, ch, sr, sr * block, block,
                           bits) + struct.pack("<HHI", 22, bits, 0) + guid
    else:
        body = struct.pack("<HHIIHH", fmt, ch, sr, sr * block, block, bits)
    hdr = b"RIFF" + struct.pack("<I", 20 + len(body) + len(raw)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<I", len(body)) + body
    hdr += b"data" + struct.pack("<I", len(raw))
    return hdr + raw


def _sig(n, ch=1, seed=0, sr=16000):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    base = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(n)
    if ch == 1:
        return base.astype(np.float32)
    return np.stack([base * (i + 1) / ch for i in range(ch)], 1).astype(
        np.float32)


# (wav kwargs, signal, atol): test_native_audio.py's matrix and tolerances
INGEST = (
    [(f"pcm{b}" if f == 1 else f"float{b}", dict(bits=b, fmt=f), 16000,
      _sig(1600), 1e-6)
     for b, f in [(8, 1), (16, 1), (24, 1), (32, 1), (32, 3), (64, 3)]]
    + [("extensible_stereo", dict(bits=16, extensible=True), 16000,
        _sig(1600, ch=2), 1e-6)]
    + [(f"resample_{sr}", dict(bits=16), sr,
        (0.4 * np.sin(2 * np.pi * 440 * np.arange(sr // 2) / sr)).astype(
            np.float32), 5e-4) for sr in (8000, 22050, 44100, 48000)]
    + [("stereo24_44100", dict(bits=24), 44100,
        _sig(3200, ch=2, sr=44100), 5e-4)])


@pytest.fixture
def ingest_paths(monkeypatch):
    """(native, numpy): the port's base64_to_audio_np on each path."""
    def run(b64, native):
        monkeypatch.setenv("TOOLBOX_NATIVE_AUDIO", "1" if native else "0")
        monkeypatch.setattr(A, "_NATIVE_AUDIO", None)
        out = A.base64_to_audio_np(b64)
        assert (A._NATIVE_AUDIO is not False) == native
        return out
    yield run
    monkeypatch.setattr(A, "_NATIVE_AUDIO", None)


@pytest.mark.parametrize("name,kw,sr,x,atol", INGEST,
                         ids=[c[0] for c in INGEST])
def test_ingest_equals_reference(ingest_paths, name, kw, sr, x, atol):
    from toolbox_for_asr_and_tts_tpu.utils import audio as JA
    b64 = base64.b64encode(_wav(x, sr, **kw)).decode()
    want = JA.base64_to_audio_np(b64)
    native, plain = ingest_paths(b64, True), ingest_paths(b64, False)
    assert native.dtype == plain.dtype == np.float32
    assert len(native) == len(plain) == len(want)
    np.testing.assert_allclose(native, want, rtol=0, atol=atol)
    np.testing.assert_allclose(plain, want, rtol=0, atol=atol)


def test_native_ingest_rejects_garbage_and_the_ladder_decides():
    assert A._ingest_native(b"definitely not a wav", 16000) is None
    with pytest.raises(ValueError):
        A.base64_to_audio_np(base64.b64encode(b"RIFF????" * 8).decode())


def test_unloadable_ingest_warns_once_and_numpy_serves(monkeypatch, caplog):
    def unloadable(name):
        raise OSError("cannot open shared object file")
    monkeypatch.setattr(bridge, "load_library", unloadable)
    monkeypatch.setattr(A, "_NATIVE_AUDIO", None)
    monkeypatch.delenv("TOOLBOX_NATIVE_AUDIO", raising=False)
    b64 = base64.b64encode(_wav(_sig(1600), 16000)).decode()
    with caplog.at_level("WARNING", logger="toolbox.audio"):
        a = A.base64_to_audio_np(b64)
        b = A.base64_to_audio_np(b64)
    warned = [r for r in caplog.records if r.name == "toolbox.audio"]
    assert len(warned) == 1 and "cannot open" in warned[0].getMessage()
    want = A.ensure_mono_16k(*A.decode_wav_bytes(base64.b64decode(b64)))
    assert np.array_equal(a, want) and np.array_equal(b, want)
    monkeypatch.setattr(A, "_NATIVE_AUDIO", None)


# ------------------------------------------------------------ load generator
def test_wsload_client_sustains_streams(tmp_path):
    """The port's copy of the epoll load generator against the port's voice
    app on CPU test engines: 2 streams, 2 cycles, a result latency per
    stream after the grace cycle."""
    from toolbox_for_asr_and_tts_tpu_torch.service.voice_app import create_app
    binary = bridge.build_library(bridge.WSLOAD)
    engines = E.build_test_engines(device="cpu")
    srv = ServerThread(create_app(engines=engines,
                                  cfg=C.VoiceConfig(disable_llm=True))).start()
    try:
        rng = np.random.default_rng(0)
        t = np.arange(int(16000 * 0.4)) / 16000
        speech = (0.3 * np.sin(2 * np.pi * 260 * t)
                  + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        (np.clip(speech, -1, 1) * 32767).astype("<i2").tofile(
            tmp_path / "speech.pcm")
        np.zeros(len(t), "<i2").tofile(tmp_path / "silence.pcm")
        proc = subprocess.run(
            [binary, "--port", str(srv.app.port), "--n", "2", "--cycles", "2",
             "--deadline", "300", "--hard-timeout", "300",
             "--connect-timeout", "60",
             "--speech", str(tmp_path / "speech.pcm"),
             "--silence", str(tmp_path / "silence.pcm")],
            capture_output=True, text=True, timeout=400)
    finally:
        srv.stop()
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(x) for x in proc.stdout.splitlines()]
    summary = [r for r in recs if "summary" in r][0]["summary"]
    assert summary == {"n": 2, "ok": 2}, (proc.stdout, proc.stderr[-1000:])
    for r in recs:
        if "idx" in r:
            assert r["ok"] and len(r["lat"]) >= 1, r
