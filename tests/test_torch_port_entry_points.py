"""The port's entry points on the CPU against the reference's, with the same
weights (`_port_engines_like`): the CLI, the batch API (`asr_wake`,
`kws_wakeup`), `Recognizer.transcribe_file`, the demo loop, the launchers
in child processes (REST and FunASR answers, exit 0 on SIGTERM, no hub
thread left, no serving when the native server cannot start), and the
serving tools (`start_all` + `smoke_http`, `warmup`).

The reference's engines run with CHUNKED_PIPELINE=0 and VOICE_AOT_TICKS=0
(as `tests/test_torch_port_service.py` runs them)."""
import asyncio
import base64
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from toolbox_for_asr_and_tts_tpu_torch import cli  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr import batch  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.corrections import (  # noqa: E402
    apply_hard_corrections)
from toolbox_for_asr_and_tts_tpu_torch.asr.itn import apply_itn  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.demo import full_voice_demo as D  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.service import engines as E  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.utils.audio import (  # noqa: E402
    base64_to_audio_np, encode_wav_bytes, read_wav, write_wav)

from _torch_port_helpers import (  # noqa: E402
    HUB_THREADS, SR, _http, _hub_thread_set, _port_engines_like, _speech,
    funasr_utterance)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jeng():
    from toolbox_for_asr_and_tts_tpu.service import engines as JE
    saved = {k: os.environ.get(k) for k in ("CHUNKED_PIPELINE",
                                            "VOICE_AOT_TICKS")}
    os.environ.update(CHUNKED_PIPELINE="0", VOICE_AOT_TICKS="0")
    eng = JE.build_test_engines()
    yield eng
    eng.close()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture
def eng(jeng):
    e = _port_engines_like(jeng)
    yield e
    e.close()


def _utterance():
    return np.concatenate([_speech(21, 10), np.zeros(6400, np.float32)])


# -------------------------------------------------------------------- CLI
def test_cli_transcribe_itn_prints_the_reference_json(tmp_path, capsys,
                                                      monkeypatch, jeng):
    from toolbox_for_asr_and_tts_tpu import cli as jcli
    from toolbox_for_asr_and_tts_tpu.service import engines as JE
    paths = []
    for i, seed in enumerate((3, 4)):
        paths.append(str(tmp_path / f"in{i}.wav"))
        write_wav(paths[-1], _speech(seed, 8 + 4 * i), SR)
    monkeypatch.setattr(JE, "build_engines", lambda *a, **k: jeng)
    monkeypatch.setattr(sys, "argv", ["cli", "transcribe", *paths, "--itn",
                                      "--no-mesh"])
    jcli.main()
    want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    built = []
    monkeypatch.setattr(E, "build_engines", lambda model_dir, device,
                        use_mesh: (built.append((model_dir, device, use_mesh))
                                   or _port_engines_like(jeng)))
    cli.main(["transcribe", *paths, "--itn", "--device", "cpu", "--no-mesh"])
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert built == [(None, "cpu", False)]
    assert got == want and len(got) == 2
    assert all(r["text"] for r in got)


def test_cli_tts_tiny_writes_a_wav(tmp_path, capsys):
    out = str(tmp_path / "out.wav")
    cli.main(["tts", "你好。今天天气很好。", "-o", out, "--tiny", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    wav, sr = read_wav(out)
    assert sr == 16000 and len(wav) > 1000 and rep["output"] == out
    assert rep["seconds"] == pytest.approx(len(wav) / sr)
    streamed = str(tmp_path / "stream.wav")
    cli.main(["tts", "你好。今天天气很好。", "-o", streamed, "--tiny", "--stream",
              "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["time_to_first_audio_s"] > 0 and rep["segments"]
    assert len(read_wav(streamed)[0]) > 1000


def test_cli_tts_on_a_broken_mount_exits_nonzero(tmp_path):
    """A TTS package that resolves but cannot load stops the command (the
    reference's CLI falls back to random weights)."""
    pkg = tmp_path / "speech_sambert-hifigan_tts_zh-cn_16k" / "voices" \
        / "zhitian_emo"
    for part in ("am", "voc"):
        (pkg / part / "ckpt").mkdir(parents=True)
        (pkg / part / "ckpt" / "checkpoint_1.pth").write_bytes(b"not torch")
    out = tmp_path / "out.wav"
    proc = subprocess.run(
        [sys.executable, "-m", "toolbox_for_asr_and_tts_tpu_torch.cli", "tts",
         "你好。", "--model-dir", str(tmp_path), "-o", str(out),
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert "checkpoint_1.pth" in proc.stderr or "pickle" in proc.stderr.lower()
    assert not out.exists()


# -------------------------------------------------------------- batch API
@pytest.mark.parametrize("fires", [False, True])
def test_asr_wake_and_kws_wakeup_equal_reference(monkeypatch, jeng, eng,
                                                 fires):
    from toolbox_for_asr_and_tts_tpu.asr import batch as jbatch
    thr = -1e9 if fires else 1e9
    monkeypatch.setattr(jeng.kws.inner, "threshold", thr)
    eng.kws.inner.threshold = thr
    wav = _utterance()
    assert batch.kws_wakeup(wav, eng) == jbatch.kws_wakeup(wav, jeng) == (
        (True, 1.0) if fires else (False, 0.0))
    for use_wake in (True, False):
        want = jbatch.asr_wake(wav, use_wake=use_wake, use_llm=False,
                               engines=jeng)
        got = batch.asr_wake(wav, use_wake=use_wake, use_llm=False,
                             engines=eng)
        assert got == want
        assert bool(got) == (fires or not use_wake)


def test_asr_wake_reads_a_path_and_builds_engines_once(tmp_path, monkeypatch,
                                                       jeng):
    from toolbox_for_asr_and_tts_tpu.asr import batch as jbatch
    path = str(tmp_path / "a.wav")
    write_wav(path, _utterance(), SR)
    built = []
    monkeypatch.setattr(batch, "_ENGINES", None)
    monkeypatch.setattr(E, "build_engines", lambda model_dir: (
        built.append(model_dir) or _port_engines_like(jeng)))
    try:
        for _ in range(2):
            got = batch.asr_wake(path, use_wake=False, use_llm=False)
        assert got == jbatch.asr_wake(path, use_wake=False, use_llm=False,
                                      engines=jeng)
        assert len(built) == 1
    finally:
        batch._ENGINES.close()


def test_transcribe_file_equals_reference(tmp_path, jeng, eng):
    path = str(tmp_path / "t.wav")
    write_wav(path, _speech(5, 9), SR)
    want = jeng.diarizer.inner.recognizer.transcribe_file(path)
    got = eng.diarizer.inner.recognizer.transcribe_file(path)
    assert got.token_ids == want.token_ids and got.text == want.text
    assert got.token_ids


# ------------------------------------------------------------------- demo
def _demo_audio():
    return np.concatenate([
        np.full(SR, 1e-4, np.float32), _speech(31, 7),
        np.zeros(24000, np.float32), _speech(32, 6),
        np.zeros(24000, np.float32), _speech(33, 4),
        np.zeros(20000, np.float32)])


@pytest.mark.parametrize("use_sv", [False, True])
def test_voice_agent_loop_turns_equal_reference(jeng, eng, use_sv):
    from toolbox_for_asr_and_tts_tpu.demo import full_voice_demo as JD
    audio = _demo_audio()
    want = JD.VoiceAgentLoop(jeng, chat=lambda t: f"echo:{t}", use_sv=use_sv,
                             use_wake=False).run_audio(audio)
    loop = D.VoiceAgentLoop(eng, chat=lambda t: f"echo:{t}", use_sv=use_sv,
                            use_wake=False)
    got = loop.run_audio(audio)
    assert got == want
    assert len(got) >= 2 and got[1]["text"].startswith("echo:")
    assert (loop.enroll_emb is not None) == use_sv


def test_vad_recorder_segments_equal_reference():
    from toolbox_for_asr_and_tts_tpu.demo import full_voice_demo as JD
    audio = _demo_audio()
    segs = []
    for mod in (JD, D):
        rec = mod.VADRecorder(max_segment_s=3.0)
        rec.calibrate(audio[:SR])
        segs.append([(s.start_s, s.end_s, s.audio)
                     for s in rec.segments(audio[SR:])])
    assert len(segs[0]) == len(segs[1]) >= 3
    for a, b in zip(*segs):
        assert a[:2] == b[:2] and np.array_equal(a[2], b[2])


def test_run_mic_without_sounddevice_raises(monkeypatch, eng):
    import builtins
    real_import = builtins.__import__

    def no_sd(name, *a, **k):
        if name == "sounddevice":
            raise ImportError("no sounddevice")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_sd)
    with pytest.raises(RuntimeError, match="sounddevice"):
        D.VoiceAgentLoop(eng, use_sv=False, use_wake=False).run_mic()


# -------------------------------------------------------------- launchers
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CHILD = """
import json, sys, threading
from toolbox_for_asr_and_tts_tpu_torch.service import engines as E
E.build_engines = lambda model_dir: \\
    E.build_test_engines(device="cpu")
if len(sys.argv) > 1:   # a native library that cannot load
    import os
    from toolbox_for_asr_and_tts_tpu_torch.native import bridge
    bridge.BUILD_ROOT = sys.argv[1]
    os.makedirs(bridge.build_dir(), exist_ok=True)
    with open(os.path.join(bridge.build_dir(), bridge.WS_LIB), "wb") as f:
        f.write(b"not a shared object")
from toolbox_for_asr_and_tts_tpu_torch.launch import launch_voice
try:
    launch_voice()
finally:
    print("HUB_THREADS " + json.dumps(sorted(
        t.name for t in threading.enumerate()
        if t.name.startswith({hubs!r}))), flush=True)
"""


def _launch(tmp_path, env_extra, *argv):
    env = dict(os.environ, PYTHONPATH=ROOT, VOICE_HOST="127.0.0.1",
               **env_extra)
    env.pop("LOG_TO_CONSOLE_ONLY", None)
    script = tmp_path / "child.py"
    script.write_text(CHILD.format(hubs=HUB_THREADS))
    return subprocess.Popen([sys.executable, str(script), *argv],
                            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait_http(proc, port, timeout=180):
    end = time.time() + timeout
    while time.time() < end:
        assert proc.poll() is None, proc.communicate()
        try:
            return _http(port, "GET", "/health")
        except OSError:
            time.sleep(0.2)
    raise AssertionError("the app did not answer")


def _sigterm(proc, timeout=15):
    t0 = time.time()
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, time.time() - t0, out, err


def test_launch_voice_serves_rest_and_funasr_and_stops_on_sigterm(tmp_path):
    """launch_voice in a child (build_engines patched to the CPU test
    engines): REST /asr and a FunASR offline request give the text of a
    direct diarize (with the hard corrections / ITN); SIGTERM → exit 0
    within 15 s, no hub thread left, the logs under the working
    directory."""
    vport, wport = _free_port(), _free_port()
    proc = _launch(tmp_path, dict(VOICE_PORT=str(vport),
                                  FUNASR_WS_PORT=str(wport)))
    try:
        status, health = _wait_http(proc, vport)
        assert status == 200 and health["status"] == "healthy"
        wav = _utterance()
        pcm = np.clip(np.round(wav * 32768.0), -32768, 32767).astype("<i2")
        fun = funasr_utterance(wport, "offline", pcm.tobytes())
        b64 = base64.b64encode(encode_wav_bytes(wav, SR)).decode()
        status, rest = _http(vport, "POST", "/api/v1/voice/asr", json.dumps(
            {"audio_data": b64, "use_wake": False}).encode())
        rc, waited, out, err = _sigterm(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    direct = E.build_test_engines(device="cpu")
    try:
        raw = "".join(s.text for s in direct.diarizer.diarize(
            pcm.astype(np.float32) / 32768.0))
        raw_rest = "".join(s.text for s in direct.diarizer.diarize(
            base64_to_audio_np(b64)))
    finally:
        direct.close()
    assert raw
    assert fun[-1][1] == {"mode": "offline", "wav_name": "w",
                          "text": apply_itn(raw), "is_final": True}
    assert status == 200 and rest["text"] == apply_hard_corrections(raw_rest)
    assert rc == 0 and waited < 15, err[-2000:]
    assert "HUB_THREADS []" in out
    log = (tmp_path / "logs" / "service.log").read_text(encoding="utf-8")
    assert "engines built in" in log


@pytest.mark.parametrize("enable", ["1", "0"])
def test_launch_voice_stops_when_the_native_server_cannot_start(tmp_path,
                                                                enable):
    """A native library that cannot load stops launch_voice before the app
    serves (exit non-zero), unless FUNASR_WS_ENABLE=0 asks for no native
    server: then the app serves and SIGTERM exits 0."""
    vport = _free_port()
    proc = _launch(tmp_path, dict(VOICE_PORT=str(vport),
                                  FUNASR_WS_PORT=str(_free_port()),
                                  FUNASR_WS_ENABLE=enable),
                   str(tmp_path / "native"))
    try:
        if enable == "1":
            out, err = proc.communicate(timeout=180)
            assert proc.returncode != 0
            assert "OSError" in err and "voice-service listening" not in err
            assert "HUB_THREADS []" in out
        else:
            assert _wait_http(proc, vport)[0] == 200
            rc, _, out, err = _sigterm(proc)
            assert rc == 0 and "HUB_THREADS []" in out, err[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


TTS_CHILD = """
from toolbox_for_asr_and_tts_tpu_torch.service import tts_app
create_app = tts_app.create_app
tts_app.create_app = lambda **kw: create_app(device="cpu", **kw)
from toolbox_for_asr_and_tts_tpu_torch.launch import launch_tts
launch_tts()
"""


def test_launch_tts_serves_and_stops_on_sigterm(tmp_path):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, TTS_HOST="127.0.0.1",
               TTS_PORT=str(port), LOG_TO_CONSOLE_ONLY="1")
    proc = subprocess.Popen(
        [sys.executable, "-c", TTS_CHILD],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        status, health = _wait_http(proc, port)
        assert status == 200 and health["status"] == "healthy"
        rc, waited, _, err = _sigterm(proc)
        assert rc == 0 and waited < 15, err[-2000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# ---------------------------------------------------------- serving tools
def test_smoke_http_passes_against_start_all(monkeypatch, capsys):
    from toolbox_for_asr_and_tts_tpu_torch.tools import smoke_http, start_all
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    random = Synthesizer.random.__func__
    monkeypatch.setattr(Synthesizer, "random", classmethod(
        lambda cls, **kw: random(cls, **dict(kw, tiny=True))))
    monkeypatch.setattr(E, "build_engines", lambda model_dir, device:
                        E.build_test_engines(device=device))
    before = _hub_thread_set()
    voice, tts = start_all.build_apps(device="cpu")
    loop = asyncio.new_event_loop()
    th = threading.Thread(target=lambda: loop.run_until_complete(
        start_all.serve_all(voice, tts, ("127.0.0.1", 0), ("127.0.0.1", 0))),
        daemon=True)
    th.start()
    try:
        for _ in range(400):
            if getattr(voice, "port", None) and getattr(tts, "port", None):
                break
            time.sleep(0.05)
        with pytest.raises(SystemExit) as exit_:
            smoke_http.main(["--voice", f"http://127.0.0.1:{voice.port}",
                             "--tts", f"http://127.0.0.1:{tts.port}"])
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert exit_.value.code == 0, report
        assert report["voice"]["health"]["status"] == "healthy"
        assert report["voice"]["asr"]["success"] is True
        assert report["tts"]["tts"]["status"] == "completed"
        assert report["tts"]["tts"]["audio_bytes"] > 1000
        with pytest.raises(SystemExit) as exit_:   # nothing listens there
            smoke_http.main(["--voice", f"http://127.0.0.1:{_free_port()}",
                             "--skip-tts"])
        assert exit_.value.code == 1
    finally:
        for app in (voice, tts):
            asyncio.run_coroutine_threadsafe(app.shutdown(), loop).result(30)
        th.join(30)
        voice.close_engines()
        tts.close_engines()
        loop.close()
    assert not _hub_thread_set() - before


def test_warmup_drives_every_bucket(eng):
    from toolbox_for_asr_and_tts_tpu_torch.tools import warmup
    reco = eng.diarizer.inner.recognizer
    before = reco.forwards.n
    timings = warmup.warmup_asr(eng, [1, 2], batch_sizes=(1, 2))
    assert sorted(timings) == ["asr_1s_b1", "asr_1s_b2", "asr_2s_b1",
                               "asr_2s_b2"]
    assert reco.forwards.n - before == 4
