"""One-command real-checkpoint mount rehearsal, on the card unless
`--device cpu`.

    python -m toolbox_for_asr_and_tts_tpu_torch.cli rehearse <models_dir>

Port of `toolbox_for_asr_and_tts_tpu/tools/rehearse.py`. When a real
ModelScope model tree mounts (`<models_dir>/<damo-package-name>/…`, the
layout `runtime/registry.py` resolves), this command makes day-one success
mechanical:

1. **Convert every family strictly** through the same loaders the services
   use (geometry pinned from each dir's own config files), reporting per
   family the rules, converted tensors, and missing and unmapped tensor
   names (`runtime/checkpoints.py::CONVERT_REPORTS`; `--reconvert` clears
   the port's caches first so coverage is re-measured).
2. **Boot both services in process** on the converted weights and drive
   golden audio and text through the real surfaces: REST `POST /asr`, the
   WS streaming session, and a TTS job.
3. **Emit a JSON report** (`--report`, default
   `<models_dir>/rehearsal_report.json`).

Exit status is non-zero when any present family has missing or unmapped
tensors (strict mode; `--lenient` downgrades to warnings) or a service
drive fails; a drive that raises ends the run with its traceback. Families
without a mounted dir are reported `absent` and do not fail the run.

Against the reference:
- `--reconvert` deletes only the port's caches (`torch_params.npz`,
  `<ckpt>.torch.npz`, `<ckpt>.torch.cfg.json`), never the reference's
  `.jax` ones, so both packages can share a mount;
- the WS drive uses a stdlib client (`_WSClient`), not the `websockets`
  package;
- each service drive also reports its seconds, and the report's service
  part the seconds the engines took to build (`boot_seconds`).
"""
from __future__ import annotations

import argparse
import base64
import json
import logging
import os
import socket
import struct
import sys
import time
import urllib.request
from typing import Any, Dict, Optional

import numpy as np

from ..device import DeviceLike

logger = logging.getLogger("toolbox.rehearse")

WS_PATH = "/api/v1/voice/asr/ws"


def _clear_caches(d: str) -> None:
    from ..runtime.checkpoints import CACHE_NAME
    from ..tts.synthesizer import CACHE_SUFFIX, CFG_SUFFIX
    for root, _, files in os.walk(d):
        for f in files:
            if f == CACHE_NAME or f.endswith((CACHE_SUFFIX, CFG_SUFFIX)):
                try:
                    os.unlink(os.path.join(root, f))
                except OSError:
                    pass


def _loaders(device: DeviceLike):
    from ..asr.recognizer import Recognizer
    from ..asr.speaker import SpeakerVerifier
    from ..models import fsmn_vad
    from ..models.ct_transformer import Punctuator
    from ..models.kws_ctc import KeywordSpotter
    from ..tts.synthesizer import Synthesizer
    on = {"device": device}
    return [
        ("paraformer_offline",
         lambda d: Recognizer.from_model_dir(d, use_mesh=False, **on)),
        ("paraformer_streaming",
         lambda d: Recognizer.from_model_dir(d, use_mesh=False, **on)),
        ("fsmn_vad", lambda d: fsmn_vad.from_model_dir(d, **on)),
        ("sv", lambda d: SpeakerVerifier.from_model_dir(d, **on)),
        ("punc", lambda d: Punctuator.from_model_dir(d, **on)),
        ("kws", lambda d: KeywordSpotter.from_model_dir(d, **on)),
        ("tts", lambda d: Synthesizer.from_model_dir(d, **on)),
    ]


def convert_families(models_dir: str, reconvert: bool = False,
                     device: DeviceLike = None) -> Dict[str, Any]:
    from ..runtime import checkpoints as ckpt
    from ..runtime.registry import resolve

    out: Dict[str, Any] = {}
    for key, load in _loaders(device):
        d = resolve(key, models_dir)
        if d is None:
            out[key] = {"status": "absent"}
            continue
        if reconvert:
            _clear_caches(d)
        ckpt.CONVERT_REPORTS.clear()
        entry: Dict[str, Any] = {"dir": d}
        t0 = time.perf_counter()
        try:
            load(d)
            entry["status"] = "converted"
        except Exception as e:
            entry["status"] = "failed"
            entry["error"] = f"{type(e).__name__}: {e}"
            logger.exception("rehearsal: %s conversion FAILED", key)
        entry["seconds"] = round(time.perf_counter() - t0, 2)
        reports = list(ckpt.CONVERT_REPORTS)
        if entry["status"] == "converted" and reports:
            # a strict conversion that SUCCEEDED has missing == []; reports
            # carrying missing names are template probes the loader tried
            # and abandoned (e.g. the offline loader's BiCIF-first attempt)
            good = [r for r in reports if not r["missing"]] or reports[-1:]
            entry["n_rules"] = sum(r["n_rules"] for r in good)
            entry["n_converted"] = sum(r["n_converted"] for r in good)
            entry["missing"] = [m for r in good for m in r["missing"]]
            entry["unmapped"] = [u for r in good for u in r["unmapped"]]
        elif entry["status"] == "converted":
            # loaded from an existing cache: coverage not re-measured
            entry["status"] = "cached"
        elif reports:  # failed: surface the last attempt's gap analysis
            entry["missing"] = reports[-1]["missing"]
            entry["unmapped"] = reports[-1]["unmapped"]
        out[key] = entry
    return out


# ------------------------------------------------------------ service drive
def _speech(secs: float = 0.4, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * secs)) / 16000
    return (0.3 * np.sin(2 * np.pi * 260 * t)
            + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


class _Server:
    """An app served on 127.0.0.1 (a free port) by an event loop of its
    own thread; `stop` shuts it down and releases its engines."""

    def __init__(self, app):
        import asyncio
        import threading
        self.app = app
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(
            target=lambda: self.loop.run_until_complete(
                app.serve("127.0.0.1", 0)), daemon=True)
        self.thread.start()
        for _ in range(400):
            if getattr(app, "port", None):
                self.port = app.port
                return
            time.sleep(0.05)
        raise RuntimeError("service did not start")

    def stop(self) -> None:
        import asyncio
        try:
            asyncio.run_coroutine_threadsafe(self.app.shutdown(),
                                             self.loop).result(60)
            self.thread.join(60)
        finally:
            self.app.close_engines()
        if not self.thread.is_alive():
            self.loop.close()


class _WSClient:
    """A minimal RFC 6455 client (masked frames, no extensions). The
    handshake is read byte by byte, so no frame that follows it is
    swallowed."""

    def __init__(self, port: int, path: str, timeout: float = 60.0):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            head += self._read(1)
        status = head.split(b"\r\n", 1)[0].split()
        if len(status) < 2 or status[1] != b"101":
            raise ConnectionError(f"WebSocket upgrade refused: {head[:200]!r}")

    def _read(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            got = self.sock.recv(n - len(out))
            if not got:
                raise ConnectionError("the server closed the connection")
            out += got
        return out

    def _send(self, opcode: int, payload: bytes) -> None:
        mask = os.urandom(4)
        n = len(payload)
        hdr = bytes([0x80 | opcode])
        if n < 126:
            hdr += bytes([0x80 | n])
        elif n < 1 << 16:
            hdr += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            hdr += bytes([0x80 | 127]) + struct.pack(">Q", n)
        body = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        self.sock.sendall(hdr + mask + body)

    def send_json(self, obj) -> None:
        self._send(0x1, json.dumps(obj).encode())

    def recv_json(self, timeout: float) -> Any:
        """The next text frame, parsed; socket.timeout when none arrives
        within `timeout` seconds."""
        while True:
            self.sock.settimeout(timeout)
            h = self._read(2)
            self.sock.settimeout(60.0)    # the rest of a started frame
            n = h[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", self._read(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", self._read(8))[0]
            payload = self._read(n)
            op = h[0] & 0x0F
            if op == 0x1:
                return json.loads(payload)
            if op == 0x8:
                raise ConnectionError("the server closed the WebSocket")
            if op == 0x9:                 # ping → pong
                self._send(0xA, payload)

    def close(self) -> None:
        try:
            self._send(0x8, struct.pack(">H", 1000))
        except OSError:
            pass
        finally:
            self.sock.close()


def _post_json(url: str, body: dict, timeout: float) -> Any:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _rest_asr(port: int, wav_b64: str) -> Dict[str, Any]:
    """REST batch ASR of the golden audio."""
    rest = _post_json(f"http://127.0.0.1:{port}/api/v1/voice/asr",
                      {"audio_data": wav_b64, "use_wake": False,
                       "use_llm": False}, timeout=600)
    return {"success": rest.get("success"), "text": rest.get("text")}


def _ws_asr(port: int) -> Dict[str, Any]:
    """One WS streaming cycle (wake and SV off): 1.2 s of speech, then 2.8
    s of silence, until the `result` frame."""
    from ..utils.audio import encode_wav_bytes
    frames = []
    ws = _WSClient(port, WS_PATH)
    ws_result = None
    try:
        frames.append(ws.recv_json(timeout=60)["type"])       # welcome
        ws.send_json({"use_wake": False, "use_sv": False, "use_llm": False})
        chunk = base64.b64encode(encode_wav_bytes(_speech(), 16000)).decode()
        sil = base64.b64encode(
            encode_wav_bytes(np.zeros(6400, np.float32), 16000)).decode()
        for b64 in [chunk] * 3 + [sil] * 7:
            ws.send_json({"audio_data": b64})
        deadline = time.time() + 600
        while time.time() < deadline:
            try:
                msg = ws.recv_json(timeout=5)
            except socket.timeout:
                continue
            if isinstance(msg, dict) and msg.get("type"):
                frames.append(msg["type"])
                if msg["type"] == "result":
                    ws_result = msg
                    break
    finally:
        ws.close()
    return {"frames": frames, "result": (ws_result or {}).get("text"),
            "ok": ws_result is not None}


def _tts_job(port: int, text: str) -> Dict[str, Any]:
    """A TTS job through `/start`, polled to its end."""
    jid = _post_json(f"http://127.0.0.1:{port}/api/v1/tts/start",
                     {"text": text, "voice": "zhitian_emo"},
                     timeout=120)["job_id"]
    status: Dict[str, Any] = {}
    for _ in range(600):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/v1/tts/result/{jid}",
                timeout=120) as r:
            status = json.loads(r.read())
        if status.get("status") in ("completed", "error"):
            break
        time.sleep(0.5)
    return {"status": status.get("status"),
            "audio_size": status.get("audio_size")}


def _timed(fn, *args) -> Dict[str, Any]:
    t0 = time.perf_counter()
    out = fn(*args)
    out["seconds"] = round(time.perf_counter() - t0, 3)
    return out


def drive_services(models_dir: str, golden_wav: Optional[str] = None,
                   golden_text: str = "你好，小护。今天天气不错。",
                   device: DeviceLike = None) -> Dict[str, Any]:
    """Boot the voice and TTS apps on the mounted weights and push golden
    inputs through REST, WS and TTS. Returns the observed outputs (the
    parity artifact a human checks against the reference deployment)."""
    from ..runtime.registry import resolve
    from ..service.engines import build_engines
    from ..service.tts_app import create_app as create_tts_app
    from ..service.voice_app import create_app as create_voice_app
    from ..tts.synthesizer import Synthesizer
    from ..utils.audio import encode_wav_bytes, ensure_mono_16k, read_wav

    os.environ.setdefault("VOICE_DISABLE_LLM", "1")
    report: Dict[str, Any] = {}

    if golden_wav and os.path.exists(golden_wav):
        x, sr = read_wav(golden_wav)
        wav = ensure_mono_16k(x, sr)
    else:
        wav = np.concatenate([_speech(seed=i) for i in range(5)])
    wav_b64 = base64.b64encode(encode_wav_bytes(wav, 16000)).decode()

    # the apps and their hubs are torn down in the finally below: a
    # rehearsal leaves no serving thread behind
    t0 = time.perf_counter()
    engines = build_engines(models_dir, device=device, use_mesh=False)
    report["boot_seconds"] = round(time.perf_counter() - t0, 3)
    servers = []
    try:
        voice = _Server(create_voice_app(engines=engines))
        servers.append(voice)
        report["rest_asr"] = _timed(_rest_asr, voice.port, wav_b64)
        report["ws_asr"] = _timed(_ws_asr, voice.port)
        tts_dir = resolve("tts", models_dir)
        try:
            synth = (Synthesizer.from_model_dir(tts_dir, device=device)
                     if tts_dir else
                     Synthesizer.random(tiny=True, device=device))
            tts = _Server(create_tts_app(synthesizer=synth))
            servers.append(tts)
            report["tts"] = dict(_timed(_tts_job, tts.port, golden_text),
                                 random_weights=tts_dir is None)
        except Exception as e:
            logger.exception("rehearsal: TTS drive failed")
            report["tts"] = {"status": "failed",
                             "error": f"{type(e).__name__}: {e}"}
    finally:
        # release the hubs' serving threads and both event loops
        for srv in servers:
            try:
                srv.stop()
            except Exception:
                logger.exception("rehearsal: server teardown failed")
        if not servers:
            engines.close()
    return report


def rehearse(models_dir: str, reconvert: bool = False, serve: bool = True,
             golden_wav: Optional[str] = None,
             device: DeviceLike = None) -> Dict[str, Any]:
    report: Dict[str, Any] = {
        "models_dir": os.path.abspath(models_dir),
        "families": convert_families(models_dir, reconvert=reconvert,
                                     device=device),
    }
    if serve:
        report["service"] = drive_services(models_dir, golden_wav=golden_wav,
                                           device=device)
    bad = sorted(
        k for k, v in report["families"].items()
        if v.get("status") == "failed" or v.get("missing")
        or v.get("unmapped"))
    if serve:
        svc = report["service"]
        if not svc.get("rest_asr", {}).get("success"):
            bad.append("service:rest_asr")
        if not svc.get("ws_asr", {}).get("ok"):
            bad.append("service:ws_asr")
        if svc.get("tts", {}).get("status") != "completed":
            bad.append("service:tts")
    report["strict_failures"] = bad
    report["ok"] = not bad
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="real-checkpoint mount rehearsal (convert all families "
                    "strictly, boot both services, drive golden inputs)")
    ap.add_argument("models_dir")
    ap.add_argument("--report", default=None,
                    help="report path (default <models_dir>/rehearsal_report.json)")
    ap.add_argument("--reconvert", action="store_true",
                    help="clear the port's converted caches first")
    ap.add_argument("--no-serve", action="store_true",
                    help="conversion coverage only, skip the service drive")
    ap.add_argument("--golden-wav", default=None,
                    help="real WAV to drive through REST ASR")
    ap.add_argument("--lenient", action="store_true",
                    help="always exit 0; failures become warnings")
    ap.add_argument("--device", default="cuda",
                    help="where the models run (cuda, or cpu)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    report = rehearse(args.models_dir, reconvert=args.reconvert,
                      serve=not args.no_serve, golden_wav=args.golden_wav,
                      device=args.device)
    path = args.report or os.path.join(args.models_dir,
                                       "rehearsal_report.json")
    try:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(report, f, ensure_ascii=False, indent=2)
        print(f"report: {path}", file=sys.stderr)
    except OSError:
        logger.warning("could not write report at %s", path)
    print(json.dumps(report, ensure_ascii=False))
    if not report["ok"] and not args.lenient:
        sys.exit(1)


if __name__ == "__main__":
    main()
