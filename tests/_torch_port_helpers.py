"""Helpers shared by the port's service-level tests: the port's test
engines over the reference engines' parameters, speech-like audio, the
app served from a thread, and raw RFC 6455 / HTTP / FunASR clients (the
card's machine has no `websockets`). Imports JAX only inside `_tree`, so
the card's tests can use the clients."""
import asyncio
import base64
import dataclasses
import json
import os
import socket
import struct
import threading
import time

import numpy as np

from toolbox_for_asr_and_tts_tpu_torch.asr import session as S
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy
from toolbox_for_asr_and_tts_tpu_torch.service import engines as E
from toolbox_for_asr_and_tts_tpu_torch.service import hub as H

SR = 16000
CHUNK = 6400
HUB_THREADS = ("vad-hub", "chunked-hub", "kws-hub", "finalize-hub")


def _speech(seed, n_chunks, amp=0.3):
    """Speech-like audio that passes the energy gate, in whole chunks."""
    rng = np.random.default_rng(seed)
    n = n_chunks * CHUNK
    t = np.arange(n) / SR
    f0 = 140 + 60 * np.sin(2 * np.pi * rng.uniform(0.3, 0.7) * t)
    x = amp * np.sin(2 * np.pi * np.cumsum(f0) / SR) \
        * (0.75 + 0.25 * np.sin(2 * np.pi * 2.3 * t))
    return (x + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _chunks(x):
    return [x[i:i + CHUNK] for i in range(0, len(x), CHUNK)]


def _hub_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(HUB_THREADS)]


def _hub_thread_set():
    """The live hub threads themselves (the module's server keeps its own
    running while other tests build and close theirs)."""
    return {t for t in threading.enumerate() if t.name.startswith(HUB_THREADS)}


def _tree(x):
    import jax
    return params_from_numpy(jax.tree.map(np.asarray, x), device="cpu")


def _cfg(cls, jcfg):
    """The port's config with the reference config's values (the fields
    the port has)."""
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


def _port_engines_like(jeng):
    """The port's test engines (`build_test_engines`'s wiring) over the
    reference engines' parameters."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.diarization import Diarizer
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier
    from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer
    from toolbox_for_asr_and_tts_tpu_torch.models import (campplus,
                                                          ct_transformer,
                                                          kws_ctc, paraformer)
    jd = jeng.diarizer.inner
    jr, jsv, jp, jk = jd.recognizer, jd.verifier, jd.punctuator, \
        jeng.kws.inner
    reco = Recognizer(_tree(jr.params),
                      _cfg(paraformer.ParaformerConfig, jr.cfg),
                      CharTokenizer.dummy(jr.cfg.vocab_size), device="cpu")
    sv = SpeakerVerifier(_tree(jsv.params),
                         _cfg(campplus.CampPlusConfig, jsv.cfg), device="cpu")
    punc = ct_transformer.Punctuator(
        _tree(jp.params), _cfg(ct_transformer.CTTransformerConfig, jp.cfg),
        ct_transformer.PuncVocab.dummy(jp.cfg.vocab_size), device="cpu")
    kw = kws_ctc.KeywordSpotter(
        _tree(jk.params), _cfg(kws_ctc.KwsConfig, jk.cfg),
        dict(jk.char_to_id), threshold=jk.threshold, device="cpu")
    return S.VoiceEngines(
        diarizer=H.FinalizeHub(Diarizer(reco, sv, punctuator=punc)),
        kws=H.KwsHub(kw), verifier=sv,
        streaming_factory=E._streaming_factory(reco, capacity=16,
                                               device="cpu"))


class ServerThread:
    """The port's app served on an ephemeral port from a thread; `stop`
    shuts the server down, closes the engines and joins the loop."""

    def __init__(self, app):
        self.app = app
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.app.serve("127.0.0.1", 0))

    def start(self):
        self.thread.start()
        for _ in range(400):
            if getattr(self.app, "port", None):
                return self
            time.sleep(0.05)
        raise RuntimeError("server did not start")

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.app.shutdown(),
                                         self.loop).result(30)
        self.thread.join(30)
        self.app.close_engines()
        self.loop.close()


class RawWS:
    """A minimal RFC 6455 client: masked frames, no extensions."""

    def __init__(self, port, path="/api/v1/voice/asr/ws", timeout=120):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                           "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                           f"Sec-WebSocket-Key: {key}\r\n"
                           "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:   # byte by byte: no frame is eaten
            head += self._read(1)
        assert head.split(b"\r\n", 1)[0].split()[1] == b"101", head

    def _read(self, n):
        out = b""
        while len(out) < n:
            got = self.sock.recv(n - len(out))
            if not got:
                raise ConnectionError("closed")
            out += got
        return out

    def send(self, opcode, payload: bytes):
        mask = os.urandom(4)
        n = len(payload)
        hdr = bytes([0x80 | opcode])
        if n < 126:
            hdr += bytes([0x80 | n])
        elif n < 1 << 16:
            hdr += bytes([0x80 | 126]) + struct.pack(">H", n)
        else:
            hdr += bytes([0x80 | 127]) + struct.pack(">Q", n)
        body = (np.frombuffer(payload + b"\0" * (-n % 4), np.uint32)
                ^ np.frombuffer(mask, np.uint32)[0]).tobytes()[:n]
        self.sock.sendall(hdr + mask + body)

    def recv_json(self):
        while True:
            h = self._read(2)
            n = h[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", self._read(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", self._read(8))[0]
            payload = self._read(n)
            if h[0] & 0x0F == 0x1:
                return json.loads(payload)
            if h[0] & 0x0F == 0x9:       # ping → pong
                self.send(0xA, payload)

    def close(self):
        try:
            self.send(0x8, struct.pack(">H", 1000))
        finally:
            self.sock.close()


def _pcm(x):
    return np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2").tobytes()


def _http(port, method, path, body=b""):
    s = socket.create_connection(("127.0.0.1", port), timeout=120)
    try:
        s.sendall((f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                   f"Content-Type: application/json\r\n"
                   f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
        data = b""
        while b"\r\n\r\n" not in data:
            data += s.recv(65536)
        head, rest = data.split(b"\r\n\r\n", 1)
        n = int([ln.split(b":")[1] for ln in head.split(b"\r\n")
                 if ln.lower().startswith(b"content-length")][0])
        while len(rest) < n:
            rest += s.recv(65536)
        return int(head.split()[1]), json.loads(rest[:n])
    finally:
        s.close()


class FunasrWS(RawWS):
    """A FunASR-protocol client: the handshake on path "/", JSON control
    frames, binary PCM, and `recv` returning ("text", dict) or ("close",
    code)."""

    def __init__(self, port, timeout=120):
        super().__init__(port, path="/", timeout=timeout)

    def send_json(self, obj):
        self.send(0x1, json.dumps(obj).encode())

    def close(self):
        try:
            super().close()
        except OSError:   # the server closed first (a 1011 close)
            pass

    def recv(self):
        while True:
            h = self._read(2)
            n = h[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", self._read(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", self._read(8))[0]
            payload = self._read(n)
            op = h[0] & 0x0F
            if op == 0x1:
                return "text", json.loads(payload)
            if op == 0x8:
                return "close", struct.unpack(">H", payload[:2])[0]
            if op == 0x9:
                self.send(0xA, payload)


def funasr_utterance(port, mode, pcm16, wav_name="w", frame=960 * 2):
    """One FunASR utterance on its own connection: the init frame, the PCM
    in `frame`-byte binary frames (60 ms by default), is_speaking false;
    returns every reply up to the final one (or the close), in order. The
    server answers each frame before it reads the next, so the replies
    wait in the socket until the end."""
    ws = FunasrWS(port)
    try:
        ws.send_json({"mode": mode, "wav_name": wav_name,
                      "is_speaking": True, "chunk_size": [5, 10, 5],
                      "wav_format": "pcm", "audio_fs": 16000})
        for i in range(0, len(pcm16), frame):
            ws.send(0x2, pcm16[i:i + frame])
        ws.send_json({"is_speaking": False})
        replies = [ws.recv()]
        while not (replies[-1][0] == "close" or replies[-1][1]["is_final"]):
            replies.append(ws.recv())
        return replies
    finally:
        ws.close()
