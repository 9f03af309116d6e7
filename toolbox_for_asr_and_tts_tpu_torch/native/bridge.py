"""Python ↔ C++ bridge for the native FunASR WebSocket server.

Port of `toolbox_for_asr_and_tts_tpu/native/bridge.py`. The C++ server
(`funasr_ws_server.cpp`) owns sockets, framing, per-connection sessions and
PCM accumulation; it calls back into Python for the model math, which runs
on the port's engines (the card unless they were built on the CPU). The
wire protocol is FunASR's, so existing FunASR clients connect unchanged:

    client → {"mode": "offline"|"online"|"2pass", "wav_name", "is_speaking",
              "hotwords", ...}                                  (text)
    client → PCM s16le 16 kHz chunks                            (binary)
    client → {"is_speaking": false}                             (text)
    server → {"mode", "wav_name", "text", "is_final"}

Departures from the reference:

- `build_library` compiles the package's own copies of the sources with
  `make` (g++ -O2 -std=c++17, no nvcc) into `_native_build/<hash of the
  sources>/`, built in a fresh directory and moved into place file by file
  with `os.replace`, so concurrent first uses (test workers, a launcher and
  a CLI) never see a half-written library. The libraries load with
  RTLD_LOCAL from that directory only: a process holding both packages'
  servers keeps two separate sets of the server's globals.
- A model error is never turned into a default answer. A callback that
  raises is logged and returns NULL, and the server closes that connection
  with code 1011 instead of sending an empty final.
- At the end of an utterance (`reset=1`) the streaming session is
  finalized, closed at once (which releases its ChunkedHub row; the
  reference leaves that to garbage collection) and then dropped.

    python -m toolbox_for_asr_and_tts_tpu_torch.native.bridge   # build, print the directory
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger("toolbox.native")

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_ROOT = os.path.join(os.path.dirname(_DIR), "_native_build")
SOURCES = ("Makefile", "funasr_ws_server.cpp", "audio_ingest.cpp",
           "wsload_client.cpp")
WS_LIB = "libfunasr_ws.so"
AUDIO_LIB = "libaudio_ingest.so"
WSLOAD = "wsload_client"
TARGETS = (WS_LIB, AUDIO_LIB, WSLOAD)
BUILD_TIMEOUT_S = 300

_RECOGNIZE_CB = ctypes.CFUNCTYPE(ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_int, ctypes.c_char_p)
_PARTIAL_CB = ctypes.CFUNCTYPE(ctypes.c_void_p, ctypes.c_ulonglong,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.c_int, ctypes.c_int)
_FREE_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)

_libc = ctypes.CDLL(None)
_libc.malloc.restype = ctypes.c_void_p
_libc.malloc.argtypes = [ctypes.c_size_t]
_libc.free.argtypes = [ctypes.c_void_p]

_build_lock = threading.Lock()


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build_dir() -> str:
    """The directory the current sources build into."""
    return os.path.join(BUILD_ROOT, _digest())


def build_library(name: str = WS_LIB) -> str:
    """Path of the built target `name` (one of TARGETS), building all three
    from the package's sources first if this version is not built yet."""
    if name not in TARGETS:
        raise ValueError(f"unknown native target {name!r}")
    out = build_dir()
    path = os.path.join(out, name)
    if os.path.exists(path):
        return path
    with _build_lock:
        if os.path.exists(path):
            return path
        os.makedirs(out, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".build-", dir=out)
        try:
            logger.info("building the native libraries into %s", out)
            r = subprocess.run(["make", "-C", _DIR, f"OUT={tmp}", "-j3"],
                               capture_output=True, text=True,
                               timeout=BUILD_TIMEOUT_S)
            if r.returncode != 0:
                raise RuntimeError(f"native build failed ({r.returncode}):\n"
                                   f"{r.stdout}{r.stderr}")
            # each target is replaced atomically on its own, so another
            # process may see one target before the next: callers check
            # the target they need (above), never the directory
            for t in TARGETS:
                os.replace(os.path.join(tmp, t), os.path.join(out, t))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return path


def load_library(name: str) -> ctypes.CDLL:
    """The target `name` built and loaded with RTLD_LOCAL."""
    return ctypes.CDLL(build_library(name), mode=os.RTLD_LOCAL)


class NativeWSServer:
    """In-process native WebSocket ASR server bound to a recognize fn.

    recognize(audio f32 [n], hotwords_json) -> text serves mode "offline"
    and the final of "2pass". streaming_factory: optional () -> an object
    with push_audio(chunk) -> partial text and finalize() -> text (and
    close(), called after finalize) that serves "online" and the partials
    of "2pass", one per connection."""

    def __init__(self, recognize: Callable[[np.ndarray, str], str],
                 port: int = 10095,
                 streaming_factory: Optional[Callable[[], object]] = None):
        self.lib = load_library(WS_LIB)
        self.lib.ws_server_start2.argtypes = [ctypes.c_int, _RECOGNIZE_CB,
                                              _PARTIAL_CB, _FREE_CB]
        self.lib.ws_server_start2.restype = ctypes.c_int
        self.lib.ws_server_port.argtypes = []
        self.lib.ws_server_port.restype = ctypes.c_int
        self.lib.ws_server_stop.argtypes = []
        self.lib.ws_server_stop.restype = None
        self._recognize = recognize
        self._port_arg = port
        self._streaming_factory = streaming_factory
        self._sessions = {}
        self._sess_lock = threading.Lock()
        self.port: Optional[int] = None

        def _alloc(text: str):
            data = text.encode("utf-8") + b"\x00"
            buf = _libc.malloc(len(data))
            ctypes.memmove(buf, data, len(data))
            return buf

        def _cb(samples, n, hotwords):
            try:
                arr = np.ctypeslib.as_array(samples, shape=(n,)).copy()
                hw = (hotwords or b"").decode("utf-8", "replace")
                return _alloc(self._recognize(arr, hw))
            except Exception:
                logger.exception("recognition failed: the connection closes "
                                 "with 1011")
                return None

        def _partial(session_id, samples, n, reset):
            try:
                if reset:
                    with self._sess_lock:
                        sr = self._sessions.get(session_id)
                    if sr is None:
                        return _alloc("")
                    try:
                        return _alloc(sr.finalize())
                    finally:
                        try:
                            _close(sr)
                        finally:   # open until its work is done
                            with self._sess_lock:
                                self._sessions.pop(session_id, None)
                with self._sess_lock:
                    sr = self._sessions.get(session_id)
                    if sr is None:
                        sr = self._streaming_factory()
                        self._sessions[session_id] = sr
                arr = np.ctypeslib.as_array(samples, shape=(n,)).copy()
                return _alloc(sr.push_audio(arr))
            except Exception:
                logger.exception("streaming recognition failed: the "
                                 "connection closes with 1011")
                return None

        def _free(ptr):
            _libc.free(ptr)

        # keep references so the callbacks aren't GC'd while C++ holds them
        self._cb = _RECOGNIZE_CB(_cb)
        self._partial_cb = (_PARTIAL_CB(_partial) if streaming_factory
                            else ctypes.cast(None, _PARTIAL_CB))
        self._free = _FREE_CB(_free)

    # ctypes trampolines ever handed to the C++ side, kept alive for the
    # PROCESS lifetime: ws_server_stop drains handler threads with a bounded
    # wait, so in a pathological hang a detached thread could still call a
    # callback after this object is garbage-collected
    _LIVE_CALLBACKS: list = []

    def start(self) -> int:
        NativeWSServer._LIVE_CALLBACKS.extend(
            [self._cb, self._partial_cb, self._free])
        rc = self.lib.ws_server_start2(self._port_arg, self._cb,
                                       self._partial_cb, self._free)
        if rc != 0:
            raise RuntimeError(f"ws_server_start failed: {rc}")
        self.port = int(self.lib.ws_server_port())
        logger.info("native WS ASR server listening on :%d", self.port)
        return self.port

    def stop(self) -> None:
        """Stop listening, drain the connections, and close any streaming
        session a connection left behind."""
        self.lib.ws_server_stop()
        with self._sess_lock:
            left, self._sessions = list(self._sessions.values()), {}
        for sr in left:
            _close(sr)

    def sessions(self) -> int:
        """Streaming sessions open now. A session counts until its
        finalize and close have returned, so 0 means that no device work
        of a finished utterance is still running (2pass: the server sends
        the final before it flushes the streaming session)."""
        with self._sess_lock:
            return len(self._sessions)


def _close(sr) -> None:
    fn = getattr(sr, "close", None)
    if fn is not None:
        fn()


def start_offline_asr_server(engines=None, port: int = 10095,
                             apply_itn: bool = True) -> NativeWSServer:
    """The native server over the engines' Diarizer (offline, and the final
    of 2pass: diarize, then ITN) and their streaming factory (online, and
    the partials of 2pass). Without engines, `build_engines()` builds the
    full-width ones on the card."""
    if engines is None:
        from ..service.engines import build_engines
        engines = build_engines()

    def recognize(audio: np.ndarray, hotwords_json: str) -> str:
        del hotwords_json  # biasing integrates at decode; LLM uses hotwords
        sents = engines.diarizer.diarize(audio)
        text = "".join(s.text for s in sents)
        if apply_itn and text:
            from ..asr.itn import apply_itn as itn
            text = itn(text)
        return text

    server = NativeWSServer(
        recognize, port=port,
        streaming_factory=getattr(engines, "streaming_factory", None))
    server.start()
    return server


if __name__ == "__main__":
    build_library()
    print(build_dir())
