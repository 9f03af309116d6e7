"""Minimal asyncio HTTP/1.1 + WebSocket (RFC 6455) server.

Copy of `toolbox_for_asr_and_tts_tpu/service/http.py` for the port
(framework-free; imports kept relative).

The reference serves FastAPI/uvicorn apps (voice-service/app/main.py,
tts-service/app/main.py). This framework ships its own dependency-free
serving edge with the same observable behavior: JSON REST routes, a
WebSocket endpoint on the same port, request logging, security headers and
permissive CORS (mirroring the reference middleware, voice-service/app/
main.py:105-183), global exception → JSON error handlers (tts-service/app/
main.py:94-132), and /health endpoints.

Scope: HTTP/1.1 with Content-Length bodies (the reference API is JSON-only;
no chunked uploads), text WebSocket frames with client masking, ping/pong,
and close handshakes — exactly what the reference wire protocol uses
(voice-service/app/api/voice.py:92-926).
"""
from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import logging
import re
import struct
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("toolbox.http")

from ..runtime import prom  # noqa: E402  (dependency-free)

_HTTP_REQS = prom.counter("toolbox_http_requests_total",
                          "HTTP requests served",
                          ("app", "method", "route", "status"))
_HTTP_LAT = prom.histogram("toolbox_http_request_seconds",
                           "HTTP request latency", ("app", "route"))
_WS_CONNS = prom.gauge("toolbox_ws_connections",
                       "open WebSocket connections", ("app", "route"))

WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_BODY = 64 * 1024 * 1024  # base64 WAVs are large
MAX_WS_FRAME = 32 * 1024 * 1024


def _unmask(payload: bytes, mask: bytes) -> bytes:
    """RFC 6455 client-frame unmask. Audio frames are ~40 KB of base64 per
    0.4 s chunk per stream, so this runs on the serving hot path: a vector
    uint32 XOR (~16 us/frame) instead of a per-byte Python loop
    (~3 ms/frame — at 64 streams x 2.5 chunks/s that loop alone cost ~half
    this 1-CPU host)."""
    n = len(payload)
    if n < 256:  # control frames / short messages: numpy overhead not worth it
        m = (mask * (n // 4 + 1))[:n]
        return bytes(a ^ b for a, b in zip(payload, m))
    import numpy as np
    pad = (-n) % 4
    a = np.frombuffer(payload + b"\0" * pad, dtype=np.uint32)
    m = np.frombuffer(mask * ((n + pad) // 4), dtype=np.uint32)
    return (a ^ m).tobytes()[:n]


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


@dataclass
class Request:
    method: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]
    body: bytes
    path_params: Dict[str, str] = field(default_factory=dict)
    matched_route: str = ""   # route TEMPLATE (metrics label, closed set)

    def json(self) -> Any:
        try:
            return json.loads(self.body.decode("utf-8") or "null")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise HTTPError(422, f"invalid JSON body: {e}")


@dataclass
class Response:
    status: int = 200
    body: bytes = b""
    content_type: str = "application/json"
    headers: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def json(cls, obj: Any, status: int = 200) -> "Response":
        return cls(status=status,
                   body=json.dumps(obj, ensure_ascii=False).encode("utf-8"))


_STATUS_TEXT = {200: "OK", 201: "Created", 204: "No Content",
                400: "Bad Request", 401: "Unauthorized", 404: "Not Found",
                405: "Method Not Allowed", 422: "Unprocessable Entity",
                500: "Internal Server Error"}

SECURITY_HEADERS = {  # reference voice-service/app/main.py security middleware
    "X-Content-Type-Options": "nosniff",
    "X-Frame-Options": "DENY",
    "X-XSS-Protection": "1; mode=block",
}


class WebSocket:
    """Server-side WebSocket connection (already-upgraded stream)."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, request: Request):
        self.reader = reader
        self.writer = writer
        self.request = request
        self.closed = False
        self._send_lock = asyncio.Lock()
        # background reader: keeps answering pings while the app handler is
        # busy (long finalize/compile) so client keepalives don't kill the
        # connection; bounded so a flooding client hits backpressure instead
        # of unbounded memory
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=32)
        self._reader_task: Optional[asyncio.Task] = None
        self._reader_exc: Optional[BaseException] = None
        self._keepalive_task: Optional[asyncio.Task] = None
        self._last_rx = time.monotonic()

    def start_reader(self) -> None:
        self._reader_task = asyncio.get_running_loop().create_task(
            self._reader_loop())
        import os
        interval = float(os.getenv("WS_PING_INTERVAL_S", "20"))
        if interval > 0:
            self._keepalive_task = asyncio.get_running_loop().create_task(
                self._keepalive_loop(interval))

    async def _keepalive_loop(self, interval: float) -> None:
        """Server-initiated pings — the only way to notice a SILENTLY
        vanished peer (no FIN: dropped network, killed process). Without
        this, a dead connection's handler blocks in receive forever and its
        session permanently holds batched-serving hub rows (round-3
        finding). Matches the reference stack's uvicorn/websockets
        ping_interval=20 default. WS_PING_INTERVAL_S=0 disables."""
        try:
            while not self.closed:
                await asyncio.sleep(interval)
                sent_at = time.monotonic()
                try:
                    await self._send_frame(0x9, b"ka")
                except Exception:
                    break
                await asyncio.sleep(interval)
                if self._queue.full():
                    # reader is backpressured (handler busy in a long
                    # finalize/compile), so the socket isn't being read and
                    # the pong CANNOT have been observed — a stale _last_rx
                    # here means "we stopped reading", not "peer died".
                    # Defer: when the handler drains, the reader resumes
                    # and a genuinely dead socket raises on the next read.
                    continue
                if self._last_rx < sent_at:   # no bytes since the ping
                    logger.info("WS peer unresponsive for %.0fs — aborting "
                                "connection", time.monotonic() - self._last_rx)
                    break
        except asyncio.CancelledError:
            return
        # abort the transport: the reader's readexactly raises, the handler
        # unwinds, and the session's finally releases its hub rows
        try:
            self.writer.close()
        except Exception:
            pass

    async def _reader_loop(self) -> None:
        try:
            while True:
                msg = await self.receive()
                await self._queue.put(msg)
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # ConnectionClosed / IncompleteRead / …
            self._reader_exc = e
            await self._queue.put(None)

    async def stop_reader(self) -> None:
        for attr in ("_reader_task", "_keepalive_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):
                    pass
                setattr(self, attr, None)

    async def receive_message(self) -> Tuple[int, bytes]:
        """Next text/binary message — via the background reader when it is
        running (pings answered concurrently), direct otherwise."""
        if self._reader_task is None:
            return await self.receive()
        item = await self._queue.get()
        if item is None:
            raise (self._reader_exc
                   if isinstance(self._reader_exc, Exception)
                   else ConnectionClosed())
        return item

    async def _read_exact(self, n: int) -> bytes:
        data = await self.reader.readexactly(n)
        # liveness is BYTE arrival, not complete-frame arrival: a slow
        # client mid-way through one large frame must not look dead to the
        # keepalive reaper
        self._last_rx = time.monotonic()
        return data

    async def receive(self) -> Tuple[int, bytes]:
        """Returns (opcode, payload) of the next complete message."""
        message = b""
        msg_opcode = None
        while True:
            hdr = await self._read_exact(2)
            fin = bool(hdr[0] & 0x80)
            opcode = hdr[0] & 0x0F
            masked = bool(hdr[1] & 0x80)
            length = hdr[1] & 0x7F
            if length == 126:
                length = struct.unpack(">H", await self._read_exact(2))[0]
            elif length == 127:
                length = struct.unpack(">Q", await self._read_exact(8))[0]
            if length > MAX_WS_FRAME:
                raise HTTPError(400, "WS frame too large")
            mask = await self._read_exact(4) if masked else b""
            payload = await self._read_exact(length) if length else b""
            if masked and payload:
                payload = _unmask(payload, mask)
            if opcode == 0x8:  # close
                await self._send_frame(0x8, payload[:2])
                self.closed = True
                raise ConnectionClosed()
            if opcode == 0x9:  # ping → pong
                await self._send_frame(0xA, payload)
                continue
            if opcode == 0xA:  # pong
                continue
            if opcode in (0x1, 0x2):
                msg_opcode = opcode
            if msg_opcode is None:
                continue
            if len(message) + len(payload) > MAX_WS_FRAME:
                # bound the TOTAL message across continuation fragments, not
                # just each frame — otherwise a client can grow one message
                # unboundedly (memory-exhaustion DoS)
                raise HTTPError(400, "WS message too large")
            message += payload
            if fin:
                return msg_opcode, message

    async def receive_json(self) -> Any:
        opcode, payload = await self.receive_message()
        if opcode != 0x1:
            raise HTTPError(400, "expected text frame")
        return json.loads(payload.decode("utf-8"))

    async def _send_frame(self, opcode: int, payload: bytes) -> None:
        async with self._send_lock:
            hdr = bytes([0x80 | opcode])
            n = len(payload)
            if n < 126:
                hdr += bytes([n])
            elif n < (1 << 16):
                hdr += bytes([126]) + struct.pack(">H", n)
            else:
                hdr += bytes([127]) + struct.pack(">Q", n)
            self.writer.write(hdr + payload)
            await self.writer.drain()

    async def send_text(self, text: str) -> None:
        await self._send_frame(0x1, text.encode("utf-8"))

    async def send_json(self, obj: Any) -> None:
        await self.send_text(json.dumps(obj, ensure_ascii=False))

    async def send_bytes(self, data: bytes) -> None:
        await self._send_frame(0x2, data)

    async def close(self, code: int = 1000) -> None:
        if not self.closed:
            self.closed = True
            try:
                await self._send_frame(0x8, struct.pack(">H", code))
            except (ConnectionError, RuntimeError):
                pass


class ConnectionClosed(Exception):
    pass


Handler = Callable[[Request], Awaitable[Response]]
WSHandler = Callable[[WebSocket], Awaitable[None]]


class App:
    """Router + server. Routes use `{name}` path params like the reference's
    FastAPI routes (e.g. /api/v1/tts/result/{job_id})."""

    def __init__(self, name: str = "app"):
        self.name = name
        # (method, compiled pattern, route TEMPLATE, handler) — the template
        # is the metrics label (closed set; raw paths would be unbounded)
        self.routes: List[Tuple[str, re.Pattern, str, Handler]] = []
        self.ws_routes: List[Tuple[re.Pattern, str, WSHandler]] = []
        self.on_startup: List[Callable[[], Awaitable[None]]] = []
        self._conn_tasks: set = set()
        self._server = None
        self._stopping: Optional[asyncio.Task] = None   # runs shutdown()
        self._add_metrics_route()

    def _add_metrics_route(self) -> None:
        """GET /metrics — Prometheus text exposition (runtime/prom.py).
        Beyond the reference (survey §5: no Prometheus/OTel there)."""
        from ..runtime.prom import REGISTRY

        async def metrics(req: Request) -> Response:
            return Response(200, REGISTRY.render().encode("utf-8"),
                            content_type="text/plain; version=0.0.4")

        self.routes.append(("GET", self._compile("/metrics"), "/metrics",
                            metrics))

    @staticmethod
    def _compile(path: str) -> re.Pattern:
        pattern = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", path)
        return re.compile(f"^{pattern}$")

    def route(self, method: str, path: str):
        def deco(fn: Handler):
            self.routes.append((method.upper(), self._compile(path), path,
                                fn))
            return fn
        return deco

    def get(self, path):
        return self.route("GET", path)

    def post(self, path):
        return self.route("POST", path)

    def delete(self, path):
        return self.route("DELETE", path)

    def websocket(self, path: str):
        def deco(fn: WSHandler):
            self.ws_routes.append((self._compile(path), path, fn))
            return fn
        return deco

    # ------------------------------------------------------- connection
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        # tracked for graceful shutdown (and to avoid "Task was destroyed
        # but it is pending!" noise when the loop dies under live conns)
        task = asyncio.current_task()
        if task is not None:
            self._conn_tasks.add(task)
            task.add_done_callback(self._conn_tasks.discard)
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                if req.headers.get("upgrade", "").lower() == "websocket":
                    await self._handle_ws(req, reader, writer)
                    break
                keep_alive = await self._handle_http(req, writer)
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.LimitOverrunError):
            pass
        except Exception:
            logger.exception("connection handler error")
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _read_request(self, reader) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, _ = lines[0].split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, v = ln.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        path, _, qs = target.partition("?")
        query = {}
        for pair in qs.split("&"):
            if "=" in pair:
                k, v = pair.split("=", 1)
                query[k] = v
        n = int(headers.get("content-length", "0") or "0")
        if n > MAX_BODY:
            raise HTTPError(400, "body too large")
        body = await reader.readexactly(n) if n else b""
        return Request(method.upper(), path, query, headers, body)

    async def _handle_http(self, req: Request,
                           writer: asyncio.StreamWriter) -> bool:
        t0 = time.perf_counter()
        resp = await self._dispatch(req)
        resp.headers.setdefault("Access-Control-Allow-Origin", "*")
        for k, v in SECURITY_HEADERS.items():
            resp.headers.setdefault(k, v)
        # gzip large JSON bodies (reference uses GZipMiddleware,
        # voice-service/app/main.py) — matters for base64 TTS results
        if (len(resp.body) > 1024
                and "gzip" in req.headers.get("accept-encoding", "")
                and "Content-Encoding" not in resp.headers):
            import gzip as _gzip
            resp.body = _gzip.compress(resp.body, compresslevel=1)
            resp.headers["Content-Encoding"] = "gzip"
        status_text = _STATUS_TEXT.get(resp.status, "Unknown")
        head = [f"HTTP/1.1 {resp.status} {status_text}",
                f"Content-Type: {resp.content_type}",
                f"Content-Length: {len(resp.body)}",
                "Connection: keep-alive"]
        head += [f"{k}: {v}" for k, v in resp.headers.items()]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + resp.body)
        await writer.drain()
        dt = (time.perf_counter() - t0) * 1000
        logger.info("%s %s → %d (%.1f ms)", req.method, req.path, resp.status, dt)
        route = req.matched_route or "unmatched"
        _HTTP_REQS.inc(app=self.name, method=req.method, route=route,
                       status=str(resp.status))
        _HTTP_LAT.observe(dt / 1000.0, app=self.name, route=route)
        return True

    async def _dispatch(self, req: Request) -> Response:
        if req.method == "OPTIONS":  # CORS preflight
            return Response(204, b"", headers={
                "Access-Control-Allow-Methods": "GET, POST, DELETE, OPTIONS",
                "Access-Control-Allow-Headers": "Content-Type, Authorization",
            })
        path_exists = False
        for method, pattern, template, fn in self.routes:
            m = pattern.match(req.path)
            if m:
                path_exists = True
                if method == req.method:
                    req.path_params = m.groupdict()
                    req.matched_route = template
                    try:
                        return await fn(req)
                    except HTTPError as e:
                        return Response.json({"detail": e.detail}, e.status)
                    except Exception:
                        logger.exception("handler error %s %s", req.method, req.path)
                        return Response.json(
                            {"detail": "internal server error",
                             "error": traceback.format_exc().splitlines()[-1]}, 500)
        return Response.json({"detail": "Method Not Allowed" if path_exists
                              else "Not Found"},
                             405 if path_exists else 404)

    async def _handle_ws(self, req: Request, reader, writer) -> None:
        handler = None
        for pattern, template, fn in self.ws_routes:
            m = pattern.match(req.path)
            if m:
                req.path_params = m.groupdict()
                req.matched_route = template
                handler = fn
                break
        key = req.headers.get("sec-websocket-key", "")
        if handler is None or not key:
            writer.write(b"HTTP/1.1 404 Not Found\r\nContent-Length: 0\r\n\r\n")
            await writer.drain()
            return
        accept = base64.b64encode(
            hashlib.sha1((key + WS_GUID).encode()).digest()).decode()
        writer.write(
            ("HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
             f"Connection: Upgrade\r\nSec-WebSocket-Accept: {accept}\r\n\r\n"
             ).encode())
        await writer.drain()
        ws = WebSocket(reader, writer, req)
        ws.start_reader()
        _WS_CONNS.inc(app=self.name, route=req.matched_route)
        try:
            await handler(ws)
        except ConnectionClosed:
            pass
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        except Exception:
            logger.exception("websocket handler error")
        finally:
            _WS_CONNS.dec(app=self.name, route=req.matched_route)
            await ws.stop_reader()
            await ws.close()

    # ------------------------------------------------------------ serve
    async def serve(self, host: str = "0.0.0.0", port: int = 8000,
                    ready: Optional[asyncio.Event] = None,
                    ssl_context=None) -> None:
        for hook in self.on_startup:
            await hook()
        server = await asyncio.start_server(
            self._handle_conn, host, port, limit=MAX_BODY, ssl=ssl_context)
        self._server = server
        self.port = server.sockets[0].getsockname()[1]  # resolved (port=0 ok)
        logger.info("%s listening on %s:%d", self.name, host, self.port)
        if ready is not None:
            ready.set()
        async with server:
            try:
                await server.serve_forever()
            except asyncio.CancelledError:
                # server.close() (from shutdown()) cancels serve_forever's
                # internal future. That is a GRACEFUL stop — return instead
                # of propagating so App.run()/asyncio.run exit cleanly. A
                # real task cancellation (shutdown not initiated) re-raises.
                if self._server is not None:
                    raise
                # return only once the task running shutdown() is done: a
                # loop driven by this coroutine (a server thread's
                # run_until_complete) would otherwise stop under it
                stopping = self._stopping
                if stopping is not None and \
                        stopping is not asyncio.current_task():
                    await asyncio.shield(stopping)

    async def shutdown(self) -> None:
        """Graceful stop: refuse new connections, cancel live connection
        tasks (their finally blocks release sessions/hub rows), and close
        the listener. Safe to call from the serving loop; from another
        thread use asyncio.run_coroutine_threadsafe(app.shutdown(), loop);
        serve() returns after the task that called this has finished."""
        self._stopping = asyncio.current_task()
        server, self._server = self._server, None
        if server is not None:
            server.close()   # refuse new connections immediately
        # cancel BEFORE wait_closed: Python 3.12's Server.wait_closed()
        # waits for live connection handlers, so the old order deadlocked
        tasks = [t for t in self._conn_tasks if not t.done()]
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        if server is not None:
            try:
                await server.wait_closed()
            except Exception:
                pass
        logger.info("%s shut down (%d connection(s) closed)",
                    self.name, len(tasks))

    def run(self, host: str = "0.0.0.0", port: int = 8000,
            ssl_context=None) -> None:
        async def _main():
            try:
                await self.serve(host, port, ssl_context=ssl_context)
            finally:
                # best-effort graceful close on SIGTERM/KeyboardInterrupt:
                # live connections' finally blocks release their sessions
                import contextlib
                with contextlib.suppress(Exception,
                                         asyncio.CancelledError):
                    await asyncio.shield(self.shutdown())

        asyncio.run(_main())


def ssl_context_for(ssl_cfg):
    """TLS context from a runtime.config.SSLConfig; None when disabled.

    enabled=True with a missing cert/key is a HARD error: silently serving
    plaintext after the operator asked for TLS is the worst outcome
    (round-2 review finding). One helper so the four entry points
    (launch_voice/launch_tts/voice_app.main/tts_app.main) cannot diverge."""
    if ssl_cfg is None or not getattr(ssl_cfg, "enabled", False):
        return None
    if not ssl_cfg.certfile or not ssl_cfg.keyfile:
        raise ValueError(
            "SSL_ENABLED=1 requires SSL_CERTFILE and SSL_KEYFILE to be set")
    return ssl_context_from(ssl_cfg.certfile, ssl_cfg.keyfile)


def ssl_context_from(certfile: Optional[str],
                     keyfile: Optional[str]):
    """TLS context from cert/key paths (reference SSLConfig / uvicorn TLS
    options, voice-service/start.py:193-218). Returns None when unset."""
    if not certfile or not keyfile:
        return None
    import ssl as _ssl
    ctx = _ssl.SSLContext(_ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(certfile, keyfile)
    return ctx
