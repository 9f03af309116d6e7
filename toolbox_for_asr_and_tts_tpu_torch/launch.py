"""Service launchers: the deploy images' entry points, on the card.

Port of `toolbox_for_asr_and_tts_tpu/launch.py`:

    python -c "from toolbox_for_asr_and_tts_tpu_torch.launch import launch_voice; launch_voice()"
    python -c "from toolbox_for_asr_and_tts_tpu_torch.launch import launch_tts; launch_tts()"

Voice: build the engines (`build_engines(VOICE_MODEL_DIR)`), start the
native FunASR WebSocket server in-process on FUNASR_WS_PORT (10095,
`native/bridge.py`) and wait until it accepts TCP, then serve the HTTP/WS
app on VOICE_HOST:VOICE_PORT. SIGTERM and SIGINT stop the native server,
the app and the engines' hubs. TTS: the TTS app on TTS_HOST:TTS_PORT.

Departures from the reference:

- A native server that fails to start raises before the app serves (the
  reference logs it and serves without it). FUNASR_WS_ENABLE=0 asks for
  no native server.
- No compilation cache is set up: the reference's `setup_compilation_cache`
  configures XLA's, and the port has nothing to compile at start but its
  CUDA kernels and native libraries, whose builds (`_kernels_build/`,
  `_native_build/` in the package) persist across restarts already.
"""
from __future__ import annotations

import logging
import logging.config
import os
import signal
import socket
import time

logger = logging.getLogger("toolbox.launch")


def setup_service_logging() -> None:
    """YAML dictConfig (assets/logging.yaml or LOG_CONFIG_FILE) with rotating
    file handlers under logs/, unless LOG_TO_CONSOLE_ONLY is set."""
    if os.getenv("LOG_TO_CONSOLE_ONLY"):
        logging.basicConfig(level=logging.INFO, force=True)
        return
    path = os.getenv("LOG_CONFIG_FILE", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "assets", "logging.yaml"))
    # `import logging.config` stays at module level: a function-local one
    # would bind a local `logging` and break the branch above
    try:
        import yaml
        with open(path, encoding="utf-8") as f:
            cfg = yaml.safe_load(f)
        os.makedirs("logs", exist_ok=True)
        logging.config.dictConfig(cfg)
    except Exception:
        logging.basicConfig(level=logging.INFO, force=True)
        logger.exception("falling back to basicConfig (bad %s)", path)


def _wait_tcp(port: int, timeout_s: float = 30.0) -> bool:
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return True
        except OSError:
            time.sleep(0.3)
    return False


def _stop_on_signals() -> None:
    def _stop(signum, frame):
        logger.info("signal %d — shutting down", signum)
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)


def launch_voice() -> None:
    """The voice service with its native FunASR server, on the card."""
    from .runtime.config import load_voice_config
    from .service.engines import build_engines
    from .service.http import ssl_context_for
    from .service.voice_app import create_app

    setup_service_logging()
    cfg = load_voice_config()
    t0 = time.perf_counter()
    engines = build_engines(cfg.model_dir)
    logger.info("engines built in %.2f s", time.perf_counter() - t0)
    ws_server = app = None
    try:
        if os.getenv("FUNASR_WS_ENABLE", "1") not in ("0", "false"):
            from .native.bridge import start_offline_asr_server
            ws_server = start_offline_asr_server(
                engines, port=int(os.getenv("FUNASR_WS_PORT", "10095")))
            if not _wait_tcp(ws_server.port):
                raise RuntimeError(f"native WS server not reachable on "
                                   f":{ws_server.port}")
            logger.info("native offline-ASR WS server ready on :%d",
                        ws_server.port)
        app = create_app(engines=engines, cfg=cfg)
        _stop_on_signals()
        app.run(cfg.server.host, cfg.server.port,
                ssl_context=ssl_context_for(cfg.ssl))
    finally:
        if ws_server is not None:
            ws_server.stop()
        if app is not None:
            app.close_engines()   # the hubs and the serving executor
        else:
            engines.close()


def launch_tts() -> None:
    """The TTS service on the card."""
    from .runtime.config import load_tts_config
    from .service.http import ssl_context_for
    from .service.tts_app import create_app

    setup_service_logging()
    cfg = load_tts_config()
    app = create_app(cfg=cfg)
    _stop_on_signals()
    try:
        app.run(cfg.server.host, cfg.server.port,
                ssl_context=ssl_context_for(cfg.ssl))
    finally:
        app.close_engines()
