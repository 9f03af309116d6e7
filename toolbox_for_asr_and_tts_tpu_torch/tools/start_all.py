"""Combined launcher: both services in one process, on the card.

Port of `toolbox_for_asr_and_tts_tpu/tools/start_all.py`, with the
launchers' logging (`launch.setup_service_logging`). Useful for
single-host deployments and smoke testing (`tools/smoke_http.py`).

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.start_all \\
        [--voice-port 8001] [--tts-port 7001] [--device cuda]
"""
from __future__ import annotations

import argparse
import asyncio
import logging

from ..device import DeviceLike

logger = logging.getLogger("toolbox.start_all")


def build_apps(device: DeviceLike = None):
    """(voice app, TTS app) on `device`: the voice engines from
    VOICE_MODEL_DIR, the synthesizer from TTS_MODEL_DIR (random weights
    where nothing resolves)."""
    from ..runtime.config import load_tts_config, load_voice_config
    from ..service.engines import build_engines
    from ..service import tts_app, voice_app
    vcfg = load_voice_config()
    engines = build_engines(vcfg.model_dir, device=device)
    try:
        tts = tts_app.create_app(cfg=load_tts_config(), device=device)
    except BaseException:
        engines.close()
        raise
    return voice_app.create_app(engines=engines, cfg=vcfg), tts


async def serve_all(voice, tts, voice_addr, tts_addr) -> None:
    """Serve both apps on one event loop: each address is (host, port)."""
    logger.info("starting voice on %s:%d and tts on %s:%d", *voice_addr,
                *tts_addr)
    await asyncio.gather(voice.serve(*voice_addr), tts.serve(*tts_addr))


def main(argv=None) -> None:
    from ..launch import setup_service_logging
    from ..runtime.config import load_tts_config, load_voice_config
    ap = argparse.ArgumentParser()
    ap.add_argument("--voice-port", type=int, default=8001)
    ap.add_argument("--tts-port", type=int, default=7001)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    setup_service_logging()
    voice, tts = build_apps(args.device)
    try:
        asyncio.run(serve_all(
            voice, tts, (load_voice_config().server.host, args.voice_port),
            (load_tts_config().server.host, args.tts_port)))
    finally:
        voice.close_engines()
        tts.close_engines()


if __name__ == "__main__":
    main()
