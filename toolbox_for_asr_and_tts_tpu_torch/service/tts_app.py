"""TTS service app: REST and WebSocket endpoints over the port's synthesis
engine.

Port of `toolbox_for_asr_and_tts_tpu/service/tts_app.py` with the same
routes and wire format. Requests parse with the port's pydantic-free
schemas (`service/schemas.py`); a body they refuse gets the same HTTP 422.
Run on the card with `python -m toolbox_for_asr_and_tts_tpu_torch.service.tts_app`.

Against the reference: where `runtime/registry.resolve("tts",
cfg.model_dir)` finds a checkpoint directory (TTS_MODEL_DIR honoured; the
reference resolves without it), `create_app` loads it with
`Synthesizer.from_model_dir`, and a failed load raises there, before any
request, where the reference logs it and serves random weights. With no
directory it serves `Synthesizer.random(tiny=False)` on the card, with the
reference's warning.

Route for route the reference TTS API (tts-service/app/api/tts.py:27-133
mounted at /api/v1/tts, plus app-level endpoints tts-service/app/main.py:
156-176):

    POST   /api/v1/tts/start            → {job_id, status}
    POST   /api/v1/tts/cancel           → {job_id, status}
    GET    /api/v1/tts/result/{job_id}  → TTSResultResponse (poll;
                                          ?partial=1 → audio-so-far)
    DELETE /api/v1/tts/jobs/{job_id}    → cleanup
    GET    /health                      → model_loaded + active_jobs
    GET    /                            → service banner
    WS     /api/v1/tts/ws               → streaming synthesis (beyond the
                                          reference: per-segment PCM frames)
"""
from __future__ import annotations

import logging
import time
from typing import Optional

from ..runtime.config import TTSConfig, load_tts_config
from ..runtime.registry import resolve
from ..tts.jobs import TTSJobManager
from .http import App, HTTPError, Request, Response
from .schemas import CancelRequest, TTSRequest, ValidationError

logger = logging.getLogger("toolbox.tts.app")


def create_app(synthesizer=None, cfg: Optional[TTSConfig] = None) -> App:
    cfg = cfg or load_tts_config()
    if synthesizer is None:
        # a mounted package loads here, so a failed load raises before any
        # request (and before the job manager's workers start)
        d = resolve("tts", cfg.model_dir)
        if d is not None:
            from ..tts.synthesizer import Synthesizer
            synthesizer = Synthesizer.from_model_dir(d, tts_cfg=cfg)
            logger.info("TTS loaded from %s", d)
        else:
            logger.warning(
                "NO TTS checkpoint dir (registry key 'tts') — serving "
                "RANDOMLY INITIALIZED weights: the audio is arbitrary until "
                "a real model is mounted")
    app = App("tts-service")
    state = {"manager": None, "started_at": time.time()}
    # WS streaming admission control: same bound as the job manager's pool
    # (reference: 2-worker ThreadPool, tts_service.py:47). Without it every
    # WS connection would spawn an unbounded synthesis thread contending for
    # the device, bypassing the bound the REST path enforces. Waiters queue
    # (connection accepted, synthesis deferred) rather than being refused.
    import threading as _threading
    ws_slots = _threading.Semaphore(cfg.max_concurrent_jobs)

    def manager() -> TTSJobManager:
        if state["manager"] is None:  # lazy load (reference tts_service.py:80-226)
            synth = synthesizer
            if synth is None:
                from ..tts.synthesizer import Synthesizer
                synth = Synthesizer.random(tiny=False, tts_cfg=cfg)
            state["manager"] = TTSJobManager(synth,
                                             max_workers=cfg.max_concurrent_jobs)
        return state["manager"]

    def close_engines() -> None:
        """Release the job manager's workers: an embedded server (tests,
        `chip_smoke.py`) must leave no thread behind."""
        if state["manager"] is not None:
            state["manager"].close()

    app.manager = manager
    app.close_engines = close_engines

    def _parse(req: Request, model):
        try:
            return model.model_validate(req.json())
        except ValidationError as e:
            raise HTTPError(422, str(e))

    @app.post("/api/v1/tts/start")
    async def start(req: Request) -> Response:
        body = _parse(req, TTSRequest)
        if not body.text.strip():
            raise HTTPError(400, "text is empty")
        job_id = manager().start_task(body.text, body.voice)
        logger.info("TTS job %s started (%d chars)", job_id, len(body.text))
        return Response.json({"job_id": job_id, "status": "pending",
                              "message": "task started"})

    @app.post("/api/v1/tts/cancel")
    async def cancel(req: Request) -> Response:
        body = _parse(req, CancelRequest)
        ok = manager().cancel_task(body.job_id)
        if not ok:
            raise HTTPError(404, f"job {body.job_id} not found or finished")
        return Response.json({"job_id": body.job_id, "status": "cancelled",
                              "message": "task cancelled"})

    @app.get("/api/v1/tts/result/{job_id}")
    async def result(req: Request) -> Response:
        job_id = req.path_params["job_id"]
        # ?partial=1 → while processing, audio_base64 carries the audio
        # synthesized so far (a sample-exact prefix of the final WAV); the
        # reference poll only ever returns completed audio (tts.py:85-119)
        partial = req.query.get("partial", "0") in ("1", "true")
        r = manager().get_result(job_id, partial=partial)
        if r is None:
            raise HTTPError(404, f"job {job_id} not found")
        timing = r.pop("detailed_timing", None)
        if timing:  # reference logs the timing breakdown on poll (tts.py:102-115)
            logger.info("TTS job %s timing: %s", job_id, timing)
        return Response.json(r)

    @app.delete("/api/v1/tts/jobs/{job_id}")
    async def cleanup(req: Request) -> Response:
        job_id = req.path_params["job_id"]
        if not manager().cleanup_job(job_id):
            raise HTTPError(404, f"job {job_id} not found")
        return Response.json({"job_id": job_id, "message": "job cleaned up"})

    @app.websocket("/api/v1/tts/ws")
    async def tts_stream(ws) -> None:
        """Streaming synthesis (beyond the reference's poll-only job API):
        the client sends one {"text", "voice"} message and receives

            {"type": "chunk", "pcm16_base64", "sample_rate",
             "segment_index", "n_segments", "text"}   — per finished segment
            {"type": "done", "rtf", "duration_s", "n_segments"}

        Concatenated pcm16 chunks are sample-identical to the job API's WAV
        for the same text. Time-to-first-audio is one small single-segment
        program instead of the whole job (benchmarks/run.py ttfa)."""
        import asyncio
        import base64 as b64mod
        import threading

        import numpy as np

        try:
            body = await ws.receive_json()
            tts_req = TTSRequest.model_validate(body)
        except Exception as e:
            await ws.send_json({"type": "error", "error": f"bad request: {e}"})
            await ws.close()
            return
        if not tts_req.text.strip():
            await ws.send_json({"type": "error", "error": "text is empty"})
            await ws.close()
            return
        synth = manager().synth
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()
        gone = threading.Event()   # client went away → stop synthesizing

        def worker() -> None:
            try:
                # admission bound (see ws_slots above); re-check the client
                # after a possibly long wait in the queue
                while not ws_slots.acquire(timeout=0.5):
                    if gone.is_set():
                        loop.call_soon_threadsafe(queue.put_nowait, None)
                        return
                try:
                    for ev in synth.synthesize_stream(
                            tts_req.text, tts_req.voice,
                            cancelled=gone.is_set):
                        loop.call_soon_threadsafe(queue.put_nowait, ev)
                finally:
                    ws_slots.release()
            except Exception as e:  # surfaced as an error frame, not a drop
                logger.exception("TTS stream failed")
                loop.call_soon_threadsafe(
                    queue.put_nowait, {"event": "error", "error": str(e)})
            loop.call_soon_threadsafe(queue.put_nowait, None)

        threading.Thread(target=worker, daemon=True,
                         name="tts-ws-stream").start()

        def pcm16(audio: np.ndarray) -> str:
            ints = np.clip(np.round(audio * 32767.0), -32768, 32767)
            return b64mod.b64encode(ints.astype("<i2").tobytes()).decode()

        try:
            while True:
                ev = await queue.get()
                if ev is None:
                    break
                if ev["event"] == "error":
                    await ws.send_json({"type": "error", "error": ev["error"]})
                elif ev["event"] == "chunk":
                    await ws.send_json({
                        "type": "chunk",
                        "pcm16_base64": pcm16(ev["audio"]),
                        "sample_rate": synth.sample_rate,
                        "segment_index": ev["segment_index"],
                        "n_segments": ev["n_segments"],
                        "text": ev["text"],
                    })
                else:  # done — flush the held tail, then the summary
                    if len(ev["audio"]):
                        # the crossfade tail is EXTRA audio after the last
                        # segment's chunk: give it a unique index one past
                        # the segments (a client keying chunks by
                        # segment_index must not see two chunks with the
                        # last segment's index) and mark it explicitly
                        await ws.send_json({
                            "type": "chunk",
                            "pcm16_base64": pcm16(ev["audio"]),
                            "sample_rate": synth.sample_rate,
                            "segment_index": len(ev["segments"]),
                            "n_segments": len(ev["segments"]),
                            "text": "",
                            "tail": True,
                        })
                    await ws.send_json({
                        "type": "done", "rtf": ev["rtf"],
                        "duration_s": ev["duration_s"],
                        "n_segments": len(ev["segments"]),
                    })
            await ws.close()
        finally:
            gone.set()

    @app.get("/health")
    async def health(req: Request) -> Response:
        return Response.json({
            "status": "healthy",
            "model_loaded": state["manager"] is not None,
            "active_jobs": (state["manager"].active_jobs
                            if state["manager"] else 0),
            "uptime_s": round(time.time() - state["started_at"], 1),
        })

    @app.get("/")
    async def root(req: Request) -> Response:
        return Response.json({"service": "tts-service",
                              "engine": "toolbox_for_asr_and_tts_tpu_torch",
                              "docs": "/api/v1/tts"})

    return app


def main() -> None:
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = load_tts_config()
    from .http import ssl_context_for
    create_app(cfg=cfg).run(cfg.server.host, cfg.server.port,
                            ssl_context=ssl_context_for(cfg.ssl))


if __name__ == "__main__":
    main()
