"""Voice service app: batch ASR REST + streaming ASR WebSocket.

Port of `toolbox_for_asr_and_tts_tpu/service/voice_app.py` over the port's
engines (`service/engines.py`), with the same routes, wire protocol and
error codes. `ASRRequest` is the port's pydantic-free dataclass; a body it
refuses gets the same HTTP 422. Run on the card with
`python -m toolbox_for_asr_and_tts_tpu_torch.service.voice_app`.

Route for route the reference voice API (voice-service/app/api/voice.py;
app endpoints voice-service/app/main.py:185-193):

    POST /api/v1/voice/asr     — batch recognition (base64 WAV in JSON)
    WS   /api/v1/voice/asr/ws  — streaming session with the 4-mode FSM
    GET  /health, GET /

WS wire protocol (kept byte-compatible with the reference):
  in:  {"type": "end_conversation" | "cancel_enrollment" | "start_asr"}
       {"wav_base64"|"audio_data": ..., "use_wake"?, "use_sv"?, "use_llm"?}
  out: {"type":"welcome", ..., "use_wake", "mode"}
       {"type":"status", "status": "conversation_ended"|"enrollment_cancelled"
                                   |"asr_started"}
       {"type":"wakeup","status":"activated", ...}
       {"type":"enrollment_completed","status":"completed", ...}
       {"type":"processing","status":"finalizing", ...}
       {"type":"result","status":"completed","text":...,"success":...}
       {"type":"error","message":...,"code":...}
"""
from __future__ import annotations

import json
import logging
import os
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np

from ..asr import session as S
from ..asr.corrections import apply_hard_corrections
from ..device import DeviceLike
from ..runtime import prom

_FINALIZE_LAT = prom.histogram("toolbox_asr_finalize_seconds",
                               "end-of-utterance finalize latency (session "
                               "buffer → diarize/SV → text)")
_UTTERANCES = prom.counter("toolbox_asr_utterances_total",
                           "finalized utterances")
from ..runtime.config import VoiceConfig, load_voice_config
from ..utils.audio import base64_to_audio_np, read_wav, ensure_mono_16k, write_wav
from .http import App, HTTPError, Request, Response, WebSocket
from .schemas import ASRRequest, ValidationError

logger = logging.getLogger("toolbox.voice.app")


class VoiceService:
    """Batch-ASR orchestrator (reference voice-service/app/services/
    voice_service.py): sample save/reuse + recognition + corrections + LLM.

    The batch path routes to the same offline recognizer `finalize()` uses,
    restoring the path the reference left stubbed (survey §3.2,
    voice_interface.py:556-561)."""

    def __init__(self, engines, cfg: VoiceConfig):
        self.engines = engines
        self.cfg = cfg
        self.samples_dir = os.path.join(cfg.generated_dir, "asr_samples")

    def create_streaming_session(self) -> S.StreamingASRSession:
        return S.StreamingASRSession(
            self.engines, use_wake=True, use_sv=True,
            generated_dir=self.cfg.generated_dir
            if self.cfg.always_save_sample else None)

    def _sample_path(self, sample_id: str) -> str:
        return os.path.join(self.samples_dir, f"{sample_id}.wav")

    def recognize_speech(self, req: ASRRequest) -> Dict[str, Any]:
        use_wake = req.use_wake if req.use_wake is not None else True
        use_llm = req.use_llm if req.use_llm is not None else not self.cfg.disable_llm
        sample_id = req.sample_id
        try:
            if sample_id and os.path.exists(self._sample_path(sample_id)):
                x, sr = read_wav(self._sample_path(sample_id))
                wav = ensure_mono_16k(x, sr)
            else:
                wav = base64_to_audio_np(req.audio_data)
        except (ValueError, OSError) as e:
            # bad audio is a client error, not a server crash — the reference
            # returns ASRResponse(success=False) too (voice_service.py:161-175)
            return {"text": "", "success": False,
                    "message": f"音频解析失败: {e}", "sample_id": sample_id}
        # KWS gate (reference asr_wake, voice_interface.py:531-578)
        if (use_wake or self.cfg.require_wake) and self.engines.kws is not None:
            sess = S.StreamingASRSession(self.engines, use_wake=True, use_sv=False)
            woke = False
            step = 6400
            for i in range(0, len(wav), step):
                if sess.process_wakeup_chunk(wav[i:i + step]):
                    woke = True
                    break
            if not woke:
                return {"text": "", "success": False,
                        "message": "未检测到唤醒词", "sample_id": sample_id}
        sents = self.engines.diarizer.diarize(wav)
        text = "".join(s.text for s in sents)
        text = apply_hard_corrections(text)
        if use_llm and text:
            from ..llm.correction import correct_text_only, load_hotword_options
            text = correct_text_only(latest_options=load_hotword_options(),
                                     text=text)
        if req.save_sample or self.cfg.always_save_sample:
            os.makedirs(self.samples_dir, exist_ok=True)
            sample_id = sample_id or uuid.uuid4().hex
            write_wav(self._sample_path(sample_id), wav, 16000)
        return {"text": text, "success": True, "message": "",
                "sample_id": sample_id}


def create_app(engines=None, cfg: Optional[VoiceConfig] = None,
               device: DeviceLike = None) -> App:
    """The voice app over `engines`, or over `build_engines(cfg.model_dir,
    device)` built at the first request."""
    cfg = cfg or load_voice_config()
    app = App("voice-service")
    state: Dict[str, Any] = {"service": None, "started_at": time.time()}

    def service() -> VoiceService:
        if state["service"] is None:
            eng = engines
            if eng is None:
                from .engines import build_engines
                eng = build_engines(cfg.model_dir, device=device)
            state["service"] = VoiceService(eng, cfg)
        return state["service"]

    def close_engines() -> None:
        """Release the serving hubs' threads (VoiceEngines.close) and the
        serving executor: an embedded server (tests, `chip_smoke.py`) must
        leave no thread behind."""
        svc = state["service"]
        eng = svc.engines if svc is not None else engines
        if eng is not None:
            eng.close()
        if serving_exec is not None:
            serving_exec.shutdown(wait=False, cancel_futures=True)

    app.close_engines = close_engines

    # ------------------------------------------------------------- REST
    @app.post("/api/v1/voice/asr")
    async def asr(req: Request) -> Response:
        try:
            body = ASRRequest.model_validate(req.json())
        except ValidationError as e:
            raise HTTPError(422, str(e))
        t0 = time.perf_counter()
        result = service().recognize_speech(body)
        logger.info("batch ASR done in %.1f ms", (time.perf_counter() - t0) * 1e3)
        return Response.json(result)

    @app.get("/health")
    async def health(req: Request) -> Response:
        return Response.json({
            "status": "healthy",
            "models_loaded": state["service"] is not None,
            "uptime_s": round(time.time() - state["started_at"], 1),
        })

    @app.get("/")
    async def root(req: Request) -> Response:
        return Response.json({"service": "voice-service",
                              "engine": "toolbox_for_asr_and_tts_tpu_torch"})

    # -------------------------------------------------------------- WS
    @app.websocket("/api/v1/voice/asr/ws")
    async def asr_ws(ws: WebSocket) -> None:
        client_id = uuid.uuid4().hex
        try:
            sess = service().create_streaming_session()
        except Exception as e:
            await ws.send_json({"type": "error",
                                "message": f"创建会话失败: {e}",
                                "code": "SESSION_CREATE_ERROR"})
            return
        await ws.send_json({"type": "welcome",
                            "message": "Connected to voice recognition service",
                            "timestamp": time.time(),
                            "use_wake": sess.use_wake,
                            "mode": sess.mode})
        use_llm_default = not cfg.disable_llm
        try:
            await _ws_loop(ws, sess, use_llm_default)
        finally:
            # release the session's hub rows — skipping this leaks one
            # batched-serving slot per closed connection until every new
            # session lands on the slow overflow path
            sess.close()

    async def _ws_loop(ws: WebSocket, sess, use_llm_default) -> None:
        # use_llm persists across messages (docs/API.md: binary frames reuse
        # the last JSON-set flags); use_wake/use_sv persist inside `sess`
        use_llm = use_llm_default
        while True:
            try:
                opcode, payload = await ws.receive_message()
                if opcode == 0x2:
                    # BINARY frame = one raw 16 kHz mono s16le PCM chunk —
                    # the FunASR runtime WS protocol's chunk format
                    # (reference voice_interface.py:255-296: JSON init +
                    # binary chunks). Flags persist from prior JSON
                    # messages; skips base64+WAV decode on the hot path.
                    if len(payload) == 0 or len(payload) % 2:
                        await ws.send_json({
                            "type": "error",
                            "message": "二进制帧须为 16 kHz 单声道 s16le PCM",
                            "code": "INVALID_PCM_FRAME"})
                        continue
                    audio_np = (np.frombuffer(payload, "<i2")
                                .astype(np.float32) / 32768.0)
                    if sess.is_completed:
                        sess.reset()
                    try:
                        await _process_audio(ws, sess, audio_np, use_llm)
                    except Exception as e:
                        logger.exception("audio processing error")
                        await ws.send_json({"type": "error",
                                            "message": f"处理音频失败: {e}",
                                            "code": "PROCESSING_ERROR"})
                    continue
                data = json.loads(payload.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                # UnicodeDecodeError: text frame with invalid UTF-8 — same
                # error-frame-keep-connection contract as malformed JSON
                await ws.send_json({"type": "error",
                                    "message": "消息格式错误，需为 JSON 字符串",
                                    "code": "INVALID_JSON"})
                continue
            if not isinstance(data, dict):
                # valid JSON but not an object ("42", "null", "[]") — error
                # frame, keep the connection (found by tests/test_ws_fuzz.py)
                await ws.send_json({"type": "error",
                                    "message": "消息格式错误，需为 JSON 对象",
                                    "code": "INVALID_JSON"})
                continue
            mtype = data.get("type", "")
            if mtype == "end_conversation":
                sess.reset()
                # full session reset restores the server-default LLM flag
                # too, matching use_wake/use_sv (which live in sess)
                use_llm = use_llm_default
                await ws.send_json({"type": "status",
                                    "status": "conversation_ended",
                                    "message": "会话已结束，状态已重置"})
                continue
            if mtype == "cancel_enrollment":
                sess.set_use_wake(True)
                sess.reset()
                sess.mode = S.WAITING_FOR_WAKEUP
                await ws.send_json({"type": "status",
                                    "status": "enrollment_cancelled",
                                    "message": "声纹录制已取消，已回退到等待唤醒状态"})
                continue
            if mtype == "start_asr":
                if sess.confirm_start_asr():
                    await ws.send_json({"type": "status",
                                        "status": "asr_started",
                                        "message": "已切换到ASR识别模式"})
                continue
            if data.get("use_wake") is not None:
                sess.set_use_wake(bool(data["use_wake"]))
            if data.get("use_sv") is not None:
                sess.set_use_sv(bool(data["use_sv"]))
            if data.get("save_sample"):
                # WS audio message carries save_sample/diagnosis_session_id
                # (reference WebSocketAudioMessage schema) — persist the
                # finalize buffers for this session
                sess.generated_dir = sess.generated_dir or cfg.generated_dir
            if data.get("use_llm") is not None:
                use_llm = bool(data["use_llm"])   # persists for later frames
            wav_b64 = data.get("wav_base64") or data.get("audio_data")
            if not wav_b64 or not isinstance(wav_b64, str):
                await ws.send_json({"type": "error",
                                    "message": "缺少有效字段 'wav_base64' 或 'audio_data'",
                                    "code": "MISSING_AUDIO_DATA"})
                continue
            if sess.is_completed:
                sess.reset()
            try:
                audio_np = base64_to_audio_np(wav_b64)
            except Exception as e:
                await ws.send_json({"type": "error",
                                    "message": f"音频解码失败: {e}",
                                    "code": "AUDIO_DECODE_ERROR"})
                continue

            try:
                await _process_audio(ws, sess, audio_np, use_llm)
            except Exception as e:  # error frame, keep connection (voice.py:881-888)
                logger.exception("audio processing error")
                await ws.send_json({"type": "error",
                                    "message": f"处理音频失败: {e}",
                                    "code": "PROCESSING_ERROR"})

    # batched serving (DEFAULT): session work runs off the event loop so N
    # concurrent connections' chunks can meet inside the shared VAD hub's
    # batched device tick (service/hub.py); VOICE_BATCH_SERVING=0 restores
    # the reference's in-loop sequential handling
    batch_serving = os.getenv("VOICE_BATCH_SERVING", "1") in ("1", "true")

    # a DEDICATED executor sized for CONCURRENCY, not cores:
    # asyncio.to_thread shares the loop's default executor, whose
    # min(32, cpu+4) threads starve at tens of concurrent streams (on a
    # small host, 64 streams × 2.5 chunks/s through 5 threads builds an
    # unbounded backlog that outlives the connections — found by
    # benchmarks/run.py wsload). Session work PARKS on hub tick events
    # rather than burning CPU, so hundreds of waiting threads are cheap —
    # the device work is batched by the hubs regardless.
    from concurrent.futures import ThreadPoolExecutor
    serving_exec = (ThreadPoolExecutor(
        max_workers=int(os.getenv("VOICE_SERVING_THREADS", "256")),
        thread_name_prefix="voice-serving") if batch_serving else None)

    async def _call(fn, *a):
        if batch_serving:
            import asyncio
            return await asyncio.get_running_loop().run_in_executor(
                serving_exec, lambda: fn(*a))
        return fn(*a)

    async def _process_audio(ws: WebSocket, sess, audio_np, use_llm) -> None:
        if sess.mode == S.WAITING_FOR_WAKEUP:
            if await _call(sess.process_wakeup_chunk, audio_np):
                await ws.send_json({"type": "wakeup",
                                    "status": "activated",
                                    "message": "系统已唤醒，等待声纹录制"})
        elif sess.mode == S.WAITING_FOR_ENROLLMENT:
            r = await _call(sess.process_enrollment_chunk, audio_np)
            if r["completed"]:
                await ws.send_json({
                    "type": "enrollment_completed",
                    "status": "completed",
                    "message": "Enrollment is completed, please close the window."})
        elif sess.mode == S.WAITING_FOR_ENROLLMENT_CONFIRM:
            pass  # waiting for start_asr control message
        elif sess.mode == S.ASR_ACTIVE:
            r = await _call(sess.process_chunk, audio_np)
            if r["intermediate_text"]:
                # 2-pass partials (opt-in; same shape as the message the
                # reference left commented out, voice.py:618-625)
                await ws.send_json({"type": "processing",
                                    "status": "processing",
                                    "intermediate_text": r["intermediate_text"]})
            if not r["should_finalize"]:
                return
            await ws.send_json({"type": "processing",
                                "status": "finalizing",
                                "message": "正在处理音频..."})
            t_fin = time.perf_counter()
            final_text = await _call(sess.finalize)
            _FINALIZE_LAT.observe(time.perf_counter() - t_fin)
            _UTTERANCES.inc()
            if final_text in (S.SV_VERIFICATION_FAILED, S.ASR_RESULT_EMPTY):
                await ws.send_json({"type": "result", "status": "completed",
                                    "text": "", "success": False,
                                    "message": "抱歉，请再说一遍！"})
            elif final_text == S.SV_NOT_ACTIVATED:
                await ws.send_json({"type": "result", "status": "completed",
                                    "text": "", "success": False,
                                    "message": "非认证注册声音，拒绝访问。"})
            else:
                text = apply_hard_corrections(final_text)
                if use_llm and text:
                    try:
                        from ..llm.correction import (correct_text_only,
                                                      load_hotword_options)
                        # weighted "word weight" lines so rule 4 (priority /
                        # banned words) has data to act on
                        text = correct_text_only(
                            latest_options=load_hotword_options(), text=text)
                    except Exception:
                        logger.exception("LLM correction failed")
                await ws.send_json({"type": "result", "status": "completed",
                                    "text": text, "success": True})
            sess.reset_asr_state()

    return app


def main(device: DeviceLike = None) -> None:
    logging.basicConfig(level=logging.INFO, force=True)
    cfg = load_voice_config()
    from .http import ssl_context_for
    create_app(cfg=cfg, device=device).run(
        cfg.server.host, cfg.server.port,
        ssl_context=ssl_context_for(cfg.ssl))


if __name__ == "__main__":
    main()
