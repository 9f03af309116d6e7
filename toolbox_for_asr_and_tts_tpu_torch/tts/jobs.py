"""Async TTS job manager.

Copy of `toolbox_for_asr_and_tts_tpu/tts/jobs.py` for the port
(framework-free; imports kept relative), with `close()` added to release the
worker pool.

Port of the reference `TTSManager` job lifecycle (tts-service/app/services/
tts_service.py:44-57,507-1041): in-memory job dict, a small worker pool (2
concurrent jobs by default, tts_service.py:47), cooperative cancellation,
result polling with base64 WAV + `_detailed_timing` (per-segment ms/duration,
total RTF, tts_service.py:915-936), and job cleanup.

Within a job, segments are synthesized as one batched
device program (tts/synthesizer.py) instead of a Python thread fan-out.

Beyond the reference: jobs run through `Synthesizer.synthesize_stream`, so a
poll during processing can already return the audio synthesized so far
(`get_result(partial=True)` → REST `?partial=1`, or the /api/v1/tts/ws
streaming endpoint). Chunk concatenation is sample-identical to the one-shot
result. TTS_STREAM_JOBS=0 restores whole-job synthesis.

Span (`runtime/profiling.py`): `tts.job`, a job on its worker from taking
it to storing its result, over the synthesizer's spans.
"""
from __future__ import annotations

import base64
import logging
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ..runtime import profiling, prom
from ..utils.audio import encode_wav_bytes

logger = logging.getLogger("toolbox.tts.jobs")

_JOB_EVENTS = prom.counter("toolbox_tts_jobs_total",
                           "TTS job lifecycle events",
                           ("event",))  # started/completed/error/cancelled
_JOB_RTF = prom.histogram("toolbox_tts_job_rtf",
                          "per-job real-time factor",
                          buckets=prom.RTF_BUCKETS)
_ACTIVE_MANAGERS: "weakref.WeakSet[TTSJobManager]"


def _sum_active() -> int:
    return sum(m.active_jobs for m in list(_ACTIVE_MANAGERS))


import weakref  # noqa: E402

_ACTIVE_MANAGERS = weakref.WeakSet()
prom.gauge_fn("toolbox_tts_active_jobs",
              "jobs currently pending or processing", _sum_active)


class TTSJobManager:
    def __init__(self, synthesizer, max_workers: int = 2,
                 job_ttl_s: Optional[float] = None):
        """job_ttl_s: terminal jobs (completed/error/cancelled) older than
        this are evicted on the next start/poll — clients that never DELETE
        /jobs/{id} must not grow memory without bound (each finished job
        holds a multi-MB base64 WAV). Env override: TTS_JOB_TTL_S."""
        import os
        self.synth = synthesizer
        self.jobs: Dict[str, Dict[str, Any]] = {}
        self.job_ttl_s = (job_ttl_s if job_ttl_s is not None
                          else float(os.getenv("TTS_JOB_TTL_S", "900")))
        self.stream_jobs = (
            os.getenv("TTS_STREAM_JOBS", "1") in ("1", "true")
            and hasattr(synthesizer, "synthesize_stream"))
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="tts-job")
        _ACTIVE_MANAGERS.add(self)

    def _sweep_locked(self) -> None:
        """Evict terminal jobs whose completion is older than the TTL.
        Caller holds self._lock."""
        if self.job_ttl_s <= 0:
            return
        cutoff = time.time() - self.job_ttl_s
        dead = [jid for jid, j in self.jobs.items()
                if j["status"] in ("completed", "error", "cancelled")
                and j.get("finished_at", j["created_at"]) < cutoff]
        for jid in dead:
            del self.jobs[jid]
        if dead:
            logger.info("TTS job TTL sweep evicted %d finished job(s)",
                        len(dead))

    # ------------------------------------------------------------- API
    def start_task(self, text: str, voice: str = "zhitian_emo") -> str:
        job_id = uuid.uuid4().hex
        with self._lock:
            self._sweep_locked()
            self.jobs[job_id] = {
                "status": "pending",
                "text": text,
                "voice": voice,
                "created_at": time.time(),
                "audio_base64": None,
                "error": None,
                "_detailed_timing": None,
                "chunks": [],          # progressive float32 audio (streamed)
                "segments_done": 0,
                "n_segments": None,
            }
        self._pool.submit(self._process, job_id)
        _JOB_EVENTS.inc(event="started")
        return job_id

    def cancel_task(self, job_id: str) -> bool:
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None or job["status"] in ("completed", "error"):
                return False
            job["status"] = "cancelled"
            job["finished_at"] = time.time()
        _JOB_EVENTS.inc(event="cancelled")
        return True

    def get_result(self, job_id: str,
                   partial: bool = False) -> Optional[Dict[str, Any]]:
        """partial=True: while the job is still processing, also return the
        audio synthesized SO FAR (the streamed chunk prefix — sample-
        identical to the same prefix of the final WAV). The reference poll
        returns audio only on completion (tts-service/app/api/tts.py:85-119)."""
        with self._lock:
            # fetch BEFORE sweeping: the polled job must survive this poll
            # even when its own TTL just expired
            job = self.jobs.get(job_id)
            self._sweep_locked()
            if job is None:
                return None
            audio_b64 = job["audio_base64"]
            pending_chunks = (list(job["chunks"])
                              if partial and audio_b64 is None else None)
            out = {
                "job_id": job_id,
                "status": job["status"],
                "text": job["text"],
                "audio_base64": audio_b64,
                "audio_size": len(audio_b64 or ""),
                "error": job["error"],
                "detailed_timing": job["_detailed_timing"],
                "segments_done": job["segments_done"],
                "n_segments": job["n_segments"],
            }
        if pending_chunks:
            # cache the encoded prefix by chunk count: a client polling at
            # 200 ms would otherwise make the server re-concatenate and
            # re-base64 the ENTIRE audio prefix on every poll (O(total
            # audio) per poll, quadratic over the job's life)
            n = len(pending_chunks)
            with self._lock:
                cached = job.get("_partial_cache")
            if cached is not None and cached[0] == n:
                b64 = cached[1]
            else:
                import numpy as np
                wav = np.concatenate(pending_chunks)
                b64 = base64.b64encode(
                    encode_wav_bytes(wav, self.synth.sample_rate)).decode()
                with self._lock:
                    job["_partial_cache"] = (n, b64)
            out["audio_base64"] = b64
            out["audio_size"] = len(b64)
        return out

    def cleanup_job(self, job_id: str) -> bool:
        with self._lock:
            return self.jobs.pop(job_id, None) is not None

    def close(self) -> None:
        """Stop the worker pool: queued jobs are dropped, a running one
        finishes first."""
        self._pool.shutdown(wait=True, cancel_futures=True)

    @property
    def active_jobs(self) -> int:
        with self._lock:
            return sum(1 for j in self.jobs.values()
                       if j["status"] in ("pending", "processing"))

    # ---------------------------------------------------------- worker
    def _cancelled(self, job_id: str) -> bool:
        with self._lock:
            j = self.jobs.get(job_id)
            return j is None or j["status"] == "cancelled"

    def _synthesize_streamed(self, job_id: str, text: str, voice: str):
        """Drive synthesize_stream, publishing chunk progress on the job as
        each segment lands; returns (wav, timing-fields) or None on cancel."""
        import numpy as np
        chunks = []
        final = None
        for ev in self.synth.synthesize_stream(
                text, voice, cancelled=lambda: self._cancelled(job_id)):
            if len(ev["audio"]):
                chunks.append(ev["audio"])
            if ev["event"] == "done":
                final = ev
                break
            with self._lock:
                job = self.jobs.get(job_id)
                if job is None or job["status"] == "cancelled":
                    return None
                if len(ev["audio"]):
                    job["chunks"].append(ev["audio"])
                job["segments_done"] = ev["segment_index"] + 1
                job["n_segments"] = ev["n_segments"]
        if final is None:  # cancelled mid-flight
            return None
        wav = (np.concatenate(chunks) if chunks
               else np.zeros(0, np.float32))
        return wav, {
            "rtf": final["rtf"],
            "segments": len(final["segments"]),
            "seg_times_ms": final["seg_times_ms"],
            "seg_durations_s": final["seg_durations_s"],
        }

    def _process(self, job_id: str) -> None:
        with profiling.annotate("tts.job"):
            self._run(job_id)

    def _run(self, job_id: str) -> None:
        t0 = time.time()
        try:
            with self._lock:
                job = self.jobs.get(job_id)
                if job is None or job["status"] == "cancelled":
                    return
                job["status"] = "processing"
                text, voice = job["text"], job["voice"]
            if self.stream_jobs:
                res = self._synthesize_streamed(job_id, text, voice)
                if res is None:
                    return
                wav, fields = res
            else:
                result = self.synth.synthesize(
                    text, voice, cancelled=lambda: self._cancelled(job_id))
                if result is None:  # cancelled mid-flight
                    return
                wav = result.wav
                fields = {
                    "rtf": result.rtf,
                    "segments": len(result.segments),
                    "seg_times_ms": result.seg_times_ms,
                    "seg_durations_s": result.seg_durations_s,
                }
            wav_bytes = encode_wav_bytes(wav, self.synth.sample_rate)
            b64 = base64.b64encode(wav_bytes).decode()
            timing = {"total_ms": (time.time() - t0) * 1000, **fields}
            with self._lock:
                job = self.jobs.get(job_id)
                if job is None or job["status"] == "cancelled":
                    return
                job["status"] = "completed"
                job["finished_at"] = time.time()
                job["audio_base64"] = b64
                job["chunks"] = []   # the base64 WAV holds the audio now
                job["segments_done"] = fields["segments"]
                job["n_segments"] = fields["segments"]
                job["_detailed_timing"] = timing
            _JOB_EVENTS.inc(event="completed")
            _JOB_RTF.observe(fields["rtf"])
        except Exception as e:  # job errors recorded, worker survives
            logger.exception("TTS job %s failed", job_id)
            with self._lock:
                job = self.jobs.get(job_id)
                if job is not None:
                    job["status"] = "error"
                    job["finished_at"] = time.time()
                    job["error"] = str(e)
            _JOB_EVENTS.inc(event="error")
