"""Streaming ASR session: the per-connection state machine.

Copy of `toolbox_for_asr_and_tts_tpu/asr/session.py` for the port
(framework-free; imports kept relative).

Behavioral port of the reference's `StreamingASRSession`
(voice-service/app/services/voice_interface.py:1096-2633) and the mode logic
the WS handler layers on top (voice-service/app/api/voice.py:375-663):

Modes: WAITING_FOR_WAKEUP → WAITING_FOR_ENROLLMENT →
       WAITING_FOR_ENROLLMENT_CONFIRM → ASR_ACTIVE
(straight to ASR_ACTIVE when use_wake is off).

Faithful rules (survey §7 "hard parts" list):
- per-chunk speech decision is ENERGY-based AND-logic (mean>0.03 ∧ peak>0.17,
  voice_interface.py:1573-1606); the FSMN-VAD model output ORs in during
  enrollment only (voice.py:484-485);
- 400 ms pre-speech rollback FIFO, flushed into the buffer at speech onset
  (voice_interface.py:1679-1698);
- after speech started, at most 2 silent chunks are appended; later silence
  only advances the silence timer (voice_interface.py:1724-1735);
- finalize when silence ≥ 2.0 s ∧ buffer non-empty ∧ speech was detected
  (voice_interface.py:1816-1818);
- KWS: 1600 ms sliding FIFO window, decision each chunk once full; success
  purges all ASR state (voice_interface.py:1306-1321,1448-1466);
- enrollment ends on the AND of ≥5 s since first speech ∧ ≥2 s silence
  (voice.py:527-548);
- finalize pipeline: diarize → group by speaker → SV per speaker → best
  score vs threshold 0.40 → sentinels __SV_VERIFICATION_FAILED__ /
  __SV_NOT_ACTIVATED__ / __ASR_RESULT_EMPTY__ (voice_interface.py:1882-2303).

Against the reference, a model step that fails (KWS, model VAD, partial
decode, speaker embedding) raises out of the session instead of being
logged and replaced by a default; the app answers it with a
PROCESSING_ERROR frame and keeps the connection.

Timing uses the AUDIO clock (accumulated chunk duration) rather than the
reference's wall clock — chunks arrive in real time in production so the two
agree, and the audio clock makes the FSM deterministic under replay tests.
"""
from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional

import numpy as np

from ..ops.vad_energy import is_speech_energy
from .corrections import is_punct_only
from .diarization import Diarizer, extract_speaker_audio, group_by_speaker

logger = logging.getLogger("toolbox.session")

SR = 16000

# sentinels (voice_interface.py:2187,2217,2277)
SV_VERIFICATION_FAILED = "__SV_VERIFICATION_FAILED__"
SV_NOT_ACTIVATED = "__SV_NOT_ACTIVATED__"
ASR_RESULT_EMPTY = "__ASR_RESULT_EMPTY__"

# modes (voice.py:375,436,598,608)
WAITING_FOR_WAKEUP = "WAITING_FOR_WAKEUP"
WAITING_FOR_ENROLLMENT = "WAITING_FOR_ENROLLMENT"
WAITING_FOR_ENROLLMENT_CONFIRM = "WAITING_FOR_ENROLLMENT_CONFIRM"
ASR_ACTIVE = "ASR_ACTIVE"


@dataclasses.dataclass
class VoiceEngines:
    """Model bundle a session runs against (all lazily loadable)."""
    diarizer: Diarizer
    kws: Any = None               # models.kws_ctc.KeywordSpotter
    verifier: Any = None          # asr.speaker.SpeakerVerifier
    vad_factory: Any = None        # optional () -> StreamingVadStepper
    streaming_factory: Any = None  # optional () -> StreamingRecognizer;
                                   # per-session (2-pass partials + offline final)

    def close(self) -> None:
        """Stop the shared serving hubs this bundle owns (the batched-
        serving default spawns FinalizeHub / VadHub / ChunkedHub threads per
        build — a process that rebuilds engines must release the old set)."""
        for obj in (self.diarizer, self.kws,
                    getattr(self.streaming_factory, "hub", None),
                    getattr(self.vad_factory, "hub", None)):
            fn = getattr(obj, "close", None)
            if fn is not None:
                try:
                    fn()
                except Exception:
                    pass


class StreamingASRSession:
    SILENCE_THRESHOLD_S = 2.0          # voice_interface.py:649
    KWS_WINDOW_S = 1.6                 # voice_interface.py:1126
    PRE_SPEECH_S = 0.4                 # voice_interface.py:1115-1116
    MAX_SILENT_CHUNKS = 2              # voice_interface.py:1724-1735
    MIN_ENROLL_S = 5.0                 # voice_interface.py:1137
    ENROLL_SILENCE_S = 2.0             # voice.py:540
    EXP_SV_MIN_S = 1.0                 # voice_interface.py:1146
    EXP_SV_INTERVAL_S = 0.4            # voice_interface.py:1148

    def __init__(self, engines: VoiceEngines, use_wake: bool = True,
                 use_sv: bool = True, generated_dir: Optional[str] = None):
        """generated_dir: when set, persist enrollment samples and finalize
        buffers as WAVs (reference `_save_enroll_sample` /
        `_save_kws_audio` / finalize dumps, voice_interface.py:1488-1544,
        1970-2028, 2449-2475)."""
        self.engines = engines
        self.generated_dir = generated_dir
        self.streaming = (engines.streaming_factory()
                          if engines.streaming_factory else None)
        self.vad = engines.vad_factory() if engines.vad_factory else None
        self.use_wake = use_wake
        self.use_speaker_verification = use_sv
        self.is_activated = False
        self.is_enrolled = False
        self.enroll_audio: Optional[np.ndarray] = None
        self.mode = WAITING_FOR_WAKEUP if use_wake else ASR_ACTIVE
        # per-chunk experimental SV (reference voice_interface.py:1834-1871):
        # diagnostic-only in the reference too; OFF by default
        self.experimental_chunk_sv = os.getenv(
            "VOICE_EXPERIMENTAL_CHUNK_SV", "0") in ("1", "true")
        self._closed = False
        self._init_asr_state()
        self._init_kws_state()
        self._init_enroll_state()

    def close(self) -> None:
        """Release the session's per-connection engine handles — under
        batched serving these HOLD HUB ROWS (HubStreamingRecognizer /
        HubVadStepper each claim a ticker slot). A server that skips this
        leaks one row per closed connection until every new session lands
        on the slow overflow path (round-3 wsload finding: after ~64
        cumulative connections, finalizes took minutes). Idempotent."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        for handle in (self.streaming, self.vad):
            fn = getattr(handle, "close", None)
            if fn is not None:
                try:
                    fn()
                except Exception:
                    logger.debug("session handle close failed",
                                 exc_info=True)

    # ------------------------------------------------------------- state
    def _init_asr_state(self) -> None:
        if getattr(self, "streaming", None) is not None:
            self.streaming.reset()
        if getattr(self, "vad", None) is not None:
            self.vad.reset()  # reference clears vad_cache on reset (:1257-1275)
        self.audio_buffer = np.array([], np.float32)
        self.pre_speech_buffer = np.array([], np.float32)
        self.silence_timer = 0.0
        self.silence_chunk_count = 0
        self.has_detected_speech = False
        self.is_completed = False
        # experimental per-chunk SV buffers (reference clears them with the
        # ASR state, voice_interface.py:1193-1200); the clock is AUDIO time
        # — the session is paced by received samples, not wall time
        self.exp_sv_buffer = np.array([], np.float32)
        self.exp_sv_accumulated = np.array([], np.float32)
        self.exp_sv_clock_s = 0.0
        self.exp_sv_last_verify_s = -1e9
        self.exp_sv_last: Optional[Dict[str, Any]] = None

    def _init_kws_state(self) -> None:
        self.kws_buffer = np.array([], np.float32)

    def _init_enroll_state(self) -> None:
        self.enroll_audio_buffer = np.array([], np.float32)
        self.enroll_has_detected_speech = False
        self.enroll_speech_elapsed = 0.0
        self.enroll_silence_timer = 0.0

    def reset(self) -> None:
        """Full reset (reference `reset`, voice_interface.py:1150-1223):
        clears ASR/KWS/enrollment state; mode follows use_wake."""
        self._init_asr_state()
        self._init_kws_state()
        self._init_enroll_state()
        self.is_activated = False
        self.mode = WAITING_FOR_WAKEUP if self.use_wake else ASR_ACTIVE

    def reset_asr_state(self) -> None:
        """Between utterances, stay in ASR_ACTIVE
        (reference `reset_asr_state`, voice_interface.py:1257-1275)."""
        self._init_asr_state()

    def set_use_wake(self, use_wake: bool) -> None:
        """Reference `set_use_wake` (voice_interface.py:1225-1255)."""
        self.use_wake = use_wake
        if not use_wake and self.mode == WAITING_FOR_WAKEUP:
            self.mode = ASR_ACTIVE
        elif use_wake and not self.is_activated:
            self.mode = WAITING_FOR_WAKEUP

    def set_use_sv(self, use_sv: bool) -> None:
        """voice.py use_sv handling: disabling clears enrollment."""
        self.use_speaker_verification = use_sv
        if not use_sv:
            self.is_enrolled = False
            self.enroll_audio = None
            self._enroll_emb = None
            self.enroll_audio_buffer = np.array([], np.float32)

    # --------------------------------------------------------------- KWS
    def process_wakeup_chunk(self, audio_np: np.ndarray) -> bool:
        """1600 ms FIFO window → KWS decision (voice_interface.py:1277-1336).
        On success, purge ASR state and report wake."""
        self.kws_buffer = np.concatenate([self.kws_buffer, audio_np])
        max_samples = int(self.KWS_WINDOW_S * SR)
        if len(self.kws_buffer) > max_samples:
            self.kws_buffer = self.kws_buffer[-max_samples:]
        if len(self.kws_buffer) < max_samples:
            return False
        if self.engines.kws is None:
            return False
        detected = self._run_kws(self.kws_buffer)
        if detected:
            self._save_generated("kws_trigger", self.kws_buffer)  # :1488-1544
            # success purges buffers so the wake word never reaches ASR
            # (voice_interface.py:1448-1466; voice.py:383-423)
            kws_audio = self.kws_buffer
            self._init_kws_state()
            self._init_asr_state()
            self.is_activated = True
            if self.use_speaker_verification and not self.is_enrolled:
                self.mode = WAITING_FOR_ENROLLMENT
                # seed enrollment with the wake-word audio (voice.py:407)
                self.enroll_audio_buffer = kws_audio.copy()
                self.enroll_has_detected_speech = True
            else:
                self.mode = ASR_ACTIVE
        return detected

    def _run_kws(self, window: np.ndarray) -> bool:
        # one fused jitted program per window length (fbank→LFR→DFSMN→CTC);
        # the previous eager frontend dispatched dozens of device ops per
        # 400 ms chunk in WAITING_FOR_WAKEUP (round-2d review finding)
        detected, score = self.engines.kws.detect_audio(window)
        logger.debug("KWS score %.3f detected=%s", score, detected)
        return detected

    # -------------------------------------------------------- enrollment
    def process_enrollment_chunk(self, audio_np: np.ndarray) -> Dict[str, Any]:
        """Accumulate voiceprint audio (voice.py:436-597). Returns
        {"completed": bool}. On completion mode → CONFIRM."""
        chunk_s = len(audio_np) / SR
        is_speech = bool(is_speech_energy(audio_np)) or self._model_vad(audio_np)
        if is_speech:
            self.enroll_has_detected_speech = True
            self.enroll_silence_timer = 0.0
        elif self.enroll_has_detected_speech:
            self.enroll_silence_timer += chunk_s
        if self.enroll_has_detected_speech:
            self.enroll_audio_buffer = np.concatenate(
                [self.enroll_audio_buffer, audio_np])
            self.enroll_speech_elapsed += chunk_s
        cond1 = self.enroll_speech_elapsed >= self.MIN_ENROLL_S
        cond2 = self.enroll_silence_timer >= self.ENROLL_SILENCE_S
        if cond1 and cond2 and not self.is_enrolled:   # AND logic, voice.py:538
            self.enroll_audio = self.enroll_audio_buffer.copy()
            self._enroll_emb = None  # invalidate any cached embedding
            self._save_generated("enroll_samples", self.enroll_audio)
            self.is_enrolled = True
            self.enroll_audio_buffer = np.array([], np.float32)
            self.enroll_has_detected_speech = False
            self.enroll_speech_elapsed = 0.0
            self.enroll_silence_timer = 0.0
            self.mode = WAITING_FOR_ENROLLMENT_CONFIRM
            return {"completed": True}
        return {"completed": False}

    def confirm_start_asr(self) -> bool:
        """`start_asr` control message (voice.py:267-302)."""
        if self.mode in (WAITING_FOR_ENROLLMENT, WAITING_FOR_ENROLLMENT_CONFIRM):
            self.mode = ASR_ACTIVE
            self._init_asr_state()
            return True
        return False

    def _model_vad(self, audio_np: np.ndarray) -> bool:
        # a failing VAD step raises (the reference falls back to the energy
        # gate alone; the port turns no model error into a default)
        if self.vad is None:
            return False
        return bool(self.vad(audio_np))

    # ---------------------------------------------------------- ASR flow
    def process_chunk(self, audio_np: np.ndarray) -> Dict[str, Any]:
        """One 400 ms chunk in ASR_ACTIVE (voice_interface.py:1546-1877)."""
        chunk_s = len(audio_np) / SR
        is_speech = bool(is_speech_energy(audio_np))  # energy is decisive
        if is_speech:
            self.silence_timer = 0.0
            self.has_detected_speech = True
            self.silence_chunk_count = 0
            if len(self.pre_speech_buffer) > 0:  # rollback protection
                self.audio_buffer = np.concatenate(
                    [self.audio_buffer, self.pre_speech_buffer])
                self.pre_speech_buffer = np.array([], np.float32)
            self.audio_buffer = np.concatenate([self.audio_buffer, audio_np])
        else:
            if self.has_detected_speech:
                if self.silence_chunk_count < self.MAX_SILENT_CHUNKS:
                    self.audio_buffer = np.concatenate(
                        [self.audio_buffer, audio_np])
                    self.silence_chunk_count += 1
                self.silence_timer += chunk_s
            else:
                self.pre_speech_buffer = np.concatenate(
                    [self.pre_speech_buffer, audio_np])
                max_pre = int(self.PRE_SPEECH_S * SR)
                if len(self.pre_speech_buffer) > max_pre:
                    self.pre_speech_buffer = self.pre_speech_buffer[-max_pre:]
                self.silence_timer = 0.0
        should_finalize = (self.silence_timer >= self.SILENCE_THRESHOLD_S
                           and len(self.audio_buffer) > 0
                           and self.has_detected_speech)
        # 2-pass partials: the reference loads the online model but disables
        # mid-chunk decode (voice_interface.py:1749-1809); here it is opt-in
        # via an attached StreamingRecognizer — the final result still comes
        # from the offline finalize pass.
        intermediate = ""
        if self.streaming is not None and is_speech:
            # a failing partial decode raises (the reference sends no
            # partial instead; the port turns no model error into a default)
            intermediate = self.streaming.push_audio(audio_np)
        out = {
            "is_speech": is_speech,
            "should_finalize": should_finalize,
            "buffer_s": len(self.audio_buffer) / SR,
            "silence_s": self.silence_timer,
            "intermediate_text": intermediate,
        }
        if self.experimental_chunk_sv:
            out["experimental_sv"] = self._experimental_sv_step(
                audio_np, chunk_s, is_speech)
        return out

    def _experimental_sv_step(self, audio_np: np.ndarray, chunk_s: float,
                              is_speech: bool) -> Optional[Dict[str, Any]]:
        """Per-chunk experimental SV (voice_interface.py:1834-1871 +
        _verify_speaker_sync :2477-2540): score the current speech run AND
        the utterance-accumulated buffer against the enrollment in real
        time. Diagnostic only — nothing gates on the result (the reference
        likewise only logs it). TPU-native differences: the enrollment
        embedding is cached in memory (no temp-WAV round trips through a
        pipeline), both buffers are scored with ONE batched embed call, and
        the verify interval runs on the session's AUDIO clock."""
        self.exp_sv_clock_s += chunk_s
        if not (self.use_speaker_verification and self.is_enrolled
                and self.is_activated and self.enroll_audio is not None):
            return None
        if not is_speech:
            # silence drops a too-short pending chunk buffer (:1866-1871);
            # the accumulated buffer is kept for the whole utterance
            if 0 < len(self.exp_sv_buffer) < int(self.EXP_SV_MIN_S * SR):
                self.exp_sv_buffer = np.array([], np.float32)
            return None
        self.exp_sv_buffer = np.concatenate([self.exp_sv_buffer, audio_np])
        self.exp_sv_accumulated = np.concatenate(
            [self.exp_sv_accumulated, audio_np])
        buf_s = len(self.exp_sv_buffer) / SR
        due = (self.exp_sv_clock_s - self.exp_sv_last_verify_s
               >= self.EXP_SV_INTERVAL_S)
        if buf_s < self.EXP_SV_MIN_S or not due:
            return self.exp_sv_last
        from ..models.campplus import cosine_score
        acc_s = len(self.exp_sv_accumulated) / SR
        bufs = [self.exp_sv_buffer]
        if acc_s >= self.EXP_SV_MIN_S:
            bufs.append(self.exp_sv_accumulated)
        embs = self.engines.verifier.embed(bufs)
        enroll = self._enroll_embedding()
        thr = self.engines.verifier.threshold
        chunk_score = float(cosine_score(enroll, embs[0]))
        res: Dict[str, Any] = {
            "chunk_score": chunk_score,
            "chunk_verified": chunk_score >= thr,
            "chunk_s": buf_s,
            "accumulated_score": None,
            "accumulated_verified": None,
            "accumulated_s": acc_s,
        }
        if len(bufs) > 1:
            acc_score = float(cosine_score(enroll, embs[1]))
            res["accumulated_score"] = acc_score
            res["accumulated_verified"] = acc_score >= thr
        logger.info(
            "experimental chunk SV: chunk %.3f (%.1fs) accumulated %s "
            "(%.1fs)", chunk_score, buf_s,
            ("%.3f" % res["accumulated_score"])
            if res["accumulated_score"] is not None else "-", acc_s)
        self.exp_sv_last = res
        # verified or not, the chunk buffer restarts for the next round
        # (:1859-1865); the accumulated buffer persists
        self.exp_sv_buffer = np.array([], np.float32)
        self.exp_sv_last_verify_s = self.exp_sv_clock_s
        return self.exp_sv_last

    def finalize(self) -> str:
        """Full-buffer recognition + diarization + SV
        (voice_interface.py:1882-2303). Returns text or a sentinel."""
        wav = self.audio_buffer
        self.is_completed = True
        if len(wav) < SR // 10:
            return ASR_RESULT_EMPTY
        if not np.isfinite(wav).all():   # NaN/Inf guard (:1930-1948)
            logger.error("non-finite audio in finalize buffer")
            return ASR_RESULT_EMPTY
        from ..ops.vad_energy import dump_clipped_audio
        dump_clipped_audio(wav)  # QC telemetry (voice_interface.py:942-980)
        self._save_generated("asr_final_audio", wav)
        # activation gate BEFORE the expensive diarization pass — a
        # non-activated session's result is discarded unconditionally, so
        # transcribing/clustering the whole buffer first was pure waste
        # (round-2d review finding; sentinel unchanged, :2187)
        if self.use_speaker_verification and not self.is_activated \
                and self.use_wake:
            return SV_NOT_ACTIVATED  # :2187
        use_sv = (self.use_speaker_verification and self.is_enrolled
                  and self.engines.verifier is not None)
        # SV off → the speaker labels are discarded below, so skip the
        # embedding/clustering/overlap device work entirely (need_spk=False
        # fast path; ~2.5× faster finalize on a high-RTT link)
        try:
            sents = self.engines.diarizer.diarize(wav, need_spk=use_sv)
        except TypeError as e:  # duck-typed diarizer without the fast path
            if "need_spk" not in str(e):
                raise
            sents = self.engines.diarizer.diarize(wav)
        if not sents:
            return ASR_RESULT_EMPTY
        if use_sv:
            groups = group_by_speaker(sents)
            best_spk, best_score = None, -1.0
            for spk in groups:
                seg_audio = extract_speaker_audio(wav, sents, spk)
                if len(seg_audio) < SR // 10:
                    continue
                _, score = self.engines.verifier.verify_embedding(
                    self._enroll_embedding(), seg_audio)
                logger.info("SV speaker %d score %.3f", spk, score)
                if score > best_score:
                    best_spk, best_score = spk, score
            if best_spk is None or best_score < self.engines.verifier.threshold:
                return SV_VERIFICATION_FAILED  # :2217
            text = "".join(s.text for s in sents if s.spk == best_spk)
        else:
            text = "".join(s.text for s in sents)
        if is_punct_only(text):
            return ASR_RESULT_EMPTY  # :2277-2301
        return text

    def _save_generated(self, subdir: str, wav: np.ndarray) -> None:
        if not self.generated_dir or len(wav) == 0:
            return
        try:
            import os
            import time
            from ..utils.audio import write_wav
            d = os.path.join(self.generated_dir, subdir)
            os.makedirs(d, exist_ok=True)
            write_wav(os.path.join(d, f"{int(time.time() * 1000)}.wav"),
                      wav, SR)
        except OSError:
            logger.warning("could not persist %s audio", subdir)

    def _enroll_embedding(self) -> np.ndarray:
        if getattr(self, "_enroll_emb", None) is None:
            self._enroll_emb = self.engines.verifier.embed([self.enroll_audio])[0]
        return self._enroll_emb
