"""Full voice-agent loop: VAD → KWS → SV → ASR → LLM (→ TTS).

Port of `toolbox_for_asr_and_tts_tpu/demo/full_voice_demo.py` over the
port's engines (the card unless told otherwise: `--torch-device cpu` here,
`demo --device cpu` through the CLI; `--device` names the microphone, as
in the reference). The audio source is a WAV file, any iterator of chunks,
or the microphone through the optional `sounddevice` package (`run_mic`
raises without it); the loop logic is the reference demo's
(full_voice_demo.py:97-615):

- `VADRecorder`: 30 ms frames, energy threshold calibrated from 1 s of
  leading background (×2.5, full_voice_demo.py:151-171), 3 voiced frames to
  start, 300 ms pre-roll, 1 s silence endpoint, 60 s max segment
  (full_voice_demo.py:194-249).
- first segment ≥ 2 s with wake word = SV enrollment (full_voice_demo.py:
  366-382); later segments verified at threshold 0.31 (:35).
- recognized text goes to the `chat` callback (LLM), and optionally back out
  through TTS.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterator, List, Optional

import numpy as np

logger = logging.getLogger("toolbox.demo")

SR = 16000
FRAME_MS = 30
FRAME = SR * FRAME_MS // 1000

DEMO_SV_THRESHOLD = 0.31  # full_voice_demo.py:35


@dataclasses.dataclass
class Segment:
    audio: np.ndarray
    start_s: float
    end_s: float


class VADRecorder:
    """Energy endpointing over 30 ms frames (reference VADRecorder)."""

    def __init__(self, pre_roll_ms: int = 300, silence_end_s: float = 1.0,
                 max_segment_s: float = 60.0, start_frames: int = 3):
        self.energy_threshold = 0.01
        self.pre_roll = pre_roll_ms // FRAME_MS
        self.silence_end = int(silence_end_s * 1000 / FRAME_MS)
        self.max_frames = int(max_segment_s * 1000 / FRAME_MS)
        self.start_frames = start_frames

    def calibrate(self, background: np.ndarray) -> None:
        """energy_threshold = background RMS × 2.5 (full_voice_demo.py:151-171)."""
        rms = float(np.sqrt(np.mean(np.square(background)) + 1e-12))
        self.energy_threshold = max(rms * 2.5, 0.005)
        logger.info("VAD calibrated: threshold=%.4f", self.energy_threshold)

    def stream(self, frames: Iterator[np.ndarray]) -> Iterator[Segment]:
        """INCREMENTAL endpointing over a live iterator of 30 ms frames —
        the same FSM the reference's VADRecorder runs on the sounddevice
        callback queue (full_voice_demo.py:194-249). Yields each Segment
        as soon as its endpoint (1 s silence / 60 s cap) fires, so a mic
        source gets results mid-stream; a trailing open segment is flushed
        when the iterator ends."""
        state = "waiting"
        voiced_run = 0
        silence_run = 0
        buf: List[np.ndarray] = []
        pre: List[np.ndarray] = []
        start_idx = 0
        idx = -1
        for idx, f in enumerate(frames):
            rms = float(np.sqrt(np.mean(np.square(f)) + 1e-12))
            voiced = rms > self.energy_threshold
            if state == "waiting":
                pre.append(f)
                if len(pre) > self.pre_roll:
                    pre.pop(0)
                voiced_run = voiced_run + 1 if voiced else 0
                if voiced_run >= self.start_frames:
                    state = "recording"
                    buf = list(pre)
                    start_idx = idx - len(pre) + 1
                    silence_run = 0
            else:
                buf.append(f)
                silence_run = 0 if voiced else silence_run + 1
                if silence_run >= self.silence_end or len(buf) >= self.max_frames:
                    seg = np.concatenate(buf)
                    yield Segment(seg, start_idx * FRAME_MS / 1000,
                                  (idx + 1) * FRAME_MS / 1000)
                    state, buf, pre = "waiting", [], []
                    voiced_run = silence_run = 0
        if state == "recording" and buf:
            yield Segment(np.concatenate(buf), start_idx * FRAME_MS / 1000,
                          (idx + 1) * FRAME_MS / 1000)

    def segments(self, audio: np.ndarray) -> Iterator[Segment]:
        """Offline segmentation of a whole recording via the same FSM."""
        return self.stream(audio[i:i + FRAME]
                           for i in range(0, len(audio) - FRAME + 1, FRAME))


class VoiceAgentLoop:
    """The demo's recognition_worker (full_voice_demo.py:283-482)."""

    def __init__(self, engines, chat: Optional[Callable[[str], str]] = None,
                 tts=None, use_sv: bool = True, use_wake: bool = True,
                 sv_threshold: float = DEMO_SV_THRESHOLD):
        self.engines = engines
        self.chat = chat or (lambda text: "")
        self.tts = tts
        self.use_sv = use_sv
        self.use_wake = use_wake
        self.sv_threshold = sv_threshold
        self.enroll_emb: Optional[np.ndarray] = None
        self.transcript: List[dict] = []

    def _wake_in(self, audio: np.ndarray) -> bool:
        if self.engines.kws is None:
            return True
        from ..asr.session import StreamingASRSession
        sess = StreamingASRSession(self.engines, use_wake=True, use_sv=False)
        step = 6400
        for i in range(0, len(audio), step):
            if sess.process_wakeup_chunk(audio[i:i + step]):
                return True
        return False

    def handle_segment(self, seg: Segment) -> Optional[str]:
        """One VAD segment through the gate chain; returns the reply text."""
        if self.use_wake and not self._wake_in(seg.audio):
            if self.enroll_emb is None:
                logger.info("segment rejected: no wake word")
                return None
        if self.use_sv and self.engines.verifier is not None:
            if self.enroll_emb is None:
                if len(seg.audio) >= 2 * SR:  # first ≥2 s segment enrolls
                    self.enroll_emb = self.engines.verifier.embed([seg.audio])[0]
                    logger.info("SV enrolled from %.1f s segment",
                                len(seg.audio) / SR)
                    return None
            else:
                from ..models.campplus import cosine_score
                emb = self.engines.verifier.embed([seg.audio])[0]
                score = cosine_score(self.enroll_emb, emb)
                if score < self.sv_threshold:
                    logger.info("segment rejected: SV score %.3f", score)
                    return None
        sents = self.engines.diarizer.diarize(seg.audio)
        text = "".join(s.text for s in sents)
        if not text:
            return None
        self.transcript.append({"role": "user", "text": text,
                                "t": seg.start_s})
        if text.strip().rstrip("。") == "退出":  # demo stop word (:475)
            return "__EXIT__"
        reply = self.chat(text)
        self.transcript.append({"role": "assistant", "text": reply})
        if self.tts is not None and reply:
            self.tts.synthesize(reply)
        return reply

    def run_file(self, wav_path: str, calibrate_s: float = 1.0) -> List[dict]:
        from ..utils.audio import ensure_mono_16k, read_wav
        x, sr = read_wav(wav_path)
        audio = ensure_mono_16k(x, sr)
        return self.run_audio(audio, calibrate_s)

    def run_audio(self, audio: np.ndarray, calibrate_s: float = 1.0) -> List[dict]:
        rec = VADRecorder()
        n_cal = int(calibrate_s * SR)
        rec.calibrate(audio[:n_cal])
        for seg in rec.segments(audio[n_cal:]):
            if self.handle_segment(seg) == "__EXIT__":
                break
        return self.transcript

    def run_mic(self, device=None, calibrate_s: float = 1.0,
                max_minutes: float = 30.0) -> List[dict]:
        """LIVE microphone loop (reference full_voice_demo.py:97-280):
        capture 30 ms frames via sounddevice, calibrate the energy
        threshold from `calibrate_s` of leading background (rms × 2.5),
        then run the same endpointing FSM incrementally — 300 ms pre-roll,
        1 s silence endpoint, 60 s max segment. sounddevice is an OPTIONAL
        dependency (absent in server images); a clear error is raised if
        it is missing. Say 退出 to stop."""
        try:
            import sounddevice as sd
        except ImportError as e:  # pragma: no cover - not in server images
            raise RuntimeError(
                "--mic needs the sounddevice package (pip install "
                "sounddevice); in server images use the WAV-file mode"
            ) from e
        import queue
        q: "queue.Queue[np.ndarray]" = queue.Queue()

        def on_block(indata, frames, time_info, status):  # pragma: no cover
            if status:
                logger.warning("mic: %s", status)
            q.put(indata[:, 0].copy())

        with sd.InputStream(samplerate=SR, channels=1, dtype="float32",
                            blocksize=FRAME, device=device,
                            callback=on_block):   # pragma: no cover
            rec = VADRecorder()
            logger.info("calibrating background noise (%.1f s) — stay "
                        "quiet...", calibrate_s)
            cal = [q.get() for _ in range(int(calibrate_s * 1000 / FRAME_MS))]
            rec.calibrate(np.concatenate(cal))
            logger.info("listening (say 退出 to stop)")
            deadline_frames = int(max_minutes * 60 * 1000 / FRAME_MS)

            def mic_frames():
                for _ in range(deadline_frames):
                    yield q.get()

            for seg in rec.stream(mic_frames()):
                if self.handle_segment(seg) == "__EXIT__":
                    break
        return self.transcript


def main(argv=None) -> None:
    import argparse
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="voice agent demo "
                                 "(WAV file or live microphone)")
    ap.add_argument("wav", nargs="?", help="input 16k WAV recording")
    ap.add_argument("--mic", action="store_true",
                    help="capture from the default microphone "
                         "(needs sounddevice)")
    ap.add_argument("--device", default=None,
                    help="sounddevice input device for --mic")
    ap.add_argument("--no-sv", action="store_true")
    ap.add_argument("--no-wake", action="store_true")
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--torch-device", default="cuda",
                    help="where the engines run (cuda, or cpu)")
    args = ap.parse_args(argv)
    if bool(args.wav) == bool(args.mic):
        ap.error("give a WAV path or --mic (exactly one)")
    from ..service.engines import build_engines
    engines = build_engines(args.model_dir, device=args.torch_device)
    try:
        loop = VoiceAgentLoop(engines, use_sv=not args.no_sv,
                              use_wake=not args.no_wake)
        if args.mic:
            transcript = loop.run_mic(device=args.device)
        else:
            transcript = loop.run_file(args.wav)
    finally:
        engines.close()
    for turn in transcript:
        print(f"[{turn['role']}] {turn['text']}")


if __name__ == "__main__":
    main()
