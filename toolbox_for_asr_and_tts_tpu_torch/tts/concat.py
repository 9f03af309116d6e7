"""Segment concatenation with pauses and linear crossfade.

Copy of `toolbox_for_asr_and_tts_tpu/tts/concat.py` for the port
(framework-free; imports kept relative).

Behavioral port of the reference's WAV stitching
(tts-service/app/services/tts_service.py:413-503): inter-segment silence
(soft 120 ms after weak/no punctuation, hard 200 ms after sentence-final
punctuation, :664-671) and a 60 ms linear crossfade at each boundary —
vectorized over numpy float32 instead of 16-bit byte loops.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def crossfade_concat(a: np.ndarray, b: np.ndarray, fade_samples: int) -> np.ndarray:
    """Concatenate with a linear crossfade over the boundary
    (reference `_crossfade_frames`, tts_service.py:418-465)."""
    if fade_samples <= 0 or len(a) < fade_samples or len(b) < fade_samples:
        return np.concatenate([a, b])
    n = fade_samples
    wa = np.linspace(1.0, 0.0, n, endpoint=True, dtype=np.float32) if n > 1 \
        else np.zeros(1, np.float32)
    wb = 1.0 - wa
    mixed = a[-n:] * wa + b[:n] * wb
    return np.concatenate([a[:-n], mixed, b[n:]])


def concat_segments(wavs: Sequence[np.ndarray], pauses_ms: Sequence[int],
                    sample_rate: int = 16000,
                    crossfade_ms: int = 60) -> np.ndarray:
    """Reference `_concat_wavs_smooth` (tts_service.py:467-503): insert the
    pause silence, then crossfade the running output with the next segment."""
    wavs = [np.asarray(w, np.float32) for w in wavs if len(w) > 0]
    if not wavs:
        return np.zeros(0, np.float32)
    fade = int(sample_rate * crossfade_ms / 1000)
    out = wavs[0]
    for i, w in enumerate(wavs[1:]):
        pause = pauses_ms[i] if i < len(pauses_ms) else 0
        if pause > 0:
            out = np.concatenate(
                [out, np.zeros(int(sample_rate * pause / 1000), np.float32)])
        out = crossfade_concat(out, w, fade)
    return out


class StreamingConcat:
    """Incremental `concat_segments`: feed segments one at a time, emit audio
    as soon as it can no longer change. The concatenation of every emitted
    chunk (+ `flush()`) is sample-identical to the offline function — locked
    by tests/test_tts_stream.py.

    Only the final `fade` samples of the running output can still be modified
    (by the next boundary's crossfade), so each `feed` emits everything except
    that tail. Branch-equivalence with the offline path: chunks are only held
    back once the running output exceeds `fade` samples, so whenever the held
    tail is shorter than `fade`, it IS the entire output so far — exactly the
    `len(a) < fade → plain concat` case of `crossfade_concat`."""

    def __init__(self, sample_rate: int = 16000, crossfade_ms: int = 60):
        self.sample_rate = sample_rate
        self.fade = max(int(sample_rate * crossfade_ms / 1000), 0)
        self._buf: np.ndarray | None = None  # un-emitted suffix
        self._n_fed = 0                      # non-empty segments so far

    def feed(self, wav: np.ndarray, pause_ms: int = 0) -> np.ndarray:
        """Add the next segment (with the pause that precedes it — ignored
        for the first non-empty segment, as offline) and return the newly
        final audio. Empty segments are skipped like the offline filter."""
        wav = np.asarray(wav, np.float32)
        if len(wav) == 0:
            return np.zeros(0, np.float32)
        if self._buf is None:
            self._buf = wav
        else:
            if pause_ms > 0:
                self._buf = np.concatenate(
                    [self._buf,
                     np.zeros(int(self.sample_rate * pause_ms / 1000),
                              np.float32)])
            self._buf = crossfade_concat(self._buf, wav, self.fade)
        self._n_fed += 1
        if len(self._buf) > self.fade:
            out = self._buf[: len(self._buf) - self.fade]
            self._buf = self._buf[len(self._buf) - self.fade:]
            return out
        return np.zeros(0, np.float32)

    @property
    def segments_fed(self) -> int:
        return self._n_fed

    def flush(self) -> np.ndarray:
        """The held-back tail once no more segments will arrive."""
        out = self._buf if self._buf is not None else np.zeros(0, np.float32)
        self._buf = None
        return out
