"""Batch recognition entry points (reference `asr_wake` API surface).

Port of `toolbox_for_asr_and_tts_tpu/asr/batch.py` over the port's engines:
`kws_wakeup` scans a recording for the wake word in 0.4 s chunks through
the session FSM's KWS window, and `asr_wake` runs the KWS gate, offline
recognition (the Diarizer), the hard corrections and the LLM correction.
`get_engines` builds the full-width engines once per process on the card
(VOICE_MODEL_DIR's checkpoints where they resolve).
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("toolbox.asr.batch")

_ENGINES = None


def get_engines():
    global _ENGINES
    if _ENGINES is None:
        from ..service.engines import build_engines
        _ENGINES = build_engines(os.getenv("VOICE_MODEL_DIR"))
    return _ENGINES


def _load(audio) -> np.ndarray:
    if isinstance(audio, str):
        from ..utils.audio import ensure_mono_16k, read_wav
        x, sr = read_wav(audio)
        return ensure_mono_16k(x, sr)
    return np.asarray(audio, np.float32)


def kws_wakeup(audio, engines=None) -> Tuple[bool, float]:
    """Scan a recording for the wake word (reference `kws_wakeup`).

    Returns (detected, best_score). `audio` is a path or float32 array."""
    engines = engines or get_engines()
    if engines.kws is None:
        return False, float("-inf")
    from .session import StreamingASRSession
    wav = _load(audio)
    sess = StreamingASRSession(engines, use_wake=True, use_sv=False)
    step = 6400
    for i in range(0, len(wav), step):
        if sess.process_wakeup_chunk(wav[i:i + step]):
            return True, 1.0
    return False, 0.0


def asr_wake(audio, use_wake: bool = True, use_llm: bool = True,
             engines=None, hotwords: Optional[dict] = None) -> str:
    """KWS gate → offline recognition → corrections → LLM
    (reference `asr_wake`)."""
    engines = engines or get_engines()
    wav = _load(audio)
    require_wake = use_wake or os.getenv("VOICE_REQUIRE_WAKE", "") in (
        "1", "true")
    if require_wake:
        detected, _ = kws_wakeup(wav, engines)
        if not detected:
            logger.info("asr_wake: no wake word detected")
            return ""
    sents = engines.diarizer.diarize(wav)
    text = "".join(s.text for s in sents)
    from .corrections import apply_hard_corrections
    text = apply_hard_corrections(text)
    if use_llm and text:
        from ..llm.correction import correct_text_only, load_hotword_options
        words = (list(hotwords) if hotwords else load_hotword_options())
        text = correct_text_only(latest_options=words, text=text)
    return text
