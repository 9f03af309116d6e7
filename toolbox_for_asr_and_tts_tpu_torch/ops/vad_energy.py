"""Energy-based VAD statistics.

Port of `toolbox_for_asr_and_tts_tpu/ops/vad_energy.py`. The reference's
final per-chunk speech decision is energy-only: a chunk is speech iff
mean(|x|) > 0.03 AND max(|x|) > 0.17. The numpy path serves host buffers (a
400 ms chunk is 6400 samples: not worth a device round trip); a torch tensor
takes the tensor branch, on whatever device it lies, and gets tensors back.
"""
from __future__ import annotations

import logging
import os
import tempfile
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

MEAN_THRESHOLD = 0.03  # reference vad_energy.py:23
PEAK_THRESHOLD = 0.17  # reference vad_energy.py:24

logger = logging.getLogger("toolbox.vad")


def _is_host(x) -> bool:
    """True for anything but a torch tensor: numpy arrays and sequences."""
    return not isinstance(x, torch.Tensor)


def energy_stats(x) -> Tuple[float, float]:
    """(mean_abs, peak_abs) of a chunk; (0, 0) for an empty chunk (a
    zero-byte WS frame must not emit NaN telemetry)."""
    if _is_host(x):
        a = np.abs(np.asarray(x))
        if a.size == 0:
            return 0.0, 0.0
        return float(a.mean()), float(a.max(initial=0.0))
    a = x.abs()
    return a.mean(), a.max()


def is_speech_energy(x, mean_threshold: float = MEAN_THRESHOLD,
                     peak_threshold: float = PEAK_THRESHOLD
                     ) -> Union[bool, torch.Tensor]:
    """AND-logic energy gate: a bool for host input, a bool tensor for a
    tensor."""
    mean_abs, peak = energy_stats(x)
    if not isinstance(mean_abs, torch.Tensor):
        return bool(mean_abs > mean_threshold and peak > peak_threshold)
    return (mean_abs > mean_threshold) & (peak > peak_threshold)


def rms(x) -> float:
    if _is_host(x):
        a = np.asarray(x)
        if a.size == 0:
            return 0.0
        return float(np.sqrt(np.mean(np.square(a)) + 1e-12))
    return torch.sqrt(torch.mean(torch.square(x)) + 1e-12)


def dump_clipped_audio(x: np.ndarray, sample_rate: int = 16000,
                       dump_dir: Optional[str] = None,
                       clipping_threshold: float = 0.01) -> Optional[str]:
    """Write a debug WAV when a buffer shows heavy clipping. Returns the
    path, or None when the buffer is clean. dump_dir defaults to
    `voice_service_debug_audio` under the temporary directory."""
    from ..utils.audio import write_wav
    stats = audio_quality_stats(x)
    if stats["clipping_ratio"] < clipping_threshold:
        return None
    if dump_dir is None:
        dump_dir = os.path.join(tempfile.gettempdir(),
                                "voice_service_debug_audio")
    try:
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(dump_dir, f"clipped_{int(time.time() * 1000)}.wav")
        write_wav(path, np.asarray(x, np.float32), sample_rate)
        logger.warning("clipped audio (%.1f%%) dumped to %s",
                       stats["clipping_ratio"] * 100, path)
        return path
    except OSError:
        return None


def audio_quality_stats(x: np.ndarray) -> dict:
    """RMS / clipping ratio / dynamic range / peak symmetry telemetry."""
    a = np.asarray(x, dtype=np.float32)
    if a.size == 0:
        return {"rms": 0.0, "clipping_ratio": 0.0, "dynamic_range_db": 0.0,
                "peak_pos": 0.0, "peak_neg": 0.0}
    clip = float(np.mean(np.abs(a) >= 0.999))
    peak_pos = float(a.max(initial=0.0))
    peak_neg = float(-a.min(initial=0.0))
    r = rms(a)
    dyn = 20.0 * np.log10(max(peak_pos, peak_neg, 1e-9) / max(r, 1e-9))
    return {
        "rms": r,
        "clipping_ratio": clip,
        "dynamic_range_db": float(dyn),
        "peak_pos": peak_pos,
        "peak_neg": peak_neg,
    }
