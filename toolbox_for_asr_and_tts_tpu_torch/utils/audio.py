"""WAV writing: the part of `toolbox_for_asr_and_tts_tpu/utils/audio.py`
that the port needs so far (16-bit PCM RIFF/WAVE, as the reference)."""
from __future__ import annotations

import struct

import numpy as np


def encode_wav_bytes(x: np.ndarray, sr: int, bits: int = 16) -> bytes:
    """float32 [-1,1] mono/`[T,C]` → 16-bit PCM RIFF/WAVE bytes."""
    if x.ndim == 1:
        x = x[:, None]
    if bits != 16:
        raise ValueError("only 16-bit PCM encoding supported")
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    raw = pcm.tobytes()
    channels = x.shape[1]
    byte_rate = sr * channels * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sr, byte_rate,
                                 channels * 2, 16)
    hdr += b"data" + struct.pack("<I", len(raw))
    return hdr + raw


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    with open(path, "wb") as f:
        f.write(encode_wav_bytes(x, sr))
