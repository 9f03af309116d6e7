"""Host-side audio I/O: WAV codec, base64 decode, channel/bit-depth/rate
normalization.

Copy of `toolbox_for_asr_and_tts_tpu/utils/audio.py` for the port, on its
pure-Python path: `decode_wav_bytes`, `encode_wav_bytes`, `read_wav`,
`write_wav`, `resample_poly`, `ensure_mono_16k` and `base64_to_audio_np`
(numpy WAV codec, then ffmpeg when installed). The native C++ ingest
(`native/audio_ingest.cpp`) is not ported yet.
"""
from __future__ import annotations

import base64
import shutil
import struct
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

TARGET_SR = 16000


# ---------------------------------------------------------------- WAV codec
def decode_wav_bytes(data: bytes) -> Tuple[np.ndarray, int]:
    """Parse a RIFF/WAVE byte string → (float32 array [T, C], sample_rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/64, any channel count.
    """
    if len(data) < 44 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    raw: Optional[bytes] = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4:pos + 8])
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError("truncated WAV fmt chunk")
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            raw = body  # may be shorter than declared (truncated upload)
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("WAV missing fmt/data chunk")
    audio_fmt, channels, sr, _brate, _align, bits = fmt
    if audio_fmt == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: real tag is in SubFormat
        # fmt ext: cbSize(2) validbits(2) chanmask(4) SubFormat GUID(16) at
        # body[24:40]; GUID = <u16 tag> 00 00 + fixed 12-byte suffix.
        if len(fmt_body) < 40:
            raise ValueError("truncated WAVE_FORMAT_EXTENSIBLE fmt chunk")
        guid = fmt_body[24:40]
        _KSDATA_SUFFIX = bytes.fromhex("000000001000800000aa00389b71")
        if guid[2:] != _KSDATA_SUFFIX:
            raise ValueError(f"unknown WAVE_FORMAT_EXTENSIBLE SubFormat {guid.hex()}")
        (audio_fmt,) = struct.unpack("<H", guid[:2])
        if audio_fmt not in (1, 3):
            raise ValueError(f"unsupported extensible WAV SubFormat tag {audio_fmt}")
    if audio_fmt == 1:  # integer PCM
        if bits == 8:
            x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
            x = (x - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8)
            n = len(b) // 3
            b = b[: n * 3].reshape(n, 3)
            vals = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(raw, dtype=dt).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format tag {audio_fmt}")
    if channels > 1:
        n = len(x) // channels
        x = x[: n * channels].reshape(n, channels)
    else:
        x = x.reshape(-1, 1)
    return x, sr


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
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sr, byte_rate, channels * 2, 16)
    hdr += b"data" + struct.pack("<I", len(raw))
    return hdr + raw


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        return decode_wav_bytes(f.read())


def write_wav(path: str, x: np.ndarray, sr: int) -> None:
    with open(path, "wb") as f:
        f.write(encode_wav_bytes(x, sr))


# ------------------------------------------------------------- resampling
def resample_poly(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample (scipy when available, else linear interpolation —
    same fallback ladder as the reference, voice_interface.py:1021-1090)."""
    if sr_in == sr_out:
        return x.astype(np.float32, copy=False)
    try:
        from scipy.signal import resample_poly as _rp
        from math import gcd
        g = gcd(sr_in, sr_out)
        return _rp(x, sr_out // g, sr_in // g, axis=0).astype(np.float32)
    except Exception:
        n_out = int(round(len(x) * sr_out / sr_in))
        t_in = np.linspace(0.0, 1.0, num=len(x), endpoint=False)
        t_out = np.linspace(0.0, 1.0, num=n_out, endpoint=False)
        return np.interp(t_out, t_in, x).astype(np.float32)


def ensure_mono_16k(x: np.ndarray, sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    """[T, C] any-rate → mono float32 @ target_sr (downmix then resample)."""
    if x.ndim == 2:
        x = x.mean(axis=1)
    x = x.astype(np.float32, copy=False)
    if sr != target_sr:
        x = resample_poly(x, sr, target_sr)
    return np.ascontiguousarray(x, dtype=np.float32)


def base64_to_audio_np(b64: str, target_sr: int = TARGET_SR) -> np.ndarray:
    """base64 WAV string → float32 mono numpy at target_sr.

    Decode ladder: numpy WAV codec → ffmpeg subprocess (the reference's
    native C++ ingest is not ported).
    """
    data = base64.b64decode(b64)
    try:
        x, sr = decode_wav_bytes(data)
    except ValueError:
        x, sr = _decode_with_ffmpeg(data)
    return ensure_mono_16k(x, sr, target_sr)


def _decode_with_ffmpeg(data: bytes) -> Tuple[np.ndarray, int]:
    """Fallback container decode via ffmpeg subprocess, if installed
    (reference keeps ffmpeg at the edge, voice_interface.py:87-181)."""
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise ValueError("unsupported audio container and no ffmpeg available")
    with tempfile.NamedTemporaryFile(suffix=".bin") as src:
        src.write(data)
        src.flush()
        out = subprocess.run(
            [ffmpeg, "-v", "error", "-i", src.name, "-f", "wav",
             "-acodec", "pcm_s16le", "-ar", str(TARGET_SR), "-ac", "1", "-"],
            capture_output=True, check=True,
        ).stdout
    return decode_wav_bytes(out)
