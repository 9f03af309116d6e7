"""Framework-free helpers copied from the reference: WAV encoding and
decoding, and resampling."""
from .audio import (
    base64_to_audio_np,
    decode_wav_bytes,
    encode_wav_bytes,
    ensure_mono_16k,
    read_wav,
    resample_poly,
    write_wav,
)

__all__ = [
    "base64_to_audio_np",
    "decode_wav_bytes",
    "encode_wav_bytes",
    "ensure_mono_16k",
    "read_wav",
    "resample_poly",
    "write_wav",
]
