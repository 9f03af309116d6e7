"""Tensor ops of the port: functional layers, the fbank frontend, and the
hand-written CUDA kernels under `kernels/`."""
from .frontend import (
    FrontendConfig,
    fbank,
    apply_lfr,
    apply_cmvn,
    compute_frontend,
    num_fbank_frames,
    num_lfr_frames,
)
from .vad_energy import energy_stats, is_speech_energy

__all__ = [
    "FrontendConfig",
    "fbank",
    "apply_lfr",
    "apply_cmvn",
    "compute_frontend",
    "num_fbank_frames",
    "num_lfr_frames",
    "energy_stats",
    "is_speech_energy",
]
