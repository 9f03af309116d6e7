"""Kaldi-compatible DSP frontend in PyTorch: framing, window, power
spectrum, log-mel filterbank, LFR stacking, CMVN.

Port of `toolbox_for_asr_and_tts_tpu/ops/frontend.py` (torchaudio kaldi
fbank with FunASR's settings: 16 kHz, 25 ms frames, 10 ms shift, hamming
window, 80 mel bins, snip_edges, DC removal, pre-emphasis 0.97, low_freq 20,
power spectrum, int16 input scaling, no dither). The framing stage runs
kernel K2 (`kernels/frame_window.py`); the real DFT is `torch.fft.rfft` and
the mel bank a float32 matmul. USE_PALLAS_FRAMING (the reference's
switch) is read as the reference reads it; on a CUDA tensor it must be on.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .kernels.frame_window import frame_window

# The fbank framing kernel K2 (the reference's Pallas-framing switch). None
# = decide from USE_PALLAS_FRAMING, else the dispatch profile, as the
# reference does. CPU tensors run K2's plain version whatever it says; a
# CUDA tensor always launches K2, and the switch off raises there.
USE_PALLAS_FRAMING: Optional[bool] = None


def _use_pallas_framing() -> bool:
    if USE_PALLAS_FRAMING is not None:
        return USE_PALLAS_FRAMING
    from ..runtime.autotune import env_or_profile
    return env_or_profile("USE_PALLAS_FRAMING", "pallas_framing")


EPSILON = 1.1920928955078125e-07  # torch.finfo(float32).eps — kaldi energy floor


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    n_mels: int = 80
    window: str = "hamming"          # FunASR WavFrontend default
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0           # <=0 → offset from nyquist
    snip_edges: bool = True
    use_power: bool = True
    int16_scale: bool = True         # FunASR multiplies waveform by 1<<15
    lfr_m: int = 7                   # paraformer: 7/6; fsmn-vad: 5/1
    lfr_n: int = 6

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000)

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000)

    @property
    def n_fft(self) -> int:
        return 1 << (self.frame_length - 1).bit_length()  # next pow2 (512)


def num_fbank_frames(n_samples: int, cfg: FrontendConfig) -> int:
    """snip_edges frame count (kaldi)."""
    if n_samples < cfg.frame_length:
        return 0
    return 1 + (n_samples - cfg.frame_length) // cfg.frame_shift


def num_lfr_frames(t: int, lfr_n: int) -> int:
    return int(math.ceil(t / lfr_n))


def _window_coeffs(cfg: FrontendConfig) -> np.ndarray:
    n = cfg.frame_length
    i = np.arange(n, dtype=np.float64)
    if cfg.window == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * i / (n - 1))
    elif cfg.window == "hanning":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))
    elif cfg.window == "povey":  # kaldi default window
        w = (0.5 - 0.5 * np.cos(2 * np.pi * i / (n - 1))) ** 0.85
    elif cfg.window == "rectangular":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window {cfg.window}")
    return w.astype(np.float32)


def _mel_scale(hz: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log(1.0 + hz / 700.0)


@functools.lru_cache(maxsize=8)
def _mel_banks_np(cfg: FrontendConfig) -> np.ndarray:
    """Kaldi mel filterbank matrix, shape (n_fft//2, n_mels).

    Matches kaldi/torchaudio `get_mel_banks`: triangular filters in mel space
    over the first n_fft//2 FFT bins (nyquist bin excluded).
    """
    n_bins = cfg.n_fft // 2
    nyquist = 0.5 * cfg.sample_rate
    high = cfg.high_freq if cfg.high_freq > 0 else nyquist + cfg.high_freq
    fft_bin_width = cfg.sample_rate / cfg.n_fft
    mel_low = _mel_scale(np.array(cfg.low_freq))
    mel_high = _mel_scale(np.array(high))
    mel_delta = (mel_high - mel_low) / (cfg.n_mels + 1)
    bin_mels = _mel_scale(fft_bin_width * np.arange(n_bins, dtype=np.float64))
    banks = np.zeros((n_bins, cfg.n_mels), dtype=np.float64)
    for m in range(cfg.n_mels):
        left = mel_low + m * mel_delta
        center = mel_low + (m + 1) * mel_delta
        right = mel_low + (m + 2) * mel_delta
        up = (bin_mels - left) / (center - left)
        down = (right - bin_mels) / (right - center)
        banks[:, m] = np.maximum(0.0, np.minimum(up, down))
    return banks.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _constants(cfg: FrontendConfig, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(window [frame_length], mel banks [n_fft//2, n_mels]) on `device`."""
    return (torch.from_numpy(_window_coeffs(cfg)).to(device),
            torch.from_numpy(_mel_banks_np(cfg)).to(device))


def fbank(x: torch.Tensor, cfg: FrontendConfig = FrontendConfig(),
          t_frames: Optional[int] = None) -> torch.Tensor:
    """Log-mel filterbank features.

    Args:
        x: waveform `[B, n_samples]` float32 in [-1, 1].
        t_frames: frame count (defaults to the max frames for n_samples).
            Frames past a stream's valid length are garbage and must be
            masked by the caller using `num_fbank_frames(valid_len)`.

    Returns:
        `[B, t_frames, n_mels]` float32.
    """
    if x.dim() != 2:
        raise ValueError("fbank expects [B, T] — batch-first everywhere")
    if x.is_cuda and not _use_pallas_framing():
        raise ValueError("USE_PALLAS_FRAMING is off, but on the card the "
                         "fbank framing always runs kernel K2: no plain "
                         "framing serves a CUDA tensor")
    x = x.float()
    if cfg.int16_scale:
        x = x * 32768.0
    t = t_frames if t_frames is not None else num_fbank_frames(x.shape[1], cfg)
    win, banks = _constants(cfg, x.device)
    frames = frame_window(x.contiguous(), win, t, cfg.frame_length,
                          cfg.frame_shift, cfg.n_fft, cfg.preemphasis,
                          cfg.remove_dc_offset)
    spec = torch.fft.rfft(frames, dim=-1)[..., : cfg.n_fft // 2]
    power = spec.real ** 2 + spec.imag ** 2
    if not cfg.use_power:
        power = torch.sqrt(power)
    mel = torch.matmul(power, banks)
    return torch.log(torch.clamp_min(mel, EPSILON))


def apply_lfr(feats: torch.Tensor, lfr_m: int, lfr_n: int,
              t_out: Optional[int] = None,
              valid_frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Low frame rate stacking (FunASR `apply_lfr` semantics).

    Left-pads (m-1)//2 copies of the first frame, stacks m consecutive frames
    every n frames, repeating the last frame past the end.

    feats: [B, T, D] → [B, ceil(T/n), m*D]

    valid_frames: optional [B] per-row valid fbank frame counts. In the
    bucketed path the padded audio produces extra fbank frames past the real
    signal; FunASR's replicate-last semantics repeat the last VALID frame
    instead, so each row matches its exact-length computation.
    """
    b, t, d = feats.shape
    t_lfr = t_out if t_out is not None else num_lfr_frames(t, lfr_n)
    left = (lfr_m - 1) // 2
    # index i of output, j of stack → input index i*n + j - left, clamped
    i = torch.arange(t_lfr, device=feats.device)[:, None] * lfr_n
    j = torch.arange(lfr_m, device=feats.device)[None, :]
    src = torch.clamp(i + j - left, 0, t - 1)              # (T_lfr, m)
    if valid_frames is not None:
        hi = torch.clamp_min(valid_frames, 1) - 1          # [B]
        src = torch.minimum(src[None], hi[:, None, None])  # (B, T_lfr, m)
        idx = src.reshape(b, -1, 1).expand(-1, -1, d)
        return torch.gather(feats, 1, idx).reshape(b, t_lfr, lfr_m * d)
    return feats[:, src].reshape(b, t_lfr, lfr_m * d)


def apply_cmvn(feats: torch.Tensor, means: torch.Tensor,
               istd: torch.Tensor) -> torch.Tensor:
    """Kaldi-style global CMVN: (x + means) * istd.

    `means` is the negative mean (kaldi AddShift) and `istd` the inverse
    stddev (kaldi Rescale), as stored in FunASR `am.mvn` files.
    """
    return (feats + means) * istd


def compute_frontend(x: torch.Tensor, cfg: FrontendConfig,
                     cmvn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     ) -> torch.Tensor:
    """wav [B, T] → LFR+CMVN features [B, T_lfr, lfr_m*n_mels]."""
    f = fbank(x, cfg)
    f = apply_lfr(f, cfg.lfr_m, cfg.lfr_n)
    if cmvn is not None:
        f = apply_cmvn(f, cmvn[0], cmvn[1])
    return f


def num_valid_fbank_frames(n_samples: torch.Tensor,
                           cfg: FrontendConfig) -> torch.Tensor:
    """[B] valid sample lengths → valid fbank frame counts (floor division,
    so lengths shorter than one frame give 0)."""
    q = torch.div(n_samples - cfg.frame_length, cfg.frame_shift,
                  rounding_mode="floor")
    return torch.clamp_min(1 + q, 0)


def frontend_valid_frames(n_samples: torch.Tensor,
                          cfg: FrontendConfig) -> torch.Tensor:
    """Valid LFR frame count for a [B] tensor of valid sample lengths."""
    t = num_valid_fbank_frames(n_samples, cfg)
    return torch.div(t + cfg.lfr_n - 1, cfg.lfr_n, rounding_mode="floor")
