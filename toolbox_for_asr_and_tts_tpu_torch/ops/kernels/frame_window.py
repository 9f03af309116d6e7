"""K2: fbank framing — overlapping frames, DC removal, pre-emphasis, window,
zero-pad to n_fft.

Replaces the TPU kernel
`toolbox_for_asr_and_tts_tpu/ops/pallas/frame_window.py::frame_window`
(dispatched from the reference's `ops/frontend.py::fbank`). On the card it
launches `csrc/frame_window.cu`; on a CPU tensor it runs
`frame_window_plain` (`unfold`, then the same three steps). A CUDA tensor
never takes the plain path.

Bound on an H100: bytes. For a batch of 8 x 10 s at 16 kHz it reads 5.1 MB
of audio and writes 16.4 MB of framed rows, about 6.4 us at 3.35 TB/s. The
kernel reads each frame's samples once into shared memory (the 2.5x overlap
between frames is served from L2), reduces the mean in the block, and writes
each output row once, coalesced.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

launches = 0   # +1 per kernel launch; chip_smoke.py reads it

_ENTRY = "frame_window_f32"


def _check(audio: torch.Tensor, window: torch.Tensor, t_frames: int,
           frame_len: int, frame_shift: int, n_fft: int) -> None:
    if audio.dim() != 2 or audio.dtype != torch.float32:
        raise ValueError(f"audio must be float32 [B, n], got {audio.dtype} "
                         f"{tuple(audio.shape)}")
    if not audio.is_contiguous():
        raise ValueError("audio must be contiguous")
    if (window.shape != (frame_len,) or window.dtype != torch.float32
            or not window.is_contiguous() or window.device != audio.device):
        raise ValueError(f"window must be contiguous float32 [{frame_len}] "
                         "on the audio's device")
    if t_frames < 0 or frame_shift < 1 or not 1 <= frame_len <= n_fft:
        raise ValueError(f"bad framing: t_frames={t_frames} "
                         f"frame_len={frame_len} shift={frame_shift} "
                         f"n_fft={n_fft}")


def frame_window_plain(audio: torch.Tensor, window: torch.Tensor,
                       t_frames: int, frame_len: int, frame_shift: int,
                       n_fft: int, preemphasis: float = 0.97,
                       remove_dc: bool = True) -> torch.Tensor:
    """Frames past the end of the audio read zeros (as the TPU kernel)."""
    need = max(t_frames - 1, 0) * frame_shift + frame_len
    if audio.shape[1] < need:
        audio = F.pad(audio, (0, need - audio.shape[1]))
    frames = audio.unfold(1, frame_len, frame_shift)[:, :t_frames]
    if remove_dc:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemphasis * prev
    frames = frames * window
    return F.pad(frames, (0, n_fft - frame_len))


def frame_window(audio: torch.Tensor, window: torch.Tensor, t_frames: int,
                 frame_len: int, frame_shift: int, n_fft: int,
                 preemphasis: float = 0.97, remove_dc: bool = True
                 ) -> torch.Tensor:
    """audio [B, n] f32 → framed + windowed [B, t_frames, n_fft] f32."""
    global launches
    _check(audio, window, t_frames, frame_len, frame_shift, n_fft)
    if audio.device.type == "cpu":
        return frame_window_plain(audio, window, t_frames, frame_len,
                                  frame_shift, n_fft, preemphasis, remove_dc)
    if audio.device.type != "cuda":
        raise ValueError(f"frame_window: unsupported device {audio.device}")
    b, n = audio.shape
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the launch grid")
    out = torch.empty((b, t_frames, n_fft), dtype=torch.float32,
                      device=audio.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(audio.device):
        stream = torch.cuda.current_stream(audio.device).cuda_stream
        err = lib.frame_window_f32(
            audio.data_ptr(), window.data_ptr(), out.data_ptr(), b, n,
            t_frames, frame_len, frame_shift, n_fft, float(preemphasis),
            int(bool(remove_dc)), stream)
    _build.check(err, _ENTRY)
    launches += 1
    return out
