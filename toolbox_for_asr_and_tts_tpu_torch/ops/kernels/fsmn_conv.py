"""K1: FSMN depthwise memory conv with residual (and fused mask).

Replaces the TPU kernel
`toolbox_for_asr_and_tts_tpu/ops/pallas/fsmn_conv.py::fsmn_depthwise`
(dispatched from the reference's `ops/nn.py::fsmn_block`). On the card it
launches `csrc/fsmn_conv.cu`; on a CPU tensor it runs `fsmn_depthwise_plain`,
the same arithmetic in PyTorch ops. A CUDA tensor never takes the plain path.

Bound on an H100: bytes, not flops. At the encoder's shape (B 8, T 167,
D 512, K 11, f32) one call must read x and write y, 2 x 2.74 MB, about
1.6 us at 3.35 TB/s, against 15 Mflop (0.2 us at the f32 rate). The kernel
reads each element once from device memory into a shared tile with its
K - 1 frame halo and fuses the two mask multiplies, so no masked copy of x
is written or read.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

launches = 0   # +1 per kernel launch; chip_smoke.py reads it

_ENTRY = {torch.float32: "fsmn_conv_f32", torch.bfloat16: "fsmn_conv_bf16"}
# csrc/fsmn_conv.cu stages (16 + 2K - 1) x 32 floats of shared memory per
# block; K <= 128 keeps that inside the 48 KB a launch gets without opt-in.
MAX_TAPS = 128
_T_BLOCK = 16   # csrc/fsmn_conv.cu: frames per block (grid.y limit)


def _check(x: torch.Tensor, w: torch.Tensor, pad_l: int, pad_r: int,
           mask: Optional[torch.Tensor]) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    b, t, d = x.shape
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if w.dim() != 3 or w.shape[0] != d or w.shape[1] != 1:
        raise ValueError(f"w must be [D, 1, K] with D={d}, got {tuple(w.shape)}")
    k = w.shape[2]
    if not 1 <= k <= MAX_TAPS:
        raise ValueError(f"kernel size {k} outside [1, {MAX_TAPS}]")
    if pad_l < 0 or pad_r < 0 or pad_l + pad_r != k - 1:
        raise ValueError("FSMN conv must be length-preserving: "
                         f"pad_l + pad_r == K - 1, got {pad_l}+{pad_r}, K={k}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if mask is not None:
        if mask.shape != (b, t) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be float32 [{b}, {t}], got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        if mask.device != x.device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous on x's device")


def fsmn_depthwise_plain(x: torch.Tensor, w: torch.Tensor, pad_l: int,
                         pad_r: int, mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Pad, then K shifted multiply-adds in f32; result in x's dtype."""
    t = x.shape[1]
    taps = w[:, 0, :].to(x.dtype).float()           # [D, K], rounded as x
    xm = x.float()
    if mask is not None:
        xm = xm * mask[..., None]
    xp = F.pad(xm, (0, 0, pad_l, pad_r))
    acc = xm
    for j in range(taps.shape[1]):
        acc = acc + xp[:, j: j + t, :] * taps[:, j]
    if mask is not None:
        acc = acc * mask[..., None]
    return acc.to(x.dtype)


def fsmn_depthwise(x: torch.Tensor, w: torch.Tensor, pad_l: int, pad_r: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, D], w [D, 1, K] (torch depthwise layout), optional mask
    [B, T] → (x·m + depthwise_conv(x·m)) · m, in x's dtype."""
    global launches
    _check(x, w, pad_l, pad_r, mask)
    if x.device.type == "cpu":
        return fsmn_depthwise_plain(x, w, pad_l, pad_r, mask)
    if x.device.type != "cuda":
        raise ValueError(f"fsmn_depthwise: unsupported device {x.device}")
    b, t, d = x.shape
    if b > 65535 or -(-t // _T_BLOCK) > 65535:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    taps = w.reshape(d, -1).to(x.dtype).contiguous()
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), taps.data_ptr(),
            None if mask is None else mask.data_ptr(), y.data_ptr(),
            b, t, d, taps.shape[1], pad_l, stream)
    _build.check(err, _ENTRY[x.dtype])
    launches += 1
    return y
