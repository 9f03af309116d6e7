"""The weight gradient of K1: dw of the FSMN memory block's taps.

    gm = g·m, xm = x·m,  dw[d, j] = Σ_{b,t} gm[b,t,d] · xm[b, t + j − pad_l, d]

(zero outside [0, T)), the gradient with respect to w of K1's
y = (xm + Σ_j w[d,j]·xm[t + j − pad_l])·m for an incoming gradient g of y.
The TPU kernel K1 replaces (`toolbox_for_asr_and_tts_tpu/ops/pallas/
fsmn_conv.py::fsmn_depthwise`) has no backward: off the TPU the reference
differentiates its XLA conv. The port's K1 sits where that differentiable
`fsmn_block` sits, so its backward (`fsmn_conv.FsmnDepthwiseFn`) needs this
kernel; dx is K1 itself. On the card it launches `csrc/fsmn_conv_dw.cu`; on a
CPU tensor it runs `fsmn_conv_dw_plain`, the same sum in PyTorch ops. A CUDA
tensor never takes the plain path.

Bound on an H100: bytes. At the encoder's shape (B 8, T 167, D 512, K 11,
f32) one call must read g and x once, 2 × 2.74 MB, about 1.6 µs at
3.35 TB/s. Pass 1 of the kernel sums each (block, tap, channel) over a
block's frames staged in shared memory; pass 2 adds the blocks' partials in a
fixed order (no atomics, so two runs give the same bits).
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

launches = 0   # +1 per kernel run; chip_smoke.py reads it
_launches_lock = threading.Lock()


def add_launches(n: int = 1) -> None:
    """Count n runs of the kernel."""
    global launches
    with _launches_lock:
        launches += n

_ENTRY = {torch.float32: "fsmn_conv_dw_f32", torch.bfloat16: "fsmn_conv_dw_bf16"}
MAX_TAPS = 128
FRAMES = 32            # frames per block of pass 1
_GRID_LIMIT = 65535    # grid.y (frame blocks) and grid.z (batch)


def _check(x: torch.Tensor, g: torch.Tensor, k: int, pad_l: int,
           mask: Optional[torch.Tensor]) -> None:
    if x.dim() != 3 or g.shape != x.shape:
        raise ValueError(f"x and g must be one [B, T, D] shape, got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if x.dtype not in _ENTRY or g.dtype != x.dtype:
        raise TypeError(f"x and g must be one of float32 / bfloat16, got "
                        f"{x.dtype} and {g.dtype}")
    if x.stride(2) != 1 or g.stride(2) != 1:
        raise ValueError(f"x and g must have unit channel stride, got "
                         f"{x.stride()} and {g.stride()}")
    if not 1 <= k <= MAX_TAPS or not 0 <= pad_l < k:
        raise ValueError(f"K {k} outside [1, {MAX_TAPS}] or pad_l {pad_l} "
                         "outside [0, K)")
    if g.device != x.device:
        raise ValueError(f"g on {g.device}, x on {x.device}")
    if mask is not None:
        b, t, _ = x.shape
        if mask.shape != (b, t) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be float32 [{b}, {t}], got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        if mask.device != x.device or not mask.is_contiguous():
            raise ValueError("mask must be contiguous on x's device")


def fsmn_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int, pad_l: int,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same sum in f32 PyTorch ops: dw [D, 1, K] float32."""
    t = x.shape[1]
    xm, gm = x.float(), g.float()
    if mask is not None:
        xm = xm * mask[..., None]
        gm = gm * mask[..., None]
    xp = F.pad(xm, (0, 0, pad_l, k - 1 - pad_l))
    dw = torch.stack([(gm * xp[:, j: j + t]).sum(dim=(0, 1))
                      for j in range(k)], dim=-1)
    return dw[:, None, :]


def fsmn_conv_dw(x: torch.Tensor, g: torch.Tensor, k: int, pad_l: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x, g [B, T, D] with unit channel stride (any batch and frame
    strides), K taps of which pad_l lie before the frame, optional mask
    [B, T] → dw [D, 1, K] float32, a new tensor."""
    _check(x, g, k, pad_l, mask)
    if x.device.type == "cpu":
        return fsmn_conv_dw_plain(x, g, k, pad_l, mask)
    if x.device.type != "cuda":
        raise ValueError(f"fsmn_conv_dw: unsupported device {x.device}")
    b, t, d = x.shape
    dw = torch.empty((d, 1, k), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    n_tb = -(-t // FRAMES)
    if b > _GRID_LIMIT or n_tb > _GRID_LIMIT:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
    partial = torch.empty((b * n_tb, k, d), dtype=torch.float32,
                          device=x.device)
    name = _ENTRY[x.dtype]
    fn = getattr(_build.load(), name)
    args = (x.data_ptr(), g.data_ptr(),
            None if mask is None else mask.data_ptr(), partial.data_ptr(),
            dw.data_ptr(), b, t, d, x.stride(0), x.stride(1), g.stride(0),
            g.stride(1), k, pad_l, FRAMES)
    index = x.device.index
    with torch.cuda.device(index):
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    _build.check(err, name)
    if not _build.count_launch("fsmn_conv_dw"):
        add_launches()
    return dw
