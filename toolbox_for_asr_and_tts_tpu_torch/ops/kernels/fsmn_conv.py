"""K1: FSMN depthwise memory conv with residual (and fused mask).

Replaces the TPU kernel
`toolbox_for_asr_and_tts_tpu/ops/pallas/fsmn_conv.py::fsmn_depthwise`
(dispatched from the reference's `ops/nn.py::fsmn_block`). On the card it
launches `csrc/fsmn_conv.cu`; on a CPU tensor it runs `fsmn_depthwise_plain`,
the same arithmetic in PyTorch ops. A CUDA tensor never takes the plain path.

Bound on an H100: bytes, not flops. At the encoder's shape (B 8, T 167,
D 512, K 11, f32) one call must read x and write y, 2 x 2.74 MB, about
1.6 us at 3.35 TB/s, against 15 Mflop. A block of the kernel loads its
frames and their K - 1 frame halo as 16-byte vectors (4 f32 or 8 bf16
channels) into a shared f32 tile in one round trip; each thread then sums
4 channels over `Tile.frames` frames, one frame at a time, and stores each
frame as soon as it is summed. x may be any view with unit channel stride,
such as the V third of SAN-M's qkv product, so no copy precedes the call;
where x's base, strides or D are not multiples of 16 bytes the wrapper
launches the kernel's scalar path (1 channel per thread) instead.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build

launches = 0   # +1 per kernel launch; chip_smoke.py reads it

_ENTRY = {torch.float32: "fsmn_conv_f32", torch.bfloat16: "fsmn_conv_bf16"}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # channels in 16 bytes
MAX_TAPS = 128
THREADS = 128               # threads per block the wrapper gives a tile
_SMEM_LIMIT = 232448        # shared memory a Hopper block can opt in to
_GRID_LIMIT = 65535         # grid.y (frame blocks) and grid.z (batch)


class Tile(NamedTuple):
    """A launch configuration of csrc/fsmn_conv.cu."""
    vec: int        # channels per 16-byte load (4 f32, 8 bf16), or 1: the
                    # scalar path
    frames: int     # output frames per thread: 2, 4 or 8
    channels: int   # channels per block, a multiple of 8
    threads_t: int  # threads along T: the block covers threads_t * frames
    k_const: int    # 11: the instantiation with K = 11 unrolled; 0: any K

    def threads_d(self) -> int:
        """Threads along D: 4 channels each in the sums (1 when scalar)."""
        return self.channels // (1 if self.vec == 1 else 4)

    def block_frames(self) -> int:
        return self.threads_t * self.frames

    def smem_bytes(self, k: int) -> int:
        """Shared memory, all f32: the tile (the block's frames and their
        K - 1 halo rows), the row masks, the block's taps."""
        rows = self.block_frames() + k - 1
        return (rows * self.channels + -(-rows // 4) * 4
                + self.channels * k) * 4


TILE_CHANNELS = 32          # channels per block on the vector path
_SCALAR_TILE = (4, 32)      # (frames, channels) on the scalar path
_FILL_BLOCKS_PER_SM = 2.5   # 4 frames per thread only if the grid fills this
_H100_SMS = 132             # the card the port targets, for CPU tensors


@lru_cache(maxsize=None)
def make_tile(t: int, k: int, vec: int, frames: int, channels: int,
              k_const: int) -> Tile:
    """The tile for T frames: up to THREADS threads per block, and no more
    threads along T than T needs, in whole warps; channels halved until the
    shared memory fits."""
    while True:
        tile = Tile(vec, frames, channels, 1, k_const)
        n_x = tile.threads_d()
        warp_rows = max(1, 32 // n_x)
        need = -(-t // frames)
        threads_t = max(1, min(THREADS // n_x,
                               -(-need // warp_rows) * warp_rows))
        tile = tile._replace(threads_t=threads_t)
        if tile.smem_bytes(k) <= _SMEM_LIMIT or channels <= 8:
            return tile
        channels //= 2


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@lru_cache(maxsize=None)
def _vector_tile(b: int, t: int, d: int, k: int, vec: int, n_sm: int) -> Tile:
    """4 frames per thread where the grid still gives every SM 2.5 blocks,
    else 2: the fastest of `chip_smoke.py --sweep` at both Paraformer
    shapes (PERF.md)."""
    for frames in (4, 2):
        tile = make_tile(t, k, vec, frames, TILE_CHANNELS, 11 if k == 11 else 0)
        blocks = b * -(-d // tile.channels) * -(-t // tile.block_frames())
        if blocks >= _FILL_BLOCKS_PER_SM * n_sm:
            break
    return tile


def tile_for(x: torch.Tensor, k: int) -> Tile:
    """The tile the wrapper launches for x [B, T, D] (unit channel stride)
    and K taps: 16-byte vectors where x's base, strides and D allow them,
    else the scalar path."""
    b, t, d = x.shape
    vec = _VEC[x.dtype]
    stride_b, stride_t, _ = x.stride()
    if x.data_ptr() % 16 or stride_b % vec or stride_t % vec or d % vec:
        return make_tile(t, k, 1, *_SCALAR_TILE, 0)
    n_sm = _sm_count(x.device.index) if x.is_cuda else _H100_SMS
    return _vector_tile(b, t, d, k, vec, n_sm)


def _check(x: torch.Tensor, w: torch.Tensor, pad_l: int, pad_r: int,
           mask: Optional[torch.Tensor]) -> int:
    """Raise on what the kernel does not take; return K."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    b, t, d = x.shape
    if x.dtype not in _ENTRY:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.stride(2) != 1:
        raise ValueError(f"x must have unit channel stride, got {x.stride()}")
    w_shape = w.shape
    if len(w_shape) != 3 or w_shape[0] != d or w_shape[1] != 1:
        raise ValueError(f"w must be [D, 1, K] with D={d}, got {tuple(w_shape)}")
    k = w_shape[2]
    if not 1 <= k <= MAX_TAPS:
        raise ValueError(f"kernel size {k} outside [1, {MAX_TAPS}]")
    if pad_l < 0 or pad_r < 0 or pad_l + pad_r != k - 1:
        raise ValueError("FSMN conv must be length-preserving: "
                         f"pad_l + pad_r == K - 1, got {pad_l}+{pad_r}, K={k}")
    dev = x.device
    if w.device != dev:
        raise ValueError(f"w on {w.device}, x on {dev}")
    if mask is not None:
        if mask.shape != (b, t) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be float32 [{b}, {t}], got "
                             f"{mask.dtype} {tuple(mask.shape)}")
        if mask.device != dev or not mask.is_contiguous():
            raise ValueError("mask must be contiguous on x's device")
    return k


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
    """x [B, T, D] with unit channel stride (any batch and frame stride),
    w [D, 1, K] (torch depthwise layout), optional mask [B, T] →
    (x·m + depthwise_conv(x·m)) · m, a new contiguous tensor in x's dtype."""
    k = _check(x, w, pad_l, pad_r, mask)
    dev_type = x.device.type
    if dev_type == "cpu":
        return fsmn_depthwise_plain(x, w, pad_l, pad_r, mask)
    if dev_type != "cuda":
        raise ValueError(f"fsmn_depthwise: unsupported device {x.device}")
    if w.dtype != x.dtype or not w.is_contiguous() or w.data_ptr() % 16:
        # a fresh allocation: the kernel reads the taps as 16-byte vectors
        w = w.to(x.dtype).clone(memory_format=torch.contiguous_format)
    return launch(x, w, pad_l, mask, tile_for(x, k))


def launch(x: torch.Tensor, w: torch.Tensor, pad_l: int,
           mask: Optional[torch.Tensor], tile: Tile) -> torch.Tensor:
    """One launch of the kernel with the given tile, on inputs that
    `fsmn_depthwise` has checked (w contiguous, 16-byte aligned, in x's
    dtype). The tile sweep of `chip_smoke.py` calls it directly."""
    global launches
    b, t, d = x.shape
    y = torch.empty((b, t, d), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if b > _GRID_LIMIT or -(-t // tile.block_frames()) > _GRID_LIMIT:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
    k = w.shape[-1]
    stride_b, stride_t, _ = x.stride()
    name = _ENTRY[x.dtype]
    fn = getattr(_build.load(), name)
    args = (x.data_ptr(), w.data_ptr(),
            None if mask is None else mask.data_ptr(), y.data_ptr(),
            b, t, d, stride_b, stride_t, k, pad_l, *tile)
    index = x.device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    _build.check(err, name)
    launches += 1
    return y
