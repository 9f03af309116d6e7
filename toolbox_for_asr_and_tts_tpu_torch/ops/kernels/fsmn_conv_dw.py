"""K1's backward: dx and dw of the FSMN memory block in one launch.

    gm = g·m, xm = x·m
    dx[b,t,d] = m·(gm + Σ_j w[d, K−1−j] · gm[b, t + j − pad_r, d])
    dw[d, j]  = Σ_{b,t} gm[b,t,d] · xm[b, t + j − pad_l, d]

(zero outside [0, T)), the gradients with respect to x and to w of K1's
y = (xm + Σ_j w[d,j]·xm[t + j − pad_l])·m for an incoming gradient g of y;
dx is K1 with the taps reversed and the pads swapped. The TPU kernel K1
replaces (`toolbox_for_asr_and_tts_tpu/ops/pallas/fsmn_conv.py::
fsmn_depthwise`) has no backward: off the TPU the reference differentiates
its XLA conv. The port's K1 sits where that differentiable `fsmn_block`
sits, so its backward (`fsmn_conv.FsmnDepthwiseFn`) is this kernel.

`fsmn_conv_bwd` on the card launches `csrc/fsmn_conv_dw.cu` once for both
gradients, or for dw alone (`fsmn_conv_dw`, the dx store compiled out); dx
alone is K1 with the taps reversed. On CPU tensors it runs
`fsmn_conv_bwd_plain`, the same arithmetic in PyTorch ops. A CUDA tensor
never takes the plain path.

Bound on an H100: bytes. At the encoder's shape (B 8, T 167, D 512, K 11,
f32) one call must read x and g and write dx, 3 × 2.74 MB, about 2.45 µs at
3.35 TB/s (dw alone 1.64 µs). A block stages its frames of xm and gm (and
the halos) as 16-byte loads into shared f32 tiles in one round trip; then
one group of its threads sums dw from registers over a sliding window while
another sums dx from the gm tile in the plain version's order (f32
bit-equal to it); each block writes a [K, channels] dw partial, and the
block that draws its channel stripe's last integer ticket adds the stripe's
partials in block order (no float atomics: two runs, and a graph replay and
an eager call, give the same bits). The tickets lie in the call's scratch,
zeroed by a memset on the launch stream before the kernel (a memset node in
a captured graph), so no two calls or replays share one.
"""
from __future__ import annotations

import threading
from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from . import fsmn_conv as k1

launches = 0   # +1 per kernel run; chip_smoke.py reads it
_launches_lock = threading.Lock()


def add_launches(n: int = 1) -> None:
    """Count n runs of the kernel."""
    global launches
    with _launches_lock:
        launches += n

_ENTRY = {torch.float32: "fsmn_conv_bwd_f32",
          torch.bfloat16: "fsmn_conv_bwd_bf16"}
_VEC = {torch.float32: 4, torch.bfloat16: 8}   # channels in 16 bytes
MAX_TAPS = 128
THREADS = 96                # most threads per group (a block has a dw
                            # group and, with dx, a dx group of as many)
_GENERIC_KC = 8             # taps per dw pass of the any-K instantiation
_SMEM_LIMIT = 232448        # shared memory a Hopper block can opt in to
_GRID_LIMIT = 65535         # grid.y (frame blocks) and grid.z (batch)


class Tile(NamedTuple):
    """A launch configuration of csrc/fsmn_conv_dw.cu."""
    vec: int         # channels per 16-byte load (4 f32, 8 bf16), or 1: the
                     # scalar path
    per_thread: int  # frames per thread: 2, 4, 8 or 16 (4 when scalar)
    channels: int    # channels per block (a stripe), a multiple of 8
    threads_t: int   # thread rows along T of each group (whole warps):
                     # the block covers threads_t * per_thread frames
    k_const: int     # 11: the instantiation with K = 11 unrolled; 0: any K

    def threads_d(self) -> int:
        """Threads along D: 4 channels each in the sums (1 when scalar)."""
        return self.channels // (1 if self.vec == 1 else 4)

    def block_frames(self) -> int:
        return self.threads_t * self.per_thread

    def smem_bytes(self, k: int, dx: bool) -> int:
        """Shared memory, all f32, as the source lays it out: the xm tile
        (frames, the halo and the last pass's spare rows), the gm tile, the
        dw group's row sums; for dx the taps and the gm rows' masks."""
        kc = k if self.k_const else _GENERIC_KC
        rows = self.block_frames() + -(-k // kc) * kc - 1
        g_rows = self.block_frames() + (k - 1 if dx else 0)
        n = (rows + g_rows) * self.channels + self.threads_t * kc * self.channels
        if dx:
            n += self.channels * k + -(-g_rows // 4) * 4
        return 4 * n


BWD_CHANNELS = 32           # channels per block on the vector path
ROWS = THREADS // (BWD_CHANNELS // 4)   # thread rows per group, at most
PER_THREAD = (2, 4, 8, 16)  # the instantiations' frames per thread
_SCALAR_TILE = Tile(1, 4, 32, 4, 0)
_H100_SMS = 132             # the card the port targets, for CPU tensors


@lru_cache(maxsize=None)
def make_tile(t: int, k: int, vec: int, channels: int, n_tb: int,
              per_thread: int, k_const: int) -> Tile:
    """The tile that covers T frames in n_tb frame blocks (more where one
    block's rows cannot) with at least `per_thread` frames per thread,
    whole warps and at most THREADS threads per group; channels halved
    until the shared memory fits."""
    while True:
        n_x = channels // (1 if vec == 1 else 4)
        warp_rows = max(1, 32 // n_x)
        max_rows = THREADS // n_x // warp_rows * warp_rows
        frames = -(-t // max(1, min(n_tb, t),
                              -(-t // (PER_THREAD[-1] * max_rows))))
        per = next(p for p in PER_THREAD if p >= max(
            per_thread, -(-frames // max_rows)))
        rows = -(-frames // (per * warp_rows)) * warp_rows
        tile = Tile(vec, per, channels, rows, k_const)
        if tile.smem_bytes(k, True) <= _SMEM_LIMIT or channels <= 8:
            return tile
        channels //= 2


@lru_cache(maxsize=None)
def _vector_tile(b: int, t: int, d: int, k: int, vec: int, n_sm: int) -> Tile:
    """One frame block per ROWS * 16 frames, or two where one would leave
    SMs idle (T > 64); frames per thread the fewest that keep a group
    within ROWS rows of threads (whole blocks of 2 x 96 threads let two sit
    on an SM). The fastest of `chip_smoke.py --sweep` at B 8 and B 64 of
    the encoder's shape and at the decoder's (PERF.md): fewer frame blocks
    mean less halo and fewer partials for the last block of a stripe to
    add, until the card runs short of blocks."""
    n_tb = -(-t // (ROWS * PER_THREAD[-1]))
    if n_tb == 1 and t > 64 and b * -(-d // BWD_CHANNELS) < n_sm:
        n_tb = 2
    frames = -(-t // n_tb)
    per = next(p for p in PER_THREAD if p * ROWS >= frames)
    return make_tile(t, k, vec, BWD_CHANNELS, n_tb, per,
                     11 if k == 11 else 0)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_for(x: torch.Tensor, g: torch.Tensor, k: int) -> Tile:
    """The tile the wrapper launches for x and g [B, T, D] (unit channel
    stride) and K taps: 16-byte vectors where both bases, their strides and
    D allow them, else the scalar path."""
    b, t, d = x.shape
    vec = _VEC[x.dtype]
    if (x.data_ptr() % 16 or g.data_ptr() % 16 or d % vec
            or any(s % vec for s in (*x.stride()[:2], *g.stride()[:2]))):
        return _SCALAR_TILE
    n_sm = _sm_count(x.device.index) if x.is_cuda else _H100_SMS
    return _vector_tile(b, t, d, k, vec, n_sm)


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
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fsmn_conv_bwd: unsupported device {x.device}")


def _check_w(x: torch.Tensor, w: torch.Tensor, pad_l: int,
             pad_r: int) -> int:
    """Raise on taps the kernel does not take; return K."""
    if w.dim() != 3 or w.shape[0] != x.shape[-1] or w.shape[1] != 1:
        raise ValueError(f"w must be [D, 1, K] with D={x.shape[-1]}, got "
                         f"{tuple(w.shape)}")
    k = w.shape[2]
    if pad_l < 0 or pad_r < 0 or pad_l + pad_r != k - 1:
        raise ValueError("FSMN conv must be length-preserving: "
                         f"pad_l + pad_r == K - 1, got {pad_l}+{pad_r}, K={k}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    return k


def fsmn_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int, pad_l: int,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dw in f32 PyTorch ops: [D, 1, K] float32."""
    t = x.shape[1]
    xm, gm = x.float(), g.float()
    if mask is not None:
        xm = xm * mask[..., None]
        gm = gm * mask[..., None]
    xp = F.pad(xm, (0, 0, pad_l, k - 1 - pad_l))
    dw = torch.stack([(gm * xp[:, j: j + t]).sum(dim=(0, 1))
                      for j in range(k)], dim=-1)
    return dw[:, None, :]


def fsmn_conv_bwd_plain(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                        pad_l: int, pad_r: int,
                        mask: Optional[torch.Tensor] = None,
                        need_dx: bool = True, need_dw: bool = True
                        ) -> Tuple[Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
    """The same gradients in PyTorch ops: dx as K1's plain version with the
    taps reversed and the pads swapped (in x's dtype), dw [D, 1, K] f32."""
    dx = (k1.fsmn_depthwise_plain(g, w.flip(-1), pad_r, pad_l, mask)
          if need_dx else None)
    dw = (fsmn_conv_dw_plain(x, g, w.shape[-1], pad_l, mask)
          if need_dw else None)
    return dx, dw


def fsmn_conv_bwd(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                  pad_l: int, pad_r: int, mask: Optional[torch.Tensor] = None,
                  need_dx: bool = True, need_dw: bool = True
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """x (K1's input), g (the gradient of its output) [B, T, D] with unit
    channel stride (any batch and frame strides), w [D, 1, K], the pads,
    optional mask [B, T] → (dx, dw): dx a new contiguous [B, T, D] in x's
    dtype, dw a new [D, 1, K] float32, each None where not wanted. Both
    gradients, or dw alone, are one launch; dx alone is K1 with the taps
    reversed."""
    k = _check_w(x, w, pad_l, pad_r)
    _check(x, g, k, pad_l, mask)
    if x.device.type == "cpu":
        return fsmn_conv_bwd_plain(x, g, w, pad_l, pad_r, mask, need_dx,
                                   need_dw)
    if not need_dw:
        dx = (k1._forward(g, w.flip(-1), pad_r, pad_l, mask, k)
              if need_dx else None)
        return dx, None
    if need_dx and (w.dtype != torch.float32 or not w.is_contiguous()
                    or w.data_ptr() % 16):
        # a fresh allocation: the kernel copies the taps 16 bytes at a time
        w = w.float().clone(memory_format=torch.contiguous_format)
    return launch(x, g, w if need_dx else None, k, pad_l, mask,
                  tile_for(x, g, k))


def fsmn_conv_dw(x: torch.Tensor, g: torch.Tensor, k: int, pad_l: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dw alone: x, g [B, T, D] with unit channel stride (any batch and
    frame strides), K taps of which pad_l lie before the frame, optional
    mask [B, T] → dw [D, 1, K] float32, a new tensor. On the card one launch
    of the backward kernel with the dx store compiled out, as
    `fsmn_conv_bwd(..., need_dx=False)` makes it. dw does not depend on the
    taps, so this call takes K instead of w: the signature of the port's
    earlier dw kernel, which the card tests and `chip_smoke.py`'s dw-only
    timings keep using."""
    _check(x, g, k, pad_l, mask)
    if x.device.type == "cpu":
        return fsmn_conv_dw_plain(x, g, k, pad_l, mask)
    return launch(x, g, None, k, pad_l, mask, tile_for(x, g, k))[1]


PHASES = ("at the start", "after staging", "after the dw partials",
          "after dx and the ticket")   # the steps of `exit_after`, 1..4


def launch(x: torch.Tensor, g: torch.Tensor, w: Optional[torch.Tensor],
           k: int, pad_l: int, mask: Optional[torch.Tensor], tile: Tile,
           exit_after: int = 0) -> Tuple[Optional[torch.Tensor],
                                         torch.Tensor]:
    """One launch of the kernel with the given tile, on inputs that
    `fsmn_conv_bwd` has checked (w f32 contiguous and 16-byte aligned, or
    None for dw alone) → (dx or None, dw). The tile sweep of
    `chip_smoke.py` calls it directly; its step breakdown passes
    `exit_after` 1..4 (f32, dx and dw, K 11 on the vector path), which
    launches an instantiation whose blocks all leave at PHASES[exit_after
    - 1]: its results are incomplete, and it counts no launch."""
    b, t, d = x.shape
    dx = (None if w is None else
          torch.empty((b, t, d), dtype=x.dtype, device=x.device))
    dw = torch.empty((d, 1, k), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dx, dw.zero_()
    n_tb = -(-t // tile.block_frames())
    stripes = -(-d // tile.channels)
    if b > _GRID_LIMIT or n_tb > _GRID_LIMIT:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
    if tile.smem_bytes(k, w is not None) > _SMEM_LIMIT:
        raise ValueError(f"tile {tile} needs more shared memory than a "
                         "block has")
    # the blocks' partials [stripes, B * frame blocks, K, channels], then
    # the stripes' int32 tickets, which the launch zeroes on its stream
    n_partial = stripes * b * n_tb * k * tile.channels
    scratch = torch.empty(n_partial + stripes, dtype=torch.float32,
                          device=x.device)
    tickets = scratch.data_ptr() + 4 * n_partial
    name = "fsmn_conv_bwd_steps_f32" if exit_after else _ENTRY[x.dtype]
    fn = getattr(_build.load(), name)
    index = x.device.index
    with torch.cuda.device(index):
        stream = torch._C._cuda_getCurrentRawStream(index)
        args = (x.data_ptr(), g.data_ptr(),
                None if w is None else w.data_ptr(),
                None if mask is None else mask.data_ptr(),
                None if dx is None else dx.data_ptr(), scratch.data_ptr(),
                dw.data_ptr(), tickets, b, t, d, x.stride(0), x.stride(1),
                g.stride(0), g.stride(1), k, pad_l, *tile, stream)
        err = fn(*args, exit_after) if exit_after else fn(*args)
    _build.check(err, name)
    if not exit_after and not _build.count_launch("fsmn_conv_dw", stream):
        add_launches()
    return dx, dw
