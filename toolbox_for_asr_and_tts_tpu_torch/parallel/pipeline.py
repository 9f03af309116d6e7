"""Pipeline-parallel SAN-M encoding (a GPipe schedule over the model axis).

Port of `toolbox_for_asr_and_tts_tpu/parallel/pipeline.py`. Encoder layers
1..N−1 stack into S stages, one per position of the mesh's model axis, and
M microbatches stream through them: at tick τ stage s runs microbatch
τ − s, and a stage hop is `Tensor.to(next stage's device)`. The reference
writes the schedule as a `lax.scan` of `ppermute`s; here one process queues
each stage's work on its device tick by tick, so stages on different cards
overlap, and a bubble slot queues nothing. Autograd differentiates the hops
and the stage slices of the stacked parameters, so the same function
serves fine-tuning: its gradients follow the plain encoder's.

Layer 0 (input_dim ≠ d_model) runs once before the pipeline, on the input's
device, as does everything after the encoder. With a data axis beside the
model axis, each microbatch's rows split over it when they divide it (each
data row then runs its own pipeline over its model positions); otherwise
the rows are not split, and the pipeline runs on the first data row (the
reference replicates them, computing the same values on every data row).
The bubble fraction is (S−1)/(M+S−1); pick M ≥ 4·S in real use.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from ..models import paraformer
from ..models.convert import tree_map
from ..ops import nn
from ..runtime.mesh import Mesh


def _stack(trees: List[Any], fn) -> Any:
    """Combine same-shaped trees leaf by leaf with fn(list of leaves)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees], fn) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack([t[i] for t in trees], fn) for i in range(len(first))]
    return fn(trees)


def stack_stage_params(enc_layers: list, n_stages: int) -> Any:
    """Encoder layers 1..N−1 → one tree whose leaves are [S, L/S, ...].
    Layer 0 stays out; the N−1 other layers must divide into `n_stages`."""
    rest = enc_layers[1:]
    if len(rest) % n_stages:
        raise ValueError(f"{len(rest)} pipelined layers do not divide into "
                         f"{n_stages} stages")
    per = len(rest) // n_stages
    return _stack(rest, lambda xs: torch.stack(
        [torch.stack(xs[s * per:(s + 1) * per]) for s in range(n_stages)]))


def _layer(layer: Any, x: torch.Tensor, mask: torch.Tensor,
           cfg: paraformer.ParaformerConfig, first: bool) -> torch.Tensor:
    h = nn.layernorm(layer["norm1"], x)
    h = nn.sanm_attention(layer["attn"], h, cfg.n_heads, mask,
                          cfg.kernel_size, cfg.sanm_shift)
    x = h if first else x + h   # no residual across the width change
    return x + nn.ffn(layer["ffn"], nn.layernorm(layer["norm2"], x))


def _apply_stage(stage_params: Any, x: torch.Tensor, mask: torch.Tensor,
                 cfg: paraformer.ParaformerConfig) -> torch.Tensor:
    """Apply one stage's [L/S] stacked layers in order."""
    n = len(_leaves(stage_params)[0])
    for i in range(n):
        x = _layer(tree_map(lambda a: a[i], stage_params), x, mask, cfg,
                   first=False)
    return x


def _leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def encode_pipelined(params: nn.Params, stage_params: Any,
                     feats: torch.Tensor, mask: torch.Tensor,
                     cfg: paraformer.ParaformerConfig, mesh: Mesh,
                     n_micro: int, axis: str = "model") -> torch.Tensor:
    """The plain encoder's forward with layers 1..N−1 pipelined.

    feats [B, T, input_dim] (B divisible by n_micro), mask [B, T];
    `stage_params` from `stack_stage_params`, its leading axis one stage
    per position of `axis`. Returns [B, T, d_model] on feats' device.
    Differentiable in `stage_params` (and in `params`' layer 0 and final
    norm)."""
    names = mesh.axis_names
    s_stages = mesh.shape[axis]
    b, t, _ = feats.shape
    if b % n_micro:
        raise ValueError(f"batch {b} is not divisible by {n_micro} "
                         "microbatches")
    home = feats.device
    mask = mask.float()
    # layer 0, scaling and posenc, once on the input's device
    x = feats * (cfg.d_model ** 0.5)
    x = x + nn.sinusoidal_posenc(t, feats.shape[-1], device=home)[None]
    x = _layer(params["encoder"]["layers"][0], x, mask, cfg, first=True)

    # dp × pp: microbatch rows split over the data axis where they divide
    grid = np.moveaxis(mesh.devices, names.index(axis), -1)
    grid = grid.reshape(-1, s_stages)          # [data rows, stages]
    mb = b // n_micro
    n_rows = grid.shape[0] if mb % grid.shape[0] == 0 else 1
    rb = mb // n_rows
    stages = [[tree_map(lambda a: a[s].to(grid[r, s]), stage_params)
               for s in range(s_stages)] for r in range(n_rows)]

    def rows(m: int, r: int) -> slice:
        lo = m * mb + r * rb
        return slice(lo, lo + rb)

    act = {}
    for tick in range(n_micro + s_stages - 1):
        for s in range(s_stages):
            m = tick - s
            if not 0 <= m < n_micro:
                continue   # a bubble
            for r in range(n_rows):
                dev = grid[r, s]
                inp = x[rows(m, r)] if s == 0 else act[m, r]
                act[m, r] = _apply_stage(stages[r][s], inp.to(dev),
                                         mask[rows(m, r)].to(dev), cfg)
    y = torch.cat([act[m, r].to(home) for m in range(n_micro)
                   for r in range(n_rows)], dim=0)
    y = nn.layernorm(params["encoder"]["after_norm"], y)
    return y * mask[..., None]
