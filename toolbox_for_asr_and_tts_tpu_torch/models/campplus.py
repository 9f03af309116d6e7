"""CAM++ speaker embeddings in PyTorch.

Port of `toolbox_for_asr_and_tts_tpu/models/campplus.py` (the model behind
ModelScope `speech_campplus_sv_zh-cn_16k-common`):

    fbank80 → FCM 2-D conv front-end (freq ↓8, 32 ch → 320 per frame)
    → TDNN (k 5, stride 2) → 3 CAM-DenseTDNN blocks (growth 32, dilations
    1/2/2, context-aware gates from the masked global mean + 100-frame
    segment pooling) with transit layers → masked stats pooling
    (mean ‖ std) → linear → non-affine BN → embedding.

The reference convolves an NHWC [B, F, T, C] image with torch-layout
(O, I, kF, kT) weights; the port convolves NCHW [B, C, F, T] with the same
weights through cuDNN (no hand kernel: the reference computes these convs
outside any Pallas kernel). BatchNorm is in eval mode (eps 1e-5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.convert import tree_to
from ..ops import nn
from ..ops.frontend import FrontendConfig


@dataclasses.dataclass(frozen=True)
class CampPlusConfig:
    feat_dim: int = 80
    fcm_channels: int = 32
    init_channels: int = 128
    growth_rate: int = 32
    bn_size: int = 4
    block_layers: Tuple[int, ...] = (12, 24, 16)
    block_dilations: Tuple[int, ...] = (1, 2, 2)
    kernel_size: int = 3
    embedding_size: int = 192
    cam_seg_len: int = 100         # CAM segment-pooling window (frames)
    cam_reduction: int = 2         # bottleneck reduction in the gate MLP

    @property
    def frontend(self) -> FrontendConfig:
        # SV fbank: 80 mel, no LFR, CMN only (mean subtraction)
        return FrontendConfig(lfr_m=1, lfr_n=1)

    @property
    def fcm_out_dim(self) -> int:
        return self.fcm_channels * (self.feat_dim // 8)


def _bn_init(d: int) -> nn.Params:
    return {"g": torch.ones(d), "b": torch.zeros(d),
            "mean": torch.zeros(d), "var": torch.ones(d)}


def _bn(p: nn.Params, x: torch.Tensor, dim: int = -1,
        eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm over channel axis `dim`, in the reference's
    order of operations."""
    shape = [1] * x.dim()
    shape[dim] = -1

    def c(a):
        return a.reshape(shape)
    return (x - c(p["mean"])) * torch.rsqrt(c(p["var"]) + eps) * c(p["g"]) \
        + c(p["b"])


def _conv2d_init(g: torch.Generator, c_in: int, c_out: int, k: int
                 ) -> nn.Params:
    return {"w": nn._uniform(g, (c_out, c_in, k, k),
                             1.0 / math.sqrt(c_in * k * k))}


def _conv2d(p: nn.Params, x: torch.Tensor, stride: Tuple[int, int],
            padding: int = 1) -> torch.Tensor:
    """x [B, C, F, T], torch weight (O, I, kF, kT), stride (freq, time)."""
    return F.conv2d(x.float(), p["w"].float(), stride=stride,
                    padding=padding)


def init_params(cfg: CampPlusConfig, g: torch.Generator) -> nn.Params:
    """Random weights from `g`, drawn on its device; BatchNorm statistics
    start at mean 0, var 1 (set them to test a layout)."""
    def resblock(stride: int):
        blk = {
            "c1": _conv2d_init(g, cfg.fcm_channels, cfg.fcm_channels, 3),
            "b1": _bn_init(cfg.fcm_channels),
            "c2": _conv2d_init(g, cfg.fcm_channels, cfg.fcm_channels, 3),
            "b2": _bn_init(cfg.fcm_channels),
            "sc": None, "sbn": None,
        }
        if stride != 1:   # speakerlab BasicResBlock: 1×1 conv + BN shortcut
            blk["sc"] = _conv2d_init(g, cfg.fcm_channels, cfg.fcm_channels, 1)
            blk["sbn"] = _bn_init(cfg.fcm_channels)
        return blk

    fcm = {
        "conv1": _conv2d_init(g, 1, cfg.fcm_channels, 3),
        "bn1": _bn_init(cfg.fcm_channels),
        "layer1": [resblock(2), resblock(1)],
        "layer2": [resblock(2), resblock(1)],
        "conv2": _conv2d_init(g, cfg.fcm_channels, cfg.fcm_channels, 3),
        "bn2": _bn_init(cfg.fcm_channels),
    }
    channels = cfg.init_channels
    tdnn = {"w": nn.conv1d_init(g, cfg.fcm_out_dim, channels, 5),
            "bn": _bn_init(channels)}
    blocks = []
    for bl, n_layers in enumerate(cfg.block_layers):
        layers = []
        for _ in range(n_layers):
            inner = cfg.bn_size * cfg.growth_rate
            red = inner // cfg.cam_reduction
            layers.append({
                "bn1": _bn_init(channels),
                "lin": nn.linear_init(g, channels, inner, bias=False),
                "bn2": _bn_init(inner),
                "conv": nn.conv1d_init(g, inner, cfg.growth_rate,
                                       cfg.kernel_size, bias=False),
                "cam1": nn.linear_init(g, inner, red),
                "cam2": nn.linear_init(g, red, cfg.growth_rate),
            })
            channels += cfg.growth_rate
        transit = None
        if bl < len(cfg.block_layers) - 1:
            transit = {"bn": _bn_init(channels),
                       "lin": nn.linear_init(g, channels, channels // 2,
                                             bias=False)}
            channels //= 2
        blocks.append({"layers": layers, "transit": transit})
    params = {
        "fcm": fcm,
        "tdnn": tdnn,
        "blocks": blocks,
        "out_bn": _bn_init(channels),
        "embed": nn.linear_init(g, 2 * channels, cfg.embedding_size,
                                bias=False),
        "embed_bn": {"mean": torch.zeros(cfg.embedding_size),
                     "var": torch.ones(cfg.embedding_size)},
    }
    return tree_to(params, g.device)


def _fcm(p: nn.Params, feats: torch.Tensor) -> torch.Tensor:
    """feats [B, T, 80] → [B, T, 320] through the 2-D conv front-end."""
    relu = nn.relu
    x = feats.transpose(1, 2)[:, None]                     # [B, 1, F, T]
    x = relu(_bn(p["bn1"], _conv2d(p["conv1"], x, (1, 1)), dim=1))
    for layer in ("layer1", "layer2"):
        for i, r in enumerate(p[layer]):
            stride = (2, 1) if i == 0 else (1, 1)
            h = relu(_bn(r["b1"], _conv2d(r["c1"], x, stride), dim=1))
            h = _bn(r["b2"], _conv2d(r["c2"], h, (1, 1)), dim=1)
            if r["sc"] is not None:
                sc = _bn(r["sbn"], _conv2d(r["sc"], x, stride, padding=0),
                         dim=1)
            else:
                sc = x
            x = relu(h + sc)
    x = relu(_bn(p["bn2"], _conv2d(p["conv2"], x, (2, 1)), dim=1))  # ↓8
    b, c, f, t = x.shape
    # channel-major flatten: [B, C, F, T] → [B, T, C·F]
    return x.permute(0, 3, 1, 2).reshape(b, t, c * f)


def _seg_pool(h: torch.Tensor, mask: Optional[torch.Tensor],
              seg_len: int) -> torch.Tensor:
    """Segment average pooling broadcast back to frames: [B, T, C] →
    per-seg_len-window means repeated over T. Unmasked, the last segment
    counts its real frames; masked, each segment counts its valid ones."""
    b, t, c = h.shape
    n_seg = -(-t // seg_len)
    pad = n_seg * seg_len - t
    hp = F.pad(h, (0, 0, 0, pad))
    if mask is not None:
        mp = F.pad(mask, (0, pad))[..., None]
        hp = hp * mp
        cnt = torch.clamp_min(mp.reshape(b, n_seg, seg_len, 1).sum(dim=2),
                              1.0)
    else:
        cnt = torch.full((b, n_seg, 1), float(seg_len), device=h.device)
        cnt[:, -1] = float(seg_len - pad)
    seg = hp.reshape(b, n_seg, seg_len, c).sum(dim=2) / cnt
    return torch.repeat_interleave(seg, seg_len, dim=1)[:, :t]


def _cam_dense_layer(p: nn.Params, x: torch.Tensor, dilation: int,
                     kernel: int, mask: Optional[torch.Tensor],
                     seg_len: int = 100) -> torch.Tensor:
    """One CAM-DenseTDNN layer: bn-relu → 1×1 bottleneck → bn-relu →
    dilated local conv, gated by sigmoid(W2 relu(W1 (global mean +
    segment-pooled context)))."""
    h = nn.linear(p["lin"], nn.relu(_bn(p["bn1"], x)))
    h = nn.relu(_bn(p["bn2"], h))
    pad = dilation * (kernel - 1) // 2
    y = nn.conv1d(p["conv"], h, padding=(pad, pad), dilation=dilation)
    if mask is not None:
        m = mask[..., None]
        gmean = (h * m).sum(dim=1, keepdim=True) / \
            torch.clamp_min(m.sum(dim=1, keepdim=True), 1.0)
    else:
        gmean = h.mean(dim=1, keepdim=True)
    ctx = gmean + _seg_pool(h, mask, seg_len)
    gate = nn.sigmoid(nn.linear(p["cam2"],
                                nn.relu(nn.linear(p["cam1"], ctx))))
    return y * gate


def forward(params: nn.Params, feats: torch.Tensor,
            lengths: Optional[torch.Tensor] = None,
            cfg: CampPlusConfig = CampPlusConfig()) -> torch.Tensor:
    """fbank feats [B, T, 80] (mean-normalized) → embeddings [B, E]."""
    x = _fcm(params["fcm"], feats)
    # TDNN: k 5, stride 2, pad 2 — halves the frame rate
    x = nn.relu(_bn(params["tdnn"]["bn"],
                    nn.conv1d(params["tdnn"]["w"], x, stride=2,
                              padding=(2, 2))))
    mask = None
    if lengths is not None:
        # valid frames after the stride-2 conv: (L + 2·2 − 5)//2 + 1
        out_lens = torch.clamp_min(
            torch.div(lengths - 1, 2, rounding_mode="floor") + 1, 1)
        mask = nn.length_mask(out_lens, x.shape[1])
    for blk, dil in zip(params["blocks"], cfg.block_dilations):
        for layer in blk["layers"]:
            new = _cam_dense_layer(layer, x, dil, cfg.kernel_size, mask,
                                   cfg.cam_seg_len)
            x = torch.cat([x, new], dim=-1)    # dense connectivity
        if blk["transit"] is not None:
            x = nn.linear(blk["transit"]["lin"],
                          nn.relu(_bn(blk["transit"]["bn"], x)))
    x = nn.relu(_bn(params["out_bn"], x))
    if mask is not None:
        m = mask[..., None]
        denom = torch.clamp_min(m.sum(dim=1), 2.0)
        mean = (x * m).sum(dim=1) / denom
        var = ((x - mean[:, None]) ** 2 * m).sum(dim=1) / (denom - 1.0)
    else:
        n = x.shape[1]
        mean = x.mean(dim=1)
        var = x.var(dim=1, unbiased=False) * (n / max(n - 1, 1))
    stats = torch.cat([mean, torch.sqrt(var + 1e-7)], dim=-1)
    emb = nn.linear(params["embed"], stats)
    bn = params["embed_bn"]   # non-affine BN (speakerlab DenseLayer tail)
    return (emb - bn["mean"]) * torch.rsqrt(bn["var"] + 1e-5)


def cosine_score(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
