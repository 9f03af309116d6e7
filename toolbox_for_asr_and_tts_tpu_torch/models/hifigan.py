"""HiFi-GAN vocoder: mel-spectrogram → waveform.

Port of `toolbox_for_asr_and_tts_tpu/models/hifigan.py` over the same
parameter tree (HiFi-GAN V1 generator):

    conv_pre(k=7) → N × [leaky_relu → ConvTranspose1d upsample →
    multi-receptive-field fusion (mean of resblocks, kernels 3/7/11,
    dilations 1/3/5)] → leaky_relu → conv_post(k=7) → tanh

The default upsample rates (5, 5, 4, 2) give hop 200 samples (12.5 ms at
16 kHz), the Sambert mel frame rate; the wav length is T_mel × hop exactly.
Every convolution is cuDNN's (`ops/nn.py::conv1d`, `conv_transpose1d`).

`HifiGanConfig.from_config` reads a mounted package's config through
`runtime/checkpoints.py::search_config`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops import nn

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HifiGanConfig:
    n_mels: int = 80
    upsample_initial_channel: int = 512
    # kernels chosen so (k−r) is even → output length is exactly T·hop
    upsample_rates: Tuple[int, ...] = (5, 5, 4, 2)
    upsample_kernels: Tuple[int, ...] = (11, 11, 8, 4)
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h

    @classmethod
    def from_config(cls, conf: dict, **overrides) -> "HifiGanConfig":
        """Config from a mounted package's own config.yaml/json. Key names
        follow the public HiFi-GAN/KAN-TTS generator config (upsample_rates,
        upsample_kernel_sizes, resblock_kernel_sizes, …); shape-derivable
        fields are later re-pinned from the state dict by
        `config_from_state_dict` — only the upsample STRIDES truly need the
        config (strides don't appear in weight shapes)."""
        from ..runtime.checkpoints import search_config
        alias = {
            "n_mels": ("num_mels", "n_mels", "in_channels"),
            "upsample_initial_channel": ("upsample_initial_channel",),
            "upsample_rates": ("upsample_rates",),
            "upsample_kernels": ("upsample_kernel_sizes", "upsample_kernels"),
            "resblock_kernels": ("resblock_kernel_sizes", "resblock_kernels"),
            "resblock_dilations": ("resblock_dilation_sizes",
                                   "resblock_dilations"),
        }
        kw = {}
        for field, names in alias.items():
            v = search_config(conf or {}, names)
            if v is None:
                continue
            if isinstance(v, (list, tuple)):
                v = tuple(tuple(x) if isinstance(x, (list, tuple)) else int(x)
                          for x in v)
            else:
                v = int(v)
            kw[field] = v
        kw.update(overrides)
        return cls(**kw)


def config_from_state_dict(sd, base: HifiGanConfig) -> HifiGanConfig:
    """Pin shape-derivable generator hyperparameters from a (weight-norm
    folded) state dict. Upsample strides are not in the shapes: they come
    from `base`, else from the kernel // 2 relation of the public configs."""
    def count(pat_s: str):
        pat = re.compile(pat_s)
        idx = {int(m.group(1)) for k in sd for m in [pat.match(k)] if m}
        return (max(idx) + 1) if idx else None

    kw = {}
    if "conv_pre.weight" in sd:
        w = sd["conv_pre.weight"]                       # [C, n_mels, 7]
        kw["upsample_initial_channel"], kw["n_mels"] = w.shape[0], w.shape[1]
    n_ups = count(r"ups\.(\d+)\.weight$")
    if n_ups:
        kernels = tuple(int(sd[f"ups.{i}.weight"].shape[-1])
                        for i in range(n_ups))
        kw["upsample_kernels"] = kernels
        rates = base.upsample_rates
        if len(rates) != n_ups:
            rates = tuple(k // 2 for k in kernels)
        kw["upsample_rates"] = rates
        n_res_total = count(r"resblocks\.(\d+)\.")
        if n_res_total and n_res_total % n_ups == 0:
            n_k = n_res_total // n_ups
            kw["resblock_kernels"] = tuple(
                int(sd[f"resblocks.{j}.convs1.0.weight"].shape[-1])
                for j in range(n_k))
            n_convs = count(r"resblocks\.0\.convs1\.(\d+)\.")
            dil = base.resblock_dilations
            if len(dil) != n_k or (n_convs and len(dil[0]) != n_convs):
                dil = (tuple(1 + 2 * i for i in range(n_convs or 3)),) * n_k
            kw["resblock_dilations"] = dil
    return dataclasses.replace(base, **kw)


def _resblock_init(g: torch.Generator, channels: int, k: int,
                   dilations) -> nn.Params:
    return {
        "convs1": [nn.conv1d_init(g, channels, channels, k)
                   for _ in dilations],
        "convs2": [nn.conv1d_init(g, channels, channels, k)
                   for _ in dilations],
    }


def _resblock(p: nn.Params, x: torch.Tensor, k: int,
              dilations) -> torch.Tensor:
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        pad1 = (d * (k - 1) // 2, d * (k - 1) - d * (k - 1) // 2)
        h = F.leaky_relu(x, LRELU_SLOPE)
        h = nn.conv1d(c1, h, padding=pad1, dilation=d)
        h = F.leaky_relu(h, LRELU_SLOPE)
        pad2 = ((k - 1) // 2, (k - 1) - (k - 1) // 2)
        h = nn.conv1d(c2, h, padding=pad2)
        x = x + h
    return x


def init_params(g: torch.Generator, cfg: HifiGanConfig) -> nn.Params:
    """Random parameters with the reference's tree, drawn on the generator's
    device; the upsample weights in torch's ConvTranspose1d layout
    (C_in, C_out, K)."""
    p: Dict = {
        "conv_pre": nn.conv1d_init(g, cfg.n_mels,
                                   cfg.upsample_initial_channel, 7),
        "ups": [],
        "resblocks": [],
    }
    ch = cfg.upsample_initial_channel
    for k in cfg.upsample_kernels:
        out_ch = ch // 2
        scale = 1.0 / (ch * k) ** 0.5
        p["ups"].append({
            "w": torch.empty((ch, out_ch, k), device=g.device).uniform_(
                -scale, scale, generator=g),
            "b": torch.zeros((out_ch,), device=g.device),
        })
        p["resblocks"].append([
            _resblock_init(g, out_ch, rk, rd)
            for rk, rd in zip(cfg.resblock_kernels, cfg.resblock_dilations)])
        ch = out_ch
    p["conv_post"] = nn.conv1d_init(g, ch, 1, 7)
    return p


def forward(params: nn.Params, mel: torch.Tensor,
            cfg: HifiGanConfig = HifiGanConfig()) -> torch.Tensor:
    """mel [B, T, n_mels] → wav [B, T·hop] float32 in [-1, 1]."""
    x = nn.conv1d(params["conv_pre"], mel, padding=(3, 3))
    for (r, k), up, blocks in zip(
            zip(cfg.upsample_rates, cfg.upsample_kernels),
            params["ups"], params["resblocks"]):
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = nn.conv_transpose1d(up, x, stride=r, padding=(k - r) // 2)
        acc = None
        for blk, rk, rd in zip(blocks, cfg.resblock_kernels,
                               cfg.resblock_dilations):
            y = _resblock(blk, x, rk, rd)
            acc = y if acc is None else acc + y
        x = acc / len(blocks)
    x = F.leaky_relu(x, LRELU_SLOPE)
    x = nn.conv1d(params["conv_post"], x, padding=(3, 3))
    return torch.tanh(x)[..., 0]
