"""FSMN-VAD: streaming voice activity detection model.

Port of `toolbox_for_asr_and_tts_tpu/models/fsmn_vad.py` over the same
parameter tree (ModelScope `speech_fsmn_vad_zh-cn-16k-common-pytorch`):

    fbank80 → LFR m=5,n=1 → CMVN → 400-dim @ 10 ms
    AffineTransform 400→140 → AffineTransform 140→250 → ReLU
    4 × [ LinearTransform 250→128 (no bias)
          FSMNBlock depthwise-conv lorder=20 (past only) + residual
          AffineTransform 128→250 → ReLU ]
    AffineTransform 250→140 → AffineTransform 140→248 → softmax
    P(speech) = 1 − P(silence pdfs)

Both `apply` and `apply_streaming` run the FSMN blocks through kernel K1
(`nn.fsmn_block`, pad (lorder − 1, rorder)). The streaming conv state is the
last lorder − 1 proj frames of each layer, held as ONE tensor
[layers, B, lorder − 1, proj] (the reference keeps a list of per-layer
arrays), so a ticker merges, moves or resets a row of every layer at once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops import nn
from ..ops.frontend import FrontendConfig


@dataclasses.dataclass(frozen=True)
class FsmnVadConfig:
    input_dim: int = 400          # 80 mel × LFR m=5
    input_affine_dim: int = 140
    linear_dim: int = 250
    proj_dim: int = 128
    fsmn_layers: int = 4
    lorder: int = 20
    rorder: int = 0
    output_affine_dim: int = 140
    output_dim: int = 248
    sil_pdf_ids: Tuple[int, ...] = (0,)

    @property
    def frontend(self) -> FrontendConfig:
        return FrontendConfig(lfr_m=5, lfr_n=1)

    @classmethod
    def from_funasr(cls, conf: dict, **overrides) -> "FsmnVadConfig":
        """Config from the checkpoint's own config.yaml (FunASR FSMN
        encoder_conf + model_conf.sil_pdf_ids)."""
        enc = conf.get("encoder_conf", {}) or {}
        kw = {}
        for srcs, dst in ((("input_dim",), "input_dim"),
                          (("input_affine_dim",), "input_affine_dim"),
                          (("linear_dim",), "linear_dim"),
                          (("proj_dim",), "proj_dim"),
                          (("fsmn_layers", "fsmn_layer_num"), "fsmn_layers"),
                          (("lorder",), "lorder"),
                          (("rorder",), "rorder"),
                          (("output_affine_dim",), "output_affine_dim"),
                          (("output_dim",), "output_dim")):
            for s in srcs:
                if s in enc:
                    kw[dst] = enc[s]
                    break
        mc = conf.get("model_conf", {}) or {}
        if "sil_pdf_ids" in mc:
            kw["sil_pdf_ids"] = tuple(mc["sil_pdf_ids"])
        kw.update(overrides)
        return cls(**kw)


def from_model_dir(model_dir: str, cfg: FsmnVadConfig = None,
                   device: DeviceLike = None):
    """A `speech_fsmn_vad_zh-cn-16k-common` checkpoint dir → (params on
    `device` (the card unless "cpu" is passed), cfg, cmvn). Geometry from
    the dir's config, CMVN from am.mvn (FunASR applies it in the VAD
    frontend)."""
    import os
    from ..runtime import checkpoints as ckpt
    from .convert import params_from_numpy
    device = resolve_device(device)
    cfg = cfg or FsmnVadConfig.from_funasr(ckpt.load_model_config(model_dir))
    params = ckpt.convert_or_load_cached(
        model_dir, ckpt.shape_template(lambda g: init_params(cfg, g)),
        ckpt.fsmn_vad_rules(cfg.fsmn_layers))
    cmvn = None
    mvn = os.path.join(model_dir, "am.mvn")
    if os.path.exists(mvn):
        cmvn = ckpt.parse_kaldi_cmvn(mvn)
    return params_from_numpy(params, device), cfg, cmvn


def init_params(cfg: FsmnVadConfig = FsmnVadConfig(),
                generator: torch.Generator = None) -> nn.Params:
    """Random float32 parameters on the CPU, drawn from `generator`: the
    reference's tree, shapes and distributions (not its numbers)."""
    g = generator if generator is not None else torch.Generator()
    p: Dict = {
        "in1": nn.linear_init(g, cfg.input_dim, cfg.input_affine_dim),
        "in2": nn.linear_init(g, cfg.input_affine_dim, cfg.linear_dim),
        "out1": nn.linear_init(g, cfg.linear_dim, cfg.output_affine_dim),
        "out2": nn.linear_init(g, cfg.output_affine_dim, cfg.output_dim),
        "blocks": [],
    }
    for _ in range(cfg.fsmn_layers):
        p["blocks"].append({
            "proj": nn.linear_init(g, cfg.linear_dim, cfg.proj_dim, bias=False),
            "fsmn": nn.fsmn_block_init(g, cfg.proj_dim, cfg.lorder, cfg.rorder),
            "affine": nn.linear_init(g, cfg.proj_dim, cfg.linear_dim),
        })
    return p


def _head(params: nn.Params, feats: torch.Tensor) -> torch.Tensor:
    return torch.relu(nn.linear(params["in2"], nn.linear(params["in1"], feats)))


def _tail(params: nn.Params, x: torch.Tensor) -> torch.Tensor:
    x = nn.linear(params["out2"], nn.linear(params["out1"], x))
    return torch.softmax(x, dim=-1)


def apply(params: nn.Params, feats: torch.Tensor,
          cfg: FsmnVadConfig = FsmnVadConfig()) -> torch.Tensor:
    """feats: [B, T, 400] (LFR+CMVN) → pdf posteriors [B, T, 248]."""
    x = _head(params, feats)
    pad = nn.fsmn_pad(cfg.lorder, cfg.rorder)
    for blk in params["blocks"]:
        h = nn.fsmn_block(blk["fsmn"], nn.linear(blk["proj"], x), pad)
        x = torch.relu(nn.linear(blk["affine"], h))
    return _tail(params, x)


def speech_prob(posteriors: torch.Tensor,
                cfg: FsmnVadConfig = FsmnVadConfig()) -> torch.Tensor:
    """[B, T, 248] → P(speech) [B, T] = 1 − Σ P(sil pdfs)."""
    # basic slices, no index tensor: a list index would be copied to the
    # card on every call, which a graph capture refuses
    sil = torch.stack([posteriors[..., i] for i in cfg.sil_pdf_ids],
                      dim=-1).sum(dim=-1)
    return 1.0 - sil


# ------------------------------------------------------------- streaming
def init_cache(batch: int, cfg: FsmnVadConfig = FsmnVadConfig(),
               device: DeviceLike = None) -> torch.Tensor:
    """FSMN conv left-context cache of every layer: the last lorder − 1
    proj frames, [layers, batch, lorder − 1, proj], on `device` (the card
    unless "cpu" is passed)."""
    return torch.zeros((cfg.fsmn_layers, batch, cfg.lorder - 1, cfg.proj_dim),
                       device=resolve_device(device))


def apply_streaming(params: nn.Params, feats: torch.Tensor,
                    cache: torch.Tensor, cfg: FsmnVadConfig = FsmnVadConfig()
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk with explicit conv state: feats [B, T_chunk, 400], cache
    [layers, B, lorder − 1, proj] → (posteriors [B, T_chunk, 248], cache').

    Equals `apply` on the whole stream sliced to this chunk (rorder must be
    0). Each layer runs K1 over [cache ‖ h] with the causal pad (lorder − 1,
    0) and keeps rows lorder − 1 onward: row ctx + t is h[t] plus the
    valid depthwise conv of [cache ‖ h] at t, term for term the reference's
    `h + conv1d(valid)` (fsmn_vad.py:152-157), in K1's order of sums."""
    if cfg.rorder != 0:
        raise ValueError("streaming requires a causal FSMN (rorder 0)")
    x = _head(params, feats)
    ctx = cfg.lorder - 1
    pad = nn.fsmn_pad(cfg.lorder, 0)
    new_cache = []
    for blk, c in zip(params["blocks"], cache):
        hc = torch.cat([c, nn.linear(blk["proj"], x)], dim=1)   # [B, ctx+T, P]
        h = nn.fsmn_block(blk["fsmn"], hc, pad)[:, ctx:]
        new_cache.append(hc[:, -ctx:])
        x = torch.relu(nn.linear(blk["affine"], h))
    return _tail(params, x), torch.stack(new_cache)
