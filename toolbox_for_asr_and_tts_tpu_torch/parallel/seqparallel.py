"""Sequence-parallel SAN-M encoding over a mesh axis (long audio in one go).

Port of `toolbox_for_asr_and_tts_tpu/parallel/seqparallel.py`. The time
axis of one utterance splits into one block per position of the axis; each
position computes its block of encoder rows, and the only exchange is K and
V, gathered along T every layer:

- the input scaling and the positional encoding apply to the whole array
  before the split (the encoding depends on the absolute position);
- per layer, each position projects q, k and v from its own block; K and V
  are gathered along T (`Tensor.to` onto the position, then `torch.cat`),
  so each position scores its rows against the whole utterance;
- the FSMN memory (kernel K1) runs on the gathered V, a contiguous
  [B, T, d] on every position, and the position keeps its own rows: no
  halo bookkeeping;
- masks travel whole; masked rows zero out exactly as offline.

`pad_to_blocks` rounds T up to a multiple of the axis; the mask keeps the
padding inert, so the sharded encoding equals the offline one on the valid
prefix. The blocks come back joined along T on the input's device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..models import paraformer
from ..ops import nn
from ..runtime.mesh import Mesh, per_position


def pad_to_blocks(feats: torch.Tensor, mask: torch.Tensor, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad [B, T, D] feats and the [B, T] mask so that T % n == 0 (the
    padding is masked)."""
    pad = (-feats.shape[1]) % n
    if pad:
        feats = F.pad(feats, (0, 0, 0, pad))
        mask = F.pad(mask, (0, pad))
    return feats, mask


def encode_seq_parallel(params: nn.Params, feats: torch.Tensor,
                        mask: torch.Tensor, cfg: paraformer.ParaformerConfig,
                        mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """feats [B, T, input_dim] (T divisible by the axis size), mask [B, T]
    → encoder states [B, T, d_model] on feats' device, each block of T
    computed on its own position. Equal to `paraformer.encode` within
    float rounding (`tests/test_torch_port_parallel.py`)."""
    devs = mesh.along(axis)
    n = len(devs)
    b, t, d_in = feats.shape
    if t % n:
        raise ValueError(f"T={t} is not divisible by mesh axis {axis}={n}")
    tb = t // n
    x = feats * (cfg.d_model ** 0.5)
    x = x + nn.sinusoidal_posenc(t, d_in, device=feats.device)[None]
    enc = per_position(params["encoder"], devs)
    masks = [mask.float().to(dv) for dv in devs]
    xb = [x[:, i * tb:(i + 1) * tb].to(dv) for i, dv in enumerate(devs)]
    pad = nn.sanm_pad(cfg.kernel_size, cfg.sanm_shift)
    for li in range(len(params["encoder"]["layers"])):
        layers = [e["layers"][li] for e in enc]
        qkv = [nn.linear(ly["attn"]["qkv"], nn.layernorm(ly["norm1"], xi))
               .chunk(3, dim=-1) for ly, xi in zip(layers, xb)]
        out = []
        for i, (dv, ly) in enumerate(zip(devs, layers)):
            k_full = torch.cat([k.to(dv) for _, k, _ in qkv], dim=1)
            v_full = torch.cat([v.to(dv) for _, _, v in qkv], dim=1)
            mem_full = nn.fsmn_block(ly["attn"]["fsmn"], v_full, pad,
                                     masks[i])
            mem = mem_full[:, i * tb:(i + 1) * tb]
            att = nn.attend(nn._split_heads(qkv[i][0], cfg.n_heads),
                            nn._split_heads(k_full, cfg.n_heads),
                            nn._split_heads(v_full, cfg.n_heads),
                            masks[i][:, None, :])
            hb = nn.linear(ly["attn"]["out"], nn._merge_heads(att)) + mem
            xi = hb if li == 0 else xb[i] + hb  # no residual when d_in ≠ d
            out.append(xi + nn.ffn(ly["ffn"],
                                   nn.layernorm(ly["norm2"], xi)))
        xb = out
    blocks = [nn.layernorm(e["after_norm"], xi)
              * masks[i][:, i * tb:(i + 1) * tb, None]
              for i, (e, xi) in enumerate(zip(enc, xb))]
    return torch.cat([blk.to(feats.device) for blk in blocks], dim=1)


def transcribe_long_forward(params: nn.Params, feats: torch.Tensor,
                            feat_lens: torch.Tensor, k_max: int,
                            cfg: paraformer.ParaformerConfig, mesh: Mesh,
                            axis: str = "data"):
    """The long-form forward: the sequence-parallel encoding, then the
    plain predictor → CIF → decoder on feats' device. Returns {"tokens",
    "token_count"} as `paraformer.forward` gives them."""
    t = feats.shape[1]
    mask = nn.length_mask(feat_lens, t)
    feats, mask = pad_to_blocks(feats, mask, len(mesh.along(axis)))
    enc = encode_seq_parallel(params, feats, mask, cfg, mesh, axis)
    alphas = paraformer.predictor_alphas(params, enc, mask, cfg)
    embeds, token_count, _, _, _ = paraformer.cif(
        enc, alphas, k_max, cfg.predictor_tail_threshold)
    tok_mask = nn.length_mask(token_count, k_max)
    logits = paraformer.decode(params, embeds, tok_mask, enc, mask, cfg)
    tokens = torch.argmax(logits, dim=-1).int() * tok_mask.int()
    return {"tokens": tokens, "token_count": token_count}
