"""Paraformer: non-autoregressive ASR (SAN-M encoder + CIF + NAR decoder).

Port of `toolbox_for_asr_and_tts_tpu/models/paraformer.py` over the same
parameter tree (ModelScope `speech_paraformer-large_asr_nat-zh-cn-16k-common-
vocab8404` geometry by default):

    frontend: fbank80 → LFR 7/6 → CMVN → 560-dim @ 60 ms
    encoder:  x·√d + sinusoidal PE (at the input width) → 1 SAN-M layer
              (560 → 512, no attention residual) → 49 SAN-M layers → LayerNorm
    predictor (CIF v2): conv1d k=3 + residual → relu → linear → sigmoid → α
    decoder:  16 SAN-M decoder layers + 1 ffn-only layer → LayerNorm →
              linear 512 → 8404
    greedy:   argmax over vocab at each fired token position.

CIF is the reference's static-shape formulation: token k's weight on frame t
is the overlap of [k, k+1) with [cumsum α_{t-1}, cumsum α_t), one [K, T]
matmul against the encoder states.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import nn
from ..ops.frontend import FrontendConfig


@dataclasses.dataclass(frozen=True)
class ParaformerConfig:
    input_dim: int = 560           # 80 mel × LFR m=7
    d_model: int = 512
    n_heads: int = 4
    ffn_dim: int = 2048
    encoder_layers: int = 50       # first layer takes input_dim
    decoder_layers: int = 16       # full layers; +1 ffn-only layer
    kernel_size: int = 11
    sanm_shift: int = 0
    vocab_size: int = 8404
    predictor_kernel: int = 3      # l_order + r_order + 1
    predictor_l_order: int = -1    # CIF conv left context; -1 = symmetric
    predictor_tail_threshold: float = 0.45
    bicif: bool = False            # BiCifParaformer: upsampled second CIF
    upsample_times: int = 3        # LFR 60 ms → 20 ms timestamp resolution
    blank_id: int = 0
    sos_id: int = 1
    eos_id: int = 2
    unk_id: int = 8403
    remat: bool = False            # recompute each encoder layer in the
                                   # backward pass (fine-tuning memory)
    lfr_m: int = 7
    lfr_n: int = 6

    @property
    def frontend(self) -> FrontendConfig:
        return FrontendConfig(lfr_m=self.lfr_m, lfr_n=self.lfr_n)

    @classmethod
    def from_funasr(cls, conf: dict, **overrides) -> "ParaformerConfig":
        """Config from a FunASR checkpoint's own config.yaml (handles
        FunASR's historical `sanm_shfit` spelling)."""
        kw = {}
        enc = conf.get("encoder_conf", {}) or {}
        for src, dst in (("output_size", "d_model"),
                         ("attention_heads", "n_heads"),
                         ("linear_units", "ffn_dim"),
                         ("num_blocks", "encoder_layers"),
                         ("kernel_size", "kernel_size"),
                         ("sanm_shift", "sanm_shift"),
                         ("sanm_shfit", "sanm_shift")):
            if src in enc:
                kw[dst] = enc[src]
        dec = conf.get("decoder_conf", {}) or {}
        if "num_blocks" in dec:
            kw["decoder_layers"] = dec["num_blocks"]
        pred = conf.get("predictor_conf", {}) or {}
        if "tail_threshold" in pred:
            kw["predictor_tail_threshold"] = pred["tail_threshold"]
        if "l_order" in pred and "r_order" in pred:
            kw["predictor_kernel"] = pred["l_order"] + pred["r_order"] + 1
            kw["predictor_l_order"] = pred["l_order"]
        fr = conf.get("frontend_conf", {}) or {}
        lfr_m = fr.get("lfr_m", 7)
        lfr_n = fr.get("lfr_n", 6)
        kw["lfr_m"], kw["lfr_n"] = lfr_m, lfr_n
        kw["input_dim"] = fr.get("n_mels", 80) * lfr_m
        if conf.get("model") == "BicifParaformer" \
                or "upsample_times" in pred:
            kw["bicif"] = True
            if "upsample_times" in pred:
                kw["upsample_times"] = pred["upsample_times"]
        kw.update(overrides)
        return cls(**kw)


def max_tokens_for(t_frames: int) -> int:
    """Static decode capacity for a given (bucketed) encoder length:
    T//2 + 8, rounded up to 8."""
    k = t_frames // 2 + 8
    return ((k + 7) // 8) * 8


# -------------------------------------------------------------------- init
def init_params(cfg: ParaformerConfig = ParaformerConfig(),
                generator: torch.Generator = None) -> nn.Params:
    """Random float32 parameters on the CPU, drawn from `generator`: the same
    tree, shapes and distributions as the reference's `init_params` (not the
    same numbers — JAX and torch generators differ). Move the tree with
    `models.convert.tree_to`."""
    g = generator if generator is not None else torch.Generator()
    enc_layers = []
    for i in range(cfg.encoder_layers):
        d_in = cfg.input_dim if i == 0 else cfg.d_model
        enc_layers.append({
            "norm1": nn.layernorm_init(d_in),
            "attn": nn.sanm_attention_init(g, d_in, cfg.d_model, cfg.n_heads,
                                           cfg.kernel_size),
            "norm2": nn.layernorm_init(cfg.d_model),
            "ffn": nn.ffn_init(g, cfg.d_model, cfg.ffn_dim),
        })
    dec_layers = []
    for _ in range(cfg.decoder_layers):
        dec_layers.append({
            "norm1": nn.layernorm_init(cfg.d_model),
            "ffn": nn.dec_ffn_init(g, cfg.d_model, cfg.ffn_dim),
            "norm2": nn.layernorm_init(cfg.d_model),
            "fsmn": nn.fsmn_memory_init(g, cfg.d_model, cfg.kernel_size),
            "norm3": nn.layernorm_init(cfg.d_model),
            "src_attn": nn.cross_attention_init(g, cfg.d_model, cfg.d_model,
                                                cfg.d_model, cfg.n_heads),
        })
    dec_final = {
        "norm1": nn.layernorm_init(cfg.d_model),
        "ffn": nn.dec_ffn_init(g, cfg.d_model, cfg.ffn_dim),
    }
    predictor = {
        "conv": nn.conv1d_init(g, cfg.d_model, cfg.d_model,
                               cfg.predictor_kernel),
        "out": nn.linear_init(g, cfg.d_model, 1),
    }
    if cfg.bicif:
        d, u = cfg.d_model, cfg.upsample_times
        s = 1.0 / (d ** 0.5)

        def lstm_dir():
            return {"w_ih": nn._uniform(g, (4 * d, d), s),
                    "w_hh": nn._uniform(g, (4 * d, d), s),
                    "b_ih": torch.zeros(4 * d), "b_hh": torch.zeros(4 * d)}

        predictor["upsample"] = {
            # ConvTranspose1d(d, d, u, u): torch weight layout [in, out, k]
            "cnn": {"w": torch.randn((d, d, u), generator=g) * s,
                    "b": torch.zeros(d)},
            "fwd": lstm_dir(),
            "bwd": lstm_dir(),
            "out": nn.linear_init(g, 2 * d, 1),
        }
    return {
        "encoder": {"layers": enc_layers,
                    "after_norm": nn.layernorm_init(cfg.d_model)},
        "predictor": predictor,
        "decoder": {"layers": dec_layers, "final": dec_final,
                    "after_norm": nn.layernorm_init(cfg.d_model),
                    "out": nn.linear_init(g, cfg.d_model, cfg.vocab_size)},
    }


def quantize_encoder_int8(params: nn.Params) -> nn.Params:
    """W8A8 serving quantization of the SAN-M encoder stack (ref
    `quantize_encoder_int8`): each encoder layer's attention `qkv` / `out`
    and FFN `w1` / `w2` linears become {"w" int8, "s" f32, "b" f32}
    (`nn.quantize_linear_int8`); layernorms, the FSMN taps, the predictor
    and the decoder keep their leaves, so the CIF and decode math is
    untouched. Serving only: a quantized tree does not train
    (`parallel/trainstep.py` refuses it). A new tree; the input's leaves
    are shared, not copied."""
    layers = []
    for layer in params["encoder"]["layers"]:
        q = dict(layer)
        q["attn"] = dict(layer["attn"],
                         qkv=nn.quantize_linear_int8(layer["attn"]["qkv"]),
                         out=nn.quantize_linear_int8(layer["attn"]["out"]))
        q["ffn"] = {"w1": nn.quantize_linear_int8(layer["ffn"]["w1"]),
                    "w2": nn.quantize_linear_int8(layer["ffn"]["w2"])}
        layers.append(q)
    return dict(params, encoder=dict(params["encoder"], layers=layers))


# ----------------------------------------------------------------- encoder
def encode(params: nn.Params, feats: torch.Tensor, mask: torch.Tensor,
           cfg: ParaformerConfig = ParaformerConfig()) -> torch.Tensor:
    """feats: [B, T, 560]; mask: [B, T] → encoder states [B, T, 512].

    With `cfg.remat` under autograd, each layer runs under
    `torch.utils.checkpoint` (non-reentrant): its activations are dropped
    and recomputed in the backward pass, K1 included (`FsmnDepthwiseFn`
    runs its forward again there), as the reference's `jax.checkpoint`."""
    t = feats.shape[1]
    x = feats * (cfg.d_model ** 0.5)
    x = x + nn.sinusoidal_posenc(t, feats.shape[-1], device=feats.device)[None]

    def layer_fn(layer, x, first: bool):
        residual = x
        h = nn.layernorm(layer["norm1"], x)
        h = nn.sanm_attention(layer["attn"], h, cfg.n_heads, mask,
                              cfg.kernel_size, cfg.sanm_shift)
        x = h if first else residual + h  # no residual when in_dim ≠ d_model
        residual = x
        return residual + nn.ffn(layer["ffn"], nn.layernorm(layer["norm2"], x))

    remat = cfg.remat and torch.is_grad_enabled()
    for i, layer in enumerate(params["encoder"]["layers"]):
        if remat:   # keep only each layer's input; recompute in backward
            # no random draws in a layer, and reading the card's generator
            # state is refused inside a CUDA graph capture
            x = checkpoint(layer_fn, layer, x, i == 0, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer_fn(layer, x, i == 0)
    x = nn.layernorm(params["encoder"]["after_norm"], x)
    return x * mask[..., None]


# --------------------------------------------------------------- predictor
def predictor_lpad(cfg: ParaformerConfig) -> int:
    """Left padding of the CIF predictor conv (FunASR ConstantPad1d
    (l_order, r_order)); -1 config default = symmetric kernel."""
    return (cfg.predictor_l_order if cfg.predictor_l_order >= 0
            else (cfg.predictor_kernel - 1) // 2)


def predictor_alphas(params: nn.Params, enc: torch.Tensor, mask: torch.Tensor,
                     cfg: ParaformerConfig = ParaformerConfig()) -> torch.Tensor:
    """CIF v2 α weights: [B, T] in [0, 1), masked. The conv output adds onto
    its input BEFORE the relu, with the (l_order, r_order) pad."""
    p = params["predictor"]
    lpad = predictor_lpad(cfg)
    h = nn.conv1d(p["conv"], enc,
                  padding=(lpad, cfg.predictor_kernel - 1 - lpad)) + enc
    h = torch.relu(h)
    alphas = torch.sigmoid(nn.linear(p["out"], h))[..., 0]
    return alphas * mask


def _first_true(cond: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where there is none
    (the rule of `jnp.argmax` over a 0/1 tensor), without relying on how a
    backend breaks ties in argmax."""
    n = cond.shape[-1]
    idx = torch.arange(n, device=cond.device)
    first = torch.where(cond, idx, n).amin(dim=-1)
    return torch.where(first == n, 0, first).int()


def cif(enc: torch.Tensor, alphas: torch.Tensor, k_max: int,
        tail_threshold: float = 0.45
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   torch.Tensor]:
    """Continuous integrate-and-fire as a static-shape overlap matmul.

    Returns (embeds [B, K, D], token_count [B] int32, fire_frame [B, K]
    int32 — the first frame whose cumsum reaches k+1 —, token_center [B, K]
    float32 — the α-weighted mean frame of token k's window —, start_frame
    [B, K] int32 — the first frame contributing mass to it).

    A virtual tail frame with α = tail_threshold and zero hidden is appended
    (FunASR CifPredictorV2.tail_process_fn).
    """
    b, t, d = enc.shape
    alphas = torch.cat([alphas, alphas.new_full((b, 1), tail_threshold)], 1)
    enc = torch.cat([enc, enc.new_zeros((b, 1, d))], 1)
    csum = torch.cumsum(alphas.float(), dim=1)         # [B, T+1]
    lo = torch.cat([csum.new_zeros((b, 1)), csum[:, :-1]], 1)
    k = torch.arange(k_max, dtype=torch.float32, device=enc.device)
    # weight of frame t on token k: |[lo_t, csum_t) ∩ [k, k+1)|
    w = torch.minimum(csum[:, None, :], k[None, :, None] + 1.0) - \
        torch.maximum(lo[:, None, :], k[None, :, None])
    # jnp.maximum's rule at a tie (w == 0, where a cumsum lands on an
    # integer): half the gradient; clamp_min would pass all of it
    w = torch.maximum(w, w.new_zeros(()))              # [B, K, T+1]
    embeds = torch.matmul(w, enc.float())
    token_count = torch.clamp_max(torch.floor(csum[:, -1]).int(), k_max)
    fire_frame = _first_true(csum[:, None, :] >= (k[None, :, None] + 1.0))
    start_frame = _first_true(csum[:, None, :] > k[None, :, None])
    t_idx = torch.arange(w.shape[-1], dtype=torch.float32, device=enc.device)
    mass = torch.clamp_min(w.sum(dim=2), 1e-6)         # [B, K]
    center = torch.matmul(w, t_idx) / mass             # [B, K]
    return embeds, token_count, fire_frame, center, start_frame


# ------------------------------------------------- BiCIF timestamp branch
def _lstm_dir(p: nn.Params, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One torch-layout LSTM direction over [B, T, D] (gate order i,f,g,o)."""
    if reverse:
        x = x.flip(1)
    b, t, _ = x.shape
    h_dim = p["w_hh"].shape[1]
    xw = torch.matmul(x.float(), p["w_ih"].float().T) + p["b_ih"] + p["b_hh"]
    w_hh_t = p["w_hh"].float().T
    h = x.new_zeros((b, h_dim), dtype=torch.float32)
    c = torch.zeros_like(h)
    ys = []
    for step in range(t):
        i, f, gg, o = (xw[:, step] + h @ w_hh_t).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    out = torch.stack(ys, dim=1) if ys else xw.new_zeros((b, 0, h_dim))
    return out.flip(1) if reverse else out


def upsample_alphas(params: nn.Params, enc: torch.Tensor, mask: torch.Tensor,
                    cfg: ParaformerConfig) -> torch.Tensor:
    """BiCIF upsampled alphas (FunASR CifPredictorV3: upsample_cnn → blstm →
    cif_output2 → sigmoid): enc [B, T, D], mask [B, T] → [B, T·u].
    ConvTranspose1d with stride == kernel == u is frame-local: an einsum."""
    p = params["predictor"]["upsample"]
    b, t, d = enc.shape
    u = p["cnn"]["w"].shape[-1]
    up = torch.einsum("btd,dok->btko", enc.float(), p["cnn"]["w"].float()) \
        + p["cnn"]["b"]
    up = up.reshape(b, t * u, d)
    ys = torch.cat([_lstm_dir(p["fwd"], up, False),
                    _lstm_dir(p["bwd"], up, True)], dim=-1)
    alphas = torch.sigmoid(nn.linear(p["out"], ys))[..., 0]     # [B, T·u]
    return alphas * torch.repeat_interleave(mask, u, dim=1)


def upsample_fire_frames(us_alphas: torch.Tensor, token_count: torch.Tensor,
                         k_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token boundary frames from upsampled alphas rescaled to the main
    CIF's token count: token k occupies frames [us_start_k, us_end_k]."""
    n = token_count.float()[:, None]
    mass = torch.clamp_min(us_alphas.sum(dim=-1, keepdim=True), 1e-6)
    csum = torch.cumsum(us_alphas * (n / mass), dim=-1)          # [B, U]
    k = torch.arange(k_max, dtype=torch.float32, device=us_alphas.device)
    us_end = _first_true(csum[:, None, :] >= (k[None, :, None] + 1.0 - 1e-4))
    us_start = _first_true(csum[:, None, :] > (k[None, :, None] + 1e-4))
    return us_start, us_end


# ----------------------------------------------------------------- decoder
def decode(params: nn.Params, embeds: torch.Tensor, token_mask: torch.Tensor,
           memory: torch.Tensor, memory_mask: torch.Tensor,
           cfg: ParaformerConfig = ParaformerConfig()) -> torch.Tensor:
    """NAR decode: CIF embeds [B, K, D] → logits [B, K, vocab] (FunASR
    `DecoderLayerSANM`: ffn → FSMN self-memory onto the pre-FFN residual →
    cross-attention with its own residual)."""
    x = embeds
    pad = nn.sanm_pad(cfg.kernel_size, cfg.sanm_shift)
    for layer in params["decoder"]["layers"]:
        residual = x
        h = nn.layernorm(layer["norm1"], x)
        h = nn.dec_ffn(layer["ffn"], h)
        h = nn.layernorm(layer["norm2"], h)
        h = nn.fsmn_block(layer["fsmn"], h, pad, token_mask)
        x = residual + h
        residual = x
        h = nn.layernorm(layer["norm3"], x)
        x = residual + nn.cross_attention(layer["src_attn"], h, memory,
                                          cfg.n_heads, memory_mask)
    # ffn-only final layer: norm1 → ffn, NO residual
    fin = params["decoder"]["final"]
    x = nn.dec_ffn(fin["ffn"], nn.layernorm(fin["norm1"], x))
    x = nn.layernorm(params["decoder"]["after_norm"], x)
    return nn.linear(params["decoder"]["out"], x)


# ------------------------------------------------------------ full forward
def forward(params: nn.Params, feats: torch.Tensor, feat_lengths: torch.Tensor,
            k_max: int, cfg: ParaformerConfig = ParaformerConfig()
            ) -> Dict[str, torch.Tensor]:
    """Batched offline recognition forward pass.

    feats: [B, T, 560] LFR+CMVN features; feat_lengths: [B] valid frames.
    Returns logits [B, K, V], greedy tokens [B, K], token_count [B],
    fire_frame / token_center / token_start [B, K], alphas [B, T], and the
    intermediates `enc` and `embeds` for two-phase rescoring.
    """
    t = feats.shape[1]
    mask = nn.length_mask(feat_lengths, t)
    enc = encode(params, feats, mask, cfg)
    alphas = predictor_alphas(params, enc, mask, cfg)
    embeds, token_count, fire_frame, center, start_frame = cif(
        enc, alphas, k_max, cfg.predictor_tail_threshold)
    token_mask = nn.length_mask(token_count, k_max)
    logits = decode(params, embeds, token_mask, enc, mask, cfg)
    tokens = torch.argmax(logits, dim=-1).int() * token_mask.int()
    extra = {}
    if "upsample" in params["predictor"]:
        us = upsample_alphas(params, enc, mask, cfg)
        us_start, us_end = upsample_fire_frames(us, token_count, k_max)
        extra = {"us_start": us_start, "us_end": us_end}
    return {
        **extra,
        "logits": logits,
        "tokens": tokens,
        "token_count": token_count,
        "fire_frame": fire_frame,
        "token_center": center,
        "token_start": start_frame,
        "alphas": alphas,
        "enc": enc,
        "embeds": embeds,
    }
