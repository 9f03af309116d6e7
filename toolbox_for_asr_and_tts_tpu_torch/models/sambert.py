"""Sambert-class acoustic model: phonemes → mel-spectrogram.

Port of `toolbox_for_asr_and_tts_tpu/models/sambert.py` over the same
parameter tree. Two decoders share one encoder / variance-adaptor /
length-regulator stack:

- **NAR fast mode** (`forward`): a FastSpeech-family parallel decoder, the
  whole mel in one pass.
- **PNCA AR decoder** (`forward_ar`, KAN-TTS Sambert's architecture): the
  mel is decoded in groups of `outputs_per_step` frames; each step runs a
  prenet on the previous group and N layers of dual attention over X (the
  decoder history, causal, optional band) and H (the frame-aligned encoder
  memory, a non-causal band around the current step). The reference's
  `lax.scan` is a Python loop over steps here, with the same static-shape
  masks: attention spans all S steps (and all frames) under additive masks,
  so every reduction has the reference's length and order.

`SambertConfig.from_kantts` reads a mounted KAN-TTS package's config
through `runtime/checkpoints.py::search_config`.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple

import torch

from ..ops import nn
from .convert import tree_to


@dataclasses.dataclass(frozen=True)
class SambertConfig:
    vocab_size: int = 4608          # `sy` stream inventory (text_frontend)
    tone_size: int = 8              # tone stream (0 none + 1–5)
    sylfl_size: int = 8             # syllable_flag stream
    wseg_size: int = 8              # word_segment stream
    n_speakers: int = 8
    n_emotions: int = 8             # emo_tokenizer rows (zhitian_emo etc.)
    d_model: int = 256
    n_heads: int = 4
    ffn_dim: int = 1024
    encoder_layers: int = 4
    decoder_layers: int = 4
    n_mels: int = 80
    max_duration: int = 20          # frames per phone cap (static shapes)
    frames_per_phone: int = 10      # mel bucket = phones × this
    postnet_layers: int = 5
    postnet_channels: int = 256
    postnet_kernel: int = 5
    var_kernel: int = 3
    var_channels: int = 256
    # PNCA AR decoder (KAN-TTS geometry)
    pnca_layers: int = 6
    outputs_per_step: int = 3       # r mel frames per AR step
    prenet_units: int = 256
    x_band: int = -1                # causal history band (-1 = unbounded)
    h_band: int = 20                # non-causal memory band (steps, ± around
                                    # the aligned position; -1 = full)

    @classmethod
    def from_kantts(cls, conf: dict, **overrides) -> "SambertConfig":
        """Config from a mounted KAN-TTS package's own config.yaml/json.
        Alias tuples absorb KAN-TTS naming drift; anything a sparse config
        omits is later pinned from the state dict itself by
        `config_from_state_dict` (shapes beat config files)."""
        from ..runtime.checkpoints import search_config
        alias = {
            "d_model": ("embedding_dim", "encoder_num_units", "d_model"),
            "n_heads": ("encoder_num_heads", "num_heads", "n_heads"),
            "ffn_dim": ("encoder_ffn_inner_dim", "ffn_inner_dim", "ffn_dim"),
            "encoder_layers": ("encoder_num_layers",),
            "pnca_layers": ("decoder_num_layers",),
            "n_mels": ("num_mels", "n_mels", "num_mel_bins"),
            "outputs_per_step": ("outputs_per_step",),
            "prenet_units": ("decoder_prenet_units", "prenet_units"),
            "postnet_layers": ("postnet_num_layers", "postnet_n_convs"),
            "postnet_channels": ("postnet_num_units", "postnet_embedding_dim",
                                 "postnet_channels"),
            "postnet_kernel": ("postnet_kernel_size", "postnet_kernel"),
            "var_channels": ("predictor_num_units", "predictor_filter_size",
                             "variance_predictor_filter_size"),
            "var_kernel": ("predictor_kernel_size",
                           "variance_predictor_kernel_size"),
            "n_speakers": ("speaker_units", "num_speakers", "speaker_num",
                           "n_speakers"),
            "n_emotions": ("emotion_units", "num_emotions", "emotion_num",
                           "n_emotions"),
            "vocab_size": ("num_symbols", "n_symbols", "vocab_size"),
        }
        kw = {}
        for field, names in alias.items():
            v = search_config(conf or {}, names)
            if v is None:
                continue
            if isinstance(v, (list, tuple)):  # e.g. prenet_units: [256, 256]
                v = v[-1]
            kw[field] = int(v)
        kw.update(overrides)
        return cls(**kw)


def config_from_state_dict(sd, base: SambertConfig) -> SambertConfig:
    """Pin every shape-derivable hyperparameter from a KAN-TTS Sambert state
    dict (shapes beat config files); only n_heads and the attention bands
    cannot be read off shapes and stay as in `base`."""
    def count(prefix: str):
        pat = re.compile(re.escape(prefix) + r"\.(\d+)\.")
        idx = {int(m.group(1)) for k in sd for m in [pat.match(k)] if m}
        return (max(idx) + 1) if idx else None

    kw = {}
    if "text_encoder.sy_emb.weight" in sd:
        kw["vocab_size"], kw["d_model"] = sd["text_encoder.sy_emb.weight"].shape
    for field, key in (("tone_size", "text_encoder.tone_emb.weight"),
                       ("sylfl_size", "text_encoder.syllable_flag_emb.weight"),
                       ("wseg_size", "text_encoder.word_segment_emb.weight"),
                       ("n_emotions", "emo_tokenizer.weight")):
        if key in sd:
            kw[field] = sd[key].shape[0]
    if "spk_tokenizer.weight" in sd:
        kw["n_speakers"] = sd["spk_tokenizer.weight"].shape[0]
    if "text_encoder.layer_stack.0.pos_ffn.w_1.weight" in sd:
        kw["ffn_dim"] = sd["text_encoder.layer_stack.0.pos_ffn.w_1.weight"
                           ].shape[0]
    for field, prefix in (("encoder_layers", "text_encoder.layer_stack"),
                          ("pnca_layers", "mel_decoder.layer_stack"),
                          ("postnet_layers", "mel_postnet.conv_stack")):
        n = count(prefix)
        if n is not None:
            kw[field] = n
    if "mel_postnet.conv_stack.0.conv.weight" in sd:
        w = sd["mel_postnet.conv_stack.0.conv.weight"]  # [C, n_mels, k]
        kw["n_mels"] = w.shape[1]
        kw["postnet_kernel"] = w.shape[-1]
        if kw.get("postnet_layers", base.postnet_layers) > 1:
            kw["postnet_channels"] = w.shape[0]
        if "mel_decoder.mel_out.weight" in sd:
            kw["outputs_per_step"] = max(
                sd["mel_decoder.mel_out.weight"].shape[0] // w.shape[1], 1)
    if "mel_decoder.prenet.fc1.weight" in sd:
        kw["prenet_units"] = sd["mel_decoder.prenet.fc1.weight"].shape[0]
    if "dur_predictor.conv1.weight" in sd:
        w = sd["dur_predictor.conv1.weight"]            # [C, d, k]
        kw["var_channels"], kw["var_kernel"] = w.shape[0], w.shape[-1]
    return dataclasses.replace(base, **kw)


# ------------------------------------------------------------------ params
def _var_predictor_init(g: torch.Generator, d: int, channels: int,
                        k: int) -> nn.Params:
    return {
        "c1": nn.conv1d_init(g, d, channels, k),
        "ln1": nn.layernorm_init(channels),
        "c2": nn.conv1d_init(g, channels, channels, k),
        "ln2": nn.layernorm_init(channels),
        "out": nn.linear_init(g, channels, 1),
    }


def _var_predictor(p: nn.Params, x: torch.Tensor, k: int) -> torch.Tensor:
    pad = ((k - 1) // 2, k // 2)
    h = torch.relu(nn.conv1d(p["c1"], x, padding=pad))
    h = nn.layernorm(p["ln1"], h)
    h = torch.relu(nn.conv1d(p["c2"], h, padding=pad))
    h = nn.layernorm(p["ln2"], h)
    # the one-column `out` product as a row reduction: each row's sum is
    # then the same whatever the batch size (a CPU gemv's is not), which
    # keeps a segment synthesized alone equal to one synthesized in a batch
    return (h * p["out"]["w"][:, 0]).sum(-1) + p["out"]["b"][0]


def _transformer_layer_init(g: torch.Generator, d: int, heads: int,
                            ffn: int) -> nn.Params:
    return {
        "norm1": nn.layernorm_init(d),
        "attn": nn.mha_init(g, d, heads),
        "norm2": nn.layernorm_init(d),
        "ffn": nn.ffn_init(g, d, ffn),
    }


def _transformer_layer(p: nn.Params, x: torch.Tensor, heads: int,
                       mask: torch.Tensor) -> torch.Tensor:
    x = x + nn.mha(p["attn"], nn.layernorm(p["norm1"], x), heads, mask)
    x = x + nn.ffn(p["ffn"], nn.layernorm(p["norm2"], x))
    return x


def init_params(g: torch.Generator, cfg: SambertConfig) -> nn.Params:
    """Random parameters with the reference's tree and layouts, drawn on the
    generator's device (the norms' ones and zeros moved there). The
    duration head's bias starts at +log 6 (≈ 5 frames per phone), so random
    weights give speech-length audio."""
    def vp():
        return _var_predictor_init(g, cfg.d_model, cfg.var_channels,
                                   cfg.var_kernel)

    enc = [_transformer_layer_init(g, cfg.d_model, cfg.n_heads, cfg.ffn_dim)
           for _ in range(cfg.encoder_layers)]
    dec = [_transformer_layer_init(g, cfg.d_model, cfg.n_heads, cfg.ffn_dim)
           for _ in range(cfg.decoder_layers)]
    postnet = []
    for i in range(cfg.postnet_layers):
        c_in = cfg.n_mels if i == 0 else cfg.postnet_channels
        c_out = (cfg.n_mels if i == cfg.postnet_layers - 1
                 else cfg.postnet_channels)
        # the channel affine is inference-time BatchNorm
        postnet.append({"conv": nn.conv1d_init(g, c_in, c_out,
                                               cfg.postnet_kernel),
                        "norm": nn.layernorm_init(c_out)})
    duration = vp()
    duration["out"]["b"] = duration["out"]["b"] + float(math.log(6.0))
    return tree_to({
        "ling": {
            "sy": nn.embedding_init(g, cfg.vocab_size, cfg.d_model),
            "tone": nn.embedding_init(g, cfg.tone_size, cfg.d_model),
            "syllable_flag": nn.embedding_init(g, cfg.sylfl_size, cfg.d_model),
            "word_segment": nn.embedding_init(g, cfg.wseg_size, cfg.d_model),
        },
        "spk": nn.embedding_init(g, cfg.n_speakers, cfg.d_model),
        "emo": nn.embedding_init(g, cfg.n_emotions, cfg.d_model),
        "encoder": enc,
        "duration": duration,
        "pitch": vp(),
        "energy": vp(),
        "pitch_embed": nn.conv1d_init(g, 1, cfg.d_model, 9),
        "energy_embed": nn.conv1d_init(g, 1, cfg.d_model, 9),
        "decoder": dec,
        "mel_out": nn.linear_init(g, cfg.d_model, cfg.n_mels),
        "postnet": postnet,
        "pnca": pnca_init(g, cfg),
    }, g.device)


# ------------------------------------------------------- PNCA (AR) decoder
def pnca_init(g: torch.Generator, cfg: SambertConfig) -> nn.Params:
    """KAN-TTS MelPNCADecoder parameters (prenet + N dual-attention layers)."""
    d, r = cfg.d_model, cfg.outputs_per_step
    layers = []
    for _ in range(cfg.pnca_layers):
        layers.append({
            "q": nn.linear_init(g, d, d),
            "kx": nn.linear_init(g, d, d),
            "vx": nn.linear_init(g, d, d),
            "kh": nn.linear_init(g, d, d),
            "vh": nn.linear_init(g, d, d),
            "fc": nn.linear_init(g, 2 * d, d),
            "norm_attn": nn.layernorm_init(d),
            "ffn": nn.ffn_init(g, d, cfg.ffn_dim),
            "norm_ffn": nn.layernorm_init(d),
        })
    return {
        "layers": layers,
        "prenet": {
            "fc1": nn.linear_init(g, cfg.n_mels * r, cfg.prenet_units),
            "fc2": nn.linear_init(g, cfg.prenet_units, cfg.prenet_units),
            "proj": nn.linear_init(g, cfg.prenet_units, d),
        },
        "mel_out": nn.linear_init(g, d, cfg.n_mels * r),
    }


def _split(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).permute(0, 2, 1, 3)


def _pnca_scan(pnca: nn.Params, memory: torch.Tensor,
               mem_step_mask: torch.Tensor,
               cfg: SambertConfig) -> torch.Tensor:
    """AR decode: memory [B, S, r, D] (frame-aligned, grouped by step) →
    mel [B, S·r, n_mels], one loop iteration per step.

    The memory keys/values are projected and split into heads once, before
    the loop; the X caches [n_layers, B, H, S, dk] (head-major, so a step
    reads them without a copy) take each layer's k/v at the step that made
    them, written in place. Each step attends over all S cached steps and
    all S·r memory frames under the reference's masks (steps ≤ t, inside
    the optional x band; frames whose step lies within h_band of t, times
    the mel mask)."""
    b, s, r, d = memory.shape
    heads = cfg.n_heads
    dk = d // heads
    dev = memory.device
    mem_flat = memory.reshape(b, s * r, d)
    layers = pnca["layers"]
    kh = [_split(nn.linear(l["kh"], mem_flat), heads).contiguous()
          for l in layers]
    vh = [_split(nn.linear(l["vh"], mem_flat), heads).contiguous()
          for l in layers]
    pe = nn.sinusoidal_posenc(s, d, device=dev)

    steps = torch.arange(s, device=dev)
    t_col = steps[:, None]
    xmask_tab = steps[None, :] <= t_col                       # [S, S]
    if cfg.x_band >= 0:
        xmask_tab &= steps[None, :] > t_col - cfg.x_band - 1
    xmask_tab = xmask_tab.float()
    if cfg.h_band >= 0:
        frame_step = torch.arange(s * r, device=dev) // r     # [S·r]
        hband_tab = ((frame_step[None, :] - t_col).abs()
                     <= cfg.h_band).float()                   # [S, S·r]

    pp = pnca["prenet"]
    kx = torch.zeros(len(layers), b, heads, s, dk, device=dev)
    vx = torch.zeros(len(layers), b, heads, s, dk, device=dev)
    prev = torch.zeros(b, cfg.n_mels * r, device=dev)
    mels = torch.empty(s, b, cfg.n_mels * r, device=dev)
    for t in range(s):
        h = torch.relu(nn.linear(pp["fc1"], prev))
        h = torch.relu(nn.linear(pp["fc2"], h))
        x = nn.linear(pp["proj"], h) + pe[t]                  # [B, D]
        xmask = xmask_tab[t].expand(b, s)[:, None, :]
        hmask = mem_step_mask
        if cfg.h_band >= 0:
            hmask = hmask * hband_tab[t][None]
        hmask = hmask[:, None, :]
        for li, layer in enumerate(layers):
            kx[li, :, :, t] = nn.linear(layer["kx"], x).view(b, heads, dk)
            vx[li, :, :, t] = nn.linear(layer["vx"], x).view(b, heads, dk)
            q = nn.linear(layer["q"], x).view(b, heads, 1, dk)
            ax = nn.attend(q, kx[li], vx[li], xmask)
            ah = nn.attend(q, kh[li], vh[li], hmask)
            a = nn.linear(layer["fc"], torch.cat(
                [ax.reshape(b, d), ah.reshape(b, d)], -1))
            x = nn.layernorm(layer["norm_attn"], x + a)
            x = nn.layernorm(layer["norm_ffn"], x + nn.ffn(layer["ffn"], x))
        prev = nn.linear(pnca["mel_out"], x)                  # [B, r·n_mels]
        mels[t] = prev
    return mels.permute(1, 0, 2).reshape(b, s * r, cfg.n_mels)


# --------------------------------------------------------- shared front half
def length_regulate(x: torch.Tensor, durations: torch.Tensor, t_mel: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand phone states by integer durations at a static length.

    x: [B, L, D]; durations: [B, L] int (0 for padding phones). Frame t
    takes the phone whose duration-cumsum interval contains t:
    idx_t = Σ_l 1[t ≥ ends_l]. Returns ([B, t_mel, D], mel_mask [B, t_mel])."""
    ends = torch.cumsum(durations, dim=1)                     # [B, L]
    t = torch.arange(t_mel, device=x.device)
    idx = (t[None, :, None] >= ends[:, None, :]).sum(-1)      # [B, T]
    mel_mask = (t[None, :] < ends[:, -1:]).to(x.dtype)
    idx = idx.clamp(max=x.shape[1] - 1)
    expanded = torch.gather(
        x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return expanded * mel_mask[..., None], mel_mask


def _embed_inputs(params: nn.Params, ling_ids: torch.Tensor,
                  speaker_ids: torch.Tensor,
                  emotion_ids: Optional[torch.Tensor],
                  cfg: SambertConfig) -> torch.Tensor:
    """The four linguistic streams' embeddings summed, plus sinusoidal
    position, speaker and emotion. A 2-D `ling_ids` [B, L] is the sy-only
    path: the other streams at id 0."""
    if ling_ids.dim() == 2:
        zeros = torch.zeros_like(ling_ids)
        ling_ids = torch.stack([ling_ids, zeros, zeros, zeros], -1)
    lp = params["ling"]
    x = (nn.embedding(lp["sy"], ling_ids[..., 0])
         + nn.embedding(lp["tone"], ling_ids[..., 1])
         + nn.embedding(lp["syllable_flag"], ling_ids[..., 2])
         + nn.embedding(lp["word_segment"], ling_ids[..., 3]))
    # in the table's dtype, as the reference: a bf16 tree keeps these
    # sums bf16 until the first product
    x = x + nn.sinusoidal_posenc(ling_ids.shape[1], cfg.d_model,
                                 device=x.device, dtype=x.dtype)[None]
    x = x + nn.embedding(params["spk"], speaker_ids)[:, None, :]
    if emotion_ids is None:
        emotion_ids = torch.zeros_like(speaker_ids)
    return x + nn.embedding(params["emo"], emotion_ids)[:, None, :]


def _encode(params: nn.Params, phone_ids, phone_lens, speaker_ids,
            cfg: SambertConfig, emotion_ids):
    """Embeddings → encoder → masked states and the log-duration head:
    (x [B, L, D], pmask [B, L], log_dur [B, L])."""
    pmask = nn.length_mask(phone_lens, phone_ids.shape[1])
    x = _embed_inputs(params, phone_ids, speaker_ids, emotion_ids, cfg)
    for layer in params["encoder"]:
        x = _transformer_layer(layer, x, cfg.n_heads, pmask)
    x = x * pmask[..., None]
    return x, pmask, _var_predictor(params["duration"], x, cfg.var_kernel)


def _durations(log_dur: torch.Tensor, pmask: torch.Tensor,
               cfg: SambertConfig) -> torch.Tensor:
    """clip(round(exp(log_dur) − 1), 1, max_duration) on valid phones, as
    int32 (torch.round, like jnp.round, rounds half to even)."""
    dur = torch.clamp(torch.round(torch.exp(log_dur) - 1.0), 1,
                      cfg.max_duration)
    return (dur * pmask).to(torch.int32)


def _encode_regulate(params: nn.Params, phone_ids: torch.Tensor,
                     phone_lens: torch.Tensor, speaker_ids: torch.Tensor,
                     cfg: SambertConfig, t_mel: int,
                     duration_override: Optional[torch.Tensor],
                     emotion_ids: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor,
                                Dict[str, torch.Tensor]]:
    """Encoder → variance adaptors → length regulation: (frame-aligned
    memory [B, t_mel, D], mel_mask [B, t_mel], aux)."""
    x, pmask, log_dur = _encode(params, phone_ids, phone_lens, speaker_ids,
                                cfg, emotion_ids)
    if duration_override is not None:
        dur = (duration_override * pmask).to(torch.int32)
    else:
        dur = _durations(log_dur, pmask, cfg)

    pitch = _var_predictor(params["pitch"], x, cfg.var_kernel) * pmask
    energy = _var_predictor(params["energy"], x, cfg.var_kernel) * pmask
    x = x + nn.conv1d(params["pitch_embed"], pitch[..., None], padding=(4, 4))
    x = x + nn.conv1d(params["energy_embed"], energy[..., None],
                      padding=(4, 4))

    h, mel_mask = length_regulate(x, dur, t_mel)
    aux = {"durations": dur, "log_duration": log_dur, "pitch": pitch,
           "energy": energy,
           "mel_lens": dur.sum(1).clamp(max=t_mel).to(torch.int32)}
    return h, mel_mask, aux


def _postnet(params: nn.Params, mel: torch.Tensor, mel_mask: torch.Tensor,
             cfg: SambertConfig) -> torch.Tensor:
    r = mel
    pad = ((cfg.postnet_kernel - 1) // 2, cfg.postnet_kernel // 2)
    for i, pn in enumerate(params["postnet"]):
        r = nn.conv1d(pn["conv"], r, padding=pad)
        r = r * pn["norm"]["g"] + pn["norm"]["b"]
        if i < len(params["postnet"]) - 1:
            r = torch.tanh(r)
    return (mel + r) * mel_mask[..., None]


def predict_mel_lens(params: nn.Params, phone_ids: torch.Tensor,
                     phone_lens: torch.Tensor, speaker_ids: torch.Tensor,
                     cfg: SambertConfig,
                     emotion_ids: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Duration probe: encoder + duration head only → mel frame counts [B]
    (the first phase of two-phase synthesis picks a tight t_mel bucket
    from these)."""
    _, pmask, log_dur = _encode(params, phone_ids, phone_lens, speaker_ids,
                                cfg, emotion_ids)
    return _durations(log_dur, pmask, cfg).sum(1).to(torch.int32)


def forward(params: nn.Params, phone_ids: torch.Tensor,
            phone_lens: torch.Tensor, speaker_ids: torch.Tensor,
            cfg: SambertConfig,
            duration_override: Optional[torch.Tensor] = None,
            t_mel: Optional[int] = None,
            emotion_ids: Optional[torch.Tensor] = None
            ) -> Dict[str, torch.Tensor]:
    """NAR fast mode: phone_ids [B, L] (sy-only) or [B, L, 4] (the four
    streams) → mel [B, T_mel, n_mels], T_mel = t_mel or the
    L·frames_per_phone worst case."""
    t_mel = t_mel or phone_ids.shape[1] * cfg.frames_per_phone
    h, mel_mask, aux = _encode_regulate(params, phone_ids, phone_lens,
                                        speaker_ids, cfg, t_mel,
                                        duration_override, emotion_ids)
    h = h + nn.sinusoidal_posenc(t_mel, cfg.d_model, device=h.device,
                                 dtype=h.dtype)[None]
    for layer in params["decoder"]:
        h = _transformer_layer(layer, h, cfg.n_heads, mel_mask)
    mel = nn.linear(params["mel_out"], h)
    return {"mel": _postnet(params, mel, mel_mask, cfg), **aux}


def forward_ar(params: nn.Params, phone_ids: torch.Tensor,
               phone_lens: torch.Tensor, speaker_ids: torch.Tensor,
               cfg: SambertConfig,
               duration_override: Optional[torch.Tensor] = None,
               t_mel: Optional[int] = None,
               emotion_ids: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
    """PNCA AR mode (KAN-TTS Sambert): the same front half, then the mel
    decoded autoregressively in ⌈t_mel / r⌉ steps of r frames."""
    b = phone_ids.shape[0]
    r = cfg.outputs_per_step
    s = -(-(t_mel or phone_ids.shape[1] * cfg.frames_per_phone) // r)
    h, mel_mask, aux = _encode_regulate(params, phone_ids, phone_lens,
                                        speaker_ids, cfg, s * r,
                                        duration_override, emotion_ids)
    memory = h.reshape(b, s, r, cfg.d_model)
    mel = _pnca_scan(params["pnca"], memory, mel_mask, cfg)
    return {"mel": _postnet(params, mel, mel_mask, cfg), **aux}
