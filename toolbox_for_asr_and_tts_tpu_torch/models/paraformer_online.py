"""Chunked online Paraformer encoder, weight-compatible with the
`speech_paraformer-large_..._online` checkpoint.

Port of `toolbox_for_asr_and_tts_tpu/models/paraformer_online.py`. FunASR's
streaming mechanics with chunk_size [c0, c1, c2] = [0, 4, 5] and encoder /
decoder look-back 4 / 1:

- **window**: each step embeds (×√d + continuing sinusoidal PE) the c1 new
  LFR frames behind the cached last c0 + c2 embedded frames: a fixed
  window W = c0 + c2 + c1, zero-initialised;
- **per-layer k/v caches**: queries are the window; keys/values are
  [cached k/v ‖ window k/v], and the cache keeps the newest look_back·c1
  departing window frames (window[0:c1] each step);
- **FSMN memory**: window-local, zero edge pad, no mask — kernel K1 on the
  V third of the qkv product, read in place;
- **CIF**: alphas outside the window's active region [c0, c0+c1) are
  zeroed; integration carries (mass, partial frame) across chunks; finalize
  applies the tail-threshold fire.

State layout. The reference keeps the encoder caches as a list of
`{k, v}` per layer and the decoder's FSMN caches as a list per layer. Here
they are stacked — "k" and "v" [layers, B, H, look_back·c1, dk], "fsmn"
[decoder layers, B, kernel−1, D] — so a ticker's masked merge, row move or
row reset is one op per leaf, not one per layer. Every other leaf has its
batch on dim 0 (`BATCH_DIM`). The functions are pure: they return a new
state dict and never write into the one they are given.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.convert import tree_to
from ..ops import frontend as fe
from ..ops import nn
from ..runtime.graphs import Program, Programs
from . import paraformer
from .paraformer_streaming import StreamingFrontend, cif_step, nar_redecode

State = Dict[str, torch.Tensor]

# batch dim of each state leaf: the stacked per-layer caches hold it on 1
BATCH_DIM = {"k": 1, "v": 1, "fsmn": 1}
DECODER_KEYS = ("fsmn", "hist_len", "mem", "mem_len")


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """FunASR streaming geometry: chunk_size=[c0, c1, c2], look-backs."""
    c0: int = 0                    # left margin inside the window
    c1: int = 4                    # new LFR frames per step (240 ms)
    c2: int = 5                    # lookahead frames (re-encoded next step)
    encoder_look_back: int = 4     # chunks of cached k/v (keys = lb*c1)
    decoder_look_back: int = 1     # chunks of encoder memory for partial decode
    max_memory_frames: int = 512   # bounded NAR re-decode memory
    max_tokens: int = 64           # static per-utterance token cap
    tokens_per_chunk: int = 8      # static per-chunk fire cap

    @property
    def window(self) -> int:
        return self.c0 + self.c2 + self.c1

    @property
    def kv_frames(self) -> int:
        return self.encoder_look_back * self.c1


def batch_dim(key: str) -> int:
    return BATCH_DIM.get(key, 0)


# ------------------------------------------------------------------- state
def init_state(cfg: paraformer.ParaformerConfig, ocfg: OnlineConfig,
               b: int = 1, device: DeviceLike = None) -> State:
    """Zero-initialised streaming state, batched over b streams, on
    `device` (the card unless "cpu" is passed)."""
    dev = resolve_device(device)
    h = cfg.n_heads
    dk = cfg.d_model // h
    kv = (cfg.encoder_layers, b, h, ocfg.kv_frames, dk)
    return {
        "start_idx": torch.zeros((b,), dtype=torch.int32, device=dev),
        "feats": torch.zeros((b, ocfg.c0 + ocfg.c2, cfg.input_dim), device=dev),
        "k": torch.zeros(kv, device=dev),
        "v": torch.zeros(kv, device=dev),
        "kv_len": torch.zeros((b,), dtype=torch.int32, device=dev),
        "cif_mass": torch.zeros((b,), device=dev),
        "cif_acc": torch.zeros((b, cfg.d_model), device=dev),
    }


# ----------------------------------------------------------------- encoder
def _posenc_rows(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal PE for explicit (1-based) positions [B, T] → [B, T, d]."""
    half = d // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32,
                                 device=positions.device)
                    * -(math.log(10000.0) / (half - 1)))
    ang = positions.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).permute(0, 2, 1, 3)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dk = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dk)


def _layer_chunk(layer: nn.Params, x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: torch.Tensor,
                 cfg: paraformer.ParaformerConfig, ocfg: OnlineConfig,
                 first: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One SAN-M encoder layer on the window with cached keys/values.

    x: [B, W, d_in]; k_cache / v_cache: [B, H, L, dk], right-aligned
    (kv_len valid). Returns (layer output [B, W, d], new k cache, new v
    cache)."""
    L, W = ocfg.kv_frames, x.shape[1]
    residual = x
    qkv = nn.linear(layer["attn"]["qkv"], nn.layernorm(layer["norm1"], x))
    q, k, v = qkv.chunk(3, dim=-1)
    # FSMN memory: window-local, zero edge pad, NO mask (FunASR streaming);
    # K1 reads the V third of qkv in place
    mem = nn.fsmn_block(layer["attn"]["fsmn"], v,
                        nn.sanm_pad(cfg.kernel_size, cfg.sanm_shift))
    keys = torch.cat([k_cache, _heads(k, cfg.n_heads)], dim=2)  # [B,H,L+W,dk]
    vals = torch.cat([v_cache, _heads(v, cfg.n_heads)], dim=2)
    # valid keys: the last kv_len cache slots + the whole window
    pos = torch.arange(L + W, device=x.device)[None, :]
    att_mask = (pos >= (L - kv_len)[:, None]).float()[:, None, :]
    out = nn.attend(_heads(q, cfg.n_heads), keys, vals, att_mask)
    att = nn.linear(layer["attn"]["out"], _merge(out)) + mem
    x = att if first else residual + att
    x = x + nn.ffn(layer["ffn"], nn.layernorm(layer["norm2"], x))
    # the window advances c1 frames per step, so window[0:c1] departs: the
    # new cache is the last L of [cache ‖ window[0:c1]], which is the slice
    # [c1, c1 + L) of [cache ‖ window]
    c1 = ocfg.c1
    return x, keys[:, :, c1:c1 + L], vals[:, :, c1:c1 + L]


def encode_chunk(params: nn.Params, state: State, new_feats: torch.Tensor,
                 cfg: paraformer.ParaformerConfig, ocfg: OnlineConfig
                 ) -> Tuple[State, torch.Tensor]:
    """One streaming encoder step.

    new_feats: [B, c1, input_dim] LFR+CMVN frames. Returns (state', window
    encoder output [B, W, d_model])."""
    b, c1, _ = new_feats.shape
    x = new_feats.float() * (cfg.d_model ** 0.5)
    steps = torch.arange(c1, dtype=torch.int32, device=x.device)
    x = x + _posenc_rows(state["start_idx"][:, None] + steps[None, :] + 1,
                         cfg.input_dim)
    window = torch.cat([state["feats"], x], dim=1)          # [B, W, Din]
    h = window
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for i, layer in enumerate(params["encoder"]["layers"]):
        h, k_i, v_i = _layer_chunk(layer, h, state["k"][i], state["v"][i],
                                   state["kv_len"], cfg, ocfg, first=(i == 0))
        ks.append(k_i)
        vs.append(v_i)
    h = nn.layernorm(params["encoder"]["after_norm"], h)
    new_state = dict(state)
    new_state["feats"] = window[:, -(ocfg.c0 + ocfg.c2):]
    new_state["start_idx"] = state["start_idx"] + c1
    new_state["k"] = torch.stack(ks)
    new_state["v"] = torch.stack(vs)
    new_state["kv_len"] = torch.clamp_max(state["kv_len"] + ocfg.c1,
                                          ocfg.kv_frames)
    return new_state, h


def predictor_chunk(params: nn.Params, enc_win: torch.Tensor,
                    active: torch.Tensor, state: State,
                    cfg: paraformer.ParaformerConfig, k_cap: int
                    ) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """CIF over the window's active region with carried integration state.

    active: [B, W] mask of positions whose alphas count this step.
    Returns (state', fired embeds [B, k_cap, d], n_fired [B] int32)."""
    p = params["predictor"]
    lpad = paraformer.predictor_lpad(cfg)
    h = nn.conv1d(p["conv"], enc_win,
                  padding=(lpad, cfg.predictor_kernel - 1 - lpad)) + enc_win
    alphas = torch.sigmoid(nn.linear(p["out"], torch.relu(h)))[..., 0]
    embeds, n_fired, mass, acc = cif_step(enc_win, alphas * active,
                                          state["cif_mass"], state["cif_acc"],
                                          k_cap)
    new_state = dict(state)
    new_state["cif_mass"] = mass
    new_state["cif_acc"] = acc
    return new_state, embeds, n_fired


# ------------------------------------------------- fused device frontend
def fused_buf_len(cfg: paraformer.ParaformerConfig, ocfg: OnlineConfig) -> int:
    """Device audio ring size for `fused_step`: one step consumes A =
    c1·lfr_n·shift samples and the LFR left context reaches left·shift
    samples before the step's first frame."""
    fcfg = cfg.frontend
    left = (fcfg.lfr_m - 1) // 2
    return ocfg.c1 * fcfg.lfr_n * fcfg.frame_shift + left * fcfg.frame_shift


def init_fused_state(cfg: paraformer.ParaformerConfig, ocfg: OnlineConfig,
                     b: int = 1, decode_partials: bool = False,
                     device: DeviceLike = None) -> State:
    dev = resolve_device(device)
    state = init_state(cfg, ocfg, b, dev)
    state["abuf"] = torch.zeros((b, fused_buf_len(cfg, ocfg)), device=dev)
    state["step_idx"] = torch.zeros((b,), dtype=torch.int32, device=dev)
    if decode_partials:
        state.update(init_decoder_state(cfg, ocfg, b, dev))
    return state


def fused_step(params: nn.Params, state: State, new_audio: torch.Tensor,
               cfg: paraformer.ParaformerConfig, ocfg: OnlineConfig,
               cmvn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               k_cap: int = 8, decode_partials: bool = False):
    """One streaming step for B streams: audio → fbank → LFR → CMVN →
    chunked encoder → CIF (→ incremental decode), with the audio tail held
    in the state's ring: `fused_encode`, then (with decode_partials)
    `fused_decode` and the greedy ids.

    new_audio: [B, A] raw samples (A = c1·lfr_n·shift, exactly one encoder
    chunk's worth). Returns (state', fired embeds [B, k_cap, d] bf16,
    n_fired [B][, token ids [B, k_cap]])."""
    new_state, enc, embeds, n = fused_encode(params, state, new_audio, cfg,
                                             ocfg, cmvn, k_cap)
    if not decode_partials:
        return new_state, embeds.to(torch.bfloat16), n
    new_state, logits, new_mask = fused_decode(params, new_state, enc, embeds,
                                               n, cfg, ocfg)
    ids = torch.argmax(logits, dim=-1).int() * new_mask.int()
    return new_state, embeds.to(torch.bfloat16), n, ids


def fused_encode(params: nn.Params, state: State, new_audio: torch.Tensor,
                 cfg: paraformer.ParaformerConfig, ocfg: OnlineConfig,
                 cmvn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 k_cap: int = 8):
    """`fused_step` up to the CIF: returns (state', encoder window [B, W,
    D], fired embeds [B, k_cap, d] f32, n_fired [B]).

    The fbank frames of the ring are kernel K2's function exactly (the
    port's `fe.fbank`, one launch per step); LFR's replicate-first-frame left
    context is reproduced by clamping global fbank indices at 0 (only step 0
    clamps, and frame 0 is still in the ring then), so the features equal
    StreamingFrontend's."""
    fcfg = cfg.frontend
    b, a = new_audio.shape
    m, n_lfr = fcfg.lfr_m, fcfg.lfr_n
    left = (m - 1) // 2
    shift = fcfg.frame_shift
    if a != ocfg.c1 * n_lfr * shift:
        raise ValueError(f"feed exactly one chunk of {ocfg.c1 * n_lfr * shift} "
                         f"samples per row, got {a}")
    ring = state["abuf"]
    keep = left * shift                                    # left context
    buf = torch.cat([ring[:, ring.shape[1] - keep:], new_audio.float()], 1)
    # fbank frames this step: frame k of buf starts at sample shift·k
    n_fb = (ocfg.c1 - 1) * n_lfr + m   # frames needed for c1 LFR outputs
    fb = fe.fbank(buf, fcfg, t_frames=n_fb)                # [B, n_fb, mels]
    # LFR with replicate-first clamping (step 0 only): local fbank index of
    # LFR (j, d) = max(F·s + j·n + d − left, 0) − (F·s − left)
    base = state["step_idx"].long()[:, None, None] * (ocfg.c1 * n_lfr)
    j = torch.arange(ocfg.c1, device=buf.device)[None, :, None]
    d = torch.arange(m, device=buf.device)[None, None, :]
    local = torch.clamp_min(base + j * n_lfr + d - left, 0) - (base - left)
    local = torch.clamp(local, 0, n_fb - 1).reshape(b, -1, 1)
    feats = torch.gather(fb, 1, local.expand(-1, -1, fcfg.n_mels)).reshape(
        b, ocfg.c1, m * fcfg.n_mels)
    if cmvn is not None:
        feats = fe.apply_cmvn(feats, cmvn[0], cmvn[1])
    new_state = dict(state)
    new_state["abuf"] = buf
    new_state["step_idx"] = state["step_idx"] + 1
    new_state, enc = encode_chunk(params, new_state, feats, cfg, ocfg)
    active = torch.zeros((b, ocfg.window), device=buf.device)
    active[:, ocfg.c0: ocfg.c0 + ocfg.c1] = 1.0
    new_state, embeds, n = predictor_chunk(params, enc, active, new_state,
                                           cfg, k_cap)
    return new_state, enc, embeds, n


def fused_decode(params: nn.Params, state: State, enc: torch.Tensor,
                 embeds: torch.Tensor, n: torch.Tensor,
                 cfg: paraformer.ParaformerConfig, ocfg: OnlineConfig
                 ) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """`fused_step`'s partials after `fused_encode`: push the step's settled
    frames into the decoder memory ring and decode the fired tokens
    incrementally (state from init_fused_state(..., decode_partials=True)).
    Returns (state', logits [B, k_cap, vocab], token mask [B, k_cap])."""
    dstate = {k: state[k] for k in DECODER_KEYS}
    settled = enc[:, ocfg.c0: ocfg.c0 + ocfg.c1]
    dstate = decoder_push_memory(
        dstate, settled, torch.full((enc.shape[0],), ocfg.c1,
                                    dtype=torch.int32, device=enc.device))
    dstate, logits, new_mask = decode_chunk_logits(params, dstate, embeds, n,
                                                   cfg)
    new_state = dict(state)
    new_state.update(dstate)
    return new_state, logits, new_mask


# ------------------------------------------------- incremental NAR decoder
def init_decoder_state(cfg: paraformer.ParaformerConfig, ocfg: OnlineConfig,
                       b: int = 1, device: DeviceLike = None) -> State:
    """FunASR-style streaming decoder caches: per-layer FSMN token history
    (the last kernel−1 post-norm2 hiddens, stacked over layers) and a
    bounded encoder-memory ring of the last decoder_look_back·c1 + window
    settled frames."""
    dev = resolve_device(device)
    kc = cfg.kernel_size - 1
    mem = ocfg.decoder_look_back * ocfg.c1 + ocfg.window
    return {
        "fsmn": torch.zeros((cfg.decoder_layers, b, kc, cfg.d_model),
                            device=dev),
        "hist_len": torch.zeros((b,), dtype=torch.int32, device=dev),
        "mem": torch.zeros((b, mem, cfg.d_model), device=dev),
        "mem_len": torch.zeros((b,), dtype=torch.int32, device=dev),
    }


def decoder_push_memory(dstate: State, enc_frames: torch.Tensor,
                        n_valid: torch.Tensor) -> State:
    """Append settled encoder frames to the bounded cross-attention ring.

    enc_frames: [B, F, D]; n_valid: [B] valid rows of enc_frames (usually
    F)."""
    m = dstate["mem"].shape[1]
    out = dict(dstate)
    out["mem"] = torch.cat([dstate["mem"], enc_frames.float()], dim=1)[:, -m:]
    out["mem_len"] = torch.clamp_max(dstate["mem_len"] + n_valid, m)
    return out


def decode_chunk_logits(params: nn.Params, dstate: State,
                        new_embeds: torch.Tensor, n_new: torch.Tensor,
                        cfg: paraformer.ParaformerConfig
                        ) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """Incrementally decode newly fired CIF tokens (FunASR's streaming
    decoder: per-layer FSMN caches + bounded cross-attention).

    new_embeds: [B, K, D] (K static cap); n_new: [B] fired this chunk.
    Returns (dstate', logits [B, K, vocab], token mask [B, K]). The FSMN's
    future taps see zeros (future tokens unknown), as FunASR's online
    decode."""
    b, k, d = new_embeds.shape
    dev = new_embeds.device
    kc = cfg.kernel_size - 1
    left = (cfg.kernel_size - 1) // 2 + cfg.sanm_shift
    new_mask = nn.length_mask(n_new, k)
    x = new_embeds.float() * new_mask[..., None]
    # the ring keeps valid frames RIGHT-aligned: mask the left zero rows
    m_ring = dstate["mem"].shape[1]
    mem_mask = (torch.arange(m_ring, device=dev)[None, :]
                >= (m_ring - dstate["mem_len"])[:, None]).float()
    # valid history of the FSMN caches (right-aligned), then the new tokens
    hist = torch.clamp_max(dstate["hist_len"], kc)
    cmask = (torch.arange(kc, device=dev)[None, :] >= kc - hist[:, None])
    seq_mask = torch.cat([cmask.float(), new_mask], dim=1)[..., None]
    # cache roll: the last kc hiddens of [cache ‖ new valid tokens], i.e.
    # rows n_new … n_new + kc − 1, clamped (a static-shape gather)
    roll = torch.clamp_max(torch.arange(kc, device=dev)[None, :]
                           + n_new[:, None], kc + k - 1).long()
    roll = roll[..., None].expand(-1, -1, d)
    new_fsmn = []
    for li, layer in enumerate(params["decoder"]["layers"]):
        residual = x
        h = nn.dec_ffn(layer["ffn"], nn.layernorm(layer["norm1"], x))
        h = nn.layernorm(layer["norm2"], h) * new_mask[..., None]
        seq = torch.cat([dstate["fsmn"][li], h], dim=1)       # [B, kc+K, D]
        # depthwise conv over [cache ‖ new] with a right zero pad only; new
        # token i's window lands at output row kc + i − left (a stock conv:
        # the residual row differs from K1's)
        conv = nn.conv1d({"w": layer["fsmn"]["w"]}, seq * seq_mask,
                         padding=(0, cfg.kernel_size - 1 - left), groups=d)
        conv = conv[:, kc - left: kc - left + k]
        x = residual + (conv + h) * new_mask[..., None]
        x = x + nn.cross_attention(layer["src_attn"],
                                   nn.layernorm(layer["norm3"], x),
                                   dstate["mem"], cfg.n_heads, mem_mask)
        new_fsmn.append(torch.gather(seq, 1, roll))
    fin = params["decoder"]["final"]
    x = nn.dec_ffn(fin["ffn"], nn.layernorm(fin["norm1"], x))
    x = nn.layernorm(params["decoder"]["after_norm"], x)
    logits = nn.linear(params["decoder"]["out"], x)
    out = dict(dstate)
    out["fsmn"] = torch.stack(new_fsmn)
    out["hist_len"] = dstate["hist_len"] + n_new
    return out, logits, new_mask


def decode_chunk(params: nn.Params, dstate: State, new_embeds: torch.Tensor,
                 n_new: torch.Tensor, cfg: paraformer.ParaformerConfig
                 ) -> Tuple[State, torch.Tensor]:
    """`decode_chunk_logits`, then greedy ids [B, K] int32 (0 past n_new)."""
    out, logits, new_mask = decode_chunk_logits(params, dstate, new_embeds,
                                                n_new, cfg)
    ids = torch.argmax(logits, dim=-1).int() * new_mask.int()
    return out, ids


def flush_tail(state: State, tail_threshold: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final tail fire (FunASR forward_chunk is_final): a virtual frame with
    α = tail_threshold and zero hidden. Returns (embed [B, d], fired [B])."""
    frac = state["cif_mass"] - torch.floor(state["cif_mass"])
    fired = (frac + tail_threshold >= 1.0) & (frac > 0)
    return state["cif_acc"], fired


# ------------------------------------------------------------- recognizer
class OnlineRecognizer:
    """Incremental wav → partial/final text with FunASR streaming
    mechanics, one session, on the card unless `device="cpu"`.

    The encoder + CIF step and the incremental decode are programs
    (`runtime/graphs.py`; the reference's `_step_fn` / `_inc_fn`): the
    session's state goes in by copy and comes back out, so one `Programs`
    owner (`programs=`) can serve many sessions, as the reference's shared
    `fns` dict does for the hub's overflow sessions."""

    def __init__(self, params, cfg: paraformer.ParaformerConfig, tokenizer,
                 ocfg: OnlineConfig = OnlineConfig(),
                 cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 partial_mode: str = "redecode", device: DeviceLike = None,
                 programs: Optional[Programs] = None):
        """partial_mode: "redecode" (NAR re-decode of all fired tokens over
        the bounded memory, O(K²) per utterance, converges) or "incremental"
        (FunASR-style fsmn-cached `decode_chunk`, each token decoded once
        with its chunk-time context). params: a Paraformer tensor tree,
        moved to `device`. programs: a program cache shared by sessions
        over the same weights and geometry (a new one otherwise)."""
        if partial_mode not in ("redecode", "incremental"):
            raise ValueError(f"unknown partial_mode {partial_mode!r}")
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.ocfg = ocfg
        self.tokenizer = tokenizer
        self.partial_mode = partial_mode
        self.frontend = StreamingFrontend(cfg.frontend, cmvn, self.device)
        self.programs = (programs if programs is not None
                         else Programs(self.device, "online"))
        self.reset()

    # ---------------------------------------------------------- programs
    def _step_fn(self) -> Program:
        """Encoder + CIF over one chunk: (feats [1, c1, D], active [1, W],
        state leaves) → (state leaves', enc window, embeds, n_fired)."""
        keys = sorted(self._state)

        def build():
            k_cap = self.ocfg.tokens_per_chunk

            def run(feats, active, *leaves):
                state, enc = encode_chunk(self.params,
                                          dict(zip(keys, leaves)), feats,
                                          self.cfg, self.ocfg)
                state, embeds, n = predictor_chunk(self.params, enc, active,
                                                   state, self.cfg, k_cap)
                return [state[k] for k in keys], enc, embeds, n
            return run, ([((1, self.ocfg.c1, self.cfg.input_dim),
                           torch.float32),
                          ((1, self.ocfg.window), torch.float32)]
                         + [(tuple(self._state[k].shape), self._state[k].dtype)
                            for k in keys])
        return self.programs.get(("step", tuple(keys)), build)

    def _inc_fn(self) -> Program:
        """The incremental decode: (embeds [1, k_cap, d], n [1], decoder
        state leaves) → (decoder state leaves', ids [1, k_cap])."""
        def build():
            def run(embeds, n, *leaves):
                d, ids = decode_chunk(self.params,
                                      dict(zip(DECODER_KEYS, leaves)),
                                      embeds, n, self.cfg)
                return [d[k] for k in DECODER_KEYS], ids
            return run, ([((1, self.ocfg.tokens_per_chunk, self.cfg.d_model),
                           torch.float32), ((1,), torch.int32)]
                         + [(tuple(self._dstate[k].shape),
                             self._dstate[k].dtype) for k in DECODER_KEYS])
        return self.programs.get(("inc",), build)

    # ------------------------------------------------------------ public
    @torch.inference_mode()
    def push_audio(self, audio: np.ndarray) -> str:
        feats = self.frontend.push(audio)
        if len(feats):
            self._feat_queue = np.concatenate([self._feat_queue, feats])
        c1 = self.ocfg.c1
        while len(self._feat_queue) >= c1:
            chunk, self._feat_queue = (self._feat_queue[:c1],
                                       self._feat_queue[c1:])
            self._run_chunk(chunk, n_valid=c1, final=False)
        return self.partial_text()

    def _active_mask(self, n_valid: int, final: bool) -> np.ndarray:
        ocfg = self.ocfg
        active = np.zeros((1, ocfg.window), np.float32)
        if final:
            # drain: the cached lookahead frames + all valid new frames
            active[0, ocfg.c0: ocfg.c0 + ocfg.c2 + n_valid] = 1.0
        else:
            active[0, ocfg.c0: ocfg.c0 + ocfg.c1] = 1.0
        return active

    @torch.inference_mode()
    def _run_chunk(self, chunk: np.ndarray, n_valid: int, final: bool) -> None:
        ocfg = self.ocfg
        padded = np.zeros((1, ocfg.c1, self.cfg.input_dim), np.float32)
        padded[0, :len(chunk)] = chunk
        keys = sorted(self._state)
        leaves, enc, embeds, n_fired = self._step_fn()(
            padded, self._active_mask(n_valid, final),
            *(self._state[k] for k in keys))
        self._state = dict(zip(keys, leaves))
        n = int(n_fired[0])
        if n > 0:
            self._embeds.extend(embeds[0, :n].cpu().numpy())
            self._embeds = self._embeds[: ocfg.max_tokens]
        # settled frames for the decoder memory: this window's active
        # region (each frame enters exactly once)
        hi = ocfg.c0 + (ocfg.c2 + n_valid if final else ocfg.c1)
        settled = enc[:, ocfg.c0: hi]
        self._memory = np.concatenate(
            [self._memory, settled[0].cpu().numpy()])[-ocfg.max_memory_frames:]
        if self.partial_mode == "incremental":
            self._dstate = decoder_push_memory(
                self._dstate, settled,
                torch.full((1,), settled.shape[1], dtype=torch.int32,
                           device=self.device))
            if n > 0:
                self._decode_incremental(embeds, n)

    @torch.inference_mode()
    def _decode_incremental(self, embeds: torch.Tensor, n: int) -> None:
        leaves, ids = self._inc_fn()(
            embeds, np.array([n], np.int32),
            *(self._dstate[k] for k in DECODER_KEYS))
        self._dstate = dict(zip(DECODER_KEYS, leaves))
        self._inc_ids.extend(ids[0, :n].tolist())

    def _decode_current(self) -> List[int]:
        return nar_redecode(self.params, self.cfg, self._embeds, self._memory)

    def partial_text(self) -> str:
        if self.partial_mode == "incremental":
            return self.tokenizer.ids_to_text(self._inc_ids)
        return self.tokenizer.ids_to_text(self._decode_current())

    @torch.inference_mode()
    def finalize(self) -> str:
        """Drain the frontend lookahead, the partial feature queue and the
        encoder lookahead, then apply the tail-threshold fire."""
        feats = self.frontend.flush()
        if len(feats):
            self._feat_queue = np.concatenate([self._feat_queue, feats])
        c1 = self.ocfg.c1
        while len(self._feat_queue) > c1:
            chunk, self._feat_queue = (self._feat_queue[:c1],
                                       self._feat_queue[c1:])
            self._run_chunk(chunk, n_valid=c1, final=False)
        # the final (possibly partial) chunk drains the cached lookahead too
        self._run_chunk(self._feat_queue, n_valid=len(self._feat_queue),
                        final=True)
        self._feat_queue = np.zeros((0, self.cfg.input_dim), np.float32)
        acc, fired = flush_tail(self._state, self.cfg.predictor_tail_threshold)
        if bool(fired[0]) and len(self._embeds) < self.ocfg.max_tokens:
            self._embeds.append(acc[0].cpu().numpy())
            if self.partial_mode == "incremental":
                buf = torch.zeros((1, self.ocfg.tokens_per_chunk,
                                   self.cfg.d_model), device=self.device)
                buf[0, 0] = acc[0]
                self._decode_incremental(buf, 1)
        text = self.partial_text()
        self.reset()
        return text

    def reset(self) -> None:
        self.frontend.reset()
        self._feat_queue = np.zeros((0, self.cfg.input_dim), np.float32)
        self._state = init_state(self.cfg, self.ocfg, 1, self.device)
        self._dstate = init_decoder_state(self.cfg, self.ocfg, 1, self.device)
        self._inc_ids: List[int] = []
        self._embeds: List[np.ndarray] = []
        self._memory = np.zeros((0, self.cfg.d_model), np.float32)
