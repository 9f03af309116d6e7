"""Streaming Paraformer: chunked online recognition with explicit state.

Port of `toolbox_for_asr_and_tts_tpu/models/paraformer_streaming.py`:

- **cif_step**: one CIF chunk with carried integration state (absolute
  fired-mass offset + partial-token accumulator), written batched over B
  (the reference `vmap`s its single-row form);
- **StreamingFrontend**: raw 16 kHz audio → fbank (kernel K2 on the card)
  → LFR → CMVN, incrementally; LFR and CMVN run on the host over numpy;
- **nar_redecode**: 2-pass partials, a NAR decode of all fired embeddings
  over the bounded encoder memory at buckets of 8 tokens × 64 frames;
- **StreamingRecognizer**: the windowed implementation — the newest chunk
  is encoded with `encoder_lookback` chunks of context by the offline
  `paraformer.encode` (K1 in every layer, masked), and only its rows go on
  to CIF.

The reference's compile caches (`jax.jit` programs keyed by shape) have no
counterpart: PyTorch runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.convert import tree_to
from ..ops import frontend as fe
from ..ops import nn
from . import paraformer


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    chunk_frames: int = 4          # LFR frames per decode chunk (240 ms)
    encoder_lookback: int = 4      # chunks of left context
    max_memory_frames: int = 512   # bounded encoder memory (~30 s)
    max_tokens: int = 64           # static cap on per-utterance tokens
    tokens_per_chunk: int = 8      # static cap on per-chunk fires


def params_device(params: nn.Params) -> torch.device:
    """The device a parameter tree lies on (its first leaf's)."""
    node = params
    while not isinstance(node, torch.Tensor):
        node = next(iter(node.values())) if isinstance(node, dict) else node[0]
    return node.device


# --------------------------------------------------------- streaming CIF
def cif_step(enc_chunk: torch.Tensor, alphas: torch.Tensor,
             mass_offset: torch.Tensor, frame_acc: torch.Tensor, k_cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One CIF chunk with carried state, batched over B.

    enc_chunk [B, T, D]; alphas [B, T]; mass_offset [B]: absolute mass
    already integrated; frame_acc [B, D]: weighted sum accumulated toward the
    current (unfired) token. Returns (embeds [B, k_cap, D], n_fired [B]
    int32, new_mass_offset [B], new_frame_acc [B, D]). Local token k is
    absolute token floor(mass_offset) + k.
    """
    enc = enc_chunk.float()
    k0 = torch.floor(mass_offset)                                # [B]
    c = mass_offset[:, None] + torch.cumsum(alphas.float(), dim=1)  # [B, T]
    lo = torch.cat([mass_offset[:, None], c[:, :-1]], dim=1)
    k = k0[:, None] + torch.arange(k_cap, dtype=torch.float32,
                                   device=enc.device)[None, :]   # [B, K]
    w = torch.minimum(c[:, None, :], k[:, :, None] + 1.0) - \
        torch.maximum(lo[:, None, :], k[:, :, None])
    w = torch.clamp_min(w, 0.0)                                  # [B, K, T]
    embeds = torch.matmul(w, enc)
    embeds[:, 0] += frame_acc          # token 0 continues the partial token
    last = c[:, -1]
    n_fired = torch.clamp_max((torch.floor(last) - k0).int(), k_cap)
    # new partial accumulator: the contribution beyond the last fired
    # boundary; if nothing fired, the old partial continues in embeds[0]
    boundary = torch.floor(last)[:, None]
    w_tail = torch.clamp_min(torch.minimum(c, boundary + 1.0)
                             - torch.maximum(lo, boundary), 0.0)   # [B, T]
    tail = torch.matmul(w_tail[:, None, :], enc)[:, 0]
    new_acc = torch.where((n_fired > 0)[:, None], tail, embeds[:, 0])
    return embeds, n_fired, last, new_acc


# ------------------------------------------------------ streaming frontend
def _lfr_rows(fbank: List[np.ndarray], first: int, stop: int, m: int, n: int
              ) -> np.ndarray:
    """LFR frames first..stop-1 over the fbank frames so far: frame i stacks
    fbank rows i·n − left … i·n − left + m − 1, clamped to the ends."""
    left = (m - 1) // 2
    last = len(fbank) - 1
    return np.stack([np.concatenate([fbank[max(0, min(i * n + j - left, last))]
                                     for j in range(m)])
                     for i in range(first, stop)])


class StreamingFrontend:
    """Raw 16 kHz audio → LFR+CMVN features, incremental.

    Emits LFR frame i when fbank frame 6i+3 is available (the centered LFR
    window needs 3 frames of lookahead), repeating the first frame for left
    context exactly like offline `apply_lfr`. The fbank of the buffered
    audio runs on `device` (kernel K2 on the card), one call per push.
    """

    def __init__(self, cfg: fe.FrontendConfig,
                 cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.cmvn = cmvn
        self.device = resolve_device(device)
        self._audio = np.zeros(0, np.float32)
        self._fbank: List[np.ndarray] = []     # per-frame vectors
        self._lfr_emitted = 0

    def push(self, audio: np.ndarray) -> np.ndarray:
        """Returns newly available LFR+CMVN frames [n_new, lfr_m*n_mels]."""
        cfg = self.cfg
        self._audio = np.concatenate([self._audio,
                                      np.asarray(audio, np.float32)])
        n_frames = fe.num_fbank_frames(len(self._audio), cfg)
        if n_frames > 0:
            x = torch.from_numpy(self._audio[None]).to(self.device)
            fb = fe.fbank(x, cfg).cpu().numpy()[0]
            self._fbank.extend(fb[:n_frames])
            self._audio = self._audio[n_frames * cfg.frame_shift:]
        return self._drain_lfr()

    def push_fbank(self, frames: np.ndarray) -> np.ndarray:
        """Append precomputed fbank frames and drain LFR (the batched
        frontend of `parallel/stream_batcher.py` computes one fbank call
        for all sessions)."""
        if len(frames):
            self._fbank.extend(np.asarray(frames, np.float32))
        return self._drain_lfr()

    def _emit(self, stop: int) -> np.ndarray:
        cfg = self.cfg
        if stop <= self._lfr_emitted:
            return np.zeros((0, cfg.lfr_m * cfg.n_mels), np.float32)
        feats = _lfr_rows(self._fbank, self._lfr_emitted, stop, cfg.lfr_m,
                          cfg.lfr_n)
        self._lfr_emitted = stop
        if self.cmvn is not None:
            feats = (feats + self.cmvn[0]) * self.cmvn[1]
        return feats.astype(np.float32)

    def _drain_lfr(self) -> np.ndarray:
        """Every LFR frame whose highest fbank row (i·n + m − left − 1)
        exists."""
        m, n = self.cfg.lfr_m, self.cfg.lfr_n
        need = m - (m - 1) // 2
        stop = max(0, (len(self._fbank) - need) // n + 1)
        return self._emit(stop)

    def flush(self) -> np.ndarray:
        """Emit the trailing LFR frames that still wait for lookahead, as
        offline `apply_lfr` does: ceil(t_fb / n) frames in all, indices
        clamped to the last fbank frame."""
        return self._emit(fe.num_lfr_frames(len(self._fbank), self.cfg.lfr_n))

    def reset(self) -> None:
        self._audio = np.zeros(0, np.float32)
        self._fbank = []
        self._lfr_emitted = 0


# --------------------------------------------------- shared partial decode
@torch.inference_mode()
def nar_redecode(params, cfg: paraformer.ParaformerConfig,
                 embeds: List[np.ndarray], memory: np.ndarray) -> List[int]:
    """2-pass partials: NAR decode of all accumulated CIF embeddings over
    the bounded encoder memory, on the params' device, padded to buckets of
    8 tokens × 64 memory frames as the reference."""
    if not len(embeds):
        return []
    dev = params_device(params)
    k = 8 * ((len(embeds) + 7) // 8)
    t_mem = 64 * ((max(len(memory), 1) + 63) // 64)
    emb = np.zeros((1, k, cfg.d_model), np.float32)
    emb[0, : len(embeds)] = np.stack(embeds)
    mem = np.zeros((1, t_mem, cfg.d_model), np.float32)
    mem[0, : len(memory)] = memory
    token_mask = nn.length_mask(torch.tensor([len(embeds)], device=dev), k)
    mem_mask = nn.length_mask(torch.tensor([len(memory)], device=dev), t_mem)
    logits = paraformer.decode(params, torch.from_numpy(emb).to(dev),
                               token_mask, torch.from_numpy(mem).to(dev),
                               mem_mask, cfg)
    return torch.argmax(logits[0], dim=-1)[: len(embeds)].tolist()


# ------------------------------------------------------ streaming recognizer
class StreamingRecognizer:
    """Incremental wav → partial/final text over a shared Paraformer."""

    def __init__(self, params, cfg: paraformer.ParaformerConfig,
                 tokenizer, scfg: StreamingConfig = StreamingConfig(),
                 cmvn: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 device: DeviceLike = None):
        """params: a Paraformer tensor tree (moved to `device`); device:
        the card unless "cpu" is passed."""
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.scfg = scfg
        self.tokenizer = tokenizer
        self.frontend = StreamingFrontend(cfg.frontend, cmvn, self.device)
        self.reset()

    # ------------------------------------------------------------ public
    @torch.inference_mode()
    def push_audio(self, audio: np.ndarray) -> str:
        """Feed a chunk; returns the current partial hypothesis."""
        feats = self.frontend.push(audio)
        if len(feats):
            self._feat_queue = np.concatenate([self._feat_queue, feats])
        cf = self.scfg.chunk_frames
        while len(self._feat_queue) >= cf:
            chunk, self._feat_queue = (self._feat_queue[:cf],
                                       self._feat_queue[cf:])
            self._process_chunk(chunk)
        return self.partial_text()

    @torch.inference_mode()
    def _process_chunk(self, chunk: np.ndarray, n_valid: int = -1) -> None:
        """n_valid: valid rows of `chunk` (the rest is finalize padding);
        pad rows neither add CIF mass nor enter the window as keys."""
        cf, lb = self.scfg.chunk_frames, self.scfg.encoder_lookback
        if n_valid < 0:
            n_valid = len(chunk)
        if n_valid == 0:
            return
        self._window = np.concatenate(
            [self._window, chunk[:n_valid]])[-cf * (lb + 1):]
        t_win = cf * (lb + 1)
        padded = np.zeros((1, t_win, self.cfg.input_dim), np.float32)
        padded[0, -len(self._window):] = self._window  # left-pad with zeros
        dev = self.device
        # the window is right-aligned: its first (t − n) frames are zero
        # left-padding and must not serve as attention keys
        mask = (torch.arange(t_win, device=dev)[None, :]
                >= t_win - len(self._window)).float()
        feats = torch.from_numpy(padded).to(dev)
        enc = paraformer.encode(self.params, feats, mask, self.cfg)
        alphas = paraformer.predictor_alphas(self.params, enc, mask, self.cfg)
        # CIF over the last cf rows; with a partial final chunk the first
        # cf − n_valid of those were integrated by earlier chunks
        enc_new, alpha_new = enc[:, -cf:], alphas[:, -cf:]
        if n_valid < cf:
            alpha_new = alpha_new * (torch.arange(cf, device=dev)
                                     >= cf - n_valid)
        embeds, n_fired, self._mass, self._acc = cif_step(
            enc_new, alpha_new, self._mass, self._acc,
            self.scfg.tokens_per_chunk)
        n = int(n_fired[0])
        if n > 0:
            self._embeds.extend(embeds[0, :n].cpu().numpy())
            self._embeds = self._embeds[: self.scfg.max_tokens]
        self._memory = np.concatenate(
            [self._memory, enc[0, -n_valid:].cpu().numpy()]
        )[-self.scfg.max_memory_frames:]

    def _decode_current(self) -> List[int]:
        return nar_redecode(self.params, self.cfg, self._embeds, self._memory)

    def partial_text(self) -> str:
        return self.tokenizer.ids_to_text(self._decode_current())

    @torch.inference_mode()
    def finalize(self) -> str:
        """Drain the frontend LFR lookahead and the partial feature queue,
        then fire any pending partial token mass ≥ (1 − tail)."""
        feats = self.frontend.flush()
        if len(feats):
            self._feat_queue = np.concatenate([self._feat_queue, feats])
        cf = self.scfg.chunk_frames
        while len(self._feat_queue) > 0:
            chunk = self._feat_queue[:cf]
            self._feat_queue = self._feat_queue[cf:]
            n_valid = len(chunk)
            if n_valid < cf:  # zero-pad the last partial chunk through
                pad = np.zeros((cf - n_valid, self.cfg.input_dim), np.float32)
                chunk = np.concatenate([chunk, pad])
            self._process_chunk(chunk, n_valid=n_valid)
        tail = self.cfg.predictor_tail_threshold
        mass = float(self._mass[0])
        frac = mass - np.floor(mass)
        if frac > 0 and frac + tail >= 1.0 and \
                len(self._embeds) < self.scfg.max_tokens:
            self._embeds.append(self._acc[0].cpu().numpy())
        text = self.partial_text()
        self.reset()
        return text

    def reset(self) -> None:
        self.frontend.reset()
        d = self.cfg.d_model
        self._feat_queue = np.zeros((0, self.cfg.input_dim), np.float32)
        self._window = np.zeros((0, self.cfg.input_dim), np.float32)
        self._memory = np.zeros((0, d), np.float32)
        self._mass = torch.zeros((1,), device=self.device)
        self._acc = torch.zeros((1, d), device=self.device)
        self._embeds: List[np.ndarray] = []
