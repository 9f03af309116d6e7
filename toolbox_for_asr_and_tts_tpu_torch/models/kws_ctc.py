"""Char-CTC keyword spotting (wake word) in PyTorch.

Port of `toolbox_for_asr_and_tts_tpu/models/kws_ctc.py` (the capability
behind ModelScope `speech_charctc_kws_phone-xiaohu`):

    fbank80 (kernel K2) → LFR 3/3 → affine in1 → affine in2 → ReLU
    → N × [proj (no bias) → FSMN (lorder past + rorder future taps, +res;
           kernel K1) → affine → ReLU]
    → affine out1 → affine out2 → CTC log-probs (blank at 0)

The left and right FSMN taps stay separate leaves (`w`, `wr`) as in the
reference's tree and are concatenated into one depthwise kernel spanning
[t − lorder + 1, t + rorder]. Detection scores the keyword's labels with
the CTC forward recursion — a loop over frames, vectorised over the batch
— as length-normalized log-odds against the blank-only path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.convert import tree_to
from ..ops import frontend as fe
from ..ops import nn
from ..ops.frontend import FrontendConfig
from ..runtime.graphs import Program, Programs
from ..runtime.metrics import Tally

NEG = -1e30   # log-zero of the CTC recursion, as the reference


@dataclasses.dataclass(frozen=True)
class KwsConfig:
    input_dim: int = 240          # 80 mel × LFR m=3
    input_affine_dim: int = 140
    hidden_dim: int = 128         # FunASR `linear_dim`
    proj_dim: int = 64
    num_layers: int = 4           # FunASR `fsmn_layers`
    lorder: int = 10
    rorder: int = 2               # future frames (conv_right)
    output_affine_dim: int = 140
    vocab_size: int = 2600        # chars (+ blank at 0); FunASR `output_dim`
    blank_id: int = 0

    @property
    def frontend(self) -> FrontendConfig:
        return FrontendConfig(lfr_m=3, lfr_n=3)

    @classmethod
    def from_funasr(cls, conf: dict, **overrides) -> "KwsConfig":
        """The config from the checkpoint's own config.yaml (FunASR FSMN
        encoder_conf)."""
        enc = conf.get("encoder_conf", {}) or {}
        kw = {}
        for srcs, dst in ((("input_dim",), "input_dim"),
                          (("input_affine_dim",), "input_affine_dim"),
                          (("linear_dim",), "hidden_dim"),
                          (("proj_dim",), "proj_dim"),
                          (("fsmn_layers", "fsmn_layer_num"), "num_layers"),
                          (("lorder",), "lorder"),
                          (("rorder",), "rorder"),
                          (("output_affine_dim",), "output_affine_dim"),
                          (("output_dim",), "vocab_size")):
            for s in srcs:
                if s in enc:
                    kw[dst] = enc[s]
                    break
        kw.update(overrides)
        return cls(**kw)


def init_params(cfg: KwsConfig, g: torch.Generator) -> nn.Params:
    """Random weights drawn from `g` on its device."""
    p = {
        "in1": nn.linear_init(g, cfg.input_dim, cfg.input_affine_dim),
        "in2": nn.linear_init(g, cfg.input_affine_dim, cfg.hidden_dim),
        "blocks": [],
        "out1": nn.linear_init(g, cfg.hidden_dim, cfg.output_affine_dim),
        "out2": nn.linear_init(g, cfg.output_affine_dim, cfg.vocab_size),
    }
    for _ in range(cfg.num_layers):
        fsmn = nn.fsmn_block_init(g, cfg.proj_dim, cfg.lorder)
        if cfg.rorder > 0:
            fsmn["wr"] = nn._normal(g, (cfg.proj_dim, 1, cfg.rorder)) * 0.02
        p["blocks"].append({
            "proj": nn.linear_init(g, cfg.hidden_dim, cfg.proj_dim,
                                   bias=False),
            "fsmn": fsmn,
            "affine": nn.linear_init(g, cfg.proj_dim, cfg.hidden_dim),
        })
    return p


def _fsmn_kernel(f: nn.Params) -> nn.Params:
    """Left taps ‖ right taps: [t−lorder+1 .. t+rorder] (torch conv_right
    starts at t+1, right after conv_left's last tap)."""
    if "wr" in f:
        return {"w": torch.cat([f["w"], f["wr"]], dim=-1)}
    return f


def forward(params: nn.Params, feats: torch.Tensor, cfg: KwsConfig
            ) -> torch.Tensor:
    """feats [B, T, input_dim] → CTC log-probs [B, T, vocab]; one K1 launch
    per FSMN layer."""
    x = nn.relu(nn.linear(params["in2"], nn.linear(params["in1"], feats)))
    pad = nn.fsmn_pad(cfg.lorder, cfg.rorder)
    for blk in params["blocks"]:
        h = nn.linear(blk["proj"], x)
        h = nn.fsmn_block(_fsmn_kernel(blk["fsmn"]), h, pad)
        x = nn.relu(nn.linear(blk["affine"], h))
    return nn.log_softmax(
        nn.linear(params["out2"], nn.linear(params["out1"], x)), dim=-1)


def ctc_forward_score(logp: torch.Tensor, labels: torch.Tensor,
                      label_len: int, frame_len, blank_id: int = 0
                      ) -> torch.Tensor:
    """log P(labels | logp) under CTC, for a batch.

    logp [B, T, V] (or [T, V]); labels [L_max] padded ids; label_len the
    keyword's length; frame_len valid frames (int, or [B]): frames past it
    leave alpha unchanged. The recursion runs over the blank-interleaved
    sequence of 2·L_max + 1 states, one step per frame."""
    single = logp.dim() == 2
    if single:
        logp = logp[None]
    b, t_max, _ = logp.shape
    dev = logp.device
    l_max = labels.shape[0]
    s = 2 * l_max + 1
    ext = torch.full((s,), blank_id, dtype=torch.long, device=dev)
    ext[1::2] = labels.long()
    pos = torch.arange(s, device=dev)
    valid_s = pos < (2 * label_len + 1)
    # skip s-2 → s when ext[s] is a label unlike ext[s-2]
    diff = torch.cat([torch.ones(2, dtype=torch.bool, device=dev),
                      ext[2:] != ext[:-2]])
    can_skip = (pos % 2 == 1) & (pos >= 2) & diff
    frame_len = torch.as_tensor(frame_len, device=dev).reshape(-1)
    emit = logp.float()[:, :, ext]                       # [B, T, S]
    neg = torch.full((b, 1), NEG, device=dev)
    alpha = torch.full((b, s), NEG, device=dev)
    alpha[:, 0] = emit[:, 0, 0]
    if label_len > 0:
        alpha[:, 1] = emit[:, 0, 1]
    for t in range(1, t_max):
        prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg, neg, alpha[:, :-2]], dim=1)
        prev2 = torch.where(can_skip, prev2, NEG)
        a = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        a = torch.where(valid_s, a + emit[:, t], NEG)
        alpha = torch.where((t < frame_len)[:, None], a, alpha)
    last = 2 * label_len
    out = torch.logaddexp(alpha[:, last], alpha[:, max(last - 1, 0)])
    return out[0] if single else out


def kws_score(logp: torch.Tensor, labels: torch.Tensor, label_len: int,
              frame_len, blank_id: int = 0) -> torch.Tensor:
    """Length-normalized keyword log-odds: (log P(kw) − log P(blank-only))
    / L, for logp [B, T, V] (or [T, V])."""
    kw = ctc_forward_score(logp, labels, label_len, frame_len, blank_id)
    lp = logp if logp.dim() == 3 else logp[None]
    frame_len = torch.as_tensor(frame_len, device=lp.device).reshape(-1)
    t = torch.arange(lp.shape[1], device=lp.device)
    blank = torch.where(t[None] < frame_len[:, None],
                        lp[..., blank_id].float(), 0.0).sum(dim=1)
    if logp.dim() == 2:
        blank = blank[0]
    return (kw - blank) / max(float(label_len), 1.0)


class KeywordSpotter:
    """Windowed wake-word detector (the 1600 ms FIFO window) on `device`,
    the card unless "cpu" is passed."""

    def __init__(self, params, cfg: KwsConfig, char_to_id: Dict[str, int],
                 keyword: str = "小护", threshold: float = 2.0,
                 max_label_len: int = 8, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.char_to_id = char_to_id
        self.threshold = threshold
        self.max_label_len = max_label_len
        # one program per (pow-2 batch, window, keyword); on the card a graph
        self.programs = Programs(self.device, "kws")
        # telemetry: DFSMN forwards run (K1 per layer) and fbanks (K2 once)
        self.forwards = Tally()
        self.fbanks = Tally()
        self.set_keyword(keyword)

    @classmethod
    def random(cls, cfg: Optional[KwsConfig] = None, seed: int = 0,
               keyword: str = "小护", device: DeviceLike = None,
               **kw) -> "KeywordSpotter":
        """Random weights drawn on the CPU from `seed`, then moved."""
        dev = resolve_device(device)
        cfg = cfg or KwsConfig(vocab_size=64, hidden_dim=32, proj_dim=16,
                               num_layers=2)
        params = init_params(cfg, torch.Generator().manual_seed(seed))
        chars = {chr(0x4E00 + i): i + 1 for i in range(cfg.vocab_size - 1)}
        chars.setdefault("小", 1)
        chars.setdefault("护", 2)
        return cls(params, cfg, chars, keyword=keyword, device=dev, **kw)

    @classmethod
    def from_model_dir(cls, model_dir: str, cfg: Optional[KwsConfig] = None,
                       keyword: str = "小护", device: DeviceLike = None,
                       **kw) -> "KeywordSpotter":
        """A `speech_charctc_kws_phone-xiaohu` checkpoint dir on `device`
        (the card unless "cpu" is passed). With no explicit cfg, geometry
        comes from the dir's own config; the token list from tokens.json,
        tokens.txt or keywords.txt, the first found."""
        import os
        from ..runtime import checkpoints as ckpt
        from .convert import params_from_numpy
        dev = resolve_device(device)
        cfg = cfg or KwsConfig.from_funasr(ckpt.load_model_config(model_dir))
        params = ckpt.convert_or_load_cached(
            model_dir, ckpt.shape_template(lambda g: init_params(cfg, g)),
            ckpt.kws_rules(cfg.num_layers, cfg.rorder))
        chars: Dict[str, int] = {}
        for cand in ("tokens.json", "tokens.txt", "keywords.txt"):
            p = os.path.join(model_dir, cand)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    toks = [ln.rstrip("\n").split()[0] for ln in f
                            if ln.strip()]
                chars = {t: i for i, t in enumerate(toks)}
                break
        if not chars:
            chars = {chr(0x4E00 + i): i + 1 for i in range(cfg.vocab_size - 1)}
        return cls(params_from_numpy(params, dev), cfg, chars,
                   keyword=keyword, device=dev, **kw)

    def set_keyword(self, keyword: str) -> None:
        """Refuses characters outside the vocabulary: aliasing them to the
        CTC blank would make the keyword unreachable."""
        missing = [c for c in keyword if c not in self.char_to_id]
        if missing:
            raise ValueError(
                f"keyword {keyword!r} has characters outside the KWS "
                f"vocabulary: {missing} — choose in-vocab characters or "
                f"retrain/extend tokens.txt")
        ids = [self.char_to_id[c] for c in keyword]
        arr = np.zeros((self.max_label_len,), np.int64)
        arr[: len(ids)] = ids[: self.max_label_len]
        self.keyword = keyword
        self._labels = torch.from_numpy(arr).to(self.device)
        self._label_len = min(len(ids), self.max_label_len)

    def _score(self, feats: torch.Tensor, frame_len, labels: torch.Tensor,
               label_len: int) -> torch.Tensor:
        logp = forward(self.params, feats, self.cfg)
        return kws_score(logp, labels, label_len, frame_len,
                         self.cfg.blank_id)

    @torch.inference_mode()
    def _score_feats(self, feats: torch.Tensor, frame_len) -> torch.Tensor:
        self.forwards.add()
        return self._score(feats, frame_len, self._labels, self._label_len)

    def detect_feats(self, feats: np.ndarray, valid_frames: int
                     ) -> Tuple[bool, float]:
        """feats [T, input_dim] window features → (detected, score)."""
        x = torch.from_numpy(np.asarray(feats, np.float32)[None]).to(self.device)
        score = float(self._score_feats(x, valid_frames)[0])
        return score > self.threshold, score

    def _batch_fn(self, nb: int, window_len: int) -> Program:
        """The scorer of one (pow-2 batch, window length) group and the
        current keyword (ref `_fn`): [nb, window_len] audio → [nb] keyword
        log-odds through fbank (one K2 launch) → LFR → the DFSMN (one K1
        launch per layer) → CTC. Concurrent first calls build it once
        (`Programs.get`)."""
        def build():
            fcfg = self.cfg.frontend
            t_fb = fe.num_fbank_frames(window_len, fcfg)
            t_lfr = fe.num_lfr_frames(t_fb, fcfg.lfr_n)
            labels, label_len = self._labels, self._label_len
            frame_len = torch.full((1,), t_lfr, dtype=torch.long,
                                   device=self.device)

            def run(wavs: torch.Tensor) -> torch.Tensor:
                feats = fe.fbank(wavs, fcfg, t_frames=t_fb)
                feats = fe.apply_lfr(feats, fcfg.lfr_m, fcfg.lfr_n,
                                     t_out=t_lfr)
                return self._score(feats, frame_len, labels, label_len)
            return run, [((nb, window_len), torch.float32)]
        return self.programs.get(("audio_batch", nb, window_len,
                                  self.keyword), build)

    def detect_audio(self, window: np.ndarray) -> Tuple[bool, float]:
        """Raw 16 kHz window → (detected, score): the batched scorer on a
        batch of one."""
        return self.detect_audio_batch([window])[0]

    def detect_audio_batch(self, windows) -> list:
        """Score many windows with one scorer run per (pow-2 batch, length)
        group; returns [(detected, score), …] aligned with the input."""
        if not windows:
            return []
        out: list = [None] * len(windows)
        by_len: Dict[int, list] = {}
        for i, w in enumerate(windows):
            by_len.setdefault(len(w), []).append(i)
        for length, idxs in by_len.items():
            nb = 1 << (len(idxs) - 1).bit_length()
            batch = np.zeros((nb, length), np.float32)
            for j, i in enumerate(idxs):
                batch[j] = windows[i]
            self.fbanks.add()
            self.forwards.add()
            scores = self._batch_fn(nb, length)(
                batch, read=lambda t: t.cpu().numpy())
            for j, i in enumerate(idxs):
                s = float(scores[j])
                out[i] = (s > self.threshold, s)
        return out

    def warm(self, max_batch: int = 64,
             window_len: int = int(1.6 * 16000)) -> None:
        """Build the program of every pow-2 batch of the standard 1600 ms
        window (on the card: capture it), so no wake-mode tick waits on a
        build."""
        nb = 1
        while nb <= max_batch:
            self._batch_fn(nb, window_len)
            nb *= 2
