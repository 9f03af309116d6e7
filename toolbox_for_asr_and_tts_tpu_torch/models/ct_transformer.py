"""CT-Transformer punctuation in PyTorch.

Port of `toolbox_for_asr_and_tts_tpu/models/ct_transformer.py` (the model
behind ModelScope `punc_ct-transformer_cn-en-common-vocab471067-large`):

    token embedding × √d_model + posenc (from position 1)
    → SAN-M encoder stack (kernel K1 on the V third of every layer's qkv
      product; layer 0 has no residual when embed_dim != d_model)
    → linear → punctuation-class logits per token.

Classes follow FunASR: 0 <unk>, 1 _ (none), 2 ，, 3 。, 4 ？, 5 、.
`right_context >= 0` bounds how many future tokens a position sees: a
[B, Tq, Tk] delay mask in the attention and a shifted FSMN window.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.convert import tree_to
from ..ops import nn
from ..runtime.bucketing import Bucketer
from ..runtime.graphs import Program, Programs
from ..runtime.metrics import Tally

DEFAULT_PUNC_LIST = ("<unk>", "_", "，", "。", "？", "、")


@dataclasses.dataclass(frozen=True)
class CTTransformerConfig:
    vocab_size: int = 471067
    embed_dim: int = 256
    d_model: int = 512
    n_heads: int = 8
    ffn_dim: int = 2048
    num_layers: int = 12
    kernel_size: int = 11
    sanm_shift: int = 0
    punc_size: int = 6
    punc_list: Tuple[str, ...] = DEFAULT_PUNC_LIST
    # future tokens a position may attend (−1 = unlimited, offline)
    right_context: int = -1

    @classmethod
    def from_funasr(cls, conf: dict, **overrides) -> "CTTransformerConfig":
        """The config from a FunASR checkpoint's own config.yaml
        (`encoder_conf` geometry + `model_conf.punc_list`)."""
        kw = {}
        enc = conf.get("encoder_conf", {}) or {}
        for src, dst in (("attention_heads", "n_heads"),
                         ("linear_units", "ffn_dim"),
                         ("num_blocks", "num_layers"),
                         ("output_size", "d_model"),
                         ("input_size", "embed_dim"),
                         ("kernel_size", "kernel_size"),
                         ("sanm_shift", "sanm_shift")):
            if src in enc:
                kw[dst] = enc[src]
        mc = conf.get("model_conf", {}) or {}
        punc = mc.get("punc_list") or conf.get("punc_list")
        if punc:
            kw["punc_list"] = tuple(punc)
            kw["punc_size"] = len(punc)
        if "vocab_size" in mc:
            kw["vocab_size"] = mc["vocab_size"]
        kw.update(overrides)
        return cls(**kw)

    def fsmn_shift(self) -> int:
        """The SAN-M shift of the FSMN window: with a bounded right context
        the window reads at most right_context future frames."""
        shift = self.sanm_shift
        if self.right_context >= 0:
            half = (self.kernel_size - 1) // 2
            shift = max(shift, half - min(self.right_context, half))
        return shift


def init_params(cfg: CTTransformerConfig, g: torch.Generator) -> nn.Params:
    """Random weights drawn from `g` on its device (the large model's
    embedding is 471067 × 256 f32, so the card draws its own)."""
    layers = []
    for i in range(cfg.num_layers):
        d_in = cfg.embed_dim if i == 0 else cfg.d_model
        layers.append({
            "norm1": nn.layernorm_init(d_in),
            "attn": nn.sanm_attention_init(g, d_in, cfg.d_model, cfg.n_heads,
                                           cfg.kernel_size),
            "norm2": nn.layernorm_init(cfg.d_model),
            "ffn": nn.ffn_init(g, cfg.d_model, cfg.ffn_dim),
        })
    params = {
        "embed": nn.embedding_init(g, cfg.vocab_size, cfg.embed_dim),
        "encoder": {"layers": layers,
                    "after_norm": nn.layernorm_init(cfg.d_model)},
        "out": nn.linear_init(g, cfg.d_model, cfg.punc_size),
    }
    return tree_to(params, g.device)


def constants(t: int, cfg: CTTransformerConfig, device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """The length bucket's device constants: posenc [T, embed_dim] and,
    with a bounded right context, the [T, T] delay pattern."""
    out = {"posenc": nn.sinusoidal_posenc(t, cfg.embed_dim, device=device)}
    if cfg.right_context >= 0:
        q = torch.arange(t, device=device)[:, None]
        k = torch.arange(t, device=device)[None, :]
        out["delay"] = (k <= q + cfg.right_context).float()
    return out


def forward(params: nn.Params, token_ids: torch.Tensor, lengths: torch.Tensor,
            cfg: CTTransformerConfig,
            consts: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
    """token_ids [B, T] int → punctuation logits [B, T, punc_size] f32.
    One K1 launch per layer."""
    t = token_ids.shape[1]
    dev = token_ids.device
    consts = consts or constants(t, cfg, dev)
    mask = nn.length_mask(lengths, t)
    att_mask = None
    if cfg.right_context >= 0:
        # key visible iff valid and k ≤ q + right_context
        att_mask = mask[:, None, :] * consts["delay"][None]
    shift = cfg.fsmn_shift()
    x = nn.embedding(params["embed"], token_ids).float()
    x = x * (cfg.d_model ** 0.5)
    x = x + consts["posenc"][None]
    for i, layer in enumerate(params["encoder"]["layers"]):
        residual = x
        h = nn.layernorm(layer["norm1"], x)
        h = nn.sanm_attention(layer["attn"], h, cfg.n_heads, mask,
                              cfg.kernel_size, shift, att_mask=att_mask)
        x = h if (i == 0 and cfg.embed_dim != cfg.d_model) else residual + h
        x = x + nn.ffn(layer["ffn"], nn.layernorm(layer["norm2"], x))
    x = nn.layernorm(params["encoder"]["after_norm"], x)
    return nn.linear(params["out"], x)


# ---------------------------------------------------------------- service
class PuncVocab:
    """Word/char → id mapping for the punctuation model's own vocab."""

    def __init__(self, tokens: Sequence[str], unk: str = "<unk>"):
        self.tokens = list(tokens)
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        self.unk_id = self.token_to_id.get(unk, 0)

    @classmethod
    def dummy(cls, size: int = 4096) -> "PuncVocab":
        toks = ["<unk>"] + [chr(0x4E00 + i) for i in range(size - 1)]
        return cls(toks)

    @classmethod
    def load(cls, path: str) -> "PuncVocab":
        import json
        if path.endswith(".json"):
            with open(path, encoding="utf-8") as f:
                return cls(json.load(f))
        with open(path, encoding="utf-8") as f:
            return cls([ln.rstrip("\n").split()[0] for ln in f if ln.strip()])

    def encode(self, words: Sequence[str]) -> List[int]:
        return [self.token_to_id.get(w, self.unk_id) for w in words]


def split_words(text: str) -> List[str]:
    """CJK chars as single tokens; latin/digit runs as words."""
    words: List[str] = []
    buf = ""
    for ch in text:
        if ch.isascii() and (ch.isalnum() or ch in "'-"):
            buf += ch
        else:
            if buf:
                words.append(buf)
                buf = ""
            if not ch.isspace():
                words.append(ch)
    if buf:
        words.append(buf)
    return words


class Punctuator:
    """Text → punctuated text on `device` (the card unless "cpu" is
    passed), one forward per (pow-2 batch, length bucket) group."""

    def __init__(self, params, cfg: CTTransformerConfig, vocab: PuncVocab,
                 buckets: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.vocab = vocab
        self.bucketer = Bucketer(tuple(buckets))
        # one program per (batch, length) bucket; on the card a graph
        self._fns = Programs(self.device, "punctuator")
        self.forwards = Tally()   # telemetry: forwards run (K1 per layer)

    @classmethod
    def random(cls, cfg: Optional[CTTransformerConfig] = None, seed: int = 0,
               vocab: Optional[PuncVocab] = None,
               device: DeviceLike = None) -> "Punctuator":
        """Random weights drawn on `device` from `seed` (a card draw and a
        CPU draw of one seed differ; copy `params` to compare devices)."""
        dev = resolve_device(device)
        cfg = cfg or CTTransformerConfig(vocab_size=4096, num_layers=2,
                                         d_model=64, embed_dim=64,
                                         n_heads=2, ffn_dim=128)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
        return cls(params, cfg, vocab or PuncVocab.dummy(cfg.vocab_size),
                   device=dev)

    @classmethod
    def from_model_dir(cls, model_dir: str,
                       cfg: Optional[CTTransformerConfig] = None,
                       device: DeviceLike = None) -> "Punctuator":
        """A `punc_ct-transformer_...-large` checkpoint dir on `device` (the
        card unless "cpu" is passed). With no explicit cfg, geometry comes
        from the dir's own config."""
        import os
        from ..models.convert import params_from_numpy
        from ..runtime import checkpoints as ckpt
        dev = resolve_device(device)
        cfg = cfg or CTTransformerConfig.from_funasr(
            ckpt.load_model_config(model_dir))
        params = ckpt.convert_or_load_cached(
            model_dir, ckpt.shape_template(lambda g: init_params(cfg, g)),
            ckpt.ct_transformer_rules(cfg.num_layers))
        vocab = None
        for cand in ("tokens.json", "tokens.txt"):
            p = os.path.join(model_dir, cand)
            if os.path.exists(p):
                vocab = PuncVocab.load(p)
                break
        return cls(params_from_numpy(params, dev), cfg,
                   vocab or PuncVocab.dummy(cfg.vocab_size), device=dev)

    def _fn(self, b: int, t: int) -> Program:
        """The forward program of one (batch, length) bucket, its constants
        built with it: ids [b, t] int32 and lengths [b] int32 → logits.
        Concurrent first calls build it once (`Programs.get`)."""
        def build():
            consts = constants(t, self.cfg, self.device)
            return ((lambda ids, lens: forward(self.params, ids, lens,
                                               self.cfg, consts)),
                    [((b, t), torch.int32), ((b,), torch.int32)])
        return self._fns.get((b, t), build)

    def _classes(self, arr: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """[B, T] ids and [B] lengths → [B, T] argmax classes on the host."""
        self.forwards.add()
        return self._fn(*arr.shape)(
            arr, lens, read=lambda lg: lg.argmax(dim=-1).cpu().numpy())

    def classify(self, words: Sequence[str]) -> np.ndarray:
        """Per-word punctuation class ids (0 <unk>, 1 none, 2 ，, 3 。, …),
        the raw decision the diarizer uses for sentence boundaries."""
        if not words:
            return np.zeros((0,), np.int64)
        ids = self.vocab.encode(list(words))
        t = self.bucketer.bucket(len(ids))
        arr = np.zeros((1, t), np.int32)
        n = min(len(ids), t)
        arr[0, :n] = ids[:n]
        cls = self._classes(arr, np.asarray([n], np.int32))[0, :n]
        out = np.ones((len(words),), np.int64)
        out[:n] = cls
        return out

    def punctuate(self, text: str) -> str:
        return self.punctuate_many([text])[0]

    def punctuate_many(self, texts: Sequence[str]) -> List[str]:
        """Punctuate a batch of utterances with one forward per (pow-2
        batch, length bucket) group."""
        words_list = [split_words(t) for t in texts]
        out_texts = list(texts)
        groups: Dict[int, list] = {}
        for i, words in enumerate(words_list):
            if not words:
                continue
            ids = self.vocab.encode(words)
            groups.setdefault(self.bucketer.bucket(len(ids)),
                              []).append((i, ids))
        for t, items in sorted(groups.items()):
            b = 1 << max(len(items) - 1, 0).bit_length()  # pow-2 batch
            arr = np.zeros((b, t), np.int32)
            lens = np.zeros((b,), np.int32)
            for r, (i, ids) in enumerate(items):
                n = min(len(ids), t)
                arr[r, :n] = ids[:n]
                lens[r] = n
            cls = self._classes(arr, lens)
            for r, (i, ids) in enumerate(items):
                out_texts[i] = self._render(words_list[i],
                                            cls[r, : int(lens[r])])
        return out_texts

    def _render(self, words, cls_ids) -> str:
        n = len(cls_ids)
        out = []
        for w, c in zip(words[:n], cls_ids):
            out.append(w)
            if c > 1 and int(c) < len(self.cfg.punc_list):
                out.append(self.cfg.punc_list[int(c)])
        out.extend(words[n:])
        # rejoin with latin-aware spacing (split_words dropped whitespace)
        s = ""
        prev_latin = False
        for p in out:
            latin = p[:1].isascii() and p[:1].isalnum()
            if s and prev_latin and latin:
                s += " "
            s += p
            prev_latin = latin
        # sentence-final normalization: ensure terminal punctuation
        if s and s[-1] not in "。？！，、":
            s += "。"
        return s
