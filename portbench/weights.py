"""Inputs the benchmark makes from `--seed`: weights, CMVN and audio; and the
tokenizer it hands the program.

Everything is drawn on the device with one `torch.Generator` there, in a few
large calls, so set-up costs no host-side initialisation and the same seed
gives the same numbers on every run. Both the program and the reference get
what these functions return; neither makes its own.

The parameter tree is the FunASR Paraformer checkpoint layout (the plain
dict the program loads from a converted checkpoint): linear `w` [in, out],
conv weights (O, I/g, K), FSMN taps [D, 1, K]. Distributions follow the
common initialisation of those layers: linear and conv uniform in ±1/√fan_in,
FSMN taps N(0, 0.02²), layer norms at gain 1 and bias 0.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# (path, shape, kind, scale); kind: "u" uniform ±scale, "n" normal·scale,
# "one", "zero"
Leaf = Tuple[Tuple[Any, ...], Tuple[int, ...], str, float]


def _ln(path, d) -> List[Leaf]:
    return [(path + ("g",), (d,), "one", 0.0), (path + ("b",), (d,), "zero", 0.0)]


def _lin(path, d_in, d_out, bias=True) -> List[Leaf]:
    s = 1.0 / math.sqrt(d_in)
    out = [(path + ("w",), (d_in, d_out), "u", s)]
    return out + [(path + ("b",), (d_out,), "u", s)] if bias else out


def paraformer_leaves(m: Dict[str, Any]) -> List[Leaf]:
    """Every leaf of a Paraformer tree of config `m` (the model keys of a
    `portbench/configs/*.json`)."""
    d, f, k = m["d_model"], m["ffn_dim"], m["kernel_size"]
    out: List[Leaf] = []
    for i in range(m["encoder_layers"]):
        p = ("encoder", "layers", i)
        d_in = m["input_dim"] if i == 0 else d
        out += _ln(p + ("norm1",), d_in)
        out += _lin(p + ("attn", "qkv"), d_in, 3 * d)
        out += _lin(p + ("attn", "out"), d, d)
        out.append((p + ("attn", "fsmn", "w"), (d, 1, k), "n", 0.02))
        out += _ln(p + ("norm2",), d)
        out += _lin(p + ("ffn", "w1"), d, f) + _lin(p + ("ffn", "w2"), f, d)
    out += _ln(("encoder", "after_norm"), d)
    pk = m["predictor_kernel"]
    s = 1.0 / math.sqrt(d * pk)
    out += [(("predictor", "conv", "w"), (d, d, pk), "u", s),
            (("predictor", "conv", "b"), (d,), "u", s)]
    out += _lin(("predictor", "out"), d, 1)
    for i in range(m["decoder_layers"]):
        p = ("decoder", "layers", i)
        out += _ln(p + ("norm1",), d)
        out += _lin(p + ("ffn", "w1"), d, f) + _ln(p + ("ffn", "norm"), f)
        out += _lin(p + ("ffn", "w2"), f, d, bias=False)
        out += _ln(p + ("norm2",), d)
        out.append((p + ("fsmn", "w"), (d, 1, k), "n", 0.02))
        out += _ln(p + ("norm3",), d)
        out += _lin(p + ("src_attn", "q"), d, d)
        out += _lin(p + ("src_attn", "kv"), d, 2 * d)
        out += _lin(p + ("src_attn", "out"), d, d)
    out += _ln(("decoder", "final", "norm1"), d)
    out += _lin(("decoder", "final", "ffn", "w1"), d, f)
    out += _ln(("decoder", "final", "ffn", "norm"), f)
    out += _lin(("decoder", "final", "ffn", "w2"), f, d, bias=False)
    out += _ln(("decoder", "after_norm"), d)
    out += _lin(("decoder", "out"), d, m["vocab_size"])
    return out


def _put(tree: dict, path, value) -> None:
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(key, int):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def generator(seed: int, device, stream: int) -> torch.Generator:
    """The generator of one input stream of a run: streams of one seed are
    independent, and the seed may be any integer (reduced mod 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2 ** 63))
    return g


WEIGHTS, CMVN, AUDIO, BATCHES = 1, 2, 3, 4


def make_params(m: Dict[str, Any], seed: int, device) -> dict:
    """The Paraformer tree of config `m` on `device`, drawn from `seed`:
    one uniform and one normal draw for all leaves, then one scaled copy per
    leaf (each leaf its own storage)."""
    leaves = paraformer_leaves(m)
    g = generator(seed, device, WEIGHTS)
    n_u = sum(int(np.prod(s)) for _, s, k, _ in leaves if k == "u")
    n_n = sum(int(np.prod(s)) for _, s, k, _ in leaves if k == "n")
    uni = torch.empty(n_u, device=device).uniform_(-1.0, 1.0, generator=g)
    nor = torch.empty(n_n, device=device).normal_(generator=g)
    tree: dict = {}
    ou = on = 0
    for path, shape, kind, scale in leaves:
        n = int(np.prod(shape))
        if kind == "u":
            t = uni[ou: ou + n].view(shape) * scale
            ou += n
        elif kind == "n":
            t = nor[on: on + n].view(shape) * scale
            on += n
        elif kind == "one":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        _put(tree, path, t)
    return tree


def leaves_of(tree) -> List[Tuple[str, torch.Tensor]]:
    """(dotted path, tensor) of every leaf, in `paraformer_leaves` order for
    a Paraformer tree."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out.append((".".join(path), node))
    walk(tree, ())
    return out


def tokenizer(vocab: int):
    """The program's tokenizer: one CJK character per id and none special,
    so the served text spells every id (`ids_of`)."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer
    return CharTokenizer([chr(0x4E00 + i) for i in range(vocab)], special=())


def ids_of(text: str) -> List[int]:
    return [ord(c) - 0x4E00 for c in text]


def make_cmvn(dim: int, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global CMVN in the `am.mvn` form (negative means, inverse stddevs):
    means about the log-mel level of the generated audio, stddevs 3–6."""
    g = generator(seed, device, CMVN)
    r = torch.rand((2, dim), generator=g, device=device)
    return -(9.0 + 4.0 * r[0]), 1.0 / (3.0 + 3.0 * r[1])


def make_audio(lengths: List[int], seed: int, device, stream: int = AUDIO
               ) -> List[np.ndarray]:
    """Speech-band signals of the given lengths (samples at 16 kHz), drawn
    on the device in one batch: a voiced part (harmonics of a gliding pitch
    of 90–260 Hz, falling 6 dB per octave) and an unvoiced part (noise),
    mixed under syllable-rate envelopes (3–6 Hz), peak about 0.3."""
    if not lengths:
        return []
    g = generator(seed, device, stream)
    out: List[np.ndarray] = []
    for i in range(0, len(lengths), 32):   # bounded device memory
        out += _audio_block(lengths[i: i + 32], g, device)
    return out


def _audio_block(lengths: List[int], g: torch.Generator, device
                 ) -> List[np.ndarray]:
    n, t = len(lengths), max(lengths)
    sr = 16000.0
    r = torch.rand((n, 6), generator=g, device=device)
    time = torch.arange(t, device=device, dtype=torch.float32)[None] / sr
    f0 = 90.0 + 170.0 * r[:, :1]
    glide = 1.0 + 0.15 * torch.sin(2 * math.pi * (0.3 + r[:, 1:2]) * time)
    phase = 2 * math.pi * torch.cumsum(f0 * glide, 1) / sr
    voiced = torch.zeros((n, t), device=device)
    for h in range(1, 16):
        voiced += torch.sin(h * phase) / h
    noise = torch.randn((n, t), generator=g, device=device)
    rate = 3.0 + 3.0 * r[:, 2:3]
    syl = 0.5 + 0.5 * torch.sin(2 * math.pi * rate * time + 6.28 * r[:, 3:4])
    mix = r[:, 4:5]
    x = syl ** 2 * ((1 - 0.5 * mix) * voiced + 0.5 * mix * noise)
    x = x * (0.3 / torch.clamp_min(x.abs().amax(1, keepdim=True), 1e-6))
    host = x.cpu().numpy()
    return [np.ascontiguousarray(host[i, :m]) for i, m in enumerate(lengths)]
