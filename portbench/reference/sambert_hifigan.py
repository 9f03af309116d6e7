"""The plain reference of Sambert + HiFi-GAN (PNCA decoder) in PyTorch: the
yardstick of the `tts-paragraph` cell's `correct`.

Written from the architecture (KAN-TTS Sambert's MelPNCADecoder, HiFi-GAN
v1) over the same parameter tree as the program, and independent of it:
float32, no cache, no batching, no graphs, one segment at a time. It
imports neither JAX nor the port; the caller sets the precision (TF32 off).

For one segment's phone ids [L, 4] (sy, tone, syllable flag, word
segment) it computes:
- the four embeddings summed, the sinusoidal position (positions from 1,
  frequency denominator half − 1), speaker and emotion; the encoder's
  pre-norm transformer layers over the L valid phones only;
- the duration, pitch and energy heads (two convolutions with ReLU and
  LayerNorm, then one output column); durations clip(round(exp(d) − 1),
  1, max_duration); pitch and energy embedded by a 9-tap convolution;
  length regulation by repeating each phone state;
- the PNCA decoder as a plain loop: each step runs the prenet on the
  previous group of r frames, then each layer projects the keys and values
  of its own inputs at every earlier step anew (no X cache), attends over
  those steps and over the valid memory frames whose step lies within
  h_band of the current one (the memory's keys and values projected once
  per segment), fuses both, then the FFN (post-norm);
- the convolutional postnet with its channel affine, and HiFi-GAN with
  `F.conv_transpose1d`.

Three departures from a whole-utterance reference, all forced by what the
service serves:
- its variance heads run over the segment padded with zero phone states
  to the program's phone bucket: the service's second convolution reads
  the first one's output over the padding, which moves the last phones'
  durations, pitch and energy;
- it vocodes the mel zero-padded to the program's mel length t_mel (rounded
  up to whole decoder steps): the service's samples near a segment's end
  depend on the padding through the vocoder's receptive field. For the same
  reason the decoder runs the steps that the postnet's right context reads
  past the last valid frame;
- its phone ids come from the port's text front end, host code that the
  program and the reference share (the caller passes them in).

`assemble` joins a job's segments as the service does: each segment after
the first behind a pause of silence, then a linear crossfade over the
boundary.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1


# ----------------------------------------------------------------- layers
def linear(p: Dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


def layernorm(p: Dict, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p["g"], p["b"], eps)


def conv1d(p: Dict, x: torch.Tensor, pad: Tuple[int, int],
           dilation: int = 1) -> torch.Tensor:
    """x [T, C_in] → [T', C_out]; weight (C_out, C_in, K)."""
    y = F.conv1d(F.pad(x.t()[None], pad), p["w"], p.get("b"),
                 dilation=dilation)
    return y[0].t()


def posenc(t: int, d: int) -> torch.Tensor:
    """Sinusoidal positions 1 … t, frequency denominator d/2 − 1."""
    pos = torch.arange(1, t + 1, dtype=torch.float32)[:, None]
    half = d // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32)
                    * -(math.log(10000.0) / (half - 1)))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int) -> torch.Tensor:
    """q [Tq, D], k and v [Tk, D] → [Tq, D]: softmax over every key."""
    tq, d = q.shape
    dk = d // heads

    def split(x):
        return x.reshape(x.shape[0], heads, dk).transpose(0, 1)
    s = split(q) @ split(k).transpose(1, 2) / math.sqrt(dk)
    return (torch.softmax(s, -1) @ split(v)).transpose(0, 1).reshape(tq, d)


def ffn(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["w2"], torch.relu(linear(p["w1"], x)))


def variance_head(p: Dict, x: torch.Tensor, k: int, phones: int
                  ) -> torch.Tensor:
    """x [L, D] → [L]: run over x padded with zero rows to `phones`."""
    pad = ((k - 1) // 2, k // 2)
    x = F.pad(x, (0, 0, 0, phones - x.shape[0]))
    h = layernorm(p["ln1"], torch.relu(conv1d(p["c1"], x, pad)))
    h = layernorm(p["ln2"], torch.relu(conv1d(p["c2"], h, pad)))
    return (h @ p["out"]["w"][:, 0] + p["out"]["b"][0])[:phones]


# ----------------------------------------------------------------- Sambert
def encode(ap: Dict, cfg: Dict, ids: torch.Tensor, speaker: int,
           phones: int, emotion: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids [L, 4] → (phone states [L, D], log durations [L]); `phones`:
    the program's phone bucket."""
    lp = ap["ling"]
    x = sum(lp[name]["table"][ids[:, i]] for i, name in enumerate(
        ("sy", "tone", "syllable_flag", "word_segment")))
    x = x + posenc(ids.shape[0], cfg["d_model"]).to(x.device)
    x = x + ap["spk"]["table"][speaker] + ap["emo"]["table"][emotion]
    heads = cfg["n_heads"]
    for layer in ap["encoder"]:
        h = layernorm(layer["norm1"], x)
        a = layer["attn"]
        x = x + linear(a["out"], attention(
            linear(a["q"], h), linear(a["k"], h), linear(a["v"], h), heads))
        x = x + ffn(layer["ffn"], layernorm(layer["norm2"], x))
    n = ids.shape[0]
    return x, variance_head(ap["duration"], x, cfg["var_kernel"], phones)[:n]


def durations(log_dur: torch.Tensor, cfg: Dict
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(durations [L] int64, their values before rounding exp(d) − 1)."""
    before = torch.exp(log_dur) - 1.0
    dur = torch.clamp(torch.round(before), 1, cfg["max_duration"])
    return dur.long(), before


def pnca(pn: Dict, cfg: Dict, memory: torch.Tensor, steps: int
         ) -> torch.Tensor:
    """memory [T_valid, D] (the length-regulated phone states) → mel
    [steps·r, n_mels], one loop iteration per step."""
    r, d, n_mels = cfg["outputs_per_step"], cfg["d_model"], cfg["n_mels"]
    heads, hb, xb = cfg["n_heads"], cfg["h_band"], cfg["x_band"]
    valid = memory.shape[0]
    pe = posenc(steps, d).to(memory.device)
    history: List[List[torch.Tensor]] = [[] for _ in pn["layers"]]
    kv_mem = [(linear(layer["kh"], memory), linear(layer["vh"], memory))
              for layer in pn["layers"]]
    prev = torch.zeros(n_mels * r, device=memory.device)
    pp = pn["prenet"]
    out = []
    for t in range(steps):
        h = torch.relu(linear(pp["fc2"], torch.relu(linear(pp["fc1"], prev))))
        x = linear(pp["proj"], h) + pe[t]
        lo, hi = (0, valid) if hb < 0 else \
            (max(0, (t - hb) * r), min(valid, (t + hb + 1) * r))
        if hi <= lo:
            raise ValueError(f"step {t}: no valid memory frame in the band")
        for li, layer in enumerate(pn["layers"]):
            history[li].append(x)
            past = torch.stack(history[li])
            if xb >= 0:
                past = past[-(xb + 1):]
            q = linear(layer["q"], x)[None]
            ax = attention(q, linear(layer["kx"], past),
                           linear(layer["vx"], past), heads)[0]
            kh, vh = kv_mem[li]
            ah = attention(q, kh[lo:hi], vh[lo:hi], heads)[0]
            x = layernorm(layer["norm_attn"],
                          x + linear(layer["fc"], torch.cat([ax, ah])))
            x = layernorm(layer["norm_ffn"], x + ffn(layer["ffn"], x))
        prev = linear(pn["mel_out"], x)
        out.append(prev.reshape(r, n_mels))
    return torch.cat(out)


def postnet(ap: Dict, cfg: Dict, mel: torch.Tensor) -> torch.Tensor:
    k = cfg["postnet_kernel"]
    y = mel
    for i, layer in enumerate(ap["postnet"]):
        y = conv1d(layer["conv"], y, ((k - 1) // 2, k // 2))
        y = y * layer["norm"]["g"] + layer["norm"]["b"]
        if i < len(ap["postnet"]) - 1:
            y = torch.tanh(y)
    return mel + y


def acoustic(ap: Dict, cfg: Dict, ids: torch.Tensor, speaker: int,
             phones: int, t_mel: int) -> Dict:
    """One segment at the program's phone bucket and mel length → {"mel"
    [S·r, n_mels] (zero past the valid frames), "mel_len", "durations",
    "before_rounding"}, S = ⌈t_mel / r⌉ the program's steps."""
    r = cfg["outputs_per_step"]
    cap = -(-t_mel // r) * r
    n = ids.shape[0]
    x, log_dur = encode(ap, cfg, ids, speaker, phones)
    dur, before = durations(log_dur, cfg)
    k = cfg["var_kernel"]
    pitch = variance_head(ap["pitch"], x, k, phones)[:n]
    energy = variance_head(ap["energy"], x, k, phones)[:n]
    x = x + conv1d(ap["pitch_embed"], pitch[:, None], (4, 4))
    x = x + conv1d(ap["energy_embed"], energy[:, None], (4, 4))
    memory = torch.repeat_interleave(x, dur, dim=0)[:cap]
    n = memory.shape[0]     # the valid frames
    # the steps whose frames the postnet's layers read for the last valid
    # frame
    reach = cfg["postnet_layers"] * (cfg["postnet_kernel"] // 2)
    steps = min(-(-(n + reach) // r), cap // r)
    mel = postnet(ap, cfg, pnca(ap["pnca"], cfg, memory, steps))
    out = torch.zeros(cap, cfg["n_mels"], device=mel.device)
    out[:n] = mel[:n]
    return {"mel": out, "mel_len": n, "durations": dur,
            "before_rounding": before}


# ---------------------------------------------------------------- HiFi-GAN
def _resblock(p: Dict, x: torch.Tensor, k: int, dilations) -> torch.Tensor:
    for c1, c2, d in zip(p["convs1"], p["convs2"], dilations):
        h = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), c1["w"], c1["b"],
                     padding=d * (k - 1) // 2, dilation=d)
        h = F.conv1d(F.leaky_relu(h, LRELU_SLOPE), c2["w"], c2["b"],
                     padding=(k - 1) // 2)
        x = x + h
    return x


def vocoder(vp: Dict, cfg: Dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [T, n_mels] → wav [T·hop] in [-1, 1]."""
    x = F.conv1d(mel.t()[None], vp["conv_pre"]["w"], vp["conv_pre"]["b"],
                 padding=3)
    for r, k, up, blocks in zip(cfg["upsample_rates"], cfg["upsample_kernels"],
                                vp["ups"], vp["resblocks"]):
        x = F.conv_transpose1d(F.leaky_relu(x, LRELU_SLOPE), up["w"],
                               up["b"], stride=r, padding=(k - r) // 2)
        x = sum(_resblock(b, x, rk, rd) for b, rk, rd in zip(
            blocks, cfg["resblock_kernels"], cfg["resblock_dilations"])
        ) / len(blocks)
    x = F.conv1d(F.leaky_relu(x, LRELU_SLOPE), vp["conv_post"]["w"],
                 vp["conv_post"]["b"], padding=3)
    return torch.tanh(x)[0, 0]


def hop(cfg: Dict) -> int:
    return math.prod(cfg["upsample_rates"])


def segment(ap: Dict, acfg: Dict, vp: Dict, vcfg: Dict, ids: torch.Tensor,
            speaker: int, phones: int, t_mel: int) -> Dict:
    """One segment's 16-bit PCM over its valid frames, with the acoustic
    model's durations: {"pcm" int16 numpy, "mel_len", "durations",
    "before_rounding"}."""
    out = acoustic(ap, acfg, ids, speaker, phones, t_mel)
    wav = vocoder(vp, vcfg, out["mel"])
    pcm = torch.clamp(torch.round(wav * 32767.0), -32768, 32767)
    n = out["mel_len"] * hop(vcfg)
    return dict(out, pcm=pcm[:n].to(torch.int16).cpu().numpy())


# ---------------------------------------------------------------- the job
def assemble(segments: Sequence[np.ndarray], pauses_ms: Sequence[int],
             sample_rate: int, crossfade_ms: int) -> np.ndarray:
    """Float32 segments → the job's float32 waveform: segment i + 1 follows
    a pause of `pauses_ms[i]` of silence, and its first samples cross-fade
    linearly with the end of what precedes it (not where either side is
    shorter than the fade)."""
    fade = int(sample_rate * crossfade_ms / 1000)
    segs = [np.asarray(s, np.float32) for s in segments if len(s)]
    if not segs:
        return np.zeros(0, np.float32)
    out = segs[0]
    for i, s in enumerate(segs[1:]):
        pause = pauses_ms[i] if i < len(pauses_ms) else 0
        if pause > 0:
            out = np.concatenate([out, np.zeros(
                int(sample_rate * pause / 1000), np.float32)])
        if fade <= 0 or len(out) < fade or len(s) < fade:
            out = np.concatenate([out, s])
            continue
        w_out = (np.linspace(1.0, 0.0, fade, endpoint=True, dtype=np.float32)
                 if fade > 1 else np.zeros(1, np.float32))
        mixed = out[-fade:] * w_out + s[:fade] * (1.0 - w_out)
        out = np.concatenate([out[:-fade], mixed, s[fade:]])
    return out


def to_pcm16(wav: np.ndarray) -> np.ndarray:
    """A float waveform as 16-bit samples (round half to even, clipped)."""
    return np.clip(np.round(wav * 32767.0), -32768, 32767).astype(np.int16)
