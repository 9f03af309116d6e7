"""Plain PyTorch reference of Paraformer-large, offline and online.

The benchmark's yardstick for `correct`: the same mathematics as the
program under test, written with stock operations only (no kernel, no
captured graph, no bucket cache) and importing nothing of the program. It
reads the parameter tree the benchmark generated (`portbench/weights.py`,
the FunASR checkpoint layout) and the inputs the benchmark made, and works
out everything else again: features, masks, the token cap, CIF, the
streaming caches.

- `offline_logits`: fbank (kaldi, 25 ms / 10 ms, hamming, 80 mel) → LFR
  7/6 (replicate-first, and replicate-last valid frame) → CMVN → SAN-M
  encoder (FSMN memory as a depthwise `F.conv1d`) → CIF v2 (static-shape
  overlap weights, tail frame 0.45) → NAR decoder → logits. Rows are padded
  to the audio bucket the deployment serves them in, because the token cap
  (`max_tokens`) is a function of the padded length; every other quantity
  is held to each row's valid length by masks.
- `OnlineSession`: FunASR's streaming layout (chunk [0, 4, 5], encoder
  look-back 4, decoder look-back 1): a window of c0 + c2 cached plus c1 new
  LFR frames per step, per-layer k/v caches, CIF integration carried over
  chunks, incremental decode with per-layer FSMN caches over a bounded ring
  of settled encoder frames; the end of an utterance pads whole chunks of
  silence plus two more, then fires the tail (0.45).
- `train_loss`: masked token cross-entropy + the CIF quantity loss with
  teacher-forced CIF, and `adamw_step`, AdamW by its formula.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e9
EPS_LOGMEL = 1.1920928955078125e-07
AUDIO_BUCKETS_S = (1, 2, 4, 6, 8, 10, 15, 20, 30, 45, 60, 90, 120)


# ----------------------------------------------------------------- frontend
def _mel_banks(n_fft: int, n_mels: int, sr: int, low: float) -> np.ndarray:
    def mel(hz):
        return 1127.0 * np.log(1.0 + hz / 700.0)
    n_bins = n_fft // 2
    lo, hi = mel(np.array(low)), mel(np.array(0.5 * sr))
    delta = (hi - lo) / (n_mels + 1)
    bins = mel(sr / n_fft * np.arange(n_bins, dtype=np.float64))
    banks = np.zeros((n_bins, n_mels))
    for m in range(n_mels):
        left, center, right = lo + m * delta, lo + (m + 1) * delta, \
            lo + (m + 2) * delta
        banks[:, m] = np.maximum(0.0, np.minimum(
            (bins - left) / (center - left), (right - bins) / (right - center)))
    return banks.astype(np.float32)


def fbank(wav: torch.Tensor, fe: dict, n_frames: int) -> torch.Tensor:
    """[B, N] f32 in [-1, 1] → log-mel [B, n_frames, n_mels]: kaldi framing
    with snip_edges, DC removal, pre-emphasis, hamming window, power
    spectrum; frames past the audio read zeros."""
    sr, flen, shift = fe["sample_rate"], fe["frame_length"], fe["frame_shift"]
    n_fft = 1 << (flen - 1).bit_length()
    x = wav.float() * 32768.0
    need = max(n_frames - 1, 0) * shift + flen
    if x.shape[1] < need:
        x = F.pad(x, (0, need - x.shape[1]))
    fr = x.unfold(1, flen, shift)[:, :n_frames]
    fr = fr - fr.mean(dim=-1, keepdim=True)
    fr = fr - fe["preemphasis"] * torch.cat([fr[..., :1], fr[..., :-1]], -1)
    i = torch.arange(flen, dtype=torch.float64, device=x.device)
    win = (0.54 - 0.46 * torch.cos(2 * math.pi * i / (flen - 1))).float()
    spec = torch.fft.rfft(F.pad(fr * win, (0, n_fft - flen)), dim=-1)
    power = spec.real[..., : n_fft // 2] ** 2 + spec.imag[..., : n_fft // 2] ** 2
    banks = torch.from_numpy(_mel_banks(n_fft, fe["n_mels"], sr,
                                        fe["low_freq"])).to(x.device)
    return torch.log(torch.clamp_min(power @ banks, EPS_LOGMEL))


def n_fbank_frames(n: int, fe: dict) -> int:
    return 0 if n < fe["frame_length"] else \
        1 + (n - fe["frame_length"]) // fe["frame_shift"]


def lfr(fb: torch.Tensor, m: int, n: int, t_out: int,
        valid: torch.Tensor) -> torch.Tensor:
    """[B, T, D] → [B, t_out, m·D]: output i stacks input rows i·n − (m−1)/2
    … + m − 1, clamped to [0, valid − 1] per row."""
    b, t, d = fb.shape
    src = torch.arange(t_out, device=fb.device)[:, None] * n + \
        torch.arange(m, device=fb.device)[None, :] - (m - 1) // 2
    src = torch.clamp(src, 0, t - 1)[None]
    src = torch.minimum(src, (torch.clamp_min(valid, 1) - 1)[:, None, None])
    return torch.gather(fb, 1, src.reshape(b, -1, 1).expand(-1, -1, d)) \
        .reshape(b, t_out, m * d)


# ------------------------------------------------------------------- layers
def linear(p, x):
    y = x.float() @ p["w"].float()
    return y + p["b"] if "b" in p else y


def layernorm(p, x, eps: float = 1e-12):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * p["g"] + p["b"]


def fsmn(w: torch.Tensor, x: torch.Tensor, pad: Tuple[int, int],
         mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(x·m + depthwise_conv(x·m)) · m."""
    if mask is not None:
        x = x * mask[..., None]
    y = x + F.conv1d(F.pad(x.transpose(1, 2), pad), w,
                     groups=x.shape[-1]).transpose(1, 2)
    return y * mask[..., None] if mask is not None else y


def heads(x, h):
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def merge(x):
    b, h, t, dk = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dk)


def attend(q, k, v, keep):
    """keep: [B, Tq or 1, Tk] (1 = attend)."""
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    s = s + (1.0 - keep[:, None]) * NEG_INF
    return torch.softmax(s, dim=-1) @ v


def dec_ffn(p, x):
    return linear(p["w2"], layernorm(p["norm"], torch.relu(linear(p["w1"], x))))


def cross_attention(p, x, mem, h, mem_keep):
    q = linear(p["q"], x)
    k, v = linear(p["kv"], mem).chunk(2, dim=-1)
    return linear(p["out"], merge(attend(heads(q, h), heads(k, h), heads(v, h),
                                         mem_keep[:, None, :])))


def posenc(pos: torch.Tensor, d: int) -> torch.Tensor:
    """FunASR sinusoid at explicit 1-based positions [..., T] → [..., T, d]."""
    half = d // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=pos.device)
                    * -(math.log(10000.0) / (half - 1)))
    ang = pos.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def sanm_pad(cfg) -> Tuple[int, int]:
    left = (cfg["kernel_size"] - 1) // 2 + cfg["sanm_shift"]
    return left, cfg["kernel_size"] - 1 - left


def alphas_of(params, enc, cfg):
    p = params["predictor"]
    k = cfg["predictor_kernel"]
    lpad = (k - 1) // 2 if cfg["predictor_l_order"] < 0 else \
        cfg["predictor_l_order"]
    h = F.conv1d(F.pad(enc.transpose(1, 2), (lpad, k - 1 - lpad)),
                 p["conv"]["w"], p["conv"]["b"]).transpose(1, 2) + enc
    return torch.sigmoid(linear(p["out"], torch.relu(h)))[..., 0]


# -------------------------------------------------------------- offline
def encode(params, feats, mask, cfg):
    h = cfg["n_heads"]
    x = feats * math.sqrt(cfg["d_model"])
    pos = torch.arange(1, feats.shape[1] + 1, device=feats.device)
    x = x + posenc(pos, feats.shape[-1])[None]
    for i, layer in enumerate(params["encoder"]["layers"]):
        a = layer["attn"]
        q, k, v = linear(a["qkv"], layernorm(layer["norm1"], x)).chunk(3, -1)
        mem = fsmn(a["fsmn"]["w"], v, sanm_pad(cfg), mask)
        att = linear(a["out"], merge(attend(heads(q, h), heads(k, h),
                                            heads(v, h), mask[:, None, :])))
        x = att + mem if i == 0 else x + att + mem
        f = layer["ffn"]
        x = x + linear(f["w2"], torch.relu(linear(
            f["w1"], layernorm(layer["norm2"], x))))
    return layernorm(params["encoder"]["after_norm"], x) * mask[..., None]


def cif(enc, alphas, k_max: int, tail: float):
    """Static-shape CIF: (embeds [B, K, D], csum_final [B] with the tail,
    token_count [B])."""
    b, _, d = enc.shape
    a = torch.cat([alphas, alphas.new_full((b, 1), tail)], 1)
    enc = torch.cat([enc, enc.new_zeros((b, 1, d))], 1)
    hi = torch.cumsum(a, 1)
    lo = torch.cat([hi.new_zeros((b, 1)), hi[:, :-1]], 1)
    k = torch.arange(k_max, dtype=torch.float32, device=enc.device)
    w = torch.clamp_min(torch.minimum(hi[:, None, :], k[None, :, None] + 1)
                        - torch.maximum(lo[:, None, :], k[None, :, None]), 0)
    count = torch.clamp_max(torch.floor(hi[:, -1]), k_max).long()
    return w @ enc, hi[:, -1], count


def decode(params, embeds, tok_mask, memory, mem_mask, cfg):
    h = cfg["n_heads"]
    x = embeds
    for layer in params["decoder"]["layers"]:
        y = layernorm(layer["norm2"], dec_ffn(layer["ffn"],
                                              layernorm(layer["norm1"], x)))
        x = x + fsmn(layer["fsmn"]["w"], y, sanm_pad(cfg), tok_mask)
        x = x + cross_attention(layer["src_attn"], layernorm(layer["norm3"], x),
                                memory, h, mem_mask)
    fin = params["decoder"]["final"]
    x = dec_ffn(fin["ffn"], layernorm(fin["norm1"], x))
    return linear(params["decoder"]["out"],
                  layernorm(params["decoder"]["after_norm"], x))


def bucket_samples(n: int, sr: int) -> int:
    for s in AUDIO_BUCKETS_S:
        if s * sr >= n:
            return int(s * sr)
    return int(AUDIO_BUCKETS_S[-1] * sr)


def max_tokens(t_lfr: int) -> int:
    k = t_lfr // 2 + 8
    return ((k + 7) // 8) * 8


def features(wavs: Sequence[np.ndarray], cfg, cmvn, device):
    """Rows padded to the bucket of the longest → (feats [B, T, 560], valid
    LFR frames [B], the bucket's token cap)."""
    fe = cfg["frontend"]
    n = bucket_samples(max(len(w) for w in wavs), fe["sample_rate"])
    batch = np.zeros((len(wavs), n), np.float32)
    lens = np.array([len(w) for w in wavs])
    for i, w in enumerate(wavs):
        batch[i, : len(w)] = w
    t_fb = n_fbank_frames(n, fe)
    t_lfr = -(-t_fb // fe["lfr_n"])
    valid_fb = torch.tensor([n_fbank_frames(int(x), fe) for x in lens],
                            device=device)
    fb = fbank(torch.from_numpy(batch).to(device), fe, t_fb)
    x = lfr(fb, fe["lfr_m"], fe["lfr_n"], t_lfr, valid_fb)
    x = (x + cmvn[0]) * cmvn[1]
    valid = torch.div(valid_fb + fe["lfr_n"] - 1, fe["lfr_n"],
                      rounding_mode="floor")
    return x, valid, max_tokens(t_lfr)


@torch.no_grad()
def offline_logits(params, cfg, cmvn, wavs: Sequence[np.ndarray], device):
    """One batch of utterances → per row (logits [count, V], csum_final,
    count) in float64 on the host."""
    x, valid, k_max = features(wavs, cfg, cmvn, device)
    mask = (torch.arange(x.shape[1], device=device)[None] < valid[:, None]) \
        .float()
    enc = encode(params, x, mask, cfg)
    alphas = alphas_of(params, enc, cfg) * mask
    emb, csum, count = cif(enc, alphas, k_max,
                           cfg["predictor_tail_threshold"])
    tok = (torch.arange(k_max, device=device)[None] < count[:, None]).float()
    logits = decode(params, emb, tok, enc, mask, cfg)
    out = []
    for i in range(len(wavs)):
        c = int(count[i])
        out.append((logits[i, :c].double().cpu(), float(csum[i]), c))
    return out


# --------------------------------------------------------------- online
class OnlineSession:
    """The streaming model over B utterances in lockstep: `run` feeds each
    row its chunks (one c1-frame LFR chunk per step), rows that have run
    out stay as they are; the result per row is the list of fired tokens,
    each as (logits [V] float64, chunk index), plus the CIF mass at the end
    of each chunk and the final mass before the tail."""

    def __init__(self, params, cfg, ocfg, cmvn, device):
        self.p, self.cfg, self.o, self.cmvn = params, cfg, ocfg, cmvn
        self.dev = device

    def _feats(self, wav: np.ndarray, n_chunks: int) -> torch.Tensor:
        """The utterance padded with silence to whole chunks plus two, as
        LFR+CMVN frames [n_chunks·c1, 560]."""
        fe = self.cfg["frontend"]
        chunk = self.o["c1"] * fe["lfr_n"] * fe["frame_shift"]
        n = n_chunks * chunk
        x = np.zeros((1, n), np.float32)
        x[0, : len(wav)] = wav
        t_lfr = n_chunks * self.o["c1"]
        t_fb = n_fbank_frames(n, fe)
        fb = fbank(torch.from_numpy(x).to(self.dev), fe, t_fb)
        f = lfr(fb, fe["lfr_m"], fe["lfr_n"], t_lfr,
                torch.tensor([t_fb], device=self.dev))
        return ((f + self.cmvn[0]) * self.cmvn[1])[0]

    def n_chunks(self, n_samples: int) -> int:
        fe = self.cfg["frontend"]
        chunk = self.o["c1"] * fe["lfr_n"] * fe["frame_shift"]
        return -(-n_samples // chunk) + 2

    def _encode(self, st, x):
        """One chunk step of the encoder over the window [cache ‖ new]."""
        cfg, o = self.cfg, self.o
        h, c1 = cfg["n_heads"], o["c1"]
        L = o["encoder_look_back"] * c1
        pos = st["start"][:, None] + torch.arange(c1, device=self.dev)[None] + 1
        x = x * math.sqrt(cfg["d_model"]) + posenc(pos, cfg["input_dim"])
        win = torch.cat([st["feats"], x], 1)
        W = win.shape[1]
        keep = (torch.arange(L + W, device=self.dev)[None]
                >= (L - st["kv_len"])[:, None]).float()[:, None, :]
        y, ks, vs = win, [], []
        for i, layer in enumerate(self.p["encoder"]["layers"]):
            a = layer["attn"]
            q, k, v = linear(a["qkv"], layernorm(layer["norm1"], y)).chunk(3, -1)
            mem = fsmn(a["fsmn"]["w"], v, sanm_pad(cfg), None)
            kk = torch.cat([st["k"][i], heads(k, h)], 2)
            vv = torch.cat([st["v"][i], heads(v, h)], 2)
            att = linear(a["out"], merge(attend(heads(q, h), kk, vv, keep))) \
                + mem
            y = att if i == 0 else y + att
            f = layer["ffn"]
            y = y + linear(f["w2"], torch.relu(linear(
                f["w1"], layernorm(layer["norm2"], y))))
            ks.append(kk[:, :, c1: c1 + L])
            vs.append(vv[:, :, c1: c1 + L])
        y = layernorm(self.p["encoder"]["after_norm"], y)
        new = dict(st, feats=win[:, -(o["c0"] + o["c2"]):],
                   start=st["start"] + c1, k=torch.stack(ks),
                   v=torch.stack(vs),
                   kv_len=torch.clamp_max(st["kv_len"] + c1, L))
        return new, y

    def _cif(self, st, enc):
        """CIF over the active region [c0, c0 + c1) with carried mass."""
        o = self.o
        a = alphas_of(self.p, enc, self.cfg)
        act = torch.zeros_like(a)
        act[:, o["c0"]: o["c0"] + o["c1"]] = 1.0
        a = a * act
        m0 = st["mass"]
        k0 = torch.floor(m0)
        hi = m0[:, None] + torch.cumsum(a, 1)
        lo = torch.cat([m0[:, None], hi[:, :-1]], 1)
        kc = o["tokens_per_chunk"]
        k = k0[:, None] + torch.arange(kc, device=self.dev)[None].float()
        w = torch.clamp_min(torch.minimum(hi[:, None, :], k[..., None] + 1)
                            - torch.maximum(lo[:, None, :], k[..., None]), 0)
        emb = w @ enc
        emb[:, 0] += st["acc"]
        last = hi[:, -1]
        n = torch.clamp_max((torch.floor(last) - k0).long(), kc)
        top = torch.floor(last)[:, None]
        wt = torch.clamp_min(torch.minimum(hi, top + 1) - torch.maximum(lo, top), 0)
        tail = (wt[:, None, :] @ enc)[:, 0]
        acc = torch.where((n > 0)[:, None], tail, emb[:, 0])
        return dict(st, mass=last, acc=acc), emb, n

    def _decode(self, st, emb, n):
        """Incremental decode of the newly fired tokens → logits [B, K, V]."""
        cfg = self.cfg
        h, d = cfg["n_heads"], cfg["d_model"]
        kc = cfg["kernel_size"] - 1
        left = (cfg["kernel_size"] - 1) // 2 + cfg["sanm_shift"]
        b, k, _ = emb.shape
        new = (torch.arange(k, device=self.dev)[None] < n[:, None]).float()
        x = emb * new[..., None]
        m = st["mem"].shape[1]
        mem_keep = (torch.arange(m, device=self.dev)[None]
                    >= (m - st["mem_len"])[:, None]).float()
        hist = torch.clamp_max(st["hist"], kc)
        cmask = (torch.arange(kc, device=self.dev)[None]
                 >= (kc - hist)[:, None]).float()
        seq_mask = torch.cat([cmask, new], 1)[..., None]
        roll = torch.clamp_max(torch.arange(kc, device=self.dev)[None]
                               + n[:, None], kc + k - 1)
        roll = roll[..., None].expand(-1, -1, d)
        caches = []
        for li, layer in enumerate(self.p["decoder"]["layers"]):
            y = layernorm(layer["norm2"], dec_ffn(
                layer["ffn"], layernorm(layer["norm1"], x))) * new[..., None]
            seq = torch.cat([st["fsmn"][li], y], 1)
            conv = F.conv1d(F.pad((seq * seq_mask).transpose(1, 2),
                                  (0, cfg["kernel_size"] - 1 - left)),
                            layer["fsmn"]["w"], groups=d).transpose(1, 2)
            conv = conv[:, kc - left: kc - left + k]
            x = x + (conv + y) * new[..., None]
            x = x + cross_attention(layer["src_attn"],
                                    layernorm(layer["norm3"], x), st["mem"],
                                    h, mem_keep)
            caches.append(torch.gather(seq, 1, roll))
        fin = self.p["decoder"]["final"]
        x = dec_ffn(fin["ffn"], layernorm(fin["norm1"], x))
        logits = linear(self.p["decoder"]["out"],
                        layernorm(self.p["decoder"]["after_norm"], x))
        return dict(st, fsmn=torch.stack(caches), hist=st["hist"] + n), logits

    def _init(self, b):
        cfg, o = self.cfg, self.o
        h, d = cfg["n_heads"], cfg["d_model"]
        z = lambda *s: torch.zeros(s, device=self.dev)  # noqa: E731
        L = o["encoder_look_back"] * o["c1"]
        W = o["c0"] + o["c1"] + o["c2"]
        return {
            "start": torch.zeros(b, dtype=torch.long, device=self.dev),
            "feats": z(b, o["c0"] + o["c2"], cfg["input_dim"]),
            "k": z(cfg["encoder_layers"], b, h, L, d // h),
            "v": z(cfg["encoder_layers"], b, h, L, d // h),
            "kv_len": torch.zeros(b, dtype=torch.long, device=self.dev),
            "mass": z(b), "acc": z(b, d),
            "fsmn": z(cfg["decoder_layers"], b, cfg["kernel_size"] - 1, d),
            "hist": torch.zeros(b, dtype=torch.long, device=self.dev),
            "mem": z(b, o["decoder_look_back"] * o["c1"] + W, d),
            "mem_len": torch.zeros(b, dtype=torch.long, device=self.dev),
        }

    @staticmethod
    def _merge(old, new, keep):
        out = {}
        for key, a in new.items():
            dim = 1 if key in ("k", "v", "fsmn") else 0
            shape = [1] * a.dim()
            shape[dim] = -1
            out[key] = torch.where(keep.reshape(shape), a, old[key])
        return out

    @torch.no_grad()
    def run(self, wavs: Sequence[np.ndarray]):
        o = self.o
        b = len(wavs)
        steps = [self.n_chunks(len(w)) for w in wavs]
        feats = [self._feats(w, s) for w, s in zip(wavs, steps)]
        st = self._init(b)
        toks: List[List[Tuple[torch.Tensor, int]]] = [[] for _ in range(b)]
        masses: List[List[float]] = [[] for _ in range(b)]
        c1 = o["c1"]
        for t in range(max(steps)):
            keep = torch.tensor([t < s for s in steps], device=self.dev)
            x = torch.stack([f[t * c1: (t + 1) * c1] if t < s else
                             f.new_zeros((c1, f.shape[1]))
                             for f, s in zip(feats, steps)])
            new, enc = self._encode(st, x)
            new, emb, n = self._cif(new, enc)
            settled = enc[:, o["c0"]: o["c0"] + c1]
            m = new["mem"].shape[1]
            new["mem"] = torch.cat([new["mem"], settled], 1)[:, -m:]
            new["mem_len"] = torch.clamp_max(new["mem_len"] + c1, m)
            new, logits = self._decode(new, emb, n)
            st = self._merge(st, new, keep)
            for r in range(b):
                if t < steps[r]:
                    masses[r].append(float(new["mass"][r]))
                    for j in range(int(n[r])):
                        toks[r].append((logits[r, j].double().cpu(), t))
        tail = self.cfg["predictor_tail_threshold"]
        for r in range(b):
            frac = masses[r][-1] - math.floor(masses[r][-1])
            if frac > 0 and frac + tail >= 1.0:
                one = {k: v[:, r: r + 1] if k in ("k", "v", "fsmn")
                       else v[r: r + 1] for k, v in st.items()}
                _, logits = self._decode(one, st["acc"][r][None, None],
                                         torch.ones(1, dtype=torch.long,
                                                    device=self.dev))
                toks[r].append((logits[0, 0].double().cpu(), steps[r]))
        return [dict(tokens=toks[r], masses=masses[r]) for r in range(b)]


# ------------------------------------------------------------ training
def train_loss(params, feats, feat_lens, targets, target_lens, cfg):
    """Token-mean cross-entropy + row-mean |Σα − target length|, CIF
    teacher-forced (α scaled to the target length, no tail)."""
    t = feats.shape[1]
    k_max = targets.shape[1]
    mask = (torch.arange(t, device=feats.device)[None]
            < feat_lens[:, None]).float()
    enc = encode(params, feats, mask, cfg)
    alphas = alphas_of(params, enc, cfg) * mask
    total = alphas.sum(1, keepdim=True)
    lens = target_lens.float()
    scaled = alphas * (lens[:, None] / torch.clamp_min(total, 1e-6))
    emb = cif(enc, scaled, k_max, 0.0)[0]
    tok = (torch.arange(k_max, device=feats.device)[None]
           < target_lens[:, None]).float()
    logp = torch.log_softmax(decode(params, emb, tok, enc, mask, cfg), -1)
    ce = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    ce = (ce * tok).sum() / torch.clamp_min(tok.sum(), 1.0)
    return ce + (total[:, 0] - lens).abs().sum() / lens.shape[0]


@torch.no_grad()
def adamw_step(leaves, grads, m, v, step: int, lr: float, b1: float,
               b2: float, eps: float, wd: float) -> None:
    """One AdamW update in place (decoupled decay, bias-corrected)."""
    for p, g, mi, vi in zip(leaves, grads, m, v):
        mi.mul_(b1).add_(g, alpha=1 - b1)
        vi.mul_(b2).add_(g * g, alpha=1 - b2)
        p.mul_(1 - lr * wd)
        mhat = mi / (1 - b1 ** step)
        vhat = vi / (1 - b2 ** step)
        p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
