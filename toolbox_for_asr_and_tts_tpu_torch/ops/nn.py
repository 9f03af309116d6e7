"""Functional neural-net building blocks over the reference's parameter tree.

Every layer is a plain function of a nested dict of tensors, with the same
keys and layouts as `toolbox_for_asr_and_tts_tpu/ops/nn.py`: linear `w` is
`[in, out]`, conv weights are `(O, I/g, K)`, batch-first `[B, T, D]`.

Products come out in float32 as in the reference, whose `jnp.matmul(...,
preferred_element_type=float32)` promotes mixed bf16/f32 operands: the
operands are cast to float32 before `torch.matmul` (torch refuses mixed
dtypes). The FSMN memory conv goes through kernel K1
(`kernels/fsmn_conv.py`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .kernels.fsmn_conv import fsmn_depthwise

Params = Dict[str, Any]

NEG_INF = -1e9  # additive mask value (finite: a fully masked row stays uniform)


# ----------------------------------------------------------------- helpers
def _uniform(g: torch.Generator, shape, scale: float) -> torch.Tensor:
    """Drawn on the generator's device."""
    return torch.empty(shape, device=g.device).uniform_(-scale, scale,
                                                        generator=g)


def _normal(g: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device)


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """[B] valid lengths → [B, T] float mask."""
    pos = torch.arange(t, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).float()


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.float())


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=dim)


# ------------------------------------------------------------------ linear
def linear_init(g: torch.Generator, d_in: int, d_out: int,
                bias: bool = True) -> Params:
    scale = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform(g, (d_in, d_out), scale)}
    if bias:
        p["b"] = _uniform(g, (d_out,), scale)
    return p


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    if not isinstance(p, dict):   # a tensor-parallel product
        return p(x)               # (parallel/sharding.py::TPLinear)
    if p["w"].dtype == torch.int8:
        return _linear_int8(p, x)
    y = dot(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def quantize_linear_int8(p: Params) -> Params:
    """Symmetric per-output-channel int8 weight quantization of a linear
    param dict: {"w" int8 [in, out], "s" f32 [out], "b" f32?}. `linear`
    dispatches on the int8 dtype, so call sites do not change. Exact
    elementwise arithmetic (max, IEEE division, round half to even), so a
    tree quantized on the card holds the CPU's bits. `w` is laid out
    column-major (the [out, in] storage seen as [in, out]): cuBLASLt's
    int8 tensor-core product takes its first operand transposed."""
    w = p["w"].float()
    m = torch.clamp_min(w.abs().amax(dim=0), 1e-12)
    s = _div127(m)                                               # [out]
    q = torch.clamp(torch.round(w / s[None, :]), -127, 127).to(torch.int8)
    out = {"w": q.t().contiguous().t(), "s": s}
    if "b" in p:
        out["b"] = p["b"].float()
    return out


def _div127(a: torch.Tensor) -> torch.Tensor:
    """a / 127 by IEEE division on every device, as the reference computes
    it: CUDA turns a division by a Python scalar into a product with its
    reciprocal, which differs in the last bit."""
    return a / torch.full_like(a, 127.0)


# torch._int_mm on CUDA takes more than 16 rows (and inner and output
# widths that are multiples of 8, which every quantized linear has)
INT_MM_MIN_ROWS = 17


def _linear_int8(p: Params, x: torch.Tensor) -> torch.Tensor:
    """W8A8 product (the reference's s8×s8→s32 `dot_general`): activations
    quantize with a dynamic per-token symmetric scale, `torch._int_mm`
    accumulates in int32 (cuBLASLt's int8 tensor cores on the card), and
    the product of the activation and per-channel weight scales dequantizes
    in f32. Fewer rows than `_int_mm` takes are padded with zero rows and
    sliced off, never sent to a float product."""
    sx = _div127(torch.clamp_min(x.abs().amax(dim=-1, keepdim=True),
                                 1e-8).float())
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    rows = xq.reshape(-1, x.shape[-1]).contiguous()
    m = rows.shape[0]
    if m < INT_MM_MIN_ROWS:
        rows = F.pad(rows, (0, 0, 0, INT_MM_MIN_ROWS - m))
    y = torch._int_mm(rows, p["w"])[:m].reshape(*x.shape[:-1], -1)
    y = y.float() * (sx * p["s"])
    if "b" in p:
        y = y + p["b"]
    return y.to(x.dtype)


# --------------------------------------------------------------- layernorm
def layernorm_init(d: int) -> Params:
    return {"g": torch.ones(d), "b": torch.zeros(d)}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Population variance and eps 1e-12, as the reference (not
    `F.layer_norm`'s 1e-5)."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


# --------------------------------------------------------------- embedding
def embedding_init(g: torch.Generator, n_vocab: int, d: int) -> Params:
    """N(0, 1/d) table [n_vocab, d], drawn on the generator's device."""
    return {"table": _normal(g, (n_vocab, d)) * (d ** -0.5)}


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    if not isinstance(p, dict):   # a vocabulary-parallel table
        return p(ids)             # (parallel/sharding.py::TPEmbedding)
    return p["table"][ids.long()]


# ------------------------------------------------------------------ conv1d
def conv1d_init(g: torch.Generator, d_in: int, d_out: int, k: int,
                groups: int = 1, bias: bool = True) -> Params:
    scale = 1.0 / math.sqrt((d_in // groups) * k)
    p = {"w": _uniform(g, (d_out, d_in // groups, k), scale)}
    if bias:
        p["b"] = _uniform(g, (d_out,), scale)
    return p


def conv1d(p: Params, x: torch.Tensor, stride: int = 1,
           padding: Tuple[int, int] = (0, 0), groups: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """x: [B, T, C_in] → [B, T', C_out] float32; weight (O, I/g, K)."""
    xt = F.pad(x.float().transpose(1, 2), padding)
    y = F.conv1d(xt, p["w"].float(), stride=stride, groups=groups,
                 dilation=dilation).transpose(1, 2)
    if "b" in p:
        y = y + p["b"]
    return y


def conv_transpose1d(p: Params, x: torch.Tensor, stride: int,
                     padding: int = 0) -> torch.Tensor:
    """Torch-semantics ConvTranspose1d. x: [B, T, C_in] → [B, T', C_out]
    float32 with T' = (T-1)·stride - 2·padding + K; weight (C_in, C_out, K).

    Computed as one forward convolution over the stride's phases: before
    the crop, output sample q·stride + φ is Σ_j x[q - j]·w[:, :, φ + j·stride],
    so the phases are the output channels of a conv1d with J = ⌈K / stride⌉
    taps (zero taps past K), interleaved afterwards. cuDNN's forward
    convolutions are deterministic; `F.conv_transpose1d` (a backward-data
    algorithm) is not by default, and two syntheses of one text differed in
    the last bit of their PCM."""
    w = p["w"].float()
    c_in, c_out, k = w.shape
    j = -(-k // stride)
    # wp[φ·C_out + o, c, J-1-i] = w[c, o, φ + i·stride]
    wp = (F.pad(w, (0, j * stride - k)).view(c_in, c_out, j, stride)
          .permute(3, 1, 0, 2).flip(-1).reshape(stride * c_out, c_in, j))
    z = F.conv1d(F.pad(x.float().transpose(1, 2), (j - 1, j - 1)), wp)
    b, _, q = z.shape
    t_out = (x.shape[1] - 1) * stride - 2 * padding + k
    y = (z.view(b, stride, c_out, q).permute(0, 2, 3, 1)
         .reshape(b, c_out, q * stride)[:, :, padding:padding + t_out])
    y = y.transpose(1, 2)
    if "b" in p:
        y = y + p["b"]
    return y


# -------------------------------------------------- sinusoidal position enc
def sinusoidal_posenc(t: int, d: int, offset: int = 1,
                      device: Optional[torch.device] = None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """FunASR `SinusoidalPositionEncoder`: positions start at `offset` (1)
    and the frequency denominator is `half - 1`; computed in float32 and
    cast to `dtype`."""
    pos = torch.arange(offset, t + offset, dtype=torch.float32,
                       device=device)[:, None]
    half = d // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / (half - 1)))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# -------------------------------------------------------------- FSMN block
def fsmn_block_init(g: torch.Generator, d: int, lorder: int,
                    rorder: int = 0) -> Params:
    """VAD-style FSMNBlock: the kernel covers lorder past frames (the
    current one included) and rorder future ones, torch layout
    [D, 1, lorder + rorder]; `fsmn_pad` gives its pads."""
    return {"w": _normal(g, (d, 1, lorder + rorder)) * 0.02}


def fsmn_pad(lorder: int, rorder: int = 0) -> Tuple[int, int]:
    """Pads for a VAD-style FSMN conv (kernel = lorder + rorder, lorder
    includes the current frame): output length == T."""
    return lorder - 1, rorder


def fsmn_memory_init(g: torch.Generator, d: int, kernel_size: int) -> Params:
    """SAN-M memory conv weights (kernel_size taps), torch layout [D, 1, K]."""
    return {"w": _normal(g, (d, 1, kernel_size)) * 0.02}


def fsmn_block(p: Params, x: torch.Tensor, pad: Tuple[int, int],
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FSMN memory: mask → x + depthwise_conv(pad)(x) → mask, as the
    reference's `fsmn_block`, in one launch of kernel K1 (the masks fused).
    x may be a view with unit channel stride (SAN-M passes the V third of
    its qkv product): K1 reads it in place."""
    return fsmn_depthwise(x, p["w"], pad[0], pad[1],
                          None if mask is None else mask.float().contiguous())


def sanm_pad(kernel_size: int, sanm_shift: int = 0) -> Tuple[int, int]:
    left = (kernel_size - 1) // 2 + sanm_shift
    return left, kernel_size - 1 - left


# ------------------------------------------------------ attention (SAN-M)
def sanm_attention_init(g: torch.Generator, d_in: int, d: int, n_heads: int,
                        kernel_size: int = 11) -> Params:
    del n_heads
    return {
        "qkv": linear_init(g, d_in, 3 * d),
        "out": linear_init(g, d, d),
        "fsmn": fsmn_memory_init(g, d, kernel_size),
    }


def _split_heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dk = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, h * dk)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q,k,v: [B,H,T,Dk]; mask: [B, Tq, Tk] or [B, 1, Tk] (1 = keep).

    The mask is additive (`NEG_INF`), never boolean, so a fully masked row
    gives uniform weights instead of NaN."""
    dk = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dk)
    if mask is not None:
        if mask.dim() == 2:
            mask = mask[:, None, :]
        scores = scores + (1.0 - mask[:, None, :, :]) * NEG_INF
    att = torch.softmax(scores, dim=-1)
    return torch.matmul(att, v.float())


def sanm_attention(p: Params, x: torch.Tensor, n_heads: int,
                   mask: Optional[torch.Tensor] = None,
                   kernel_size: int = 11, sanm_shift: int = 0,
                   att_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FunASR `MultiHeadedAttentionSANM`: MHA + depthwise FSMN memory on V.

    mask: [B, T] validity (1 = valid); att_mask optionally overrides the
    attention visibility with a full [B, Tq, Tk] pattern. Returns [B, T, d].
    """
    qkv = linear(p["qkv"], x)
    q, k, v = qkv.chunk(3, dim=-1)
    mem = fsmn_block(p["fsmn"], v, sanm_pad(kernel_size, sanm_shift), mask)
    if att_mask is None:
        att_mask = None if mask is None else mask[:, None, :]
    out = attend(_split_heads(q, n_heads), _split_heads(k, n_heads),
                 _split_heads(v, n_heads), att_mask)
    return linear(p["out"], _merge_heads(out)) + mem


def cross_attention_init(g: torch.Generator, d_q: int, d_kv: int, d: int,
                         n_heads: int) -> Params:
    del n_heads
    return {
        "q": linear_init(g, d_q, d),
        "kv": linear_init(g, d_kv, 2 * d),
        "out": linear_init(g, d, d),
    }


def cross_attention(p: Params, x: torch.Tensor, memory: torch.Tensor,
                    n_heads: int,
                    memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FunASR `MultiHeadedAttentionCrossAtt`. memory_mask: [B, T_mem]."""
    q = linear(p["q"], x)
    k, v = linear(p["kv"], memory).chunk(2, dim=-1)
    m = None if memory_mask is None else memory_mask[:, None, :]
    out = attend(_split_heads(q, n_heads), _split_heads(k, n_heads),
                 _split_heads(v, n_heads), m)
    return linear(p["out"], _merge_heads(out))


def mha_init(g: torch.Generator, d: int, n_heads: int) -> Params:
    """Standard transformer self-attention (q/k/v/out)."""
    del n_heads
    return {
        "q": linear_init(g, d, d),
        "k": linear_init(g, d, d),
        "v": linear_init(g, d, d),
        "out": linear_init(g, d, d),
    }


def mha(p: Params, x: torch.Tensor, n_heads: int,
        mask: Optional[torch.Tensor] = None,
        kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention, or attention over `kv` [B, Tk, D] when given (keys
    and values from it, queries from x). mask: [B, Tk] key validity or
    [B, Tq, Tk], applied additively through `attend`."""
    src = x if kv is None else kv
    q, k, v = linear(p["q"], x), linear(p["k"], src), linear(p["v"], src)
    out = attend(_split_heads(q, n_heads), _split_heads(k, n_heads),
                 _split_heads(v, n_heads), mask)
    return linear(p["out"], _merge_heads(out))


# --------------------------------------------------------------------- FFN
def ffn_init(g: torch.Generator, d: int, d_hidden: int,
             d_out: Optional[int] = None) -> Params:
    return {"w1": linear_init(g, d, d_hidden),
            "w2": linear_init(g, d_hidden, d_out or d)}


def ffn(p: Params, x: torch.Tensor, activation=torch.relu) -> torch.Tensor:
    return linear(p["w2"], activation(linear(p["w1"], x)))


def dec_ffn_init(g: torch.Generator, d: int, d_hidden: int,
                 d_out: Optional[int] = None) -> Params:
    """FunASR `PositionwiseFeedForwardDecoderSANM`: w_1 (bias) → act →
    LayerNorm over the hidden dim → w_2 (NO bias)."""
    return {"w1": linear_init(g, d, d_hidden),
            "norm": layernorm_init(d_hidden),
            "w2": linear_init(g, d_hidden, d_out or d, bias=False)}


def dec_ffn(p: Params, x: torch.Tensor, activation=torch.relu) -> torch.Tensor:
    return linear(p["w2"], layernorm(p["norm"], activation(linear(p["w1"], x))))


# ----------------------------------------------------------------- sampling
def glu(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Gated linear unit: the first half of `axis` times the sigmoid of the
    second."""
    a, b = x.chunk(2, dim=axis)
    return a * torch.sigmoid(b)
