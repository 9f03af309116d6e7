"""Operations and bytes of the work, counted from the configuration's shapes.

The yardstick of the per-layer `mfu` and `*_roofline` metrics: it counts
what the model's layers need for the shapes they are given, never what a
kernel happens to launch, so a fusion or a new kernel leaves the counts as
they are. Multiply-adds count two operations; elementwise work, norms and
softmax are left out of the model's count (they are not what a peak rate
measures), which keeps `mfu` a lower bound.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: float32 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
F32 = 4


def encoder_layer(m: Dict, t: int, keys: int, d_in: int) -> float:
    """One SAN-M encoder layer over t query frames and `keys` key frames."""
    d, f, k = m["d_model"], m["ffn_dim"], m["kernel_size"]
    return (2 * t * d_in * 3 * d          # qkv
            + 2 * 2 * t * keys * d        # scores and weighted values
            + 2 * t * d * d               # out
            + 2 * k * t * d               # FSMN memory taps
            + 2 * 2 * t * d * f)          # feed-forward


def encoder(m: Dict, t: int, keys: int = None) -> float:
    keys = t if keys is None else keys
    return sum(encoder_layer(m, t, keys, m["input_dim"] if i == 0
                             else m["d_model"])
               for i in range(m["encoder_layers"]))


def predictor(m: Dict, t: int, tokens: int) -> float:
    d = m["d_model"]
    return 2 * t * m["predictor_kernel"] * d * d + 2 * t * d \
        + 2 * tokens * t * d          # CIF's overlap product


def decoder(m: Dict, tokens: int, memory: int) -> float:
    d, f, k, v = m["d_model"], m["ffn_dim"], m["kernel_size"], m["vocab_size"]
    layer = (2 * 2 * tokens * d * f       # feed-forward
             + 2 * k * tokens * d         # FSMN memory taps
             + 2 * tokens * d * d         # query
             + 2 * memory * d * 2 * d     # keys and values of the memory
             + 2 * 2 * tokens * memory * d
             + 2 * tokens * d * d)        # out
    return m["decoder_layers"] * layer + 2 * 2 * tokens * d * f \
        + 2 * tokens * d * v


def offline_row(m: Dict, frames: int, tokens: int) -> float:
    """One utterance of `frames` valid LFR frames and `tokens` tokens."""
    return encoder(m, frames) + predictor(m, frames, tokens) \
        + decoder(m, tokens, frames)


def stream_step(m: Dict, o: Dict) -> float:
    """One row's encoder and predictor over one chunk's window."""
    w = o["c0"] + o["c1"] + o["c2"]
    keys = o["encoder_look_back"] * o["c1"] + w
    return encoder(m, w, keys) + predictor(m, w, o["tokens_per_chunk"])


def stream_token(m: Dict, o: Dict) -> float:
    """The incremental decode of one fired token over the memory ring."""
    mem = o["decoder_look_back"] * o["c1"] + o["c0"] + o["c1"] + o["c2"]
    return decoder(m, 1, mem)


def fsmn_forward(b: int, t: int, d: int, k: int, masked: bool):
    """(bytes, operations) of one FSMN memory block y = (x·m + conv(x·m))·m:
    x read and y written once, the taps and the mask read once."""
    nbytes = F32 * (2 * b * t * d + d * k + (b * t if masked else 0))
    ops = 2 * k * b * t * d + b * t * d * (3 if masked else 1)
    return nbytes, ops


def fsmn_backward(b: int, t: int, d: int, k: int, masked: bool):
    """(bytes, operations) of its backward, dx and dw: x and the incoming
    gradient read once, dx written once, the taps read and dw written once."""
    nbytes = F32 * (3 * b * t * d + 2 * d * k + (b * t if masked else 0))
    ops = 2 * 2 * k * b * t * d + b * t * d * (2 if masked else 1)
    return nbytes, ops


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_HBM_BYTES, ops / PEAK_F32_FLOPS)
