"""The Sambert + HiFi-GAN family (`portbench/reference/sambert_hifigan.py`):
what the harness and its readers need to know of a configuration whose
`reference` names that file.

- `TINY`: the geometry the benchmark's CPU tests run it at, by group of
  the configuration file;
- `call_flops(call, config)`: the model FLOPs of one call in a window's
  record, valid work only: the encoder and heads over each row's own
  phones, the PNCA decoder's steps over each row's own mel length with its
  attention over the valid history and the valid band of memory, the
  postnet and HiFi-GAN over the valid frames;
- `conv_flops(replay, config)`: the convolutions' FLOPs of one program
  replay at the shapes it is given (rows, phone bucket, decoder steps ·
  r frames), the yardstick of `conv_roofline`.

Multiply-adds count two operations; norms, softmax and elementwise work
are left out. A transposed convolution counts what the layer needs, K taps
per input sample.
"""
from __future__ import annotations

from typing import Dict

TINY = {
    "sambert": dict(d_model=32, n_heads=2, ffn_dim=64, encoder_layers=1,
                    decoder_layers=1, pnca_layers=2, var_channels=32,
                    postnet_channels=32, prenet_units=32),
    "hifigan": dict(upsample_initial_channel=32, resblock_kernels=[3],
                    resblock_dilations=[[1, 3]]),
}


def _encoder(a: Dict, n: int) -> float:
    d, f = a["d_model"], a["ffn_dim"]
    layer = 2 * n * d * 3 * d + 2 * 2 * n * n * d + 2 * n * d * d \
        + 2 * 2 * n * d * f
    return a["encoder_layers"] * layer


def _head_convs(a: Dict, n: int) -> float:
    """One variance head's two convolutions over n phones."""
    d, c, k = a["d_model"], a["var_channels"], a["var_kernel"]
    return 2 * n * k * d * c + 2 * n * k * c * c


def _head(a: Dict, n: int) -> float:
    return _head_convs(a, n) + 2 * n * a["var_channels"]


def _adaptor_convs(a: Dict, n: int) -> float:
    """The duration, pitch and energy heads' convolutions and the pitch
    and energy embeddings (9 taps, 1 → d) over n phones."""
    return 3 * _head_convs(a, n) + 2 * 2 * n * 9 * a["d_model"]


def _pnca(a: Dict, frames: int) -> float:
    """The decoder over `frames` valid frames: ⌈frames / r⌉ steps, each
    attending over its history and over the valid frames of its band."""
    d, f, r, m = a["d_model"], a["ffn_dim"], a["outputs_per_step"], \
        a["n_mels"]
    p, hb = a["prenet_units"], a["h_band"]
    steps = -(-frames // r)
    prenet = 2 * (m * r * p + p * p + p * d)
    per_layer = 3 * 2 * d * d + 2 * 2 * d * d + 2 * 2 * d * f
    total = steps * (prenet + a["pnca_layers"] * per_layer + 2 * d * m * r)
    # the memory's keys and values, once per valid frame and layer
    total += a["pnca_layers"] * 2 * 2 * frames * d * d
    for t in range(steps):
        band = frames if hb < 0 else \
            min(frames, (t + hb + 1) * r) - max(0, (t - hb) * r)
        total += a["pnca_layers"] * 2 * 2 * d * ((t + 1) + band)
    return total


def _postnet(a: Dict, frames: int) -> float:
    m, c, k, n = a["n_mels"], a["postnet_channels"], a["postnet_kernel"], \
        a["postnet_layers"]
    widths = [m] + [c] * (n - 1) + [m]
    return sum(2 * frames * k * i * o for i, o in zip(widths, widths[1:]))


def _vocoder(v: Dict, frames: int) -> float:
    ch = v["upsample_initial_channel"]
    t = frames
    total = 2 * t * v["n_mels"] * ch * 7
    taps = sum(k * len(ds) * 2 for k, ds in zip(v["resblock_kernels"],
                                              v["resblock_dilations"]))
    for r, k in zip(v["upsample_rates"], v["upsample_kernels"]):
        total += 2 * t * ch * (ch // 2) * k
        ch //= 2
        t *= r
        total += 2 * t * ch * ch * taps
    return total + 2 * t * ch * 7


def call_flops(c: Dict, cfg: Dict) -> float:
    a, v = cfg["sambert"], cfg["hifigan"]
    if c["kind"] == "probe":
        return sum(_encoder(a, n) + _head(a, n) for n in c["phones"])
    if c["kind"] == "synth":
        return sum(_encoder(a, n) + 3 * _head(a, n)
                   + 2 * 2 * n * 9 * a["d_model"] + _pnca(a, frames)
                   + _postnet(a, frames) + _vocoder(v, frames)
                   for n, frames in c["rows"])
    return 0.0


def conv_flops(c: Dict, cfg: Dict) -> float:
    """The convolutions of `c["replays"]` replays of the program
    `c["key"]`: ("dur", b, l) runs the duration head over b × l phones,
    ("synth", decoder, b, l, t_mel) the three heads and the embeddings
    over b × l phones, and the postnet and HiFi-GAN over b × ⌈t_mel / r⌉ · r
    frames."""
    a, v = cfg["sambert"], cfg["hifigan"]
    key = c["key"]
    if key[0] == "dur":
        _, b, l = key
        return c["replays"] * b * _head_convs(a, l)
    if key[0] == "synth":
        _, _, b, l, t_mel = key
        r = a["outputs_per_step"]
        frames = -(-t_mel // r) * r
        per_row = _adaptor_convs(a, l) + _postnet(a, frames) \
            + _vocoder(v, frames)
        return c["replays"] * b * per_row
    return 0.0
