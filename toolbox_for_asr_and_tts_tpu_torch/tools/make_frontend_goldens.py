"""Generate EXTERNALLY-AUTHORED golden fbank vectors for the DSP frontend.

Port's copy of `toolbox_for_asr_and_tts_tpu/tools/make_frontend_goldens.py`
(a CPU tool: it needs HuggingFace `transformers`, imported only inside
`main`). The goldens lock `ops/frontend.py`'s kaldi semantics against code
that shares no authorship with this repo: HuggingFace transformers'
`audio_utils` (`mel_filter_bank(mel_scale="kaldi",
triangularize_in_mel_space=True)` + `spectrogram(center=False,
preemphasis=0.97, remove_dc_offset=True, mel_floor=FLT_EPSILON)`), the
library's documented replication of `torchaudio.compliance.kaldi.fbank`
(the torchaudio-free fallback of its AST feature extractor). A shared
misreading of the kaldi spec (window normalization, pre-emphasis edge,
mel-bank rounding) cannot pass both sides.

Provenance is recorded inside the npz (`_provenance` key). Regenerate with:

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.make_frontend_goldens \
        [OUT.npz]

OUT defaults to tests/data/frontend_goldens.npz, which
tests/test_frontend_goldens.py and tests/test_torch_port_frontend.py read.
Settings mirror FunASR's WavFrontend: 16 kHz, 25 ms / 10 ms frames, 80 mel
bins, low_freq 20, snip_edges, dither off, int16 input scaling.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

SR = 16000
FLT_EPS = 1.1920928955078125e-07     # torch.finfo(float32).eps
WINDOWS = ("hamming", "hanning", "povey")


def make_waveforms() -> dict:
    """Deterministic stimuli covering the error-prone regimes: tonal,
    broadband, transient (DC-removal + frame edges), near-silence
    (mel_floor), and an odd length that is not a hop multiple."""
    rng = np.random.default_rng(20260819)
    t1 = np.arange(SR) / SR
    tone = (0.3 * np.sin(2 * np.pi * 220 * t1)
            + 0.05 * rng.standard_normal(SR))
    t2 = np.arange(int(1.6 * SR)) / SR
    # 2e-3 noise floor (~66 int16 LSB, −46 dB vs carrier): a pure tone's
    # far-sidelobe leakage sits >30 log units below the carrier, where an
    # f32 FFT cannot represent it faithfully (relative ε ≈ 1e-7 of carrier
    # energy scatters into every bin) — the goldens are f64. Real audio
    # never has that dynamic range; the noise floor keeps every mel bin in
    # the f32-faithful regime without weakening the semantic checks.
    chirp = (0.4 * np.sin(2 * np.pi * (100 * t2 + 1900 * t2 ** 2))
             + 2e-3 * rng.standard_normal(len(t2)))
    n3 = int(0.73 * SR)                      # odd vs the 160-sample hop
    impulses = 1e-4 * rng.standard_normal(n3)
    impulses[::1111] = 0.9
    impulses += 0.02                          # DC offset → remove_dc path
    noise = 0.2 * rng.standard_normal(int(2.0 * SR))
    # crude speech-shaped tilt: integrate white noise (−6 dB/oct)
    speechy = np.cumsum(0.02 * rng.standard_normal(int(1.2 * SR)))
    speechy -= speechy.mean()
    quiet = 1e-5 * rng.standard_normal(int(0.5 * SR))
    return {"tone": tone, "chirp": chirp, "impulses": impulses,
            "noise": noise, "speechy": speechy, "quiet": quiet}


def main(out_path: str | None = None) -> str:
    import transformers
    from transformers.audio_utils import (mel_filter_bank, spectrogram,
                                          window_function)
    banks = mel_filter_bank(
        num_frequency_bins=257, num_mel_filters=80, min_frequency=20.0,
        max_frequency=SR / 2.0, sampling_rate=SR, norm=None,
        mel_scale="kaldi", triangularize_in_mel_space=True)
    payload: dict = {"melbank": banks}
    for wname in WINDOWS:
        # kaldi windows are symmetric (periodic=False); "hanning" is
        # kaldi's name for hann
        hf_name = {"hanning": "hann"}.get(wname, wname)
        payload[f"window_{wname}"] = window_function(
            400, hf_name, periodic=False)
    waves = make_waveforms()
    for name, wav in waves.items():
        wav = wav.astype(np.float64)
        payload[f"wav_{name}"] = wav.astype(np.float32)
        for wname in WINDOWS:
            fb = spectrogram(
                wav * 32768.0, payload[f"window_{wname}"],
                frame_length=400, hop_length=160, fft_length=512,
                power=2.0, center=False, preemphasis=0.97,
                mel_filters=banks, log_mel="log", mel_floor=FLT_EPS,
                remove_dc_offset=True, dtype=np.float64).T
            payload[f"fbank_{name}_{wname}"] = fb.astype(np.float32)
    payload["_provenance"] = np.bytes_(json.dumps({
        "generator": "transformers.audio_utils (HuggingFace)",
        "transformers_version": transformers.__version__,
        "semantics": "torchaudio.compliance.kaldi.fbank replication "
                     "(AST feature extractor fallback path)",
        "settings": {"sr": SR, "frame": 400, "hop": 160, "fft": 512,
                     "n_mels": 80, "low_freq": 20.0, "high_freq": 8000.0,
                     "preemphasis": 0.97, "remove_dc_offset": True,
                     "snip_edges": True, "dither": 0.0,
                     "mel_floor": FLT_EPS, "int16_scale": True,
                     "windows": list(WINDOWS)},
        "date": "2026-08-19",
    }))
    if out_path is None:
        out_path = os.path.join(os.path.dirname(__file__), "..", "..",
                                "tests", "data", "frontend_goldens.npz")
    out_path = os.path.abspath(out_path)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez_compressed(out_path, **payload)
    print(f"wrote {out_path} "
          f"({os.path.getsize(out_path) / 1024:.0f} KiB, "
          f"{len(waves)} waveforms × {len(WINDOWS)} windows)")
    return out_path


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="write the frontend goldens")
    ap.add_argument("out", nargs="?", default=None,
                    help="output .npz (default tests/data/frontend_goldens.npz)")
    main(ap.parse_args().out)
