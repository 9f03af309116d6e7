"""TTS parity metric: log-mel spectral distance between two waveforms
(port of `toolbox_for_asr_and_tts_tpu/tools/mel_distance.py`).

Frame-aligned dB-scale RMSE and correlation of the two waveforms' log-mel
spectra over the port's own fbank front end (`ops/frontend.fbank`, kernel
K2 on the card), trailing frames trimmed to the shorter:

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.mel_distance \
        a.wav b.wav [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


def log_mel(wav: np.ndarray, sr: int = 16000,
            device: DeviceLike = None) -> np.ndarray:
    """Natural-log mel spectrum [frames, n_mels] of a mono waveform, on
    `device` (the card unless "cpu" is passed)."""
    from ..ops import frontend as fe
    dev = resolve_device(device)
    cfg = fe.FrontendConfig(lfr_m=1, lfr_n=1)
    x = torch.from_numpy(np.ascontiguousarray(wav, np.float32))[None]
    with torch.inference_mode():
        return fe.fbank(x.to(dev), cfg)[0].cpu().numpy()


def mel_distance(a: np.ndarray, b: np.ndarray, sr: int = 16000,
                 device: DeviceLike = None) -> dict:
    """Frame-aligned spectral stats. Lengths may differ slightly (trailing
    frames are trimmed to the shorter)."""
    ma, mb = log_mel(a, sr, device), log_mel(b, sr, device)
    n = min(len(ma), len(mb))
    if n == 0:
        return {"frames": 0, "rmse_db": None, "corr": None}
    da, db = ma[:n], mb[:n]
    # natural-log mel → dB
    scale = 10.0 / np.log(10.0)
    rmse = float(np.sqrt(np.mean((da - db) ** 2)) * scale)
    corr = float(np.corrcoef(da.reshape(-1), db.reshape(-1))[0, 1])
    return {"frames": int(n), "len_ratio": float(len(ma) / max(len(mb), 1)),
            "rmse_db": rmse, "corr": corr}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    from ..utils.audio import ensure_mono_16k, read_wav
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    a, sra = read_wav(args.a)
    b, srb = read_wav(args.b)
    out = mel_distance(ensure_mono_16k(a, sra), ensure_mono_16k(b, srb),
                       device=args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
