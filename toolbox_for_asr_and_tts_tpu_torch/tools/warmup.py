"""Serving warmup: make the first requests find everything ready.

Port of `toolbox_for_asr_and_tts_tpu/tools/warmup.py`. The reference warms
XLA's per-bucket compilations; the port compiles nothing per shape, and
its first-call costs are the CUDA kernels' build (or the load of the
cached build), the cuBLAS / cuDNN handles and their per-shape plans, and
the caching allocator's first blocks. This tool drives each engine through
its serving buckets with dummy inputs on the card: every audio bucket
through `transcribe` and the phase-2 rescoring program (which a real
checkpoint never reaches on silence), and optionally the TTS synthesizer.

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.warmup [--seconds 1 2 4 10] [--tts]
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np

logger = logging.getLogger("toolbox.warmup")


def warmup_asr(engines, seconds, batch_sizes=(1,)) -> dict:
    reco = engines.diarizer.recognizer
    timings = {}
    for s in seconds:
        for b in batch_sizes:
            wavs = [np.zeros(int(16000 * s), np.float32)] * b
            t0 = time.perf_counter()
            reco.transcribe(wavs)
            reco.warmup_rescoring(b, int(16000 * s))
            timings[f"asr_{s}s_b{b}"] = round(time.perf_counter() - t0, 2)
    return timings


def warmup_tts(synth, texts=("你好。", "一" * 20 + "。")) -> dict:
    timings = {}
    for i, t in enumerate(texts):
        t0 = time.perf_counter()
        synth.synthesize(t)
        timings[f"tts_{i}"] = round(time.perf_counter() - t0, 2)
    return timings


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", nargs="*", type=float, default=[1, 2, 4, 10])
    ap.add_argument("--model-dir", default=None)
    ap.add_argument("--tts", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..service.engines import build_engines
    engines = build_engines(args.model_dir, device=args.device)
    try:
        report = warmup_asr(engines, args.seconds)
    finally:
        engines.close()
    if args.tts:
        from ..tts.synthesizer import Synthesizer
        report.update(warmup_tts(Synthesizer.random(tiny=False,
                                                    device=args.device)))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
