"""Command-line tools of the port, on the card unless `--device cpu`.

    python -m toolbox_for_asr_and_tts_tpu_torch.cli transcribe a.wav [--itn] [--model-dir D] [--no-mesh]
    python -m toolbox_for_asr_and_tts_tpu_torch.cli tts "文本" -o out.wav [--stream] [--tiny]
    python -m toolbox_for_asr_and_tts_tpu_torch.cli serve-voice / serve-tts
    python -m toolbox_for_asr_and_tts_tpu_torch.cli demo recording.wav
    python -m toolbox_for_asr_and_tts_tpu_torch.cli rehearse MODELS_DIR [--reconvert]

Port of `toolbox_for_asr_and_tts_tpu/cli.py`. Every command takes
`--device` (default `cuda`); `transcribe --no-mesh` keeps the offline
recognizer on one device instead of the serving mesh. Departure: `tts`
raises when a mounted checkpoint fails to load (the reference logs it and
synthesizes with random weights).
"""
from __future__ import annotations

import argparse
import json
import logging
import sys


def cmd_transcribe(args) -> None:
    from .service.engines import build_engines
    engines = build_engines(args.model_dir, device=args.device,
                            use_mesh=not args.no_mesh)
    try:
        for path in args.wavs:
            sents = engines.diarizer.diarize(_load(path))
            text = "".join(s.text for s in sents)
            if args.itn:
                from .asr.itn import apply_itn
                text = apply_itn(text)
            print(json.dumps({
                "file": path,
                "text": text,
                "sentences": [vars(s) for s in sents],
            }, ensure_ascii=False), flush=True)
    finally:
        engines.close()


def cmd_tts(args) -> None:
    from .runtime.registry import resolve
    from .tts.synthesizer import Synthesizer
    from .utils.audio import write_wav
    d = None if args.tiny else resolve("tts", args.model_dir)
    if d is not None:
        synth = Synthesizer.from_model_dir(d, voice=args.voice,
                                           device=args.device)
    else:
        synth = Synthesizer.random(tiny=args.tiny, device=args.device)
    if args.stream:
        # streaming path: report time-to-first-audio; the WAV on disk is
        # the same samples the WS endpoint would deliver incrementally
        import time as _t
        import numpy as np
        t0 = _t.perf_counter()
        ttfa = None
        chunks = []
        done = None
        for ev in synth.synthesize_stream(args.text, voice=args.voice):
            if len(ev["audio"]) and ttfa is None:
                ttfa = _t.perf_counter() - t0
            chunks.append(ev["audio"])
            if ev["event"] == "done":
                done = ev
        wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        write_wav(args.output, wav, synth.sample_rate)
        print(json.dumps({"output": args.output, "rtf": done["rtf"],
                          "seconds": len(wav) / synth.sample_rate,
                          "time_to_first_audio_s": round(ttfa or 0.0, 4),
                          "segments": done["segments"]}, ensure_ascii=False))
        return
    res = synth.synthesize(args.text, voice=args.voice)
    write_wav(args.output, res.wav, res.sample_rate)
    print(json.dumps({"output": args.output, "rtf": res.rtf,
                      "seconds": len(res.wav) / res.sample_rate,
                      "segments": res.segments}, ensure_ascii=False))


def cmd_serve_voice(args) -> None:
    from .service.voice_app import main as voice_main
    voice_main(device=args.device)


def cmd_serve_tts(args) -> None:
    from .service.tts_app import main as tts_main
    tts_main(device=args.device)


def cmd_demo(args) -> None:
    from .demo.full_voice_demo import main as demo_main
    demo_main([args.wav, "--torch-device", args.device])


def cmd_rehearse(args) -> None:
    from .tools.rehearse import main as rehearse_main
    argv = [args.models_dir, "--device", args.device]
    for flag in ("report", "golden_wav"):
        v = getattr(args, flag)
        if v:
            argv += [f"--{flag.replace('_', '-')}", v]
    for flag in ("reconvert", "no_serve", "lenient"):
        if getattr(args, flag):
            argv.append(f"--{flag.replace('_', '-')}")
    rehearse_main(argv)


def _load(path: str):
    from .utils.audio import ensure_mono_16k, read_wav
    x, sr = read_wav(path)
    return ensure_mono_16k(x, sr)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(prog="toolbox_for_asr_and_tts_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def command(name: str, fn, help: str) -> argparse.ArgumentParser:
        p = sub.add_parser(name, help=help)
        p.add_argument("--device", default="cuda",
                       help="where the models run (cuda, or cpu)")
        p.set_defaults(fn=fn)
        return p

    t = command("transcribe", cmd_transcribe, "offline ASR on WAV files")
    t.add_argument("wavs", nargs="+")
    t.add_argument("--model-dir", default=None)
    t.add_argument("--itn", action="store_true")
    t.add_argument("--no-mesh", action="store_true")

    s = command("tts", cmd_tts, "synthesize text to WAV")
    s.add_argument("text")
    s.add_argument("-o", "--output", default="tts_out.wav")
    s.add_argument("--voice", default="zhitian_emo")
    s.add_argument("--model-dir", default=None)
    s.add_argument("--tiny", action="store_true")
    s.add_argument("--stream", action="store_true",
                   help="streaming synthesis; prints time-to-first-audio")

    command("serve-voice", cmd_serve_voice, "run the voice service")
    command("serve-tts", cmd_serve_tts, "run the TTS service")

    d = command("demo", cmd_demo, "file-driven full voice demo")
    d.add_argument("wav")

    r = command("rehearse", cmd_rehearse,
                "real-checkpoint mount rehearsal: strict-convert all "
                "families, boot both services, drive golden inputs, emit a "
                "report")
    r.add_argument("models_dir")
    r.add_argument("--report", default=None)
    r.add_argument("--reconvert", action="store_true")
    r.add_argument("--no-serve", action="store_true")
    r.add_argument("--golden-wav", default=None)
    r.add_argument("--lenient", action="store_true")

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
