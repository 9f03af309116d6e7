"""Layer: `tts/synthesizer.py` (the mel buckets). The share of the mel
frames that the decoder and vocoder computed beyond the segments' own mel
lengths: 100 · (`mel_frames` − `mel_frames_valid`) / `mel_frames`, the
synthesizer's counters outside the profile (`ctx["counters"]`)."""


def read(ctx):
    c = ctx.get("counters") or {}
    if not c.get("mel_frames") or "mel_frames_valid" not in c:
        return None
    return 100.0 * (c["mel_frames"] - c["mel_frames_valid"]) / c["mel_frames"]
