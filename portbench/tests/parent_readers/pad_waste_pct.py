"""Layer: `asr/recognizer.py` (bucketing). Padded samples over bucket
samples in the window: each transcribe's rows against the audio bucket
(`runtime/bucketing.py`) the recognizer padded them to."""


def read(ctx):
    calls = [c for c in ctx["calls"] if c["kind"] == "transcribe"]
    bucket = sum(c["bucket_samples"] * len(c["samples"]) for c in calls)
    if not bucket:
        return None
    valid = sum(sum(c["samples"]) for c in calls)
    return 100.0 * (bucket - valid) / bucket
