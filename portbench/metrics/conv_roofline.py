"""Layer: `models/hifigan.py` and the postnet (cuDNN float32
convolutions). The least time of the convolutions of the synthesizer's
replays that the profile saw, their FLOPs at the card's float32 peak (67
TFLOP/s; `portbench/families/<family>.py::conv_flops`, from each replay's
rows, phone bucket and mel length), over the device time of the
convolution kernels in the trace. Replays are counted under the replay
lock as the profile began and stopped, so each ran wholly inside it."""
from portbench import flops, harness

# cuDNN's convolution kernels and its layout transforms around them
PATTERNS = ("conv", "fprop", "cudnn", "winograd", "fft")


def is_convolution(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in PATTERNS)


def read(ctx):
    tr = ctx.get("trace")
    replays = [c for c in ctx["calls"] if c["kind"] == "replay"]
    family = harness.family(ctx["config"])
    if not tr or not replays or not hasattr(family, "conv_flops"):
        return None
    t = sum(s for name, (_, s) in tr["kernels"].items()
            if is_convolution(name))
    work = sum(family.conv_flops(c, ctx["config"]) for c in replays)
    if t <= 0 or work <= 0:
        return None
    return 100.0 * work / flops.PEAK_F32_FLOPS / t
