"""Layer: the model step. The window's model FLOPs, each call counted by
the configuration's family (`portbench/families/<family>.py::call_flops`,
from the configuration's shapes and the valid frames and tokens of each
call in the window's record), over the window's wall time and the card's
dense float32 peak outside the tensor cores (H100 SXM: 67 TFLOP/s at
700 W). Read only where the trace saw the card work, so no CPU run
reports it."""
from portbench import flops, harness


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0 or not ctx.get("window_s"):
        return None
    family = harness.family(ctx["config"])
    total = sum(family.call_flops(c, ctx["config"]) for c in ctx["calls"])
    if total <= 0:
        return None
    return 100.0 * total / ctx["window_s"] / flops.PEAK_F32_FLOPS
