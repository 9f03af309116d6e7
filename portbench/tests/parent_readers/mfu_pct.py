"""Layer: the model step (`models/paraformer.py`,
`models/paraformer_online.py`). The window's model FLOPs, counted from the
configuration's shapes and the valid frames and tokens of each call in the
window's record (`portbench/flops.py`; a training step counts forward,
backward and update as three forwards), over the window's wall time and
the card's dense float32 peak outside the tensor cores (H100 SXM: 67
TFLOP/s at 700 W). Read only where the trace saw the card work, so no CPU
run reports it."""
from portbench import flops
from portbench.reference.paraformer import n_fbank_frames


def call_flops(c, cfg):
    m, fe, o = cfg["model"], cfg["frontend"], cfg.get("online")
    if c["kind"] == "transcribe":
        return sum(flops.offline_row(
            m, -(-n_fbank_frames(n, fe) // fe["lfr_n"]), k)
            for n, k in zip(c["samples"], c["tokens"]))
    if c["kind"] == "train_step":
        zero = flops.offline_row(m, c["frames"], 0)
        one = flops.offline_row(m, c["frames"], 1)
        return 3 * (c["batch"] * zero + c["tokens"] * (one - zero))
    if c["kind"] == "frame":
        chunk = o["c1"] * fe["lfr_n"] * fe["frame_shift"]
        return c["samples"] / chunk * flops.stream_step(m, o)
    if c["kind"] == "finalize":
        # the drain's two silence chunks, and the final's tokens
        return 2 * flops.stream_step(m, o) + \
            c["tokens"] * flops.stream_token(m, o)
    if c["kind"] == "cut":
        return c["tokens"] * flops.stream_token(m, o)
    return 0.0


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0 or not ctx.get("window_s"):
        return None
    total = sum(call_flops(c, ctx["config"]) for c in ctx["calls"])
    if total <= 0:
        return None
    return 100.0 * total / ctx["window_s"] / flops.PEAK_F32_FLOPS
