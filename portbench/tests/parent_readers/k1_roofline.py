"""Layer: kernel K1 (`csrc/fsmn_conv.cu`, the FSMN memory blocks). The
least time the card could take for the FSMN blocks' work of the calls the
trace saw (each input read once and each output written once, for the
tensors the layers are given, at 3.35 TB/s; or the operations at 67
TFLOP/s, the larger), over the device time of the kernels that implement
it. The work is counted from the layers and the shapes of each traced
call in the window's record, never from launches."""
from portbench import flops

KERNEL = "fsmn_conv_kernel"


def blocks(c, m):
    """The FSMN memory blocks' shapes (b, t, d, k, masked) of one call."""
    d, k = m["d_model"], m["kernel_size"]
    if c["kind"] in ("transcribe", "train_step"):
        b = c["batch"] if c["kind"] == "train_step" else len(c["samples"])
        return [(b, c["frames"], d, k, True)] * m["encoder_layers"] + \
            [(b, c["k_max"], d, k, True)] * m["decoder_layers"]
    if c["kind"] == "tick":
        return [(c["rows"], c["frames"], d, k, False)] * \
            (c["count"] * m["encoder_layers"])
    return []


def read(ctx):
    tr = ctx.get("trace")
    m = ctx["config"]["model"]
    work = [w for c in ctx["calls"] if c.get("traced") for w in blocks(c, m)]
    if not tr or not work:
        return None
    t = sum(s for name, (_, s) in tr["kernels"].items() if KERNEL in name)
    if t <= 0:
        return None
    least = sum(flops.least_seconds(*flops.fsmn_forward(*w)) for w in work)
    return 100.0 * least / t
