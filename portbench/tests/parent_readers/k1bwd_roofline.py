"""Layer: K1's backward (`csrc/fsmn_conv_dw.cu`: dx and dw of the FSMN
memory blocks). The least time for the backward's work of the training
steps the trace saw (x and the incoming gradient read once, dx written
once, the taps read and dw written once, at 3.35 TB/s; or the operations
at 67 TFLOP/s, the larger), over the device time of the kernels that
implement it."""
from portbench import flops

KERNEL = "fsmn_bwd_kernel"


def read(ctx):
    tr = ctx.get("trace")
    m = ctx["config"]["model"]
    d, k = m["d_model"], m["kernel_size"]
    work = []
    for c in ctx["calls"]:
        if c["kind"] == "train_step" and c.get("traced"):
            work += [(c["batch"], c["frames"], d, k, True)] * \
                m["encoder_layers"]
            work += [(c["batch"], c["k_max"], d, k, True)] * \
                m["decoder_layers"]
    if not tr or not work:
        return None
    t = sum(s for name, (_, s) in tr["kernels"].items() if KERNEL in name)
    if t <= 0:
        return None
    least = sum(flops.least_seconds(*flops.fsmn_backward(*w)) for w in work)
    return 100.0 * least / t
