"""Layer: the device. The share of the traced span in which nothing ran on
the card: 100 · (1 − busy / span), busy being the union of the kernel,
copy and memset intervals in the profiler's trace."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
