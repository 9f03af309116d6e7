"""Layer: `runtime/graphs.py`, `runtime/train_graph.py`. CUDA graph
captures made during the window: `graphs.report()`'s captures summed over
owners, after the window minus before it."""


def read(ctx):
    return ctx.get("captures_window")
