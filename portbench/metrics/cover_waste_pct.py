"""Layer: `parallel/stream_batcher.py::BatchedChunkedASR` (the pow-2
cover). The share of the rows the ticks' steps covered that carried no
chunk: 100 · (`rows_stepped` − `rows_active`) / `rows_stepped`, the
ticker's counters over the window before the profile began
(`ctx["counters"]`)."""


def read(ctx):
    c = ctx.get("counters") or {}
    if not c.get("rows_stepped"):
        return None
    return 100.0 * (c["rows_stepped"] - c["rows_active"]) / c["rows_stepped"]
