"""Layer: `service/hub.py::ChunkedHub` (queue and gather). The 95th
percentile of the program's `hub.queue` spans: each submission from its
`submit` until the tick that carries it holds the ticker lock. Over the
spans that ended before the profile began (`ctx["spans"]`)."""
import numpy as np


def read(ctx):
    waits = [s["end_ns"] - s["start_ns"] for s in ctx.get("spans") or ()
             if s["name"] == "hub.queue"]
    if not waits:
        return None
    return 1e-6 * float(np.percentile(np.asarray(waits, np.float64), 95))
