"""Layer: the load generator (`portbench/drivers/stream.py`). The 95th
percentile of how late each frame was handed to its session, against the
frame's due time, over the frames due before the profile began (a traced
run holds the load back while the profiler starts and stops): it grows
when sessions wait on their partials longer than a frame period."""
import numpy as np


def read(ctx):
    cut = ctx.get("trace_cut_s")
    late = [c["late_s"] for c in ctx["calls"] if c["kind"] == "frame"
            and (cut is None or c["due_s"] < cut)]
    if not late:
        return None
    return 1e3 * float(np.percentile(np.asarray(late, np.float64), 95))
