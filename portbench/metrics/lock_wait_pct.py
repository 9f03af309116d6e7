"""Layer: `service/hub.py::ChunkedHub` (the ticker lock). The share of the
ticks' wall time spent waiting for the ticker lock: 100 · Σ `hub.lock_wait`
/ Σ `hub.tick`, over the spans that ended before the profile began."""


def read(ctx):
    total = {"hub.tick": 0, "hub.lock_wait": 0}
    for s in ctx.get("spans") or ():
        if s["name"] in total:
            total[s["name"]] += s["end_ns"] - s["start_ns"]
    if total["hub.tick"] <= 0:
        return None
    return 100.0 * total["hub.lock_wait"] / total["hub.tick"]
