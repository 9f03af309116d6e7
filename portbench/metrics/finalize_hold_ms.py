"""Layer: `service/hub.py::ChunkedHub` (`finalize`). The mean time a
finalize holds the ticker lock (`hub.finalize.hold`: the take of its row),
over the spans that ended before the profile began."""


def read(ctx):
    holds = [s["end_ns"] - s["start_ns"] for s in ctx.get("spans") or ()
             if s["name"] == "hub.finalize.hold"]
    if not holds:
        return None
    return 1e-6 * sum(holds) / len(holds)
