"""Layer: `service/hub.py::ChunkedHub`. The mean wall time of a tick over
the window, from the hub's `chunked` tick histogram in the service's
metric registry (sum over count)."""


def read(ctx):
    hub = ctx.get("hub")
    if not hub or not hub["tick_count"]:
        return None
    return 1e3 * hub["tick_s"] / hub["tick_count"]
