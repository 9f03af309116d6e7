"""Layer: `service/hub.py::ChunkedHub`. Session submissions per device
tick over the window: the hub's own `submissions` over its `ticks`."""


def read(ctx):
    hub = ctx.get("hub")
    if not hub or not hub["ticks"]:
        return None
    return hub["submissions"] / hub["ticks"]
