"""Layer: `asr/recognizer.py::transcribe` (the host). The mean time of a
`recognizer.transcribe` span less the `program.fetch` spans inside it (the
host waiting for the card), over the spans that ended before the profile
began: the host's own time per call."""


def read(ctx):
    spans = ctx.get("spans") or ()
    by_id = {s["id"]: s for s in spans}
    fetch = {}
    for s in spans:
        if s["name"] != "program.fetch":
            continue
        up = by_id.get(s["parent"])
        while up is not None and up["name"] != "recognizer.transcribe":
            up = by_id.get(up["parent"])
        if up is not None:
            fetch[up["id"]] = fetch.get(up["id"], 0) + \
                s["end_ns"] - s["start_ns"]
    host = [s["end_ns"] - s["start_ns"] - fetch.get(s["id"], 0)
            for s in spans if s["name"] == "recognizer.transcribe"]
    if not host:
        return None
    return 1e-6 * sum(host) / len(host)
