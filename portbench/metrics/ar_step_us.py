"""Layer: `models/sambert.py::_pnca_scan` (the PNCA decoder's steps). The
device time of the synthesizer's replays that the profile saw, less their
convolution kernels (`conv_roofline`'s), over the AR steps of the traced
synthesis replays (⌈t_mel / r⌉ per replay, from the replays counted under
the replay lock as the profile began and stopped). Copies and memsets are
left out; the duration probes' and the encoder's kernels, and the
elementwise passes of the postnet and HiFi-GAN, stay in."""
from portbench import harness

CONVOLUTION = harness.load_module(harness.metric_path("conv_roofline"),
                                  "portbench_metric_conv_roofline_base")


def read(ctx):
    tr = ctx.get("trace")
    r = ctx["config"].get("sambert", {}).get("outputs_per_step")
    steps = sum(c["replays"] * -(-c["key"][-1] // r) for c in ctx["calls"]
                if c["kind"] == "replay" and c["key"][0] == "synth")
    if not tr or not steps:
        return None
    t = sum(s for name, (_, s) in tr["kernels"].items()
            if not CONVOLUTION.is_convolution(name)
            and not name.lower().startswith(("memcpy", "memset")))
    if t <= 0:
        return None
    return 1e6 * t / steps
