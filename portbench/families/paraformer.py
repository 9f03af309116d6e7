"""The Paraformer family (`portbench/reference/paraformer.py`): what the
harness and its readers need to know of a configuration whose `reference`
names that file.

- `TINY`: the geometry the benchmark's CPU tests run it at, by group of
  the configuration file;
- `call_flops(call, config)`: the model FLOPs of one call in a window's
  record (`portbench/flops.py`; a training step counts forward, backward
  and update as three forwards).

Its configurations are held to the program's geometry by
`portbench/tests/test_family_paraformer.py`.
"""
from portbench import flops
from portbench.reference.paraformer import n_fbank_frames

TINY = {"model": dict(d_model=32, n_heads=2, ffn_dim=64, encoder_layers=2,
                      decoder_layers=2, vocab_size=64)}


def call_flops(c, cfg):
    m, fe, o = cfg["model"], cfg["frontend"], cfg.get("online")
    if c["kind"] == "transcribe":
        return sum(flops.offline_row(
            m, -(-n_fbank_frames(n, fe) // fe["lfr_n"]), k)
            for n, k in zip(c["samples"], c["tokens"]))
    if c["kind"] == "train_step":
        zero = flops.offline_row(m, c["frames"], 0)
        one = flops.offline_row(m, c["frames"], 1)
        return 3 * (c["batch"] * zero + c["tokens"] * (one - zero))
    if c["kind"] == "frame":
        chunk = o["c1"] * fe["lfr_n"] * fe["frame_shift"]
        return c["samples"] / chunk * flops.stream_step(m, o)
    if c["kind"] == "finalize":
        # the drain's two silence chunks, and the final's tokens
        return 2 * flops.stream_step(m, o) + \
            c["tokens"] * flops.stream_token(m, o)
    if c["kind"] == "cut":
        return c["tokens"] * flops.stream_token(m, o)
    return 0.0
