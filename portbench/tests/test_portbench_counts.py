"""The yardstick's operation and byte counts at one small shape, counted
by hand, and the readers that turn them into shares."""
import pytest

from portbench import flops, harness
from portbench.trace import summarize


def test_fsmn_forward_counts():
    # x [2, 3, 4], taps [4, 1, 5], masked: x read and y written (2·24
    # floats), taps 20, mask 6; 2·5 per output tap, x·m, +x, ·m
    assert flops.fsmn_forward(2, 3, 4, 5, True) == (4 * (48 + 20 + 6),
                                                    240 + 72)
    assert flops.fsmn_forward(2, 3, 4, 5, False) == (4 * (48 + 20), 240 + 24)


def test_fsmn_backward_counts():
    # x and g read, dx written (3·24), taps read and dw written (2·20),
    # mask 6; dx and dw 2·5·24 each, the mask twice
    assert flops.fsmn_backward(2, 3, 4, 5, True) == (4 * (72 + 40 + 6),
                                                     480 + 48)


def test_model_counts():
    m = dict(d_model=4, ffn_dim=8, kernel_size=3, input_dim=4,
             encoder_layers=1, decoder_layers=1, predictor_kernel=3,
             vocab_size=10)
    # qkv 2·2·4·12, scores and values 2·2·2·2·4, out 2·2·4·4, taps 2·3·2·4,
    # ffn 2·2·2·4·8
    assert flops.encoder_layer(m, 2, 2, 4) == 192 + 64 + 64 + 48 + 256
    # conv 2·2·3·4·4, out 2·2·4, CIF 2·1·2·4
    assert flops.predictor(m, 2, 1) == 192 + 16 + 16
    # one token over 2 memory frames: ffn 2·2·4·8, taps 2·3·4, q 2·16,
    # kv 2·2·4·8, scores and values 2·2·2·4, out 2·16; final ffn 2·2·4·8,
    # output 2·4·10
    layer = 128 + 24 + 32 + 128 + 32 + 32
    assert flops.decoder(m, 1, 2) == layer + 128 + 80


def _tr(kernels, busy=1.0, window=2.0):
    return {"busy_s": busy, "window_s": window,
            "kernels": {k: [1, v] for k, v in kernels.items()}}


CFG = {"reference": "portbench/reference/paraformer.py",
       "model": dict(d_model=512, kernel_size=11, encoder_layers=2,
                     decoder_layers=1, ffn_dim=2048, input_dim=560,
                     predictor_kernel=3, vocab_size=100),
       "frontend": dict(lfr_n=6, frame_shift=160, frame_length=400),
       "online": dict(c0=0, c1=4, c2=5, encoder_look_back=4,
                      decoder_look_back=1, tokens_per_chunk=3)}


def test_readers():
    m = CFG["model"]
    call = {"kind": "transcribe", "traced": True, "samples": [16000] * 8,
            "tokens": [5] * 8, "bucket_samples": 32000, "frames": 100,
            "k_max": 20}
    work = [(8, 100, 512, 11, True)] * 2 + [(8, 20, 512, 11, True)]
    least = sum(flops.least_seconds(*flops.fsmn_forward(*w)) for w in work)
    model = sum(flops.offline_row(m, 17, 5) for _ in range(8))
    ctx = {"trace": _tr({"void fsmn_conv_kernel<float>": 4 * least,
                         "ampere_sgemm_128x64": 0.25}),
           "calls": [call, dict(call, traced=False)], "window_s": 2.0,
           "config": CFG}
    assert harness.read_metric("k1_roofline", ctx) == pytest.approx(25.0)
    assert harness.read_metric("device_idle_pct", ctx) == pytest.approx(50.0)
    assert harness.read_metric("linear_share_pct", ctx) == pytest.approx(25.0)
    # 16000 samples: 98 fbank frames, 17 LFR frames
    assert harness.read_metric("mfu_pct", ctx) == pytest.approx(
        100.0 * 2 * model / 2.0 / flops.PEAK_F32_FLOPS)
    assert harness.read_metric("pad_waste_pct", ctx) == pytest.approx(50.0)
    # nothing to read: nothing reported, never a 0 share
    empty = {"trace": None, "calls": [], "window_s": 1.0, "config": CFG}
    for name in ("k1_roofline", "k1bwd_roofline", "device_idle_pct",
                 "mfu_pct", "linear_share_pct", "pad_waste_pct",
                 "lateness_p95_ms", "rows_per_tick", "hub_tick_ms"):
        assert harness.read_metric(name, empty) is None


def test_train_and_stream_readers():
    m, o = CFG["model"], CFG["online"]
    step = {"kind": "train_step", "traced": True, "batch": 4, "frames": 50,
            "k_max": 10, "tokens": 30}
    work = [(4, 50, 512, 11, True)] * 2 + [(4, 10, 512, 11, True)]
    bwd = sum(flops.least_seconds(*flops.fsmn_backward(*w)) for w in work)
    ctx = {"trace": _tr({"fsmn_bwd_kernel": 2 * bwd}), "calls": [step],
           "window_s": 1.0, "config": CFG}
    assert harness.read_metric("k1bwd_roofline", ctx) == pytest.approx(50.0)
    zero, one = flops.offline_row(m, 50, 0), flops.offline_row(m, 50, 1)
    assert harness.read_metric("mfu_pct.train", ctx) == pytest.approx(
        100.0 * 3 * (4 * zero + 30 * (one - zero)) / flops.PEAK_F32_FLOPS)
    # a stream: two frames of 1.5 chunks, one final of 2 tokens, a cut
    # utterance of 1; 3 replays of the 8-row tick program traced
    calls = [{"kind": "frame", "samples": 5760, "due_s": 0.1, "late_s": 0.001},
             {"kind": "frame", "samples": 5760, "due_s": 0.5, "late_s": 0.003},
             {"kind": "finalize", "tokens": 2}, {"kind": "cut", "tokens": 1},
             {"kind": "tick", "traced": True, "rows": 8, "frames": 9,
              "count": 3}]
    fwd = flops.least_seconds(*flops.fsmn_forward(8, 9, 512, 11, False))
    ctx = {"trace": _tr({"fsmn_conv_kernel": 6 * 3 * fwd}), "calls": calls,
           "window_s": 1.0, "config": CFG, "trace_cut_s": 0.3,
           "hub": {"ticks": 4, "submissions": 10, "tick_s": 0.2,
                   "tick_count": 4}}
    assert harness.read_metric("k1_roofline.stream", ctx) == \
        pytest.approx(100 / 3)
    want = (5 * flops.stream_step(m, o) + 3 * flops.stream_token(m, o))
    assert harness.read_metric("mfu_pct.stream", ctx) == pytest.approx(
        100.0 * want / flops.PEAK_F32_FLOPS)
    assert harness.read_metric("lateness_p95_ms.stream", ctx) == \
        pytest.approx(1.0)
    assert harness.read_metric("rows_per_tick.stream", ctx) == 2.5
    assert harness.read_metric("hub_tick_ms.stream", ctx) == \
        pytest.approx(50.0)


def _span(name, i, start, end, parent=None, thread="MainThread"):
    return {"name": name, "id": i, "parent": parent, "request": i,
            "cause": None, "thread": thread, "start_ns": start,
            "end_ns": end}


def test_span_and_counter_readers():
    ms = 1_000_000
    # 20 submissions waiting 1..20 ms; two ticks of 10 and 30 ms with 1 and
    # 3 ms of lock wait; holds of 4 and 8 ms
    spans = [_span("hub.queue", i, 0, (i + 1) * ms) for i in range(20)]
    spans += [_span("hub.tick", 30, 0, 10 * ms),
              _span("hub.lock_wait", 31, 0, 1 * ms, 30),
              _span("hub.tick", 32, 20 * ms, 50 * ms),
              _span("hub.lock_wait", 33, 20 * ms, 23 * ms, 32),
              _span("hub.finalize.hold", 34, 0, 4 * ms),
              _span("hub.finalize.hold", 35, 0, 8 * ms)]
    ctx = {"spans": spans, "counters": {"rows_stepped": 64,
                                        "rows_active": 4}}
    assert harness.read_metric("hub_queue_p95_ms.stream", ctx) == \
        pytest.approx(19.05)
    assert harness.read_metric("lock_wait_pct.stream", ctx) == \
        pytest.approx(10.0)
    assert harness.read_metric("finalize_hold_ms.stream", ctx) == \
        pytest.approx(6.0)
    assert harness.read_metric("cover_waste_pct.stream", ctx) == \
        pytest.approx(93.75)
    # two calls of 30 and 40 ms, 20 and 28 of it in fetches, one of them
    # under a child span; a fetch of no call counts for none
    calls = [_span("recognizer.transcribe", 1, 0, 30 * ms),
             _span("program.fetch", 2, 5 * ms, 25 * ms, 1),
             _span("recognizer.transcribe", 3, 40 * ms, 80 * ms),
             _span("recognizer.rescore", 4, 45 * ms, 75 * ms, 3),
             _span("program.fetch", 5, 45 * ms, 73 * ms, 4),
             _span("program.fetch", 6, 90 * ms, 99 * ms)]
    assert harness.read_metric("transcribe_host_ms", {"spans": calls}) == \
        pytest.approx(11.0)
    for name in ("hub_queue_p95_ms", "lock_wait_pct", "finalize_hold_ms",
                 "cover_waste_pct", "transcribe_host_ms"):
        assert harness.read_metric(name, {"spans": [], "counters": {}}) \
            is None


def test_idle_by_span():
    # traced 0–100 µs; the card busy 10–20 and 60–100: idle 0–10, 20–60.
    # The replaying thread has `outer` 0–50 over `inner` 25–35; `hub.queue`
    # and a thread that replays nothing are left out
    dev = [("k", 10.0, 20.0), ("k", 60.0, 100.0)]
    program = [("outer", "T", 0.0, 50.0), ("inner", "T", 25.0, 35.0),
               ("program.replay", "T", 10.0, 20.0),
               ("hub.queue", "T", 0.0, 100.0),
               ("elsewhere", "U", 0.0, 100.0)]
    s = summarize(dev, [], 100e-6, program, (0.0, 100.0))
    got = {n: v for n, v in s["idle_by_span"]}
    # outer: 0–10, 20–25, 35–50; inner 25–35; none 50–60
    assert got == {"outer": pytest.approx(30e-6),
                   "inner": pytest.approx(10e-6),
                   "(none)": pytest.approx(10e-6)}
    assert s["idle_by_span"][-1][0] == "(none)"
    assert sum(got.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    # the gaps name the program's span too
    assert s["idle_gaps"][0][0].startswith("no benchmark span open / outer")
    # no program spans recorded: no split
    assert "idle_by_span" not in summarize(dev, [], 100e-6)


def test_trace_busy_is_a_union():
    dev = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 30.0, 40.0),
           ("d", 90.0, 120.0)]
    spans = [("transcribe", 0.0, 50.0), ("fetch", 20.0, 25.0)]
    s = summarize(dev, spans, 130e-6)
    assert s["busy_s"] == pytest.approx(55e-6)       # 15 + 10 + 30
    assert s["window_s"] == pytest.approx(130e-6)
    assert s["kernels"]["b"] == [1, pytest.approx(10e-6)]
    assert s["idle_gaps"][0][1] == pytest.approx(50e-6)   # 40–90
    assert s["idle_gaps"][0][0].startswith("no benchmark span open")
    assert s["idle_gaps"][1][0].startswith("fetch")        # 15–30, mid 22.5
    assert s["device_ops"][0][0] in ("b", "c", "a", "d")


def test_partials_behind_counts_what_was_due():
    from portbench.check import partials_behind
    # CIF mass after each chunk; token 1 fires within 5e-4 of the end of
    # chunk 2, so rounding may move it to chunk 3
    utt = {"masses": [0.5, 1.2, 2.0005, 3.5],
           "tokens": [(None, 1), (None, 2), (None, 3)]}
    # frame k's partial is due the tokens of chunks t ≤ ⌊6400k/3840⌋ − 1:
    # none, none, token 0 (token 1 is fragile), all three
    assert partials_behind([utt], [[[], [], [7], [7, 8, 9]]], 6400, 3840,
                           1e-3) == 0
    assert partials_behind([utt], [[[], [], [7], [7, 8]]], 6400, 3840,
                           1e-3) == 1
    assert partials_behind([utt], [[[], [], [], [7, 8, 9]]], 6400, 3840,
                           1e-3) == 1
    # a stale partial falls behind on every frame that was due a token
    assert partials_behind([utt], [[[]] * 4], 6400, 3840, 1e-3) == 2
