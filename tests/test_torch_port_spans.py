"""The port's spans and counters (`runtime/profiling.py`) on the CPU: the
recorder off and on, parents, requests and causes, a full buffer, the
profiler's clock and `trace_to`'s Chrome trace; then the spans a tiny
`ChunkedHub`, the unfused ticker and a tiny `Recognizer` record, and the
tickers' `rows_stepped` / `rows_active` against the pow-2 cover; and the
spans of a TTS job through `TTSJobManager` over a tiny PNCA `Synthesizer`
and its `mel_frames_valid` counter."""
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import stream_batcher as sb  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import profiling  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime.bucketing import Bucketer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.service import hub  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tts.jobs import TTSJobManager  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer  # noqa: E402

TINY = pf.ParaformerConfig(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
                           encoder_layers=2, decoder_layers=2, vocab_size=64)
SR = 16000
CHUNK = 6400   # the WebSocket protocol's 0.4 s


@pytest.fixture(autouse=True)
def _recording_off(monkeypatch):
    """Each test starts and ends with recording off and an empty buffer;
    the tickers upload f32 and build their programs on first use."""
    monkeypatch.setenv("PARAFORMER_TRANSFER_INT16", "0")
    monkeypatch.setenv("VOICE_AOT_TICKS", "0")
    profiling.set_recording(False)
    profiling.drain()
    yield
    profiling.set_recording(False)
    profiling.drain()


@pytest.fixture(scope="module")
def params():
    return pf.init_params(TINY, torch.Generator().manual_seed(0))


def _audio(seed, n, amp=0.1):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal(n)).astype(np.float32)


def _by_id(records):
    return {r["id"]: r for r in records}


# ------------------------------------------------------------ recorder
def test_off_records_nothing():
    """Off (the default): every span is the one shared no-op, `begin`
    gives None, and nothing reaches the buffer."""
    assert profiling.annotate("a") is profiling.annotate("b")
    with profiling.annotate("a") as span:
        assert span is None
        inner = profiling.begin("b")
    assert inner is None
    profiling.end(inner)
    assert profiling.drain() == ([], 0)


def test_parents_requests_and_causes():
    """Nested spans name their parent and share the root's request; a span
    begun on one thread and ended from another keeps its thread and takes
    the ending span's id as its cause."""
    profiling.set_recording(True)
    with profiling.annotate("outer") as outer:
        with profiling.annotate("inner") as inner:
            queued = profiling.begin("queued")
    with profiling.annotate("second root"):
        pass

    def other():
        with profiling.annotate("tick") as tick:
            profiling.end(queued, cause=tick)
            profiling.end(queued, cause=tick)    # a second end is a no-op
    t = threading.Thread(target=other, name="ticker")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    records, dropped = profiling.drain()
    assert dropped == 0
    by_name = {r["name"]: r for r in records}
    assert len(by_name) == len(records) == 5
    o, i, q = by_name["outer"], by_name["inner"], by_name["queued"]
    tick, root2 = by_name["tick"], by_name["second root"]
    assert (o["id"], i["id"], q["id"]) == (outer.id, inner.id, queued.id)
    assert o["parent"] is None and o["request"] == o["id"]
    assert i["parent"] == o["id"] and i["request"] == o["id"]
    assert q["parent"] == i["id"] and q["request"] == o["id"]
    assert root2["parent"] is None and root2["request"] == root2["id"]
    assert tick["parent"] is None and tick["thread"] == "ticker"
    assert q["thread"] == threading.current_thread().name
    assert q["cause"] == tick["id"]
    assert o["cause"] is None and i["cause"] is None
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= o["end_ns"]


def test_full_buffer_counts_what_it_drops():
    profiling.set_recording(True, capacity=3)
    for k in range(5):
        with profiling.annotate(f"s{k}"):
            pass
    records, dropped = profiling.drain()
    assert [r["name"] for r in records] == ["s0", "s1", "s2"]
    assert dropped == 2
    assert profiling.drain() == ([], 0)


def test_concurrent_spans_are_all_counted():
    """More threads than cores, a short switch interval: every span is
    either recorded or counted as dropped, ids are unique, and each
    thread's parents are its own spans."""
    import sys
    threads, per = 2 * (os.cpu_count() or 4), 300
    profiling.set_recording(True, capacity=threads * per)   # outers fit
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with profiling.annotate("outer"):
                    with profiling.annotate("inner"):
                        pass
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    records, dropped = profiling.drain()
    assert len(records) + dropped == 2 * threads * per
    assert len(records) == threads * per
    by_id = _by_id(records)
    assert len(by_id) == len(records)
    for r in records:
        if r["parent"] in by_id:
            assert by_id[r["parent"]]["thread"] == r["thread"]


def test_a_span_maps_onto_the_profilers_clock():
    """The same main-thread region as the profiler records it and as the
    span recorder does, after one warm-up region: within 250 µs at both
    ends on the profile's timeline."""
    from torch.profiler import ProfilerActivity, profile, record_function
    profiling.set_recording(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            torch.ones(64).sum()
        with record_function("region"), profiling.annotate("region"):
            torch.ones(4096).sum()
            time.sleep(0.002)
    offset = profiling.profile_offset_ns(prof)
    (span,), _ = profiling.drain()
    (event,) = [e for e in prof.events() if e.name == "region"]
    assert abs((span["start_ns"] + offset) / 1e3
               - event.time_range.start) < 250
    assert abs((span["end_ns"] + offset) / 1e3 - event.time_range.end) < 250


def test_trace_to_writes_spans_of_a_thread_started_before_it(tmp_path):
    """A thread that exists before `trace_to` (as a hub's tick thread
    does): its spans are in the trace's JSON on a thread of their own,
    inside the profile's span of time; recording is off again after."""
    stop, started = threading.Event(), threading.Event()

    def loop():
        started.set()
        while not stop.is_set():
            with profiling.annotate("early-thread-work"):
                time.sleep(0.001)
    t = threading.Thread(target=loop, name="early", daemon=True)
    t.start()
    assert started.wait(10)
    try:
        with profiling.trace_to(str(tmp_path / "tb"), device="cpu") as path:
            with profiling.annotate("main-work"):
                torch.ones(128).sum().item()
            time.sleep(0.02)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    with profiling.annotate("after") as after:
        assert after is None
    assert profiling.drain() == ([], 0)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    names = {e["args"]["name"]: e["tid"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    spans = [e for e in events if e.get("cat") == "span"]
    early = [e for e in spans if e["name"] == "early-thread-work"]
    assert early and all(e["tid"] == names["spans: early"] for e in early)
    assert [e["name"] for e in spans if e["tid"] == names[
        f"spans: {threading.current_thread().name}"]] == ["main-work"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("cat") != "span"]
    lo = min(e["ts"] for e in ops)
    hi = max(e["ts"] + e.get("dur", 0) for e in ops)
    main = next(e for e in spans if e["name"] == "main-work")
    assert lo - 1e3 < main["ts"] < hi + 1e3


# ------------------------------------------------------- the service
def _counted_cover(ticker, covers):
    rows = ticker._rows
    cover = rows.cover

    def counted(slots):
        b = cover(slots)
        covers.append((b, len(slots)))
        return b
    rows.cover = counted


def test_chunked_hub_spans_and_cover_counters(params):
    """Three sessions through a tiny CPU ChunkedHub: one `hub.queue` per
    submission, each caused by a `hub.tick`; each `hub.lock_wait` inside
    its tick; the finalize spans nested (its drain too); Σ `hub.tick` over
    the tick histogram's sum for the same ticks; the counters as the
    covers the ticker chose."""
    h = hub.ChunkedHub(params, TINY, po.OnlineConfig(),
                       CharTokenizer.dummy(64), capacity=4, device="cpu")
    covers = []
    _counted_cover(h.ticker, covers)
    try:
        slots = [h.join() for _ in range(3)]
        hist0 = list(hub._HUB_LAT._values.get(("chunked",), [0.0, 0.0])[-2:])
        profiling.set_recording(True)
        submits = 0
        for k in range(3):
            for i, s in enumerate(slots[: 3 - (k == 1) * 2]):
                h.submit(s, _audio(10 * i + k, CHUNK))
                submits += 1
        h.finalize(slots[0])
        profiling.set_recording(False)
        hist1 = hub._HUB_LAT._values[("chunked",)][-2:]
        records, dropped = profiling.drain()
        for s in slots:
            h.leave(s)
    finally:
        h.close()
    assert dropped == 0
    by_id = _by_id(records)
    ticks = [r for r in records if r["name"] == "hub.tick"]
    queues = [r for r in records if r["name"] == "hub.queue"]
    assert len(queues) == submits == 7
    assert {r["thread"] for r in queues} == {
        threading.current_thread().name}
    for q in queues:
        assert by_id[q["cause"]]["name"] == "hub.tick"
        assert by_id[q["cause"]]["start_ns"] <= q["end_ns"]
    assert len({q["cause"] for q in queues}) == len(ticks) == submits
    assert int(hist1[1] - hist0[1]) == len(ticks)
    waits = [r for r in records if r["name"] == "hub.lock_wait"]
    assert len(waits) == len(ticks)
    for w in waits:
        t = by_id[w["parent"]]
        assert t["name"] == "hub.tick" and t["request"] == w["request"]
        assert t["start_ns"] <= w["start_ns"] <= w["end_ns"] <= t["end_ns"]
    assert {r["thread"] for r in ticks} == {"chunked-hub"}
    gathers = [r for r in records if r["name"] == "hub.gather"]
    assert gathers and all(r["end_ns"] - r["start_ns"] >= 5e6
                           for r in gathers)
    span_s = sum(r["end_ns"] - r["start_ns"] for r in ticks) / 1e9
    hist_s = hist1[0] - hist0[0]
    assert hist_s <= span_s <= 1.02 * hist_s + 2e-3
    (fin,) = [r for r in records if r["name"] == "hub.finalize"]
    for name in ("hub.finalize.lock_wait", "hub.finalize.hold",
                 "hub.finalize.drain"):
        (child,) = [r for r in records if r["name"] == name]
        assert child["parent"] == fin["id"]
    names = {r["name"] for r in records}
    assert {"ticker.stage", "ticker.dispatch", "ticker.harvest",
            "program.lock_wait", "program.replay"} <= names
    stepped = sum(b for b, _ in covers)
    assert h.ticker.rows_stepped == stepped
    assert h.ticker.rows_active == sum(n for _, n in covers)
    assert h.ticker.rows_stepped > h.ticker.rows_active > 0


def test_unfused_ticker_spans_and_counters(params):
    """The unfused ticker steps every row: its counters read the capacity
    per step, and its host work is split into the ticker's spans."""
    asr = sb.BatchedChunkedASR(params, TINY, po.OnlineConfig(), capacity=4,
                               fused=False, device="cpu")
    slots = [asr.join() for _ in range(2)]
    profiling.set_recording(True)
    for k in range(2):
        asr.tick({slots[0]: _audio(k, CHUNK)})
    records, _ = profiling.drain()
    assert asr.steps > 0
    assert asr.rows_stepped == 4 * asr.steps
    assert asr.rows_active == asr.steps       # one live row per step
    names = [r["name"] for r in records]
    for name in ("ticker.stage", "ticker.dispatch", "ticker.harvest"):
        assert name in names
    replays = [r for r in records if r["name"] == "program.replay"]
    assert {_by_id(records)[r["parent"]]["name"] for r in replays} == {
        "ticker.stage", "ticker.dispatch"}


def test_recognizer_transcribe_spans(params):
    """A transcribe with hotwords (so the rescoring pass runs): one
    `recognizer.transcribe` request over its pad, rescore and decode
    children and the programs' own spans."""
    reco = Recognizer(params, TINY, CharTokenizer.dummy(64),
                      bucketer=Bucketer((SR, 2 * SR)), device="cpu",
                      use_mesh=False)
    wavs = [_audio(1, SR, amp=0.3), _audio(2, SR // 2, amp=0.3)]
    profiling.set_recording(True)
    res = reco.transcribe(wavs, hotwords={"x": 1.0})
    records, _ = profiling.drain()
    assert len(res) == 2
    (top,) = [r for r in records if r["name"] == "recognizer.transcribe"]
    assert all(r["request"] == top["id"] for r in records)
    children = {r["name"] for r in records if r["parent"] == top["id"]}
    assert {"recognizer.pad", "recognizer.decode",
            "program.lock_wait", "program.replay"} <= children
    assert any(r.token_ids for r in res)
    assert "recognizer.rescore" in children


# ------------------------------------------------------------------- TTS
# seven segments: the first alone, then a batch of six in two phone buckets
TTS_TEXT = ("你好。今天天气很好，我们一起去公园散步吧。好的。明天可能会下雨，"
            "记得带伞，也别忘了带上水杯和外套。是。这是一段用来测试语音合成的"
            "文字。最后一句话在这里结束，谢谢大家。")


@pytest.fixture(scope="module")
def tts_synth():
    """The tiny synthesizer on the PNCA decoder, grouped as the card's
    profile groups it (one call per phone bucket, one mel group)."""
    saved = {k: os.environ.get(k) for k in ("TTS_GROUP_BY_LENGTH",
                                             "TTS_MEL_GROUP")}
    os.environ.update(TTS_GROUP_BY_LENGTH="1", TTS_MEL_GROUP="0")
    try:
        s = Synthesizer.random(tiny=True, device="cpu")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    s.decoder_mode = "pnca"
    return s


def _job(synth):
    mgr = TTSJobManager(synth, max_workers=1)
    try:
        job = mgr.start_task(TTS_TEXT)
        while mgr.get_result(job)["status"] in ("pending", "processing"):
            time.sleep(0.01)
        return mgr.get_result(job)
    finally:
        mgr.close()


def test_tts_job_spans_nest(tts_synth):
    """A streamed job is one `tts.job` request: `synth.segments` per batch
    and `synth.concat` per segment fed and the flush under it, the probes'
    and groups' spans under their batch, the programs' own spans under
    those."""
    profiling.set_recording(True)
    result = _job(tts_synth)
    records, dropped = profiling.drain()
    assert result["status"] == "completed", result["error"]
    assert dropped == 0
    by = _by_id(records)
    (job,) = [r for r in records if r["name"] == "tts.job"]
    assert job["parent"] is None
    assert all(r["request"] == job["id"] for r in records)

    def parent(r):
        return by[r["parent"]]["name"]
    n = result["n_segments"]
    batches = [r for r in records if r["name"] == "synth.segments"]
    assert len(batches) == 1 + -(-(n - 1) // 8) and n > 2
    assert {parent(r) for r in batches} == {"tts.job"}
    concat = [r for r in records if r["name"] == "synth.concat"]
    assert len(concat) == n + 1 and {parent(r) for r in concat} == {"tts.job"}
    probes = [r for r in records if r["name"] == "synth.probe"]
    groups = [r for r in records if r["name"] == "synth.group"]
    assert len(probes) == len(groups) > len(batches)
    assert {parent(r) for r in probes + groups} == {"synth.segments"}
    replays = [r for r in records if r["name"] == "program.replay"]
    assert len(replays) == len(probes) + len(groups)
    assert {parent(r) for r in replays} == {"synth.probe", "synth.group"}
    for r in records:
        if r["parent"] is not None:
            up = by[r["parent"]]
            assert up["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= up["end_ns"]


def test_tts_mel_frames_valid_counts_the_mel_lengths(tts_synth):
    """`mel_frames_valid` grows by the segments' mel lengths, and
    `mel_frames` by the padded frames the groups computed."""
    s = tts_synth
    counts = {k: getattr(s, k).n for k in ("mel_frames", "mel_frames_valid",
                                           "synths", "ar_steps")}
    segments = ["你好，", "今天天气很好，我们一起去公园散步吧。", "记得带伞。"]
    wavs, durs = s.synthesize_segments(segments, "zhitian_emo")
    hop = s.vcfg.hop_length
    lens = [len(w) // hop for w in wavs]
    assert [round(d * s.sample_rate / hop) for d in durs] == lens
    assert s.mel_frames_valid.n - counts["mel_frames_valid"] == sum(lens)
    assert s.mel_frames.n - counts["mel_frames"] > sum(lens)
    assert s.synths.n > counts["synths"] and s.ar_steps.n > counts["ar_steps"]


def test_tts_records_nothing_while_off(tts_synth):
    """Recording off: a whole job records no span."""
    result = _job(tts_synth)
    assert result["status"] == "completed", result["error"]
    assert profiling.drain() == ([], 0)
