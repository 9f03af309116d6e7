"""The chunked finalize drain on the CPU (`parallel/stream_batcher.py::
BatchedChunkedASR.take_slot` / `drain`, `service/hub.py::ChunkedHub.
finalize`): the drained row's one-row copy stepped alone, outside the
ticker lock.

Against the reference ticker's `finalize_slot` (which steps the pow-2 cover
of the row under its caller's lock): the same ids for a slot at the top row
of a full cover, at row 0 and with other slots' carried ids in flight,
pipelined and not; the counters; the slot reset at the take; a leave that
moves the drained row; a hub tick answered while a drain is held open.
Tiny geometry: the Paraformer of `service/engines.py:58` (d 32, 2 + 2
layers, vocab 64)."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer_online as jpo  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import stream_batcher as jsb  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import stream_batcher as sb  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import profiling  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.service import hub  # noqa: E402

TINY = dict(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
            encoder_layers=2, decoder_layers=2, vocab_size=64)
CHUNK = 6400   # the WebSocket protocol's 0.4 s; 5/3 of a 3840-sample step


@pytest.fixture(autouse=True)
def _f32_upload(monkeypatch):
    monkeypatch.setenv("PARAFORMER_TRANSFER_INT16", "0")
    monkeypatch.setenv("VOICE_AOT_TICKS", "0")


@pytest.fixture(scope="module")
def asr_params():
    jparams = jpf.init_params(jax.random.PRNGKey(0),
                              jpf.ParaformerConfig(**TINY))
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             device="cpu"), jparams


def _audio(seed, n, amp=0.1):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal(n)).astype(np.float32)


def _port(p, **kw):
    return sb.BatchedChunkedASR(p, pf.ParaformerConfig(**TINY),
                                po.OnlineConfig(), capacity=4, partials=True,
                                device="cpu", **kw)


def _row_is_clear(t, slot):
    state, row = t._at(t.row_of(slot))
    return (len(t._audio[slot]) == 0
            and all(not a.select(po.batch_dim(k), row).any()
                    for k, a in state.items()))


# sessions 0-3 on rows 0-3 (a cover of 4 of capacity 4); session 1 skips
# the last tick, so its remainder is 1280 samples (3 drain steps) where the
# others' is 0 (2 steps)
FEEDS = [(0, 1, 2, 3), (0, 1, 2, 3), (0, 2, 3)]
ORDERS = {"top_row_first": (3, 0, 1, 2), "row_0_first": (0, 1, 3, 2)}


def _finalizes(t, order):
    """Three ticks, then every session finalized in `order`. Returns the
    finalizes' {session: ids}, and per finalize (Δ drain_steps, Δ steps,
    Δ rows_stepped, the slot clear afterwards) on the port."""
    slots = [t.join() for _ in range(4)]
    back = {s: i for i, s in enumerate(slots)}
    for k, feed in enumerate(FEEDS):
        t.tick({slots[i]: _audio(10 * i + k, CHUNK) for i in feed})
    outs, counts = [], []
    for i in order:
        port = isinstance(t, sb.BatchedChunkedASR)
        if port:
            before = (t.drain_steps, t.steps, t.rows_stepped)
        fired = t.finalize_slot(slots[i])
        outs.append({back[s]: [int(x) for x in v]
                     for s, v in fired.items() if len(v)})
        if port:
            counts.append((t.drain_steps - before[0], t.steps - before[1],
                           t.rows_stepped - before[2],
                           _row_is_clear(t, slots[i])))
    return outs, counts


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["unpipelined", "pipelined"])
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_drain_matches_reference_finalize(asr_params, pipelined, order):
    """Each finalize's ids (the slot's and the carried ones of every row)
    equal the reference's; the drain steps the slot's row alone (2 steps
    where the remainder is 0, 3 where it is not; none counted as cover
    rows) and leaves the slot reset."""
    p, jp = asr_params
    mine = _port(p, pipelined=pipelined)
    ref = jsb.BatchedChunkedASR(jp, jpf.ParaformerConfig(**TINY),
                                jpo.OnlineConfig(), capacity=4,
                                partials=True, pipelined=pipelined)
    got, counts = _finalizes(mine, ORDERS[order])
    want, _ = _finalizes(ref, ORDERS[order])
    assert got == want
    assert sum(len(v) for out in got for v in out.values()) > 4
    first = ORDERS[order][0]
    if pipelined:       # the take handed other rows' carried ids out
        assert set(got[0]) - {first}, got[0]
    else:
        assert set(got[0]) <= {first}
    steps = [2 if i != 1 else 3 for i in ORDERS[order]]
    assert [c[0] for c in counts] == [c[1] for c in counts] == steps
    assert [c[2] for c in counts] == [0] * 4
    assert all(c[3] for c in counts)
    assert mine.drains == 4 and mine.drain_steps == sum(steps)


def test_a_leave_that_moves_the_drained_row(asr_params):
    """Between the take and the drain another session leaves and the
    drained slot's row moves into the vacated one: the drain reads its own
    copy, so its ids equal an undisturbed finalize's."""
    p, _ = asr_params
    runs = {}
    for leave in (False, True):
        t = _port(p)
        slots = [t.join() for _ in range(3)]
        for k in range(3):
            t.tick({s: _audio(20 * i + k, CHUNK)
                    for i, s in enumerate(slots)})
        taken = t.take_slot(slots[2])
        if leave:
            t.leave(slots[0])
            assert t.row_of(slots[2]) == 0 and t.n_live == 2
            assert _row_is_clear(t, slots[2])
        runs[leave] = taken.fired[slots[2]] + t.drain(taken)
    assert runs[True] == runs[False] and runs[False]


def test_lanes_share_the_drain(asr_params):
    """Tickers of one exec_cache share the drain's program, state and
    lock; each keeps only its tick programs."""
    p, _ = asr_params
    cache: dict = {}
    a, b = _port(p, exec_cache=cache), _port(p, exec_cache=cache)
    a.warm()
    assert a._drain is b._drain and ("drain", 1) in b.shared
    assert {k[0] for k in a.programs} == {"tick"} and len(b.programs) == 0


class _Gate:
    """The drain's program, held at its first call until `release`."""

    def __init__(self, prog):
        self.prog = prog
        self.entered, self.release = threading.Event(), threading.Event()

    def __call__(self, *args, **kw):
        if not self.entered.is_set():
            self.entered.set()
            assert self.release.wait(60), "the gate was never released"
        return self.prog(*args, **kw)


def _hub_run(p, hold: bool):
    """Sessions 0-2 through a tiny CPU ChunkedHub: three frames each, then
    session 2 (the top row) is finalized. With `hold`, its drain is held
    inside its first step while session 1 submits a frame and session 0
    leaves (session 2's row moves to row 0). Returns (final text, whether
    session 1's submit was answered with the drain open, the hub, the
    slots)."""
    h = hub.ChunkedHub(p, pf.ParaformerConfig(**TINY), po.OnlineConfig(),
                       CharTokenizer.dummy(64), capacity=4, device="cpu")
    slots = [h.join() for _ in range(3)]
    for k in range(3):
        for i, s in enumerate(slots):
            h.submit(s, _audio(30 * i + k, CHUNK))
    if not hold:
        return h.finalize(slots[2]), None, h, slots
    real = h.ticker._drain_fn()
    gate = _Gate(real)
    h.ticker._drain_fn = lambda: gate
    out = {}
    fin = threading.Thread(target=lambda: out.update(
        text=h.finalize(slots[2])))
    fin.start()
    assert gate.entered.wait(60)
    ticks = h.ticks
    h.submit(slots[1], _audio(99, CHUNK))
    answered = h.ticks > ticks and fin.is_alive()
    h.leave(slots[0])
    gate.release.set()
    fin.join(60)
    assert not fin.is_alive()
    return out["text"], answered, h, slots


def test_hub_ticks_while_a_drain_is_held(asr_params):
    """A drain held inside its steps leaves the ticker lock free: another
    session's submit is ticked and answered meanwhile, a leave moves the
    drained row, and the final text equals an undisturbed hub's. The
    finalize's hold ends before its drain starts; both are its children;
    the hub counts one drain and the slot reads clear."""
    p, _ = asr_params
    plain, _, h0, _ = _hub_run(p, hold=False)
    h0.close()
    profiling.drain()
    profiling.set_recording(True)
    try:
        text, answered, h, slots = _hub_run(p, hold=True)
    finally:
        profiling.set_recording(False)
        records, _ = profiling.drain()
    try:
        assert answered
        assert text == plain and text
        assert h.ticker.drains == 1 and h.ticker.drain_steps in (2, 3)
        assert _row_is_clear(h.ticker, slots[2])
    finally:
        h.close()
    (fin,) = [r for r in records if r["name"] == "hub.finalize"]
    (hold,) = [r for r in records if r["name"] == "hub.finalize.hold"]
    (drain,) = [r for r in records if r["name"] == "hub.finalize.drain"]
    assert hold["parent"] == drain["parent"] == fin["id"]
    assert hold["end_ns"] <= drain["start_ns"]
    # the submit's tick ran inside the drain
    ticks = [r for r in records if r["name"] == "hub.tick"
             and drain["start_ns"] < r["start_ns"] < drain["end_ns"]]
    assert ticks
