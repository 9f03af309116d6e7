"""Port `parallel/stream_batcher.py` vs the reference's tickers on the CPU
with capacity 4: the same sessions, joins, a leave mid-stream (the last
live row moves into the vacated one), a rejoin into the freed slot, and
`finalize_slot` for every survivor.

Chunked ASR at the tiny Paraformer of `service/engines.py:54-55` (d 32,
2 + 2 layers, vocab 64) and the default OnlineConfig; FSMN-VAD at the
geometry of tests/test_torch_port_vad.py. Per-slot token ids and VAD
decisions identical tick for tick; embeddings within 1e-4, or one bf16
step where the two float32 sums round to neighbouring bf16 values (the
tickers return bf16, as the reference)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from toolbox_for_asr_and_tts_tpu.models import fsmn_vad as jfv  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer_online as jpo  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import stream_batcher as jsb  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import stream_batcher as sb  # noqa: E402

TINY = dict(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
            encoder_layers=2, decoder_layers=2, vocab_size=64)
VAD = dict(input_dim=400, input_affine_dim=12, linear_dim=16, proj_dim=8,
           fsmn_layers=3, lorder=5, output_affine_dim=12, output_dim=10,
           sil_pdf_ids=(0, 1, 2, 3, 4))
CHUNK = 6400   # the WebSocket protocol's 0.4 s


@pytest.fixture(autouse=True)
def _f32_upload(monkeypatch):
    monkeypatch.setenv("PARAFORMER_TRANSFER_INT16", "0")


@pytest.fixture(scope="module")
def asr_params():
    jparams = jpf.init_params(jax.random.PRNGKey(0), jpf.ParaformerConfig(**TINY))
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             device="cpu"), jparams


def _audio(seed, n, amp=0.1):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal(n)).astype(np.float32)


def _check_packed(t):
    if not isinstance(t, (sb.BatchedChunkedASR, sb.BatchedVadTicker)):
        return
    rows = sorted(t._rows.slot_row.values())
    assert rows == list(range(t.n_live))
    assert {t._rows.row_slot[r] for r in rows} == set(t._rows.slot_row)


def _schedule(ticker, audios):
    """Sessions 0-2 join; after tick 1 session 0 leaves; before tick 2
    session 3 joins (the freed slot); then every live session is
    finalized. Returns the list of per-tick (and per-finalize) outputs,
    keyed by session."""
    slots = {i: ticker.join() for i in range(3)}
    pos = {i: 0 for i in audios}
    outs = []

    def route(fired):
        back = {s: i for i, s in slots.items()}
        outs.append({back[s]: v for s, v in fired.items() if v})

    for k in range(4):
        if k == 2:
            ticker.leave(slots.pop(0))
            _check_packed(ticker)
            slots[3] = ticker.join()
            _check_packed(ticker)
        chunks = {}
        for i, s in slots.items():
            if pos[i] < len(audios[i]):
                chunks[s] = audios[i][pos[i]:pos[i] + CHUNK]
                pos[i] += CHUNK
        route(ticker.tick(chunks))
    for i in sorted(slots):
        route(ticker.finalize_slot(slots[i]))
    return outs


@pytest.mark.parametrize("partials", [False, True], ids=["embeds", "partials"])
def test_batched_chunked_asr_matches_reference(asr_params, partials):
    p, jp = asr_params
    audios = {0: _audio(1, 12800), 1: _audio(2, 24000), 2: _audio(3, 19200),
              3: _audio(4, 12800)}
    mine = sb.BatchedChunkedASR(p, pf.ParaformerConfig(**TINY),
                                po.OnlineConfig(), capacity=4,
                                partials=partials, device="cpu")
    ref = jsb.BatchedChunkedASR(jp, jpf.ParaformerConfig(**TINY),
                                jpo.OnlineConfig(), capacity=4,
                                partials=partials)
    got, want = _schedule(mine, audios), _schedule(ref, audios)
    assert len(got) == len(want)
    n_tokens = 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for i in w:
            if partials:
                assert g[i] == [int(t) for t in w[i]], i
            else:
                a, b = np.stack(g[i]), np.stack(w[i]).astype(np.float32)
                assert a.shape == b.shape, i
                np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=1e-4)
                assert (np.abs(a - b) <= 1e-4).mean() > 0.99
            n_tokens += len(w[i])
    assert n_tokens > 10
    assert mine.n_live == 3 and mine.steps > 0


def test_chunked_rows_move_reset_and_warm(asr_params):
    """leave() moves the last live row into the vacated one and zeroes the
    tail; reset_slot zeroes a row; warm() steps every pow-2 prefix with all
    rows masked and leaves the state as it was."""
    p, _ = asr_params
    t = sb.BatchedChunkedASR(p, pf.ParaformerConfig(**TINY), po.OnlineConfig(),
                             capacity=3, partials=True, device="cpu")
    a, b, c = t.join(), t.join(), t.join()
    with pytest.raises(sb.AtCapacity):
        t.join()
    t.tick({s: _audio(10 + s, 7680) for s in (a, b, c)})
    before = {k: v.clone() for k, v in t.state.items()}
    steps = t.steps
    t.warm()
    assert t.steps == steps + 3                       # prefixes 1, 2, 3
    for k, v in t.state.items():
        assert torch.equal(v, before[k]), k
    row_c = {k: v.select(po.batch_dim(k), t.row_of(c)).clone()
             for k, v in t.state.items()}
    t.leave(a)
    assert t.row_of(c) == 0 and t.n_live == 2
    for k, v in t.state.items():
        d = po.batch_dim(k)
        assert torch.equal(v.select(d, 0), row_c[k]), k
        assert not v.select(d, 2).any(), k
    t.reset_slot(b)
    for k, v in t.state.items():
        assert not v.select(po.batch_dim(k), t.row_of(b)).any(), k


def test_failed_join_returns_the_row(asr_params, monkeypatch):
    p, _ = asr_params
    t = sb.BatchedVadTicker(fv.init_params(fv.FsmnVadConfig(**VAD)),
                            fv.FsmnVadConfig(**VAD), capacity=2,
                            device="cpu")

    def boom(slot):
        raise RuntimeError("injected device error")

    monkeypatch.setattr(t, "_reset_slot", boom)
    with pytest.raises(RuntimeError) as ei:
        t.join()
    assert not isinstance(ei.value, sb.AtCapacity)
    monkeypatch.undo()
    t.join(), t.join()
    assert t.n_live == 2


def test_batched_vad_ticker_matches_reference():
    """Decisions identical tick for tick: uneven chunk sizes (several
    length buckets and frame-count groups), a leave mid-stream, a
    rejoin, and a reset."""
    cfg, jcfg = fv.FsmnVadConfig(**VAD), jfv.FsmnVadConfig(**VAD)
    jparams = jfv.init_params(jax.random.PRNGKey(1), jcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    mine = sb.BatchedVadTicker(params, cfg, capacity=4, device="cpu")
    ref = jsb.BatchedVadTicker(jparams, jcfg, capacity=4)
    sizes = (6400, 6400, 3300, 6400, 100, 8000)
    amps = (0.3, 0.001, 0.2, 0.0, 0.5, 0.05)
    got, want = [], []
    for t, out in ((mine, got), (ref, want)):
        slots = [t.join() for _ in range(3)]
        for k in range(6):
            if k == 2:
                t.leave(slots.pop(0))
                slots.append(t.join())
            if k == 4:
                t.reset_slot(slots[1])
            chunks = {s: _audio(100 * j + k, sizes[(j + k) % 6],
                                amps[(j + k) % 6])
                      for j, s in enumerate(slots)}
            res = t.tick(chunks)
            out.append([res[s] for s in slots])
    assert got == want
    flat = [d for tick in got for d in tick]
    assert True in flat and False in flat
    assert mine.tick({}) == {}
