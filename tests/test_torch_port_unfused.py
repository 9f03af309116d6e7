"""The reference's remaining serving paths in the port, against the
reference on the CPU:

- `BatchedChunkedASR(fused=False)`: the host-frontend ticker (a batched
  fbank per 24-frame quantum, LFR drained per session, a full-capacity
  encoder + CIF step), on the schedule of the reference's
  `tests/test_stream_batcher.py::test_batched_chunked_asr_matches_single_
  sessions` (OnlineConfig(c1=4, c2=5, encoder_look_back=2), 3200-sample
  chunks, a late join, a leave mid-stream) plus a `reset_slot`: fired
  counts equal tick for tick, embeddings within 1e-4 of the reference's
  unfused ticker, and within 1e-5 rel / 1e-6 abs of the port's own
  per-session `OnlineRecognizer`;
- `BatchedChunkedASR(bucketed=False)`: the full-width masked fused step,
  on the reference's occupancy ramp (`test_bucketed_occupancy_ramp_
  matches_unbucketed`): ids equal to the bucketed port's and the
  reference's unbucketed ticker's;
- the gating of `fused`, `bucketed`, `partials` and `pipelined`, as the
  reference's constructor sets it;
- single-phase TTS (TTS_TWO_PHASE=0) for the NAR and PNCA decoders: PCM
  within 1 LSB of the reference's single-phase, no duration probe.

Tiny geometry: Paraformer d 32, 2 + 2 layers, vocab 64 (as
tests/test_torch_port_stream_batcher.py); the tiny TTS synthesizer (the port's
seed-0 draw, copied into the reference)."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from toolbox_for_asr_and_tts_tpu.models import hifigan as JH  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer_online as jpo  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import sambert as JS  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import stream_batcher as jsb  # noqa: E402
from toolbox_for_asr_and_tts_tpu.tts.synthesizer import (  # noqa: E402
    Synthesizer as JSynthesizer)
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import (  # noqa: E402
    params_from_numpy, tree_map)
from toolbox_for_asr_and_tts_tpu_torch.parallel import stream_batcher as sb  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import mesh  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tts.text_frontend import text_to_ling_ids  # noqa: E402

TINY = dict(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
            encoder_layers=2, decoder_layers=2, vocab_size=64)
CHUNK_CFG = dict(c1=4, c2=5, encoder_look_back=2)
STEP = 3200                 # the reference test's chunk
N_TICKS = 6
LATE, LEAVE, RESET = 2, 3, 4   # ticks of the late join, the leave, the reset
TEXT = "今天天气很好。病人血压一百二，心率正常,没有出血。请多休息，按时吃药。谢谢。"
TTS_ENV = ("TTS_TWO_PHASE", "TTS_DECODER", "TTS_GROUP_BY_LENGTH",
           "TTS_MEL_GROUP")


@pytest.fixture(autouse=True)
def _f32_upload(monkeypatch):
    monkeypatch.setenv("PARAFORMER_TRANSFER_INT16", "0")


@pytest.fixture(scope="module")
def asr():
    """(port tree, reference tree) of the tiny Paraformer, seed 0."""
    jparams = jpf.init_params(jax.random.PRNGKey(0),
                              jpf.ParaformerConfig(**TINY))
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             device="cpu"), jparams


def _port(params, **kw):
    kw.setdefault("device", "cpu")
    return sb.BatchedChunkedASR(params, pf.ParaformerConfig(**TINY),
                                po.OnlineConfig(**CHUNK_CFG), capacity=4,
                                **kw)


def _ref(jparams, **kw):
    return jsb.BatchedChunkedASR(jparams, jpf.ParaformerConfig(**TINY),
                                 jpo.OnlineConfig(**CHUNK_CFG), capacity=4,
                                 **kw)


def _audios(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(STEP * N_TICKS) * 0.1).astype(np.float32)
            for _ in range(n)]


def _schedule(ticker, audios):
    """Sessions 0 and 1 join; session 2 joins at tick LATE (fed its audio
    from there); session 1 leaves at tick LEAVE; session 0 is reset before
    tick RESET. Returns per tick {session: fired list}."""
    slots = {0: ticker.join(), 1: ticker.join()}
    ticks = []
    for k in range(N_TICKS):
        if k == LATE:
            slots[2] = ticker.join()
        if k == LEAVE:
            ticker.leave(slots.pop(1))
        if k == RESET:
            ticker.reset_slot(slots[0])
        i = k * STEP
        fired = ticker.tick({s: audios[j][i:i + STEP]
                             for j, s in slots.items()})
        back = {s: j for j, s in slots.items()}
        ticks.append({back[s]: list(v) for s, v in fired.items()})
    return ticks


def _oracle(params, audio, start, stop, cmvn):
    """The port's per-session OnlineRecognizer fed audio[start:stop]."""
    reco = po.OnlineRecognizer(params, pf.ParaformerConfig(**TINY),
                               CharTokenizer.dummy(TINY["vocab_size"]),
                               po.OnlineConfig(**CHUNK_CFG), cmvn=cmvn,
                               device="cpu")
    for i in range(start, stop, STEP):
        reco.push_audio(audio[i:i + STEP])
    return reco._embeds


def _seeded_cmvn():
    rng = np.random.default_rng(8)
    return (rng.normal(-8, 2, TINY["input_dim"]).astype(np.float32),
            rng.uniform(0.2, 0.5, TINY["input_dim"]).astype(np.float32))


# ------------------------------------------------------ the unfused ticker
@pytest.mark.parametrize("with_cmvn", [False, True], ids=["raw", "cmvn"])
def test_unfused_ticker_matches_reference(asr, with_cmvn):
    p, jp = asr
    cmvn = _seeded_cmvn() if with_cmvn else None
    audios = _audios(seed=5 if with_cmvn else 0)
    mine = _port(p, fused=False, cmvn=cmvn)
    got = _schedule(mine, audios)
    want = _schedule(_ref(jp, fused=False, cmvn=cmvn), audios)
    assert len(got) == len(want) == N_TICKS
    for k, (g, w) in enumerate(zip(got, want)):
        assert {j: len(v) for j, v in g.items()} == \
            {j: len(v) for j, v in w.items()}, k
        for j in w:
            if w[j]:
                np.testing.assert_allclose(np.stack(g[j]), np.stack(w[j]),
                                           rtol=0, atol=1e-4,
                                           err_msg=f"tick {k} session {j}")
    flat = {j: [e for t in got for e in t.get(j, [])] for j in range(3)}
    assert all(len(v) > 0 for v in flat.values())
    # each session against the port's own recognizer: session 0 in two
    # parts around its reset, session 2 from its late join
    session0 = [e for t in got[:RESET] for e in t.get(0, [])]
    checks = ((session0, _oracle(p, audios[0], 0, RESET * STEP, cmvn)),
              (flat[0][len(session0):],
               _oracle(p, audios[0], RESET * STEP, N_TICKS * STEP, cmvn)),
              (flat[2],
               _oracle(p, audios[2], LATE * STEP, N_TICKS * STEP, cmvn)))
    for a, b in checks:
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(np.stack(a), np.stack(b), rtol=1e-5,
                                   atol=1e-6)
    # one K2 program per ready count, one step program
    assert mine.fbanks > 0 and mine.steps > 0
    assert sorted(mine.programs) == [("unfused", 4)]
    assert {k[0] for k in mine.shared} == {"fbank"}


# ------------------------------------------------- the unbucketed ticker
def _ramp(ticker):
    """The reference's occupancy ramp at capacity 8: 1, 2, 4 and 6 live
    sessions on ticks 0-3, then every session finalized."""
    rng = np.random.default_rng(23)
    audios = [(rng.standard_normal(12800) * 0.1).astype(np.float32)
              for _ in range(6)]
    slots, got = [], {}
    for s in range(0, 12800, 3200):
        while len(slots) < (1, 2, 4, 6)[s // 3200]:
            slots.append(ticker.join())
            got[len(slots) - 1] = []
        fired = ticker.tick({slots[i]: audios[i][s:s + 3200]
                             for i in range(len(slots))})
        for i, sl in enumerate(slots):
            got[i].extend(fired.get(sl, []))
    for sl in slots:
        for sl2, ids in ticker.finalize_slot(sl).items():
            got[slots.index(sl2)].extend(int(t) for t in ids)
    return got


def test_unbucketed_ticker_matches_bucketed_and_reference(asr):
    p, jp = asr
    kw = dict(capacity=8, partials=True)
    cfg, ocfg = pf.ParaformerConfig(**TINY), po.OnlineConfig(**CHUNK_CFG)
    full = sb.BatchedChunkedASR(p, cfg, ocfg, bucketed=False, device="cpu",
                                **kw)
    got = _ramp(full)
    packed = _ramp(sb.BatchedChunkedASR(p, cfg, ocfg, device="cpu", **kw))
    want = _ramp(jsb.BatchedChunkedASR(jp, jpf.ParaformerConfig(**TINY),
                                       jpo.OnlineConfig(**CHUNK_CFG),
                                       bucketed=False, **kw))
    assert got == packed == want
    assert sum(len(v) for v in got.values()) > 0
    # every step covered all 8 rows, slot = row
    assert not full.bucketed and sorted(full.programs) == [("tick", 8)]
    assert isinstance(full._rows, sb._FixedRows)


# ------------------------------------------------------------ the gating
def _embeds_run(ticker, audios):
    return [{j: np.stack(v).tolist() for j, v in t.items() if v}
            for t in _schedule(ticker, audios)]


@pytest.mark.parametrize("case", [
    "flags", "partials_and_pipelined_inert", "finalize_raises",
    "warm_builds_nothing", "exec_cache_across_fused", "mesh_equals_meshless",
    "failed_join_returns_the_row"])
def test_unfused_gating(asr, case, monkeypatch):
    """The reference's gating (`stream_batcher.py:127-133`, `:271`, `:388`,
    `:580`, `:224-226`): partials and pipelined only with fused; bucketed
    defaults to fused without a mesh, an explicit value ANDed with it."""
    p, _ = asr
    if case == "flags":
        m2 = mesh.Mesh(np.array([torch.device("cpu")] * 2), ("data",))
        for fused, bucketed, on_mesh, want in (
                (True, None, False, True), (True, False, False, False),
                (True, True, True, False), (False, None, False, False),
                (False, True, False, False), (True, None, True, False)):
            t = _port(p, fused=fused, bucketed=bucketed,
                      mesh=m2 if on_mesh else None, partials=True,
                      pipelined=True)
            assert t.bucketed is want, (fused, bucketed, on_mesh)
            assert t.partials is fused and t.pipelined is fused
            assert isinstance(t._rows, sb._PackedRows if want
                              else sb._FixedRows)
        return
    if case == "partials_and_pipelined_inert":
        audios = _audios(seed=3)
        plain = _embeds_run(_port(p, fused=False), audios)
        flagged = _embeds_run(_port(p, fused=False, partials=True,
                                    pipelined=True), audios)
        assert flagged == plain and any(plain)
        return
    t = _port(p, fused=False)
    if case == "finalize_raises":
        s = t.join()
        t.tick({s: _audios()[0][:STEP]})
        with pytest.raises(ValueError, match="fused ticker"):
            t.finalize_slot(s)
    elif case == "warm_builds_nothing":
        t.warm()
        assert len(t.programs) == 0 and len(t.shared) == 0
        assert t.steps == t.fbanks == 0
    elif case == "exec_cache_across_fused":
        cache = {}
        a = _port(p, fused=False, exec_cache=cache)
        assert _port(p, fused=False, exec_cache=cache).shared is a.shared
        with pytest.raises(ValueError, match="differently-configured"):
            _port(p, fused=True, exec_cache=cache)
    elif case == "mesh_equals_meshless":
        monkeypatch.setattr(mesh, "local_devices", lambda platform="cuda":
                            [torch.device(platform)] * 4)
        m4 = mesh.serving_mesh(device="cpu")
        audios = _audios(seed=9)
        on_mesh = _port(p, fused=False, mesh=m4)
        assert len(on_mesh._shards) == 1 and on_mesh.rows_per == 4
        assert _embeds_run(on_mesh, audios) == _embeds_run(
            _port(p, fused=False), audios)
        with pytest.raises(ValueError, match="not divisible"):
            sb.BatchedChunkedASR(p, pf.ParaformerConfig(**TINY),
                                 po.OnlineConfig(**CHUNK_CFG), capacity=6,
                                 fused=False, mesh=m4)
    elif case == "failed_join_returns_the_row":
        def boom(slot):
            raise RuntimeError("injected device error")
        monkeypatch.setattr(t, "_reset_slot", boom)
        with pytest.raises(RuntimeError, match="injected"):
            t.join()
        monkeypatch.undo()
        assert t._frontends == {} and t._queues == {} and t.n_live == 0
        slots = [t.join() for _ in range(4)]
        assert sorted(slots) == [0, 1, 2, 3] and len(t._frontends) == 4
        t.leave(slots[0])
        assert slots[0] not in t._frontends and slots[0] not in t._queues
        state, row = t._at(slots[0])
        for key, a in state.items():
            assert not a.select(po.batch_dim(key), row).any(), key


# ------------------------------------------------------ single-phase TTS
def _with_env(env, fn):
    saved = {k: os.environ.get(k) for k in TTS_ENV}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module", params=["nar", "pnca"])
def single_phase(request):
    """(reference, port) tiny synthesizers on one tree (the port's seed-0
    draw, copied into the reference), built under TTS_TWO_PHASE=0, one
    call per phone bucket."""
    env = {"TTS_TWO_PHASE": "0", "TTS_DECODER": request.param,
           "TTS_GROUP_BY_LENGTH": "1", "TTS_MEL_GROUP": "0"}

    def build():
        port = Synthesizer.random(seed=0, tiny=True, device="cpu")
        to_jax = lambda t: tree_map(lambda x: jax.numpy.asarray(  # noqa: E731
            x.numpy()), t)
        jsynth = JSynthesizer(
            to_jax(port.ap), JS.SambertConfig(**dataclasses.asdict(port.acfg)),
            to_jax(port.vp), JH.HifiGanConfig(**dataclasses.asdict(port.vcfg)))
        return jsynth, port
    return _with_env(env, build)


def _pcm(wav):
    return np.round(np.asarray(wav, np.float64) * 32767.0).astype(np.int64)


def test_single_phase_tts_matches_reference(single_phase):
    jsynth, port = single_phase
    assert jsynth.two_phase is port.two_phase is False
    want = jsynth.synthesize(TEXT)
    probes, synths = port.probes.n, port.synths.n
    frames = port.mel_frames.n
    got = port.synthesize(TEXT)
    assert got.segments == want.segments and len(got.segments) >= 3
    assert got.seg_durations_s == want.seg_durations_s
    assert len(got.wav) == len(want.wav)
    assert np.abs(_pcm(got.wav) - _pcm(want.wav)).max() <= 1
    # no probe; one synthesis per phone group, each at its worst case
    buckets = [port.bucketer.bucket(max(len(text_to_ling_ids(
        s, port.g2p, port.vocab)), 1)) for s in got.segments]
    assert port.probes.n == probes
    assert port.synths.n - synths == len(set(buckets)) >= 2
    assert port.mel_frames.n - frames == sum(
        l * port.acfg.frames_per_phone for l in buckets)
    assert not any(k[0] == "dur" for k in port.programs)


@pytest.mark.parametrize("value", ["1", "true", "0", "True", None])
def test_two_phase_env_parsing_matches_reference(single_phase, value):
    jsynth, port = single_phase
    env = {} if value is None else {"TTS_TWO_PHASE": value}

    def build():
        if value is None:
            os.environ.pop("TTS_TWO_PHASE", None)
        return (JSynthesizer(jsynth.ap, jsynth.acfg, jsynth.vp,
                             jsynth.vcfg).two_phase,
                Synthesizer(port.ap, port.acfg, port.vp, port.vcfg,
                            device="cpu").two_phase)
    ref, mine = _with_env(env, build)
    assert mine is ref
    assert mine is (value in (None, "1", "true"))
