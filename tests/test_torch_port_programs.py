"""The port's program layer (`runtime/graphs.py`) on the CPU, where a
program runs its eager function with no capture: the per-owner cache and
its build-once lock, the `exec_cache` signatures of the tickers, the
`pipelined` tick dispatch against the reference's tick for tick, and the
ChunkedHub's partials under the default CHUNKED_PIPELINE=1 against the
reference's hub. Tiny geometry: the Paraformer of `service/engines.py:58`
(d 32, 2 + 2 layers, vocab 64)."""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from toolbox_for_asr_and_tts_tpu.asr.tokenizer import (  # noqa: E402
    CharTokenizer as JTok)
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer_online as jpo  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import stream_batcher as jsb  # noqa: E402
from toolbox_for_asr_and_tts_tpu.service import hub as jhub  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import stream_batcher as sb  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import graphs  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.service import hub as hub  # noqa: E402

TINY = dict(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
            encoder_layers=2, decoder_layers=2, vocab_size=64)
CHUNK = 6400   # the WebSocket protocol's 0.4 s


@pytest.fixture(autouse=True)
def _f32_upload(monkeypatch):
    monkeypatch.setenv("PARAFORMER_TRANSFER_INT16", "0")


@pytest.fixture(scope="module")
def asr_params():
    jparams = jpf.init_params(jax.random.PRNGKey(0),
                              jpf.ParaformerConfig(**TINY))
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             device="cpu"), jparams


def _audio(seed, n, amp=0.1):
    rng = np.random.default_rng(seed)
    return (amp * rng.standard_normal(n)).astype(np.float32)


# ------------------------------------------------------------ the cache
def test_program_cache_same_key_same_object():
    """One program per key; the CPU runs the eager function on inputs cast
    as the static inputs would hold them, and refuses another shape."""
    progs = graphs.Programs("cpu", "test")
    builds = []

    def build():
        builds.append(1)
        return (lambda x, n: x * 2 + n.to(x.dtype)[:, None],
                [((2, 3), torch.float32), ((2,), torch.int64)])
    a = progs.get(("k", 2), build)
    assert progs.get(("k", 2), build) is a and len(builds) == 1
    assert ("k", 2) in progs and len(progs) == 1
    out = a(np.ones((2, 3), np.float64), np.array([1, 2], np.int32))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), [[3, 3, 3], [4, 4, 4]])
    assert a(np.ones((2, 3)), np.zeros(2), read=lambda t: t.sum().item()) == 12
    assert (a.replays, progs.replays) == (2, 2)
    with pytest.raises(ValueError, match="shape"):
        a(np.ones((3, 3)), np.zeros(2))
    assert progs.stats()["pool_bytes"] == 0 and progs.captures == 0
    assert progs in graphs.owners()


def test_program_cache_builds_once_under_threads():
    """Eight threads asking for a new key at once build it once (the
    double-checked lookup under COMPILE_LOCK), and all get that object."""
    progs = graphs.Programs("cpu", "test")
    builds = []
    start = threading.Barrier(8)

    def build():
        builds.append(threading.get_ident())
        time.sleep(0.05)        # widen the window a racing build would use
        return (lambda x: x + 1), [((1,), torch.float32)]
    got = []

    def ask():
        start.wait()
        got.append(progs.get("new", build))
    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(got) == 8
    assert len({id(p) for p in got}) == 1


# ----------------------------------------------------------- exec_cache
def _vad_params(cfg):
    return fv.init_params(cfg, torch.Generator().manual_seed(0))


def test_exec_cache_refuses_a_mismatched_share(asr_params):
    """Tickers sharing one exec_cache must match its signature: a chunked
    ticker of another capacity or another CMVN, and two VAD tickers that
    differ only in CMVN, raise ValueError; a matching lane shares the
    stateless programs' owner and keeps its own tick programs."""
    p, _ = asr_params
    cfg = pf.ParaformerConfig(**TINY)
    cmvn = (np.full(560, -1.0, np.float32), np.full(560, 0.5, np.float32))
    shared: dict = {}
    a = sb.BatchedChunkedASR(p, cfg, capacity=4, partials=True, cmvn=cmvn,
                             exec_cache=shared, device="cpu")
    b = sb.BatchedChunkedASR(p, cfg, capacity=4, partials=True, cmvn=cmvn,
                             exec_cache=shared, device="cpu")
    assert a.shared is b.shared and a.programs is not b.programs
    a.warm()
    assert ("tail",) in b.shared and len(b.programs) == 0
    other = (cmvn[0] + 1e-3, cmvn[1])
    for kw in (dict(capacity=8, cmvn=cmvn), dict(capacity=4, cmvn=other),
               dict(capacity=4, cmvn=None)):
        with pytest.raises(ValueError, match="exec_cache"):
            sb.BatchedChunkedASR(p, cfg, partials=True, exec_cache=shared,
                                 device="cpu", **kw)
    vcfg = fv.FsmnVadConfig(proj_dim=16, linear_dim=32, fsmn_layers=2)
    vp = _vad_params(vcfg)
    vshared: dict = {}
    v1 = sb.BatchedVadTicker(vp, vcfg, capacity=4, cmvn=cmvn,
                             exec_cache=vshared, device="cpu")
    v2 = sb.BatchedVadTicker(vp, vcfg, capacity=4, cmvn=cmvn,
                             exec_cache=vshared, device="cpu")
    assert v1.shared is v2.shared
    with pytest.raises(ValueError, match="exec_cache"):
        sb.BatchedVadTicker(vp, vcfg, capacity=4, cmvn=other,
                            exec_cache=vshared, device="cpu")
    v1.warm()
    assert {k[0] for k in v2.shared} == {"fb"}
    assert {k[0] for k in v1.programs} == {"p"} and len(v2.programs) == 0


def test_vad_warm_builds_what_the_ticks_reach():
    """`BatchedVadTicker.warm` builds every fbank and step program that
    ticks of 0.4 s chunks reach: a VadHub-style run afterwards builds none."""
    vcfg = fv.FsmnVadConfig(proj_dim=16, linear_dim=32, fsmn_layers=2)
    t = sb.BatchedVadTicker(_vad_params(vcfg), vcfg, capacity=4,
                            device="cpu")
    t.warm()
    built = set(t.programs) | set(t.shared)
    slots = [t.join() for _ in range(3)]
    for c in range(6):
        t.tick({s: _audio(40 + i + 7 * c, CHUNK)
                for i, s in enumerate(slots)})
    assert set(t.programs) | set(t.shared) == built
    assert t.steps == 6 and t.fbanks == 6


# ------------------------------------------------------------ pipelined
def _script(ticker):
    """Sessions 0-2 join; 5 ticks of 0.4 s chunks (session 2 starts one
    tick late); session 0 leaves after tick 3; then sessions 1 and 2 are
    finalized. Returns (per-tick {session: ids}, per-session ids joined
    over ticks and finalizes)."""
    audios = {i: _audio(60 + i, 5 * CHUNK) for i in range(3)}
    slots = {i: ticker.join() for i in range(3)}
    back = {s: i for i, s in slots.items()}
    ticks, joined = [], {i: [] for i in audios}

    def route(fired):
        got = {back[s]: [int(t) for t in v] for s, v in fired.items() if v}
        for i, v in got.items():
            joined[i].extend(v)
        return got
    for k in range(5):
        if k == 3:
            ticker.leave(slots.pop(0))
        chunks = {s: audios[i][k * CHUNK:(k + 1) * CHUNK]
                  for i, s in slots.items() if not (i == 2 and k == 0)}
        ticks.append(route(ticker.tick(chunks)))
    for i in (1, 2):
        ticks.append(route(ticker.finalize_slot(slots[i])))
    return ticks, joined


def test_pipelined_ticks_match_reference(asr_params):
    """pipelined=True: each tick's ids equal the reference's pipelined
    ticker's for that tick (one tick late), and in both packages the ids
    joined over the ticks and finalize drains equal the unpipelined
    ticker's for every finalized session (a session that leaves with a
    step in flight loses that step's ids, in both); the unpipelined ticks
    equal the reference's too."""
    p, jp = asr_params
    cfg, jcfg = pf.ParaformerConfig(**TINY), jpf.ParaformerConfig(**TINY)
    jcache: dict = {}    # the reference's signature leaves pipelined out
    runs = {}
    for piped in (True, False):
        runs["port", piped] = _script(sb.BatchedChunkedASR(
            p, cfg, po.OnlineConfig(), capacity=4, partials=True,
            pipelined=piped, device="cpu"))
        runs["ref", piped] = _script(jsb.BatchedChunkedASR(
            jp, jcfg, jpo.OnlineConfig(), capacity=4, partials=True,
            pipelined=piped, exec_cache=jcache))
    for piped in (True, False):
        assert runs["port", piped][0] == runs["ref", piped][0], piped
    for pkg in ("port", "ref"):
        piped, plain = runs[pkg, True][1], runs[pkg, False][1]
        for i in (1, 2):                      # finalized: everything
            assert piped[i] == plain[i], (pkg, i)
        # session 0 left with a step in flight: leave drops its results
        assert piped[0] == plain[0][:len(piped[0])], pkg
    piped_ticks, plain_ticks = runs["port", True][0], runs["port", False][0]
    assert piped_ticks[0] == {} and plain_ticks[0]    # the lag is real
    assert sum(len(v) for v in runs["port", True][1].values()) > 10


def test_chunked_hub_partials_under_default_pipeline(asr_params,
                                                     monkeypatch):
    """ChunkedHub with CHUNKED_PIPELINE unset (the serving default, 1):
    every submit's partial text and both finals equal the reference hub's,
    and the port's ticker runs pipelined."""
    p, jp = asr_params
    monkeypatch.delenv("CHUNKED_PIPELINE", raising=False)
    monkeypatch.setenv("VOICE_AOT_TICKS", "0")
    mine = hub.ChunkedHub(p, pf.ParaformerConfig(**TINY), po.OnlineConfig(),
                          CharTokenizer.dummy(64), capacity=4, device="cpu")
    ref = jhub.ChunkedHub(jp, jpf.ParaformerConfig(**TINY),
                          jpo.OnlineConfig(), JTok.dummy(64), capacity=4)
    try:
        assert mine.ticker.pipelined
        out = {}
        for name, h in (("port", mine), ("ref", ref)):
            slots = [h.join() for _ in range(2)]
            texts = []
            for k in range(4):
                for i, s in enumerate(slots):
                    texts.append(h.submit(
                        s, _audio(80 + i, 4 * CHUNK)[k * CHUNK:
                                                     (k + 1) * CHUNK]))
            texts += [h.finalize(s) for s in slots]
            for s in slots:
                h.leave(s)
            out[name] = texts
        assert out["port"] == out["ref"]
        assert any(out["port"][:-2]) and any(out["port"][-2:])
    finally:
        mine.close()
        ref.close()
