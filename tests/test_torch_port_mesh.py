"""The port's serving mesh (`runtime/mesh.py`) and its mesh paths against the
reference's on its 8 virtual CPU devices: the offline `Recognizer`, the
chunked ticker (`BatchedChunkedASR(mesh=...)`, through `ChunkedHub` too)
and the `Synthesizer`, each with the reference's parameters; the graph
owner of a mesh position; and the kernels refusing inputs on two devices.

The port's CPU positions come from monkeypatching `mesh.local_devices`, as
the reference's conftest forces 8 JAX CPU devices."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import Mesh as JMesh  # noqa: E402

from toolbox_for_asr_and_tts_tpu.asr.recognizer import Recognizer as JRecognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu.asr.tokenizer import CharTokenizer as JTok  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer_online as jpo  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel.stream_batcher import (  # noqa: E402
    BatchedChunkedASR as JBatchedChunkedASR)
from toolbox_for_asr_and_tts_tpu.runtime import mesh as jmesh  # noqa: E402
from toolbox_for_asr_and_tts_tpu.runtime.bucketing import Bucketer as JBucketer  # noqa: E402
from toolbox_for_asr_and_tts_tpu.tts.synthesizer import Synthesizer as JSynthesizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (  # noqa: E402
    frame_window as k2, fsmn_conv as k1, fsmn_conv_dw as k1dw)
from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (  # noqa: E402
    BatchedChunkedASR)
from toolbox_for_asr_and_tts_tpu_torch.runtime import mesh  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime.bucketing import Bucketer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime.graphs import Programs  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer  # noqa: E402

SR = 16000
TINY = dict(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
            encoder_layers=2, decoder_layers=2, vocab_size=64)
CPU = torch.device("cpu")


@pytest.fixture
def eight(monkeypatch):
    """8 CPU positions, as the reference's conftest gives JAX 8 devices."""
    monkeypatch.setattr(mesh, "local_devices", lambda platform="cuda":
                        [torch.device(platform)] * 8)


@pytest.fixture(autouse=True)
def _f32_upload(monkeypatch):
    monkeypatch.setenv("PARAFORMER_TRANSFER_INT16", "0")


def _tree(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _wav(secs, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * secs)) / SR
    return (0.3 * np.sin(2 * np.pi * 300 * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


# ------------------------------------------------------------- the mesh
def test_serving_mesh_shards_batch(eight):
    """Mirror of the reference's `test_serving_mesh_shards_batch`."""
    ref = jmesh.serving_mesh()
    got = mesh.serving_mesh(device="cpu")
    assert got.devices.size == ref.devices.size == 8
    assert got.shape == dict(ref.shape)
    x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
    y = mesh.shard_batch(got, x)
    want = jmesh.shard_batch(ref, x)
    assert y.sharding.num_devices == want.sharding.num_devices == 8
    assert [tuple(s.shape) for s in y.shards] == \
        [tuple(s.data.shape) for s in want.addressable_shards]
    np.testing.assert_array_equal(y.gather().numpy(), np.asarray(want))
    assert mesh.local_device_count("cpu") == 8
    assert mesh.pad_to_multiple(13, 8) == jmesh.pad_to_multiple(13, 8) == 16


def test_serving_mesh_covers_the_cards(monkeypatch):
    """Without a device, the mesh is every card (none is touched here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = mesh.serving_mesh()
    assert m.positions() == [torch.device("cuda", i) for i in range(3)]
    assert mesh.serving_mesh(n_devices=2).shape == {"data": 2}
    assert mesh.serving_mesh(device="cpu").positions() == [CPU]


def test_mesh_placements_mirror_the_reference(eight):
    m = mesh.Mesh(np.array(mesh.local_devices("cpu")).reshape(4, 2),
                  ("data", "model"))
    assert m.shape == {"data": 4, "model": 2}
    assert m.along("data") == [CPU] * 4 and m.along("model") == [CPU] * 2
    tree = {"w": torch.ones(2), "none": None}
    copies = mesh.per_position(tree, m.positions())
    assert len(copies) == 8   # the tree itself on its own device, no copy
    assert all(c["w"] is tree["w"] and c["none"] is None for c in copies)
    assert mesh.batch_sharding(m).spec == ("data",)
    assert mesh.replicated_sharding(m).spec == ()
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    for spec in [(None, "model"), ("model", None), ("data", "model"), ()]:
        sh = mesh.place(x, mesh.Placement(m, spec))
        assert len(sh.shards) == 8
        assert torch.equal(sh.gather(), x), spec
    with pytest.raises(ValueError, match="does not split"):
        mesh.place(torch.zeros(3, 2), mesh.Placement(m, ("data",)))


def test_owner_of_a_mesh_position_is_fixed_to_its_card(monkeypatch):
    """A graph owner made for "cuda" keeps the card current at its making,
    so its pool and stream belong to that card, not to a later current."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr("toolbox_for_asr_and_tts_tpu_torch.runtime.autotune."
                        "get_profile", lambda: None)
    assert Programs("cuda", "x").device == torch.device("cuda", 1)
    assert Programs("cuda:0", "y").device == torch.device("cuda", 0)
    assert Programs("cpu", "z").device == CPU


# --------------------------------------------------------- the recognizer
@pytest.fixture(scope="module")
def jparams():
    return jpf.init_params(jax.random.PRNGKey(0), jpf.ParaformerConfig(**TINY))


def _recognizers(jparams, **kw):
    buckets = (SR, 2 * SR)
    ref = JRecognizer(jparams, jpf.ParaformerConfig(**TINY), JTok.dummy(64),
                      bucketer=JBucketer(buckets), use_mesh=True)
    ours = Recognizer(_tree(jparams), pf.ParaformerConfig(**TINY),
                      CharTokenizer.dummy(64), bucketer=Bucketer(buckets),
                      device="cpu", **kw)
    return ours, ref


def test_recognizer_on_mesh(eight, jparams):
    """Mirror of the reference's `test_recognizer_on_mesh`: the batch pads
    to the mesh and splits over 8 positions, each running its own program;
    ids equal the reference's mesh transcribe and a meshless one."""
    ours, ref = _recognizers(jparams)
    local = Recognizer(_tree(jparams), pf.ParaformerConfig(**TINY),
                       CharTokenizer.dummy(64), bucketer=Bucketer((SR, 2 * SR)),
                       device="cpu", use_mesh=False)
    assert ours.mesh.devices.size == ref.mesh.devices.size == 8
    assert local.mesh is None
    wavs = [_wav(1.0), _wav(1.0, seed=9), _wav(0.5, seed=3)]
    got, want, alone = (ours.transcribe(wavs), ref.transcribe(wavs),
                        local.transcribe(wavs))
    assert [r.token_ids for r in got] == [r.token_ids for r in want] \
        == [r.token_ids for r in alone]
    assert [r.timestamp for r in got] == [r.timestamp for r in alone]
    assert sum(len(r.token_ids) for r in got) > 0, "no tokens: not probative"
    # one forward per position, each its own owner's program of 1 row
    assert ours.forwards.n == 8
    assert [o.replays for o in ours._positions] == [1] * 8
    assert all(("forward", 1, SR, False) in o for o in ours._positions)


def test_mesh_recognizer_rescores_on_every_position(eight, jparams):
    """Hotword rescoring: each position re-decodes its rows; ids equal the
    meshless recognizer's."""
    ours, _ = _recognizers(jparams)
    local = Recognizer(_tree(jparams), pf.ParaformerConfig(**TINY),
                       CharTokenizer.dummy(64), bucketer=Bucketer((SR, 2 * SR)),
                       device="cpu", use_mesh=False)
    wavs = [_wav(1.0), _wav(0.7, seed=1)]
    plain = local.transcribe(wavs)
    tok = plain[0].tokens[0] if plain[0].tokens else "a"
    hot = {tok + tok: 5.0}
    got, want = ours.transcribe(wavs, hotwords=hot), local.transcribe(
        wavs, hotwords=hot)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert ours.rescorings.n == 8
    ours.warmup_rescoring(3, SR)   # 3 rows pad to 8: one row per position
    assert all(("logits", 1, ours._bucket_shapes(SR)[0], 16) in o
               for o in ours._positions)


# ------------------------------------------------------------ the ticker
CHUNK_CFG = dict(c1=4, c2=5, encoder_look_back=2)


def _drive(ticker, audios, finalize=False):
    slots = [ticker.join() for _ in audios]
    got = {i: [] for i in range(len(audios))}
    for s in range(0, len(audios[0]), 3200):
        fired = ticker.tick({slots[i]: a[s:s + 3200]
                             for i, a in enumerate(audios)})
        for i in range(len(audios)):
            got[i].extend(fired.get(slots[i], []))
    if finalize:
        for s in slots:
            fired = ticker.finalize_slot(s)   # every row's carried results
            for i in range(len(audios)):
                got[i].extend(fired.get(slots[i], []))
    return got


def _audios(n=8, seed=30):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(9600) * 0.1).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["unpipelined", "pipelined"])
def test_fused_ticker_on_mesh_matches_reference(eight, jparams, pipelined):
    """Mirror of the reference's `test_fused_ticker_on_mesh_matches_single_
    device`: rows shard over 8 positions; the partial ids equal the
    reference's mesh ticker and the port's meshless one, finalize
    included."""
    cfg, ocfg = pf.ParaformerConfig(**TINY), po.OnlineConfig(**CHUNK_CFG)
    audios = _audios()
    jmesh8 = JMesh(np.array(jax.devices()[:8]), ("data",))
    want = _drive(JBatchedChunkedASR(jparams, jpf.ParaformerConfig(**TINY),
                                     jpo.OnlineConfig(**CHUNK_CFG),
                                     capacity=8, partials=True, mesh=jmesh8),
                  audios)
    m8 = mesh.serving_mesh(device="cpu")
    ticker = BatchedChunkedASR(_tree(jparams), cfg, ocfg, capacity=8,
                               partials=True, mesh=m8, pipelined=pipelined)
    got = _drive(ticker, audios, finalize=True)
    alone = _drive(BatchedChunkedASR(_tree(jparams), cfg, ocfg, capacity=8,
                                     partials=True, device="cpu"),
                   audios, finalize=True)
    assert got == alone
    for i in range(8):   # the reference's ticks, then the finalize drain
        assert got[i][:len(want[i])] == want[i]
    assert any(len(v) for v in want.values())
    # 8 positions of one row each, each stepping its own program
    assert ticker.rows_per == 1 and len(ticker._shards) == 8
    assert all(("tick", 1) in sh.programs for sh in ticker._shards)


def test_mesh_ticker_rows_stay_on_their_positions(eight, jparams):
    """A slot keeps its row (slot = row), a leave zeroes it in place, and
    a capacity that does not divide the data axis raises."""
    cfg, ocfg = pf.ParaformerConfig(**TINY), po.OnlineConfig(**CHUNK_CFG)
    m8 = mesh.serving_mesh(device="cpu")
    with pytest.raises(ValueError, match="not divisible by data axis 8"):
        BatchedChunkedASR(_tree(jparams), cfg, ocfg, capacity=12, mesh=m8)
    t = BatchedChunkedASR(_tree(jparams), cfg, ocfg, capacity=16,
                          partials=True, mesh=m8)
    t.warm()
    assert all(list(sh.programs) == [("tick", 2)] for sh in t._shards)
    a, b = t.join(), t.join()
    assert (t.row_of(a), t.row_of(b)) == (a, b) == (15, 14)
    t.tick({a: _audios(1)[0], b: _audios(1, 5)[0]})   # two steps
    state, row = t._at(a)
    assert state is t._shards[7].state and row == 1
    assert float(state["cif_mass"][row]) > 0
    t.leave(a)
    assert float(state["cif_mass"][row]) == 0.0 and t.n_live == 1
    assert t.row_of(b) == 14


def test_chunked_hub_on_mesh(eight, jparams):
    """`ChunkedHub(mesh=...)` serves partials through the mesh ticker."""
    from toolbox_for_asr_and_tts_tpu_torch.service.hub import ChunkedHub
    hub = ChunkedHub(_tree(jparams), pf.ParaformerConfig(**TINY),
                     po.OnlineConfig(**CHUNK_CFG), CharTokenizer.dummy(64),
                     capacity=8, mesh=mesh.serving_mesh(device="cpu"))
    try:
        assert hub.ticker.mesh is not None and len(hub.ticker._shards) == 8
        slot = hub.join()
        for s in range(0, 9600, 3200):
            hub.submit(slot, _audios(1)[0][s:s + 3200])
        hub.leave(slot)
    finally:
        hub.close()


# ------------------------------------------------------- the synthesizer
def test_synthesizer_mesh_matches_reference(eight):
    """Mirror of the reference's `test_synthesizer_mesh_matches_single_
    device`: 3 segments pad to 8 rows; the padding rows give no segment."""
    jsynth = JSynthesizer.random(seed=3, use_mesh=True)
    ap, vp = _tree(jsynth.ap), _tree(jsynth.vp)
    s8 = Synthesizer(ap, jsynth.acfg, vp, jsynth.vcfg, device="cpu",
                     use_mesh=True)
    s1 = Synthesizer(ap, jsynth.acfg, vp, jsynth.vcfg, device="cpu")
    assert s8.mesh.devices.size == jsynth.mesh.devices.size == 8
    segs = ["你好。", "今天天气不错。", "请按时吃药。"]
    w8, d8 = s8.synthesize_segments(segs, "zhitian_emo")
    w1, d1 = s1.synthesize_segments(segs, "zhitian_emo")
    wj, dj = jsynth.synthesize_segments(segs, "zhitian_emo")
    assert d8 == d1 == pytest.approx(dj)
    for a, b, c in zip(w8, w1, wj):
        np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_allclose(a, c, atol=1e-4)
    # one probe and one synthesis per position, each of one row
    assert s8.probes.n == s8.synths.n == 8
    assert all(o.replays == 2 for o in s8._positions)


def test_synthesizer_mesh_skips_mel_grouping(eight, monkeypatch):
    monkeypatch.setenv("TTS_MEL_GROUP", "1")
    monkeypatch.setenv("TTS_GROUP_BY_LENGTH", "0")
    jsynth = JSynthesizer.random(seed=3)
    s8 = Synthesizer(_tree(jsynth.ap), jsynth.acfg, _tree(jsynth.vp),
                     jsynth.vcfg, device="cpu", use_mesh=True)
    assert s8.mel_group
    s8.synthesize_segments(["你好。", "今天天气不错，请按时吃药。"], "zhitian_emo")
    assert s8.synths.n == 8   # one mel group over every position


# --------------------------------------------- kernels and their devices
def test_kernels_raise_on_inputs_on_two_devices():
    """K1, K1's backward and K2 refuse inputs that do not share a device
    (here the CPU and `meta`), rather than move them."""
    x = torch.zeros(2, 5, 8)
    w = torch.zeros(8, 1, 3)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="w on meta"):
        k1.fsmn_depthwise(x, w.to(meta), 1, 1)
    with pytest.raises(ValueError, match="mask must be contiguous on x"):
        k1.fsmn_depthwise(x, w, 1, 1, torch.ones(2, 5, device=meta))
    with pytest.raises(ValueError, match="g on meta"):
        k1dw.fsmn_conv_bwd(x, x.to(meta), w, 1, 1)
    with pytest.raises(ValueError, match="w on meta"):
        k1dw.fsmn_conv_bwd(x, x, w.to(meta), 1, 1)
    with pytest.raises(ValueError, match="on the audio's device"):
        k2.frame_window(torch.zeros(2, 800), torch.zeros(400, device=meta),
                        3, 400, 160, 512)
