"""Port kernels K1 and K2 on a CUDA card, each against its plain PyTorch
version at the main path's shapes. Needs no JAX, so it runs on a machine
with a card and the port alone:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Without a card every test skips (the kernels have no CPU mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from toolbox_for_asr_and_tts_tpu_torch.ops import frontend as fe  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (  # noqa: E402
    frame_window as k2, fsmn_conv as k1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _fsmn_against_plain(x, w, pad_l, mask=None):
    """One launch (the counter +1), a new contiguous y in x's dtype; f32
    equal to the plain version bit for bit (the kernel repeats its
    roundings in its order), bf16 within 1e-2 (one output rounding)."""
    pad_r = w.shape[-1] - 1 - pad_l
    before = k1.launches
    got = k1.fsmn_depthwise(x, w, pad_l, pad_r, mask)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    want = k1.fsmn_depthwise_plain(x, w, pad_l, pad_r, mask)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert got.is_contiguous()
    if x.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 0.0),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t", [167, 96, 5])
def test_fsmn_kernel_matches_plain(cuda, dtype, tol, t):
    """f32: the kernel repeats the plain version's roundings (exact);
    bf16: one rounding of the output (1e-2)."""
    rng = np.random.default_rng(1)
    x = _randn(rng, 8, t, 512)
    w = _randn(rng, 512, 1, 11, scale=0.1)
    mask = torch.ones(8, t)
    mask[3, t // 2:] = 0.0
    xt, wt, mt = x.to(cuda, dtype), w.to(cuda), mask.to(cuda)
    for m in (None, mt):
        before = k1.launches
        got = k1.fsmn_depthwise(xt, wt, 5, 5, m)
        torch.cuda.synchronize()
        assert k1.launches == before + 1
        want = k1.fsmn_depthwise_plain(xt, wt, 5, 5, m)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("pad_l,k", [(0, 1), (19, 20), (3, 11)])
def test_fsmn_kernel_pads(cuda, pad_l, k):
    rng = np.random.default_rng(2)
    x = _randn(rng, 2, 50, 40)
    w = _randn(rng, 40, 1, k)
    xt, wt = x.to(cuda), w.to(cuda)
    got = k1.fsmn_depthwise(xt, wt, pad_l, k - 1 - pad_l)
    want = k1.fsmn_depthwise_plain(xt, wt, pad_l, k - 1 - pad_l)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["v_view", "odd_d", "unaligned"])
def test_fsmn_kernel_layouts(cuda, dtype, layout):
    """The V third of a [8, 167, 1536] qkv buffer (16-byte vectors, read in
    place); D not a multiple of the vector (30 f32, 36 bf16) and a base off
    16 bytes (x[..., 1:65] of a 68-wide buffer), both on the scalar path."""
    rng = np.random.default_rng(4)
    if layout == "v_view":
        x = _randn(rng, 8, 167, 1536).to(cuda, dtype)[..., 1024:]
    elif layout == "odd_d":
        x = _randn(rng, 2, 50, 30 if dtype == torch.float32 else 36
                   ).to(cuda, dtype)
    else:
        x = _randn(rng, 2, 50, 68).to(cuda, dtype)[..., 1:65]
    b, t, d = x.shape
    w = _randn(rng, d, 1, 11, scale=0.1).to(cuda)
    mask = torch.ones(b, t, device=cuda)
    mask[-1, t // 3:] = 0.0
    assert k1.tile_for(x, 11).vec == (1 if layout != "v_view"
                                      else 16 // x.element_size())
    for m in (None, mask):
        _fsmn_against_plain(x, w, 5, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side", ["pad_left", "pad_right"])
@pytest.mark.parametrize("k", [1, 11, 12, 20])
@pytest.mark.parametrize("t", [1, 5, 167])
def test_fsmn_kernel_lengths_and_taps(cuda, dtype, side, k, t):
    """T shorter than, near and beyond a block's frames; K of SAN-M (11,
    the unrolled instantiation), KWS (12), FSMN-VAD (20) and 1; all the
    padding on the left (causal) or on the right."""
    rng = np.random.default_rng(5)
    x = _randn(rng, 3, t, 256).to(cuda, dtype)
    w = _randn(rng, 256, 1, k, scale=0.1).to(cuda)
    mask = torch.ones(3, t, device=cuda)
    mask[1, (t + 1) // 2:] = 0.0
    pad_l = k - 1 if side == "pad_left" else 0
    for m in (None, mask):
        _fsmn_against_plain(x, w, pad_l, m)


@pytest.mark.parametrize("seconds,extra", [(10.0, 0), (0.1, 3)])
def test_frame_window_kernel_matches_plain(cuda, seconds, extra):
    """rtol 1e-5, atol 1e-5·max|x|: only the mean's summation order
    differs; `extra` frames past the audio read zeros on both."""
    cfg = fe.FrontendConfig()
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.3 * rng.standard_normal((8, int(16000 * seconds)))
                          * 32768.0).astype(np.float32)).to(cuda)
    win = torch.from_numpy(fe._window_coeffs(cfg)).to(cuda)
    t = fe.num_fbank_frames(x.shape[1], cfg) + extra
    before = k2.launches
    got = k2.frame_window(x, win, t, 400, 160, 512)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    want = k2.frame_window_plain(x, win, t, 400, 160, 512)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * x.abs().max().item())


def test_fbank_on_card_matches_cpu(cuda):
    """The whole fbank on the card (K2 + cuFFT + mel matmul) vs the CPU
    (plain framing + pocketfft): log-mel within 1e-3."""
    rng = np.random.default_rng(3)
    wav = torch.from_numpy((0.3 * rng.standard_normal((2, 16000)))
                           .astype(np.float32))
    got = fe.fbank(wav.to(cuda)).cpu()
    want = fe.fbank(wav)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


def test_wrapper_refuses_cpu_mask_with_cuda_x(cuda):
    x = torch.zeros(2, 8, 4, device=cuda)
    w = torch.zeros(4, 1, 3, device=cuda)
    with pytest.raises(ValueError):
        k1.fsmn_depthwise(x, w, 1, 1, torch.ones(2, 8))


# ------------------------------------------------- the streaming shapes
@pytest.mark.parametrize("b", [1, 64])
def test_fsmn_kernel_streaming_window(cuda, b):
    """The chunked encoder's call: the V third of a [B, 9, 1536] qkv
    buffer (window W = 9), K 11, pad (5, 5), no mask; exact in f32."""
    rng = np.random.default_rng(6)
    x = _randn(rng, b, 9, 1536).to(cuda)[..., 1024:]
    w = _randn(rng, 512, 1, 11, scale=0.1).to(cuda)
    assert k1.tile_for(x, 11).vec == 4
    _fsmn_against_plain(x, w, 5)


@pytest.mark.parametrize("b", [1, 64])
def test_fsmn_kernel_vad_cache_window(cuda, b):
    """FSMN-VAD's streaming call: [cache ‖ h] = [B, 19 + 40, 128], K 20,
    causal pad (19, 0), no mask; exact in f32, and rows 19 onward equal h
    plus the valid depthwise conv of [cache ‖ h]."""
    rng = np.random.default_rng(7)
    hc = _randn(rng, b, 59, 128).to(cuda)
    w = _randn(rng, 128, 1, 20, scale=0.1).to(cuda)
    _fsmn_against_plain(hc, w, 19)
    got = k1.fsmn_depthwise(hc, w, 19, 0)[:, 19:]
    valid = torch.nn.functional.conv1d(hc.transpose(1, 2), w, groups=128)
    torch.testing.assert_close(got, hc[:, 19:] + valid.transpose(1, 2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [1, 64])
def test_frame_window_kernel_ring(cuda, b):
    """The fused step's framing of its audio ring: [B, 4320] → 25 frames
    (24·160 + 400 = 4240 ≤ 4320, no frame past the end), ×32768 scale."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy((0.3 * rng.standard_normal((b, 4320)) * 32768.0)
                         .astype(np.float32)).to(cuda)
    win = torch.from_numpy(fe._window_coeffs(fe.FrontendConfig())).to(cuda)
    before = k2.launches
    got = k2.frame_window(x, win, 25, 400, 160, 512)
    torch.cuda.synchronize()
    assert k2.launches == before + 1 and got.shape == (b, 25, 512)
    want = k2.frame_window_plain(x, win, 25, 400, 160, 512)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * x.abs().max().item())


def _tickers_on(device, partials):
    """The tiny-width Paraformer at FULL encoder depth (50 layers, so K1
    runs 50 times a step) and a small VAD, same seeded weights."""
    from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf
    from toolbox_for_asr_and_tts_tpu_torch.parallel import stream_batcher as sb
    cfg = pf.ParaformerConfig(d_model=32, n_heads=2, ffn_dim=64,
                              encoder_layers=50, decoder_layers=2,
                              vocab_size=64)
    vcfg = fv.FsmnVadConfig(proj_dim=16, linear_dim=32, fsmn_layers=4)
    p = pf.init_params(cfg, torch.Generator().manual_seed(0))
    vp = fv.init_params(vcfg, torch.Generator().manual_seed(0))
    return (sb.BatchedChunkedASR(p, cfg, capacity=4, partials=partials,
                                 device=device),
            sb.BatchedVadTicker(vp, vcfg, capacity=4, device=device))


@pytest.mark.parametrize("partials", [False, True])
def test_tickers_on_card_match_cpu(cuda, partials):
    """Both tickers on the card against the same on the CPU, 3 sessions
    of 0.4 s chunks: fired counts and ids equal, embeddings within one
    bf16 step, VAD decisions equal; K1 +50 and K2 +1 per chunked step, K1
    +4 per VAD group step and K2 +1 per fbank length bucket."""
    rng = np.random.default_rng(9)
    audio = [(0.1 * rng.standard_normal(19200)).astype(np.float32)
             for _ in range(3)]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        asr, vad_t = _tickers_on(dev, partials)
        slots = [asr.join() for _ in audio]
        vslots = [vad_t.join() for _ in audio]
        fired, decisions = [], []
        for s in range(0, 19200, 6400):
            k1_0, k2_0, steps_0 = k1.launches, k2.launches, asr.steps
            fired.append(asr.tick({sl: a[s:s + 6400]
                                   for sl, a in zip(slots, audio)}))
            if dev.type == "cuda":
                n = asr.steps - steps_0
                assert k1.launches - k1_0 == 50 * n
                assert k2.launches - k2_0 == n
            k1_0, k2_0 = k1.launches, k2.launches
            decisions.append(vad_t.tick({sl: a[s:s + 6400]
                                         for sl, a in zip(vslots, audio)}))
            if dev.type == "cuda":
                assert k1.launches - k1_0 == 4 and k2.launches - k2_0 == 1
        fired.append(asr.finalize_slot(slots[0]))
        outs[dev.type] = fired, decisions
    (fc, dc), (fg, dg) = outs["cpu"], outs["cuda"]
    assert dc == dg
    assert sum(len(v) for tick in fc for v in tick.values()) > 0
    for a, b in zip(fg, fc):
        assert sorted(a) == sorted(b)
        for s in b:
            assert len(a[s]) == len(b[s])
            if partials:
                assert a[s] == b[s]
            elif b[s]:
                np.testing.assert_allclose(np.stack(a[s]), np.stack(b[s]),
                                           rtol=2.0 ** -7, atol=1e-4)


# ------------------------------------- the service slice's shapes and models
@pytest.mark.parametrize("b,t,masked", [(1, 32, True), (8, 64, True),
                                        (64, 53, False)])
def test_fsmn_kernel_service_shapes(cuda, b, t, masked):
    """CT-Transformer layers: the V third of a [B, T, 1536] qkv buffer, K 11
    pad (5, 5) with a length mask; KWS FSMN layers: [64, 53, 64], K 12 =
    lorder 10 + rorder 2, pad (9, 2), no mask. f32 exact."""
    rng = np.random.default_rng(10 + b)
    if t == 53:
        x = _randn(rng, b, t, 64).to(cuda)
        w = _randn(rng, 64, 1, 12, scale=0.1).to(cuda)
        pad_l = 9
    else:
        x = _randn(rng, b, t, 1536).to(cuda)[..., 1024:]
        w = _randn(rng, 512, 1, 11, scale=0.1).to(cuda)
        pad_l = 5
    mask = None
    if masked:
        mask = torch.ones(b, t, device=cuda)
        mask[0, t - 7:] = 0.0
    _fsmn_against_plain(x, w, pad_l, mask)


def test_frame_window_kernel_kws_batch(cuda):
    """KWS's batch of 64 1.6 s windows: [64, 25600] → 158 frames."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy((0.3 * rng.standard_normal((64, 25600)) * 32768.0)
                         .astype(np.float32)).to(cuda)
    win = torch.from_numpy(fe._window_coeffs(fe.FrontendConfig())).to(cuda)
    before = k2.launches
    got = k2.frame_window(x, win, 158, 400, 160, 512)
    torch.cuda.synchronize()
    assert k2.launches == before + 1 and got.shape == (64, 158, 512)
    want = k2.frame_window_plain(x, win, 158, 400, 160, 512)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * x.abs().max().item())


@pytest.fixture
def no_tf32():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


def _counted(fn):
    torch.cuda.synchronize()
    a, b = k1.launches, k2.launches
    out = fn()
    torch.cuda.synchronize()
    return out, k1.launches - a, k2.launches - b


def _texts(n_words=(9, 23)):
    rng = np.random.default_rng(12)
    return ["".join(chr(0x4E00 + int(c)) for c in rng.integers(0, 4000, n))
            for n in n_words]


def test_punctuator_on_card_matches_cpu(cuda, no_tf32):
    """12 layers at d 64: class ids equal, 12 K1 per forward (one per
    layer) and no K2, logits within 1e-4."""
    from toolbox_for_asr_and_tts_tpu_torch.models import ct_transformer as ct
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_to
    cfg = ct.CTTransformerConfig(vocab_size=4096, num_layers=12, d_model=64,
                                 embed_dim=64, n_heads=2, ffn_dim=128)
    cpu = ct.Punctuator.random(cfg, device="cpu")
    card = ct.Punctuator(tree_to(cpu.params, cuda), cfg, cpu.vocab,
                         device=cuda)
    texts = _texts()
    words = ct.split_words(texts[1])
    got, n1, n2 = _counted(lambda: card.classify(words))
    assert (n1, n2) == (12, 0)
    np.testing.assert_array_equal(got, cpu.classify(words))
    out, n1, _ = _counted(lambda: card.punctuate_many(texts))
    assert n1 == 12 * 2          # two length buckets: two forwards
    assert out == cpu.punctuate_many(texts)
    ids = torch.from_numpy(np.asarray(cpu.vocab.encode(words))[None])
    lens = torch.tensor([len(words)])
    want = ct.forward(cpu.params, ids, lens, cfg)
    logits = ct.forward(card.params, ids.to(cuda), lens.to(cuda), cfg).cpu()
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)


def test_speaker_verifier_on_card_matches_cpu(cuda, no_tf32):
    """One K2 (and no K1) per embed call; embeddings within 1e-3 and
    cosine ≥ 0.9999 of the CPU's; scores within 1e-4."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier
    cpu = SpeakerVerifier.random(device="cpu")
    card = SpeakerVerifier.random(device=cuda)
    rng = np.random.default_rng(13)
    wavs = [(0.3 * rng.standard_normal(n)).astype(np.float32)
            for n in (24000, 16000, 30000)]
    got, n1, n2 = _counted(lambda: card.embed(wavs))
    assert (n1, n2) == (0, 1)
    want = cpu.embed(wavs)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    for a, b in zip(got, want):
        cos = float(a @ b / np.linalg.norm(a) / np.linalg.norm(b))
        assert cos >= 0.9999
    assert abs(card.verify(wavs[0], wavs[1])[1]
               - cpu.verify(wavs[0], wavs[1])[1]) < 1e-4


def test_keyword_spotter_on_card_matches_cpu(cuda, no_tf32):
    """4 FSMN layers (K1 +4) and one fbank (K2 +1) per length group of
    detect_audio_batch; scores within 1e-3 of the CPU's."""
    from toolbox_for_asr_and_tts_tpu_torch.models import kws_ctc
    cfg = kws_ctc.KwsConfig(vocab_size=64, hidden_dim=32, proj_dim=16,
                            num_layers=4)
    cpu = kws_ctc.KeywordSpotter.random(cfg, threshold=0.0, device="cpu")
    card = kws_ctc.KeywordSpotter.random(cfg, threshold=0.0, device=cuda)
    rng = np.random.default_rng(14)
    wins = [(0.3 * rng.standard_normal(25600)).astype(np.float32)
            for _ in range(5)]
    got, n1, n2 = _counted(lambda: card.detect_audio_batch(wins))
    assert (n1, n2) == (4, 1)
    want = cpu.detect_audio_batch(wins)
    for (_, s), (_, w) in zip(got, want):
        assert abs(s - w) < 1e-3
    _, n1, n2 = _counted(lambda: card.detect_audio_batch(
        wins + [wins[0][:16000]]))
    assert (n1, n2) == (8, 2)    # two length groups


# ------------------------------------------------------------------ TTS
def _tts_pair(cuda, mode):
    """The tiny synthesizer on the CPU and the same weights on the card."""
    import os
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    saved = os.environ.get("TTS_DECODER")
    os.environ["TTS_DECODER"] = mode
    try:
        cpu = Synthesizer.random(tiny=True, device="cpu")
        card = Synthesizer(cpu.ap, cpu.acfg, cpu.vp, cpu.vcfg, device=cuda)
    finally:
        if saved is None:
            os.environ.pop("TTS_DECODER")
        else:
            os.environ["TTS_DECODER"] = saved
    return cpu, card


@pytest.mark.parametrize("mode", ["nar", "pnca"])
def test_synthesizer_on_card_matches_cpu(cuda, no_tf32, mode):
    """Tiny Sambert + HiFi-GAN on the card: segments and per-segment
    sample counts (the mel lengths) equal the CPU's, PCM within 1 LSB, and
    no K1 or K2 launch (the TTS path reaches neither)."""
    cpu, card = _tts_pair(cuda, mode)
    text = "今天天气很好。病人血压一百二，心率正常,没有出血。请多休息，按时吃药。谢谢。"
    got, n1, n2 = _counted(lambda: card.synthesize(text))
    assert (n1, n2) == (0, 0)
    want = cpu.synthesize(text)
    assert got.segments == want.segments
    assert got.seg_durations_s == want.seg_durations_s
    pcm = lambda w: np.round(w.astype(np.float64) * 32767.0)  # noqa: E731
    assert len(got.wav) == len(want.wav)
    assert np.abs(pcm(got.wav) - pcm(want.wav)).max() <= 1
    assert np.array_equal(card.synthesize(text).wav, got.wav)   # repeatable


@pytest.mark.parametrize("stride,kernel", [(5, 11), (4, 8), (2, 4)])
def test_conv_transpose1d_on_card_matches_cpu(cuda, no_tf32, stride, kernel):
    from toolbox_for_asr_and_tts_tpu_torch.ops import nn
    rng = np.random.default_rng(15)
    p = {"w": _randn(rng, 64, 32, kernel, scale=0.1),
         "b": _randn(rng, 32, scale=0.1)}
    x = _randn(rng, 4, 50, 64)
    pad = (kernel - stride) // 2
    want = nn.conv_transpose1d(p, x, stride, pad)
    card_p = {k: v.to(cuda) for k, v in p.items()}
    got = nn.conv_transpose1d(card_p, x.to(cuda), stride, pad).cpu()
    assert got.shape == (4, 50 * stride, 32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # deterministic: forward convolutions only (cuDNN's ConvTranspose is not)
    again = nn.conv_transpose1d(card_p, x.to(cuda), stride, pad).cpu()
    assert torch.equal(got, again)


def test_mha_on_card_matches_cpu(cuda, no_tf32):
    from toolbox_for_asr_and_tts_tpu_torch.ops import nn
    p = nn.mha_init(torch.Generator().manual_seed(16), 256, 4)
    rng = np.random.default_rng(16)
    x = _randn(rng, 3, 40, 256)
    mask = (torch.arange(40)[None] < torch.tensor([[40], [17], [1]])).float()
    want = nn.mha(p, x, 4, mask)
    got = nn.mha({k: {n: t.to(cuda) for n, t in v.items()}
                  for k, v in p.items()}, x.to(cuda), 4, mask.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_tts_entry_points_default_to_the_card(cuda):
    """With no device, `Synthesizer` and `create_app`'s lazily built
    synthesizer land on the card."""
    from toolbox_for_asr_and_tts_tpu_torch.service.tts_app import create_app
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    synth = Synthesizer.random(tiny=True)
    assert synth.device.type == "cuda"
    assert synth.ap["encoder"][0]["attn"]["q"]["w"].is_cuda
    assert synth.vp["ups"][0]["w"].is_cuda
    app = create_app()
    try:
        served = app.manager().synth
        assert served.device.type == "cuda"
        assert served.vcfg.upsample_initial_channel == 512   # full width
    finally:
        app.close_engines()


def test_loaded_recognizer_on_card_matches_cpu(cuda, no_tf32, tmp_path):
    """A tiny Paraformer directory (model.pt, config.json, tokens.json,
    am.mvn) loaded by `Recognizer.from_model_dir` on the card (the default
    device) and on the CPU: equal trees and CMVN, K1 once per layer and K2
    once per transcribe, token ids and token counts equal, logits within
    1e-4."""
    import json
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf
    from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ckpt
    cfg = pf.ParaformerConfig(d_model=32, n_heads=2, ffn_dim=64,
                              encoder_layers=3, decoder_layers=2,
                              vocab_size=64)
    tree = pf.init_params(cfg, torch.Generator().manual_seed(0))
    sd = ckpt.invert_to_state_dict(
        tree, ckpt.paraformer_rules(cfg.encoder_layers, cfg.decoder_layers))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, tmp_path / "model.pt")
    (tmp_path / "config.json").write_text(json.dumps({
        "encoder_conf": {"output_size": 32, "attention_heads": 2,
                         "linear_units": 64, "num_blocks": 3},
        "decoder_conf": {"num_blocks": 2}}))
    toks = ["<blank>", "<s>", "</s>"] + [chr(0x4E00 + i) for i in range(60)]
    (tmp_path / "tokens.json").write_text(json.dumps(toks + ["<unk>"]))
    rng = np.random.default_rng(3)
    vecs = [" ".join(f"{v:.5f}" for v in rng.uniform(lo, hi, 560))
            for lo, hi in ((-12, -5), (0.1, 0.5))]
    (tmp_path / "am.mvn").write_text(
        f"<AddShift> 560 560\n[ {vecs[0]} ]\n<Rescale> 560 560\n"
        f"[ {vecs[1]} ]\n")
    card = Recognizer.from_model_dir(str(tmp_path))
    cpu = Recognizer.from_model_dir(str(tmp_path), device="cpu")
    assert card.device.type == "cuda" and card.cfg == cpu.cfg
    assert card.cfg.vocab_size == 64 and card.cmvn[0].is_cuda
    for a, b in zip(card.cmvn, cpu.cmvn):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)
    fa, fb = ckpt.flatten_params(card.params), ckpt.flatten_params(cpu.params)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    t = np.arange(16000) / 16000
    wavs = [(0.3 * np.sin(2 * np.pi * f * t[:n])
             + 0.05 * rng.standard_normal(n)).astype(np.float32)
            for f, n in ((220, 16000), (330, 11000))]
    got, n1, n2 = _counted(lambda: card.transcribe(wavs))
    assert (n1, n2) == (cfg.encoder_layers + cfg.decoder_layers, 1)
    want = cpu.transcribe(wavs)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    batch, lens = cpu.bucketer.pad_batch(wavs)
    a = card.forward_padded(batch, lens)
    b = cpu.forward_padded(batch, lens)
    torch.testing.assert_close(a["token_count"].cpu(), b["token_count"])
    torch.testing.assert_close(a["logits"].cpu(), b["logits"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["offline", "2pass"])
def test_funasr_request_on_card(cuda, no_tf32, mode):
    """The port's FunASR server over the test engines built on the card
    (the default device): an offline / 2pass utterance in 60 ms frames
    gets the final text of a direct diarize + ITN on the same samples,
    and launches K1 and K2 on the card as often as that diarize (2pass: and
    once per layer of each chunked step, and K2 once per step); no
    streaming session or ChunkedHub row stays in use."""
    import time
    from _torch_port_helpers import _speech, funasr_utterance
    from toolbox_for_asr_and_tts_tpu_torch.asr.itn import apply_itn
    from toolbox_for_asr_and_tts_tpu_torch.native.bridge import (
        start_offline_asr_server)
    from toolbox_for_asr_and_tts_tpu_torch.service import engines as E
    engines = E.build_test_engines()
    srv = start_offline_asr_server(engines, port=0)
    try:
        x = np.concatenate([_speech(7, 15), np.zeros(3200, np.float32)])
        pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
        ticker = engines.streaming_factory.hub.ticker
        steps = ticker.steps
        def request():
            got = funasr_utterance(srv.port, mode, pcm.tobytes())
            end = time.time() + 30   # 2pass flushes after its final
            while srv.sessions() and time.time() < end:
                time.sleep(0.01)
            return got

        replies, n1, n2 = _counted(request)
        steps = ticker.steps - steps
        reco = engines.diarizer.inner.recognizer
        assert reco.device.type == "cuda"
        sents, d1, d2 = _counted(lambda: engines.diarizer.diarize(
            pcm.astype(np.float32) / 32768.0))
        kind, final = replies[-1]
        assert kind == "text" and final["is_final"]
        assert final["mode"] == ("2pass-offline" if mode == "2pass"
                                 else "offline")
        text = "".join(s.text for s in sents)
        assert text and final["text"] == apply_itn(text)
        assert (mode == "2pass") == (steps > 0)
        assert n1 == d1 + reco.cfg.encoder_layers * steps > 0
        assert n2 == d2 + steps > 0
        assert srv.sessions() == 0 and ticker.n_live == 0
    finally:
        srv.stop()
        engines.close()


# ------------------------------------- the program layer (runtime/graphs.py)
def _tiny_recognizer(device):
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import (
        ParaformerConfig)
    return Recognizer.random(
        ParaformerConfig(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
                         encoder_layers=2, decoder_layers=2, vocab_size=64),
        device=device)


def _equal_trees(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal_trees(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _equal_trees(a, b)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def _replay_vs_eager(prog, *inputs):
    """A program's replay against its eager function on the same inputs:
    equal bit for bit (TF32 off)."""
    dev = prog.owner.device
    with torch.inference_mode():
        want = prog.fn(*[torch.as_tensor(a).to(dev, dt)
                         for a, (_, dt) in zip(inputs, prog.specs)])
    got = prog(*inputs)
    torch.cuda.synchronize()
    _equal_trees(got, want)


def _wavs(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.standard_normal(n)).astype(np.float32)
            for n in lengths]


def test_recognizer_replay_equals_eager(cuda, no_tf32):
    """The forward and rescoring programs replay what their eager functions
    compute; transcribe (with hotwords: rescoring) equals the CPU's ids."""
    reco = _tiny_recognizer(cuda)
    batch, lens = reco.bucketer.pad_batch(_wavs(20, (16000, 9000, 30000)))
    prog = reco._fn_for(*batch.shape)
    assert prog.graph is not None
    _replay_vs_eager(prog, batch, lens)
    out = prog(batch, lens)
    t_lfr, _ = reco._bucket_shapes(batch.shape[1])
    lp = reco._logits_fn(batch.shape[0], t_lfr, reco.K_BUCKET)
    _replay_vs_eager(lp, *(out[k] for k in reco._RESCORING_INPUTS))
    cpu = _tiny_recognizer("cpu")
    wavs = _wavs(21, (16000, 30000))
    for hw in (None, {"一": 2.0}):
        got = [r.token_ids for r in reco.transcribe(wavs, hotwords=hw)]
        assert got == [r.token_ids for r in cpu.transcribe(wavs, hotwords=hw)]


def test_recognizer_four_threads_replay_one_program(cuda, no_tf32):
    """Hub and REST threads share one recognizer: four threads replaying
    its programs at once get the single-thread answers."""
    import threading
    reco = _tiny_recognizer(cuda)
    batches = [_wavs(30 + i, (16000 + 3000 * i, 12000)) for i in range(4)]
    want = [[r.token_ids for r in reco.transcribe(b, hotwords={"一": 1.0})]
            for b in batches]
    got = [None] * 4

    def run(i):
        for _ in range(5):
            got[i] = [r.token_ids for r in
                      reco.transcribe(batches[i], hotwords={"一": 1.0})]
    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == want


def test_tick_programs_replay_equals_eager(cuda, no_tf32):
    """A chunked tick at two prefix buckets and a VAD tick: the tickers'
    replays against the same programs' eager functions on a second pair
    of tickers (state, fired ids and counts, VAD probabilities bit-equal)."""
    asr_g, vad_g = _tickers_on(cuda, True)
    asr_e, vad_e = _tickers_on(cuda, True)
    rng = np.random.default_rng(22)
    for t in (asr_g, asr_e):
        for _ in range(3):
            t.join()
    for step in range(3):
        audio = (0.2 * rng.standard_normal((4, 6400))).astype(np.float32)
        for b in (2, 4):
            active = np.ones((b,), np.float32)
            prog = asr_g._tick_fn(b)
            a_len = asr_g.chunk_samples
            got = prog(audio[:b, :a_len], active)
            with torch.inference_mode():
                want = asr_e._tick_fn(b).fn(
                    torch.from_numpy(audio[:b, :a_len]).to(cuda),
                    torch.from_numpy(active).to(cuda))
            _equal_trees(got, want)
            _equal_trees(asr_g.state, asr_e.state)
    for t in (vad_g, vad_e):
        t.join()
    feats = (rng.standard_normal((1, 40, vad_g.cfg.input_dim))
             .astype(np.float32))
    got = vad_g._step_fn(1, 40)(feats, np.ones((1,), bool))
    with torch.inference_mode():
        want = vad_e._step_fn(1, 40).fn(torch.from_numpy(feats).to(cuda),
                                        torch.ones((1,), dtype=torch.bool,
                                                   device=cuda))
    _equal_trees(got, want)
    assert torch.equal(vad_g.cache, vad_e.cache)


def test_service_programs_replay_equals_eager(cuda, no_tf32):
    """KWS batch, punctuation and embed programs against their eager
    functions, bit for bit."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier
    from toolbox_for_asr_and_tts_tpu_torch.models import ct_transformer as ct
    from toolbox_for_asr_and_tts_tpu_torch.models import kws_ctc
    kws = kws_ctc.KeywordSpotter.random(device=cuda)
    wins = np.stack(_wavs(23, (25600,) * 4))
    _replay_vs_eager(kws._batch_fn(4, 25600), wins)
    punc = ct.Punctuator.random(device=cuda)
    ids = np.random.default_rng(24).integers(0, 4000, (2, 16)).astype(
        np.int32)
    _replay_vs_eager(punc._fn(2, 16), ids, np.array([16, 9], np.int32))
    sv = SpeakerVerifier.random(device=cuda)
    batch, lens = sv.bucketer.pad_batch(_wavs(25, (16000, 24000)))
    _replay_vs_eager(sv._fn(*batch.shape), batch, lens)


def test_replay_counts_the_captured_launches(cuda, no_tf32):
    """A capture counts no launch; each replay adds the capture's tally
    (K1 once per encoder and decoder layer, K2 once) to the counters."""
    reco = _tiny_recognizer(cuda)
    batch, lens = reco.bucketer.pad_batch(_wavs(26, (16000,)))
    prog, n1, n2 = _counted(lambda: reco._fn_for(*batch.shape))
    assert (n1, n2) == (0, 0) and prog.graph is not None
    assert prog.tally == {"fsmn_conv": 4, "frame_window": 1}
    for reps in (1, 3):
        _, n1, n2 = _counted(lambda: [prog(batch, lens) for _ in range(reps)])
        assert (n1, n2) == (4 * reps, reps)


def test_session_programs_replay_equals_eager(cuda, no_tf32):
    """The per-session programs: OnlineRecognizer's step and incremental
    decode (ids equal the CPU's), the VAD stepper's step; each replay
    bit-equal to its eager function."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer
    from toolbox_for_asr_and_tts_tpu_torch.asr.vad import StreamingVadStepper
    from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po
    cfg = pf.ParaformerConfig(d_model=32, n_heads=2, ffn_dim=64,
                              encoder_layers=4, decoder_layers=2,
                              vocab_size=64)
    p = pf.init_params(cfg, torch.Generator().manual_seed(0))
    audio = _wavs(27, (6400 * 6,))[0]
    ids = {}
    for dev in (cuda, torch.device("cpu")):
        reco = po.OnlineRecognizer(p, cfg, CharTokenizer.dummy(64),
                                   partial_mode="incremental", device=dev)
        for c in range(0, len(audio), 6400):
            reco.push_audio(audio[c:c + 6400])
        ids[dev.type] = list(reco._inc_ids)
        if dev.type == "cuda":
            keys = sorted(reco._state)
            feats = np.random.default_rng(28).standard_normal(
                (1, reco.ocfg.c1, cfg.input_dim)).astype(np.float32)
            _replay_vs_eager(reco._step_fn(), feats,
                             reco._active_mask(reco.ocfg.c1, False),
                             *(reco._state[k] for k in keys))
            emb = torch.randn(1, reco.ocfg.tokens_per_chunk, 32, device=cuda)
            _replay_vs_eager(reco._inc_fn(), emb, np.array([2], np.int32),
                             *(reco._dstate[k] for k in po.DECODER_KEYS))
        reco.finalize()
    assert ids["cuda"] == ids["cpu"] and ids["cpu"]
    vcfg = fv.FsmnVadConfig(proj_dim=16, linear_dim=32, fsmn_layers=4)
    step = StreamingVadStepper(
        fv.init_params(vcfg, torch.Generator().manual_seed(0)), vcfg,
        device=cuda)
    for c in range(3):
        step(audio[c * 6400:(c + 1) * 6400])
    feats = np.random.default_rng(29).standard_normal(
        (1, 40, vcfg.input_dim)).astype(np.float32)
    _replay_vs_eager(step._step_fn(40), feats, step.cache)


def test_pnca_synthesis_replay_equals_eager(cuda, no_tf32):
    """The PNCA synthesis program (the whole AR scan in one graph) and the
    duration probe against their eager functions, bit for bit."""
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    synth = Synthesizer.random(tiny=True, device=cuda)
    synth.decoder_mode = "pnca"
    from toolbox_for_asr_and_tts_tpu_torch.tts.text_frontend import (
        text_to_ling_ids)
    seqs = [text_to_ling_ids(t, synth.g2p, synth.vocab)
            for t in ("你好世界。", "今天天气很好。")]
    ids = np.zeros((2, 16, 4), np.int32)
    for i, q in enumerate(seqs):
        ids[i, :len(q)] = q
    lens = np.array([len(q) for q in seqs], np.int32)
    spk = np.zeros((2,), np.int32)
    _replay_vs_eager(synth._dur_prog(2, 16), ids, lens, spk)
    _replay_vs_eager(synth._synth_prog(2, 16, 64), ids, lens, spk)


def test_a_failing_capture_raises(cuda):
    """A program whose function syncs with the host cannot be captured: the
    build raises, and nothing runs it eagerly instead."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime.graphs import Programs
    progs = Programs(cuda, "failing")
    calls = []

    def fn(x):
        calls.append(torch.cuda.is_current_stream_capturing())
        return x * float(x.sum().item())
    with pytest.raises(Exception):
        progs.get("sync", lambda: (fn, [((4,), torch.float32)]))
    assert "sync" not in progs
    assert calls[-1] is True        # the last run was the capture's
    torch.cuda.synchronize()


def test_an_owner_captures_again_after_a_failed_capture(cuda):
    """Captures that failed end the allocator's routing into the owner's
    pool, so the same owner's next capture takes the pool and replays
    its eager function's bits."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime.graphs import Programs
    progs = Programs(cuda, "again")

    def syncs(x):
        return x * float(x.sum().item())

    def good(x):
        return x * 2.0 + 1.0
    for _ in range(2):
        with pytest.raises(Exception):
            progs.get("sync", lambda: (syncs, [((4,), torch.float32)]))
    prog = progs.get("good", lambda: (good, [((4,), torch.float32)]))
    x = np.arange(4, dtype=np.float32)
    got = prog(x)
    torch.cuda.synchronize()
    assert prog.graph is not None and progs.captures == 1
    assert torch.equal(got.cpu(), good(torch.from_numpy(x)))


# -------------------------------------- K1 under autograd (fine-tuning)
from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (  # noqa: E402
    fsmn_conv_dw as kdw)


def _within(got, want, tol):
    """max |got - want| <= tol · max |want| (in f32)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= tol * max(want.abs().max().item(), 1e-30), err


def _backward_on_card(x, w, pad_l, mask, cot):
    """dx and dw of sum(K1(x) · cot) through `FsmnDepthwiseFn` on the
    card, with the launches it made: (dx, dw, K1 launches, dw launches)."""
    xg = x.detach().requires_grad_(True)
    wg = w.detach().clone().requires_grad_(True)
    pad_r = w.shape[-1] - 1 - pad_l
    y = k1.fsmn_depthwise(xg, wg, pad_l, pad_r, mask)
    torch.cuda.synchronize()
    a, b = k1.launches, kdw.launches
    (y.float() * cot).sum().backward()
    torch.cuda.synchronize()
    return xg.grad, wg.grad, k1.launches - a, kdw.launches - b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("side", ["pad_left", "pad_right", "sanm"])
@pytest.mark.parametrize("k", [1, 11, 12, 20])
@pytest.mark.parametrize("t", [1, 5, 167])
def test_fsmn_backward_matches_plain(cuda, dtype, side, k, t):
    """On a strided view (the V third of a [3, T, 768] buffer) one backward
    is one launch of K1's backward kernel and no K1 launch: dx against
    autograd of the plain version (f32 within 1e-6 of max|dx|: another
    order of the same sums) and, in f32, equal bit for bit to the plain
    version with the taps reversed and the pads swapped; dw against
    `fsmn_conv_dw_plain` (f32 within 1e-5 of max|dw|); bf16 within 1e-2."""
    rng = np.random.default_rng(11)
    x = _randn(rng, 3, t, 768).to(cuda, dtype)[..., 512:]
    w = _randn(rng, 256, 1, k, scale=0.1).to(cuda)
    cot = _randn(rng, 3, t, 256).to(cuda)
    mask = torch.ones(3, t, device=cuda)
    mask[1, (t + 1) // 2:] = 0.0
    pad_l = {"pad_left": k - 1, "pad_right": 0, "sanm": (k - 1) // 2}[side]
    pad_r = k - 1 - pad_l
    f32 = dtype == torch.float32
    for m in (None, mask):
        dx, dw, n1, n_dw = _backward_on_card(x, w, pad_l, m, cot)
        assert (n1, n_dw) == (0, 1)
        assert dx.shape == x.shape and dx.dtype == dtype
        assert dw.shape == w.shape and dw.dtype == torch.float32
        xp = x.detach().requires_grad_(True)
        wp = w.detach().clone().requires_grad_(True)
        (k1.fsmn_depthwise_plain(xp, wp, pad_l, pad_r, m).float() * cot
         ).sum().backward()
        _within(dx, xp.grad, 1e-6 if f32 else 1e-2)
        g = cot.to(dtype)
        if f32:
            assert torch.equal(dx, k1.fsmn_depthwise_plain(
                g, w.flip(-1), pad_r, pad_l, m))
        _within(dw, kdw.fsmn_conv_dw_plain(x, g, k, pad_l, m).to(dtype),
                1e-5 if f32 else 1e-2)


def _encoder_case(b):
    """The encoder's backward inputs at batch b: x the V view of
    [b, 167, 1536], g, w, a length mask with a short row."""
    rng = np.random.default_rng(12)
    x = _randn(rng, b, 167, 1536).to("cuda")[..., 1024:]
    g = _randn(rng, b, 167, 512).to("cuda")
    w = _randn(rng, 512, 1, 11, scale=0.1).to("cuda")
    mask = torch.ones(b, 167, device="cuda")
    mask[2, 60:] = 0.0
    return x, g, w, mask


def test_fsmn_dw_is_deterministic(cuda):
    """No float atomics: at the encoder's shape (the V view of
    [8, 167, 1536]) two runs of dw alone and two of the fused call give the
    same bits, and so do two replays of a captured fused call (each replay
    zeroes its own tickets by a memset node before the kernel) and the
    eager call."""
    x, g, w, mask = _encoder_case(8)
    a = kdw.fsmn_conv_dw(x, g, 11, 5, mask)
    b = kdw.fsmn_conv_dw(x, g, 11, 5, mask)
    dx1, dw1 = kdw.fsmn_conv_bwd(x, g, w, 5, 5, mask)
    dx2, dw2 = kdw.fsmn_conv_bwd(x, g, w, 5, 5, mask)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(dw1, dw2)
    assert torch.equal(dx1, dx2)
    _within(a, kdw.fsmn_conv_dw_plain(x, g, 11, 5, mask), 1e-5)
    _within(dw1, a, 1e-5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kdw.fsmn_conv_bwd(x, g, w, 5, 5, mask)   # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = kdw.fsmn_conv_bwd(x, g, w, 5, 5, mask)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], dx1) and torch.equal(out[1], dw1)


def test_fsmn_backward_replay_beside_an_eager_call(cuda):
    """A captured fused call replayed on another stream while the capture
    stream runs an eager call on other inputs: the two share no tickets or
    scratch, so each gives the bits it gives alone, round after round."""
    x, g, w, mask = _encoder_case(8)
    x2, g2 = x.flip(0), g.flip(0)
    want = kdw.fsmn_conv_bwd(x, g, w, 5, 5, mask)
    want2 = kdw.fsmn_conv_bwd(x2, g2, w, 5, 5, mask)
    cap, other = torch.cuda.Stream(), torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(cap):
        kdw.fsmn_conv_bwd(x, g, w, 5, 5, mask)   # warm-up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=cap):
        out = kdw.fsmn_conv_bwd(x, g, w, 5, 5, mask)
    torch.cuda.synchronize()
    for _ in range(20):
        for s in (cap, other):
            s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(other):
            graph.replay()
        with torch.cuda.stream(cap):
            got2 = kdw.fsmn_conv_bwd(x2, g2, w, 5, 5, mask)
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        assert torch.equal(got2[0], want2[0]) and torch.equal(got2[1],
                                                              want2[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,pad_l", [(11, 5), (12, 9)])
def test_fsmn_backward_scalar_path(cuda, dtype, k, pad_l):
    """x and g whose base is not 16-byte aligned take the kernel's scalar
    instantiation: still one launch, f32 dx bit-equal to the reversed-taps
    plain version, dw within 1e-5 of max|dw| (bf16 1e-2)."""
    rng = np.random.default_rng(14)
    x = _randn(rng, 3, 40, 260).to(cuda, dtype)[..., 1:257]
    g = _randn(rng, 3, 40, 260).to(cuda, dtype)[..., 3:259]
    w = _randn(rng, 256, 1, k, scale=0.1).to(cuda)
    mask = torch.ones(3, 40, device=cuda)
    mask[0, 25:] = 0.0
    assert kdw.tile_for(x, g, k).vec == 1
    before = kdw.launches
    dx, dw = kdw.fsmn_conv_bwd(x, g, w, pad_l, k - 1 - pad_l, mask)
    torch.cuda.synchronize()
    assert kdw.launches == before + 1
    want = k1.fsmn_depthwise_plain(g, w.flip(-1), k - 1 - pad_l, pad_l, mask)
    if dtype == torch.float32:
        assert torch.equal(dx, want)
    else:
        _within(dx, want, 1e-2)
    _within(dw, kdw.fsmn_conv_dw_plain(x, g, k, pad_l, mask),
            1e-5 if dtype == torch.float32 else 1e-2)


def test_fsmn_backward_at_batch_64(cuda):
    """Batch 64 of the encoder's shape (many blocks per channel stripe, so
    the last block adds many partials): dx bit-equal to the reversed-taps
    plain version, dw within 1e-5 of max|dw| of the plain version."""
    x, g, w, mask = _encoder_case(64)
    dx, dw = kdw.fsmn_conv_bwd(x, g, w, 5, 5, mask)
    torch.cuda.synchronize()
    assert torch.equal(dx, k1.fsmn_depthwise_plain(g, w.flip(-1), 5, 5,
                                                   mask))
    _within(dw, kdw.fsmn_conv_dw_plain(x, g, 11, 5, mask), 1e-5)


@pytest.mark.parametrize("wants", [(True, True), (True, False),
                                   (False, True)])
def test_fsmn_backward_launch_counts(cuda, wants):
    """A backward with both gradients, or dw alone, is one launch of K1's
    backward kernel; dx alone is one K1 launch (taps reversed). Without
    grad, or with grad off, the forward is the plain K1 launch and no
    Function."""
    rng = np.random.default_rng(13)
    x = _randn(rng, 2, 30, 64).to(cuda)
    w = _randn(rng, 64, 1, 11, scale=0.1).to(cuda)
    xg = x.clone().requires_grad_(wants[0])
    wg = w.clone().requires_grad_(wants[1])
    y = k1.fsmn_depthwise(xg, wg, 5, 5)
    torch.cuda.synchronize()
    a, b = k1.launches, kdw.launches
    y.sum().backward()
    torch.cuda.synchronize()
    want = {(True, True): (0, 1), (True, False): (1, 0),
            (False, True): (0, 1)}[wants]
    assert (k1.launches - a, kdw.launches - b) == want
    assert (xg.grad is not None, wg.grad is not None) == wants
    with torch.no_grad():
        assert k1.fsmn_depthwise(xg, wg, 5, 5).grad_fn is None


def test_frame_window_raises_on_an_input_that_requires_grad(cuda):
    """K2 has no backward: on the card it refuses to cut the graph."""
    cfg = fe.FrontendConfig()
    x = torch.zeros(2, 16000, device=cuda, requires_grad=True)
    win = torch.from_numpy(fe._window_coeffs(cfg)).to(cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        k2.frame_window(x, win, 98, 400, 160, 512)
    with torch.no_grad():
        assert k2.frame_window(x, win, 98, 400, 160, 512).shape == (2, 98, 512)


def test_train_step_on_card_matches_cpu(cuda, no_tf32):
    """One fine-tuning step at tiny geometry on the card against the CPU:
    features from `tools/finetune._features` (K2 once), loss within 1e-5,
    every gradient within 1e-4 of its leaf's norm, and the launches of
    the step: 1 K1 (forward) and 1 backward (dx and dw) per FSMN layer."""
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_map
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    cfg = pf.ParaformerConfig(d_model=32, n_heads=2, ffn_dim=64,
                              encoder_layers=3, decoder_layers=2,
                              vocab_size=64)
    layers = cfg.encoder_layers + cfg.decoder_layers
    rows = [(w, list(range(4, 4 + n))) for w, n in
            zip(_wavs(14, (24000, 17000)), (7, 5))]
    grads = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda a: a.to(dev), pf.init_params(
            cfg, torch.Generator().manual_seed(0)))
        init_opt, step = ts.make_train_step(cfg, device=dev)
        opt = init_opt(params)
        torch.cuda.synchronize()
        a, b, c = k1.launches, kdw.launches, k2.launches
        batch = finetune._features(rows, cfg.frontend, 8, dev)
        if dev == "cpu":
            feats = batch["feats"]
        batch["feats"] = feats.to(dev)      # the same features on both
        loss, _ = ts.paraformer_loss(params, batch["feats"],
                                     batch["feat_lens"], batch["targets"],
                                     batch["target_lens"], cfg)
        loss.backward()
        torch.cuda.synchronize()
        if dev != "cpu":
            assert (k1.launches - a, kdw.launches - b,
                    k2.launches - c) == (layers, layers, 1)
        leaves = []
        tree_map(leaves.append, params)
        grads[str(dev)] = (loss.item(), [p.grad.cpu() for p in leaves])
        params, opt, m = step(params, opt, batch)
        assert np.isfinite(m["loss"].item())
    (l_cpu, g_cpu), (l_card, g_card) = grads["cpu"], grads["cuda"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    for a, b in zip(g_card, g_cpu):
        assert (a - b).norm() <= 1e-4 * max(b.norm().item(), 1e-30)


# ------------------------------------------------ reduced precision
@pytest.mark.parametrize("d_in,d_out", [(512, 1536), (2048, 512), (32, 96)])
@pytest.mark.parametrize("rows", [1, 9, 16, 17, 1336])
def test_linear_int8_on_card_equals_cpu(cuda, rows, d_in, d_out):
    """`_linear_int8` on the card (cuBLASLt's int8 product through
    `torch._int_mm`, rows under 17 padded) equals the CPU's bit for bit:
    the int32 product is exact and the elementwise steps round alike."""
    from toolbox_for_asr_and_tts_tpu_torch.ops import nn
    rng = np.random.default_rng(rows + d_in)
    p = {"w": _randn(rng, d_in, d_out, scale=d_in ** -0.5),
         "b": _randn(rng, d_out, scale=0.1)}
    x = _randn(rng, 1, rows, d_in)
    q = nn.quantize_linear_int8(p)
    qc = nn.quantize_linear_int8({k: v.to(cuda) for k, v in p.items()})
    for k in q:
        assert torch.equal(qc[k].cpu(), q[k]), k
    got = nn.linear(qc, x.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == (1, rows, d_out) and got.dtype == torch.float32
    assert torch.equal(got.cpu(), nn.linear(q, x))


def _int8_recognizer(device, monkeypatch):
    monkeypatch.setenv("PARAFORMER_QUANT", "int8")
    return _tiny_recognizer(device)


def test_int8_recognizer_on_card_holds_the_cpu_leaves(cuda, no_tf32,
                                                      monkeypatch):
    """Under PARAFORMER_QUANT=int8 a card Recognizer and a CPU Recognizer
    from one seed hold the same int8 `q` and f32 `s` bit for bit, and
    transcribe to the same ids."""
    reco = _int8_recognizer(cuda, monkeypatch)
    cpu = _int8_recognizer("cpu", monkeypatch)
    n = 0
    for a, b in zip(reco.params["encoder"]["layers"],
                    cpu.params["encoder"]["layers"]):
        for lin in (a["attn"]["qkv"], a["attn"]["out"], a["ffn"]["w1"],
                    a["ffn"]["w2"]):
            assert lin["w"].dtype == torch.int8 and lin["w"].is_cuda
        for got, want in ((a["attn"]["qkv"], b["attn"]["qkv"]),
                          (a["attn"]["out"], b["attn"]["out"]),
                          (a["ffn"]["w1"], b["ffn"]["w1"]),
                          (a["ffn"]["w2"], b["ffn"]["w2"])):
            assert torch.equal(got["w"].cpu(), want["w"])
            assert torch.equal(got["s"].cpu(), want["s"])
            n += 1
    assert n == 4 * len(cpu.params["encoder"]["layers"])
    wavs = _wavs(22, (16000, 9000, 30000))
    assert [r.token_ids for r in reco.transcribe(wavs)] == \
        [r.token_ids for r in cpu.transcribe(wavs)]


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_reduced_precision_replay_equals_eager(cuda, no_tf32, monkeypatch,
                                               mode):
    """The captured forward of an int8 (and a bf16) Recognizer replays
    what its eager function computes, bit for bit."""
    if mode == "int8":
        reco = _int8_recognizer(cuda, monkeypatch)
    else:
        from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import (
            Recognizer)
        reco = Recognizer.random(_tiny_recognizer("cpu").cfg, device=cuda,
                                 param_dtype=torch.bfloat16)
    batch, lens = reco.bucketer.pad_batch(_wavs(23, (16000, 9000)))
    prog = reco._fn_for(*batch.shape)
    assert prog.graph is not None
    _replay_vs_eager(prog, batch, lens)


# --------------------------------- the dispatch profile and the rehearsal
def _pcm_wavs(seed, lengths):
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import to_int16_pcm
    return [to_int16_pcm(w) / np.float32(32768.0)
            for w in _wavs(seed, lengths)]


def test_profile_resolves_local_with_the_cuda_knobs(cuda):
    from toolbox_for_asr_and_tts_tpu_torch.runtime import autotune as at
    at._cache.clear()
    try:
        prof = at.get_profile()
    finally:
        at._cache.clear()
    assert prof["name"] == "local" and prof["platform"] == "cuda"
    assert prof["rtt_ms"] < at.TUNNEL_RTT_MS
    assert {k: prof[k] for k in at.profile_knobs("local", "cuda")} == \
        at.profile_knobs("local", "cuda")


def test_framing_switch_off_raises_on_the_card(cuda, monkeypatch):
    x = torch.zeros((1, 16000), device=cuda)
    monkeypatch.setenv("USE_PALLAS_FRAMING", "0")
    with pytest.raises(ValueError, match="USE_PALLAS_FRAMING"):
        fe.fbank(x)
    monkeypatch.delenv("USE_PALLAS_FRAMING")
    before = k2.launches
    fe.fbank(x)
    torch.cuda.synchronize()
    assert k2.launches == before + 1


def test_int16_upload_equals_f32_on_the_card(cuda, no_tf32, monkeypatch):
    """On PCM-sourced audio the int16 upload gives the f32 path's outputs
    bit for bit: a transcribe (K1 4 / K2 1 each) and a chunked step."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import to_int16_pcm
    recos, tickers = {}, {}
    for mode in ("1", "0"):
        monkeypatch.setenv("PARAFORMER_TRANSFER_INT16", mode)
        recos[mode] = _tiny_recognizer(cuda)
        tickers[mode] = _tickers_on(cuda, True)[0]
    assert recos["1"]._int16_transfer and not recos["0"]._int16_transfer
    wavs = _pcm_wavs(40, (16000, 9000, 30000))
    batch, lens = recos["0"].bucketer.pad_batch(wavs)
    a = recos["1"]._fn_for(*batch.shape)(to_int16_pcm(batch), lens)
    b = recos["0"]._fn_for(*batch.shape)(batch, lens)
    _equal_trees(a, b)
    (got, n1, n2), want = _counted(lambda: recos["1"].transcribe(wavs)), \
        recos["0"].transcribe(wavs)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert (n1, n2) == (4, 1)
    audio = _pcm_wavs(41, (6400,) * 4)
    for t in tickers.values():
        for _ in range(4):
            t.join()
    outs = [t.tick({s: a for s, a in enumerate(audio)})
            for t in tickers.values()]
    assert outs[0] == outs[1]
    _equal_trees(tickers["1"].state, tickers["0"].state)


def test_rehearse_on_a_tiny_zoo_exits_0_on_the_card(cuda, tmp_path, capsys,
                                                    monkeypatch):
    """`cli rehearse` (default device: the card) over the synthetic zoo of
    tests/_torch_port_helpers.py: every family converted, REST, WS and a
    TTS job served, exit status 0."""
    import json
    from _torch_port_helpers import write_zoo, zoo_state_dicts
    from toolbox_for_asr_and_tts_tpu_torch import cli
    monkeypatch.setenv("VOICE_DISABLE_LLM", "1")
    monkeypatch.setenv("VOICE_BATCH_CAPACITY", "4")
    root = write_zoo(tmp_path / "zoo", zoo_state_dicts())
    cli.main(["rehearse", str(root), "--reconvert", "--report",
              str(tmp_path / "report.json")])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["ok"], report["strict_failures"]
    assert {v["status"] for v in report["families"].values()} == {"converted"}
    assert report["service"]["tts"]["status"] == "completed"


# ----------------------------------------------------- the mesh layer
def _positions(monkeypatch, devices):
    from toolbox_for_asr_and_tts_tpu_torch.runtime import mesh
    monkeypatch.setattr(mesh, "local_devices",
                        lambda platform="cuda": list(devices))


def test_mesh_transcribe_on_two_positions_equals_one(cuda, no_tf32,
                                                     monkeypatch):
    """(a) at tiny width: 2 positions on card 0 (each its own programs and
    K1 / K2 launches) give the ids of `use_mesh=False`; each position's
    owner is card 0."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    alone = _tiny_recognizer(cuda)
    c0 = torch.device("cuda", 0)
    _positions(monkeypatch, [c0, c0])
    reco = Recognizer(alone.params, alone.cfg, alone.tokenizer,
                      bucketer=alone.bucketer, device="cuda")
    assert [o.device for o in reco._positions] == [c0, c0]
    wavs = _wavs(21, (16000, 9000, 30000))
    want = alone.transcribe(wavs)
    before = (k1.launches, k2.launches)
    got = reco.transcribe(wavs)
    torch.cuda.synchronize()
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    layers = alone.cfg.encoder_layers + alone.cfg.decoder_layers
    assert (k1.launches - before[0], k2.launches - before[1]) == \
        (2 * layers, 2)
    assert all(o.replays == 1 for o in reco._positions)


def test_seq_parallel_on_the_card_equals_encode(cuda, no_tf32):
    """(d) at tiny width: 4 positions of card 0, K1 on the gathered V each
    layer; the encoding within the reference test's 2e-4 of `encode`, the
    long-form ids equal `forward`'s."""
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_to
    from toolbox_for_asr_and_tts_tpu_torch.ops import nn
    from toolbox_for_asr_and_tts_tpu_torch.parallel import seqparallel as sq
    from toolbox_for_asr_and_tts_tpu_torch.parallel.sharding import (
        make_2d_mesh)
    cfg = pf.ParaformerConfig(input_dim=24, d_model=16, n_heads=2,
                              ffn_dim=32, encoder_layers=3, decoder_layers=1,
                              vocab_size=32)
    params = tree_to(pf.init_params(cfg, torch.Generator().manual_seed(0)),
                     cuda)
    rng = np.random.default_rng(0)
    feats = _randn(rng, 2, 64, 24).to(cuda)
    lens = torch.tensor([64, 41], device=cuda)
    mask = nn.length_mask(lens, 64)
    mesh = make_2d_mesh(4, 1, devices=[torch.device("cuda", 0)] * 4)
    with torch.inference_mode():
        before = k1.launches
        got = sq.encode_seq_parallel(params, feats, mask, cfg, mesh)
        torch.cuda.synchronize()
        assert k1.launches - before == 4 * cfg.encoder_layers
        want = pf.encode(params, feats, mask, cfg)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        long_ = sq.transcribe_long_forward(params, feats, lens, 12, cfg,
                                           mesh)
        plain = pf.forward(params, feats, lens, 12, cfg)
    assert torch.equal(long_["tokens"], plain["tokens"])
    assert torch.equal(long_["token_count"], plain["token_count"])


def test_kernels_launch_on_a_second_card(cuda):
    """K1, K1's backward and K2 launch on their tensors' card and its
    current stream, whichever card is current (needs two cards)."""
    from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (
        fsmn_conv_dw as kdw)
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    c1 = torch.device("cuda", 1)
    rng = np.random.default_rng(3)
    x = _randn(rng, 2, 40, 64).to(c1)
    w = _randn(rng, 64, 1, 11, scale=0.1).to(c1)
    g = _randn(rng, 2, 40, 64).to(c1)
    with torch.cuda.device(0):
        y = k1.fsmn_depthwise(x, w, 5, 5)
        dx, dw = kdw.fsmn_conv_bwd(x, g, w, 5, 5)
        audio = _randn(rng, 2, 16000).to(c1)
        win = torch.hamming_window(400, periodic=False).to(c1)
        fr = k2.frame_window(audio, win, 98, 400, 160, 512)
    torch.cuda.synchronize(c1)
    assert y.device == dx.device == dw.device == fr.device == c1
    torch.testing.assert_close(y, k1.fsmn_depthwise_plain(x, w, 5, 5),
                               rtol=0, atol=0)
    pdx, pdw = kdw.fsmn_conv_bwd_plain(x, g, w, 5, 5)
    torch.testing.assert_close(dx, pdx, rtol=0, atol=0)
    torch.testing.assert_close(dw, pdw, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        fr, k2.frame_window_plain(audio, win, 98, 400, 160, 512),
        rtol=1e-5, atol=1e-5 * float(audio.abs().max()))


# ------------------- the unfused and unbucketed tickers, single-phase TTS
def _chunked_on(device, **kw):
    """`_tickers_on`'s chunked ticker (50 encoder layers, tiny width),
    with the given flags."""
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf
    from toolbox_for_asr_and_tts_tpu_torch.parallel import stream_batcher as sb
    cfg = pf.ParaformerConfig(d_model=32, n_heads=2, ffn_dim=64,
                              encoder_layers=50, decoder_layers=2,
                              vocab_size=64)
    p = pf.init_params(cfg, torch.Generator().manual_seed(0))
    return sb.BatchedChunkedASR(p, cfg, capacity=4, device=device, **kw)


def test_frame_window_kernel_unfused_quantum(cuda):
    """The unfused ticker's fbank quantum: [64, 4080] → 24 frames."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy((0.3 * rng.standard_normal((64, 4080)) * 32768.0)
                         .astype(np.float32)).to(cuda)
    win = torch.from_numpy(fe._window_coeffs(fe.FrontendConfig())).to(cuda)
    before = k2.launches
    got = k2.frame_window(x, win, 24, 400, 160, 512)
    torch.cuda.synchronize()
    assert k2.launches == before + 1 and got.shape == (64, 24, 512)
    want = k2.frame_window_plain(x, win, 24, 400, 160, 512)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * x.abs().max().item())


def test_unfused_ticker_on_card_matches_cpu(cuda, no_tf32):
    """`fused=False` on the card against the CPU, 3 sessions of 0.4 s
    chunks and a reset: fired counts equal tick for tick, embeddings
    within 1e-4; K1 +50 per step and K2 +1 per fbank quantum call."""
    rng = np.random.default_rng(19)
    audio = [(0.1 * rng.standard_normal(19200)).astype(np.float32)
             for _ in range(3)]
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        asr = _chunked_on(dev, fused=False)
        slots = [asr.join() for _ in audio]
        fired = []
        for s in range(0, 19200, 6400):
            if s == 12800:
                asr.reset_slot(slots[1])
            k1_0, k2_0 = k1.launches, k2.launches
            steps_0, fb_0 = asr.steps, asr.fbanks
            fired.append(asr.tick({sl: a[s:s + 6400]
                                   for sl, a in zip(slots, audio)}))
            if dev.type == "cuda":
                torch.cuda.synchronize()
                assert k1.launches - k1_0 == 50 * (asr.steps - steps_0)
                assert k2.launches - k2_0 == asr.fbanks - fb_0 > 0
        outs[dev.type] = fired
    assert sum(len(v) for t in outs["cpu"] for v in t.values()) > 0
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert {s: len(v) for s, v in a.items()} == \
            {s: len(v) for s, v in b.items()}
        for s in b:
            if b[s]:
                np.testing.assert_allclose(np.stack(a[s]), np.stack(b[s]),
                                           rtol=0, atol=1e-4)


def test_unbucketed_ticker_on_card_equals_bucketed(cuda, no_tf32):
    """`bucketed=False` on the card: every step one full 4-row program (K1
    50 / K2 1), the ids of the bucketed ticker, finalize included."""
    rng = np.random.default_rng(20)
    audio = [(0.1 * rng.standard_normal(12800)).astype(np.float32)
             for _ in range(3)]
    got = {}
    for bucketed in (False, True):
        asr = _chunked_on(cuda, partials=True, bucketed=bucketed)
        slots = [asr.join() for _ in audio]
        ids = {i: [] for i in range(3)}
        back = {s: i for i, s in enumerate(slots)}
        k1_0, k2_0, steps_0 = k1.launches, k2.launches, asr.steps
        for s in range(0, 12800, 6400):
            for sl, v in asr.tick({sl: a[s:s + 6400] for sl, a in
                                   zip(slots[:1 + s // 6400], audio)}).items():
                ids[back[sl]].extend(v)
        for sl in slots:
            for sl2, v in asr.finalize_slot(sl).items():
                ids[back[sl2]].extend(v)
        torch.cuda.synchronize()
        n = asr.steps - steps_0
        assert (k1.launches - k1_0, k2.launches - k2_0) == (50 * n, n)
        if not bucketed:
            assert list(asr.programs) == [("tick", 4)]
        got[bucketed] = ids
    assert got[False] == got[True]
    assert sum(len(v) for v in got[False].values()) > 0


def test_finalize_drain_on_card_matches_cpu(cuda, no_tf32, monkeypatch):
    """The finalize drain on the card, pipelined: the ids of ticks and
    finalizes equal the CPU's; K1 50 and K2 1 per step, the drains' steps
    included; the drain's program lives with the tail, so the ticker's own
    programs are the ticks'; its replays run on a stream that no tick
    replay ran on."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime import graphs
    streams = {}
    call = graphs.Program.__call__

    def spy(self, *args, **kw):
        if self.owner.on_card:
            streams.setdefault(self.key[0], set()).add(
                torch.cuda.current_stream(self.owner.device).cuda_stream)
        return call(self, *args, **kw)
    monkeypatch.setattr(graphs.Program, "__call__", spy)
    rng = np.random.default_rng(31)
    audio = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in (12800, 16000, 19200)]
    got = {}
    for dev in (cuda, torch.device("cpu")):
        asr = _chunked_on(dev, partials=True, pipelined=True)
        asr.warm()
        slots = [asr.join() for _ in audio]
        back = {s: i for i, s in enumerate(slots)}
        ids = {i: [] for i in range(3)}
        k1_0, k2_0, steps_0 = k1.launches, k2.launches, asr.steps
        for s in range(0, 19200, 6400):
            for sl, v in asr.tick({sl: a[s:s + 6400] for sl, a in
                                   zip(slots, audio) if s < len(a)}).items():
                ids[back[sl]].extend(v)
        drained = []
        for sl in slots:
            before = asr.drain_steps
            for sl2, v in asr.finalize_slot(sl).items():
                ids[back[sl2]].extend(v)
            drained.append(asr.drain_steps - before)
        assert asr.drains == 3 and all(n in (2, 3) for n in drained)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            n = asr.steps - steps_0
            assert (k1.launches - k1_0, k2.launches - k2_0) == (50 * n, n)
            assert {k[0] for k in asr.programs} == {"tick"}
            assert ("drain", 1) in asr.shared
        got[dev.type] = ids, drained
    assert got["cuda"] == got["cpu"]
    assert sum(len(v) for v in got["cpu"][0].values()) > 0
    assert streams["drain"] and streams["tick"]
    assert not streams["drain"] & streams["tick"]


@pytest.mark.parametrize("mode", ["nar", "pnca"])
def test_single_phase_synthesis_on_card_matches_cpu(cuda, no_tf32, mode,
                                                    monkeypatch):
    """TTS_TWO_PHASE=0 on the card: no probe, one synthesis per phone
    group, PCM within 1 LSB of the CPU's single-phase run, no K1 or K2."""
    monkeypatch.setenv("TTS_TWO_PHASE", "0")
    cpu, card = _tts_pair(cuda, mode)
    assert not card.two_phase and not cpu.two_phase
    text = "今天天气很好。病人血压一百二，心率正常,没有出血。请多休息，按时吃药。谢谢。"
    probes, synths = card.probes.n, card.synths.n
    got, n1, n2 = _counted(lambda: card.synthesize(text))
    assert (n1, n2) == (0, 0)
    assert card.probes.n == probes and card.synths.n > synths
    want = cpu.synthesize(text)
    assert got.seg_durations_s == want.seg_durations_s
    pcm = lambda w: np.round(w.astype(np.float64) * 32767.0)  # noqa: E731
    assert len(got.wav) == len(want.wav)
    assert np.abs(pcm(got.wav) - pcm(want.wav)).max() <= 1


# ------------------ the captured fine-tuning step (runtime/train_graph.py)
def _train_cfg(remat=False):
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf
    return pf.ParaformerConfig(d_model=32, n_heads=2, ffn_dim=64,
                               encoder_layers=3, decoder_layers=2,
                               vocab_size=64, remat=remat)


def _train_state(cfg, dev):
    """A fresh seed-0 tree on `dev`, its AdamW (`trainstep.adamw`) and its
    eager step."""
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf
    from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_map
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    params = tree_map(lambda a: a.to(dev), pf.init_params(
        cfg, torch.Generator().manual_seed(0)))
    init_opt, step = ts.make_train_step(cfg, device=dev)
    return params, init_opt(params), step


def _train_batch(cfg, dev):
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    rows = [(w, list(range(4, 4 + n))) for w, n in
            zip(_wavs(14, (24000, 17000)), (7, 5))]
    return finetune._features(rows, cfg.frontend, 8, dev)


def _train_tensors(params, opt):
    """Every parameter and AdamW state tensor, in order."""
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    leaves = ts.param_leaves(params)
    return leaves + [opt.state[p][k] for p in leaves
                     for k in sorted(opt.state[p])]


@pytest.fixture
def deterministic():
    flag = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = flag


@pytest.mark.parametrize("remat", [False, True])
def test_captured_train_step_equals_eager(cuda, no_tf32, deterministic,
                                          remat):
    """5 calls of the captured step (the eager step at the batch's shape,
    the eager step and its capture, then 3 replays) against 5 eager steps
    of the same AdamW made capturable: losses, parameters and AdamW state
    bit for bit, the storages kept from call to call, no gradient left
    behind. Under remat the recompute runs on autograd's thread inside the
    capture."""
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (
        capturable, capture_train_step)
    cfg = _train_cfg(remat)
    batch = _train_batch(cfg, cuda)
    params, opt, step = _train_state(cfg, cuda)
    assert not opt.param_groups[0]["capturable"]
    capturable(opt)
    want = [step(params, opt, batch)[2]["loss"].item() for _ in range(5)]
    want_t = _train_tensors(params, opt)
    params, opt, step = _train_state(cfg, cuda)
    cstep = capture_train_step(step, params, opt)
    assert opt.param_groups[0]["capturable"]
    got, ptrs = [], []
    for _ in range(5):
        got.append(cstep(params, opt, batch)[2]["loss"].item())
        ptrs.append([t.data_ptr() for t in _train_tensors(params, opt)])
        assert all(p.grad is None for p in ts.param_leaves(params))
    assert got == want
    assert ptrs[0] == ptrs[1] == ptrs[2] == ptrs[3] == ptrs[4]
    for a, b in zip(_train_tensors(params, opt), want_t):
        assert torch.equal(a, b)
    stats = cstep.stats()
    assert (stats["programs"], stats["eager"], stats["captures"],
            stats["replays"]) == (1, 1, 1, 3)
    assert stats["pool_bytes"] > 0


def test_train_replay_counts_k1_and_its_backward(cuda, no_tf32,
                                                 deterministic):
    """Every call counts one K1 and one backward per FSMN layer, a replay
    by its capture's tally (the backward launches from autograd's thread,
    on the capture stream); K2 stays with the features."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (
        capture_train_step)
    cfg = _train_cfg()
    layers = cfg.encoder_layers + cfg.decoder_layers
    batch = _train_batch(cfg, cuda)
    params, opt, step = _train_state(cfg, cuda)
    cstep = capture_train_step(step, params, opt)
    for _ in range(4):
        torch.cuda.synchronize()
        a, b, c = k1.launches, kdw.launches, k2.launches
        cstep(params, opt, batch)
        torch.cuda.synchronize()
        assert (k1.launches - a, kdw.launches - b, k2.launches - c) == \
            (layers, layers, 0)
    assert cstep.programs.replays == 2
    prog = cstep.programs._progs[next(iter(cstep.programs))]
    assert prog.tally == {"fsmn_conv": layers, "fsmn_conv_dw": layers}


def test_a_failing_train_capture_raises(cuda):
    """A step that syncs with the host inside its function: the first
    call's eager step runs; the second runs the step, then its capture
    raises, saying the step was applied; so does the third. The program
    stays without a graph: nothing runs eagerly in a capture's place."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (
        capture_train_step)
    cfg = _train_cfg()
    batch = _train_batch(cfg, cuda)
    params, opt, step = _train_state(cfg, cuda)
    capturing = []

    def syncing(p, o, b):
        out = step(p, o, b)
        capturing.append(torch.cuda.is_current_stream_capturing())
        float(out[2]["loss"])
        return out
    cstep = capture_train_step(syncing, params, opt)
    cstep(params, opt, batch)
    assert capturing == [False]
    for _ in range(2):
        with pytest.raises(Exception) as err:
            cstep(params, opt, batch)
        assert "advanced one step" in " ".join(err.value.__notes__)
        progs = cstep.programs
        assert len(progs) == 1 and capturing[-1] is True
        assert progs._progs[next(iter(progs))].graph is None
    torch.cuda.synchronize()


def test_restore_into_a_captured_step(cuda, no_tf32, deterministic,
                                      tmp_path):
    """A checkpoint restored into a step that has captured: the parameters
    keep their storages, the optimizer takes the saved state, and the step
    drops its program and makes it again (an eager step, then the step and
    its capture); the run continues bit-equal to the run that was saved."""
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as ts
    from toolbox_for_asr_and_tts_tpu_torch.runtime import train_ckpt as tc
    from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (
        capture_train_step)
    cfg = _train_cfg()
    batch = _train_batch(cfg, cuda)
    params, opt, step = _train_state(cfg, cuda)
    cstep = capture_train_step(step, params, opt)
    for i in range(5):
        if i == 2:
            tc.save_train_state(str(tmp_path), 2, params, opt)
        cstep(params, opt, batch)
    # copies outside autograd: a clone under grad mode would keep the
    # leaves' gradient accumulators on this stream, which the capture
    # on its side stream cannot use
    want = [t.detach().clone() for t in _train_tensors(params, opt)]
    ptrs = [p.data_ptr() for p in ts.param_leaves(params)]
    assert cstep.programs.captures == 1 and cstep.programs.replays == 3
    assert tc.restore_train_state(str(tmp_path), params, opt)[0] == 2
    assert [p.data_ptr() for p in ts.param_leaves(params)] == ptrs
    assert all(t.is_cuda for t in _train_tensors(params, opt))
    for _ in range(3):
        cstep(params, opt, batch)
    stats = cstep.stats()
    assert (stats["programs"], stats["eager"], stats["captures"],
            stats["replays"]) == (1, 2, 2, 4)
    for a, b in zip(_train_tensors(params, opt), want):
        assert torch.equal(a, b)
