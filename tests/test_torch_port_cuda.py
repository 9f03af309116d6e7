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
