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
