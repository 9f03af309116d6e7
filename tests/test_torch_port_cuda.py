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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("t", [167, 96, 5])
def test_fsmn_kernel_matches_plain(cuda, dtype, tol, t):
    """f32: the kernel repeats the plain version's roundings (1e-5 leaves
    room for none); bf16: one rounding of the output (1e-2)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((8, t, 512)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((512, 1, 11)) * 0.1)
                         .astype(np.float32))
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
    x = torch.from_numpy(rng.standard_normal((2, 50, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 1, k)).astype(np.float32))
    xt, wt = x.to(cuda), w.to(cuda)
    got = k1.fsmn_depthwise(xt, wt, pad_l, k - 1 - pad_l)
    want = k1.fsmn_depthwise_plain(xt, wt, pad_l, k - 1 - pad_l)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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
