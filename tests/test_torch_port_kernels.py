"""Port kernels K1 (FSMN memory conv) and K2 (fbank framing).

On the CPU each wrapper runs its plain PyTorch version; those are held here
against the reference's Pallas kernels in interpret mode. The kernels
themselves run only on a CUDA card: tests/test_torch_port_cuda.py holds each
one against its plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.ops import frontend as jfe  # noqa: E402
from toolbox_for_asr_and_tts_tpu.ops import nn as jnn  # noqa: E402
from toolbox_for_asr_and_tts_tpu.ops.pallas.frame_window import (  # noqa: E402
    frame_window as jax_frame_window)
from toolbox_for_asr_and_tts_tpu.ops.pallas.fsmn_conv import (  # noqa: E402
    fsmn_depthwise as jax_fsmn_depthwise)
from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (  # noqa: E402
    frame_window as k2, fsmn_conv as k1)

FSMN_SHAPES = [(100, 64, 11, 5), (50, 128, 20, 19), (200, 96, 11, 8),
               (167, 512, 11, 5)]


def _fsmn_inputs(t, d, k, seed=1, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, t, d)).astype(np.float32)
    w = (rng.standard_normal((d, 1, k)) * 0.1).astype(np.float32)
    return x, w


def _audio(seconds=1.0, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    return (0.3 * rng.standard_normal((batch, n)) * 32768.0).astype(np.float32)


# ------------------------------------------------------------- K1 on CPU
@pytest.mark.parametrize("t,d,k,pad_l", FSMN_SHAPES)
def test_fsmn_plain_matches_pallas_and_nn(t, d, k, pad_l):
    """Plain K1 vs the Pallas kernel (interpret mode) and the reference's
    XLA `fsmn_block`, within 1e-5: both sum the same K f32 products, in
    another order."""
    x, w = _fsmn_inputs(t, d, k)
    pad_r = k - 1 - pad_l
    before = k1.launches
    got = k1.fsmn_depthwise(torch.from_numpy(x), torch.from_numpy(w),
                            pad_l, pad_r).numpy()
    assert k1.launches == before, "a CPU tensor must not count a launch"
    pallas = np.asarray(jax_fsmn_depthwise(jnp.asarray(x), jnp.asarray(w),
                                           pad_l, pad_r, interpret=True))
    ref = np.asarray(jnn.fsmn_block({"w": jnp.asarray(w)}, jnp.asarray(x),
                                    (pad_l, pad_r)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_fsmn_plain_mask_matches_nn():
    x, w = _fsmn_inputs(40, 32, 11)
    mask = np.ones((2, 40), np.float32)
    mask[0, 25:] = 0.0
    mask[1, 3:] = 0.0
    got = k1.fsmn_depthwise(torch.from_numpy(x), torch.from_numpy(w), 5, 5,
                            torch.from_numpy(mask)).numpy()
    ref = np.asarray(jnn.fsmn_block({"w": jnp.asarray(w)}, jnp.asarray(x),
                                    (5, 5), jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert (got[0, 25:] == 0).all() and (got[1, 3:] == 0).all()


def test_fsmn_plain_bf16_keeps_dtype():
    x, w = _fsmn_inputs(30, 16, 5)
    xb = torch.from_numpy(x).bfloat16()
    got = k1.fsmn_depthwise(xb, torch.from_numpy(w), 2, 2)
    assert got.dtype == torch.bfloat16
    want = k1.fsmn_depthwise(xb.float(), torch.from_numpy(w).bfloat16().float(),
                             2, 2)
    # one bf16 rounding of the f32 result: relative 2^-8
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("case", ["rank", "dtype", "contiguous", "w_shape",
                                  "pads", "mask_shape", "mask_dtype",
                                  "device"])
def test_fsmn_wrapper_rejects(case):
    x = torch.zeros(2, 8, 4)
    w = torch.zeros(4, 1, 3)
    kw = dict(pad_l=1, pad_r=1, mask=None)
    if case == "rank":
        x = torch.zeros(8, 4)
    elif case == "dtype":
        x = x.half()
    elif case == "contiguous":
        x = torch.zeros(2, 4, 8).transpose(1, 2)
    elif case == "w_shape":
        w = torch.zeros(5, 1, 3)
    elif case == "pads":
        kw.update(pad_l=2, pad_r=1)
    elif case == "mask_shape":
        kw.update(mask=torch.ones(2, 7))
    elif case == "mask_dtype":
        kw.update(mask=torch.ones(2, 8, dtype=torch.float64))
    elif case == "device":
        x = torch.zeros(2, 8, 4, device="meta")
        w = torch.zeros(4, 1, 3, device="meta")
    with pytest.raises((ValueError, TypeError)):
        k1.fsmn_depthwise(x, w, **kw)


# ------------------------------------------------------------- K2 on CPU
def test_frame_window_plain_matches_pallas():
    """Plain K2 vs the Pallas kernel (interpret mode) on 1 s of audio at
    ×32768 scale: rtol 1e-5, atol 1e-5·max|x| (the frame mean is summed in
    another order)."""
    cfg = jfe.FrontendConfig()
    x = _audio()
    t = jfe.num_fbank_frames(x.shape[1], cfg)
    win = jfe._window_coeffs(cfg)
    before = k2.launches
    got = k2.frame_window(torch.from_numpy(x), torch.from_numpy(win), t,
                          cfg.frame_length, cfg.frame_shift, cfg.n_fft,
                          cfg.preemphasis, cfg.remove_dc_offset).numpy()
    assert k2.launches == before
    want = np.asarray(jax_frame_window(
        jnp.asarray(x), jnp.asarray(win), t, cfg.frame_length,
        cfg.frame_shift, cfg.n_fft, cfg.preemphasis, cfg.remove_dc_offset,
        interpret=True))
    assert got.shape == want.shape == (2, t, cfg.n_fft)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(x).max())


def test_frame_window_plain_past_end_reads_zeros():
    """Frames beyond the audio see zeros, as in the Pallas kernel."""
    cfg = jfe.FrontendConfig()
    x = _audio(0.1, batch=1)
    t = jfe.num_fbank_frames(x.shape[1], cfg) + 3
    win = jfe._window_coeffs(cfg)
    got = k2.frame_window(torch.from_numpy(x), torch.from_numpy(win), t,
                          400, 160, 512).numpy()
    want = np.asarray(jax_frame_window(jnp.asarray(x), jnp.asarray(win), t,
                                       400, 160, 512, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(x).max())


@pytest.mark.parametrize("case", ["rank", "dtype", "window", "frames"])
def test_frame_window_wrapper_rejects(case):
    audio, win, t = torch.zeros(1, 1600), torch.ones(400), 5
    if case == "rank":
        audio = torch.zeros(1600)
    elif case == "dtype":
        audio = audio.double()
    elif case == "window":
        win = torch.ones(399)
    elif case == "frames":
        t = -1
    with pytest.raises(ValueError):
        k2.frame_window(audio, win, t, 400, 160, 512)
