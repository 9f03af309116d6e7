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


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("t,d,k,pad_l", [(13, 32, 11, 5), (40, 64, 20, 19)])
def test_fsmn_plain_on_qkv_v_view(t, d, k, pad_l, with_mask):
    """The wrapper takes the V third of a numpy-seeded [2, T, 3D] buffer as
    a view (as SAN-M passes it) and gives, within 1e-5, what it gives on the
    contiguous copy, the reference's `fsmn_block` on the same V, and (without
    a mask, which the Pallas kernel does not take) the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((2, t, 3 * d)).astype(np.float32)
    w = (rng.standard_normal((d, 1, k)) * 0.1).astype(np.float32)
    mask = np.ones((2, t), np.float32)
    mask[1, t // 2:] = 0.0
    v = torch.from_numpy(qkv)[..., 2 * d:]
    assert not v.is_contiguous() and v.stride() == (3 * d * t, 3 * d, 1)
    m = torch.from_numpy(mask) if with_mask else None
    pad_r = k - 1 - pad_l
    got = k1.fsmn_depthwise(v, torch.from_numpy(w), pad_l, pad_r, m).numpy()
    assert got.flags["C_CONTIGUOUS"] and got.shape == (2, t, d)
    copy = k1.fsmn_depthwise(v.contiguous(), torch.from_numpy(w), pad_l,
                             pad_r, m).numpy()
    np.testing.assert_allclose(got, copy, rtol=1e-5, atol=1e-5)
    v_np = np.ascontiguousarray(qkv[..., 2 * d:])
    ref = np.asarray(jnn.fsmn_block(
        {"w": jnp.asarray(w)}, jnp.asarray(v_np), (pad_l, pad_r),
        jnp.asarray(mask) if with_mask else None))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    if not with_mask:
        pallas = np.asarray(jax_fsmn_depthwise(
            jnp.asarray(v_np), jnp.asarray(w), pad_l, pad_r, interpret=True))
        np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case,dtype,vec", [
    ("v_view", torch.float32, 4), ("v_view", torch.bfloat16, 8),
    ("contiguous", torch.float32, 4), ("odd_d", torch.float32, 1),
    ("odd_d", torch.bfloat16, 1), ("unaligned", torch.float32, 1),
    ("odd_frame_stride", torch.bfloat16, 1)])
def test_fsmn_tile_vector_or_scalar(case, dtype, vec):
    """16-byte vectors need x's base, batch and frame strides and D to be
    multiples of 16 bytes; anything else takes the kernel's scalar path."""
    if case == "v_view":
        x = torch.zeros(8, 167, 1536, dtype=dtype)[..., 1024:]
    elif case == "contiguous":
        x = torch.zeros(8, 96, 512, dtype=dtype)
    elif case == "odd_d":
        x = torch.zeros(2, 50, 30 if dtype == torch.float32 else 36,
                        dtype=dtype)
    elif case == "unaligned":   # only the base is off 16 bytes
        x = torch.zeros(2, 50, 68, dtype=dtype)[..., 1:65]
    else:
        x = torch.zeros(2, 50, 3 * 64 + 4, dtype=dtype)[..., :64]
    tile = k1.tile_for(x, 11)
    assert tile.vec == vec
    assert tile.k_const == (11 if vec > 1 else 0)
    assert tile.smem_bytes(11) <= k1._SMEM_LIMIT
    assert tile.block_frames() >= tile.frames


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fsmn_tile_fits_shared_memory_at_max_taps(dtype):
    x = torch.zeros(2, 50, 512, dtype=dtype)
    tile = k1.tile_for(x, k1.MAX_TAPS)
    assert tile.k_const == 0
    assert tile.smem_bytes(k1.MAX_TAPS) <= k1._SMEM_LIMIT
    assert tile.channels % 8 == 0
    assert tile.threads_d() * tile.threads_t <= k1.THREADS


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,frames,threads_t", [
    (167, 4, 16),   # the encoder: 384 blocks fill 132 SMs with 4 frames
    (96, 2, 16),    # the decoder: 4 frames would leave 256 blocks, 2 do not
    (5, 2, 4),      # a short input: one block of whole warps along T
    (1, 2, 4)])
def test_fsmn_tile_frames_fill_the_card(dtype, t, frames, threads_t):
    """4 frames per thread only where the grid still gives each of the
    H100's 132 SMs 2.5 blocks; threads along T in whole warps, no more than
    T needs."""
    x = torch.zeros(8, t, 3 * 512, dtype=dtype)[..., 1024:]
    tile = k1.tile_for(x, 11)
    assert (tile.frames, tile.channels, tile.threads_t) == (
        frames, k1.TILE_CHANNELS, threads_t)
    assert tile.block_frames() * -(-t // tile.block_frames()) >= t
    assert tile.threads_d() * tile.threads_t % 32 == 0


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
                                  "device", "channel_stride"])
def test_fsmn_wrapper_rejects(case):
    """Any batch and frame stride is taken; a channel stride other than 1
    (a transpose, a step along D) is not."""
    x = torch.zeros(2, 8, 4)
    w = torch.zeros(4, 1, 3)
    kw = dict(pad_l=1, pad_r=1, mask=None)
    if case == "rank":
        x = torch.zeros(8, 4)
    elif case == "dtype":
        x = x.half()
    elif case == "contiguous":
        x = torch.zeros(2, 4, 8).transpose(1, 2)
    elif case == "channel_stride":
        x = torch.zeros(2, 8, 8)[..., ::2]
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
