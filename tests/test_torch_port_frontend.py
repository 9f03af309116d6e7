"""Port `ops/frontend.py` vs the reference's frontend, and vs the vendored
external goldens (tests/data/frontend_goldens.npz) under the same masks and
limits as tests/test_frontend_goldens.py."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.ops import frontend as jfe  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.ops import frontend as fe  # noqa: E402

GOLDENS = np.load("tests/data/frontend_goldens.npz")
WAVE_NAMES = sorted(k[4:] for k in GOLDENS.files if k.startswith("wav_"))
WINDOWS = ("hamming", "hanning", "povey")


def _wav(batch, n, scale=0.3, seed=0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((batch, n))).astype(np.float32)


def _cfgs(**kw):
    return fe.FrontendConfig(**kw), jfe.FrontendConfig(**kw)


def test_config_mirrors_reference():
    ours, ref = _cfgs()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.frame_length, ours.frame_shift, ours.n_fft) == \
        (ref.frame_length, ref.frame_shift, ref.n_fft)
    for n in (0, 399, 400, 559, 560, 16000, 160000):
        assert fe.num_fbank_frames(n, ours) == jfe.num_fbank_frames(n, ref)
    for t in (0, 1, 6, 7, 998):
        assert fe.num_lfr_frames(t, 6) == jfe.num_lfr_frames(t, 6)


@pytest.mark.parametrize("window", WINDOWS + ("rectangular",))
def test_window_and_mel_banks_equal(window):
    ours, ref = _cfgs(window=window)
    np.testing.assert_array_equal(fe._window_coeffs(ours),
                                  jfe._window_coeffs(ref))
    np.testing.assert_array_equal(fe._mel_banks_np(ours),
                                  jfe._mel_banks_np(ref))


@pytest.mark.parametrize("n,scale,t_frames", [(16000, 0.3, None),
                                              (8000, 1e-4, None),
                                              (6000, 0.3, 30)])
def test_fbank_matches_reference(n, scale, t_frames):
    """Log-mel within 1e-3 (observed 1e-4): the two f32 FFTs and mel
    matmuls round differently, and log() amplifies that in quiet bins.
    (Frames past the audio are garbage the caller masks: there the
    reference's gather clamps while both kernels read zeros, so only
    t_frames <= the audio's frame count is compared.)"""
    ours, ref = _cfgs()
    x = _wav(2, n, scale)
    got = fe.fbank(torch.from_numpy(x), ours, t_frames=t_frames).numpy()
    want = np.asarray(jfe.fbank(jnp.asarray(x), ref, t_frames=t_frames))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.abs(got - want).mean() < 1e-5


@pytest.mark.parametrize("t_out", [None, 9])
def test_apply_lfr_matches_reference(t_out):
    feats = _wav(3, 50 * 8, 1.0).reshape(3, 50, 8)
    got = fe.apply_lfr(torch.from_numpy(feats), 7, 6, t_out=t_out)
    want = jfe.apply_lfr(jnp.asarray(feats), 7, 6, t_out=t_out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_lfr_valid_frames_replicates_last_valid():
    feats = _wav(3, 50 * 8, 1.0).reshape(3, 50, 8)
    valid = np.array([50, 17, 0], np.int32)
    got = fe.apply_lfr(torch.from_numpy(feats), 7, 6, t_out=9,
                       valid_frames=torch.from_numpy(valid))
    want = jfe.apply_lfr(jnp.asarray(feats), 7, 6, t_out=9,
                         valid_frames=jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # row 1's stacks past frame 16 repeat frame 16
    assert (got[1, -1].reshape(7, 8) == torch.from_numpy(feats[1, 16])).all()


def test_apply_cmvn_matches_reference():
    feats = _wav(2, 5 * 16, 1.0).reshape(2, 5, 16)
    means, istd = _wav(1, 16, 1.0)[0], _wav(1, 16, 1.0, seed=1)[0]
    got = fe.apply_cmvn(torch.from_numpy(feats), torch.from_numpy(means),
                        torch.from_numpy(istd))
    want = jfe.apply_cmvn(jnp.asarray(feats), jnp.asarray(means),
                          jnp.asarray(istd))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_valid_frames_floor_division_of_short_lengths():
    """Lengths below one frame make `n - 400` negative: floor division, and
    the clamp at 0, as the reference."""
    ours, ref = _cfgs()
    lens = np.array([0, 1, 239, 399, 400, 401, 559, 560, 1360, 16000],
                    np.int32)
    got = fe.frontend_valid_frames(torch.from_numpy(lens), ours)
    want = jfe.frontend_valid_frames(jnp.asarray(lens), ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vfb = fe.num_valid_fbank_frames(torch.from_numpy(lens), ours)
    want_vfb = jnp.maximum(0, 1 + (jnp.asarray(lens) - 400) // 160)
    np.testing.assert_array_equal(vfb.numpy(), np.asarray(want_vfb))


@pytest.mark.parametrize("wname", WINDOWS)
@pytest.mark.parametrize("wave", WAVE_NAMES)
def test_fbank_matches_external_golden(wave, wname):
    """The goldens test of the reference, run on the port's fbank: the same
    live-bin masks (away from the mel floor, within 12 log units of the
    frame's max) and the same limits."""
    cfg = fe.FrontendConfig(window=wname)
    wav = GOLDENS[f"wav_{wave}"]
    got = fe.fbank(torch.from_numpy(np.array(wav))[None], cfg)[0].numpy()
    want = GOLDENS[f"fbank_{wave}_{wname}"]
    assert got.shape == want.shape, (got.shape, want.shape)
    floor = np.log(1.1920928955078125e-07)
    live = np.maximum(got, want) > floor + 2.0
    live &= want > want.max(axis=1, keepdims=True) - 12.0
    d = np.abs(got - want)[live]
    assert live.mean() > 0.05, "stimulus mostly masked — not probative"
    assert live.any(axis=0).mean() > 0.9, "mel columns never checked"
    assert d.max() < 5e-3, (wave, wname, d.max())
    assert d.mean() < 1e-4, (wave, wname, d.mean())
    assert (np.abs(got - want)[~live] < 4.0).all()
