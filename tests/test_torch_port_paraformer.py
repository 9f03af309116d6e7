"""Port `models/paraformer.py` vs the reference at the tiny geometry of
tests/test_recognizer.py: the reference's `init_params` goes through
`params_from_numpy`, and both sides run `forward` on the same features.
Integer outputs must be equal; float outputs agree within 1e-4 (50 ops of
float32 rounding in another order, amplified by the encoder's √d scale)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402

TINY = dict(input_dim=560, d_model=32, n_heads=2, ffn_dim=64,
            encoder_layers=2, decoder_layers=2, vocab_size=64)
INT_KEYS = ("tokens", "token_count", "fire_frame", "token_start")
FLOAT_KEYS = ("logits", "token_center", "alphas", "enc")


def _cfgs(**kw):
    return pf.ParaformerConfig(**TINY, **kw), jpf.ParaformerConfig(**TINY, **kw)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "bicif"])
def pair(request):
    ours, ref = _cfgs(bicif=request.param)
    jparams = jpf.init_params(jax.random.PRNGKey(0), ref)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return ours, ref, params, jparams


def _feats(b=3, t=40, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((b, t, 560)).astype(np.float32)
    lens = np.array([t, 27, 9], np.int32)[:b]
    return feats, lens


def test_forward_matches_reference(pair):
    ours, ref, params, jparams = pair
    feats, lens = _feats()
    k_max = pf.max_tokens_for(feats.shape[1])
    got = pf.forward(params, torch.from_numpy(feats), torch.from_numpy(lens),
                     k_max, ours)
    want = jpf.forward(jparams, jnp.asarray(feats), jnp.asarray(lens), k_max,
                       ref)
    assert set(got) == set(want)
    keys = INT_KEYS + (("us_start", "us_end") if ours.bicif else ())
    for key in keys:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
        assert got[key].dtype == torch.int32, key
    for key in FLOAT_KEYS + ("embeds",):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    assert int(got["token_count"].max()) > 0, "no token fired: not probative"


def test_stages_match_reference(pair):
    """encode → predictor → cif → decode, stage by stage, on the reference's
    own intermediates, so a fault names its stage."""
    ours, ref, params, jparams = pair
    feats, lens = _feats(seed=1)
    t = feats.shape[1]
    mask = np.array((np.arange(t)[None] < lens[:, None]), np.float32)
    enc_j = jpf.encode(jparams, jnp.asarray(feats), jnp.asarray(mask), ref)
    enc = pf.encode(params, torch.from_numpy(feats), torch.from_numpy(mask),
                    ours)
    np.testing.assert_allclose(enc.numpy(), np.asarray(enc_j), rtol=1e-4,
                               atol=1e-4)
    enc_np = np.array(enc_j)
    al_j = jpf.predictor_alphas(jparams, enc_j, jnp.asarray(mask), ref)
    al = pf.predictor_alphas(params, torch.from_numpy(enc_np),
                             torch.from_numpy(mask), ours)
    np.testing.assert_allclose(al.numpy(), np.asarray(al_j), rtol=1e-5,
                               atol=1e-5)
    k_max = pf.max_tokens_for(t)
    al_np = np.array(al_j)
    cj = jpf.cif(enc_j, jnp.asarray(al_np), k_max)
    c = pf.cif(torch.from_numpy(enc_np), torch.from_numpy(al_np), k_max)
    for a, b in zip(c, cj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    count = np.array(cj[1])
    tmask = np.array((np.arange(k_max)[None] < count[:, None]), np.float32)
    lj = jpf.decode(jparams, cj[0], jnp.asarray(tmask), enc_j,
                    jnp.asarray(mask), ref)
    lo = pf.decode(params, torch.from_numpy(np.array(cj[0])),
                   torch.from_numpy(tmask), torch.from_numpy(enc_np),
                   torch.from_numpy(mask), ours)
    np.testing.assert_allclose(lo.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)


def test_cif_first_index_rules():
    """fire_frame is the FIRST frame whose cumsum reaches k+1, start_frame
    the first with cumsum > k; a token that never fires reads 0 (the
    argmax-of-zeros rule), and the tail frame adds α = 0.45."""
    enc = np.ones((1, 4, 2), np.float32)
    alphas = np.array([[0.5, 0.5, 1.0, 0.3]], np.float32)
    # csum with the tail frame: .5 1 2 2.3 2.75
    out = pf.cif(torch.from_numpy(enc), torch.from_numpy(alphas), 4)
    ref = jpf.cif(jnp.asarray(enc), jnp.asarray(alphas), 4)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    assert out[1].tolist() == [2]                # floor(2.3 + 0.45)
    assert out[2].tolist() == [[1, 2, 0, 0]]     # tokens 2, 3 never fire
    assert out[4].tolist() == [[0, 2, 3, 0]]     # token 3 never starts


def test_upsample_fire_frames_match_reference():
    rng = np.random.default_rng(3)
    us = rng.uniform(0, 0.6, (2, 30)).astype(np.float32)
    count = np.array([7, 0], np.int32)
    got = pf.upsample_fire_frames(torch.from_numpy(us),
                                  torch.from_numpy(count), 16)
    want = jpf.upsample_fire_frames(jnp.asarray(us), jnp.asarray(count), 16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_init_params_tree_and_shapes_match_reference():
    for bicif in (False, True):
        ours, ref = _cfgs(bicif=bicif)
        mine = pf.init_params(ours, torch.Generator().manual_seed(0))
        theirs = jpf.init_params(jax.random.PRNGKey(0), ref)
        a = jax.tree_util.tree_flatten_with_path(jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), mine,
            is_leaf=lambda t: isinstance(t, torch.Tensor)))
        b = jax.tree_util.tree_flatten_with_path(jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype)), theirs))
        assert a == b
    # the same seed draws the same weights
    again = pf.init_params(ours, torch.Generator().manual_seed(0))
    assert torch.equal(again["decoder"]["out"]["w"], mine["decoder"]["out"]["w"])


def test_config_and_helpers_mirror_reference():
    ours, ref = pf.ParaformerConfig(), jpf.ParaformerConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    conf = {"model": "BicifParaformer",
            "encoder_conf": {"output_size": 256, "attention_heads": 4,
                             "linear_units": 1024, "num_blocks": 12,
                             "kernel_size": 11, "sanm_shfit": 2},
            "decoder_conf": {"num_blocks": 6},
            "predictor_conf": {"tail_threshold": 0.45, "l_order": 1,
                               "r_order": 0, "upsample_times": 3},
            "frontend_conf": {"lfr_m": 7, "lfr_n": 6, "n_mels": 80}}
    a = pf.ParaformerConfig.from_funasr(conf, vocab_size=100)
    b = jpf.ParaformerConfig.from_funasr(conf, vocab_size=100)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert pf.predictor_lpad(a) == jpf.predictor_lpad(b) == 1
    for t in (0, 1, 17, 167, 1000):
        assert pf.max_tokens_for(t) == jpf.max_tokens_for(t)
