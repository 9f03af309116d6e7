"""Port `ops/nn.py` vs the reference's ops, on the same numpy inputs and the
same parameter tree, within 1e-5 (float32 sums in another order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.ops import nn as jnn  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.ops import nn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pt(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **TOL)


def _mask(b, t, lens):
    return np.array(jnn.length_mask(jnp.asarray(lens), t))


def test_length_mask():
    lens = np.array([0, 3, 7], np.int32)
    got = nn.length_mask(torch.from_numpy(lens), 7)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _mask(3, 7, lens))


def test_linear():
    p = jnn.linear_init(jax.random.PRNGKey(0), 24, 40)
    x = _x(2, 5, 24)
    _close(nn.linear(_pt(p), torch.from_numpy(x)),
           jnn.linear(p, jnp.asarray(x)))


def test_linear_mixed_bf16_weights_promote_to_f32():
    """bf16 weights × f32 activations → f32 product, as jnp.matmul's
    promotion (torch would refuse the mixed operands)."""
    p = jnn.linear_init(jax.random.PRNGKey(1), 16, 8)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    x = _x(3, 16)
    got = nn.linear(params_from_numpy(_np_tree(pb), device="cpu",
                                      dtype=torch.bfloat16),
                    torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, jnn.linear(pb, jnp.asarray(x)))


def test_layernorm_eps_and_population_variance():
    p = {"g": jnp.asarray(_x(32, seed=1)), "b": jnp.asarray(_x(32, seed=2))}
    x = _x(2, 6, 32) * 1e-4          # tiny variance: eps 1e-12 matters
    x[0, 0] = 3.0                    # constant row: variance 0
    _close(nn.layernorm(_pt(p), torch.from_numpy(x)),
           jnn.layernorm(p, jnp.asarray(x)))


@pytest.mark.parametrize("stride,padding,groups,dilation",
                         [(1, (1, 1), 1, 1), (1, (0, 2), 1, 1),
                          (2, (1, 0), 1, 1), (1, (2, 2), 8, 2)])
def test_conv1d(stride, padding, groups, dilation):
    p = jnn.conv1d_init(jax.random.PRNGKey(2), 16, 24, 3, groups=groups)
    x = _x(2, 11, 16)
    _close(nn.conv1d(_pt(p), torch.from_numpy(x), stride, padding, groups,
                     dilation),
           jnn.conv1d(p, jnp.asarray(x), stride, padding, groups, dilation))


@pytest.mark.parametrize("t,d", [(167, 560), (10, 32)])
def test_sinusoidal_posenc(t, d):
    """XLA's and torch's f32 `exp` differ by 1 ulp on a few frequencies, and
    the angle pos·inv carries that ulp times the position: the two agree
    within 1e-7·t (1.7e-5 at t = 167). The port's table is within 1e-7 of
    float64 sin/cos of its own angles."""
    got = nn.sinusoidal_posenc(t, d)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jnn.sinusoidal_posenc(t, d)),
                               rtol=0, atol=1e-7 * t)
    half = d // 2
    inv = torch.exp(torch.arange(half, dtype=torch.float32)
                    * -(np.log(10000.0) / (half - 1)))
    ang = (torch.arange(1, t + 1, dtype=torch.float32)[:, None]
           * inv[None]).double()
    exact = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    np.testing.assert_allclose(got.double().numpy(), exact.numpy(),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("with_mask", [False, True])
def test_fsmn_block(with_mask):
    p = jnn.fsmn_memory_init(jax.random.PRNGKey(3), 32, 11)
    x = _x(3, 20, 32)
    mask = _mask(3, 20, np.array([20, 9, 1])) if with_mask else None
    got = nn.fsmn_block(_pt(p), torch.from_numpy(x), (5, 5),
                        None if mask is None else torch.from_numpy(mask))
    want = jnn.fsmn_block(p, jnp.asarray(x), (5, 5),
                          None if mask is None else jnp.asarray(mask))
    _close(got, want)


@pytest.mark.parametrize("with_mask", [False, True])
def test_fsmn_block_on_qkv_v_view(with_mask):
    """fsmn_block on the V third of a [B, T, 3D] buffer, as SAN-M passes it:
    the reference's fsmn_block on the same V."""
    p = jnn.fsmn_memory_init(jax.random.PRNGKey(8), 32, 11)
    qkv = _x(3, 20, 96, seed=9)
    mask = _mask(3, 20, np.array([20, 9, 1])) if with_mask else None
    got = nn.fsmn_block(_pt(p), torch.from_numpy(qkv)[..., 64:], (5, 5),
                        None if mask is None else torch.from_numpy(mask))
    want = jnn.fsmn_block(p, jnp.asarray(qkv[..., 64:]), (5, 5),
                          None if mask is None else jnp.asarray(mask))
    _close(got, want)


@pytest.mark.parametrize("with_mask", [False, True])
def test_sanm_attention_passes_v_view_without_copy(monkeypatch, with_mask):
    """K1 receives the V third of the qkv product itself: a view sharing its
    storage, at offset 2D with frame stride 3D, so no copy precedes it; the
    attention still equals the reference's."""
    seen = {"linear": [], "fsmn": []}
    linear, fsmn = nn.linear, nn.fsmn_depthwise

    def spy_linear(p, x):
        y = linear(p, x)
        seen["linear"].append(y)
        return y

    def spy_fsmn(x, *args):
        seen["fsmn"].append(x)
        return fsmn(x, *args)

    monkeypatch.setattr(nn, "linear", spy_linear)
    monkeypatch.setattr(nn, "fsmn_depthwise", spy_fsmn)
    p = jnn.sanm_attention_init(jax.random.PRNGKey(4), 48, 32, 4, 11)
    x = _x(2, 13, 48)
    mask = _mask(2, 13, np.array([13, 6])) if with_mask else None
    got = nn.sanm_attention(_pt(p), torch.from_numpy(x), 4,
                            None if mask is None else torch.from_numpy(mask),
                            11, 0)
    qkv = seen["linear"][0]
    (v,) = seen["fsmn"]
    assert qkv.shape == (2, 13, 96)
    assert v.untyped_storage().data_ptr() == qkv.untyped_storage().data_ptr()
    assert v.data_ptr() == qkv.data_ptr() + 64 * qkv.element_size()
    assert v.stride() == qkv.stride() and not v.is_contiguous()
    _close(got, jnn.sanm_attention(p, jnp.asarray(x), 4,
                                   None if mask is None else jnp.asarray(mask),
                                   11, 0))


@pytest.mark.parametrize("k,shift", [(11, 0), (11, 2), (4, 0), (1, 0)])
def test_sanm_pad(k, shift):
    assert nn.sanm_pad(k, shift) == jnn.sanm_pad(k, shift)


def test_attend_fully_masked_row_is_uniform():
    q, k, v = _x(2, 2, 5, 8, seed=1), _x(2, 2, 7, 8, seed=2), _x(2, 2, 7, 8, seed=3)
    mask = _mask(2, 7, np.array([7, 0]))[:, None, :]   # row 1: nothing valid
    got = nn.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                    torch.from_numpy(mask))
    want = jnn.attend(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask))
    assert torch.isfinite(got).all()
    _close(got, want)
    # uniform weights over all keys: the mean of v
    _close(got[1], v[1].mean(axis=1, keepdims=True).repeat(5, axis=1))


def test_attend_full_pattern_mask():
    q, k, v = _x(1, 2, 4, 8, seed=4), _x(1, 2, 4, 8, seed=5), _x(1, 2, 4, 8, seed=6)
    mask = np.tril(np.ones((4, 4), np.float32))[None]
    _close(nn.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                     torch.from_numpy(mask)),
           jnn.attend(*(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(mask)))


@pytest.mark.parametrize("d_in,with_mask", [(48, True), (32, False)])
def test_sanm_attention(d_in, with_mask):
    p = jnn.sanm_attention_init(jax.random.PRNGKey(4), d_in, 32, 4, 11)
    x = _x(2, 13, d_in)
    mask = _mask(2, 13, np.array([13, 6])) if with_mask else None
    got = nn.sanm_attention(_pt(p), torch.from_numpy(x), 4,
                            None if mask is None else torch.from_numpy(mask),
                            11, 0)
    want = jnn.sanm_attention(p, jnp.asarray(x), 4,
                              None if mask is None else jnp.asarray(mask),
                              11, 0)
    _close(got, want)


def test_cross_attention():
    p = jnn.cross_attention_init(jax.random.PRNGKey(5), 32, 32, 32, 2)
    x, mem = _x(2, 6, 32, seed=7), _x(2, 9, 32, seed=8)
    mask = _mask(2, 9, np.array([9, 4]))
    _close(nn.cross_attention(_pt(p), torch.from_numpy(x),
                              torch.from_numpy(mem), 2,
                              torch.from_numpy(mask)),
           jnn.cross_attention(p, jnp.asarray(x), jnp.asarray(mem), 2,
                               jnp.asarray(mask)))


@pytest.mark.parametrize("with_mask", [False, True])
def test_mha_over_kv_matches_reference(with_mask):
    """`mha(..., kv=)`: queries from x, keys and values from kv (the
    reference's `ops/nn.py:329-337`), with and without a key mask."""
    p = jnn.mha_init(jax.random.PRNGKey(3), 32, 4)
    x, kv = _x(2, 5, 32, seed=1), _x(2, 9, 32, seed=2)
    mask = _mask(2, 9, [9, 4]) if with_mask else None
    want = jnn.mha(p, jnp.asarray(x), 4,
                   None if mask is None else jnp.asarray(mask),
                   kv=jnp.asarray(kv))
    got = nn.mha(_pt(p), torch.from_numpy(x), 4,
                 None if mask is None else torch.from_numpy(mask),
                 kv=torch.from_numpy(kv))
    assert tuple(got.shape) == (2, 5, 32)
    _close(got, want)
    _close(nn.mha(_pt(p), torch.from_numpy(x), 4),
           jnn.mha(p, jnp.asarray(x), 4))


def test_ffn():
    p = jnn.ffn_init(jax.random.PRNGKey(6), 32, 64)
    x = _x(2, 5, 32)
    _close(nn.ffn(_pt(p), torch.from_numpy(x)), jnn.ffn(p, jnp.asarray(x)))


def test_dec_ffn_norm_over_hidden_and_no_w2_bias():
    p = jnn.dec_ffn_init(jax.random.PRNGKey(7), 32, 64)
    assert "b" not in p["w2"] and p["norm"]["g"].shape == (64,)
    x = _x(2, 5, 32)
    _close(nn.dec_ffn(_pt(p), torch.from_numpy(x)),
           jnn.dec_ffn(p, jnp.asarray(x)))


def test_init_shapes_match_reference():
    g = torch.Generator().manual_seed(0)
    pairs = [
        (nn.sanm_attention_init(g, 48, 32, 4, 11),
         jnn.sanm_attention_init(jax.random.PRNGKey(0), 48, 32, 4, 11)),
        (nn.cross_attention_init(g, 32, 32, 32, 2),
         jnn.cross_attention_init(jax.random.PRNGKey(0), 32, 32, 32, 2)),
        (nn.dec_ffn_init(g, 32, 64), jnn.dec_ffn_init(jax.random.PRNGKey(0), 32, 64)),
        (nn.conv1d_init(g, 16, 24, 3, groups=8),
         jnn.conv1d_init(jax.random.PRNGKey(0), 16, 24, 3, groups=8)),
    ]
    for ours, ref in pairs:
        a = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: tuple(t.shape), ours,
                         is_leaf=lambda t: isinstance(t, torch.Tensor)))
        b = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: tuple(t.shape), _np_tree(ref)))
        assert a == b
