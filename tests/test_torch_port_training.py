"""Fine-tuning in the port against the reference, on the CPU at tiny
geometry: K1 under autograd (`FsmnDepthwiseFn`: dx and dw by K1's backward
kernel `fsmn_conv_dw.fsmn_conv_bwd`, its plain version here) against
`jax.grad` of the
reference's `nn.fsmn_block`; `paraformer_loss` and its gradients against
`jax.value_and_grad`; three AdamW steps against `optax.adamw`; checkpoint
save / restore / resume, the serving export in both directions, and the
`tools/finetune.py` CLI.

Tolerances: the FSMN gradients 1e-5 (f32, another order of the same sums);
the loss rtol 1e-5, its gradients rtol 1e-4 with atol 1e-6·max|g| per leaf
(f32 reductions in other orders); parameters after three AdamW steps atol
1e-2·lr (measured: 1.2e-3·lr): Adam divides by √v, so a gradient that
differs by 1e-6 relative moves a parameter by about lr·1e-6. Where the
gradient itself is rounding noise (the attention key biases, whose exact
gradient is 0), Adam's step is lr times the noise's sign in both packages,
so there the bound is what three steps can move a parameter, 6·lr; such
elements are 266 of the 10241 (at most 5 % allowed)."""
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.models import paraformer as rpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.ops import nn as rnn  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import trainstep as rts  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import (  # noqa: E402
    params_from_numpy, tree_map)
from toolbox_for_asr_and_tts_tpu_torch.ops import nn as pnn  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import (  # noqa: E402
    fsmn_conv as k1, fsmn_conv_dw as kdw)
from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as pts  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import train_ckpt as tc  # noqa: E402

# the reference test's geometry, and the CLI's --tiny one
CFG = pf.ParaformerConfig(input_dim=24, d_model=16, n_heads=2, ffn_dim=32,
                          encoder_layers=2, decoder_layers=1, vocab_size=32)
TINY = pf.ParaformerConfig(d_model=32, n_heads=2, ffn_dim=64,
                           encoder_layers=2, decoder_layers=1, vocab_size=64)
LR = 1e-4


def _ref_cfg(cfg):
    import dataclasses
    return rpf.ParaformerConfig(**dataclasses.asdict(cfg))


def _ref_params(cfg, seed=0):
    return rpf.init_params(jax.random.PRNGKey(seed), _ref_cfg(cfg))


def _port_params(ref):
    return params_from_numpy(jax.device_get(ref), device="cpu")


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({
            "feats": rng.standard_normal((2, 12, cfg.input_dim)
                                         ).astype(np.float32),
            "feat_lens": np.array([12, 9], np.int32),
            "targets": rng.integers(3, cfg.vocab_size, (2, 5)
                                    ).astype(np.int32),
            "target_lens": np.array([5, 3], np.int32)})
    return out


# ------------------------------------------------------ K1 under autograd
FSMN_CASES = {"k11": (11, (5, 5)), "k20": (20, (19, 0)), "k12": (12, (9, 2))}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case,layout", [("k11", "contiguous"),
                                         ("k11", "v_view"),
                                         ("k20", "contiguous"),
                                         ("k20", "v_view"),
                                         ("k12", "contiguous"),
                                         ("k12", "v_view")])
def test_fsmn_function_matches_jax_grad(case, layout, masked, monkeypatch):
    """dx and dw of `nn.fsmn_block` through `FsmnDepthwiseFn` (one call of
    `fsmn_conv_bwd_plain` per backward on the CPU) equal `jax.grad` of the
    reference's `fsmn_block` (its XLA conv off the TPU); on a V view the
    gradient lands in the V third of qkv's gradient."""
    k, pad = FSMN_CASES[case]
    rng = np.random.default_rng(3)
    b, t, d = 3, 17, 24
    qkv = rng.standard_normal((b, t, 3 * d)).astype(np.float32)
    x = qkv[..., 2 * d:] if layout == "v_view" else qkv[..., :d].copy()
    w = (rng.standard_normal((d, 1, k)) * 0.3).astype(np.float32)
    cot = rng.standard_normal((b, t, d)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(t)[None] < np.array([t, 11, 4])[:, None]
                ).astype(np.float32)

    def ref(xx, ww):
        m = None if mask is None else jnp.asarray(mask)
        return jnp.sum(rnn.fsmn_block({"w": ww}, xx, pad, m) * cot)
    gx, gw = jax.grad(ref, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    calls = []
    plain = kdw.fsmn_conv_bwd_plain
    monkeypatch.setattr(kdw, "fsmn_conv_bwd_plain",
                        lambda *a: calls.append(a[5:]) or plain(*a))
    wt = torch.tensor(w, requires_grad=True)
    mt = None if mask is None else torch.from_numpy(mask)
    if layout == "v_view":
        src = torch.tensor(qkv, requires_grad=True)
        xt = src[..., 2 * d:]
    else:
        src = xt = torch.tensor(x, requires_grad=True)
    y = pnn.fsmn_block({"w": wt}, xt, pad, mt)
    assert type(y.grad_fn).__name__ == "FsmnDepthwiseFnBackward"
    (y * torch.from_numpy(cot)).sum().backward()
    assert [c[1:] for c in calls] == [(True, True)]
    dx = src.grad[..., 2 * d:] if layout == "v_view" else src.grad
    if layout == "v_view":
        assert not src.grad[..., :2 * d].any()
    for got, want in ((dx, gx), (wt.grad, gw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("wants", [(True, True), (True, False),
                                   (False, True)])
def test_fsmn_backward_returns_only_the_wanted_gradients(wants):
    """Each `needs_input_grad` combination: the Function's backward asks
    `fsmn_conv_bwd` for just those gradients, which gives None for the
    other, and the gradients it gives equal autograd of the plain
    version's."""
    rng = np.random.default_rng(8)
    x0 = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32))
    w0 = torch.from_numpy((rng.standard_normal((16, 1, 11)) * 0.3)
                          .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32))
    mask = torch.ones(2, 9)
    mask[0, 7:] = 0
    x = x0.clone().requires_grad_(wants[0])
    w = w0.clone().requires_grad_(wants[1])
    (k1.fsmn_depthwise(x, w, 4, 6, mask) * g).sum().backward()
    assert (x.grad is not None, w.grad is not None) == wants
    dx, dw = kdw.fsmn_conv_bwd(x0, g, w0, 4, 6, mask, *wants)
    assert (dx is not None, dw is not None) == wants
    xp = x0.clone().requires_grad_(True)
    wp = w0.clone().requires_grad_(True)
    (k1.fsmn_depthwise_plain(xp, wp, 4, 6, mask) * g).sum().backward()
    for got, direct, want in ((x.grad, dx, xp.grad), (w.grad, dw, wp.grad)):
        if want is not None and got is not None:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(direct, got, rtol=0, atol=0)
    assert kdw.fsmn_conv_bwd(x0, g, w0, 4, 6, mask, False, False) == (None,
                                                                      None)


def _refused(what):
    """The arguments of `fsmn_conv_bwd` with one refused, and the error."""
    x = torch.zeros(2, 5, 8)
    g = torch.zeros(2, 5, 8)
    w = torch.zeros(8, 1, 3)
    args = dict(x=x, g=g, w=w, pad_l=1, pad_r=1, mask=torch.ones(2, 5))
    change = {
        "channel_stride": dict(x=torch.zeros(2, 8, 5).transpose(1, 2)),
        "dtype": dict(x=x.double(), g=g.double()),
        "g_dtype": dict(g=g.bfloat16()),
        "pads": dict(pad_l=2, pad_r=1),
        "negative_pad": dict(pad_l=-1, pad_r=3),
        "taps": dict(w=torch.zeros(8, 1, 129), pad_l=64, pad_r=64),
        "mask_shape": dict(mask=torch.ones(2, 4)),
        "mask_dtype": dict(mask=torch.ones(2, 5, dtype=torch.float64)),
        "mask_device": dict(mask=torch.ones(2, 5, device="meta")),
        "device": dict(x=x.to("meta"), g=g.to("meta"), w=w.to("meta"),
                       mask=None),
    }[what]
    return dict(args, **change), (TypeError if "dtype" in what
                                  and "mask" not in what else ValueError)


@pytest.mark.parametrize("what", ["channel_stride", "dtype", "g_dtype",
                                  "pads", "negative_pad", "taps",
                                  "mask_shape", "mask_dtype", "mask_device",
                                  "device"])
def test_fsmn_conv_bwd_refuses(what):
    """The wrapper raises on what the kernel does not take, on the CPU as
    on the card: a channel stride other than 1, a dtype other than f32 /
    bf16 (or g's differing from x's), pads that do not preserve the length,
    K > 128, a mask of another shape, dtype or device, and a device other
    than cpu or cuda."""
    args, err = _refused(what)
    with pytest.raises(err):
        kdw.fsmn_conv_bwd(**args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fsmn_function_matches_autograd_of_the_plain_version(dtype):
    """The Function's backward (`fsmn_conv_bwd`: dx as K1 with reversed
    taps, dw) against autograd through `fsmn_depthwise_plain` itself, whose taps are
    rounded to x's dtype: dw goes back through that cast (f32 exact up to
    the sums' order, bf16 within its rounding)."""
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32))
    w0 = torch.from_numpy((rng.standard_normal((16, 1, 11)) * 0.3)
                          .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 9, 16)).astype(np.float32))
    mask = torch.ones(2, 9)
    mask[1, 6:] = 0
    grads = []
    for fn in (k1.fsmn_depthwise, k1.fsmn_depthwise_plain):
        x = x0.to(dtype).requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        y = fn(x, w, 5, 5, mask)
        (y.float() * g).sum().backward()
        grads.append((x.grad.float(), w.grad))
        assert w.grad.dtype == torch.float32 and x.grad.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=tol,
                                   atol=tol * want.abs().max().item())


def test_fsmn_without_grad_bypasses_the_function():
    """Grad mode off, or inputs that need no grad: the call is the one the
    serving paths make (no Function, no graph), with the same values."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 7, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 1, 11)).astype(np.float32))
    want = k1.fsmn_depthwise_plain(x, w, 5, 5)
    with torch.inference_mode():
        got = k1.fsmn_depthwise(x, w, 5, 5)
    assert got.grad_fn is None and torch.equal(got, want)
    assert k1.fsmn_depthwise(x, w, 5, 5).grad_fn is None
    wg = w.clone().requires_grad_(True)
    with torch.no_grad():
        assert k1.fsmn_depthwise(x, wg, 5, 5).grad_fn is None
    y = k1.fsmn_depthwise(x, wg, 5, 5)
    assert y.grad_fn is not None and torch.equal(y.detach(), want)


def test_fsmn_gradient_of_an_expanded_incoming_gradient():
    """`y.sum()` hands the backward an expanded gradient (stride 0 on
    every axis): it is made contiguous before K1 reads it."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 7, 8)).astype(np.float32)
                         ).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((8, 1, 12)).astype(np.float32)
                         ).requires_grad_(True)
    k1.fsmn_depthwise(x, w, 9, 2).sum().backward()
    x2 = x.detach().clone().requires_grad_(True)
    w2 = w.detach().clone().requires_grad_(True)
    k1.fsmn_depthwise_plain(x2, w2, 9, 2).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-5, atol=1e-5)


def test_fsmn_conv_dw_plain_is_the_weight_gradient():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((3, 10, 4)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 10, 4)).astype(np.float32))
    mask = (torch.arange(10)[None] < torch.tensor([10, 6, 1])[:, None]).float()
    want = np.zeros((4, 1, 20))
    xm = (x * mask[..., None]).double().numpy()
    gm = (g * mask[..., None]).double().numpy()
    for j in range(20):
        for t in range(10):
            s = t + j - 19
            if 0 <= s < 10:
                want[:, 0, j] += (gm[:, t] * xm[:, s]).sum(0)
    got = kdw.fsmn_conv_dw(x, g, 20, 19, mask)
    assert got.shape == (4, 1, 20) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        kdw.fsmn_conv_dw(x, g, 20, 20, mask)
    with pytest.raises(ValueError):
        kdw.fsmn_conv_dw(x, g.transpose(1, 2), 20, 19)


# ----------------------------------------------------------------- loss
def _ref_loss_and_grads(cfg, ref, batch):
    def loss_fn(p):
        return rts.paraformer_loss(
            p, jnp.asarray(batch["feats"]), jnp.asarray(batch["feat_lens"]),
            jnp.asarray(batch["targets"]), jnp.asarray(batch["target_lens"]),
            _ref_cfg(cfg))
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(ref)
    return float(loss), {k: float(v) for k, v in aux.items()}, grads


@pytest.mark.parametrize("which", ["ref_test", "cli_tiny"])
def test_loss_and_gradients_match_reference(which):
    cfg = CFG if which == "ref_test" else TINY
    ref = _ref_params(cfg)
    batch = _batches(cfg, 1, seed=1)[0]
    r_loss, r_aux, r_grads = _ref_loss_and_grads(cfg, ref, batch)

    params = _port_params(ref)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux = pts.paraformer_loss(params, b["feats"], b["feat_lens"],
                                    b["targets"], b["target_lens"], cfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), r_loss, rtol=1e-5)
    for k in ("ce", "quantity"):
        np.testing.assert_allclose(aux[k].item(), r_aux[k], rtol=1e-5)
    want = [np.asarray(g) for g in jax.tree.leaves(r_grads)]
    assert len(want) == len(leaves)
    for p, g in zip(leaves, want):
        assert p.grad is not None and p.grad.shape == g.shape
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(g).max(), 1e-30))


def test_cif_gradient_follows_the_reference_at_ties():
    """α that put cumulative sums exactly on integers: the clamp of the
    overlap weights at 0 takes jnp.maximum's rule (half the gradient at a
    tie); clamp_min's (all of it) gave 3.6 of difference here."""
    rng = np.random.default_rng(0)
    enc = rng.standard_normal((2, 6, 4)).astype(np.float32)
    al = np.array([[0.5, 0.5, 0.25, 0.75, 0.5, 0.5],
                   [0.25, 0.25, 0.5, 1.0, 0.0, 0.0]], np.float32)
    cot = rng.standard_normal((2, 5, 4)).astype(np.float32)

    def ref(a, e):
        return jnp.sum(rpf.cif(e, a, 5, tail_threshold=0.0)[0] * cot)
    ga, ge = jax.grad(ref, argnums=(0, 1))(jnp.asarray(al), jnp.asarray(enc))
    a = torch.tensor(al, requires_grad=True)
    e = torch.tensor(enc, requires_grad=True)
    (pf.cif(e, a, 5, tail_threshold=0.0)[0] * torch.from_numpy(cot)
     ).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), atol=1e-6)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), atol=1e-6)


# ------------------------------------------------------------ AdamW steps
def test_adamw_defaults_are_optax_defaults():
    opt = pts.adamw()([torch.zeros(2, requires_grad=True)])
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-4, (0.9, 0.999), 1e-8, 1e-4)


def test_three_adamw_steps_match_optax():
    ref = _ref_params(CFG)
    batches = _batches(CFG, 3, seed=2)
    init_opt, step = rts.make_train_step(_ref_cfg(CFG))
    p_ref, o_ref = ref, init_opt(ref)
    jit_step = jax.jit(step)
    r_losses = []
    for b in batches:
        p_ref, o_ref, m = jit_step(p_ref, o_ref, {k: jnp.asarray(v)
                                                  for k, v in b.items()})
        r_losses.append(float(m["loss"]))

    params = _port_params(ref)
    init0 = [p.clone() for p in _leaves(params)]
    p_init, p_step = pts.make_train_step(CFG, device="cpu")
    opt = p_init(params)
    losses = []
    for b in batches:
        params, opt, m = p_step(params, opt, b)
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)
    # the elements whose gradient is rounding noise (below 1e-6 of their
    # leaf's largest): the key biases, whose exact gradient is 0 (softmax
    # ignores a shift shared by a query's scores), and exact zeros
    _, _, g0 = _ref_loss_and_grads(CFG, ref, batches[0])
    atol, n_noise, n = 1e-2 * LR, 0, 0
    for got, want, before, g in zip(_leaves(params), jax.tree.leaves(p_ref),
                                    init0, jax.tree.leaves(g0)):
        g = np.abs(np.asarray(g))
        noise = g <= 1e-6 * g.max()
        d = np.abs(got.detach().numpy() - np.asarray(want))
        assert d[~noise].max(initial=0.0) <= atol
        assert d[noise].max(initial=0.0) <= 6 * LR
        assert (got.detach() - before).abs().max().item() > atol
        n_noise, n = n_noise + noise.sum(), n + g.size
    assert n_noise <= 0.05 * n


def test_train_step_updates_the_tree_in_place():
    """The step keeps the tree's storages (a Recognizer's programs bind
    them) and its leaves require grad."""
    params = _port_params(_ref_params(CFG))
    ptrs = [p.data_ptr() for p in _leaves(params)]
    init_opt, step = pts.make_train_step(CFG, device="cpu")
    opt = init_opt(params)
    out, opt2, m = step(params, opt, _batches(CFG, 1)[0])
    assert out is params and opt2 is opt
    assert [p.data_ptr() for p in _leaves(params)] == ptrs
    assert all(p.requires_grad for p in _leaves(params))
    assert set(m) == {"loss", "ce", "quantity"}
    with pytest.raises(ValueError, match="parameter on cpu"):
        pts.make_train_step(CFG, device="meta")[0](params)


# ------------------------------------------------------ checkpoint/resume
def _state(cfg=CFG):
    params = _port_params(_ref_params(cfg))
    init_opt, step = pts.make_train_step(cfg, device="cpu")
    return params, init_opt(params), step, init_opt


def _zeros_like(params, init_opt):
    tpl = tree_map(torch.zeros_like, params)
    return tpl, init_opt(tpl)


def _opt_tensors(opt):
    return [v for st in opt.state_dict()["state"].values()
            for v in st.values()]


def test_save_restore_roundtrip(tmp_path):
    params, opt, step, init_opt = _state()
    params, opt, _ = step(params, opt, _batches(CFG, 1)[0])
    d = str(tmp_path / "ckpts")
    tc.save_train_state(d, 7, params, opt)
    tc.save_train_state(d, 30, params, opt)
    assert tc.latest_step(d) == 30
    tpl_p, tpl_o = _zeros_like(params, init_opt)
    got = tc.restore_train_state(d, tpl_p, tpl_o, device="cpu")
    step_n, p2, o2 = got
    assert step_n == 30 and p2 is tpl_p and o2 is tpl_o
    for a, b in zip(_leaves(params), _leaves(p2)):
        assert torch.equal(a, b)
    a_t, b_t = _opt_tensors(opt), _opt_tensors(o2)
    assert len(a_t) == len(b_t) > 0
    for a, b in zip(a_t, b_t):
        assert torch.equal(a, b)


def test_restore_none_when_empty(tmp_path):
    params, opt, _, _ = _state()
    assert tc.restore_train_state(str(tmp_path / "nope"), params, opt,
                                  device="cpu") is None
    assert tc.latest_step(str(tmp_path / "nope")) is None


def test_training_resumes_equivalently(tmp_path):
    """save at step k, resume, continue → the same params as uninterrupted
    (bit for bit on the CPU)."""
    batches = _batches(CFG, 4, seed=3)
    p, o, step, init_opt = _state()
    for b in batches:
        p, o, _ = step(p, o, b)
    d = str(tmp_path / "ck")
    p2, o2, _, _ = _state()
    for b in batches[:2]:
        p2, o2, _ = step(p2, o2, b)
    tc.save_train_state(d, 2, p2, o2)
    tpl_p, tpl_o = _zeros_like(p2, init_opt)
    _, p3, o3 = tc.restore_train_state(d, tpl_p, tpl_o, device="cpu")
    for b in batches[2:]:
        p3, o3, _ = step(p3, o3, b)
    for a, b in zip(_leaves(p), _leaves(p3)):
        assert torch.equal(a, b)


def test_latest_step_skips_a_half_written_step(tmp_path):
    params, opt, _, init_opt = _state()
    d = tmp_path / "ck"
    tc.save_train_state(str(d), 3, params, opt)
    (d / "9").mkdir()
    torch.save({}, str(d / "9" / tc.PARAMS_FILE))     # opt_state missing
    (d / ".12.tmpdir").mkdir()                         # an unfinished save
    assert tc.latest_step(str(d)) == 3
    tpl_p, tpl_o = _zeros_like(params, init_opt)
    assert tc.restore_train_state(str(d), tpl_p, tpl_o, device="cpu")[0] == 3
    # a save of an existing step replaces it whole
    with torch.no_grad():
        _leaves(params)[0].add_(1.0)
    tc.save_train_state(str(d), 3, params, opt)
    assert sorted(os.listdir(d / "3")) == [tc.OPT_FILE, tc.PARAMS_FILE]
    assert not [n for n in os.listdir(d) if n.startswith(".3.")]
    tc.restore_train_state(str(d), tpl_p, tpl_o, device="cpu")
    assert torch.equal(_leaves(tpl_p)[0], _leaves(params)[0])


def test_restore_refuses_another_geometry(tmp_path):
    params, opt, _, _ = _state()
    tc.save_train_state(str(tmp_path), 1, params, opt)
    other, other_opt, _, _ = _state(pf.ParaformerConfig(
        input_dim=24, d_model=16, n_heads=2, ffn_dim=48, encoder_layers=2,
        decoder_layers=1, vocab_size=32))
    with pytest.raises(ValueError, match="shape mismatch"):
        tc.restore_train_state(str(tmp_path), other, other_opt,
                               device="cpu")


# ---------------------------------------------------------------- export
def test_export_params_npz_loads_into_serving(tmp_path):
    from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ck
    params, opt, step, _ = _state()
    params, _, _ = step(params, opt, _batches(CFG, 1)[0])
    out = str(tmp_path / "torch_params.npz")
    assert tc.export_params_npz(params, out) == out
    loaded = ck.load_converted(out, tree_map(torch.zeros_like, params))
    for a, b in zip(_leaves(params), _leaves(loaded)):
        np.testing.assert_array_equal(np.asarray(b), a.detach().numpy())


def test_export_is_the_reference_format_both_ways(tmp_path):
    """The reference's export loads through the port's `load_converted`,
    and the port's through the reference's."""
    from toolbox_for_asr_and_tts_tpu.runtime import checkpoints as rck
    from toolbox_for_asr_and_tts_tpu.runtime import train_ckpt as rtc
    from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ck
    ref = _ref_params(CFG, seed=1)
    r_out = str(tmp_path / "jax_params.npz")
    rtc.export_params_npz(ref, r_out)
    port = _port_params(_ref_params(CFG, seed=2))
    p_out = str(tmp_path / "torch_params.npz")
    tc.export_params_npz(port, p_out)
    got = ck.load_converted(r_out, tree_map(torch.zeros_like, port))
    for a, b in zip(jax.tree.leaves(ref), _leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    got_r = rck.load_converted(p_out, jax.tree.map(jnp.zeros_like, ref))
    for a, b in zip(_leaves(port), jax.tree.leaves(got_r)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy())


# ------------------------------------------------------------------- CLI
def _manifest(tmp_path, tokenizer):
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import write_wav
    rng = np.random.default_rng(8)
    rows = []
    for i, secs in enumerate((1.3, 0.9)):
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, (0.2 * rng.standard_normal(int(16000 * secs))
                         ).astype(np.float32), 16000)
        ids = rng.integers(4, len(tokenizer.tokens), 6)
        rows.append({"wav": path,
                     "text": "".join(tokenizer.tokens[j] for j in ids)})
    path = str(tmp_path / "data.jsonl")
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    return path


def test_finetune_cli_smoke_resume_and_export(tmp_path):
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    tok = CharTokenizer.dummy(TINY.vocab_size)
    manifest = _manifest(tmp_path, tok)
    d = str(tmp_path / "run1")
    mount = tmp_path / "mount"          # made by the export
    out = str(mount / "torch_params.npz")
    base = ["--manifest", manifest, "--ckpt-dir", d, "--batch", "2",
            "--tiny", "--k-max", "8", "--device", "cpu"]
    first = finetune.main(base + ["--steps", "4", "--save-every", "2",
                                  "--export", out])
    assert tc.latest_step(d) == 4 and sorted(os.listdir(d)) == ["2", "4"]
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert all(np.isfinite(first["losses"]))
    # resume: continues from step 4 for 2 more steps
    second = finetune.main(base + ["--steps", "6"])
    assert second["start"] == 4 and len(second["losses"]) == 2
    assert tc.latest_step(d) == 6
    # the export serves: a mount of it gives the ids of the tuned tree
    with open(mount / "config.json", "w") as f:
        json.dump({"encoder_conf": {"output_size": 32, "attention_heads": 2,
                                    "linear_units": 64, "num_blocks": 2},
                   "decoder_conf": {"num_blocks": 1}}, f)
    with open(mount / "tokens.json", "w", encoding="utf-8") as f:
        json.dump(tok.tokens, f, ensure_ascii=False)
    served = Recognizer.from_model_dir(str(mount), device="cpu")
    assert served.cfg == first["cfg"]
    tuned = Recognizer(first["params"], first["cfg"], first["tokenizer"],
                       device="cpu")
    wav = (0.2 * np.random.default_rng(9).standard_normal(24000)
           ).astype(np.float32)
    a, b = served.transcribe([wav]), tuned.transcribe([wav])
    assert a[0].token_ids == b[0].token_ids


def test_finetune_cli_synthetic_batches_and_nonfinite_loss(tmp_path,
                                                          monkeypatch):
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    res = finetune.main(["--ckpt-dir", str(tmp_path / "a"), "--steps", "1",
                         "--batch", "2", "--tiny", "--k-max", "8",
                         "--device", "cpu"])
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"][0])

    def nan_loss(*args, **kw):
        loss, aux = real(*args, **kw)
        return loss * float("nan"), aux
    real = pts.paraformer_loss
    monkeypatch.setattr(pts, "paraformer_loss", nan_loss)
    with pytest.raises(SystemExit, match="non-finite loss at step 0"):
        finetune.main(["--ckpt-dir", str(tmp_path / "b"), "--steps", "1",
                       "--batch", "2", "--tiny", "--k-max", "8",
                       "--device", "cpu"])
