"""The captured fine-tuning step (`runtime/train_graph.py::
capture_train_step`, the reference's `jax.jit(train_step,
donate_argnums=(0, 1))`) on the CPU, where it is the eager step behind the
programs' cache and keys, at the reference test's geometry
(`tests/test_finetune_ckpt.py`: d 16, 2 + 1 layers, vocab 32).

Tolerances against the reference's jitted step over 4 batches: the losses
rtol 1e-5 (`test_three_adamw_steps_match_optax`'s); the parameters atol
1e-6 + rtol 1e-6 (`test_training_resumes_equivalently`'s), except where
the first batch's gradient is rounding noise (below 1e-6 of its leaf's
largest: the attention key biases, whose exact gradient is 0), where Adam
steps by ±lr on the noise's sign in either package, so the bound is what
4 steps can move a parameter, 8·lr (at most 5 % of the elements). Against
the port's own eager step: bit for bit."""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.models import paraformer as rpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import trainstep as rts  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import (  # noqa: E402
    params_from_numpy, tree_map)
from toolbox_for_asr_and_tts_tpu_torch.ops.kernels import _build  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep as pts  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import graphs  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime import train_ckpt as tc  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime.train_graph import (  # noqa: E402
    capture_train_step)

# tests/test_finetune_ckpt.py's geometry
CFG = pf.ParaformerConfig(input_dim=24, d_model=16, n_heads=2, ffn_dim=32,
                          encoder_layers=2, decoder_layers=1, vocab_size=32)
LR = 1e-4


def _ref_cfg():
    import dataclasses
    return rpf.ParaformerConfig(**dataclasses.asdict(CFG))


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def _batches(n, t=12, seed=0):
    """tests/test_finetune_ckpt.py's batches (at T = 12), as numpy."""
    rng = np.random.default_rng(seed)
    return [{"feats": rng.standard_normal((2, t, CFG.input_dim)
                                          ).astype(np.float32),
             "feat_lens": np.array([t, t - 3], np.int32),
             "targets": rng.integers(3, 32, (2, 5)).astype(np.int32),
             "target_lens": np.array([5, 3], np.int32)} for _ in range(n)]


def _port_state():
    ref = rpf.init_params(jax.random.PRNGKey(0), _ref_cfg())
    params = params_from_numpy(jax.device_get(ref), device="cpu")
    init_opt, step = pts.make_train_step(CFG, device="cpu")
    return ref, params, init_opt(params), step


def _storages(params, opt):
    """data_ptr of every parameter and AdamW state tensor."""
    ptrs = []
    for p in _leaves(params):
        ptrs += [p.data_ptr()]
        ptrs += [opt.state[p][k].data_ptr() for k in sorted(opt.state[p])]
    return ptrs


def test_captured_step_matches_the_reference_jit():
    batches = _batches(4)
    ref, params, opt, step = _port_state()
    _, g0 = jax.jit(jax.value_and_grad(lambda p: rts.paraformer_loss(
        p, *(jnp.asarray(batches[0][k]) for k in
             ("feats", "feat_lens", "targets", "target_lens")),
        _ref_cfg()), has_aux=True))(ref)
    init_r, step_r = rts.make_train_step(_ref_cfg())
    p_ref, o_ref = ref, init_r(ref)     # donated below
    jit_step = jax.jit(step_r, donate_argnums=(0, 1))
    r_losses = []
    for b in batches:
        p_ref, o_ref, m = jit_step(p_ref, o_ref, {k: jnp.asarray(v)
                                                  for k, v in b.items()})
        r_losses.append(float(m["loss"]))

    cstep = capture_train_step(step, params, opt)
    losses = []
    for b in batches:
        out, o2, m = cstep(params, opt, b)
        assert out is params and o2 is opt
        assert set(m) == {"loss", "ce", "quantity"}
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, r_losses, rtol=1e-5)

    # the port's eager step on the same batches: the same bits
    _, eager, e_opt, e_step = _port_state()
    e_losses = []
    for b in batches:
        e_losses.append(e_step(eager, e_opt, b)[2]["loss"].item())
    assert losses == e_losses
    for a, b in zip(_leaves(params), _leaves(eager)):
        assert torch.equal(a, b)

    n_noise = n = 0
    for got, want, g in zip(_leaves(params), jax.tree.leaves(p_ref),
                            jax.tree.leaves(g0)):
        g = np.abs(np.asarray(g))
        noise = g <= 1e-6 * g.max()
        got, want = got.detach().numpy(), np.asarray(want)
        np.testing.assert_allclose(got[~noise], want[~noise], atol=1e-6,
                                   rtol=1e-6)
        assert np.abs(got[noise] - want[noise]).max(initial=0.0) <= 8 * LR
        n_noise, n = n_noise + noise.sum(), n + g.size
    assert n_noise <= 0.05 * n


def test_storages_keep_their_identity_across_steps_and_a_restore(tmp_path):
    """Parameters and AdamW's state keep their storages after steps 1, 2
    and 3, and no step leaves a gradient behind (the step's own, as inside
    the reference's jit). A restore into the step that has run copies the
    parameters into their storages and gives the optimizer the saved
    state, so the step drops its program and makes it again; the restored
    run continues bit-equal to the run that was saved."""
    batches = _batches(5, seed=4)
    _, params, opt, step = _port_state()
    cstep = capture_train_step(step, params, opt)
    params_at = [p.data_ptr() for p in _leaves(params)]
    seen = []
    for b in batches[:3]:
        cstep(params, opt, b)
        seen.append(_storages(params, opt))
        assert all(p.grad is None for p in _leaves(params))
    assert seen[0] == seen[1] == seen[2]

    d = str(tmp_path / "ck")
    tc.save_train_state(d, 3, params, opt)
    want = [p.detach().clone()
            for p in _leaves(cstep(params, opt, batches[3])[0])]
    cstep(params, opt, batches[4])                  # moves on past step 4
    state, (key,) = opt.state, list(cstep.programs)
    prog = cstep.programs._progs[key]
    got = tc.restore_train_state(d, params, opt, device="cpu")
    assert got[0] == 3 and got[1] is params and got[2] is opt
    assert opt.state is not state
    assert [p.data_ptr() for p in _leaves(params)] == params_at
    assert all(opt.state[p]["step"].item() == 3.0 for p in _leaves(params))
    cstep(params, opt, batches[3])
    assert list(cstep.programs) == [key]
    assert cstep.programs._progs[key] is not prog   # made again
    for a, b in zip(_leaves(params), want):
        assert torch.equal(a, b)
    assert cstep.programs.captures == 0 and cstep.stats()["eager"] == 0


def test_a_second_shape_makes_a_second_program():
    """One program per batch shape, as XLA compiles once per shape: a
    second T makes a second program, the same shapes reuse the first."""
    _, params, opt, step = _port_state()
    cstep = capture_train_step(step, params, opt)
    progs = cstep.programs
    assert progs.name == "train-step" and progs in graphs.owners()
    a, b = _batches(1, t=12)[0], _batches(1, t=10, seed=1)[0]
    for batch in (a, a, b, a):
        cstep(params, opt, batch)
    keys = list(progs)
    assert len(keys) == 2
    assert [dict((n, s) for n, s, _ in k)["feats"] for k in keys] == \
        [(2, 12, 24), (2, 10, 24)]
    assert [progs._progs[k].replays for k in keys] == [3, 1]
    assert progs.stats()["replays"] == 4 and progs.stats()["captures"] == 0
    # host tensors are the same shape key as numpy arrays
    cstep(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
    assert len(progs) == 2


def test_captured_step_refuses_another_tree_and_sees_a_rebinding():
    """Another tree or optimizer is refused; new optimizer state (what a
    `load_state_dict` gives) drops the programs, which bind the old."""
    _, params, opt, step = _port_state()
    cstep = capture_train_step(step, params, opt)
    _, other, other_opt, _ = _port_state()
    with pytest.raises(ValueError, match="tree and optimizer"):
        cstep(other, opt, _batches(1)[0])
    with pytest.raises(ValueError, match="tree and optimizer"):
        cstep(params, other_opt, _batches(1)[0])
    a, b = _batches(1)[0], _batches(1, t=10, seed=1)[0]
    cstep(params, opt, a)
    cstep(params, opt, b)
    progs = dict(cstep.programs._progs)
    cstep(params, opt, a)
    assert cstep.programs._progs == progs      # the same state: kept
    opt.load_state_dict(opt.state_dict())      # a new state mapping
    cstep(params, opt, a)
    assert len(cstep.programs) == 1
    assert all(p not in progs.values()
               for p in cstep.programs._progs.values())


def test_dropping_the_last_graph_drops_the_pool():
    """torch releases a graph pool that no graph uses and takes no further
    capture into it, so an owner whose last graph goes takes a fresh pool
    for its next capture; while a graph is left, the pool stays."""
    progs = graphs.Programs("cpu", "pool")
    for key in ("a", "b"):
        progs.get(key, lambda: (lambda x: x, [((1,), torch.float32)]))
        progs._progs[key].graph = object()    # as a capture leaves it
    progs._pool = pool = object()
    progs.pop("a")
    assert progs._pool is pool
    progs.pop("b")
    assert progs._pool is None and len(progs) == 0


def test_a_streams_launches_are_tallied_from_any_thread():
    """A capture's tally also takes the launches another thread makes on
    the capture stream (autograd's backward thread); this thread's own
    open block comes first, and outside any block a launch is a run."""
    import threading
    assert "fsmn_conv_dw" in graphs._COUNTERS
    seen = []

    def launch(stream):
        seen.append(_build.count_launch("fsmn_conv_dw", stream))
    with _build.tallied(stream=1234) as tally:
        for s in (1234, 99):
            t = threading.Thread(target=launch, args=(s,))
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert _build.count_launch("fsmn_conv", 99)
    assert seen == [True, False]
    assert tally == {"fsmn_conv_dw": 1, "fsmn_conv": 1}
    assert not _build.count_launch("fsmn_conv_dw", 1234)


def test_restore_refuses_another_optimizer_layout(tmp_path):
    _, params, opt, step = _port_state()
    step(params, opt, _batches(1)[0])
    tc.save_train_state(str(tmp_path), 1, params, opt)
    leaves = _leaves(params)
    half = torch.optim.AdamW([{"params": leaves[:3]},
                              {"params": leaves[3:]}])
    with pytest.raises(ValueError, match="parameter groups"):
        tc.restore_train_state(str(tmp_path), params, half, device="cpu")


def test_restore_keeps_the_optimizers_own_device_flags(tmp_path):
    """A checkpoint's numbers go into the template optimizer, whose device
    flags (foreach, capturable: how it runs on its device) stay its own,
    whether it has state yet or not."""
    _, params, opt, step = _port_state()
    batch = _batches(1)[0]
    step(params, opt, batch)
    tc.save_train_state(str(tmp_path), 1, params, opt)
    assert opt.param_groups[0]["foreach"] is None
    _, p2, _, _ = _port_state()
    o2 = torch.optim.AdamW(_leaves(p2), **dict(pts.ADAMW_DEFAULTS, lr=LR),
                           foreach=True)
    for fresh in (True, False):
        if not fresh:
            pts.make_train_step(CFG, device="cpu")[1](p2, o2, batch)
        tc.restore_train_state(str(tmp_path), p2, o2, device="cpu")
        assert o2.param_groups[0]["foreach"] is True
        for p, q in zip(_leaves(params), _leaves(p2)):
            for k in opt.state[p]:
                assert torch.equal(opt.state[p][k], o2.state[q][k])


def _one_row_manifest(tmp_path, tokenizer):
    """One utterance: every batch the CLI draws is the same rows, so a
    resumed run sees the batches of the uninterrupted one."""
    from toolbox_for_asr_and_tts_tpu_torch.utils.audio import write_wav
    rng = np.random.default_rng(8)
    path = str(tmp_path / "u0.wav")
    write_wav(path, (0.2 * rng.standard_normal(16000)).astype(np.float32),
              16000)
    ids = rng.integers(4, len(tokenizer.tokens), 6)
    manifest = str(tmp_path / "data.jsonl")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write(json.dumps({"wav": path, "text": "".join(
            tokenizer.tokens[j] for j in ids)}, ensure_ascii=False) + "\n")
    return manifest


def test_finetune_resume_equals_the_uninterrupted_run(tmp_path):
    from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer
    from toolbox_for_asr_and_tts_tpu_torch.tools import finetune
    manifest = _one_row_manifest(tmp_path, CharTokenizer.dummy(64))
    base = ["--manifest", manifest, "--batch", "2", "--tiny", "--k-max", "8",
            "--device", "cpu", "--save-every", "2"]
    whole = finetune.main(base + ["--ckpt-dir", str(tmp_path / "a"),
                                  "--steps", "4"])
    assert whole["train_graphs"]["owner"] == "train-step"
    assert whole["train_graphs"]["programs"] == 1
    assert whole["train_graphs"]["replays"] == 4
    assert whole["train_graphs"]["eager"] == 0      # the card's first steps
    d = str(tmp_path / "b")
    finetune.main(base + ["--ckpt-dir", d, "--steps", "2"])
    resumed = finetune.main(base + ["--ckpt-dir", d, "--steps", "4"])
    assert resumed["start"] == 2 and len(resumed["losses"]) == 2
    assert resumed["losses"] == whole["losses"][2:]
    for a, b in zip(_leaves(whole["params"]), _leaves(resumed["params"])):
        assert torch.equal(a, b)
