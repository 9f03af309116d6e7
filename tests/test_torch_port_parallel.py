"""The port's multi-card training and long-audio layer against the
reference's, on CPU positions: the sharding rules (`parallel/sharding.py`),
the dp + tp train step and `remat` (`parallel/trainstep.py`), the
sequence-parallel encoder (`parallel/seqparallel.py`) and the GPipe
encoder (`parallel/pipeline.py`). The reference runs on its 8 virtual CPU
devices, with the same trees."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from toolbox_for_asr_and_tts_tpu.models import ct_transformer as jct  # noqa: E402
from toolbox_for_asr_and_tts_tpu.models import paraformer as jpf  # noqa: E402
from toolbox_for_asr_and_tts_tpu.ops import nn as jnn  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import pipeline as jpipe  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import seqparallel as jseq  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import sharding as jsh  # noqa: E402
from toolbox_for_asr_and_tts_tpu.parallel import trainstep as jts  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import (  # noqa: E402
    params_from_numpy, tree_map)
from toolbox_for_asr_and_tts_tpu_torch.ops import nn  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import pipeline  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import seqparallel  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import sharding  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.runtime.mesh import Sharded  # noqa: E402

CPU8 = [torch.device("cpu")] * 8
LLM_TINY = dict(input_dim=32, d_model=16, n_heads=2, ffn_dim=32,
                encoder_layers=2, decoder_layers=1, vocab_size=32)


def _tree(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


# ------------------------------------------------------------- the rules
def test_spec_rules():
    """Mirror of the reference's `test_spec_rules`."""
    assert sharding.spec_for_path("encoder.layers.0.ffn.w1.w", 2) \
        == (None, "model")
    assert sharding.spec_for_path("encoder.layers.0.ffn.w2.w", 2) \
        == ("model", None)
    assert sharding.spec_for_path("encoder.layers.3.attn.qkv.w", 2) \
        == (None, "model")
    assert sharding.spec_for_path("decoder.out.w", 2) == (None, "model")
    assert sharding.spec_for_path("encoder.layers.0.norm1.g", 1) == ()


@pytest.mark.parametrize("family", ["paraformer", "ct_transformer"])
def test_spec_for_path_equals_the_reference_on_every_path(family):
    """Every flat path of a full-width reference tree (Paraformer-large;
    the CT-Transformer, whose `embed.table` is vocabulary-parallel) gets
    the reference's spec."""
    if family == "paraformer":
        cfg = jpf.ParaformerConfig(encoder_layers=2, decoder_layers=1)
        tree = jax.eval_shape(lambda: jpf.init_params(jax.random.PRNGKey(0),
                                                      cfg))
    else:
        tree = jax.eval_shape(lambda: jct.init_params(
            jax.random.PRNGKey(0), jct.CTTransformerConfig()))
    paths = dict(jsh._flat_paths(tree))
    specs = {p: sharding.spec_for_path(p, len(a.shape))
             for p, a in paths.items()}
    for p, a in paths.items():
        assert specs[p] == tuple(jsh.spec_for_path(p, len(a.shape))), p
    assert any(s for s in specs.values())   # some leaves split
    if family == "ct_transformer":
        assert [p for p, s in specs.items() if s == ("model", None)
                and p.endswith("embed.table")]


def test_make_2d_mesh_matches_and_raises():
    for n, mp in [(8, 2), (8, 1), (6, 4), (4, 2)]:
        ours = sharding.make_2d_mesh(n, mp, devices=CPU8[:n])
        assert ours.shape == dict(jsh.make_2d_mesh(n, mp).shape), (n, mp)
    with pytest.raises(ValueError, match="requested 8 devices but only 1"):
        sharding.make_2d_mesh(8, 2, device="cpu")
    with pytest.raises(ValueError, match="3 devices given for 4 positions"):
        sharding.make_2d_mesh(4, 2, devices=CPU8[:3])


@pytest.fixture(scope="module")
def llm_params():
    jparams = jpf.init_params(jax.random.PRNGKey(1),
                              jpf.ParaformerConfig(**LLM_TINY))
    return jparams, _tree(jparams)


def test_param_shardings_cover_tree(llm_params):
    """Mirror of the reference's `test_param_shardings_cover_tree`, and
    each position's piece has the shape of the reference's shard."""
    jparams, params = llm_params
    jmesh = jsh.make_2d_mesh(8, model_parallel=2)
    mesh = sharding.make_2d_mesh(8, 2, devices=CPU8)
    sh = sharding.param_shardings(params, mesh)
    flat_s = _leaves(sh)
    want = jax.tree.leaves(jsh.param_shardings(jparams, jmesh),
                           is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(flat_s) == len(_leaves(params)) == len(want)
    assert [s.spec for s in flat_s] == [tuple(w.spec) for w in want]
    placed = sharding.shard_params(params, mesh)
    jplaced = jsh.shard_params(jparams, jmesh)
    for got, ref, whole in zip(_leaves(placed), jax.tree.leaves(jplaced),
                               _leaves(params)):
        assert [tuple(t.shape) for t in got.shards] == \
            [tuple(s.data.shape) for s in ref.addressable_shards]
        assert torch.equal(got.gather(), whole)
        # every position holds its own tensor, none the input's storage
        ptrs = {t.untyped_storage().data_ptr() for t in got.shards}
        assert len(ptrs) == 8
        assert whole.untyped_storage().data_ptr() not in ptrs


def test_tp_products_match_the_plain_ones():
    """A column split off the q | k | v boundaries, a row split and a
    vocabulary-split table give the plain product's values."""
    g = torch.Generator().manual_seed(0)
    lin = nn.linear_init(g, 16, 48)
    table = nn.embedding_init(g, 10, 4)
    x = torch.randn(2, 5, 16, generator=g)
    ids = torch.tensor([[0, 3, 9, 5], [4, 5, 6, 1]])
    mesh = sharding.make_2d_mesh(2, 2, devices=CPU8[:2])
    col = sharding.TPLinear(list(lin["w"].chunk(2, 1)),
                            list(lin["b"].chunk(2)), column=True)
    torch.testing.assert_close(nn.linear(col, x), nn.linear(lin, x))
    row_lin = {"w": lin["w"][:, :16].T.contiguous(), "b": lin["b"][:16]}
    row = sharding.TPLinear(list(row_lin["w"].chunk(2, 0)), row_lin["b"],
                            column=False)
    torch.testing.assert_close(nn.linear(row, x), nn.linear(row_lin, x))
    placed = sharding.shard_params({"embed": table}, mesh)
    local = sharding.local_tree(placed, 0)
    assert isinstance(local["embed"], sharding.TPEmbedding)
    torch.testing.assert_close(nn.embedding(local["embed"], ids),
                               nn.embedding(table, ids), rtol=0, atol=0)


# ------------------------------------------------------ the dp + tp step
def _batch(rng, n=8, t=12, k=6, uneven=False):
    tl = (rng.integers(1, k + 1, n) if uneven
          else np.full((n,), k)).astype(np.int32)
    return {"feats": rng.standard_normal((n, t, 32)).astype(np.float32),
            "feat_lens": np.full((n,), t, np.int32),
            "targets": rng.integers(3, 32, (n, k)).astype(np.int32),
            "target_lens": tl}


@pytest.mark.parametrize("uneven", [False, True], ids=["even", "uneven"])
def test_sharded_train_step_matches_local(llm_params, uneven):
    """Mirror of the reference's `test_sharded_train_step_matches_local`
    (rtol 1e-4), through the port's step: the sharded loss equals the
    reference's whole-batch loss, also with shards that hold different
    token counts, where a mean of shard losses would differ; gradients
    equal the local step's (1e-5 of each leaf's largest), and the data
    replicas stay bit-equal over two steps."""
    jparams, params = llm_params
    rng = np.random.default_rng(1)
    batch = _batch(rng, uneven=uneven)
    want, _ = jts.paraformer_loss(jparams, *(jnp.asarray(batch[k]) for k in (
        "feats", "feat_lens", "targets", "target_lens")),
        jpf.ParaformerConfig(**LLM_TINY))
    cfg = pf.ParaformerConfig(**LLM_TINY)
    mesh = sharding.make_2d_mesh(8, model_parallel=2, devices=CPU8)
    sp = sharding.shard_params(params, mesh)
    init_opt, step = trainstep.make_train_step(cfg, mesh=mesh)
    opt = init_opt(sp)
    sp, opt, m = step(sp, opt, batch)
    np.testing.assert_allclose(float(m["loss"]), float(want),
                               rtol=1e-4, atol=1e-5)
    if uneven:   # the whole batch's normalization, not a mean of 4
        shard_means = np.mean([float(jts.paraformer_loss(
            jparams, *(jnp.asarray(batch[k][i * 2:(i + 1) * 2]) for k in (
                "feats", "feat_lens", "targets", "target_lens")),
            jpf.ParaformerConfig(**LLM_TINY))[0]) for i in range(4)])
        assert abs(shard_means - float(want)) > 1e-3
    local = tree_map(torch.clone, params)
    li, ls = trainstep.make_train_step(cfg, device="cpu")
    lopt = li(local)
    ls(local, lopt, batch)
    for got, ref in zip(_leaves(sp), _leaves(local)):
        g = Sharded([t.grad if t.grad is not None else torch.zeros_like(t)
                     for t in got.shards], got.sharding).gather()
        scale = max(float(ref.grad.abs().max()), 1e-30)
        assert float((g - ref.grad).abs().max()) <= 1e-5 * scale
    step(sp, opt, batch)
    for leaf in _leaves(sp):
        n = len(leaf.shards) // 4       # 4 data rows
        for d in range(1, 4):
            for a, b in zip(leaf.shards[:n], leaf.shards[d * n:(d + 1) * n]):
                assert torch.equal(a, b)
        if "model" not in leaf.sharding.spec:   # copies along model too
            assert torch.equal(leaf.shards[0], leaf.shards[1])


def test_sharded_step_refuses_a_batch_that_does_not_split(llm_params):
    _, params = llm_params
    mesh = sharding.make_2d_mesh(8, model_parallel=2, devices=CPU8)
    init_opt, step = trainstep.make_train_step(
        pf.ParaformerConfig(**LLM_TINY), mesh=mesh)
    sp = sharding.shard_params(params, mesh)
    with pytest.raises(ValueError, match="does not split over data=4"):
        step(sp, init_opt(sp), _batch(np.random.default_rng(0), n=6))


def test_train_step_with_remat_matches(llm_params):
    """Mirror of the reference's `test_train_step_with_remat_matches`, for
    the port (each encoder layer under `torch.utils.checkpoint`) and against
    the reference's remat gradients."""
    jparams, params = llm_params
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 10, 32)).astype(np.float32)
    lens = np.asarray([10, 8], np.int32)
    tgt = rng.integers(3, 32, (2, 5)).astype(np.int32)
    tlens = np.asarray([5, 4], np.int32)
    jcfg = dataclasses.replace(jpf.ParaformerConfig(**LLM_TINY), remat=True)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jts.paraformer_loss(
        p, jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(tgt),
        jnp.asarray(tlens), jcfg)[0]))(jparams)
    out = {}
    for remat in (False, True):
        p = tree_map(lambda a: a.clone().requires_grad_(True), params)
        cfg = pf.ParaformerConfig(**LLM_TINY, remat=remat)
        loss, _ = trainstep.paraformer_loss(
            p, torch.from_numpy(feats), torch.from_numpy(lens),
            torch.from_numpy(tgt), torch.from_numpy(tlens), cfg)
        loss.backward()
        out[remat] = (float(loss.detach()), [a.grad for a in _leaves(p)])
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    np.testing.assert_allclose(out[True][0], float(jl), rtol=1e-5)
    for a, b, c in zip(out[True][1], out[False][1], jax.tree.leaves(jg)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(_np(a), np.asarray(c), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------ sequence parallel
SEQ_CFG = dict(input_dim=24, d_model=16, n_heads=2, ffn_dim=32,
               encoder_layers=3, decoder_layers=1, vocab_size=32)


@pytest.fixture(scope="module")
def seq_setup():
    jcfg = jpf.ParaformerConfig(**SEQ_CFG)
    jparams = jpf.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, 64, 24)).astype(np.float32)
    lens = np.asarray([64, 41], np.int32)
    return (jsh.make_2d_mesh(8, model_parallel=1), jparams, _tree(jparams),
            feats, lens, sharding.make_2d_mesh(8, 1, devices=CPU8))


def test_seq_parallel_encode_matches_offline(seq_setup):
    """Mirror of the reference's test: against the port's plain encoder
    and the reference's sequence-parallel one (2e-4)."""
    jmesh, jparams, params, feats, lens, mesh = seq_setup
    cfg = pf.ParaformerConfig(**SEQ_CFG)
    mask = nn.length_mask(torch.from_numpy(lens), 64)
    got = seqparallel.encode_seq_parallel(params, torch.from_numpy(feats),
                                          mask, cfg, mesh)
    ref = pf.encode(params, torch.from_numpy(feats), mask, cfg)
    jgot = jax.jit(lambda p, f, m: jseq.encode_seq_parallel(
        p, f, m, jpf.ParaformerConfig(**SEQ_CFG), jmesh))(
        jparams, jnp.asarray(feats), jnn.length_mask(jnp.asarray(lens), 64))
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(got), np.asarray(jgot), atol=2e-4,
                               rtol=2e-4)


def test_seq_parallel_full_forward_matches(seq_setup):
    """Ids and counts exact against the plain forward and the
    reference's long-form forward."""
    jmesh, jparams, params, feats, lens, mesh = seq_setup
    cfg = pf.ParaformerConfig(**SEQ_CFG)
    got = seqparallel.transcribe_long_forward(
        params, torch.from_numpy(feats), torch.from_numpy(lens), 12, cfg,
        mesh)
    ref = pf.forward(params, torch.from_numpy(feats), torch.from_numpy(lens),
                     12, cfg)
    jgot = jax.jit(lambda p, f, l: jseq.transcribe_long_forward(
        p, f, l, 12, jpf.ParaformerConfig(**SEQ_CFG), jmesh))(
        jparams, jnp.asarray(feats), jnp.asarray(lens))
    for k in ("tokens", "token_count"):
        np.testing.assert_array_equal(_np(got[k]), _np(ref[k]))
        np.testing.assert_array_equal(_np(got[k]), np.asarray(jgot[k]))
    assert int(got["token_count"].sum()) > 0


def test_pad_to_blocks_keeps_padding_inert(seq_setup):
    _, _, params, feats, lens, mesh = seq_setup
    cfg = pf.ParaformerConfig(**SEQ_CFG)
    f = torch.from_numpy(feats)
    odd = torch.cat([f, f[:, :49]], dim=1)           # 113 → 120 on 8
    f_p, m_p = seqparallel.pad_to_blocks(
        odd, nn.length_mask(torch.from_numpy(lens), odd.shape[1]), 8)
    jf, jm = jseq.pad_to_blocks(jnp.asarray(odd.numpy()),
                                jnn.length_mask(jnp.asarray(lens), 113), 8)
    assert tuple(f_p.shape) == tuple(jf.shape) and f_p.shape[1] % 8 == 0
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(jm))
    got = _np(seqparallel.encode_seq_parallel(params, f_p, m_p, cfg, mesh))
    ref = _np(pf.encode(params, f, nn.length_mask(torch.from_numpy(lens), 64),
                        cfg))
    for row, n_valid in enumerate(lens):
        np.testing.assert_allclose(got[row, :n_valid], ref[row, :n_valid],
                                   atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="not divisible"):
        seqparallel.encode_seq_parallel(params, odd, m_p[:, :113], cfg, mesh)


# ------------------------------------------------------------- pipeline
PIPE_CFG = dict(input_dim=24, d_model=16, n_heads=2, ffn_dim=32,
                encoder_layers=5, decoder_layers=1, vocab_size=32)


@pytest.fixture(scope="module")
def pipe_setup():
    jcfg = jpf.ParaformerConfig(**PIPE_CFG)
    jparams = jpf.init_params(jax.random.PRNGKey(0), jcfg)
    jmesh = jsh.make_2d_mesh(8, model_parallel=2)          # data 4 × model 2
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((8, 20, 24)).astype(np.float32)
    lens = np.asarray([20, 20, 15, 20, 9, 20, 20, 12], np.int32)
    return (jparams, jmesh, _tree(jparams), feats, lens,
            sharding.make_2d_mesh(8, 2, devices=CPU8))


def test_stack_stage_params_shapes(pipe_setup):
    jparams, jmesh, params, *_ = pipe_setup
    stage = pipeline.stack_stage_params(params["encoder"]["layers"], 2)
    jstage = jpipe.stack_stage_params(jparams["encoder"]["layers"], 2)
    w = stage["ffn"]["w1"]["w"]
    assert w.shape[:2] == (2, 2)           # [S, L/S]
    assert torch.equal(w[1, 0], params["encoder"]["layers"][3]["ffn"]["w1"]["w"])
    for a, b in zip(_leaves(stage), jax.tree.leaves(jstage)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    with pytest.raises(ValueError, match="do not divide into 3 stages"):
        pipeline.stack_stage_params(params["encoder"]["layers"], 3)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipelined_forward_matches_sequential(pipe_setup, n_micro):
    """Mirror of the reference's test (2e-5): n_micro 2 splits each
    microbatch's 4 rows over the 4 data rows, n_micro 4's 2 rows do not
    split and run on the first; against the plain encoder and the
    reference's pipeline."""
    jparams, jmesh, params, feats, lens, mesh = pipe_setup
    cfg = pf.ParaformerConfig(**PIPE_CFG)
    stage = pipeline.stack_stage_params(params["encoder"]["layers"], 2)
    mask = nn.length_mask(torch.from_numpy(lens), 20)
    got = pipeline.encode_pipelined(params, stage, torch.from_numpy(feats),
                                    mask, cfg, mesh, n_micro=n_micro)
    ref = pf.encode(params, torch.from_numpy(feats), mask, cfg)
    jgot = jax.jit(lambda p, sp, f, m: jpipe.encode_pipelined(
        p, sp, f, m, jpf.ParaformerConfig(**PIPE_CFG), jmesh,
        n_micro=n_micro))(
        jparams, jpipe.stack_stage_params(jparams["encoder"]["layers"], 2),
        jnp.asarray(feats), jnn.length_mask(jnp.asarray(lens), 20))
    np.testing.assert_allclose(_np(got), _np(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(got), np.asarray(jgot), atol=2e-5,
                               rtol=2e-5)


def test_pipelined_gradients_match(pipe_setup):
    """Mirror of the reference's test (5e-4): the stage parameters'
    gradients through the pipeline equal the plain encoder's, restacked,
    and the reference pipeline's."""
    jparams, jmesh, params, feats, lens, mesh = pipe_setup
    cfg = pf.ParaformerConfig(**PIPE_CFG)
    f = torch.from_numpy(feats)
    mask = nn.length_mask(torch.from_numpy(lens), 20)
    stage = tree_map(lambda a: a.requires_grad_(True),
                     pipeline.stack_stage_params(params["encoder"]["layers"],
                                                 2))
    y = pipeline.encode_pipelined(params, stage, f, mask, cfg, mesh,
                                  n_micro=2)
    (y * y).sum().backward()
    rest = tree_map(lambda a: a.clone().requires_grad_(True),
                    params["encoder"]["layers"][1:])
    p = dict(params, encoder=dict(params["encoder"], layers=[
        params["encoder"]["layers"][0]] + rest))
    y2 = pf.encode(p, f, mask, cfg)
    (y2 * y2).sum().backward()
    g_seq = pipeline.stack_stage_params(
        [None] + tree_map(lambda a: a.grad, rest), 2)
    jmask = jnn.length_mask(jnp.asarray(lens), 20)
    jstage = jpipe.stack_stage_params(jparams["encoder"]["layers"], 2)
    jg = jax.jit(jax.grad(lambda sp: jnp.sum(jpipe.encode_pipelined(
        jparams, sp, jnp.asarray(feats), jmask,
        jpf.ParaformerConfig(**PIPE_CFG), jmesh, n_micro=2) ** 2)))(jstage)
    for a, b, c in zip(_leaves(stage), _leaves(g_seq), jax.tree.leaves(jg)):
        np.testing.assert_allclose(_np(a.grad), _np(b), atol=5e-4, rtol=5e-4)
        np.testing.assert_allclose(_np(a.grad), np.asarray(c), atol=5e-4,
                                   rtol=5e-4)


def test_pipelined_gradients_under_a_projection(pipe_setup):
    """Σ y² has no gradient before the final LayerNorm in exact arithmetic
    (a normalized row's Σ y² is fixed), so the mirror above compares
    rounding noise; under Σ y·r for a fixed random r the stage gradients
    are real and equal the plain encoder's within 1e-5 of each leaf's
    largest."""
    _, _, params, feats, lens, mesh = pipe_setup
    cfg = pf.ParaformerConfig(**PIPE_CFG)
    f = torch.from_numpy(feats)
    mask = nn.length_mask(torch.from_numpy(lens), 20)
    r = torch.randn((8, 20, 16), generator=torch.Generator().manual_seed(8))
    stage = tree_map(lambda a: a.requires_grad_(True),
                     pipeline.stack_stage_params(params["encoder"]["layers"],
                                                 2))
    (pipeline.encode_pipelined(params, stage, f, mask, cfg, mesh,
                               n_micro=2) * r).sum().backward()
    rest = tree_map(lambda a: a.clone().requires_grad_(True),
                    params["encoder"]["layers"][1:])
    p = dict(params, encoder=dict(params["encoder"], layers=[
        params["encoder"]["layers"][0]] + rest))
    (pf.encode(p, f, mask, cfg) * r).sum().backward()
    g_seq = pipeline.stack_stage_params(
        [None] + tree_map(lambda a: a.grad, rest), 2)
    for a, b in zip(_leaves(stage), _leaves(g_seq)):
        scale = float(b.abs().max())
        assert scale > 1e-3          # a real gradient, not rounding noise
        assert float((a.grad - b).abs().max()) <= 1e-5 * scale
