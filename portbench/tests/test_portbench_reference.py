"""The plain reference agrees with the port on the CPU at tiny geometry,
layer by layer: the frontend, the offline forward (encoder with K1's plain
version, CIF, decoder), the streaming step (ring frontend, chunked encoder,
CIF, incremental decode, the finalize tail), and the training loss, its
gradients and AdamW."""
import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT

from portbench import harness, weights
from portbench.reference import paraformer as ref

TINY = harness.load_family("paraformer").TINY["model"]


def _cfg(name):
    c = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                    f"{name}.json")))
    return dict(c["model"], **TINY), c["frontend"], c["online"]


@pytest.fixture(scope="module")
def model():
    m, fe, o = _cfg("paraformer-large-zh-online")
    params = weights.make_params(m, 11, "cpu")
    cmvn = weights.make_cmvn(m["input_dim"], 11, "cpu")
    return m, fe, o, params, cmvn


def test_fbank_matches_the_port():
    from toolbox_for_asr_and_tts_tpu_torch.ops import frontend as pfe
    _, fe, _ = _cfg("paraformer-large-zh-offline")
    wav = torch.from_numpy(np.stack(weights.make_audio([8000, 8000], 3,
                                                       "cpu")))
    got = ref.fbank(wav, fe, 48)
    want = pfe.fbank(wav, pfe.FrontendConfig(), t_frames=48)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_offline_matches_the_port(model):
    from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer
    from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import \
        ParaformerConfig
    m, fe, _, params, cmvn = model
    wavs = weights.make_audio([16000 * 3, 16000 * 5, 9000], 4, "cpu")
    reco = Recognizer(params, ParaformerConfig(**m),
                      CharTokenizer.dummy(m["vocab_size"]),
                      cmvn=tuple(c.numpy() for c in cmvn), device="cpu",
                      use_mesh=False)
    batch, lens = reco.bucketer.pad_batch(wavs)
    out = reco.forward_padded(batch, lens)
    rows = ref.offline_logits(params, dict(m, frontend=fe), cmvn, wavs,
                              "cpu")
    for i, (logits, csum, count) in enumerate(rows):
        assert count == int(out["token_count"][i]) > 0
        torch.testing.assert_close(logits.float(), out["logits"][i, :count],
                                   rtol=1e-4, atol=1e-4)


def test_streaming_matches_the_port(model):
    """One session through the port's fused step (ring frontend, chunked
    encoder, CIF, incremental decode) and its finalize tail, against the
    reference's tokens."""
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online \
        as po
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import \
        ParaformerConfig
    m, fe, o, params, cmvn = model
    cfg, ocfg = ParaformerConfig(**m), po.OnlineConfig()
    wav = weights.make_audio([16000 * 2 + 1234], 5, "cpu")[0]
    sess = ref.OnlineSession(params, dict(m, frontend=fe), o, cmvn, "cpu")
    want = sess.run([wav])[0]
    n_chunks = sess.n_chunks(len(wav))
    a = ocfg.c1 * fe["lfr_n"] * fe["frame_shift"]
    audio = np.zeros(n_chunks * a, np.float32)
    audio[: len(wav)] = wav
    state = po.init_fused_state(cfg, ocfg, 1, True, "cpu")
    got = []
    with torch.inference_mode():
        for c in range(n_chunks):
            x = torch.from_numpy(audio[c * a: (c + 1) * a])[None]
            state, enc, emb, n = po.fused_encode(params, state, x, cfg, ocfg,
                                                 cmvn, ocfg.tokens_per_chunk)
            state, logits, _ = po.fused_decode(params, state, enc, emb, n,
                                               cfg, ocfg)
            got += list(logits[0, : int(n[0])])
        acc, fired = po.flush_tail(state, cfg.predictor_tail_threshold)
        if bool(fired[0]):
            dstate = {k: state[k] for k in po.DECODER_KEYS}
            _, logits, _ = po.decode_chunk_logits(
                params, dstate, acc[:, None], torch.ones(1, dtype=torch.int32),
                cfg)
            got.append(logits[0, 0])
    assert len(got) == len(want["tokens"]) > 0
    for g, (w, _) in zip(got, want["tokens"]):
        torch.testing.assert_close(w.float(), g, rtol=1e-4, atol=1e-4)


def test_training_matches_the_port(model):
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import \
        ParaformerConfig
    from toolbox_for_asr_and_tts_tpu_torch.parallel import trainstep
    m, _, _, _, _ = model
    g = torch.Generator().manual_seed(2)
    feats = torch.randn((3, 20, m["input_dim"]), generator=g)
    lens = torch.tensor([20, 17, 11])
    targets = torch.randint(4, m["vocab_size"] - 1, (3, 8), generator=g)
    tlens = torch.tensor([8, 5, 3])
    p1 = weights.make_params(m, 9, "cpu")
    p2 = weights.make_params(m, 9, "cpu")
    l1 = [v.requires_grad_(True) for _, v in weights.leaves_of(p1)]
    l2 = [v.requires_grad_(True) for _, v in weights.leaves_of(p2)]
    loss1 = ref.train_loss(p1, feats, lens, targets, tlens, m)
    loss2, _ = trainstep.paraformer_loss(p2, feats, lens, targets, tlens,
                                         ParaformerConfig(**m))
    torch.testing.assert_close(loss1, loss2, rtol=1e-5, atol=1e-6)
    g1 = torch.autograd.grad(loss1, l1)
    g2 = torch.autograd.grad(loss2, l2)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(3)
    w = torch.randn(50, generator=g)
    ours, theirs = w.clone(), w.clone().requires_grad_(True)
    opt = torch.optim.AdamW([theirs], lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    m, v = torch.zeros(50), torch.zeros(50)
    for step in range(1, 4):
        grad = torch.randn(50, generator=g)
        ref.adamw_step([ours], [grad], [m], [v], step, lr=1e-3, b1=0.9,
                       b2=0.999, eps=1e-8, wd=1e-4)
        theirs.grad = grad.clone()
        opt.step()
    torch.testing.assert_close(ours, theirs.detach(), rtol=1e-6, atol=1e-7)
