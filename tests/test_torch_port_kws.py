"""Port `models/kws_ctc.py` vs the reference, on the reference's
`init_params` tree (through `params_from_numpy`) and seeded numpy inputs,
at `KeywordSpotter.random()`'s geometry (hidden 32, proj 16, 2 layers,
lorder 10 + rorder 2, vocab 64): log-probs within 1e-5, CTC and keyword
scores within 1e-4 (and against a brute-force path sum), decisions equal."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from toolbox_for_asr_and_tts_tpu.models import kws_ctc as jkws  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import kws_ctc as kws  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.convert import params_from_numpy  # noqa: E402


@pytest.fixture(scope="module")
def spotters():
    jk = jkws.KeywordSpotter.random(threshold=0.0)
    cfg = kws.KwsConfig(**dataclasses.asdict(jk.cfg))
    p = params_from_numpy(jax.tree.map(np.asarray, jk.params), device="cpu")
    assert p["blocks"][0]["fsmn"]["wr"].shape == (cfg.proj_dim, 1, 2)
    k = kws.KeywordSpotter(p, cfg, dict(jk.char_to_id), threshold=0.0,
                           device="cpu")
    return jk, k


def test_forward_matches_reference(spotters):
    """Log-probs within 1e-5 with the right-context taps; without them
    (rorder 0) too."""
    jk, k = spotters
    x = np.random.default_rng(0).standard_normal((2, 53, 240)).astype(
        np.float32)
    got = kws.forward(k.params, torch.from_numpy(x), k.cfg).numpy()
    jforward = jax.jit(jkws.forward, static_argnums=2)
    want = np.asarray(jforward(jk.params, jnp.asarray(x), jk.cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jcfg0 = dataclasses.replace(jk.cfg, rorder=0)
    jp0 = jkws.init_params(jax.random.PRNGKey(1), jcfg0)
    p0 = params_from_numpy(jax.tree.map(np.asarray, jp0), device="cpu")
    got0 = kws.forward(p0, torch.from_numpy(x),
                       dataclasses.replace(k.cfg, rorder=0)).numpy()
    np.testing.assert_allclose(got0, np.asarray(jforward(
        jp0, jnp.asarray(x), jcfg0)), rtol=1e-5, atol=1e-5)


def _brute_ctc(logp, labels, blank=0):
    """log Σ over every frame path that collapses to `labels`."""
    t, v = logp.shape
    total = []
    for path in itertools.product(range(v), repeat=t):
        out, prev = [], None
        for c in path:
            if c != blank and c != prev:
                out.append(c)
            prev = c
        if out == list(labels):
            total.append(sum(logp[i, c] for i, c in enumerate(path)))
    return np.logaddexp.reduce(total) if total else -np.inf


@pytest.mark.parametrize("labels", [[1, 2], [2, 2], [3]])
def test_ctc_forward_score_matches_brute_force_and_reference(labels):
    """T 5, V 4 (1024 paths): the recursion equals the path sum within
    1e-4 (repeated labels need a blank between them), and the reference's
    scan within 1e-4; frame_len 4 freezes alpha after frame 4."""
    rng = np.random.default_rng(len(labels) + labels[0])
    lp = rng.standard_normal((2, 5, 4)).astype(np.float32)
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    lab = np.zeros(4, np.int64)
    lab[: len(labels)] = labels
    got = kws.ctc_forward_score(torch.from_numpy(lp), torch.from_numpy(lab),
                                len(labels), [5, 4]).numpy()
    for r, n in enumerate((5, 4)):
        assert abs(got[r] - _brute_ctc(lp[r, :n].astype(np.float64),
                                       labels)) < 1e-4
        want = float(jkws.ctc_forward_score(
            jnp.asarray(lp[r]), jnp.asarray(lab.astype(np.int32)),
            jnp.asarray(len(labels)), jnp.asarray(n)))
        assert abs(got[r] - want) < 1e-4
        single = float(kws.ctc_forward_score(
            torch.from_numpy(lp[r]), torch.from_numpy(lab), len(labels), n))
        assert abs(single - got[r]) < 1e-6
        ks = float(kws.kws_score(torch.from_numpy(lp[r]),
                                 torch.from_numpy(lab), len(labels), n))
        jks = float(jkws.kws_score(
            jnp.asarray(lp[r]), jnp.asarray(lab.astype(np.int32)),
            jnp.asarray(len(labels)), jnp.asarray(n)))
        assert abs(ks - jks) < 1e-4


def _windows(n, length=25600, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(length) / 16000
    return [(0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * t)
             + 0.05 * rng.standard_normal(length)).astype(np.float32)
            for _ in range(n)]


def test_detect_audio_and_batch_match_reference(spotters):
    """Five 1.6 s windows and one 1.0 s window: detect_audio_batch equals
    detect_audio row by row (two length groups, pow-2 batch 8 and 1), the
    scores within 1e-4 of the reference's batched and single scorers, and
    a threshold at the median score splits the decisions alike."""
    jk, k = spotters
    wins = _windows(5) + _windows(1, 16000, seed=1)
    batch = k.detect_audio_batch(wins)
    single = [k.detect_audio(w) for w in wins]
    for (db, sb), (ds, ss) in zip(batch, single):
        assert db == ds and abs(sb - ss) < 1e-5
    want = jk.detect_audio_batch(wins)
    for (_, s), (_, js) in zip(batch, want):
        assert abs(s - js) < 1e-4
    assert abs(single[0][1] - jk.detect_audio(wins[0])[1]) < 1e-4
    k.threshold = jk.threshold = float(np.median([s for _, s in batch]))
    assert [d for d, _ in k.detect_audio_batch(wins)] == \
        [d for d, _ in jk.detect_audio_batch(wins)]
    assert 0 < sum(d for d, _ in k.detect_audio_batch(wins)) < len(wins)
    k.threshold = jk.threshold = 0.0


def test_detect_feats_matches_reference(spotters):
    jk, k = spotters
    x = np.random.default_rng(2).standard_normal((30, 240)).astype(np.float32)
    d, s = k.detect_feats(x, 25)
    jd, js = jk.detect_feats(x, 25)
    assert d == jd and abs(s - js) < 1e-4


def test_set_keyword_refuses_out_of_vocabulary(spotters):
    _, k = spotters
    with pytest.raises(ValueError, match="outside the KWS vocabulary"):
        k.set_keyword("小a")
    assert k.keyword == "小护"
    k.set_keyword("一丁")
    assert k._label_len == 2 and k._labels[:2].tolist() == [
        k.char_to_id["一"], k.char_to_id["丁"]]
    k.set_keyword("小护")
