"""Port `tools/der.py` (tests/test_der.py, mirrored on the port): the
hand-computed md-eval cases, the RTTM round trip, and the synthetic
full-pipeline and service-layer harnesses through the port's Diarizer,
FinalizeHub and sessions. DER, miss, FA and confusion equal the reference
`tools.der`'s on the same RTTM and seeds."""
import math

import numpy as np
import pytest

from toolbox_for_asr_and_tts_tpu.tools import der as J  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tools import der as D  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.tools.der import (  # noqa: E402
    Turn, der, read_rttm, synth_mixture, synthetic_eval, turns_from_sentences,
    write_rttm)

METRICS = ("der", "miss", "fa", "confusion", "total")


def T(spk, a, b):
    return Turn(spk, float(a), float(b))


def _same_as_reference(ref, hyp, **kw):
    """The port's DER of (ref, hyp) equal to the reference's, figure for
    figure and mapping for mapping."""
    got = der(ref, hyp, **kw)
    want = J.der([J.Turn(t.spk, t.start, t.end) for t in ref],
                 [J.Turn(t.spk, t.start, t.end) for t in hyp], **kw)
    assert {k: got[k] for k in METRICS + ("mapping",)} == \
        {k: want[k] for k in METRICS + ("mapping",)}
    return got


def test_perfect_hypothesis_is_zero():
    ref = [T("A", 0, 10), T("B", 12, 20)]
    m = _same_as_reference(ref, ref)
    assert m["der"] == 0.0 and m["miss"] == 0.0 and m["fa"] == 0.0


def test_permutation_invariance():
    ref = [T("A", 0, 10), T("B", 12, 20)]
    hyp = [T("x9", 0, 10), T("x1", 12, 20)]
    assert _same_as_reference(ref, hyp)["der"] == 0.0


def test_pure_miss():
    m = _same_as_reference([T("A", 0, 10)], [])
    assert math.isclose(m["total"], 9.5, abs_tol=1e-9)
    assert math.isclose(m["miss"], 9.5, abs_tol=1e-9)
    assert math.isclose(m["der"], 1.0, abs_tol=1e-9)


def test_pure_false_alarm():
    m = _same_as_reference([T("A", 0, 10)], [T("A", 0, 10), T("A", 20, 25)])
    assert math.isclose(m["fa"], 5.0, abs_tol=1e-9)
    assert math.isclose(m["der"], 5.0 / 9.5, abs_tol=1e-9)


def test_confusion_two_speakers_one_hyp_label():
    m = _same_as_reference([T("A", 0, 10), T("B", 10, 20)],
                           [T("X", 0, 10), T("X", 10, 20)])
    assert math.isclose(m["confusion"], 9.5, abs_tol=1e-9)
    assert math.isclose(m["der"], 0.5, abs_tol=1e-9)


def test_collar_forgives_small_boundary_error():
    assert _same_as_reference([T("A", 0, 10)], [T("A", 0.2, 10.2)])[
        "der"] == 0.0
    # without a collar the same shift is scored
    assert _same_as_reference([T("A", 0, 10)], [T("A", 0.2, 10.2)],
                              collar=0.0)["der"] > 0.0


def test_overlap_counts_in_denominator():
    m = _same_as_reference([T("A", 0, 10), T("B", 5, 10)], [T("A", 0, 10)])
    assert math.isclose(m["total"], 13.5, abs_tol=1e-9)
    assert math.isclose(m["miss"], 4.5, abs_tol=1e-9)
    assert math.isclose(m["der"], 1.0 / 3.0, abs_tol=1e-9)


def test_turns_from_sentences_overlap_spk():
    class S:
        def __init__(self, spk, a, b, ov=None):
            self.spk, self.start_ms, self.end_ms = spk, a, b
            self.overlap_spk = ov

    turns = turns_from_sentences([S(0, 0, 2000), S(1, 2000, 5000, ov=[0])])
    assert T("spk0", 0, 2) in turns
    assert T("spk1", 2, 5) in turns
    assert T("spk0", 2, 5) in turns
    assert len(turns) == 3


def test_rttm_round_trip_and_reference_reads_it(tmp_path):
    """The port writes and reads RTTM as the reference does: each package
    reads the other's file, and the DER of two files is the same."""
    turns = [T("alice", 0.5, 3.25), T("bob", 3.0, 7.125)]
    p = str(tmp_path / "x.rttm")
    write_rttm(p, turns)
    got = read_rttm(p)
    assert sorted(got, key=lambda t: t.start) == sorted(
        turns, key=lambda t: t.start)
    q = str(tmp_path / "y.rttm")
    J.write_rttm(q, [J.Turn("alice", 0.5, 2.0), J.Turn("carol", 2.0, 7.0)])
    assert [(t.spk, t.start, t.end) for t in read_rttm(q)] == \
        [(t.spk, t.start, t.end) for t in J.read_rttm(q)]
    got = der(read_rttm(p), read_rttm(q))
    want = J.der(J.read_rttm(p), J.read_rttm(q))
    assert {k: got[k] for k in METRICS} == {k: want[k] for k in METRICS}


def test_cli_on_rttm_matches_reference(tmp_path, capsys, monkeypatch):
    import json
    import sys
    ref, hyp = str(tmp_path / "r.rttm"), str(tmp_path / "h.rttm")
    write_rttm(ref, [T("A", 0, 6), T("B", 5, 12)])
    write_rttm(hyp, [T("x", 0, 7), T("y", 7, 12)])
    outs = []
    for mod in (D, J):
        monkeypatch.setattr(sys, "argv", ["der", "--ref", ref, "--hyp", hyp,
                                          "--collar", "0.1"])
        mod.main()
        outs.append(json.loads(capsys.readouterr().out))
    assert outs[0] == outs[1] and outs[0]["der"] > 0


def test_synth_mixture_is_reproducible_and_coded():
    t1, w1 = synth_mixture(3, seed=7)
    t2, w2 = synth_mixture(3, seed=7)
    assert t1 == t2 and np.array_equal(w1, w2)
    mask = np.round(w1 / 0.02).astype(int)
    assert mask.max() >= 1 and (np.abs(w1 - 0.02 * mask) < 1e-6).all()
    jt, jw = J.synth_mixture(3, seed=7)
    assert [(t.spk, t.start, t.end) for t in t1] == \
        [(t.spk, t.start, t.end) for t in jt]
    assert np.array_equal(w1, jw)


def test_full_pipeline_der_regression():
    """The port's Diarizer over the synthesized 2/3/4-speaker mixtures:
    the pooled DER and every mixture's figures equal the reference
    harness's (both under the reference's 0.08 threshold)."""
    r = synthetic_eval(n_mixtures=6)
    assert r["pooled_der"] < 0.08, r
    want = J.synthetic_eval(n_mixtures=6)
    assert r["pooled_der"] == want["pooled_der"]
    assert r["mixtures"] == want["mixtures"]


@pytest.mark.parametrize("n_spk", [2, 4])
def test_single_mixture_der_bounded(n_spk):
    from toolbox_for_asr_and_tts_tpu_torch.asr.diarization import Diarizer
    diar = Diarizer(D.SyntheticRecognizer(), D.SyntheticVerifier(),
                    punctuator=None)
    truth, wav = synth_mixture(n_spk, seed=11)
    m = der(truth, turns_from_sentences(diar.diarize(wav)))
    assert m["der"] < 0.25, m


def test_service_layer_eval():
    """The port's sessions → FinalizeHub → SV gate over synthesized
    mixtures, scored from the service's own outputs (synthetic engines:
    the service-layer logic, not acoustics), as the reference's harness
    scores its service."""
    r = D.service_eval(n_target=4, n_impostor=2)
    assert r["pooled_der"] < 0.10, r
    assert r["sv"]["target_accept"] == "4/4", r
    assert r["sv"]["impostor_reject"] == "2/2", r
    assert r["sv"]["mean_best_score_target"] > 0.6, r
    assert r["sv"]["mean_best_score_impostor"] < 0.2, r
