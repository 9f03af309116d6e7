"""Diarization Error Rate (DER): the quality metric for the speaker side of
finalize.

Port's copy of `toolbox_for_asr_and_tts_tpu/tools/der.py` (framework-free:
numpy and scipy; the harnesses drive the port's `asr.diarization.Diarizer`,
`service.hub.FinalizeHub` and `asr.session.StreamingASRSession`). Standard
NIST md-eval semantics:

- **collar** (default 0.25 s): a no-score zone around every reference
  turn boundary, excluded from both the error numerator and the scored
  denominator (md-eval's ``-c 0.25``).
- **permutation-invariant mapping**: reference↔hypothesis speaker labels
  are matched by maximum scored overlap time (Hungarian assignment),
  never by label value.
- **overlap-aware accounting**: regions where R reference speakers talk
  at once contribute R× to the denominator; MISS/FA/CONFUSION follow the
  md-eval definitions (miss = ref speakers beyond hyp count, fa = hyp
  speakers beyond ref count, confusion = matched-count shortfall).

    DER = (MISS + FA + CONFUSION) / total reference speaker time

CLI (RTTM in, JSON out):

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.der \
        --ref ref.rttm --hyp hyp.rttm [--collar 0.25]
    python -m toolbox_for_asr_and_tts_tpu_torch.tools.der --synthetic
    python -m toolbox_for_asr_and_tts_tpu_torch.tools.der --service

``--synthetic`` runs the full-pipeline evaluation harness: synthesized
2–4-speaker mixtures with controlled overlap are driven through the real
``asr.diarization.Diarizer`` (gap splitting, clustering, overlap second
pass) with CAM++-statistics synthetic embeddings, and the resulting
sentence labels are scored against ground truth. ``--service`` drives the
same mixtures through the service's finalize path (sessions →
FinalizeHub → SV gate). Neither touches a device: the recognizer and the
verifier are synthetic.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
from typing import Dict, Iterable, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Turn:
    spk: str
    start: float   # seconds
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


# --------------------------------------------------------------- metric

def _assign(overlap: Dict[Tuple[str, str], float], refs: List[str],
            hyps: List[str]) -> Dict[str, str]:
    """Max-overlap one-to-one speaker mapping (Hungarian; brute-force
    fallback for tiny label sets when scipy is unavailable)."""
    if not refs or not hyps:
        return {}
    try:
        import numpy as np
        from scipy.optimize import linear_sum_assignment
        cost = np.zeros((len(refs), len(hyps)))
        for (r, h), t in overlap.items():
            cost[refs.index(r), hyps.index(h)] = -t
        ri, hi = linear_sum_assignment(cost)
        return {refs[i]: hyps[j] for i, j in zip(ri, hi)
                if overlap.get((refs[i], hyps[j]), 0.0) > 0.0}
    except ImportError:  # pragma: no cover - scipy is in the image
        small, large = (refs, hyps) if len(refs) <= len(hyps) else (hyps, refs)
        best, best_map = -1.0, {}
        for perm in itertools.permutations(large, len(small)):
            pairs = list(zip(small, perm))
            score = sum(overlap.get((r, h) if small is refs else (h, r), 0.0)
                        for r, h in pairs)
            if score > best:
                best = score
                best_map = {(r if small is refs else h):
                            (h if small is refs else r) for r, h in pairs}
        return {r: h for r, h in best_map.items()
                if overlap.get((r, h), 0.0) > 0.0}


def _scored_intervals(ref: Sequence[Turn], hyp: Sequence[Turn],
                      collar: float) -> List[Tuple[float, float]]:
    """Elementary intervals covering all turns, minus the ±collar no-score
    zones around every REFERENCE turn boundary."""
    points = set()
    for t in ref:
        points.update((t.start - collar, t.start + collar,
                       t.end - collar, t.end + collar))
    for t in hyp:
        points.update((t.start, t.end))
    pts = sorted(points)
    noscore: List[Tuple[float, float]] = []
    for t in ref:
        noscore.append((t.start - collar, t.start + collar))
        noscore.append((t.end - collar, t.end + collar))
    out = []
    for a, b in zip(pts, pts[1:]):
        if b - a <= 1e-12:
            continue
        mid = (a + b) / 2.0
        if any(lo < mid < hi for lo, hi in noscore):
            continue
        out.append((a, b))
    return out


def _active(turns: Sequence[Turn], a: float, b: float) -> List[str]:
    mid = (a + b) / 2.0
    return [t.spk for t in turns if t.start < mid < t.end]


def der(ref: Sequence[Turn], hyp: Sequence[Turn], collar: float = 0.25
        ) -> Dict[str, object]:
    """DER with md-eval semantics. Returns miss/fa/confusion/total seconds,
    the der ratio, and the speaker mapping used."""
    intervals = _scored_intervals(ref, hyp, collar)
    # pass 1: scored overlap time per (ref spk, hyp spk) → optimal mapping
    overlap: Dict[Tuple[str, str], float] = {}
    for a, b in intervals:
        for r in _active(ref, a, b):
            for h in _active(hyp, a, b):
                overlap[(r, h)] = overlap.get((r, h), 0.0) + (b - a)
    refs = sorted({t.spk for t in ref})
    hyps = sorted({t.spk for t in hyp})
    mapping = _assign(overlap, refs, hyps)
    # pass 2: accumulate errors per elementary interval
    miss = fa = conf = total = 0.0
    for a, b in intervals:
        dur = b - a
        ra = _active(ref, a, b)
        ha = set(_active(hyp, a, b))
        nr, nh = len(ra), len(ha)
        matched = sum(1 for r in set(ra) if mapping.get(r) in ha)
        total += dur * nr
        miss += dur * max(0, nr - nh)
        fa += dur * max(0, nh - nr)
        conf += dur * (min(nr, nh) - matched)
    d = (miss + fa + conf) / total if total > 0 else 0.0
    return {"der": d, "miss": miss, "fa": fa, "confusion": conf,
            "total": total, "mapping": mapping, "collar": collar}


# ------------------------------------------------------------ conversion

def turns_from_sentences(sents: Iterable, prefix: str = "spk") -> List[Turn]:
    """asr.diarization.Sentence list → turns. A sentence's span is one turn
    for its assigned speaker; overlap_spk speakers (the windowed second
    pass's within-sentence detections) each get a turn over the same span —
    sentence granularity is the finest the pipeline emits."""
    out: List[Turn] = []
    for s in sents:
        a, b = s.start_ms / 1000.0, s.end_ms / 1000.0
        out.append(Turn(f"{prefix}{int(s.spk)}", a, b))
        for o in (s.overlap_spk or []):
            if int(o) != int(s.spk):
                out.append(Turn(f"{prefix}{int(o)}", a, b))
    return out


def read_rttm(path: str) -> List[Turn]:
    """SPEAKER <file> <chan> <tbeg> <tdur> <ortho> <stype> <name> ..."""
    out: List[Turn] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].upper() != "SPEAKER":
                continue
            tbeg, tdur, name = float(parts[3]), float(parts[4]), parts[7]
            out.append(Turn(name, tbeg, tbeg + tdur))
    return out


def write_rttm(path: str, turns: Sequence[Turn], file_id: str = "f0") -> None:
    with open(path, "w", encoding="utf-8") as f:
        for t in sorted(turns, key=lambda t: t.start):
            f.write(f"SPEAKER {file_id} 1 {t.start:.3f} {t.dur:.3f} "
                    f"<NA> <NA> {t.spk} <NA> <NA>\n")


# ---------------------------------------------- synthetic pipeline harness

def synth_mixture(n_spk: int, seed: int, n_turns: int = 14,
                  overlap_frac: float = 0.15, sr: int = 16000):
    """Ground-truth turn script + a speaker-coded waveform.

    Each sample's amplitude encodes the ACTIVE SPEAKER BITMASK
    (0.02 × mask), so the synthetic verifier below can recover exactly who
    talks inside any window — including overlap regions, where two bits are
    set. Turn lengths 1.6–4.0 s, inter-turn gaps 0–1.4 s (some exceed the
    800 ms gap-split heuristic, some don't — both splitting regimes are
    exercised); with probability overlap_frac a turn starts 0.4–0.9 s
    before the previous one ends."""
    import numpy as np
    rng = np.random.default_rng(seed)
    turns: List[Turn] = []
    t = 0.3
    prev_spk = -1
    prev_end = t
    for i in range(n_turns):
        spk = int(rng.integers(n_spk))
        if spk == prev_spk:                       # force speaker changes
            spk = (spk + 1) % n_spk
        dur = float(rng.uniform(1.6, 4.0))
        if turns and rng.random() < overlap_frac:
            start = max(0.0, prev_end - float(rng.uniform(0.4, 0.9)))
        else:
            start = prev_end + float(rng.uniform(0.0, 1.4))
        turns.append(Turn(f"spk{spk}", start, start + dur))
        prev_end = start + dur
        prev_spk = spk
    total_s = prev_end + 0.5
    mask = np.zeros(int(total_s * sr), np.int32)
    for t_ in turns:
        s_i = int(t_.start * sr)
        e_i = int(t_.end * sr)
        mask[s_i:e_i] |= 1 << int(t_.spk[3:])
    return turns, (0.02 * mask).astype(np.float32)


class SyntheticVerifier:
    """CAM++-statistics embedder over speaker-coded waveforms: decodes the
    per-sample speaker bitmask, embeds as the noise-perturbed sum of
    per-speaker unit anchors weighted by airtime. noise=0.5 puts
    within-speaker cosine ≈ 0.8, the regime real CAM++ scores live in
    (same calibration as tests/test_diarization_cluster.py)."""

    def __init__(self, n_spk: int = 8, d: int = 192, noise: float = 0.5,
                 seed: int = 1234):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.anchors = rng.standard_normal((n_spk, d))
        self.anchors /= np.linalg.norm(self.anchors, axis=1, keepdims=True)
        self.noise = noise
        self.threshold = 0.40        # the service's gate, voice_interface.py:1140
        self._rng = rng

    def verify_embedding(self, enroll_emb, test_wav):
        """Same contract as asr.speaker.SpeakerVerifier.verify_embedding
        (cosine of enrollment embedding vs test-segment embedding, gated at
        `threshold`) so the service-layer harness can slot this in for the
        session's SV gate."""
        import numpy as np
        e = self.embed([test_wav])[0]
        score = float(np.dot(np.asarray(enroll_emb, np.float64), e))
        return score >= self.threshold, score

    def embed(self, segs):
        import numpy as np
        out = []
        for s in segs:
            mask = np.round(np.abs(np.asarray(s, np.float64)) / 0.02
                            ).astype(np.int64)
            w = np.zeros(len(self.anchors))
            for k in range(len(self.anchors)):
                w[k] = float(np.count_nonzero(mask & (1 << k)))
            if w.sum() == 0:
                w[0] = 1.0                       # silence → arbitrary
            e = (w / w.sum()) @ self.anchors
            e /= np.linalg.norm(e) + 1e-12
            g = self._rng.standard_normal(self.anchors.shape[1])
            e = e + g / np.linalg.norm(g) * self.noise
            out.append(e / np.linalg.norm(e))
        return np.stack(out)


class SyntheticRecognizer:
    """Emits one token per 360 ms of coded speech with true timestamps, so
    the Diarizer's sentence splitting (>800 ms gap heuristic,
    asr/diarization.py::_sentences_from_tokens) runs exactly as it would on
    real Paraformer output."""

    token_ms = 360

    def transcribe(self, wavs, sr: int = 16000):
        import numpy as np
        from ..asr.recognizer import TranscribeResult
        out = []
        step = int(self.token_ms * sr / 1000)
        for w in wavs:
            speech = np.abs(np.asarray(w)) > 1e-6
            toks, ts, spans = [], [], []
            for i in range(0, len(w) - step + 1, step):
                if speech[i:i + step].mean() > 0.5:
                    toks.append("字")
                    ts.append(int((i + step // 2) * 1000 / sr))
                    spans.append((int(i * 1000 / sr),
                                  int((i + step) * 1000 / sr)))
            out.append(TranscribeResult(
                text="".join(toks), tokens=toks,
                token_ids=[0] * len(toks), timestamps_ms=ts,
                timestamp=spans, audio_s=len(w) / sr))
        return out


def synthetic_eval(n_mixtures: int = 6, collar: float = 0.25,
                   seed0: int = 0) -> Dict[str, object]:
    """Drive the REAL Diarizer (clustering + overlap second pass + gap
    splitting) over synthesized 2/3/4-speaker mixtures; score sentence
    labels against ground truth. Returns per-mixture and pooled DER."""
    from ..asr.diarization import Diarizer
    ver = SyntheticVerifier()
    diar = Diarizer(SyntheticRecognizer(), ver, punctuator=None)
    per = []
    pooled_err = pooled_total = 0.0
    for i in range(n_mixtures):
        n_spk = 2 + (i % 3)                      # 2, 3, 4 speakers
        truth, wav = synth_mixture(n_spk, seed=seed0 + i)
        sents = diar.diarize(wav)
        got = turns_from_sentences(sents)
        m = der(truth, got, collar=collar)
        per.append({"n_spk": n_spk, "der": round(m["der"], 4),
                    "miss": round(m["miss"], 3), "fa": round(m["fa"], 3),
                    "confusion": round(m["confusion"], 3),
                    "total": round(m["total"], 3)})
        pooled_err += m["miss"] + m["fa"] + m["confusion"]
        pooled_total += m["total"]
    return {"pooled_der": pooled_err / max(pooled_total, 1e-9),
            "collar": collar, "mixtures": per}


# --------------------------------------------- service-layer finalize eval

class _RecordingDiarizer:
    """Tee around the FinalizeHub: the REAL hub path runs (batched
    diarize_batch, need_spk grouping), and each calling thread's resolved
    sentence list is kept so the eval can score exactly what the service's
    finalize consumed."""

    def __init__(self, hub):
        self._hub = hub
        self.by_thread: Dict[int, list] = {}

    def diarize(self, wav, sample_rate: int = 16000, need_spk: bool = True):
        import threading
        sents = self._hub.diarize(wav, sample_rate, need_spk=need_spk)
        self.by_thread[threading.get_ident()] = sents
        return sents

    def __getattr__(self, name):
        return getattr(self._hub, name)


def service_eval(n_target: int = 9, n_impostor: int = 6,
                 collar: float = 0.25, seed0: int = 50) -> Dict[str, object]:
    """End-to-end SERVICE-LAYER diarization+SV quality.

    Drives synthesized mixtures through the REAL finalize path the WS
    handler invokes — ``StreamingASRSession.finalize()`` →
    ``FinalizeHub.diarize(need_spk=True)`` (one batched
    ``Diarizer.diarize_batch`` across concurrent sessions) →
    ``group_by_speaker`` → per-speaker ``verify_embedding`` → threshold
    gate → sentinel-or-text — and scores the service's OWN outputs
    (voice_interface.py:2040-2263):

    - **DER** of each target trial's recorded sentence labels vs ground
      truth (same md-eval scoring as ``--synthetic``);
    - **SV operating stats**: target trials (the enrolled speaker IS in
      the mixture) must return that speaker's words; impostor trials
      (enrolled speaker absent) must return __SV_VERIFICATION_FAILED__.

    All sessions finalize concurrently from threads behind a barrier so
    the FinalizeHub genuinely batches them. CAVEAT (stated wherever this
    number is cited): the embedder and recognizer are SYNTHETIC
    (speaker-bitmask-coded waveforms, noise calibrated to real CAM++
    score spreads) — this validates the clustering/grouping/gating LOGIC
    at the service layer; the acoustic half awaits real weights. The
    chunk-FSM half of the WS path is not part of this harness."""
    import threading

    import numpy as np

    from ..asr.diarization import Diarizer
    from ..asr.session import (SV_VERIFICATION_FAILED, StreamingASRSession,
                               VoiceEngines)
    from ..service.hub import FinalizeHub

    ver = SyntheticVerifier()
    scores: Dict[int, List[float]] = {}
    real_verify = ver.verify_embedding

    def verify_recorded(enroll_emb, test_wav):
        ok, score = real_verify(enroll_emb, test_wav)
        scores.setdefault(threading.get_ident(), []).append(float(score))
        return ok, score

    ver.verify_embedding = verify_recorded
    hub = FinalizeHub(Diarizer(SyntheticRecognizer(), ver, punctuator=None))
    rec = _RecordingDiarizer(hub)
    engines = VoiceEngines(diarizer=rec, verifier=ver)

    trials = []
    for i in range(n_target + n_impostor):
        n_spk = 2 + (i % 3)                       # mixture speakers 0..n-1
        truth, wav = synth_mixture(n_spk, seed=seed0 + i)
        target = i < n_target
        # enrolled identity: in-mixture for target trials, an anchor the
        # mixture never uses (indices ≥ 4) for impostor trials
        enroll_spk = (i % n_spk) if target else 4 + (i % 4)
        enroll_wav = np.full(16000 * 6, 0.02 * (1 << enroll_spk), np.float32)
        sess = StreamingASRSession(engines, use_wake=True, use_sv=True)
        sess.is_activated = True                  # wake already passed
        sess.is_enrolled = True
        sess.enroll_audio = enroll_wav
        sess.audio_buffer = wav
        sess.has_detected_speech = True
        trials.append({"target": target, "n_spk": n_spk, "truth": truth,
                       "enroll_spk": enroll_spk, "sess": sess})

    barrier = threading.Barrier(len(trials))

    def run(tr):
        barrier.wait(timeout=60)
        tr["ident"] = threading.get_ident()
        tr["text"] = tr["sess"].finalize()

    threads = [threading.Thread(target=run, args=(t,)) for t in trials]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    try:
        pooled_err = pooled_total = 0.0
        per = []
        n_acc_t = n_corr_t = n_rej_i = 0
        sc_t: List[float] = []
        sc_i: List[float] = []
        for tr in trials:
            sents = rec.by_thread.get(tr["ident"], [])
            best = max(scores.get(tr["ident"], [float("nan")]))
            (sc_t if tr["target"] else sc_i).append(best)
            accepted = tr["text"] != SV_VERIFICATION_FAILED
            if not tr["target"]:
                n_rej_i += not accepted
                continue
            m = der(tr["truth"], turns_from_sentences(sents), collar=collar)
            pooled_err += m["miss"] + m["fa"] + m["confusion"]
            pooled_total += m["total"]
            # the service's output is the SELECTED SPEAKER'S words: compare
            # against the hyp speaker that max-overlaps the enrolled one
            mapped = m["mapping"].get(f"spk{tr['enroll_spk']}")
            want = "".join(s.text for s in sents
                           if f"spk{int(s.spk)}" == mapped)
            correct = accepted and tr["text"] == want and len(want) > 0
            n_acc_t += accepted
            n_corr_t += correct
            per.append({"n_spk": tr["n_spk"], "der": round(m["der"], 4),
                        "accepted": bool(accepted),
                        "correct_speaker_text": bool(correct),
                        "best_sv_score": round(best, 3)})
    finally:
        hub.close()
    return {"pooled_der": pooled_err / max(pooled_total, 1e-9),
            "collar": collar, "trials": per,
            "sv": {"target_accept": f"{n_acc_t}/{n_target}",
                   "target_correct_speaker_text": f"{n_corr_t}/{n_target}",
                   "impostor_reject": f"{n_rej_i}/{n_impostor}",
                   "threshold": ver.threshold,
                   "mean_best_score_target": round(
                       float(np.mean(sc_t)), 3) if sc_t else None,
                   "mean_best_score_impostor": round(
                       float(np.mean(sc_i)), 3) if sc_i else None},
            "note": ("synthetic embedder+recognizer: validates service-layer "
                     "clustering/grouping/SV-gating logic; acoustic half "
                     "awaits real weights")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ref", help="reference RTTM")
    ap.add_argument("--hyp", help="hypothesis RTTM")
    ap.add_argument("--collar", type=float, default=0.25)
    ap.add_argument("--synthetic", action="store_true",
                    help="run the synthetic full-pipeline harness")
    ap.add_argument("--service", action="store_true",
                    help="run the service-layer finalize harness (real "
                         "session→FinalizeHub→SV path, synthetic engines)")
    args = ap.parse_args()
    if args.synthetic:
        print(json.dumps(synthetic_eval(collar=args.collar),
                         ensure_ascii=False))
        return
    if args.service:
        print(json.dumps(service_eval(collar=args.collar),
                         ensure_ascii=False))
        return
    if not (args.ref and args.hyp):
        ap.error("--ref and --hyp required (or --synthetic)")
    m = der(read_rttm(args.ref), read_rttm(args.hyp), collar=args.collar)
    print(json.dumps(m, ensure_ascii=False))


if __name__ == "__main__":
    main()
