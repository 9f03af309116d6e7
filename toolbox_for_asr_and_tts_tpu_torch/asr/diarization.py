"""Speaker diarization: ASR sentences + CAM++ embeddings + host clustering.

Copy of `toolbox_for_asr_and_tts_tpu/asr/diarization.py` for the port
(framework-free; imports kept relative).

Equivalent of the reference's `iic/speech_paraformer-large-vad-punc-spk`
pipeline (voice-service/app/services/voice_interface.py:759-848), which
returns `sentence_info`: per-sentence text, timestamps and speaker labels —
the structure `finalize()` groups by speaker (voice_interface.py:2108-2170).

TPU/host split (survey §7 hard parts): sentence embeddings run batched on
the TPU (models/campplus.py); clustering over the handful of sentence
embeddings is sequential and runs on host numpy. Default clusterer (round 2)
is spectral clustering with eigengap speaker-count estimation — the same
algorithm family FunASR's CAM++ diarization backend uses — with the round-1
average-linkage agglomerative clusterer as a fallback; both are validated
against synthetic-speaker ground truth in tests/test_diarization_cluster.py.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Sequence

import numpy as np

logger = logging.getLogger("toolbox.diarization")


@dataclasses.dataclass
class Sentence:
    text: str
    start_ms: int
    end_ms: int
    spk: int = 0
    overlap_spk: list = None   # other speakers detected INSIDE this span
                               # (overlap / within-sentence speaker change);
                               # None = pure single-speaker sentence


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _renumber(labels: np.ndarray) -> np.ndarray:
    """Renumber labels by first appearance (stable ids like the reference)."""
    order: Dict[int, int] = {}
    out = np.zeros(len(labels), np.int32)
    for i, l in enumerate(labels):
        if int(l) not in order:
            order[int(l)] = len(order)
        out[i] = order[int(l)]
    return out


def _kmeans(x: np.ndarray, k: int, seed: int = 0, iters: int = 50
            ) -> np.ndarray:
    """Deterministic Lloyd k-means with farthest-point init."""
    rng = np.random.default_rng(seed)
    n = len(x)
    centers = [x[int(rng.integers(n))]]
    for _ in range(1, k):
        d = np.min([((x - c) ** 2).sum(-1) for c in centers], axis=0)
        centers.append(x[int(np.argmax(d))])
    c = np.stack(centers)
    labels = np.zeros(n, np.int64)
    for _ in range(iters):
        d = ((x[:, None] - c[None]) ** 2).sum(-1)
        new = d.argmin(1)
        if (new == labels).all():
            break
        labels = new
        for j in range(k):
            if (labels == j).any():
                c[j] = x[labels == j].mean(0)
    return labels


def spectral_cluster(embeddings: np.ndarray, max_speakers: int = 8,
                     p_keep: float = 0.4, min_gap: float = 1e-3
                     ) -> np.ndarray:
    """Spectral clustering with eigengap speaker-count estimation — the
    algorithm family behind FunASR's CAM++ diarization backend
    (voice_interface.py:832-841 pipeline).

    cosine affinity → per-row top-p pruning → symmetric normalized
    Laplacian → number of speakers = largest eigengap among the smallest
    eigenvalues (capped) → k-means on the spectral embedding.
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros((0,), np.int32)
    if n == 1:
        return np.zeros((1,), np.int32)
    x = np.asarray(embeddings, np.float64)
    x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
    if n == 2:  # eigengap needs ≥3 points; fall back to a cosine decision
        same = float(x[0] @ x[1]) >= 0.60
        return np.array([0, 0] if same else [0, 1], np.int32)
    sim = np.clip((x @ x.T + 1.0) / 2.0, 0.0, 1.0)       # [0, 1] affinity
    # per-row pruning: keep the top ceil(p*n) affinities (incl. self)
    keep = max(2, int(np.ceil(p_keep * n)))
    pruned = np.zeros_like(sim)
    for i in range(n):
        idx = np.argsort(sim[i])[-keep:]
        pruned[i, idx] = sim[i, idx]
    aff = (pruned + pruned.T) / 2.0
    d = aff.sum(1)
    d_isqrt = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    lap = np.eye(n) - d_isqrt[:, None] * aff * d_isqrt[None, :]
    vals, vecs = np.linalg.eigh(lap)
    k_max = min(max_speakers, n)
    gaps = np.diff(vals[:k_max + 1])
    # eigengap: ignore near-zero gaps (all-one-speaker case)
    k = int(np.argmax(gaps)) + 1 if gaps.max() > min_gap else 1
    if k == 1:
        return np.zeros(n, np.int32)
    emb = vecs[:, :k]
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    return _renumber(_kmeans(emb, k))


def cluster_embeddings(embeddings: np.ndarray, threshold: float = 0.60,
                       max_speakers: int = 8) -> np.ndarray:
    """Average-linkage agglomerative clustering on cosine similarity.

    Merges the two closest clusters while their average similarity exceeds
    `threshold`; caps at max_speakers by continuing to merge the closest
    pair. Returns int labels, renumbered by first appearance.
    """
    n = len(embeddings)
    if n == 0:
        return np.zeros((0,), np.int32)
    x = np.asarray(embeddings, np.float64)
    x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
    clusters: List[List[int]] = [[i] for i in range(n)]
    sim = x @ x.T

    def avg_sim(a: List[int], b: List[int]) -> float:
        return float(sim[np.ix_(a, b)].mean())

    while len(clusters) > 1:
        best, bi, bj = -2.0, -1, -1
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                s = avg_sim(clusters[i], clusters[j])
                if s > best:
                    best, bi, bj = s, i, j
        if best < threshold and len(clusters) <= max_speakers:
            break
        clusters[bi] = clusters[bi] + clusters[bj]
        del clusters[bj]
    labels = np.zeros(n, np.int32)
    for lbl, members in enumerate(clusters):
        for m in members:
            labels[m] = lbl
    # renumber by first appearance (stable speaker ids like the reference)
    order: Dict[int, int] = {}
    out = np.zeros(n, np.int32)
    for i, l in enumerate(labels):
        if l not in order:
            order[l] = len(order)
        out[i] = order[l]
    return out


def _majority3(v: List[int]) -> List[int]:
    """3-tap majority smoothing (kills single-window label flaps)."""
    if len(v) < 3:
        return list(v)
    out = list(v)
    for i in range(len(v)):
        a = v[max(0, i - 1): i + 2]
        out[i] = max(set(a), key=a.count)
    return out


def _split_runs(winners: List[int], min_run: int = 2) -> List[List[int]]:
    """Contiguous same-label runs; runs shorter than min_run merge into the
    previous (or following, for a short head) run."""
    runs: List[List[int]] = []
    for i, w in enumerate(winners):
        if runs and winners[i - 1] == w:
            runs[-1].append(i)
        else:
            runs.append([i])
    merged: List[List[int]] = []
    for r in runs:
        if len(r) < min_run and merged:
            merged[-1].extend(r)
        elif len(r) < min_run and not merged and len(runs) > 1:
            runs[1][:0] = r   # fold the short head into the next run
        else:
            merged.append(r)
    return merged if merged else [list(range(len(winners)))]


def _split_sentence(s: Sentence, runs: List[List[int]],
                    run_lbls: List[int], w_start: List[int], win: int,
                    sample_rate: int) -> List[Sentence]:
    """Cut a sentence at the midpoints between adjacent window runs' boundary
    windows (end of prev run's last window / start of next run's first
    window); text divided proportionally by duration."""
    mids = [int((w_start[nxt[0]] + w_start[prv[-1]] + win)
                / 2 * 1000 / sample_rate)
            for prv, nxt in zip(runs, runs[1:])]
    bounds = [s.start_ms] + mids + [s.end_ms]
    total = max(bounds[-1] - bounds[0], 1)
    cuts = [0] + [round(len(s.text) * (bounds[k + 1] - bounds[0]) / total)
                  for k in range(len(runs) - 1)] + [len(s.text)]
    return [Sentence(text=s.text[cuts[k]:cuts[k + 1]],
                     start_ms=bounds[k], end_ms=bounds[k + 1],
                     spk=int(run_lbls[k]))
            for k in range(len(runs))]


def refine_overlap(wav: np.ndarray, sents: List[Sentence],
                   sent_emb: np.ndarray, labels: np.ndarray, verifier,
                   sample_rate: int = 16000, win_ms: int = 1000,
                   hop_ms: int = 500, min_sent_ms: int = 1500,
                   margin: float = 0.05, reassign_frac: float = 0.7,
                   change_split: bool = False) -> List[Sentence]:
    """Overlap / within-sentence speaker-change detection (second pass).

    A sentence whose span contains two voices gets ONE mixture embedding at
    the sentence level, so cluster labels can't see inside it (the reference
    pipeline has the same blind spot — one spk per sentence_info entry,
    voice_interface.py:2108-2170). Second pass: slide win_ms windows over
    every long-enough sentence, embed ALL windows in ONE batched TPU call,
    and vote each window against the cluster centroids. Windows whose best
    centroid beats the sentence's assigned centroid by `margin` reveal a
    secondary speaker → recorded in `overlap_spk`; if ≥ reassign_frac of
    windows vote for one other speaker, the sentence's own embedding was
    mixture-dominated and `spk` is reassigned to the window majority.

    change_split=True additionally SPLITS a sentence whose windows vote in
    time-contiguous runs for different speakers (a rapid A→B turn change
    that fell inside one <gap_split_ms pause): the sentence becomes one
    Sentence per run, cut at the midpoint between the runs' boundary
    windows, text divided proportionally by duration. This is finer than
    the reference's sentence_info granularity (one spk per sentence,
    voice_interface.py:2108-2170) and is what keeps DER low on fast
    turn-taking (tools/der.py synthetic harness).
    """
    k = int(labels.max()) + 1 if len(labels) else 0
    if k < 2 or len(np.unique(labels)) < 2:
        return sents
    x = np.asarray(sent_emb, np.float64)
    x = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-9)
    counts = np.bincount(labels, minlength=k)
    cent = np.stack([x[labels == j].mean(0) if counts[j] else np.zeros(
        x.shape[1]) for j in range(k)])
    cent = cent / (np.linalg.norm(cent, axis=1, keepdims=True) + 1e-9)
    win = int(win_ms * sample_rate / 1000)
    hop = int(hop_ms * sample_rate / 1000)
    windows: List[np.ndarray] = []
    owners: List[int] = []
    w_starts: List[int] = []
    for si, s in enumerate(sents):
        if s.end_ms - s.start_ms < min_sent_ms:
            continue
        a = int(s.start_ms * sample_rate / 1000)
        b = min(int(s.end_ms * sample_rate / 1000), len(wav))
        starts = list(range(a, b - win + 1, hop))
        if starts and starts[-1] != b - win:
            starts.append(b - win)   # right-align the last window
        for w in starts:
            windows.append(np.asarray(wav[w: w + win], np.float32))
            owners.append(si)
            w_starts.append(w)
    if not windows:
        return sents
    # pow-2 pad the window COUNT: it depends on sentence spans (content),
    # and every distinct batch size would otherwise compile its own program
    n_pad = _next_pow2(len(windows)) - len(windows)
    wemb = np.asarray(verifier.embed(
        windows + [np.zeros(win, np.float32)] * n_pad)[: len(windows)],
        np.float64)
    wemb = wemb / (np.linalg.norm(wemb, axis=1, keepdims=True) + 1e-9)
    sim = wemb @ cent.T                                    # [W, K]
    sim[:, counts == 0] = -np.inf   # empty clusters can't win votes
    best = sim.argmax(1)
    owners_arr = np.asarray(owners)
    replacement: Dict[int, List[Sentence]] = {}
    for si in sorted(set(owners)):
        rows = np.flatnonzero(owners_arr == si)
        own = sents[si].spk
        if change_split and len(rows) >= 4:
            winners = _majority3([int(best[r]) for r in rows])
            runs = _split_runs(winners)
            # label = run MAJORITY, not first element: a short head run
            # folded in by _split_runs would otherwise mislabel the piece
            run_lbls = [max({winners[i] for i in r},
                            key=[winners[i] for i in r].count)
                        for r in runs]
            if len(runs) >= 2 and len(set(run_lbls)) >= 2:
                replacement[si] = _split_sentence(
                    sents[si], runs, run_lbls,
                    [w_starts[r] for r in rows], win, sample_rate)
                logger.info("speaker change inside sentence %d: split "
                            "into %d turns %s", si, len(runs), run_lbls)
                continue
        others: Dict[int, int] = {}
        for r in rows:
            b_lbl = int(best[r])
            if b_lbl != own and sim[r, b_lbl] - sim[r, own] >= margin:
                others[b_lbl] = others.get(b_lbl, 0) + 1
        if not others:
            continue
        sents[si].overlap_spk = sorted(others)
        dom, cnt = max(others.items(), key=lambda kv: kv[1])
        if cnt / len(rows) >= reassign_frac:
            # mixture-dominated sentence embedding: window majority wins
            sents[si].overlap_spk = sorted(set([own]) | set(
                o for o in others if o != dom))
            sents[si].spk = dom
        logger.info("overlap in sentence %d: spk=%d others=%s",
                    si, sents[si].spk, sents[si].overlap_spk)
    if not replacement:
        return sents
    out: List[Sentence] = []
    for si, s in enumerate(sents):
        out.extend(replacement.get(si, [s]))
    return out


class Diarizer:
    """Offline transcription with sentence timestamps + speaker labels."""

    def __init__(self, recognizer, verifier, punctuator=None,
                 cluster_threshold: float = 0.60,
                 gap_split_ms: int = 800, method: str = "spectral",
                 overlap_detection: bool = True,
                 change_split: bool = True,
                 win_ms: int = 1000, hop_ms: int = 500):
        """gap_split_ms mirrors the reference's >800 ms-gap heuristic speaker
        split (voice_interface.py:2108-2170). method: "spectral" (FunASR's
        algorithm family, default) or "agglomerative". overlap_detection
        runs the windowed second pass (refine_overlap) on multi-speaker
        audio — one extra batched embed call. change_split additionally
        splits sentences at within-sentence speaker changes detected by
        that pass (see refine_overlap; measured by tools/der.py)."""
        self.recognizer = recognizer
        self.verifier = verifier
        self.punctuator = punctuator
        self.cluster_threshold = cluster_threshold
        self.gap_split_ms = gap_split_ms
        self.method = method
        self.overlap_detection = overlap_detection
        self.change_split = change_split
        self.win_ms = win_ms
        self.hop_ms = hop_ms

    def _sentences_from_tokens(self, result) -> List[Sentence]:
        """Split a TranscribeResult into sentences at predicted sentence-final
        punctuation (the reference's `sentence_info` granularity) and at
        >gap_split_ms timestamp gaps."""
        toks, ts = result.tokens, result.timestamps_ms
        if not toks:
            return []
        final_after = set()
        if self.punctuator is not None:
            # a failing punctuator raises (the reference logs it and splits
            # at gaps only; the port turns no model error into a default)
            cls = self.punctuator.classify(toks)
            plist = self.punctuator.cfg.punc_list
            for i, c in enumerate(cls):
                if int(c) < len(plist) and plist[int(c)] in "。？！；":
                    final_after.add(i)
        # FunASR-style [start, end] spans when available (round 2) give
        # sentence boundaries at integration-window edges instead of token
        # centers — tighter SV segment extraction
        spans = getattr(result, "timestamp", None)
        sents: List[Sentence] = []
        start = 0
        for i in range(1, len(toks) + 1):
            gap = (ts[i] - ts[i - 1]) if i < len(toks) else self.gap_split_ms + 1
            if gap > self.gap_split_ms or (i - 1) in final_after:
                text = "".join(toks[start:i])
                if spans:
                    s_ms, e_ms = spans[start][0], spans[i - 1][1]
                else:
                    s_ms, e_ms = ts[start], ts[i - 1] + 60
                sents.append(Sentence(text=text, start_ms=s_ms, end_ms=e_ms))
                start = i
        return sents

    def diarize(self, wav: np.ndarray, sample_rate: int = 16000,
                need_spk: bool = True) -> List[Sentence]:
        return self.diarize_batch([wav], sample_rate, need_spk=need_spk)[0]

    def _long_limit(self, sample_rate: int) -> int:
        """Samples above which a buffer takes the silence-aware
        transcribe_long path instead of joining the cross-utterance device
        batch: the RECOGNIZER'S largest audio bucket — anything longer
        would be silently truncated by pad_batch (the round-2 bug
        transcribe_long was built to fix)."""
        bucketer = getattr(self.recognizer, "bucketer", None)
        if bucketer is not None:
            return int(bucketer.sizes[-1])
        return int(120.0 * sample_rate)

    def diarize_batch(self, wavs: Sequence[np.ndarray],
                      sample_rate: int = 16000,
                      need_spk: bool = True) -> List[List[Sentence]]:
        """Diarize N independent utterances with BATCHED device work: one
        recognition call for every normal-length wav (bucketed batch on the
        serving mesh), then ONE speaker-embedding call over all wavs'
        sentence segments. Host-side clustering/overlap/punctuation stay
        per-wav. This is what the service's cross-session finalize hub
        (service/hub.py::FinalizeHub) drives so concurrent WS finalizes
        don't serialize N recognition round trips.

        need_spk=False skips the speaker side entirely (no segment
        embeddings, no clustering, no overlap pass; spk stays 0): a session
        with SV off discards the labels, and the skipped device calls are
        the difference between a ~2.5 s and a ~1 s finalize on a
        high-latency link (round-3 wsload finding)."""
        long_limit = self._long_limit(sample_rate)
        results: List[object] = [None] * len(wavs)
        short = [i for i, w in enumerate(wavs) if len(w) <= long_limit]
        if short:
            # pad the batch-size axis to a power of two: otherwise every
            # distinct number of concurrently-finalizing sessions compiles
            # its own recognition program (audio LENGTH is already bucketed
            # inside transcribe; this bounds the batch dimension too)
            batch = [wavs[i] for i in short]
            n_pad = _next_pow2(len(batch)) - len(batch)
            pad_len = max(len(w) for w in batch)
            batch += [np.zeros(pad_len, np.float32)] * n_pad
            for i, r in zip(short, self.recognizer.transcribe(batch)):
                results[i] = r
        for i, w in enumerate(wavs):
            if results[i] is None:
                # arbitrary-length finalize buffers: silence-aware split +
                # merge instead of truncating at the largest audio bucket
                if hasattr(self.recognizer, "transcribe_long"):
                    results[i] = self.recognizer.transcribe_long(w)
                else:
                    results[i] = self.recognizer.transcribe([w])[0]
        all_sents = [self._sentences_from_tokens(r) for r in results]
        if not need_spk:
            out_nospk: List[List[Sentence]] = [list(sents)
                                               for sents in all_sents]
            self._punctuate_all(out_nospk)
            return out_nospk
        # Window-level speaker modeling (round 4): 1 s / 0.5 s-hop windows
        # over every sentence span, embedded in ONE batched device call and
        # CLUSTERED AT WINDOW LEVEL. Sentence-level embeddings mix speakers
        # whenever a turn change falls inside one <gap_split_ms pause; the
        # mixtures blur the affinity matrix and make the eigengap
        # underestimate the speaker count (measured on tools/der.py's
        # synthetic mixtures: pooled DER 1.01 sentence-level → ~0.04
        # window-level). Windows are ~pure, so the cluster structure
        # survives; sentences take the majority label of their windows,
        # split at within-sentence label runs (change_split), and record
        # residual off-label windows as overlap_spk. This also REPLACES the
        # former two-call design (sentence embed + refine_overlap
        # re-embed) with a single embed call.
        win = int(self.win_ms * sample_rate / 1000)
        hop = int(self.hop_ms * sample_rate / 1000)
        windows: List[np.ndarray] = []
        w_owner: List[int] = []
        w_sent: List[int] = []
        w_start: List[int] = []
        for i, sents in enumerate(all_sents):
            for si, s in enumerate(sents):
                a = int(s.start_ms * sample_rate / 1000)
                b = min(int(s.end_ms * sample_rate / 1000), len(wavs[i]))
                b = max(b, a + sample_rate // 10)  # ≥100 ms embedding
                starts = list(range(a, b - win + 1, hop))
                if starts and starts[-1] != b - win:
                    starts.append(b - win)   # right-align the last window
                if not starts:
                    starts = [a]             # short sentence: whole span
                for w in starts:
                    windows.append(np.asarray(
                        wavs[i][w: min(w + win, b)], np.float32))
                    w_owner.append(i)
                    w_sent.append(si)
                    w_start.append(w)
        if windows:
            # power-of-two pad the window COUNT (it varies with speech
            # content; lengths bucket inside embed)
            n_pad = _next_pow2(len(windows)) - len(windows)
            wemb = np.asarray(self.verifier.embed(
                windows + [np.zeros(win, np.float32)] * n_pad
            )[: len(windows)], np.float64)
            wemb = wemb / (np.linalg.norm(wemb, axis=1, keepdims=True)
                           + 1e-9)
        out: List[List[Sentence]] = []
        for i, sents in enumerate(all_sents):
            if not sents:
                out.append([])
                continue
            rows = [j for j, o in enumerate(w_owner) if o == i]
            emb_i = wemb[rows]
            if self.method == "spectral":
                labels = spectral_cluster(emb_i)
            else:
                labels = cluster_embeddings(emb_i, self.cluster_threshold)
            out.append(self._label_sentences(
                sents, labels, emb_i, [w_sent[j] for j in rows],
                [w_start[j] for j in rows], win, sample_rate))
        self._punctuate_all(out)
        return out

    def _label_sentences(self, sents: List[Sentence], labels: np.ndarray,
                         emb: np.ndarray, sent_idx: List[int],
                         w_start: List[int], win: int,
                         sample_rate: int) -> List[Sentence]:
        """Window cluster labels → sentence speaker labels.

        Majority window label per sentence; ≥2 time-contiguous label runs
        (3-tap smoothed, min 2 windows each) split the sentence at the run
        boundary (change_split); off-majority windows whose cluster
        centroid beats the majority centroid by ≥0.05 cosine mark
        overlap_spk — same margin rule as refine_overlap. Speaker ids are
        renumbered by first appearance in sentence order (stable ids like
        the reference's sentence_info)."""
        k = int(labels.max()) + 1 if len(labels) else 0
        counts = np.bincount(labels, minlength=max(k, 1))
        cent = np.stack([emb[labels == j].mean(0) if counts[j]
                         else np.zeros(emb.shape[1]) for j in range(k)])
        cent = cent / (np.linalg.norm(cent, axis=1, keepdims=True) + 1e-9)
        sim = emb @ cent.T
        sim[:, counts == 0] = -np.inf
        out: List[Sentence] = []
        for si, s in enumerate(sents):
            rows = [r for r, owner in enumerate(sent_idx) if owner == si]
            raw = [int(labels[r]) for r in rows]
            if not raw:
                out.append(s)
                continue
            winners = _majority3(raw)
            runs = _split_runs(winners)
            # label = run MAJORITY, not first element: a short head run
            # folded in by _split_runs would otherwise mislabel the piece
            run_lbls = [max({winners[i] for i in r},
                            key=[winners[i] for i in r].count)
                        for r in runs]
            if (self.change_split and len(rows) >= 4
                    and len(set(run_lbls)) >= 2):
                pieces = _split_sentence(
                    s, runs, run_lbls, [w_start[r] for r in rows], win,
                    sample_rate)
                logger.info("speaker change inside sentence %d: split "
                            "into %d turns %s", si, len(pieces), run_lbls)
                out.extend(pieces)
                continue
            own = max(set(raw), key=raw.count)
            s.spk = int(own)
            if self.overlap_detection and k >= 2:
                others: Dict[int, int] = {}
                for r in rows:
                    b_lbl = int(sim[r].argmax())
                    if b_lbl != own and sim[r, b_lbl] - sim[r, own] >= 0.05:
                        others[b_lbl] = others.get(b_lbl, 0) + 1
                if others:
                    s.overlap_spk = sorted(others)
                    logger.info("overlap in sentence %d: spk=%d others=%s",
                                si, s.spk, s.overlap_spk)
            out.append(s)
        # stable speaker ids: renumber by first appearance in final order
        order: Dict[int, int] = {}
        for s in out:
            order.setdefault(int(s.spk), len(order))
        for s in out:
            s.spk = order[int(s.spk)]
            if s.overlap_spk:
                s.overlap_spk = sorted(
                    order.setdefault(int(o), len(order))
                    for o in s.overlap_spk)
        return out

    def _punctuate_all(self, out: List[List[Sentence]]) -> None:
        """ONE batched punctuation pass over every wav's sentences (bucketed
        inside punctuate_many) instead of a device round trip per sentence."""
        if self.punctuator is None:
            return
        flat = [s for sents in out for s in sents]
        if flat:
            for s, txt in zip(flat, self.punctuator.punctuate_many(
                    [s.text for s in flat])):
                s.text = txt


def group_by_speaker(sents: Sequence[Sentence]) -> Dict[int, List[Sentence]]:
    """Reference `finalize` grouping (voice_interface.py:2108-2170)."""
    groups: Dict[int, List[Sentence]] = {}
    for s in sents:
        groups.setdefault(s.spk, []).append(s)
    return groups


def extract_speaker_audio(wav: np.ndarray, sents: Sequence[Sentence], spk: int,
                          sample_rate: int = 16000) -> np.ndarray:
    """Concatenate a speaker's segments (reference `_extract_speaker_audio`,
    voice_interface.py:2347-2388)."""
    parts = []
    for s in sents:
        if s.spk == spk:
            a = int(s.start_ms * sample_rate / 1000)
            b = int(s.end_ms * sample_rate / 1000)
            parts.append(np.asarray(wav[a:b], np.float32))
    if not parts:
        return np.zeros((0,), np.float32)
    return np.concatenate(parts)
