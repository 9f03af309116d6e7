"""N-gram language model fusion for offline decoding.

Equivalent of the reference's optional WFST n-gram LM
(`damo/speech_ngram_lm_zh-cn-ai-wesp-fst`, applied inside the FunASR C++
server and gated by FUNASR_DISABLE_LM — voice-service/start.py:73-99). Here:
an ARPA-format character LM (unigram..trigram with backoff) fused into the
NAR decoder's output by Viterbi rescoring over the top-k acoustic candidates
per token position:

    path score = Σ_t [ logP_acoustic(y_t) + λ · logP_LM(y_t | y_{t-2} y_{t-1}) ]

Host-side dynamic programming over (positions × k² transitions) — the
candidate set is tiny (k≈4, utterances ≤ ~64 tokens), so this costs
microseconds and needs no device work.
"""
from __future__ import annotations

import logging
import math
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

logger = logging.getLogger("toolbox.ngram")

LOG10 = math.log(10.0)


class ArpaLM:
    """ARPA back-off LM over character tokens (orders 1..3)."""

    def __init__(self):
        self.logp: List[Dict[Tuple[str, ...], float]] = [{}, {}, {}]
        self.backoff: List[Dict[Tuple[str, ...], float]] = [{}, {}, {}]
        self.order = 1

    @classmethod
    def load(cls, path: str) -> "ArpaLM":
        lm = cls()
        order = 0
        with open(path, encoding="utf-8") as f:
            for raw in f:
                line = raw.strip()
                if not line or line.startswith("\\data"):
                    continue
                m = re.match(r"\\(\d)-grams:", line)
                if m:
                    order = int(m.group(1))
                    lm.order = max(lm.order, order)
                    continue
                if line.startswith("\\end"):
                    break
                if order == 0:
                    continue
                parts = line.split("\t")
                if len(parts) < 2:
                    parts = line.split()
                    if len(parts) < order + 1:
                        continue
                    prob, words = parts[0], parts[1:order + 1]
                    bo = parts[order + 1] if len(parts) > order + 1 else None
                else:
                    prob = parts[0]
                    words = parts[1].split()
                    bo = parts[2] if len(parts) > 2 else None
                key = tuple(words)
                try:
                    lm.logp[order - 1][key] = float(prob) * LOG10
                    if bo is not None:
                        lm.backoff[order - 1][key] = float(bo) * LOG10
                except ValueError:
                    continue
        logger.info("ARPA LM loaded: %s", [len(d) for d in lm.logp])
        return lm

    def score(self, context: Sequence[str], word: str) -> float:
        """log P(word | context), Katz back-off (natural log):

            P(w | c_1..c_n) = logp[(c_1..c_n, w)]            if present
                            = bo(c_1..c_n) + P(w | c_2..c_n)  otherwise

        Backoff weights ACCUMULATE across every skipped order (round-2
        review finding: only one level's weight was applied, so a
        trigram→unigram backoff dropped bo(c_2))."""
        ctx = tuple(context[-(self.order - 1):]) if self.order > 1 else ()
        bo_acc = 0.0
        for n in range(len(ctx), 0, -1):
            key = ctx[len(ctx) - n:] + (word,)          # (n+1)-gram
            if key in self.logp[n]:
                return bo_acc + self.logp[n][key]
            bo_acc += self.backoff[n - 1].get(ctx[len(ctx) - n:], 0.0)
        return bo_acc + self.logp[0].get((word,), math.log(1e-7))


def lm_rescore(token_ids: List[int], logprobs: np.ndarray, lm: ArpaLM,
               id_to_token: Sequence[str], lm_weight: float = 0.3,
               top_k: int = 4) -> List[int]:
    """Exact second-order Viterbi fusion over top-k acoustic candidates:
    the DP state is the (y_{t-1}, y_t) candidate PAIR, so the trigram
    context in the module docstring's objective is honored (round-2 review
    finding: the previous first-order DP only ever scored bigrams and a
    loaded 3-gram table was dead weight). Cost n·k³ with k≈4 — host-side
    microseconds."""
    n = len(token_ids)
    if n == 0:
        return token_ids
    cands = np.argsort(-logprobs[:n], axis=-1)[:, :top_k]  # [n, k]
    k = cands.shape[1]

    def tok(t: int, j: int) -> str:
        tid = int(cands[t, j])
        return id_to_token[tid] if tid < len(id_to_token) else ""

    if n == 1:
        scores = [logprobs[0, cands[0, j]] + lm_weight * lm.score([], tok(0, j))
                  for j in range(k)]
        return [int(cands[0, int(np.argmax(scores))])]

    dp = np.full((k, k), -np.inf)      # dp[i, j]: y_{t-1}=cand i, y_t=cand j
    bp = np.zeros((n, k, k), np.int32)
    for i in range(k):
        si = logprobs[0, cands[0, i]] + lm_weight * lm.score([], tok(0, i))
        for j in range(k):
            dp[i, j] = (si + logprobs[1, cands[1, j]]
                        + lm_weight * lm.score([tok(0, i)], tok(1, j)))
    for t in range(2, n):
        ndp = np.full((k, k), -np.inf)
        for j in range(k):           # candidate at t-1
            for l in range(k):       # candidate at t
                ac = logprobs[t, cands[t, l]]
                lmw = lm_weight * np.array(
                    [lm.score([tok(t - 2, i), tok(t - 1, j)], tok(t, l))
                     for i in range(k)])
                s = dp[:, j] + ac + lmw
                bi = int(np.argmax(s))
                ndp[j, l] = s[bi]
                bp[t, j, l] = bi
        dp = ndp
    flat = int(np.argmax(dp))
    j, l = divmod(flat, k)
    out = [0] * n
    out[n - 1] = int(cands[n - 1, l])
    out[n - 2] = int(cands[n - 2, j])
    for t in range(n - 1, 1, -1):
        i = int(bp[t, j, l])
        out[t - 2] = int(cands[t - 2, i])
        j, l = i, j
    return out
