"""Uni-gram DP word segmentation for the word_segment prosody stream.

Copy of `toolbox_for_asr_and_tts_tpu/tts/segmenter.py` for the port
(framework-free; imports kept relative).

Replaces the greedy longest-match `_word_spans` (round-2) with a Viterbi
pass over the item DAG — the algorithm family ttsfrd's statistical
segmenter uses (tts-service/Dockerfile:61-64), at lexicon scale authored
in tts/segwords.py. Greedy longest-match over-commits to 3-char entries —
生活费 in 生活费用 strands 用, 皮肤科 in 皮肤科学 strands 学; the DP pass
scores whole segmentations, so the two-word reading wins on word priors.

Scoring: each lexicon word costs `-tier` (higher tier = cheaper; tiers are
coarse log-frequency classes, segwords.py), single out-of-lexicon items
cost a flat OOV penalty slightly worse than a tier-3 word per char, so real
words always beat char runs but unknown text degrades to chars, never to
false merges (edges only exist for lexicon words).

Operates on G2P items (char-run, syllable) — erhua merges keep their full
char run, so 一点儿 matches as one node.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# a lexicon word of tier t costs WORD_BASE - t (so tier 6 ≈ free); WORD_BASE
# keeps all costs positive for readability, constants cancel in comparisons
WORD_BASE = 6.5
# cost of one out-of-lexicon single item. MUST exceed the dearest lexicon
# word cost (tier 3 → 3.5): if an OOV single were cheaper per item than a
# word, adjacent real words would mis-segment into word+stranded-OOV
# (大学|习惯 → 大|学习|惯) — the exact failure the DP exists to prevent.
OOV_COST = 4.5


def viterbi_spans(chars: Sequence[str], words: Dict[str, float],
                  max_word: int) -> List[int]:
    """chars: per-item char runs. Returns span lengths: spans[i] = number of
    items in the word starting at i, 0 inside a word (the `_word_spans`
    contract, text_frontend.py)."""
    n = len(chars)
    if n == 0:
        return []
    INF = float("inf")
    best = [INF] * (n + 1)
    back = [1] * (n + 1)    # items consumed by the chosen last word
    best[0] = 0.0
    for i in range(n):
        if best[i] == INF:
            continue
        # single item (word of one item, or OOV char). A single-char lexicon
        # entry must never cost MORE than an unknown char — listing a char
        # can only help it.
        one = chars[i]
        tier = words.get(one)
        c_single = min(WORD_BASE - tier, OOV_COST) if tier is not None else OOV_COST
        if best[i] + c_single < best[i + 1]:
            best[i + 1] = best[i] + c_single
            back[i + 1] = 1
        # multi-item lexicon words
        acc = one
        j = i + 1
        while j < n and len(acc) < max_word:
            acc += chars[j]
            j += 1
            tier = words.get(acc)
            if tier is None:
                continue
            c = WORD_BASE - tier
            if best[i] + c < best[j]:
                best[j] = best[i] + c
                back[j] = j - i
    spans = [0] * n
    i = n
    while i > 0:
        ln = back[i]
        spans[i - ln] = ln
        i -= ln
    return spans


def segment(text: str, words: Dict[str, float],
            max_word: int) -> List[str]:
    """Convenience: segment a plain string into words (tests/tools)."""
    spans = viterbi_spans(list(text), words, max_word)
    out: List[str] = []
    i = 0
    while i < len(text):
        ln = max(spans[i], 1)
        out.append(text[i:i + ln])
        i += ln
    return out
