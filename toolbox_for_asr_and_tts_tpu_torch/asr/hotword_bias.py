"""Hotword biasing for the NAR decoder output.

The reference feeds hotword JSON to FunASR decoding (voice_interface.py:
185-194) — in FunASR that's SeACo/contextual biasing inside the decoder.
Here, as in the JAX package: constrained rescoring of the greedy output against
the hotword list. For every utterance position, if a hotword aligns with the
decoded tokens with at most ⌈len/4⌉ substitutions AND every substituted
position has a weak logit margin (the decoder was unsure), the hotword's
characters replace the decoded ones. Weight scales the allowed margin, so
`负权重` (banned) words instead *veto* exact matches by remapping them to
runner-up tokens.

Host-side numpy over the [K, V] logprobs the recognizer already returns —
no extra device work.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import numpy as np

logger = logging.getLogger("toolbox.hotword_bias")

BASE_MARGIN = 1.0   # nats of logit margin a default-weight (20) word may flip


def _encode_hotwords(hotwords: Dict[str, int], token_to_id: Dict[str, int]
                     ) -> List[Tuple[List[int], int, str]]:
    out = []
    for word, weight in hotwords.items():
        ids = [token_to_id.get(ch, -1) for ch in word]
        if all(i >= 0 for i in ids) and len(ids) >= 2:
            out.append((ids, weight, word))
    return out


def apply_hotword_bias(token_ids: List[int], logprobs: np.ndarray,
                       hotwords: Dict[str, int],
                       token_to_id: Dict[str, int]) -> List[int]:
    """token_ids: greedy ids (len n); logprobs: [n, V] log-softmax rows.

    Returns possibly-rewritten ids.
    """
    if not hotwords or not token_ids:
        return token_ids
    n = len(token_ids)
    ids = list(token_ids)
    encoded = _encode_hotwords(hotwords, token_to_id)
    for hw_ids, weight, word in encoded:
        m = len(hw_ids)
        if weight < 0:
            continue  # banned words handled below
        max_sub = max(1, m // 4 + (1 if m <= 3 else 0))
        margin = BASE_MARGIN * (weight / 20.0)
        for start in range(0, n - m + 1):
            window = ids[start:start + m]
            subs = [i for i in range(m) if window[i] != hw_ids[i]]
            if not subs or len(subs) > max_sub:
                continue
            ok = True
            for i in subs:
                row = logprobs[start + i]
                have = row[window[i]]
                want = row[hw_ids[i]]
                if have - want > margin:
                    ok = False
                    break
            if ok:
                ids[start:start + m] = hw_ids
                logger.info("hotword bias applied: %s at %d", word, start)
    # banned words: if an exact banned sequence appears, demote each char to
    # the runner-up token
    for hw_ids, weight, word in encoded:
        if weight >= 0:
            continue
        m = len(hw_ids)
        for start in range(0, n - m + 1):
            if ids[start:start + m] == hw_ids:
                for i in range(m):
                    row = logprobs[start + i].copy()
                    row[hw_ids[i]] = -np.inf
                    ids[start + i] = int(np.argmax(row))
                logger.info("banned word removed: %s at %d", word, start)
    return ids
