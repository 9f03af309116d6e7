"""Hotword loading & normalization.

Copy of `toolbox_for_asr_and_tts_tpu/asr/hotwords.py` for the port
(framework-free; imports kept relative).

Port of the reference's hotword handling (voice-service/app/services/
voice_interface.py:39-82 `load_hotwords_from_file` and :185-194
`_normalize_hotwords`): `hotwords.txt` lines are either `word` (default
weight 20) or `word weight`; negative weights mark banned words. The result
serializes to the JSON string format FunASR consumes, and feeds both decoding
bias and the LLM correction prompt (reference LLM_functions.py:454-502
`load_hotwords_list`).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List

logger = logging.getLogger("toolbox.hotwords")

DEFAULT_WEIGHT = 20


def load_hotwords_from_file(path: str,
                            default_weight: int = DEFAULT_WEIGHT) -> Dict[str, int]:
    """Parse hotwords.txt → {word: weight}. Comment lines start with '#'."""
    words: Dict[str, int] = {}
    if not os.path.exists(path):
        logger.warning("hotwords file %s not found", path)
        return words
    with open(path, encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            word = parts[0]
            weight = default_weight
            if len(parts) > 1:
                try:
                    weight = int(parts[1])
                except ValueError:
                    logger.warning("bad hotword weight %r, using default", parts[1])
            words[word] = weight
    return words


def normalize_hotwords(hotwords) -> Dict[str, int]:
    """Accept dict / list / JSON-string / whitespace-string forms
    (reference `_normalize_hotwords`)."""
    if hotwords is None:
        return {}
    if isinstance(hotwords, dict):
        return {str(k): int(v) for k, v in hotwords.items()}
    if isinstance(hotwords, (list, tuple, set)):
        return {str(w): DEFAULT_WEIGHT for w in hotwords}
    if isinstance(hotwords, str):
        s = hotwords.strip()
        if not s:
            return {}
        try:
            return normalize_hotwords(json.loads(s))
        except json.JSONDecodeError:
            return {w: DEFAULT_WEIGHT for w in s.split()}
    raise TypeError(f"unsupported hotwords type {type(hotwords)}")


def hotwords_json(hotwords) -> str:
    """Serialize to the JSON-dict string the FunASR wire protocol carries."""
    return json.dumps(normalize_hotwords(hotwords), ensure_ascii=False)


def positive_hotword_list(hotwords) -> List[str]:
    """Words with weight > 0 (banned words have negative weights)."""
    return [w for w, wt in normalize_hotwords(hotwords).items() if wt > 0]


def banned_words(hotwords) -> List[str]:
    return [w for w, wt in normalize_hotwords(hotwords).items() if wt < 0]
