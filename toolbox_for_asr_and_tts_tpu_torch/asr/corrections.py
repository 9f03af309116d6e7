"""Hard-coded ASR post-corrections, as data.

Copy of `toolbox_for_asr_and_tts_tpu/asr/corrections.py` for the port
(framework-free; imports kept relative).

Port of the reference's 16 inline correction rules + interjection stripping
(voice-service/app/api/voice.py:666-815), restructured as a declarative table
(survey §7: "port them as a table-driven FSM / data, not ad hoc ifs"):

1. whole-utterance homophones of 无 (五/乌/吴/屋/舞/5/午/吾/芜, matched after
   stripping punctuation) → 无
2-14. global medical homophone replacements (前妻→前期, 黑边/黑变→黑便, …)
15. interjection/filler character stripping (嗯哈哼…), punctuation preserved
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

# rule 1: exact match after punctuation strip → replacement
WHOLE_UTTERANCE_CORRECTIONS: Dict[str, str] = {
    w: "无" for w in ["五", "乌", "吴", "屋", "舞", "5", "午", "吾", "芜"]
}

_PUNCT_STRIP_RE = re.compile(
    "[，。！？、；：“”‘’（）【】《》〈〉「」『』〔〕〖〗…—～·\\s]")

# rules 2–14: ordered global replacements (multi-char patterns first so e.g.
# 脱腾→头疼 wins over 腾→疼)
GLOBAL_REPLACEMENTS: List[Tuple[str, str]] = [
    ("脱腾", "头疼"), ("拖腾", "头疼"), ("拖疼", "头疼"), ("脱疼", "头疼"),
    ("颜面不通", "颜面部痛"),
    ("犯罪症状", "伴随症状"),
    ("前妻", "前期"),
    ("气势", "前期"),
    ("黑边", "黑便"), ("黑变", "黑便"),
    ("游离", "油腻"), ("游历", "油腻"),
    ("即性", "急性"),
    ("树叶", "输液"), ("书页", "输液"), ("术业", "输液"), ("树业", "输液"),
    ("腾", "疼"), ("藤", "疼"), ("滕", "疼"), ("誊", "疼"),
    ("壳", "咳"),
    ("串", "喘"), ("川", "喘"),
    ("涨", "胀"), ("账", "胀"),
]

# rule 15: filler/interjection characters removed everywhere
INTERJECTION_RE = re.compile(r"[嗯哈哼噗砰呀嗷啊哦额呃诶唉哎呦妈]+")


def apply_hard_corrections(text: str) -> str:
    """Apply rules 1–15 in the reference's order."""
    if not text:
        return text
    stripped = _PUNCT_STRIP_RE.sub("", text.strip())
    if stripped in WHOLE_UTTERANCE_CORRECTIONS:
        return WHOLE_UTTERANCE_CORRECTIONS[stripped]
    for src, dst in GLOBAL_REPLACEMENTS:
        if src in text:
            text = text.replace(src, dst)
    return INTERJECTION_RE.sub("", text)


def is_punct_only(text: str) -> bool:
    """True if nothing but punctuation/whitespace remains (the reference
    filters such results as empty, voice_interface.py:2279-2301)."""
    return _PUNCT_STRIP_RE.sub("", text or "") == ""
