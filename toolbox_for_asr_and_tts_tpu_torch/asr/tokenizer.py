"""Character/BPE tokenizer for ASR output (FunASR CharTokenizer semantics).

Loads the vocab shipped with Paraformer checkpoints (`tokens.json` — a JSON
list — or `tokens.txt`, one token per line; vocab 8404 for paraformer-large)
and renders greedy token ids to display text with FunASR's joining rules:
CJK tokens concatenate, ASCII/BPE tokens join with spaces and `@@` suffixes
merge into the following token.
"""
from __future__ import annotations

import json
from typing import Iterable, List, Sequence

DEFAULT_SPECIAL = ("<blank>", "<s>", "</s>", "<unk>")


class CharTokenizer:
    def __init__(self, tokens: Sequence[str],
                 special: Iterable[str] = DEFAULT_SPECIAL):
        self.tokens = list(tokens)
        self.special = set(special)
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}

    def __len__(self) -> int:
        return len(self.tokens)

    @classmethod
    def load(cls, path: str) -> "CharTokenizer":
        if path.endswith(".json"):
            with open(path, encoding="utf-8") as f:
                tokens = json.load(f)
        else:
            with open(path, encoding="utf-8") as f:
                tokens = [ln.rstrip("\n").split()[0] for ln in f if ln.strip()]
        return cls(tokens)

    @classmethod
    def dummy(cls, size: int) -> "CharTokenizer":
        """Synthetic vocab for tests/benchmarks: specials + CJK-range chars."""
        toks = list(DEFAULT_SPECIAL)
        i = 0
        while len(toks) < size:
            toks.append(chr(0x4E00 + i))
            i += 1
        return cls(toks[:size])

    def ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        out = []
        for i in ids:
            if 0 <= int(i) < len(self.tokens):
                t = self.tokens[int(i)]
                if t not in self.special:
                    out.append(t)
        return out

    def ids_to_text(self, ids: Sequence[int]) -> str:
        return join_tokens(self.ids_to_tokens(ids))


def _is_cjk(tok: str) -> bool:
    return len(tok) > 0 and any(
        0x4E00 <= ord(c) <= 0x9FFF or 0x3400 <= ord(c) <= 0x4DBF
        or 0xF900 <= ord(c) <= 0xFAFF or c in "，。？！、；：" for c in tok)


def join_tokens(tokens: Sequence[str]) -> str:
    """FunASR sentence postprocess: merge `@@` BPE pieces, no spaces around
    CJK, single spaces between latin words."""
    words: List[str] = []
    buf = ""
    for t in tokens:
        if t.endswith("@@"):
            buf += t[:-2]
            continue
        if buf:
            t = buf + t
            buf = ""
        words.append(t)
    if buf:
        words.append(buf)
    out = ""
    prev_latin = False
    for w in words:
        latin = not _is_cjk(w)
        if out and prev_latin and latin:
            out += " "
        out += w
        prev_latin = latin
    return out
