"""TTS text frontend: normalization, prosody-aware splitting, G2P.

Copy of `toolbox_for_asr_and_tts_tpu/tts/text_frontend.py` for the port
(framework-free; imports kept relative).

Behavioral port of the reference's text handling
(tts-service/app/services/tts_service.py:230-392): whitespace/newline →
comma normalization, list-number stripping, strong-punctuation split, list
merging, weak-punctuation split, hard cut at `hard_max`, trailing-comma
patching — with the same default targets (18 / first 14 / hard max 22 chars,
tts_service.py:66-68).

G2P replaces the reference's native `ttsfrd` frontend (survey §2.3): a
pinyin lexicon (initial/final + tone phonemes) with a per-character fallback
token for out-of-lexicon characters. The lexicon ships with a seed vocabulary
(tts/pinyin_data.py) and can be extended/overridden from a deployment lexicon
file, which is how parity with ttsfrd's pronunciations is reached when real
checkpoints are converted.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .pinyin_data import PINYIN_TABLE, INITIALS

STRONG_PUNCT = "。！？；"
WEAK_PUNCT = "，、："
ALL_PUNCT = STRONG_PUNCT + WEAK_PUNCT + "\n"


# ------------------------------------------------------------- normalize
_DERIVED_LEXICON: Optional[Dict[str, str]] = None


def _derived_word_lexicon() -> Dict[str, str]:
    """POS-derived polyphone words (assets/polyphone_lexicon.tsv), loaded
    once per process. Returns a fresh dict so callers may mutate. Missing
    or unreadable file → empty (the asset is optional at runtime)."""
    global _DERIVED_LEXICON
    if _DERIVED_LEXICON is None:
        import os
        path = os.path.join(os.path.dirname(__file__), "..", "assets",
                            "polyphone_lexicon.tsv")
        lex: Dict[str, str] = {}
        try:
            with open(path, encoding="utf-8") as f:
                for ln in f:
                    if ln.startswith("#"):
                        continue
                    parts = ln.rstrip("\n").split("\t")
                    if len(parts) >= 2:
                        lex[parts[0]] = parts[1]
        except OSError:
            pass
        _DERIVED_LEXICON = lex
    return dict(_DERIVED_LEXICON)


def normalize_text(text: str) -> str:
    """Reference `_normalize_text` semantics (tts_service.py:230-266)."""
    t = (text or "").strip()
    if not t:
        return ""
    t = t.replace("\r\n", "\n").replace("\r", "\n")
    t = re.sub(r"[ \t]+", " ", t)
    t = re.sub(r"\n\s*\n+", "，", t)                       # blank lines → comma
    t = re.sub(r"([^\n，。！？；\s])\s*\n\s*([^\n，。！？；\s])", r"\1，\2", t)
    t = re.sub(r"(^|\n)\s*\d{1,2}\s*[\.、:：\)]\s*", r"\1", t)  # strip list nums
    t = re.sub(r"，+", "，", t)
    t = re.sub(r"^，+|，+$", "", t)
    return t.strip()


def merge_list_items(parts: List[str]) -> List[str]:
    """Reference `_merge_list_items` (tts_service.py:268-302): numbered items
    start fresh segments; plain text accumulates."""
    out: List[str] = []
    buf = ""
    for p in parts:
        s = p.strip()
        if not s:
            continue
        if re.match(r"^\d{1,2}\.\s+", s):
            if buf.strip():
                out.append(buf.strip())
                buf = ""
            out.append(s)
        else:
            buf = s if not buf else buf + " " + s
    if buf.strip():
        out.append(buf.strip())
    return out


def split_text_for_tts(text: str, target: int = 18, first_target: int = 14,
                       hard_max: int = 22) -> List[str]:
    """Reference `_split_text_for_tts` (tts_service.py:304-392)."""
    t = normalize_text(text)
    if not t:
        return []
    strong = [p.strip() for p in re.split(r"(?<=[。！？；\n])", t) if p.strip()]
    strong = merge_list_items(strong)

    out: List[str] = []
    buf = ""

    def emit(s: str):
        if s.strip():
            out.append(s.strip())

    def limit(is_first: bool) -> int:
        return first_target if is_first else target

    for p in strong:
        p = p.strip()
        if not p:
            continue
        lim = limit(len(out) == 0 and not buf)
        if buf and len(buf) + len(p) <= lim:
            buf += p
            continue
        if not buf and len(p) <= lim:
            buf = p
            continue
        if buf:
            emit(buf)
            buf = ""
        if len(p) > hard_max:
            subs = [s.strip() for s in re.split(r"(?<=[，、：])", p) if s.strip()]
            tmp = ""
            for s in subs:
                lim2 = limit(len(out) == 0 and not tmp)
                if tmp and len(tmp) + len(s) <= lim2:
                    tmp += s
                elif not tmp and len(s) <= lim2:
                    tmp = s
                else:
                    if tmp:
                        emit(tmp)
                        tmp = ""
                    if len(s) <= hard_max:
                        emit(s)
                    else:
                        for i in range(0, len(s), hard_max):
                            emit(s[i:i + hard_max])
            if tmp:
                emit(tmp)
        else:
            emit(p)
    if buf:
        emit(buf)
    # non-final segments without trailing punctuation get a comma
    for i in range(len(out) - 1):
        if out[i] and out[i][-1] not in "。！？；，、：\n":
            out[i] += "，"
    return out


def pause_after(segment: str, soft_ms: int = 120, hard_ms: int = 200) -> int:
    """Inter-segment pause (tts_service.py:664-671): hard after sentence-final
    punctuation, soft otherwise."""
    last = segment[-1] if segment else ""
    return hard_ms if last in "。！？；\n" else soft_ms


# --------------------------------------------------------------------- G2P
@dataclasses.dataclass
class Phone:
    symbol: str
    tone: int = 0          # 0 = none/neutral context (punct etc.)
    is_punct: bool = False
    # KAN-TTS linguistic streams (kantts ling-unit lfeat_type_list:
    # sy,tone,syllable_flag,word_segment):
    syl_pos: int = 0       # 0 none · 1 s_begin · 2 s_end · 3 s_both
    word_pos: int = 0      # 0 none · 1 begin · 2 middle · 3 end · 4 single


def split_pinyin(syllable: str) -> Tuple[str, str, int]:
    """'zhong4' → ('zh', 'ong', 4). Tone 5 = neutral.

    Orthographic normalization: after j/q/x/y a written 'u' is actually ü
    ('v' in the phone set) — xue→(x, ve), jun→(j, vn), yuan→(y, van) —
    standard pinyin spelling rules; without it every ü-final syllable
    (血/觉/乐/略/全/军…) encoded as <unk>."""
    tone = 5
    if syllable and syllable[-1].isdigit():
        tone = int(syllable[-1])
        syllable = syllable[:-1]
    for ini in INITIALS:  # longest-first list
        if syllable.startswith(ini) and len(syllable) > len(ini):
            fin = syllable[len(ini):]
            if ini in ("j", "q", "x", "y") and fin.startswith("u"):
                fin = "v" + fin[1:]
            return ini, fin, tone
    return "", syllable, tone


class G2P:
    """Text → pinyin syllables → phoneme sequence (ttsfrd-parity rules).

    Pipeline (replacing the reference's native ttsfrd frontend,
    tts-service/Dockerfile:61-64):
      1. greedy longest-match segmentation against the polyphone word
         lexicon (tts/polyphones.py) — 银行→hang2, 重要→zhong4 etc. — with
         per-character fallback readings;
      2. erhua: a trailing 儿 of a lexicalized 儿化 word rhotacizes the
         previous final (一点儿 → dianr3) instead of being a syllable;
      3. tone sandhi: 一 (yi2 before tone 4, yi4 before 1/2/3, yi1 in
         ordinals/numbers), 不 (bu2 before tone 4), and third-tone chains
         (all but the last of a 3-tone run become tone 2).

    Out-of-lexicon CJK characters map to a per-char token (`char_<cp>`), so
    synthesis still works end-to-end; latin letters/digits map to themselves.
    """

    def __init__(self, lexicon: Optional[Dict[str, str]] = None,
                 words: Optional[Dict[str, str]] = None,
                 phrase_breaks: bool = True):
        from .polyphones import ERHUA_WORDS, WORD_PINYIN
        # prosodic #2/#3 phrase-break prediction inside long
        # punctuation-free clauses (tts/prosody.py; ttsfrd's phrasing role)
        self.phrase_breaks = phrase_breaks
        self.lexicon = dict(PINYIN_TABLE)
        if lexicon:
            self.lexicon.update(lexicon)
        # word precedence (low→high): POS-derived statistical lexicon
        # (assets/polyphone_lexicon.tsv, compiled offline from jieba's
        # word-POS data by tools/build_polyphone_lexicon.py — the ttsfrd
        # tagger's signal without a runtime tagger) < authored WORD_PINYIN
        # < caller-supplied words
        self.words = _derived_word_lexicon()
        self.words.update(WORD_PINYIN)
        if words:
            self.words.update(words)
        self.erhua = set(ERHUA_WORDS)
        self._max_word = max(len(w) for w in self.words)
        # segmentation lexicon (word_segment prosody stream ONLY — never
        # pronunciations): the authored general list ∪ the pronunciation
        # compounds ∪ erhua words, with coarse frequency tiers for the DP
        # segmenter (tts/segmenter.py)
        from .segwords import general_words
        self.seg_words = general_words()
        for w in self.words:
            self.seg_words.setdefault(w, 3.0)
        for w in self.erhua:
            self.seg_words.setdefault(w, 4.0)
        self._max_seg_word = max(len(w) for w in self.seg_words)

    @classmethod
    def with_lexicon_file(cls, path: str) -> "G2P":
        """Load `char pinyin` lines (deployment lexicon, ttsfrd-extracted)."""
        lex: Dict[str, str] = {}
        with open(path, encoding="utf-8") as f:
            for ln in f:
                parts = ln.strip().split()
                if len(parts) >= 2:
                    lex[parts[0]] = parts[1]
        return cls(lex)

    # ------------------------------------------------------------ stages
    def _segment(self, text: str
                 ) -> Tuple[List[Tuple[str, Optional[str]]], set]:
        """([(char, syllable-or-None)], locked-index set) with polyphone
        words resolved. Indices covered by a word-lexicon match are LOCKED:
        the contextual particle rules must not override 目的/的确/了解/…"""
        items: List[Tuple[str, Optional[str]]] = []
        locked: set = set()
        i = 0
        n = len(text)
        while i < n:
            matched = False
            for ln in range(min(self._max_word, n - i), 1, -1):
                w = text[i:i + ln]
                if w in self.words:
                    for ch, sy in zip(w, self.words[w].split()):
                        locked.add(len(items))
                        items.append((ch, sy))
                    i += ln
                    matched = True
                    break
            if not matched:
                ch = text[i]
                items.append((ch, self.lexicon.get(ch)))
                i += 1
        return items, locked

    def _apply_context(self, items: List[Tuple[str, Optional[str]]],
                       locked: set) -> List[Tuple[str, Optional[str]]]:
        """Contextual particle disambiguation for 地/得/了 (ttsfrd does this
        with a POS tagger; these window rules cover the dominant patterns —
        roadmap item 11 tracks a learned tagger for the open-domain tail).

        地: AA地 reduplication or before a verb → adverbial de5, else di4.
        得: verb + complement → de5 (跑得快); subject + verb → modal dei3
            (我得去); otherwise attainment de2 (测得).
        了: after 不 → liao3 (受不了); after 得 at clause end → liao3
            (来得了), else aspect le5.
        只: after a numeral/determiner → measure word zhi1 (一只/这只),
            else the adverb zhi3 ("only").
        数: before the aspect particles 了/过/着 → the verb shu3
            (数了数), else the noun shu4.
        子: noun-suffix 子 neutralizes (本子/帖子/桌子 → zi5) — which also
            stops the 3-3 sandhi a full zi3 would wrongly trigger (本子
            must be ben3 zi5, not ben2 zi3); literary/scientific compounds
            keep the full tone (电子/学子/男子 — _ZI_FULL_TONE_PREV).
        """
        out = list(items)
        n = len(out)
        for i, (ch, sy) in enumerate(out):
            if i in locked or sy is None:
                continue
            prev = out[i - 1][0] if i else ""
            prev2 = out[i - 2][0] if i > 1 else ""
            nxt = out[i + 1][0] if i + 1 < n else ""
            if ch == "地":
                if (prev and prev == prev2) or nxt in _PARTICLE_VERBS:
                    out[i] = (ch, "de5")
            elif ch == "得":
                if prev in _PARTICLE_VERBS and (nxt in _ADJ_COMPLEMENT
                                                or nxt in _PARTICLE_VERBS
                                                or not nxt):
                    out[i] = (ch, "de5")
                elif prev in _SUBJ_BEFORE_DEI and (nxt in _PARTICLE_VERBS
                                                   or nxt in "先再把"):
                    out[i] = (ch, "dei3")
            elif ch == "了":
                if prev == "不":
                    out[i] = (ch, "liao3")
                elif prev == "得" and (not nxt or nxt in ALL_PUNCT
                                       or nxt in "吗呢吧！？"):
                    out[i] = (ch, "liao3")
            elif ch == "只":
                if prev in _DETERMINERS:
                    out[i] = (ch, "zhi1")      # measure word: 一只/这只
            elif ch == "数":
                if nxt in "了过着":
                    out[i] = (ch, "shu3")      # verb: 数了数/数过
            elif ch == "子":
                if (sy == "zi3" and i and out[i - 1][1]
                        and prev not in _ZI_FULL_TONE_PREV):
                    out[i] = (ch, "zi5")       # noun suffix: 本子/帖子
        return out

    def _apply_erhua(self, items: List[Tuple[str, Optional[str]]]
                     ) -> List[Tuple[str, Optional[str]]]:
        out: List[Tuple[str, Optional[str]]] = []
        for ch, sy in items:
            if (ch == "儿" and out and out[-1][1]
                    and any("".join(c for c, _ in out[-(k - 1):]) + "儿"
                            in self.erhua for k in (2, 3))):
                pch, psy = out[-1]
                tone = psy[-1] if psy[-1].isdigit() else ""
                base = psy[:-1] if tone else psy
                out[-1] = (pch + "儿", f"{base}r{tone}")
                continue
            out.append((ch, sy))
        return out

    def _apply_sandhi(self, items: List[Tuple[str, Optional[str]]]
                      ) -> List[Tuple[str, Optional[str]]]:
        def tone_of(sy: Optional[str]) -> int:
            return int(sy[-1]) if sy and sy[-1].isdigit() else 0

        def retone(sy: str, t: int) -> str:
            return (sy[:-1] if sy[-1].isdigit() else sy) + str(t)

        out = list(items)
        n = len(out)
        # 一 / 不
        for i, (ch, sy) in enumerate(out):
            if sy is None:
                continue
            nxt = out[i + 1][1] if i + 1 < n else None
            t_next = tone_of(nxt)
            if ch in "一不" and 0 < i < n - 1 \
                    and out[i - 1][0] == out[i + 1][0] \
                    and out[i - 1][1] is not None:
                out[i] = (ch, retone(sy, 5))  # V一V / V不V: 看一看, 好不好
            elif ch == "一":
                prev_ch = out[i - 1][0] if i else ""
                next_ch = out[i + 1][0] if i + 1 < n else ""
                in_number = (prev_ch == "第" or prev_ch in _NUM_NEIGHBORS
                             or next_ch in _NUM_NEIGHBORS)
                if not in_number and t_next:
                    if t_next == 4:
                        out[i] = (ch, retone(sy, 2))      # 一个 → yi2
                    elif t_next in (1, 2, 3):
                        out[i] = (ch, retone(sy, 4))      # 一天 → yi4
            elif ch == "不" and t_next == 4:
                out[i] = (ch, retone(sy, 2))              # 不是 → bu2
        # third-tone chains: in a run of consecutive tone-3 syllables, all
        # but the last become tone 2 (很好 → hen2 hao3)
        run: List[int] = []
        for i in range(n + 1):
            t = tone_of(out[i][1]) if i < n else 0
            if t == 3:
                run.append(i)
            else:
                for j in run[:-1]:
                    out[j] = (out[j][0], retone(out[j][1], 2))
                run = []
        return out

    def _resolve(self, text: str) -> List[Tuple[str, Optional[str]]]:
        items, locked = self._segment(text)
        items = self._apply_context(items, locked)
        # bare-polyphone POS rules (the ttsfrd-tagger tail the compound
        # lexicon can't see): 还/曲/难/弹/长/着/重/行/为/相/传/将/盛/干…
        from .postagger import disambiguate
        items = disambiguate(items, locked)
        return self._apply_sandhi(self._apply_erhua(items))

    def pinyin(self, text: str) -> List[str]:
        """Tone-numbered syllables after polyphone/context/erhua/sandhi —
        the golden test surface (non-CJK and punctuation are skipped)."""
        return [sy for _, sy in self._resolve(text) if sy]

    def _word_spans(self, items: List[Tuple[str, Optional[str]]]) -> List[int]:
        """Word length (in items) at each starting item, 0 inside a word —
        uni-gram Viterbi over the GENERAL segmentation lexicon (round 3c:
        ~1.9k authored words + the pronunciation compounds, tts/segwords.py;
        was greedy longest-match over pronunciation compounds only, which
        marked ordinary words like 我们/医院 as singles and over-committed
        on 研究生-class prefixes). Erhua-merged items contribute their full
        char run, so 一点儿 still matches as one node. Segmentation feeds
        the word_segment prosody stream ONLY — never pronunciations."""
        from .segmenter import viterbi_spans
        return viterbi_spans([ch for ch, _ in items], self.seg_words,
                             self._max_seg_word)

    def __call__(self, text: str) -> List[Phone]:
        items = self._resolve(text)
        spans = self._word_spans(items)
        # prosodic phrase breaks (#2 → #sp, #3 → #br) for long clauses —
        # item idx → level, emitted after that item's phones below
        brk: Dict[int, int] = {}
        if self.phrase_breaks:
            from .prosody import predict_breaks
            brk = predict_breaks(items, spans)
        # word-segment position per item (syllable)
        wpos = [0] * len(items)

        def speakable(it: Tuple[str, Optional[str]]) -> bool:
            ch, sy = it
            if sy is not None:
                return True
            return not (ch in ALL_PUNCT or ch in "！？" or ch.isspace())

        i = 0
        while i < len(items):
            ln = max(spans[i], 1)
            if ln == 1:
                wpos[i] = 4 if speakable(items[i]) else 0
            else:
                for k in range(ln):
                    wpos[i + k] = 1 if k == 0 else (3 if k == ln - 1 else 2)
            i += ln
        phones: List[Phone] = []
        for idx, (ch, sy) in enumerate(items):
            wp = wpos[idx]
            if sy is not None:
                ini, fin, tone = split_pinyin(sy)
                if ini:
                    # initials carry no tone (legacy folded vocab relies on
                    # this); the tone stream rides on the final
                    phones.append(Phone(ini, 0, syl_pos=1, word_pos=wp))
                    phones.append(Phone(fin, tone, syl_pos=2, word_pos=wp))
                else:
                    phones.append(Phone(fin, tone, syl_pos=3, word_pos=wp))
            elif ch in ALL_PUNCT or ch in "！？":
                phones.append(Phone("#sil" if ch in STRONG_PUNCT else "#br",
                                    is_punct=True))
            elif ch.isascii() and ch.isalnum():
                phones.append(Phone(ch.lower(), word_pos=wp))
            elif ch.isspace():
                continue
            else:
                # fallback chars keep the COMPUTED word mark: a seg-lexicon
                # word may contain a char with no pinyin entry, and hardcoding
                # single(4) here emitted begin-without-end word streams
                phones.append(Phone(f"char_{ord(ch) % 4096}", word_pos=wp))
            if idx in brk:
                phones.append(Phone("#sp" if brk[idx] == 2 else "#br",
                                    is_punct=True))
        return phones


_NUM_NEIGHBORS = set("零一二两三四五六七八九十百千万亿0123456789")

# single-char classes for the particle rules (_apply_context): verbs that
# head 地+V / V+得 patterns, complement starters after 得, and subjects/
# adverbs before modal 得 (dei3)
_PARTICLE_VERBS = set(
    "走跑跳说讲做作吃喝看听写读念画唱哭笑学玩来去飞站坐睡躺穿脱洗想开关打拿"
    "抓拉推抱接送买卖借找换修办管教考问答帮等待留抬搬扔挂爬游流倒煮炒切剪缝"
    "补挑选争赢逃追赶躲藏摸碰撞摔跌灌浇泡蒸烤煎砍揉捏敲铺叠卷摆移搭拼干弄搞"
    "查治检养护救抢挤压按住记忘懂认猜盼望活动休息变长高升降用讲喊练")
_ADJ_COMPLEMENT = set(
    "很太好快慢多少高低早晚远近长短大小对错清准稳轻重舒难易紧松深浅香甜苦咸"
    "厉流利整齐漂亮不了凶狠死透惨够")
_SUBJ_BEFORE_DEI = set("我你他她它们咱谁都也还就总先可人家这那必")
# numerals/determiners that turn a following 只 into the measure word zhi1
_DETERMINERS = set("一二两三四五六七八九十几每这那哪0123456789")
# chars before which suffix-子 keeps its FULL tone (literary/scientific
# compounds: 电子/原子/学子/男子/独生子/棋子…); everything else neutralizes
_ZI_FULL_TONE_PREV = set("电原分量离中质粒光核精卵男女王公孔孟诸父母妻独生"
                         "长次幼嫡学弟君才天赤游骄棋孝")


class PhoneVocab:
    """Phoneme symbol ↔ id table (tone folded in as symbol_tone)."""

    PAD, UNK = "<pad>", "<unk>"

    def __init__(self, symbols: Sequence[str]):
        self.symbols = [self.PAD, self.UNK] + [s for s in symbols
                                               if s not in (self.PAD, self.UNK)]
        self.to_id = {s: i for i, s in enumerate(self.symbols)}

    def __len__(self):
        return len(self.symbols)

    @classmethod
    def default(cls) -> "PhoneVocab":
        from .pinyin_data import all_symbols
        return cls(all_symbols())

    def encode(self, phones: Sequence[Phone]) -> List[int]:
        ids = []
        for p in phones:
            sym = p.symbol if (p.is_punct or p.tone == 0) else f"{p.symbol}{p.tone}"
            ids.append(self.to_id.get(sym, self.to_id[self.UNK]))
        return ids


def text_to_phone_ids(text: str, g2p: G2P, vocab: PhoneVocab) -> List[int]:
    return vocab.encode(g2p(text))


class LingVocab:
    """KAN-TTS 4-stream linguistic encoding: each phone row is
    (sy, tone, syllable_flag, word_segment) ids — the ling-unit format the
    real Sambert checkpoint embeds with four separate tables
    (kantts lfeat_type_list: sy,tone,syllable_flag,word_segment,…). The sy
    sub-vocabulary is TONELESS (tone rides its own stream), unlike the
    legacy folded `PhoneVocab`."""

    PAD, UNK = "<pad>", "<unk>"
    TONE_SIZE = 8       # 0 none + tones 1–5 (+ headroom)
    SYLFL_SIZE = 8      # 0 none · 1 s_begin · 2 s_end · 3 s_both
    WSEG_SIZE = 8       # 0 none · 1 begin · 2 middle · 3 end · 4 single

    def __init__(self, symbols: Sequence[str]):
        self.symbols = [self.PAD, self.UNK] + [s for s in symbols
                                               if s not in (self.PAD, self.UNK)]
        self.to_id = {s: i for i, s in enumerate(self.symbols)}

    def __len__(self):
        return len(self.symbols)

    @classmethod
    def default(cls) -> "LingVocab":
        from .pinyin_data import all_sy_symbols
        return cls(all_sy_symbols())

    def encode(self, phones: Sequence[Phone]) -> List[List[int]]:
        rows = []
        for p in phones:
            rows.append([
                self.to_id.get(p.symbol, self.to_id[self.UNK]),
                0 if p.is_punct else min(max(p.tone, 0), self.TONE_SIZE - 1),
                min(max(p.syl_pos, 0), self.SYLFL_SIZE - 1),
                min(max(p.word_pos, 0), self.WSEG_SIZE - 1),
            ])
        return rows


def text_to_ling_ids(text: str, g2p: G2P, vocab: LingVocab) -> List[List[int]]:
    return vocab.encode(g2p(text))
