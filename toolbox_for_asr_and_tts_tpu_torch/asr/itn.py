"""Inverse text normalization (ITN): spoken Chinese numbers → digits.

Copy of `toolbox_for_asr_and_tts_tpu/asr/itn.py` for the port
(framework-free).

Equivalent of the `thuduj12/fst_itn_zh` FST the reference's C++ FunASR
runtime applies to offline results (voice-service/start.py:82-95). Round-2
coverage (VERDICT item #6) matches the FST's categories: cardinals
(一百二十三 → 123), decimals (三点五 → 3.5), percentages (百分之八十 → 80%),
permille (千分之三 → 3‰), fractions (三分之一 → 1/3), ordinals (第三十五 →
第35), dates (二零二四年一月五号 → 2024年1月5号), negative numbers
(负三点五 → -3.5), ranges (三到五天 → 3到5天), currency (五十块钱 → 50块钱),
phone/ID digit strings with 幺 (幺三八… → 138…), and measure-word contexts.
Pure host-side string processing; golden table in tests/test_itn_demo_cli.py.
"""
from __future__ import annotations

import re
from typing import Optional

_DIGITS = {"零": 0, "一": 1, "二": 2, "两": 2, "三": 3, "四": 4,
           "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
_UNITS = {"十": 10, "百": 100, "千": 1000}
_BIG_UNITS = {"万": 10_000, "亿": 100_000_000}

_NUM_CHARS = "零一二两三四五六七八九十百千万亿"


def _parse_section(s: str) -> Optional[int]:
    """Parse a number below 万 (e.g. 三千五百二十一).

    Colloquial trailing abbreviation (fst_itn long-tail): a single digit
    after a unit with no explicit 零 takes the NEXT LOWER unit — 一千二 =
    1200, 两百五 = 250 — while 一百零五 stays 105 (零 makes it literal)."""
    total = 0
    current = 0
    last_unit = 0
    explicit_zero = False
    for ch in s:
        if ch == "零":
            explicit_zero = True
            continue
        if ch in _DIGITS:
            current = current * 10 + _DIGITS[ch] if current else _DIGITS[ch]
        elif ch in _UNITS:
            unit = _UNITS[ch]
            total += (current or 1) * unit
            current = 0
            last_unit = unit
            explicit_zero = False
        else:
            return None
    if current:
        if last_unit > 10 and not explicit_zero and current < 10:
            total += current * (last_unit // 10)
        else:
            total += current
    return total


def parse_cn_number(s: str) -> Optional[int]:
    """整数: handles 万/亿 grouping. Returns None if not parseable."""
    if not s or any(c not in _NUM_CHARS for c in s):
        return None
    # digit-string form like 一二三 (dates/codes): all plain digits. Two-char
    # pairs are NOT converted — adjacent-digit pairs are approximations
    # (五六个人 "five or six", 一两天, 三五成群, 十之八九), an fst_itn
    # long-tail rule the round-2 engine missed.
    if all(c in _DIGITS or c == "零" for c in s) and len(s) > 1:
        if len(s) == 2:
            return None
        digit_map = {**_DIGITS, "零": 0}
        return int("".join(str(digit_map[c]) for c in s))
    total = 0
    rest = s
    last_big = 0
    for ch, mult in (("亿", _BIG_UNITS["亿"]), ("万", _BIG_UNITS["万"])):
        if ch in rest:
            left, rest = rest.split(ch, 1)
            # a bare 万/亿 with no leading section is lexical (万一, 亿万),
            # never a spoken number — numbers always carry the multiplier
            if not left:
                return None
            sec = _parse_section(left)
            if sec is None:
                return None
            total += sec * mult
            last_big = mult
    # colloquial trailing abbreviation across 万/亿: 三万五 = 35000,
    # 三亿五 = 350000000 (next lower power of ten of the big unit)
    if rest and last_big and len(rest) == 1 and rest in _DIGITS:
        return total + _DIGITS[rest] * (last_big // 10)
    sec = _parse_section(rest) if rest else 0
    if sec is None:
        return None
    total += sec
    # bare 十 prefix (十三 = 13) handled by _parse_section already
    return total


_PERCENT_RE = re.compile(f"(百|千)分之([{_NUM_CHARS}]+(?:点[{_NUM_CHARS}]+)?)")
_FRACTION_RE = re.compile(f"([{_NUM_CHARS}]+)分之([{_NUM_CHARS}]+)")
_DECIMAL_RE = re.compile(
    # block when the "fraction" is really a following number unit (三点二十
    # is a TIME, 3点20) — unless that unit starts a measure word (三点二千克
    # IS the decimal 3.2 kg)
    f"([{_NUM_CHARS}]+)点([零一二两三四五六七八九]+)"
    # 万/亿 after the fraction are SCALE suffixes of a decimal quantity
    # (三点五万 = 3.5万), never time minutes, so they don't block
    "(?!(?:十|刻|[百千](?![克米帕瓦升])))")   # 两点一刻 is a TIME, 2点1刻
_NUMBER_RE = re.compile(f"[{_NUM_CHARS}]{{2,}}|[一二两三四五六七八九]")
# digit-string readouts: ≥5 plain digits, or ≥3 containing 幺 (幺 only ever
# appears in phone/code readouts — 幺二零 → 120); enforced in the callback
_PHONE_RE = re.compile("[零一二三四五六七八九幺]{3,}")
_PHONE_DIGITS = {**{c: str(d) for c, d in _DIGITS.items()}, "零": "0",
                 "幺": "1"}
# measure/unit words that license converting a single spoken digit
_UNIT_CONTEXT = re.compile(
    r"^(毫米|毫克|千克|公斤|厘米|毫升|小时|分钟|岁|次|天|周|月|年|度|号|日|点|倍|"
    r"粒|片|克|秒|升|条|支|针|盒|瓶|袋|块|元|毛|角|刻|mg|ml|kg|cm|mm)")
# characters that license a single digit by ADJACENCY (ranges, ordinals)
_RANGE_NEXT = ("到", "至", "或")
# units whose PRECEDING conversion licenses a trailing colloquial decimal
# digit: 五块三 → 5块3, 体温38度五 → 38度5 (fst_itn money/measure tails)
_PREV_UNIT = set("块元毛角度")
# 一点 is usually the degree word ("a little": 好一点, 吃一点东西), not
# 1 o'clock — converting needs explicit time evidence around the 点
_TIME_OF_DAY = ("凌晨", "清晨", "早上", "上午", "中午", "下午", "傍晚",
                "晚上", "夜里", "半夜")
_TIME_CONT = set("半钟分整多过")


def _fmt_decimal(int_part: str, frac_part: str) -> Optional[str]:
    n = parse_cn_number(int_part)
    if n is None:
        return None
    frac = "".join(str(_DIGITS.get(c, 0)) for c in frac_part)
    return f"{n}.{frac}"


def _num_or_decimal(s: str) -> Optional[str]:
    if "点" in s:
        ip, fp = s.split("点", 1)
        return _fmt_decimal(ip, fp)
    n = parse_cn_number(s)
    return None if n is None else str(n)


def apply_itn(text: str) -> str:
    """Convert spoken-form numbers in text to digit form (fst_itn_zh scope)."""
    # 1) phone/ID digit strings (幺 = 1) — before cardinals so 幺三八... wins
    def phone(m):
        s = m.group(0)
        if "幺" not in s and len(s) < 5:
            return s  # short plain strings stay for the cardinal pass (年份…)
        if m.start() > 0 and text[m.start() - 1] == "点":
            # a digit run after 点 is a DECIMAL fraction (三点一四一五九),
            # not a phone readout — leave it for the decimal pass
            return s
        return "".join(_PHONE_DIGITS[c] for c in s)

    text = _PHONE_RE.sub(phone, text)

    # 2) percent / permille
    def pct(m):
        d = _num_or_decimal(m.group(2))
        if d is None:
            return m.group(0)
        return f"{d}{'%' if m.group(1) == '百' else '‰'}"

    text = _PERCENT_RE.sub(pct, text)

    # 3) general fractions: 三分之一 → 1/3 (denominator first in Chinese)
    def frac(m):
        den = parse_cn_number(m.group(1))
        num_ = parse_cn_number(m.group(2))
        if den is None or num_ is None:
            return m.group(0)
        return f"{num_}/{den}"

    text = _FRACTION_RE.sub(frac, text)

    # 4) decimals
    def dec(m):
        d = _fmt_decimal(m.group(1), m.group(2))
        return d if d else m.group(0)

    text = _DECIMAL_RE.sub(dec, text)

    # 5) cardinals (with single-digit gating by context)
    def num(m):
        s = m.group(0)
        # single 一/二/两 etc. are usually lexical (一起, 一些) — require a
        # numeric context: measure/unit words, 第-ordinal, range links
        n = parse_cn_number(s)
        if n is None:
            return s
        if len(s) == 1:
            start, end = m.start(), m.end()
            prev = text[start - 1] if start else ""
            unit_lic = bool(_UNIT_CONTEXT.match(text[end:end + 2]))
            if unit_lic and s == "一" and text[end:end + 1] == "点":
                # lexical 一点 ("a little") stays verbatim unless the 点 is
                # demonstrably a clock time (一点半 / 下午一点 / 一点一刻)
                unit_lic = (text[end + 1: end + 2] in _TIME_CONT
                            or text[end + 1: end + 3] == "一刻"
                            or text[max(0, start - 2): start] in _TIME_OF_DAY)
            licensed = (prev == "第"                      # ordinal 第三 → 第3
                        or prev in _RANGE_NEXT            # 三到五: the 五 side
                        or prev in _PREV_UNIT             # 五块三: the 三 side
                        or unit_lic)
            if not licensed and text[end:end + 1] in _RANGE_NEXT:
                # 三到五天: the 三 side — license only when the other side
                # looks numeric (想到五月 must not turn 想到 into a range)
                after = text[end + 1: end + 2]
                licensed = after in _NUM_CHARS or after.isdigit()
            if not licensed:
                return s
        return str(n)

    text = _NUMBER_RE.sub(num, text)

    # 6) negatives: 负 directly before a converted number → minus sign
    text = re.sub(r"负(?=\d)", "-", text)
    return text
