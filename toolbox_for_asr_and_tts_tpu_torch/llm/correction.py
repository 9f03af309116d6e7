"""LLM post-correction client for medical-ASR text.

Copy of `toolbox_for_asr_and_tts_tpu/llm/correction.py` for the port
(framework-free; imports kept relative).

Port of the reference's `LLM_functions.py` (the module deployed as
`hg_deepseek`, survey §0): an OpenAI-compatible chat call that minimally
edits ASR text using a hotword list, with the same operating budget —
temperature 0, top_p 1, seed 42, max_tokens 840, JSON mode, thinking
disabled, 3 retries with 0.8 s-base exponential backoff, 60 s timeout,
HTTP/1.1 forced (LLM_functions.py:184-262).

The full 9-rule protocol (LLM_functions.py:70-113) is carried, reworded but
rule-for-rule equivalent:
 1. minimal edit
 2. symptom-category conservation
 3. hotword priority for homophone fixes
 4. hotword weight semantics — lines may be "word weight"; positive weight
    breaks ties, negative weight marks the word BANNED from output, and
    weight digits must never leak into `corrected`
 5. ordinary conservative correction only when no hotword fits
 6. semantic conservation details: body-part conservation (no invented
    anatomy, chest/respiratory context stays chest), bleeding-type
    conservation (咯血 vs 呕血/黑便/血便 decided by context only)
 7. pain-phrase disambiguation — classify X痛 as body-part (A) vs
    pain-quality (B) from local structure only; prefer the
    pinyin-closest, least-information-adding candidate; fall back to
    neutral 疼痛/不适 when undecidable
 8. strip obviously broken punctuation, no literary rewriting
 9. xiaohu-homophone coercion: 小户/小虎/小胡 → 小护, deduplicated
Output contract: {"corrected": ..., "changed": true|false}.

Beyond the prompt, the client-side layers the reference has are ported:
robust JSON extraction (LLM_functions.py:151-181), regex fallback parsing
(:303-366), matches validation/normalization against the provided options
(:380-451 — unvalidated model matches are dropped, not trusted), the
context-bearing `process_with_context` entry (:380), and the public
surface the reference imports: `correct_text_only` (:505),
`process_speech_result` (:571 — returns the `(match_string, corrected)`
tuple), `load_hotwords_list` (:454).

This build adds one guard the reference lacks: a banned word (negative
weight) that the model *introduces* into `corrected` rejects the
correction client-side, so rule 4's ban holds even against a misbehaving
model. Endpoint/model/key come from env (LLM_BASE_URL, LLM_MODEL,
LLM_API_KEY — no checked-in keys, unlike the reference). Without an
endpoint configured, correction is a transparent no-op so the service
degrades gracefully.
"""
from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger("toolbox.llm")

PROMPT_HEADER = (
    "请在 n o t h i n k 模式下工作：不要输出任何推理、解释或多余文字，只输出最终 JSON。\n"
    "你是医院预问诊与院内流程/导航场景的中文 ASR 纠错助手。\n\n"
    "唯一目标：对输入的 ASR 文本做最小必要纠错，让它在医院问询场景下清晰可懂。"
    "核心是同音/近音误识别，并优先用【热词列表】里的词来纠正。\n\n"
    "硬规则（必须全部遵守）：\n"
    "1) 最小编辑：只替换明显错误的片段，保留原句结构与信息量，禁止整句改写。\n"
    "2) 症状类别守恒：不得为了命中热词而把一种症状/事件改成另一种；"
    "出血相关词必须依据上下文在咯血/呕血/黑便/血便等之间判断，不能随意互换。\n"
    "3) 热词最高优先：疑似同音误识别处，若热词列表里有读音相近且语义更合理的候选，优先换成该热词。\n"
    "4) 热词权重：列表行可能是“词语 权重”的形式。权重为正，数值越大候选冲突时越优先；"
    "权重为负，该词是禁止词，绝不能出现在 corrected 里；corrected 中也不得出现权重数字本身。\n"
    "5) 热词里没有合理候选时才做常规纠错，且仍受最小编辑与类别守恒约束。\n"
    "6) 语义守恒细则：\n"
    "   - 部位守恒：原句或邻句含“胸/前胸/胸闷/胸痛/咳嗽/呼吸困难”等线索时，纠错结果保持胸部/呼吸系统表达；"
    "除非原句明确出现“腹/肚子/胃/拉肚子/排便/恶心呕吐”等线索，禁止把疼痛改成“腹痛”。\n"
    "   - 解剖部位守恒：原句没有出现的身体部位词（脚/腿/手/背/腰等）不得在纠错后新增；"
    "描述疼痛优先用性质词（绞痛/刺痛/闷痛/压榨痛），不要添加部位词。\n"
    "   - 出血类型守恒：出血片段邻近“咳嗽/咳痰/胸部不适”时优先纠为“咯血/咳血”；"
    "邻近“呕吐/胃/排便/黑便/血便”时才可纠为“呕血/黑便/血便”；无法确定时保留原片段。\n"
    "7) “X痛”类短语必须先消歧：判断 X 是部位类（脚痛/腹痛/胸痛/耳痛/关节痛…）"
    "还是性质类（绞痛/刺痛/闷痛/胀痛/压榨样疼痛…），只依据局部结构和原句线索，不得凭空猜测：\n"
    "   - 原句已有明确部位词且同指一处疼痛时输出部位类；\n"
    "   - 原句有“针刺样/闷胀/压榨样/烧灼样”等性质描述、或该片段描述感觉性质时输出性质类；\n"
    "   - 同音候选（如 脚痛/绞痛）都合理时，选与原句整体一致、新增信息更少、拼音更接近的那个；\n"
    "   - 仍不能可靠判断时用中性的“疼痛/痛感/不适”，不要强选具体词。\n"
    "8) 清除明显异常的标点（句首孤立标点、重复逗号等），但不要润色。\n"
    "9) 强制：凡 xiaohu 读音的词（小户、小虎、小胡等）一律改为“小护”，"
    "且重复出现时 corrected 里只保留一次“小护小护”式的最后一组。\n\n"
    "输出必须是严格 JSON（只输出 JSON，不要代码块）：\n"
    "{\n"
    "  \"corrected\": \"...\",\n"
    "  \"changed\": true_or_false\n"
    "}\n"
)

MAX_TOKENS = 840        # LLM_functions.py:208
TEMPERATURE = 0.0
TOP_P = 1.0
SEED = 42
RETRIES = 3
RETRY_BASE_DELAY = 0.8  # LLM_functions.py:184-198
TIMEOUT_S = 60.0


def build_prompt(context: Optional[List[Dict[str, str]]],
                 options: Sequence[str], original: str) -> str:
    """Reference `build_prompt` (LLM_functions.py:116-133): header, then
    role-prefixed context lines, dash-bulleted options, quoted original."""
    ctx_text = "\n".join(
        f"{m.get('role', '')}: {m.get('content', '')}" for m in (context or []))
    options_text = "\n".join(f"- {opt}" for opt in options)
    return (PROMPT_HEADER
            + "上下文（近对话历史）：\n" + ctx_text
            + "\n\n当前可选项：\n" + options_text
            + "\n\n请修正的原句：\n" + f"'{original}'\n")


def _extract_json(text: str) -> Optional[Any]:
    """Robust JSON extraction (LLM_functions.py:151-181): direct parse,
    ```json fenced block, fence-stripped, then the outermost {...} blob."""
    if not text:
        return None
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    m = re.search(r"```json\s*(.*?)\s*```", text, re.S | re.I)
    if m:
        try:
            return json.loads(m.group(1))
        except json.JSONDecodeError:
            pass
    stripped = re.sub(r"```json|```", "", text).strip()
    if stripped and stripped != text:
        try:
            return json.loads(stripped)
        except json.JSONDecodeError:
            pass
    m2 = re.search(r"\{[\s\S]*\}", text)
    if m2:
        try:
            return json.loads(m2.group(0))
        except json.JSONDecodeError:
            pass
    return None


def _extract_via_regex(raw: str):
    """Last-ditch field scrape from non-JSON model text
    (LLM_functions.py:303-330): pull `corrected` and the `matches` array
    with regexes so a truncated/fenced reply still yields a result."""
    corrected = None
    matches: List[str] = []
    m = re.search(r'"corrected"\s*:\s*"((?:\\.|[^"\\])*)"', raw, re.S)
    if m:
        corrected = _unescape_json_fragment(m.group(1))
    m2 = re.search(r'"matches"\s*:\s*\[\s*([\s\S]*?)\s*\]', raw, re.S)
    if m2:
        for it in re.findall(r'"((?:\\.|[^"\\])*)"', m2.group(1)):
            matches.append(_unescape_json_fragment(it))
    return corrected, matches


def _unescape_json_fragment(val: str) -> str:
    """Decode the body of a scraped JSON string literal. json.loads on the
    re-quoted fragment handles \\n/\\uXXXX correctly for non-ASCII text;
    `unicode_escape` would decode the UTF-8 bytes as Latin-1 and turn
    Chinese into mojibake."""
    if "\\" not in val:
        return val
    try:
        return json.loads(f'"{val}"')
    except json.JSONDecodeError:
        return val


def parse_model_output(raw: str, original: str = "") -> Dict[str, Any]:
    """Reference `parse_model_output` (LLM_functions.py:333-377): JSON
    first, regex scrape second, structured failure third."""
    raw = (raw or "").strip()
    data = _extract_json(raw)   # direct / ```json fenced / outermost {...}
    if isinstance(data, dict):
        matches = data.get("matches", [])
        return {
            "success": True,
            "corrected": data.get("corrected", original),
            "changed": data.get("changed"),
            "matches": matches,
            "has_match": bool(matches),
            "raw": raw,
            "matched_via": "model",
            "error": None,
        }
    corr, matches = _extract_via_regex(raw)
    if corr is not None or matches:
        return {
            "success": True,
            "corrected": corr or original,
            "changed": None,
            "matches": matches or [],
            "has_match": bool(matches),
            "raw": raw,
            "matched_via": "regex",
            "error": "parsed_via_regex",
        }
    return {
        "success": False,
        "corrected": original,
        "changed": None,
        "matches": [],
        "has_match": False,
        "raw": raw,
        "matched_via": "none",
        "error": "invalid json from model",
    }


def normalize_str_for_match(s: str) -> str:
    """Whitespace-stripped, lowercased (LLM_functions.py:372-377)."""
    if not isinstance(s, str):
        return ""
    return re.sub(r"\s+", "", s).lower()


def validate_matches(matches: Sequence[Any], options: Sequence[str]
                     ) -> List[str]:
    """Reference match validation (LLM_functions.py:415-433): a model match
    survives only if it IS an option or normalized-substring-overlaps one;
    survivors map to the canonical option's WORD (weights stripped — the
    options may be "word weight" lines from load_hotword_options, and rule
    4 forbids weight digits surfacing), deduplicated in order. Model output
    is never trusted verbatim."""
    validated: List[str] = []
    seen = set()
    for m in matches:
        if not isinstance(m, str):
            continue
        if m in options:
            cand: Optional[str] = m
        else:
            nm = normalize_str_for_match(m)
            cand = next(
                (o for o in options
                 if nm and (nm in normalize_str_for_match(o)
                            or normalize_str_for_match(o) in nm)), None)
        if cand:
            word = _parse_weighted(cand)[0]
            if word not in seen:
                seen.add(word)
                validated.append(word)
    return validated


def _parse_weighted(option: str):
    """Split a "word weight" option line; weight None when absent
    (same trailing-int rule as the reference's hotword parser)."""
    if " " in option:
        word, _, tail = option.rpartition(" ")
        try:
            return word.strip(), int(tail.strip())
        except ValueError:
            pass
    return option.strip(), None


def banned_words_from_options(options: Sequence[str]) -> List[str]:
    """Negative-weight words in the option lines (prompt rule 4's ban list,
    enforced client-side as well)."""
    out = []
    for opt in options:
        word, weight = _parse_weighted(opt)
        if weight is not None and weight < 0 and word:
            out.append(word)
    return out


class LLMCorrector:
    def __init__(self, base_url: Optional[str] = None,
                 model: Optional[str] = None,
                 api_key: Optional[str] = None):
        self.base_url = base_url or os.getenv("LLM_BASE_URL", "")
        self.model = model or os.getenv("LLM_MODEL", "qwen3-32b")
        self.api_key = api_key or os.getenv("LLM_API_KEY", "")

    @property
    def enabled(self) -> bool:
        return bool(self.base_url)

    def _call(self, messages: list) -> Optional[str]:
        import httpx
        url = self.base_url.rstrip("/") + "/chat/completions"
        payload = {
            "model": self.model,
            "messages": messages,
            "stream": False,
            "temperature": TEMPERATURE,
            "top_p": TOP_P,
            "seed": SEED,
            "max_tokens": MAX_TOKENS,
            "response_format": {"type": "json_object"},
            # reference extra_body (LLM_functions.py:247): Qwen3 reasoning off
            "enable_thinking": False,
        }
        headers = {"Content-Type": "application/json"}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        for attempt in range(RETRIES):
            try:
                # HTTP/1.1 forced, as the reference does (LLM_functions.py:201-211)
                with httpx.Client(http1=True, http2=False,
                                  timeout=TIMEOUT_S) as client:
                    r = client.post(url, json=payload, headers=headers)
                    r.raise_for_status()
                    content = r.json()["choices"][0]["message"]["content"]
                    if not (content or "").strip():
                        raise ValueError("empty LLM response")
                    return content
            except Exception as e:
                logger.warning("LLM call failed (attempt %d/%d): %s",
                               attempt + 1, RETRIES, e)
                if attempt + 1 < RETRIES:
                    time.sleep(RETRY_BASE_DELAY * (2 ** attempt))
        return None

    def process_with_context(self, context: Optional[List[Dict[str, str]]],
                             options: Sequence[str], text: str
                             ) -> Dict[str, Any]:
        """Reference `process_with_context` (LLM_functions.py:380-451):
        prompt → model → parse → validate matches. Pure model + client
        validation; no heuristic fallback."""
        original = (text or "").strip()
        if not original:
            return {"success": False, "corrected": "", "matches": [],
                    "has_match": False, "matched_via": "none", "raw": "",
                    "error": "empty input"}
        if not self.enabled:
            return {"success": False, "corrected": original, "matches": [],
                    "has_match": False, "matched_via": "none", "raw": "",
                    "error": "llm disabled"}
        prompt = (build_prompt(context, options, original)
                  + "\n\n请直接输出JSON格式，不要包含任何思考过程或解释。/nothink")
        raw = self._call([{"role": "user", "content": prompt}]) or ""
        parsed = parse_model_output(raw, original=original)
        if parsed.get("success") and parsed.get("matches"):
            validated = validate_matches(parsed["matches"], list(options))
            parsed["matches"] = validated
            parsed["has_match"] = bool(validated)
            if not validated:
                # model offered matches but none validated → report, don't trust
                parsed["error"] = "model_matches_not_validated"
        return parsed

    def correct_text_only(self, hotwords: Sequence[str], text: str,
                          context: Optional[List[Dict[str, str]]] = None
                          ) -> str:
        """Minimal-edit correction; returns input on any failure
        (LLM_functions.py:505-535)."""
        if not text or not self.enabled:
            return text
        parsed = self.process_with_context(context, list(hotwords), text)
        corrected = parsed.get("corrected")
        if not corrected or not isinstance(corrected, str):
            return text
        # semantic-conservation guard: reject wildly different outputs
        if abs(len(corrected) - len(text)) > max(8, len(text) // 2):
            logger.warning("LLM correction rejected (length drift): %r",
                           corrected)
            return text
        # rule-4 ban enforced client-side: a banned word the model
        # INTRODUCED invalidates the whole correction
        for banned in banned_words_from_options(hotwords):
            if banned in corrected and banned not in text:
                logger.warning("LLM correction rejected (banned word %r): %r",
                               banned, corrected)
                return text
        return corrected


_default = LLMCorrector()


def process_with_context(context: Optional[List[Dict[str, str]]],
                         options: Sequence[str], text: str) -> Dict[str, Any]:
    """Module-level entry matching the reference's (LLM_functions.py:380)."""
    return _default.process_with_context(context, options, text)


def correct_text_only(latest_context=None, latest_options: Sequence[str] = (),
                      text: str = "", DEBUG: bool = False) -> str:
    """Signature-compatible with the reference's import sites
    (voice.py:831-836; LLM_functions.py:505-535). Empty text → ""."""
    del DEBUG
    if not text or not str(text).strip():
        return ""
    return _default.correct_text_only(list(latest_options), text,
                                      context=latest_context)


def process_speech_result(latest_context=None,
                          latest_options: Sequence[str] = (),
                          text: str = "", useQwen=None, DEBUG: bool = False):
    """Reference `process_speech_result` (LLM_functions.py:571-626):
    correction + validated intent matches, returned as the
    `(match_string, corrected_text)` tuple with the `", "`-joined match
    string. Empty input → ("", "")."""
    del useQwen, DEBUG
    if not text or not str(text).strip():
        return "", ""
    parsed = _default.process_with_context(latest_context,
                                           list(latest_options), text)
    corrected = parsed.get("corrected") or text
    match_string = '", "'.join(parsed.get("matches") or [])
    return match_string, corrected


def load_hotwords_list(path: Optional[str] = None) -> List[str]:
    """Reference `load_hotwords_list` (LLM_functions.py:454-502): bare
    positive hotwords (weights stripped). Resolution: explicit path →
    HOTWORDS_FILE env → packaged assets/hotwords.txt → SYMS."""
    from ..asr.hotwords import load_hotwords_from_file, positive_hotword_list
    for p in _hotword_paths(path):
        if p and os.path.exists(p):
            words = positive_hotword_list(load_hotwords_from_file(p))
            if words:
                return words
    from .syms import SYMS
    return list(SYMS)


def load_hotword_options(path: Optional[str] = None) -> List[str]:
    """Weighted "word weight" option lines for the prompt, so rule 4 has
    data to act on: positive weights break ties, negative weights mark
    banned words. Falls back to the bare SYMS list."""
    from ..asr.hotwords import load_hotwords_from_file
    for p in _hotword_paths(path):
        if p and os.path.exists(p):
            weighted = load_hotwords_from_file(p)
            if weighted:
                return [f"{w} {weight}" for w, weight in weighted.items()]
    from .syms import SYMS
    return list(SYMS)


def _hotword_paths(path: Optional[str]) -> List[Optional[str]]:
    return [path, os.getenv("HOTWORDS_FILE"),
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "assets", "hotwords.txt")]
