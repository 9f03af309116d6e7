"""WER/CER and transcript parity utilities (port of
`toolbox_for_asr_and_tts_tpu/tools/wer.py`; framework-free).

Character error rate (the standard metric for Mandarin ASR), word units
for latin runs, and a parity harness that scores this package's
transcripts against golden files:

    python -m toolbox_for_asr_and_tts_tpu_torch.tools.wer \
        --golden golden.jsonl [--hyp hyp.jsonl | --model-dir dir] \
        [--device cpu]

golden.jsonl lines: {"wav": "path.wav", "text": "reference transcript"}.
Without --hyp, the port's engines (`service.engines.build_engines`, on the
card unless --device cpu) transcribe each wav through the diarizer.
"""
from __future__ import annotations

import argparse
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, Dict[str, int]]:
    """Levenshtein with operation counts (S/D/I)."""
    n, m = len(ref), len(hyp)
    # dp over (cost, subs, dels, ins)
    prev = [(j, 0, 0, j) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0)] + [None] * m
        for j in range(1, m + 1):
            if ref[i - 1] == hyp[j - 1]:
                cur[j] = prev[j - 1]
            else:
                sub = prev[j - 1]
                dele = prev[j]
                ins = cur[j - 1]
                cur[j] = min(
                    (sub[0] + 1, sub[1] + 1, sub[2], sub[3]),
                    (dele[0] + 1, dele[1], dele[2] + 1, dele[3]),
                    (ins[0] + 1, ins[1], ins[2], ins[3] + 1),
                )
        prev = cur
    cost, s, d, i_ = prev[m]
    return cost, {"sub": s, "del": d, "ins": i_}


_PUNCT = re.compile(r"[，。！？、；：\s,.!?;:\"'（）()]+")


def normalize_zh(text: str) -> List[str]:
    """Strip punctuation; CJK → chars, latin runs → words (CER units)."""
    text = _PUNCT.sub(" ", text or "")
    units: List[str] = []
    buf = ""
    for ch in text:
        if ch.isascii() and ch.isalnum():
            buf += ch.lower()
        else:
            if buf:
                units.append(buf)
                buf = ""
            if not ch.isspace():
                units.append(ch)
    if buf:
        units.append(buf)
    return units


def cer(ref: str, hyp: str) -> float:
    r, h = normalize_zh(ref), normalize_zh(hyp)
    if not r:
        return 0.0 if not h else 1.0
    dist, _ = edit_distance(r, h)
    return dist / len(r)


def corpus_cer(pairs: Sequence[Tuple[str, str]]) -> Dict[str, float]:
    total_units = 0
    total_err = 0
    exact = 0
    for ref, hyp in pairs:
        r, h = normalize_zh(ref), normalize_zh(hyp)
        dist, _ = edit_distance(r, h)
        total_units += max(len(r), 1)
        total_err += dist
        exact += int(r == h)
    return {
        "cer": total_err / max(total_units, 1),
        "exact_match": exact / max(len(pairs), 1),
        "n": len(pairs),
    }


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--golden", required=True)
    ap.add_argument("--hyp")
    ap.add_argument("--model-dir")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    with open(args.golden, encoding="utf-8") as f:
        golden = [json.loads(line) for line in f if line.strip()]
    if args.hyp:
        with open(args.hyp, encoding="utf-8") as f:
            hyps = {row["wav"]: row["text"]
                    for row in (json.loads(line) for line in f
                                if line.strip())}
    else:
        from ..service.engines import build_engines
        from ..utils.audio import ensure_mono_16k, read_wav
        engines = build_engines(args.model_dir, device=args.device)
        try:
            hyps = {}
            for item in golden:
                x, sr = read_wav(item["wav"])
                sents = engines.diarizer.diarize(ensure_mono_16k(x, sr))
                hyps[item["wav"]] = "".join(s.text for s in sents)
        finally:
            engines.close()
    stats = corpus_cer([(item["text"], hyps.get(item["wav"], ""))
                        for item in golden])
    print(json.dumps(stats, ensure_ascii=False))
    return stats


if __name__ == "__main__":
    main()
