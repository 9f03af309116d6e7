"""The comparisons that decide `correct`: what the timed path served against
the plain reference (`portbench/reference/`).

Every function returns numbers; the cell's traffic file holds the limit of
each one compared (`limits`), and a run is correct when no number exceeds
its limit. The others are printed beside them as diagnostics.

Served tokens are judged by the reference's own logits at their position:
the gap by which the served token's logit lies below the reference's best
(0 where the program chose the reference's argmax). The number of tokens is
CIF's, a step function of the integrated mass, so the served count is
judged by how far the reference's mass lies from the masses that give that
count (`count_gap`): a count off by rounding at a threshold reads about the
rounding, a dropped or extra token about a whole token. An utterance whose
count is off by more than `fragile` (a mass) makes `logit_gap` infinite;
one off by less is rounding at a threshold, and its tokens are not
compared.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence

import torch


def _count_gap(mass: float, n: int, lo_shift: float, cap: Optional[int] = None
               ) -> float:
    """Distance of `mass` from the masses whose count is n (count = floor of
    mass + lo_shift, capped at `cap`)."""
    lo = n - lo_shift
    hi = math.inf if cap is not None and n >= cap else n + 1 - lo_shift
    if lo <= mass < hi:
        return 0.0
    return lo - mass if mass < lo else mass - hi + 1e-9


def judge_offline(ref_rows, served: Sequence[Sequence[int]],
                  caps: Sequence[int], fragile: float) -> Dict[str, float]:
    """ref_rows: per row (logits [count, V] float64, csum with the tail
    frame, count) from `reference.paraformer.offline_logits`; served: the
    token ids the program returned per row; caps: the rows' token caps."""
    gap, count_gap, tokens, excused = 0.0, 0.0, 0, 0
    for (logits, csum, count), ids, cap in zip(ref_rows, served, caps):
        off = _count_gap(csum, len(ids), 0.0, cap)
        count_gap = max(count_gap, off)
        if len(ids) != count:
            excused += 1
            if off > fragile:
                gap = math.inf
            continue
        gap = max(gap, _token_gap([lg for lg in logits], ids))
        tokens += count
    return {"logit_gap": gap, "count_gap": count_gap, "tokens": tokens,
            "rows_off_by_rounding": excused}


def _token_gap(logits: Sequence[torch.Tensor], ids: Sequence[int]) -> float:
    """The widest gap by which a served id's logit lies below the best."""
    gap = 0.0
    for lg, t in zip(logits, ids):
        t = int(t)
        if not 0 <= t < lg.shape[0]:
            return math.inf
        gap = max(gap, float(lg.max() - lg[t]))
    return gap


def judge_online(ref_utts, served: Sequence[Sequence[int]], tail: float,
                 fragile: float) -> Dict[str, float]:
    """ref_utts: per utterance {"tokens": [(logits [V], chunk)], "masses":
    [CIF mass after each chunk]} from `reference.paraformer.OnlineSession`;
    served: the final ids the program returned.

    The streaming decode takes each chunk's fired tokens together, so a fire
    that rounding moves across a chunk boundary changes the logits of its
    chunk's tokens and of every later one. Tokens are compared up to the
    first fire whose mass lies within `fragile` of a chunk boundary in the
    reference (a fire that rounding could move); the count is judged from
    the final mass whatever the fires' chunks."""
    gap, count_gap, tokens, cut = 0.0, 0.0, 0, 0
    for utt, ids in zip(ref_utts, served):
        masses = utt["masses"]
        final = masses[-1]
        off = _count_gap(final, len(ids), tail)
        count_gap = max(count_gap, off)
        if off > fragile:
            gap = math.inf
        stop = len(utt["tokens"])
        for i, (_, chunk) in enumerate(utt["tokens"]):
            if chunk >= len(masses):           # the tail fire
                frac = final - math.floor(final)
                margin = abs(frac - (1.0 - tail))
            else:
                before = masses[chunk - 1] if chunk else 0.0
                margin = min(masses[chunk] - (i + 1), (i + 1) - before)
            if margin < fragile:
                first = max(chunk - 1, 0)
                stop = next(j for j, (_, c) in enumerate(utt["tokens"])
                            if c >= first)
                break
        n = min(stop, len(ids))
        cut += len(utt["tokens"]) - stop
        gap = max(gap, _token_gap([lg for lg, _ in utt["tokens"][:n]],
                                  ids[:n]))
        tokens += n
    return {"logit_gap": gap, "count_gap": count_gap, "tokens": tokens,
            "tokens_after_a_fragile_fire": cut}


def judge_partials(partials: Sequence[Sequence[str]],
                   finals: Sequence[str]) -> int:
    """How many partial texts of an utterance are not a prefix of its final
    text (partials only append)."""
    return sum(1 for ps, f in zip(partials, finals)
               for p in ps if not f.startswith(p))


def partials_behind(ref_utts, partials: Sequence[Sequence[Sequence[int]]],
                    frame: int, chunk: int, fragile: float) -> int:
    """How many partials hold fewer tokens than the reference fired by the
    chunks complete one frame earlier. partials: per utterance, the ids of
    the partial each frame's push returned; frame, chunk: their samples.

    The partial after frame k (0-based) is due every token of the chunk
    steps whose audio frames 0 … k−1 complete, t ≤ ⌊k·frame / chunk⌋ − 1:
    the served path may hold its newest step's results back one dispatch
    (the pipelined hub), and a step's fires need the chunk's lookahead,
    which the reference's step t already counts. A fire whose mass lies
    within `fragile` of the mass after step t may fall into step t + 1, so
    it is not yet due."""
    behind = 0
    for utt, ps in zip(ref_utts, partials):
        masses, toks = utt["masses"], utt["tokens"]
        for k, ids in enumerate(ps):
            t = k * frame // chunk - 1
            if t < 0:
                continue
            t = min(t, len(masses) - 1)
            due = sum(1 for i, (_, c) in enumerate(toks)
                      if c <= t and i + 1 <= masses[t] - fragile)
            behind += len(ids) < due
    return behind


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1]
                                                    + s[len(s) // 2])


def judge_training(prog: dict, ref: dict, still: float = 1e-3
                   ) -> Dict[str, float]:
    """prog, ref: {"losses": [3 floats], "grad": {leaf: first gradient},
    "change": {leaf: parameters after step 3 − before step 1}}.

    loss_gap: the largest relative gap of the three losses. grad_gap and
    change_gap: by the worst leaf, the gap between the program's norm and
    the reference's, over the larger of the reference's norm of that leaf
    and of the median leaf. Leaves whose reference gradient is under
    `still` of the median leaf's move under Adam by round-off alone and are
    left out of change_gap."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    loss_gap = max(gaps)
    gn = {k: float(torch.linalg.vector_norm(v.double()))
          for k, v in ref["grad"].items()}
    med_g = _median(list(gn.values()))
    grad_gap = max(abs(float(torch.linalg.vector_norm(prog["grad"][k].double()))
                       - gn[k]) / max(gn[k], med_g) for k in gn)
    moved = [k for k in gn if gn[k] >= still * med_g]
    cn = {k: float(torch.linalg.vector_norm(ref["change"][k].double()))
          for k in moved}
    med_c = _median(list(cn.values()))
    change_gap = max(abs(float(torch.linalg.vector_norm(
        prog["change"][k].double())) - cn[k]) / max(cn[k], med_c)
        for k in moved)
    names = sorted({re.sub(r"\.\d+\.", ".*.", k) for k in gn
                    if k not in moved})
    return {"loss_gap": loss_gap, "loss_gap_step1": gaps[0],
            "grad_gap": grad_gap,
            "change_gap": change_gap, "leaves_still": len(gn) - len(moved),
            "still": names}
