"""The comparisons that decide `correct` in the TTS cells: the jobs' WAVs the
timed path served against the plain reference's
(`portbench/reference/sambert_hifigan.py`), and the service's grouping of a
job's segments into device calls, rebuilt from what it served.

Numbers (the cell's traffic file holds the limit of each compared one):
- `dur_changed`: segments whose served mel length differs from the
  reference's sum of durations, among those that are not fragile;
- `pcm_gap_lsb`: the widest difference, in 16-bit steps, between the served
  WAV and the reference's WAV of the same text, over the samples of the
  segments compared (every segment but the fragile ones, and the silence
  between them); infinite where a segment's length changed.

A segment is fragile when one of its phones' durations before rounding,
exp(d) − 1, lies within `fragile` of a rounding boundary k + 0.5 that the
clip to [1, max_duration] keeps: float32 round-off may round it either way.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


def mel_lengths(seg_durations_s: Sequence[float], sample_rate: int,
                hop: int) -> List[int]:
    """The served segments' mel lengths from the job's per-segment
    durations (each a whole number of hops)."""
    return [int(round(d * sample_rate / hop)) for d in seg_durations_s]


def plan(phones: Sequence[int], mel_lens: Sequence[int],
         buckets: Sequence[int], knobs: Dict) -> List[Dict]:
    """The device calls of one streamed job, as `Synthesizer.
    synthesize_stream` makes them: the first segment alone, then batches of
    `batch_size`; in each batch one group per phone bucket (or one at the
    longest row's bucket), a duration probe, then one synthesis per mel
    group at the largest of its rows' mel lengths rounded up to
    `mel_bucket` frames, at least one bucket and at most the phone bucket
    times `frames_per_phone`. The rows' mel lengths are the served ones, so
    each call's mel length is the one the program used. → [{"kind":
    "probe" | "synth", "l", "t_mel" (synth), "segments": [indices], and
    "phones" (probe) or "rows": [[phones, mel length]] (synth)}]."""
    def bucket(n):
        return next((b for b in sorted(buckets) if b >= n), max(buckets))

    bs = max(1, knobs["batch_size"])
    n = len(phones)
    batches = [[0]] + [list(range(i, min(i + bs, n))) for i in range(1, n, bs)]
    calls = []
    for batch in batches:
        groups: Dict[int, List[int]] = {}
        if knobs["group_by_length"]:
            for j in batch:
                groups.setdefault(bucket(max(phones[j], 1)), []).append(j)
        else:
            groups[bucket(max(max(phones[j] for j in batch), 1))] = batch
        for l, rows in sorted(groups.items()):
            calls.append({"kind": "probe", "l": l, "segments": rows,
                          "phones": [phones[j] for j in rows]})
            mb, cap = knobs["mel_bucket"], l * knobs["frames_per_phone"]
            t_row = {j: max(min(-(-mel_lens[j] // mb) * mb, cap), mb)
                     for j in rows}
            mel_groups: Dict[int, List[int]] = {}
            if knobs["mel_group"]:
                for j in rows:
                    mel_groups.setdefault(t_row[j], []).append(j)
            else:
                mel_groups[max(t_row.values())] = rows
            for t_mel, segs in sorted(mel_groups.items()):
                calls.append({"kind": "synth", "l": l, "t_mel": t_mel,
                              "segments": segs,
                              "rows": [[phones[j], mel_lens[j]]
                                       for j in segs]})
    return calls


def fragile(before, margin: float, max_duration: int) -> bool:
    """Whether a duration before rounding lies within `margin` of a
    boundary k + 0.5, 1 ≤ k < max_duration."""
    v = np.asarray(before, np.float64)
    k = np.clip(np.floor(v), 1, max_duration - 1)
    return bool(np.any(np.abs(v - (k + 0.5)) < margin))


def judge_job(served: np.ndarray, served_lens: Sequence[int],
              ref_segments: Sequence[Dict], pauses_ms: Sequence[int],
              hop: int, sample_rate: int, crossfade_ms: int, margin: float,
              max_duration: int, assemble, to_pcm16) -> Dict[str, float]:
    """served: the job's int16 WAV samples; served_lens: its segments' mel
    lengths; ref_segments: the reference's {"pcm", "mel_len",
    "before_rounding"} per segment. The reference's WAV is assembled from
    its segments, each fragile one replaced by silence of its served
    length, and compared with the served WAV outside the fragile ones.
    Where a segment's length changed, `pcm_gap_lsb` is infinite, and
    `pcm_gap_lsb_same_lengths` compares the other segments (each changed
    one replaced by silence too)."""
    fragile_segs, changed_segs, pieces = [], [], []
    for i, (n, r) in enumerate(zip(served_lens, ref_segments)):
        if fragile(r["before_rounding"], margin, max_duration):
            fragile_segs.append(i)
        elif r["mel_len"] != n:
            changed_segs.append(i)
        else:
            pieces.append(r["pcm"].astype(np.float32) / 32767.0)
            continue
        pieces.append(np.zeros(n * hop, np.float32))
    out = {"dur_changed": len(changed_segs),
           "fragile_segments": len(fragile_segs)}
    want = to_pcm16(assemble(pieces, pauses_ms, sample_rate, crossfade_ms))
    if len(want) != len(served):
        return dict(out, pcm_gap_lsb=math.inf,
                    pcm_gap_lsb_same_lengths=math.inf)
    keep = np.ones(len(served), bool)
    for i, (a, b) in enumerate(_spans(served_lens, pauses_ms, hop,
                                      sample_rate, crossfade_ms)):
        if i in fragile_segs or i in changed_segs:
            keep[a:b] = False
    gap = np.abs(served.astype(np.int32) - want.astype(np.int32))[keep]
    gap = float(gap.max()) if gap.size else 0.0
    return dict(out, pcm_gap_lsb=math.inf if changed_segs else gap,
                pcm_gap_lsb_same_lengths=gap)


def _spans(lens: Sequence[int], pauses_ms: Sequence[int], hop: int,
           sample_rate: int, crossfade_ms: int):
    """[start, end) of each segment in the job's WAV, as `assemble` lays
    them out."""
    fade = int(sample_rate * crossfade_ms / 1000)
    out, at = [], 0
    for i, n in enumerate(lens):
        n *= hop
        if i:
            pause = int(sample_rate * pauses_ms[i - 1] / 1000) \
                if i - 1 < len(pauses_ms) else 0
            at += pause
            if fade > 0 and at >= fade and n >= fade:
                at -= fade
        out.append((at, at + n))
        at += n
    return out
