"""The device trace of a `--trace 1` run: `torch.profiler` over a steady
part of the measured window, reduced to the numbers the per-layer metrics
and the result line read.

- busy: the union of the intervals in which a kernel, copy or memset ran on
  the card, inside the traced span; idle = span − busy;
- kernels: device time and count by kernel name;
- idle gaps: the longest stretches with nothing on the card, each named by
  the innermost span of the benchmark's own (`portbench.*`, recorded around
  its calls into the program) that was open at the gap's middle, and by the
  program's span there where the program's spans were recorded;
- idle by span (with the program's spans): the card's idle time in the
  traced span split by the latest-opened span of the program open over it,
  on the threads that replay programs (every thread, where none does;
  `hub.queue`, a submission waiting for its tick, left out).
"""
from __future__ import annotations

import contextlib
import heapq
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

# a program span of (name, thread, start, end), in µs on the profile's timeline
ProgramSpan = Tuple[str, str, float, float]
REPLAY = "program.replay"   # a thread that opens it replays programs
WAITING = ("hub.queue",)    # a submission waiting for its tick
IDLE_TOP = 9                # named entries of `idle_by_span`, then (none)


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def summarize(device: List[Tuple[str, float, float]],
              spans: List[Tuple[str, float, float]], window_s: float,
              program: Optional[Sequence[ProgramSpan]] = None,
              traced: Optional[Tuple[float, float]] = None) -> Dict:
    """device: (kernel name, start, end) in µs; spans: the benchmark's
    (name, start, end); window_s: the traced span's wall time; program: the
    program's spans, where they were recorded, with `traced`, the traced
    span (start, end) on the same timeline. → {busy_s, window_s, kernels
    {name: [count, seconds]}, device_ops, idle_gaps, and with `program`
    idle_by_span}: the gaps lie between the first and the last event the
    trace holds."""
    kernels: Dict[str, List[float]] = {}
    for n, s, e in device:
        k = kernels.setdefault(n, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-6
    busy = _merge([(s, e) for _, s, e in device])
    ends = [t for _, s, e in device + spans for t in (s, e)]
    gaps = []
    if busy:
        prev = min(ends)
        for s, e in busy + [(max(ends), max(ends))]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    t0 = min(ends) if ends else 0.0
    replaying = _replaying(program or [])
    longest = [[f"{_gap_name(g, spans, replaying)} @ "
                f"{(g[0] - t0) * 1e-3:.3f} ms",
                (g[1] - g[0]) * 1e-6] for g in gaps[:10]]
    ops = sorted(([n, v[1]] for n, v in kernels.items()),
                 key=lambda x: -x[1])[:10]
    out = {"busy_s": sum(e - s for s, e in busy) * 1e-6,
           "window_s": window_s, "kernels": kernels, "device_ops": ops,
           "idle_gaps": longest}
    if program is not None:
        out["idle_by_span"] = idle_by_span(busy, replaying, *traced)
    return out


def _replaying(program: Sequence[ProgramSpan]) -> List[Tuple[float, float,
                                                             str]]:
    """(start, end, name) of the program's spans on the threads that
    replay programs (on every thread, where none does), without those that
    wait on the card's work."""
    threads = {t for n, t, _, _ in program if n == REPLAY} or \
        {t for _, t, _, _ in program}
    return sorted((s, e, n) for n, t, s, e in program
                  if t in threads and n not in WAITING)


def _gap_name(gap, spans, replaying) -> str:
    """The innermost benchmark span open at the gap's middle, and the
    latest-opened program span there."""
    mid = 0.5 * (gap[0] + gap[1])
    open_ = [(b, n) for n, b, f in spans if b <= mid < f]
    name = max(open_)[1] if open_ else "no benchmark span open"
    prog = [(b, n) for b, f, n in replaying if b <= mid < f]
    return f"{name} / {max(prog)[1]}" if prog else name


def idle_by_span(busy: List[Tuple[float, float]],
                 replaying: List[Tuple[float, float, str]], lo: float,
                 hi: float, top: int = IDLE_TOP) -> List[List]:
    """The idle time in [lo, hi) (µs; busy: the merged device intervals)
    by the latest-opened of the spans open over it (`_replaying`), in
    seconds, the most first: the `top` largest names, then "(none)", the
    idle time no span covers."""
    idle, prev = [], lo
    for s, e in busy:
        if s > prev:
            idle.append((prev, min(s, hi)))
        prev = max(prev, e)
        if prev >= hi:
            break
    if prev < hi:
        idle.append((prev, hi))
    # sweep over every boundary: +1 opens a span, −1 closes it, 0 / 2 an
    # idle stretch's end / start; at one time, the state in force is
    # settled before the stretch up to the next time is counted
    points = [(max(s, lo), 1, i) for i, (s, e, _) in enumerate(replaying)
              if e > lo and s < hi]
    points += [(min(e, hi), -1, i) for i, (s, e, _) in enumerate(replaying)
               if e > lo and s < hi]
    points += [(a, 2, -1) for a, b in idle if b > a]
    points += [(b, 0, -1) for a, b in idle if b > a]
    points.sort(key=lambda p: p[0])
    heap: List[Tuple[float, int]] = []   # (−start, −index) of open spans
    closed = set()
    by: Dict[str, float] = {}
    in_idle, t_prev = False, lo
    for t, kind, i in points:
        if in_idle and t > t_prev:
            while heap and -heap[0][1] in closed:
                heapq.heappop(heap)
            name = replaying[-heap[0][1]][2] if heap else "(none)"
            by[name] = by.get(name, 0.0) + (t - t_prev) * 1e-6
        t_prev = t
        if kind == 1:
            heapq.heappush(heap, (-replaying[i][0], -i))
        elif kind == -1:
            closed.add(i)
        else:
            in_idle = kind == 2
    none = by.pop("(none)", 0.0)
    named = sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])
    return named[:top] + [["(none)", none]]


class Tracer:
    """A profile over part of a window. `prepare()`, before the window,
    runs an empty profile once, so the profiler's first start in the
    process (CUPTI's set-up, seconds) falls outside the window; `begin
    (seconds)`, in the window, starts recording and `poll()` stops it
    `seconds` later. `span` marks the benchmark's calls while recording.
    `mark`, where given, is called as a profile begins and once it has
    stopped. The profile is reduced in `finish`, after the window, with the
    program's spans where they were recorded; `overhead_s` is the window's
    time spent starting and stopping the profiler."""

    def __init__(self, enabled: bool,
                 mark: Optional[Callable[[], None]] = None):
        self.enabled = enabled
        self.mark = mark
        self.recording = False
        self.recorded = False
        self.summary: Optional[Dict] = None
        self.overhead_s = 0.0
        self._prof = None

    @staticmethod
    def _activities():
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def span(self, name: str):
        if not self.recording:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"portbench.{name}")

    def prepare(self) -> float:
        """The profiler's first start and stop → their seconds."""
        if not self.enabled:
            return 0.0
        t = time.perf_counter()
        with torch.profiler.profile(activities=self._activities()):
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        return time.perf_counter() - t

    def begin(self, seconds: float) -> None:
        if not self.enabled or self.recording or self.recorded:
            return
        if self.mark is not None:
            self.mark()
        t = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.start()
        self.recording = True
        self.t0_ns = time.perf_counter_ns()
        self.t0 = self.t0_ns * 1e-9
        self.until = self.t0 + seconds
        self.overhead_s += self.t0 - t

    def poll(self) -> None:
        if self.recording and time.perf_counter() >= self.until:
            self.stop()

    def stop(self) -> None:
        if not self.recording:
            return
        t = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1_ns = time.perf_counter_ns()
        self.window_s = (self.t1_ns - self.t0_ns) * 1e-9
        self._prof.stop()
        self.recording, self.recorded = False, True
        self.overhead_s += time.perf_counter() - t
        if self.mark is not None:
            self.mark()

    def finish(self, program: Optional[List[Dict]] = None) -> None:
        """Reduce the profile (after the window); `program`: the program's
        span records (`runtime/profiling.py::drain`), where recorded."""
        self.stop()
        if self._prof is not None:
            self.summary = self._reduce(self._prof, program)
        self._prof = None

    def _reduce(self, prof, program: Optional[List[Dict]]) -> Dict:
        device, spans = [], []
        for e in prof.events():
            tr = e.time_range
            if "CUDA" in str(getattr(e, "device_type", "")):
                if not getattr(e, "is_user_annotation", False):
                    device.append((e.name, tr.start, tr.end))
            elif e.name.startswith("portbench."):
                spans.append((e.name[len("portbench."):], tr.start, tr.end))
        if program is None:
            return summarize(device, spans, self.window_s)
        from toolbox_for_asr_and_tts_tpu_torch.runtime import profiling
        off = profiling.profile_offset_ns(prof)
        lo, hi = (self.t0_ns + off) / 1e3, (self.t1_ns + off) / 1e3
        mapped = [(r["name"], r["thread"], (r["start_ns"] + off) / 1e3,
                   (r["end_ns"] + off) / 1e3) for r in program
                  if r["end_ns"] > self.t0_ns and r["start_ns"] < self.t1_ns]
        return summarize(device, spans, self.window_s, mapped, (lo, hi))
