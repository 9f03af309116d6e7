"""The device trace of a `--trace 1` run: `torch.profiler` over a steady
part of the measured window, reduced to the numbers the per-layer metrics
and the result line read.

- busy: the union of the intervals in which a kernel, copy or memset ran on
  the card, inside the traced span; idle = span − busy;
- kernels: device time and count by kernel name;
- idle gaps: the longest stretches with nothing on the card, each named by
  the innermost span of the benchmark's own (`portbench.*`, recorded around
  its calls into the program) that was open at the gap's middle.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def summarize(device: List[Tuple[str, float, float]],
              spans: List[Tuple[str, float, float]], window_s: float) -> Dict:
    """device: (kernel name, start, end) in µs; spans: the benchmark's
    (name, start, end); window_s: the traced span's wall time. → {busy_s,
    window_s, kernels {name: [count, seconds]}, device_ops, idle_gaps}: the
    gaps lie between the first and the last event the trace holds."""
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
    longest = [[f"{_gap_name(g, spans)} @ {(g[0] - t0) * 1e-3:.3f} ms",
                (g[1] - g[0]) * 1e-6] for g in gaps[:10]]
    ops = sorted(([n, v[1]] for n, v in kernels.items()),
                 key=lambda x: -x[1])[:10]
    return {"busy_s": sum(e - s for s, e in busy) * 1e-6,
            "window_s": window_s, "kernels": kernels, "device_ops": ops,
            "idle_gaps": longest}


def _gap_name(gap, spans) -> str:
    """The innermost benchmark span open at the gap's middle."""
    mid = 0.5 * (gap[0] + gap[1])
    open_ = [(b, n) for n, b, f in spans if b <= mid < f]
    return max(open_)[1] if open_ else "no benchmark span open"


class Tracer:
    """A profile over part of a window. `prepare()`, before the window,
    runs an empty profile once, so the profiler's first start in the
    process (CUPTI's set-up, seconds) falls outside the window; `begin
    (seconds)`, in the window, starts recording and `poll()` stops it
    `seconds` later. `span` marks the benchmark's calls while recording.
    The profile is reduced in `finish`, after the window; `overhead_s` is
    the window's time spent starting and stopping the profiler."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
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
        t = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.start()
        self.recording = True
        self.t0 = time.perf_counter()
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
        self.window_s = time.perf_counter() - self.t0
        self._prof.stop()
        self.recording, self.recorded = False, True
        self.overhead_s += time.perf_counter() - t

    def finish(self) -> None:
        """Reduce the profile (after the window)."""
        self.stop()
        if self._prof is not None:
            self.summary = self._reduce(self._prof, self.window_s)
        self._prof = None

    @staticmethod
    def _reduce(prof, window_s: float) -> Dict:
        device, spans = [], []
        for e in prof.events():
            tr = e.time_range
            if "CUDA" in str(getattr(e, "device_type", "")):
                if not getattr(e, "is_user_annotation", False):
                    device.append((e.name, tr.start, tr.end))
            elif e.name.startswith("portbench."):
                spans.append((e.name[len("portbench."):], tr.start, tr.end))
        return summarize(device, spans, window_s)
