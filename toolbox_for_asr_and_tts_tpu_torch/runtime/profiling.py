"""Profiling: `torch.profiler` traces and the program's own spans, the port
of `toolbox_for_asr_and_tts_tpu/runtime/profiling.py`.

    with trace_to("/tmp/tb"):         # host and card trace (Chrome format)
        reco.transcribe(wavs)

    with annotate("finalize"):        # a span of the program
        ...

Spans are off by default: `annotate` then checks one module flag and
returns a shared no-op context, recording and allocating nothing.
`set_recording(True)` turns them on: each span that ends appends a record
to a bounded buffer (past `capacity` records it counts them as dropped),
and `drain()` takes the records. A record holds the span's name, its id,
the id of the span open around it on its thread (`parent`), the request it
belongs to (a root span's own id, which its children inherit), the thread
that opened it, its start and end in `time.perf_counter_ns()` (the clock of
the service's histograms), and `cause`: the id of the span, on another
thread, that ended it. `begin(name)` and `end(span, cause=)` make a span
whose end comes from elsewhere, such as a hub submission ended by the tick
that carries it.

`profile_offset_ns(prof)` maps that clock onto a `torch.profiler`
profile's timeline through the profile's start on the wall clock: a
record's time t lies at (t + offset) / 1e3 µs, the unit of
`FunctionEvent.time_range`. The spans are not `record_function` regions,
since the profiler records those only on threads that exist when it
starts, and a serving hub's tick thread starts before any profile.

`trace_to` records CPU activity, and the card's kernels and copies when
the device is a card, records spans for its block, and writes one
Chrome-trace JSON file into the directory, the spans on threads of their
own (open it in Perfetto or chrome://tracing).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device

logger = logging.getLogger("toolbox.profiling")

MEMORY_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")
CAPACITY = 1 << 18          # records held between drains
_SPAN_TID = 1 << 30         # trace_to's thread ids for the spans' threads

_ON = False
_capacity = CAPACITY
_records: List["_Span"] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> List["_Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One span, open from its construction; as a context it is also the
    innermost open span of its thread for its block."""

    __slots__ = ("name", "id", "parent", "request", "thread", "start", "end",
                 "cause")

    def __init__(self, name: str):
        stack = _stack()
        top = stack[-1] if stack else None
        self.name = name
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        self.request = top.request if top is not None else self.id
        self.thread = threading.current_thread().name
        self.cause: Optional[int] = None
        self.end: Optional[int] = None
        self.start = time.perf_counter_ns()

    def __enter__(self) -> "_Span":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        _close(self)
        return False

    def as_dict(self) -> Dict:
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request, "cause": self.cause,
                "thread": self.thread, "start_ns": self.start,
                "end_ns": self.end}


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _close(span: _Span) -> None:
    global _dropped
    span.end = time.perf_counter_ns()
    if not _ON:
        return
    with _lock:
        if len(_records) < _capacity:
            _records.append(span)
        else:
            _dropped += 1


def annotate(name: str):
    """A span of the program over the `with` block; `as` gives the span
    (None while recording is off)."""
    if not _ON:
        return _OFF
    return _Span(name)


def begin(name: str) -> Optional[_Span]:
    """Open a span that `end` closes, on this thread or another (None
    while recording is off). It is not the thread's innermost span."""
    if not _ON:
        return None
    return _Span(name)


def end(span: Optional[_Span], cause: Optional[_Span] = None) -> None:
    """Close a span from `begin` once; `cause`, the span that ended it."""
    if span is None or span.end is not None:
        return
    if cause is not None:
        span.cause = cause.id
    _close(span)


def set_recording(on: bool, capacity: int = CAPACITY) -> None:
    """Turn span recording on or off; the buffer holds `capacity` records
    until the next `drain`."""
    global _ON, _capacity
    _capacity = int(capacity)
    _ON = bool(on)


def drain() -> Tuple[List[Dict], int]:
    """Take the records (in the order their spans ended) and the count of
    those dropped since the last drain."""
    global _records, _dropped
    with _lock:
        taken, dropped = _records, _dropped
        _records, _dropped = [], 0
    return [s.as_dict() for s in taken], dropped


def _epoch_offset_ns() -> int:
    """time.time_ns() − time.perf_counter_ns(), from the tightest of a few
    paired readings."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, wall - (a + b) // 2)
    return best[1]


def profile_offset_ns(prof) -> int:
    """The offset that puts a record's `start_ns` / `end_ns` on `prof`'s
    timeline (a stopped `torch.profiler.profile`): (t + offset) / 1e3 is
    in the µs of its events' `time_range`."""
    return _epoch_offset_ns() - prof.profiler.kineto_results.trace_start_ns()


def _write_spans(path: str, spans: List[Dict]) -> None:
    """Add the spans to a Chrome trace that `export_chrome_trace` wrote,
    one thread of the trace per thread that opened spans."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    offset = _epoch_offset_ns() - int(trace.get("baseTimeNanoseconds", 0))
    events = trace.setdefault("traceEvents", [])
    pid = os.getpid()
    tids: Dict[str, int] = {}
    for s in spans:
        tid = tids.get(s["thread"])
        if tid is None:
            tid = tids[s["thread"]] = _SPAN_TID + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"spans: {s['thread']}"}})
        events.append({
            "ph": "X", "cat": "span", "name": s["name"], "pid": pid,
            "tid": tid, "ts": (s["start_ns"] + offset) / 1e3,
            "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
            "args": {k: s[k] for k in ("id", "parent", "request", "cause")
                     if s[k] is not None}})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def trace_to(logdir: str, device: DeviceLike = None):
    """Profile the block on `device` (the card unless "cpu" is passed),
    with span recording on, and write `<logdir>/trace-<pid>-<ns>.json`;
    yields that path. Spans recorded before the block stay in the buffer
    for their `drain`."""
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    was_on = _ON
    since = time.perf_counter_ns()
    if not was_on:
        set_recording(True)
    try:
        with profile(activities=activities) as prof:
            yield path
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    finally:
        with _lock:
            spans = [s.as_dict() for s in _records if s.end >= since]
        if not was_on:
            drain()
            set_recording(False)
    prof.export_chrome_trace(path)
    _write_spans(path, spans)
    logger.info("profile written to %s", path)


def device_memory_stats(device: DeviceLike = None) -> dict:
    """Per-device memory gauges under the reference's keys: for each card,
    the caching allocator's bytes in use and their peak
    (`torch.cuda.memory_stats`) and the card's total memory
    (`torch.cuda.mem_get_info`). On the CPU (device="cpu") the allocator
    keeps no such gauges: one entry whose values are None, as the
    reference reports for a host device."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {str(dev): dict.fromkeys(MEMORY_KEYS)}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total,
        }
    return out
