"""Per-stage timing log lines and real-time-factor accounting.

Own copy of `StageTimer`, `RTFMeter` and `timing_log` from the reference's
`runtime/metrics.py`. Callers time work that ends in a host fetch (which
waits for the device), so the recorded seconds include the device's time;
`StageTimer` waits for the card itself at the end of a stage that names
CUDA tensors.
"""
from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger("toolbox.metrics")

TIMING_PREFIX = "耗时统计 -"  # keep the reference's greppable convention


def timing_log(step: str, ms: float) -> None:
    logger.info("%s %s: %.2f ms", TIMING_PREFIX, step, ms)


def _wait_device(x: Any) -> None:
    """Wait for the card's work on every CUDA tensor in `x` (a tensor or a
    tree of dicts, lists and tuples): one synchronize per device named."""
    devices = set()

    def walk(t: Any) -> None:
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                devices.add(t.device)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclass
class StageTimer:
    """Collects named stage durations into a structured timing dict."""

    stages: Dict[str, float] = field(default_factory=dict)
    _t0: float = field(default_factory=time.perf_counter)

    @contextmanager
    def stage(self, name: str, block_on: Any = None):
        """Time a stage. Yields a list the body can append device tensors
        to (outputs that do not exist at entry); at exit the card finishes
        the work on each of them, so device time is attributed to the stage
        that spent it."""
        t = time.perf_counter()
        pending: list = [] if block_on is None else [block_on]
        try:
            yield pending
        finally:
            _wait_device(pending)
            ms = (time.perf_counter() - t) * 1000.0
            self.stages[name] = self.stages.get(name, 0.0) + ms
            timing_log(name, ms)

    def total_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1000.0

    def detailed(self) -> Dict[str, Any]:
        return {"total_ms": self.total_ms(), "stages_ms": dict(self.stages)}


class Tally:
    """A running count that several threads may bump at once: the device
    programs a model has run (serving hubs and sessions share the models).
    Read `n` before and after a run to count that run's programs."""

    def __init__(self) -> None:
        self.n = 0
        self._lock = threading.Lock()

    def add(self, k: int = 1) -> None:
        with self._lock:
            self.n += k


def real_time_factor(proc_s: float, audio_s: float, label: str = "") -> float:
    """processing_seconds / audio_seconds (lower is better); warns where a
    call ran slower than real time."""
    rtf = proc_s / max(audio_s, 1e-9)
    if rtf > 1.0:
        logger.warning("RTF %.2f > 1.0 for %s — slower than real time",
                       rtf, label)
    return rtf


@dataclass
class RTFMeter:
    """Real-time factor over many calls: running sums of processing and
    audio seconds, no per-call list."""

    calls: int = 0
    proc_s: float = 0.0
    audio_s: float = 0.0

    def record(self, proc_s: float, audio_s: float, label: str = "") -> float:
        self.calls += 1
        self.proc_s += proc_s
        self.audio_s += audio_s
        return real_time_factor(proc_s, audio_s, label)

    @property
    def overall(self) -> Optional[float]:
        if not self.calls:
            return None
        return self.proc_s / max(self.audio_s, 1e-9)

    def detailed(self) -> Dict[str, Any]:
        return {"overall_rtf": self.overall, "calls": self.calls,
                "proc_s": self.proc_s, "audio_s": self.audio_s}
