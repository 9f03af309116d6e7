"""Dependency-free Prometheus metrics (text exposition format 0.0.4).

Copy of `toolbox_for_asr_and_tts_tpu/runtime/prom.py` for the port
(framework-free; imports kept relative).

Beyond the reference: survey §5 records that the reference's observability
stops at log lines and /health gauges ("No Prometheus/OTel"). Serving ~600
concurrent streams per chip makes scrapeable metrics table stakes, so both
services expose GET /metrics backed by this registry: counters, gauges
(including callback gauges collected at scrape time), and histograms, all
thread-safe and allocation-light on the hot path.

Usage:
    from ..runtime import prom
    REQS = prom.counter("toolbox_http_requests_total",
                        "HTTP requests", ("method", "route", "status"))
    REQS.inc(method="GET", route="/health", status="200")
    LAT = prom.histogram("toolbox_http_request_seconds",
                         "request latency", ("route",))
    LAT.observe(0.012, route="/health")
    prom.gauge_fn("toolbox_tts_active_jobs", "...", lambda: mgr.active_jobs)

Label cardinality discipline: label values must come from closed sets
(route templates, methods, statuses, bucketed sizes) — never raw paths,
session ids, or texts.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_INF = float("inf")

# latency buckets (s): sub-ms device ticks up to multi-minute compiles
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
# batch-size buckets (pow-2, matching the serving hubs' padding)
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
# real-time-factor buckets
RTF_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
               1.0, 2.0)


def _fmt(v: float) -> str:
    if v == _INF:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _labels_str(names: Sequence[str], values: Tuple[str, ...],
                extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


class _Metric:
    mtype = "untyped"

    def __init__(self, name: str, help_: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def _header(self) -> List[str]:
        return [f"# HELP {self.name} {_escape(self.help)}",
                f"# TYPE {self.name} {self.mtype}"]

    def render(self) -> List[str]:  # pragma: no cover - overridden
        return []


class Counter(_Metric):
    mtype = "counter"

    def __init__(self, name, help_, labelnames=()):
        super().__init__(name, help_, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        for k, v in items:
            out.append(f"{self.name}{_labels_str(self.labelnames, k)} "
                       f"{_fmt(v)}")
        return out


class Gauge(_Metric):
    mtype = "gauge"

    def __init__(self, name, help_, labelnames=(),
                 fn: Optional[Callable[[], float]] = None):
        super().__init__(name, help_, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._fn = fn
        if fn is not None and labelnames:
            raise ValueError("callback gauges take no labels")

    def set(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + amount

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def render(self) -> List[str]:
        out = self._header()
        if self._fn is not None:
            try:
                v = float(self._fn())
            except Exception:  # a broken gauge must not break the scrape
                v = float("nan")
            out.append(f"{self.name} {_fmt(v) if v == v else 'NaN'}")
            return out
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.labelnames:
            items = [((), 0.0)]
        for k, v in items:
            out.append(f"{self.name}{_labels_str(self.labelnames, k)} "
                       f"{_fmt(v)}")
        return out


class Histogram(_Metric):
    mtype = "histogram"

    def __init__(self, name, help_, labelnames=(),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help_, labelnames)
        self.buckets = tuple(sorted(buckets)) + (_INF,)
        # per-label-set: [bucket counts…, sum, count]
        self._values: Dict[Tuple[str, ...], List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        with self._lock:
            row = self._values.get(k)
            if row is None:
                row = self._values[k] = [0.0] * (len(self.buckets) + 2)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    row[i] += 1.0
            row[-2] += value
            row[-1] += 1.0

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted((k, list(v)) for k, v in self._values.items())
        for k, row in items:
            for i, b in enumerate(self.buckets):
                le = _labels_str(self.labelnames, k, f'le="{_fmt(b)}"')
                out.append(f"{self.name}_bucket{le} {_fmt(row[i])}")
            ls = _labels_str(self.labelnames, k)
            out.append(f"{self.name}_sum{ls} {repr(row[-2])}")
            out.append(f"{self.name}_count{ls} {_fmt(row[-1])}")
        return out


class Registry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name, help_, labelnames=(), **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                    raise ValueError(f"metric {name} re-registered with a "
                                     "different type or labels")
                return m
            m = cls(name, help_, labelnames, **kw)
            self._metrics[name] = m
            return m

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in sorted(metrics, key=lambda m: m.name):
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


REGISTRY = Registry()


def counter(name: str, help_: str, labelnames: Sequence[str] = ()) -> Counter:
    return REGISTRY._register(Counter, name, help_, labelnames)


def gauge(name: str, help_: str, labelnames: Sequence[str] = ()) -> Gauge:
    return REGISTRY._register(Gauge, name, help_, labelnames)


def gauge_fn(name: str, help_: str, fn: Callable[[], float]) -> Gauge:
    return REGISTRY._register(Gauge, name, help_, (), fn=fn)


def histogram(name: str, help_: str, labelnames: Sequence[str] = (),
              buckets: Sequence[float] = LATENCY_BUCKETS) -> Histogram:
    return REGISTRY._register(Histogram, name, help_, labelnames,
                              buckets=buckets)
