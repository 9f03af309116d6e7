"""Run one cell of `BENCHMARK.json` once: find its configuration, traffic
and metrics by name, drive it, and build the result line.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by the name in
`BENCHMARK.json`:

- `portbench/configs/<config>.json`: the model's sizes, its source and cut;
- `portbench/traffic/<traffic>.json`: the driver that generates it, its
  parameters and the limits of its correctness check;
- `portbench/drivers/<driver>.py`: one general generator per kind of
  traffic (a `Driver` class);
- `portbench/metrics/<metric>.py`: one reader per per-layer metric
  (`read(ctx)`: a number, or None where it finds nothing to read); a name
  with a dot (`mfu_pct.stream`) takes the reader of the part before it. A
  reader counts the work it
  needs from the window's record (`ctx["calls"]`: each call into the
  program with its shapes, and whether the trace saw it).

A driver builds the program under test in `setup`, measures in `window`,
frees the program's state in `free` and compares what the window served
with the plain reference in `check`.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
from typing import Any, Callable, Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "toolbox_for_asr_and_tts_tpu")


def forbidden_modules(names) -> List[str]:
    """Modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: the port's own package name begins with the
    reference package's and is not one of them."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of `workloads` with everything it names."""

    def __init__(self, bench: Dict, name: str):
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = found[0]
        self.name = name
        self.chips = int(self.spec["chips"])
        self.config = load_json(os.path.join(
            PKG, "configs", f"{self.spec['config']}.json"))
        self.traffic = load_json(os.path.join(
            PKG, "traffic", f"{self.spec['traffic']}.json"))
        self.driver_path = os.path.join(PKG, "drivers",
                                        f"{self.traffic['driver']}.py")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]

    def _reports(self, m: Dict) -> bool:
        if "workloads" in m:
            return self.name in m["workloads"]
        return any(e["name"] == m["moves"] for e in self.end_to_end)

    def driver(self, seed: int, device) -> Any:
        mod = load_module(self.driver_path,
                          f"portbench_driver_{self.traffic['driver']}")
        return mod.Driver(self.config, self.traffic, seed, device)


def metric_path(name: str) -> str:
    """The reader of the name before its first dot: `mfu_pct.stream` is
    `metrics/mfu_pct.py` read in the cells that report `partial_p95_ms`."""
    return os.path.join(PKG, "metrics", f"{name.split('.')[0]}.py")


def read_metric(name: str, ctx: Dict) -> Optional[float]:
    mod = load_module(metric_path(name),
                      "portbench_metric_" + name.replace(".", "_"))
    return mod.read(ctx)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, clock: Callable[[], float],
        log=lambda s: print(s, file=sys.stderr, flush=True)) -> Dict:
    """One run of `cell` → the result line's object, `checks` last."""
    import torch
    from portbench.trace import Tracer

    drv = cell.driver(seed, device)
    t_setup = clock()
    drv.setup(seconds)
    setup_s = clock() - t_start
    parts = ", ".join(f"{k} {v:.3f}"
                      for k, v in getattr(drv, "phases", {}).items())
    log(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s "
        f"(before the driver's set-up {t_setup - t_start:.3f}; {parts})")
    tracer = Tracer(trace)
    if trace:
        log(f"portbench: profiler's first start {tracer.prepare():.3f} s")
    drv.window(seconds, tracer)
    tracer.finish()
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(torch.device(device))
                    if on_card else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
               torch.device(device))) if on_card else 0}
    e2e = dict(drv.end_to_end(), setup_s=setup_s)
    ctx = dict(drv.context(), trace=tracer.summary, config=cell.config,
               traffic=cell.traffic)
    metrics: Dict[str, Dict] = {}
    if trace:
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if _finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if tracer.summary is not None:
            dev["busy_s"] = tracer.summary["busy_s"]
            dev["window_s"] = tracer.summary["window_s"]
    else:
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            if _finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted, failed = drv.attempted, drv.failed
    drv.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = drv.check()
    limits = cell.traffic["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(_finite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and tracer.summary is not None:
        out["breakdown"] = {"device_ops": tracer.summary["device_ops"],
                            "idle_gaps": tracer.summary["idle_gaps"]}
    diag = {k: v for k, v in numbers.items() if k not in limits}
    if diag:
        log(f"portbench: diagnostics {json.dumps(diag)}")
    out["checks"] = checks
    return out
