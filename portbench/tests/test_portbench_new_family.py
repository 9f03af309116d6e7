"""A new model family needs no edit of a file the benchmark has: a copy of
`portbench/` and `BENCHMARK.json` takes a toy family as new files alone (a
configuration naming `reference/toy.py`, its plain reference, a traffic, a
driver whose program is a few torch ops with one span and one counter, the
family's module and configuration test, and a reader of the span), and
entries appended to `BENCHMARK.json`. The benchmark's self-tests pass in
the copy, and runs of the toy cell on the CPU, with the trace off and on,
report the reader's number and the toy's `mfu` share."""
import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

FILES = {
    "configs/toy-mlp.json": json.dumps({
        "name": "toy-mlp", "source": "https://example.org/toy-mlp",
        "reference": "portbench/reference/toy.py", "reduced": ["layers"],
        "precision": {"dtype": "float32", "matmul_tf32": False,
                      "cudnn_tf32": False},
        "model": {"width": 512, "layers": 4}}),
    "traffic/toy-loop.json": json.dumps({
        "driver": "toy", "why": "a closed loop of one batch",
        "params": {"rows": 64, "seconds_per_row": 1.0,
                   "trace": {"after_s": 0.1, "seconds": 0.2}},
        "check": {}, "limits": {"max_abs_err": 1e-5}}),
    "reference/toy.py": '''
import torch


def forward(weights, x):
    for w in weights:
        x = torch.relu(x @ w)
    return x
''',
    "families/toy.py": '''
TINY = {"model": {"layers": 2}}


def call_flops(c, cfg):
    m = cfg["model"]
    if c["kind"] != "step":
        return 0.0
    return 2.0 * c["rows"] * m["width"] ** 2 * m["layers"]
''',
    "drivers/toy.py": '''
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from portbench.reference import toy as ref  # noqa: E402


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.m, self.p = config["model"], traffic["params"]
        self.seed, self.device = seed, torch.device(device)
        self.attempted = self.failed = self.steps = 0

    def inputs(self):
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        w, n = self.m["width"], self.m["layers"]
        return (torch.randn(n, w, w, generator=g, device=self.device)
                / w ** 0.5,
                torch.randn(self.p["rows"], w, generator=g,
                            device=self.device))

    def setup(self, seconds):
        self.weights, self.x = self.inputs()
        self.program(self.x)

    def program(self, x):
        from toolbox_for_asr_and_tts_tpu_torch.runtime import profiling
        with profiling.annotate("toy.step"):
            for w in self.weights:
                x = torch.relu(x @ w)
        self.steps += 1
        return x

    def counters(self):
        return {"steps": self.steps}

    def window(self, seconds, tracer):
        self.calls = []
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            if time.perf_counter() >= t0 + self.p["trace"]["after_s"]:
                tracer.begin(self.p["trace"]["seconds"])
            tracer.poll()
            self.y = self.program(self.x)
            self.attempted += 1
            self.calls.append({"kind": "step", "rows": self.p["rows"],
                               "traced": tracer.recording})
        tracer.stop()
        self.window_s = time.perf_counter() - t0 - tracer.overhead_s

    def end_to_end(self):
        return {"audio_throughput": len(self.calls) * self.p["rows"]
                * self.p["seconds_per_row"] / self.window_s}

    def context(self):
        return {"window_s": self.window_s, "calls": self.calls}

    def free(self):
        del self.weights

    def check(self):
        weights, x = self.inputs()
        return {"max_abs_err": float(
            (self.y - ref.forward(weights, x)).abs().max())}
''',
    "metrics/toy_step_ms.py": '''
def read(ctx):
    spans = [s for s in ctx.get("spans") or () if s["name"] == "toy.step"]
    steps = (ctx.get("counters") or {}).get("steps")
    if not spans or not steps:
        return None
    return 1e-6 * sum(s["end_ns"] - s["start_ns"] for s in spans) / steps
''',
    "tests/test_toy_cell_runs.py": '''
import json
import os
import time

import conftest
from portbench import harness, trace

reduce = trace.Tracer._reduce


def with_card(self, prof, program):
    # a CPU profile holds no device time: a stand-in, so that the readers
    # that need the card's work read
    out = reduce(self, prof, program)
    out["busy_s"] = 0.5 * out["window_s"]
    return out


def test_the_toy_cell_runs(monkeypatch):
    monkeypatch.setattr(trace.Tracer, "_reduce", with_card)
    lines = []
    for on in (False, True):
        cell = conftest.tiny_cell("toy-loop")
        lines.append(harness.run(cell, 2 ** 31 + 3, 0.35, on, "cpu",
                                 time.perf_counter(), time.perf_counter,
                                 log=lambda s: None))
    with open(os.path.join(conftest.ROOT, "toy_lines.json"), "w") as f:
        json.dump(lines, f)
''',
    "tests/test_family_toy.py": '''
import json
import os

from conftest import ROOT


def test_configs_are_the_programs():
    cfg = json.load(open(os.path.join(ROOT, "portbench/configs/toy-mlp.json")))
    assert set(cfg["model"]) == {"width", "layers"}
''',
}



def test_a_new_family_needs_no_edit(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in FILES.items():
        path = tmp_path / "portbench" / rel
        assert not path.exists(), rel
        path.write_text(text)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy-mlp", "source": "https://example.org/toy-mlp",
        "file": "portbench/configs/toy-mlp.json", "reduced": ["layers"],
        "why": "a toy family"})
    bench["workloads"].append({
        "name": "toy-loop", "config": "toy-mlp", "traffic": "toy-loop",
        "chips": 1, "why": "a closed loop of one batch"})
    [e2e] = [m for m in bench["end_to_end"]
             if m["name"] == "audio_throughput"]
    e2e["workloads"].append("toy-loop")
    bench["per_layer"] += [
        {"name": "toy_step_ms", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "toy step",
         "moves": "audio_throughput", "workloads": ["toy-loop"]},
        {"name": "mfu_pct.toy", "unit": "%", "better": "higher",
         "source": "host_clock", "layer": "toy model step",
         "moves": "audio_throughput", "workloads": ["toy-loop"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{ROOT}",
               PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "--rootdir", str(tmp_path),
         "portbench/tests/test_portbench_harness.py",
         "portbench/tests/test_family_toy.py",
         "portbench/tests/test_family_paraformer.py",
         "portbench/tests/test_toy_cell_runs.py",
         "-k", "not result_line"],
        cwd=tmp_path, env=env, text=True, capture_output=True, timeout=120)
    assert tests.returncode == 0, tests.stdout[-3000:]
    off, on = json.loads((tmp_path / "toy_lines.json").read_text())
    assert off["correct"] and on["correct"]
    assert set(off["metrics"]) == {"audio_throughput", "setup_s"}
    assert set(on["metrics"]) == {"toy_step_ms", "mfu_pct.toy"}
    assert on["metrics"]["toy_step_ms"]["value"] > 0
    assert on["metrics"]["mfu_pct.toy"]["value"] > 0
    assert "toy.step" in dict(on["breakdown"]["idle_by_span"])
