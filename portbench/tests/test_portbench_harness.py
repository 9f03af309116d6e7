"""The harness finds every cell and metric by name, the files it names
exist, every configuration's family brings the pieces the harness looks up
by its name (the configurations are held to the program's geometry by each
family's own `test_family_<family>.py`), and a run's last line has exactly
the contract's keys."""
import json
import os
import re
import time

import pytest

from conftest import ROOT, SMALL, tiny_cell

from portbench import harness

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for s in [c["why"] for c in BENCH["configs"] + BENCH["workloads"]] + \
            [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(cell):
    c = harness.Cell(BENCH, cell)
    assert os.path.exists(c.driver_path)
    assert c.chips in (1, 4)
    assert "limits" in c.traffic and c.traffic["limits"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        # every per-layer metric moves an end-to-end metric the cell reports
        assert m["moves"] in names
        assert os.path.exists(harness.metric_path(m["name"]))


def test_four_chip_cells_are_few():
    """At most a quarter of the cells, rounded down, ask for four chips;
    one always may."""
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def _keys(cfg):
    """A configuration file's keys: its own and those of its groups."""
    return set(cfg) | {k for v in cfg.values() if isinstance(v, dict)
                       for k in v}


def _config(c):
    return json.load(open(os.path.join(ROOT, c["file"])))


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        cfg = _config(c)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= _keys(cfg), c["name"]


FAMILIES = sorted({harness.family_name(_config(c))
                   for c in BENCH["configs"]})


@pytest.mark.parametrize("family", FAMILIES)
def test_every_family_has_its_pieces(family):
    """What the harness and the tests look up by a family's name: its plain
    reference, its module with `TINY` (groups of the configuration file)
    and `call_flops`, and its test of the configurations."""
    pb = os.path.join(ROOT, "portbench")
    assert os.path.exists(os.path.join(pb, "reference", f"{family}.py")), \
        f"family {family!r}: no plain reference"
    assert os.path.exists(harness.family_path(family)), \
        f"family {family!r}: no portbench/families/{family}.py"
    assert os.path.exists(os.path.join(pb, "tests",
                                       f"test_family_{family}.py")), \
        f"family {family!r}: no portbench/tests/test_family_{family}.py"
    mod = harness.load_family(family)
    assert callable(getattr(mod, "call_flops", None)), \
        f"family {family!r}: no call_flops"
    tiny = getattr(mod, "TINY", None)
    assert isinstance(tiny, dict) and tiny, f"family {family!r}: no TINY"
    for c in BENCH["configs"]:
        cfg = _config(c)
        if harness.family_name(cfg) != family:
            continue
        for group, keys in tiny.items():
            assert isinstance(cfg.get(group), dict) and \
                set(keys) <= set(cfg[group]), \
                f"family {family!r}: TINY[{group!r}] not in {c['name']}"


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(trace):
    cell = tiny_cell("offline-b8-mixed", **SMALL["offline-b8-mixed"],
                     trace={"after_s": 0.1, "seconds": 0.2})
    t = time.perf_counter()
    out = harness.run(cell, 2 ** 31 + 7, 4.0 if trace else 1.0, bool(trace), "cpu", t,
                      time.perf_counter, log=lambda s: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + \
        (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == keys
    assert out["correct"] is True and out["attempted"] > 0
    assert set(out["checks"]) == set(cell.traffic["limits"])
    if not trace:
        assert set(out["metrics"]) == {"audio_throughput", "setup_s"}
    else:
        # a CPU run reports no device metric
        assert not {"device_idle_pct", "mfu_pct", "k1_roofline",
                    "linear_share_pct"} & set(out["metrics"])
        # what needs no card is read
        assert set(out["metrics"]) >= {"pad_waste_pct", "captures_in_window",
                                       "transcribe_host_ms"}
        # the profiled second's idle time by the program's spans
        named = dict(out["breakdown"]["idle_by_span"])
        assert "(none)" in named and "recognizer.transcribe" in named
    json.dumps(out)


def test_a_dotted_name_takes_its_base_reader():
    base = os.path.join(harness.PKG, "metrics")
    assert harness.metric_path("mfu_pct.stream") == \
        os.path.join(base, "mfu_pct.py")
    assert harness.metric_path("k1_roofline") == \
        os.path.join(base, "k1_roofline.py")


def test_a_traced_window_reads_outside_the_profile():
    """The readers get the program's spans that ended before the profile
    began or started after it stopped, and the counters' deltas over those
    two stretches; the profiled second's spans split its idle time."""
    from toolbox_for_asr_and_tts_tpu_torch.runtime import profiling

    class Driver:
        n = 0

        def counters(self):
            return {"steps": self.n}

        def step(self, name):
            with profiling.annotate(name):
                self.n += 1

        def window(self, seconds, tracer):
            self.step("before")
            tracer.begin(60.0)
            self.step("during")
            self.step("during")
            tracer.stop()
            self.step("after")
            self.step("after")
            self.step("after")

    tracer, spans, counters = harness._traced_window(
        Driver(), 1.0, lambda s: None)
    assert sorted(s["name"] for s in spans) == ["after"] * 3 + ["before"]
    assert counters == {"steps": 4}
    named = dict(tracer.summary["idle_by_span"])
    assert "during" in named and "before" not in named
    # recording is off again
    assert profiling.begin("after the window") is None
