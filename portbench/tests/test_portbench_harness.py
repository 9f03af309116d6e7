"""The harness finds every cell and metric by name, the files it names
exist, the configurations are the program's, and a run's last line has
exactly the contract's keys."""
import json
import os
import re
import time

import pytest

from conftest import ROOT, SMALL, tiny_cell

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
    from portbench import harness
    c = harness.Cell(BENCH, cell)
    assert os.path.exists(c.driver_path)
    assert c.chips == 1
    assert "limits" in c.traffic and c.traffic["limits"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        # every per-layer metric moves an end-to-end metric the cell reports
        assert m["moves"] in names
        assert os.path.exists(harness.metric_path(m["name"]))


def test_configs_name_their_files():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []


def test_configs_are_the_programs():
    """The configurations hold the port's Paraformer-large, FunASR frontend
    and streaming geometry (the hub takes `OnlineConfig()` as it is)."""
    import dataclasses
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer import \
        ParaformerConfig
    from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_online import \
        OnlineConfig
    from toolbox_for_asr_and_tts_tpu_torch.ops.frontend import FrontendConfig
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        want = dataclasses.asdict(ParaformerConfig())
        assert all(want[k] == v for k, v in cfg["model"].items())
        fe = FrontendConfig()
        got = cfg["frontend"]
        assert (got["sample_rate"], got["frame_length"], got["frame_shift"],
                got["n_mels"], got["preemphasis"], got["low_freq"]) == \
            (fe.sample_rate, fe.frame_length, fe.frame_shift, fe.n_mels,
             fe.preemphasis, fe.low_freq)
        if cfg["online"]:
            o = dataclasses.asdict(OnlineConfig())
            assert all(o[k] == v for k, v in cfg["online"].items())


def test_weights_have_the_programs_tree():
    import torch
    from portbench import weights
    from conftest import TINY
    from toolbox_for_asr_and_tts_tpu_torch.models import paraformer
    cfg = json.load(open(os.path.join(
        ROOT, "portbench/configs/paraformer-large-zh-offline.json")))
    m = dict(cfg["model"], **TINY)
    ours = weights.leaves_of(weights.make_params(m, 5, "cpu"))
    theirs = weights.leaves_of(paraformer.init_params(
        paraformer.ParaformerConfig(**m), torch.Generator().manual_seed(0)))
    assert [(k, tuple(v.shape)) for k, v in ours] == \
        [(k, tuple(v.shape)) for k, v in theirs]
    again = weights.leaves_of(weights.make_params(m, 5, "cpu"))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(ours, again))


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contract_keys(trace):
    from portbench import harness
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
        assert set(out["metrics"]) >= {"pad_waste_pct", "captures_in_window"}
    json.dumps(out)


def test_a_dotted_name_takes_its_base_reader():
    from portbench import harness
    base = os.path.join(harness.PKG, "metrics")
    assert harness.metric_path("mfu_pct.stream") == \
        os.path.join(base, "mfu_pct.py")
    assert harness.metric_path("k1_roofline") == \
        os.path.join(base, "k1_roofline.py")
