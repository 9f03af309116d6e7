"""The readers of the per-layer metrics the benchmark had before the
program's spans were read (`parent_readers/`, copied as they were) and
today's read the same value, bit for bit, from the same context: one
recorded from a tiny `--trace 1` run of each cell on the CPU, its trace
replaced by one in which every kernel the readers look for ran (a CPU run
has no device trace, and the device readers would read nothing)."""
import glob
import os
import time

import pytest

from conftest import SMALL, tiny_cell

from portbench import harness

PARENT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "parent_readers")
NAMES = sorted(os.path.splitext(os.path.basename(p))[0]
               for p in glob.glob(os.path.join(PARENT, "*.py")))
SECONDS = {"offline-b8-mixed": 1.0, "stream-hub-knee80": 3.0,
           "finetune-b32-10s": 1.0}
TRACE = {"busy_s": 0.75, "window_s": 1.0,
         "kernels": {"void fsmn_conv_kernel<float>": [66, 2.5e-4],
                     "void fsmn_bwd_kernel<float>": [66, 5.5e-4],
                     "ampere_sgemm_128x64_nn": [100, 0.25],
                     "elementwise_kernel": [300, 0.05]},
         "device_ops": [], "idle_gaps": []}


def recorded(name, monkeypatch):
    """The context the harness hands the readers in a tiny traced run."""
    seen = []
    read = harness.read_metric
    monkeypatch.setattr(harness, "read_metric",
                        lambda n, ctx: seen.append(ctx) or read(n, ctx))
    cell = tiny_cell(name, **SMALL[name],
                     trace={"after_s": 0.1, "seconds": 0.2})
    harness.run(cell, 2 ** 31 + 29, SECONDS[name], True, "cpu",
                time.perf_counter(), time.perf_counter, log=lambda s: None)
    assert seen
    return cell, dict(seen[0], trace=TRACE)


@pytest.mark.parametrize("name", list(SECONDS))
def test_existing_readers_read_the_same(name, monkeypatch):
    cell, ctx = recorded(name, monkeypatch)
    monkeypatch.undo()
    old = [m["name"] for m in cell.per_layer
           if m["name"].split(".")[0] in NAMES]
    assert old
    numbers = 0
    for metric in old:
        base = metric.split(".")[0]
        parent = harness.load_module(os.path.join(PARENT, f"{base}.py"),
                                     f"portbench_parent_{base}").read(ctx)
        assert harness.read_metric(metric, ctx) == parent, metric
        numbers += parent is not None
    # the context gives most readers something to read
    assert numbers >= len(old) - 1, (name, numbers, len(old))
