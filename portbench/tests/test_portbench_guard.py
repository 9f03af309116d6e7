"""What the benchmark may load: no JAX and no JAX package in a run, and
nothing of the program in the reference."""
import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

from portbench import harness


def test_forbidden_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "toolbox_for_asr_and_tts_tpu", "toolbox_for_asr_and_tts_tpu.ops",
             "toolbox_for_asr_and_tts_tpu_torch",
             "toolbox_for_asr_and_tts_tpu_torch.ops.nn", "jaxtyping",
             "flaxen", "numpy", "torch"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "toolbox_for_asr_and_tts_tpu", "toolbox_for_asr_and_tts_tpu.ops"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "portbench", "reference",
                                       "*.py")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax",
                           "toolbox_for_asr_and_tts_tpu",
                           "toolbox_for_asr_and_tts_tpu_torch", "portbench"}


def test_no_benchmark_file_imports_jax():
    for path in glob.glob(os.path.join(ROOT, "portbench", "**", "*.py"),
                          recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax",
                           "toolbox_for_asr_and_tts_tpu"}, path


@pytest.mark.parametrize("trace", [False, True])
def test_a_cpu_run_loads_no_jax(trace):
    """Nor does a traced run, which records the program's spans."""
    code = (
        "import sys, time; sys.path.insert(0, 'portbench/tests');"
        "import conftest; from portbench import harness;"
        "c = conftest.tiny_cell('offline-b8-mixed', batches=2,"
        " trace={'after_s': 0.05, 'seconds': 0.1});"
        f"harness.run(c, 1, 0.2, {trace}, 'cpu', time.perf_counter(),"
        " time.perf_counter, log=lambda s: None);"
        "print(harness.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "offline-b8-mixed", "--seed", "1", "--seconds",
                          "1"], cwd=ROOT, text=True, capture_output=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_does_not_run(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone, without the
    program, fails before any result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, 'portbench/tests');"
            "import conftest; from portbench import harness;"
            "c = conftest.tiny_cell('offline-b8-mixed', batches=2);"
            "print(harness.run(c, 1, 0.2, False, 'cpu', time.perf_counter(),"
            " time.perf_counter))")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         text=True, capture_output=True, timeout=300, env=env)
    assert out.returncode != 0 and "correct" not in out.stdout
    assert "toolbox_for_asr_and_tts_tpu_torch" in out.stderr
