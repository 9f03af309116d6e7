"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU quietly."""
import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import toolbox_for_asr_and_tts_tpu_torch as port  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.recognizer import Recognizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.device import resolve_device  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(port.__file__)
REF = "toolbox_for_asr_and_tts_tpu"
TINY = pf.ParaformerConfig(d_model=32, n_heads=2, ffn_dim=64,
                           encoder_layers=2, decoder_layers=2, vocab_size=64)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix=port.__name__ + "."))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == REF


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    assert len(mods) >= 15, mods
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if _forbidden(m)]
    assert "toolbox_for_asr_and_tts_tpu_torch.asr.recognizer" in loaded


def _sources():
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_the_reference():
    bad = []
    n = 0
    for path in _sources():
        n += 1
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, nm) for nm in names if _forbidden(nm)]
    assert n >= 16
    assert not bad, bad


def test_no_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Recognizer.random(TINY)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_explicit_cpu_runs_on_cpu():
    reco = Recognizer.random(TINY, device="cpu")
    assert reco.device == torch.device("cpu")
    w = reco.params["encoder"]["layers"][0]["attn"]["qkv"]["w"]
    assert w.device.type == "cpu" and w.dtype == torch.float32
