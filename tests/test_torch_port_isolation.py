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
from toolbox_for_asr_and_tts_tpu_torch.asr.tokenizer import CharTokenizer  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.asr.vad import StreamingVadStepper  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import fsmn_vad as fv  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer as pf  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models import paraformer_online as po  # noqa: E402
from toolbox_for_asr_and_tts_tpu_torch.models.paraformer_streaming import (  # noqa: E402
    StreamingRecognizer)
from toolbox_for_asr_and_tts_tpu_torch.parallel.stream_batcher import (  # noqa: E402
    BatchedChunkedASR, BatchedVadTicker)

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
    assert len(mods) >= 24, mods
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if _forbidden(m)]
    for name in ("asr.recognizer", "asr.vad", "models.fsmn_vad",
                 "models.paraformer_online", "models.paraformer_streaming",
                 "ops.vad_energy", "parallel.stream_batcher", "utils.audio"):
        assert f"toolbox_for_asr_and_tts_tpu_torch.{name}" in loaded, name


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
    assert n >= 25
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


VAD = fv.FsmnVadConfig(proj_dim=8, fsmn_layers=2, lorder=5, linear_dim=16)


def _streaming_entry_points(device):
    """Each streaming entry point of the port, built with `device`."""
    p = pf.init_params(TINY, torch.Generator().manual_seed(0))
    vp = fv.init_params(VAD, torch.Generator().manual_seed(0))
    tok = CharTokenizer.dummy(TINY.vocab_size)
    kw = {} if device is None else {"device": device}
    return {
        "OnlineRecognizer": lambda: po.OnlineRecognizer(
            p, TINY, tok, partial_mode="incremental", **kw),
        "StreamingRecognizer": lambda: StreamingRecognizer(p, TINY, tok, **kw),
        "StreamingVadStepper": lambda: StreamingVadStepper(vp, VAD, **kw),
        "BatchedChunkedASR": lambda: BatchedChunkedASR(
            p, TINY, capacity=2, partials=True, **kw),
        "BatchedVadTicker": lambda: BatchedVadTicker(vp, VAD, capacity=2,
                                                     **kw),
    }


def test_streaming_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, make in _streaming_entry_points(None).items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _streaming_entry_points("cuda")[name]()


def test_streaming_entry_points_run_on_explicit_cpu():
    cpu = torch.device("cpu")
    for name, make in _streaming_entry_points("cpu").items():
        obj = make()
        assert obj.device == cpu, name
    t = _streaming_entry_points("cpu")["BatchedChunkedASR"]()
    assert all(v.device == cpu for v in t.state.values())
    w = t.params["encoder"]["layers"][0]["attn"]["qkv"]["w"]
    assert w.device == cpu
