"""The port stands alone: it imports neither JAX nor the JAX package (nor
pydantic, websockets or httpx, which the card's machine lacks), and its
entry points never fall back to the CPU quietly."""
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
from toolbox_for_asr_and_tts_tpu_torch.models.convert import tree_map  # noqa: E402
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


NOT_ON_THE_CARD = ("pydantic", "websockets", "httpx")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == REF


def _missing_on_the_card(name: str) -> bool:
    return name.split(".")[0] in NOT_ON_THE_CARD


def test_importing_every_module_loads_no_jax():
    mods = _port_modules()
    assert len(mods) >= 44, mods
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [m for m in loaded if _forbidden(m)]
    assert not [m for m in loaded if _missing_on_the_card(m)]
    for name in ("asr.recognizer", "asr.vad", "models.fsmn_vad",
                 "models.paraformer_online", "models.paraformer_streaming",
                 "ops.vad_energy", "parallel.stream_batcher", "utils.audio",
                 "models.ct_transformer", "models.campplus",
                 "models.kws_ctc", "asr.speaker", "asr.diarization",
                 "asr.session", "asr.corrections", "asr.hotwords",
                 "llm.correction", "runtime.config", "runtime.prom",
                 "runtime.registry", "service.hub", "service.http",
                 "service.schemas", "service.voice_app", "service.engines",
                 "models.sambert", "models.hifigan", "tts.synthesizer",
                 "tts.jobs", "tts.concat", "tts.text_frontend", "tts.prosody",
                 "tts.break_stats", "service.tts_app", "runtime.checkpoints",
                 "tools.convert_checkpoint", "tools.check_cache", "asr.itn",
                 "native.bridge", "launch", "cli", "asr.batch",
                 "demo.full_voice_demo", "tools.warmup", "tools.smoke_http",
                 "tools.start_all"):
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
            bad += [(path, nm) for nm in names
                    if _forbidden(nm) or (_missing_on_the_card(nm)
                                          and path.endswith("chip_smoke.py"))]
    assert n >= 45
    assert not bad, bad


def _code_strings(tree):
    """The string constants of a module that are not docstrings."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)
            and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_source_names_a_path_of_the_reference():
    """No string in the port's code (docstrings aside) names the reference
    package's directory, so no module can open a file under it (its
    `native/` libraries included); the port's Makefile builds only its own
    sources. `chip_smoke.py`'s `replaces` fields ("file:line" of a TPU
    kernel) name a line, not a path to open."""
    import re
    n = 0
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for value in _code_strings(tree):
            n += 1
            if re.fullmatch(REF + r"/[\w/]+\.py:\d+", value):
                assert path.endswith("chip_smoke.py"), (path, value)
                continue
            assert not (value == REF or value.startswith((REF + "/",
                                                          REF + "."))), \
                (path, value)
    assert n > 1000
    with open(os.path.join(PKG_DIR, "native", "Makefile")) as f:
        assert REF + "/" not in f.read()


def test_native_libraries_load_from_the_port_build_only():
    """The FunASR server and the WAV ingest, started through the port,
    map their libraries from the port's `_native_build/` and nothing from
    the reference's `native/` directory."""
    code = (
        "import json\n"
        "from toolbox_for_asr_and_tts_tpu_torch.native import bridge\n"
        "from toolbox_for_asr_and_tts_tpu_torch.utils import audio\n"
        "srv = bridge.NativeWSServer(lambda a, h: '', port=0)\n"
        "srv.start()\n"
        "assert audio._native_audio() is not None\n"
        "maps = [ln.split()[-1] for ln in open('/proc/self/maps')\n"
        "        if ln.rstrip().endswith('.so')]\n"
        "srv.stop()\n"
        "print(json.dumps(sorted(set(maps))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=180)
    maps = json.loads(out.stdout.strip().splitlines()[-1])
    ref_native = os.path.join(ROOT, REF, "native")
    build = os.path.join(PKG_DIR, "_native_build")
    assert not [m for m in maps if m.startswith(ref_native)]
    ours = [m for m in maps if m.startswith(build)]
    assert sorted(os.path.basename(m) for m in ours) == [
        "libaudio_ingest.so", "libfunasr_ws.so"]


def test_deployed_entry_points_default_to_the_card(monkeypatch, tmp_path):
    """The CLI, the FunASR server, the batch API, the serving tools and the
    demo build their engines on the card unless told otherwise: without a
    card they raise."""
    from toolbox_for_asr_and_tts_tpu_torch import cli
    from toolbox_for_asr_and_tts_tpu_torch.asr import batch
    from toolbox_for_asr_and_tts_tpu_torch.demo import full_voice_demo
    from toolbox_for_asr_and_tts_tpu_torch.native import bridge
    from toolbox_for_asr_and_tts_tpu_torch.tools import start_all, warmup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(batch, "_ENGINES", None)
    wav = str(tmp_path / "a.wav")
    calls = [lambda: cli.main(["transcribe", wav]),
             lambda: cli.main(["tts", "你好。", "--tiny",
                               "-o", str(tmp_path / "o.wav")]),
             lambda: bridge.start_offline_asr_server(port=0),
             batch.get_engines, start_all.build_apps,
             lambda: warmup.main(["--seconds", "1"]),
             lambda: full_voice_demo.main([wav])]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_service_modules_import_httpx_only_inside_calls():
    """The LLM clients import httpx inside the call that needs it (the
    card's machine has none); nothing else names pydantic, websockets or
    httpx at all."""
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        top_level = [n for n in tree.body
                     if isinstance(n, (ast.Import, ast.ImportFrom))]
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for nm in filter(_missing_on_the_card, names):
                assert nm == "httpx" and node not in top_level \
                    and "/llm/" in path, (path, nm)


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


def _service_entry_points(device):
    """The service slice's entry points, built with `device`."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier
    from toolbox_for_asr_and_tts_tpu_torch.models.ct_transformer import (
        Punctuator)
    from toolbox_for_asr_and_tts_tpu_torch.models.kws_ctc import (
        KeywordSpotter)
    from toolbox_for_asr_and_tts_tpu_torch.service import engines
    kw = {} if device is None else {"device": device}
    return {
        "Punctuator.random": lambda: Punctuator.random(**kw),
        "SpeakerVerifier.random": lambda: SpeakerVerifier.random(**kw),
        "KeywordSpotter.random": lambda: KeywordSpotter.random(**kw),
        "build_engines": lambda: engines.build_engines(**kw),
        "build_test_engines": lambda: engines.build_test_engines(**kw),
    }


def test_service_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, make in _service_entry_points(None).items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _service_entry_points("cuda")[name]()


def test_service_entry_points_run_on_explicit_cpu():
    """The models and every hub of the test engines live on the CPU when
    asked; closing the engines stops every hub thread."""
    import threading
    cpu = torch.device("cpu")
    made = _service_entry_points("cpu")
    for name in ("Punctuator.random", "SpeakerVerifier.random",
                 "KeywordSpotter.random"):
        obj = made[name]()
        assert obj.device == cpu, name
        leaves = []
        tree_map(leaves.append, obj.params)
        assert leaves and all(a.device == cpu for a in leaves), name
    eng = made["build_test_engines"]()
    try:
        assert eng.verifier.device == cpu
        assert eng.kws.inner.device == cpu
        assert eng.diarizer.inner.recognizer.device == cpu
        assert eng.diarizer.inner.punctuator.device == cpu
        assert eng.streaming_factory.hub.device == cpu
    finally:
        eng.close()
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith(("chunked-hub", "kws-hub",
                                      "finalize-hub", "vad-hub"))]


def _tts_entry_points(device):
    """The TTS slice's entry points, built with `device`."""
    from toolbox_for_asr_and_tts_tpu_torch.service.tts_app import create_app
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    kw = {} if device is None else {"device": device}
    cpu = Synthesizer.random(tiny=True, device="cpu")

    def served():
        app = create_app()
        try:
            return app.manager().synth
        finally:
            app.close_engines()
    return {
        "Synthesizer.random": lambda: Synthesizer.random(tiny=True, **kw),
        "Synthesizer": lambda: Synthesizer(cpu.ap, cpu.acfg, cpu.vp,
                                           cpu.vcfg, **kw),
        **({"create_app": served} if device is None else {}),
    }


def test_tts_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, make in _tts_entry_points(None).items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for name, make in _tts_entry_points("cuda").items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_tts_entry_points_run_on_explicit_cpu():
    cpu = torch.device("cpu")
    for name, make in _tts_entry_points("cpu").items():
        synth = make()
        assert synth.device == cpu, name
        leaves = []
        tree_map(leaves.append, (synth.ap, synth.vp))
        assert leaves and all(a.device == cpu for a in leaves), name


# the reference's mesh names, which wait for the multi-card slice
MESH_NAMES = {"serving_mesh", "local_device_count", "shard_batch"}


@pytest.mark.parametrize("sub", ["ops", "models", "runtime", "utils", "asr",
                                 "tts", "service"])
def test_subpackage_exports_match_the_reference(sub):
    """Each subpackage exports the reference's names (less the mesh names),
    and each name resolves."""
    import importlib
    ref = importlib.import_module(f"{REF}.{sub}")
    ours = importlib.import_module(f"toolbox_for_asr_and_tts_tpu_torch.{sub}")
    assert set(ours.__all__) == set(ref.__all__) - MESH_NAMES
    for name in ours.__all__:
        assert getattr(ours, name) is not None, name


def test_export_imports_work():
    from toolbox_for_asr_and_tts_tpu_torch.asr import apply_itn
    from toolbox_for_asr_and_tts_tpu_torch.ops import compute_frontend, fbank
    from toolbox_for_asr_and_tts_tpu_torch.runtime import StageTimer
    assert apply_itn("一百二十三") == "123"
    x = torch.zeros(1, 4000)
    cfg = pf.ParaformerConfig().frontend
    feats = compute_frontend(x, cfg)
    assert feats.shape == (1, 4, 560)
    assert torch.equal(fbank(x, cfg)[:, :1], feats[:, :1, :80])
    timer = StageTimer()
    with timer.stage("s") as pending:
        pending.append(feats)
    assert "s" in timer.detailed()["stages_ms"]


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """One tiny checkpoint directory per family."""
    import test_torch_port_checkpoints as T
    from test_torch_port_tts_checkpoints import (am_state_dict,
                                                 voc_state_dict,
                                                 write_package)
    from toolbox_for_asr_and_tts_tpu_torch.models import (
        campplus, ct_transformer, kws_ctc)
    from toolbox_for_asr_and_tts_tpu_torch.runtime import checkpoints as ckpt
    root = tmp_path_factory.mktemp("damo")
    g = torch.Generator().manual_seed(0)
    pcfg = pf.ParaformerConfig(**T.PARA)
    vcfg = fv.FsmnVadConfig(**T.VAD)
    ccfg = ct_transformer.CTTransformerConfig(**T.PUNC)
    kcfg = kws_ctc.KwsConfig(**T.KWS)
    scfg = campplus.CampPlusConfig(**T.CAMPP)
    sv = root / "sv"
    T._save(ckpt.invert_to_state_dict(campplus.init_params(scfg, g),
                                      ckpt.campplus_rules(scfg.block_layers)),
            sv / "model.pt")
    return {
        "paraformer": T._paraformer_dir(root, ckpt.invert_to_state_dict(
            pf.init_params(pcfg, g), ckpt.paraformer_rules(2, 1)), pcfg),
        "fsmn_vad": T._vad_dir(root, ckpt.invert_to_state_dict(
            fv.init_params(vcfg, g), ckpt.fsmn_vad_rules(2)), vcfg),
        "punc": T._punc_dir(root, ckpt.invert_to_state_dict(
            ct_transformer.init_params(ccfg, g),
            ckpt.ct_transformer_rules(2)), ccfg),
        "kws": T._kws_dir(root, ckpt.invert_to_state_dict(
            kws_ctc.init_params(kcfg, g), ckpt.kws_rules(2, 1)), kcfg),
        "sv": (str(sv), scfg),
        "tts": write_package(root / "tts", am_state_dict("invert"),
                             voc_state_dict()),
    }


def _loaders(dirs, device):
    """Every `from_model_dir` of the port, on `dirs`, with `device`."""
    from toolbox_for_asr_and_tts_tpu_torch.asr.speaker import SpeakerVerifier
    from toolbox_for_asr_and_tts_tpu_torch.models.ct_transformer import (
        Punctuator)
    from toolbox_for_asr_and_tts_tpu_torch.models.kws_ctc import (
        KeywordSpotter)
    from toolbox_for_asr_and_tts_tpu_torch.tts.synthesizer import Synthesizer
    kw = {} if device is None else {"device": device}
    sv_dir, scfg = dirs["sv"]
    return {
        "Recognizer": lambda: Recognizer.from_model_dir(dirs["paraformer"],
                                                        **kw),
        "fsmn_vad": lambda: fv.from_model_dir(dirs["fsmn_vad"], **kw),
        "Punctuator": lambda: Punctuator.from_model_dir(dirs["punc"], **kw),
        "KeywordSpotter": lambda: KeywordSpotter.from_model_dir(dirs["kws"],
                                                                **kw),
        "SpeakerVerifier": lambda: SpeakerVerifier.from_model_dir(
            sv_dir, cfg=scfg, **kw),
        "Synthesizer": lambda: Synthesizer.from_model_dir(dirs["tts"], **kw),
    }


def test_from_model_dir_raises_without_a_card(model_dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, load in _loaders(model_dirs, None).items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load()
    for name, load in _loaders(model_dirs, "cuda").items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load()


def test_from_model_dir_runs_on_explicit_cpu(model_dirs):
    cpu = torch.device("cpu")
    for name, load in _loaders(model_dirs, "cpu").items():
        obj = load()
        if name == "fsmn_vad":
            trees = obj[0]
        elif name == "Synthesizer":
            trees = (obj.ap, obj.vp)
        else:
            trees = obj.params
            assert obj.device == cpu, name
        leaves = []
        tree_map(leaves.append, trees)
        assert leaves and all(a.device == cpu for a in leaves), name
