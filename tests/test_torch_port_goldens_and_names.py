"""The port's `tools/make_frontend_goldens.py` reproduces the vendored
goldens (tests/data/frontend_goldens.npz) array for array, written into a
temporary directory; the two names the port took over last:
`service/schemas.py::TTSResultResponse` and
`runtime/bucketing.py::CompileCacheStats`, against the reference's; and,
per module present in both packages, the public keyword names of every
function and method present in both (by AST), so that a keyword the port
lacks fails here, save the listed idiom renames, each with its reason."""
import ast
import dataclasses
import json
import os

import numpy as np
import pytest

from toolbox_for_asr_and_tts_tpu.runtime.bucketing import (  # noqa: E402
    CompileCacheStats as JStats)
from toolbox_for_asr_and_tts_tpu.service.schemas import (  # noqa: E402
    TTSResultResponse as JResult)
from toolbox_for_asr_and_tts_tpu_torch.runtime.bucketing import (  # noqa: E402
    CompileCacheStats)
from toolbox_for_asr_and_tts_tpu_torch.service.schemas import (  # noqa: E402
    TTSResultResponse, ValidationError)

GOLDENS = "tests/data/frontend_goldens.npz"


def test_generator_reproduces_the_goldens(tmp_path):
    pytest.importorskip("transformers")
    from toolbox_for_asr_and_tts_tpu_torch.tools import make_frontend_goldens
    out = make_frontend_goldens.main(str(tmp_path / "goldens.npz"))
    got, want = np.load(out), np.load(GOLDENS)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        if k == "_provenance":
            continue
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    meta, ref = (json.loads(bytes(a["_provenance"]).decode())
                 for a in (got, want))
    meta.pop("date")
    ref.pop("date")
    assert meta == ref


def test_generator_defaults_to_the_vendored_path(monkeypatch):
    """Without an argument the output is tests/data/frontend_goldens.npz
    (never written here: `np.savez_compressed` is intercepted)."""
    pytest.importorskip("transformers")
    import os
    from toolbox_for_asr_and_tts_tpu_torch.tools import make_frontend_goldens
    written = []
    monkeypatch.setattr(np, "savez_compressed",
                        lambda path, **kw: written.append(path))
    monkeypatch.setattr(os.path, "getsize", lambda p: 0)
    path = make_frontend_goldens.main()
    assert written == [path] and path == os.path.abspath(GOLDENS)


def test_tts_result_response_fields_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(TTSResultResponse)}
    ref = {name: f.default for name, f in JResult.model_fields.items()}
    assert list(ours) == list(ref)
    assert {k: (None if v is dataclasses.MISSING else v)
            for k, v in ours.items()} == \
        {k: (None if repr(v) == "PydanticUndefined" else v)
         for k, v in ref.items()}
    body = {"job_id": "j", "status": "completed", "audio_base64": "AAA=",
            "text": "你好", "audio_size": 4, "segments_done": 2,
            "n_segments": 2}
    assert dataclasses.asdict(TTSResultResponse.model_validate(body)) == \
        JResult.model_validate(body).model_dump()
    with pytest.raises(ValidationError):
        TTSResultResponse.model_validate({"status": "completed"})


def test_compile_cache_stats_record_matches_reference():
    ours, ref = CompileCacheStats(), JStats()
    shapes = [(8, 160000), (8, 160000), (4, 32000), (8, 160000, 1), (4, 32000)]
    assert [ours.record(*s) for s in shapes] == \
        [ref.record(*s) for s in shapes] == [True, False, True, True, False]
    assert ours.shapes == ref.shapes


# ------------------------------------------------ public keyword names
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_PKG = os.path.join(ROOT, "toolbox_for_asr_and_tts_tpu")
PORT_PKG = os.path.join(ROOT, "toolbox_for_asr_and_tts_tpu_torch")
# keywords the port names otherwise wherever they occur, and why
RENAMED = {
    "key": (("g", "generator"), "a torch.Generator draws the weights in "
            "place of a JAX PRNG key"),
    "fns": (("programs",), "a runtime/graphs.py Programs owner caches the "
            "compiled programs in place of a dict of jitted functions"),
}
# keywords one port function leaves out, and why
DROPPED = {
    ("runtime/profiling.py", "trace_to"): (
        {"create_perfetto_link"}, "a jax.profiler option; torch.profiler "
        "writes a Chrome trace, which Perfetto opens as it is"),
    ("models/paraformer_streaming.py", "nar_redecode"): (
        {"fns"}, "the re-decode runs eagerly on the params' device: no "
        "compiled function to cache"),
    ("tools/start_all.py", "serve_all"): (
        {"voice_port", "tts_port"}, "it serves the apps `main` built on "
        "the chosen device, each at its (host, port) address"),
}
# public top-level functions of a shared module that the port leaves out
LEFT_OUT = {
    ("launch.py", "setup_compilation_cache"): "XLA's persistent "
    "compilation cache; a CUDA graph is captured per process",
}


def _signatures(path):
    """Public top-level functions and public methods (and __init__) of
    public classes → their parameter names (self and cls left out)."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())

    def names(fn):
        a = fn.args
        return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
                if x.arg not in ("self", "cls")]
    fns = (ast.FunctionDef, ast.AsyncFunctionDef)
    out = {}
    for node in tree.body:
        if isinstance(node, fns) and not node.name.startswith("_"):
            out[node.name] = names(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, fns) and (not m.name.startswith("_")
                                           or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = names(m)
    return out


def _shared_modules():
    out = []
    for root, _, files in os.walk(REF_PKG):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), REF_PKG)
            if f.endswith(".py") and os.path.exists(
                    os.path.join(PORT_PKG, rel)):
                out.append(rel.replace(os.sep, "/"))
    return sorted(out)


SHARED = _shared_modules()


def test_every_listed_difference_exists():
    """No stale entry: each dropped keyword and left-out function names a
    module present in both packages."""
    assert len(SHARED) > 50
    for rel, _ in list(DROPPED) + list(LEFT_OUT):
        assert rel in SHARED, rel


@pytest.mark.parametrize("rel", SHARED)
def test_public_keywords_match_reference(rel):
    """Every keyword a reference function or method of `rel` takes, the
    port's function or method of the same name takes too (renamed only as
    RENAMED lists, or left out only as DROPPED lists); every public
    top-level function of the reference module is in the port's, save
    LEFT_OUT; and every DROPPED / LEFT_OUT entry still applies."""
    ref = _signatures(os.path.join(REF_PKG, rel))
    port = _signatures(os.path.join(PORT_PKG, rel))
    missing = {}
    for name in sorted(set(ref) & set(port)):
        dropped = DROPPED.get((rel, name), (set(), ""))[0]
        lacks = [k for k in ref[name] if k not in port[name]
                 and k not in dropped
                 and not set(RENAMED.get(k, ((),))[0]) & set(port[name])]
        if lacks:
            missing[name] = lacks
        assert dropped <= set(ref[name]) - set(port[name]), (name, dropped)
    assert not missing, f"{rel}: keywords the port lacks: {missing}"
    top = {n for n in ref if "." not in n} - {n for n in port if "." not in n}
    assert top == {n for r, n in LEFT_OUT if r == rel}, (rel, top)
    for r, name in DROPPED:
        if r == rel:
            assert name in ref and name in port, name
