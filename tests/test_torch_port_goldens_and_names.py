"""The port's `tools/make_frontend_goldens.py` reproduces the vendored
goldens (tests/data/frontend_goldens.npz) array for array, written into a
temporary directory; and the two names the port took over last:
`service/schemas.py::TTSResultResponse` and
`runtime/bucketing.py::CompileCacheStats`, against the reference's."""
import dataclasses
import json

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
